"""Shared model machinery (port of ``repro/models/common.py``): parameter
definitions and init laws, norms, rotary embeddings (RoPE and M-RoPE),
the MLP, embedding and unembedding (one head or one per codebook).

Parameters are flat dicts keyed by '/'-joined paths, each declared once
as a :class:`ParamDef` with its shape, logical axes and init law — the
same layout as the reference, so its parameters convert key by key.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core.distributed import (copy_to_model, model_index,
                                          model_parallel_size,
                                          reduce_from_model)
from repro_torch.core.gemm import ca_glu_matmul, ca_matmul
from repro_torch.kernels.epilogue import Epilogue
from repro_torch.kernels.program import (RmsPrologue, apply_rms_reference,
                                         rms_row_scale)
from repro_torch.quant.calibrate import QuantConfig, quantize_tensor
from repro_torch.quant.scales import QTensor


# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]   # logical names, len == len(shape)
    init: str = "fanin"               # fanin|embed|zeros|ones|a_log|dt_bias|conv
    scale: float = 1.0

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"param shape {self.shape} and logical axes "
                             f"{self.axes} disagree")


Defs = Dict[str, ParamDef]


def prefix_defs(prefix: str, defs: Defs) -> Defs:
    return {f"{prefix}/{k}": v for k, v in defs.items()}


def stack_defs(defs: Defs, n: int) -> Defs:
    """Add a leading 'layers' axis to every def."""
    return {
        k: dataclasses.replace(d, shape=(n,) + d.shape,
                               axes=("layers",) + d.axes)
        for k, d in defs.items()
    }


def init_one(d: ParamDef, generator: torch.Generator, dtype: torch.dtype,
             device, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One parameter drawn by its init law in ``dtype`` (the reference's
    distributions; ``jax.random`` gives other numbers) and stored in
    ``out_dtype`` (default ``dtype``).  A layer-stacked leaf (3-D or more)
    is drawn one layer at a time into the preallocated leaf, scaled in
    place, so a stacked leaf in a narrower serving dtype never exists
    whole in ``dtype``: the peak is the served leaf plus one layer.

    The laws: ``fanin`` a normal truncated at 2 sigma with std
    ``scale / sqrt(fan_in)``; ``embed`` N(0, 0.02²); Mamba2's ``a_log``
    log U[1, 16] (A = -exp(a_log)), ``dt_bias`` the softplus inverse of
    exp U[log 1e-3, log 1e-1], and ``conv`` U[-1/sqrt(fan), 1/sqrt(fan)]
    with ``fan`` the def's leading dim (the layer count of a stacked def,
    as in the reference)."""
    out_dtype = out_dtype or dtype
    kw = {"dtype": out_dtype, "device": device}
    if d.init == "zeros":
        return torch.zeros(d.shape, **kw)
    if d.init == "ones":
        return torch.ones(d.shape, **kw)
    if d.init not in _LAWS:
        raise ValueError(f"unknown init law {d.init!r}")
    out = torch.empty(d.shape, **kw)
    for part in (out.unbind(0) if len(d.shape) >= 3 else (out,)):
        draw = part if out_dtype == dtype else torch.empty(
            part.shape, dtype=dtype, device=device)
        _LAWS[d.init](draw, d, generator)
        if draw is not part:
            part.copy_(draw)
    return out


def _draw_fanin(t: torch.Tensor, d: ParamDef, gen: torch.Generator):
    fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    t.mul_(d.scale / math.sqrt(fan_in))


def _draw_embed(t: torch.Tensor, d: ParamDef, gen: torch.Generator):
    t.normal_(generator=gen).mul_(0.02)


def _draw_a_log(t: torch.Tensor, d: ParamDef, gen: torch.Generator):
    t.uniform_(1.0, 16.0, generator=gen).log_()


def _draw_dt_bias(t: torch.Tensor, d: ParamDef, gen: torch.Generator):
    dt = t.uniform_(math.log(1e-3), math.log(1e-1), generator=gen).exp_()
    t.copy_(dt + torch.log(-torch.expm1(-dt)))


def _draw_conv(t: torch.Tensor, d: ParamDef, gen: torch.Generator):
    bound = 1.0 / math.sqrt(d.shape[0])
    t.uniform_(-bound, bound, generator=gen)


_LAWS = {"fanin": _draw_fanin, "embed": _draw_embed, "a_log": _draw_a_log,
         "dt_bias": _draw_dt_bias, "conv": _draw_conv}


def subtree(params: Dict[str, torch.Tensor],
            prefix: str) -> Dict[str, torch.Tensor]:
    pre = prefix + "/"
    return {k[len(pre):]: v for k, v in params.items() if k.startswith(pre)}


# ---------------------------------------------------------------------------
# Weight quantization (repro_torch.quant)
# ---------------------------------------------------------------------------

# Projection weights that flow through ``ca_matmul`` as plain (k, n)
# operands (the reference's list; embedding tables, norm gains and other
# vectors stay dense).
QUANTIZABLE_SUFFIXES = (
    "wq", "wk", "wv", "wo", "wq_a", "wq_b", "wkv_a",
    "w_up", "w_gate", "w_down", "w_in", "in_proj", "out_proj",
)


def default_quant_predicate(key: str, leaf) -> bool:
    """2-D (k, n) or layer-stacked 3-D (L, k, n) projection matrices; the
    logits head (``head/w``) in its single-head 2-D form."""
    ndim = leaf.dim()
    if ndim not in (2, 3):
        return False
    if key.rsplit("/", 1)[-1] in QUANTIZABLE_SUFFIXES:
        return True
    return key.endswith("head/w") and ndim == 2


def quantize_params(params: Dict[str, torch.Tensor],
                    qconfig: Optional[QuantConfig] = None,
                    predicate=None) -> Dict[str, object]:
    """Weight-quantize a parameter dict for serving: every eligible
    projection matrix becomes an int8 :class:`QTensor` along its
    contraction axis (per-channel by default, per-tile with
    ``qconfig.block``), on the weight's own device; everything else is
    passed through.  The input dict is not modified."""
    qconfig = qconfig or QuantConfig()
    predicate = predicate or default_quant_predicate
    out = {}
    for key, leaf in params.items():
        if not isinstance(leaf, QTensor) and predicate(key, leaf):
            out[key] = quantize_tensor(leaf, qconfig, axis=-2)
        else:
            out[key] = leaf
    return out


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, gain: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """The rms prologue's own helpers, so the standalone op and the kernel
    prologue share one definition."""
    return apply_rms_reference(x, rms_row_scale(x, eps), gain)


def rms_norm_def(d: int) -> Defs:
    return {"scale": ParamDef((d,), ("embed",), init="ones")}


# ---------------------------------------------------------------------------
# Rotary embeddings (RoPE and Qwen2-VL's M-RoPE)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0,
               mrope_sections: Optional[Sequence[int]] = None
               ) -> torch.Tensor:
    """Rotate (B, L, H, D) at positions (B, L), or (B, L, 3) for M-RoPE,
    in fp32, cast back.

    M-RoPE (Qwen2-VL): the D/2 frequency lanes are split into (temporal,
    height, width) sections of ``mrope_sections`` lanes, each rotated by
    its own position stream.  With the vision frontend a stub, all three
    streams carry the text position."""
    B, L = positions.shape[:2]
    half = x.shape[-1] // 2
    inv = rope_freqs(x.shape[-1], theta, x.device)
    if positions.dim() == 3:
        sections = list(mrope_sections or ())
        if sum(sections) != half:
            raise ValueError(f"mrope sections {sections} do not cover the "
                             f"{half} half-dim lanes")
        sec_id = torch.repeat_interleave(
            torch.arange(len(sections), device=x.device),
            torch.as_tensor(sections, device=x.device))
        pos = torch.gather(positions.float(), 2,
                           sec_id[None, None].expand(B, L, half))
    else:
        pos = positions.float()[..., None].expand(B, L, half)
    ang = pos * inv                                   # (B, L, half)
    sin = torch.sin(ang)[:, :, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GELU)
# ---------------------------------------------------------------------------

def mlp_defs(d: int, f: int, act: str, depth_scale: float = 1.0) -> Defs:
    defs = {
        "w_up": ParamDef((d, f), ("embed", "mlp")),
        "w_down": ParamDef((f, d), ("mlp", "embed"), scale=depth_scale),
    }
    if act == "silu":
        defs["w_gate"] = ParamDef((d, f), ("embed", "mlp"))
    return defs


def mlp_apply(p: Dict[str, torch.Tensor], x: torch.Tensor, act: str,
              residual: Optional[torch.Tensor] = None,
              norm_gain: Optional[torch.Tensor] = None,
              norm_eps: float = 1e-5) -> torch.Tensor:
    """SwiGLU / GELU MLP as GemmPrograms: SwiGLU's gate and up run as one
    dual-branch program with the pre-FFN rms_norm folded into the x fetch;
    ``residual`` rides the down projection's single write-back.  Weights
    arrive in the compute dtype (cast once, at load) or as int8
    :class:`QTensor` s, which pass to the GEMMs as they are.

    Tensor-parallel (inside ``core.distributed.model_parallel``, weights
    this rank's ``mlp`` slices): the first program is column-parallel on
    the local ``n`` after ``copy_to_model``, ``w_down`` row-parallel
    (:func:`row_parallel_out`), the residual added once after the sum."""
    if model_parallel_size() == 1:
        down_epi = Epilogue(residual=residual) if residual is not None \
            else None
        return ca_matmul(_mlp_hidden(p, x, act, norm_gain, norm_eps),
                         p["w_down"], epilogue=down_epi)
    return row_parallel_out(
        mlp_partial(p, copy_to_model(x), act, norm_gain, norm_eps),
        residual, x.dtype)


def _mlp_hidden(p, x, act, norm_gain, norm_eps) -> torch.Tensor:
    pro = RmsPrologue(gain=norm_gain, eps=norm_eps) \
        if norm_gain is not None else None
    if act == "silu":
        return ca_glu_matmul(x, p["w_gate"], p["w_up"], activation="silu",
                             prologue=pro, out_dtype=x.dtype)
    return ca_matmul(x, p["w_up"], epilogue=Epilogue(activation="gelu"),
                     prologue=pro)


def mlp_partial(p: Dict[str, torch.Tensor], x: torch.Tensor, act: str,
                norm_gain: Optional[torch.Tensor] = None,
                norm_eps: float = 1e-5) -> torch.Tensor:
    """This rank's fp32 part of a tensor-parallel MLP's output: the
    column-parallel first program on ``x`` (already past
    ``copy_to_model``), then ``w_down``'s rows of this rank, K1's ``none``
    program with an fp32 output."""
    return ca_matmul(_mlp_hidden(p, x, act, norm_gain, norm_eps),
                     p["w_down"], out_dtype=torch.float32)


def row_parallel_out(partial: torch.Tensor,
                     residual: Optional[torch.Tensor], dtype) -> torch.Tensor:
    """A row-parallel GEMM's output: the fp32 partials summed over
    ``model`` (``reduce_from_model``), then the residual, added once, and
    the cast to ``dtype``."""
    y = reduce_from_model(partial)
    if residual is not None:
        y = y + residual.float()
    return y.to(dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed_defs(vocab: int, d: int) -> Defs:
    return {"table": ParamDef((vocab, d), ("vocab", "embed"), init="embed")}


def embed_apply(p: Dict[str, torch.Tensor], tokens: torch.Tensor,
                dtype) -> torch.Tensor:
    """The rows of ``tokens``.  Tensor-parallel, the table is this rank's
    ``vocab`` slice: :func:`vocab_parallel_rows`.  On one rank a plain
    lookup, which an H100 runs forward and backward in 0.34 / 0.58 ms at
    1024 / 16384 tokens of stablelm-1.6b against the masked form's 0.54 /
    0.89 (``tools/loss_forms_ab.py``)."""
    if model_parallel_size() == 1:
        return p["table"][tokens].to(dtype)
    return vocab_parallel_rows(p["table"], tokens, dtype)


def vocab_parallel_rows(table: torch.Tensor, tokens: torch.Tensor,
                        dtype) -> torch.Tensor:
    """The rows of ``tokens`` from this rank's ``vocab`` slice of the
    table: the rows in its range looked up, the rest zero, and the fp32
    sum over ``model`` gives every rank the whole lookup."""
    rows = table.shape[0]
    local = tokens - model_index() * rows
    own = (local >= 0) & (local < rows)
    x = table[torch.where(own, local, 0)]
    x = torch.where(own[..., None], x, 0)
    return reduce_from_model(x, "embed").to(dtype)


def unembed_defs(d: int, vocab: int, n_heads: int = 1) -> Defs:
    if n_heads == 1:
        return {"w": ParamDef((d, vocab), ("embed", "vocab"))}
    return {"w": ParamDef((n_heads, d, vocab), (None, "embed", "vocab"))}


def unembed_apply(p: Dict[str, torch.Tensor], x: torch.Tensor,
                  n_heads: int = 1) -> torch.Tensor:
    """The logits head, fp32 out: one head on K1 (a QTensor head
    included); musicgen's ``n_heads`` codebook heads (``(n_heads, d, V)``
    -> ``(B, L, n_heads, V)``) as the reference computes them, an einsum
    of the compute-dtype operands accumulated in fp32.  Tensor-parallel,
    each head is column-parallel: this rank's ``vocab`` columns of the
    logits (``models.model.lm_loss`` takes them so), ``x`` past
    ``copy_to_model``, so its gradient sums the ranks' parts."""
    x = copy_to_model(x)
    if n_heads == 1:
        return ca_matmul(x, p["w"], out_dtype=torch.float32)
    return torch.einsum("bld,hdv->blhv", x.float(), p["w"].float())


# ---------------------------------------------------------------------------
# Parameter counts and casts (the reference's helpers)
# ---------------------------------------------------------------------------

def count_params(params: Dict[str, object]) -> int:
    """Elements of every leaf, an int8 :class:`QTensor` counted by its
    payload (its scales not)."""
    return int(sum(p.data.numel() if isinstance(p, QTensor) else p.numel()
                   for p in params.values()))


def wcast(w, dtype):
    """A projection weight in the compute dtype; a :class:`QTensor`
    passes as it is (its int8 payload is what the kernel streams)."""
    if isinstance(w, QTensor):
        return w
    return w.to(dtype)


def init_params(defs: Defs, seed: int = 0, dtype=torch.float32,
                device=None) -> Dict[str, torch.Tensor]:
    """Every def of ``defs`` drawn by its init law in ``dtype``, in sorted
    key order from one ``torch.Generator`` seeded with ``seed`` (the
    reference's laws; ``jax.random`` gives other numbers).  ``device``
    defaults to the CPU here: the model's own ``models.model.init_params``
    places the tree."""
    device = torch.device(device or "cpu")
    gen = torch.Generator(device=device).manual_seed(seed)
    return {name: init_one(defs[name], gen, dtype, device)
            for name in sorted(defs)}
