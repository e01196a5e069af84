"""Shared model machinery (port of ``repro/models/common.py``): parameter
definitions, norms, rotary embeddings, the MLP, embedding and unembedding.

Parameters are flat dicts keyed by '/'-joined paths, each declared once
as a :class:`ParamDef` with its shape, logical axes and init law — the
same layout as the reference, so its parameters convert key by key.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

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
    init: str = "fanin"               # fanin|embed|zeros|ones
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
    whole in ``dtype``: the peak is the served leaf plus one layer."""
    out_dtype = out_dtype or dtype
    kw = {"dtype": out_dtype, "device": device}
    if d.init == "zeros":
        return torch.zeros(d.shape, **kw)
    if d.init == "ones":
        return torch.ones(d.shape, **kw)
    if d.init not in ("embed", "fanin"):
        raise ValueError(f"init law {d.init!r} is not ported yet (its "
                         "architectures are ROADMAP queue 1 items)")
    fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
    std = 0.02 if d.init == "embed" else d.scale / math.sqrt(fan_in)
    out = torch.empty(d.shape, **kw)
    for part in (out.unbind(0) if len(d.shape) >= 3 else (out,)):
        draw = part if out_dtype == dtype else torch.empty(
            part.shape, dtype=dtype, device=device)
        if d.init == "embed":
            draw.normal_(generator=generator)
        else:
            torch.nn.init.trunc_normal_(draw, 0.0, 1.0, -2.0, 2.0,
                                        generator=generator)
        draw.mul_(std)
        if draw is not part:
            part.copy_(draw)
    return out


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
# Rotary embeddings (plain RoPE)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotate (B, L, H, D) at positions (B, L), in fp32, cast back."""
    half = x.shape[-1] // 2
    inv = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions.float()[..., None] * inv      # (B, L, half)
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
    :class:`QTensor` s, which pass to the GEMMs as they are."""
    dt = x.dtype
    pro = RmsPrologue(gain=norm_gain, eps=norm_eps) \
        if norm_gain is not None else None
    if act == "silu":
        h = ca_glu_matmul(x, p["w_gate"], p["w_up"], activation="silu",
                          prologue=pro, out_dtype=dt)
    else:
        h = ca_matmul(x, p["w_up"], epilogue=Epilogue(activation="gelu"),
                      prologue=pro)
    down_epi = Epilogue(residual=residual) if residual is not None else None
    return ca_matmul(h, p["w_down"], epilogue=down_epi)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed_defs(vocab: int, d: int) -> Defs:
    return {"table": ParamDef((vocab, d), ("vocab", "embed"), init="embed")}


def embed_apply(p: Dict[str, torch.Tensor], tokens: torch.Tensor,
                dtype) -> torch.Tensor:
    return p["table"][tokens].to(dtype)


def unembed_defs(d: int, vocab: int) -> Defs:
    return {"w": ParamDef((d, vocab), ("embed", "vocab"))}


def unembed_apply(p: Dict[str, torch.Tensor],
                  x: torch.Tensor) -> torch.Tensor:
    """One logits head, fp32 out (a QTensor head included)."""
    return ca_matmul(x, p["w"], out_dtype=torch.float32)
