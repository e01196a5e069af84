"""Mamba2 mixer (port of ``repro/models/ssm.py``): SSD (state-space
duality) with a chunked linear-time scan, in plain torch as the reference
computes it in plain JAX.

Within a chunk the SSD is dense batched products; only an
O(heads·head_dim·d_state) fp32 state crosses chunk boundaries.  The
reference's ``lax.scan`` over chunks is a Python loop here.  Decode is the
exact recurrence ``s <- exp(dt·A)·s + dt·x ⊗ B``, ``y = C·s + D·x``: O(1)
a token.  ``in_proj`` and ``out_proj`` run on K1 (``ca_matmul``, the
``none`` program).

Rounding follows the reference: the causal conv accumulates in fp32 and
casts to the serve dtype, ``silu`` and the scan run in fp32, the gated
RMSNorm reads ``y * silu(z)`` cast to the serve dtype; the conv cache is
kept in the serve dtype, the SSM state in fp32.

Tensor-parallel (train mode inside ``core.distributed.model_parallel``;
``train.fsdp`` hands each rank ``in_proj``, ``conv_w`` and ``conv_b``
whole, ``norm`` and ``out_proj``'s rows as its ``ssm`` slices): each rank
runs ``h / tp`` SSD heads.  Its columns of ``in_proj`` (its ``z``, ``x``
and ``dt``, with ``B`` and ``C`` whole) make one local projection, one K1
launch; its conv channels, its slices of ``a_log``, ``d_skip`` and
``dt_bias``, and the scan over its heads follow.  The gated norm's sum of
squares is summed over ``model`` (``core.distributed.model_allreduce``,
whose backward sums too: each rank's channels consume it), and
``out_proj`` is row-parallel (``models.common.row_parallel_out``).  The
contiguous ``ssm`` shards of the fused leaves do not line up with heads,
so each rank's gradient of them is partial: ``train.fsdp`` sums it over
``model``.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.distributed import (copy_to_model, model_allreduce,
                                          model_index, model_parallel_size)
from repro_torch.core.gemm import ca_matmul
from repro_torch.kernels.program import apply_rms_reference
from repro_torch.models import common as cm
from repro_torch.models.common import Defs, ParamDef


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d = cfg.d_model
    return s, d, s.d_inner(d), s.n_heads(d), s.d_state, s.n_groups


def mamba2_defs(cfg: ModelConfig, depth_scale: float = 1.0) -> Defs:
    s, d, di, h, n, g = _dims(cfg)
    conv_ch = di + 2 * g * n
    proj_out = 2 * di + 2 * g * n + h   # [z, x, B, C, dt]
    return {
        "in_proj": ParamDef((d, proj_out), ("embed", "ssm")),
        "conv_w": ParamDef((s.conv_kernel, conv_ch), (None, "ssm"),
                           init="conv"),
        "conv_b": ParamDef((conv_ch,), ("ssm",), init="zeros"),
        "a_log": ParamDef((h,), (None,), init="a_log"),
        "d_skip": ParamDef((h,), (None,), init="ones"),
        "dt_bias": ParamDef((h,), (None,), init="dt_bias"),
        "norm": ParamDef((di,), ("ssm",), init="ones"),
        "out_proj": ParamDef((di, d), ("ssm", "embed"), scale=depth_scale),
    }


def _split_proj(zxbcdt: torch.Tensor, di: int, gn: int):
    """in_proj's output as views: z and x (``di`` columns each), B and C
    (``gn`` each) and dt."""
    z = zxbcdt[..., :di]
    xin = zxbcdt[..., di:2 * di]
    b = zxbcdt[..., 2 * di:2 * di + gn]
    c = zxbcdt[..., 2 * di + gn:2 * di + 2 * gn]
    dt = zxbcdt[..., 2 * di + 2 * gn:]
    return z, xin, b, c, dt


def tp_columns(cfg: ModelConfig, tp: int, index: int) -> Dict[str, list]:
    """The columns of the fused leaves that rank ``index`` of ``tp``
    reads, as ``(start, stop)`` ranges in order: ``in_proj``'s its ``z``
    and ``x`` columns, ``B`` and ``C`` whole and its ``dt`` columns;
    the conv's its ``x`` channels, then ``B`` and ``C``."""
    s, d, di, h, n, g = _dims(cfg)
    dil, hl = di // tp, h // tp
    c0, h0 = index * dil, index * hl
    bc = (2 * di, 2 * di + 2 * g * n)
    return {"in_proj": [(c0, c0 + dil), (di + c0, di + c0 + dil), bc,
                        (bc[1] + h0, bc[1] + h0 + hl)],
            "conv": [(c0, c0 + dil), (di, di + 2 * g * n)]}


def _columns(t: torch.Tensor, spans) -> torch.Tensor:
    """The columns (last dim) of ``t`` in ``spans``, one gather (its
    backward scatters into zeros of ``t``'s shape)."""
    idx = torch.cat([torch.arange(a, b, device=t.device) for a, b in spans])
    return torch.index_select(t, t.dim() - 1, idx)


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, L, C) with kernel (K, C): the K
    shifted products accumulated in fp32 in the reference's order, the
    bias added, cast back to x's dtype."""
    K, L = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(K):
        out = out + xp[:, i:i + L].float() * w[i].float()
    return (out + b.float()).to(x.dtype)


def _ssd_scan(xdt, da, b_h, c_h, chunk: int, s0=None):
    """Chunked SSD.  xdt: (B, L, H, P) [= x·dt], da: (B, L, H) [= dt·A],
    b_h / c_h: (B, L, H, N).  Returns (y: (B, L, H, P), s_final: (B, H, P,
    N)).  L is padded up to a chunk multiple (zero xdt adds nothing; zero
    da is a decay of 1, so the final state is unchanged)."""
    B, L0, H, P = xdt.shape
    pad = (-L0) % chunk
    if pad:
        xdt = F.pad(xdt, (0, 0, 0, 0, 0, pad))
        da = F.pad(da, (0, 0, 0, pad))
        b_h = F.pad(b_h, (0, 0, 0, 0, 0, pad))
        c_h = F.pad(c_h, (0, 0, 0, 0, 0, pad))
    N = b_h.shape[-1]
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=xdt.device))[None, :, :, None]
    s = torch.zeros((B, H, P, N), dtype=torch.float32, device=xdt.device) \
        if s0 is None else s0
    ys = []
    for lo in range(0, L0 + pad, chunk):
        xd, da_, bb, cc = (t[:, lo:lo + chunk] for t in (xdt, da, b_h, c_h))
        cs = torch.cumsum(da_, dim=1)                 # (B, Q, H)
        # intra-chunk: y_t += sum_{s<=t} C_t·B_s exp(cs_t - cs_s) x_s.
        # Above the diagonal ldec is a positive sum of decays whose exp
        # overflows; it is masked to -inf *before* the exp (exp(-inf) = 0,
        # the same forward bit for bit), so the backward never forms
        # 0 · inf.  The reference masks after the exp, and its d(da) is NaN
        # once a chunk's decays pass ~88.
        ldec = cs[:, :, None, :] - cs[:, None, :, :]  # (B, Q, K, H)
        lmat = torch.exp(torch.where(mask, ldec, float("-inf")))
        scores = torch.einsum("bqhn,bkhn->bqkh", cc, bb)
        y = torch.einsum("bqkh,bkhp->bqhp", scores * lmat, xd)
        # inter-chunk: y_t += C_t · s_in · exp(cs_t)
        y = y + torch.einsum("bqhn,bhpn->bqhp", cc, s) \
            * torch.exp(cs)[..., None]
        # s_out = exp(cs_end)·s_in + sum_k exp(cs_end - cs_k) B_k ⊗ x_k
        cs_end = cs[:, -1]                            # (B, H)
        s = torch.exp(cs_end)[..., None, None] * s + torch.einsum(
            "bkh,bkhp,bkhn->bhpn", torch.exp(cs_end[:, None] - cs), xd, bb)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :L0], s


def make_ssm_cache(B: int, cfg: ModelConfig, dtype,
                   device=None) -> Dict[str, torch.Tensor]:
    s, d, di, h, n, g = _dims(cfg)
    return {
        "conv": torch.zeros((B, s.conv_kernel - 1, di + 2 * g * n),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((B, h, s.head_dim, n), dtype=torch.float32,
                           device=device),
    }


def mamba2_apply(p: Dict[str, torch.Tensor], x: torch.Tensor,
                 cfg: ModelConfig, *, cache=None, mode: str = "train"):
    """mode train / prefill: the whole sequence (any L; the scan pads to
    its chunk); decode: L == 1 against ``cache``.  Returns (out,
    new_cache): prefill's cache from the prompt (the conv window
    left-padded with zeros for a prompt shorter than it), decode's the
    updated one (new tensors: the model writes them into its stacked
    cache).  Inside ``model_parallel`` train mode runs this rank's heads
    (see the module docstring); prefill and decode raise there."""
    s, d, di, h, n, g = _dims(cfg)
    B, L, _ = x.shape
    dt_ = x.dtype
    P = s.head_dim
    K = s.conv_kernel
    tp = model_parallel_size()
    w_in, conv_w, conv_b = p["in_proj"], p["conv_w"], p["conv_b"]
    h0, hl = 0, h
    if tp > 1:
        if mode != "train":
            raise ValueError(f"the tensor-parallel Mamba2 mixer runs train "
                             f"mode only, not {mode!r}")
        hl, index = h // tp, model_index()
        h0 = index * hl
        cols = tp_columns(cfg, tp, index)
        w_in = _columns(w_in, cols["in_proj"])
        conv_w = _columns(conv_w, cols["conv"])
        conv_b = _columns(conv_b, cols["conv"])
        x = copy_to_model(x)
    dil = hl * P

    zxbcdt = ca_matmul(x, w_in)
    z, xin, b, c, dtv = _split_proj(zxbcdt, dil, g * n)
    conv_in = torch.cat([xin, b, c], dim=-1)

    new_cache = None
    if mode == "decode":
        if cache is None or L != 1:
            raise ValueError("mamba2 decode takes one token and a cache")
        hist = torch.cat([cache["conv"].to(dt_), conv_in], dim=1)
        conv_out = _causal_conv(hist, conv_w, conv_b)[:, -1:]
        new_conv = hist[:, 1:]
    else:
        conv_out = _causal_conv(conv_in, conv_w, conv_b)
        new_conv = conv_in[:, -(K - 1):] if L >= K \
            else F.pad(conv_in, (0, 0, K - 1 - L, 0))
    conv_out = F.silu(conv_out.float())

    xs = conv_out[..., :dil].reshape(B, L, hl, P)
    bs = conv_out[..., dil:dil + g * n].reshape(B, L, g, n)
    cs = conv_out[..., dil + g * n:].reshape(B, L, g, n)
    rep = h // g
    # (B, L, H, N) fp32, this rank's heads
    b_h = bs.repeat_interleave(rep, dim=2)[:, :, h0:h0 + hl]
    c_h = cs.repeat_interleave(rep, dim=2)[:, :, h0:h0 + hl]

    a = -torch.exp(p["a_log"][h0:h0 + hl].float())    # (H,) < 0
    dt_act = F.softplus(dtv.float()
                        + p["dt_bias"][h0:h0 + hl].float())   # (B, L, H)
    da = dt_act * a
    xdt = xs * dt_act[..., None]

    if mode == "decode":
        s_out = torch.exp(da)[:, 0, :, None, None] * cache["ssm"] \
            + torch.einsum("bhp,bhn->bhpn", xdt[:, 0], b_h[:, 0])
        y = torch.einsum("bhn,bhpn->bhp", c_h[:, 0], s_out)[:, None]
        new_cache = {"conv": new_conv.to(cache["conv"].dtype), "ssm": s_out}
    else:
        y, s_fin = _ssd_scan(xdt, da, b_h, c_h, s.chunk)
        if mode == "prefill":
            new_cache = {"conv": new_conv.contiguous(), "ssm": s_fin}

    y = y + xs * p["d_skip"][h0:h0 + hl].float()[None, None, :, None]
    y = y.reshape(B, L, dil)
    # gated RMSNorm (Mamba2): norm(y * silu(z))
    y = (y * F.silu(z.float())).to(dt_)
    if tp == 1:
        return ca_matmul(cm.rms_norm(y, p["norm"], cfg.norm_eps),
                         p["out_proj"]), new_cache
    y = _tp_rms_norm(y, p["norm"], cfg.norm_eps, di)
    return cm.row_parallel_out(
        ca_matmul(y, p["out_proj"], out_dtype=torch.float32), None,
        dt_), new_cache


def _tp_rms_norm(y: torch.Tensor, gain: torch.Tensor, eps: float,
                 width: int) -> torch.Tensor:
    """``models.common.rms_norm`` of a row split over ``model``: this
    rank's ``y`` and ``gain`` columns, the fp32 sum of squares summed
    over the ranks (``ssm_norm``) and divided by the whole ``width``."""
    yf = y.float()
    ss = model_allreduce(torch.sum(yf * yf, dim=-1, keepdim=True),
                         "ssm_norm")
    return apply_rms_reference(y, torch.rsqrt(ss / width + eps), gain)
