"""Plain-torch oracles (port of ``repro/kernels/ref.py``)."""

from __future__ import annotations

from typing import Optional

import torch

# Elements of the (m, kc, n) broadcast one chunk of the distance product
# may hold (128 MB of fp32): the whole (m, k, n) broadcast at
# m = n = k = 4096 would be 275 GB.
_MIN_PLUS_CHUNK = 1 << 25


def ref_matmul(a: torch.Tensor, b: torch.Tensor,
               out_dtype=None) -> torch.Tensor:
    """C = A @ B with fp32 (or int32) accumulation — the paper's Lst. 1."""
    if a.dtype.is_floating_point:
        c = a.float() @ b.float()
        return c.to(out_dtype or a.dtype)
    # Integer operands contract exactly; int64 holds every int8 x int8 sum.
    c = (a.long() @ b.long()).to(torch.int32)
    return c.to(out_dtype or torch.int32)


def ref_distance_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """min-plus (tropical) matmul — the paper's Sec. 5.2 custom-semiring
    example ('replace multiply and add with add and minimum').

    a: (m, k), b: (k, n) -> (m, n): min_k (a[m,k] + b[k,n]), in the
    operands' promoted dtype, NaN propagating.  The broadcast is taken over
    chunks of k and the chunks' minima are merged: min is exact and
    order-free, so the chunking changes no bit."""
    m, k = a.shape
    n = b.shape[1]
    kc = max(1, _MIN_PLUS_CHUNK // max(1, m * n))
    out = torch.full((m, n), float("inf"), device=a.device,
                     dtype=torch.promote_types(a.dtype, b.dtype))
    for k0 in range(0, k, kc):
        part = (a[:, k0:k0 + kc, None] + b[None, k0:k0 + kc, :]).amin(dim=1)
        out = torch.minimum(out, part)
    return out


def ref_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: Optional[int] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Oracle for the attention kernel: plain softmax attention.

    q: (L, H, D), k/v: (S, Hkv, D) with H % Hkv == 0.  fp32 math; queries
    end-aligned with the keys."""
    L, H, D = q.shape
    S, Hkv, _ = k.shape
    g = H // Hkv
    scale = scale if scale is not None else D ** -0.5
    qf = q.float() * scale
    kf = k.float().repeat_interleave(g, dim=1)   # (S, H, D)
    vf = v.float().repeat_interleave(g, dim=1)
    logits = torch.einsum("lhd,shd->hls", qf, kf)
    pos_q = torch.arange(L, device=q.device)[:, None] + (S - L)
    pos_k = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((L, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos_k <= pos_q
    if window is not None:
        mask &= pos_k > pos_q - window
    logits = torch.where(mask[None], logits, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("hls,shd->lhd", p, vf)
    return out.to(q.dtype)
