"""Attention, the GQA path (port of ``repro/models/attention.py``): the
chunked online-softmax ("flash") attention for prefill, dense attention
for decode, the slab KV cache and the GQA layer.

Attention on the slab cache is plain torch, as it is plain JAX in the
reference: scores and the PV product accumulate in fp32 from operands in
the compute dtype, with the reference's masks and its 1e-30 clamp.  On a
paged cache (:mod:`repro_torch.kvcache`) decode attention runs the paged
int8 kernel instead.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch import kvcache as kvc
from repro_torch.configs.base import ModelConfig
from repro_torch.core.gemm import ca_matmul
from repro_torch.kernels.epilogue import Epilogue
from repro_torch.kernels.flash_attn import attention_mask, chunked_attention
from repro_torch.models import common as cm
from repro_torch.models.common import Defs, ParamDef

NEG = -1e30


def flash_attention(
    q: torch.Tensor,             # (B, Lq, H, Dq)
    k: torch.Tensor,             # (B, S, Hkv, Dq)
    v: torch.Tensor,             # (B, S, Hkv, Dv)
    *,
    q_positions: torch.Tensor,   # (B, Lq)
    kv_positions: torch.Tensor,  # (B, S); -1 marks invalid slots
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
) -> torch.Tensor:
    """Scores are produced and consumed per (q-chunk, kv-chunk) tile while
    the running max, denominator and output accumulator stay resident
    (:func:`repro_torch.kernels.flash_attn.chunked_attention`, plain
    torch).  The chunk boundaries are the reference's, so the
    online-softmax rescales happen at the same places."""
    return chunked_attention(
        q, k, v, q_positions=q_positions, kv_positions=kv_positions,
        causal=causal, window=window, scale=scale, q_chunk=q_chunk,
        kv_chunk=kv_chunk)


def dense_attention(q, k, v, *, q_positions, kv_positions, causal=True,
                    window=None, scale=None) -> torch.Tensor:
    """Unchunked scores — used for decode (Lq == 1)."""
    B, Lq, H, Dq = q.shape
    _, S, Hkv, _ = k.shape
    G = H // Hkv
    scale = Dq ** -0.5 if scale is None else scale
    qf = q.reshape(B, Lq, Hkv, G, Dq).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * scale
    mask = attention_mask(q_positions, kv_positions, causal,
                          window)[:, None, None]
    s = torch.where(mask, s, NEG)
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask, p, 0.0)
    out = torch.einsum("bhgqk,bkhd->bhgqd", p.to(q.dtype).float(),
                       v.float())
    return out.permute(0, 3, 1, 2, 4).reshape(B, Lq, H, v.shape[-1]) \
        .to(q.dtype)


# ---------------------------------------------------------------------------
# Slab KV cache (rolling for sliding-window archs)
# ---------------------------------------------------------------------------

def make_kv_cache(B: int, cache_len: int, n_kv: int, dk: int, dv: int,
                  dtype, device=None) -> Dict[str, torch.Tensor]:
    return {
        "k": torch.zeros((B, cache_len, n_kv, dk), dtype=dtype,
                         device=device),
        "v": torch.zeros((B, cache_len, n_kv, dv), dtype=dtype,
                         device=device),
        "pos": torch.full((B, cache_len), -1, dtype=torch.int32,
                          device=device),
    }


def cache_len_for(cfg: ModelConfig, seq_len: int) -> int:
    if cfg.sliding_window is not None:
        return min(cfg.sliding_window, seq_len)
    return seq_len


def kv_cache_insert(cache, k_new, v_new, step: int):
    """Insert one token (B, 1, Hkv, D) at rolling slot ``step % C``.

    Unlike the reference (which returns an updated copy), this writes the
    slab **in place** and returns the same dict: decode then never copies
    the cache, and a layer's slab may be a view into the model's stacked
    cache."""
    slot = step % cache["k"].shape[1]
    cache["k"][:, slot] = k_new[:, 0]
    cache["v"][:, slot] = v_new[:, 0]
    cache["pos"][:, slot] = step
    return cache


def kv_cache_from_prefill(k, v, positions, cache_len: int):
    """Build a cache from full-sequence prefill k/v: keeps the last
    ``cache_len`` entries or pads with free slots (pos = -1).

    Kept entries go to their rolling slots, position ``p`` at slot
    ``p % cache_len``, which is where :func:`kv_cache_insert` later
    overwrites the oldest one (prefill positions run 0..S-1, so the kept
    slice rolls by ``S % cache_len``).  The reference keeps them in order
    instead, so for a prompt longer than a sliding window (and not a
    multiple of it) its decode overwrites positions still inside the
    window."""
    S = k.shape[1]
    positions = positions.to(torch.int32)
    if S > cache_len:
        shift = S % cache_len
        k, v, positions = (torch.roll(t[:, -cache_len:], shift, dims=1)
                           for t in (k, v, positions))
    elif S < cache_len:
        pad = cache_len - S
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        positions = F.pad(positions, (0, pad), value=-1)
    return {"k": k.contiguous(), "v": v.contiguous(),
            "pos": positions.contiguous()}


# ---------------------------------------------------------------------------
# GQA / MQA attention layer
# ---------------------------------------------------------------------------

def gqa_defs(cfg: ModelConfig, depth_scale: float = 1.0) -> Defs:
    d = cfg.d_model
    Dh = cfg.resolved_head_dim
    return {
        "wq": ParamDef((d, cfg.n_heads * Dh), ("embed", "qkv")),
        "wk": ParamDef((d, cfg.n_kv_heads * Dh), ("embed", "qkv")),
        "wv": ParamDef((d, cfg.n_kv_heads * Dh), ("embed", "qkv")),
        "wo": ParamDef((cfg.n_heads * Dh, d), ("qkv", "embed"),
                       scale=depth_scale),
    }


def gqa_apply(p, x, cfg: ModelConfig, *, positions, cache=None,
              step: Optional[int] = None, mode: str = "train",
              max_len: Optional[int] = None, residual=None):
    """mode: train | prefill (returns a cache) | decode (uses and updates
    ``cache`` in place).  ``residual`` is added in the output projection's
    drain.

    A paged ``cache`` (one layer's view of the model's pool) is written in
    place in both modes: prefill attends over the unquantized k/v and then
    bulk-inserts them into the pre-assigned pages; decode appends the
    token, then attends over the int8 pages."""
    B, L, _ = x.shape
    Dh = cfg.resolved_head_dim
    H, Kv = cfg.n_heads, cfg.n_kv_heads
    q = ca_matmul(x, p["wq"]).reshape(B, L, H, Dh)
    k = ca_matmul(x, p["wk"]).reshape(B, L, Kv, Dh)
    v = ca_matmul(x, p["wv"]).reshape(B, L, Kv, Dh)
    q = cm.apply_rope(q, positions, cfg.rope_theta)
    k = cm.apply_rope(k, positions, cfg.rope_theta)

    if mode == "decode":
        if cache is None or step is None:
            raise ValueError("decode needs a cache and a step")
        if kvc.is_paged(cache):
            # Positions are implicit in the block table and the length,
            # so ``step`` goes unused here.
            cache = kvc.paged_decode_insert(cache, k, v)
            out = kvc.paged_attention(q, cache, window=cfg.sliding_window)
        else:
            cache = kv_cache_insert(cache, k, v, step)
            out = dense_attention(
                q, cache["k"], cache["v"], q_positions=positions,
                kv_positions=cache["pos"], causal=True,
                window=cfg.sliding_window)
        new_cache = cache
    else:
        out = flash_attention(
            q, k, v, q_positions=positions, kv_positions=positions,
            causal=True, window=cfg.sliding_window,
            q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
        new_cache = None
        if mode == "prefill":
            if cache is not None and kvc.is_paged(cache):
                new_cache = kvc.paged_prefill_insert(cache, k, v)
            else:
                C = cache_len_for(cfg, max_len or L)
                new_cache = kv_cache_from_prefill(k, v, positions, C)
    epi = Epilogue(residual=residual) if residual is not None else None
    y = ca_matmul(out.reshape(B, L, H * Dh), p["wo"], epilogue=epi)
    return y, new_cache
