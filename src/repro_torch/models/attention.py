"""Attention (port of ``repro/models/attention.py``): the chunked
online-softmax ("flash") attention for prefill, dense attention for
decode, the slab KV cache, the GQA layer and MLA (multi-head latent
attention, DeepSeek-V2 / MiniCPM3) with its compressed cache.

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
from repro_torch.core.distributed import copy_to_model, model_parallel_size
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


def _slab_insert(cache, entries: Dict[str, torch.Tensor], step: int):
    """Write one token's entries (each (B, 1, ...)) at rolling slot
    ``step % C``, in place."""
    slot = step % cache["pos"].shape[1]
    for key, t in entries.items():
        cache[key][:, slot] = t[:, 0]
    cache["pos"][:, slot] = step
    return cache


def kv_cache_insert(cache, k_new, v_new, step: int):
    """Insert one token (B, 1, Hkv, D) at rolling slot ``step % C``.

    Unlike the reference (which returns an updated copy), this writes the
    slab **in place** and returns the same dict: decode then never copies
    the cache, and a layer's slab may be a view into the model's stacked
    cache."""
    return _slab_insert(cache, {"k": k_new, "v": v_new}, step)


def _slab_from_prefill(entries: Dict[str, torch.Tensor], positions,
                       cache_len: int):
    """A slab of ``cache_len`` slots from full-sequence entries (each
    (B, S, ...)): the last ``cache_len`` kept, or free slots (pos = -1)
    padded on.  Kept entries go to their rolling slots, position ``p`` at
    slot ``p % cache_len``, which is where :func:`_slab_insert` later
    overwrites the oldest one (prefill positions run 0..S-1, so the kept
    slice rolls by ``S % cache_len``)."""
    out = dict(entries, pos=positions.to(torch.int32))
    S = positions.shape[1]
    if S > cache_len:
        out = {key: torch.roll(t[:, -cache_len:], S % cache_len, dims=1)
               for key, t in out.items()}
    elif S < cache_len:
        pad = cache_len - S
        out = {key: F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad),
                          value=-1 if key == "pos" else 0)
               for key, t in out.items()}
    return {key: t.contiguous() for key, t in out.items()}


def kv_cache_from_prefill(k, v, positions, cache_len: int):
    """Build a cache from full-sequence prefill k/v: keeps the last
    ``cache_len`` entries or pads with free slots (pos = -1), each kept
    entry at its rolling slot (:func:`_slab_from_prefill`).  The reference
    keeps them in order instead, so for a prompt longer than a sliding
    window (and not a multiple of it) its decode overwrites positions
    still inside the window."""
    return _slab_from_prefill({"k": k, "v": v}, positions, cache_len)


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
    drain.  ``positions`` are (B, L), or (B, L, 3) with M-RoPE.

    A paged ``cache`` (one layer's view of the model's pool) is written in
    place in both modes: prefill attends over the unquantized k/v and then
    bulk-inserts them into the pre-assigned pages; decode appends the
    token, then attends over the int8 pages."""
    B, L, _ = x.shape
    Dh = cfg.resolved_head_dim
    # the heads this rank holds: all of them, or its tensor-parallel slice
    H, Kv = p["wq"].shape[-1] // Dh, p["wk"].shape[-1] // Dh
    x = copy_to_model(x)
    q = ca_matmul(x, p["wq"]).reshape(B, L, H, Dh)
    k = ca_matmul(x, p["wk"]).reshape(B, L, Kv, Dh)
    v = ca_matmul(x, p["wv"]).reshape(B, L, Kv, Dh)
    sections = cfg.mrope_sections if cfg.rope_kind == "mrope" else None
    q = cm.apply_rope(q, positions, cfg.rope_theta, sections)
    k = cm.apply_rope(k, positions, cfg.rope_theta, sections)
    # M-RoPE's (B, L, 3) positions: the cache and the mask take the first
    # (temporal) stream.
    positions = positions if positions.dim() == 2 else positions[..., 0]

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
    y = _out_proj(out.reshape(B, L, H * Dh), p["wo"], residual)
    return y, new_cache


def _out_proj(out, wo, residual):
    """The output projection with the residual in its drain, or
    tensor-parallel row-parallel (``models.common.row_parallel_out``)."""
    if model_parallel_size() > 1:
        return cm.row_parallel_out(
            ca_matmul(out, wo, out_dtype=torch.float32), residual,
            out.dtype)
    epi = Epilogue(residual=residual) if residual is not None else None
    return ca_matmul(out, wo, epilogue=epi)


# ---------------------------------------------------------------------------
# MLA — multi-head latent attention (DeepSeek-V2 family, MiniCPM3)
# ---------------------------------------------------------------------------

def mla_defs(cfg: ModelConfig, depth_scale: float = 1.0) -> Defs:
    d = cfg.d_model
    m = cfg.mla
    H = cfg.n_heads
    qdim = m.qk_nope_dim + m.qk_rope_dim
    defs: Defs = {}
    if m.q_lora_rank:
        defs["wq_a"] = ParamDef((d, m.q_lora_rank), ("embed", "lora"))
        defs["q_norm"] = ParamDef((m.q_lora_rank,), ("lora",), init="ones")
        defs["wq_b"] = ParamDef((m.q_lora_rank, H * qdim), ("lora", "qkv"))
    else:
        defs["wq"] = ParamDef((d, H * qdim), ("embed", "qkv"))
    defs["wkv_a"] = ParamDef((d, m.kv_lora_rank + m.qk_rope_dim),
                             ("embed", "lora"))
    defs["kv_norm"] = ParamDef((m.kv_lora_rank,), ("lora",), init="ones")
    defs["wkv_b"] = ParamDef((m.kv_lora_rank,
                              H * (m.qk_nope_dim + m.v_head_dim)),
                             ("lora", "qkv"))
    defs["wo"] = ParamDef((H * m.v_head_dim, d), ("qkv", "embed"),
                          scale=depth_scale)
    return defs


def _mla_q(p, x, cfg: ModelConfig, positions):
    """Queries split into their no-position part and their rotary part;
    with q-LoRA the down projection's output is rms-normalized (a
    standalone norm, as in the reference) before the up projection."""
    B, L, _ = x.shape
    m = cfg.mla
    if m.q_lora_rank:
        cq = cm.rms_norm(ca_matmul(x, p["wq_a"]), p["q_norm"], cfg.norm_eps)
        q = ca_matmul(cq, p["wq_b"])
    else:
        q = ca_matmul(x, p["wq"])
    q = q.reshape(B, L, -1, m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    return q_nope, cm.apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_ckv(p, x, cfg: ModelConfig, positions):
    """Compressed KV stream: c_kv (B, L, r), rms-normalized, and the
    rotary key (B, L, rope) shared by every head.  Both are views of one
    projection's output, consumed by plain ops only."""
    m = cfg.mla
    ckv = ca_matmul(x, p["wkv_a"])
    c, k_rope = ckv[..., :m.kv_lora_rank], ckv[..., m.kv_lora_rank:]
    c = cm.rms_norm(c, p["kv_norm"], cfg.norm_eps)
    k_rope = cm.apply_rope(k_rope[:, :, None, :], positions,
                           cfg.rope_theta)[:, :, 0]
    return c, k_rope


def _f32_einsum(spec: str, a: torch.Tensor, b: torch.Tensor,
                dtype) -> torch.Tensor:
    """An einsum of compute-dtype operands accumulated in fp32 and cast
    to ``dtype`` (the reference's ``preferred_element_type=float32``)."""
    return torch.einsum(spec, a.float(), b.float()).to(dtype)


def mla_apply(p, x, cfg: ModelConfig, *, positions, cache=None,
              step: Optional[int] = None, mode: str = "train",
              max_len: Optional[int] = None, residual=None):
    """MLA with the compressed-KV cache ``{"c": (B, C, r), "k_rope": (B,
    C, rope), "pos": (B, C)}``.

    train/prefill: k_nope and v expanded from c_kv by ``wkv_b``, the
    shared rotary key broadcast over the heads, then the chunked flash
    attention at D = nope + rope, Dv = v_head_dim.  decode: the
    matrix-absorbed path, queries projected into the kv_lora space so
    attention runs against the compressed cache itself; the cache is
    written in place, like the slab cache.  The expansion and absorbed
    einsums are plain torch, as they are ``jnp.einsum`` in the reference;
    ``residual`` rides the output projection's drain."""
    B, L, _ = x.shape
    m = cfg.mla
    # the heads this rank holds: all, or its tensor-parallel slice of
    # wq / wq_b, wkv_b and wo (wkv_a and kv_norm are whole on every rank)
    H = p["wkv_b"].shape[-1] // (m.qk_nope_dim + m.v_head_dim)
    dt = x.dtype
    x = copy_to_model(x)
    q_nope, q_rope = _mla_q(p, x, cfg, positions)
    c_kv, k_rope = _mla_ckv(p, x, cfg, positions)
    scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
    wkv_b = p["wkv_b"].to(dt).reshape(m.kv_lora_rank, H,
                                      m.qk_nope_dim + m.v_head_dim)

    if mode == "decode":
        if cache is None or step is None:
            raise ValueError("decode needs a cache and a step")
        cache = _slab_insert(cache, {"c": c_kv, "k_rope": k_rope}, step)
        w_uk, w_uv = wkv_b[..., :m.qk_nope_dim], wkv_b[..., m.qk_nope_dim:]
        q_abs = _f32_einsum("blhn,rhn->blhr", q_nope, w_uk, dt)
        s = torch.einsum("blhr,bsr->bhls", q_abs.float(), cache["c"].float())
        s = s + torch.einsum("blhn,bsn->bhls", q_rope.float(),
                             cache["k_rope"].float())
        s = s * scale
        kpos = cache["pos"][:, None, :]
        mask = ((kpos >= 0) & (kpos <= positions[:, :, None]))[:, None]
        s = torch.where(mask, s, NEG)
        pattn = torch.where(mask, torch.softmax(s, dim=-1), 0.0)
        o_c = _f32_einsum("bhls,bsr->blhr", pattn.to(dt), cache["c"], dt)
        out = _f32_einsum("blhr,rhv->blhv", o_c, w_uv, dt)
        new_cache = cache
    else:
        kv = _f32_einsum("blr,rhn->blhn", c_kv, wkv_b, dt)
        k_nope, v = kv[..., :m.qk_nope_dim], kv[..., m.qk_nope_dim:]
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
            B, L, H, m.qk_rope_dim)], dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        out = flash_attention(
            q, k, v, q_positions=positions, kv_positions=positions,
            causal=True, scale=scale, q_chunk=cfg.q_chunk,
            kv_chunk=cfg.kv_chunk)
        new_cache = None
        if mode == "prefill":
            new_cache = _slab_from_prefill(
                {"c": c_kv, "k_rope": k_rope}, positions,
                cache_len_for(cfg, max_len or L))
    y = _out_proj(out.reshape(B, L, H * m.v_head_dim), p["wo"], residual)
    return y, new_cache


def make_mla_cache(B: int, cache_len: int, cfg: ModelConfig, dtype,
                   device=None) -> Dict[str, torch.Tensor]:
    m = cfg.mla
    return {
        "c": torch.zeros((B, cache_len, m.kv_lora_rank), dtype=dtype,
                         device=device),
        "k_rope": torch.zeros((B, cache_len, m.qk_rope_dim), dtype=dtype,
                              device=device),
        "pos": torch.full((B, cache_len), -1, dtype=torch.int32,
                          device=device),
    }


def qkv_head_widths(cfg: ModelConfig) -> Dict[str, int]:
    """The width of one head in each attention leaf with a ``qkv`` dim,
    by its last key part (``sharding.rules.split_heads``)."""
    if cfg.attn_kind == "mla":
        m = cfg.mla
        qdim = m.qk_nope_dim + m.qk_rope_dim
        return {"wq": qdim, "wq_b": qdim,
                "wkv_b": m.qk_nope_dim + m.v_head_dim, "wo": m.v_head_dim}
    Dh = cfg.resolved_head_dim
    return {"wq": Dh, "wk": Dh, "wv": Dh, "wo": Dh}


def attn_defs(cfg: ModelConfig, depth_scale: float = 1.0) -> Defs:
    if cfg.attn_kind == "mla":
        return mla_defs(cfg, depth_scale)
    return gqa_defs(cfg, depth_scale)


def attn_apply(p, x, cfg: ModelConfig, **kw):
    if cfg.attn_kind == "mla":
        return mla_apply(p, x, cfg, **kw)
    return gqa_apply(p, x, cfg, **kw)


def make_attn_cache(B: int, cache_len: int, cfg: ModelConfig, dtype,
                    device=None) -> Dict[str, torch.Tensor]:
    if cfg.attn_kind == "mla":
        return make_mla_cache(B, cache_len, cfg, dtype, device)
    Dh = cfg.resolved_head_dim
    return make_kv_cache(B, cache_len, cfg.n_kv_heads, Dh, Dh, dtype, device)
