"""Device-side paged KV cache (port of ``repro/kvcache/paged.py``): int8
page payloads + per-page fp32 scales.

One *layer-level* cache is the dict

.. code-block:: python

    {"k":       (P, page, Hkv, D)  int8,   # page pool, K payload
     "v":       (P, page, Hkv, Dv) int8,
     "k_scale": (P,) float32,              # per-page absmax scales
     "v_scale": (P,) float32,
     "tables":  (B, NP) int32,             # block table; -1 = unmapped
     "len":     (B,)  int32}               # tokens present per sequence

The model stacks one of these per layer along a leading axis, sharing the
page *ids* across layers: page ``p`` of layer ``l`` lives at ``k[l, p]``, so
one host-side allocation (:class:`repro_torch.kvcache.pool.PagePool`)
covers the whole depth.

Quantization is int8 symmetric on [-127, 127] with fp32 scales.  Prefill
bulk-inserts whole pages (one absmax scale per page); the decode append
*requantizes* the touched page under ``max(old_scale, |token|/127)``.  A
freshly assigned page has scale 0, so the first append rescales its stale
payload by ``0 / new_scale`` — prior tenants' bytes are dead on arrival.

Unlike the reference, whose functions return updated copies, every
function here that changes a cache writes its tensors **in place**
(``index_copy_``/``index_put_``/``fill_``) and returns the same dict: the
pool is never copied, and a layer's cache may be a view into the model's
stacked one.  The pool therefore persists across requests, and reuse
safety rests on :func:`model_assign_sequence` zeroing the assigned pages'
scales.  No function reads a sequence length or a page id to the host.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.analyze.preflight import preflight_attn
from repro_torch.kernels.flash_attn import paged_flash_attention
from repro_torch.obs.ledger import get_ledger

_EPS = 1e-12
_QMAX = 127.0  # symmetric int8 grid

# The leaves of one layer's paged cache (:func:`make_paged_cache`).
PAGED_KEYS = ("k", "v", "k_scale", "v_scale", "tables", "len")


def is_paged(cache) -> bool:
    """A cache dict is paged iff it carries a block table."""
    return isinstance(cache, dict) and "tables" in cache


def make_paged_cache(n_pages: int, page_size: int, n_kv: int, dk: int,
                     dv: int, batch: int, max_pages: int,
                     device=None) -> Dict[str, torch.Tensor]:
    """One layer's empty paged cache (see module docstring for layout)."""
    return {
        "k": torch.zeros((n_pages, page_size, n_kv, dk), dtype=torch.int8,
                         device=device),
        "v": torch.zeros((n_pages, page_size, n_kv, dv), dtype=torch.int8,
                         device=device),
        "k_scale": torch.zeros((n_pages,), dtype=torch.float32,
                               device=device),
        "v_scale": torch.zeros((n_pages,), dtype=torch.float32,
                               device=device),
        "tables": torch.full((batch, max_pages), -1, dtype=torch.int32,
                             device=device),
        "len": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


# ---------------------------------------------------------------------------
# Sequence assignment (host-driven, device-applied)
# ---------------------------------------------------------------------------

def _table_row(page_ids: Sequence[int], max_pages: int,
               device) -> torch.Tensor:
    ids = [int(p) for p in page_ids]
    if len(ids) > max_pages:
        raise ValueError(f"{len(ids)} pages exceed the block table's "
                         f"{max_pages} slots")
    return torch.tensor(ids + [-1] * (max_pages - len(ids)),
                        dtype=torch.int32, device=device)


def model_assign_sequence(cache, b: int, page_ids: Sequence[int]):
    """Bind pool pages to batch slot ``b`` across every layer, in place.

    Writes the block-table row, resets the sequence length, and zeroes
    the assigned pages' scales (all layers — the leading stacked axis
    broadcasts), which logically clears any prior tenant's payload.
    """
    lay = cache["layers"]
    lay["tables"][..., b, :] = _table_row(page_ids, lay["tables"].shape[-1],
                                          lay["tables"].device)
    lay["len"][..., b] = 0
    if len(page_ids):
        ids = torch.tensor([int(p) for p in page_ids], dtype=torch.long,
                           device=lay["k_scale"].device)
        lay["k_scale"][..., ids] = 0.0
        lay["v_scale"][..., ids] = 0.0
    return cache


def model_release_sequence(cache, b: int):
    """Unmap batch slot ``b``'s block-table row, in place (pages return to
    the host free list separately — the payload bytes are left as garbage,
    made unreachable here and re-zeroed by the next
    ``model_assign_sequence``)."""
    lay = cache["layers"]
    lay["tables"][..., b, :] = -1
    lay["len"][..., b] = 0
    return cache


# ---------------------------------------------------------------------------
# Inserts
# ---------------------------------------------------------------------------

def paged_prefill_insert(cache: Dict[str, torch.Tensor], k_new: torch.Tensor,
                         v_new: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Bulk-insert a prefill's K/V into the sequence's mapped pages, in
    place.

    ``k_new``/``v_new`` are ``(B, L, Hkv, D)`` in the serve dtype.  Each
    page quantizes independently under its own absmax scale; the ragged
    tail page zero-pads, and the padding never scores because attention
    masks ``kpos >= len``.  The first ``ceil(L / page)`` table slots of
    every row must be mapped — the engine allocates before prefilling.
    """
    B, L, Hkv, _ = k_new.shape
    page = cache["k"].shape[1]
    npg = -(-L // page)
    pad = npg * page - L

    def quantize_pages(x):
        xf = x.float()
        if pad:
            xf = F.pad(xf, (0, 0, 0, 0, 0, pad))
        xb = xf.reshape(B, npg, page, Hkv, x.shape[-1])
        amax = xb.abs().amax(dim=(2, 3, 4))                  # (B, npg)
        scale = torch.clamp(amax, min=_EPS) / _QMAX
        q = torch.clamp(torch.round(xb / scale[:, :, None, None, None]),
                        -_QMAX, _QMAX).to(torch.int8)
        return q.reshape(B * npg, page, Hkv, x.shape[-1]), \
            scale.reshape(B * npg)

    kq, ks = quantize_pages(k_new)
    vq, vs = quantize_pages(v_new)
    ids = cache["tables"][:, :npg].reshape(B * npg).long()
    cache["k"].index_copy_(0, ids, kq)
    cache["v"].index_copy_(0, ids, vq)
    cache["k_scale"].index_copy_(0, ids, ks)
    cache["v_scale"].index_copy_(0, ids, vs)
    cache["len"].fill_(L)
    return cache


def _append_token(pool: torch.Tensor, scales: torch.Tensor,
                  pid: torch.Tensor, slot: torch.Tensor,
                  tok: torch.Tensor) -> None:
    """Requantizing append of one ``(Hkv, D)`` token per sequence into page
    ``pid[b]`` at ``slot[b]``, in place.

    The page's new scale is ``max(old, |tok|/127)``; the existing int8
    payload rescales by ``old/new`` (identity when the token fits the old
    grid, and exactly 0 for a fresh page whose scale is 0 — stale bytes
    die here).  Only the touched pages are read and written.
    """
    old = pool[pid].float()                                 # (B, page, Hkv, D)
    old_sc = scales[pid]                                    # (B,)
    tokf = tok.float()                                      # (B, Hkv, D)
    new_sc = torch.maximum(
        old_sc, torch.clamp(tokf.abs().amax(dim=(1, 2)), min=_EPS) / _QMAX)
    rescaled = torch.clamp(torch.round(old * (old_sc / new_sc)[:, None, None,
                                                               None]),
                           -_QMAX, _QMAX).to(torch.int8)
    tok_q = torch.clamp(torch.round(tokf / new_sc[:, None, None]),
                        -_QMAX, _QMAX).to(torch.int8)
    rescaled[torch.arange(pid.shape[0], device=pid.device), slot] = tok_q
    pool.index_copy_(0, pid, rescaled)
    scales.index_copy_(0, pid, new_sc)


def paged_decode_insert(cache: Dict[str, torch.Tensor], k_new: torch.Tensor,
                        v_new: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Append one decode token ``(B, 1, Hkv, D)`` per sequence, in place.

    The target page/slot derives from the sequence length (``len //
    page``, ``len % page``) through the block table by tensor indexing, so
    neither the caller nor this function reads a page id to the host.
    """
    page = cache["k"].shape[1]
    lens = cache["len"].long()
    pid = cache["tables"].gather(1, (lens // page)[:, None])[:, 0] \
        .clamp(min=0).long()
    slot = lens % page
    _append_token(cache["k"], cache["k_scale"], pid, slot, k_new[:, 0])
    _append_token(cache["v"], cache["v_scale"], pid, slot, v_new[:, 0])
    cache["len"].add_(1)
    return cache


# ---------------------------------------------------------------------------
# Attention over the paged cache
# ---------------------------------------------------------------------------

def gather_kv(cache: Dict[str, torch.Tensor], dtype=torch.float32):
    """Dequantize the mapped pages into contiguous ``(B, NP*page, Hkv, D)``
    K/V plus a ``(B, NP*page)`` position array (-1 beyond ``len``).

    This materializes the dequantized cache — what the kernel exists to
    avoid — and serves as an oracle in the tests.
    """
    B, NP = cache["tables"].shape
    page = cache["k"].shape[1]
    ids = cache["tables"].clamp(min=0).long()
    k = cache["k"][ids].float() * cache["k_scale"][ids][..., None, None, None]
    v = cache["v"][ids].float() * cache["v_scale"][ids][..., None, None, None]
    S = NP * page
    k = k.reshape(B, S, *k.shape[3:]).to(dtype)
    v = v.reshape(B, S, *v.shape[3:]).to(dtype)
    pos = torch.arange(S, dtype=torch.int32, device=ids.device)[None, :]
    pos = torch.where(pos < cache["len"][:, None], pos, -1)
    return k, v, pos


def paged_attention(q: torch.Tensor, cache: Dict[str, torch.Tensor], *,
                    window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Decode attention of ``q`` (``(B, 1, H, D)``) against the paged
    cache through :func:`repro_torch.kernels.flash_attn.paged_flash_attention`
    (the kernel on a card, its plain version on the CPU); returns
    ``(B, 1, H, Dv)``.  The call first passes the dispatch preflight
    (:func:`repro_torch.analyze.preflight.preflight_attn`, memoized): q's
    decode shape, the page and the GQA ratio (KV005) and K2's plan within
    its shared memory (SMEM001) raise
    :class:`~repro_torch.analyze.ProgramValidationError` before any
    launch.  Every dispatch is recorded in the ledger (when enabled) with
    its planned KV bytes: mapped pages × page size, the route ``paged`` on
    the card, ``plain`` on the CPU."""
    page = cache["v"].shape[1]
    Hkv = cache["v"].shape[2]
    preflight_attn(q.shape, page, q.shape[2] if q.dim() == 4 else 0, Hkv,
                   head_dim=q.shape[-1], v_head_dim=cache["v"].shape[-1])
    out = paged_flash_attention(
        q[:, 0].contiguous(), cache["k"], cache["v"], cache["k_scale"], cache["v_scale"],
        cache["tables"], cache["len"], window=window, scale=scale)
    led = get_ledger()
    if led.enabled:
        B, _, H, D = q.shape
        led.record_attention(
            b=B, q_len=1, kv_len=cache["tables"].shape[1] * page, heads=H,
            kv_heads=Hkv, head_dim=D, v_head_dim=cache["v"].shape[-1],
            kv_dtype=cache["k"].dtype, q_dtype=q.dtype,
            tag="attn.paged_decode", page=page,
            mode="plain" if q.device.type == "cpu" else "paged")
    return out[:, None]


def pages_for(n_tokens: int, page_size: int) -> int:
    """Host-side ceil helper shared with
    :class:`repro_torch.kvcache.pool.PagePool`."""
    return -(-max(0, int(n_tokens)) // int(page_size))
