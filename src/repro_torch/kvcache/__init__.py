"""repro_torch.kvcache — paged, quantized KV cache (port of
``repro.kvcache``).

* :mod:`.pool`  — the host-side page allocator: fixed-size pages, a free
  list, per-sequence accounting.
* :mod:`.paged` — the device-side cache dict (int8 page payloads +
  per-page fp32 scales + block tables) with prefill bulk-insert,
  requantizing decode append and decode attention, all writing the pool
  in place.

The decode-attention kernel itself lives in
:mod:`repro_torch.kernels.flash_attn` (``paged_flash_attention``); the
pool's page size resolves through :mod:`repro_torch.tuning.attention`.
"""

from repro_torch.kvcache.paged import (gather_kv, is_paged, make_paged_cache,
                                       model_assign_sequence,
                                       model_release_sequence, pages_for,
                                       paged_attention, paged_decode_insert,
                                       paged_prefill_insert)
from repro_torch.kvcache.pool import PagePool, PagePoolExhausted

__all__ = [
    "PagePool", "PagePoolExhausted",
    "is_paged", "make_paged_cache", "gather_kv",
    "paged_prefill_insert", "paged_decode_insert", "paged_attention",
    "model_assign_sequence", "model_release_sequence", "pages_for",
]
