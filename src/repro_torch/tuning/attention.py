"""Attention blocking (port of ``repro/tuning/attention.py``), analytic
tier only.

For the paged decode kernel the kv block *is* the page size: one page is
the unit the kernel streams, so choosing it chooses the pool's geometry.
The reference resolves it through its registry — a persistent cache entry,
then an autotune of the real kernel, then the analytic default of
``_analytic_config("paged_decode", ...)``.  The port computes that
analytic default only; the cache and autotune tiers wait for the registry
(ROADMAP queue 1, item 4), and so do the flash blocking and
``warmup_attention``.
"""

from __future__ import annotations

# Page sizes the paged cache is tuned over (the reference's
# ``_PAGE_CANDIDATES``): 16 keeps tiny-context pools from wasting 8x their
# payload, 256 caps the page a kernel step stages.
_PAGE_CANDIDATES = (16, 32, 64, 128, 256)


def resolve_page_size(seq_len: int) -> int:
    """The analytic page size for a paged decode cache of contexts up to
    ``seq_len`` tokens: lane width (128) at most, no larger than about a
    quarter of the context rounded up to a power of two (ragged-tail waste
    and pool granularity), rounded down to a candidate.  The reference
    keys its registry by the head geometry too; its analytic rule does not
    read it."""
    bucket = 1 << max(0, seq_len - 1).bit_length()
    page = min(128, max(16, bucket // 4))
    return max(p for p in _PAGE_CANDIDATES if p <= page)
