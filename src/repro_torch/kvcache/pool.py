"""Host-side page allocator (port of ``repro/kvcache/pool.py``): fixed-size
KV pages + per-sequence accounting.

The pool is deliberately plain Python with no torch dependency: allocation
is a free-list pop, release is a push, and every policy question the
serve engine asks at admission ("does this request fit?") is O(1)
arithmetic.  The *payload* of the pages lives on device
(:mod:`repro_torch.kvcache.paged`); the ids handed out here index that pool.

One page id maps to the same page slot in **every** layer's pool (the
per-layer payload arrays are stacked along a leading layer axis), so a
sequence's allocation is one list of ids regardless of model depth —
the block table is shared, the bytes are per-layer.
"""

from __future__ import annotations

from typing import Dict, List, Sequence


class PagePoolExhausted(RuntimeError):
    """An allocation asked for more pages than the free list holds."""


class PagePool:
    """Free-list allocator over ``n_pages`` pages of ``page_size`` tokens.

    Pages are handed out lowest-id-first (deterministic tests) and owned
    by a caller-chosen sequence key so double frees and leaked
    allocations are detectable — the reference's failure-isolation
    contract extends to KV memory.
    """

    def __init__(self, n_pages: int, page_size: int):
        if n_pages <= 0 or page_size <= 0:
            raise ValueError(f"PagePool needs positive geometry, got "
                             f"n_pages={n_pages} page_size={page_size} "
                             "[KV005]")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self._free: List[int] = list(range(self.n_pages - 1, -1, -1))
        self._owned: Dict[int, List[int]] = {}  # seq key -> page ids

    # -- sizing --------------------------------------------------------------

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return self.n_pages - len(self._free)

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` (ceil division)."""
        return -(-max(0, int(n_tokens)) // self.page_size)

    def can_admit(self, n_tokens: int) -> bool:
        """Would an ``alloc`` for ``n_tokens`` succeed right now?"""
        return self.pages_for(n_tokens) <= self.n_free

    # -- allocation ----------------------------------------------------------

    def alloc(self, seq: int, n_tokens: int) -> List[int]:
        """Allocate pages covering ``n_tokens`` to sequence key ``seq``.

        Raises :class:`PagePoolExhausted` (pool too small right now) or
        ``ValueError`` (``seq`` already holds pages — free first).
        """
        if seq in self._owned:
            raise ValueError(f"sequence {seq} already holds "
                             f"{len(self._owned[seq])} pages")
        need = self.pages_for(n_tokens)
        if need > self.n_free:
            raise PagePoolExhausted(
                f"need {need} pages for {n_tokens} tokens, "
                f"{self.n_free}/{self.n_pages} free")
        ids = [self._free.pop() for _ in range(need)]
        self._owned[seq] = ids
        return list(ids)

    def free(self, seq: int) -> List[int]:
        """Release all pages of ``seq`` back to the free list.

        Freeing a sequence that holds nothing is a no-op (a failed
        request may never have reached allocation) — the engine's
        try/finally release stays unconditional.
        """
        ids = self._owned.pop(seq, [])
        for pid in ids:
            self._free.append(pid)
        return ids

    def owned(self, seq: int) -> Sequence[int]:
        return tuple(self._owned.get(seq, ()))

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"PagePool(pages={self.n_pages}, page={self.page_size}, "
                f"free={self.n_free}, seqs={len(self._owned)})")
