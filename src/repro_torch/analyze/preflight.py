"""Dispatch preflight (port of ``repro/analyze/preflight.py``): run the
verifier once per resolved plan.

``core.gemm`` and ``kvcache.paged`` call these hooks after resolution and
before launching a kernel, as the tuning cache's lint does for persisted
entries.  Verdicts are memoized per (cache key, tile, operand metadata,
shape) under a lock, so the steady-state serve path pays one dict lookup;
a failing plan keeps failing from the memo: re-dispatching it re-raises
the same :class:`~repro_torch.analyze.diagnostics.ProgramValidationError`
without re-running the checks, and before any launch.

Fresh violations count in ``analyze.violations_total{code}`` of
:mod:`repro_torch.obs`.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.analyze import validate as _v
from repro_torch.analyze.diagnostics import Diagnostic, ProgramValidationError
from repro_torch.core.hardware import dtype_name
from repro_torch.obs import get_metrics

_LOCK = threading.Lock()
# memo key -> None (plan passed) | ProgramValidationError (plan rejected)
_VERDICTS: Dict[Tuple, Optional[ProgramValidationError]] = {}
_STATS = {"validated": 0, "hits": 0}


def _dtype_token(dtype) -> Optional[str]:
    if dtype is None or isinstance(dtype, str):
        return dtype
    return dtype_name(dtype)


def _check(memo_key: Tuple, run) -> None:
    """Memoized verdict for ``memo_key``; ``run`` produces diagnostics."""
    with _LOCK:
        if memo_key in _VERDICTS:
            _STATS["hits"] += 1
            verdict = _VERDICTS[memo_key]
            if verdict is not None:
                raise verdict
            return
    # Validate outside the lock: the checks are pure, and a racing
    # duplicate writes the same verdict twice.
    diags: Sequence[Diagnostic] = run()
    errors = [d for d in diags if d.severity == "error"]
    verdict = ProgramValidationError(errors) if errors else None
    if errors:
        _count(d.code for d in errors)
    with _LOCK:
        _STATS["validated"] += 1
        _VERDICTS[memo_key] = verdict
    if verdict is not None:
        raise verdict


def _count(codes) -> None:
    counter = get_metrics().counter(
        "analyze.violations_total",
        "programs rejected by the dispatch preflight, by diagnostic code")
    for code in codes:
        counter.labels(code=code).inc()


def preflight_gemm(key: str, tag: str, config, hw, *, dtype,
                   dtype_b=None, dtype_a=None,
                   semiring: str = "plus_times",
                   scale_block: int = 0, act_block: int = 0,
                   m: Optional[int] = None, n: Optional[int] = None,
                   k: Optional[int] = None, layout: str = "nn") -> None:
    """Verify a resolved GEMM plan; raise ``ProgramValidationError``.

    ``key`` is the registry resolution key (target, dtype, tag, layout
    and shape bucket); with the tile, scale blocks and the exact shape
    (the route's shared memory depends on it) it pins the verdict."""
    memo_key = ("gemm", key, tag,
                (config.bm, config.bn, config.bk, config.order),
                _dtype_token(dtype), _dtype_token(dtype_b),
                _dtype_token(dtype_a), semiring, scale_block, act_block,
                m, n, k, layout, hw.name)
    _check(memo_key, lambda: _v.validate_program(
        tag, config, hw, dtype=dtype, dtype_b=dtype_b, dtype_a=dtype_a,
        semiring=semiring, scale_block=scale_block, act_block=act_block,
        m=m, n=n, k=k, layout=layout))


def preflight_dist(schedule: str, mesh: Tuple[int, int, int],
                   shapes: Tuple[int, int, int], *, b_block: int = 0,
                   scale_rows: int = 0) -> None:
    """Verify distributed GEMM geometry (no caller until the port's
    distributed layer)."""
    mesh = tuple(int(x) for x in mesh)
    shapes = tuple(int(x) for x in shapes)
    memo_key = ("dist", schedule, mesh, shapes, int(b_block),
                int(scale_rows))
    _check(memo_key, lambda: _v.validate_dist(
        schedule, mesh, shapes, b_block=b_block, scale_rows=scale_rows))


def preflight_attn(q_shape: Sequence[int], page: int, n_heads: int,
                   kv_heads: int, head_dim: Optional[int] = None,
                   v_head_dim: Optional[int] = None) -> None:
    """Verify paged-attention call geometry (shapes, page, GQA and, with
    the head dims, K2's shared memory)."""
    q_shape = tuple(int(d) for d in q_shape)
    memo_key = ("attn", q_shape, int(page), int(n_heads), int(kv_heads),
                head_dim, v_head_dim)
    _check(memo_key, lambda: _v.validate_paged_dispatch(
        q_shape=q_shape, page=page, n_heads=n_heads, kv_heads=kv_heads,
        head_dim=head_dim, v_head_dim=v_head_dim))


def preflight_stats() -> Dict[str, int]:
    """Copy of the memo counters (``validated`` fresh runs, ``hits``)."""
    with _LOCK:
        return dict(_STATS)


def reset_preflight() -> None:
    """Drop all memoized verdicts and zero the counters."""
    with _LOCK:
        _VERDICTS.clear()
        _STATS["validated"] = 0
        _STATS["hits"] = 0
