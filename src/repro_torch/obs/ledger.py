"""GEMM ledger (port of ``repro/obs/ledger.py``): what every dispatched
GEMM *planned* to move and compute.

:mod:`repro_torch.core.gemm` records every ``ca_matmul`` /
``ca_glu_matmul`` / expert-loop dispatch here: shape, program tag,
composite dtype, the tile the registry resolved and where it came from
(cache/autotune/analytic), the route that ran (``decode``/``wgmma``/
``simt`` on the card, ``plain`` on the CPU), planned HBM bytes (the
itemsize-split Eq. 6 program extension of :mod:`repro_torch.core.io_model`
at that tile) and planned flops.  :mod:`repro_torch.kvcache.paged` records
each paged decode attention the same way, and
:mod:`repro_torch.core.distributed` each ``dist_matmul`` dispatch with its
planned wire bytes (:class:`DistRecord`).  The records aggregate per
*step* (a prefill, a decode step, a train step), so achieved GB/s against
the plan and the model error (measured over planned seconds) are queryable
per workload.

The port runs eagerly, so every step records its own dispatches.
:meth:`GemmLedger.step` still replays the label's last recorded program
for a step that records none (the reference's jitted steps record only
when they trace).  A step's ``gemm_calls`` counts GEMM records only;
attention records count in ``attn_calls`` (their bytes join the step's
planned bytes).

Disabled (the default), the ``core.gemm`` hook is one attribute check:
no allocation, no string.  Enable with ``REPRO_TORCH_LEDGER=1`` or
:func:`enable_ledger`.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Any, Dict, List, Optional

from repro_torch.core.hardware import H100, HopperTarget, dtype_name, itemsize
from repro_torch.core.io_model import TileConfig, epilogue_q_elements

_ENV_LEDGER = "REPRO_TORCH_LEDGER"

# Dequant scale vectors are fp32 and charged at 4 B/element no matter how
# narrow the GEMM operands are (io_model's convention); prologue operand
# streams ride the A/B streams at the serve itemsize, exactly as
# ``bench_gemm.run_glu`` charges ``io_volume_elements_program``.
_SCALE_ITEMSIZE = 4.0


def planned_gemm_bytes(m: int, n: int, k: int, tile: TileConfig, tag: str,
                       *, itemsize_in: int, itemsize_b: Optional[int] = None,
                       itemsize_a: Optional[int] = None,
                       itemsize_out: Optional[int] = None,
                       scale_a_elements: int = 0,
                       scale_b_elements: int = 0) -> float:
    """Planned HBM traffic (bytes) of one program-tagged GEMM.

    The itemsize-split composition of the :mod:`repro_torch.core.io_model`
    pieces (the reference's, term for term): the per-operand Eq. 6 stream
    terms of :func:`io_volume_bytes` generalized to ``n_b`` branches /
    ``n_out`` outputs / prologue streams exactly as
    :func:`io_volume_elements_program` does element-wise, plus the fused
    epilogue's operand reads (:func:`epilogue_q_elements`, charged at the
    serve itemsize) and the fp32 dequant-scale reads (4 B/element).  On
    a single-branch uniform-dtype tag this reduces to
    ``io_volume_elements(...) * itemsize``; with ``dqab`` itemsizes it
    reduces to ``io_volume_bytes(a=1, b=1) + scales``.  At a decode step
    (``m <= tile.bm``) the B term is exactly the weights' bytes; the A
    term re-reads the activation once per ``tile.bn`` columns.
    """
    from repro_torch.kernels.program import program_cost  # lazy: avoid cycles

    cost = program_cost(tag)
    ib = itemsize_in if itemsize_b is None else itemsize_b
    ia = itemsize_in if itemsize_a is None else itemsize_a
    io = itemsize_in if itemsize_out is None else itemsize_out
    x = min(tile.bm, m)
    y = min(tile.bn, n)
    core = (cost.n_out * m * n * io
            + m * n * k * ((cost.n_b * ib + cost.prologue_kn * itemsize_in) / x
                           + (ia + cost.prologue_mk * itemsize_in) / y))
    vec = itemsize_in * (m + k) if cost.prologue_vec else 0.0
    epi = epilogue_q_elements(m, n, cost.stream_mn,
                              cost.has_bias) * itemsize_in
    scales = _SCALE_ITEMSIZE * epilogue_q_elements(
        m, n, scale_a_elements=scale_a_elements,
        scale_b_elements=scale_b_elements)
    return core + vec + epi + scales


def planned_attn_kv_bytes(b: int, kv_len: int, kv_heads: int, head_dim: int,
                          v_head_dim: int, *, kv_itemsize: float,
                          page: int = 0) -> float:
    """Planned HBM bytes an attention dispatch streams from the KV cache.

    The decode-bound stream: every kv token's K and V rows once per
    batch element at the cache's storage itemsize, plus (paged caches)
    the two fp32 per-page scale reads.  Queries/outputs are one token
    and charged nowhere (the reference's accounting: a slab-vs-paged
    comparison is then a pure KV-stream ratio).
    """
    core = float(b) * kv_len * kv_heads * (head_dim + v_head_dim) * kv_itemsize
    if page:
        core += 2.0 * _SCALE_ITEMSIZE * b * (-(-kv_len // page))
    return core


@dataclasses.dataclass(frozen=True)
class AttnRecord:
    """One dispatched attention program.

    Shares the ledger's record list with :class:`GemmRecord` — the step
    replay and :meth:`GemmLedger.aggregate` machinery only touch the
    duck-typed subset (``key``/``calls``/``planned_*``/``config_source``),
    so attention dispatches ride the same per-step accounting as GEMMs.
    """

    b: int
    q_len: int
    kv_len: int
    heads: int
    kv_heads: int
    head_dim: int
    v_head_dim: int
    tag: str                    # attn.paged_decode | attn.flash | ...
    dtype: str                  # composite kv/q storage dtypes
    mode: str                   # route that ran (paged) | plain
    config: Dict[str, Any]      # q_block/kv_block (page) of the dispatch
    config_source: str
    planned_bytes: float
    planned_flops: float
    planned_s: float
    calls: int = 1

    @property
    def key(self) -> str:
        return (f"{self.tag}|{self.dtype}|b{self.b}|"
                f"q{self.q_len}xkv{self.kv_len}|"
                f"h{self.heads}kv{self.kv_heads}d{self.head_dim}")

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class DistRecord:
    """One dispatched distributed GEMM (``core.distributed.dist_matmul``).

    Rides the ledger's record list like :class:`AttnRecord` (the
    duck-typed ``key``/``calls``/``planned_*``/``config_source`` subset).
    ``planned_bytes`` here is the schedule's planned **wire** traffic per
    rank, the Eq. 6 analog ``estimate_cost`` computes, not HBM bytes;
    ``planned_s`` is the per-step pipelined overlap model's time.
    """

    m: int
    n: int
    k: int
    schedule: str               # allgather | ring | ring_unpipelined | ...
    steps: int                  # ring steps (1 for allgather)
    mesh: str                   # "dp2.tp4" / "dp2.tp2.pods2"
    tag: str                    # local-step program tag (none|dqb|dqab)
    dtype: str                  # composite for quant rides
    mode: str                   # local step's route: plain | decode | ...
    config: Dict[str, Any]      # local tile + (mloc, nloc, kstep)
    config_source: str          # cache | autotune | analytic
    planned_bytes: float        # planned comm bytes (Eq. 6 analog)
    planned_flops: float        # global 2mnk
    planned_s: float            # pipelined overlap model seconds
    calls: int = 1

    @property
    def key(self) -> str:
        return (f"dist.{self.schedule}|{self.tag}|{self.dtype}|"
                f"{self.m}x{self.n}x{self.k}|{self.mesh}")

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class GemmRecord:
    """One dispatched GEMM program (``calls`` folds an expert loop)."""

    m: int
    n: int
    k: int
    tag: str
    layout: str
    dtype: str                  # composite for quant ("int8w_bf16a", ...)
    mode: str                   # route: decode | wgmma | simt | plain
    config: Dict[str, Any]      # bm/bn/bk/order of the resolved tile
    config_source: str          # cache | autotune | analytic
    planned_bytes: float
    planned_flops: float
    planned_s: float            # roofline seconds under the plan
    calls: int = 1

    @property
    def key(self) -> str:
        return (f"{self.tag}|{self.layout}|{self.dtype}|"
                f"{self.m}x{self.n}x{self.k}")

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class _StepHandle:
    """Context for one measured step: wall time + the records inside."""

    def __init__(self, ledger: "GemmLedger", label: str):
        self.ledger = ledger
        self.label = label
        self.records: List[GemmRecord] = []
        self.measured_s = 0.0
        self._start_idx = 0
        self._t0 = 0.0

    def __enter__(self):
        self._start_idx = self.ledger._mark()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, *exc):
        self.measured_s = time.perf_counter() - self._t0
        if exc_type is None:
            self.ledger._finish_step(self)
        return False


class GemmLedger:
    """Thread-safe record store + per-step aggregation."""

    def __init__(self, enabled: bool = False, hw: HopperTarget = H100):
        self.enabled = enabled
        self.hw = hw
        self._lock = threading.RLock()
        self._records: List[GemmRecord] = []
        # label -> replayable program (the records of the last step under
        # that label that recorded any) and accumulated per-label totals.
        self._programs: Dict[str, List[GemmRecord]] = {}
        self._steps: Dict[str, Dict[str, float]] = {}

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        with self._lock:
            self._records.clear()
            self._programs.clear()
            self._steps.clear()

    # -- recording (called from repro_torch.core.gemm dispatch) -------------

    def record_gemm(self, m: int, n: int, k: int, dtype, *, tag: str,
                    layout: str = "nn", mode: str = "plain",
                    hw: Optional[HopperTarget] = None,
                    dtype_b=None, dtype_a=None, out_dtype=None,
                    scale_a_elements: int = 0, scale_b_elements: int = 0,
                    calls: int = 1,
                    resolution=None) -> Optional[GemmRecord]:
        """Resolve the plan (unless the caller already has a
        ``Resolution``) and append one record.  No-op when disabled."""
        if not self.enabled or m <= 0 or n <= 0 or k <= 0:
            return None
        from repro_torch.kernels.program import program_cost  # lazy
        from repro_torch.quant.scales import quant_dtype_str

        hw = hw or self.hw
        if resolution is None:
            from repro_torch.tuning import get_registry  # lazy: imports kernels

            resolution = get_registry().resolve_full(
                m, n, k, dtype=dtype, hw=hw, epilogue=tag, layout=layout,
                dtype_b=dtype_b, dtype_a=dtype_a)
        tile = resolution.config
        ib = itemsize(dtype_b) if dtype_b is not None else None
        ia = itemsize(dtype_a) if dtype_a is not None else None
        io = itemsize(out_dtype) if out_dtype is not None else None
        planned_bytes = planned_gemm_bytes(
            m, n, k, tile, tag, itemsize_in=itemsize(dtype), itemsize_b=ib,
            itemsize_a=ia, itemsize_out=io,
            scale_a_elements=scale_a_elements,
            scale_b_elements=scale_b_elements)
        planned_flops = 2.0 * m * n * k * program_cost(tag).n_b
        # Roofline under the plan: the w8a8 (dqab) programs contract at
        # the int8 tensor-core rate, everything else at the serve dtype's.
        int8 = "int8"
        compute_dtype = int8 if (
            dtype_a is not None and dtype_name(dtype_a) == int8
            and dtype_b is not None and dtype_name(dtype_b) == int8) \
            else dtype
        planned_s = max(planned_flops / hw.peak_flops(compute_dtype),
                        planned_bytes / hw.hbm_bandwidth)
        if dtype_b is not None:
            dtype_str = quant_dtype_str(
                dtype_a if dtype_a is not None else dtype, dtype_b)
        else:
            dtype_str = dtype_name(dtype)
        rec = GemmRecord(
            m=int(m), n=int(n), k=int(k), tag=tag, layout=layout,
            dtype=dtype_str, mode=mode,
            config={"bm": tile.bm, "bn": tile.bn, "bk": tile.bk,
                    "order": tile.order},
            config_source=resolution.source,
            planned_bytes=float(planned_bytes),
            planned_flops=float(planned_flops),
            planned_s=float(planned_s), calls=int(calls))
        with self._lock:
            self._records.append(rec)
        from repro_torch.obs.metrics import get_metrics

        get_metrics().counter(
            "gemm.ledger_records_total",
            "GEMM dispatches recorded by the ledger").labels(
                source=resolution.source).inc()
        return rec

    def record_attention(self, *, b: int, q_len: int, kv_len: int,
                         heads: int, kv_heads: int, head_dim: int,
                         v_head_dim: int, kv_dtype, q_dtype,
                         tag: str = "attn.flash", mode: str = "plain",
                         page: int = 0, config: Optional[Dict[str, Any]] = None,
                         config_source: str = "analytic",
                         hw: Optional[HopperTarget] = None,
                         calls: int = 1) -> Optional["AttnRecord"]:
        """Append one attention dispatch record.  No-op when disabled.

        ``kv_len`` is what the kernel streams (for paged caches, mapped
        pages × page size, padding included); ``page`` > 0 additionally
        charges the fp32 per-page scale reads.
        """
        if not self.enabled or b <= 0 or kv_len <= 0:
            return None
        hw = hw or self.hw
        planned_bytes = planned_attn_kv_bytes(
            b, kv_len, kv_heads, head_dim, v_head_dim,
            kv_itemsize=itemsize(kv_dtype), page=page)
        # QK^T + PV over the full streamed window, fp32 accumulate.
        planned_flops = 2.0 * b * heads * q_len * kv_len * (head_dim
                                                            + v_head_dim)
        planned_s = max(planned_flops / hw.peak_flops(q_dtype),
                        planned_bytes / hw.hbm_bandwidth)
        dtype_str = f"{dtype_name(kv_dtype)}kv_{dtype_name(q_dtype)}q"
        rec = AttnRecord(
            b=int(b), q_len=int(q_len), kv_len=int(kv_len), heads=int(heads),
            kv_heads=int(kv_heads), head_dim=int(head_dim),
            v_head_dim=int(v_head_dim), tag=tag, dtype=dtype_str, mode=mode,
            config=dict(config or ({"page": page} if page else {})),
            config_source=config_source,
            planned_bytes=float(planned_bytes),
            planned_flops=float(planned_flops),
            planned_s=float(planned_s), calls=int(calls))
        with self._lock:
            self._records.append(rec)
        from repro_torch.obs.metrics import get_metrics

        get_metrics().counter(
            "attn.ledger_records_total",
            "Attention dispatches recorded by the ledger").labels(
                tag=tag, mode=mode).inc()
        return rec

    def record_dist(self, *, schedule: str, m: int, n: int, k: int,
                    dp: int, tp: int, pods: int = 1, dtype,
                    dtype_b=None, dtype_a=None, tag: str = "none",
                    mode: str = "plain", steps: int = 1,
                    config: Optional[Dict[str, Any]] = None,
                    config_source: str = "analytic",
                    planned_bytes: float = 0.0, planned_flops: float = 0.0,
                    planned_s: float = 0.0,
                    hw: Optional[HopperTarget] = None,
                    calls: int = 1) -> Optional["DistRecord"]:
        """Append one distributed-GEMM dispatch record.  No-op when
        disabled.  The caller (``core.distributed``) passes the planned
        comm bytes and overlap time straight from its ``estimate_cost``,
        so record and cost model cannot drift."""
        if not self.enabled or m <= 0 or n <= 0 or k <= 0:
            return None
        from repro_torch.quant.scales import quant_dtype_str

        if dtype_b is not None:
            dtype_str = quant_dtype_str(
                dtype_a if dtype_a is not None else dtype, dtype_b)
        else:
            dtype_str = dtype_name(dtype)
        mesh = f"dp{dp}.tp{tp}" + (f".pods{pods}" if pods > 1 else "")
        rec = DistRecord(
            m=int(m), n=int(n), k=int(k), schedule=schedule,
            steps=int(steps), mesh=mesh, tag=tag, dtype=dtype_str,
            mode=mode, config=dict(config or {}),
            config_source=config_source,
            planned_bytes=float(planned_bytes),
            planned_flops=float(planned_flops),
            planned_s=float(planned_s), calls=int(calls))
        with self._lock:
            self._records.append(rec)
        from repro_torch.obs.metrics import get_metrics

        get_metrics().counter(
            "dist.ledger_records_total",
            "Distributed GEMM dispatches recorded by the ledger").labels(
                schedule=schedule, source=config_source).inc()
        return rec

    # -- step aggregation ----------------------------------------------------

    def step(self, label: str) -> _StepHandle:
        """Measure one step: wall-times the ``with`` body and attributes
        the dispatches recorded inside it (or, for a step that recorded
        none, the label's last recorded program) to the per-label
        aggregate.  The body should end in the step's own read to the
        host (the sampled token), so the wall covers the device's work."""
        return _StepHandle(self, label)

    def _mark(self) -> int:
        with self._lock:
            return len(self._records)

    def _finish_step(self, handle: _StepHandle) -> None:
        if not self.enabled:
            return
        with self._lock:
            fresh = self._records[handle._start_idx:]
            if fresh:
                self._programs[handle.label] = list(fresh)
            program = self._programs.get(handle.label, [])
            handle.records = program
            agg = self._steps.setdefault(handle.label, {
                "steps": 0, "measured_s": 0.0, "planned_bytes": 0.0,
                "planned_flops": 0.0, "planned_s": 0.0, "gemm_calls": 0,
                "attn_calls": 0})
            agg["steps"] += 1
            agg["measured_s"] += handle.measured_s
            agg["planned_bytes"] += sum(r.planned_bytes * r.calls
                                        for r in program)
            agg["planned_flops"] += sum(r.planned_flops * r.calls
                                        for r in program)
            agg["planned_s"] += sum(r.planned_s * r.calls for r in program)
            agg["gemm_calls"] += sum(r.calls for r in program
                                     if isinstance(r, GemmRecord))
            agg["attn_calls"] += sum(r.calls for r in program
                                     if isinstance(r, AttnRecord))

    # -- queries -------------------------------------------------------------

    @property
    def records(self) -> List[GemmRecord]:
        with self._lock:
            return list(self._records)

    def aggregate(self) -> Dict[str, Dict[str, float]]:
        """Per (tag, layout, dtype, shape) totals over all records."""
        out: Dict[str, Dict[str, float]] = {}
        for r in self.records:
            agg = out.setdefault(r.key, {
                "dispatches": 0, "calls": 0, "planned_bytes": 0.0,
                "planned_flops": 0.0, "config_sources": {}})
            agg["dispatches"] += 1
            agg["calls"] += r.calls
            agg["planned_bytes"] += r.planned_bytes * r.calls
            agg["planned_flops"] += r.planned_flops * r.calls
            srcs = agg["config_sources"]
            srcs[r.config_source] = srcs.get(r.config_source, 0) + 1
        return out

    def steps_summary(self) -> Dict[str, Dict[str, float]]:
        """Per-label step totals with achieved-vs-planned derived rates:
        ``achieved_gbps`` (planned bytes over measured wall) and
        ``model_error`` (measured / planned seconds)."""
        with self._lock:
            out = {}
            for label, agg in self._steps.items():
                d = dict(agg)
                if d["measured_s"] > 0:
                    d["achieved_gbps"] = d["planned_bytes"] / d["measured_s"] / 1e9
                    d["achieved_gflops"] = (d["planned_flops"]
                                            / d["measured_s"] / 1e9)
                if d["planned_s"] > 0 and d["measured_s"] > 0:
                    d["model_error"] = d["measured_s"] / d["planned_s"]
                out[label] = d
            return out

    def snapshot(self) -> Dict[str, Any]:
        return {
            "enabled": self.enabled,
            "n_records": len(self.records),
            "records": [r.to_dict() for r in self.records],
            "aggregate": self.aggregate(),
            "steps": self.steps_summary(),
        }


# ---------------------------------------------------------------------------
# Process-global instance
# ---------------------------------------------------------------------------

_global_lock = threading.Lock()
_global: Optional[GemmLedger] = None


def get_ledger() -> GemmLedger:
    global _global
    with _global_lock:
        if _global is None:
            _global = GemmLedger(
                enabled=os.environ.get(_ENV_LEDGER, "0") == "1")
        return _global


def set_ledger(ledger: Optional[GemmLedger]) -> None:
    """Install (or with ``None`` reset) the process-global ledger."""
    global _global
    with _global_lock:
        _global = ledger


def enable_ledger() -> GemmLedger:
    led = get_ledger()
    led.enable()
    return led


def reset_ledger() -> None:
    set_ledger(None)
