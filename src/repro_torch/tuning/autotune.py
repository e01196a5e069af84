"""Empirical autotuner (port of ``repro/tuning/autotune.py``): time the
model's candidates, keep the winner.

The space (:mod:`.space`) nominates candidates, the roofline
(:func:`repro_torch.core.io_model.gemm_roofline`) supplies a prior on each
candidate's runtime, and this module measures, best prior first, so early
stopping is sound: stop when the measured best is within
``early_stop_factor`` of the best prior, or after ``patience`` candidates
without improvement.

:func:`time_tile` times the real kernel variant on the card with CUDA
events (the median of ``iters`` timed calls after ``warmup`` untimed
ones); it refuses to run without one.  On the CPU the tuning loop is
reached only through a ``timer`` the caller supplies.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.hardware import H100, HopperTarget, as_dtype, dtype_name
from repro_torch.core.io_model import TileConfig, gemm_roofline
from repro_torch.tuning import space as tspace

DEFAULT_WARMUP = 1
DEFAULT_ITERS = 3


def _operand(shape, dtype: torch.dtype, gen: torch.Generator,
             device) -> torch.Tensor:
    """Random operand in ``dtype``: small integers for int8, normals for
    floats (drawn on the host from ``gen``, then moved)."""
    if dtype == torch.int8:
        t = torch.randint(-4, 5, shape, generator=gen, dtype=torch.int8)
    else:
        t = torch.randn(shape, generator=gen).to(dtype)
    return t.to(device)


def cuda_time_s(call: Callable[[], object], warmup: int = DEFAULT_WARMUP,
                iters: int = DEFAULT_ITERS) -> float:
    """Median seconds of ``call`` on the current CUDA stream, each timed
    between two CUDA events after ``warmup`` untimed calls."""
    for _ in range(max(0, warmup)):
        call()
    times = []
    for _ in range(max(1, iters)):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        call()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e-3)
    times.sort()
    return times[len(times) // 2]


def time_tile(
    m: int,
    n: int,
    k: int,
    tile: TileConfig,
    dtype=torch.bfloat16,
    semiring: str = "plus_times",
    warmup: int = DEFAULT_WARMUP,
    iters: int = DEFAULT_ITERS,
    epilogue: str = "none",
    layout: str = "nn",
    dtype_b=None,
    dtype_a=None,
) -> float:
    """Median seconds of one K1 launch under ``tile`` on the card.

    ``epilogue`` (a full program tag) and ``layout`` time the variant the
    config will serve: bias/gate/residual operands for fused drain
    stages, a second B for two-branch programs, rms scales or a saved
    preact for prologues, transposed storage for 'nt'/'tn'.  ``dtype_b``
    (with a ``dq*`` stage) streams an int8 B with per-channel scales;
    ``dtype_a`` (with ``dqab``) an int8 A with per-row scales.  The launch
    checks ``tile`` against its route's (``ca_mmm.route_tile``).  Operands
    are drawn from a ``torch.Generator`` seeded with 0.
    """
    from repro_torch.kernels import ca_mmm as K
    from repro_torch.kernels.program import (program_from_tag,
                                             synthetic_operands)

    if not torch.cuda.is_available():
        raise RuntimeError("time_tile times the kernel on a CUDA card; on "
                           "the CPU give autotune_gemm a timer")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    dtype = as_dtype(dtype)
    a_dtype = as_dtype(dtype_a) if dtype_a is not None else dtype
    b_dtype = as_dtype(dtype_b) if dtype_b is not None else dtype
    if tile.order == "k_outer":
        if epilogue != "none" or layout != "nn":
            raise ValueError(f"k_outer cannot time epilogue={epilogue!r}/"
                             f"layout={layout!r}")
        a = _operand((m, k), dtype, gen, dev)
        b = _operand((k, n), dtype, gen, dev)
        # The ablation kernel takes tile-divisible shapes: pad up.
        bm, bn, bk = (min(tile.bm, -(-m // 8) * 8),
                      min(tile.bn, -(-n // 128) * 128),
                      min(tile.bk, -(-k // 128) * 128))
        ap = torch.nn.functional.pad(a, (0, -k % bk, 0, -m % bm))
        bp = torch.nn.functional.pad(b, (0, -n % bn, 0, -k % bk))

        def call():
            return K.ca_mmm_k_outer(ap, bp, bm=bm, bn=bn, bk=bk)  # repro: noqa RPR001 -- the tuner times the kernel itself
        return cuda_time_s(call, warmup, iters)

    prog = program_from_tag(epilogue)
    ta, tb = layout[0] == "t", layout[1] == "t"
    a = _operand((k, m) if ta else (m, k), a_dtype, gen, dev)
    bs = tuple(_operand((n, k) if tb else (k, n), b_dtype, gen, dev)
               for _ in range(prog.n_b))
    pro = synthetic_operands(epilogue, m, n, k, dtype, generator=gen,
                             device=dev)
    branch_ops = []
    for bspec in prog.branches:
        d = {}
        if bspec.has_bias:
            d["bias"] = _operand((n,), dtype, gen, dev)
        if bspec.has_mul:
            d["mul"] = _operand((m, n), dtype, gen, dev)
        if bspec.has_residual:
            d["residual"] = _operand((m, n), dtype, gen, dev)
        if bspec.dequant != "none":
            d["scale_b"] = torch.full((n,), 0.02, device=dev)
        if bspec.dequant == "ab":
            d["scale_a"] = torch.full((m,), 0.02, device=dev)
        branch_ops.append(d)

    def call():
        return K.ca_gemm_program(  # repro: noqa RPR001 -- the tuner times the kernel itself
            a, bs, spec=prog, semiring=semiring, transpose_a=ta,
            transpose_b=tb, row_scale=pro.get("row_scale"),
            gain=pro.get("gain"), preact=pro.get("preact"),
            branch_operands=branch_ops, tile=tile)
    return cuda_time_s(call, warmup, iters)


@dataclasses.dataclass(frozen=True)
class TuneResult:
    """Winner + provenance for one GEMM signature."""

    config: TileConfig
    measured_s: float
    predicted_s: float           # roofline prior of the winner
    n_tried: int
    trials: Tuple[Tuple[TileConfig, float], ...] = ()
    early_stopped: bool = False


def autotune_gemm(
    m: int,
    n: int,
    k: int,
    dtype=torch.bfloat16,
    semiring: str = "plus_times",
    hw: HopperTarget = H100,
    candidates: Optional[Sequence[TileConfig]] = None,
    max_candidates: int = tspace.DEFAULT_TOP_N,
    orders: Sequence[str] = ("k_inner",),
    patience: int = 3,
    early_stop_factor: float = 1.10,
    warmup: int = DEFAULT_WARMUP,
    iters: int = DEFAULT_ITERS,
    timer: Optional[Callable[[TileConfig], float]] = None,
    epilogue: str = "none",
    layout: str = "nn",
    dtype_b=None,
    dtype_a=None,
) -> TuneResult:
    """Measure model-nominated candidates; return the fastest.

    ``timer`` injects a measurement function (tests supply one on the
    CPU); without one each candidate runs through :func:`time_tile` on
    the card.  Candidates are measured best-prior-first.
    """
    if candidates is None:
        candidates = tspace.candidate_tile_configs(
            m, n, k, dtype_in=dtype, hw=hw, top_n=max_candidates,
            orders=orders, semiring=semiring, epilogue=epilogue,
            dtype_b=dtype_b, dtype_a=dtype_a, layout=layout)
    if epilogue != "none" or layout != "nn":
        # k_outer has no fused/transposed variant: a plain-GEMM proxy
        # must not win a fused/transposed key.
        candidates = [c for c in candidates if c.order != "k_outer"]
    if not candidates:
        raise ValueError(f"no legal tile candidates for {(m, n, k)}")

    if timer is None:
        def timer(tile: TileConfig) -> float:
            return time_tile(m, n, k, tile, dtype=dtype, semiring=semiring,
                             warmup=warmup, iters=iters, epilogue=epilogue,
                             layout=layout, dtype_b=dtype_b, dtype_a=dtype_a)

    # Roofline prior orders the measurements; a k_outer schedule re-reads
    # the C tile per k step, which the prior charges.
    def prior(tile: TileConfig) -> float:
        rl = gemm_roofline(m, n, k, tile, dtype, hw=hw)
        if tile.order == "k_outer":
            extra = (2.0 * m * n * (k // max(tile.bk, 1))
                     * as_dtype(dtype).itemsize) / hw.hbm_bandwidth
            return rl.time_s + extra
        return rl.time_s

    ranked = sorted(candidates, key=prior)
    best_prior = prior(ranked[0])

    from repro_torch.obs import get_metrics, span

    trials: List[Tuple[TileConfig, float]] = []
    best: Optional[Tuple[TileConfig, float]] = None
    since_improved = 0
    early = False
    t_tune = time.perf_counter()
    with span("tune.gemm", m=m, n=n, k=k, dtype=dtype_name(dtype),
              epilogue=epilogue, layout=layout, candidates=len(ranked)):
        for tile in ranked:
            with span("tune.trial", bm=tile.bm, bn=tile.bn, bk=tile.bk,
                      order=tile.order):
                t = float(timer(tile))
            trials.append((tile, t))
            if best is None or t < best[1]:
                best = (tile, t)
                since_improved = 0
            else:
                since_improved += 1
            if best[1] <= early_stop_factor * best_prior:
                early = True
                break
            if since_improved >= patience:
                early = True
                break

    metrics = get_metrics()
    metrics.counter("tuning.autotune_trials_total",
                    "Candidate tiles measured by the autotuner").inc(
                        len(trials))
    metrics.histogram("tuning.autotune_seconds",
                      "Wall time of one autotune_gemm call").observe(
                          time.perf_counter() - t_tune)

    return TuneResult(config=best[0], measured_s=best[1],
                      predicted_s=float(prior(best[0])),
                      n_tried=len(trials), trials=tuple(trials),
                      early_stopped=early)
