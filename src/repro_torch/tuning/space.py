"""Candidate tile-config generation (port of ``repro/tuning/space.py``),
pruned by the paper's analytic model and parameterized over the target.

The empirical tuner does not search blindly: the I/O model ranks tile
shapes by effective intensity under the fast-memory capacity constraint,
so the search space is *the model's top-N*, not a grid sweep.

On a target whose kernels run fixed tiles (``hw.route_tiles``, the H100)
the candidates for a K1 launch are the tiles its route instantiates: the
route :func:`repro_torch.kernels.ca_mmm.k1_route` gives for the program,
layout, dtypes and shape (operand rows assumed 16-byte aligned where their
widths allow it, as contiguous tensors are), and that route's tile
(:func:`~repro_torch.kernels.ca_mmm.route_tile`).  A tile the kernel
cannot run is never a candidate.

On any other target (the CPU parity tests build one from the reference's
TPU constants) every emitted candidate is legal by construction, as in the
reference:

* ``bm % qm == 0``, ``bn % qn == 0``, ``bk % qk == 0`` for the dtype's
  quanta (Eq. 8 analog);
* ``tile_vmem_bytes(...) <= vmem_fraction * hw.fast_bytes``;
* min-plus candidates additionally keep an O(bm*bk*bn) broadcast inside
  the budget.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import torch

from repro_torch.core.hardware import H100, HopperTarget, as_dtype, itemsize
from repro_torch.core.io_model import (TileConfig, effective_intensity,
                                       io_lower_bound_elements,
                                       io_volume_elements, round_up_to,
                                       solve_tile_config, tile_vmem_bytes,
                                       vmem_quantum)

DEFAULT_TOP_N = 8
DEFAULT_BK_CANDIDATES = (128, 256, 512, 1024, 2048)


def _geometric_multiples(quantum: int, cap: int) -> List[int]:
    """quantum * 2^i up to cap, always including cap rounded to quantum."""
    vals = []
    v = quantum
    while v <= cap:
        vals.append(v)
        v *= 2
    capped = max(quantum, (cap // quantum) * quantum)
    if capped not in vals:
        vals.append(capped)
    return vals


def _min_plus_vmem_ok(bm: int, bn: int, bk: int, budget: int) -> bool:
    # The reference's tropical kernel broadcasts (bm, bk, bn) fp32.
    return bm * bk * bn * 4 <= budget


def _rows_aligned(m: int, n: int, k: int, layout: str, a_dtype, b_dtype,
                  cost) -> bool:
    """Whether contiguous operands of this GEMM meet TMA's 16-byte row
    rule (their bases are, as fresh allocations)."""
    rows = [(m if layout[0] == "t" else k) * itemsize(a_dtype),
            (k if layout[1] == "t" else n) * itemsize(b_dtype)]
    if cost.prologue_mk:
        rows.append(k * 4)
    if cost.prologue_kn:
        rows.append(n * 4)
    return all(r % 16 == 0 for r in rows)


def _route_candidates(m, n, k, dtype_in, dtype_acc, hw, vmem_fraction,
                      orders, semiring, epilogue, layout, dtype_b, dtype_a,
                      cost) -> List[TileConfig]:
    """The one tile the launch's route runs, for each k-inner order (the
    K1 routes are all k-inner; the k-outer ablation keeps its own)."""
    from repro_torch.kernels import ca_mmm  # lazy: kernels import tuning
    from repro_torch.kernels.program import program_from_tag

    spec = program_from_tag(epilogue)
    a_dtype = as_dtype(dtype_a if dtype_a is not None else dtype_in)
    b_dtype = as_dtype(dtype_b if dtype_b is not None else dtype_in)
    aligned = _rows_aligned(m, n, k, layout, a_dtype, b_dtype, cost)
    route = ca_mmm.k1_route(spec, layout, a_dtype, b_dtype, m, n, k,
                            aligned, semiring)
    bm, bn, bk = ca_mmm.route_tile(route, spec, a_dtype, m, layout)
    itemsize_in = itemsize(dtype_in)
    acc_bytes = itemsize(dtype_acc)
    vb = tile_vmem_bytes(bm, bn, bk, itemsize_in, acc_bytes,
                         epilogue_mn_ops=cost.stream_mn,
                         epilogue_bias=cost.has_bias,
                         itemsize_b=itemsize(b_dtype),
                         itemsize_a=itemsize(a_dtype), n_b=cost.n_b,
                         n_out=cost.n_out, prologue_mk_ops=cost.prologue_mk,
                         prologue_kn_ops=cost.prologue_kn)
    budget = int(hw.fast_bytes * vmem_fraction)
    return [TileConfig(
        bm=bm, bn=bn, bk=bk, order=order, vmem_bytes=vb,
        intensity=effective_intensity(bm, bn, bk, itemsize_in),
        q_elements=io_volume_elements(m, n, k, min(bm, m), min(bn, n)),
        q_lower_bound=io_lower_bound_elements(
            m, n, k, budget // max(itemsize_in, acc_bytes)),
        utilization=vb / hw.fast_bytes) for order in orders
        if order == "k_inner"]


def candidate_tile_configs(
    m: int,
    n: int,
    k: int,
    dtype_in=torch.bfloat16,
    dtype_acc=torch.float32,
    hw: HopperTarget = H100,
    vmem_fraction: float = 0.75,
    top_n: int = DEFAULT_TOP_N,
    orders: Sequence[str] = ("k_inner",),
    semiring: str = "plus_times",
    max_block: int = 8192,
    bk_candidates: Iterable[int] = DEFAULT_BK_CANDIDATES,
    epilogue: str = "none",
    dtype_b=None,
    dtype_a=None,
    layout: str = "nn",
) -> List[TileConfig]:
    """Model-pruned candidate list, best-first by effective intensity.

    Returns up to ``top_n`` tile shapes (each crossed with ``orders``), the
    analytic :func:`solve_tile_config` answer always among them, so the
    tuner can never do worse than the pure model by construction.

    ``epilogue`` (a full *program tag* — prologue/combiner grammar
    included) charges the program's extra VMEM residents against the same
    budget: one (bm, bn) tile per streamed gate/residual operand plus a
    bias row for a fused drain, a second B double-buffer **and** a second
    accumulator for dual-branch (GLU) programs, and an fp32 (bm, bk)
    stream buffer per dact-prologue operand — so every program variant's
    candidates are feasible by construction.

    ``dtype_b`` (mixed-precision GEMMs, e.g. int8 weights under bf16
    activations) shrinks the B stream buffers in the budget: a quantized
    kernel's feasible region is *wider* than the uniform-dtype one, and
    the candidates here exploit that instead of inheriting bf16 limits.
    ``dtype_a`` (the w8a8 path's int8 activation stream) does the same
    for the A double buffer; the accumulator stays 4 B/element (int32 is
    as wide as fp32), so only the stream terms shrink.

    ``layout`` ('nn'/'nt'/'tn', the port's addition) picks the route on a
    fixed-tile target; the solver's candidates do not depend on it.
    """
    from repro_torch.kernels.program import program_cost  # no cycle: leaf

    cost = program_cost(epilogue)
    if hw.route_tiles:
        return _route_candidates(m, n, k, dtype_in, dtype_acc, hw,
                                 vmem_fraction, orders, semiring, epilogue,
                                 layout, dtype_b, dtype_a, cost)
    epi_mn, epi_bias = cost.stream_mn, cost.has_bias
    n_b, n_out = cost.n_b, cost.n_out
    pro_mk, pro_kn = cost.prologue_mk, cost.prologue_kn
    itemsize_in = itemsize(dtype_in)
    itemsize_b = itemsize(dtype_b) if dtype_b is not None else itemsize_in
    itemsize_a = itemsize(dtype_a) if dtype_a is not None else itemsize_in
    acc_bytes = itemsize(dtype_acc)
    budget = int(hw.fast_bytes * vmem_fraction)
    qm, qn = vmem_quantum(dtype_in, hw)
    qk = hw.tile_quantum(dtype_in)[2]

    m_cap = min(round_up_to(m, qm), max_block)
    n_cap = min(round_up_to(n, qn), max_block)
    bk_cap = min(round_up_to(k, qk), max(bk_candidates))
    bks = sorted({min(bk_cap, round_up_to(c, qk)) for c in bk_candidates})

    seen: set = set()
    shapes: List[Tuple[float, Tuple[int, int, int]]] = []

    def consider(bm: int, bn: int, bk: int) -> None:
        if bm <= 0 or bn <= 0 or bk <= 0:
            return
        if bm % qm or bn % qn or bk % qk:
            return
        if bm > m_cap or bn > n_cap or bk > bk_cap:
            return
        if tile_vmem_bytes(bm, bn, bk, itemsize_in, acc_bytes,
                           epilogue_mn_ops=epi_mn,
                           epilogue_bias=epi_bias,
                           itemsize_b=itemsize_b,
                           itemsize_a=itemsize_a,
                           n_b=n_b, n_out=n_out,
                           prologue_mk_ops=pro_mk,
                           prologue_kn_ops=pro_kn) > budget:
            return
        if semiring == "min_plus" and not _min_plus_vmem_ok(bm, bn, bk,
                                                            budget):
            return
        key = (bm, bn, bk)
        if key in seen:
            return
        seen.add(key)
        shapes.append((effective_intensity(bm, bn, bk, itemsize_in), key))

    # Seed with the analytic solution (clamped bk to the candidate cap).
    solved = solve_tile_config(m, n, k, dtype_in=dtype_in,
                               dtype_acc=dtype_acc, hw=hw,
                               vmem_fraction=vmem_fraction,
                               max_block=max_block, dtype_b=dtype_b,
                               dtype_a=dtype_a)
    consider(solved.bm, solved.bn, solved.bk)

    for bk in bks:
        for bm in _geometric_multiples(qm, m_cap):
            # Largest bn the budget allows at this (bm, bk), then a short
            # geometric descent below it — the model says intensity falls
            # monotonically with bn at fixed bm, so deep descent is waste.
            fixed = 2 * bm * bk * (itemsize_a + 4 * pro_mk)
            # B-side prologue blocks ((bk, bn) fp32) scale with bn, so
            # they join the per-bn slope, not the fixed term.
            per_bn = 2 * bk * (n_b * itemsize_b + 4 * pro_kn) \
                + bm * (n_b * acc_bytes + n_out * itemsize_in) \
                + epi_mn * bm * itemsize_in + (itemsize_in if epi_bias else 0)
            bn_budget = (budget - fixed) // per_bn if budget > fixed else 0
            bn_top = min((int(bn_budget) // qn) * qn, n_cap)
            if semiring == "min_plus":
                # Start the descent inside the broadcast-feasible region.
                bn_mp = (budget // (4 * bm * bk) // qn) * qn
                bn_top = min(bn_top, bn_mp)
            bn = bn_top
            for _ in range(3):
                if bn < qn:
                    break
                consider(bm, bn, bk)
                bn = max((bn // 2 // qn) * qn, 0)

    shapes.sort(key=lambda t: (-t[0], t[1]))
    top = shapes[:max(1, top_n)]

    out: List[TileConfig] = []
    for inten, (bm, bn, bk) in top:
        for order in orders:
            vb = tile_vmem_bytes(bm, bn, bk, itemsize_in, acc_bytes,
                                 epilogue_mn_ops=epi_mn,
                                 epilogue_bias=epi_bias,
                                 itemsize_b=itemsize_b,
                                 itemsize_a=itemsize_a,
                                 n_b=n_b, n_out=n_out,
                                 prologue_mk_ops=pro_mk,
                                 prologue_kn_ops=pro_kn)
            out.append(TileConfig(
                bm=bm, bn=bn, bk=bk, order=order, vmem_bytes=vb,
                intensity=inten,
                q_elements=io_volume_elements(m, n, k, min(bm, m),
                                              min(bn, n)),
                q_lower_bound=io_lower_bound_elements(
                    m, n, k, budget // max(itemsize_in, acc_bytes)),
                utilization=vb / hw.fast_bytes,
            ))
    return out
