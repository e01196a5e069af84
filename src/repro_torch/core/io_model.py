"""The paper's I/O model (port of ``repro/core/io_model.py``, Secs.
3.2-3.4), parameterized over a :class:`~repro_torch.core.hardware.HopperTarget`.

Every formula is the reference's, equation for equation:

* ``computational_intensity``  — Eq. 5 objective ``x·y / (x + y)``.
* ``io_volume_elements``       — Eq. 6: ``Q = mn (1 + k (1/x + 1/y))``.
* ``io_lower_bound_elements``  — Eq. 7 consequence: ``Q >= 2mnk/sqrt(S)``.
* ``vmem_quantum``             — Eq. 8 analog: the (m, n) step a tile
  grows by (on the H100 WGMMA's 64 rows by 8 columns; the name is the
  reference's).
* ``solve_tile_config``        — Eq. 9 + Sec. 5.1 parameter selection:
  maximize intensity subject to the fast memory ``S`` of the target, with
  the output tile resident and the streamed operands double-buffered.

On the H100 ``S`` is one CTA's register accumulator plus its shared-memory
ring, and the kernels run only the tiles their routes instantiate, so the
tuning space picks among those (``repro_torch.tuning.space``); the solver
stays the paper's model, and with the reference's TPU constants it makes
the reference's choices exactly.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.core.hardware import H100, HopperTarget, itemsize


# ---------------------------------------------------------------------------
# Paper equations (element-counted, dtype-agnostic)
# ---------------------------------------------------------------------------

def computational_intensity(x_tot: float, y_tot: float) -> float:
    """Eq. 5 objective: MACs per off-fast-memory element moved.

    A memory tile of shape (x_tot, y_tot) performs ``x·y·k`` MACs while
    loading ``k (x + y)`` stream elements; the intensity is the k-independent
    ratio ``x·y / (x + y)``.
    """
    return (x_tot * y_tot) / (x_tot + y_tot)


# Minimum contiguous HBM transaction for full bandwidth.  The paper's
# Sec. 4.3 DDR-burst argument (its on-the-fly transpose exists solely to
# lengthen bursts): stream-block rows of bk*itemsize bytes below this waste
# HBM transactions.  The reference's constant, kept for parity.
MIN_BURST_BYTES = 512


def burst_penalty(bk: int, itemsize: int,
                  min_burst: int = MIN_BURST_BYTES) -> float:
    """Multiplier (>= 1) on stream traffic from short rows."""
    row = bk * itemsize
    return max(1.0, min_burst / row)


def effective_intensity(x_tot: float, y_tot: float, bk: int,
                        itemsize: int) -> float:
    """Eq. 5 objective with burst-inefficiency folded into the stream
    term: MACs per *effective* element moved."""
    return (x_tot * y_tot) / (burst_penalty(bk, itemsize)
                              * (x_tot + y_tot))


def arithmetic_intensity_ops_per_byte(
    x_tot: int, y_tot: int, itemsize: int
) -> float:
    """Paper Fig. 9 quantity: 2x computational intensity (mul+add), per byte."""
    return 2.0 * computational_intensity(x_tot, y_tot) / itemsize


def io_volume_elements(m: int, n: int, k: int, x_tot: int, y_tot: int) -> float:
    """Eq. 6: total slow-memory traffic in elements for the full MMM."""
    return m * n * (1.0 + k * (1.0 / x_tot + 1.0 / y_tot))


def io_volume_bytes(m: int, n: int, k: int, x_tot: int, y_tot: int, *,
                    a_itemsize: int, b_itemsize: int,
                    out_itemsize: Optional[int] = None) -> float:
    """Eq. 6 with per-operand itemsizes — the quantized-GEMM accounting.

    Eq. 6's stream terms split by operand: the ``k/y_tot`` term is the A
    panel traffic (each A element re-read once per column stripe of C,
    ``mnk/y`` elements total) and ``k/x_tot`` is B's (``mnk/x``).  With
    int8 weights and bf16 activations those move bytes at different
    rates, and for serve-shape GEMMs (small m => small x_tot) the B term
    dominates — which is exactly why weight-only quantization roughly
    halves planned Q there without touching the schedule.
    """
    out_itemsize = a_itemsize if out_itemsize is None else out_itemsize
    return (m * n * out_itemsize
            + m * n * k * (a_itemsize / y_tot + b_itemsize / x_tot))


def io_volume_elements_program(m: int, n: int, k: int, x_tot: int,
                               y_tot: int, *, n_b: int = 1, n_out: int = 1,
                               prologue_mk_ops: int = 0,
                               prologue_kn_ops: int = 0,
                               prologue_vec_elements: int = 0) -> float:
    """Eq. 6 extended to shared-A multi-output programs.

    Eq. 6's stream terms split by operand (see :func:`io_volume_bytes`):
    ``mnk/y_tot`` is the A panel's traffic, ``mnk/x_tot`` one B panel's.
    A program with ``n_b`` branches streams A **once** and each B operand
    once per memory tile, and drains ``n_out`` outputs::

        Q = n_out·mn + (n_b + p_kn)·mnk/x_tot + (1 + p_mk)·mnk/y_tot + p_vec

    where ``p_mk`` counts (m, k)-shaped prologue operands riding the A
    stream (the forward dact preact: 1), ``p_kn`` (k, n)-shaped ones
    riding the B stream (the ``@b`` backward variant), and ``p_vec`` the
    O(m + k) prologue vector reads (rms row scale + gain).  The
    dual-output GLU win falls straight out: vs two single-output GEMMs
    (which pay ``2mn/x`` *and* ``2mn/y`` *and* 3 mn output terms — the
    up write plus its re-read as the gate's mul operand plus the gate
    output) the shared-A program saves a whole A stream and 2mn of
    output round trips.  The model shows the win before the bench does.
    """
    return (n_out * m * n
            + (n_b + prologue_kn_ops) * m * n * k / x_tot
            + (1.0 + prologue_mk_ops) * m * n * k / y_tot
            + prologue_vec_elements)


def two_pass_glu_q_elements(m: int, n: int, k: int, x_tot: int,
                            y_tot: int,
                            x_gate: Optional[int] = None,
                            y_gate: Optional[int] = None) -> float:
    """Planned traffic of the *two-pass* SwiGLU formulation: an up GEMM
    (plain Eq. 6, tiled as ``(x_tot, y_tot)``) plus a gate GEMM whose
    drain streams the up output as its mul operand
    (``epilogue_q_elements(n_stream_mn=1)``).  The gate GEMM plans under
    its own fused-epilogue key, so it may tile differently — pass
    ``(x_gate, y_gate)`` (default: same as the up GEMM) so the baseline
    is the traffic the two-pass path would actually plan, not a
    one-tile approximation.  The comparison baseline for the dual-branch
    GLU program."""
    x_gate = x_tot if x_gate is None else x_gate
    y_gate = y_tot if y_gate is None else y_gate
    return (io_volume_elements(m, n, k, x_tot, y_tot)
            + io_volume_elements(m, n, k, x_gate, y_gate)
            + epilogue_q_elements(m, n, n_stream_mn=1))


def io_lower_bound_elements(m: int, n: int, k: int, s_words: int) -> float:
    """Eq. 7 consequence: Q >= 2mnk/sqrt(S) (+ the mandatory mn write)."""
    return 2.0 * m * n * k / math.sqrt(s_words) + m * n


def epilogue_q_elements(m: int, n: int, n_stream_mn: int = 0,
                        has_bias: bool = False, fused: bool = True,
                        scale_a_elements: int = 0,
                        scale_b_elements: int = 0) -> float:
    """Extra slow-memory traffic (elements) of a GEMM epilogue.

    Fused (Sec. 4.4 extension): the elementwise chain runs on the
    resident accumulator during the drain, so the output write is already counted
    by Eq. 6's ``mn`` term — only the epilogue's *operand reads* are new
    (each streamed (m, n) gate/residual once, plus a bias row).

    Unfused (a separate op): the epilogue additionally re-reads the
    GEMM result and re-writes the final output — one full (m, n) round
    trip (``2mn``) that the fused drain never pays.

    A drain-fused dequant stage (repro_torch.quant) reads its scale vectors
    once: ``scale_b_elements`` (n per-channel, or ceil(k/g)·n per-tile)
    and ``scale_a_elements`` (m, the "ab" path).  Scales are fp32 —
    byte-counting callers charge them at 4 B/element even when the GEMM
    operands are narrower.  There is deliberately no unfused dequant
    variant: a separate dequant materializes the *weight* at full precision
    (mk extra elements), which is the whole regression the fused stage
    exists to avoid.
    """
    q = (float(n_stream_mn) * m * n + (n if has_bias else 0)
         + float(scale_a_elements) + float(scale_b_elements))
    if not fused:
        q += 2.0 * m * n
    return q


def drain_overhead_fraction(m: int, n: int, k: int, y_c: int, n_c: int) -> float:
    """Sec. 4.4: cycles draining C vs. compute cycles.

    Drain takes ``mn / y_c`` cycles against ``mnk / N_c`` compute cycles;
    the fraction of peak lost is ``1 / (1 + k·y_c/N_c ... )`` — we return
    drain/(drain+compute).  Used by bench_efficiency (Fig. 8 analog).
    """
    drain = m * n / y_c
    compute = m * n * k / n_c
    return drain / (drain + compute)


# ---------------------------------------------------------------------------
# Hardware quantization (Eq. 8/9 analogs)
# ---------------------------------------------------------------------------

def vmem_quantum(dtype, hw: HopperTarget = H100) -> Tuple[int, int]:
    """Minimum legal (m, n) growth step of a fast-memory tile for
    ``dtype`` (the reference's name).

    Paper Eq. 8: the BRAM port width forces tile sizes to be multiples of
    ``N_b,min`` blocks.  On the H100 the WGMMA instruction shape (64 rows
    by 8 columns) plays the identical role.
    """
    return hw.tile_quantum(dtype)[:2]


def round_down_to(value: int, quantum: int) -> int:
    return max(quantum, (value // quantum) * quantum)


def round_up_to(value: int, quantum: int) -> int:
    return ((value + quantum - 1) // quantum) * quantum


def memory_utilization(bm: int, bn: int, bk: int, itemsize_in: int,
                       acc_bytes: int, hw: HopperTarget = H100) -> float:
    """Fig. 3 analog: fraction of fast memory actually used by the tiles."""
    used = tile_vmem_bytes(bm, bn, bk, itemsize_in, acc_bytes)
    return used / hw.fast_bytes


def tile_vmem_bytes(bm: int, bn: int, bk: int, itemsize_in: int,
                    acc_bytes: int = 4, itemsize_out: Optional[int] = None,
                    double_buffer_out: bool = False,
                    epilogue_mn_ops: int = 0,
                    epilogue_bias: bool = False,
                    itemsize_b: Optional[int] = None,
                    n_b: int = 1,
                    n_out: int = 1,
                    prologue_mk_ops: int = 0,
                    prologue_kn_ops: int = 0,
                    itemsize_a: Optional[int] = None) -> int:
    """Fast-memory bytes claimed by one kernel instance (the reference's
    name; on the H100 one CTA's accumulator plus its stage ring).

    A and B stream blocks are double-buffered (the paper's Feed A/Feed B
    prefetch).  C lives once in fast memory as the
    accumulator — the paper's drain-phase separation (Sec. 4.4) means we do
    NOT double-buffer it, which is exactly the sqrt(2) intensity win the
    paper claims over Dou/Kumar.  ``double_buffer_out=True`` models the
    prior-work layout for the ablation benchmark.

    A fused epilogue parks its operands in fast memory alongside the accumulator:
    one (bm, bn) tile per streamed gate/residual (fetched once per (i, j)
    step — the index map ignores k, so no double buffer) plus a bias row.

    ``itemsize_b`` splits the stream-buffer budget by operand for
    mixed-precision GEMMs (int8 weights under bf16 activations): B's
    double buffer shrinks with its dtype, which widens the feasible
    (bm, bn) region — quantization buys intensity, not just bandwidth.
    ``itemsize_a`` (default: ``itemsize_in``) does the same for the A
    stream — the w8a8 path streams int8 activations, halving/quartering
    the A double buffer too (the accumulator stays 4 B/element: int32
    for w8a8 is as wide as fp32).  ``itemsize_in`` still sizes the
    epilogue residents and output blocks (those stay in the serve
    dtype).  Dequant scale vectors (O(bm + bn) fp32) are below the
    budget's resolution and are not charged.

    Multi-branch programs (``n_b`` B operands) double-buffer each B
    stream and park one accumulator per branch; ``n_out`` drained outputs
    each claim a write-back block; ``prologue_mk_ops`` /
    ``prologue_kn_ops`` count streamed prologue operands riding the A
    stream ((bm, bk) blocks — the forward dact preact) and the B stream
    ((bk, bn) blocks — the ``@b`` backward variant), charged at fp32
    width (their worst case — the preact is stored fp32).  The rms
    prologue's O(bm + bk) scale vectors are, like dequant scales, below
    the budget's resolution.
    """
    itemsize_out = itemsize_out if itemsize_out is not None else itemsize_in
    itemsize_b = itemsize_b if itemsize_b is not None else itemsize_in
    itemsize_a = itemsize_a if itemsize_a is not None else itemsize_in
    stream = 2 * (bm * bk * (itemsize_a + 4 * prologue_mk_ops)
                  + bk * bn * (n_b * itemsize_b + 4 * prologue_kn_ops))
    acc = n_b * bm * bn * acc_bytes
    out = n_out * bm * bn * itemsize_out  # output blocks written at drain
    if double_buffer_out:
        acc *= 2
    epi = epilogue_mn_ops * bm * bn * itemsize_in
    if epilogue_bias:
        epi += bn * itemsize_in
    return stream + acc + out + epi


# ---------------------------------------------------------------------------
# Tile solver (Sec. 5.1 parameter selection, on the target's constants)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TileConfig:
    """A solved kernel plan: the paper's (x_tot, y_tot, ...) for one chip."""

    bm: int
    bn: int
    bk: int
    # grid order: "k_inner" streams k fastest (paper Sec. 4.2 variant,
    # every K1 route); "k_outer" revisits C blocks through device memory
    # (the K4 ablation only).
    order: str = "k_inner"
    vmem_bytes: int = 0
    intensity: float = 0.0  # MACs / element (Eq. 5)
    q_elements: float = 0.0  # Eq. 6 for the full problem
    q_lower_bound: float = 0.0
    utilization: float = 0.0  # Fig. 3 analog

    def grid(self, m: int, n: int, k: int) -> Tuple[int, int, int]:
        return (pl_ceil(m, self.bm), pl_ceil(n, self.bn), pl_ceil(k, self.bk))


def pl_ceil(a: int, b: int) -> int:
    return -(-a // b)


def solve_tile_config(
    m: int,
    n: int,
    k: int,
    dtype_in=torch.bfloat16,
    dtype_acc=torch.float32,
    hw: HopperTarget = H100,
    vmem_fraction: float = 0.75,
    # The reference's cap: large enough that the Eq. 5 capacity bound,
    # not the cap, binds.
    max_block: int = 8192,
    double_buffer_out: bool = False,
    bk_max: int = 2048,
    dtype_b=None,
    dtype_a=None,
) -> TileConfig:
    """Solve the paper's optimization problem (Eqs. 5-9) for one target.

    Maximize ``bm·bn/(bm+bn)`` s.t. the fast-memory capacity constraint
    (``hw.fast_bytes``; bn at most ``hw.max_n`` where set), with
    (bm, bn) quantized to the hardware step (Eq. 8 analog) and clamped to
    the problem size.  Following Eq. 7 the optimum is square; when m or n
    is smaller than the square optimum the solver degrades to the best
    rectangle, mirroring the paper's narrow-compute-tile discussion
    (Sec. 4.1: keep x_tot and y_tot "as similar as possible").

    ``dtype_b`` (default: ``dtype_in``) is the B-operand/weight dtype for
    mixed-precision GEMMs — its itemsize shrinks B's double buffer in the
    capacity constraint (see :func:`tile_vmem_bytes`).  ``dtype_a``
    (default: ``dtype_in``) is the *streamed* A dtype — the w8a8 path's
    int8 activations shrink the A double buffer the same way, while the
    int32 accumulator stays at ``dtype_acc``'s 4 B width.
    """
    itemsize_in = itemsize(dtype_in)
    itemsize_b = itemsize(dtype_b) if dtype_b is not None \
        else itemsize_in
    itemsize_a = itemsize(dtype_a) if dtype_a is not None \
        else itemsize_in
    acc_bytes = itemsize(dtype_acc)
    budget = int(hw.fast_bytes * vmem_fraction)
    qm, qn = vmem_quantum(dtype_in, hw)
    # k participates in the streamed blocks only; its quantum is the
    # target's k step (contiguity — the paper's DDR-burst argument, Sec.
    # 4.3, maps to long HBM bursts).
    qk = hw.tile_quantum(dtype_in)[2]

    m_cap = min(round_up_to(m, qm), max_block)
    n_cap = min(round_up_to(n, qn), max_block, hw.max_n or max_block)

    best: Optional[TileConfig] = None
    bk_cap = min(round_up_to(k, qk), bk_max)
    bk_candidates = sorted({min(bk_cap, c) for c in (128, 256, 512, 1024, 2048)})
    for bk in bk_candidates:
        for bm in range(qm if qm > m_cap else round_down_to(m_cap, qm), 0, -qm):
            if bm > m_cap:
                continue
            # Largest bn satisfying the capacity constraint, then quantize
            # down (Eq. 9: floor to a whole number of hardware steps).
            # stream + (acc+out) <= budget
            fixed = 2 * bm * bk * itemsize_a
            per_bn = 2 * bk * itemsize_b + bm * (
                acc_bytes * (2 if double_buffer_out else 1) + itemsize_in
            )
            bn_max = (budget - fixed) // per_bn if budget > fixed else 0
            bn = min(round_down_to(int(bn_max), qn), n_cap)
            if bn <= 0 or bn_max < qn:
                continue
            vb = tile_vmem_bytes(bm, bn, bk, itemsize_in, acc_bytes,
                                 double_buffer_out=double_buffer_out,
                                 itemsize_b=itemsize_b,
                                 itemsize_a=itemsize_a)
            if vb > budget:
                continue
            inten = effective_intensity(bm, bn, bk, itemsize_in)
            cand = TileConfig(
                bm=bm, bn=bn, bk=bk, vmem_bytes=vb, intensity=inten,
                q_elements=io_volume_elements(m, n, k, min(bm, m), min(bn, n)),
                q_lower_bound=io_lower_bound_elements(
                    m, n, k, budget // max(itemsize_in, acc_bytes)),
                utilization=vb / hw.fast_bytes,
            )
            if best is None or _better(cand, best):
                best = cand
            # bm loop descends; once bn hits its cap the intensity can only
            # fall (bm shrinking at fixed bn) — but mid-range bm trades bn
            # up, so keep scanning until intensity drops well below best.
            if best is not None and inten < 0.5 * best.intensity:
                break
    if best is None:
        # Degenerate tiny problem: single quantum tile.  bk still honors the
        # k quantum and the solver's bk cap (the old ``min(qk, round_up)``
        # always collapsed to qk — dead rounding).
        bm, bn, bk = qm, qn, bk_cap
        vb = tile_vmem_bytes(bm, bn, bk, itemsize_in, acc_bytes,
                             itemsize_b=itemsize_b, itemsize_a=itemsize_a)
        best = TileConfig(
            bm=bm, bn=bn, bk=bk,
            vmem_bytes=vb,
            intensity=computational_intensity(bm, bn),
            q_elements=io_volume_elements(m, n, k, min(bm, m), min(bn, n)),
            # Same S divisor as the main path: words of the wider of input
            # and accumulator dtypes (not a hardcoded // 4).
            q_lower_bound=io_lower_bound_elements(
                m, n, k, budget // max(itemsize_in, acc_bytes)),
            utilization=vb / hw.fast_bytes,
        )
    return best


def _better(a: TileConfig, b: TileConfig) -> bool:
    """Higher intensity wins; ties prefer squarer tiles then bigger bk."""
    if abs(a.intensity - b.intensity) > 1e-9:
        return a.intensity > b.intensity
    asq = abs(math.log(a.bm / a.bn))
    bsq = abs(math.log(b.bm / b.bn))
    if abs(asq - bsq) > 1e-9:
        return asq < bsq
    return a.bk > b.bk


# ---------------------------------------------------------------------------
# Roofline terms for a single-chip GEMM (used by benchmarks)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GemmRoofline:
    compute_s: float
    memory_s: float
    intensity_ops_per_byte: float
    bound: str

    @property
    def time_s(self) -> float:
        return max(self.compute_s, self.memory_s)


def gemm_roofline(m: int, n: int, k: int, tile: TileConfig, dtype_in,
                  hw: HopperTarget = H100) -> GemmRoofline:
    size = itemsize(dtype_in)
    flops = 2.0 * m * n * k
    q_bytes = io_volume_elements(m, n, k, tile.bm, tile.bn) * size
    compute_s = flops / hw.peak_flops(dtype_in)
    memory_s = q_bytes / hw.hbm_bandwidth
    return GemmRoofline(
        compute_s=compute_s,
        memory_s=memory_s,
        intensity_ops_per_byte=flops / q_bytes,
        bound="compute" if compute_s >= memory_s else "memory",
    )
