"""The program verifier (port of ``repro/analyze/validate.py``): static
checks on resolved dispatch plans.

Each function returns a list of :class:`repro_torch.analyze.diagnostics.
Diagnostic`; empty means the plan satisfies every hard constraint the
kernels assume.  The solver and autotuner only emit feasible tiles, but
persisted cache entries, hand-built tiles and schema drift can smuggle an
infeasible plan to the dispatch funnel, where it would otherwise die as a
launch error on the card (or, on the CPU, whose plain versions ignore the
tile, not at all).

The checks are parameterized over the target, as ``core/io_model.py`` is:

* on the card (a target whose kernels run fixed route tiles,
  ``hw.route_tiles``), SMEM001 requires the tile to be a K1 route's
  (``kernels.ca_mmm.ROUTE_TILES``) and the shared memory that route's CTA
  really takes to fit ``hw.smem_per_block``: the dynamic bytes its
  launcher passes (:func:`repro_torch.kernels.ca_mmm.route_smem_bytes`,
  the stage ring x (bm·bk + bk·bn) x itemsize of its tile, or the decode
  kernel's staged A rows) plus its static panels and reduction buffers
  (``route_static_smem_bytes``).  A tile no route runs is charged a
  double-buffered ring of its own (bm, bk) and (bk, bn) panels.  The
  distance product (K1g) has no (bm, bk, bn) broadcast buffer, unlike the
  reference's tropical kernel: it stages two k-major slabs, which is what
  its check charges.  K2's check is its plan's shared memory
  (``kernels.flash_attn.paged_plan``) against ``PAGED_SMEM``.
* on a target built from a TPU's fields (``route_tiles=False``), the
  capacity check is the reference's Eq. 9: ``tile_vmem_bytes`` against
  ``vmem_fraction`` of the target's fast memory, the min-plus broadcast
  buffer included, so the verdicts and budgets are the reference's
  VMEM001 ones under the name SMEM001.

QNT003's per-tile scale blocks must be multiples of the k slab the int8
routes stream (``kernels.ca_mmm.SCALE_BLOCK_QUANTUM``, 128: the SIMT
tile's 32 and 128, the wgmma route's 64 and 128) on the card, of the
lane width (``hw.quantum_n``) on a TPU target.  ``validate_dist`` checks
geometry only; it has no caller until the port's distributed layer.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.analyze.diagnostics import Diagnostic, error, warning
from repro_torch.core.hardware import (H100, TARGETS, HopperTarget,
                                       as_dtype)
from repro_torch.core.io_model import TileConfig, tile_vmem_bytes
from repro_torch.kernels import ca_mmm
from repro_torch.kernels import flash_attn as FA
from repro_torch.kernels.program import (program_cost, program_from_tag,
                                         program_tag)
from repro_torch.tuning.attention import _PAGE_CANDIDATES, AttnConfig

# The fraction of fast memory the reference's tile solve budgets against
# (its tuning/space.py default), for a target built from a TPU's fields.
DEFAULT_VMEM_FRACTION = 0.75

_VALID_ORDERS = ("k_inner", "k_outer")
_ATTN_ORDER = "attn"

# Short dtype names used by composite cache keys (quant_dtype_str).
_SHORT = {"bf16": torch.bfloat16, "f16": torch.float16,
          "f32": torch.float32, "f64": torch.float64, "int8": torch.int8}

# The reference's distributed schedules (core/distributed.py), whose
# geometry validate_dist checks.
SCHEDULES = ("allgather", "ring", "ring_unpipelined", "summa25d")
_RING_SCHEDULES = ("ring", "ring_unpipelined", "summa25d")


def _target_by_name(name: str) -> Optional[HopperTarget]:
    hit = TARGETS.get(name)
    if hit is not None:
        return hit
    for hw in TARGETS.values():
        if hw.name == name:
            return hw
    return None


def _dtype(dtype) -> Optional[torch.dtype]:
    if dtype is None:
        return None
    if isinstance(dtype, str) and dtype in _SHORT:
        return _SHORT[dtype]
    return as_dtype(dtype)


def _is_int8(dtype) -> bool:
    if dtype is None:
        return False
    if isinstance(dtype, str) and dtype in ("int8", "int8w"):
        return True
    return _dtype(dtype) == torch.int8


def scale_quantum(hw: HopperTarget) -> int:
    """The multiple a per-tile scale block must be: the k slab the port's
    int8 routes stream on the card, the lane width on a TPU target."""
    if hw.route_tiles:
        return ca_mmm.SCALE_BLOCK_QUANTUM
    return hw.quantum_n


# ---------------------------------------------------------------------------
# GEMM programs (TAG002 / SMEM001 / QNT003)
# ---------------------------------------------------------------------------

def planned_tile_bytes(tag: str, config: TileConfig, *,
                       dtype=torch.bfloat16, dtype_b=None, dtype_a=None,
                       scale_block: int = 0) -> int:
    """The reference's Eq. 9 left-hand side for a plan: double-buffered
    streams, accumulators and the program's residents at the kernel's
    effective ``bk`` (the capacity claim on a TPU target)."""
    cost = program_cost(tag)
    item = _dtype(dtype).itemsize
    return tile_vmem_bytes(
        config.bm, config.bn, scale_block or config.bk, item,
        acc_bytes=4, epilogue_mn_ops=cost.stream_mn,
        epilogue_bias=cost.has_bias,
        itemsize_b=_dtype(dtype_b).itemsize if dtype_b is not None
        else item,
        n_b=cost.n_b, n_out=cost.n_out,
        prologue_mk_ops=cost.prologue_mk,
        prologue_kn_ops=cost.prologue_kn,
        itemsize_a=_dtype(dtype_a).itemsize if dtype_a is not None
        else item)


def planned_smem_bytes(spec, config: TileConfig, *, dtype=torch.bfloat16,
                       dtype_b=None, dtype_a=None, semiring="plus_times",
                       m: Optional[int] = None, n: Optional[int] = None,
                       k: Optional[int] = None, scale_block: int = 0,
                       layout: str = "nn",
                       hw: HopperTarget = H100) -> Tuple[int, str]:
    """(bytes, route) of a CTA's shared memory for a plan on the card: the
    route whose tile ``config`` is, its launcher's dynamic bytes plus its
    static ones; for a tile no route runs, a double-buffered ring of the
    tile's own panels plus the alignment slack (route ``"none"``)."""
    a_dt = _dtype(dtype_a) or _dtype(dtype)
    b_dt = _dtype(dtype_b) or _dtype(dtype)
    tile = (config.bm, config.bn, config.bk)
    if tile not in ca_mmm.ROUTE_TILES:
        ring = 2 * (config.bm * config.bk * a_dt.itemsize
                    + spec.n_b * config.bk * config.bn * b_dt.itemsize)
        return ring + ca_mmm.SMEM_ALIGN_SLACK, "none"
    route = "minplus" if semiring == "min_plus" \
        else ca_mmm.tile_route(tile)
    dyn = ca_mmm.route_smem_bytes(route, spec, a_dt, b_dt, m=m, n=n, k=k,
                                  scale_block=scale_block, sms=hw.sms)
    static = ca_mmm.route_static_smem_bytes(route, spec, a_dt, b_dt, m=m,
                                            layout=layout)
    return dyn + static, route


def validate_program(tag: str,
                     config: Optional[TileConfig],
                     hw: HopperTarget = H100,
                     *,
                     dtype=torch.bfloat16,
                     dtype_b=None,
                     dtype_a=None,
                     semiring: str = "plus_times",
                     scale_block: int = 0,
                     act_block: int = 0,
                     m: Optional[int] = None,
                     n: Optional[int] = None,
                     k: Optional[int] = None,
                     layout: str = "nn",
                     vmem_fraction: float = DEFAULT_VMEM_FRACTION
                     ) -> List[Diagnostic]:
    """Verify one resolved GEMM program against its hard constraints.

    ``tag`` is the full program tag the dispatch resolved under;
    ``config`` the tile it plans to launch (``None`` skips the capacity
    check: tag and dtype-chain legality only).  ``scale_block`` is the
    weight's per-tile scale block (0: per channel), ``act_block`` the
    per-k-tile activation scale block.  ``m``, ``n``, ``k`` (when known)
    size the route's shared memory exactly; unknown, the most it can take.
    """
    diags: List[Diagnostic] = []

    # -- TAG002: the tag must parse, and parse canonically -----------------
    try:
        spec = program_from_tag(tag)
    except ValueError as e:
        diags.append(error("TAG002",
                           f"program tag {tag!r} does not parse: {e}",
                           tag=tag))
        return diags
    round_trip = program_tag(spec)
    if round_trip != tag:
        diags.append(error(
            "TAG002",
            f"program tag {tag!r} is not canonical (round-trips to "
            f"{round_trip!r}): cache keys minted from it would never "
            "hit the canonical entry", tag=tag, canonical=round_trip))

    # -- QNT003: dtype-chain legality --------------------------------------
    b_int8 = _is_int8(dtype_b)
    a_int8 = _is_int8(dtype_a)
    dequants = tuple(b.dequant for b in spec.branches)
    if b_int8 and any(d == "none" for d in dequants):
        diags.append(error(
            "QNT003",
            "int8 B operand but a branch has no dequant drain stage: "
            "the accumulator would be served unscaled",
            tag=tag, dequants=dequants))
    if a_int8:
        if not b_int8:
            diags.append(error(
                "QNT003",
                "int8 A stream without an int8 B operand: the int8 x int8 "
                "-> int32 path needs both sides quantized", tag=tag))
        if any(d != "ab" for d in dequants):
            diags.append(error(
                "QNT003",
                "int8 A stream requires the 'ab' dequant stage on every "
                "branch (both scales apply at the drain)",
                tag=tag, dequants=dequants))

    # -- QNT003: scale-block alignment -------------------------------------
    quantum = scale_quantum(hw)
    if scale_block:
        if scale_block % quantum != 0:
            diags.append(error(
                "QNT003",
                f"per-tile weight scale block {scale_block} is not a "
                f"multiple of {quantum}: a streamed k slab would straddle "
                "two scale rows", scale_block=scale_block, quantum=quantum))
        if act_block and act_block != scale_block:
            diags.append(error(
                "QNT003",
                f"per-k-tile activation scale block {act_block} != "
                f"weight scale block {scale_block}: the kernel applies "
                "one fused scale per k-step partial",
                act_block=act_block, scale_block=scale_block))
    elif act_block and act_block % quantum != 0:
        diags.append(error(
            "QNT003",
            f"activation scale block {act_block} is not a multiple of "
            f"{quantum}", act_block=act_block, quantum=quantum))

    # -- SMEM001: capacity -------------------------------------------------
    if config is None:
        return diags
    eff_bk = scale_block or config.bk
    if not hw.route_tiles:
        budget = int(hw.fast_bytes * vmem_fraction)
        need = planned_tile_bytes(tag, config, dtype=dtype, dtype_b=dtype_b,
                                  dtype_a=dtype_a, scale_block=scale_block)
        if need > budget:
            diags.append(error(
                "SMEM001",
                f"tile ({config.bm}, {config.bn}, {eff_bk}) claims {need} "
                f"B of fast memory > budget {budget} B ({vmem_fraction:.2f}"
                f" x {hw.fast_bytes} B on {hw.name})",
                bm=config.bm, bn=config.bn, bk=eff_bk, bytes=need,
                budget=budget, hw=hw.name, tag=tag))
        if semiring == "min_plus":
            bcast = config.bm * eff_bk * config.bn * 4
            if bcast > budget:
                diags.append(error(
                    "SMEM001",
                    f"min_plus broadcast buffer bm*bk*bn*4 = {bcast} B "
                    f"exceeds the budget {budget} B",
                    bm=config.bm, bn=config.bn, bk=eff_bk, bytes=bcast,
                    budget=budget, semiring=semiring))
        return diags
    tile = (config.bm, config.bn, config.bk)
    need, route = planned_smem_bytes(
        spec, config, dtype=dtype, dtype_b=dtype_b, dtype_a=dtype_a,
        semiring=semiring, m=m, n=n, k=k, scale_block=scale_block,
        layout=layout, hw=hw)
    if tile not in ca_mmm.ROUTE_TILES:
        diags.append(error(
            "SMEM001",
            f"tile {tile} is no K1 route's (the routes run "
            f"{sorted(ca_mmm.ROUTE_TILES)}), so the card would refuse it; "
            f"its double-buffered panels take {need} B of shared memory "
            f"({hw.smem_per_block} B a block on {hw.name})",
            bm=config.bm, bn=config.bn, bk=config.bk, bytes=need,
            budget=hw.smem_per_block, route=route, hw=hw.name, tag=tag))
    elif need > hw.smem_per_block:
        diags.append(error(
            "SMEM001",
            f"tile {tile} ({route} route) takes {need} B of shared memory "
            f"> {hw.smem_per_block} B a block on {hw.name}",
            bm=config.bm, bn=config.bn, bk=config.bk, bytes=need,
            budget=hw.smem_per_block, route=route, hw=hw.name, tag=tag))
    return diags


# ---------------------------------------------------------------------------
# Attention / KV pages (KV005, SMEM001)
# ---------------------------------------------------------------------------

def validate_attn(cfg,
                  *,
                  arch: str = "flash",
                  hw: HopperTarget = H100,
                  heads: Optional[int] = None,
                  kv_heads: Optional[int] = None,
                  pool_pages: Optional[int] = None,
                  batch: Optional[int] = None,
                  max_context: Optional[int] = None,
                  table_pages: Optional[int] = None) -> List[Diagnostic]:
    """Verify a resolved :class:`repro_torch.tuning.attention.AttnConfig`.

    For ``arch="paged_decode"`` the ``kv_block`` is the pool's page
    size, so the optional pool arguments extend the check to admission
    arithmetic: ``batch`` sequences of ``max_context`` tokens must fit
    ``pool_pages`` pages and ``table_pages`` block-table slots.  A flash
    ``kv_block`` must be a multiple of the lane on a TPU target; K3 on
    the card takes any."""
    diags: List[Diagnostic] = []
    q_block = int(getattr(cfg, "q_block", 0) or 0)
    kv_block = int(getattr(cfg, "kv_block", 0) or 0)
    if q_block < 1 or kv_block < 1:
        diags.append(error(
            "KV005", f"non-positive attention blocking q_block={q_block} "
            f"kv_block={kv_block}", q_block=q_block, kv_block=kv_block))
        return diags

    if heads is not None and kv_heads:
        if heads % kv_heads != 0:
            diags.append(error(
                "KV005",
                f"GQA heads {heads} not divisible by kv heads {kv_heads}",
                heads=heads, kv_heads=kv_heads))

    if arch == "paged_decode":
        page = kv_block
        if page not in _PAGE_CANDIDATES:
            diags.append(error(
                "KV005",
                f"page size {page} is outside the supported candidate "
                f"set {_PAGE_CANDIDATES}: the pool granularity is tuned "
                "over exactly these", page=page,
                candidates=_PAGE_CANDIDATES))
        if pool_pages is not None and batch and max_context:
            need = batch * (-(-int(max_context) // page))
            if need > pool_pages:
                diags.append(error(
                    "KV005",
                    f"pool admission overflow: {batch} sequences x "
                    f"{max_context} tokens need {need} pages of size "
                    f"{page}, pool holds {pool_pages}",
                    pages_needed=need, pool_pages=pool_pages,
                    page=page, batch=batch, max_context=max_context))
        if table_pages is not None and max_context:
            if table_pages * page < int(max_context):
                diags.append(error(
                    "KV005",
                    f"block table covers {table_pages} x {page} = "
                    f"{table_pages * page} tokens < max context "
                    f"{max_context}", table_pages=table_pages,
                    page=page, max_context=max_context))
    elif not hw.route_tiles and kv_block % hw.quantum_n != 0:
        diags.append(error(
            "KV005",
            f"flash kv_block {kv_block} is not a multiple of the lane "
            f"width {hw.quantum_n}", kv_block=kv_block,
            lane=hw.quantum_n))
    return diags


def validate_paged_dispatch(*, q_shape: Sequence[int], page: int,
                            n_heads: int, kv_heads: int,
                            head_dim: Optional[int] = None,
                            v_head_dim: Optional[int] = None
                            ) -> List[Diagnostic]:
    """The ``paged_attention`` call-site checks: q's decode shape, the
    page and the GQA ratio (KV005); with the head dims, that K2's plan
    for the group fits ``PAGED_SMEM`` (SMEM001)."""
    diags: List[Diagnostic] = []
    q_shape = tuple(int(d) for d in q_shape)
    if len(q_shape) != 4 or q_shape[1] != 1:
        diags.append(error(
            "KV005",
            f"paged decode attention takes q of shape (B, 1, H, D), got "
            f"{q_shape}", q_shape=q_shape))
    if page < 1:
        diags.append(error("KV005", f"non-positive page size {page}",
                           page=page))
    if kv_heads and n_heads % kv_heads != 0:
        diags.append(error(
            "KV005",
            f"GQA heads {n_heads} not divisible by kv heads {kv_heads}",
            heads=n_heads, kv_heads=kv_heads))
    if head_dim and kv_heads and not diags:
        dv = v_head_dim or head_dim
        try:
            plan = FA.paged_plan(n_heads // kv_heads, head_dim, dv)
        except ValueError as e:
            diags.append(error("SMEM001", f"paged attention: {e}",
                               head_dim=head_dim, budget=FA.PAGED_SMEM))
        else:
            if plan.smem > FA.PAGED_SMEM:
                diags.append(error(
                    "SMEM001",
                    f"paged attention plan takes {plan.smem} B of shared "
                    f"memory > {FA.PAGED_SMEM} B", bytes=plan.smem,
                    budget=FA.PAGED_SMEM, head_dim=head_dim))
    return diags


# ---------------------------------------------------------------------------
# Distributed schedules (DIST004)
# ---------------------------------------------------------------------------

def validate_dist(schedule: str,
                  mesh: Union[Tuple[int, int, int], Dict[str, int]],
                  shapes: Tuple[int, int, int],
                  *,
                  b_block: int = 0,
                  scale_rows: int = 0) -> List[Diagnostic]:
    """Verify a distributed GEMM's geometry: ``mesh`` is ``(dp, tp,
    pods)`` or a dict with those keys, ``shapes`` the global ``(m, n,
    k)``; ``b_block`` the weight's per-tile scale block (its rows ride the
    ring in k-chunks, so it must divide the chunk), ``scale_rows`` the
    scale tensor's leading dim (split over pods).  ``m`` may be ragged
    (padded to a ``dp`` multiple), so it is not checked."""
    diags: List[Diagnostic] = []
    if isinstance(mesh, dict):
        dp = int(mesh.get("dp", 1))
        tp = int(mesh.get("tp", 1))
        pods = int(mesh.get("pods", 1))
    else:
        dp, tp, pods = (int(x) for x in mesh)
    m, n, k = (int(x) for x in shapes)

    if schedule not in SCHEDULES + ("auto",):
        diags.append(error(
            "DIST004", f"unknown schedule {schedule!r} (valid: "
            f"{SCHEDULES + ('auto',)})", schedule=schedule))
        return diags
    if min(dp, tp, pods) < 1:
        diags.append(error(
            "DIST004", f"non-positive mesh axis dp={dp} tp={tp} "
            f"pods={pods}", dp=dp, tp=tp, pods=pods))
        return diags
    if n % tp != 0:
        diags.append(error(
            "DIST004", f"n={n} does not divide over tp={tp}",
            n=n, tp=tp, schedule=schedule))
    if k % (tp * pods) != 0:
        diags.append(error(
            "DIST004", f"k={k} does not divide over tp*pods={tp * pods}",
            k=k, tp=tp, pods=pods, schedule=schedule))
    elif b_block and (schedule in _RING_SCHEDULES or schedule == "auto"):
        kchunk = k // (tp * pods)
        if kchunk % b_block != 0:
            diags.append(error(
                "DIST004",
                f"per-tile scale block {b_block} does not divide the "
                f"ring k-chunk {kchunk}: a rotated chunk would carry a "
                "fractional scale row", b_block=b_block, kchunk=kchunk,
                schedule=schedule))
        if pods > 1 and scale_rows and scale_rows % pods != 0:
            diags.append(error(
                "DIST004",
                f"per-tile scale rows {scale_rows} do not split over "
                f"pods={pods}", scale_rows=scale_rows, pods=pods))
    return diags


# ---------------------------------------------------------------------------
# Persisted tuning-cache entries (the `cache lint` mode)
# ---------------------------------------------------------------------------

def validate_cache_entry(key: str, entry) -> List[Diagnostic]:
    """Verify one persisted :class:`repro_torch.tuning.cache.CacheEntry`.

    GEMM keys re-run the tag and capacity checks under the key's own
    target and (possibly composite) dtype; attention keys check the order
    marker and page-candidate membership.  A target this build does not
    know is flagged as a warning (never judged against another target's
    budgets), structural damage as errors."""
    diags: List[Diagnostic] = []
    parts = key.split("/")
    is_attn = len(parts) >= 2 and parts[1].startswith("attn.")
    if not is_attn and len(parts) != 6:
        diags.append(error(
            "TAG002", f"malformed GEMM cache key {key!r} (want "
            "hw/dtype/semiring/tag/layout/shape)", key=key))
        return diags
    if is_attn and len(parts) != 5:
        diags.append(error(
            "TAG002", f"malformed attention cache key {key!r}", key=key))
        return diags
    hw = _target_by_name(parts[0])
    if hw is None:
        diags.append(warning(
            "SMEM001", f"unknown target {parts[0]!r} (known: "
            f"{sorted(TARGETS)}): its budgets are not checked", key=key,
            hw=parts[0]))
        return diags
    if int(entry.bm) < 1 or int(entry.bn) < 1 or int(entry.bk) < 1:
        diags.append(error(
            "SMEM001", f"non-positive tile ({entry.bm}, {entry.bn}, "
            f"{entry.bk}) in cache entry", key=key))
        return diags

    if is_attn:
        if entry.order != _ATTN_ORDER:
            diags.append(error(
                "TAG002", f"attention key with order={entry.order!r} "
                f"(want 'attn')", key=key, order=entry.order))
        cfg = AttnConfig(q_block=int(entry.bm), kv_block=int(entry.bn))
        diags.extend(validate_attn(cfg, arch=parts[1][len("attn."):],
                                   hw=hw))
        return diags

    hw_name, dtype_str, semiring, tag, layout, _shape = parts
    if entry.order not in _VALID_ORDERS:
        diags.append(error(
            "TAG002", f"unknown loop order {entry.order!r}", key=key,
            order=entry.order))
    dtype_a = dtype_b = None
    dtype = dtype_str
    if "w_" in dtype_str:            # composite quant key: "int8w_bf16a"
        w_part, a_part = dtype_str.split("w_", 1)
        dtype_b = w_part
        dtype = a_part[:-1] if a_part.endswith("a") else a_part
        dtype_a = dtype if _is_int8(dtype) else None
    try:
        cfg = TileConfig(bm=int(entry.bm), bn=int(entry.bn),
                         bk=int(entry.bk), order=entry.order)
        diags.extend(validate_program(
            tag, cfg, hw, dtype=dtype, dtype_b=dtype_b, dtype_a=dtype_a,
            semiring=semiring, layout=layout))
    except (TypeError, ValueError) as e:
        diags.append(error(
            "TAG002", f"cache entry fails to validate structurally: {e}",
            key=key))
    if layout not in ("nn", "nt", "tn", "tt"):
        diags.append(error(
            "TAG002", f"unknown layout {layout!r}", key=key,
            layout=layout))
    return diags
