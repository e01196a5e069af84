"""Communication-avoiding *distributed* GEMM (port of
``repro/core/distributed.py``): the paper's Sec. 4.1 chain argument at
cluster scale.

The paper collapses its 2-D PE grid into a 1-D chain so that only three
buses cross each chiplet boundary (constant fan-out, neighbour-only
links).  Between cards the analog of a chiplet crossing is an NVLink hop
(and, across hosts, a network hop).  Four schedules over a
:class:`~torch.distributed.device_mesh.DeviceMesh`, each rank working on
its own shards (``DTensor.to_local``) with explicit collectives on the
mesh axes' process groups:

* ``allgather`` — SUMMA-style: gather the rotating operand up front
  (``all_gather`` over tp, then over pod).  The "broadcast" topology the
  paper argues against, kept as the baseline.
* ``ring`` — output-stationary C; the A panels rotate neighbour to
  neighbour while each step's partial product is computed.  The rotation
  is double-buffered: the transfer feeding step s+1 is issued (one
  ``batch_isend_irecv``) before step s's local GEMM and waited on only
  when step s+1 needs it, the torch form of the reference's prologue
  permute plus ``optimization_barrier``.  Exactly g−1 hops.
* ``ring_unpipelined`` — compute, then rotate: g hops, the last one dead.
  The measured ablation; never chosen by ``auto``.
* ``summa25d`` — 2.5-D C replication over the ``pod`` axis: each pod runs
  the ring on 1/pods of k and C is all-reduced over pod once.

Each ring step's local GEMM resolves its tile through the port's tuning
registry keyed by the per-rank *local* shape ``(m/dp, n/tp, k/g)``
(:func:`dist_local_resolution`) and, for float operands, runs on K1 (the
``none`` program with an fp32 output, ``core.gemm.dist_local_matmul``).
int8 :class:`~repro_torch.quant.QTensor` weights ride the ring with their
scales, and a per-tensor w8a8 activation rides as its int8 payload; those
partials are plain products, as the reference computes them with
``jnp.dot`` outside any Pallas kernel.  Each dispatch is recorded in the
GEMM ledger with its planned wire bytes (:func:`estimate_cost`), and the
bytes its own transport moved are counted in :data:`wire_bytes`.

The transport follows the group's backend (``dist.get_backend``): under
NCCL, one rank per card, the panels stay on the card; under gloo (CPU
ranks, or several ranks sharing one card, which NCCL refuses) the ring's
and the gather's buffers of card ranks go through pinned host copies,
while every local GEMM still runs on the card.

:func:`choose_schedule` is the Eq. 6 cost model re-derived per rank and
per step: a pipelined schedule costs ``fill + (g−1)·max(step_compute,
step_comm) + drain``.  Its default target is ``core/hardware.H100``
(NVLink and a 400 Gb/s adapter per card as the two link tiers).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.hardware import H100, HopperTarget, as_dtype
from repro_torch.core.hardware import itemsize as _itemsize
from repro_torch.core.io_model import TileConfig, io_volume_bytes

SCHEDULES = ("allgather", "ring", "ring_unpipelined", "summa25d")
# Schedules built on the rotating-A chain (share geometry + divisibility).
_RING_SCHEDULES = ("ring", "ring_unpipelined", "summa25d")
_STAGE = "dist_matmul"

# Bytes the schedules' own transfers moved on this process, by kind:
# "hop" the ring chunks a rank sent, "gather" the A panels it received
# from its axis peers, "all_reduce" the C payload it handed to summa25d's
# pod all-reduce.  The operands' re-shards and full_output's gathers are
# not counted.  Read as a difference (:func:`wire_traffic`).
wire_bytes = {"hop": 0, "gather": 0, "all_reduce": 0}


def _dist_error(message: str):
    """A DIST004 geometry violation as the single typed dispatch error."""
    from repro_torch.analyze.diagnostics import ProgramValidationError, error

    return ProgramValidationError([error("DIST004", message)])


# ---------------------------------------------------------------------------
# Cost model (per-rank, per-step Eq. 6 analog)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DistributedCost:
    """Planned cost of one distributed GEMM dispatch.

    ``comm_bytes`` is the total per-rank wire traffic (what the ledger
    pins); the ``step_*`` fields carry the per-ring-step decomposition the
    pipelined ``time_s`` is built from.  ``reduce_s`` is a terminal
    reduction that nothing overlaps (summa25d's C all-reduce over pod).
    """

    schedule: str
    compute_s: float
    comm_bytes: float
    comm_s: float
    overlapped: bool
    steps: int = 1
    step_compute_s: float = 0.0
    step_comm_s: float = 0.0
    reduce_s: float = 0.0

    @property
    def time_s(self) -> float:
        if self.overlapped and self.steps > 1:
            # One fill step of compute, then g-1 steps each bounded by the
            # slower of the local GEMM and the hop in flight, then any
            # terminal reduction.
            return (self.step_compute_s
                    + (self.steps - 1) * max(self.step_compute_s,
                                             self.step_comm_s)
                    + self.reduce_s)
        if self.overlapped:
            return max(self.compute_s, self.comm_s) + self.reduce_s
        return self.compute_s + self.comm_s + self.reduce_s


def dist_local_shapes(schedule: str, m: int, n: int, k: int, dp: int,
                      tp: int, pods: int = 1) -> Tuple[int, int, int, int]:
    """Per-rank local GEMM shape ``(mloc, nloc, kloc, steps)``.

    Ring schedules run ``steps = tp`` local GEMMs over ``k/(tp·pods)``
    chunks; allgather runs one local GEMM over the full ``k/pods`` range.
    Ceil-divided so non-divisible query shapes still key a resolution
    (the dispatch pads m and requires n and k to divide)."""
    mloc = -(-m // dp)
    nloc = max(1, -(-n // tp))
    if schedule in _RING_SCHEDULES:
        return mloc, nloc, max(1, -(-k // (tp * max(pods, 1)))), tp
    if schedule == "allgather":
        return mloc, nloc, max(1, -(-k // max(pods, 1))), 1
    raise ValueError(schedule)


def _is_int8(dtype) -> bool:
    return dtype is not None and as_dtype(dtype) == torch.int8


def _step_compute_s(mloc: int, nloc: int, kloc: int, hw: HopperTarget,
                    dtype, tile: Optional[TileConfig], dtype_b,
                    dtype_a) -> float:
    """Roofline seconds of one local GEMM step under the resolved tile:
    peak rate alone without a tile; with one, the larger of the compute
    term (at the int8 rate iff both operands ride int8, the ledger's
    rule) and the Eq. 6 memory term at the per-operand itemsizes."""
    compute_dtype = torch.int8 if (_is_int8(dtype_a) and _is_int8(dtype_b)) \
        else dtype
    flops = 2.0 * mloc * nloc * kloc
    peak = flops / hw.peak_flops(compute_dtype)
    if tile is None:
        return peak
    size = _itemsize(dtype)
    ia = _itemsize(dtype_a) if dtype_a is not None else size
    ib = _itemsize(dtype_b) if dtype_b is not None else size
    hbm = io_volume_bytes(mloc, nloc, kloc,
                          min(tile.bm, mloc), min(tile.bn, nloc),
                          a_itemsize=ia, b_itemsize=ib, out_itemsize=4)
    return max(peak, hbm / hw.hbm_bandwidth)


def estimate_cost(schedule: str, m: int, n: int, k: int, itemsize: int,
                  dp: int, tp: int, pods: int = 1,
                  hw: HopperTarget = H100, dtype=torch.bfloat16, *,
                  tile: Optional[TileConfig] = None, dtype_b=None,
                  dtype_a=None) -> DistributedCost:
    """Planned per-rank cost of one schedule (the Eq. 6 analog).

    ``itemsize`` is the wire itemsize of the rotating A panel (1 when a
    w8a8 activation rides as its int8 payload).  ``tile`` (with the
    composite ``dtype_b``/``dtype_a``) sharpens the compute term from the
    peak rate to the local step's roofline: pass the config from
    :func:`dist_local_resolution`."""
    pods = max(pods, 1)
    mloc, nloc, kloc, steps = dist_local_shapes(
        "ring" if schedule in _RING_SCHEDULES else schedule,
        m, n, k, dp, tp, pods)
    step_c = _step_compute_s(mloc, nloc, kloc, hw, dtype, tile,
                             dtype_b, dtype_a)
    link_bw = hw.ici_bandwidth
    hop_bytes = float(mloc) * kloc * itemsize      # one rotating A chunk
    if schedule == "allgather":
        # Gather the A panels over the tp axis: each rank receives
        # (tp-1)/tp of the (m/dp, k/pods) panel, then one local GEMM.
        bytes_ = (m / dp) * (k / pods) * (1 - 1 / tp) * itemsize
        return DistributedCost("allgather", step_c, bytes_,
                               bytes_ / link_bw, overlapped=False)
    if schedule == "ring":
        # g-1 hops in flight, each hidden behind a local step.
        bytes_ = hop_bytes * (steps - 1)
        return DistributedCost("ring", step_c * steps, bytes_,
                               bytes_ / link_bw, overlapped=True,
                               steps=steps, step_compute_s=step_c,
                               step_comm_s=hop_bytes / link_bw)
    if schedule == "ring_unpipelined":
        # Rotate after every step, the last hop dead; nothing hides any
        # hop, so they are charged serialized.
        bytes_ = hop_bytes * steps
        return DistributedCost("ring_unpipelined", step_c * steps, bytes_,
                               bytes_ / link_bw, overlapped=False,
                               steps=steps, step_compute_s=step_c,
                               step_comm_s=hop_bytes / link_bw)
    if schedule == "summa25d":
        # k split over pods: each pod's ring moves 1/pods of the bytes;
        # C is all-reduced over the pod axis once, not overlapped.
        intra = hop_bytes * (steps - 1)
        c_bytes = 2.0 * (m / dp) * (n / tp) * (1 - 1 / pods) * 4  # fp32
        comm_s = intra / link_bw + c_bytes / hw.dcn_bandwidth
        return DistributedCost("summa25d", step_c * steps, intra + c_bytes,
                               comm_s, overlapped=True, steps=steps,
                               step_compute_s=step_c,
                               step_comm_s=hop_bytes / link_bw,
                               reduce_s=c_bytes / hw.dcn_bandwidth)
    raise ValueError(schedule)


def dist_local_resolution(schedule: str, m: int, n: int, k: int, *,
                          dp: int, tp: int, pods: int = 1,
                          dtype=torch.bfloat16, hw: HopperTarget = H100,
                          dtype_b=None, dtype_a=None):
    """Resolve the per-step local GEMM's tile through the tuning registry.

    The key is the per-rank *local* shape of :func:`dist_local_shapes`,
    under the local step's program tag (``none`` dense, ``dqb`` for int8
    weights riding the ring, ``dqab`` for the w8a8 ride) and composite
    dtype.  Returns ``(resolution, tag, (mloc, nloc, kloc, steps))``."""
    from repro_torch.kernels.program import program_with_dequant
    from repro_torch.tuning import get_registry  # lazy: imports kernels

    mloc, nloc, kloc, steps = dist_local_shapes(schedule, m, n, k,
                                                dp, tp, pods)
    tag = "none"
    if dtype_b is not None:
        tag = program_with_dequant("none",
                                   "ab" if dtype_a is not None else "b")
    res = get_registry().resolve_full(
        mloc, nloc, kloc, dtype=dtype, hw=hw, epilogue=tag, layout="nn",
        dtype_b=dtype_b, dtype_a=dtype_a)
    return res, tag, (mloc, nloc, kloc, steps)


def choose_schedule(m, n, k, itemsize, dp, tp, pods=1,
                    hw: HopperTarget = H100, dtype=torch.bfloat16, *,
                    tile: Optional[TileConfig] = None, dtype_b=None,
                    dtype_a=None, use_registry: bool = False
                    ) -> DistributedCost:
    """Cheapest schedule under the per-step pipelined cost model.

    ``use_registry=True`` resolves each candidate's local-step tile
    through the registry first, so the compute term is the plan's
    roofline instead of the peak rate (``ring_unpipelined`` is strictly
    dominated and never a candidate)."""
    cands = ["allgather", "ring"]
    if pods > 1:
        cands.append("summa25d")
    costs = []
    for s in cands:
        t = tile
        if t is None and use_registry:
            res, _tag, _shapes = dist_local_resolution(
                s, m, n, k, dp=dp, tp=tp, pods=pods, dtype=dtype, hw=hw,
                dtype_b=dtype_b, dtype_a=dtype_a)
            t = res.config
        costs.append(estimate_cost(s, m, n, k, itemsize, dp, tp, pods, hw,
                                   dtype, tile=t, dtype_b=dtype_b,
                                   dtype_a=dtype_a))
    return min(costs, key=lambda c: c.time_s)


# ---------------------------------------------------------------------------
# Placements and transport
# ---------------------------------------------------------------------------

def placements_for(spec: Sequence, mesh) -> list:
    """DTensor placements of a ``PartitionSpec``-like ``spec`` (one entry
    per tensor dim: None, a mesh axis name, or a tuple of names, major
    first) on a named ``DeviceMesh``: the mesh dim of each named axis
    shards its tensor dim; a tensor dim over several axes is split in
    mesh-dim order, so the spec's tuple must list them in that order."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"spec entry {entry} is not in the mesh's "
                             f"axis order {names}")
        for p in pos:
            out[p] = Shard(dim)
    return out


def _local(t, mesh, spec) -> torch.Tensor:
    """This rank's shard of ``t`` under ``spec``.  A ``DTensor`` already
    so placed gives its local tensor, and one replicated where it is not
    so placed a local chunk of it; one sharded otherwise is first
    gathered whole on the schedules' own transport (as the reference
    re-shards a weight on entry), then chunked here.  A plain tensor is
    the global value, the same on every rank, and is chunked here."""
    from torch.distributed.tensor import DTensor, Replicate

    want = placements_for(spec, mesh)
    if isinstance(t, DTensor):
        if t.device_mesh != mesh:
            raise ValueError("operand lies on another device mesh")
        if list(t.placements) == want:
            return t.to_local()
        if all(p == w or p.is_replicate()
               for p, w in zip(t.placements, want)):
            return t.redistribute(mesh, want).to_local()
        t = _replicated(t)
    full = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)
    return full.redistribute(mesh, want).to_local()


class _Axis:
    """One mesh axis's process group, this rank's index along it, and the
    transport its buffers take (``staged``: pinned host copies, for card
    tensors under a backend other than NCCL).  A ``counted`` axis adds
    its transfers to :data:`wire_bytes`."""

    def __init__(self, mesh, axis: str, device: torch.device,
                 counted: bool = False):
        self.counted = counted      # a schedule's own transfers
        self.group = mesh.get_group(axis)
        self.ranks = dist.get_process_group_ranks(self.group)
        self.index = mesh.get_local_rank(axis)
        self.size = len(self.ranks)
        self.device = device
        self.staged = (device.type == "cuda"
                       and dist.get_backend(self.group) != "nccl")

    def wire(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as the transport sends it (a pinned host copy when
        staged)."""
        if not self.staged or t.device.type == "cpu":
            return t.contiguous()
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        return host

    def compute(self, t: torch.Tensor) -> torch.Tensor:
        """A received buffer where the local GEMM reads it."""
        return t.to(self.device, non_blocking=True)

    def start_hop(self, buf: torch.Tensor):
        """Send ``buf`` (already on the wire) to the next rank of the
        ring and receive the previous rank's: one ``batch_isend_irecv``.
        Returns ``(requests, received)``."""
        recv = torch.empty(buf.shape, dtype=buf.dtype, device=buf.device,
                           pin_memory=buf.is_pinned())
        nxt = self.ranks[(self.index + 1) % self.size]
        prv = self.ranks[(self.index - 1) % self.size]
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, buf, nxt, self.group),
            dist.P2POp(dist.irecv, recv, prv, self.group)])
        self._count("hop", buf)
        return reqs, recv

    def _count(self, kind: str, buf: torch.Tensor, times: int = 1) -> None:
        if self.counted:
            wire_bytes[kind] += times * buf.numel() * buf.element_size()

    @staticmethod
    def finish_hop(hop) -> torch.Tensor:
        reqs, recv = hop
        for r in reqs:
            r.wait()
        return recv

    def gather(self, t: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """All-gather ``t`` over this axis, concatenated along ``dim`` in
        the axis's rank order (the reference's tiled ``all_gather``)."""
        buf = self.wire(t)
        parts = [torch.empty_like(buf) for _ in range(self.size)]
        dist.all_gather(parts, buf, group=self.group)
        self._count("gather", buf, self.size - 1)
        return self.compute(torch.cat(parts, dim=dim))

    def gather_to_first(self, t: torch.Tensor, dim: int):
        """:meth:`gather` onto this axis's first rank only (``None``
        elsewhere): each rank sends its block once.  A staged transport
        leaves the result on the host, where it arrived (a checkpoint's
        writer wants it there)."""
        buf = self.wire(t)
        parts = ([torch.empty_like(buf) for _ in range(self.size)]
                 if self.index == 0 else None)
        dist.gather(buf, parts, dst=self.ranks[0], group=self.group)
        if parts is None:
            return None
        out = torch.cat(parts, dim=dim)
        return out if self.staged else self.compute(out)

    def reduce_scatter(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block along ``dim`` of the sum of ``t`` over the
        axis, summed in fp32: an all-to-all of the blocks in ``t``'s own
        dtype, then the rank's ``size`` received blocks added locally in
        rank order.  Each rank sends (size − 1)/size of ``t`` once, half
        of what a ring all-reduce moves (gloo has no reduce-scatter)."""
        n = t.shape[dim] // self.size
        blocks = t.movedim(dim, 0).reshape(self.size, n, *(
            t.shape[:dim] + t.shape[dim + 1:]))
        buf = self.wire(blocks)
        recv = torch.empty_like(buf)
        dist.all_to_all_single(recv, buf, group=self.group)
        return self.compute(recv).float().sum(0).movedim(0, dim)

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM
                   ) -> torch.Tensor:
        buf = self.wire(t)
        if buf is t:      # reduced in place: never the caller's tensor
            buf = t.clone()
        dist.all_reduce(buf, op=op, group=self.group)
        self._count("all_reduce", buf)
        return self.compute(buf)


# ---------------------------------------------------------------------------
# Tensor parallelism of the training forward (over the ``model`` axis)
# ---------------------------------------------------------------------------

# Bytes this process handed to the ``model`` axis's collectives in a
# tensor-parallel training step, by site: ``embed`` the vocab-parallel
# lookup, ``row`` each row-parallel GEMM's fp32 output (the forward's and
# a remat recompute's), ``col`` each column-parallel region's input
# gradient, ``route`` the MoE routing weights' gradient, ``loss`` the
# vocab-parallel cross-entropy's statistics, ``ssm_norm`` the Mamba2
# gated norm's sum of squares (forward and backward), ``grads`` the
# gradients of leaves held whole whose gradient a rank gets in part,
# ``ssm_fused`` the Mamba2 fused leaves' all-gather (this rank's shard)
# and their gradients' reduce-scatter (the whole gradient), ``norm`` the
# clip's sum of squares.  The payload's bytes, each buffer once (as the
# dry run plans them); read as a difference.
tp_wire_bytes: Dict[str, int] = {}


_model = threading.local()


class model_parallel:
    """Context: the forward runs on this rank's tensor-parallel slices of
    the weights, over a ``model`` axis of ``size`` ranks at ``index``.
    ``axis(device)`` is the axis's transport (``core.distributed._Axis``),
    made when a collective first needs it.  Inside it the model code takes
    the Megatron layout: a column-parallel GEMM's input passes
    ``copy_to_model`` and a row-parallel GEMM's fp32 output
    ``reduce_from_model`` (``core.distributed``)."""

    def __init__(self, axis: Callable, size: int, index: int):
        self.axis = axis
        self.size = size
        self.index = index

    def __enter__(self):
        self.prev = getattr(_model, "cur", None)
        _model.cur = self
        return self

    def __exit__(self, *exc):
        _model.cur = self.prev


def model_parallel_state() -> Optional[model_parallel]:
    """The active :class:`model_parallel` context of more than one rank,
    or ``None`` (the forward holds whole weights)."""
    cur = getattr(_model, "cur", None)
    return cur if cur is not None and cur.size > 1 else None


def model_parallel_size() -> int:
    """Ranks of the active ``model`` axis (1 outside
    :class:`model_parallel`)."""
    ctx = model_parallel_state()
    return ctx.size if ctx is not None else 1


def model_index() -> int:
    """This rank's index along the active ``model`` axis (0 outside)."""
    ctx = model_parallel_state()
    return ctx.index if ctx is not None else 0


def count_tp_bytes(site: str, t: torch.Tensor) -> None:
    """Add ``t``'s bytes to :data:`tp_wire_bytes` at ``site``."""
    tp_wire_bytes[site] = (tp_wire_bytes.get(site, 0)
                           + t.numel() * t.element_size())


def _model_all_reduce(ctx, t: torch.Tensor, site: str,
                      op=dist.ReduceOp.SUM) -> torch.Tensor:
    out = ctx.axis(t.device).all_reduce(t, op=op)
    count_tp_bytes(site, t)
    return out


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over ``model``
    (each rank's column slice contributes a part of it)."""

    @staticmethod
    def forward(ctx, x, mp, site):
        ctx.mp, ctx.site, ctx.dtype = mp, site, x.dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        out = _model_all_reduce(ctx.mp, g.float().contiguous(), ctx.site)
        return out.to(ctx.dtype), None, None


class _ReduceFromModel(torch.autograd.Function):
    """The fp32 sum over ``model`` forward; identity backward (every rank
    holds the whole sum's gradient)."""

    @staticmethod
    def forward(ctx, x, mp, site):
        ctx.dtype = x.dtype
        return _model_all_reduce(mp, x.float().contiguous(), site)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None, None


class _AllReduceModel(torch.autograd.Function):
    """The fp32 sum over ``model`` forward and backward: a statistic each
    rank adds its part to and each rank's own consumers read."""

    @staticmethod
    def forward(ctx, x, mp, site):
        ctx.mp, ctx.site, ctx.dtype = mp, site, x.dtype
        return _model_all_reduce(mp, x.float().contiguous(), site)

    @staticmethod
    def backward(ctx, g):
        out = _model_all_reduce(ctx.mp, g.float().contiguous(), ctx.site)
        return out.to(ctx.dtype), None, None


def copy_to_model(x: torch.Tensor, site: str = "col") -> torch.Tensor:
    """A replicated activation entering a tensor-parallel region: ``x``
    itself, its gradient summed in fp32 over the active ``model`` axis.
    The identity outside :class:`model_parallel`."""
    ctx = model_parallel_state()
    return x if ctx is None else _CopyToModel.apply(x, ctx, site)


def reduce_from_model(x: torch.Tensor, site: str = "row") -> torch.Tensor:
    """The sum over the active ``model`` axis of each rank's partial
    ``x``, in fp32 (one all-reduce); the gradient passes unchanged.  The
    identity outside :class:`model_parallel`."""
    ctx = model_parallel_state()
    return x if ctx is None else _ReduceFromModel.apply(x, ctx, site)


def model_allreduce(x: torch.Tensor, site: str) -> torch.Tensor:
    """The fp32 sum over the active ``model`` axis of each rank's part of
    ``x``, its gradient summed over ``model`` too (every rank's consumers
    of the sum add to it).  The identity outside
    :class:`model_parallel`."""
    ctx = model_parallel_state()
    return x if ctx is None else _AllReduceModel.apply(x, ctx, site)


def model_max(x: torch.Tensor, site: str = "loss") -> torch.Tensor:
    """The elementwise max of ``x`` over the active ``model`` axis, no
    gradient (``x`` itself outside the context)."""
    ctx = model_parallel_state()
    if ctx is None:
        return x
    return _model_all_reduce(ctx, x.detach().float().contiguous(), site,
                             op=dist.ReduceOp.MAX)


def model_sum(x: torch.Tensor, site: str) -> torch.Tensor:
    """``x`` summed in fp32 over the active ``model`` axis, no gradient
    (``x`` itself outside the context)."""
    ctx = model_parallel_state()
    if ctx is None:
        return x
    return _model_all_reduce(ctx, x.detach().float().contiguous(), site)


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------

def _fault_check() -> None:
    """Chaos hook (FaultPlan) on the distributed dispatch path: one
    dispatch index per ring step, at the same point on every rank."""
    from repro_torch.core.gemm import _fault_check as check  # lazy: cycle

    check(_STAGE)


def _ring_chain(a_blk: torch.Tensor, acc: torch.Tensor,
                partial_fn: Callable, ax: _Axis, *,
                pipelined: bool = True) -> torch.Tensor:
    """The rotating-A chain of every ring schedule.  ``partial_fn(a_cur,
    chunk)`` is one local partial product for k-chunk ``chunk``; rank j
    at step s holds A chunk ``(j − s) mod g``, the paper's PE chain.

    Pipelined: at each step the fault hook runs first (before any of the
    step's transfers), then the hop feeding step s+1 is issued, then the
    step's local GEMM, and the hop is waited on only when step s+1 needs
    its buffer: exactly g−1 hops.  Unpipelined: one fault check, then
    compute and rotate g times (the last hop dead)."""
    g, j = ax.size, ax.index
    buf = ax.wire(a_blk)
    a_cur = a_blk
    if not pipelined:
        _fault_check()
        for s in range(g):
            acc = acc + partial_fn(a_cur, (j - s) % g)
            buf = ax.finish_hop(ax.start_hop(buf))
            a_cur = ax.compute(buf)
        return acc
    for s in range(g):
        _fault_check()
        hop = ax.start_hop(buf) if s + 1 < g else None
        acc = acc + partial_fn(a_cur, (j - s) % g)
        if hop is not None:
            buf = ax.finish_hop(hop)
            a_cur = ax.compute(buf)
    return acc


def _dequant_rows(data_rows: torch.Tensor, scale_rows: torch.Tensor,
                  block: int) -> torch.Tensor:
    """fp32 values of a k-slice of an int8 weight: ``scale_rows`` is the
    matching slice of the scale, ``(1, nloc)`` per channel (block 0) or
    ``(rows/block, nloc)`` per tile."""
    s = scale_rows.float()
    if block:
        s = torch.repeat_interleave(s, block, dim=0)[:data_rows.shape[0]]
    return data_rows.float() * s


def _int_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 × int8 summed exactly into int32 by an fp64 product, exact
    while k·127² < 2^53 (``torch.matmul`` has no integer kernel on the
    card, and ``torch._int_mm`` refuses m <= 16, every decode row
    count)."""
    k = a.shape[1]
    if k * 127 * 127 >= 2 ** 53:
        raise ValueError(f"k = {k}: an fp64 int8 product is not exact")
    return (a.double() @ b.double()).round().int()


def wire_traffic(before: Dict[str, int], pods: int = 1) -> float:
    """Per-rank wire bytes of the dispatches since ``before`` (a copy of
    :data:`wire_bytes`) in :func:`estimate_cost`'s terms: the ring chunks
    sent, the A panels received, and for each payload all-reduced over a
    pod axis of ``pods`` ranks the 2(pods−1)/pods of it a ring
    all-reduce moves (the model's charge; the backend's own algorithm is
    not observed)."""
    d = {k: wire_bytes[k] - before.get(k, 0) for k in wire_bytes}
    return float(d["hop"] + d["gather"]
                 + 2.0 * (pods - 1) / max(pods, 1) * d["all_reduce"])


def _axis_size(mesh, axis: Optional[str]) -> int:
    if axis is None:
        return 1
    names = tuple(mesh.mesh_dim_names)
    if axis not in names:
        raise _dist_error(f"mesh axes {names} have no {axis!r}")
    return int(mesh.shape[names.index(axis)])


def dist_matmul(a, b, mesh, *, schedule: str = "auto",
                dp_axis: str = "data", tp_axis: str = "model",
                pod_axis: Optional[str] = None, out_dtype=None,
                hw: HopperTarget = H100):
    """Distributed C = A @ B on a named ``DeviceMesh``; returns a
    ``DTensor``.

    Logical sharding: A is (m, k), m over ``dp_axis`` and k over
    ``tp_axis``; B is (k, n), n over ``tp_axis``; C comes back (m, n)
    sharded (dp, tp).  With ``pod_axis`` (2.5-D) k is split over (pod,
    tp), pod major, and C partials are all-reduced over the pod axis.
    ``a`` and ``b`` are ``DTensor`` s (redistributed on entry: a local
    chunk when B is replicated over k and the axes A's spec shards) or
    plain tensors holding the global value on every rank.

    ``b`` may be a :class:`~repro_torch.quant.QTensor` whose payload and
    scale are such tensors: int8 weights ride the ring with their
    per-channel or per-tile scales (dequant folded into each step's
    partial), and a per-tensor static ``act_scale`` quantizes A on entry
    so its int8 payload rides the ring; fp8 emulation weights dequantize
    onto the dense path.  ``m`` may be ragged (padded to a ``dp``
    multiple and sliced back); ``n`` and ``k`` must divide exactly.

    Faults (the port's departure from the reference, which re-dispatches
    its GSPMD oracle on any failure): only a non-fatal
    ``InjectedKernelFailure`` of an active ``FaultPlan`` re-dispatches,
    as the same schedule, counted in
    ``gemm.fallback_total{stage="dist_matmul"}``; the plan fires at the
    same dispatch index on every rank, so every rank re-dispatches
    together.  Every other error propagates."""
    from repro_torch.runtime.fault import InjectedKernelFailure

    if schedule not in SCHEDULES + ("auto",):
        raise _dist_error(f"unknown schedule {schedule!r} "
                          f"(valid: {SCHEDULES + ('auto',)})")
    kw = dict(schedule=schedule, dp_axis=dp_axis, tp_axis=tp_axis,
              pod_axis=pod_axis, out_dtype=out_dtype, hw=hw)
    try:
        return _dist_matmul_impl(a, b, mesh, record=True, **kw)
    except InjectedKernelFailure as e:
        from repro_torch.core.gemm import _note_fallback  # lazy: cycle

        _note_fallback(_STAGE, e)   # re-raises if fatal or disabled
        return _dist_matmul_impl(a, b, mesh, record=False, **kw)


def _dist_matmul_impl(a, b, mesh, *, schedule, dp_axis, tp_axis, pod_axis,
                      out_dtype, hw, record):
    from torch.distributed.tensor import DTensor

    from repro_torch.analyze.preflight import preflight_dist
    from repro_torch.core.gemm import dist_local_matmul
    from repro_torch.quant.scales import (QTensor, fake_quant_activation,
                                          quantize_activation)

    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"a {tuple(a.shape)} does not contract with b "
                         f"{tuple(b.shape)}")
    out_dtype = out_dtype or a.dtype
    dp = _axis_size(mesh, dp_axis)
    tp = _axis_size(mesh, tp_axis)
    pods = _axis_size(mesh, pod_axis)

    # -- quantized operand normalization ------------------------------------
    b_q = None
    if isinstance(b, QTensor):
        if b.fmt != "int8":   # fp8 emulation: the dense path
            b = _qtensor_global(b).dequantize(a.dtype)
        else:
            b_q = b
    a_is_int = not a.dtype.is_floating_point
    # A per-tensor static act scale makes A ride the ring as its int8
    # payload; per-k-tile act scales cannot factor out of the rotated
    # chunks, so they fake-quant on entry and ride float.
    ride_int8 = (b_q is not None and b_q.act_scale is not None
                 and b_q.act_block == 0 and not a_is_int)
    dtype_b = torch.int8 if b_q is not None else None
    dtype_a = torch.int8 if ride_int8 else None
    b_block = b_q.block if b_q is not None else 0
    # Pure-int chain: every partial is an exact int8 x int8 -> int32 sum
    # (the per-channel b scale and the scalar act scale factor out of the
    # contraction and apply once at the drain).
    pure_int = (ride_int8 and b_block == 0) or (a_is_int and b_q is None)
    wire_itemsize = 1 if ride_int8 else a.dtype.itemsize
    m_pad = -(-m // dp) * dp

    # -- schedule choice + registry-tuned local step ------------------------
    if schedule == "auto":
        schedule = choose_schedule(
            m_pad, n, k, wire_itemsize, dp, tp, pods, hw, a.dtype,
            dtype_b=dtype_b, dtype_a=dtype_a, use_registry=True).schedule
    if schedule == "summa25d" and pod_axis is None:
        raise _dist_error("summa25d needs a replication (pod) axis")
    ring = schedule in _RING_SCHEDULES
    scale_rows = int(b_q.scale.shape[0]) if (b_q is not None and b_block) \
        else 0
    preflight_dist(schedule, (dp, tp, pods), (m, n, k),
                   b_block=b_block if ring else 0, scale_rows=scale_rows)
    res, tag, (mloc, nloc, kstep, steps) = dist_local_resolution(
        schedule, m_pad, n, k, dp=dp, tp=tp, pods=pods, dtype=a.dtype,
        hw=hw, dtype_b=dtype_b, dtype_a=dtype_a)
    tile = res.config
    cost = estimate_cost(schedule, m_pad, n, k, wire_itemsize, dp, tp, pods,
                         hw, a.dtype, tile=tile, dtype_b=dtype_b,
                         dtype_a=dtype_a)

    # -- operands: this rank's shards ---------------------------------------
    a_spec = (dp_axis, (pod_axis, tp_axis) if pod_axis else tp_axis)
    b_spec = (pod_axis, tp_axis) if (pod_axis and ring) else (None, tp_axis)
    a_loc = _local(a, mesh, a_spec)
    rows = a_loc.shape[0]
    device = a_loc.device
    if b_q is not None:
        b_loc = _local(b_q.data, mesh, b_spec)
        # Per-channel (1, n) scales replicate over k; per-tile rows follow
        # b's k rows (split over pods on the 2.5-D meshes).
        scale_k = pod_axis if (b_block and pod_axis and ring) else None
        s_loc = _local(b_q.scale, mesh, (scale_k, tp_axis)).float()
        if b_q.act_scale is not None and not a_is_int:
            act = _replicated(b_q.act_scale).to(device, torch.float32)
            a_loc = (quantize_activation(a_loc, act, 0) if ride_int8
                     else fake_quant_activation(a_loc, act, b_q.act_block))
    else:
        b_loc = _local(b, mesh, b_spec)
        s_loc = None
    if rows != mloc:   # ragged m: pad this rank's rows to m/dp
        a_loc = torch.cat([a_loc, a_loc.new_zeros(mloc - rows,
                                                  a_loc.shape[1])])
    a_loc = a_loc.contiguous()
    b_loc = b_loc.contiguous()
    if record:
        _record_dist(schedule=schedule, m=m_pad, n=n, k=k, dp=dp, tp=tp,
                     pods=pods, dtype=a.dtype, dtype_b=dtype_b,
                     dtype_a=dtype_a, tag=tag, cost=cost, tile=tile,
                     source=res.source, hw=hw, device=device,
                     quantized=b_q is not None)

    acc_dtype = torch.int32 if pure_int else torch.float32

    def local_partial(a_cur, b_rows, s_rows):
        """One chunk's partial product on this rank."""
        if b_q is None and not pure_int:
            return dist_local_matmul(a_cur, b_rows, tile=tile)
        if pure_int:
            return _int_product(a_cur, b_rows)
        return a_cur.float() @ _dequant_rows(b_rows, s_rows, b_block)

    tp_ax = _Axis(mesh, tp_axis, device, counted=True)
    pod_ax = _Axis(mesh, pod_axis, device, counted=True) if pod_axis \
        else None
    if schedule == "allgather":
        # The paper's rejected broadcast topology: full-panel gather.
        a_full = tp_ax.gather(a_loc)
        if pod_ax is not None:
            a_full = pod_ax.gather(a_full)
        _fault_check()
        c_loc = local_partial(a_full.contiguous(), b_loc, s_loc)
    else:
        kchunk = a_loc.shape[1]

        def partial_fn(a_cur, chunk):
            b_rows = b_loc[chunk * kchunk:(chunk + 1) * kchunk]
            s_rows = s_loc
            if s_loc is not None and b_block:
                srows = kchunk // b_block
                s_rows = s_loc[chunk * srows:(chunk + 1) * srows]
            return local_partial(a_cur, b_rows, s_rows)

        acc0 = torch.zeros((mloc, b_loc.shape[1]), dtype=acc_dtype,
                           device=device)
        c_loc = _ring_chain(a_loc, acc0, partial_fn, tp_ax,
                            pipelined=schedule != "ring_unpipelined")
        if pod_ax is not None:
            c_loc = pod_ax.all_reduce(c_loc)

    # -- drain: factored scales, output cast, ragged rows -------------------
    if ride_int8:
        c_loc = c_loc.float() * act.reshape(())
        if b_block == 0:
            c_loc = c_loc * s_loc      # (1, nloc) column broadcast
    c_loc = c_loc.to(out_dtype)[:rows]
    return DTensor.from_local(
        c_loc, mesh, placements_for((dp_axis, tp_axis), mesh),
        run_check=False, shape=torch.Size((m, n)), stride=(n, 1))


def _replicated(t) -> torch.Tensor:
    """The full value, on this rank, of a plain tensor or of a
    ``DTensor``: its shards gathered along each sharded mesh dim,
    innermost first (undoing the nesting of a tensor dim split over
    several mesh dims), on the schedules' transport."""
    from torch.distributed.tensor import DTensor

    if not isinstance(t, DTensor):
        return torch.as_tensor(t)
    mesh = t.device_mesh
    names = tuple(mesh.mesh_dim_names)
    loc = t.to_local()
    for mdim in reversed(range(mesh.ndim)):
        p = t.placements[mdim]
        if p.is_partial():
            raise ValueError("a partial DTensor has no value to gather")
        if p.is_shard():
            ax = _Axis(mesh, names[mdim], loc.device)
            if loc.shape[p.dim] * ax.size != _span(t, mesh, mdim, p.dim):
                raise ValueError(f"uneven shards of {tuple(t.shape)} over "
                                 f"{names[mdim]}")
            loc = ax.gather(loc.contiguous(), p.dim)
    return loc


def _span(t, mesh, mdim: int, dim: int) -> int:
    """The extent of tensor dim ``dim`` that mesh dim ``mdim``'s shards
    split: the global size over the mesh dims before it sharding it."""
    size = t.shape[dim]
    for before in range(mdim):
        p = t.placements[before]
        if p.is_shard() and p.dim == dim:
            size //= int(mesh.shape[before])
    return size


def full_output(c, mesh, *, dp_axis: str = "data",
                tp_axis: str = "model") -> torch.Tensor:
    """The full (m, n) value, on every rank, of a :func:`dist_matmul`
    output sharded (dp, tp): gathered over tp, then over dp, on the
    schedules' transport (pinned host copies for card ranks under gloo),
    ragged rows padded for the gather and sliced off."""
    m, n = c.shape
    loc = c.to_local()
    dp = _axis_size(mesh, dp_axis)
    mloc = -(-m // dp)
    if loc.shape[0] != mloc:
        loc = torch.cat([loc, loc.new_zeros(mloc - loc.shape[0],
                                            loc.shape[1])])
    full = _Axis(mesh, tp_axis, loc.device).gather(loc.contiguous(), 1)
    if dp > 1:
        full = _Axis(mesh, dp_axis, loc.device).gather(full, 0)[:m]
    return full


def _qtensor_global(q):
    """A QTensor whose payload and scales are full tensors on this rank
    (the fp8 path dequantizes the whole weight, as the reference's)."""
    return dataclasses.replace(
        q, data=_replicated(q.data), scale=_replicated(q.scale),
        act_scale=None if q.act_scale is None else _replicated(q.act_scale))


def _record_dist(*, schedule, m, n, k, dp, tp, pods, dtype, dtype_b,
                 dtype_a, tag, cost, tile, source, hw, device, quantized):
    """Ledger hook: one ``dist`` record per dispatch (no-op disabled).
    ``mode`` is the local step's route: ``plain`` on the CPU and for the
    int8 partials (plain products, as in the reference), on the card the
    K1 route of the tile."""
    from repro_torch.kernels import ca_mmm as kern
    from repro_torch.obs.ledger import get_ledger

    led = get_ledger()
    if not led.enabled:
        return
    mode = "plain" if (device.type == "cpu" or quantized) else \
        kern.tile_route((tile.bm, tile.bn, tile.bk))
    led.record_dist(
        schedule=schedule, m=m, n=n, k=k, dp=dp, tp=tp, pods=pods,
        dtype=dtype, dtype_b=dtype_b, dtype_a=dtype_a, tag=tag, mode=mode,
        steps=cost.steps,
        config={"bm": tile.bm, "bn": tile.bn, "bk": tile.bk,
                "order": tile.order, "mloc": int(-(-m // dp)),
                "nloc": int(n // tp),
                "kstep": int(k // (tp * pods)) if schedule in _RING_SCHEDULES
                else int(k // pods)},
        config_source=source, planned_bytes=cost.comm_bytes,
        planned_flops=2.0 * m * n * k, planned_s=cost.time_s, hw=hw)


def dist_matmul_reference(a, b, mesh, dp_axis: str = "data",
                          tp_axis: str = "model",
                          pod_axis: Optional[str] = None, out_dtype=None):
    """The oracle: DTensor's own ``a @ b`` on the schedules' placements,
    its sharding propagation deciding the collectives (the reference's
    GSPMD oracle, sharding constraints only).  The same ``out_dtype``
    contract (default: A's dtype), QTensor semantics (a static act
    scale fake-quants A on entry, the weight dequantizes) and ragged-m
    contract as :func:`dist_matmul`; returns a ``DTensor`` sharded (dp,
    tp)."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.quant.scales import QTensor, fake_quant_activation

    out_dtype = out_dtype or a.dtype
    a = _replicated(a)
    if isinstance(b, QTensor):
        q = _qtensor_global(b)
        if q.act_scale is not None and a.dtype.is_floating_point:
            a = fake_quant_activation(a, q.act_scale, q.act_block)
        b = q.dequantize(a.dtype)
    else:
        b = _replicated(b)
    # A ragged m shards as the padded rows would (DTensor's uneven
    # shards), so the (m, n) result needs no padding here.
    repl = [Replicate()] * mesh.ndim
    kspec = (pod_axis, tp_axis) if pod_axis else tp_axis
    a_d = DTensor.from_local(a, mesh, repl, run_check=False).redistribute(
        mesh, placements_for((dp_axis, kspec), mesh))
    b_d = DTensor.from_local(b, mesh, repl, run_check=False).redistribute(
        mesh, placements_for((pod_axis, tp_axis), mesh))
    if a.dtype.is_floating_point:
        c = a_d.float() @ b_d.float()
    else:
        c = a_d.long() @ b_d.long()
    c = c.redistribute(mesh, placements_for((dp_axis, tp_axis), mesh))
    return c.to(out_dtype)
