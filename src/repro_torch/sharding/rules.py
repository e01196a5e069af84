"""Logical-axis -> mesh-axis rule engine with divisibility checks (port of
``repro/sharding/rules.py``).

Parameters declare *logical* axes (embed, mlp, qkv, expert, vocab, ...);
this module maps them to the mesh's named axes.  Non-divisible dims are
left unsharded instead of failing (e.g. minicpm3's 40 heads on a 16-way
model axis).

A spec is the ``PartitionSpec`` analog: a tuple with one entry per tensor
dim, each ``None``, a mesh-axis name or a tuple of names (major first).
A :class:`NamedSharding` is a spec on a mesh, the reference's
``jax.sharding.NamedSharding``: its rank-local shard shape
(``shard_shape``), the slice of a global tensor a rank holds
(``local``), the gather of those slices back to the whole (``gather``)
and its DTensor ``placements`` on a named ``DeviceMesh``.  The rules
themselves read only axis names and sizes, so they also run on an
:class:`~repro_torch.launch.mesh.AbstractMesh`.

:class:`batch_statistics` is the rank-local training step's counterpart
of GSPMD computing a statistic over the global batch: inside it,
:func:`batch_sum` sums a loss statistic over the batch axes' ranks.

FSDP: with ``fsdp=True`` the 'embed' logical axis (rows of most weight
matrices) is also sharded over the data axis.

Tensor parallelism in a rank-local training step: :func:`tp_dims` gives
the tensor dim of each leaf that the TP layout shards over ``model``,
:func:`split_heads` the leaves whose ``qkv`` shard is not a whole number
of heads (``train.fsdp.tp_refusal`` raises on them).  Inside
``core.distributed.model_parallel`` the model code runs on this rank's
slices.  :func:`recompute_contexts` carries that context and this
module's into a remat recompute.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import (TYPE_CHECKING, Callable, Dict, Mapping, NamedTuple,
                    Optional, Sequence, Tuple)

import torch

from repro_torch.core.distributed import _model
from repro_torch.launch.mesh import axis_sizes

if TYPE_CHECKING:  # annotation-only (models imports its own modules)
    from repro_torch.models.common import Defs

Spec = Tuple[object, ...]

# Logical axis -> preferred mesh axis (tensor-parallel dims).
TP_RULES: Dict[str, Optional[str]] = {
    "vocab": "model",
    "mlp": "model",
    "qkv": "model",      # fused heads*head_dim projections
    "expert": "model",   # EP when divisible, else w falls back to mlp dim
    "ssm": "model",      # fused mamba projections / conv channels
    "lora": None,        # MLA latent dims stay replicated (small)
    "embed": None,
    "embed2": None,
    "layers": None,
}


def _axis_for(logical: Optional[str], size: int, sizes: Dict[str, int],
              used: set, fsdp: bool, fsdp_axes: Tuple[str, ...]):
    if logical is None:
        return None
    pref = TP_RULES.get(logical)
    if pref and pref in sizes and pref not in used \
            and size % sizes[pref] == 0:
        used.add(pref)
        return pref
    if fsdp and logical in ("embed",):
        axes = tuple(a for a in fsdp_axes if a in sizes and a not in used)
        if axes:
            total = 1
            for a in axes:
                total *= sizes[a]
            if size % total == 0:
                used.update(axes)
                return axes if len(axes) > 1 else axes[0]
    return None


def pspec_for_def(axes: Sequence[Optional[str]], shape: Sequence[int],
                  mesh, *, fsdp: bool = False,
                  fsdp_axes: Tuple[str, ...] = ("data",)) -> Spec:
    """The spec of one parameter.  Tensor-parallel dims claim their axes
    first (priority over FSDP), in dim order after the replicated-kind
    dims are moved last: the Megatron column-parallel convention."""
    sizes = axis_sizes(mesh)
    used: set = set()
    entries = [None] * len(shape)
    order = sorted(range(len(shape)),
                   key=lambda i: (axes[i] in (None, "embed", "embed2"), i))
    for i in order:
        entries[i] = _axis_for(axes[i], shape[i], sizes, used, fsdp,
                               fsdp_axes)
    return tuple(entries)


def pspecs_for_defs(defs: "Defs", mesh, *, fsdp: bool = False,
                    fsdp_axes: Tuple[str, ...] = ("data",)
                    ) -> Dict[str, Spec]:
    return {k: pspec_for_def(d.axes, d.shape, mesh, fsdp=fsdp,
                             fsdp_axes=fsdp_axes)
            for k, d in defs.items()}


def tp_dims(defs: "Defs", mesh, axis: str = "model"
            ) -> Dict[str, Optional[int]]:
    """For each leaf, the tensor dim that the TP layout
    (``pspecs_for_defs(defs, mesh, fsdp=False)``) shards over ``axis``,
    or ``None`` where the leaf is held whole on every rank of it."""
    out: Dict[str, Optional[int]] = {}
    for k, spec in pspecs_for_defs(defs, mesh, fsdp=False).items():
        dims = [i for i, e in enumerate(spec) if axis in spec_axes(e)]
        out[k] = dims[0] if dims else None
    return out


def split_heads(defs: "Defs", mesh, head_widths: Mapping[str, int],
                axis: str = "model") -> Dict[str, str]:
    """The leaves whose ``qkv`` dim the TP layout shards over ``axis``
    into a slice that is not a whole number of heads: leaf -> why.
    ``head_widths`` maps a leaf's last key part (``wq``, ``wkv_b``, ...)
    to the width of one of its heads."""
    sizes = axis_sizes(mesh)
    n = sizes.get(axis, 1)
    out = {}
    for k, dim in tp_dims(defs, mesh, axis).items():
        d = defs[k]
        if dim is None or d.axes[dim] != "qkv":
            continue
        width = head_widths.get(k.rsplit("/", 1)[-1])
        if width is None:
            continue
        local = d.shape[dim] // n
        if local % width:
            out[k] = (f"{d.shape[dim]} columns, heads of {width}, over "
                      f"{axis} = {n}: {local} columns a rank")
    return out


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, major first."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


class ShapeDtypeStruct(NamedTuple):
    """A leaf's global shape and dtype, with nothing allocated (the
    reference's ``jax.ShapeDtypeStruct``)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * self.dtype.itemsize


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (a named ``DeviceMesh`` or an ``AbstractMesh``):
    which slice of a global tensor each rank holds.  A tensor dim over
    several axes is split major first, as the reference's
    ``PartitionSpec`` splits it: chunk ``Σ_j coord(a_j) · Π_{l>j}
    size(a_l)``.  Every sharded dim must divide by its axes' product."""

    mesh: object
    spec: Spec

    def _entry(self, dim: int):
        return self.spec[dim] if dim < len(self.spec) else None

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """The rank-local shape of a global ``shape``: the reference's
        ``NamedSharding.shard_shape``."""
        sizes = axis_sizes(self.mesh)
        out = []
        for dim, size in enumerate(shape):
            n = 1
            for a in spec_axes(self._entry(dim)):
                n *= sizes[a]
            if size % n:
                raise ValueError(f"dim {dim} of {tuple(shape)} does not "
                                 f"divide over {self._entry(dim)} ({n})")
            out.append(size // n)
        return tuple(out)

    def coords(self) -> Dict[str, int]:
        """This rank's index along each mesh axis (a ``DeviceMesh``)."""
        return {a: self.mesh.get_local_rank(a) for a in axis_sizes(self.mesh)}

    def local_slices(self, shape: Sequence[int],
                     coords: Optional[Mapping[str, int]] = None
                     ) -> Tuple[slice, ...]:
        """The slice of a global ``shape`` held at ``coords`` (default:
        this rank's on the mesh)."""
        coords = self.coords() if coords is None else coords
        sizes = axis_sizes(self.mesh)
        local = self.shard_shape(shape)
        out = []
        for dim, n in enumerate(local):
            idx = 0
            for a in spec_axes(self._entry(dim)):
                idx = idx * sizes[a] + coords[a]
            out.append(slice(idx * n, (idx + 1) * n))
        return tuple(out)

    def local(self, full: torch.Tensor,
              coords: Optional[Mapping[str, int]] = None) -> torch.Tensor:
        """This rank's slice of the global ``full`` (a view)."""
        return full[self.local_slices(tuple(full.shape), coords)]

    def gather(self, local: torch.Tensor, to_first: bool = False,
               axes: Optional[Sequence[str]] = None):
        """The global tensor from this rank's slice: an all-gather over
        each sharded dim's axes of more than one rank, innermost first,
        on the schedules' transport (``core.distributed._Axis``: pinned host copies for card
        tensors under gloo).  With ``to_first`` only the mesh's first rank
        (every coordinate 0) receives it, the others return ``None``.
        ``axes`` limits the gather to those mesh axes (the slice stays
        split over the others).  A collective: every rank of the mesh
        calls it."""
        from repro_torch.core.distributed import _Axis  # lazy: cycle

        sizes = axis_sizes(self.mesh)
        out = local
        for dim in range(local.dim()):
            for a in reversed(spec_axes(self._entry(dim))):
                if out is None:      # dropped out at an inner axis
                    return None
                if sizes[a] == 1 or (axes is not None and a not in axes):
                    continue
                ax = _Axis(self.mesh, a, local.device)
                out = (ax.gather_to_first(out.contiguous(), dim) if to_first
                       else ax.gather(out.contiguous(), dim))
        if to_first and out is not None and any(self.coords().values()):
            return None              # no sharded dim: only the first keeps it
        return out

    @property
    def placements(self) -> list:
        """DTensor placements (one per mesh dim) on a named
        ``DeviceMesh``."""
        from repro_torch.core.distributed import placements_for

        return placements_for(self.spec, self.mesh)


def shardings_for_defs(defs: "Defs", mesh, **kw) -> Dict[str, NamedSharding]:
    """Each parameter's :class:`NamedSharding` (its mesh and spec)."""
    return {k: NamedSharding(mesh, s)
            for k, s in pspecs_for_defs(defs, mesh, **kw).items()}


def dist_operand_specs(axes: Sequence[Optional[str]], shape: Sequence[int],
                       mesh, *, dp_axis: str = "data",
                       tp_axis: str = "model"
                       ) -> Optional[Tuple[Spec, Spec, Spec]]:
    """Specs under which ``core.distributed.dist_matmul`` consumes a
    (rows, k) activation against this (k, n) weight def.

    Returns ``(a_spec, b_spec, c_spec)``: B n-sharded over the model axis
    (column-parallel, the only layout the ring schedules implement), A
    (dp, tp)-sharded with k over the ring axis; or ``None`` when the
    weight cannot ride the ring (not 2-D, no tp axis, or k or n not
    divisible by the tp degree).  The def's logical output axis need not
    map to the model axis: the ring re-shards its stationary operand
    anyway, so any divisible projection (wo included) may ride it."""
    sizes = axis_sizes(mesh)
    if len(shape) != 2 or tp_axis not in sizes:
        return None
    tp = sizes[tp_axis]
    k, n = shape
    if n % tp or k % tp:
        return None
    return ((dp_axis, tp_axis), (None, tp_axis), (dp_axis, tp_axis))


# ---------------------------------------------------------------------------
# Activation sharding policy (threaded through model code via maybe_shard)
# ---------------------------------------------------------------------------

_policy = threading.local()


class activation_sharding:
    """Context: route ``maybe_shard`` logical specs onto a mesh.

    Logical entries: "batch" -> the batch axes tuple (("pod", "data") on
    the multi-pod mesh), "seq" -> the sequence-parallel axis,
    "model_dim" -> model."""

    def __init__(self, mesh, batch_axes: Tuple[str, ...],
                 seq_axis: Optional[str] = None):
        sizes = axis_sizes(mesh)
        self.table = {
            "batch": tuple(a for a in batch_axes if a in sizes),
            "seq": seq_axis,
            "model_dim": "model" if "model" in sizes else None,
        }
        self.mesh = mesh

    def __enter__(self):
        self.prev = getattr(_policy, "cur", None)
        _policy.cur = self
        return self

    def __exit__(self, *exc):
        _policy.cur = self.prev


def activation_spec(shape: Sequence[int], logical: Sequence[Optional[str]]
                    ) -> Optional[Spec]:
    """The spec :func:`maybe_shard` would constrain ``shape`` to under the
    active policy (None outside the context): divisibility-checked per
    dim, a mesh axis used at most once (first dim wins)."""
    pol = getattr(_policy, "cur", None)
    if pol is None:
        return None
    sizes = axis_sizes(pol.mesh)
    entries = []
    used: set = set()
    for dim, name in enumerate(logical):
        ax = pol.table.get(name) if name else None
        if not ax:
            entries.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        if any(a in used for a in axes):
            entries.append(None)
            continue
        total = 1
        for a in axes:
            total *= sizes[a]
        if total and shape[dim] % total == 0 and shape[dim] >= total:
            entries.append(ax)
            used.update(axes)
        else:
            entries.append(None)
    return tuple(entries)


def maybe_shard(x: torch.Tensor, logical: Sequence[Optional[str]]):
    """Constrain ``x`` to the active policy's mesh along logical axes: a
    no-op outside :class:`activation_sharding`.  Inside it, a ``DTensor``
    is redistributed to the spec's placements (the reference's
    ``with_sharding_constraint``); a plain tensor, which carries no
    placement to constrain, passes through unchanged."""
    spec = activation_spec(tuple(x.shape), logical)
    if spec is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    from repro_torch.core.distributed import placements_for

    pol = _policy.cur
    return x.redistribute(pol.mesh, placements_for(spec, pol.mesh))


# ---------------------------------------------------------------------------
# Batch statistics of a rank-local training step
# ---------------------------------------------------------------------------

_batch = threading.local()


class batch_statistics:
    """Context: the loss's batch statistics are global over ``ranks``
    batch ranks.  ``reduce_sum(t)`` sums a tensor over them (a
    collective).  Each rank holds its slice of the global batch and its
    gradients are mean-reduced over the batch ranks afterwards
    (``train.fsdp``), so inside the context :func:`batch_sum` returns the
    global sum as its value and ``ranks`` times the local statistic's
    gradient: the mean of those gradients over the ranks is the global
    statistic's gradient.  Outside it :func:`batch_sum` is the identity."""

    def __init__(self, reduce_sum: Callable[[torch.Tensor], torch.Tensor],
                 ranks: int):
        self.reduce_sum = reduce_sum
        self.ranks = ranks

    def __enter__(self):
        self.prev = getattr(_batch, "cur", None)
        _batch.cur = self
        return self

    def __exit__(self, *exc):
        _batch.cur = self.prev


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of the statistic ``x`` over the batch ranks (see
    :class:`batch_statistics`); ``x`` itself outside the context."""
    pol = getattr(_batch, "cur", None)
    if pol is None:
        return x
    # x - x.detach() is exactly 0 with x's gradient: the value is the
    # reduced sum bit for bit.
    return pol.reduce_sum(x.detach()) + pol.ranks * (x - x.detach())


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the batch ranks, each holding as many
    entries (a per-token mean's global value); ``x`` outside the
    context."""
    pol = getattr(_batch, "cur", None)
    if pol is None:
        return x
    return batch_sum(x) / pol.ranks


# ---------------------------------------------------------------------------
# The contexts a remat recompute enters again
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _entered(batch, model, policy):
    prev = (getattr(_batch, "cur", None), getattr(_model, "cur", None),
            getattr(_policy, "cur", None))
    _batch.cur, _model.cur, _policy.cur = batch, model, policy
    try:
        yield
    finally:
        _batch.cur, _model.cur, _policy.cur = prev


def recompute_contexts():
    """``context_fn`` of ``torch.utils.checkpoint``: this module's
    contexts and ``core.distributed.model_parallel`` as the forward sees
    them, entered again around the
    recompute, which runs in the backward, on the autograd engine's own
    thread for card tensors (these contexts are per thread).  The
    recompute then issues the forward's collectives again, on every rank
    in the same order."""
    saved = (getattr(_batch, "cur", None), getattr(_model, "cur", None),
             getattr(_policy, "cur", None))
    return contextlib.nullcontext(), _entered(*saved)
