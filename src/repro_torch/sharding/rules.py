"""Logical-axis -> mesh-axis rule engine with divisibility checks (port of
``repro/sharding/rules.py``).

Parameters declare *logical* axes (embed, mlp, qkv, expert, vocab, ...);
this module maps them to the mesh's named axes.  Non-divisible dims are
left unsharded instead of failing (e.g. minicpm3's 40 heads on a 16-way
model axis).

A spec is the ``PartitionSpec`` analog: a tuple with one entry per tensor
dim, each ``None``, a mesh-axis name or a tuple of names (major first).
:func:`shardings_for_defs` turns specs into DTensor ``Placement`` s on a
named ``DeviceMesh``; the rules themselves read only axis names and
sizes, so they also run on an :class:`~repro_torch.launch.mesh.
AbstractMesh`.

FSDP: with ``fsdp=True`` the 'embed' logical axis (rows of most weight
matrices) is also sharded over the data axis.
"""

from __future__ import annotations

import threading
from typing import TYPE_CHECKING, Dict, Optional, Sequence, Tuple

import torch

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


def shardings_for_defs(defs: "Defs", mesh, **kw) -> Dict[str, list]:
    """DTensor placements (one per mesh dim) of each parameter on a named
    ``DeviceMesh``: the ``NamedSharding`` analog."""
    from repro_torch.core.distributed import placements_for

    return {k: placements_for(s, mesh)
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
