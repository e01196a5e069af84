"""FSDP training on a named mesh: the weight-hoist reshard hooks of the
reference's ``lower_cell`` (``src/repro/launch/dryrun.py:86-110``), run
rank-local over ``torch.distributed``.

The reference states the layout and GSPMD partitions one global program:
the fp32 masters and both AdamW moments live sharded over the batch axes
(``pspecs_for_defs(fsdp=True, fsdp_axes=batch_axes(mesh))``, ZeRO-3),
``reshard_params`` constrains the step's cast bf16 copy to the
tensor-parallel layout (one all-gather a step, hoisted out of the
microbatch loop), and ``reshard_grads`` constrains each microbatch's
gradients back onto the FSDP layout (a reduce-scatter, ZeRO-2).  Here
each rank runs the step on its own slice of the global batch and the
hooks move the bytes themselves:

* ``reshard_params`` all-gathers every leaf from its FSDP shard to the
  whole (the TP-only layout: the mesh's ``model`` axis has size 1);
* ``reshard_grads`` mean-reduce-scatters every gradient onto its FSDP
  shard, summed in fp32: over each batch axis, major first, an
  all-to-all of the blocks (the first in the gradient's own dtype, then
  the fp32 partial sums) and a local sum (gloo has no reduce-scatter);
  it mean-reduces the leaves that every rank holds whole.  Given meta
  tensors (the microbatch accumulator's zeros) it returns meta tensors
  of the shard shapes.

Both are callables with a ``layout`` (:class:`FsdpLayout`), from which
``train.step.build_train_step`` also takes what GSPMD would compute over
the global batch and the global tree: the loss's batch statistics
(``sharding.rules.batch_statistics``: the masked loss's numerator and
denominator, the MoE aux's two means) and the clip's global norm, whose
sum of squares is all-reduced once over the shards, a leaf that every
rank holds whole counted once.  Collectives on card tensors under a
backend other than NCCL go through pinned host copies
(``core.distributed._Axis``).

The layout itself takes any mesh: the dry run plans the hooks' bytes on
the production meshes from it.  Running the step on a mesh whose
``model`` axis is larger than 1 raises (the hooks, ``init_state``,
``local_batch`` and ``build_train_step``): the reference shards a
training forward over ``model`` only inside its compile-only dry run,
and the port has no tensor-parallel training forward.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.mesh import axis_sizes, batch_axes
from repro_torch.sharding import rules

Tree = Dict[str, torch.Tensor]


class FsdpLayout:
    """Each parameter's FSDP sharding over the batch axes of ``mesh`` (a
    named ``DeviceMesh``, or an ``AbstractMesh`` for planning), and the
    collectives of the rank-local FSDP step.  Process groups are touched
    only when a collective runs."""

    def __init__(self, cfg: ModelConfig, mesh):
        from repro_torch.models.model import model_defs

        sizes = axis_sizes(mesh)
        self.model = sizes.get("model", 1)
        self.axes = batch_axes(mesh)
        if not self.axes:
            raise ValueError(f"mesh axes {tuple(sizes)} have no batch axis "
                             "('pod' or 'data')")
        self.cfg, self.mesh = cfg, mesh
        self.ranks = math.prod(sizes[a] for a in self.axes)
        self.defs = model_defs(cfg)
        self.shardings = rules.shardings_for_defs(
            self.defs, mesh, fsdp=True, fsdp_axes=self.axes)
        self.tp = rules.shardings_for_defs(self.defs, mesh, fsdp=False)
        # The tensor dim of each leaf sharded over the batch axes (all of
        # them, major first: the rules shard 'embed' over all or none).
        self.dims: Dict[str, Optional[int]] = {}
        for k, sh in self.shardings.items():
            dims = [i for i, e in enumerate(sh.spec)
                    if set(rules.spec_axes(e)) & set(self.axes)]
            self.dims[k] = dims[0] if dims else None
        self._axes = {}

    def require_runnable(self) -> None:
        """Raise unless the step can run on this mesh (``model`` 1)."""
        if self.model > 1:
            raise ValueError(
                f"FSDP training on a mesh with model = {self.model}: the "
                "port has no tensor-parallel training forward (the "
                "reference shards one over 'model' only in its "
                "compile-only dry run); use a mesh whose model axis has "
                "size 1")

    # -- transport ---------------------------------------------------------
    def _axis(self, name: str, device: torch.device):
        from repro_torch.core.distributed import _Axis  # lazy: cycle

        key = (name, str(device))
        if key not in self._axes:
            self._axes[key] = _Axis(self.mesh, name, device)
        return self._axes[key]

    def batch_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over every batch rank (a collective)."""
        for a in self.axes:
            t = self._axis(a, t.device).all_reduce(t)
        return t

    def batch_statistics(self) -> rules.batch_statistics:
        """The context in which the loss's batch statistics are global."""
        return rules.batch_statistics(self.batch_sum, self.ranks)

    # -- the hooks ---------------------------------------------------------
    def gather(self, k: str, local: torch.Tensor) -> torch.Tensor:
        """Leaf ``k`` whole from this rank's FSDP shard: its
        ``NamedSharding``'s all-gather over the batch axes."""
        d = self.dims[k]
        if d is None:
            return local
        if local.is_meta:
            return torch.empty(self.defs[k].shape, dtype=local.dtype,
                               device="meta")
        return self.shardings[k].gather(local)

    def reduce_scatter(self, k: str, full: torch.Tensor) -> torch.Tensor:
        """The fp32 mean over the batch ranks of gradient ``k``, this
        rank's FSDP shard of it."""
        d = self.dims[k]
        if full.is_meta:
            shape = self.shardings[k].shard_shape(full.shape)
            return torch.empty(shape, dtype=torch.float32, device="meta")
        out = full
        for a in self.axes:                 # major first
            ax = self._axis(a, out.device)
            out = (ax.all_reduce(out.float()) if d is None
                   else ax.reduce_scatter(out.contiguous(), d))
        return (out / self.ranks).contiguous()

    def reshard_params(self, tree: Tree) -> Tree:
        """Each leaf whole on every rank, a fresh autograd leaf where the
        input required grad (the step's cast copy)."""
        self.require_runnable()
        out = {}
        for k, v in tree.items():
            full = self.gather(k, v.detach())
            out[k] = full.requires_grad_(v.requires_grad)
        return out

    def reshard_grads(self, tree: Tree) -> Tree:
        self.require_runnable()
        return {k: self.reduce_scatter(k, g) for k, g in tree.items()}

    # -- the optimizer's one cross-rank step --------------------------------
    def global_norm(self, grads: Tree) -> torch.Tensor:
        """The L2 norm of the global gradient from its shards: the sharded
        leaves' sums of squares all-reduced once, the whole leaves' added
        once."""
        dev = next(iter(grads.values())).device
        sharded = torch.zeros((), dtype=torch.float32, device=dev)
        whole = torch.zeros((), dtype=torch.float32, device=dev)
        for k in sorted(grads):
            sq = torch.sum(torch.square(grads[k].float()))
            if self.dims[k] is None:
                whole = whole + sq
            else:
                sharded = sharded + sq
        return torch.sqrt(self.batch_sum(sharded) + whole)

    # -- state and batch ----------------------------------------------------
    def shard(self, params: Tree) -> Tree:
        """This rank's FSDP shards (contiguous copies) of whole leaves."""
        return {k: self.shardings[k].local(v).clone()
                for k, v in params.items()}

    def init_state(self, seed: int = 0, device=None):
        """The train state of this rank: every rank draws the same fp32
        masters from ``seed`` (``train.step.init_state``'s) and keeps its
        shards; zero moments of the shards' shapes."""
        from repro_torch.models import model as M
        from repro_torch.optim import adamw
        from repro_torch.train.step import TrainState

        self.require_runnable()
        params = self.shard(M.init_params(self.cfg, seed, device,
                                          masters=True))
        step = torch.zeros((), dtype=torch.int32,
                           device=next(iter(params.values())).device)
        return TrainState(step=step, params=params, opt=adamw.init(params))

    def gather_state(self, state):
        """The whole train state on every rank (a collective)."""
        from repro_torch.optim import adamw
        from repro_torch.train.step import TrainState

        def whole(tree):
            return {k: self.gather(k, v) for k, v in tree.items()}

        return TrainState(state.step, whole(state.params), adamw.AdamWState(
            state.opt.count, whole(state.opt.m), whole(state.opt.v)))

    def local_batch(self, batch: Tree) -> Tree:
        """This rank's rows of a global batch, by the batch-axes split of
        ``launch.specs.train_inputs`` (the whole batch where it does not
        divide)."""
        from repro_torch.launch.specs import train_inputs

        self.require_runnable()
        ref = batch.get("labels", next(iter(batch.values())))
        shape = ShapeConfig("batch", int(ref.shape[1]), int(ref.shape[0]),
                            "train")
        _, shardings = train_inputs(self.cfg, shape, self.mesh)
        return {k: shardings[k].local(v).contiguous()
                for k, v in batch.items()}

    # -- the plan ----------------------------------------------------------
    def step_bytes(self, microbatches: int = 1) -> Dict[str, float]:
        """Per-rank bytes one step's hooks send, by kind, at each leaf's
        tensor-parallel shard (its whole on a mesh with ``model`` 1): the
        all-gather, (R−1)/R of every FSDP leaf in the step's cast dtype
        (ndim ≥ 2 in the compute dtype, vectors fp32), once a step; each
        microbatch's reduce-scatter, over each batch axis of n ranks
        (n−1)/n of what is left of the leaf, the first axis in the cast
        dtype and the later ones in fp32; and the ring all-reduce of the
        leaves every rank holds whole, 2(n−1)/n of them in fp32 an
        axis."""
        sizes = axis_sizes(self.mesh)
        comp = self.cfg.dtype().itemsize
        frac = (self.ranks - 1) / self.ranks
        out = {"all-gather": 0.0, "reduce-scatter": 0.0, "all-reduce": 0.0}
        for k, d in self.defs.items():
            n = math.prod(self.tp[k].shard_shape(d.shape))
            cast = comp if len(d.shape) >= 2 else 4
            if self.dims[k] is None:
                out["all-reduce"] += sum(2 * (sizes[a] - 1) / sizes[a]
                                         for a in self.axes) * n * 4
                continue
            out["all-gather"] += frac * n * cast
            left, size = n, cast
            for a in self.axes:
                out["reduce-scatter"] += (sizes[a] - 1) / sizes[a] * left \
                    * size
                left, size = left / sizes[a], 4
        out["reduce-scatter"] *= microbatches
        out["all-reduce"] *= microbatches
        return {k: v for k, v in out.items() if v}


class _Hook:
    """One reshard hook: a callable over a tree, carrying its layout."""

    def __init__(self, layout: FsdpLayout, fn: Callable[[Tree], Tree]):
        self.layout = layout
        self._fn = fn

    def __call__(self, tree: Tree) -> Tree:
        return self._fn(tree)


def weight_hoist(cfg: ModelConfig, mesh) -> Tuple[_Hook, _Hook]:
    """``(reshard_params, reshard_grads)`` for ``build_train_step`` on
    ``mesh``: the reference's ``weight_hoist`` hooks (see the module
    docstring).  On a mesh whose ``model`` axis is larger than 1 they
    build (the dry run plans with their layout) and refuse to run."""
    layout = FsdpLayout(cfg, mesh)
    return (_Hook(layout, layout.reshard_params),
            _Hook(layout, layout.reshard_grads))
