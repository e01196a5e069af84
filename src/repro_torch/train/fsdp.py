"""FSDP × TP training on a named mesh: the weight-hoist reshard hooks of
the reference's ``lower_cell`` (``src/repro/launch/dryrun.py:86-110``),
run rank-local over ``torch.distributed``.

The reference states the layout and GSPMD partitions one global program:
the fp32 masters and both AdamW moments live sharded over the batch axes
(``pspecs_for_defs(fsdp=True, fsdp_axes=batch_axes(mesh))``, ZeRO-3) and,
where the mesh has a ``model`` axis, over it too (the tensor-parallel
dims: ``vocab``, ``qkv``, ``mlp``, ``expert``), ``reshard_params``
constrains the step's cast bf16 copy to the tensor-parallel layout (one
all-gather a step, hoisted out of the microbatch loop), and
``reshard_grads`` constrains each microbatch's gradients back onto the
FSDP layout (a reduce-scatter, ZeRO-2).  Here each rank runs the step on
its own slice of the global batch and its own tensor-parallel slices of
the weights, and the hooks move the bytes themselves:

* ``reshard_params`` all-gathers every leaf over the batch axes only:
  each leaf keeps its ``model`` shard (the reference's ``tp_specs``),
  but for the leaves of ``models.model.tp_whole_leaves``, which it also
  all-gathers over ``model``: the Mamba2 mixer's fused ``in_proj``,
  ``conv_w`` and ``conv_b``, whose contiguous shards do not line up
  with the SSD heads a rank runs, and the KV projections ``wk`` and
  ``wv`` where ``model`` splits a KV head (granite-20b's one head),
  whose shard is part of the head a rank's query heads read;
* ``reshard_grads`` first sums over ``model`` the gradients of the
  leaves every model rank holds whole but gets only in part
  (``models.model.tp_partial_leaves``) and reduce-scatters over
  ``model`` those of the whole-read leaves onto their contiguous shards
  (the ranks' partial ``B`` and ``C`` or KV gradients summed, the zeros
  outside each rank's columns dropped), then mean-reduce-scatters every
  gradient onto its FSDP shard, summed in fp32: over each batch axis,
  major first, an all-to-all of the blocks (the first in the gradient's
  own dtype, then the fp32 partial sums) and a local sum (gloo has no
  reduce-scatter); it mean-reduces the leaves that every batch rank
  holds whole.  Given meta tensors (the microbatch accumulator's zeros)
  it returns meta tensors of the shard shapes.

Both are callables with a ``layout`` (:class:`FsdpLayout`), from which
``train.step.build_train_step`` also takes what GSPMD would compute over
the global batch and the global tree: the loss's batch statistics
(``sharding.rules.batch_statistics``: the masked loss's numerator and
denominator, the MoE aux's two means), the forward's tensor-parallel
context (``core.distributed.model_parallel``: the vocab-parallel embedding
and cross-entropy, column- and row-parallel projections, the experts
split over ``model``, the Mamba2 mixer's heads split over it) and the
clip's global norm.  Collectives on card
tensors under a backend other than NCCL go through pinned host copies
(``core.distributed._Axis``).

The layout takes any mesh: the dry run plans the hooks' bytes on the
production meshes from it.  On a mesh whose ``model`` axis is larger
than 1 the step runs every arch of ``configs.list_archs()`` that a CPU
case holds against the reference: the dense GQA stacks (stablelm-1.6b;
h2o-danube-3-4b with its sliding window; granite-20b's one KV head,
whose projections the step reads whole over ``model``, and its GELU
MLP), the MoE + MLA deepseek-v2-lite-16b, the q-LoRA MLA minicpm3-4b,
mixtral-8x7b's experts beside GQA, qwen2-vl-72b's M-RoPE and
musicgen-large's codebook heads over the ``embeds`` frontend, the
Mamba2 stack mamba2-370m and zamba2-7b's hybrid of Mamba2 layers and a
shared attention block.  A layout the step lacks (SSD heads or query
heads that do not divide over ``model``, KV heads split so that a
rank's query heads straddle two of them, experts or tensor-parallel
dims that do not divide) or a feature no case holds (tied embeddings)
raises a ``ValueError`` that names what is missing (``tp_refusal``:
the hooks, ``init_state``, ``local_batch`` and ``build_train_step``).
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.mesh import axis_sizes, batch_axes
from repro_torch.sharding import rules

Tree = Dict[str, torch.Tensor]


def _tp_unheld(cfg: ModelConfig) -> list:
    """The features of ``cfg`` that no CPU case holds tensor-parallel
    against the reference.  ``tests/_torch_train_tp_cases.py`` holds
    every arch of ``configs.list_archs()``: dense GQA stacks (RoPE,
    SwiGLU or GELU, a sliding window, one KV head read whole), MoE
    stacks beside full-rank-Q MLA and beside GQA, q-LoRA MLA, M-RoPE and
    the codebook heads over the ``embeds`` frontend, a Mamba2 stack and
    a hybrid of Mamba2 layers and a weight-shared attention block; none
    ties its embeddings."""
    return ["tied embeddings"] if cfg.tie_embeddings else []


def whole_site(k: str) -> str:
    """The ``core.distributed.tp_wire_bytes`` site of a leaf of
    ``models.model.tp_whole_leaves``: ``ssm_fused`` the Mamba2 mixer's
    fused leaves, ``kv_head`` the KV projections."""
    return "ssm_fused" if "/mixer/" in k else "kv_head"


def tp_refusal(cfg: ModelConfig, mesh) -> Optional[str]:
    """Why the port does not train ``cfg`` tensor-parallel on ``mesh``
    (``None`` where it does, or where ``model`` is 1): what is missing,
    named."""
    from repro_torch.models import attention as A
    from repro_torch.models.model import model_defs, tp_whole_leaves

    tp = axis_sizes(mesh).get("model", 1)
    if tp == 1:
        return None
    why = []
    if cfg.family in ("ssm", "hybrid"):
        heads = cfg.ssm.n_heads(cfg.d_model)    # d_inner = heads x P
        if heads % tp:
            why.append(f"SSD heads that divide over model = {tp} (the "
                       f"Mamba2 mixer splits its {heads} heads)")
    defs = model_defs(cfg)
    if cfg.family not in ("ssm",):
        whole = set(tp_whole_leaves(cfg, tp))
        split = {k: v for k, v in rules.split_heads(
            defs, mesh, A.qkv_head_widths(cfg)).items() if k not in whole}
        if split:
            why.append("split heads: the 'qkv' shard is not a whole number "
                       "of heads (" + "; ".join(
                           f"{k}: {v}" for k, v in sorted(split.items()))
                       + ")")
    dims = rules.tp_dims(defs, mesh)
    whole = sorted(k for k, d in defs.items()
                   if dims[k] is None and set(d.axes) & {"vocab", "mlp",
                                                         "qkv", "expert",
                                                         "ssm"})
    if whole:
        why.append(f"a tensor-parallel dim that does not divide over "
                   f"model = {tp}: {', '.join(whole)} held whole")
    if "blocks/moe/w_gate" in defs and dims["blocks/moe/w_gate"] != 1:
        why.append(f"{cfg.moe.n_experts} experts do not divide over "
                   f"model = {tp}")
    why += [f"a CPU case holding {what} tensor-parallel"
            for what in _tp_unheld(cfg)]
    if not why:
        return None
    return (f"tensor-parallel training of {cfg.name} on model = {tp} is "
            "missing " + "; ".join(why))


class FsdpLayout:
    """Each parameter's FSDP × TP sharding (FSDP over the batch axes of
    ``mesh``, tensor parallelism over its ``model`` axis; ``mesh`` a named
    ``DeviceMesh``, or an ``AbstractMesh`` for planning), and the
    collectives of the rank-local step.  Process groups are touched only
    when a collective runs."""

    def __init__(self, cfg: ModelConfig, mesh):
        from repro_torch.models.model import (model_defs, tp_partial_leaves,
                                              tp_whole_leaves)

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
        # them, major first: the rules shard 'embed' over all or none),
        # and the one sharded over 'model'.
        self.dims: Dict[str, Optional[int]] = {}
        for k, sh in self.shardings.items():
            dims = [i for i, e in enumerate(sh.spec)
                    if set(rules.spec_axes(e)) & set(self.axes)]
            self.dims[k] = dims[0] if dims else None
        self.tp_dims = rules.tp_dims(self.defs, mesh)
        self.partial = (tp_partial_leaves(cfg) if self.model > 1 else ())
        # The leaves whose tensor-parallel copy is whole over 'model'
        # (their state stays split over it).
        self.whole = tuple(k for k in tp_whole_leaves(cfg, self.model)
                           if self.tp_dims[k] is not None)
        self.refusal = tp_refusal(cfg, mesh)
        self._axes = {}

    def require_runnable(self) -> None:
        """Raise unless the step can run on this mesh: ``model`` 1, or
        nothing missing for ``tp_refusal``."""
        if self.refusal:
            raise ValueError(self.refusal)

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

    def model_parallel(self):
        """The forward's tensor-parallel context over ``model`` (a no-op
        context where ``model`` is 1)."""
        from repro_torch.core.distributed import model_parallel

        if self.model == 1:
            return contextlib.nullcontext()
        return model_parallel(
            lambda device: self._axis("model", device), self.model,
            self.mesh.get_local_rank("model"))

    # -- the hooks ---------------------------------------------------------
    def gather(self, k: str, local: torch.Tensor) -> torch.Tensor:
        """Leaf ``k``'s copy the forward reads (the whole leaf where
        ``model`` is 1) from this rank's FSDP shard: its
        ``NamedSharding``'s all-gather over the batch axes, and for the
        leaves of ``self.whole`` an all-gather over ``model``
        (:func:`whole_site`)."""
        if local.is_meta:
            shape = self.defs[k].shape if k in self.whole \
                else self.tp[k].shard_shape(self.defs[k].shape)
            return torch.empty(shape, dtype=local.dtype, device="meta")
        out = local
        if self.dims[k] is not None:
            out = self.shardings[k].gather(local, axes=self.axes)
        if k in self.whole:
            from repro_torch.core.distributed import count_tp_bytes

            count_tp_bytes(whole_site(k), out)
            out = self._axis("model", out.device).gather(out.contiguous(),
                                                         self.tp_dims[k])
        return out

    def reduce_scatter(self, k: str, full: torch.Tensor) -> torch.Tensor:
        """The fp32 mean over the batch ranks of gradient ``k`` (of the
        leaf's tensor-parallel shard), this rank's FSDP shard of it."""
        d = self.dims[k]
        if full.is_meta:
            shape = self.shardings[k].shard_shape(self.defs[k].shape)
            return torch.empty(shape, dtype=torch.float32, device="meta")
        out = full
        for a in self.axes:                 # major first
            ax = self._axis(a, out.device)
            out = (ax.all_reduce(out.float()) if d is None
                   else ax.reduce_scatter(out.contiguous(), d))
        return (out / self.ranks).contiguous()

    def reshard_params(self, tree: Tree) -> Tree:
        """Each leaf's tensor-parallel shard on every rank, a fresh
        autograd leaf where the input required grad (the step's cast
        copy)."""
        self.require_runnable()
        out = {}
        for k, v in tree.items():
            full = self.gather(k, v.detach())
            out[k] = full.requires_grad_(v.requires_grad)
        return out

    def reshard_grads(self, tree: Tree) -> Tree:
        self.require_runnable()
        from repro_torch.core.distributed import count_tp_bytes, model_sum

        out = {}
        with self.model_parallel():
            for k, g in tree.items():
                if k in self.partial and not g.is_meta:
                    g = model_sum(g, "grads").to(g.dtype)
                elif k in self.whole and not g.is_meta:
                    # the ranks' partial gradients of the whole leaf summed
                    # onto this rank's 'model' shard
                    count_tp_bytes(whole_site(k), g)
                    g = self._axis("model", g.device).reduce_scatter(
                        g.contiguous(), self.tp_dims[k])
                out[k] = self.reduce_scatter(k, g)
        return out

    # -- the optimizer's one cross-rank step --------------------------------
    def global_norm(self, grads: Tree) -> torch.Tensor:
        """The L2 norm of the global gradient from its shards: each leaf's
        sum of squares summed over the axes that split it, a leaf held
        whole on every rank of an axis counted once: the batch-sharded
        leaves' sums all-reduced once over the batch axes (the
        model-sharded among them first over ``model``), the model-sharded
        leaves held whole over the batch axes over ``model``, the rest
        added once."""
        from repro_torch.core.distributed import model_sum

        dev = next(iter(grads.values())).device
        zero = lambda: torch.zeros((), dtype=torch.float32,  # noqa: E731
                                   device=dev)
        sums = {(b, m): zero() for b in (True, False) for m in (True, False)}
        for k in sorted(grads):
            sq = torch.sum(torch.square(grads[k].float()))
            key = (self.dims[k] is not None,
                   self.model > 1 and self.tp_dims[k] is not None)
            sums[key] = sums[key] + sq
        with self.model_parallel():
            batch = sums[(True, False)]
            if self.model > 1:
                batch = batch + model_sum(sums[(True, True)], "norm")
                whole = (model_sum(sums[(False, True)], "norm")
                         + sums[(False, False)])
            else:
                whole = sums[(False, False)]
        return torch.sqrt(self.batch_sum(batch) + whole)

    # -- state and batch ----------------------------------------------------
    def shard(self, params: Tree) -> Tree:
        """This rank's FSDP shards (contiguous copies) of whole leaves."""
        return {k: self.shardings[k].local(v).clone()
                for k, v in params.items()}

    def init_state(self, seed: int = 0, device=None):
        """The train state of this rank: every rank draws the same fp32
        masters from ``seed`` (``train.step.init_state``'s) and keeps its
        FSDP × TP shards (the model ranks of one batch group the same
        FSDP rows of their own TP slices); zero moments of the shards'
        shapes."""
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
            return {k: self.shardings[k].gather(v) for k, v in tree.items()}

        return TrainState(state.step, whole(state.params), adamw.AdamWState(
            state.opt.count, whole(state.opt.m), whole(state.opt.v)))

    def local_batch(self, batch: Tree) -> Tree:
        """This rank's rows of a global batch, by the batch-axes split of
        ``launch.specs.train_inputs`` (the whole batch where it does not
        divide): the model ranks of one batch group hold the same rows.
        The stream (``tokens`` or ``embeds``), ``labels`` (a codebook
        stream each) and ``mask`` take their specs; ``positions``, where
        a batch carries them ((B, L), or (B, L, 3) with M-RoPE), split as
        ``mask`` does."""
        from repro_torch.launch.specs import train_inputs

        self.require_runnable()
        ref = batch.get("labels", next(iter(batch.values())))
        shape = ShapeConfig("batch", int(ref.shape[1]), int(ref.shape[0]),
                            "train")
        _, shardings = train_inputs(self.cfg, shape, self.mesh)
        rows = shardings["mask"].spec[0]
        return {k: (shardings[k] if k in shardings else rules.NamedSharding(
            self.mesh, (rows,) + (None,) * (v.dim() - 1))).local(v)
            .contiguous() for k, v in batch.items()}

    def tp_wire_plan(self, seq_len: int, rows: int,
                     microbatches: int = 1) -> Dict[str, int]:
        """The bytes each site of this rank's tensor-parallel step hands
        to the ``model`` axis (``core.distributed.tp_wire_bytes``), one
        step of ``microbatches`` microbatches over the rank's ``rows``
        sequences of ``seq_len`` tokens; the clip's ``norm`` site (two
        fp32 scalars) aside.  A microbatch of T tokens: ``embed`` one
        (T, d) fp32 lookup (none from the ``embeds`` frontend); ``row``
        each layer's attention output once a forward (twice with remat)
        and its FFN's once (a remat recompute stops after the FFN's last
        GEMM, before its sum), a Mamba2 layer's out_proj once (a hybrid's
        twice with remat: the segment's recompute runs it whole, but for
        a partial last segment's last layer) and a shared-block
        application as a transformer layer; ``col`` one input gradient a
        region (each layer's attention and FFN or Mamba2 mixer, each
        shared-block application's attention and FFN, the head or the
        codebook heads); ``loss`` three (T,) statistics a codebook;
        ``route`` the (T, top_k) routing weights' gradient a MoE layer;
        ``ssm_norm`` a (T,) statistic each forward of a Mamba2 layer
        (``_mamba_forwards``) and one in its backward; ``grads`` the
        ``models.model.tp_partial_leaves`` in fp32; ``ssm_fused`` and
        ``kv_head`` the leaves of ``self.whole`` (:func:`whole_site`) in
        the cast dtype: this rank's shard once a step (the all-gather)
        and the whole gradient a microbatch (the reduce-scatter).  Empty
        where ``model`` is 1; a site that moves nothing is left out."""
        if self.model == 1:
            return {}
        cfg = self.cfg
        tokens = rows // microbatches * seq_len
        n, act = cfg.n_layers, tokens * cfg.d_model * 4
        fwd = 2 if cfg.remat else 1
        out = {"embed": act if cfg.frontend == "tokens" else 0,
               "loss": 3 * tokens * max(1, cfg.n_codebooks) * 4,
               "grads": sum(math.prod(self.tp[k].shard_shape(
                   self.defs[k].shape)) * 4 for k in self.partial)}
        if cfg.family in ("ssm", "hybrid"):
            from repro_torch.models.model import n_shared_applications

            apps = n_shared_applications(cfg)
            forwards = self._mamba_forwards()
            rows_m = sum(f - 1 if cfg.remat and cfg.shared_attn_every
                         else 1 for f in forwards)
            out.update(row=(rows_m + apps * (fwd + 1)) * act,
                       col=(n + 2 * apps + 1) * act,
                       ssm_norm=sum(f + 1 for f in forwards) * tokens * 4)
        else:
            out.update(row=n * (fwd + 1) * act, col=(2 * n + 1) * act)
        if cfg.moe is not None and cfg.moe.n_experts:
            out["route"] = n * tokens * cfg.moe.top_k * 4
        for k in self.whole:         # the whole gradient's reduce-scatter
            site = whole_site(k)
            out[site] = out.get(site, 0) + math.prod(
                self.defs[k].shape) * self._cast_size(k)
        out = {k: v * microbatches for k, v in out.items()}
        for k in self.whole:         # this rank's shard's all-gather
            out[whole_site(k)] += math.prod(self.tp[k].shard_shape(
                self.defs[k].shape)) * self._cast_size(k)
        return {k: v for k, v in out.items() if v}

    def _mamba_forwards(self) -> list:
        """How many times each Mamba2 layer's forward runs in a step: once,
        twice with remat, and in a hybrid (a checkpoint a segment around
        the layers' own) three times, but twice for a partial last
        segment's last layer, which feeds no checkpoint inside the segment
        (its recompute stops before it)."""
        cfg = self.cfg
        n, e = cfg.n_layers, cfg.shared_attn_every
        if not cfg.remat:
            return [1] * n
        if not e:
            return [2] * n
        return [2 if (i == n - 1 and n % e) else 3 for i in range(n)]

    def _cast_size(self, k: str) -> int:
        """The itemsize of leaf ``k`` in the step's cast copy
        (``train.step.cast_params``)."""
        return self.cfg.dtype().itemsize if len(self.defs[k].shape) >= 2 \
            else 4

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
        axis.  The leaves of ``self.whole`` (a ``model`` axis of m ranks)
        add (m−1)/m of the whole leaf to each: its all-gather over
        ``model`` once a step and its gradient's reduce-scatter over
        ``model`` a microbatch, both in the cast dtype; the batch axes'
        reduce-scatter then sends fp32."""
        sizes = axis_sizes(self.mesh)
        frac = (self.ranks - 1) / self.ranks
        out = {"all-gather": 0.0, "reduce-scatter": 0.0, "all-reduce": 0.0}
        for k, d in self.defs.items():
            n = math.prod(self.tp[k].shard_shape(d.shape))
            cast = first = self._cast_size(k)
            if k in self.whole:
                model = (self.model - 1) * n * cast
                out["all-gather"] += model
                out["reduce-scatter"] += model
                first = 4
            if self.dims[k] is None:
                out["all-reduce"] += sum(2 * (sizes[a] - 1) / sizes[a]
                                         for a in self.axes) * n * 4
                continue
            out["all-gather"] += frac * n * cast
            left, size = n, first
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
    docstring).  They build for any arch and mesh (the dry run plans
    with their layout); they run where ``tp_refusal`` finds nothing
    missing."""
    layout = FsdpLayout(cfg, mesh)
    return (_Hook(layout, layout.reshard_params),
            _Hook(layout, layout.reshard_grads))
