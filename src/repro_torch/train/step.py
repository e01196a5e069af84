"""Train step builder (port of ``repro/train/step.py``): loss, microbatch
gradient accumulation, mixed precision and remat, for every family: the
dense and MoE transformers (GQA or MLA), the Mamba2 stack, zamba2's
hybrid, and the vlm and audio models over precomputed ``embeds``.  The
loss is the LM loss plus the MoE load-balancing aux loss, as in the
reference.

The fp32 master parameters are cast to the compute dtype **once per
step** (matrices only; norm gains and other vectors stay fp32), gradients
are taken with respect to that cast copy, and AdamW updates the masters.
Every projection GEMM of the forward and of the backward (each GEMM the
reference routes through ``ca_matmul``, the per-expert loops included)
runs on the CA-GEMM kernel (``kernels.ops``' trainable programs); the
contractions the reference writes as einsums (attention, the SSD scan,
the router, MLA's ``wkv_b`` expansion, the codebook heads) stay plain
torch, as in the reference.  Remat follows ``cfg.remat``
(``models.model.forward``; the hybrid nests it per segment).
Microbatches run as a Python loop over a strided split of the batch,
their gradients summed in fp32 and divided by the count, the loss and
aux averaged the same way.

``warmup_gemm_rows`` resolves the model's forward and backward GEMM
tiles through the kernel-config registry when the step is built, as the
reference's does.  The reference's sharding hooks
(``reshard_params``/``reshard_grads``) are called where it calls them:
after the cast, after each microbatch's gradients, and on the fp32
accumulator's zeros.  ``train.fsdp.weight_hoist`` builds the FSDP pair:
each rank then steps its shards of the masters and moments on its slice
of the global batch, and on a mesh whose ``model`` axis is larger than 1
its tensor-parallel slices of the weights (``train.fsdp``).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.tuning import warmup_model

Batch = Dict[str, torch.Tensor]


class TrainState(NamedTuple):
    step: torch.Tensor             # int32 scalar
    params: Dict[str, torch.Tensor]
    opt: adamw.AdamWState


def init_state(cfg: ModelConfig, seed: int = 0, device=None) -> TrainState:
    """fp32 masters drawn from ``seed`` (``M.init_params(masters=True)``;
    ``device=None`` is the card) and zero AdamW moments."""
    params = M.init_params(cfg, seed, device, masters=True)
    step = torch.zeros((), dtype=torch.int32,
                       device=next(iter(params.values())).device)
    return TrainState(step=step, params=params, opt=adamw.init(params))


def loss_fn(params, batch: Batch, cfg: ModelConfig):
    """(loss + aux, {"loss", "aux"}): the LM loss (over every codebook for
    the audio family) and the MoE load-balancing loss summed over layers,
    which is 0 for every other family."""
    logits, _, aux = M.forward(params, batch, cfg, mode="train",
                               return_aux=True)
    loss = M.lm_loss(logits, batch["labels"], cfg, batch.get("mask"))
    return loss + aux, {"loss": loss, "aux": aux}


def cast_params(params, cfg: ModelConfig):
    """The step's compute copy of the masters: float matrices (ndim ≥ 2)
    in the compute dtype, vectors as they are; every float leaf a new
    autograd leaf that requires grad."""
    dt = cfg.dtype()
    return {k: (v.detach().to(dt) if v.dim() >= 2 and v.is_floating_point()
                else v.detach()).requires_grad_(v.is_floating_point())
            for k, v in params.items()}


def _split_mb(x: torch.Tensor, n: int, i: int) -> torch.Tensor:
    """Microbatch ``i`` of ``n`` of the strided split (rows i, i+n, ...):
    the reference's (B//n, n) reshape with the scan axis swapped first."""
    if x.shape[0] % n:
        raise ValueError(f"batch of {x.shape[0]} rows does not split into "
                         f"{n} microbatches")
    return x.reshape(x.shape[0] // n, n, *x.shape[1:])[:, i]


def build_train_step(
    cfg: ModelConfig,
    opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig(),
    microbatches: int = 1,
    reshard_params: Optional[Callable] = None,
    reshard_grads: Optional[Callable] = None,
    warmup_gemm_rows: Optional[int] = None,
    donate: bool = False,
) -> Callable[[TrainState, Batch], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Returns train_step(state, batch) -> (state, metrics).

    ``donate`` consumes the state passed in: AdamW writes the new
    parameters and moments into its tensors (``adamw.update(...,
    donate=True)``, the same values), so a step holds one copy of them,
    where the functional step holds the old state beside the new one
    until the caller drops it.  Keep the functional default where the
    state passed in is used again after the step (``adamw.update`` says
    which callers do).

    ``warmup_gemm_rows`` (tokens per microbatch, B*L/microbatches)
    pre-resolves the hot-path GEMM tiles, the backward layouts included,
    through the kernel-config registry.  The batch's leading dim must
    divide by ``microbatches``; metrics are 0-dim tensors (``loss``,
    ``aux``, ``grad_norm``, ``lr``).

    ``reshard_params(tree)`` maps the step's cast copy of the parameters
    to the layout the forward reads (its leaves autograd leaves that
    require grad); ``reshard_grads(tree)`` maps gradients to the state's
    layout, and is also handed the accumulator's zeros as meta tensors,
    whose shapes it maps.  Hooks that carry a ``layout``
    (``train.fsdp.weight_hoist``) also make the loss's batch statistics
    and the clip's norm global over the ranks; with them the state holds
    this rank's shards and the batch this rank's rows
    (``FsdpLayout.local_batch``), and the metrics are the global step's
    on every rank.  On a mesh whose ``model`` axis is larger than 1 the
    forward and backward also run inside the layout's
    ``core.distributed.model_parallel`` context, on each leaf's
    tensor-parallel shard; the loss statistics stay global over the batch
    axes."""
    if warmup_gemm_rows:
        # train=True adds the backward GEMMs' transposed layouts and their
        # dact-prologue variants to the plan set.
        warmup_model(cfg, [warmup_gemm_rows], train=True)
    if microbatches < 1:
        raise ValueError(f"microbatches = {microbatches}")

    def grads_of(params_c, batch):
        leaves = sorted(k for k, v in params_c.items() if v.requires_grad)
        loss, metrics = loss_fn(params_c, batch, cfg)
        gs = torch.autograd.grad(loss, [params_c[k] for k in leaves],
                                 allow_unused=True)
        grads = {k: torch.zeros_like(params_c[k]) if g is None else g
                 for k, g in zip(leaves, gs)}
        return grads, {k: v.detach() for k, v in metrics.items()}

    layout = getattr(reshard_grads, "layout",
                     getattr(reshard_params, "layout", None))
    if layout is not None:
        layout.require_runnable()
    stats = (layout.batch_statistics if layout is not None
             else contextlib.nullcontext)
    tensor_parallel = (layout.model_parallel if layout is not None
                       else contextlib.nullcontext)
    norm_fn = layout.global_norm if layout is not None else None

    def local_grads(params_c, batch: Batch):
        if microbatches == 1:
            grads, metrics = grads_of(params_c, batch)
            if reshard_grads is not None:
                grads = reshard_grads(grads)
            return grads, metrics
        # The reference's scan: fp32 zeros on the state's layout (the
        # hook maps their shapes as meta tensors), each microbatch's
        # gradients resharded, then added.
        reshard = reshard_grads or (lambda tree: tree)
        zeros = reshard({k: torch.empty(v.shape, dtype=torch.float32,
                                        device="meta")
                         for k, v in params_c.items() if v.requires_grad})
        dev = next(iter(params_c.values())).device
        grads = {k: torch.zeros(z.shape, dtype=torch.float32, device=dev)
                 for k, z in zeros.items()}
        metrics = None
        for i in range(microbatches):
            g, m = grads_of(params_c, {k: _split_mb(v, microbatches, i)
                                       for k, v in batch.items()})
            g = reshard(g)
            for k in grads:
                grads[k] += g[k].float()
            del g
            metrics = m if metrics is None else {
                k: metrics[k] + m[k] for k in metrics}
        grads = {k: g / microbatches for k, g in grads.items()}
        metrics = {k: v / microbatches for k, v in metrics.items()}
        return grads, metrics

    def train_step(state: TrainState, batch: Batch):
        params_c = cast_params(state.params, cfg)
        if reshard_params is not None:
            params_c = reshard_params(params_c)
        with stats(), tensor_parallel():
            grads, metrics = local_grads(params_c, batch)
        del params_c
        new_params, new_opt, opt_metrics = adamw.update(
            grads, state.opt, state.params, opt_cfg, donate=donate,
            norm_fn=norm_fn)
        return (TrainState(state.step + 1, new_params, new_opt),
                dict(metrics, **opt_metrics))

    return train_step


def cast_batch(batch, cfg: ModelConfig, device=None) -> Batch:
    """A batch of numpy arrays (or tensors) as tensors on ``device``
    (``None`` is the card); precomputed ``embeds`` in the compute
    dtype."""
    device = M.resolve_device(device)
    out = {}
    for k, v in batch.items():
        v = torch.as_tensor(v, device=device)
        if k == "embeds":
            v = v.to(cfg.dtype())
        out[k] = v
    return out
