"""AdamW with global-norm clipping (port of ``repro/optim/adamw.py``), in
plain torch over dicts of tensors.

This is the reference's arithmetic step for step, not
``torch.optim.AdamW`` (which decays before the moment update and leaves
clipping to the caller): the gradients are clipped by their global norm,
the fp32 moments updated and bias-corrected, decoupled weight decay added
for matrices (ndim ≥ 2) only, and the step scaled by the warmup-then-cosine
rate of :func:`lr_at`.  :func:`update` is functional, like the
reference's: it returns new parameters and state and leaves its inputs as
they are; with ``donate=True`` it writes the same values into the
inputs' own tensors instead (the counterpart of the reference's donated
train state, ``donate_argnums=(0,)`` in its dry run), so a step holds one
copy of the masters and moments, not two.  Either way it runs one leaf
at a time: the clipped fp32 gradient of one leaf lives at once.

The compressed gradient all-reduce (``allreduce_compressed``, with
``compress_grads``/``decompress_grads``) needs ``torch.distributed`` and
waits for ``core/distributed.py``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional

import torch

Params = Dict[str, torch.Tensor]


class AdamWState(NamedTuple):
    count: torch.Tensor        # int32 scalar: updates taken
    m: Params                  # fp32 first moments, one per parameter
    v: Params                  # fp32 second moments


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup over ``warmup_steps``, then a cosine decay to
    ``min_lr_ratio · lr`` at ``total_steps``; fp32, as the reference."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree: Params) -> torch.Tensor:
    """fp32 L2 norm over every leaf, summed in sorted key order (the
    reference's leaf order)."""
    return torch.sqrt(sum(torch.sum(torch.square(tree[k].float()))
                          for k in sorted(tree)))


def init(params: Params) -> AdamWState:
    device = next(iter(params.values())).device
    zeros = {k: torch.zeros_like(p, dtype=torch.float32)
             for k, p in params.items()}
    return AdamWState(count=torch.zeros((), dtype=torch.int32, device=device),
                      m=zeros, v={k: torch.zeros_like(z)
                                  for k, z in zeros.items()})


@torch.no_grad()
def update(grads: Params, state: AdamWState, params: Params,
           cfg: AdamWConfig, *, donate: bool = False):
    """Returns (new_params, new_state, metrics); parameters keep their
    dtype, moments are fp32.  ``donate`` writes them into ``params`` and
    ``state``'s tensors, which the call consumes, and returns those; the
    values are the same bit for bit.  The functional form is for a caller
    that steps one state more than once or keeps it after the step (the
    tests holding a step against the reference, microbatches or remat
    from one state; the checkpoint round trips); a loop that replaces its
    state every step (``launch.train.run_training``) donates it."""
    gnorm = torch.zeros((), dtype=torch.float32, device=state.count.device)
    scale = None
    if cfg.clip_norm is not None:
        # The reference's clip by global norm, its scale applied leaf by
        # leaf below (g.float() · scale, in fp32 as its bf16 × fp32
        # promotes).
        gnorm = global_norm(grads)
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    count = state.count + 1
    lr = lr_at(cfg, state.count)
    b1c = 1 - cfg.b1 ** count.float()
    b2c = 1 - cfg.b2 ** count.float()
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g = grads[k].float()
        if scale is not None:
            g = g * scale
        m = cfg.b1 * state.m[k] + (1 - cfg.b1) * g
        v = cfg.b2 * state.v[k] + (1 - cfg.b2) * g * g
        del g
        step = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if p.dim() >= 2:       # no decay on norms and other vectors
            step = step + cfg.weight_decay * p.float()
        new = (p.float() - lr * step).to(p.dtype)
        del step
        if donate:
            for dst, src in ((p, new), (state.m[k], m), (state.v[k], v)):
                dst.copy_(src)
            new, m, v = p, state.m[k], state.v[k]
        new_p[k], new_m[k], new_v[k] = new, m, v
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_p, AdamWState(count, new_m, new_v), metrics
