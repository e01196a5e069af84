"""AdamW with global-norm clipping (port of ``repro/optim/adamw.py``), in
plain torch over dicts of tensors.

This is the reference's arithmetic step for step, not
``torch.optim.AdamW`` (which decays before the moment update and leaves
clipping to the caller): the gradients are clipped by their global norm,
the fp32 moments updated and bias-corrected, decoupled weight decay added
for matrices (ndim ≥ 2) only, and the step scaled by the warmup-then-cosine
rate of :func:`lr_at`.  :func:`update` is functional, like the
reference's: it returns new parameters and state and leaves its inputs as
they are.

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


def clip_by_global_norm(tree: Params, max_norm: float):
    """The leaves scaled so that their global norm is at most
    ``max_norm``, in fp32 (as the reference's bf16 × fp32 promotes), and
    the norm before clipping."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: g.float() * scale for k, g in tree.items()}, norm


def init(params: Params) -> AdamWState:
    device = next(iter(params.values())).device
    zeros = {k: torch.zeros_like(p, dtype=torch.float32)
             for k, p in params.items()}
    return AdamWState(count=torch.zeros((), dtype=torch.int32, device=device),
                      m=zeros, v={k: torch.zeros_like(z)
                                  for k, z in zeros.items()})


@torch.no_grad()
def update(grads: Params, state: AdamWState, params: Params,
           cfg: AdamWConfig):
    """Returns (new_params, new_state, metrics); parameters keep their
    dtype, moments are fp32."""
    gnorm = torch.zeros((), dtype=torch.float32, device=state.count.device)
    if cfg.clip_norm is not None:
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    count = state.count + 1
    lr = lr_at(cfg, state.count)
    b1c = 1 - cfg.b1 ** count.float()
    b2c = 1 - cfg.b2 ** count.float()
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g = grads[k].float()
        m = cfg.b1 * state.m[k] + (1 - cfg.b1) * g
        v = cfg.b2 * state.v[k] + (1 - cfg.b2) * g * g
        step = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if p.dim() >= 2:       # no decay on norms and other vectors
            step = step + cfg.weight_decay * p.float()
        new_p[k] = (p.float() - lr * step).to(p.dtype)
        new_m[k], new_v[k] = m, v
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_p, AdamWState(count, new_m, new_v), metrics
