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

On a sharded state (``train.fsdp``) the update runs leaf by leaf on each
rank's shards; the clip's global norm is the one cross-rank step
(:func:`update`'s ``norm_fn``: the sums of squares all-reduced over the
axes that split each leaf, FSDP's batch axes and tensor parallelism's
``model``).

``allreduce_compressed`` mean-reduces gradients over one named mesh axis
with bf16 or int8 wire compression and error feedback (the quantization
residual carried into the next step), for the slow cross-pod axis where
gradient bytes dominate; ``compress_grads``/``decompress_grads`` are its
single-rank halves.  As in the reference, all of this is plain tensor
arithmetic: no kernel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

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


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(tree: Params, max_norm: float):
    """``(tree scaled so its global norm is at most max_norm, the
    norm)``: each leaf times ``min(1, max_norm / norm)`` in fp32 (the
    reference's bf16 × fp32 promotes).  :func:`update` applies the same
    scale leaf by leaf instead, so the clipped fp32 tree never lives
    whole."""
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
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
           cfg: AdamWConfig, *, donate: bool = False,
           norm_fn: Optional[Callable[[Params], torch.Tensor]] = None):
    """Returns (new_params, new_state, metrics); parameters keep their
    dtype, moments are fp32.  ``donate`` writes them into ``params`` and
    ``state``'s tensors, which the call consumes, and returns those; the
    values are the same bit for bit.  The functional form is for a caller
    that steps one state more than once or keeps it after the step (the
    tests holding a step against the reference, microbatches or remat
    from one state; the checkpoint round trips); a loop that replaces its
    state every step (``launch.train.run_training``) donates it.
    ``norm_fn(grads)`` gives the clip's global norm where the leaves are
    shards (``train.fsdp.FsdpLayout.global_norm``); default
    :func:`global_norm`."""
    gnorm = torch.zeros((), dtype=torch.float32, device=state.count.device)
    scale = None
    if cfg.clip_norm is not None:
        # The reference's clip by global norm, its scale applied leaf by
        # leaf below (g.float() · scale, in fp32 as its bf16 × fp32
        # promotes).
        gnorm = (norm_fn or global_norm)(grads)
        scale = _clip_scale(gnorm, cfg.clip_norm)
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


# ---------------------------------------------------------------------------
# Compressed gradient all-reduce (error feedback)
# ---------------------------------------------------------------------------

def quantize_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fp32 scale for the whole tensor (max |g| / 127, floored at
    1e-12 / 127) and the rounded, clipped int8 codes."""
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_grads(grads: Params, ef: Params, mode: str = "int8"):
    """Quantize grads plus their error feedback.  Returns ``(payload,
    new_ef)``: the payload is what crosses the wire (bf16 leaves, or
    ``(q, scale)`` pairs for int8); ``new_ef`` carries each leaf's
    quantization residual into the next step, so the compression is
    unbiased over time (EF-SGD)."""
    if mode == "none":
        return grads, ef
    payload, new_ef = {}, {}
    for k in grads:
        gf = grads[k].float() + ef[k]
        if mode == "bf16":
            q = gf.to(torch.bfloat16)
            payload[k], new_ef[k] = q, gf - q.float()
            continue
        q, scale = quantize_int8(gf)
        payload[k], new_ef[k] = (q, scale), gf - dequantize_int8(q, scale)
    return payload, new_ef


def decompress_grads(payload, mode: str = "int8") -> Params:
    if mode == "none":
        return payload
    if mode == "bf16":
        return {k: p.float() for k, p in payload.items()}
    return {k: dequantize_int8(*p) for k, p in payload.items()}


def allreduce_compressed(grads: Params, ef: Params, axis: str,
                         mode: str = "int8", mesh=None):
    """Mean-reduce ``grads`` over the named ``axis`` of ``mesh`` (a named
    ``DeviceMesh``) with wire compression and error feedback; returns
    ``(reduced, new_ef)``.  Every rank of the axis calls it with its own
    gradients.

    int8: the quantization scale is shared across the axis (MAX over it
    of each rank's max |g| / 127, floored at 1e-12), so the SUM of the
    codes (as int32, the reference's ``psum``) times the scale is exact.
    bf16: the bf16 values summed in fp32.  none: the plain mean, ``ef``
    passed through.  Card tensors under a backend other than NCCL travel
    as pinned host copies, the transport of ``core.distributed``."""
    from repro_torch.core.distributed import _Axis  # lazy: cycle

    if mode not in ("none", "bf16", "int8"):
        raise ValueError(f"unknown compression mode {mode!r}")
    if mesh is None:
        raise ValueError("allreduce_compressed reduces over a named axis "
                         "of a DeviceMesh: pass mesh=")
    red, new_ef = {}, {}
    for k, g in grads.items():
        ax = _Axis(mesh, axis, g.device)
        n = ax.size
        if mode == "none":
            red[k] = (ax.all_reduce(g.float()) / n).to(g.dtype)
            continue
        gf = g.float() + ef[k]
        if mode == "bf16":
            q = gf.to(torch.bfloat16).float()
            red[k], new_ef[k] = ax.all_reduce(q) / n, gf - q
            continue
        scale = ax.all_reduce(torch.max(torch.abs(gf)),
                              op=dist.ReduceOp.MAX) / 127.0
        scale = torch.clamp(scale, min=1e-12)
        q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
        s = ax.all_reduce(q.to(torch.int32))
        red[k] = s.float() * scale / n
        new_ef[k] = gf - q.float() * scale
    return red, (ef if mode == "none" else new_ef)
