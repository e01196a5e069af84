"""Mixture-of-Experts with capacity-buffer scatter dispatch (port of
``repro/models/moe.py``).

Routing is fp32: router logits, softmax, top-k with its weights
renormalised, and the Switch load-balancing aux loss.  Groups are
per-sequence: each sequence's (token, choice) pairs, in their flattened
``(L·k)`` order, rank within their expert by a cumsum, and those past the
capacity ``round_up(ceil(k·L/E·cf), 8)`` drop.  Kept rows scatter into a
``(B, E, C, d)`` buffer (one spare row a group takes the dropped ones, so
every kept row lands in a slot of its own and the write is deterministic
on the card), the two expert GEMMs run per expert on K1
(:func:`~repro_torch.core.gemm.ca_expert_glu_matmul`, then
:func:`~repro_torch.core.gemm.ca_expert_matmul`), and each choice's
output is gathered back, weighted by ``weight · keep`` and summed over
the k choices.  Shared experts are a silu MLP with the block's residual
in their down projection's drain.  In a rank-local training step
(``sharding.rules.batch_statistics``) the aux loss's two statistics are
means over the global batch, as GSPMD computes them.

Tensor-parallel (``core.distributed.model_parallel``; the reference's
``"expert": "model"`` rule): routing and dispatch stay whole on every
rank, which sees the same tokens; each rank scatters only the pairs
routed to its ``E / tp`` experts, runs the two expert GEMMs over them,
and combines its part of the output, to which the shared experts (the
dense MLP, column- then row-parallel) add theirs; one fp32 sum over
``model`` and the residual, added once, finish the block.  The
normalized tokens and the routing weights pass ``copy_to_model`` into
that region, so the router's gradient is whole on every rank.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, round_up
from repro_torch.core.distributed import (copy_to_model, model_index,
                                          model_parallel_size)
from repro_torch.core.gemm import ca_expert_glu_matmul, ca_expert_matmul
from repro_torch.models import common as cm
from repro_torch.models.common import Defs, ParamDef
from repro_torch.sharding.rules import batch_mean


def moe_defs(cfg: ModelConfig, depth_scale: float = 1.0) -> Defs:
    d = cfg.d_model
    mo = cfg.moe
    E, fe = mo.n_experts, mo.d_ff_expert
    defs: Defs = {
        "router": ParamDef((d, E), ("embed", None)),
        "w_gate": ParamDef((E, d, fe), ("expert", "embed", "mlp")),
        "w_up": ParamDef((E, d, fe), ("expert", "embed", "mlp")),
        "w_down": ParamDef((E, fe, d), ("expert", "mlp", "embed"),
                           scale=depth_scale),
    }
    if mo.n_shared_experts:
        fs = mo.n_shared_experts * fe
        defs.update(cm.prefix_defs("shared", cm.mlp_defs(d, fs, "silu",
                                                         depth_scale)))
    return defs


def capacity(cfg: ModelConfig, L: int) -> int:
    """Rows each expert takes from one group of ``L`` tokens."""
    mo = cfg.moe
    return round_up(int(math.ceil(mo.top_k * L / mo.n_experts
                                  * mo.capacity_factor)), 8)


def route(x: torch.Tensor, router: torch.Tensor, cfg: ModelConfig):
    """fp32 routing of (B, L, d) tokens: returns the top-k expert ids and
    renormalised weights, each (B, L, k), and the Switch aux loss."""
    B, L, _ = x.shape
    mo = cfg.moe
    E, k = mo.n_experts, mo.top_k
    logits = torch.einsum("bld,de->ble", x.float(), router.float())
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.topk(probs, k, dim=-1)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    # Global-batch means in a rank-local training step (every rank holds
    # as many tokens), before their product.
    me = batch_mean(probs.mean(dim=(0, 1)))
    ce = batch_mean(torch.zeros(E, dtype=torch.float32,
                                device=x.device).index_add_(
        0, top_i.reshape(-1), torch.full((B * L * k,), 1.0 / (B * L * k),
                                         device=x.device)))
    aux = E * torch.sum(me * ce) * mo.aux_loss_coef
    return top_i, top_w, aux


def dispatch(top_i: torch.Tensor, n_experts: int, cap: int):
    """Each (token, choice) pair's slot in its expert's buffer: the rank
    of the pair among its expert's pairs of the group, in the flattened
    ``(L·k)`` order.  Returns the expert ids (B, T), the slots (B, T)
    with ``cap`` for a dropped pair, and the keep mask."""
    idx = top_i.reshape(top_i.shape[0], -1)
    oh = F.one_hot(idx, n_experts).to(torch.int32)
    pos = torch.gather(oh.cumsum(dim=1), 2, idx[..., None])[..., 0] - 1
    keep = pos < cap
    return idx, torch.where(keep, pos, cap), keep


def moe_apply(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
              residual=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output, aux load-balancing loss).  ``x`` is the
    normalized stream; ``residual`` (the block's pre-norm stream) rides
    the shared experts' down-projection drain, or is a plain add without
    shared experts."""
    B0, L0, d = x.shape
    if L0 == 1 and B0 > 1:
        # Decode: one token a sequence.  Group across the batch (one
        # group of B tokens), as the reference does, rather than B groups
        # of E·8 buffer rows each.
        y, aux = moe_apply(p, x.reshape(1, B0, d), cfg,
                           residual=None if residual is None
                           else residual.reshape(1, B0, d))
        return y.reshape(B0, L0, d), aux
    B, L = B0, L0
    mo = cfg.moe
    E, k = mo.n_experts, mo.top_k
    dt = x.dtype
    tp = model_parallel_size() > 1

    top_i, top_w, aux = route(x, p["router"], cfg)
    cap = capacity(cfg, L)
    idx, dest, keep = dispatch(top_i, E, cap)
    wgt = top_w.reshape(B, L * k)
    # The experts this rank holds (all, or its tensor-parallel slice): a
    # pair routed elsewhere goes to a spare expert row, dropped with the
    # spare slot.
    E_loc = p["w_gate"].shape[0]
    eid, slot, take = idx, dest, keep
    if tp:
        x, wgt = copy_to_model(x), copy_to_model(wgt, "route")
        local = idx - model_index() * E_loc
        mine = (local >= 0) & (local < E_loc)
        eid = torch.where(mine, local, E_loc)
        slot = torch.where(mine, dest, cap)
        take = keep & mine

    x_rep = x.repeat_interleave(k, dim=1)                     # (B, T, d)
    rows = torch.arange(B, device=x.device)[:, None].expand_as(idx)
    xe = torch.zeros((B, E_loc + tp, cap + 1, d), dtype=dt, device=x.device)
    xe[rows, eid, slot] = x_rep
    xe = xe[:, :E_loc, :cap]                                  # (B, E, C, d)

    h = ca_expert_glu_matmul(xe, p["w_gate"], p["w_up"], out_dtype=dt)
    ye = ca_expert_matmul(h, p["w_down"], out_dtype=dt)

    y_tok = ye[rows, torch.clamp(eid, max=E_loc - 1),
               torch.clamp(slot, max=cap - 1)]                # (B, T, d)
    y_tok = y_tok * (wgt * take.float())[..., None].to(dt)
    y = y_tok.reshape(B, L, k, d).sum(dim=2)

    if tp:
        if mo.n_shared_experts:
            part = y.float() + cm.mlp_partial(cm.subtree(p, "shared"), x,
                                              "silu")
        else:
            part = y.float()
        return cm.row_parallel_out(part, residual, dt), aux
    if mo.n_shared_experts:
        y = y + cm.mlp_apply(cm.subtree(p, "shared"), x, "silu",
                             residual=residual)
    elif residual is not None:
        y = y + residual
    return y, aux
