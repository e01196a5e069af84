"""Decoder blocks (port of ``repro/models/blocks.py``): the transformer
block of the dense, MoE, vlm and audio families (GQA or MLA attention),
the Mamba2 block of the ssm and hybrid families, and zamba2's
weight-shared attention block."""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.gemm import ca_matmul
from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import Defs, ParamDef


def _depth_scale(cfg: ModelConfig) -> float:
    return 1.0 / math.sqrt(2.0 * cfg.n_layers)


def _is_moe(cfg: ModelConfig) -> bool:
    return cfg.moe is not None and bool(cfg.moe.n_experts)


def transformer_block_defs(cfg: ModelConfig) -> Defs:
    ds = _depth_scale(cfg)
    defs: Defs = {}
    defs.update(cm.prefix_defs("norm_attn", cm.rms_norm_def(cfg.d_model)))
    defs.update(cm.prefix_defs("attn", attn.attn_defs(cfg, ds)))
    defs.update(cm.prefix_defs("norm_ffn", cm.rms_norm_def(cfg.d_model)))
    if _is_moe(cfg):
        defs.update(cm.prefix_defs("moe", moe_mod.moe_defs(cfg, ds)))
    else:
        defs.update(cm.prefix_defs("mlp", cm.mlp_defs(cfg.d_model, cfg.d_ff,
                                                      cfg.act, ds)))
    return defs


def transformer_block_apply(p, x, cfg: ModelConfig, *, positions,
                            cache=None, step=None, mode="train",
                            max_len=None):
    """Returns (x, new_cache, aux).  Both residual adds ride a GEMM
    drain: the attention residual in the output projection, the FFN
    residual in the down projection (the shared experts' for MoE).  The
    dense FFN's pre-norm rides the GLU or GELU program's prologue; MoE
    needs the normalized stream as a value (the router and the scatter
    read it), so its norm is a standalone op.  ``aux`` is the MoE
    load-balancing loss (0 for the dense FFN)."""
    x, new_cache = attn.attn_apply(
        cm.subtree(p, "attn"),
        cm.rms_norm(x, p["norm_attn/scale"], cfg.norm_eps),
        cfg, positions=positions, cache=cache, step=step, mode=mode,
        max_len=max_len, residual=x)
    if _is_moe(cfg):
        u = cm.rms_norm(x, p["norm_ffn/scale"], cfg.norm_eps)
        x, aux = moe_mod.moe_apply(cm.subtree(p, "moe"), u, cfg, residual=x)
    else:
        x = cm.mlp_apply(cm.subtree(p, "mlp"), x, cfg.act, residual=x,
                         norm_gain=p["norm_ffn/scale"], norm_eps=cfg.norm_eps)
        aux = 0.0
    return x, new_cache, aux


# ---------------------------------------------------------------------------
# Mamba2 block (ssm / hybrid families)
# ---------------------------------------------------------------------------

def mamba_block_defs(cfg: ModelConfig) -> Defs:
    defs: Defs = {}
    defs.update(cm.prefix_defs("norm", cm.rms_norm_def(cfg.d_model)))
    defs.update(cm.prefix_defs("mixer", ssm_mod.mamba2_defs(
        cfg, _depth_scale(cfg))))
    return defs


def mamba_block_apply(p, x, cfg: ModelConfig, *, cache=None, mode="train"):
    """Pre-norm Mamba2 mixer and its residual, added after the mixer as in
    the reference (not in out_proj's drain).  Returns (x, new_cache)."""
    h, new_cache = ssm_mod.mamba2_apply(
        cm.subtree(p, "mixer"),
        cm.rms_norm(x, p["norm/scale"], cfg.norm_eps),
        cfg, cache=cache, mode=mode)
    return x + h, new_cache


# ---------------------------------------------------------------------------
# Zamba2 shared attention block (hybrid family)
# ---------------------------------------------------------------------------

def shared_block_defs(cfg: ModelConfig) -> Defs:
    """One weight-shared attention + MLP block, applied after every full
    group of ``cfg.shared_attn_every`` Mamba2 layers.  Its input is
    concat(hidden, embedding stream) -> 2d, normalized and projected back
    to d (Zamba2's concatenation trick), then GQA and the MLP."""
    d = cfg.d_model
    ds = _depth_scale(cfg)
    defs: Defs = {"w_in": ParamDef((2 * d, d), ("embed", "embed2"))}
    defs.update(cm.prefix_defs("norm_in", cm.rms_norm_def(2 * d)))
    defs.update(cm.prefix_defs("attn", attn.gqa_defs(cfg, ds)))
    defs.update(cm.prefix_defs("norm_ffn", cm.rms_norm_def(d)))
    defs.update(cm.prefix_defs("mlp", cm.mlp_defs(d, cfg.d_ff, cfg.act, ds)))
    return defs


def shared_block_apply(p, x, emb0, cfg: ModelConfig, *, positions,
                       cache=None, step=None, mode="train", max_len=None):
    """The shared block on hidden state ``x`` and embedding stream
    ``emb0``: attention reads the projected ``u``, and its output
    projection's drain adds the hidden state ``x`` (not ``u``); the MLP's
    pre-norm rides its first program's prologue, its residual the down
    projection's drain.  Returns (x, new_cache)."""
    u = cm.rms_norm(torch.cat([x, emb0], dim=-1), p["norm_in/scale"],
                    cfg.norm_eps)
    u = ca_matmul(u, p["w_in"])
    x, new_cache = attn.gqa_apply(
        cm.subtree(p, "attn"), u, cfg, positions=positions, cache=cache,
        step=step, mode=mode, max_len=max_len, residual=x)
    x = cm.mlp_apply(cm.subtree(p, "mlp"), x, cfg.act, residual=x,
                     norm_gain=p["norm_ffn/scale"], norm_eps=cfg.norm_eps)
    return x, new_cache
