"""Decoder block (port of ``repro/models/blocks.py``): the transformer
block of the dense and MoE families, with GQA or MLA attention."""

from __future__ import annotations

import math

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import Defs


def _depth_scale(cfg: ModelConfig) -> float:
    return 1.0 / math.sqrt(2.0 * cfg.n_layers)


def _check_ported(cfg: ModelConfig) -> None:
    """The SSM and hybrid families, mrope and multi-codebook heads are
    not ported yet."""
    unported = {"the ssm/hybrid families": cfg.family in ("ssm", "hybrid"),
                "mrope": cfg.rope_kind != "rope",
                "multi-codebook heads": cfg.n_codebooks > 1,
                "a shared attention block": bool(cfg.shared_attn_every)}
    missing = [name for name, hit in unported.items() if hit]
    if missing:
        raise ValueError(f"{cfg.name}: {', '.join(missing)} not ported yet "
                         "(ROADMAP queue 1, item 2)")


def _is_moe(cfg: ModelConfig) -> bool:
    return cfg.moe is not None and bool(cfg.moe.n_experts)


def transformer_block_defs(cfg: ModelConfig) -> Defs:
    _check_ported(cfg)
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
