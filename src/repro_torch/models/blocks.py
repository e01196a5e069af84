"""Decoder block (port of ``repro/models/blocks.py``), dense family only."""

from __future__ import annotations

import math

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models.common import Defs


def _depth_scale(cfg: ModelConfig) -> float:
    return 1.0 / math.sqrt(2.0 * cfg.n_layers)


def _check_dense(cfg: ModelConfig) -> None:
    if (cfg.family != "dense" or cfg.attn_kind != "gqa"
            or cfg.moe is not None or cfg.rope_kind != "rope"):
        raise ValueError(f"{cfg.name}: only the dense GQA block with plain "
                         "RoPE is ported (ROADMAP queue 1, item 12)")


def transformer_block_defs(cfg: ModelConfig) -> Defs:
    _check_dense(cfg)
    ds = _depth_scale(cfg)
    defs: Defs = {}
    defs.update(cm.prefix_defs("norm_attn", cm.rms_norm_def(cfg.d_model)))
    defs.update(cm.prefix_defs("attn", attn.gqa_defs(cfg, ds)))
    defs.update(cm.prefix_defs("norm_ffn", cm.rms_norm_def(cfg.d_model)))
    defs.update(cm.prefix_defs("mlp", cm.mlp_defs(cfg.d_model, cfg.d_ff,
                                                  cfg.act, ds)))
    return defs


def transformer_block_apply(p, x, cfg: ModelConfig, *, positions,
                            cache=None, step=None, mode="train",
                            max_len=None):
    """Both residual adds ride a GEMM drain: the attention residual in the
    output projection, the FFN residual in the down projection; the
    pre-FFN rms_norm rides the GLU program's prologue."""
    x, new_cache = attn.gqa_apply(
        cm.subtree(p, "attn"),
        cm.rms_norm(x, p["norm_attn/scale"], cfg.norm_eps),
        cfg, positions=positions, cache=cache, step=step, mode=mode,
        max_len=max_len, residual=x)
    x = cm.mlp_apply(cm.subtree(p, "mlp"), x, cfg.act, residual=x,
                     norm_gain=p["norm_ffn/scale"], norm_eps=cfg.norm_eps)
    return x, new_cache
