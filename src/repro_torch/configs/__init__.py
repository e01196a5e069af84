"""Architecture registry (port of ``repro.configs``).

The port serves the dense GQA archs stablelm-1.6b, h2o-danube-3-4b and
granite-20b (GELU MLP, one KV head), the MoE archs mixtral-8x7b (sliding
window) and deepseek-v2-lite-16b (with MLA), and minicpm3-4b (MLA with
q-LoRA).  The SSM family, mrope and the multi-codebook frontend join as
their model code is ported (ROADMAP queue 1, item 2).
"""

import dataclasses
from typing import List

from repro_torch.configs import (deepseek_v2_lite_16b, granite_20b,
                                 h2o_danube_3_4b, minicpm3_4b, mixtral_8x7b,
                                 stablelm_1_6b)
from repro_torch.configs.base import ModelConfig

_MODULES = {
    "deepseek-v2-lite-16b": deepseek_v2_lite_16b,
    "mixtral-8x7b": mixtral_8x7b,
    "minicpm3-4b": minicpm3_4b,
    "granite-20b": granite_20b,
    "stablelm-1.6b": stablelm_1_6b,
    "h2o-danube-3-4b": h2o_danube_3_4b,
}


def list_archs() -> List[str]:
    return list(_MODULES)


def _module(name: str):
    if name not in _MODULES:
        raise ValueError(f"architecture {name!r} is not ported yet "
                         f"(ROADMAP queue 1, item 2; ported: {list_archs()})")
    return _MODULES[name]


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_reduced(name: str, compute_dtype: str = "float32") -> ModelConfig:
    """Reduced same-family config for CPU tests (fp32 compute by default,
    the dtype the port is held to the reference in)."""
    return dataclasses.replace(_module(name).reduced(),
                               compute_dtype=compute_dtype)


__all__ = ["ModelConfig", "get_config", "get_reduced", "list_archs"]
