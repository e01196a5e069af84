"""Architecture registry (port of ``repro.configs``): one module per
architecture, in the reference's order.

The dense GQA archs (stablelm-1.6b, h2o-danube-3-4b, granite-20b), the
MoE archs (mixtral-8x7b, deepseek-v2-lite-16b with MLA), minicpm3-4b
(MLA with q-LoRA), the attention-free SSM mamba2-370m, the hybrid
zamba2-7b (Mamba2 layers and one weight-shared attention block),
qwen2-vl-72b (M-RoPE over the ``embeds`` frontend) and musicgen-large
(four codebook heads over the ``embeds`` frontend).  ``paper_gemm`` holds
the paper's standalone GEMM sizes.
"""

import dataclasses
from typing import List

from repro_torch.configs import (deepseek_v2_lite_16b, granite_20b,
                                 h2o_danube_3_4b, mamba2_370m, minicpm3_4b,
                                 mixtral_8x7b, musicgen_large, qwen2_vl_72b,
                                 stablelm_1_6b, zamba2_7b)
from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig,
                                      applicable_shapes)

_MODULES = {
    "deepseek-v2-lite-16b": deepseek_v2_lite_16b,
    "mixtral-8x7b": mixtral_8x7b,
    "mamba2-370m": mamba2_370m,
    "minicpm3-4b": minicpm3_4b,
    "granite-20b": granite_20b,
    "stablelm-1.6b": stablelm_1_6b,
    "h2o-danube-3-4b": h2o_danube_3_4b,
    "qwen2-vl-72b": qwen2_vl_72b,
    "musicgen-large": musicgen_large,
    "zamba2-7b": zamba2_7b,
}


def list_archs() -> List[str]:
    return list(_MODULES)


def _module(name: str):
    if name not in _MODULES:
        raise ValueError(f"unknown architecture {name!r} (known: "
                         f"{list_archs()})")
    return _MODULES[name]


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_reduced(name: str, compute_dtype: str = "float32") -> ModelConfig:
    """Reduced same-family config for CPU tests (fp32 compute by default,
    the dtype the port is held to the reference in)."""
    return dataclasses.replace(_module(name).reduced(),
                               compute_dtype=compute_dtype)


__all__ = ["SHAPES", "ModelConfig", "ShapeConfig", "applicable_shapes",
           "get_config", "get_reduced", "list_archs"]
