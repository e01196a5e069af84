"""Architecture registry (port of ``repro.configs``).

This slice of the port serves stablelm-1.6b only; the other architectures
of the reference join as their model code is ported (ROADMAP queue 1).
"""

import dataclasses
from typing import List

from repro_torch.configs import stablelm_1_6b
from repro_torch.configs.base import ModelConfig

_MODULES = {
    "stablelm-1.6b": stablelm_1_6b,
}


def list_archs() -> List[str]:
    return list(_MODULES)


def _module(name: str):
    if name not in _MODULES:
        raise ValueError(f"architecture {name!r} is not ported yet "
                         f"(ported: {list_archs()})")
    return _MODULES[name]


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_reduced(name: str, compute_dtype: str = "float32") -> ModelConfig:
    """Reduced same-family config for CPU tests (fp32 compute by default,
    the dtype the port is held to the reference in)."""
    return dataclasses.replace(_module(name).reduced(),
                               compute_dtype=compute_dtype)


__all__ = ["ModelConfig", "get_config", "get_reduced", "list_archs"]
