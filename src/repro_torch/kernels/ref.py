"""Plain-torch oracles (port of ``repro/kernels/ref.py``)."""

from __future__ import annotations

import torch


def ref_matmul(a: torch.Tensor, b: torch.Tensor,
               out_dtype=None) -> torch.Tensor:
    """C = A @ B with fp32 (or int32) accumulation — the paper's Lst. 1."""
    if a.dtype.is_floating_point:
        c = a.float() @ b.float()
        return c.to(out_dtype or a.dtype)
    # Integer operands contract exactly; int64 holds every int8 x int8 sum.
    c = (a.long() @ b.long()).to(torch.int32)
    return c.to(out_dtype or torch.int32)
