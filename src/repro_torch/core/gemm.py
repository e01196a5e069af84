"""Public matmul API of the port (``repro/core/gemm.py``'s ``ca_matmul`` and
``ca_glu_matmul``): every dense contraction of the model funnels here.

Leading batch dims collapse into the GEMM's m dim, the (..., n) epilogue
operands with them, and the program runs on the CA-GEMM kernel — on the
card for CUDA tensors, its plain version for CPU tensors.  An epilogue or
prologue the kernel does not take raises; nothing is re-dispatched to
another path.  The reference's dispatch modes, tuning registry, ledger,
fault hooks and quantized branches are later slices (ROADMAP).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.epilogue import Epilogue
from repro_torch.kernels.program import RmsPrologue


def _flatten_epilogue(epilogue: Optional[Epilogue], m: int, n: int):
    """Collapse leading batch dims of the (..., n) epilogue operands."""
    if epilogue is None:
        return None
    mul = epilogue.mul
    residual = epilogue.residual
    if mul is not None:
        if mul.shape[-1] != n:
            raise ValueError(f"mul {tuple(mul.shape)} vs n = {n}")
        mul = mul.reshape(m, n).contiguous()
    if residual is not None:
        if residual.shape[-1] != n:
            raise ValueError(f"residual {tuple(residual.shape)} vs n = {n}")
        residual = residual.reshape(m, n).contiguous()
    return Epilogue(bias=epilogue.bias, activation=epilogue.activation,
                    mul=mul, residual=residual)


def _lead(x: torch.Tensor, k_w: int):
    if x.shape[-1] != k_w:
        raise ValueError(f"x {tuple(x.shape)} does not contract with a "
                         f"({k_w}, n) weight")
    lead = tuple(x.shape[:-1])
    m = 1
    for d in lead:
        m *= d
    return lead, m


def ca_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    out_dtype=None,
    epilogue: Optional[Epilogue] = None,
    prologue: Optional[RmsPrologue] = None,
) -> torch.Tensor:
    """``epilogue(prologue(x) @ w)``: x (..., K), w (K, N) -> (..., N) in
    ``out_dtype`` (default: x's dtype)."""
    k_w, n = w.shape
    lead, m = _lead(x, k_w)
    out_dtype = out_dtype or x.dtype
    y = kops.fused_matmul(  # repro: noqa RPR001 -- port dispatch layer
        x.reshape(m, k_w).contiguous(), w, _flatten_epilogue(epilogue, m, n),
        out_dtype=out_dtype, prologue=prologue)
    return y.reshape(*lead, n)


def ca_glu_matmul(
    x: torch.Tensor,
    w_gate: torch.Tensor,
    w_up: torch.Tensor,
    *,
    activation: str = "silu",
    out_dtype=None,
    prologue: Optional[RmsPrologue] = None,
) -> torch.Tensor:
    """``act(x @ Wg) · (x @ Wu)`` as one dual-branch program (x streams
    once); ``prologue`` folds the pre-FFN rms_norm into the same fetch."""
    k_w, n = w_gate.shape
    if tuple(w_up.shape) != (k_w, n):
        raise ValueError(f"w_up {tuple(w_up.shape)} vs w_gate "
                         f"{tuple(w_gate.shape)}")
    lead, m = _lead(x, k_w)
    out_dtype = out_dtype or x.dtype
    y = kops.glu_matmul(  # repro: noqa RPR001 -- port dispatch layer
        x.reshape(m, k_w).contiguous(), w_gate, w_up, activation=activation,
        prologue=prologue, out_dtype=out_dtype)
    return y.reshape(*lead, n)
