"""Public matmul API of the port (``repro/core/gemm.py``'s ``ca_matmul``,
``ca_glu_matmul`` and the MoE expert loops ``ca_expert_matmul`` /
``ca_expert_glu_matmul``): every dense contraction of the model funnels
here.

Leading batch dims collapse into the GEMM's m dim, the (..., n) epilogue
operands with them, and the program runs on the CA-GEMM kernel — on the
card for CUDA tensors, its plain version for CPU tensors.  An epilogue or
prologue the kernel does not take raises; nothing is re-dispatched to
another path.  Dense weights go through the trainable entry points
(``kernels.ops.fused_matmul``/``glu_matmul``), so gradients flow through
the K1f backward programs whenever an operand requires grad.

A :class:`~repro_torch.quant.QTensor` weight routes to the quantized
programs: int8 weights (``dqb``), or with a calibrated ``act_scale`` the
w8a8 programs (``dqab``), which quantize the activation on entry; these
have no backward, as in the reference, so an activation that requires
grad raises there.  While
an :class:`~repro_torch.quant.ActivationCalibration` is active, each such
call records its input activation first.  The reference's dispatch modes
(its XLA oracle path), tuning registry, ledger and fault hooks are later
slices (ROADMAP).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.epilogue import Epilogue
from repro_torch.kernels.program import (RmsPrologue, apply_rms_reference,
                                         rms_row_scale)
from repro_torch.quant.calibrate import active_calibration
from repro_torch.quant.scales import QTensor


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


def _apply_rms(x: torch.Tensor, prologue: RmsPrologue) -> torch.Tensor:
    """The rms prologue's chain applied up front (the standalone
    ``rms_norm``)."""
    return apply_rms_reference(x, rms_row_scale(x, prologue.eps),
                               prologue.gain)


def _check_serve_only(x: torch.Tensor) -> None:
    if torch.is_grad_enabled() and x.requires_grad:
        raise ValueError("the quantized programs have no backward (serving "
                         "only, as in the reference): run them under "
                         "torch.no_grad() or on an activation that does "
                         "not require grad")


def _record_activation(quant: QTensor, x: torch.Tensor,
                       prologue: Optional[RmsPrologue]) -> None:
    """Hand this GEMM's input activation to an active calibration context
    (the w8a8 observe phase): the *normalized* activation when an rms
    prologue precedes the projection, since that is what the serve path
    will quantize."""
    ctx = active_calibration()
    if ctx is None:
        return
    ctx.record(quant.shape, _apply_rms(x, prologue) if prologue is not None
               else x)


def ca_matmul(
    x: torch.Tensor,
    w,
    *,
    out_dtype=None,
    epilogue: Optional[Epilogue] = None,
    prologue: Optional[RmsPrologue] = None,
) -> torch.Tensor:
    """``epilogue(prologue(x) @ w)``: x (..., K), w (K, N) -> (..., N) in
    ``out_dtype`` (default: x's dtype).  ``w`` may be an int8
    :class:`QTensor`; one carrying an ``act_scale`` serves w8a8, with an
    rms prologue applied up front (an int8 stream cannot carry it)."""
    quantized = isinstance(w, QTensor)
    if quantized:
        kops.check_qweight(w)
        _check_serve_only(x)
    k_w, n = w.shape
    lead, m = _lead(x, k_w)
    out_dtype = out_dtype or x.dtype
    if not quantized:
        y = kops.fused_matmul(  # repro: noqa RPR001 -- port dispatch layer
            x.reshape(m, k_w).contiguous(), w,
            _flatten_epilogue(epilogue, m, n), out_dtype=out_dtype,
            prologue=prologue)
        return y.reshape(*lead, n)
    _record_activation(w, x, prologue)
    if w.act_scale is not None and prologue is not None:
        x, prologue = _apply_rms(x, prologue), None
    y = kops.quant_matmul(  # repro: noqa RPR001 -- port dispatch layer
        x.reshape(m, k_w).contiguous(), w,
        _flatten_epilogue(epilogue, m, n), out_dtype=out_dtype,
        prologue=prologue, act_scale=w.act_scale, act_block=w.act_block)
    return y.reshape(*lead, n)


def ca_glu_matmul(
    x: torch.Tensor,
    w_gate,
    w_up,
    *,
    activation: str = "silu",
    out_dtype=None,
    prologue: Optional[RmsPrologue] = None,
) -> torch.Tensor:
    """``act(x @ Wg) · (x @ Wu)`` as one dual-branch program (x streams
    once); ``prologue`` folds the pre-FFN rms_norm into the same fetch.
    Both weights are dense or both int8 :class:`QTensor` s; with the gate's
    ``act_scale`` the program runs w8a8, the norm applied up front."""
    quantized = isinstance(w_gate, QTensor)
    if quantized != isinstance(w_up, QTensor):
        raise ValueError("quantize both GLU weights or neither")
    if quantized:
        kops.check_qweight(w_gate)
        kops.check_qweight(w_up)
        _check_serve_only(x)
    k_w, n = w_gate.shape
    if tuple(w_up.shape) != (k_w, n):
        raise ValueError(f"w_up {tuple(w_up.shape)} vs w_gate "
                         f"{tuple(w_gate.shape)}")
    lead, m = _lead(x, k_w)
    out_dtype = out_dtype or x.dtype
    if not quantized:
        y = kops.glu_matmul(  # repro: noqa RPR001 -- port dispatch layer
            x.reshape(m, k_w).contiguous(), w_gate, w_up,
            activation=activation, prologue=prologue, out_dtype=out_dtype)
        return y.reshape(*lead, n)
    _record_activation(w_gate, x, prologue)
    if w_gate.act_scale is not None and prologue is not None:
        x, prologue = _apply_rms(x, prologue), None
    y = kops.quant_glu_matmul(  # repro: noqa RPR001 -- port dispatch layer
        x.reshape(m, k_w).contiguous(), w_gate, w_up, activation=activation,
        prologue=prologue, out_dtype=out_dtype, act_scale=w_gate.act_scale,
        act_block=w_gate.act_block)
    return y.reshape(*lead, n)


def _check_expert_operands(x: torch.Tensor, w, name: str) -> int:
    if isinstance(w, QTensor):
        raise ValueError(f"{name}: the expert banks serve in the compute "
                         "dtype (the reference's quantize predicate skips "
                         "them)")
    if w.dim() != 3 or x.dim() < 3 or x.shape[-3] != w.shape[0] \
            or x.shape[-1] != w.shape[1]:
        raise ValueError(f"{name}: x {tuple(x.shape)} does not contract "
                         f"with an (E, k, n) bank {tuple(w.shape)}")
    return w.shape[0]


def ca_expert_matmul(x: torch.Tensor, w: torch.Tensor, *,
                     out_dtype=None) -> torch.Tensor:
    """The MoE contraction ``x[..., e, :, :] @ w[e]`` (the reference's
    ``...ecd,edf->...ecf``) as one :func:`ca_matmul` per expert (K1 on the
    card, its plain version on the CPU), stacked on the expert axis."""
    E = _check_expert_operands(x, w, "ca_expert_matmul")
    return torch.stack([ca_matmul(x[..., e, :, :], w[e], out_dtype=out_dtype)
                        for e in range(E)], dim=-3)


def ca_expert_glu_matmul(x: torch.Tensor, w_gate: torch.Tensor,
                         w_up: torch.Tensor, *, activation: str = "silu",
                         out_dtype=None) -> torch.Tensor:
    """Per-expert dual-branch GLU: each expert's gate and up share one
    pass over that expert's capacity rows (:func:`ca_glu_matmul` once per
    expert), stacked on the expert axis."""
    E = _check_expert_operands(x, w_gate, "ca_expert_glu_matmul")
    if tuple(w_up.shape) != tuple(w_gate.shape):
        raise ValueError(f"w_up {tuple(w_up.shape)} vs w_gate "
                         f"{tuple(w_gate.shape)}")
    return torch.stack([ca_glu_matmul(x[..., e, :, :], w_gate[e], w_up[e],
                                      activation=activation,
                                      out_dtype=out_dtype)
                        for e in range(E)], dim=-3)
