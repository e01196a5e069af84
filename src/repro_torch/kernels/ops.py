"""Program builders over the CA-GEMM kernel (port of the forward entry
points of ``repro/kernels/ops.py``).

Each entry point assembles a :class:`GemmProgramSpec` and hands it to
:func:`repro_torch.kernels.ca_mmm.ca_gemm_program`: ``fused_matmul`` is
the one-branch program, ``glu_matmul`` the dual-branch GLU program (gate
and up share one pass over x); ``quant_matmul`` and ``quant_glu_matmul``
are the same programs over int8 weights (``dqb``) or, with a static
activation scale, int8 weights and activations (``dqab``).  The rms prologue's per-row factor is
computed here in torch and handed in as an (m, 1) fp32 operand.  There is
no backward in this slice (training is ROADMAP queue 1, item 11).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels import ca_mmm as kern
from repro_torch.kernels.epilogue import Epilogue, IDENTITY
from repro_torch.kernels.program import (GemmProgramSpec, NO_PROLOGUE,
                                         PrologueSpec, RmsPrologue,
                                         rms_row_scale)
from repro_torch.quant.scales import QTensor, quantize_activation


def _rms_operands(x: torch.Tensor, prologue: Optional[RmsPrologue]):
    if prologue is None:
        return NO_PROLOGUE, None, None
    return (PrologueSpec(kind="rms"), rms_row_scale(x, prologue.eps),
            prologue.gain)


def fused_matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    epilogue: Optional[Epilogue] = None,
    *,
    out_dtype=None,
    prologue: Optional[RmsPrologue] = None,
) -> torch.Tensor:
    """``epilogue(prologue(A) @ B)`` in one kernel pass."""
    pro, row_scale, gain = _rms_operands(a, prologue)
    spec = GemmProgramSpec(
        prologue=pro,
        branches=(epilogue.spec() if epilogue is not None else IDENTITY,))
    ops = epilogue.operands() if epilogue is not None else {}
    return kern.ca_gemm_program(  # repro: noqa RPR001 -- port dispatch layer
        a, (b,), spec=spec, out_dtype=out_dtype, row_scale=row_scale,
        gain=gain, branch_operands=[ops])


def glu_matmul(
    x: torch.Tensor,
    w_gate: torch.Tensor,
    w_up: torch.Tensor,
    *,
    activation: str = "silu",
    prologue: Optional[RmsPrologue] = None,
    out_dtype=None,
) -> torch.Tensor:
    """``act(x @ Wg) · (x @ Wu)`` as one dual-branch program: x streams
    once for both contractions; an :class:`RmsPrologue` folds the pre-FFN
    norm into the same fetch."""
    pro, row_scale, gain = _rms_operands(x, prologue)
    spec = GemmProgramSpec(prologue=pro, branches=(IDENTITY, IDENTITY),
                           combine="glu", combine_activation=activation)
    return kern.ca_gemm_program(  # repro: noqa RPR001 -- port dispatch layer
        x, (w_gate, w_up), spec=spec, out_dtype=out_dtype,
        row_scale=row_scale, gain=gain)


# ---------------------------------------------------------------------------
# Quantized (in-kernel dequant) programs — repro_torch.quant consumers
# ---------------------------------------------------------------------------

def check_qweight(qw, k: Optional[int] = None) -> None:
    """The quantized programs' weight contract: an int8, (k, n)
    :class:`QTensor` quantized along k (contracting with an activation of
    ``k`` columns, where given)."""
    if not isinstance(qw, QTensor):
        raise ValueError(f"the kernel takes int8 QTensor weights, got "
                         f"{type(qw).__name__}")
    if qw.fmt != "int8":
        raise ValueError(f"QTensor format {qw.fmt!r} is not ported yet "
                         "(ROADMAP queue 1, item 7)")
    if qw.ndim != 2:
        raise ValueError(f"a QTensor weight must be (k, n), got {qw.shape}")
    # A wrong-axis QTensor would pass the reshapes below for square
    # weights and mis-scale silently.
    if qw.axis not in (-2, 0):
        raise ValueError(f"weight quantized along axis {qw.axis}, expected "
                         "the k axis (-2)")
    if k is not None and qw.shape[0] != k:
        raise ValueError(f"x with k = {k} does not contract with a "
                         f"{qw.shape} weight")


def _scale_b(qw: QTensor) -> torch.Tensor:
    # (ceil(k/block), n) per-tile rows, or the (1, n) keepdims per-channel
    # scale as flat channels.
    return qw.scale if qw.block else qw.scale.reshape(qw.shape[1])


def _static_act(x, act_scale, act_block: int):
    """Quantize ``x`` on entry with a static scale; returns the int8
    activation and its ``scale_a`` operand: per-k-tile, or the per-tensor
    scale as an (m,) per-row vector."""
    xq = quantize_activation(x, act_scale, block=act_block)
    sa = torch.as_tensor(act_scale, dtype=torch.float32, device=x.device)
    if not act_block:
        sa = sa.reshape(1).expand(x.shape[0]).contiguous()
    return xq, sa


def quant_matmul(
    a: torch.Tensor,
    qw: QTensor,
    epilogue: Optional[Epilogue] = None,
    *,
    act_scale: Optional[torch.Tensor] = None,
    act_block: int = 0,
    out_dtype=None,
    prologue: Optional[RmsPrologue] = None,
) -> torch.Tensor:
    """``epilogue(dequant(prologue(A) @ Q))`` in one kernel pass over an
    int8 :class:`QTensor` weight (per-channel or per-tile scales): the
    ``dqb`` program.  With ``act_scale`` (+ ``act_block``) the float ``a``
    is quantized on entry with a calibrated static scale (per-tensor, or
    per-k-tile with ``act_block=g``) and the int8×int8 ``dqab`` program
    runs.  ``prologue`` composes with float activations only.
    """
    check_qweight(qw, a.shape[1])
    if prologue is not None and act_scale is not None:
        raise ValueError("the rms prologue composes with float activations, "
                         "not the int8 'ab' path: normalize before "
                         "quantizing")
    base = epilogue.spec() if epilogue is not None else IDENTITY
    ops = dict(epilogue.operands()) if epilogue is not None else {}
    ops["scale_b"] = _scale_b(qw)
    deq = "b"
    if act_scale is not None:
        a, ops["scale_a"] = _static_act(a, act_scale, act_block)
        deq = "ab"
    pro, row_scale, gain = _rms_operands(a, prologue)
    spec = GemmProgramSpec(prologue=pro, branches=(
        dataclasses.replace(base, dequant=deq),))
    return kern.ca_gemm_program(  # repro: noqa RPR001 -- port dispatch layer
        a, (qw.data,), spec=spec, out_dtype=out_dtype, row_scale=row_scale,
        gain=gain, branch_operands=[ops], scale_b_block=qw.block,
        scale_a_block=act_block if act_scale is not None else 0)


def quant_glu_matmul(
    x: torch.Tensor,
    qwg: QTensor,
    qwu: QTensor,
    *,
    activation: str = "silu",
    prologue: Optional[RmsPrologue] = None,
    out_dtype=None,
    act_scale: Optional[torch.Tensor] = None,
    act_block: int = 0,
) -> torch.Tensor:
    """Quantized dual-branch GLU: both int8 weights stream in one pass over
    x, each branch's dequant on its own accumulator (per-tile scales on
    every branch; both weights share one block size).  ``act_scale``
    quantizes x on entry: the w8a8 program, one int8 x stream for both
    branches (``prologue`` must then be None: normalize first)."""
    for qw in (qwg, qwu):
        check_qweight(qw, x.shape[1])
    if qwg.shape != qwu.shape or qwg.block != qwu.block:
        raise ValueError(f"GLU weights {qwg.shape}/{qwu.shape} with blocks "
                         f"{qwg.block}/{qwu.block}: one shape and one block")
    branch_ops = [{"scale_b": _scale_b(qw)} for qw in (qwg, qwu)]
    deq = "b"
    if act_scale is not None:
        if prologue is not None:
            raise ValueError("apply the norm before static activation "
                             "quantization (an rms prologue cannot "
                             "decorate an int8 stream)")
        x, sa = _static_act(x, act_scale, act_block)
        for ops in branch_ops:
            ops["scale_a"] = sa
        deq = "ab"
    pro, row_scale, gain = _rms_operands(x, prologue)
    branch = dataclasses.replace(IDENTITY, dequant=deq)
    spec = GemmProgramSpec(prologue=pro, branches=(branch, branch),
                           combine="glu", combine_activation=activation)
    return kern.ca_gemm_program(  # repro: noqa RPR001 -- port dispatch layer
        x, (qwg.data, qwu.data), spec=spec, out_dtype=out_dtype,
        row_scale=row_scale, gain=gain, branch_operands=branch_ops,
        scale_b_block=qwg.block,
        scale_a_block=act_block if act_scale is not None else 0)
