"""Program builders over the CA-GEMM kernel (port of the forward entry
points of ``repro/kernels/ops.py``).

Each entry point assembles a :class:`GemmProgramSpec` and hands it to
:func:`repro_torch.kernels.ca_mmm.ca_gemm_program`: ``fused_matmul`` is
the one-branch program, ``glu_matmul`` the dual-branch GLU program (gate
and up share one pass over x).  The rms prologue's per-row factor is
computed here in torch and handed in as an (m, 1) fp32 operand.  There is
no backward in this slice (training is ROADMAP queue 1, item 11).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ca_mmm as kern
from repro_torch.kernels.epilogue import Epilogue, IDENTITY
from repro_torch.kernels.program import (GemmProgramSpec, NO_PROLOGUE,
                                         PrologueSpec, RmsPrologue,
                                         rms_row_scale)


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
