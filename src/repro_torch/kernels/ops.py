"""Program builders over the CA-GEMM kernel (port of
``repro/kernels/ops.py``).

Each entry point assembles a :class:`GemmProgramSpec` and hands it to
:func:`repro_torch.kernels.ca_mmm.ca_gemm_program`: ``fused_matmul`` is
the one-branch program, ``glu_matmul`` the dual-branch GLU program (gate
and up share one pass over x); ``quant_matmul`` and ``quant_glu_matmul``
are the same programs over int8 weights (``dqb``) or, with a static
activation scale, int8 weights and activations (``dqab``).  The rms
prologue's per-row factor is computed here in torch, differentiably, and
handed in as an (m, 1) fp32 operand.

``ca_mmm_any`` is the bare one-branch program for any shape and either
semiring; ``distance_product`` the tropical (min, +) product on it (K1g).

``fused_matmul`` and ``glu_matmul`` are trainable: when grad mode is on
and an operand requires grad they run as ``torch.autograd.Function`` s
whose backward products are K1f programs on the same kernel.  dA = dC·Bᵀ
(``nt``) and dB = Aᵀ·dC (``tn``) read the transposed operand from its
stored layout, and the activation backward ``g·act'(h)`` rides the
``dact`` prologue of those GEMMs, with h the fp32 pre-activation the
forward drained (``save_preact``).  The quantized programs have no
backward, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels import ca_mmm as kern
from repro_torch.kernels.epilogue import (Epilogue, EpilogueSpec, IDENTITY,
                                          act_fn, act_grad)
from repro_torch.kernels.program import (GemmProgramSpec, NO_PROLOGUE,
                                         PLAIN, PrologueSpec, RmsPrologue,
                                         apply_rms_reference, rms_row_scale)
from repro_torch.quant.scales import QTensor, quantize_activation


def ca_mmm_any(a: torch.Tensor, b: torch.Tensor, tile=None, *,
               out_dtype=None, semiring: str = "plus_times") -> torch.Tensor:
    """CA-MMM for arbitrary (m, k) x (k, n): masked edge tiles, no padding.

    ``tile`` (a ``TileConfig`` or (bm, bn, bk), optional) must on the card
    be the launch route's tile (``ca_mmm.route_tile``), or the call
    raises; the plain version ignores it."""
    return kern.ca_gemm_program(  # repro: noqa RPR001 -- port dispatch layer
        a, (b,), out_dtype=out_dtype, semiring=semiring, tile=tile)


def _rms_operands(x: torch.Tensor, prologue: Optional[RmsPrologue]):
    if prologue is None:
        return NO_PROLOGUE, None, None
    return (PrologueSpec(kind="rms"), rms_row_scale(x, prologue.eps),
            prologue.gain)


def _trainable(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _dact(activation: str, operand: str = "a") -> GemmProgramSpec:
    return GemmProgramSpec(prologue=PrologueSpec(
        kind="dact", activation=activation, operand=operand))


def _nt(g, b, spec=PLAIN, preact=None):
    """dA = g · Bᵀ, B read in its stored (k, n) layout, in fp32."""
    return kern.ca_gemm_program(  # repro: noqa RPR001 -- port dispatch layer
        g, (b,), spec=spec, transpose_b=True, out_dtype=torch.float32,
        preact=preact)


def _tn(a, g, out_dtype, spec=PLAIN, preact=None):
    """dB = Aᵀ · g, A read in its stored (m, k) layout."""
    return kern.ca_gemm_program(  # repro: noqa RPR001 -- port dispatch layer
        a, (g,), spec=spec, transpose_a=True, out_dtype=out_dtype,
        preact=preact)


def _rms_bwd_terms(dxn: torch.Tensor, x, row_scale, gain):
    """Chain the fp32 grad at the normalized activation back through the
    rms prologue ``xn = x · rs · gain``: returns dx, d_rs and d_gain (the
    rsqrt factor rs came from differentiable torch ops outside the
    kernel, so autograd closes the loop through the variance)."""
    xf = x.float()
    gf = gain.float()
    dx = (dxn * row_scale * gf).to(x.dtype)
    d_rs = (dxn * xf * gf).sum(dim=-1, keepdim=True)
    d_gain = (dxn * xf * row_scale).sum(dim=0).to(gain.dtype)
    return dx, d_rs, d_gain


class _FusedMM(torch.autograd.Function):
    """``epilogue(prologue(a) @ b)`` with the reference's custom VJP
    (``ops.py:108-225``): two K1f programs per backward."""

    @staticmethod
    def forward(ctx, a, b, bias, mul, residual, row_scale, gain,
                spec: EpilogueSpec, out_dtype):
        ops = {name: t for name, t in (("bias", bias), ("mul", mul),
                                       ("residual", residual))
               if t is not None}
        pro = PrologueSpec(kind="rms") if row_scale is not None \
            else NO_PROLOGUE
        out = kern.ca_gemm_program(  # repro: noqa RPR001 -- port dispatch layer
            a, (b,), spec=GemmProgramSpec(prologue=pro, branches=(spec,)),
            out_dtype=out_dtype, row_scale=row_scale, gain=gain,
            branch_operands=[ops], save_preact=spec.needs_preact)
        y, h = out if spec.needs_preact else (out, None)
        # The backward reads the mul gate's and the rms operands' values;
        # of bias and residual only their dtypes.
        ctx.save_for_backward(a, b, mul, row_scale, gain, h)
        ctx.spec = spec
        ctx.dtypes = {name: t.dtype for name, t in ops.items()}
        return y

    @staticmethod
    def backward(ctx, g):
        a, b, mul, rs, gain, h = ctx.saved_tensors
        spec = ctx.spec
        need_a, need_b = ctx.needs_input_grad[:2]
        g32 = g.float()
        d_bias = d_mul = d_res = d_rs = d_gain = da = db = None
        if spec.has_residual:
            d_res = g.to(ctx.dtypes["residual"])
        if spec.has_mul:
            # d_mul needs the post-activation: recompute it from h.
            d_mul = (g32 * act_fn(spec.activation)(h)).to(ctx.dtypes["mul"])
            d_p = g32 * mul.float()
        else:
            d_p = g32
        # dB streams the *normalized* A, which the forward never stored.
        an = a if rs is None else apply_rms_reference(a, rs, gain)
        gbar = d_p.to(a.dtype).contiguous()
        act = spec.activation
        # dz = gbar·act'(h) rides the dact prologue of both GEMMs.
        pro_a, pro_b, pre = (PLAIN, PLAIN, None) if act == "none" else \
            (_dact(act), _dact(act, "b"), h)
        dxn = _nt(gbar, b, pro_a, pre) if need_a or rs is not None else None
        if need_b:
            db = _tn(an, gbar, b.dtype, pro_b, pre)
        if spec.has_bias:
            dz = d_p if act == "none" else d_p * act_grad(act)(h)
            d_bias = dz.sum(dim=0).to(ctx.dtypes["bias"])
        if rs is not None:
            da, d_rs, d_gain = _rms_bwd_terms(dxn, a, rs, gain)
        elif dxn is not None:
            da = dxn.to(a.dtype)
        return da, db, d_bias, d_mul, d_res, d_rs, d_gain, None, None


def fused_matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    epilogue: Optional[Epilogue] = None,
    *,
    out_dtype=None,
    prologue: Optional[RmsPrologue] = None,
    tile=None,
) -> torch.Tensor:
    """``epilogue(prologue(A) @ B)`` in one kernel pass — trainable: with
    grad mode on and an operand requiring grad, the backward runs the
    ``nt``/``tn`` K1f programs.  ``tile`` is the resolved tile of the
    serving launch (checked on the card against its route's); the
    trainable path runs its routes' tiles unchecked."""
    pro, row_scale, gain = _rms_operands(a, prologue)
    spec = epilogue.spec() if epilogue is not None else IDENTITY
    ops = epilogue.operands() if epilogue is not None else {}
    if _trainable(a, b, gain, *ops.values()):
        return _FusedMM.apply(a, b, ops.get("bias"), ops.get("mul"),
                              ops.get("residual"), row_scale, gain, spec,
                              out_dtype)
    return kern.ca_gemm_program(  # repro: noqa RPR001 -- port dispatch layer
        a, (b,), spec=GemmProgramSpec(prologue=pro, branches=(spec,)),
        out_dtype=out_dtype, row_scale=row_scale, gain=gain,
        branch_operands=[ops], tile=tile)


def ca_matmul_trainable(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain trainable CA-MMM (identity epilogue)."""
    return fused_matmul(a, b)  # repro: noqa RPR001 -- port dispatch layer


class _GluMM(torch.autograd.Function):
    """``act(xn @ Wg) · (xn @ Wu)``, xn = rms(x) or x, with the
    reference's custom VJP (``ops.py:278-333``): the forward drains both
    pre-activations; the backward runs four K1f programs, the gate side's
    ``dg = (dy·u)·act'(h0)`` riding the dact prologue, plus the one
    elementwise ``du = dy·act(h0)``."""

    @staticmethod
    def forward(ctx, x, wg, wu, row_scale, gain, activation, out_dtype):
        pro = PrologueSpec(kind="rms") if row_scale is not None \
            else NO_PROLOGUE
        spec = GemmProgramSpec(prologue=pro, branches=(IDENTITY, IDENTITY),
                               combine="glu", combine_activation=activation)
        y, h0, u = kern.ca_gemm_program(  # repro: noqa RPR001 -- port dispatch layer
            x, (wg, wu), spec=spec, out_dtype=out_dtype,
            row_scale=row_scale, gain=gain, save_preact=True)
        ctx.save_for_backward(x, wg, wu, row_scale, gain, h0, u)
        ctx.activation = activation
        return y

    @staticmethod
    def backward(ctx, dy):
        x, wg, wu, rs, gain, h0, u = ctx.saved_tensors
        act = ctx.activation
        need_x, need_wg, need_wu = ctx.needs_input_grad[:3]
        dyf = dy.float()
        du = (dyf * act_fn(act)(h0)).to(x.dtype).contiguous()
        # dg = gbar·act'(h0) rides the dact prologue.
        gbar = (dyf * u).to(x.dtype).contiguous()
        xn = x if rs is None else apply_rms_reference(x, rs, gain)
        dx = dwg = dwu = d_rs = d_gain = None
        if need_x or rs is not None:
            dxn = _nt(gbar, wg, _dact(act), h0) + _nt(du, wu)
            if rs is not None:
                dx, d_rs, d_gain = _rms_bwd_terms(dxn, x, rs, gain)
            else:
                dx = dxn.to(x.dtype)
        if need_wg:
            dwg = _tn(xn, gbar, wg.dtype, _dact(act, "b"), h0)
        if need_wu:
            dwu = _tn(xn, du, wu.dtype)
        return dx, dwg, dwu, d_rs, d_gain, None, None


def glu_matmul(
    x: torch.Tensor,
    w_gate: torch.Tensor,
    w_up: torch.Tensor,
    *,
    activation: str = "silu",
    prologue: Optional[RmsPrologue] = None,
    out_dtype=None,
    tile=None,
) -> torch.Tensor:
    """``act(x @ Wg) · (x @ Wu)`` as one dual-branch program: x streams
    once for both contractions; an :class:`RmsPrologue` folds the pre-FFN
    norm into the same fetch.  Trainable like :func:`fused_matmul`;
    ``tile`` as there."""
    pro, row_scale, gain = _rms_operands(x, prologue)
    if _trainable(x, w_gate, w_up, gain):
        return _GluMM.apply(x, w_gate, w_up, row_scale, gain, activation,
                            out_dtype)
    spec = GemmProgramSpec(prologue=pro, branches=(IDENTITY, IDENTITY),
                           combine="glu", combine_activation=activation)
    return kern.ca_gemm_program(  # repro: noqa RPR001 -- port dispatch layer
        x, (w_gate, w_up), spec=spec, out_dtype=out_dtype,
        row_scale=row_scale, gain=gain, tile=tile)


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
        raise ValueError(f"QTensor format {qw.fmt!r}: the kernel takes "
                         "int8 payloads only; an fp8 emulation weight is "
                         "served by dequantizing (core.gemm.ca_matmul)")
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
    tile=None,
) -> torch.Tensor:
    """``epilogue(dequant(prologue(A) @ Q))`` in one kernel pass over an
    int8 :class:`QTensor` weight (per-channel or per-tile scales): the
    ``dqb`` program.  With ``act_scale`` (+ ``act_block``) the float ``a``
    is quantized on entry with a calibrated static scale (per-tensor, or
    per-k-tile with ``act_block=g``) and the int8×int8 ``dqab`` program
    runs.  ``prologue`` composes with float activations only.  ``tile``
    as in :func:`fused_matmul`.
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
        scale_a_block=act_block if act_scale is not None else 0, tile=tile)


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
    tile=None,
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
        scale_a_block=act_block if act_scale is not None else 0, tile=tile)


def distance_product(a: torch.Tensor, b: torch.Tensor, *,
                     tile=None) -> torch.Tensor:
    """Tropical (min, +) matrix product — paper Sec. 5.2 flexibility demo:
    ``C[i, j] = min_k (A[i, k] + B[k, j])``, fp32 out, A and B fp32 or
    bf16.  CPU operands run the plain version; CUDA operands launch the
    kernel (K1g) or raise.  ``tile``, where given, must on the card be
    the kernel's own (see :func:`ca_mmm_any`)."""
    return ca_mmm_any(a, b, tile, semiring="min_plus")
