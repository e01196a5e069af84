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
call records its input activation first.

Every launch runs the tile the kernel-config registry resolves for its
program (:func:`plan_for`; the dispatch memo
:func:`repro_torch.tuning.registry.plan` makes that a dict hit once a
signature has resolved), checked on the card against the launch's route.
With the GEMM ledger enabled (``REPRO_TORCH_LEDGER=1``) each dispatch is
recorded with its tile, the route that ran (``plain`` on the CPU) and its
planned bytes; an expert loop records once with ``calls`` = E, as the
reference's.  Disabled, the hook is one attribute check.  Before the
launch the resolved plan passes the dispatch preflight
(:func:`repro_torch.analyze.preflight.preflight_gemm`, memoized): a plan
the card cannot run (a tuning-cache entry over shared memory, a tile no
route runs, an illegal dtype chain) raises
:class:`~repro_torch.analyze.ProgramValidationError` before any launch.
The reference's dispatch modes (its XLA oracle path) are not ported.

Fault hook and fallback policy.  Every dispatch with m > 0 first consults
the active :class:`~repro_torch.runtime.fault.FaultPlan`
(:func:`_fault_check`, stage ``matmul``, ``glu``, ``quant_matmul`` or
``quant_glu``; an expert loop dispatches once per expert, as the
reference's kernel mode does).  **The port departs from the reference here,
on purpose.**  The reference also re-dispatches its XLA oracle when a
real Pallas compile or execute fails.  The port re-dispatches the plain
version **only** for a non-fatal
:class:`~repro_torch.runtime.fault.InjectedKernelFailure` raised by an
active plan, a scheduled and counted event: the ``try`` around the
dispatch catches that class and nothing broader, :func:`_note_fallback`
counts ``gemm.fallback_total{stage}`` and re-raises a fatal one, and
``set_gemm_fallback(False)`` makes injected failures propagate too.  A
CUDA error, a build failure, a ``ProgramValidationError`` or any other
exception reaches the caller, so a kernel fault is never hidden behind
the plain version.  The re-dispatch runs the same GEMM again where its
operands lie: on the card that is the kernel's launch (no host copy and no
plain version), on the CPU the plain version, which there is the kernel's
stand-in.  The request that took the failure is marked degraded by the
serve engine from the counter; its tokens equal a fault-free run's.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import torch

from repro_torch.analyze.preflight import preflight_gemm
from repro_torch.core.hardware import H100, HopperTarget
from repro_torch.core.io_model import TileConfig
from repro_torch.kernels import ca_mmm as kern
from repro_torch.kernels import ops as kops
from repro_torch.kernels.epilogue import IDENTITY, Epilogue, apply_reference
from repro_torch.kernels.program import (NO_PROLOGUE, GemmProgramSpec,
                                         PrologueSpec, RmsPrologue,
                                         apply_rms_reference, rms_row_scale)
from repro_torch.obs import ledger as _ledger_mod
from repro_torch.obs.metrics import get_metrics
from repro_torch.quant.calibrate import active_calibration
from repro_torch.quant.scales import QTensor, fake_quant_activation
from repro_torch.runtime.fault import InjectedKernelFailure, active_fault_plan
from repro_torch.tuning import registry as _registry

_RMS = PrologueSpec(kind="rms")

# ---------------------------------------------------------------------------
# Fault hook and fallback policy
# ---------------------------------------------------------------------------

_fallback_enabled = True
_fallback_lock = threading.Lock()


def set_gemm_fallback(enabled: bool) -> None:
    """Enable or disable the re-dispatch of an injected non-fatal kernel
    failure.  On (the default) the failure counts in
    ``gemm.fallback_total{stage}`` and the same GEMM is dispatched again;
    off, the failure propagates to the caller.  No other failure is ever
    re-dispatched."""
    global _fallback_enabled
    with _fallback_lock:
        _fallback_enabled = bool(enabled)


def gemm_fallback_enabled() -> bool:
    return _fallback_enabled


class gemm_fallback:
    """Context manager for temporarily switching the fallback policy."""

    def __init__(self, enabled: bool):
        self.enabled = enabled

    def __enter__(self):
        self.prev = gemm_fallback_enabled()
        set_gemm_fallback(self.enabled)
        return self

    def __exit__(self, *exc):
        set_gemm_fallback(self.prev)


def _fault_check(stage: str) -> None:
    """Chaos hook: raise the active FaultPlan's scheduled failure for this
    dispatch, if any (one thread-local read when no plan is active)."""
    plan = active_fault_plan()
    if plan is not None:
        plan.check_gemm(stage)


def _note_fallback(stage: str, exc: Exception) -> None:
    """Account an injected kernel failure and authorize its re-dispatch,
    or re-raise when the failure is fatal or the fallback
    policy is off."""
    if getattr(exc, "fatal", False) or not _fallback_enabled:
        raise exc
    get_metrics().counter(
        "gemm.fallback_total",
        "Injected kernel failures re-dispatched on the plain version, by "
        "dispatch stage").labels(stage=stage).inc()


def _dispatch(stage: str, run, x: torch.Tensor, *args, **kwargs):
    """One dispatch under the fault hook: ``run(x, *args, **kwargs)``,
    run once more when the active plan injects a non-fatal failure here
    and the fallback policy is on.  The failure is raised before ``run``
    starts, so the re-dispatch is the GEMM's only launch."""
    if x.numel() == 0:
        return run(x, *args, **kwargs)
    try:
        _fault_check(stage)
    except InjectedKernelFailure as e:
        _note_fallback(stage, e)
    return run(x, *args, **kwargs)


def _preflight(res, tag: str, m: int, n: int, k: int, dtype,
               **operands) -> None:
    """Statically verify a resolved plan before its launch (memoized per
    resolution key, tile, operand metadata and shape); ``operands``:
    ``dtype_b``, ``dtype_a``, ``scale_block``, ``act_block``."""
    hw = (_registry._global or _registry.get_registry()).hw
    preflight_gemm(res.key, tag, res.config, hw, dtype=dtype, m=m, n=n,
                   k=k, **operands)


def plan_for(m: int, n: int, k: int, dtype, hw: HopperTarget = H100,
             epilogue: str = "none", layout: str = "nn",
             dtype_b=None) -> TileConfig:
    """Resolve the tile plan through the kernel-config registry: cache hit
    > autotune (with ``REPRO_TORCH_AUTOTUNE=1``) > the analytic tier (on
    the H100 the tile of the launch's route).  ``epilogue`` (program tag)
    and ``layout`` key fused and transposed programs distinctly;
    ``dtype_b`` keys a quantized-weight GEMM under its composite dtype.
    The plan passes the dispatch preflight before it is returned."""
    res = _registry.get_registry().resolve_full(
        m, n, k, dtype=dtype, hw=hw, epilogue=epilogue, layout=layout,
        dtype_b=dtype_b)
    preflight_gemm(res.key, epilogue, res.config, hw, dtype=dtype,
                   dtype_b=dtype_b, m=m, n=n, k=k, layout=layout)
    return res.config


def _ledger():
    """The process-global GEMM ledger (one global read once created)."""
    return _ledger_mod._global or _ledger_mod.get_ledger()


def _mode(x: torch.Tensor, tile: TileConfig) -> str:
    """The route a launch ran, for the ledger: ``plain`` on the CPU; on
    the card the route whose tile the launch was checked against."""
    if x.device.type == "cpu":
        return "plain"
    return kern.tile_route((tile.bm, tile.bn, tile.bk))


def _numel(t) -> int:
    return torch.as_tensor(t).numel()


# Per thread: set while an expert loop runs its launches, which the loop
# records once (``calls`` = E) instead of one record each.
_local = threading.local()


def _recording() -> bool:
    return not getattr(_local, "in_experts", False)


def _dense_plan(m: int, n: int, k: int, dtype, epi_spec,
                rms: bool):
    """The plan and tag of a one-branch float launch (a dict hit once
    resolved)."""
    return _registry.plan(
        (m, n, k, dtype, epi_spec, rms), m, n, k, dtype,
        lambda: GemmProgramSpec(prologue=_RMS if rms else NO_PROLOGUE,
                                branches=(epi_spec,)).tag())


def _glu_plan(m: int, n: int, k: int, dtype, activation: str, rms: bool):
    """The plan and tag of a float GLU launch."""
    return _registry.plan(
        (m, n, k, dtype, "glu", activation, rms), m, n, k, dtype,
        lambda: GemmProgramSpec(
            prologue=_RMS if rms else NO_PROLOGUE,
            branches=(IDENTITY, IDENTITY), combine="glu",
            combine_activation=activation).tag())


def _quant_tag(epi_spec, prologue, act_scale, glu_activation=None) -> str:
    """The program tag ``kernels.ops.quant_matmul`` / ``quant_glu_matmul``
    build for these inputs (the reference's ``_quant_matmul_tag`` /
    ``_quant_glu_tag``): ``dqab`` on the w8a8 path, whose norm runs up
    front, ``dqb`` otherwise."""
    deq = "ab" if act_scale is not None else "b"
    pro = _RMS if (prologue is not None and act_scale is None) \
        else NO_PROLOGUE
    if glu_activation is None:
        spec = GemmProgramSpec(prologue=pro, branches=(
            dataclasses.replace(epi_spec, dequant=deq),))
    else:
        branch = dataclasses.replace(IDENTITY, dequant=deq)
        spec = GemmProgramSpec(prologue=pro, branches=(branch, branch),
                               combine="glu",
                               combine_activation=glu_activation)
    return spec.tag()


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
    rms prologue applied up front (an int8 stream cannot carry it).  One
    dispatch of the fault hook (stage ``matmul`` or ``quant_matmul``)."""
    stage = "quant_matmul" if isinstance(w, QTensor) else "matmul"
    return _dispatch(stage, _matmul, x, w, out_dtype=out_dtype,
                     epilogue=epilogue, prologue=prologue)


def _matmul(x: torch.Tensor, w, *, out_dtype=None,
            epilogue: Optional[Epilogue] = None,
            prologue: Optional[RmsPrologue] = None) -> torch.Tensor:
    """:func:`ca_matmul`'s plan, preflight, launch and ledger record."""
    quantized = isinstance(w, QTensor)
    if quantized and w.fmt != "int8":
        _record_activation(w, x, prologue)
        return _dequant_matmul(x, (w,), out_dtype, prologue,
                               epilogue=epilogue)
    if quantized:
        kops.check_qweight(w)
        _check_serve_only(x)
    k_w, n = w.shape
    lead, m = _lead(x, k_w)
    out_dtype = out_dtype or x.dtype
    epi_spec = epilogue.spec() if epilogue is not None else IDENTITY
    if not quantized:
        res = tag = None
        if m > 0:
            res, tag = _dense_plan(m, n, k_w, x.dtype, epi_spec,
                                   prologue is not None)
            _preflight(res, tag, m, n, k_w, x.dtype)
        y = kops.fused_matmul(  # repro: noqa RPR001 -- port dispatch layer
            x.reshape(m, k_w).contiguous(), w,
            _flatten_epilogue(epilogue, m, n), out_dtype=out_dtype,
            prologue=prologue, tile=res.config if res else None)
        led = _ledger()
        if led.enabled and res is not None and _recording():
            led.record_gemm(m, n, k_w, x.dtype, tag=tag,
                            mode=_mode(x, res.config), out_dtype=out_dtype,
                            resolution=res)
        return y.reshape(*lead, n)
    _record_activation(w, x, prologue)
    if w.act_scale is not None and prologue is not None:
        x, prologue = _apply_rms(x, prologue), None
    act = w.act_scale is not None
    res = None
    if m > 0:
        res, tag = _registry.plan(
            (m, n, k_w, x.dtype, epi_spec, prologue is not None, "q", act),
            m, n, k_w, x.dtype,
            lambda: _quant_tag(epi_spec, prologue, w.act_scale),
            dtype_b=torch.int8, dtype_a=torch.int8 if act else None)
        _preflight(res, tag, m, n, k_w, x.dtype, dtype_b=torch.int8,
                   dtype_a=torch.int8 if act else None,
                   scale_block=w.block, act_block=w.act_block if act else 0)
    y = kops.quant_matmul(  # repro: noqa RPR001 -- port dispatch layer
        x.reshape(m, k_w).contiguous(), w,
        _flatten_epilogue(epilogue, m, n), out_dtype=out_dtype,
        prologue=prologue, act_scale=w.act_scale, act_block=w.act_block,
        tile=res.config if res else None)
    led = _ledger()
    if led.enabled and res is not None and _recording():
        led.record_gemm(
            m, n, k_w, x.dtype, tag=tag, mode=_mode(x, res.config),
            dtype_b=torch.int8, dtype_a=torch.int8 if act else None,
            out_dtype=out_dtype,
            scale_a_elements=_numel(w.act_scale) if act else 0,
            scale_b_elements=_numel(w.scale), resolution=res)
    return y.reshape(*lead, n)


def _dequant_matmul(x: torch.Tensor, ws, out_dtype, prologue, *,
                    epilogue: Optional[Epilogue] = None,
                    activation: Optional[str] = None) -> torch.Tensor:
    """An fp8 emulation weight (or GLU pair) served as the reference's
    oracle path serves it (``src/repro/core/gemm.py:344-370``, ``:552-562``):
    the norm applied up front, each weight dequantized to x's dtype, an
    fp32 product, then the epilogue chain (or the GLU combine) and the
    output cast.  The kernel takes int8 payloads only, and the reference
    computes this product outside any Pallas kernel, so it is a plain
    product on the card too; the ledger records nothing, as the
    reference's records only int8 programs.  A static activation scale
    applies only where the gate is int8, as in the reference."""
    _check_serve_only(x)
    k_w, n = ws[0].shape
    lead, m = _lead(x, k_w)
    out_dtype = out_dtype or x.dtype
    if prologue is not None:
        x = _apply_rms(x, prologue)
    if ws[0].fmt == "int8" and ws[0].act_scale is not None:
        x = fake_quant_activation(x, ws[0].act_scale, ws[0].act_block)
    xf = x.reshape(m, k_w).float()
    zs = [xf @ w.dequantize(x.dtype).float() for w in ws]
    if activation is not None:
        from repro_torch.kernels.epilogue import act_fn

        z = act_fn(activation)(zs[0]) * zs[1]
    else:
        z = zs[0]
        if epilogue is not None:
            flat = _flatten_epilogue(epilogue, m, n)
            z = apply_reference(z, flat.spec(), flat.operands())
    return z.to(out_dtype).reshape(*lead, n)


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
    ``act_scale`` the program runs w8a8, the norm applied up front.  One
    dispatch of the fault hook (stage ``glu`` or ``quant_glu``)."""
    stage = "quant_glu" if isinstance(w_gate, QTensor) else "glu"
    return _dispatch(stage, _glu_matmul, x, w_gate, w_up,
                     activation=activation, out_dtype=out_dtype,
                     prologue=prologue)


def _glu_matmul(x: torch.Tensor, w_gate, w_up, *, activation: str = "silu",
                out_dtype=None,
                prologue: Optional[RmsPrologue] = None) -> torch.Tensor:
    """:func:`ca_glu_matmul`'s plan, preflight, launch and ledger record."""
    quantized = isinstance(w_gate, QTensor)
    if quantized != isinstance(w_up, QTensor):
        raise ValueError("quantize both GLU weights or neither")
    if quantized and not (w_gate.fmt == "int8" and w_up.fmt == "int8"):
        _record_activation(w_gate, x, prologue)
        return _dequant_matmul(x, (w_gate, w_up), out_dtype, prologue,
                               activation=activation)
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
        res = tag = None
        if m > 0:
            res, tag = _glu_plan(m, n, k_w, x.dtype, activation,
                                 prologue is not None)
            _preflight(res, tag, m, n, k_w, x.dtype)
        y = kops.glu_matmul(  # repro: noqa RPR001 -- port dispatch layer
            x.reshape(m, k_w).contiguous(), w_gate, w_up,
            activation=activation, prologue=prologue, out_dtype=out_dtype,
            tile=res.config if res else None)
        led = _ledger()
        if led.enabled and res is not None and _recording():
            led.record_gemm(m, n, k_w, x.dtype, tag=tag,
                            mode=_mode(x, res.config), out_dtype=out_dtype,
                            resolution=res)
        return y.reshape(*lead, n)
    _record_activation(w_gate, x, prologue)
    if w_gate.act_scale is not None and prologue is not None:
        x, prologue = _apply_rms(x, prologue), None
    act = w_gate.act_scale is not None
    res = None
    if m > 0:
        res, tag = _registry.plan(
            (m, n, k_w, x.dtype, "glu", activation, prologue is not None,
             "q", act),
            m, n, k_w, x.dtype,
            lambda: _quant_tag(IDENTITY, prologue, w_gate.act_scale,
                               activation),
            dtype_b=torch.int8, dtype_a=torch.int8 if act else None)
        _preflight(res, tag, m, n, k_w, x.dtype, dtype_b=torch.int8,
                   dtype_a=torch.int8 if act else None,
                   scale_block=w_gate.block,
                   act_block=w_gate.act_block if act else 0)
    y = kops.quant_glu_matmul(  # repro: noqa RPR001 -- port dispatch layer
        x.reshape(m, k_w).contiguous(), w_gate, w_up, activation=activation,
        prologue=prologue, out_dtype=out_dtype, act_scale=w_gate.act_scale,
        act_block=w_gate.act_block, tile=res.config if res else None)
    led = _ledger()
    if led.enabled and res is not None and _recording():
        led.record_gemm(
            m, n, k_w, x.dtype, tag=tag, mode=_mode(x, res.config),
            dtype_b=torch.int8, dtype_a=torch.int8 if act else None,
            out_dtype=out_dtype,
            scale_a_elements=_numel(w_gate.act_scale) if act else 0,
            scale_b_elements=(_numel(w_gate.scale)
                              + _numel(w_up.scale)), resolution=res)
    return y.reshape(*lead, n)


def ca_einsum(spec: str, x: torch.Tensor, w, **kw) -> torch.Tensor:
    """An einsum whose matmul-shaped specs (``...k,kn->...n``: ``w`` 2-D,
    x's last index contracted, the output x's other indices then w's)
    run on K1 through :func:`ca_matmul` (``kw`` its keywords); any other
    spec is a plain fp32 einsum of the operands (the reference's
    ``preferred_element_type=float32``), which takes no keywords."""
    try:
        lhs, out = spec.replace(" ", "").split("->")
        a_spec, b_spec = lhs.split(",")
    except ValueError:
        a_spec = b_spec = out = None
    if (b_spec is not None and len(b_spec) == 2 and a_spec[-1] == b_spec[0]
            and out == a_spec[:-1] + b_spec[1]):
        return ca_matmul(x, w, **kw)
    if kw:
        raise ValueError(f"ca_einsum({spec!r}) is not matmul-shaped: "
                         f"{sorted(kw)} are ca_matmul's keywords")
    return torch.einsum(spec, x.float(), w.float())


def dist_local_matmul(a: torch.Tensor, b: torch.Tensor, *,  # repro: noqa RPR002 -- dist_matmul records once per collective dispatch
                      tile: Optional[TileConfig] = None) -> torch.Tensor:
    """One ring step's local GEMM of a distributed schedule
    (``core.distributed``), with the tile the dispatch already resolved
    for the per-rank local shape, so no per-step registry or ledger work
    happens here: K1's ``none`` program with an fp32 output on CUDA
    operands (the kernel checks ``tile`` against its route), its plain
    version on CPU operands.  Float operands only: the int8 partials are
    plain products in ``core.distributed``, as the reference computes
    them outside any Pallas kernel."""
    if not (a.dtype.is_floating_point and b.dtype.is_floating_point):
        raise ValueError(f"dist_local_matmul takes float operands, got "
                         f"{a.dtype} x {b.dtype}")
    return kops.fused_matmul(  # repro: noqa RPR001 -- port dispatch layer
        a, b, out_dtype=torch.float32, tile=tile)


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


def _record_experts(x: torch.Tensor, E: int, n: int, plan,
                    out_dtype) -> None:
    """One ledger record for an expert loop: ``calls`` = E launches of
    the per-expert GEMM at that expert's rows (the reference's fold)."""
    led = _ledger()
    k = x.shape[-1]
    m = x.numel() // (E * k) if E and k else 0
    if led.enabled and m > 0:
        res, tag = plan(m)
        led.record_gemm(m, n, k, x.dtype, tag=tag, mode=_mode(x, res.config),
                        out_dtype=out_dtype or x.dtype, calls=E,
                        resolution=res)


def _expert_loop(fn, E: int):
    """Run the per-expert launches with their own ledger records off (the
    loop records once)."""
    _local.in_experts = True
    try:
        return [fn(e) for e in range(E)]
    finally:
        _local.in_experts = False


def ca_expert_matmul(x: torch.Tensor, w: torch.Tensor, *,
                     out_dtype=None) -> torch.Tensor:
    """The MoE contraction ``x[..., e, :, :] @ w[e]`` (the reference's
    ``...ecd,edf->...ecf``) as one :func:`ca_matmul` per expert (K1 on the
    card, its plain version on the CPU; each a dispatch of the fault hook),
    stacked on the expert axis; the ledger
    records the loop once, ``calls`` = E.  The operands are unbound once,
    so a backward stacks each bank's and the buffer's gradient in one
    op, where indexing would add a full-size zero-padded gradient per
    expert."""
    E = _check_expert_operands(x, w, "ca_expert_matmul")
    xs, ws = x.unbind(-3), w.unbind(0)
    ys = _expert_loop(lambda e: ca_matmul(xs[e], ws[e],
                                          out_dtype=out_dtype), E)
    k, n = w.shape[-2:]
    _record_experts(x, E, n, lambda m: _dense_plan(m, n, k, x.dtype,
                                                   IDENTITY, False),
                    out_dtype)
    return torch.stack(ys, dim=-3)


def ca_expert_glu_matmul(x: torch.Tensor, w_gate: torch.Tensor,
                         w_up: torch.Tensor, *, activation: str = "silu",
                         out_dtype=None) -> torch.Tensor:
    """Per-expert dual-branch GLU: each expert's gate and up share one
    pass over that expert's capacity rows (:func:`ca_glu_matmul` once per
    expert, each a dispatch of the fault hook), stacked on the expert
    axis; recorded once, ``calls`` = E."""
    E = _check_expert_operands(x, w_gate, "ca_expert_glu_matmul")
    if tuple(w_up.shape) != tuple(w_gate.shape):
        raise ValueError(f"w_up {tuple(w_up.shape)} vs w_gate "
                         f"{tuple(w_gate.shape)}")
    xs, wgs, wus = x.unbind(-3), w_gate.unbind(0), w_up.unbind(0)
    ys = _expert_loop(lambda e: ca_glu_matmul(
        xs[e], wgs[e], wus[e], activation=activation,
        out_dtype=out_dtype), E)
    k, n = w_gate.shape[-2:]
    _record_experts(x, E, n, lambda m: _glu_plan(m, n, k, x.dtype,
                                                 activation, False),
                    out_dtype)
    return torch.stack(ys, dim=-3)
