"""Communication-avoiding GEMM program kernel (port of
``repro/kernels/ca_mmm.py:ca_gemm_program``).

The kernel is hand-written CUDA C++ for Hopper,
``repro_torch/csrc/ca_gemm_program.cu``: one CTA keeps its output tile's
fp32 accumulators (one per B branch) resident for the whole k loop, streams
the A and B panels through shared memory, folds the rms prologue into the
A fetch and runs the whole drain chain (bias → act → mul → residual, or
the ``glu`` combine) before the single write-back of each C element.

Dispatch depends only on where the operands lie: a CPU tensor runs the
plain-torch version :func:`ca_gemm_program_reference`; a CUDA tensor
launches the kernel or raises.  The kernel is compiled with ``nvcc`` at
first use into ``build/`` at the repository root and bound through
``ctypes`` (a plain C entry point, no PyTorch headers), by
:mod:`repro_torch.kernels._build`.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.epilogue import act_fn, apply_reference
from repro_torch.kernels.program import (GemmProgramSpec, PLAIN,
                                         apply_rms_reference)

SOURCE = _build.CSRC / "ca_gemm_program.cu"

# Launches of the CUDA kernel, by program tag.  Only the kernel launch
# below adds to it; the plain version never does.
launch_counts: Dict[str, int] = {}

_ACT_CODES = {"none": 0, "relu": 1, "gelu": 2, "silu": 3}
_FLOATS = (torch.float32, torch.bfloat16)


def reset_launch_counts() -> None:
    launch_counts.clear()


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.ca_gemm_program_launch
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 11
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int


def _library() -> ctypes.CDLL:
    return _build.load(SOURCE, _bind)


# ---------------------------------------------------------------------------
# Validation shared by both paths
# ---------------------------------------------------------------------------

def _unsupported(what: str, slice_: str) -> ValueError:
    return ValueError(f"{what} is not ported yet (ROADMAP queue 2, {slice_})")


def _check_program(spec: GemmProgramSpec, semiring: str,
                   transpose_a: bool, transpose_b: bool,
                   save_preact: bool) -> None:
    if semiring != "plus_times":
        raise _unsupported(f"semiring {semiring!r}", "K1g")
    if transpose_a or transpose_b or save_preact:
        raise _unsupported("transposed layouts and save_preact", "K1f")
    if spec.prologue.kind == "dact":
        raise _unsupported("the dact prologue", "K1f")
    if any(b.dequant != "none" for b in spec.branches):
        raise _unsupported("dequant epilogues", "K1d/K1e")
    if spec.n_b == 2 and spec.combine != "glu":
        raise _unsupported("two-output 'dual' programs", "K1c follow-up")


def _check_operands(a, bs, spec, row_scale, gain, branch_operands):
    """Shapes, dtypes, devices and contiguity the kernel takes; returns
    (m, n, k)."""
    if len(bs) != spec.n_b:
        raise ValueError(f"{spec.tag()!r} takes {spec.n_b} B operand(s), "
                         f"got {len(bs)}")
    if len(branch_operands) != spec.n_b:
        raise ValueError("one branch_operands dict per B operand")
    if a.dim() != 2 or a.dtype not in _FLOATS:
        raise ValueError(f"A must be a 2-D float32/bfloat16 tensor, got "
                         f"{tuple(a.shape)} {a.dtype}")
    m, k = a.shape
    n = bs[0].shape[-1]
    tensors = [a]
    for b in bs:
        if b.dim() != 2 or tuple(b.shape) != (k, n) or b.dtype != a.dtype:
            raise ValueError(f"B must be ({k}, {n}) {a.dtype}, got "
                             f"{tuple(b.shape)} {b.dtype}")
        tensors.append(b)
    if spec.prologue.kind == "rms":
        if row_scale is None or gain is None:
            raise ValueError("the rms prologue needs row_scale and gain")
        if tuple(row_scale.shape) != (m, 1) or row_scale.dtype != torch.float32:
            raise ValueError(f"row_scale must be ({m}, 1) float32, got "
                             f"{tuple(row_scale.shape)} {row_scale.dtype}")
        if tuple(gain.shape) != (k,) or gain.dtype not in _FLOATS:
            raise ValueError(f"gain must be ({k},) float32/bfloat16, got "
                             f"{tuple(gain.shape)} {gain.dtype}")
        tensors += [row_scale, gain]
    elif row_scale is not None or gain is not None:
        raise ValueError("row_scale/gain given without an rms prologue")
    for bspec, ops in zip(spec.branches, branch_operands):
        want = {"bias": bspec.has_bias, "mul": bspec.has_mul,
                "residual": bspec.has_residual}
        extra = set(ops) - {name for name, on in want.items() if on}
        if extra:
            raise ValueError(f"operands {sorted(extra)} not in program "
                             f"{spec.tag()!r}")
        for name, on in want.items():
            if not on:
                continue
            t = ops.get(name)
            shape = (n,) if name == "bias" else (m, n)
            if t is None or tuple(t.shape) != shape or t.dtype not in _FLOATS:
                raise ValueError(
                    f"{name} must be a {shape} float32/bfloat16 tensor, got "
                    f"{None if t is None else (tuple(t.shape), t.dtype)}")
            tensors.append(t)
    dev = a.device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"operands on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("the kernel takes contiguous operands")
    return m, n, k


def _out_dtype(a: torch.Tensor, out_dtype) -> torch.dtype:
    # ca_mmm.py:445-452 for float operands: the output defaults to A's
    # dtype, glu included.
    out = out_dtype or a.dtype
    if out not in _FLOATS:
        raise ValueError(f"out_dtype must be float32/bfloat16, got {out}")
    return out


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def ca_gemm_program_reference(
    a: torch.Tensor,
    bs: Sequence[torch.Tensor],
    *,
    spec: GemmProgramSpec = PLAIN,
    out_dtype=None,
    row_scale: Optional[torch.Tensor] = None,
    gain: Optional[torch.Tensor] = None,
    branch_operands: Optional[Sequence[Dict[str, torch.Tensor]]] = None,
) -> torch.Tensor:
    """The same program in plain torch: prologue, fp32 products, drain
    chain and combine, in the kernel's order."""
    bs = tuple(bs)
    branch_operands = list(branch_operands or [{} for _ in bs])
    _check_program(spec, "plus_times", False, False, False)
    _check_operands(a, bs, spec, row_scale, gain, branch_operands)
    out_dtype = _out_dtype(a, out_dtype)
    if spec.prologue.kind == "rms":
        a = apply_rms_reference(a, row_scale, gain)
    af = a.float()
    vals = []
    for b, bspec, ops in zip(bs, spec.branches, branch_operands):
        z = af @ b.float()
        vals.append(z if bspec.is_identity
                    else apply_reference(z, bspec, ops))
    if spec.combine == "glu":
        y = act_fn(spec.combine_activation)(vals[0]) * vals[1]
    else:
        y = vals[0]
    return y.to(out_dtype)


# ---------------------------------------------------------------------------
# Wrapper
# ---------------------------------------------------------------------------

def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _launch(a, bs, spec: GemmProgramSpec, out_dtype, row_scale, gain,
            branch_operands, m: int, n: int, k: int) -> torch.Tensor:
    if m > 65535 * 64:
        raise ValueError(f"m = {m} exceeds the kernel's grid")
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    single = spec.branches[0]
    ops0 = branch_operands[0]
    bias0 = ops0.get("bias")
    bias1 = branch_operands[1].get("bias") if spec.n_b == 2 else None
    biases = [t for t in (bias0, bias1) if t is not None]
    if len({t.dtype for t in biases}) > 1:
        raise ValueError("the two branches' biases must share one dtype")
    mul, res = ops0.get("mul"), ops0.get("residual")
    f32 = torch.float32
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _library().ca_gemm_program_launch(
        _ptr(a), _ptr(bs[0]), _ptr(bs[1]) if spec.n_b == 2 else None,
        _ptr(row_scale), _ptr(gain), _ptr(bias0), _ptr(bias1),
        _ptr(mul), _ptr(res), _ptr(out),
        m, n, k, int(a.dtype == torch.bfloat16),
        int(gain is not None and gain.dtype == f32),
        int(bool(biases) and biases[0].dtype == f32),
        int(mul is not None and mul.dtype == f32),
        int(res is not None and res.dtype == f32),
        int(out_dtype == f32),
        _ACT_CODES[single.activation], _ACT_CODES[spec.combine_activation],
        stream)
    if err != 0:
        raise RuntimeError(f"ca_gemm_program kernel launch failed: CUDA "
                           f"error {err}")
    tag = spec.tag()
    launch_counts[tag] = launch_counts.get(tag, 0) + 1
    return out


def ca_gemm_program(
    a: torch.Tensor,
    bs: Sequence[torch.Tensor],
    *,
    spec: GemmProgramSpec = PLAIN,
    out_dtype=None,
    semiring: str = "plus_times",
    transpose_a: bool = False,
    transpose_b: bool = False,
    save_preact: bool = False,
    row_scale: Optional[torch.Tensor] = None,
    gain: Optional[torch.Tensor] = None,
    branch_operands: Optional[Sequence[Dict[str, torch.Tensor]]] = None,
) -> torch.Tensor:
    """Execute a :class:`GemmProgramSpec`: ``a`` (m, k) is the streamed A
    operand, ``bs`` the 1..2 (k, n) B operands; ``row_scale`` ((m, 1)
    fp32) and ``gain`` ((k,)) feed the rms prologue; ``branch_operands[i]``
    holds branch ``i``'s ``bias``/``mul``/``residual``.

    CPU operands run :func:`ca_gemm_program_reference`; CUDA operands
    launch the kernel.  Programs this slice does not port (dequant, dact,
    transposed layouts, ``save_preact``, ``min_plus``) raise ValueError.
    """
    bs = tuple(bs)
    branch_operands = list(branch_operands or [{} for _ in bs])
    _check_program(spec, semiring, transpose_a, transpose_b, save_preact)
    m, n, k = _check_operands(a, bs, spec, row_scale, gain, branch_operands)
    out_dtype = _out_dtype(a, out_dtype)
    if a.device.type == "cpu":
        return ca_gemm_program_reference(
            a, bs, spec=spec, out_dtype=out_dtype, row_scale=row_scale,
            gain=gain, branch_operands=branch_operands)
    if a.device.type != "cuda":
        raise ValueError(f"no kernel for device {a.device}")
    return _launch(a, bs, spec, out_dtype, row_scale, gain,
                   branch_operands, m, n, k)

