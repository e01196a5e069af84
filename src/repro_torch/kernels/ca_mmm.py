"""Communication-avoiding GEMM program kernel (port of
``repro/kernels/ca_mmm.py:ca_gemm_program``).

The kernel is hand-written CUDA C++ for Hopper,
``repro_torch/csrc/ca_gemm_program.cu``: one CTA keeps its output tile's
fp32 accumulators (one per B branch) resident for the whole k loop, streams
the A and B panels through shared memory, folds the rms prologue into the
A fetch and runs the whole drain chain (dequant → bias → act → mul →
residual, or the ``glu`` combine) before the single write-back of each C
element.

The backward programs of training (K1f) ride it too: ``transpose_a``
(A stored (k, m)) and ``transpose_b`` (B stored (n, k)) stream an operand
from its stored layout with no transposed copy; the ``dact`` prologue
multiplies the decorated operand (A, or B with ``@b``) by ``act'`` of a
saved fp32 pre-activation as it is fetched; ``save_preact`` drains each
branch's fp32 value after bias and before the activation as extra outputs.

The tropical distance product (K1g, ``semiring="min_plus"``) is one
more instantiation of the same kernel: plain programs only, fp32 or bf16
operands widened to fp32, ``C[i, j] = min_k (A[i, k] + B[k, j])`` from a
+inf start with +inf in every out-of-range lane, NaN propagating, fp32
out.

The k-outer ablation (K4, :func:`ca_mmm_k_outer`) is a kernel of its own,
``repro_torch/csrc/ca_mmm_k_outer.cu``: the schedule the paper rejects,
one launch per k step, each reading and writing every C tile through
device memory.

Three routes (:func:`k1_route`, twinned by ``k1_route`` in the C entry
point, which refuses a launch whose route differs).  bf16 programs at
m > 8 whose TMA'd operands are 16-byte aligned run on a TMA + WGMMA main
loop (``csrc/wgmma_mainloop.cuh``): 128 x 128 C tiles (128 x 64 for the
GLU), A and B through a ring of swizzled TMA stages in their stored
layouts, wgmma into fp32 registers, the same prologues and drain.  The
same bf16 serving programs (``nn``, no training flag) at m <= 8, decode,
and the int8 ones (``dqb`` with bf16 A, ``dqab``), run a split-k cluster
kernel: 64-column strips of B streamed once in 16-byte vectors (8-byte
for int8, 4-byte at m > 1), int8 widened by byte permutes, k split over
up to 8 CTAs of a cluster whose partials (int32 for ``dqab`` without
per-tile scales, so exact) the leader sums in rank order through
distributed shared memory before the dequant and the drain.  fp32, fp32 A with int8
B, int8 at m > 8, min_plus, training programs at m <= 8 and misaligned
operands stay on the SIMT tile.  K4's bf16 step at whole 128 x 128 x 64
blocks runs the wgmma main loop (:func:`k_outer_route`).

Quantized programs ride the same schedule.  ``dqb`` (int8 weights, float
activations) streams int8 B tiles and widens them in registers; ``dqab``
(w8a8) streams int8 A and B and contracts in int32.  Per-channel weight
scales ((n,)) and per-row activation scales ((m,)) are drain stages;
per-tile scales (a (ceil(k/g), n) weight scale, or a (ceil(k/g),)
activation scale, ``scale_b_block``/``scale_a_block`` = g) rescale each
k-block's partial product before it joins the fp32 accumulator, on every
dequant branch.

Dispatch depends only on where the operands lie: a CPU tensor runs the
plain-torch version :func:`ca_gemm_program_reference`; a CUDA tensor
launches the kernel or raises.  The kernel is compiled with ``nvcc`` at
first use into ``build/`` at the repository root and bound through
``ctypes`` (a plain C entry point, no PyTorch headers), by
:mod:`repro_torch.kernels._build`.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional, Sequence

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.epilogue import (EpilogueSpec, act_fn,
                                          apply_reference)
from repro_torch.kernels.program import (GemmProgramSpec, NO_PROLOGUE, PLAIN,
                                         PrologueSpec, apply_dact_reference,
                                         apply_rms_reference)
from repro_torch.kernels.ref import ref_distance_product

SOURCE = _build.CSRC / "ca_gemm_program.cu"
K_OUTER_SOURCE = _build.CSRC / "ca_mmm_k_outer.cu"
SEMIRINGS = ("plus_times", "min_plus")
# Launch key of the k-outer ablation kernel (one launch per k step).
K_OUTER = "k_outer"
# The wgmma route's CTA tile (bm, bn, bk) for one branch: two consumer
# warpgroups of 64 rows, 128 columns, 64 rows of k a TMA stage.
WGMMA_TILE = (128, 128, 64)
# The SIMT tile K1 takes for m > 8, and the SIMT k-outer step's sub-tile
# and slab: bm and bn multiples of 64, bk of 32.
SIMT_TILE = (64, 64, 32)
# The k-outer kernel's own tile for each dtype (bm, bn, bk), K1's tile for
# that dtype with the k loop moved outermost; the default clamps it to the
# shape as the reference does (``ca_mmm.py:85-111``).
K_OUTER_TILES = {torch.float32: SIMT_TILE, torch.bfloat16: WGMMA_TILE,
                 torch.int8: SIMT_TILE}

# Launches of the CUDA kernel, by :func:`launch_key`.  Only the kernel
# launch below adds to it; the plain version never does.
launch_counts: Dict[str, int] = {}
# The same launches by route and launch key: "wgmma none nt",
# "decode res", "simt dqb", "wgmma k_outer", ...
route_counts: Dict[str, int] = {}
# The route codes of the C entry point.
_ROUTE_CODES = {"simt": 0, "wgmma": 1, "decode": 2}

_ACT_CODES = {"none": 0, "relu": 1, "gelu": 2, "silu": 3}
_FLOATS = (torch.float32, torch.bfloat16)
# Element type codes of the C entry point's A and B operands.
_TYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# The kernel streams k in slabs of 32 or 128 rows, so a per-tile scale
# block must be a multiple of 128 for each slab to lie in one block.
SCALE_BLOCK_QUANTUM = 128


# The dact prologue's operand codes in the C entry point.
_DACT_CODES = {"none": 0, "a": 1, "b": 2}


def reset_launch_counts() -> None:
    launch_counts.clear()
    route_counts.clear()


def _count(key: str, route: str) -> None:
    launch_counts[key] = launch_counts.get(key, 0) + 1
    rkey = f"{route} {key}"
    route_counts[rkey] = route_counts.get(rkey, 0) + 1


def layout_tag(transpose_a: bool, transpose_b: bool) -> str:
    """Canonical operand-layout key: 'nn' | 'nt' | 'tn' | 'tt'."""
    return ("t" if transpose_a else "n") + ("t" if transpose_b else "n")


def launch_key(tag: str, layout: str = "nn", save_preact: bool = False,
               semiring: str = "plus_times") -> str:
    """The key a launch counts under: the program tag (the reference's
    tags carry no layout), then the layout where it is not ``nn``,
    ``save_preact`` where the program drains its pre-activations and the
    semiring where it is not ``plus_times``, e.g. ``"none"``,
    ``"dact.silu>none nt"``, ``"rms>glu.silu(none|none) save_preact"``,
    ``"none min_plus"``."""
    key = tag if layout == "nn" else f"{tag} {layout}"
    if save_preact:
        key = f"{key} save_preact"
    return key if semiring == "plus_times" else f"{key} {semiring}"


# The wgmma grid puts n / 64 (at least) on its second axis.
_WGMMA_MAX_N = 65535 * 64


def k1_route(spec: GemmProgramSpec, layout: str, a_dtype: torch.dtype,
             b_dtype: torch.dtype, m: int, n: int, k: int, aligned: bool,
             semiring: str = "plus_times", save_preact: bool = False) -> str:
    """The route a K1 launch takes, for a plus_times program whose
    operands have 16-byte aligned bases and row strides (``aligned``).
    bf16 A and B (no dequant): ``"decode"`` at m <= 8 for a serving
    program (``nn``, no ``dact``, no ``save_preact``); ``"wgmma"`` at
    m > 8 for one branch in any layout or the GLU in ``nn`` without
    ``dact``.  int8 B with bf16 A (``dqb``) or int8 A (``dqab``):
    ``"decode"`` at m <= 8.  ``"simt"`` otherwise: fp32, fp32 A with int8
    B, int8 at m > 8, min_plus, training programs at m <= 8, misaligned
    operands.  The C entry point's ``k1_route`` is its twin and refuses a
    launch whose route differs."""
    bf16 = a_dtype == torch.bfloat16 and b_dtype == torch.bfloat16
    int8 = b_dtype == torch.int8 and a_dtype in (torch.bfloat16, torch.int8)
    if semiring != "plus_times" or not (bf16 or int8) or k < 1 \
            or not aligned:
        return "simt"
    if m <= 8:
        training = (layout != "nn" or spec.prologue.kind == "dact"
                    or save_preact)
        return "simt" if training else "decode"
    if int8 or n > _WGMMA_MAX_N:
        return "simt"
    if spec.n_b == 2 and (layout != "nn" or spec.prologue.kind == "dact"):
        return "simt"
    return "wgmma"


def tma_aligned(*tensors: Optional[torch.Tensor]) -> bool:
    """Whether each given 2-D row-major tensor meets TMA's address rules: a
    16-byte aligned base and row stride."""
    return all(t.data_ptr() % 16 == 0
               and (t.shape[-1] * t.element_size()) % 16 == 0
               for t in tensors if t is not None)


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.ca_gemm_program_launch
    fn.argtypes = ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 20
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.ca_gemm_min_plus_launch
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int


def _library() -> ctypes.CDLL:
    return _build.load(SOURCE, _bind)


def _bind_k_outer(lib: ctypes.CDLL) -> None:
    fn = lib.ca_mmm_k_outer_step
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 10
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int


# ---------------------------------------------------------------------------
# Validation shared by both paths
# ---------------------------------------------------------------------------

def _unsupported(what: str, slice_: str) -> ValueError:
    return ValueError(f"{what} is not ported yet (ROADMAP queue 2, {slice_})")


def _check_program(spec: GemmProgramSpec, semiring: str,
                   transpose_a: bool, transpose_b: bool,
                   save_preact: bool, preact) -> None:
    """The reference's contracts (``ca_mmm.py:363-397``) and what the port
    does not take yet."""
    if semiring not in SEMIRINGS:
        raise ValueError(f"unknown semiring {semiring!r} (valid: "
                         f"{SEMIRINGS})")
    if semiring == "min_plus" and not (
            spec.is_plain and not (transpose_a or transpose_b
                                   or save_preact)):
        raise ValueError("min_plus supports plain (A, B) programs only")
    if len({b.dequant for b in spec.branches}) > 1:
        raise ValueError(f"the branches of {spec.tag()!r} must share one "
                         "dequant stage")
    if spec.n_b == 2 and spec.combine != "glu":
        raise _unsupported("two-output 'dual' programs", "K1c follow-up")
    transposed = transpose_a or transpose_b
    if spec.n_b > 1 and transposed:
        raise ValueError("multi-branch programs stream the plain 'nn' "
                         "layout")
    quant = spec.branches[0].dequant != "none"
    if quant and transposed:
        raise ValueError("quantized streaming supports the plain 'nn' "
                         "layout")
    if quant and save_preact:
        raise _unsupported("save_preact on a dequant program",
                           "K1f follow-up")
    pro = spec.prologue
    if pro.kind == "rms" and transpose_a:
        raise ValueError("the rms prologue decorates the natural A layout")
    if pro.kind == "dact":
        if quant:
            raise _unsupported("the dact prologue on a dequant program",
                               "K1f follow-up")
        if pro.operand == "a" and transpose_a:
            raise ValueError("dact@a decorates a non-transposed A")
        if pro.operand == "b" and transpose_b:
            raise ValueError("dact@b decorates a non-transposed B")
        if preact is None:
            raise ValueError("the dact prologue needs preact")
    elif preact is not None:
        raise ValueError("preact given without a dact prologue")


def _min_plus_operands(a, bs, semiring):
    """min_plus takes fp32 and bf16 operands as they are (the kernel widens
    bf16) and casts any other numeric type (fp16, int8, int32, ...) to fp32
    on entry, as the reference's kernel does (``ca_mmm.py:190-191``); both
    casts are exact or round once, as ``astype`` does."""
    if semiring != "min_plus":
        return a, bs
    cast = lambda t: t if t.dtype in _FLOATS else t.float()  # noqa: E731
    return cast(a), tuple(cast(b) for b in bs)


def _check_types(a, bs, spec, transpose_a=False, transpose_b=False,
                 semiring="plus_times"):
    """A and B element types against the program's dequant stage (any
    float32/bfloat16 pair for min_plus), and their shapes in the stored
    layouts; returns the stage ("none", "b" or "ab") and (m, n, k)."""
    deq = spec.branches[0].dequant
    want = {"none": (_FLOATS, "the same float type as A"),
            "b": (_FLOATS, "int8"), "ab": ((torch.int8,), "int8")}[deq]
    if semiring == "min_plus":
        want = (_FLOATS, "float32/bfloat16")
    if a.dim() != 2 or a.dtype not in want[0]:
        raise ValueError(
            f"A must be a 2-D {'/'.join(str(t)[6:] for t in want[0])} "
            f"tensor for {spec.tag()!r}, got {tuple(a.shape)} {a.dtype}")
    k, m = a.shape if transpose_a else a.shape[::-1]
    n = bs[0].shape[0 if transpose_b else -1] if bs[0].dim() else 0
    want_shape = (n, k) if transpose_b else (k, n)
    if semiring == "min_plus":
        b_dtypes = _FLOATS
    else:
        b_dtypes = (a.dtype,) if deq == "none" else (torch.int8,)
    for b in bs:
        if tuple(b.shape) != want_shape or b.dtype not in b_dtypes:
            raise ValueError(f"B must be {want_shape} {want[1]} for "
                             f"{spec.tag()!r}, got {tuple(b.shape)} "
                             f"{b.dtype}")
    return deq, m, n, k


def _check_scales(ops, deq, m, n, k, scale_b_block, scale_a_block):
    """The dequant operands of one branch; returns them as tensors."""
    shapes = {"scale_b": ((-(-k // scale_b_block), n) if scale_b_block
                          else (n,))}
    if deq == "ab":
        shapes["scale_a"] = ((-(-k // scale_a_block),) if scale_a_block
                             else (m,))
    out = []
    for name, shape in shapes.items():
        t = ops.get(name)
        if t is None or tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(
                f"{name} must be a {shape} float32 tensor, got "
                f"{None if t is None else (tuple(t.shape), t.dtype)}")
        out.append(t)
    return out


def _check_operands(a, bs, spec, row_scale, gain, branch_operands,
                    scale_b_block=0, scale_a_block=0, transpose_a=False,
                    transpose_b=False, preact=None, semiring="plus_times"):
    """Shapes, dtypes, devices and contiguity the kernel takes; returns
    (m, n, k)."""
    if len(bs) != spec.n_b:
        raise ValueError(f"{spec.tag()!r} takes {spec.n_b} B operand(s), "
                         f"got {len(bs)}")
    if len(branch_operands) != spec.n_b:
        raise ValueError("one branch_operands dict per B operand")
    deq, m, n, k = _check_types(a, bs, spec, transpose_a, transpose_b,
                                semiring)
    tensors = [a, *bs]
    if preact is not None:
        shape = (m, k) if spec.prologue.operand == "a" else (k, n)
        if tuple(preact.shape) != shape or preact.dtype != torch.float32:
            raise ValueError(f"preact must be {shape} float32 (shaped like "
                             f"the decorated operand), got "
                             f"{tuple(preact.shape)} {preact.dtype}")
        tensors.append(preact)
    for name, g in (("scale_b_block", scale_b_block),
                    ("scale_a_block", scale_a_block)):
        if g < 0 or g % SCALE_BLOCK_QUANTUM:
            raise ValueError(f"{name} = {g} must be a multiple of "
                             f"{SCALE_BLOCK_QUANTUM} (the kernel's k slab)")
    if scale_b_block and deq == "none":
        raise ValueError("per-tile weight scales need a dequant stage")
    if scale_a_block and deq != "ab":
        raise ValueError("per-tile activation scales need an 'ab' dequant "
                         "stage")
    if scale_a_block and scale_b_block and scale_a_block != scale_b_block:
        raise ValueError(f"per-tile activation and weight scales must share "
                         f"one block, got {scale_a_block} and "
                         f"{scale_b_block}")
    if spec.prologue.kind == "rms":
        if deq == "ab":
            raise ValueError("the rms prologue composes with float "
                             "activations, not an int8 A stream: normalize "
                             "before quantizing")
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
                "residual": bspec.has_residual,
                "scale_b": deq != "none", "scale_a": deq == "ab"}
        extra = set(ops) - {name for name, on in want.items() if on}
        if extra:
            raise ValueError(f"operands {sorted(extra)} not in program "
                             f"{spec.tag()!r}")
        if deq != "none":
            tensors += _check_scales(ops, deq, m, n, k, scale_b_block,
                                     scale_a_block)
        for name in ("bias", "mul", "residual"):
            if not want[name]:
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


def _out_dtype(a: torch.Tensor, out_dtype,
               semiring: str = "plus_times") -> torch.dtype:
    # ca_mmm.py:445-452: the output defaults to A's dtype, glu included,
    # and to fp32 when A is int8 (w8a8); min_plus writes fp32.
    if semiring == "min_plus":
        if out_dtype not in (None, torch.float32):
            raise ValueError(f"min_plus writes float32, got out_dtype "
                             f"{out_dtype}")
        return torch.float32
    out = out_dtype or (torch.float32 if a.dtype == torch.int8 else a.dtype)
    if out not in _FLOATS:
        raise ValueError(f"out_dtype must be float32/bfloat16, got {out}")
    return out


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fp32 product of A and B over one k range.  Float A: fp32 operands
    (int8 B widens exactly).  int8 A and B: an exact integer contraction
    rounded once to fp32, as the kernel's int32 sum is — int64 on the CPU
    (``kernels/ref.py``), fp64 on the card, where ``torch.matmul`` has no
    integer kernel (exact while 127²·k < 2^53)."""
    if a.dtype != torch.int8:
        return a.float() @ b.float()
    if a.device.type == "cpu":
        return (a.long() @ b.long()).float()
    return (a.double() @ b.double()).float()


def _dequant_product(a, b, deq, ops, scale_b_block, scale_a_block):
    """One branch's product in real units: per-tile scales rescale each
    k-block's partial before it is summed (blocks in order), per-channel
    and per-row scales multiply the sum."""
    g = scale_b_block or scale_a_block
    if not g:
        z = _dot(a, b)
    else:
        z = torch.zeros(a.shape[0], b.shape[1], device=a.device)
        for i, start in enumerate(range(0, a.shape[1], g)):
            part = _dot(a[:, start:start + g], b[start:start + g])
            if scale_b_block:
                part = part * ops["scale_b"][i]
            if scale_a_block:
                part = part * ops["scale_a"][i]
            z = z + part
    if not scale_b_block:
        z = z * ops["scale_b"].reshape(1, -1)
    if deq == "ab" and not scale_a_block:
        z = z * ops["scale_a"].reshape(-1, 1)
    return z


def ca_gemm_program_reference(
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
    preact: Optional[torch.Tensor] = None,
    branch_operands: Optional[Sequence[Dict[str, torch.Tensor]]] = None,
    scale_b_block: int = 0,
    scale_a_block: int = 0,
):
    """The same program in plain torch: prologue, fp32 (or exact integer)
    products, dequant, drain chain and combine, in the kernel's order; for
    min_plus the distance product of the operands widened to fp32."""
    a, bs = _min_plus_operands(a, tuple(bs), semiring)
    branch_operands = list(branch_operands or [{} for _ in bs])
    _check_program(spec, semiring, transpose_a, transpose_b, save_preact,
                   preact)
    _check_operands(a, bs, spec, row_scale, gain, branch_operands,
                    scale_b_block, scale_a_block, transpose_a, transpose_b,
                    preact, semiring)
    out_dtype = _out_dtype(a, out_dtype, semiring)
    if semiring == "min_plus":
        return ref_distance_product(a.float(), bs[0].float())
    if transpose_a:
        a = a.t()
    if transpose_b:
        bs = tuple(b.t() for b in bs)
    pro = spec.prologue
    if pro.kind == "rms":
        a = apply_rms_reference(a, row_scale, gain)
    elif pro.kind == "dact" and pro.operand == "a":
        a = apply_dact_reference(a, preact, pro.activation)
    elif pro.kind == "dact":
        bs = tuple(apply_dact_reference(b, preact, pro.activation)
                   for b in bs)
    vals, preacts = [], []
    for b, bspec, ops in zip(bs, spec.branches, branch_operands):
        if bspec.dequant == "none":
            z = _dot(a, b)
            if save_preact:
                preacts.append(z + ops["bias"].float() if bspec.has_bias
                               else z)
            vals.append(z if bspec.is_identity
                        else apply_reference(z, bspec, ops))
            continue
        z = _dequant_product(a, b, bspec.dequant, ops, scale_b_block,
                             scale_a_block)
        vals.append(apply_reference(
            z, dataclasses.replace(bspec, dequant="none"),
            {k: v for k, v in ops.items() if not k.startswith("scale_")}))
    if spec.combine == "glu":
        y = act_fn(spec.combine_activation)(vals[0]) * vals[1]
    else:
        y = vals[0]
    y = y.to(out_dtype)
    return (y, *preacts) if save_preact else y


# ---------------------------------------------------------------------------
# Wrapper
# ---------------------------------------------------------------------------

def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _launch(a, bs, spec: GemmProgramSpec, out_dtype, row_scale, gain,
            branch_operands, m: int, n: int, k: int, scale_b_block: int,
            scale_a_block: int, transpose_a: bool, transpose_b: bool,
            save_preact: bool, preact):
    if m > 65535 * 64:
        raise ValueError(f"m = {m} exceeds the kernel's grid")
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    pres = [torch.empty((m, n), dtype=torch.float32, device=a.device)
            for _ in range(spec.n_b if save_preact else 0)]
    result = (out, *pres) if save_preact else out
    if m == 0 or n == 0:
        return result
    single = spec.branches[0]
    ops0 = branch_operands[0]
    ops1 = branch_operands[1] if spec.n_b == 2 else {}
    bias0, bias1 = ops0.get("bias"), ops1.get("bias")
    biases = [t for t in (bias0, bias1) if t is not None]
    if len({t.dtype for t in biases}) > 1:
        raise ValueError("the two branches' biases must share one dtype")
    mul, res = ops0.get("mul"), ops0.get("residual")
    f32 = torch.float32
    pro = spec.prologue
    layout = layout_tag(transpose_a, transpose_b)
    route = k1_route(spec, layout, a.dtype, bs[0].dtype, m, n, k,
                     tma_aligned(a, *bs, preact), save_preact=save_preact)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _library().ca_gemm_program_launch(
        _ptr(a), _ptr(bs[0]), _ptr(bs[1]) if spec.n_b == 2 else None,
        _ptr(row_scale), _ptr(gain), _ptr(bias0), _ptr(bias1),
        _ptr(mul), _ptr(res), _ptr(out),
        _ptr(ops0.get("scale_b")), _ptr(ops1.get("scale_b")),
        _ptr(ops0.get("scale_a")), _ptr(ops1.get("scale_a")),
        _ptr(preact), _ptr(pres[0]) if pres else None,
        _ptr(pres[1]) if len(pres) == 2 else None,
        m, n, k, _TYPE_CODES[a.dtype], _TYPE_CODES[bs[0].dtype],
        int(gain is not None and gain.dtype == f32),
        int(bool(biases) and biases[0].dtype == f32),
        int(mul is not None and mul.dtype == f32),
        int(res is not None and res.dtype == f32),
        int(out_dtype == f32),
        _ACT_CODES[single.activation], _ACT_CODES[spec.combine_activation],
        scale_b_block or scale_a_block, int(scale_b_block > 0),
        int(scale_a_block > 0), int(transpose_a), int(transpose_b),
        _DACT_CODES[pro.operand if pro.kind == "dact" else "none"],
        _ACT_CODES[pro.activation], _ROUTE_CODES[route], stream)
    if err != 0:
        raise RuntimeError(f"ca_gemm_program kernel launch failed ({route} "
                           f"route): CUDA error {err}")
    _count(launch_key(spec.tag(), layout, save_preact), route)
    return result


def _launch_min_plus(a, b, m: int, n: int, k: int) -> torch.Tensor:
    if m > 65535 * 64:
        raise ValueError(f"m = {m} exceeds the kernel's grid")
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m == 0 or n == 0:
        return out
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _library().ca_gemm_min_plus_launch(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
        int(a.dtype == torch.float32), int(b.dtype == torch.float32), stream)
    if err != 0:
        raise RuntimeError(f"min_plus kernel launch failed: CUDA error {err}")
    _count(launch_key(PLAIN.tag(), semiring="min_plus"), "simt")
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
    preact: Optional[torch.Tensor] = None,
    branch_operands: Optional[Sequence[Dict[str, torch.Tensor]]] = None,
    scale_b_block: int = 0,
    scale_a_block: int = 0,
):
    """Execute a :class:`GemmProgramSpec`: ``a`` (m, k) is the streamed A
    operand, ``bs`` the 1..2 (k, n) B operands; ``row_scale`` ((m, 1)
    fp32) and ``gain`` ((k,)) feed the rms prologue; ``branch_operands[i]``
    holds branch ``i``'s ``bias``/``mul``/``residual`` and, for a dequant
    branch, ``scale_b`` and (``dqab``) ``scale_a``.

    ``transpose_a`` takes A stored (k, m), ``transpose_b`` B stored
    (n, k) (one-branch float programs).  A ``dact`` prologue takes
    ``preact``, the fp32 pre-activation shaped like the decorated operand
    ((m, k) for A, (k, n) for ``@b``), which must not be transposed.  With
    ``save_preact`` the call returns ``(out, *preacts)``: each branch's
    fp32 value after bias, before the activation.

    ``semiring="min_plus"`` runs the distance product
    ``C[i, j] = min_k (A[i, k] + B[k, j])`` on a plain program (no
    prologue, drain or transposed layout): A and B each fp32 or bf16,
    widened to fp32 (any other numeric type cast to fp32 on entry, as the
    reference casts it), fp32 out, NaN propagating.

    bf16 programs with 16-byte aligned operands take the wgmma route at
    m > 8 and, serving programs, the decode route at m <= 8, as do the
    aligned ``dqb`` (bf16 A) and ``dqab`` programs at m <= 8; the rest the
    SIMT tile (:func:`k1_route`).  All count in ``launch_counts`` and, by
    route, in ``route_counts``.

    A ``dqb`` program takes float A and int8 B; ``dqab`` int8 A and B.
    ``scale_b`` is per channel ((n,)) or, with ``scale_b_block=g``, per
    tile ((ceil(k/g), n)); ``scale_a`` per row ((m,)) or, with
    ``scale_a_block=g``, per k-tile ((ceil(k/g),)).  g is a multiple of
    128, and the same for both when both are per tile.  The output
    defaults to A's dtype, fp32 for int8 A.

    CPU operands run :func:`ca_gemm_program_reference`; CUDA operands
    launch the kernel.  Programs the port does not take yet (``dual``,
    dequant with ``save_preact`` or ``dact``) and the reference's refused
    combinations raise ValueError.
    """
    a, bs = _min_plus_operands(a, tuple(bs), semiring)
    branch_operands = list(branch_operands or [{} for _ in bs])
    _check_program(spec, semiring, transpose_a, transpose_b, save_preact,
                   preact)
    m, n, k = _check_operands(a, bs, spec, row_scale, gain, branch_operands,
                              scale_b_block, scale_a_block, transpose_a,
                              transpose_b, preact, semiring)
    out_dtype = _out_dtype(a, out_dtype, semiring)
    if a.device.type == "cpu":
        return ca_gemm_program_reference(
            a, bs, spec=spec, out_dtype=out_dtype, semiring=semiring,
            transpose_a=transpose_a, transpose_b=transpose_b,
            save_preact=save_preact, row_scale=row_scale, gain=gain,
            preact=preact, branch_operands=branch_operands,
            scale_b_block=scale_b_block, scale_a_block=scale_a_block)
    if a.device.type != "cuda":
        raise ValueError(f"no kernel for device {a.device}")
    if semiring == "min_plus":
        return _launch_min_plus(a, bs[0], m, n, k)
    return _launch(a, bs, spec, out_dtype, row_scale, gain,
                   branch_operands, m, n, k, scale_b_block, scale_a_block,
                   transpose_a, transpose_b, save_preact, preact)


def ca_mmm(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    bm: Optional[int] = None,
    bn: Optional[int] = None,
    bk: Optional[int] = None,
    out_dtype=None,
    semiring: str = "plus_times",
    transpose_a: bool = False,
    transpose_b: bool = False,
    epilogue: Optional[EpilogueSpec] = None,
    bias: Optional[torch.Tensor] = None,
    mul: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
    save_preact: bool = False,
    scale_a: Optional[torch.Tensor] = None,
    scale_b: Optional[torch.Tensor] = None,
    scale_b_block: int = 0,
    scale_a_block: int = 0,
    prologue: Optional[PrologueSpec] = None,
    row_scale: Optional[torch.Tensor] = None,
    gain: Optional[torch.Tensor] = None,
    preact: Optional[torch.Tensor] = None,
):
    """C = op(A) @ op(B) (+ fused prologue/epilogue): the single-branch
    program with the reference's keyword surface (``ca_mmm.py:565-613``),
    a thin builder over :func:`ca_gemm_program`.  The kernel's tiles are
    fixed: ``bm``, ``bn`` and ``bk`` are accepted and not read."""
    ops = {name: t for name, t in (("bias", bias), ("mul", mul),
                                   ("residual", residual),
                                   ("scale_a", scale_a),
                                   ("scale_b", scale_b)) if t is not None}
    spec = GemmProgramSpec(prologue=prologue or NO_PROLOGUE,
                           branches=(epilogue or EpilogueSpec(),))
    return ca_gemm_program(  # repro: noqa RPR001 -- port dispatch layer
        a, (b,), spec=spec, out_dtype=out_dtype, semiring=semiring,
        transpose_a=transpose_a, transpose_b=transpose_b,
        save_preact=save_preact, row_scale=row_scale, gain=gain,
        preact=preact, branch_operands=[ops], scale_b_block=scale_b_block,
        scale_a_block=scale_a_block)


# ---------------------------------------------------------------------------
# The k-outer ablation (K4)
# ---------------------------------------------------------------------------

_K_OUTER_TYPES = (torch.float32, torch.bfloat16, torch.int8)


def _round_up(x: int, q: int) -> int:
    return -(-x // q) * q


def k_outer_route(dtype: torch.dtype, bm: int, bn: int,
                  bk: int) -> Optional[str]:
    """The K4 step that takes a tile on the card: ``"wgmma"`` for bf16 at
    whole ``WGMMA_TILE`` blocks, ``"simt"`` for bm and bn multiples of 64
    and bk of 32 (any dtype), None where no step takes it.  The C entry
    point's check is its twin."""
    if dtype == torch.bfloat16 and not (bm % WGMMA_TILE[0] or bn % WGMMA_TILE[1]
                                        or bk % WGMMA_TILE[2]):
        return "wgmma"
    if not (bm % SIMT_TILE[0] or bn % SIMT_TILE[1] or bk % SIMT_TILE[2]):
        return "simt"
    return None


def _check_k_outer(a, b, bm, bn, bk, out_dtype):
    """Operands and tiles both paths take, as the reference takes them
    (``ca_mmm.py:616-651``): an unset tile dim defaults to the kernel's own
    tile for the dtype (``K_OUTER_TILES``), and every dim is clamped to
    the rounded-up shape, ``min(bm, round_up(m, 8))``,
    ``min(bn, round_up(n, 128))``, ``min(bk, round_up(k, 128))``; the
    tile must then divide the shape.  Returns (m, n, k, bm, bn, bk, the
    accumulator's dtype, the output's dtype)."""
    if a.dim() != 2 or b.dim() != 2 or a.dtype not in _K_OUTER_TYPES \
            or b.dtype != a.dtype:
        raise ValueError(f"A and B must be 2-D and share one of "
                         f"float32/bfloat16/int8, got {tuple(a.shape)} "
                         f"{a.dtype} and {tuple(b.shape)} {b.dtype}")
    m, k = a.shape
    if b.shape[0] != k:
        raise ValueError(f"contraction mismatch {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    n = b.shape[1]
    d_bm, d_bn, d_bk = K_OUTER_TILES[a.dtype]
    bm, bn, bk = bm or d_bm, bn or d_bn, bk or d_bk
    if bm < 1 or bn < 1 or bk < 1:
        raise ValueError(f"tiles ({bm}, {bn}, {bk}) must be positive")
    # (An empty dim clamps to the quantum, so that it divides.)
    bm, bn, bk = (min(bm, _round_up(max(m, 1), 8)),
                  min(bn, _round_up(max(n, 1), 128)),
                  min(bk, _round_up(max(k, 1), 128)))
    if m % bm or n % bn or k % bk:
        raise ValueError(f"the k-outer ablation takes tile-divisible shapes "
                         f"only: ({m}, {k}) @ ({k}, {n}) with tiles "
                         f"({bm}, {bn}, {bk})")
    if b.device != a.device:
        raise ValueError(f"operands on {b.device} and {a.device}")
    acc_t = torch.int32 if a.dtype == torch.int8 else torch.float32
    out_dtype = out_dtype or (acc_t if a.dtype == torch.int8 else a.dtype)
    return m, n, k, bm, bn, bk, acc_t, out_dtype


def _step_product(a: torch.Tensor, b: torch.Tensor,
                  acc_t: torch.dtype) -> torch.Tensor:
    """One k step's product in the accumulator's dtype: fp32 from float
    operands; exact int32 from int8 ones (int64 on the CPU, fp64 on the
    card, where torch.matmul has no integer kernel; exact while
    127^2 k < 2^53)."""
    if acc_t == torch.float32:
        return a.float() @ b.float()
    if a.device.type == "cpu":
        return (a.long() @ b.long()).to(acc_t)
    return (a.double() @ b.double()).to(acc_t)


def ca_mmm_k_outer_reference(a: torch.Tensor, b: torch.Tensor, *,
                             bm: Optional[int] = None,
                             bn: Optional[int] = None,
                             bk: Optional[int] = None,
                             out_dtype=None) -> torch.Tensor:
    """The same schedule in plain torch: C starts at zero and each k step
    adds one A panel times one B panel, in the accumulator's dtype (fp32,
    int32 for int8); the cast to ``out_dtype`` follows the last step."""
    m, n, k, bm, bn, bk, acc_t, out_dtype = _check_k_outer(
        a, b, bm, bn, bk, out_dtype)
    c = torch.zeros((m, n), dtype=acc_t, device=a.device)
    for k0 in range(0, k, bk):
        c = c + _step_product(a[:, k0:k0 + bk], b[k0:k0 + bk], acc_t)
    return c.to(out_dtype)


def ca_mmm_k_outer(a: torch.Tensor, b: torch.Tensor, *,
                   bm: Optional[int] = None, bn: Optional[int] = None,
                   bk: Optional[int] = None,
                   out_dtype=None) -> torch.Tensor:
    """Ablation variant: k outermost, C blocks revisited from device memory
    (port of ``ca_mmm.py:ca_mmm_k_outer``).

    The schedule the paper's model rejects: every k step re-reads and
    re-writes each (bm, bn) C tile, one launch per step, k / bk launches.
    A and B share one dtype, fp32, bf16 or int8; C accumulates in fp32
    (int32 for int8) and is cast to ``out_dtype`` (default: A's dtype,
    int32 for int8) after the last step.  As in the reference, any tile
    that divides the shape (after the reference's clamp to the shape),
    the default being the kernel's own tile for the dtype
    (``K_OUTER_TILES``, clamped).  CPU operands run
    :func:`ca_mmm_k_outer_reference`; CUDA operands launch the kernel's
    step for the tile (:func:`k_outer_route`), or raise where no step
    takes it.
    """
    m, n, k, bm, bn, bk, acc_t, out_dtype = _check_k_outer(
        a, b, bm, bn, bk, out_dtype)
    if a.device.type == "cpu":
        return ca_mmm_k_outer_reference(a, b, bm=bm, bn=bn, bk=bk,
                                        out_dtype=out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"no kernel for device {a.device}")
    route = k_outer_route(a.dtype, bm, bn, bk)
    if route is None:
        raise ValueError(
            f"no k-outer step on the card takes tiles ({bm}, {bn}, {bk}) "
            f"for ({m}, {k}) @ ({k}, {n}) {str(a.dtype)[6:]}: bm and bn "
            f"multiples of {SIMT_TILE[0]} and bk of {SIMT_TILE[2]}, or bf16 "
            f"at multiples of {WGMMA_TILE}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("the kernel takes contiguous operands")
    # Grid: (n / bn, m / bm) for the SIMT step, (m / 128, n / 128) for wgmma.
    grid_y = n // WGMMA_TILE[1] if route == "wgmma" else m // bm
    if grid_y > 65535:
        raise ValueError(f"({m}, {n}) with tiles ({bm}, {bn}) exceeds the "
                         "kernel's grid")
    c = torch.empty((m, n), dtype=acc_t, device=a.device)
    if m == 0 or n == 0 or k == 0:
        return c.zero_().to(out_dtype)
    lib = _build.load(K_OUTER_SOURCE, _bind_k_outer)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    for k0 in range(0, k, bk):
        err = lib.ca_mmm_k_outer_step(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, k0, bk, bm,
            bn, int(k0 == 0), _TYPE_CODES[a.dtype], int(route == "wgmma"),
            stream)
        if err != 0:
            raise RuntimeError(f"k-outer kernel launch failed ({route} "
                               f"step): CUDA error {err}")
        _count(K_OUTER, route)
    return c.to(out_dtype)
