"""GemmProgram (port of ``repro/kernels/program.py``): the static
description of one streamed-A GEMM pipeline.

* one streamed **A** operand, optionally decorated by a
  :class:`PrologueSpec` (the rms_norm feeding a projection, folded into
  the A-tile fetch);
* 1..2 **B** operands (*branches*), each with its own accumulator and
  :class:`~repro_torch.kernels.epilogue.EpilogueSpec`;
* a **combiner**: ``combine="glu"`` drains ``act(v_gate) * v_up`` as one
  output — SwiGLU's gate and up GEMMs share one pass over x.

Tag grammar (byte-identical to the reference's, because tuning caches key
on it)::

    tag      := [prologue ">"] body
    prologue := "rms" | "dact." act ["@b"]
    body     := epitag                      # single branch
              | "glu." act "(" epitag "|" epitag ")"
              | "dual(" epitag "|" epitag ")"
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Tuple

import torch

from repro_torch.kernels.epilogue import (ACTIVATIONS, EpilogueSpec,
                                          IDENTITY, act_grad, spec_from_tag)

PROLOGUE_KINDS = ("none", "rms", "dact")
COMBINES = ("none", "glu")


def _spec_error(message: str):
    """An ill-formed program spec is a TAG002 violation: the spec could
    never have round-tripped through the tag grammar.  The error is a
    ``ValueError`` (``ProgramValidationError`` subclasses it)."""
    from repro_torch.analyze.diagnostics import (ProgramValidationError,
                                                 error)

    return ProgramValidationError([error("TAG002", message)])


@dataclasses.dataclass(frozen=True)
class PrologueSpec:
    """Elementwise producer folded into a streamed operand's tile fetch.

    ``kind="rms"`` multiplies the A tile by a per-row scale
    (``rsqrt(mean(x²) + eps)``, computed outside the kernel) and a
    per-column gain.  ``kind="dact"`` (activation backward) multiplies the
    decorated operand (A, or B with ``operand="b"``) by ``act'`` of the
    saved fp32 pre-activation streamed beside it.
    """

    kind: str = "none"
    activation: str = "none"   # dact: which activation's derivative
    operand: str = "a"

    def __post_init__(self):
        if self.kind not in PROLOGUE_KINDS:
            raise _spec_error(f"unknown prologue kind {self.kind!r} "
                             f"(valid: {PROLOGUE_KINDS})")
        if self.operand not in ("a", "b"):
            raise _spec_error(f"unknown prologue operand {self.operand!r}")
        if self.kind == "dact":
            if self.activation not in ACTIVATIONS:
                raise _spec_error(
                    f"unknown dact activation {self.activation!r}")
        elif self.activation != "none":
            raise _spec_error(
                f"prologue kind {self.kind!r} takes no activation, got "
                f"{self.activation!r}")
        if self.kind == "rms" and self.operand != "a":
            raise _spec_error("rms_norm decorates the A stream")

    @property
    def is_identity(self) -> bool:
        return self.kind == "none"

    def tag(self) -> str:
        if self.kind == "none":
            return ""
        if self.kind == "rms":
            return "rms"
        t = f"dact.{self.activation}"
        return t + ("@b" if self.operand == "b" else "")


NO_PROLOGUE = PrologueSpec()


def _prologue_from_tag(tag: str) -> PrologueSpec:
    if tag == "rms":
        return PrologueSpec(kind="rms")
    if tag.startswith("dact."):
        body = tag[len("dact."):]
        operand = "a"
        if body.endswith("@b"):
            operand, body = "b", body[:-2]
        return PrologueSpec(kind="dact", activation=body, operand=operand)
    raise ValueError(f"unknown prologue tag {tag!r}")


@dataclasses.dataclass(frozen=True)
class GemmProgramSpec:
    """Static shape of one streamed-A GEMM program.

    With two branches the per-branch chains are restricted to the
    pre-combine stages (dequant + bias): the combiner owns the
    nonlinearity.
    """

    prologue: PrologueSpec = NO_PROLOGUE
    branches: Tuple[EpilogueSpec, ...] = (IDENTITY,)
    combine: str = "none"
    combine_activation: str = "silu"

    def __post_init__(self):
        if self.combine not in COMBINES:
            raise _spec_error(f"unknown combine {self.combine!r} "
                             f"(valid: {COMBINES})")
        if not 1 <= len(self.branches) <= 2:
            raise _spec_error(
                f"a program has 1 or 2 branches, got {len(self.branches)}")
        if self.combine == "glu":
            if len(self.branches) != 2:
                raise _spec_error("glu combines two branches, got "
                                 f"{len(self.branches)}")
            if self.combine_activation not in ACTIVATIONS:
                raise _spec_error(f"unknown glu activation "
                                 f"{self.combine_activation!r}")
        if len(self.branches) == 2:
            for b in self.branches:
                if b.activation != "none" or b.has_mul or b.has_residual:
                    raise _spec_error(
                        "multi-branch epilogues are dequant/bias only, "
                        f"got {b.tag()!r}")
            if self.prologue.kind == "dact":
                raise _spec_error("dact prologue is single-branch (one "
                                 "gradient operand)")

    @property
    def n_b(self) -> int:
        return len(self.branches)

    @property
    def n_out(self) -> int:
        """Drained (m, n) outputs."""
        return 1 if self.combine == "glu" else len(self.branches)

    @property
    def is_plain(self) -> bool:
        """Single-branch identity program (the bare CA-MMM)."""
        return (self.prologue.is_identity and self.combine == "none"
                and len(self.branches) == 1 and self.branches[0].is_identity)

    def tag(self) -> str:
        return program_tag(self)


PLAIN = GemmProgramSpec()


def program_tag(spec: GemmProgramSpec) -> str:
    """Canonical cache-key fragment (see module docstring for grammar)."""
    if spec.combine == "glu":
        body = (f"glu.{spec.combine_activation}"
                f"({spec.branches[0].tag()}|{spec.branches[1].tag()})")
    elif len(spec.branches) == 2:
        body = f"dual({spec.branches[0].tag()}|{spec.branches[1].tag()})"
    else:
        body = spec.branches[0].tag()
    pro = spec.prologue.tag()
    return f"{pro}>{body}" if pro else body


@functools.lru_cache(maxsize=None)
def program_from_tag(tag: str) -> GemmProgramSpec:
    """Inverse of :func:`program_tag`; unknown fragments raise.  Memoized
    (a spec is frozen): the ledger parses a launch's tag per record."""
    prologue = NO_PROLOGUE
    if ">" in tag:
        pro_s, tag = tag.split(">", 1)
        prologue = _prologue_from_tag(pro_s)
    if tag.startswith("glu.") or tag.startswith("dual("):
        if tag.startswith("glu."):
            act, _, rest = tag[len("glu."):].partition("(")
            combine = "glu"
        else:
            act, rest = "silu", tag[len("dual("):]
            combine = "none"
        if not rest.endswith(")") or "|" not in rest:
            raise ValueError(f"malformed program tag {tag!r}")
        t0, t1 = rest[:-1].split("|")
        return GemmProgramSpec(
            prologue=prologue, combine=combine, combine_activation=act,
            branches=(spec_from_tag(t0), spec_from_tag(t1)))
    return GemmProgramSpec(prologue=prologue, branches=(spec_from_tag(tag),))



def program_with_dequant(tag: str, mode: str = "b") -> str:
    """Prefix a dequant stage onto *every* branch of a program tag (a
    quantized GLU quantizes both the gate and the up weight)."""
    spec = program_from_tag(tag)
    return program_tag(dataclasses.replace(
        spec, branches=tuple(dataclasses.replace(b, dequant=mode)
                             for b in spec.branches)))


def program_activation(tag: str) -> str:
    """The program's primary nonlinearity ("none" if linear): what the
    backward pass needs ``act'`` of (workload planning)."""
    spec = program_from_tag(tag)
    if spec.combine == "glu":
        return spec.combine_activation
    return spec.branches[0].activation


# ---------------------------------------------------------------------------
# Cost shape (tuning-space + I/O-model consumers)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ProgramCost:
    """What a program adds to the kernel's fast-memory and HBM budgets.

    ``stream_mn``: streamed (m, n)-shaped drain operands (mul/residual);
    ``prologue_mk``: (m, k)-shaped prologue operands riding the A stream
    (the forward dact saved pre-activation: 1); ``prologue_kn``: (k, n)
    ones riding the B stream (the ``@b`` backward dact variant);
    ``prologue_vec``: O(m)/O(k) prologue vectors (rms row scale + gain =
    2); ``n_b`` B operands/accumulators; ``n_out`` drained outputs.
    """

    stream_mn: int = 0
    has_bias: bool = False
    n_b: int = 1
    n_out: int = 1
    prologue_mk: int = 0
    prologue_kn: int = 0
    prologue_vec: int = 0


@functools.lru_cache(maxsize=None)
def program_cost(tag: str) -> ProgramCost:
    spec = program_from_tag(tag)
    stream_mn = sum(int(b.has_mul) + int(b.has_residual)
                    for b in spec.branches)
    dact = spec.prologue.kind == "dact"
    on_a = spec.prologue.operand == "a"
    return ProgramCost(
        stream_mn=stream_mn,
        has_bias=any(b.has_bias for b in spec.branches),
        n_b=spec.n_b, n_out=spec.n_out,
        prologue_mk=1 if dact and on_a else 0,
        prologue_kn=1 if dact and not on_a else 0,
        prologue_vec=2 if spec.prologue.kind == "rms" else 0)

@dataclasses.dataclass
class RmsPrologue:
    """rms_norm folded into the A-tile fetch: ``gain`` is the norm's (k,)
    scale; the per-row ``rsqrt(mean(x²) + eps)`` factor is computed by
    the wrapper, outside the kernel."""

    gain: torch.Tensor
    eps: float = 1e-5


def rms_row_scale(x: torch.Tensor, eps: float) -> torch.Tensor:
    """The per-row factor of rms_norm: ``rsqrt(mean(x², -1) + eps)``,
    (..., 1) fp32."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return torch.rsqrt(var + eps)


def apply_rms_reference(x: torch.Tensor, row_scale: torch.Tensor,
                        gain: torch.Tensor) -> torch.Tensor:
    """Oracle semantics of the rms prologue (== models.common.rms_norm):
    fp32 multiply chain, cast back to the operand dtype."""
    out = x.float() * row_scale.float() * gain.float()
    return out.to(x.dtype)


def apply_dact_reference(g: torch.Tensor, h: torch.Tensor,
                         activation: str) -> torch.Tensor:
    """Oracle semantics of the dact prologue: ``g · act'(h)`` in fp32,
    cast back to the gradient operand's dtype.  An integer operand (int8
    B of a dequant program, or dqab's int8 A) rounds as JAX's ``astype``
    does: toward zero, saturating at the type's range, NaN to 0."""
    out = g.float() * act_grad(activation)(h.float())
    if not g.dtype.is_floating_point:
        info = torch.iinfo(g.dtype)
        out = torch.nan_to_num(out, nan=0.0).clamp(info.min, info.max)
        out = out.trunc()
    return out.to(g.dtype)


def synthetic_operands(tag: str, m: int, n: int, k: int, dtype, *,
                       generator: torch.Generator,
                       device=None) -> Dict[str, torch.Tensor]:
    """Prologue operands for timing a program variant (the autotuner's):
    the dict matches :func:`repro_torch.kernels.ca_mmm.ca_gemm_program`'s
    prologue keywords for ``tag``, with the reference's shapes and dtypes
    (fp32 ``row_scale`` (m, 1) and a ``gain`` (k,) in ``dtype`` for rms;
    an fp32 ``preact`` shaped like the decorated operand for dact).  The
    values are drawn from ``generator`` in [0.5, 1.5), where the
    reference's are ones; timing does not depend on them."""
    spec = program_from_tag(tag)

    def draw(shape, dt):
        return (torch.rand(shape, generator=generator) + 0.5).to(
            dtype=dt, device=device)

    out: Dict[str, torch.Tensor] = {}
    if spec.prologue.kind == "rms":
        out["row_scale"] = draw((m, 1), torch.float32)
        out["gain"] = draw((k,), dtype)
    elif spec.prologue.kind == "dact":
        shape = (m, k) if spec.prologue.operand == "a" else (k, n)
        out["preact"] = draw(shape, torch.float32)
    return out
