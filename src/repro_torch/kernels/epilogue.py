"""Fused GEMM epilogue (port of ``repro/kernels/epilogue.py``): bias /
activation / gating / residual riding the drain phase's single write-back.

* :class:`EpilogueSpec` — the static shape of an epilogue (which slots are
  present, which activation); its :meth:`~EpilogueSpec.tag` is
  byte-identical to the reference's, since tuning caches key on it.
* :class:`Epilogue` — the user-facing bundle: spec + the actual tensors.
* :func:`apply_reference` — the fp32 oracle semantics the kernel's drain
  and the plain version share.
* :func:`act_grad` — each activation's derivative in closed form, which
  the backward programs' ``dact`` prologue applies.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

ACTIVATIONS = ("none", "relu", "gelu", "silu")

# Dequant stage of the drain chain: "b" rescales by the weight's
# per-channel column scales, "ab" additionally by per-row activation
# scales.  Parsed for tag parity; the kernels of this slice do not run it.
DEQUANTS = ("none", "b", "ab")


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation; torch defaults to erf.
    return F.gelu(x, approximate="tanh")


# The derivatives below are written op for op as the kernel's act_grad
# evaluates them (csrc/ca_gemm_program.cu), so that on the card both round
# alike before the dact prologue's cast.

def _gelu_tanh_grad(x: torch.Tensor) -> torch.Tensor:
    c = 0.7978845608028654          # sqrt(2 / pi)
    x2 = x * x
    t = torch.tanh(c * (x + 0.044715 * x2 * x))
    return 0.5 * (1 + t) + 0.5 * x * (1 - t * t) * c * (1 + 3 * 0.044715 * x2)


def _silu_grad(x: torch.Tensor) -> torch.Tensor:
    s = torch.sigmoid(x)
    return s * (1 + x * (1 - s))


def act_grad(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """fp32 derivative of :func:`act_fn` by name, in closed form (the
    formulas the kernel's ``dact`` prologue evaluates).  ``relu``'s is 0 at
    0, as JAX's is."""
    if name == "none":
        return torch.ones_like
    if name == "relu":
        return lambda x: (x > 0).to(x.dtype)
    if name == "gelu":
        return _gelu_tanh_grad
    if name == "silu":
        return _silu_grad
    raise ValueError(f"unknown activation {name!r}; expected {ACTIVATIONS}")


def act_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """fp32 elementwise activation by name (``none`` is identity)."""
    if name == "none":
        return lambda x: x
    if name == "relu":
        return torch.relu
    if name == "gelu":
        return _gelu_tanh
    if name == "silu":
        return F.silu
    raise ValueError(f"unknown activation {name!r}; expected {ACTIVATIONS}")


@dataclasses.dataclass(frozen=True)
class EpilogueSpec:
    """Static epilogue description: presence flags + activation name.

    Order of application (all math in fp32, matching ``apply_reference``):
    ``y = act(z·s_a·s_b + bias) * mul + residual`` — each stage optional.
    """

    activation: str = "none"
    has_bias: bool = False
    has_mul: bool = False
    has_residual: bool = False
    dequant: str = "none"

    def __post_init__(self):
        if self.activation not in ACTIVATIONS:
            raise ValueError(f"unknown epilogue activation "
                             f"{self.activation!r} (valid: {ACTIVATIONS})")
        if self.dequant not in DEQUANTS:
            raise ValueError(f"unknown dequant stage {self.dequant!r} "
                             f"(valid: {DEQUANTS})")

    @property
    def is_identity(self) -> bool:
        return (self.activation == "none" and not self.has_bias
                and not self.has_mul and not self.has_residual
                and self.dequant == "none")

    @property
    def needs_preact(self) -> bool:
        """Backward needs the saved pre-activation z+bias iff some stage is
        nonlinear in it (activation) or re-reads it (the mul gate's grad)."""
        return self.activation != "none" or self.has_mul

    def tag(self) -> str:
        """Canonical cache-key fragment, e.g. ``dqb+bias+silu+mul+res``."""
        if self.is_identity:
            return "none"
        parts = []
        if self.dequant != "none":
            parts.append("dq" + self.dequant)
        if self.has_bias:
            parts.append("bias")
        if self.activation != "none":
            parts.append(self.activation)
        if self.has_mul:
            parts.append("mul")
        if self.has_residual:
            parts.append("res")
        return "+".join(parts)


IDENTITY = EpilogueSpec()


def spec_from_tag(tag: str) -> EpilogueSpec:
    """Inverse of :meth:`EpilogueSpec.tag`; unknown parts raise."""
    if tag == "none":
        return IDENTITY
    activation = "none"
    dequant = "none"
    flags = {"bias": False, "mul": False, "res": False}
    for p in tag.split("+"):
        if p in flags:
            flags[p] = True
        elif p in ACTIVATIONS and p != "none":
            activation = p
        elif p in ("dqb", "dqab"):
            dequant = p[2:]
        else:
            raise ValueError(f"unknown epilogue tag part {p!r} in {tag!r}")
    return EpilogueSpec(activation=activation, has_bias=flags["bias"],
                        has_mul=flags["mul"], has_residual=flags["res"],
                        dequant=dequant)


def stream_cost(tag: str) -> Tuple[int, bool]:
    """(number of streamed (m, n) operands, has_bias) for a spec tag: the
    drain-phase tiles the tuning space budgets shared memory for and the
    I/O model charges one HBM read each.  A dequant stage's scale vectors
    (O(bm + bn) against an O(bm·bn) accumulator) are not charged here;
    ``core.io_model.epilogue_q_elements`` counts their reads."""
    spec = spec_from_tag(tag)
    return int(spec.has_mul) + int(spec.has_residual), spec.has_bias


def with_dequant(tag: str, mode: str = "b") -> str:
    """An epilogue tag with a dequant stage in front (``dqb`` or
    ``dqab``; idempotent per mode)."""
    return dataclasses.replace(spec_from_tag(tag), dequant=mode).tag()


@dataclasses.dataclass
class Epilogue:
    """User-facing epilogue: optional tensors + activation.

    ``bias``: (n,) added to each output row; ``mul``: (..., n) gate
    multiplied after activation; ``residual``: (..., n) added last.
    Leading dims of mul/residual must match the GEMM lhs.
    """

    bias: Optional[torch.Tensor] = None
    activation: str = "none"
    mul: Optional[torch.Tensor] = None
    residual: Optional[torch.Tensor] = None

    def spec(self) -> EpilogueSpec:
        return EpilogueSpec(
            activation=self.activation,
            has_bias=self.bias is not None,
            has_mul=self.mul is not None,
            has_residual=self.residual is not None,
        )

    def operands(self) -> Dict[str, torch.Tensor]:
        out = {}
        if self.bias is not None:
            out["bias"] = self.bias
        if self.mul is not None:
            out["mul"] = self.mul
        if self.residual is not None:
            out["residual"] = self.residual
        return out


def apply_reference(z: torch.Tensor, spec: EpilogueSpec,
                    operands: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Oracle semantics: fp32 elementwise chain on the accumulator ``z``.

    Returns fp32 (the caller casts to the output dtype).
    """
    zf = z.float()
    if spec.dequant != "none":
        zf = zf * operands["scale_b"].reshape(1, -1).float()
        if spec.dequant == "ab":
            zf = zf * operands["scale_a"].reshape(-1, 1).float()
    if spec.has_bias:
        zf = zf + operands["bias"].float()
    zf = act_fn(spec.activation)(zf)
    if spec.has_mul:
        zf = zf * operands["mul"].float()
    if spec.has_residual:
        zf = zf + operands["residual"].float()
    return zf
