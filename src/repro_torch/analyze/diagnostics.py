"""Diagnostic records and the single validation error type (port of
``repro/analyze/diagnostics.py``).

Every constraint the verifier checks has a stable code (``SMEM001``,
``TAG002``, ...) so tests, dashboards and the ``analyze.violations_total``
counter can name the invariant that broke, not just that *something*
did.  Codes are append-only — retiring one would silently un-gate the
constraint it named.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Sequence

# code -> one-line invariant.  The reference's codes, but for one: its
# VMEM001 (a tile's VMEM footprint) is SMEM001 here, since the budget on
# the card is a CTA's shared memory.
CODES: Dict[str, str] = {
    "SMEM001": "tile fast-memory footprint must fit the target: on a card "
               "whose kernels run fixed route tiles, the tile must be a K1 "
               "route's and its shared memory (stage ring + epilogue "
               "residents) must fit hw.smem_per_block; on a target built "
               "from a TPU's fields, the reference's Eq. 9 budget "
               "(vmem_fraction * its VMEM)",
    "TAG002": "program tag must parse and round-trip through "
              "program_from_tag / program_tag",
    "QNT003": "quantized dtype chain must be legal (int8 operands need a "
              "dequant drain stage; int8 activations need int8 weights) "
              "and per-tile scale blocks must be aligned to the k slabs "
              "the int8 routes stream and mutually consistent",
    "DIST004": "distributed schedule geometry must divide exactly "
               "(n over tp, k over tp*pods, per-tile blocks over the "
               "ring k-chunk)",
    "KV005": "KV page geometry and pool admission arithmetic must hold "
             "(positive lane-friendly pages, GQA head divisibility, "
             "enough pages/table slots for the admitted context)",
}

SEVERITIES = ("error", "warning")


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One named constraint violation (or advisory).

    ``context`` carries the numbers that made the check fail (shapes,
    budgets, block sizes) as plain values, so reports serialize.
    """

    code: str
    severity: str
    message: str
    context: Mapping = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.code not in CODES:
            raise ValueError(f"unknown diagnostic code {self.code!r} "
                             f"(known: {sorted(CODES)})")
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r}")

    def __str__(self) -> str:
        ctx = ""
        if self.context:
            ctx = " [" + ", ".join(f"{k}={v}" for k, v
                                   in sorted(self.context.items())) + "]"
        return f"{self.code} ({self.severity}): {self.message}{ctx}"

    def to_json(self) -> Dict:
        return {"code": self.code, "severity": self.severity,
                "message": self.message, "context": dict(self.context)}


def error(code: str, message: str, **context) -> Diagnostic:
    return Diagnostic(code=code, severity="error", message=message,
                      context=context)


def warning(code: str, message: str, **context) -> Diagnostic:
    return Diagnostic(code=code, severity="warning", message=message,
                      context=context)


class ProgramValidationError(ValueError):
    """A dispatch (or constructor) was rejected by the verifier.

    Carries the full diagnostic list — one raise names *every* violated
    constraint, instead of the first launch error naming none.

    ``fatal = True`` opts out of the fallback ladder
    (``core.gemm._note_fallback`` re-raises fatal failures): a program
    that fails static validation is misconfigured, and serving it from
    the plain version would hide the bug the validator exists to
    surface.
    """

    fatal = True

    def __init__(self, diagnostics: Sequence[Diagnostic]):
        self.diagnostics = tuple(diagnostics)
        lines = [str(d) for d in self.diagnostics]
        super().__init__(
            "program validation failed with "
            f"{len(lines)} diagnostic(s):\n  " + "\n  ".join(lines))

    @property
    def codes(self) -> Sequence[str]:
        return tuple(d.code for d in self.diagnostics)
