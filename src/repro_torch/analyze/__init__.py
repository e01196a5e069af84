"""Static analysis for the port's serve and train stack (port of
``repro.analyze``).

Three coordinated passes, one diagnostic vocabulary:

* **Program verifier** (:mod:`repro_torch.analyze.validate`): checks a
  resolved (program tag, tile, target) triple against the hard
  constraints before anything launches: shared memory on the card
  (SMEM001), tag-grammar round-trips (TAG002), quantized dtype chains and
  scale-block alignment (QNT003), distributed geometry (DIST004) and KV
  page and pool arithmetic (KV005).
* **Dispatch preflight** (:mod:`repro_torch.analyze.preflight`): the hook
  ``core.gemm`` and ``kvcache.paged`` call before launching a kernel,
  memoized per plan; a failure raises one
  :class:`~repro_torch.analyze.diagnostics.ProgramValidationError`
  listing every diagnostic and counts ``analyze.violations_total{code}``.
* **AST lint** (:mod:`repro_torch.analyze.lint`, ``python -m
  repro_torch.analyze lint src/repro_torch``): rules RPR001-RPR005 keep
  code on the registry, ledger and fallback rails.
"""

from repro_torch.analyze.diagnostics import (CODES, Diagnostic,
                                             ProgramValidationError)
from repro_torch.analyze.preflight import (preflight_attn, preflight_dist,
                                           preflight_gemm, preflight_stats,
                                           reset_preflight)
from repro_torch.analyze.validate import (validate_attn,
                                          validate_cache_entry,
                                          validate_dist, validate_program)

__all__ = [
    "CODES", "Diagnostic", "ProgramValidationError",
    "validate_program", "validate_attn", "validate_dist",
    "validate_cache_entry",
    "preflight_gemm", "preflight_dist", "preflight_attn",
    "preflight_stats", "reset_preflight",
]
