"""Observability (port of ``repro.obs``): metrics registry, trace spans,
and the GEMM ledger.

Import-light: ``repro_torch.obs`` pulls in the hardware target and the
I/O model at import time, nothing else (the tuning registry, the kernels
and the program grammar are deferred to the call sites that need them),
so hot paths can hook in unconditionally.
"""

from repro_torch.obs.ledger import (AttnRecord, DistRecord, GemmLedger,
                                    GemmRecord, enable_ledger, get_ledger,
                                    planned_attn_kv_bytes,
                                    planned_gemm_bytes, reset_ledger,
                                    set_ledger)
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, get_metrics,
                                     reset_metrics, set_metrics)
from repro_torch.obs.trace import (DEFAULT_TRACE_PATH, disable_tracing,
                                   enable_tracing, flush, instant,
                                   read_trace, span, trace_path,
                                   tracing_enabled)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "get_metrics", "set_metrics", "reset_metrics",
    "DEFAULT_TRACE_PATH", "span", "instant", "enable_tracing",
    "disable_tracing", "tracing_enabled", "trace_path", "flush",
    "read_trace",
    "AttnRecord", "DistRecord", "GemmLedger", "GemmRecord", "get_ledger",
    "set_ledger",
    "enable_ledger", "reset_ledger", "planned_gemm_bytes",
    "planned_attn_kv_bytes",
]
