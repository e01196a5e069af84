"""Tracing spans (port of ``repro/obs/trace.py``): Chrome-trace-event /
Perfetto-compatible JSONL.

``span("name", **attrs)`` wraps any region of host code; when tracing is
enabled each completed span appends one complete ("ph": "X") trace event
line to the output file, which loads directly in Perfetto /
chrome://tracing (the Trace Event *array* format, whose closing bracket is
optional by spec, so the file is line-appendable and crash-safe).

Enable with ``REPRO_TORCH_TRACE=<path>`` in the environment (``1`` means
the default, ``build/trace.jsonl`` at the repository root) or
programmatically via :func:`enable_tracing`.  Disabled, the default, a
span is one shared no-op context manager: no file is opened, no event
object is built, no lock is taken.

An enabled span also enters ``torch.profiler.record_function(name)``, so a
``torch.profiler`` trace of the same run shows the same region names
beside the device's kernels.
"""

from __future__ import annotations

import json
import os
import pathlib
import threading
import time
from typing import Any, Dict, List, Optional

_ENV_TRACE = "REPRO_TORCH_TRACE"
DEFAULT_TRACE_PATH = str(
    pathlib.Path(__file__).resolve().parents[3] / "build" / "trace.jsonl")


class _Tracer:
    """Thread-safe JSONL trace writer (one per process)."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._f = open(path, "w")
        self._f.write("[\n")          # array format; "]" optional by spec
        self._f.flush()
        self.pid = os.getpid()
        self._t0 = time.perf_counter()

    def now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def emit(self, event: Dict[str, Any]) -> None:
        line = json.dumps(event, sort_keys=True)
        with self._lock:
            self._f.write(line + ",\n")

    def flush(self) -> None:
        with self._lock:
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.flush()
                self._f.close()


_state_lock = threading.Lock()
_tracer: Optional[_Tracer] = None
_env_checked = False


def _profiler_annotation(name: str):
    """The ``torch.profiler`` region of a span (recorded only while a
    profiler is collecting)."""
    import torch.profiler  # deferred: a disabled span never needs it

    return torch.profiler.record_function(name)


def enable_tracing(path: str = DEFAULT_TRACE_PATH) -> str:
    """Start writing trace events to ``path`` (truncates). Returns path."""
    global _tracer, _env_checked
    pathlib.Path(path).parent.mkdir(parents=True, exist_ok=True)
    with _state_lock:
        if _tracer is not None:
            _tracer.close()
        _tracer = _Tracer(path)
        _env_checked = True
        return path


def disable_tracing() -> None:
    """Stop tracing and close the output file (flushes pending events)."""
    global _tracer, _env_checked
    with _state_lock:
        if _tracer is not None:
            _tracer.close()
        _tracer = None
        _env_checked = True     # an explicit disable beats the env var


def tracing_enabled() -> bool:
    return _get_tracer() is not None


def trace_path() -> Optional[str]:
    t = _get_tracer()
    return t.path if t is not None else None


def flush() -> None:
    t = _get_tracer()
    if t is not None:
        t.flush()


def _get_tracer() -> Optional[_Tracer]:
    """The active tracer, honoring REPRO_TRACE on first use."""
    global _tracer, _env_checked
    if _tracer is not None:
        return _tracer
    if _env_checked:
        return None
    with _state_lock:
        if not _env_checked:
            _env_checked = True
            val = os.environ.get(_ENV_TRACE, "")
            if val and val != "0":
                path = DEFAULT_TRACE_PATH if val == "1" else val
                pathlib.Path(path).parent.mkdir(parents=True, exist_ok=True)
                _tracer = _Tracer(path)
    return _tracer


class _NoopSpan:
    """Shared do-nothing span (tracing disabled)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


class Span:
    """An active span: records wall duration, emits one "X" event."""

    __slots__ = ("name", "attrs", "tracer", "_annotation", "_start_us",
                 "duration_s")

    def __init__(self, name: str, tracer: _Tracer, annotation,
                 attrs: Dict[str, Any]):
        self.name = name
        self.attrs = attrs
        self.tracer = tracer
        self._annotation = annotation
        self._start_us = 0.0
        self.duration_s = 0.0

    def __enter__(self):
        if self._annotation is not None:
            self._annotation.__enter__()
        self._start_us = self.tracer.now_us()
        return self

    def __exit__(self, *exc):
        end_us = self.tracer.now_us()
        self.duration_s = (end_us - self._start_us) * 1e-6
        event = {
            "name": self.name,
            "ph": "X",
            "ts": self._start_us,
            "dur": end_us - self._start_us,
            "pid": self.tracer.pid,
            "tid": threading.get_ident() & 0x7FFFFFFF,
            "cat": "repro",
        }
        if self.attrs:
            event["args"] = {k: _jsonable(v) for k, v in self.attrs.items()}
        self.tracer.emit(event)
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
        return False


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


def span(name: str, **attrs):
    """Context manager tracing one named region.

    Attrs become the event's ``args`` (shown in the Perfetto detail
    pane); values are JSON-encoded, non-scalars via ``str``.  Nesting is
    expressed by the containment of [ts, ts+dur] intervals on one tid —
    exactly how Chrome trace viewers reconstruct flame graphs from "X"
    events, so nothing extra is recorded per level.
    """
    tracer = _get_tracer()
    if tracer is None:
        return _NOOP
    return Span(name, tracer, _profiler_annotation(name), attrs)


def instant(name: str, **attrs) -> None:
    """Emit a zero-duration instant event (scope: thread)."""
    tracer = _get_tracer()
    if tracer is None:
        return
    event = {
        "name": name, "ph": "i", "s": "t",
        "ts": tracer.now_us(),
        "pid": tracer.pid,
        "tid": threading.get_ident() & 0x7FFFFFFF,
        "cat": "repro",
    }
    if attrs:
        event["args"] = {k: _jsonable(v) for k, v in attrs.items()}
    tracer.emit(event)


def read_trace(path: str) -> List[Dict[str, Any]]:
    """Parse a trace file written by this module (the validation half of
    the JSONL round trip: one event per line, array brackets and trailing
    commas tolerated exactly as the Trace Event spec allows)."""
    events = []
    with open(path) as f:
        for line in f:
            line = line.strip().rstrip(",")
            if line in ("", "[", "]"):
                continue
            events.append(json.loads(line))
    return events
