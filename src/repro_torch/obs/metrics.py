"""Process-global metrics (port of ``repro/obs/metrics.py``): counters,
gauges, exponential-bucket histograms.

Every subsystem (the serve engine, the tuning registry, the autotuner, the
train launcher) increments named metrics here, and one ``snapshot()``
makes a run auditable after the fact: which kernels planned from cache vs
the solver, what the TTFT distribution was.

* **Cheap when nobody reads.**  An increment is a dict lookup + an add
  under a registry lock; no I/O, no string formatting.
* **Labels as children.**  ``counter.labels(source="cache")`` returns a
  child sharing the parent's name; the parent's value is the sum over
  children plus its own unlabeled increments.
* **Histograms are exponential.**  Bucket ``i`` spans
  ``(base·factor^(i-1), base·factor^i]``; with the defaults (1 µs, ×2) 41
  buckets cover 1 µs..1100 s.  ``percentile()`` answers from bucket upper
  bounds, clamped to the exact max, so the error is at most one factor.

Standard library only, thread-safe; the same semantics and key strings as
the reference, which the port cannot import.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Tuple


def _label_key(labels: Dict[str, object]) -> str:
    """Canonical child key: sorted ``k=v`` pairs, comma-joined."""
    return ",".join(f"{k}={labels[k]}" for k in sorted(labels))


class _Metric:
    """Shared family machinery: a parent metric with labeled children."""

    kind = "metric"

    def __init__(self, name: str, description: str = "",
                 lock: Optional[threading.RLock] = None, **child_kw):
        self.name = name
        self.description = description
        self._lock = lock or threading.RLock()
        self._children: Dict[str, "_Metric"] = {}
        self._child_kw = child_kw

    def labels(self, **labels):
        """The child metric for this label set (created on first use)."""
        key = _label_key(labels)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = type(self)(self.name, self.description,
                                   lock=self._lock, **self._child_kw)
                self._children[key] = child
            return child

    def child_items(self) -> List[Tuple[str, "_Metric"]]:
        with self._lock:
            return sorted(self._children.items())


class Counter(_Metric):
    """Monotonic sum (float increments allowed — seconds accumulate too)."""

    kind = "counter"

    def __init__(self, name, description="", lock=None):
        super().__init__(name, description, lock)
        self._value = 0.0

    def inc(self, value: float = 1.0) -> None:
        if value < 0:
            raise ValueError(f"counter {self.name}: negative inc {value}")
        with self._lock:
            self._value += value

    @property
    def value(self) -> float:
        with self._lock:
            return self._value + sum(c._value
                                     for c in self._children.values())

    def snapshot(self) -> dict:
        with self._lock:
            out = {"type": self.kind, "value": self.value}
            if self._children:
                out["labels"] = {k: c._value
                                 for k, c in sorted(self._children.items())}
            return out


class Gauge(_Metric):
    """Last-written value (set/add; ``None`` until first write)."""

    kind = "gauge"

    def __init__(self, name, description="", lock=None):
        super().__init__(name, description, lock)
        self._value: Optional[float] = None

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def add(self, value: float) -> None:
        with self._lock:
            self._value = (self._value or 0.0) + value

    @property
    def value(self) -> Optional[float]:
        with self._lock:
            return self._value

    def snapshot(self) -> dict:
        with self._lock:
            out = {"type": self.kind, "value": self._value}
            if self._children:
                out["labels"] = {k: c._value
                                 for k, c in sorted(self._children.items())}
            return out


class Histogram(_Metric):
    """Exponential-bucket histogram.

    Bucket ``i >= 1`` holds values in ``(base·factor^(i-1), base·factor^i]``;
    bucket 0 holds ``(0, base]`` and bucket -1 holds ``<= 0`` (a timing
    bug, but it must not crash the metric).  Only touched buckets are
    stored, so an idle histogram costs one dict.
    """

    kind = "histogram"

    def __init__(self, name, description="", lock=None,
                 base: float = 1e-6, factor: float = 2.0):
        super().__init__(name, description, lock, base=base, factor=factor)
        if base <= 0 or factor <= 1:
            raise ValueError(f"histogram needs base > 0 and factor > 1, "
                             f"got base={base} factor={factor}")
        self.base = base
        self.factor = factor
        self._log_factor = math.log(factor)
        self._buckets: Dict[int, int] = {}
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def _index(self, value: float) -> int:
        if value <= 0:
            return -1
        if value <= self.base:
            return 0
        # ceil with a tolerance so exact bucket bounds land in their own
        # bucket despite float log error.
        return max(1, math.ceil(
            math.log(value / self.base) / self._log_factor - 1e-9))

    def bucket_upper(self, index: int) -> float:
        """Upper bound of bucket ``index`` (0.0 for the <=0 bucket)."""
        return 0.0 if index < 0 else self.base * self.factor ** index

    def observe(self, value: float) -> None:
        value = float(value)
        idx = self._index(value)
        with self._lock:
            self._buckets[idx] = self._buckets.get(idx, 0) + 1
            self._count += 1
            self._sum += value
            self._min = min(self._min, value)
            self._max = max(self._max, value)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def mean(self) -> Optional[float]:
        with self._lock:
            return self._sum / self._count if self._count else None

    def percentile(self, p: float) -> Optional[float]:
        """Upper bound of the bucket holding the p-th percentile
        observation (clamped to the exact max — the top bucket's bound
        would otherwise overstate by up to one factor).  ``p`` in [0, 100].
        """
        if not 0 <= p <= 100:
            raise ValueError(f"percentile {p} outside [0, 100]")
        with self._lock:
            if not self._count:
                return None
            rank = p / 100.0 * self._count
            cum = 0
            for idx in sorted(self._buckets):
                cum += self._buckets[idx]
                if cum >= rank:
                    return float(min(self.bucket_upper(idx), self._max))
            return float(self._max)

    def snapshot(self) -> dict:
        with self._lock:
            out = {
                "type": self.kind,
                "count": self._count,
                "sum": self._sum,
                "min": self._min if self._count else None,
                "max": self._max if self._count else None,
                "mean": self._sum / self._count if self._count else None,
                "buckets": {f"{self.bucket_upper(i):.3g}": c
                            for i, c in sorted(self._buckets.items())},
            }
            for p in (50, 90, 99):
                out[f"p{p}"] = self.percentile(p)
            if self._children:
                out["labels"] = {k: c.snapshot()
                                 for k, c in sorted(self._children.items())}
            return out


class MetricsRegistry:
    """Named metric store; ``counter/gauge/histogram`` get-or-create.

    Re-requesting a name returns the existing instance (so call sites
    never coordinate); re-requesting under a different metric type is a
    bug and raises.
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: Dict[str, _Metric] = {}

    def _get(self, cls, name: str, description: str, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, description, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}")
            return m

    def counter(self, name: str, description: str = "") -> Counter:
        return self._get(Counter, name, description)

    def gauge(self, name: str, description: str = "") -> Gauge:
        return self._get(Gauge, name, description)

    def histogram(self, name: str, description: str = "",
                  base: float = 1e-6, factor: float = 2.0) -> Histogram:
        return self._get(Histogram, name, description,
                         base=base, factor=factor)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def snapshot(self) -> Dict[str, dict]:
        """One JSON-ready dict of every metric's current state."""
        with self._lock:
            metrics = sorted(self._metrics.items())
        return {name: m.snapshot() for name, m in metrics}

    def report(self) -> str:
        """Human-readable one-line-per-metric summary."""
        lines = []
        for name, snap in sorted(self.snapshot().items()):
            if snap["type"] == "histogram":
                if not snap["count"]:
                    lines.append(f"{name}: count=0")
                    continue
                lines.append(
                    f"{name}: count={snap['count']} mean={snap['mean']:.3g} "
                    f"p50={snap['p50']:.3g} p99={snap['p99']:.3g} "
                    f"max={snap['max']:.3g}")
            else:
                val = snap["value"]
                vs = "-" if val is None else f"{val:g}"
                line = f"{name}: {vs}"
                if snap.get("labels"):
                    line += " {" + ", ".join(
                        f"{k}: {v:g}" for k, v in snap["labels"].items()
                        if not isinstance(v, dict)) + "}"
                lines.append(line)
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Process-global instance (mirrors repro_torch.tuning.registry's pattern)
# ---------------------------------------------------------------------------

_global_lock = threading.Lock()
_global: Optional[MetricsRegistry] = None


def get_metrics() -> MetricsRegistry:
    global _global
    with _global_lock:
        if _global is None:
            _global = MetricsRegistry()
        return _global


def set_metrics(registry: Optional[MetricsRegistry]) -> None:
    """Install (or with ``None`` reset) the process-global registry."""
    global _global
    with _global_lock:
        _global = registry


def reset_metrics() -> None:
    set_metrics(None)
