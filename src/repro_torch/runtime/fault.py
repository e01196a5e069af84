"""Fault tolerance runtime (port of ``repro/runtime/fault.py``):
heartbeats, straggler detection, supervised restart, elastic resize,
and deterministic chaos injection for the serve path.

One host runs here, so host failures and stragglers are *simulated*
through the interfaces a multi-host deployment would use: hosts report
(step, timestamp) heartbeats; the monitor flags dead hosts by timeout
and stragglers by step-time z-score; the supervisor restarts the
training function from the newest checkpoint on failure and hands a
resize its new host count.  All policies are deterministic and tested.

The serve side is :class:`FaultPlan`: a thread-local context (the
``ActivationCalibration`` pattern) that schedules faults by *position*:
the nth GEMM dispatch raises :class:`InjectedKernelFailure` (fatal, or
recoverable by the dispatch layer's plain re-dispatch), the nth decode
step gets NaN logits, a transient error, or a stall.  ``core/gemm`` and
``serve/engine`` consult the active plan at their dispatch points.  Every
injected event counts in ``fault.events_total{kind}`` of
:mod:`repro_torch.obs`.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.obs.metrics import get_metrics


def _fault_counter(event: str):
    """Labeled child of the fault-event counter — a fault-injection run
    is auditable from the metrics snapshot alone."""
    return get_metrics().counter(
        "fault.events_total",
        "Fault-runtime events by kind (injected/restart/resize)").labels(
            kind=event)


@dataclasses.dataclass
class HostStatus:
    host_id: int
    last_step: int = -1
    last_beat: Optional[float] = None   # None = never heard from
    step_times: Optional[List[float]] = None

    def __post_init__(self):
        if self.step_times is None:
            self.step_times = []


class HeartbeatMonitor:
    """Tracks per-host liveness + step-time distribution."""

    def __init__(self, n_hosts: int, timeout_s: float = 60.0,
                 straggler_z: float = 3.0, window: int = 32,
                 clock: Callable[[], float] = time.monotonic):
        self.hosts = {i: HostStatus(i) for i in range(n_hosts)}
        self.timeout_s = timeout_s
        self.straggler_z = straggler_z
        self.window = window
        self.clock = clock

    def beat(self, host_id: int, step: int, now: Optional[float] = None):
        now = self.clock() if now is None else now
        h = self.hosts[host_id]
        if h.last_step >= 0 and step > h.last_step:
            h.step_times.append((now - h.last_beat)
                                / max(step - h.last_step, 1))
            h.step_times = h.step_times[-self.window:]
        h.last_step = step
        h.last_beat = now

    def dead_hosts(self, now: Optional[float] = None) -> List[int]:
        now = self.clock() if now is None else now
        dead = [i for i, h in self.hosts.items()
                if h.last_beat is not None
                and now - h.last_beat > self.timeout_s]
        get_metrics().gauge(
            "fault.dead_hosts",
            "Hosts past the heartbeat timeout at last check").set(
                len(dead))
        return dead

    def stragglers(self) -> List[int]:
        """Hosts whose mean step time is straggler_z sigmas above fleet."""
        means = {i: sum(h.step_times) / len(h.step_times)
                 for i, h in self.hosts.items() if len(h.step_times) >= 4}
        if len(means) < 2:
            return []
        vals = list(means.values())
        mu = sum(vals) / len(vals)
        var = sum((v - mu) ** 2 for v in vals) / len(vals)
        sd = math.sqrt(var)
        if sd == 0:
            return []
        return [i for i, v in means.items()
                if (v - mu) / sd > self.straggler_z]


class FailureInjector:
    """Deterministic failure schedule for tests/examples."""

    def __init__(self, fail_at_steps: Dict[int, str]):
        # step -> kind ("crash" | "resize:<new_n_hosts>")
        self.fail_at_steps = dict(fail_at_steps)

    def check(self, step: int) -> Optional[str]:
        kind = self.fail_at_steps.pop(step, None)
        if kind is not None:
            _fault_counter("injected:" + kind.split(":")[0]).inc()
        return kind


class SimulatedFailure(RuntimeError):
    pass


class ResizeEvent(RuntimeError):
    def __init__(self, new_n_hosts: int):
        super().__init__(f"resize to {new_n_hosts}")
        self.new_n_hosts = new_n_hosts


# ---------------------------------------------------------------------------
# Chaos injection (the serve path's deterministic fault source)
# ---------------------------------------------------------------------------

class InjectedKernelFailure(RuntimeError):
    """A scheduled kernel compile/execute failure.

    ``fatal=False`` models a kernel failure the dispatch layer recovers
    from (``core/gemm`` counts ``gemm.fallback_total{stage}`` and
    dispatches the same GEMM again); ``fatal=True`` models a failure the
    fallback cannot absorb either: it propagates to the request wrapper
    and fails exactly that request.  In the port this scheduled failure
    is the only one the dispatch layer re-dispatches; a real kernel
    error propagates.
    """

    def __init__(self, msg: str, fatal: bool = False):
        super().__init__(msg)
        self.fatal = fatal


class TransientServeError(RuntimeError):
    """A retryable failure (the serve engine's exponential-backoff class)."""

    transient = True


@dataclasses.dataclass(frozen=True)
class DecodeFault:
    """What the active plan injects into one decode step."""

    nan: bool = False
    transient: bool = False
    slow_s: float = 0.0


_plan_tls = threading.local()


def active_fault_plan() -> Optional["FaultPlan"]:
    stack = getattr(_plan_tls, "stack", None)
    return stack[-1] if stack else None


class FaultPlan:
    """Deterministic fault schedule, positional over two event streams.

    * **GEMM dispatches** — every ``core.gemm`` dispatch with m > 0
      (``ca_matmul``, ``ca_glu_matmul``, their quantized programs, and
      each expert's launch of ``ca_expert_matmul`` /
      ``ca_expert_glu_matmul``) advances one counter; ``kernel_fail_at``
      indices raise a *recoverable* :class:`InjectedKernelFailure` there
      (the dispatch layer re-runs that GEMM's plain version),
      ``kernel_fatal_at`` indices raise a fatal one (the request fails).
      The port dispatches eagerly, so every launch consumes an index (the
      reference counts at ``jax.jit`` trace time): a fatal injection at a
      request's first GEMM aborts it before its next one, so the next
      index is the next request's first GEMM in both.
    * **Decode steps** — every serve decode iteration advances the other
      counter; ``nan_decode_at`` poisons that step's logits with NaN
      (exercising the quant degradation ladder), ``transient_decode_at``
      raises :class:`TransientServeError` (exercising retry/backoff),
      ``slow_decode_at`` maps step index -> stall seconds (straggler
      steps; also what deadline enforcement is tested against).

    Indices are 0-based and consumed once: a request retried after an
    injection advances past the poisoned position, so retries see clean
    steps.  The plan is a context manager (thread-local stack, the
    ``ActivationCalibration`` pattern) and records everything it injected
    in ``self.injected`` — a chaos run is auditable from the plan alone,
    and from ``fault.events_total{kind=injected:*}``.
    """

    def __init__(self,
                 kernel_fail_at: Sequence[int] = (),
                 kernel_fatal_at: Sequence[int] = (),
                 nan_decode_at: Sequence[int] = (),
                 transient_decode_at: Sequence[int] = (),
                 slow_decode_at: Optional[Mapping[int, float]] = None):
        self.kernel_fail_at = frozenset(kernel_fail_at)
        self.kernel_fatal_at = frozenset(kernel_fatal_at)
        overlap = self.kernel_fail_at & self.kernel_fatal_at
        if overlap:
            raise ValueError("a GEMM dispatch index cannot be both "
                             f"recoverable and fatal: {sorted(overlap)}")
        self.nan_decode_at = frozenset(nan_decode_at)
        self.transient_decode_at = frozenset(transient_decode_at)
        self.slow_decode_at = dict(slow_decode_at or {})
        self.gemm_dispatches = 0
        self.decode_steps = 0
        self.injected: List[Tuple[str, int]] = []

    # -- context manager ----------------------------------------------------

    def __enter__(self) -> "FaultPlan":
        stack = getattr(_plan_tls, "stack", None)
        if stack is None:
            stack = _plan_tls.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc):
        _plan_tls.stack.pop()

    # -- injection points ---------------------------------------------------

    def _inject(self, kind: str, index: int) -> None:
        self.injected.append((kind, index))
        _fault_counter("injected:" + kind).inc()

    def check_gemm(self, stage: str) -> None:
        """Called once per GEMM dispatch; raises when one is scheduled."""
        i = self.gemm_dispatches
        self.gemm_dispatches += 1
        if i in self.kernel_fatal_at:
            self._inject("kernel_fatal", i)
            raise InjectedKernelFailure(
                f"injected fatal kernel failure at GEMM dispatch {i} "
                f"(stage {stage})", fatal=True)
        if i in self.kernel_fail_at:
            self._inject("kernel", i)
            raise InjectedKernelFailure(
                f"injected kernel failure at GEMM dispatch {i} "
                f"(stage {stage})", fatal=False)

    def decode_fault(self) -> Optional[DecodeFault]:
        """Called once per serve decode step; the engine acts on it."""
        i = self.decode_steps
        self.decode_steps += 1
        nan = i in self.nan_decode_at
        transient = i in self.transient_decode_at
        slow = self.slow_decode_at.get(i, 0.0)
        if not (nan or transient or slow):
            return None
        if nan:
            self._inject("nan", i)
        if transient:
            self._inject("transient", i)
        if slow:
            self._inject("slow", i)
        return DecodeFault(nan=nan, transient=transient, slow_s=slow)


@dataclasses.dataclass
class SupervisorReport:
    restarts: int
    resizes: int
    final_step: int
    events: List[Tuple[int, str]]


class TrainSupervisor:
    """Runs a step function under checkpoint/restart supervision.

    run_fn(start_step, n_hosts) must yield (step) after each completed
    step and raise SimulatedFailure/ResizeEvent when injected.  The
    supervisor restores from the checkpoint manager and resumes —
    restart-safety of the data pipeline (``data.pipeline.batch_at``)
    makes the resumed run bitwise-deterministic on the same device.
    """

    def __init__(self, ckpt_manager, save_every: int = 10,
                 max_restarts: int = 8, max_resizes: int = 32):
        self.ckpt = ckpt_manager
        self.save_every = save_every
        self.max_restarts = max_restarts
        self.max_resizes = max_resizes

    def run(self, make_runner, total_steps: int, n_hosts: int
            ) -> SupervisorReport:
        restarts = resizes = 0
        events: List[Tuple[int, str]] = []
        step = 0
        while step < total_steps:
            # A checkpoint at step s resumes at s + 1 — including s == 0
            # (`latest_step() or -1` treated the falsy step 0 as missing
            # and re-ran the completed step).
            latest = self.ckpt.latest_step()
            start = latest + 1 if latest is not None else step
            runner = make_runner(start, n_hosts)
            try:
                for step in runner:
                    pass
                step = total_steps
            except SimulatedFailure:
                restarts += 1
                events.append((step, "crash->restart"))
                _fault_counter("restart").inc()
                if restarts > self.max_restarts:
                    raise
            except ResizeEvent as e:
                resizes += 1
                n_hosts = e.new_n_hosts
                events.append((step, f"resize->{n_hosts}"))
                _fault_counter("resize").inc()
                # A resize storm that never progresses must not loop the
                # supervisor forever — the cap bounds it like restarts.
                if resizes > self.max_resizes:
                    raise
        return SupervisorReport(restarts, resizes, step, events)
