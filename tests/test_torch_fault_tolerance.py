"""The port's serve-path fault tolerance against the reference's: the 11
scenarios of ``tests/test_fault_tolerance.py`` (request isolation, the
degradation ladder, chaos injection, admission backpressure, deadlines,
retries), each run through both engines on reduced stablelm-1.6b with the
reference's params carried over, under the same ``FaultPlan``.

Statuses, error reasons, generated tokens, attempts, ``degraded_to`` and
every fault counter must be equal.  Faults are positional, over GEMM
dispatches and decode steps: the reference counts dispatches at
``jax.jit`` trace time, the port at every eager launch, and in each
scenario the indices hit the same GEMM (a fatal injection at a request's
first GEMM ends it before its next one, so the next index is the next
request's first GEMM in both).  One more case is the port's own: a real
kernel error is never re-dispatched.
"""

import time

import jax
import numpy as np
import pytest

from _torch_isolation import isolated_port_state  # noqa: F401
from repro.configs import get_reduced as jax_reduced
from repro.core import gemm_fallback as jgemm_fallback
from repro.models import common as jcm
from repro.models import model as JM
from repro.obs import get_metrics as jget_metrics
from repro.runtime.fault import FaultPlan as JFaultPlan
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_reduced
from repro_torch.core.gemm import gemm_fallback
from repro_torch.kernels import ca_mmm as K
from repro_torch.models import model as TM
from repro_torch.obs import get_metrics
from repro_torch.runtime.fault import FaultPlan
from repro_torch.serve.engine import Request, ServeEngine

ARCH = "stablelm-1.6b"
COUNTERS = ("serve.requests_total", "serve.requests_failed_total",
            "serve.degraded_total", "serve.rejected_total",
            "serve.retries_total", "gemm.fallback_total",
            "fault.events_total")


def _as_numpy(tree):
    """The reference's params as numpy, each quantized leaf as the mapping
    of its fields that ``params_from_jax`` takes."""
    from repro.quant import QTensor as JQTensor

    out = {}
    for key, v in tree.items():
        if isinstance(v, JQTensor):
            d = {"data": np.asarray(v.data), "scale": np.asarray(v.scale),
                 "axis": v.axis, "block": v.block, "fmt": v.fmt,
                 "act_block": v.act_block}
            if v.act_scale is not None:
                d["act_scale"] = np.asarray(v.act_scale)
            out[key] = d
        else:
            out[key] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def params():
    """(reference, port) params, dense and weight-quantized (quantized in
    the reference, then carried over, so both serve the same int8)."""
    jp = JM.init_params(jax_reduced(ARCH), jax.random.PRNGKey(0))
    jq = jcm.quantize_params(jp)
    cfg = get_reduced(ARCH)
    return {False: (jp, TM.params_from_jax(_as_numpy(jp), cfg,
                                           device="cpu")),
            True: (jq, TM.params_from_jax(_as_numpy(jq), cfg,
                                          device="cpu"))}


def _engines(params, quantize=False, **kw):
    jp, tp = params[quantize]
    jeng = JServeEngine(jp, jax_reduced(ARCH), batch_size=1, max_len=32,
                        warmup_gemms=False, **kw)
    teng = ServeEngine(tp, get_reduced(ARCH), max_len=32, device="cpu",
                       **kw)
    return jeng, teng


def _requests(make, n, max_new_tokens=5):
    rng = np.random.RandomState(0)
    V = get_reduced(ARCH).vocab_size
    return [make(uid=u, prompt=rng.randint(0, V, 8),
                 max_new_tokens=max_new_tokens) for u in range(n)]


def _counters(registry):
    snap = registry.snapshot()
    return {name: {"value": snap[name]["value"],
                   "labels": snap[name].get("labels", {})}
            for name in COUNTERS if name in snap}


def _reason(req):
    return None if req.error is None else req.error.split(":")[0]


def _same_outcomes(jdone, tdone):
    """Both engines' requests agree on everything a fault run decides."""
    assert sorted(jdone) == sorted(tdone)
    for uid in jdone:
        j, t = jdone[uid], tdone[uid]
        assert (t.status, _reason(t), t.generated, t.attempts,
                t.quant_level, t.degraded_to, t.fallbacks) == \
            (j.status, _reason(j), j.generated, j.attempts, j.quant_level,
             j.degraded_to, j.fallbacks), uid
        if j.status in ("failed", "rejected") and j.error.split(":")[0] in (
                "kernel", "nonfinite", "transient"):
            assert t.error == j.error, uid
    assert _counters(get_metrics()) == _counters(jget_metrics())


def _run_both(jeng, teng, plan_kw=None, fallback=False):
    """Run both engines, each under its own package's FaultPlan built
    from ``plan_kw`` (and the fallback policy); returns (jdone, tdone,
    jplan, tplan)."""
    plans = [None, None]
    with jgemm_fallback(fallback):
        if plan_kw is None:
            jdone = jeng.run()
        else:
            with JFaultPlan(**plan_kw) as plans[0]:
                jdone = jeng.run()
    with gemm_fallback(fallback):
        if plan_kw is None:
            tdone = teng.run()
        else:
            with FaultPlan(**plan_kw) as plans[1]:
                tdone = teng.run()
    return jdone, tdone, plans[0], plans[1]


# -- chaos e2e (the acceptance scenario) ------------------------------------

def test_chaos_isolates_poisoned_requests_exactly(params):
    """Fatal kernel + recoverable kernel + NaN decode into a 4-request
    queue: the same requests fail and degrade in both engines, the clean
    and plain-recovered requests equal a fault-free run, and every
    counter reads the same."""
    jclean, tclean = _engines(params, quantize=True)
    for a, b in zip(_requests(JRequest, 4), _requests(Request, 4)):
        jclean.submit(a)
        tclean.submit(b)
    jc, tc, _, _ = _run_both(jclean, tclean)
    _same_outcomes(jc, tc)

    jeng, teng = _engines(params, quantize=True)
    for a, b in zip(_requests(JRequest, 4), _requests(Request, 4)):
        jeng.submit(a)
        teng.submit(b)
    # dispatch 0 = request 0's first prefill GEMM (fatal); dispatch 1 =
    # request 1's (recoverable); decode step 4 = request 2's first decode
    # iteration (requests 0/1 consumed 0 + 4 steps).
    jdone, tdone, jplan, tplan = _run_both(
        jeng, teng, dict(kernel_fatal_at=(0,), kernel_fail_at=(1,),
                         nan_decode_at=(4,)), fallback=True)
    assert sorted(tplan.injected) == sorted(jplan.injected) == [
        ("kernel", 1), ("kernel_fatal", 0), ("nan", 4)]
    assert [tdone[u].status for u in range(4)] == [
        "failed", "degraded", "degraded", "done"]
    assert tdone[1].generated == tc[1].generated
    assert tdone[3].generated == tc[3].generated
    assert tdone[2].degraded_to == "dense" and tdone[2].attempts == 2
    _same_outcomes(jdone, tdone)


def test_recoverable_kernel_failure_output_identical(params):
    """A recoverable kernel failure re-dispatches the same GEMM: same
    output as a fault-free run, one gemm.fallback_total tick."""
    jclean, tclean = _engines(params)
    jclean.submit(_requests(JRequest, 1)[0])
    tclean.submit(_requests(Request, 1)[0])
    _, tc, _, _ = _run_both(jclean, tclean)

    jeng, teng = _engines(params)
    jeng.submit(_requests(JRequest, 1)[0])
    teng.submit(_requests(Request, 1)[0])
    jdone, tdone, jplan, tplan = _run_both(
        jeng, teng, dict(kernel_fail_at=(0,)), fallback=True)
    assert tplan.injected == jplan.injected == [("kernel", 0)]
    assert tdone[0].status == "degraded" and tdone[0].fallbacks == 1
    assert tdone[0].generated == tc[0].generated
    _same_outcomes(jdone, tdone)


def test_fallback_disabled_fails_request_not_engine(params):
    """With the fallback off (the test default), a recoverable kernel
    fault still fails only its own request."""
    jeng, teng = _engines(params)
    for a, b in zip(_requests(JRequest, 2), _requests(Request, 2)):
        jeng.submit(a)
        teng.submit(b)
    jdone, tdone, _, _ = _run_both(jeng, teng, dict(kernel_fail_at=(0,)))
    assert tdone[0].status == "failed" and "kernel" in tdone[0].error
    assert tdone[1].status == "done" and len(tdone[1].generated) == 5
    _same_outcomes(jdone, tdone)


def test_nonfinite_on_dense_engine_fails_request(params):
    """A dense engine has no ladder rung left: NaN logits fail the
    request with reason=nonfinite instead of degrading."""
    jeng, teng = _engines(params)
    jeng.submit(_requests(JRequest, 1)[0])
    teng.submit(_requests(Request, 1)[0])
    jdone, tdone, _, _ = _run_both(jeng, teng, dict(nan_decode_at=(0,)))
    assert tdone[0].status == "failed" and "nonfinite" in tdone[0].error
    assert _counters(get_metrics())["serve.degraded_total"]["value"] == 0
    _same_outcomes(jdone, tdone)


# -- admission backpressure -------------------------------------------------

def test_admission_reject(params):
    jeng, teng = _engines(params, max_queue=2, overflow="reject")
    for eng, make in ((jeng, JRequest), (teng, Request)):
        reqs = _requests(make, 3)
        assert eng.submit(reqs[0]) and eng.submit(reqs[1])
        assert not eng.submit(reqs[2])
        assert reqs[2].status == "rejected" and eng.done[2] is reqs[2]
        assert [r.uid for r in eng.queue] == [0, 1]
        assert 2 not in eng._submit_t
    assert teng.done[2].error == jeng.done[2].error
    assert _counters(get_metrics()) == _counters(jget_metrics())


def test_admission_shed_oldest(params):
    jeng, teng = _engines(params, max_queue=2, overflow="shed_oldest")
    for eng, make in ((jeng, JRequest), (teng, Request)):
        reqs = _requests(make, 3)
        for r in reqs:
            assert eng.submit(r)  # the *new* request is always admitted
        assert reqs[0].status == "rejected" and eng.done[0] is reqs[0]
        assert [r.uid for r in eng.queue] == [1, 2]
        assert 0 not in eng._submit_t
    assert teng.done[0].error == jeng.done[0].error
    assert _counters(get_metrics()) == _counters(jget_metrics())


def test_queue_ttl_expires_before_serving(params):
    jeng, teng = _engines(params)
    for eng, make in ((jeng, JRequest), (teng, Request)):
        req = _requests(make, 1)[0]
        req.queue_ttl_s = 0.0
        eng.submit(req)
    time.sleep(0.01)
    jdone, tdone, _, _ = _run_both(jeng, teng)
    assert tdone[0].status == "failed" and "queue_ttl" in tdone[0].error
    assert tdone[0].generated == [] and 0 not in teng._submit_t
    _same_outcomes(jdone, tdone)


def test_decode_deadline_keeps_partial_output(params):
    jeng, teng = _engines(params)
    for eng, make in ((jeng, JRequest), (teng, Request)):
        req = _requests(make, 1, max_new_tokens=8)[0]
        req.deadline_s = 0.0  # expires right after prefill
        eng.submit(req)
    jdone, tdone, _, _ = _run_both(jeng, teng)
    assert tdone[0].status == "failed" and "deadline" in tdone[0].error
    assert len(tdone[0].generated) == 1  # the prefill token survives
    _same_outcomes(jdone, tdone)


# -- retries ----------------------------------------------------------------

def test_transient_failure_retries_with_backoff(params):
    jeng, teng = _engines(params, retry_backoff_s=0.001)
    for eng, make in ((jeng, JRequest), (teng, Request)):
        req = _requests(make, 1)[0]
        req.max_retries = 2
        eng.submit(req)
    jdone, tdone, jplan, tplan = _run_both(
        jeng, teng, dict(transient_decode_at=(0,)))
    assert tplan.injected == jplan.injected == [("transient", 0)]
    assert tdone[0].status == "done" and tdone[0].attempts == 2
    assert len(tdone[0].generated) == 5
    _same_outcomes(jdone, tdone)


def test_transient_failure_without_budget_fails(params):
    jeng, teng = _engines(params)
    jeng.submit(_requests(JRequest, 1)[0])
    teng.submit(_requests(Request, 1)[0])
    jdone, tdone, _, _ = _run_both(jeng, teng,
                                   dict(transient_decode_at=(0,)))
    assert tdone[0].status == "failed" and "transient" in tdone[0].error
    _same_outcomes(jdone, tdone)


# -- engine-init degradation ------------------------------------------------

def test_calibration_failure_degrades_to_weight_only(params, monkeypatch):
    def boom(self, n):
        raise RuntimeError("empty reservoir")
    monkeypatch.setattr(JServeEngine, "_calibrate_activations", boom)
    monkeypatch.setattr(ServeEngine, "_calibrate_activations", boom)
    with pytest.warns(RuntimeWarning, match="degrading"):
        jeng, teng = _engines(params, quantize=True,
                              quantize_activations=True)
    assert not teng.w8a8 and teng.base_level == jeng.base_level == "int8w"
    jeng.submit(_requests(JRequest, 1)[0])
    teng.submit(_requests(Request, 1)[0])
    jdone, tdone, _, _ = _run_both(jeng, teng)
    assert tdone[0].status == "done" and len(tdone[0].generated) == 5
    _same_outcomes(jdone, tdone)


# -- the port's own: a real kernel error never falls back --------------------

def test_real_kernel_error_fails_request_without_fallback(params,
                                                          monkeypatch):
    """A plain ``RuntimeError`` from the kernel launcher (what a CUDA
    error raises) is not re-dispatched even with the fallback on: the
    request fails with that error and gemm.fallback_total stays 0; the
    next request serves."""
    _, teng = _engines(params)
    real = K.ca_gemm_program
    calls = []

    def launcher(*a, **k):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("ca_gemm_program kernel launch failed "
                               "(wgmma route): CUDA error 700")
        return real(*a, **k)

    monkeypatch.setattr(K, "ca_gemm_program", launcher)
    for r in _requests(Request, 2):
        teng.submit(r)
    with gemm_fallback(True):
        done = teng.run()
    assert done[0].status == "failed"
    assert done[0].error == ("RuntimeError: ca_gemm_program kernel launch "
                             "failed (wgmma route): CUDA error 700")
    assert done[1].status == "done" and len(done[1].generated) == 5
    snap = get_metrics().snapshot()
    assert snap.get("gemm.fallback_total", {}).get("value", 0) == 0
    assert snap["serve.requests_failed_total"]["labels"] == {
        "reason=RuntimeError": 1.0}
