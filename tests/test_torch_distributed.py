"""The port's distributed GEMM against the reference's.

The cost model on a target built from the reference's V5E fields (its ICI
and DCN rates included) reproduces every field of the reference's
``estimate_cost`` at rel 1e-12, and the reference's own property tests
(``tests/test_distributed.py``) hold on the port's H100 target.
``dist_matmul`` at every schedule on the 2-D and 3-D meshes, ragged m,
``out_dtype``, int8w and w8a8-ride (scale blocks 0 and 16) runs once as
8 gloo ranks and is held against the reference's own ``dist_matmul`` (a
subprocess with 8 forced host devices) on the same numpy inputs: the
float cases at the reference's ``_dist_check`` tolerance (atol 1e-3, rtol
1e-4), the int8 ones at its 5e-3 / 1e-3.  The same ranks run the fault
cases; a real error on one rank fails the run without hanging."""

import dataclasses
import os
import pathlib
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_cases as C
from _torch_isolation import isolated_port_state  # noqa: F401  (autouse)
from repro.core import distributed as jdist
from repro.core.hardware import V5E
from repro.core.io_model import TileConfig as JTile
from repro.obs.ledger import GemmLedger as JLedger
from repro.tuning import workload as jwork
from repro_torch.core import distributed as tdist
from repro_torch.core.io_model import TileConfig as TTile
from repro_torch.launch.mesh import RankError, spawn_ranks
from repro_torch.obs.ledger import GemmLedger
from repro_torch.tuning import shard_gemm_workloads
from test_torch_io_model import tpu_target

REPO = pathlib.Path(__file__).resolve().parents[1]
# The port's target holding the reference's V5E fields, links included.
TPU = dataclasses.replace(tpu_target(), ici_bandwidth=V5E.ici_bandwidth,
                          dcn_bandwidth=V5E.dcn_bandwidth)
FIELDS = ("schedule", "compute_s", "comm_bytes", "comm_s", "overlapped",
          "steps", "step_compute_s", "step_comm_s", "reduce_s", "time_s")


def _same(got, want):
    for f in FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        if isinstance(w, float):
            assert g == pytest.approx(w, rel=1e-12, abs=0.0), f
        else:
            assert g == w, f


COST_SHAPES = [(16384, 16384, 16384, 2, 16, 16, 1),
               (16384, 16384, 16384, 2, 16, 16, 2),
               (8192, 8192, 8192, 2, 16, 2, 1),
               (8192, 8192, 8192, 2, 2, 16, 1),
               (256, 512, 512, 4, 2, 4, 1),
               (37, 512, 512, 1, 2, 4, 2),
               (8, 5632, 2048, 2, 2, 4, 2)]


@pytest.mark.parametrize("shape", COST_SHAPES, ids=str)
@pytest.mark.parametrize("schedule", jdist.SCHEDULES)
def test_cost_model_matches_the_reference(schedule, shape):
    m, n, k, size, dp, tp, pods = shape
    for dt, tdt in ((jnp.bfloat16, torch.bfloat16),
                    (jnp.float32, torch.float32)):
        _same(tdist.estimate_cost(schedule, m, n, k, size, dp, tp, pods,
                                  TPU, tdt),
              jdist.estimate_cost(schedule, m, n, k, size, dp, tp, pods,
                                  V5E, dt))
    # with a tile and the int8 composite dtypes (the w8a8 ride)
    for jb, ja, tb, ta in ((jnp.int8, None, torch.int8, None),
                           (jnp.int8, jnp.int8, torch.int8, torch.int8)):
        _same(tdist.estimate_cost(schedule, m, n, k, size, dp, tp, pods,
                                  TPU, torch.bfloat16,
                                  tile=TTile(128, 256, 512), dtype_b=tb,
                                  dtype_a=ta),
              jdist.estimate_cost(schedule, m, n, k, size, dp, tp, pods,
                                  V5E, jnp.bfloat16,
                                  tile=JTile(128, 256, 512), dtype_b=jb,
                                  dtype_a=ja))
    assert tdist.dist_local_shapes(
        schedule, m, n, k, dp, tp, pods) == jdist.dist_local_shapes(
        schedule, m, n, k, dp, tp, pods)


@pytest.mark.parametrize("shape", COST_SHAPES, ids=str)
def test_choose_schedule_matches_the_reference(shape):
    m, n, k, size, dp, tp, pods = shape
    _same(tdist.choose_schedule(m, n, k, size, dp, tp, pods, TPU,
                                torch.bfloat16),
          jdist.choose_schedule(m, n, k, size, dp, tp, pods, V5E,
                                jnp.bfloat16))
    _same(tdist.choose_schedule(m, n, k, size, dp, tp, pods, TPU,
                                torch.float32, use_registry=True),
          jdist.choose_schedule(m, n, k, size, dp, tp, pods, V5E,
                                jnp.float32, use_registry=True))


def test_cost_model_properties():
    """The reference's properties, on the port's H100 target."""
    r = tdist.estimate_cost("ring", 16384, 16384, 16384, 2, 16, 16)
    g = tdist.estimate_cost("allgather", 16384, 16384, 16384, 2, 16, 16)
    assert abs(r.comm_bytes - g.comm_bytes) < 1e-6
    assert r.time_s <= g.time_s
    c1 = tdist.estimate_cost("summa25d", 16384, 16384, 16384, 2, 16, 16,
                             pods=2)
    assert c1.comm_bytes < 2 * g.comm_bytes
    best = tdist.choose_schedule(16384, 16384, 16384, 2, 16, 16, pods=2)
    for s in ("allgather", "ring", "summa25d"):
        assert best.time_s <= tdist.estimate_cost(
            s, 16384, 16384, 16384, 2, 16, 16, pods=2).time_s + 1e-12
    assert tdist.estimate_cost("ring", 8192, 8192, 8192, 2, dp=16,
                               tp=2).comm_bytes != tdist.estimate_cost(
        "ring", 8192, 8192, 8192, 2, dp=2, tp=16).comm_bytes


def test_cost_model_pipelining():
    m = n = k = 16384
    g = 16
    r = tdist.estimate_cost("ring", m, n, k, 2, 16, g)
    u = tdist.estimate_cost("ring_unpipelined", m, n, k, 2, 16, g)
    assert r.steps == u.steps == g
    assert abs(r.comm_bytes / u.comm_bytes - (g - 1) / g) < 1e-12
    assert r.overlapped and not u.overlapped
    want_r = r.step_compute_s + (g - 1) * max(r.step_compute_s,
                                              r.step_comm_s)
    assert abs(r.time_s - want_r) < 1e-15
    assert abs(u.time_s - (g * u.step_compute_s + u.comm_s)) < 1e-15
    assert r.time_s < u.time_s
    cb = tdist.estimate_cost("ring", m, 1 << 22, k, 2, 16, g)
    assert cb.step_comm_s < cb.step_compute_s
    assert abs(cb.time_s - cb.steps * cb.step_compute_s) < 1e-12
    one = tdist.estimate_cost("ring", m, n, k, 2, 16, 1)
    assert one.steps == 1 and one.comm_bytes == 0


def test_local_resolution_key_matches_the_reference():
    for sched, dtb, dta in (("ring", None, None), ("ring", "int8", "int8"),
                            ("ring", "int8", None),
                            ("allgather", None, None)):
        res, tag, loc = tdist.dist_local_resolution(
            sched, 256, 512, 512, dp=2, tp=4, dtype=torch.float32, hw=TPU,
            dtype_b=dtb and torch.int8, dtype_a=dta and torch.int8)
        jres, jtag, jloc = jdist.dist_local_resolution(
            sched, 256, 512, 512, dp=2, tp=4, dtype=jnp.float32,
            dtype_b=dtb and jnp.int8, dtype_a=dta and jnp.int8)
        assert (loc, tag, res.key) == (jloc, jtag, jres.key)
        assert (res.config.bm, res.config.bn, res.config.bk) == (
            jres.config.bm, jres.config.bn, jres.config.bk)
    res, tag, loc = tdist.dist_local_resolution(
        "ring", 256, 512, 512, dp=2, tp=4, dtype=torch.float32)
    assert loc == (128, 128, 128, 4) and tag == "none"
    assert res.key == "h100/float32/plus_times/none/nn/m128n128k128"


def test_dist_ledger_record_matches_the_reference():
    kw = dict(schedule="ring", m=256, n=512, k=512, dp=2, tp=4, steps=4,
              mode="plain", tag="dqab",
              planned_bytes=tdist.estimate_cost("ring", 256, 512, 512, 1, 2,
                                                4).comm_bytes,
              planned_flops=2.0 * 256 * 512 * 512,
              config={"bm": 128, "bn": 128, "bk": 128})
    led, jled = GemmLedger(enabled=True), JLedger(enabled=True)
    (rec,) = [led.record_dist(dtype=torch.bfloat16, dtype_b=torch.int8,
                              dtype_a=torch.int8, **kw)]
    (jrec,) = [jled.record_dist(dtype=jnp.bfloat16, dtype_b=jnp.int8,
                                dtype_a=jnp.int8, **kw)]
    assert rec.to_dict() == jrec.to_dict()
    assert rec.key == "dist.ring|dqab|int8w_int8a|256x512x512|dp2.tp4"
    assert rec.planned_bytes == jdist.estimate_cost(
        "ring", 256, 512, 512, 1, 2, 4).comm_bytes
    off = GemmLedger(enabled=False)
    assert off.record_dist(dtype=torch.float32, **kw) is None


def test_shard_gemm_workloads_matches_the_reference():
    loads = [(37, 512, 512, "none", "nn"),
             (37, 512, 512, "res", "nn", "int8"),
             (37, 90, 512, "none", "nn")]
    assert shard_gemm_workloads(loads, 2, 4) == jwork.shard_gemm_workloads(
        loads, 2, 4) == [(19, 128, 128, "none", "nn"),
                         (19, 128, 128, "res", "nn", "int8")]
    assert shard_gemm_workloads([(64, 512, 512, "none", "nn")], 2, 4,
                                pods=2) == [(32, 128, 64, "none", "nn")]
    from repro.configs import get_reduced as jreduced
    from repro_torch.configs import get_reduced
    from repro_torch.tuning import model_gemm_workloads, quantize_workloads

    for acts in (False, True):
        tl = quantize_workloads(model_gemm_workloads(
            get_reduced("stablelm-1.6b"), 8), acts=acts)
        jl = jwork.quantize_workloads(jwork.model_gemm_workloads(
            jreduced("stablelm-1.6b"), 8), acts=acts)
        assert shard_gemm_workloads(tl, 2, 4) == \
            jwork.shard_gemm_workloads(jl, 2, 4)


def test_unknown_schedule_raises_dist004():
    from repro_torch.analyze.diagnostics import ProgramValidationError

    with pytest.raises(ProgramValidationError) as e:
        tdist.dist_matmul(torch.ones(2, 2), torch.ones(2, 2), None,
                          schedule="tree")
    assert e.value.codes == ("DIST004",)


# ---------------------------------------------------------------------------
# The port on 8 gloo ranks against the reference's dist_matmul
# ---------------------------------------------------------------------------

def _env():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides at once: the reference's cases in a subprocess while
    the port runs them (and its fault cases) on 8 ranks."""
    path = tmp_path_factory.mktemp("dist") / "ref_dm.npz"
    proc = subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "_torch_dist_cases.py"),
         str(path), "dm"], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        port = spawn_ranks(C.port_dm_ranks, 8, timeout=180)
        log, _ = proc.communicate(timeout=180)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, log
    return dict(np.load(path)), port


@pytest.mark.parametrize("case", C.CASES, ids=C.case_name)
def test_dist_matmul_matches_the_reference(runs, case):
    ref, port = runs
    key = "dm " + C.case_name(case)
    want = ref[key]
    got = port[0][key]
    for other in port[1:]:
        np.testing.assert_array_equal(other[key], got)
    _mesh, _sched, _rows, quant, od = case
    if quant:
        tol = dict(atol=5e-3, rtol=1e-3)
    elif od == "bfloat16":
        # both round a float32 product to bf16: one ulp apart at most
        tol = dict(atol=1e-3, rtol=2 ** -7)
    else:
        tol = dict(atol=1e-3, rtol=1e-4)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **tol)
    assert port[0]["dtype " + C.case_name(case)] == (
        "torch.bfloat16" if od == "bfloat16" else "torch.float32")


@pytest.mark.parametrize("case", C.CASES, ids=C.case_name)
def test_wire_bytes_equal_the_planned_bytes(runs, case):
    """The bytes each dispatch's own transfers moved (counted by the
    transport on every rank) against the ledger's planned bytes.  On the
    3-D mesh (pods 2, fp32) the reference's cost model charges the pod
    axis only for summa25d: allgather also gathers the panel over pod
    ((pods - 1) / pods of an (m/dp, k) panel more), and ring and
    ring_unpipelined also all-reduce C over pod (2 (pods - 1) / pods of
    the (m/dp, n/tp) fp32 block more), as both sides run them."""
    mesh, _sched, _rows, _quant, _od = case
    pods = 2
    for out in runs[1]:
        w = out["wire " + C.case_name(case)]
        extra = 0.0
        if mesh == "3d" and w["schedule"] == "allgather":
            extra = (pods - 1) * w["mloc"] * (w["k"] // pods) * 4
        elif mesh == "3d" and w["schedule"] != "summa25d":
            extra = 2 * (pods - 1) / pods * w["mloc"] * w["nloc"] * 4
        assert w["sent"] > 0
        assert w["sent"] == w["planned"] + extra


def test_quantized_payloads_match_the_reference(runs):
    ref, port = runs
    for block in (0, 16):
        np.testing.assert_array_equal(port[0][f"qdata{block}"],
                                      ref[f"qdata{block}"])


def test_injected_failure_redispatches_the_same_schedule_on_every_rank(runs):
    for out in runs[1]:
        assert out["fault redispatch equal"]
        assert out["fault injected"] == [["kernel", 1]]
        assert out["fault fallbacks"] == 1
        assert out["after faults equal"]


def test_injected_failure_propagates_when_the_policy_is_off(runs):
    for out in runs[1]:
        assert out["fault policy off raises"]
        assert out["fault fatal raises"]


def test_geometry_errors_raise_dist004(runs):
    for out in runs[1]:
        assert out["geometry codes"] == [["DIST004"]] * 3


def test_a_real_error_on_one_rank_fails_every_rank():
    t0 = time.perf_counter()
    with pytest.raises(RankError) as e:
        spawn_ranks(C.bad_rank, 4, timeout=120)
    assert e.value.rank == 2
    assert "does not contract" in e.value.trace
    assert time.perf_counter() - t0 < 60


def test_a_rank_past_the_timeout_ends_the_run():
    t0 = time.perf_counter()
    with pytest.raises(TimeoutError):
        spawn_ranks(C.slow_rank, 2, (60,), timeout=5)
    assert time.perf_counter() - t0 < 30


def test_dist_check_cli():
    """``python -m repro_torch.core._dist_check 8``: only OK lines, the
    reference's load-bearing checks by name."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.core._dist_check", "8"],
        capture_output=True, text=True, env=_env(), timeout=180)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = [ln for ln in out.stdout.splitlines()
             if ln.startswith(("OK", "FAIL"))]
    assert len(lines) >= 27 and all(ln.startswith("OK") for ln in lines), \
        out.stdout
    for want in ("ring_unpipelined 2d", "summa25d 3d", "ragged-m37",
                 "w8a8-ride", "ledger dist records",
                 "ring plain-local-step"):
        assert any(want in ln for ln in lines), (want, out.stdout)
