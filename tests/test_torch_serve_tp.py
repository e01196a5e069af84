"""The port's tensor-parallel serve path against the reference's.

The reference's TP decode block (``repro.serve.tp``, 8 forced host
devices, a subprocess) runs dense and int8w over 3 steps with its KV
history and w8a8-ride for one, from its own params; the port (8 gloo
ranks) runs the same from those params on the ring and on allgather and
is held against it at the reference's ``_tp_check`` limits (max error
below 1e-3 dense, 5e-3 int8w / w8a8-ride), as against its own
single-process oracle.  Also: the port's ``_tp_check`` command, and
``ServeEngine(tp_local=...)`` warming the ring-step local shapes that the
reference engine warms."""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_dist_cases as C
from _torch_isolation import isolated_port_state  # noqa: F401  (autouse)
from repro_torch.launch.mesh import spawn_ranks

REPO = pathlib.Path(__file__).resolve().parents[1]
LIMIT = {"dense": 1e-3, "int8w": 5e-3, "w8a8": 5e-3}
RUNS = [(sched, label, t) for sched in C.TP_SCHEDULES
        for label, steps in (("dense", C.TP_T), ("int8w", C.TP_T),
                             ("w8a8", 1)) for t in range(steps)]


def _env():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    path = tmp_path_factory.mktemp("tp") / "ref_tp.npz"
    out = subprocess.run(
        [sys.executable, str(REPO / "tests" / "_torch_dist_cases.py"),
         str(path), "tp"], env=_env(), capture_output=True, text=True,
        timeout=180)
    assert out.returncode == 0, out.stdout + out.stderr
    port = spawn_ranks(C.port_tp_ranks, 8, (str(path),), timeout=180)
    return dict(np.load(path)), port


@pytest.mark.parametrize("run", RUNS, ids=lambda r: f"{r[0]}-{r[1]}-y{r[2]}")
def test_tp_decode_step_matches_the_reference(runs, run):
    ref, port = runs
    sched, label, t = run
    want = ref[f"tp {label} y{t}"]
    got = port[0][f"{sched} tp {label} y{t}"]
    for other in port[1:]:
        np.testing.assert_array_equal(other[f"{sched} tp {label} y{t}"],
                                      got)
    assert got.shape == want.shape == (C.TP_B, C.TP_DIMS["d_model"])
    assert np.abs(got - want).max() < LIMIT[label]
    oracle = port[0][f"{sched} tp {label} oracle y{t}"]
    assert np.abs(got - oracle).max() < LIMIT[label]


@pytest.mark.parametrize("sched", C.TP_SCHEDULES)
@pytest.mark.parametrize("label", ["dense", "int8w", "w8a8"])
def test_tp_kv_history_matches_the_reference(runs, sched, label):
    ref, port = runs
    steps = C.TP_T if label != "w8a8" else 1
    d, h = C.TP_DIMS["d_model"], C.TP_DIMS["n_heads"]
    assert port[0][f"{sched} tp {label} k shape"] == (C.TP_B, steps, h,
                                                      d // h)
    np.testing.assert_allclose(port[0][f"{sched} tp {label} k"],
                               ref[f"tp {label} k"], atol=LIMIT[label],
                               rtol=0)


def test_tp_check_cli():
    """``python -m repro_torch.serve._tp_check 8``: only OK lines, the
    reference's load-bearing checks by name."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.serve._tp_check", "8"],
        capture_output=True, text=True, env=_env(), timeout=180)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = [ln for ln in out.stdout.splitlines()
             if ln.startswith(("OK", "FAIL"))]
    assert len(lines) >= 8 and all(ln.startswith("OK") for ln in lines), \
        out.stdout
    for want in ("dense parity", "int8w parity", "w8a8-ride parity",
                 "ledger planned bytes"):
        assert any(want in ln for ln in lines), (want, out.stdout)


def test_tp_params_from_jax_checks_keys_and_shapes():
    from repro_torch.serve import tp

    cfg = tp.TpDecodeConfig(**C.TP_DIMS)
    defs = tp.tp_decode_defs(cfg)
    good = {k: np.zeros(d.shape, np.float32) for k, d in defs.items()}
    params = tp.tp_params_from_jax(good, cfg, device="cpu")
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        k: d.shape for k, d in defs.items()}
    with pytest.raises(ValueError, match="keys differ"):
        tp.tp_params_from_jax({"attn/wq": good["attn/wq"]}, cfg,
                              device="cpu")
    bad = dict(good, **{"attn/wq": np.zeros((3, 3), np.float32)})
    with pytest.raises(ValueError, match="attn/wq"):
        tp.tp_params_from_jax(bad, cfg, device="cpu")


def test_tp_reference_records_calibration_sites():
    """Inside an ActivationCalibration the oracle records each quantized
    projection's input by site, so the w8a8 block's act scales come from
    its own run: q/k/v/o share one site, gate/up take the MLP norm's
    output and w_down the GLU's, each scale max|input| / 127."""
    import torch

    from repro_torch.quant.calibrate import ActivationCalibration, QuantConfig
    from repro_torch.quant.scales import quantize
    from repro_torch.serve import tp

    cfg = tp.TpDecodeConfig(**C.TP_DIMS)
    params = tp.init_tp_params(cfg, seed=0, device="cpu")
    qparams = {k: (quantize(v, axis=-2, block=0) if v.dim() == 2 else v)
               for k, v in params.items()}
    x = torch.from_numpy(C.inputs()[4][0])
    y0, _ = tp.tp_decode_reference(qparams, x, None, cfg)
    with ActivationCalibration(QuantConfig(act_fmt="int8")) as cal:
        y1, _ = tp.tp_decode_reference(qparams, x, None, cfg)
    torch.testing.assert_close(y1, y0, rtol=0, atol=0)
    d, f = cfg.d_model, cfg.d_ff
    assert sorted(cal.calibrators) == sorted(
        {f"k{d}n{d}", f"k{d}n{f}", f"k{f}n{d}"})
    assert cal.calibrators[f"k{d}n{d}"].n_observed == 4
    assert cal.calibrators[f"k{d}n{f}"].n_observed == 2
    assert cal.calibrators[f"k{f}n{d}"].n_observed == 1
    for s in cal.scales().values():
        assert float(s) > 0
    # Outside the context nothing is recorded.
    tp.tp_decode_reference(qparams, x, None, cfg)
    assert sorted(c.n_observed for c in cal.calibrators.values()) \
        == [1, 2, 4]


def test_engine_tp_local_warmup_matches_the_reference():
    """tp_local=(dp, tp) warms the ring-step local shapes on top of the
    global ones: every key the reference engine warms (past the target
    name), each local workload's key among them."""
    from repro.configs import get_reduced as jreduced
    from repro.models import model as JM
    from repro.serve.engine import ServeEngine as JServeEngine
    from repro_torch.configs import get_reduced
    from repro_torch.models import model as TM
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.tuning import (cache_key, model_gemm_workloads,
                                    shard_gemm_workloads)

    cfg = get_reduced("stablelm-1.6b")
    jeng = JServeEngine(JM.init_params(jreduced("stablelm-1.6b"),
                                       jax.random.PRNGKey(0)),
                        jreduced("stablelm-1.6b"), batch_size=2,
                        max_len=8, tp_local=(2, 4))
    eng = ServeEngine(TM.init_params(cfg, seed=0, device="cpu"), cfg,
                      batch_size=2, max_len=8, tp_local=(2, 4),
                      device="cpu")
    strip = lambda keys: sorted(k.split("/", 1)[1] for k in keys)  # noqa: E731
    assert strip(eng.gemm_plan_sources) == strip(jeng.gemm_plan_sources)
    local = shard_gemm_workloads(model_gemm_workloads(cfg, 2), 2, 4)
    assert local
    dtype = str(cfg.dtype()).removeprefix("torch.")
    for (m, n, k, tag, lay) in local:
        key = cache_key(m, n, k, dtype, epilogue=tag, layout=lay)
        assert key in eng.gemm_plan_sources, key
    plain = ServeEngine(TM.init_params(cfg, seed=0, device="cpu"), cfg,
                        batch_size=2, max_len=8, device="cpu")
    assert set(plain.gemm_plan_sources) < set(eng.gemm_plan_sources)
    assert jnp.dtype(jreduced("stablelm-1.6b").dtype()).name == dtype
