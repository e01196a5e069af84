"""The port's examples (``examples/torch_port/``) on the CPU, each held
against its reference script (``examples/*.py``) at the reduced configs.

* quickstart: the tile table and the schedules, on a target built from
  the reference's V5E fields, equal the reference functions' values
  (tiles exact, bytes at rel 1e-12); the port's ``ca_mmm_any`` equals the
  reference's ``ca_mmm_any(..., interpret=True)`` at rtol/atol 1e-4.
* serve_lm: from the reference's weights (``params_from_jax``) the greedy
  tokens of ``none``, ``int8`` and ``w8a8`` and every line's quant note
  equal what the reference script prints; under ``--chaos`` the
  per-request statuses, the degraded quant level and ``plan.injected``
  too.  The sampled request gets a length and range check only: the port
  does not reproduce ``jax.random``.
* train_lm: the crashed-and-resumed run's losses are bit-equal to an
  uninterrupted run's, and the script's last line parses.
* distributed_gemm: 8 gloo ranks, one spawn: both schedules correct on
  every rank, and the bytes their transfers moved equal the cost
  model's plan (the reference's ``estimate_cost``).
"""

import ast
import contextlib
import dataclasses
import importlib
import importlib.util
import io
import pathlib
import re
import sys

import jax
import numpy as np
import pytest
import torch

from _torch_isolation import isolated_port_state  # noqa: F401  (autouse)
from repro.configs import get_config as jax_config
from repro.configs import get_reduced as jax_reduced
from repro.core import distributed as jdist
from repro.core import gemm_fallback as jgemm_fallback
from repro.core import io_model as jio
from repro.core.hardware import V5E
from repro.models import model as JM
from repro_torch.configs import get_reduced
from repro_torch.core.gemm import gemm_fallback
from repro_torch.models import model as TM
from test_torch_io_model import tpu_target

REPO = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = REPO / "examples"
# Spawned ranks re-import ``torch_port.distributed_gemm`` by name: the
# spawn start method hands them this process's sys.path.
if str(EXAMPLES) not in sys.path:
    sys.path.insert(0, str(EXAMPLES))

NAMES = ("quickstart", "serve_lm", "train_lm", "distributed_gemm")
# The port's target holding the reference's V5E fields, links included.
TPU = dataclasses.replace(tpu_target(), ici_bandwidth=V5E.ici_bandwidth,
                          dcn_bandwidth=V5E.dcn_bandwidth)


def port(name):
    return importlib.import_module(f"torch_port.{name}")


def reference(name):
    """The reference's script ``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def stdout_of(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue()


@pytest.mark.parametrize("name", NAMES)
def test_example_needs_the_card_unless_told_cpu(name):
    """The card is the default: without CUDA, ``main`` raises before it
    serves, trains or spawns anything."""
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port(name).main([])


# -- quickstart --------------------------------------------------------------

@pytest.mark.parametrize("row", range(3), ids=["bfloat16", "float32", "int8"])
def test_quickstart_tile_table_matches_reference(row):
    dt, t, q, lb, ai = port("quickstart").tile_table(TPU)[row]
    jdt = jax.numpy.dtype(str(dt).removeprefix("torch."))
    m = n = k = 16384
    jt = jio.solve_tile_config(m, n, k, dtype_in=jdt)
    assert (t.bm, t.bn, t.bk, t.vmem_bytes) == (jt.bm, jt.bn, jt.bk,
                                                jt.vmem_bytes)
    want_q = jio.io_volume_elements(m, n, k, jt.bm, jt.bn) * jdt.itemsize
    want_lb = jio.io_lower_bound_elements(
        m, n, k, int(0.75 * V5E.vmem_bytes) // 4) * jdt.itemsize
    want_ai = jio.arithmetic_intensity_ops_per_byte(jt.bm, jt.bn,
                                                    jdt.itemsize)
    assert q == pytest.approx(want_q, rel=1e-12, abs=0.0)
    assert lb == pytest.approx(want_lb, rel=1e-12, abs=0.0)
    assert ai == pytest.approx(want_ai, rel=1e-12, abs=0.0)


def test_quickstart_schedules_match_reference():
    got = port("quickstart").schedules(TPU)
    assert [mesh for mesh, _ in got] == [(16, 16, 1), (4, 64, 1), (16, 16, 2)]
    for (dp, tp, pods), c in got:
        want = jdist.choose_schedule(16384, 16384, 16384, 2, dp, tp, pods,
                                     V5E)
        assert c.schedule == want.schedule
        for f in ("comm_bytes", "time_s"):
            assert getattr(c, f) == pytest.approx(getattr(want, f),
                                                  rel=1e-12, abs=0.0), f


def test_quickstart_gemm_matches_reference_kernel():
    from repro.kernels import ca_mmm_any as jca_mmm_any
    from repro_torch.kernels.ops import ca_mmm_any

    rng = np.random.RandomState(0)
    a = rng.randn(512, 384).astype(np.float32)
    b = rng.randn(384, 256).astype(np.float32)
    want = np.asarray(jca_mmm_any(jax.numpy.asarray(a), jax.numpy.asarray(b),
                                  interpret=True))
    got = ca_mmm_any(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    err, route = port("quickstart").gemm_check("cpu")
    assert route == "plain"
    assert err == pytest.approx(float(np.abs(a.astype(np.float64)
                                             @ b.astype(np.float64)
                                             - got).max()), rel=1e-6)
    assert err < 1e-3


def test_quickstart_prints_the_reference_lines():
    """Line for line the reference's output: the same line count and
    each line's leading words, the card's constants in the numbers."""
    _, got = stdout_of(port("quickstart").main, ["--device", "cpu"])
    _, want = stdout_of(reference("quickstart").main)
    got, want = got.splitlines(), want.splitlines()
    assert len(got) == len(want) == 10
    lead = lambda line: line.split()[:2] if line.startswith(" ") \
        else line.split()[:1]  # noqa: E731
    assert [lead(g) for g in got if "CA-MMM" not in g] == \
        [lead(w) for w in want if "CA-MMM" not in w]
    assert "fast=" in got[0] and "VMEM=" not in got[0]
    assert re.search(r"K1 route: plain\) vs float64 host product: "
                     r"max\|err\| = \S+$", got[4])


# -- serve_lm ----------------------------------------------------------------

ARCHS = ["stablelm-1.6b", "mamba2-370m", "zamba2-7b"]
_GREEDY = re.compile(r"^(\S+)\s+greedy=(\[.*?\]) sampled=(\[.*?\])(.*)$")
_CHAOS = re.compile(r"^(\S+)\s+chaos: (.*?) injected=(\[.*?\])(.*)$")


def _reference_lines(argv):
    """What the reference's serve script prints, by arch."""
    _, out = stdout_of(reference("serve_lm").main, argv)
    return {line.split()[0]: line for line in out.splitlines()
            if line and not line.startswith(("#", "-"))}


def _reference_weights(arch):
    jp = JM.init_params(jax_reduced(arch), jax.random.PRNGKey(0))
    return TM.params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                              get_reduced(arch), device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("quantize", ["none", "int8", "w8a8"])
def test_serve_lm_greedy_tokens_match_reference(quantize, arch):
    want = _GREEDY.match(_reference_lines(
        ["--quantize", quantize, "--archs", arch])[arch])
    res, _ = stdout_of(port("serve_lm").serve_arch, arch,
                       _reference_weights(arch), quantize=quantize,
                       device="cpu")
    got = _GREEDY.match(res["line"])
    done = res["done"]
    assert [done[u].status for u in (0, 1)] == ["done", "done"]
    assert done[0].generated == ast.literal_eval(want.group(2))
    assert got.group(4) == want.group(4)        # the quant note
    sampled = done[1].generated
    V = get_reduced(arch).vocab_size
    assert len(sampled) == 6 and all(0 <= t < V for t in sampled)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_lm_chaos_matches_reference(arch):
    """The reference script's ``--chaos --quantize int8`` statuses,
    degraded levels, injections and note, with the GEMM fallback on in
    both packages as it is outside the test suite."""
    with jgemm_fallback(True):
        want = _CHAOS.match(_reference_lines(
            ["--chaos", "--quantize", "int8", "--archs", arch])[arch])
    with gemm_fallback(True):
        res, _ = stdout_of(port("serve_lm").serve_arch, arch,
                           _reference_weights(arch), quantize="int8",
                           chaos=True, device="cpu")
    got = _CHAOS.match(res["line"])
    assert got.group(2) == want.group(2)
    assert got.group(2) == ("req0=failed req1=degraded(int8w) "
                            "req2=degraded(dense) req3=done")
    assert sorted(res["plan"].injected) == ast.literal_eval(want.group(3))
    assert got.group(4) == want.group(4)


# -- train_lm ----------------------------------------------------------------

@pytest.mark.parametrize("scale", ["25m", "100m"])
def test_train_lm_config_matches_reference(scale):
    """The example's config: the reference script's fields on both
    packages' stablelm-1.6b, the same parameter count."""
    cfg = port("train_lm").example_config(scale)
    fields = dict(n_layers=cfg.n_layers, d_model=cfg.d_model,
                  n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                  d_ff=cfg.d_ff, vocab_size=cfg.vocab_size,
                  compute_dtype="float32", q_chunk=cfg.q_chunk,
                  kv_chunk=cfg.kv_chunk)
    want = dict(n_layers=8, d_model=384, n_heads=6, n_kv_heads=6, d_ff=1024,
                vocab_size=16384, q_chunk=64, kv_chunk=64) \
        if scale == "25m" else dict(n_layers=12, d_model=768, n_heads=12,
                                    n_kv_heads=12, d_ff=2048,
                                    vocab_size=32000, q_chunk=64,
                                    kv_chunk=128)
    assert {k: fields[k] for k in want} == want
    jcfg = dataclasses.replace(jax_config("stablelm-1.6b"), **fields)
    assert cfg.n_params() == jcfg.n_params()
    assert cfg.compute_dtype == "float32"


def test_train_lm_resume_is_bit_equal_to_uninterrupted(monkeypatch):
    """A 4-step run crashes after step 2 (checkpoints at steps 0 and 1),
    resumes from step 1's checkpoint and finishes: steps 2 and 3 lose
    exactly what an uninterrupted run's do."""
    import repro_torch.configs as C
    from repro_torch.launch.train import run_training

    mod = port("train_lm")
    monkeypatch.setattr(C, "_MODULES", dict(C._MODULES))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # one reduction order for both runs
    try:
        kw = dict(seq_len=16, global_batch=2)
        losses, out = stdout_of(mod.main, [
            "--device", "cpu", "--steps", "4", "--seq-len", "16",
            "--global-batch", "2"])
        _, want = run_training("stablelm-25m", 4, lr=1e-3, device="cpu",
                               log_every=25, **kw)
    finally:
        torch.set_num_threads(threads)
    lines = out.splitlines()
    assert lines[0] == "training stablelm-25m: 27M params, 4 steps @ " \
                       "seq=16 batch=2"
    assert "!! injected failure at step 2 — restarting from last " \
           "checkpoint" in lines
    assert "resumed from checkpoint at step 2" in lines
    assert losses == want[2:]
    last = re.fullmatch(r"loss: (\S+) -> (\S+) \((DECREASED|no decrease)\)",
                        lines[-1])
    assert last is not None, lines[-1]
    assert float(last.group(1)) == pytest.approx(losses[0], abs=5e-4)
    assert float(last.group(2)) == pytest.approx(losses[-1], abs=5e-4)
    assert (last.group(3) == "DECREASED") == (losses[-1] < losses[0])


# -- distributed_gemm --------------------------------------------------------

@pytest.fixture(scope="module")
def dist_runs():
    """The script's 8 gloo ranks, spawned once."""
    return port("distributed_gemm").run("cpu")


@pytest.mark.parametrize("sched", ["allgather", "ring"])
def test_distributed_gemm_is_correct_on_every_rank(dist_runs, sched):
    assert len(dist_runs) == 8
    for rank, out in enumerate(dist_runs):
        assert out[sched]["correct"], (rank, out[sched]["max_abs_err"])
        assert out[sched]["k1_launches"] == 0      # the CPU's plain path


@pytest.mark.parametrize("sched", ["allgather", "ring"])
def test_distributed_gemm_wire_bytes_equal_the_plan(dist_runs, sched):
    """Each rank's counted bytes equal the port's and the reference's
    ``estimate_cost`` on the (data 2, model 4) mesh, which has no pod
    axis: the gather receives 3 of the 4 A panels, the ring sends 3
    hops."""
    from repro_torch.core.distributed import estimate_cost

    plan = estimate_cost(sched, 256, 384, 512, 4, 2, 4).comm_bytes
    assert plan == jdist.estimate_cost(sched, 256, 384, 512, 4, 2,
                                       4).comm_bytes
    kind = "gather" if sched == "allgather" else "hop"
    for out in dist_runs:
        assert out[sched]["wire_traffic"] == plan
        assert out[sched]["wire_bytes"] == {
            "hop": 0, "gather": 0, "all_reduce": 0, kind: int(plan)}


def test_distributed_gemm_prints_one_line_a_schedule(dist_runs, monkeypatch):
    mod = port("distributed_gemm")
    monkeypatch.setattr(mod, "run", lambda device: dist_runs)
    _, out = stdout_of(mod.main, ["--device", "cpu"])
    lines = out.splitlines()
    assert lines[0] == "# 8 gloo ranks on the CPU"
    assert [line.split()[:2] for line in lines[1:]] == [
        ["allgather", "correct=True"], ["ring", "correct=True"]]
    for line in lines[1:]:
        assert re.search(r"wire_traffic=1\.97e\+05  \(model 1\.97e\+05\)$",
                         line), line
