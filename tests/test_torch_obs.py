"""The port's observability layer against the reference's: metrics math,
the trace's JSONL round trip and shared no-op span, the GEMM ledger's
planned bytes (against the reference's ``planned_gemm_bytes`` and the I/O
model), the expert loop's folded calls, step replay, one decode step's
planned bytes split into weight bytes and the rest on every reduced
config, and the serve engine end to end beside the reference engine."""

import collections
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_isolation import isolated_port_state  # noqa: F401  (autouse)
from repro.configs import get_reduced as jax_reduced
from repro.core import gemm as jgemm
from repro.core.io_model import TileConfig as JTile
from repro.models import model as JM
from repro.obs import enable_ledger as jax_enable_ledger
from repro.obs import ledger as jledger
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import obs
from repro_torch.configs import get_reduced, list_archs
from repro_torch.core import gemm as tgemm
from repro_torch.core.hardware import H100
from repro_torch.core.io_model import (TileConfig, epilogue_q_elements,
                                       io_volume_bytes, io_volume_elements,
                                       io_volume_elements_program)
from repro_torch.kernels.epilogue import Epilogue
from repro_torch.kernels.program import program_cost
from repro_torch.models import model as TM
from repro_torch.obs import trace as trace_mod
from repro_torch.obs.metrics import Histogram
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.tuning import get_registry
from test_torch_program import WORKLOAD_TAGS

ARCH = "stablelm-1.6b"


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def test_counter_inc_labels_and_negative():
    c = obs.get_metrics().counter("t.requests", "test counter")
    c.inc()
    c.inc(2.5)
    assert c.value == 3.5
    c.labels(kind="a").inc(2)
    c.labels(kind="b").inc()
    assert c.value == 6.5
    assert c.labels(kind="a").value == 2
    with pytest.raises(ValueError):
        c.inc(-1)


def test_gauge_set_add_none_until_written():
    g = obs.get_metrics().gauge("t.level", "test gauge")
    assert g.value is None
    g.set(4.0)
    g.add(-1.5)
    assert g.value == 2.5


def test_registry_kind_mismatch_raises():
    reg = obs.get_metrics()
    reg.counter("t.same_name", "first as counter")
    with pytest.raises(TypeError):
        reg.histogram("t.same_name", "now as histogram")


@pytest.mark.parametrize("i", [0, 3, 10])
def test_histogram_bucket_bounds_and_index(i):
    from repro.obs.metrics import Histogram as JHistogram

    h, j = Histogram("t.h", ""), JHistogram("t.h", "")
    upper = h.bucket_upper(i)
    assert upper == h.base * h.factor ** i == j.bucket_upper(i)
    assert h._index(upper) == i == j._index(upper)
    assert h._index(upper * 1.01) == i + 1 == j._index(upper * 1.01)
    assert h._index(-0.5) == -1
    h.observe(-0.5)
    assert h.count == 1 and h.snapshot()["min"] == -0.5


def test_histogram_snapshot_matches_reference():
    from repro.obs.metrics import Histogram as JHistogram

    vals = np.random.RandomState(2).lognormal(-6, 2, 200)
    h, j = Histogram("t.lat", ""), JHistogram("t.lat", "")
    for v in vals:
        h.observe(float(v))
        j.observe(float(v))
    assert h.snapshot() == j.snapshot()
    for p in (0, 10, 50, 90, 99, 100):
        assert h.percentile(p) == j.percentile(p)
    assert np.median(vals) <= h.percentile(50) <= np.median(vals) * h.factor
    assert h.percentile(100) == vals.max()
    assert Histogram("t.empty", "").percentile(50) is None


def test_metrics_snapshot_and_report_match_reference():
    from repro.obs.metrics import MetricsRegistry as JRegistry

    regs = (obs.get_metrics(), JRegistry())
    for reg in regs:
        reg.counter("t.a", "").inc(3)
        reg.counter("t.l", "").labels(source="cache").inc(2)
        reg.gauge("t.g", "").set(1.5)
        reg.histogram("t.b", "").observe(0.5)
        reg.histogram("t.e", "")
    assert regs[0].snapshot() == regs[1].snapshot()
    assert regs[0].report() == regs[1].report()
    assert regs[0].snapshot()["t.a"] == {"type": "counter", "value": 3}
    assert "t.a: 3" in regs[0].report() and "t.b: count=1" in \
        regs[0].report()


# ---------------------------------------------------------------------------
# trace
# ---------------------------------------------------------------------------

def test_span_is_shared_noop_when_disabled():
    assert not obs.tracing_enabled()
    s1, s2 = obs.span("a"), obs.span("b", attr=1)
    assert s1 is s2 is trace_mod._NOOP
    with s1:
        pass
    assert trace_mod._ENV_TRACE == "REPRO_TORCH_TRACE"


def test_trace_roundtrip_and_nesting(tmp_path):
    path = str(tmp_path / "trace.jsonl")
    obs.enable_tracing(path)
    assert obs.tracing_enabled() and obs.trace_path() == path
    with obs.span("outer", phase="test"):
        with obs.span("inner", i=0):
            pass
        obs.instant("tick", note="x")
    obs.disable_tracing()
    assert not obs.tracing_enabled()
    events = obs.read_trace(path)
    by_name = {e["name"]: e for e in events}
    assert set(by_name) == {"outer", "inner", "tick"}
    for e in events:
        assert e["cat"] == "repro"
        assert {"name", "ph", "ts", "pid", "tid"} <= set(e)
    inner, outer = by_name["inner"], by_name["outer"]
    assert inner["ph"] == outer["ph"] == "X"
    assert by_name["tick"]["ph"] == "i"
    assert outer["args"] == {"phase": "test"}
    assert inner["tid"] == outer["tid"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-6
    text = open(path).read().rstrip().rstrip(",")
    assert len(json.loads(text + "\n]")) == len(events)
    # the reference's reader parses the port's file the same way
    from repro.obs.trace import read_trace as jax_read_trace

    assert jax_read_trace(path) == events


def test_enabled_span_names_a_profiler_region(tmp_path):
    """An enabled span enters torch.profiler.record_function, so a
    profiler trace carries the span's name."""
    obs.enable_tracing(str(tmp_path / "t.jsonl"))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with obs.span("serve.decode", uid=1):
            torch.ones(4) + 1
    obs.disable_tracing()
    assert "serve.decode" in {e.key for e in prof.key_averages()}


# ---------------------------------------------------------------------------
# ledger: planned bytes against the reference's and the I/O model
# ---------------------------------------------------------------------------

_BR = np.random.RandomState(9)
BYTE_CASES = [(int(_BR.randint(1, 3000)), int(_BR.randint(1, 6000)),
               int(_BR.randint(1, 6000)), int(_BR.choice([8, 64, 128])),
               int(_BR.choice([16, 64, 128])), int(_BR.choice([32, 64, 256])))
              for _ in range(3)]


@pytest.mark.parametrize("tag", WORKLOAD_TAGS)
def test_planned_gemm_bytes_match_reference(tag):
    for m, n, k, bm, bn, bk in BYTE_CASES:
        for kw in (dict(itemsize_in=2), dict(itemsize_in=4, itemsize_out=4),
                   dict(itemsize_in=2, itemsize_b=1, scale_b_elements=n),
                   dict(itemsize_in=2, itemsize_b=1, itemsize_a=1,
                        itemsize_out=2, scale_a_elements=m,
                        scale_b_elements=2 * n)):
            assert obs.planned_gemm_bytes(
                m, n, k, TileConfig(bm, bn, bk), tag, **kw) == \
                jledger.planned_gemm_bytes(m, n, k, JTile(bm, bn, bk), tag,
                                           **kw)


@pytest.mark.parametrize("b, kv_len, hkv, d, dv, it, page", [
    (1, 1056, 32, 64, 64, 1, 16), (2, 48, 8, 120, 120, 2, 0),
    (4, 4096, 1, 128, 128, 1, 128)])
def test_planned_attn_kv_bytes_match_reference(b, kv_len, hkv, d, dv, it,
                                               page):
    assert obs.planned_attn_kv_bytes(b, kv_len, hkv, d, dv, kv_itemsize=it,
                                     page=page) == \
        jledger.planned_attn_kv_bytes(b, kv_len, hkv, d, dv,
                                      kv_itemsize=it, page=page)


def test_ledger_disabled_is_noop(rng):
    led = obs.get_ledger()
    assert not led.enabled
    assert led.record_gemm(8, 8, 8, torch.float32, tag="none") is None
    tgemm.ca_matmul(torch.from_numpy(rng.randn(8, 16)).float(),
                    torch.from_numpy(rng.randn(16, 8)).float())
    assert led.records == []
    assert "gemm.ledger_records_total" not in obs.get_metrics().snapshot()


def test_ledger_fused_bytes_match_io_model(rng):
    led = obs.enable_ledger()
    m, n, k = 37, 1024, 1024
    x = torch.from_numpy(rng.randn(m, k)).float()
    w = torch.from_numpy(rng.randn(k, n)).float()
    b = torch.from_numpy(rng.randn(n)).float()
    tgemm.ca_matmul(x, w, epilogue=Epilogue(bias=b, activation="gelu"))
    (rec,) = led.records
    assert rec.tag == "bias+gelu" and rec.dtype == "float32"
    assert rec.config_source == "analytic" and rec.mode == "plain"
    tile = get_registry().resolve(m, n, k, dtype=torch.float32,
                                  epilogue=rec.tag)
    assert (tile.bm, tile.bn, tile.bk) == tuple(rec.config.values())[:3]
    cost = program_cost(rec.tag)
    want = (io_volume_elements(m, n, k, min(tile.bm, m), min(tile.bn, n))
            + epilogue_q_elements(m, n, cost.stream_mn, cost.has_bias,
                                  fused=True)) * 4
    assert rec.planned_bytes == want
    assert rec.planned_flops == 2.0 * m * n * k
    # fp32 runs at the SIMT rate of the h100 target
    assert rec.planned_s == max(rec.planned_flops / H100.peak_flops_fp32,
                                rec.planned_bytes / H100.hbm_bandwidth)
    snap = obs.get_metrics().snapshot()["gemm.ledger_records_total"]
    assert snap["labels"] == {"source=analytic": 1}


def test_ledger_glu_bytes_match_io_model(rng):
    led = obs.enable_ledger()
    m, n, k = 512, 256, 128
    x = torch.from_numpy(rng.randn(m, k)).float()
    wg, wu = (torch.from_numpy(rng.randn(k, n)).float() for _ in range(2))
    tgemm.ca_glu_matmul(x, wg, wu)
    (rec,) = led.records
    assert rec.tag == "glu.silu(none|none)"
    tile = get_registry().resolve(m, n, k, dtype=torch.float32,
                                  epilogue=rec.tag)
    assert rec.planned_bytes == io_volume_elements_program(
        m, n, k, min(tile.bm, m), min(tile.bn, n), n_b=2) * 4
    assert rec.planned_flops == 2.0 * m * n * k * 2


def test_ledger_w8a8_bytes_and_int8_rate(rng):
    from repro_torch.quant.calibrate import quantize_tensor

    led = obs.enable_ledger()
    m, n, k = 37, 256, 256
    qw = quantize_tensor(torch.from_numpy(rng.randn(k, n)).float().to(
        torch.bfloat16))
    qw = dataclasses.replace(qw, act_scale=torch.tensor(0.5))
    xb = torch.from_numpy(rng.randn(m, k)).float().to(torch.bfloat16)
    tgemm.ca_matmul(xb, qw)
    (rec,) = led.records
    assert rec.tag == "dqab" and rec.dtype == "int8w_int8a"
    tile = get_registry().resolve(m, n, k, dtype=torch.bfloat16,
                                  epilogue=rec.tag, dtype_b=torch.int8,
                                  dtype_a=torch.int8)
    want = io_volume_bytes(m, n, k, min(tile.bm, m), min(tile.bn, n),
                           a_itemsize=1, b_itemsize=1, out_itemsize=2) \
        + 4.0 * epilogue_q_elements(m, n, scale_b_elements=n,
                                    scale_a_elements=1)
    assert rec.planned_bytes == want
    assert rec.planned_s == max(rec.planned_flops / H100.peak_flops_int8,
                                rec.planned_bytes / H100.hbm_bandwidth)


def test_ledger_expert_loop_folds_calls_as_the_reference(rng):
    led = obs.enable_ledger()
    xe = rng.randn(2, 4, 8, 16).astype(np.float32)
    we = rng.randn(4, 16, 32).astype(np.float32)
    wu = rng.randn(4, 16, 32).astype(np.float32)
    tgemm.ca_expert_matmul(torch.from_numpy(xe), torch.from_numpy(we))
    tgemm.ca_expert_glu_matmul(torch.from_numpy(xe), torch.from_numpy(we),
                               torch.from_numpy(wu))
    jled = jax_enable_ledger()
    jgemm.ca_expert_matmul(jnp.asarray(xe), jnp.asarray(we))
    jgemm.ca_expert_glu_matmul(jnp.asarray(xe), jnp.asarray(we),
                               jnp.asarray(wu))
    fields = lambda r: (r.m, r.n, r.k, r.tag, r.layout, r.dtype, r.calls)  # noqa: E731
    assert [fields(r) for r in led.records] == \
        [fields(r) for r in jled.records]
    assert led.records[0].calls == 4 and led.records[0].m == 2 * 8


def test_ledger_step_replay_and_rates(rng):
    led = obs.enable_ledger()
    x = torch.from_numpy(rng.randn(16, 32)).float()
    w = torch.from_numpy(rng.randn(32, 16)).float()
    with led.step("s"):
        tgemm.ca_matmul(x, w)
    with led.step("s"):                # records nothing: replays
        pass
    with led.step("s"):                # eager: records its own
        tgemm.ca_matmul(x, w)
    agg = led.steps_summary()["s"]
    assert agg["steps"] == 3 and agg["gemm_calls"] == 3
    assert agg["planned_bytes"] == 3 * led.records[0].planned_bytes
    assert agg["achieved_gbps"] > 0 and agg["model_error"] > 0


# ---------------------------------------------------------------------------
# one decode step of each reduced config: planned bytes vs weight bytes
# ---------------------------------------------------------------------------

# The weights the K1 launches of a step read (``core.gemm`` callers); the
# router, norms, convolutions, MLA's absorbed wkv_b and a codebook head
# (an einsum) are not K1 launches.
K1_WEIGHTS = {"wq", "wk", "wv", "wo", "wq_a", "wq_b", "wkv_a", "w_gate",
              "w_up", "w_down", "in_proj", "out_proj", "w_in"}


def weight_bytes(params, cfg) -> float:
    """Bytes of the weights one decode step multiplies, from the params:
    every K1 weight once a step (the stacked layers, every expert of a
    bank), zamba2's shared block once an application, a 2-D head."""
    total = 0.0
    for name, t in params.items():
        leaf = name.split("/")[-1]
        if leaf in K1_WEIGHTS or (name == "head/w" and t.dim() == 2):
            times = TM.n_shared_applications(cfg) \
                if name.startswith("shared/") else 1
            total += times * t.numel() * t.element_size()
    return total


@pytest.mark.parametrize("arch", list_archs())
def test_decode_step_planned_bytes_split(arch):
    cfg = get_reduced(arch)
    params = TM.init_params(cfg, seed=0, device="cpu")
    led = obs.enable_ledger()
    eng = ServeEngine(params, cfg, max_len=16, device="cpu")
    eng.submit(Request(uid=0, prompt=np.arange(5) % cfg.vocab_size,
                       max_new_tokens=2))
    eng.run()
    program = led._programs["decode"]
    weights = weight_bytes(params, cfg)
    b_term = a_term = rest = 0.0
    for r in program:
        x, y = min(r.config["bm"], r.m), min(r.config["bn"], r.n)
        cost = program_cost(r.tag)
        mnk = r.m * r.n * r.k
        assert x == r.m                      # decode: B is read once
        b_term += r.calls * mnk * cost.n_b * 4 / x
        a_term += r.calls * mnk * 4 / y
        rest += r.calls * (
            cost.n_out * r.m * r.n * 4
            + (4 * (r.m + r.k) if cost.prologue_vec else 0)
            + 4 * epilogue_q_elements(r.m, r.n, cost.stream_mn,
                                      cost.has_bias))
    planned = sum(r.planned_bytes * r.calls for r in program)
    print(f"{arch}: planned {planned:.0f} B = weights {weights:.0f} "
          f"+ A re-reads {a_term:.0f} + outputs/epilogue/norm {rest:.0f}")
    assert planned >= weights
    assert b_term == pytest.approx(weights, rel=1e-12)
    assert planned == pytest.approx(weights + a_term + rest, rel=1e-12)
    assert led.steps_summary()["decode"]["planned_bytes"] == \
        pytest.approx(planned, rel=1e-12)


# ---------------------------------------------------------------------------
# the serve engine end to end, beside the reference engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stablelm_params():
    jp = JM.init_params(jax_reduced(ARCH), jax.random.PRNGKey(0))
    tp = TM.params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                            get_reduced(ARCH), device="cpu")
    return jp, tp


NEW_TOKENS = [4, 3]


def _prompts(vocab):
    r = np.random.RandomState(0)
    return [r.randint(0, vocab, 6) for _ in NEW_TOKENS]


def _serve_reference(jp, paged):
    jled = jax_enable_ledger()
    jled.reset()
    eng = JServeEngine(jp, jax_reduced(ARCH), batch_size=1, max_len=24,
                       paged_kv=paged)
    for uid, (p, n) in enumerate(zip(_prompts(jax_reduced(ARCH).vocab_size),
                                     NEW_TOKENS)):
        eng.submit(JRequest(uid=uid, prompt=p, max_new_tokens=n))
    done = eng.run()
    return {u: r.generated for u, r in done.items()}, dict(jled._programs)


@pytest.mark.parametrize("paged", [False, True])
def test_serve_engine_metrics_e2e(stablelm_params, paged, tmp_path):
    jp, tp = stablelm_params
    cfg = get_reduced(ARCH)
    want_tokens, ref_programs = _serve_reference(jp, paged)

    obs.enable_ledger()
    trace = str(tmp_path / "serve.jsonl")
    obs.enable_tracing(trace)
    eng = ServeEngine(tp, cfg, max_len=24, device="cpu", paged_kv=paged)
    for uid, (p, n) in enumerate(zip(_prompts(cfg.vocab_size), NEW_TOKENS)):
        eng.submit(Request(uid=uid, prompt=p, max_new_tokens=n))
    done = eng.run()
    obs.disable_tracing()

    # greedy tokens unchanged by the instrumentation
    assert {u: r.generated for u, r in done.items()} == want_tokens

    snap = eng.metrics_snapshot()
    mets = snap["metrics"]
    assert mets["serve.ttft_seconds"]["count"] == 2
    assert mets["serve.ttft_seconds"]["min"] > 0
    assert mets["serve.tpot_seconds"]["count"] == 5
    assert mets["serve.queue_wait_seconds"]["count"] == 2
    assert mets["serve.tokens_generated_total"]["value"] == 7
    assert mets["serve.requests_total"]["value"] == 2
    assert mets["serve.tokens_per_second"]["value"] > 0
    assert mets["serve.warmup_seconds"]["value"] > 0
    want_sources = collections.Counter(eng.gemm_plan_sources.values())
    assert mets["serve.gemm_plan_total"]["labels"] == {
        f"source={s}": c for s, c in want_sources.items()}
    assert all(k.startswith("h100/") for k in eng.gemm_plan_sources)
    if paged:
        assert mets["serve.attn_warmup_seconds"]["value"] > 0
        assert any("attn.paged_decode" in k for k in eng.attn_plan_sources)
    steps = snap["ledger"]["steps"]
    assert steps["prefill"]["steps"] == 2 and steps["decode"]["steps"] == 5
    for agg in steps.values():
        assert agg["gemm_calls"] > 0 and agg["planned_bytes"] > 0
        assert agg["achieved_gbps"] > 0 and agg["model_error"] > 0

    # One step's records against the reference's recorded program: the
    # reference records a scanned layer's GEMMs once (lax.scan traces the
    # body once), the port every layer's launch, so each per-layer record
    # counts n_layers times; the head once.
    led = obs.get_ledger()
    for label in ("prefill", "decode"):
        port = collections.Counter(
            (r.m, r.n, r.k, r.tag, r.layout, r.dtype, r.calls)
            for r in led._programs[label] if isinstance(r, obs.GemmRecord))
        ref = collections.Counter()
        for r in ref_programs[label]:
            if not isinstance(r, jledger.GemmRecord):
                continue
            key = (r.m, r.n, r.k, r.tag, r.layout, r.dtype, r.calls)
            ref[key] += 1 if r.n == cfg.padded_vocab else cfg.n_layers
        assert port == ref, label
        attn = [r for r in led._programs[label]
                if isinstance(r, obs.AttnRecord)]
        assert len(attn) == (cfg.n_layers if paged and label == "decode"
                             else 0)

    report = eng.metrics_report()
    for needle in ("serve.ttft_seconds", "serve.tpot_seconds",
                   "serve.tokens_per_second", "serve.gemm_plan_total",
                   "ledger.prefill", "ledger.decode", "model_error"):
        assert needle in report, needle
    spans = collections.Counter(e["name"] for e in obs.read_trace(trace))
    assert spans["serve.warmup"] == 1 and spans["serve.request"] == 2
    assert spans["serve.prefill"] == 2 and spans["serve.decode"] == 2
    assert spans["serve.attn_warmup"] == int(paged)


def test_serve_engine_calibrate_span_and_gauge(stablelm_params, tmp_path):
    from repro_torch.models.common import quantize_params

    _, tp = stablelm_params
    cfg = get_reduced(ARCH)
    trace = str(tmp_path / "cal.jsonl")
    obs.enable_tracing(trace)
    eng = ServeEngine(quantize_params(tp), cfg, max_len=16, device="cpu",
                      quantize_activations=True, calibration_batches=1)
    obs.disable_tracing()
    assert eng.w8a8
    spans = collections.Counter(e["name"] for e in obs.read_trace(trace))
    assert spans["serve.calibrate"] == 1 and spans["serve.warmup"] == 1
    assert obs.get_metrics().get("serve.calibration_seconds").value > 0
    assert all("int8w_int8a" in k for k in eng.gemm_plan_sources)


def test_serve_launcher_flags(capsys, tmp_path):
    from repro_torch.launch import serve

    trace = str(tmp_path / "launch.jsonl")
    serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "1",
                "--prompt-len", "4", "--max-new", "3", "--ledger",
                "--metrics", "--trace", trace])
    out = capsys.readouterr().out
    assert "serve.ttft_seconds" in out and "ledger.decode" in out
    names = {e["name"] for e in obs.read_trace(trace)}
    assert {"serve.request", "serve.prefill", "serve.decode"} <= names


def test_train_launcher_metrics_and_spans(tmp_path, capsys):
    from repro_torch.launch import train

    trace = str(tmp_path / "train.jsonl")
    train.main(["--arch", ARCH, "--steps", "2", "--seq-len", "8",
                "--global-batch", "2", "--device", "cpu", "--metrics",
                "--trace", trace])
    mets = obs.get_metrics().snapshot()
    assert mets["train.steps_total"]["value"] == 2
    assert mets["train.step_seconds"]["count"] == 2
    assert np.isfinite(mets["train.loss"]["value"])
    assert mets["train.tokens_per_second"]["value"] > 0
    assert "train.step_seconds" in capsys.readouterr().out
    spans = [e for e in obs.read_trace(trace) if e["name"] == "train.step"]
    assert [e["args"]["step"] for e in spans] == [0, 1]


def test_tokens_per_second_counts_only_this_run(stablelm_params):
    """``serve.tokens_per_second`` over two ``run()`` calls on one metrics
    registry: the port's gauge is the second call's tokens over its wall
    (rel 1e-2); the reference's gauge divides the process's token counter
    by that call's wall, so it reads twice that (the reference fault
    recorded in ROADMAP §3; not fixed in the reference)."""
    import time

    from repro import obs as jobs

    jp, tp = stablelm_params
    cfg = get_reduced(ARCH)
    r = np.random.RandomState(3)
    prompts = [r.randint(0, cfg.vocab_size, 6) for _ in range(2)]

    def serve(eng, req_cls, uid0):
        for i, p in enumerate(prompts):
            eng.submit(req_cls(uid=uid0 + i, prompt=p, max_new_tokens=4))
        t0 = time.perf_counter()
        done = eng.run()
        wall = time.perf_counter() - t0
        return sum(len(done[uid0 + i].generated) for i in range(2)), wall

    eng = ServeEngine(tp, cfg, batch_size=1, max_len=24, device="cpu")
    serve(eng, Request, 0)
    tokens, wall = serve(eng, Request, 10)
    got = obs.get_metrics().snapshot()["serve.tokens_per_second"]["value"]
    assert tokens == 8
    assert got == pytest.approx(tokens / wall, rel=1e-2)

    jeng = JServeEngine(jp, jax_reduced(ARCH), batch_size=1, max_len=24)
    serve(jeng, JRequest, 0)
    jtokens, jwall = serve(jeng, JRequest, 10)
    jgot = jobs.get_metrics().snapshot()["serve.tokens_per_second"]["value"]
    assert jtokens == 8
    assert jgot == pytest.approx(2 * jtokens / jwall, rel=1e-2)
