"""The port's ServeEngine on the CPU against the reference engine."""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.models import model as JM
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_reduced
from repro_torch.models import model as TM
from repro_torch.serve.engine import Request, ServeEngine

ARCH = "stablelm-1.6b"
DANUBE = "h2o-danube-3-4b"


def _params(arch):
    jp = JM.init_params(jax_reduced(arch), jax.random.PRNGKey(0))
    tp = TM.params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                            get_reduced(arch), device="cpu")
    return jp, tp


@pytest.fixture(scope="module")
def params():
    return _params(ARCH)


def test_greedy_tokens_identical_to_reference_engine(params):
    jp, tp = params
    cfg = get_reduced(ARCH)
    prompt = np.arange(8) % cfg.vocab_size
    jeng = JServeEngine(jp, jax_reduced(ARCH), batch_size=1, max_len=32)
    jeng.submit(JRequest(uid=1, prompt=prompt, max_new_tokens=5))
    want = jeng.run()[1].generated
    eng = ServeEngine(tp, cfg, max_len=32, device="cpu")
    eng.submit(Request(uid=1, prompt=prompt, max_new_tokens=5))
    done = eng.run()
    assert done[1].status == "done"
    assert done[1].generated == want, (done[1].generated, want)


def test_temperature_sampling_is_deterministic_per_seed(params):
    _, tp = params
    cfg = get_reduced(ARCH)
    prompt = np.arange(6) % cfg.vocab_size
    outs = []
    for seed in (7, 7, 8):
        eng = ServeEngine(tp, cfg, max_len=24, seed=seed,
                          device="cpu")
        eng.submit(Request(uid=1, prompt=prompt, max_new_tokens=6,
                           temperature=0.8))
        outs.append(eng.run()[1].generated)
    assert outs[0] == outs[1]
    assert len(outs[2]) == 6


def test_default_device_needs_cuda(params, monkeypatch):
    _, tp = params
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(tp, get_reduced(ARCH), max_len=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        TM.init_params(get_reduced(ARCH))


# w8a8 is ported: quantize_activations over dense params raises, as the
# reference's test_w8a8_requires_weight_quantized_params checks.  Bounded
# admission is ported: an unknown overflow policy raises, as the
# reference's constructor does.  tp_local is ported (its warmup is held in
# tests/test_torch_serve_tp.py); a batch_size below 1 raises.
@pytest.mark.parametrize("kw,match", [
    ({"paged_kv": True, "quantize_activations": True},
     "quantize_activations"),
    ({"quantize_activations": True}, "quantize_activations"),
    ({"batch_size": 0}, "batch_size"),
    ({"max_queue": 4, "overflow": "drop_newest"},
     "unknown overflow policy")],
    ids=["kw0", "kw1", "kw2", "kw3"])
def test_later_slice_options_raise(params, kw, match):
    _, tp = params
    with pytest.raises(ValueError, match=match):
        ServeEngine(tp, get_reduced(ARCH), max_len=16,
                    device="cpu", **kw)


# Prompt lengths per arch: danube's reduced window is 32 tokens, so its
# first prompt runs past it; later requests reuse pages the earlier wrote.
PAGED_PROMPTS = {ARCH: [8, 12, 5], DANUBE: [40, 9]}


@pytest.mark.parametrize("arch", [ARCH, DANUBE])
def test_paged_greedy_tokens_identical_to_reference_and_slab(arch):
    jp, tp = _params(arch)
    cfg = get_reduced(arch)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in PAGED_PROMPTS[arch]]
    jeng = JServeEngine(jp, jax_reduced(arch), batch_size=1, max_len=48,
                        warmup_gemms=False, paged_kv=True, kv_page_size=8)
    engines = [ServeEngine(tp, cfg, max_len=48, device="cpu", paged_kv=True,
                           kv_page_size=8),
               ServeEngine(tp, cfg, max_len=48, device="cpu")]
    for eng in [jeng] + engines:
        for uid, prompt in enumerate(prompts):
            req = (JRequest if eng is jeng else Request)(
                uid=uid, prompt=prompt, max_new_tokens=5)
            assert eng.submit(req)
    want = jeng.run()
    paged, slab = (e.run() for e in engines)
    for uid in range(len(prompts)):
        assert paged[uid].status == "done"
        assert paged[uid].generated == want[uid].generated, uid
        assert paged[uid].generated == slab[uid].generated, uid
    pool = engines[0].kv_pool
    assert pool.page_size == 8 and pool.n_pages == 6
    assert pool.n_free == pool.n_pages
    assert bool((engines[0].kv_cache["layers"]["tables"] == -1).all())


def test_paged_engine_rejects_oversized_request(params):
    _, tp = params
    cfg = get_reduced(ARCH)
    eng = ServeEngine(tp, cfg, max_len=32, device="cpu", paged_kv=True,
                      kv_page_size=8)      # pool: 4 pages of 8 = 32 tokens
    big = Request(uid=7, prompt=np.zeros(30, np.int64), max_new_tokens=16)
    assert not eng.submit(big)
    assert big.status == "rejected" and "kv pages" in big.error
    assert eng.done[7] is big and not eng.queue
    ok = Request(uid=8, prompt=np.zeros(6, np.int64), max_new_tokens=4)
    assert eng.submit(ok)
    done = eng.run()
    assert done[8].status == "done" and done[8].error is None
    assert eng.kv_pool.n_free == eng.kv_pool.n_pages


def test_paged_engine_frees_pages_when_a_request_fails(params, monkeypatch):
    _, tp = params
    cfg = get_reduced(ARCH)
    eng = ServeEngine(tp, cfg, max_len=32, device="cpu", paged_kv=True)
    assert eng.kv_pool.page_size == 16          # analytic for max_len 32
    eng.submit(Request(uid=1, prompt=np.arange(6), max_new_tokens=4))

    def fail(*a, **k):
        raise RuntimeError("decode failed")

    monkeypatch.setattr(TM, "decode_step", fail)
    # request isolation: the failure lands on the request, not the engine
    done = eng.run()
    assert done[1].status == "failed"
    assert done[1].error == "RuntimeError: decode failed"
    assert eng.kv_pool.n_free == eng.kv_pool.n_pages
    assert eng.kv_pool.owned(1) == ()


@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
def test_greedy_past_the_window_matches_full_forward(paged):
    """Decoding past danube's 32-token window agrees with argmax over a
    full forward of the same tokens.  The slab cache keeps a long prompt's
    last 32 entries at their rolling slots (the reference keeps them in
    order, and its decode then overwrites entries inside the window)."""
    _, tp = _params(DANUBE)
    cfg = get_reduced(DANUBE)
    prompt = np.random.RandomState(4).randint(0, cfg.vocab_size, 40)
    eng = ServeEngine(tp, cfg, max_len=48, device="cpu", paged_kv=paged,
                      kv_page_size=8 if paged else 0)
    eng.submit(Request(uid=0, prompt=prompt, max_new_tokens=5))
    got = eng.run()[0].generated
    seq = torch.as_tensor(np.concatenate([prompt, got[:-1]]))[None]
    with torch.inference_mode():
        logits, _ = TM.forward(tp, {"tokens": seq}, cfg)
    assert got == logits[0, 39:, :cfg.vocab_size].argmax(-1).tolist()


# ---------------------------------------------------------------------------
# int8 weights (K1d) and w8a8 (K1e)
# ---------------------------------------------------------------------------

def _quantized(arch):
    """The reference's quantized params and the same tree in the port."""
    from repro.models import common as jcm
    from test_torch_models import as_numpy_params

    jq = jcm.quantize_params(JM.init_params(jax_reduced(arch),
                                            jax.random.PRNGKey(0)))
    return jq, TM.params_from_jax(as_numpy_params(jq), get_reduced(arch),
                                  device="cpu")


@pytest.fixture(scope="module")
def qparams():
    return _quantized(ARCH)


def test_w8a8_calibration_matches_reference_engine(qparams):
    from repro_torch.quant import QTensor

    jq, tq = qparams
    jeng = JServeEngine(jq, jax_reduced(ARCH), batch_size=1, max_len=32,
                        warmup_gemms=False, quantize_activations=True)
    eng = ServeEngine(tq, get_reduced(ARCH), max_len=32, device="cpu",
                      quantize_activations=True)
    assert eng.quantized and eng.w8a8 and eng.calibration_s > 0
    assert eng.calibration_sites == jeng.calibration_sites
    assert len(eng.calibration_sites) == 4     # k64n64 is shared by wq..wo
    for key, q in eng.params.items():
        if not isinstance(q, QTensor):
            continue
        want = np.asarray(jeng.params[key].act_scale)
        assert q.act_scale is not None and q.act_scale.shape == want.shape
        np.testing.assert_allclose(q.act_scale.numpy(), want, rtol=1e-5)
    assert all(q.act_scale is None for q in tq.values()
               if isinstance(q, QTensor))          # input left as it was


@pytest.mark.parametrize("act_block", [0, 128], ids=["per_tensor",
                                                   "per_k_tile"])
def test_w8a8_calibration_options_match_reference_engine(qparams, act_block):
    """``calibration_batches`` and a percentile ``act_qconfig`` (per
    tensor or per k-tile) give the reference engine's scales and tokens."""
    from repro.quant import QuantConfig as JQuantConfig
    from repro_torch.quant import QTensor, QuantConfig

    jq, tq = qparams
    cfg = get_reduced(ARCH)
    kw = dict(act_fmt="int8", method="percentile", percentile=99.0,
              act_block=act_block)
    jeng = JServeEngine(jq, jax_reduced(ARCH), batch_size=1, max_len=32,
                        warmup_gemms=False, quantize_activations=True,
                        calibration_batches=2,
                        act_qconfig=JQuantConfig(**kw))
    eng = ServeEngine(tq, cfg, max_len=32, device="cpu",
                      quantize_activations=True, calibration_batches=2,
                      act_qconfig=QuantConfig(**kw))
    assert eng.calibration_sites == jeng.calibration_sites
    for key, q in eng.params.items():
        if isinstance(q, QTensor):
            assert q.act_block == act_block
            np.testing.assert_allclose(
                q.act_scale.numpy(), np.asarray(jeng.params[key].act_scale),
                rtol=1e-5)
    prompt = np.random.RandomState(8).randint(0, cfg.vocab_size, 11)
    jeng.submit(JRequest(uid=0, prompt=prompt, max_new_tokens=5))
    eng.submit(Request(uid=0, prompt=prompt, max_new_tokens=5))
    assert eng.run()[0].generated == jeng.run()[0].generated


@pytest.mark.parametrize("w8a8", [False, True], ids=["int8w", "w8a8"])
def test_quantized_greedy_tokens_identical_to_reference_engine(qparams,
                                                                w8a8):
    jq, tq = qparams
    cfg = get_reduced(ARCH)
    rng = np.random.RandomState(6)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in (8, 13)]
    jeng = JServeEngine(jq, jax_reduced(ARCH), batch_size=1, max_len=32,
                        warmup_gemms=False, quantize_activations=w8a8)
    eng = ServeEngine(tq, cfg, max_len=32, device="cpu",
                      quantize_activations=w8a8)
    assert eng.w8a8 == w8a8 and jeng.w8a8 == w8a8
    for e, R in ((jeng, JRequest), (eng, Request)):
        for uid, p in enumerate(prompts):
            e.submit(R(uid=uid, prompt=p, max_new_tokens=5))
    want, got = jeng.run(), eng.run()
    for uid in range(len(prompts)):
        assert got[uid].status == "done"
        assert got[uid].generated == want[uid].generated, uid


def _paged_quantized_tokens(qparams, w8a8):
    jq, tq = qparams
    cfg = get_reduced(ARCH)
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in (12, 5)]
    jeng = JServeEngine(jq, jax_reduced(ARCH), batch_size=1, max_len=48,
                        warmup_gemms=False, paged_kv=True, kv_page_size=8,
                        quantize_activations=w8a8)
    eng = ServeEngine(tq, cfg, max_len=48, device="cpu", paged_kv=True,
                      kv_page_size=8, quantize_activations=w8a8)
    assert eng.w8a8 == w8a8
    for e, R in ((jeng, JRequest), (eng, Request)):
        for uid, p in enumerate(prompts):
            assert e.submit(R(uid=uid, prompt=p, max_new_tokens=5))
    want, got = jeng.run(), eng.run()
    for uid in range(len(prompts)):
        assert got[uid].generated == want[uid].generated, uid
    assert eng.kv_pool.n_free == eng.kv_pool.n_pages


def test_int8w_paged_greedy_tokens_identical_to_reference_paged(qparams):
    _paged_quantized_tokens(qparams, w8a8=False)


def test_w8a8_paged_greedy_tokens_identical_to_reference_paged(qparams):
    """Calibration prefills on a slab cache; serving then runs on the
    paged pool."""
    _paged_quantized_tokens(qparams, w8a8=True)


# ---------------------------------------------------------------------------
# The other architectures (reduced): granite-20b, deepseek-v2-lite-16b,
# minicpm3-4b, mixtral-8x7b
# ---------------------------------------------------------------------------

NEW_ARCHS = ["granite-20b", "deepseek-v2-lite-16b", "minicpm3-4b",
             "mixtral-8x7b"]
GQA_ARCHS = ["granite-20b", "mixtral-8x7b"]
MLA_ARCHS = ["deepseek-v2-lite-16b", "minicpm3-4b"]


def _serve_both(arch, jparams, tparams, prompts, *, paged=False, **jkw):
    """The same requests on the reference engine and the port's (slab,
    and with ``paged`` the paged pool too); returns the reference's
    tokens and the port's, per engine."""
    cfg = get_reduced(arch)
    kw = dict(paged_kv=True, kv_page_size=8) if paged else {}
    jeng = JServeEngine(jparams, jax_reduced(arch), batch_size=1, max_len=48,
                        warmup_gemms=False, **kw, **jkw)
    engines = [ServeEngine(tparams, cfg, max_len=48, device="cpu", **kw)]
    if paged:
        engines.append(ServeEngine(tparams, cfg, max_len=48, device="cpu"))
    for eng in [jeng] + engines:
        for uid, prompt in enumerate(prompts):
            req = (JRequest if eng is jeng else Request)(
                uid=uid, prompt=prompt, max_new_tokens=5)
            assert eng.submit(req)
    want = jeng.run()
    return ([want[u].generated for u in range(len(prompts))],
            [[e.run()[u].generated for u in range(len(prompts))]
             for e in engines])


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_arch_greedy_tokens_identical_to_reference_engine(arch):
    """Slab cache, prompts inside mixtral's reduced 32-token window (past
    it the reference's slab misplaces kept entries, ROADMAP §3; the next
    test holds the port there against a full forward)."""
    jp, tp = _params(arch)
    cfg = get_reduced(arch)
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in (13, 7)]
    want, (got,) = _serve_both(arch, jp, tp, prompts)
    assert got == want


@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
def test_mixtral_greedy_past_the_window_matches_full_forward(paged):
    """A 40-token prompt past mixtral's reduced 32-token window, decoded
    on the slab or the paged cache: each greedy token is the argmax of a
    full forward over the same tokens (MoE routing included)."""
    arch = "mixtral-8x7b"
    _, tp = _params(arch)
    cfg = get_reduced(arch)
    prompt = np.random.RandomState(4).randint(0, cfg.vocab_size, 40)
    eng = ServeEngine(tp, cfg, max_len=48, device="cpu", paged_kv=paged,
                      kv_page_size=8 if paged else 0)
    eng.submit(Request(uid=0, prompt=prompt, max_new_tokens=5))
    got = eng.run()[0].generated
    seq = torch.as_tensor(np.concatenate([prompt, got[:-1]]))[None]
    with torch.inference_mode():
        logits, _ = TM.forward(tp, {"tokens": seq}, cfg)
    assert got == logits[0, 39:, :cfg.vocab_size].argmax(-1).tolist()


@pytest.mark.parametrize("arch", GQA_ARCHS)
def test_new_arch_paged_greedy_tokens_identical_to_reference_and_slab(arch):
    jp, tp = _params(arch)
    cfg = get_reduced(arch)
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in (12, 5)]
    want, (paged, slab) = _serve_both(arch, jp, tp, prompts, paged=True)
    assert paged == want and slab == want


@pytest.mark.parametrize("arch", MLA_ARCHS)
def test_mla_paged_kv_raises_kv005(arch):
    """MLA compresses its cache instead of paging it; both engines refuse
    a paged pool for it."""
    jp, tp = _params(arch)
    with pytest.raises(ValueError, match="KV005"):
        JServeEngine(jp, jax_reduced(arch), batch_size=1, max_len=16,
                     warmup_gemms=False, paged_kv=True)
    with pytest.raises(ValueError, match="KV005"):
        ServeEngine(tp, get_reduced(arch), max_len=16, device="cpu",
                    paged_kv=True)
    with pytest.raises(ValueError, match="KV005"):
        TM.make_paged_model_cache(get_reduced(arch), 1, n_pages=2,
                                  page_size=8, max_pages=2, device="cpu")


def test_deepseek_int8w_greedy_tokens_identical_to_reference_engine():
    """int8 weights on deepseek: attention and shared-expert projections
    quantized, the expert banks bf16-dense as in the reference."""
    arch = "deepseek-v2-lite-16b"
    jq, tq = _quantized(arch)
    cfg = get_reduced(arch)
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in (11, 6)]
    want, (got,) = _serve_both(arch, jq, tq, prompts)
    assert got == want


# ---------------------------------------------------------------------------
# batch_size and warmup_gemms (the reference's constructor arguments)
# ---------------------------------------------------------------------------

def _pool_gauge(metrics):
    return metrics.snapshot()["serve.kv_pool_pages"]["value"]


@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
@pytest.mark.parametrize("warmup", [True, False], ids=["warm", "cold"])
@pytest.mark.parametrize("batch_size", [1, 4])
def test_batch_size_and_warmup_match_reference_engine(params, batch_size,
                                                      warmup, paged):
    """The warmed plans (rows [batch_size, batch_size·max_len], none with
    warmup_gemms=False) have the reference engine's keys past the target
    name, and the default page pool holds batch_size sequences, as the
    reference's serve.kv_pool_pages reads."""
    from repro import obs as jobs
    from repro_torch import obs as tobs

    jp, tp = params
    kw = dict(batch_size=batch_size, max_len=24, warmup_gemms=warmup,
              paged_kv=paged, kv_page_size=8 if paged else 0)
    jeng = JServeEngine(jp, jax_reduced(ARCH), **kw)
    eng = ServeEngine(tp, get_reduced(ARCH), device="cpu", **kw)
    strip = lambda keys: sorted(k.split("/", 1)[1] for k in keys)  # noqa: E731
    assert strip(eng.gemm_plan_sources) == strip(jeng.gemm_plan_sources)
    assert bool(eng.gemm_plan_sources) == warmup
    assert eng.B == jeng.B == batch_size
    if paged:
        assert eng.kv_pool.n_pages == jeng.kv_pool.n_pages \
            == batch_size * 3
        assert _pool_gauge(tobs.get_metrics()) \
            == _pool_gauge(jobs.get_metrics()) == batch_size * 3
