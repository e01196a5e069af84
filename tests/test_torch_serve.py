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


@pytest.mark.parametrize("kw", [{"paged_kv": True,
                                 "quantize_activations": True},
                                {"quantize_activations": True},
                                {"tp_local": (1, 2)}, {"max_queue": 4}])
def test_later_slice_options_raise(params, kw):
    _, tp = params
    with pytest.raises(ValueError, match="not ported"):
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
    with pytest.raises(RuntimeError, match="decode failed"):
        eng.run()
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
