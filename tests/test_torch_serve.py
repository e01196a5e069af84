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


@pytest.fixture(scope="module")
def params():
    jp = JM.init_params(jax_reduced(ARCH), jax.random.PRNGKey(0))
    tp = TM.params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                            get_reduced(ARCH), device="cpu")
    return jp, tp


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


@pytest.mark.parametrize("kw", [{"paged_kv": True},
                                {"quantize_activations": True},
                                {"tp_local": (1, 2)}, {"max_queue": 4}])
def test_later_slice_options_raise(params, kw):
    _, tp = params
    with pytest.raises(ValueError, match="not ported"):
        ServeEngine(tp, get_reduced(ARCH), max_len=16,
                    device="cpu", **kw)
