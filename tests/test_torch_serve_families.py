"""The port's ServeEngine and serve launcher on the last four model
families, against the reference engine on the CPU (reduced configs, fp32,
the reference's parameters): mamba2-370m and zamba2-7b on the slab cache
(zamba2 also at 7 layers), qwen2-vl-72b and musicgen-large on the slab
and the paged cache."""

import dataclasses

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
from repro_torch.serve import engine as E
from repro_torch.serve.engine import Request, ServeEngine


def _setup(case):
    arch, _, layers = case.partition("@")
    jcfg, cfg = jax_reduced(arch), get_reduced(arch)
    if layers:
        jcfg = dataclasses.replace(jcfg, n_layers=int(layers))
        cfg = dataclasses.replace(cfg, n_layers=int(layers))
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = TM.params_from_jax({k: np.asarray(v) for k, v in jp.items()}, cfg,
                            device="cpu")
    return jcfg, cfg, jp, tp


# Prompt lengths: the SSM archs' first prompt spans two reduced 16-token
# SSD chunks and is not a multiple of one; the second is shorter than the
# conv window.  The paged archs reuse pages across requests.
PROMPTS = {"mamba2-370m": (21, 3), "zamba2-7b": (21, 3),
           "zamba2-7b@7": (37, 9), "qwen2-vl-72b": (12, 5),
           "musicgen-large": (12, 5)}
PAGED = {"qwen2-vl-72b", "musicgen-large"}


def _serve(engine, request_cls, prompts):
    for uid, prompt in enumerate(prompts):
        assert engine.submit(request_cls(uid=uid, prompt=prompt,
                                         max_new_tokens=6))
    done = engine.run()
    return [done[uid].generated for uid in range(len(prompts))]


@pytest.mark.parametrize("case", list(PROMPTS))
def test_greedy_tokens_identical_to_reference_engine(case):
    """Greedy tokens of the port's engine equal the reference engine's on
    the slab cache, and for the paged archs on the paged cache too."""
    jcfg, cfg, jp, tp = _setup(case)
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in PROMPTS[case]]
    kinds = [False, True] if case in PAGED else [False]
    for paged in kinds:
        kw = dict(paged_kv=True, kv_page_size=8) if paged else {}
        want = _serve(JServeEngine(jp, jcfg, batch_size=1, max_len=48,
                                   warmup_gemms=False, **kw),
                      JRequest, prompts)
        eng = ServeEngine(tp, cfg, max_len=48, device="cpu", **kw)
        got = _serve(eng, Request, prompts)
        assert got == want, (paged, got, want)
        assert all(r.status == "done" for r in eng.done.values())
        if paged:
            assert eng.kv_pool.n_free == eng.kv_pool.n_pages


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-7b"])
def test_paged_kv_raises_kv005(arch):
    """A Mamba2 layer's state is not addressed by token: both engines
    refuse a paged pool for the ssm and hybrid families."""
    jcfg, cfg, jp, tp = _setup(arch)
    with pytest.raises(ValueError, match="KV005"):
        JServeEngine(jp, jcfg, batch_size=1, max_len=16, warmup_gemms=False,
                     paged_kv=True)
    with pytest.raises(ValueError, match="KV005"):
        ServeEngine(tp, cfg, max_len=16, device="cpu", paged_kv=True)


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "musicgen-large"])
def test_sample_table_bit_equal_to_reference(arch, monkeypatch):
    """The embeds frontend's demo table, drawn in row chunks (here of 37
    rows, so the reduced vocab spans several), equals the reference
    engine's single draw bit for bit; the engine takes one passed in."""
    jcfg, cfg, jp, tp = _setup(arch)
    want = np.asarray(JServeEngine(jp, jcfg, batch_size=1, max_len=16,
                                   warmup_gemms=False)._sample_table)
    monkeypatch.setattr(E, "_TABLE_ROWS", 37)
    got = E.sample_table(cfg, "cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    eng = ServeEngine(tp, cfg, max_len=16, device="cpu", sample_table=got)
    ids = torch.tensor([[3, 0, 7]])
    np.testing.assert_array_equal(eng._inputs(ids)["embeds"].numpy(),
                                  want[[[3, 0, 7]]])


def test_musicgen_samples_codebook_zero():
    """With four codebook heads the engine samples codebook 0 of the last
    position, over the real vocabulary."""
    cfg = get_reduced("musicgen-large")
    eng = ServeEngine({}, cfg, max_len=8, device="cpu")
    logits = torch.zeros(1, 2, cfg.n_codebooks, cfg.padded_vocab)
    logits[0, -1, 0, 17] = 1.0
    logits[0, -1, 1, 5] = 3.0
    logits[0, -1, 0, cfg.vocab_size] = 9.0          # a padded entry
    assert eng._sample(logits, 0.0) == 17
    logits[0, -1, 3, 2] = float("nan")
    with pytest.raises(E.NonFiniteLogits):
        eng._sample(logits, 0.0)


@pytest.mark.parametrize("arch", ["mamba2-370m", "musicgen-large"])
def test_launch_serve_on_the_cpu(arch, capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", arch, "--device", "cpu", "--requests", "2",
                "--prompt-len", "5", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "req 0 (done)" in out and "req 1 (done)" in out
    assert "6 tokens in" in out
    done, _ = serve.run_serving(arch, requests=1, prompt_len=5, max_new=3,
                                device="cpu")
    assert len(done[0].generated) == 3


def test_launch_serve_paged_and_default_device(monkeypatch):
    from repro_torch.launch import serve

    done, _ = serve.run_serving("qwen2-vl-72b", requests=2, prompt_len=6,
                                max_new=3, device="cpu", paged=True)
    assert [r.status for r in done.values()] == ["done", "done"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "mamba2-370m"])
