"""The last four model families in the port against the reference on the
CPU (reduced configs, fp32, the reference's parameters through
``params_from_jax``): mamba2-370m (ssm), zamba2-7b (hybrid, also at 7
layers: one full group and a partial one past the reduced 4), qwen2-vl-72b
(M-RoPE over the ``embeds`` frontend) and musicgen-large (four codebook
heads over the ``embeds`` frontend)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_reduced as jax_reduced
from repro.models import common as jcm
from repro.models import model as JM
from repro_torch.configs import get_config, get_reduced, list_archs
from repro_torch.models import common as tcm
from repro_torch.models import model as TM

ARCHS = ["mamba2-370m", "zamba2-7b", "qwen2-vl-72b", "musicgen-large"]
# The reduced configs, and zamba2 at 7 layers (shared_attn_every 2: three
# applications, none after the last layer).
CASES = ARCHS + ["zamba2-7b@7"]


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _cfgs(case):
    arch, _, layers = case.partition("@")
    jcfg, cfg = jax_reduced(arch), get_reduced(arch)
    if layers:
        jcfg = dataclasses.replace(jcfg, n_layers=int(layers))
        cfg = dataclasses.replace(cfg, n_layers=int(layers))
    return jcfg, cfg


@pytest.fixture(scope="module", params=CASES)
def case(request):
    jcfg, cfg = _cfgs(request.param)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = TM.params_from_jax({k: np.asarray(v) for k, v in jp.items()}, cfg,
                            device="cpu")
    return request.param, jcfg, cfg, jp, tp


def _inputs(cfg, B, L, seed):
    """The same input in both packages: token ids, or embeddings for the
    ``embeds`` frontend."""
    r = np.random.RandomState(seed)
    if cfg.frontend == "tokens":
        a = r.randint(0, cfg.vocab_size, (B, L))
        return ({"tokens": jnp.asarray(a, jnp.int32)},
                {"tokens": torch.as_tensor(a)})
    a = r.randn(B, L, cfg.d_model).astype(np.float32)
    return {"embeds": jnp.asarray(a)}, {"embeds": torch.as_tensor(a)}


def _slice(batch, lo, hi):
    return {k: v[:, lo:hi] for k, v in batch.items()}


def test_list_archs_equals_reference():
    from repro.configs import list_archs as jax_list_archs

    assert list_archs() == jax_list_archs()


@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_and_n_params_equal_reference(arch):
    for want, got in ((jax_config(arch), get_config(arch)),
                      (jax_reduced(arch), get_reduced(arch))):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert (got.padded_vocab, got.n_params(), got.active_params()) \
            == (want.padded_vocab, want.n_params(), want.active_params())


def test_paper_gemm_config():
    from repro.configs import paper_gemm as jpg
    from repro_torch.configs import paper_gemm as tpg

    assert (tpg.MATRIX_SIZES, tpg.PAPER_N) == (jpg.MATRIX_SIZES, jpg.PAPER_N)
    assert tpg.DTYPES == (torch.bfloat16, torch.float32, torch.int8)


def test_model_defs_equal_reference(case):
    """Every leaf of the reference's tree, with its shape: no embedding
    table for the embeds frontend, zamba2's ``shared`` subtree, the 3-D
    codebook head."""
    name, jcfg, cfg, jp, tp = case
    jdefs, tdefs = JM.model_defs(jcfg), TM.model_defs(cfg)
    assert {k: d.shape for k, d in tdefs.items()} \
        == {k: d.shape for k, d in jdefs.items()}
    assert {k: d.init for k, d in tdefs.items()} \
        == {k: d.init for k, d in jdefs.items()}
    assert ("embed/table" in tdefs) == (cfg.frontend == "tokens")
    assert any(k.startswith("shared/") for k in tdefs) \
        == bool(cfg.shared_attn_every)
    assert len(tdefs["head/w"].shape) == (3 if cfg.n_codebooks > 1 else 2)


def test_forward_logits_match_reference(case):
    """37 tokens: past two reduced 16-token SSD chunks, not a multiple of
    one."""
    name, jcfg, cfg, jp, tp = case
    jb, tb = _inputs(cfg, 2, 37, 5)
    want, _, _ = JM.forward(jp, jb, jcfg)
    with torch.no_grad():
        got, cache = TM.forward(tp, tb, cfg)
    assert cache is None and got.dtype == torch.float32
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)


def test_prefill_and_decode_match_reference(case):
    """The reference's own check (tests/test_models.py): a 32-token
    prefill within 2e-4 of a full forward over 36 tokens, then four
    teacher-forced decode steps within 1e-3; and each step within the same
    tolerances of the reference's prefill and decode, its SSM caches
    (conv window, state) and the shared block's k/v too."""
    name, jcfg, cfg, jp, tp = case
    jb, tb = _inputs(cfg, 2, 36, 1)
    full, _, _ = JM.forward(jp, jb, jcfg)
    full = _np(full)
    want, jc = JM.prefill(jp, _slice(jb, 0, 32), jcfg, max_len=36)
    with torch.no_grad():
        got, tc = TM.prefill(tp, _slice(tb, 0, 32), cfg, max_len=36)
    for ref in (full[:, :32], _np(want)):
        np.testing.assert_allclose(_np(got), ref, rtol=2e-4, atol=2e-4)
    assert set(tc) == set(jc)
    for t in range(32, 36):
        want, jc = JM.decode_step(jp, _slice(jb, t, t + 1), jc, jnp.int32(t),
                                  jcfg)
        with torch.no_grad():
            got, tc = TM.decode_step(tp, _slice(tb, t, t + 1), tc, t, cfg)
        for ref in (full[:, t:t + 1], _np(want)):
            np.testing.assert_allclose(_np(got), ref, rtol=1e-3, atol=1e-3)
    for part in tc:
        for key in tc[part]:
            np.testing.assert_allclose(_np(tc[part][key]),
                                       _np(jc[part][key]), rtol=1e-3,
                                       atol=1e-3)


def test_decode_from_empty_cache_matches_reference(case):
    name, jcfg, cfg, jp, tp = case
    jc = JM.make_cache(jcfg, 2, 8)
    tc = TM.make_cache(cfg, 2, 8, device="cpu")
    assert set(tc) == set(jc)
    for part in jc:
        assert set(tc[part]) == set(jc[part])
        for key in jc[part]:
            np.testing.assert_array_equal(_np(tc[part][key]),
                                          _np(jc[part][key]))
    jb, tb = _inputs(cfg, 2, 2, 7)
    for s in range(2):
        want, jc = JM.decode_step(jp, _slice(jb, s, s + 1), jc, jnp.int32(s),
                                  jcfg)
        with torch.no_grad():
            got, tc2 = TM.decode_step(tp, _slice(tb, s, s + 1), tc, s, cfg)
        assert tc2 is tc                            # written in place
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("layers,apps", [(4, 2), (5, 2), (7, 3), (1, 0)])
def test_shared_applications_full_groups_only(layers, apps):
    jcfg = dataclasses.replace(jax_reduced("zamba2-7b"), n_layers=layers)
    cfg = dataclasses.replace(get_reduced("zamba2-7b"), n_layers=layers)
    assert TM.n_shared_applications(cfg) \
        == JM.n_shared_applications(jcfg) == apps
    cache = TM.make_cache(cfg, 1, 8, device="cpu")
    assert cache["shared"]["k"].shape[0] == apps
    assert cache["layers"]["ssm"].shape[0] == layers
    if layers == 1:
        with torch.no_grad():
            _, pc = TM.prefill(TM.init_params(cfg, device="cpu"),
                               {"tokens": torch.zeros(1, 3, dtype=torch.long)},
                               cfg, max_len=8)
        assert pc["shared"]["k"].shape == cache["shared"]["k"].shape
    assert TM.n_shared_applications(get_config("zamba2-7b")) == 13


# ---------------------------------------------------------------------------
# M-RoPE, the codebook head and the loss
# ---------------------------------------------------------------------------

def test_mrope_sections_match_reference():
    r = np.random.RandomState(0)
    x = r.randn(2, 8, 2, 16).astype(np.float32)
    pos1 = np.tile(np.arange(8), (2, 1))
    pos3 = np.stack([pos1, pos1 * 2 + 1, pos1 * 3], axis=-1)
    want = jcm.apply_rope(jnp.asarray(x), jnp.asarray(pos3), 1e6,
                          mrope_sections=(2, 3, 3))
    got = tcm.apply_rope(torch.as_tensor(x), torch.as_tensor(pos3), 1e6,
                         mrope_sections=(2, 3, 3))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)
    plain = tcm.apply_rope(torch.as_tensor(x), torch.as_tensor(pos1), 1e6)
    assert not np.allclose(_np(got), _np(plain))
    with pytest.raises(ValueError, match="sections"):
        tcm.apply_rope(torch.as_tensor(x), torch.as_tensor(pos3),
                       mrope_sections=(2, 3))


def test_mrope_equal_streams_is_plain_rope():
    x = torch.as_tensor(np.random.RandomState(1).randn(1, 8, 2, 16)
                        .astype(np.float32))
    pos1 = torch.arange(8)[None]
    same = tcm.apply_rope(x, torch.stack([pos1] * 3, dim=-1),
                          mrope_sections=(2, 3, 3))
    np.testing.assert_allclose(_np(same), _np(tcm.apply_rope(x, pos1)),
                               rtol=1e-6, atol=1e-6)


def test_codebook_head_matches_reference():
    r = np.random.RandomState(2)
    x = r.randn(2, 5, 16).astype(np.float32)
    w = r.randn(4, 16, 32).astype(np.float32)
    want = jcm.unembed_apply({"w": jnp.asarray(w)}, jnp.asarray(x),
                             jnp.float32, n_heads=4)
    got = tcm.unembed_apply({"w": torch.as_tensor(w)}, torch.as_tensor(x),
                            n_heads=4)
    assert got.shape == (2, 5, 4, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    # A bf16 head accumulates in fp32: the products of the bf16 operands.
    xb, wb = torch.as_tensor(x).bfloat16(), torch.as_tensor(w).bfloat16()
    got = tcm.unembed_apply({"w": wb}, xb, n_heads=4)
    exact = torch.einsum("bld,hdv->blhv", xb.double(), wb.double())
    np.testing.assert_allclose(_np(got), _np(exact), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True], ids=["mean", "mask"])
def test_lm_loss_over_codebooks_matches_reference(masked):
    jcfg, cfg = jax_reduced("musicgen-large"), get_reduced("musicgen-large")
    r = np.random.RandomState(3)
    B, L, Cb, V = 2, 6, cfg.n_codebooks, cfg.padded_vocab
    logits = r.randn(B, L, Cb, V).astype(np.float32)
    logits[..., V - 1] = 50.0        # a padded entry, masked out
    labels = r.randint(0, cfg.vocab_size, (B, L, Cb))
    mask = (r.rand(B, L) > 0.3).astype(np.float32) if masked else None
    want = JM.lm_loss(jnp.asarray(logits), jnp.asarray(labels), jcfg,
                      None if mask is None else jnp.asarray(mask))
    got = TM.lm_loss(torch.as_tensor(logits), torch.as_tensor(labels), cfg,
                     None if mask is None else torch.as_tensor(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# Parameters, batches, training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_serving_dtypes(arch):
    """Projection matrices and the codebook head in bf16; norm gains and
    the Mamba2 mixer's vectors and conv in fp32, as the reference reads
    them; every leaf its def's shape, drawn deterministically."""
    cfg = get_reduced(arch, compute_dtype="bfloat16")
    p = TM.init_params(cfg, seed=0, device="cpu")
    defs = TM.model_defs(cfg)
    assert set(p) == set(defs)
    fp32 = ("/scale", "/norm", "/a_log", "/d_skip", "/dt_bias", "/conv_w",
            "/conv_b")
    for name, t in p.items():
        assert tuple(t.shape) == defs[name].shape, name
        want = torch.float32 if name.endswith(fp32) else torch.bfloat16
        assert t.dtype == want, name
    if cfg.ssm is not None:
        a = p["blocks/mixer/a_log"].exp()
        assert bool(((a >= 1) & (a <= 16)).all())
    again = TM.init_params(cfg, seed=0, device="cpu")
    assert all(torch.equal(p[k], again[k]) for k in p)


@pytest.mark.parametrize("arch", ["musicgen-large", "qwen2-vl-72b",
                                  "mamba2-370m"])
def test_batch_for_model_bit_equal_to_reference(arch):
    from repro.data.pipeline import DataConfig as JDataConfig
    from repro.data.pipeline import batch_for_model as jax_batch
    from repro_torch.data.pipeline import DataConfig, batch_for_model

    cfg = get_reduced(arch)
    kw = dict(vocab_size=cfg.vocab_size, seq_len=12, global_batch=3)
    for step in (0, 5):
        want = jax_batch(jax_reduced(arch), JDataConfig(**kw), step)
        got = batch_for_model(cfg, DataConfig(**kw), step)
        assert set(got) == set(want)
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key])
    if cfg.n_codebooks > 1:
        assert got["labels"].shape == (3, 12, cfg.n_codebooks)
    assert ("embeds" in got) == (cfg.frontend == "embeds")


@pytest.mark.parametrize("arch", ["musicgen-large", "qwen2-vl-72b"])
def test_batch_for_model_with_a_drawn_table_is_bit_equal(arch):
    """A table drawn once with ``embed_table`` and passed to every batch
    (as ``run_training`` does) gives the batches of the default draw."""
    from repro_torch.data.pipeline import (DataConfig, batch_for_model,
                                           embed_table)

    cfg = get_reduced(arch)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=12,
                          global_batch=3, seed=4)
    table = embed_table(data_cfg, cfg.d_model)
    for step in (0, 5):
        want = batch_for_model(cfg, data_cfg, step)
        got = batch_for_model(cfg, data_cfg, step, table=table)
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])
