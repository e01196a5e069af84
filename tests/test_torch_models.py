"""The port's model on reduced stablelm-1.6b in fp32 against
``repro.models.model``, with the reference's parameters converted by
``params_from_jax``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.models import model as JM
from repro_torch.configs import get_reduced
from repro_torch.models import attention as tattn
from repro_torch.models import model as TM

ARCH = "stablelm-1.6b"


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_reduced(ARCH)
    cfg = get_reduced(ARCH)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = TM.params_from_jax({k: np.asarray(v) for k, v in jp.items()}, cfg,
                            device="cpu")
    return jcfg, cfg, jp, tp


def _np(x):
    return np.asarray(x) if not isinstance(x, torch.Tensor) \
        else x.detach().numpy()


def test_forward_logits_match_reference(setup):
    jcfg, cfg, jp, tp = setup
    toks = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 37))
    want, _, _ = JM.forward(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                            jcfg)
    got, cache = TM.forward(tp, {"tokens": torch.as_tensor(toks)}, cfg)
    assert cache is None and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)


def test_prefill_and_decode_match_reference(setup):
    jcfg, cfg, jp, tp = setup
    r = np.random.RandomState(1)
    prompt = r.randint(0, cfg.vocab_size, (1, 9))
    want, jc = JM.prefill(jp, {"tokens": jnp.asarray(prompt, jnp.int32)},
                          jcfg, max_len=16)
    got, tc = TM.prefill(tp, {"tokens": torch.as_tensor(prompt)}, cfg,
                         max_len=16)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)
    for s in range(3):
        nxt = r.randint(0, cfg.vocab_size, (1, 1))
        pos = prompt.shape[1] + s
        want, jc = JM.decode_step(jp, {"tokens": jnp.asarray(nxt, jnp.int32)},
                                  jc, jnp.int32(pos), jcfg)
        got, tc = TM.decode_step(tp, {"tokens": torch.as_tensor(nxt)}, tc,
                                 pos, cfg)
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4,
                                   atol=1e-4)
        for key in ("k", "v"):
            np.testing.assert_allclose(_np(tc["layers"][key]),
                                       _np(jc["layers"][key]),
                                       rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(_np(tc["layers"]["pos"]),
                                      _np(jc["layers"]["pos"]))


def test_params_cast_once_norm_gains_stay_fp32(setup):
    jcfg, _, jp, _ = setup
    cfg = get_reduced(ARCH, compute_dtype="bfloat16")
    tp = TM.params_from_jax({k: np.asarray(v) for k, v in jp.items()}, cfg,
                            device="cpu")
    for name, t in tp.items():
        want = torch.float32 if name.endswith("/scale") else torch.bfloat16
        assert t.dtype == want, name
    with pytest.raises(ValueError, match="missing"):
        TM.params_from_jax({"embed/table": np.asarray(jp["embed/table"])},
                           cfg, device="cpu")


def test_init_params_laws_and_layout():
    cfg = get_reduced(ARCH, compute_dtype="bfloat16")
    p = TM.init_params(cfg, seed=0, device="cpu")
    defs = TM.model_defs(cfg)
    assert set(p) == set(defs)
    for name, t in p.items():
        assert tuple(t.shape) == defs[name].shape, name
    assert torch.equal(p["norm_f/scale"], torch.ones(cfg.d_model))
    wq = p["blocks/attn/wq"].float()
    std = 1 / np.sqrt(cfg.d_model)
    assert wq.abs().max() <= 2 * std * 1.01          # truncated at 2 sigma
    assert 0.7 * std < wq.std() < 1.0 * std          # std of N(0,1)|2 = 0.88
    again = TM.init_params(cfg, seed=0, device="cpu")
    assert all(torch.equal(p[k], again[k]) for k in p)


def test_dense_attention_agrees_with_flash_for_several_queries():
    # dense_attention serves decode (Lq = 1); for Lq > 1 it must still
    # put each query's heads in its own row, as the chunked path does.
    r = np.random.RandomState(2)
    q = torch.as_tensor(r.randn(2, 6, 4, 8)).float()
    k = torch.as_tensor(r.randn(2, 6, 2, 8)).float()
    v = torch.as_tensor(r.randn(2, 6, 2, 8)).float()
    pos = torch.arange(6)[None].expand(2, 6)
    want = tattn.flash_attention(q, k, v, q_positions=pos, kv_positions=pos,
                                 q_chunk=4, kv_chunk=4)
    got = tattn.dense_attention(q, k, v, q_positions=pos, kv_positions=pos)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


def test_config_field_equal_to_reference():
    import dataclasses

    from repro.configs import get_config as jax_config
    from repro_torch.configs import get_config

    want, got = jax_config(ARCH), get_config(ARCH)
    assert [f.name for f in dataclasses.fields(got)] \
        == [f.name for f in dataclasses.fields(want)]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.padded_vocab, got.n_params()) \
        == (want.padded_vocab, want.n_params())
    assert got.dtype() == torch.bfloat16 and got.pdtype() == torch.float32


def test_decode_from_empty_cache_matches_reference(setup):
    jcfg, cfg, jp, tp = setup
    jc = JM.make_cache(jcfg, 1, 8)
    tc = TM.make_cache(cfg, 1, 8, device="cpu")
    for key in ("k", "v", "pos"):
        np.testing.assert_array_equal(_np(tc["layers"][key]),
                                      _np(jc["layers"][key]))
    nxt = np.array([[11]])
    want, jc = JM.decode_step(jp, {"tokens": jnp.asarray(nxt, jnp.int32)},
                              jc, jnp.int32(0), jcfg)
    got, tc = TM.decode_step(tp, {"tokens": torch.as_tensor(nxt)}, tc, 0,
                             cfg)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(_np(tc["layers"]["pos"]),
                                  _np(jc["layers"]["pos"]))


DANUBE = "h2o-danube-3-4b"


def _arch_setup(arch):
    jcfg, cfg = jax_reduced(arch), get_reduced(arch)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = TM.params_from_jax({k: np.asarray(v) for k, v in jp.items()}, cfg,
                            device="cpu")
    return jcfg, cfg, jp, tp


def test_danube_forward_logits_match_reference():
    # 37 tokens run past the reduced config's 32-token window.
    jcfg, cfg, jp, tp = _arch_setup(DANUBE)
    toks = np.random.RandomState(5).randint(0, cfg.vocab_size, (2, 37))
    want, _, _ = JM.forward(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                            jcfg)
    got, _ = TM.forward(tp, {"tokens": torch.as_tensor(toks)}, cfg)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", [ARCH, DANUBE])
def test_paged_prefill_and_decode_match_reference(arch):
    """Prefill into assigned pages, then decode steps on the paged cache:
    logits at 1e-4 and the int8 pools equal to the reference's, with the
    port's cache returned as the same dict, written in place."""
    from repro import kvcache as jkvc
    from repro_torch import kvcache as tkvc

    jcfg, cfg, jp, tp = _arch_setup(arch)
    geo = dict(n_pages=6, page_size=8, max_pages=5)
    jc = jkvc.model_assign_sequence(
        JM.make_paged_model_cache(jcfg, 1, **geo), 0, [4, 0, 5, 2, 1])
    tc = tkvc.model_assign_sequence(
        TM.make_paged_model_cache(cfg, 1, device="cpu", **geo), 0,
        [4, 0, 5, 2, 1])
    r = np.random.RandomState(6)
    prompt = r.randint(0, cfg.vocab_size, (1, 27))
    want, jc = JM.prefill(jp, {"tokens": jnp.asarray(prompt, jnp.int32)},
                          jcfg, cache=jc)
    got, tc2 = TM.prefill(tp, {"tokens": torch.as_tensor(prompt)}, cfg,
                          cache=tc)
    assert tc2 is tc
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)
    for s in range(6):
        nxt = r.randint(0, cfg.vocab_size, (1, 1))
        want, jc = JM.decode_step(jp, {"tokens": jnp.asarray(nxt, jnp.int32)},
                                  jc, jnp.int32(27 + s), jcfg)
        got, tc = TM.decode_step(tp, {"tokens": torch.as_tensor(nxt)}, tc,
                                 27 + s, cfg)
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4,
                                   atol=1e-4)
    lay, jlay = tc["layers"], jc["layers"]
    assert lay["len"].tolist() == [[33]] * cfg.n_layers
    for key in ("k", "v", "tables", "len"):
        np.testing.assert_array_equal(_np(lay[key]), _np(jlay[key]))
    for key in ("k_scale", "v_scale"):
        np.testing.assert_allclose(_np(lay[key]), _np(jlay[key]), rtol=1e-6)


# ---------------------------------------------------------------------------
# int8 weights (K1d) and w8a8 (K1e) on reduced stablelm-1.6b
# ---------------------------------------------------------------------------

def as_numpy_params(tree):
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


@pytest.mark.parametrize("block", [0, 128], ids=["channel", "tile128"])
def test_quantize_params_matches_reference(setup, block):
    from repro.models import common as jcm
    from repro.quant import QuantConfig as JQC
    from repro_torch.models import common as tcm
    from repro_torch.quant import QTensor, QuantConfig

    jcfg, cfg, jp, tp = setup
    jq = jcm.quantize_params(jp, JQC(block=block))
    tq = tcm.quantize_params(tp, QuantConfig(block=block))
    jkeys = {k for k, v in jq.items() if not isinstance(v, jax.Array)}
    tkeys = {k for k, v in tq.items() if isinstance(v, QTensor)}
    assert tkeys == jkeys and "head/w" in tkeys
    assert "embed/table" not in tkeys and "norm_f/scale" not in tkeys
    for key in tkeys:
        np.testing.assert_array_equal(tq[key].data.numpy(),
                                      np.asarray(jq[key].data))
        np.testing.assert_allclose(tq[key].scale.numpy(),
                                   np.asarray(jq[key].scale), rtol=1e-6)
        assert (tq[key].axis, tq[key].block) == (jq[key].axis, block)
    # params_from_jax carries the reference's quantized leaves unchanged.
    carried = TM.params_from_jax(as_numpy_params(jq), cfg, device="cpu")
    for key in tkeys:
        assert isinstance(carried[key], QTensor)
        assert torch.equal(carried[key].data, tq[key].data)
        np.testing.assert_allclose(carried[key].scale.numpy(),
                                   tq[key].scale.numpy(), rtol=1e-6)
    for key in set(tq) - tkeys:
        assert torch.equal(carried[key], tq[key])


@pytest.mark.parametrize("mode", ["int8w", "w8a8"])
def test_quantized_prefill_and_decode_match_reference(setup, mode):
    """The reference's quantized weights (and, for w8a8, its calibrated
    static activation scales) in both packages: the reference dequantizes
    up front (its xla oracle path), the port runs the dqb / dqab
    programs' plain versions."""
    from repro.models import common as jcm
    from repro.serve.engine import ServeEngine as JServeEngine

    jcfg, cfg, jp, _ = setup
    jq = jcm.quantize_params(jp)
    if mode == "w8a8":
        jq = JServeEngine(jq, jcfg, batch_size=1, max_len=16,
                          warmup_gemms=False,
                          quantize_activations=True).params
    tq = TM.params_from_jax(as_numpy_params(jq), cfg, device="cpu")
    r = np.random.RandomState(5)
    prompt = r.randint(0, cfg.vocab_size, (1, 9))
    want, jc = JM.prefill(jq, {"tokens": jnp.asarray(prompt, jnp.int32)},
                          jcfg, max_len=16)
    got, tc = TM.prefill(tq, {"tokens": torch.as_tensor(prompt)}, cfg,
                         max_len=16)
    tol = dict(rtol=2e-4, atol=2e-3 * np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    nxt = r.randint(0, cfg.vocab_size, (1, 1))
    want, _ = JM.decode_step(jq, {"tokens": jnp.asarray(nxt, jnp.int32)},
                             jc, jnp.int32(9), jcfg)
    got, _ = TM.decode_step(tq, {"tokens": torch.as_tensor(nxt)}, tc, 9, cfg)
    np.testing.assert_allclose(_np(got), _np(want), **tol)


# ---------------------------------------------------------------------------
# The other architectures: granite-20b (GELU MLP, one KV head),
# deepseek-v2-lite-16b (MoE + MLA), minicpm3-4b (MLA with q-LoRA) and
# mixtral-8x7b (MoE + sliding window)
# ---------------------------------------------------------------------------

NEW_ARCHS = ["granite-20b", "deepseek-v2-lite-16b", "minicpm3-4b",
             "mixtral-8x7b"]
MLA_ARCHS = ["deepseek-v2-lite-16b", "minicpm3-4b"]


@pytest.mark.parametrize("arch", [ARCH, DANUBE] + NEW_ARCHS)
def test_ported_config_fields_and_n_params_equal_reference(arch):
    import dataclasses

    from repro.configs import get_config as jax_config
    from repro_torch.configs import get_config, list_archs

    assert arch in list_archs()
    for want, got in ((jax_config(arch), get_config(arch)),
                      (jax_reduced(arch), get_reduced(arch))):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert (got.padded_vocab, got.n_params(), got.active_params()) \
            == (want.padded_vocab, want.n_params(), want.active_params())


@pytest.fixture(scope="module", params=NEW_ARCHS)
def arch_setup(request):
    return (request.param,) + _arch_setup(request.param)


def test_new_arch_forward_logits_and_aux_match_reference(arch_setup):
    """37 tokens: past mixtral's reduced 32-token window, and enough to
    fill the reduced MoE archs' capacity buffers unevenly."""
    arch, jcfg, cfg, jp, tp = arch_setup
    toks = np.random.RandomState(5).randint(0, cfg.vocab_size, (2, 37))
    want, _, jaux = JM.forward(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                               jcfg)
    got, cache, aux = TM.forward(tp, {"tokens": torch.as_tensor(toks)}, cfg,
                                 return_aux=True)
    assert cache is None
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6,
                               atol=1e-6)
    assert (float(aux) > 0) == (cfg.moe is not None)


def test_new_arch_prefill_and_decode_match_reference(arch_setup):
    """Prefill on a batch of 2, then decode steps: logits at 1e-4 and the
    slab cache (k/v, or MLA's c/k_rope) against the reference's, slot for
    slot where the reference places them the same way."""
    arch, jcfg, cfg, jp, tp = arch_setup
    r = np.random.RandomState(1)
    prompt = r.randint(0, cfg.vocab_size, (2, 9))
    want, jc = JM.prefill(jp, {"tokens": jnp.asarray(prompt, jnp.int32)},
                          jcfg, max_len=16)
    got, tc = TM.prefill(tp, {"tokens": torch.as_tensor(prompt)}, cfg,
                         max_len=16)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)
    keys = ("c", "k_rope") if arch in MLA_ARCHS else ("k", "v")
    assert set(tc["layers"]) == set(keys) | {"pos"}
    for s in range(3):
        nxt = r.randint(0, cfg.vocab_size, (2, 1))
        want, jc = JM.decode_step(jp, {"tokens": jnp.asarray(nxt, jnp.int32)},
                                  jc, jnp.int32(9 + s), jcfg)
        got, tc = TM.decode_step(tp, {"tokens": torch.as_tensor(nxt)}, tc,
                                 9 + s, cfg)
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4,
                                   atol=1e-4)
        for key in keys:
            np.testing.assert_allclose(_np(tc["layers"][key]),
                                       _np(jc["layers"][key]),
                                       rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(_np(tc["layers"]["pos"]),
                                      _np(jc["layers"]["pos"]))


def test_new_arch_decode_from_empty_cache_matches_reference(arch_setup):
    arch, jcfg, cfg, jp, tp = arch_setup
    jc = JM.make_cache(jcfg, 2, 8)
    tc = TM.make_cache(cfg, 2, 8, device="cpu")
    assert set(tc["layers"]) == set(jc["layers"])
    for key in jc["layers"]:
        np.testing.assert_array_equal(_np(tc["layers"][key]),
                                      _np(jc["layers"][key]))
    nxt = np.array([[11], [3]])
    for s in range(2):
        want, jc = JM.decode_step(jp, {"tokens": jnp.asarray(nxt, jnp.int32)},
                                  jc, jnp.int32(s), jcfg)
        got, tc = TM.decode_step(tp, {"tokens": torch.as_tensor(nxt)}, tc,
                                 s, cfg)
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("arch", MLA_ARCHS, ids=["no_q_lora", "q_lora"])
def test_mla_decode_layer_matches_reference(arch):
    """One MLA layer's absorbed decode against the compressed cache of a
    7-token prefill, batch 2, without (deepseek) and with (minicpm3)
    q-LoRA: the output at 1e-4 and the new cache entries."""
    from repro.models import attention as jattn

    jcfg, cfg, jp, _ = _arch_setup(arch)
    pre = "blocks/attn/"
    jsub = {k[len(pre):]: v[0] for k, v in jp.items() if k.startswith(pre)}
    tsub = {k: torch.as_tensor(np.array(v)) for k, v in jsub.items()}
    assert ("wq_a" in tsub) == (arch == "minicpm3-4b")
    r = np.random.RandomState(9)
    x = r.randn(2, 7, cfg.d_model).astype(np.float32)
    pos = np.tile(np.arange(7), (2, 1))
    _, jc = jattn.mla_apply(jsub, jnp.asarray(x), jcfg,
                            positions=jnp.asarray(pos), mode="prefill",
                            max_len=12)
    _, tc = tattn.mla_apply(tsub, torch.as_tensor(x), cfg,
                            positions=torch.as_tensor(pos), mode="prefill",
                            max_len=12)
    for key in ("c", "k_rope", "pos"):
        np.testing.assert_allclose(_np(tc[key]), _np(jc[key]), rtol=1e-5,
                                   atol=1e-5)
    x1 = r.randn(2, 1, cfg.d_model).astype(np.float32)
    res = r.randn(2, 1, cfg.d_model).astype(np.float32)
    p1 = np.full((2, 1), 7)
    want, jc = jattn.mla_apply(jsub, jnp.asarray(x1), jcfg,
                               positions=jnp.asarray(p1), cache=jc,
                               step=jnp.int32(7), mode="decode",
                               residual=jnp.asarray(res))
    got, tc2 = tattn.mla_apply(tsub, torch.as_tensor(x1), cfg,
                               positions=torch.as_tensor(p1), cache=tc,
                               step=7, mode="decode",
                               residual=torch.as_tensor(res))
    assert tc2 is tc                                   # written in place
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)
    for key in ("c", "k_rope", "pos"):
        np.testing.assert_allclose(_np(tc[key]), _np(jc[key]), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_arch_init_params_laws_and_layout(arch):
    """Every leaf drawn by its law in its serving dtype: bf16 matrices
    and expert banks, fp32 norm gains and router; a stacked leaf drawn one
    layer at a time keeps the truncated-normal law in every layer."""
    cfg = get_reduced(arch, compute_dtype="bfloat16")
    p = TM.init_params(cfg, seed=0, device="cpu")
    defs = TM.model_defs(cfg)
    assert set(p) == set(defs)
    fp32 = ("/scale", "/q_norm", "/kv_norm", "/router")
    for name, t in p.items():
        assert tuple(t.shape) == defs[name].shape, name
        want = torch.float32 if name.endswith(fp32) else torch.bfloat16
        assert t.dtype == want, name
    bank = "blocks/moe/w_up" if cfg.moe is not None else "blocks/mlp/w_up"
    w = p[bank].float()
    std = 1 / np.sqrt(cfg.d_model)
    assert w.abs().max() <= 2 * std * 1.01
    for layer in w.unbind(0):
        assert 0.7 * std < layer.std() < 1.0 * std
    assert not torch.equal(w[0], w[1])
    again = TM.init_params(cfg, seed=0, device="cpu")
    assert all(torch.equal(p[k], again[k]) for k in p)


# The keys each arch's quantized tree must hold, and must not: the
# reference's predicate quantizes MLA's wq_a/wq_b/wkv_a and the shared
# experts' projections, and leaves the 4-D expert banks, wkv_b and the
# router dense.
QUANT_KEYS = {
    "granite-20b": ({"blocks/attn/wk", "blocks/mlp/w_up", "head/w"},
                    {"embed/table", "blocks/norm_ffn/scale"}),
    "deepseek-v2-lite-16b": (
        {"blocks/attn/wq", "blocks/attn/wkv_a", "blocks/attn/wo",
         "blocks/moe/shared/w_up", "head/w"},
        {"blocks/moe/w_up", "blocks/moe/w_down", "blocks/moe/router",
         "blocks/attn/wkv_b"}),
    "minicpm3-4b": ({"blocks/attn/wq_a", "blocks/attn/wq_b",
                     "blocks/attn/wkv_a", "blocks/mlp/w_gate"},
                    {"blocks/attn/wkv_b", "blocks/attn/q_norm"}),
    "mixtral-8x7b": ({"blocks/attn/wv", "head/w"},
                     {"blocks/moe/w_gate", "blocks/moe/router"}),
}


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_arch_quantize_params_matches_reference(arch):
    from repro.models import common as jcm
    from repro_torch.models import common as tcm
    from repro_torch.quant import QTensor

    jcfg, cfg, jp, tp = _arch_setup(arch)
    jq = jcm.quantize_params(jp)
    tq = tcm.quantize_params(tp)
    jkeys = {k for k, v in jq.items() if not isinstance(v, jax.Array)}
    tkeys = {k for k, v in tq.items() if isinstance(v, QTensor)}
    assert tkeys == jkeys
    quantized, dense = QUANT_KEYS[arch]
    assert quantized <= tkeys and not tkeys & dense
    for key in tkeys:
        np.testing.assert_array_equal(tq[key].data.numpy(),
                                      np.asarray(jq[key].data))
        np.testing.assert_allclose(tq[key].scale.numpy(),
                                   np.asarray(jq[key].scale), rtol=1e-6)
    carried = TM.params_from_jax(as_numpy_params(jq), cfg, device="cpu")
    for key in tkeys:
        assert torch.equal(carried[key].data, tq[key].data)
