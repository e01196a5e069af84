"""The reference's small public helpers and constants the port now also
names, each against the reference on the same numpy inputs:
``models.common.count_params``, ``wcast`` and ``init_params``,
``quant.scales.dequantize``, ``kernels.epilogue.stream_cost`` and
``with_dequant``, ``kvcache.paged.PAGED_KEYS``, ``core.gemm.ca_einsum``
(matmul-shaped specs through ``ca_matmul``, on K1 on a card) and
``optim.adamw.clip_by_global_norm``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_isolation import isolated_port_state  # noqa: F401  (autouse)
from repro.core import gemm as jgemm
from repro.kernels import epilogue as jepi
from repro.kvcache import paged as jpaged
from repro.models import common as jcm
from repro.optim import adamw as jadamw
from repro.quant import scales as jscales
from repro_torch.configs import get_reduced
from repro_torch.core import gemm
from repro_torch.kernels import epilogue as epi
from repro_torch.kvcache import paged
from repro_torch.models import common as cm
from repro_torch.models.model import model_defs
from repro_torch.optim import adamw
from repro_torch.quant import scales


def _quantized(rng):
    w = rng.randn(64, 48).astype(np.float32)
    q = scales.quantize(torch.from_numpy(w), axis=-2, block=16)
    jq = jscales.QTensor(data=jnp.asarray(q.data.numpy()),
                         scale=jnp.asarray(q.scale.numpy()), axis=q.axis,
                         block=q.block, fmt=q.fmt)
    return q, jq


def test_count_params_matches_the_reference():
    rng = np.random.RandomState(0)
    q, jq = _quantized(rng)
    arrays = {"a": rng.randn(3, 5).astype(np.float32),
              "b": rng.randn(7).astype(np.float32)}
    port = {k: torch.from_numpy(v) for k, v in arrays.items()}
    ref = {k: jnp.asarray(v) for k, v in arrays.items()}
    assert cm.count_params(port) == jcm.count_params(ref) == 22
    port["q"], ref["q"] = q, jq
    assert cm.count_params(port) == jcm.count_params(ref) == 22 + 64 * 48


def test_wcast_matches_the_reference():
    rng = np.random.RandomState(1)
    w = rng.randn(8, 4).astype(np.float32)
    got = cm.wcast(torch.from_numpy(w), torch.bfloat16)
    want = jcm.wcast(jnp.asarray(w), jnp.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    q, jq = _quantized(rng)
    assert cm.wcast(q, torch.bfloat16) is q
    assert jcm.wcast(jq, jnp.bfloat16) is jq


def test_init_params_matches_the_reference_laws():
    """The same keys, shapes and dtypes as the reference's
    ``init_params(defs, key)``; the constant laws equal; each drawn leaf
    of 4096 or more elements within 5 % of the reference's std and inside
    its range (the truncated normal's 2 sigma).  The numbers differ:
    ``jax.random`` is not torch's generator."""
    defs = model_defs(get_reduced("stablelm-1.6b"))
    got = cm.init_params(defs, seed=3)
    want = jcm.init_params(defs, jax.random.PRNGKey(3))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = np.asarray(w)
        g = got[k].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if defs[k].init in ("zeros", "ones"):
            np.testing.assert_array_equal(g, w, err_msg=k)
        elif w.size >= 4096:
            np.testing.assert_allclose(g.std(), w.std(), rtol=0.05,
                                       err_msg=k)
            assert np.abs(g).max() <= np.abs(w).max() * 1.05 + 1e-6 \
                or defs[k].init == "embed", k
    again = cm.init_params(defs, seed=3)
    assert all(torch.equal(again[k], got[k]) for k in got)


@pytest.mark.parametrize("block", [0, 16])
def test_dequantize_matches_the_reference(block):
    rng = np.random.RandomState(2)
    w = rng.randn(64, 24).astype(np.float32)
    q = scales.quantize(torch.from_numpy(w), axis=-2, block=block)
    jq = jscales.QTensor(data=jnp.asarray(q.data.numpy()),
                         scale=jnp.asarray(q.scale.numpy()), axis=q.axis,
                         block=q.block, fmt=q.fmt)
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        got = scales.dequantize(q, dt)
        want = jscales.dequantize(jq, jdt)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))


TAGS = ["none", "bias", "silu", "res", "silu+mul", "bias+gelu+mul+res",
        "dqb", "dqab+res", "dqb+bias+silu+mul+res"]


@pytest.mark.parametrize("tag", TAGS)
def test_stream_cost_and_with_dequant_match_the_reference(tag):
    assert epi.stream_cost(tag) == jepi.stream_cost(tag)
    for mode in ("b", "ab"):
        assert epi.with_dequant(tag, mode) == jepi.with_dequant(tag, mode)
        once = epi.with_dequant(tag, mode)
        assert epi.with_dequant(once, mode) == once


def test_paged_keys_match_the_reference_and_the_cache():
    assert paged.PAGED_KEYS == jpaged.PAGED_KEYS
    cache = paged.make_paged_cache(4, 8, 2, 16, 16, 2, 3, "cpu")
    assert tuple(cache) == paged.PAGED_KEYS


EINSUMS = [("bld,dn->bln", (2, 5, 16), (16, 12), True),
           ("md,dn->mn", (7, 16), (16, 9), True),
           ("bld,hdv->blhv", (2, 5, 16), (3, 16, 4), False),
           ("bld,nd->bln", (2, 5, 16), (12, 16), False)]


@pytest.mark.parametrize("spec,xs,ws,on_k1", EINSUMS,
                         ids=[e[0] for e in EINSUMS])
def test_ca_einsum_matches_the_reference(spec, xs, ws, on_k1, monkeypatch):
    """Matmul-shaped specs go through ``ca_matmul`` (K1 on a card, its
    plain version here), the rest through an fp32 einsum: values within
    fp32 rounding of the reference's (its GEMM mode ``xla``)."""
    rng = np.random.RandomState(4)
    x = rng.randn(*xs).astype(np.float32)
    w = rng.randn(*ws).astype(np.float32)
    calls = []
    real = gemm.ca_matmul
    monkeypatch.setattr(gemm, "ca_matmul",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    got = gemm.ca_einsum(spec, torch.from_numpy(x), torch.from_numpy(w))
    with jgemm.gemm_mode("xla"):
        want = jgemm.ca_einsum(spec, jnp.asarray(x), jnp.asarray(w))
    assert len(calls) == int(on_k1)
    assert tuple(got.shape) == tuple(want.shape)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_ca_einsum_takes_keywords_only_where_matmul_shaped():
    x, w = torch.ones(2, 4), torch.ones(3, 4, 5)
    with pytest.raises(ValueError, match="not matmul-shaped"):
        gemm.ca_einsum("md,hdv->mhv", x, w, out_dtype=torch.float32)
    y = gemm.ca_einsum("md,dn->mn", x, torch.ones(4, 5),
                       out_dtype=torch.bfloat16)
    assert y.dtype == torch.bfloat16


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_the_reference(max_norm):
    rng = np.random.RandomState(5)
    tree = {"a": rng.randn(6, 5).astype(np.float32) * 3,
            "b": rng.randn(9).astype(np.float32)}
    port = {"a": torch.from_numpy(tree["a"]).to(torch.bfloat16),
            "b": torch.from_numpy(tree["b"])}
    ref = {"a": jnp.asarray(tree["a"]).astype(jnp.bfloat16),
           "b": jnp.asarray(tree["b"])}
    got, norm = adamw.clip_by_global_norm(port, max_norm)
    want, jnorm = jadamw.clip_by_global_norm(ref, max_norm)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
    for k in tree:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(),
                                   np.asarray(want[k], np.float32),
                                   rtol=1e-6)
