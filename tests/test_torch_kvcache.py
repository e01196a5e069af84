"""The port's paged KV cache against ``repro.kvcache``: the page pool,
the int8 inserts (equal payloads, scales within 1e-6 relative, written in
place), ``gather_kv`` and the analytic page size."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import kvcache as jkvc
from repro.core.hardware import V5E
from repro.tuning.attention import _analytic_config
from repro_torch import kvcache as tkvc
from repro_torch.kvcache import PagePool, PagePoolExhausted
from repro_torch.tuning import KernelRegistry, resolve_page_size

N_PAGES, PAGE, HKV, D, MAX_PAGES = 10, 4, 2, 8, 4


def test_pool_alloc_free_lifecycle():
    pool = PagePool(8, 16)
    assert [pool.pages_for(n) for n in (0, 1, 16, 17)] == [0, 1, 1, 2]
    ids = pool.alloc(1, 40)
    assert ids == [0, 1, 2] and pool.n_free == 5 and pool.n_used == 3
    assert tuple(pool.owned(1)) == tuple(ids)
    with pytest.raises(ValueError):
        pool.alloc(1, 1)
    pool.alloc(2, 80)
    assert pool.n_free == 0
    with pytest.raises(PagePoolExhausted):
        pool.alloc(3, 1)
    assert pool.free(1) == ids
    assert pool.can_admit(48) and not pool.can_admit(64)
    assert pool.free(99) == []
    pool.free(2)
    assert pool.n_free == 8 and pool.owned(2) == ()
    with pytest.raises(ValueError):
        PagePool(0, 16)


def _stale_model_caches(rng):
    """One-layer model caches of both packages whose every page holds a
    previous tenant's int8 bytes at a positive scale."""
    jc = jkvc.make_paged_cache(N_PAGES, PAGE, HKV, D, D, 2, MAX_PAGES)
    stale = {"k": rng.randint(-127, 128, jc["k"].shape).astype(np.int8),
             "v": rng.randint(-127, 128, jc["v"].shape).astype(np.int8),
             "k_scale": rng.rand(N_PAGES).astype(np.float32) + 1,
             "v_scale": rng.rand(N_PAGES).astype(np.float32) + 1}
    jc.update({k: jnp.asarray(v) for k, v in stale.items()})
    tc = tkvc.make_paged_cache(N_PAGES, PAGE, HKV, D, D, 2, MAX_PAGES,
                               device="cpu")
    for k, v in stale.items():
        tc[k].copy_(torch.as_tensor(v))
    return ({"layers": jax.tree.map(lambda t: t[None], jc)},
            {"layers": {k: v[None].clone() for k, v in tc.items()}})


def _assert_same_cache(jl, tl):
    for key in ("k", "v", "tables", "len"):
        np.testing.assert_array_equal(tl[key].numpy(), np.asarray(jl[key]),
                                      err_msg=key)
    for key in ("k_scale", "v_scale"):
        np.testing.assert_allclose(tl[key].numpy(), np.asarray(jl[key]),
                                   rtol=1e-6, atol=0, err_msg=key)


@pytest.mark.parametrize("L", [7, 8, 3], ids=["ragged", "whole", "short"])
def test_inserts_match_reference_in_place(L):
    """Prefill L tokens into reused (stale) pages, then append decode
    tokens of growing magnitude past the prefill's pages into a fresh
    stale page: payloads equal, scales within 1e-6 relative, every step,
    and the port's layer views write through to the stacked pool."""
    rng = np.random.RandomState(L)
    jm, tm = _stale_model_caches(rng)
    for b, ids in enumerate(([7, 2, 5, 0], [3, 9, 1, 8])):
        jm = jkvc.model_assign_sequence(jm, b, ids)
        assert tkvc.model_assign_sequence(tm, b, ids) is tm
    jl = jax.tree.map(lambda t: t[0], jm["layers"])
    tl = {k: v[0] for k, v in tm["layers"].items()}
    k = rng.randn(2, L, HKV, D).astype(np.float32)
    v = rng.randn(2, L, HKV, D).astype(np.float32)
    jl = jkvc.paged_prefill_insert(jl, jnp.asarray(k), jnp.asarray(v))
    assert tkvc.paged_prefill_insert(tl, torch.as_tensor(k),
                                     torch.as_tensor(v)) is tl
    _assert_same_cache(jl, tl)
    for t in range((-(-L // PAGE) + 1) * PAGE + 1 - L):
        kn = (rng.randn(2, 1, HKV, D) * (1 + t)).astype(np.float32)
        vn = (rng.randn(2, 1, HKV, D) * (1 + t)).astype(np.float32)
        jl = jkvc.paged_decode_insert(jl, jnp.asarray(kn), jnp.asarray(vn))
        tkvc.paged_decode_insert(tl, torch.as_tensor(kn),
                                 torch.as_tensor(vn))
        _assert_same_cache(jl, tl)
    _assert_same_cache(jl, {k: v[0] for k, v in tm["layers"].items()})
    # The first append onto a fresh page killed its stale bytes: slots
    # past the length dequantize to exactly 0.
    gk, _, pos = tkvc.gather_kv(tl)
    n = int(tl["len"][0])
    assert n > -(-L // PAGE) * PAGE
    assert float(gk[0, n:-(-n // PAGE) * PAGE].abs().max()) == 0.0
    assert torch.equal(pos[0, n:], torch.full_like(pos[0, n:], -1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_kv_matches_reference(dtype):
    rng = np.random.RandomState(4)
    jm, tm = _stale_model_caches(rng)
    jm = jkvc.model_assign_sequence(jm, 0, [6, 1])
    jm = jkvc.model_assign_sequence(jm, 1, [4])
    tkvc.model_assign_sequence(tm, 0, [6, 1])
    tkvc.model_assign_sequence(tm, 1, [4])
    jl = jax.tree.map(lambda t: t[0], jm["layers"])
    tl = {k: v[0] for k, v in tm["layers"].items()}
    k = rng.randn(2, 3, HKV, D).astype(np.float32)
    jl = jkvc.paged_prefill_insert(jl, jnp.asarray(k), jnp.asarray(k))
    tkvc.paged_prefill_insert(tl, torch.as_tensor(k), torch.as_tensor(k))
    want = jkvc.gather_kv(jl, dtype=getattr(jnp, dtype))
    got = tkvc.gather_kv(tl, dtype=getattr(torch, dtype))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w).astype(np.float32),
                                   rtol=1e-6, atol=0)
    assert got[0].dtype == getattr(torch, dtype)


def test_release_unmaps_tables():
    _, tm = _stale_model_caches(np.random.RandomState(5))
    tkvc.model_assign_sequence(tm, 0, [2, 3])
    assert tm["layers"]["tables"][0, 0, :2].tolist() == [2, 3]
    assert tm["layers"]["k_scale"][0, [2, 3]].tolist() == [0.0, 0.0]
    tkvc.model_release_sequence(tm, 0)
    assert bool((tm["layers"]["tables"] == -1).all())
    assert int(tm["layers"]["len"][0, 0]) == 0
    with pytest.raises(ValueError, match="slots"):
        tkvc.model_assign_sequence(tm, 0, list(range(MAX_PAGES + 1)))


@pytest.mark.parametrize("seq_len", [8, 32, 160, 1056, 5000])
def test_page_size_matches_reference_analytic(seq_len, tmp_path,
                                              monkeypatch):
    """The analytic tier of the port's page-size resolution (a fresh
    registry over an empty cache, autotune off) equals the reference's."""
    monkeypatch.setenv("REPRO_TORCH_TUNING_CACHE", str(tmp_path / "c.json"))
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE", raising=False)
    registry = KernelRegistry()
    for heads, kv_heads, head_dim in ((32, 32, 64), (32, 8, 120)):
        want = _analytic_config("paged_decode", heads=heads,
                                kv_heads=kv_heads, head_dim=head_dim,
                                seq_len=seq_len, kv_dtype=jnp.int8,
                                hw=V5E).kv_block
        got = resolve_page_size(heads=heads, kv_heads=kv_heads,
                                head_dim=head_dim, seq_len=seq_len,
                                registry=registry)
        assert got.source == "analytic"
        assert got.config.kv_block == want
