"""The port's attention kernels' wrappers on the CPU against the
reference's Pallas kernels in interpret mode: paged decode attention (K2,
``paged_flash_attention_tpu``) on the same numpy-seeded int8 pools, and
forward flash attention (K3, ``flash_attention_tpu``) on numpy-seeded
q/k/v and positions.  The CUDA kernels themselves are held against the
plain versions in test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.kernels.flash_attn import (flash_attention_tpu,
                                      paged_flash_attention_tpu)
from repro_torch.kernels import flash_attn as FA
from repro_torch.kernels import ref as torch_ref
from repro_torch.models import attention as model_attention
from test_torch_cuda import POOL_KEYS, poisoned, query, random_pool


def _torch(pool):
    return [torch.as_tensor(pool[k]) for k in POOL_KEYS]


def _jax(pool):
    return [jnp.asarray(pool[k]) for k in POOL_KEYS]


@pytest.mark.parametrize("D", [32, 120])
@pytest.mark.parametrize("window", [None, 11], ids=["causal", "sliding"])
@pytest.mark.parametrize("gqa", [1, 2], ids=["mha", "gqa2"])
def test_paged_attention_matches_reference_kernel(gqa, window, D):
    """Ragged lengths crossing page boundaries, shuffled page ids."""
    Hkv, page = 2, 8
    pool = random_pool(0, [19, 27], page=page, n_pages=16, Hkv=Hkv, D=D)
    q = query(0, 2, Hkv * gqa, D)
    want = paged_flash_attention_tpu(jnp.asarray(q), *_jax(pool),
                                     window=window, interpret=True)
    FA.reset_launch_counts()
    got = FA.paged_flash_attention(torch.as_tensor(q), *_torch(pool),
                                   window=window)
    assert got.dtype == torch.float32 and FA.launch_counts == {}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("window", [None, 5], ids=["causal", "sliding"])
def test_paged_attention_48_query_heads_per_kv_head(window):
    """granite-20b's head geometry: 48 query heads over one KV head,
    D = 128, a short ragged batch; the reference folds the 48 heads into
    one tile, the port's kernel takes them 8 to a CTA."""
    pool = random_pool(5, [13, 6], page=4, n_pages=8, Hkv=1, D=128)
    q = query(5, 2, 48, 128)
    want = paged_flash_attention_tpu(jnp.asarray(q), *_jax(pool),
                                     window=window, interpret=True)
    got = FA.paged_flash_attention(torch.as_tensor(q), *_torch(pool),
                                   window=window)
    assert got.shape == (2, 48, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_poisoned_free_pages_are_bit_identical():
    """Unmapped pages full of 127 at scale 1e6 never reach the output."""
    pool = random_pool(1, [9, 13], page=8, n_pages=8, Hkv=2, D=16,
                       shuffle=False)
    q = torch.as_tensor(query(1, 2, 4, 16))
    base = FA.paged_flash_attention(q, *_torch(pool))
    got = FA.paged_flash_attention(q, *_torch(poisoned(pool)))
    assert torch.equal(base, got)


def test_empty_sequence_drains_zeros_and_bf16_keeps_dtype():
    pool = random_pool(2, [0, 5], page=8, n_pages=4, Hkv=1, D=8)
    q = torch.as_tensor(query(2, 2, 2, 8)).bfloat16()
    out = FA.paged_flash_attention(q, *_torch(pool))
    assert out.dtype == torch.bfloat16 and out.shape == (2, 2, 8)
    assert torch.equal(out[0], torch.zeros(2, 8, dtype=torch.bfloat16))
    assert bool(out[1].abs().sum() > 0)


def test_cuda_tensors_never_run_the_plain_version(monkeypatch):
    """On a CUDA tensor the wrapper launches the kernel or raises; here,
    with no card and no nvcc, it raises and never falls back."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def no_fallback(*a, **k):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(FA, "paged_flash_attention_reference", no_fallback)
    FA.reset_launch_counts()
    with FakeTensorMode():
        q = torch.empty(1, 2, 8, device="cuda")
        kp = torch.empty(2, 4, 1, 8, dtype=torch.int8, device="cuda")
        sc = torch.empty(2, device="cuda")
        tables = torch.empty(1, 1, dtype=torch.int32, device="cuda")
        lens = torch.empty(1, dtype=torch.int32, device="cuda")
        with pytest.raises((RuntimeError, AssertionError)) as err:
            FA.paged_flash_attention(q, kp, kp, sc, sc, tables, lens)
    assert "plain version" not in str(err.value)
    assert FA.launch_counts == {}


@pytest.mark.parametrize("bad,match", [
    ({"k_scale": np.zeros(3, np.float32)}, "k_scale"),
    ({"tables": np.zeros((2, 2), np.int64)}, "block_tables"),
    ({"lens": np.zeros(3, np.int32)}, "seq_lens"),
])
def test_geometry_checks_raise(bad, match):
    pool = random_pool(3, [5, 9], page=8, n_pages=4, Hkv=2, D=8)
    pool.update(bad)
    with pytest.raises(ValueError, match=match):
        FA.paged_flash_attention(torch.as_tensor(query(3, 2, 4, 8)),
                                 *_torch(pool))


# ---------------------------------------------------------------------------
# K3: forward flash attention
# ---------------------------------------------------------------------------

def fwd_inputs(seed, B, Lq, S, H, Hkv, D, *, holes=False):
    """numpy q (B, Lq, H, D), k/v (B, S, Hkv, D) ~ N(0, 1) and int32
    positions: kv slot s at position s, queries end-aligned with the keys.
    With ``holes`` some kv slots are invalid (-1) and the last batch row's
    first query sits before every kv position, so it sees no slot."""
    r = np.random.RandomState(seed)
    q = r.randn(B, Lq, H, D).astype(np.float32)
    k = r.randn(B, S, Hkv, D).astype(np.float32)
    v = r.randn(B, S, Hkv, D).astype(np.float32)
    kpos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    qpos = np.tile(np.arange(Lq, dtype=np.int32) + (S - Lq), (B, 1))
    if holes:
        kpos[r.rand(B, S) < 0.2] = -1
        qpos[-1, 0] = -3
    return q, k, v, qpos, kpos


def _run_both(inputs, *, window=None, causal=True, q_block=16, kv_block=32):
    q, k, v, qpos, kpos = inputs
    want = flash_attention_tpu(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_positions=jnp.asarray(qpos), kv_positions=jnp.asarray(kpos),
        causal=causal, window=window, q_block=q_block, kv_block=kv_block,
        interpret=True)
    FA.reset_launch_counts()
    got = FA.flash_attention(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
        q_positions=torch.as_tensor(qpos), kv_positions=torch.as_tensor(kpos),
        causal=causal, window=window, q_block=q_block, kv_block=kv_block)
    assert FA.launch_counts == {}
    return got, np.asarray(want)


@pytest.mark.parametrize("holes", [False, True], ids=["dense", "holes"])
@pytest.mark.parametrize("window", [None, 17], ids=["causal", "sliding"])
@pytest.mark.parametrize("gqa", [1, 4], ids=["mha", "gqa4"])
def test_flash_attention_matches_reference_kernel(gqa, window, holes):
    """Lq = 37 and S = 50 are ragged against the reference's blocks (16,
    32) and the port's (64); with holes, -1 kv slots and a fully masked
    query row, which drains exactly 0."""
    Hkv = 2
    inputs = fwd_inputs(gqa + 2 * bool(window), 2, 37, 50, Hkv * gqa, Hkv,
                        32, holes=holes)
    got, want = _run_both(inputs, window=window)
    assert got.dtype == torch.float32 and got.shape == (2, 37, Hkv * gqa, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    if holes:
        assert not want[-1, 0].any() and not got[-1, 0].any()


def test_flash_attention_non_causal_head_dim_120():
    """causal=False with a window, danube's head dim and GQA 4."""
    inputs = fwd_inputs(5, 1, 20, 70, 8, 2, 120, holes=True)
    got, want = _run_both(inputs, window=9, causal=False, q_block=8,
                          kv_block=16)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_flash_attention_96_query_heads_per_kv_head():
    """Any G: 96 query heads over one KV head (more than the 64 rows of
    the SIMT CTA and the 128 of the wgmma one, so the card splits the
    group over head chunks); the reference folds all 96 into its rows."""
    inputs = fwd_inputs(8, 1, 5, 20, 96, 1, 16, holes=True)
    got, want = _run_both(inputs, window=7)
    assert got.shape == (1, 5, 96, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype,D,Dv,aligned,want", [
    (torch.bfloat16, 64, 64, True, "wgmma"),
    (torch.bfloat16, 120, 120, True, "wgmma"),
    (torch.bfloat16, 40, 40, True, "wgmma"),
    (torch.bfloat16, 64, 64, False, "simt"),
    (torch.bfloat16, 36, 36, True, "simt"),
    (torch.bfloat16, 64, 20, True, "simt"),
    (torch.float32, 64, 64, True, "simt"),
    (torch.float32, 120, 120, True, "simt"),
], ids=lambda v: str(v).replace("torch.", ""))
def test_fwd_route(dtype, D, Dv, aligned, want):
    """K3's route: wgmma for bf16 whose q, k, v bases are 16-byte aligned
    and whose head dims are multiples of 8 (TMA's row-stride rule); SIMT
    for fp32 and for bf16 TMA cannot take."""
    assert FA.fwd_route(dtype, D, Dv, aligned) == want


@pytest.mark.parametrize("blocks", [(16, 16), (32, 64), (64, 64)],
                         ids=lambda b: f"q{b[0]}kv{b[1]}")
def test_flash_attention_block_invariance(blocks):
    """The reference kernel's result at each of its blockings
    (tests/test_kernels.py's cases) is the port's, which has one fixed
    tile and does not read q_block/kv_block."""
    inputs = fwd_inputs(3, 1, 64, 64, 4, 4, 16)
    got, want = _run_both(inputs, q_block=blocks[0], kv_block=blocks[1])
    base, _ = _run_both(inputs, q_block=None, kv_block=None)
    assert torch.equal(got, base)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_flash_attention_bf16_keeps_dtype_and_agrees_with_the_model_path():
    """bf16 in, bf16 out; the kernel's plain version against the model's
    own chunked prefill attention (which rounds p to bf16 too), within one
    bf16 ulp of max|out|."""
    q, k, v, qpos, kpos = (torch.as_tensor(x) for x in
                           fwd_inputs(4, 1, 40, 40, 4, 2, 16))
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    got = FA.flash_attention(q, k, v, q_positions=qpos, kv_positions=kpos)
    want = model_attention.flash_attention(q, k, v, q_positions=qpos,
                                           kv_positions=kpos)
    assert got.dtype == torch.bfloat16
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2 ** -8 * want.float().abs().max().item(), err


def test_ref_flash_attention_matches_the_reference_oracle():
    q, k, v, _, _ = fwd_inputs(6, 1, 24, 30, 6, 2, 8)
    for window in (None, 5):
        want = jax_ref.ref_flash_attention(jnp.asarray(q[0]),
                                           jnp.asarray(k[0]),
                                           jnp.asarray(v[0]), window=window)
        got = torch_ref.ref_flash_attention(torch.as_tensor(q[0]),
                                            torch.as_tensor(k[0]),
                                            torch.as_tensor(v[0]),
                                            window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-5)


def test_flash_attention_cuda_tensors_never_run_the_plain_version(
        monkeypatch):
    """On CUDA tensors flash_attention launches K3 or raises; here, with no
    card and no nvcc, it raises and never falls back."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def no_fallback(*a, **k):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(FA, "flash_attention_reference", no_fallback)
    FA.reset_launch_counts()
    with FakeTensorMode():
        q = torch.empty(1, 4, 2, 8, device="cuda")
        kv = torch.empty(1, 6, 2, 8, device="cuda")
        qpos = torch.empty(1, 4, dtype=torch.int32, device="cuda")
        kpos = torch.empty(1, 6, dtype=torch.int32, device="cuda")
        with pytest.raises((RuntimeError, AssertionError)) as err:
            FA.flash_attention(q, kv, kv, q_positions=qpos,
                               kv_positions=kpos)
    assert "plain version" not in str(err.value)
    assert FA.launch_counts == {}


@pytest.mark.parametrize("bad,match", [
    ({"k": np.zeros((1, 6, 3, 8), np.float32),
      "v": np.zeros((1, 6, 3, 8), np.float32)}, "not divisible"),
    ({"kpos": np.zeros((1, 6), np.int64)}, "kv_positions"),
    ({"v": np.zeros((1, 5, 2, 8), np.float32)}, "do not fit"),
    ({"window": 0}, "window"),
])
def test_flash_attention_checks_raise(bad, match):
    args = dict(q=np.zeros((1, 4, 4, 8), np.float32),
                k=np.zeros((1, 6, 2, 8), np.float32),
                v=np.zeros((1, 6, 2, 8), np.float32),
                qpos=np.zeros((1, 4), np.int32),
                kpos=np.zeros((1, 6), np.int32), window=None)
    args.update(bad)
    t = {name: torch.as_tensor(x) for name, x in args.items()
         if name != "window"}
    with pytest.raises(ValueError, match=match):
        FA.flash_attention(t["q"], t["k"], t["v"], q_positions=t["qpos"],
                           kv_positions=t["kpos"], window=args["window"])
