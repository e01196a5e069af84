"""The port's paged decode attention (K2's wrapper) on the CPU against
the reference's Pallas kernel ``paged_flash_attention_tpu`` in interpret
mode, on the same numpy-seeded int8 pools.  The CUDA kernel itself is held
against the plain version in test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn import paged_flash_attention_tpu
from repro_torch.kernels import flash_attn as FA
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
