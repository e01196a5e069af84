"""The port's ca_matmul / ca_glu_matmul against ``repro.core.gemm`` in xla
mode: leading (B, L) dims, the residual epilogue, the rms prologue and an
fp32 out_dtype."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gemm as jg
from repro.kernels.epilogue import Epilogue as JEpilogue
from repro.kernels.program import RmsPrologue as JRms
from repro_torch.core import gemm as tg
from repro_torch.kernels.epilogue import Epilogue as TEpilogue
from repro_torch.kernels.program import RmsPrologue as TRms

B, L, K, N = 2, 5, 48, 40


def _inputs(seed):
    r = np.random.RandomState(seed)
    return {"x": r.randn(B, L, K), "w": r.randn(K, N) / np.sqrt(K),
            "w2": r.randn(K, N) / np.sqrt(K), "res": r.randn(B, L, N),
            "gain": r.rand(K) + 0.5}


def _close(got, want, rtol=1e-4, atol=1e-4):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("prologue", [False, True])
def test_ca_matmul_residual_epilogue(prologue):
    d = _inputs(0)
    jx, tx = jnp.asarray(d["x"], jnp.float32), torch.tensor(d["x"]).float()
    jpro = JRms(jnp.asarray(d["gain"], jnp.float32)) if prologue else None
    tpro = TRms(torch.tensor(d["gain"]).float()) if prologue else None
    want = jg.ca_matmul(jx, jnp.asarray(d["w"], jnp.float32), mode="xla",
                        epilogue=JEpilogue(residual=jnp.asarray(
                            d["res"], jnp.float32)), prologue=jpro)
    got = tg.ca_matmul(tx, torch.tensor(d["w"]).float(),
                       epilogue=TEpilogue(residual=torch.tensor(
                           d["res"]).float()), prologue=tpro)
    _close(got, want)


def test_ca_matmul_rms_prologue_gelu_bias():
    d = _inputs(1)
    bias = np.random.RandomState(9).randn(N)
    want = jg.ca_matmul(
        jnp.asarray(d["x"], jnp.float32), jnp.asarray(d["w"], jnp.float32),
        mode="xla", epilogue=JEpilogue(bias=jnp.asarray(bias, jnp.float32),
                                       activation="gelu"),
        prologue=JRms(jnp.asarray(d["gain"], jnp.float32)))
    got = tg.ca_matmul(
        torch.tensor(d["x"]).float(), torch.tensor(d["w"]).float(),
        epilogue=TEpilogue(bias=torch.tensor(bias).float(),
                           activation="gelu"),
        prologue=TRms(torch.tensor(d["gain"]).float()))
    _close(got, want)


def test_ca_matmul_fp32_out_of_bf16():
    # The logits head's call: bf16 operands, fp32 out, no output rounding.
    d = _inputs(2)
    want = jg.ca_matmul(jnp.asarray(d["x"], jnp.bfloat16),
                        jnp.asarray(d["w"], jnp.bfloat16), mode="xla",
                        out_dtype=jnp.float32)
    got = tg.ca_matmul(torch.tensor(d["x"]).bfloat16(),
                       torch.tensor(d["w"]).bfloat16(),
                       out_dtype=torch.float32)
    assert got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_ca_glu_matmul_rms_prologue(act):
    d = _inputs(3)
    want = jg.ca_glu_matmul(
        jnp.asarray(d["x"], jnp.float32), jnp.asarray(d["w"], jnp.float32),
        jnp.asarray(d["w2"], jnp.float32), activation=act, mode="xla",
        prologue=JRms(jnp.asarray(d["gain"], jnp.float32)))
    got = tg.ca_glu_matmul(
        torch.tensor(d["x"]).float(), torch.tensor(d["w"]).float(),
        torch.tensor(d["w2"]).float(), activation=act,
        prologue=TRms(torch.tensor(d["gain"]).float()))
    _close(got, want)


def test_shape_mismatches_raise():
    x = torch.ones(B, L, K)
    with pytest.raises(ValueError, match="contract"):
        tg.ca_matmul(x, torch.ones(K + 1, N))
    with pytest.raises(ValueError, match="residual"):
        tg.ca_matmul(x, torch.ones(K, N),
                     epilogue=TEpilogue(residual=torch.ones(B, L, N + 1)))
    with pytest.raises(ValueError, match="w_up"):
        tg.ca_glu_matmul(x, torch.ones(K, N), torch.ones(K, N + 1))


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_ref_matmul_matches_reference(dtype):
    from repro.kernels.ref import ref_matmul as jref
    from repro_torch.kernels.ref import ref_matmul as tref

    r = np.random.RandomState(5)
    a = (r.randn(7, 33) * 40).astype(dtype)
    b = (r.randn(33, 9) * 40).astype(dtype)
    want = np.asarray(jref(jnp.asarray(a), jnp.asarray(b)))
    got = tref(torch.as_tensor(a), torch.as_tensor(b))
    assert str(got.dtype) == f"torch.{want.dtype}"
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-3)
