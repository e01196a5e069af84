"""The port's Mamba2 mixer (``repro_torch.models.ssm``) and its init laws
against the reference's ``repro.models.ssm`` on the CPU, in fp32."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.models import model as JM
from repro.models import ssm as jssm
from repro_torch.configs import get_reduced
from repro_torch.models import ssm as tssm
from repro_torch.models.common import ParamDef, init_one


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _scan_inputs(seed, B, L, H, P, N, decay=0.3):
    r = np.random.RandomState(seed)
    return [r.randn(B, L, H, P).astype(np.float32) * 0.5,
            -np.abs(r.rand(B, L, H).astype(np.float32)) * decay,
            r.randn(B, L, H, N).astype(np.float32) * 0.3,
            r.randn(B, L, H, N).astype(np.float32) * 0.3]


def _naive(xdt, da, b_h, c_h):
    """The exact sequential recurrence, in numpy."""
    B, L, H, P = xdt.shape
    s = np.zeros((B, H, P, b_h.shape[-1]), np.float32)
    ys = []
    for t in range(L):
        s = np.exp(da[:, t])[:, :, None, None] * s \
            + np.einsum("bhp,bhn->bhpn", xdt[:, t], b_h[:, t])
        ys.append(np.einsum("bhn,bhpn->bhp", c_h[:, t], s))
    return np.stack(ys, axis=1), s


def test_ssd_scan_matches_reference_and_naive_recurrence():
    args = _scan_inputs(0, 2, 48, 3, 8, 16)
    y, s = tssm._ssd_scan(*map(torch.as_tensor, args), chunk=16)
    jy, js = jssm._ssd_scan(*map(jnp.asarray, args), chunk=16)
    ny, ns = _naive(*args)
    for got, want in ((y, jy), (s, js), (y, ny), (s, ns)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4,
                                   atol=1e-4)
    assert s.dtype == torch.float32


@pytest.mark.parametrize("chunk", [8, 19])
def test_ssd_scan_chunk_padding(chunk):
    """19 tokens padded up to the chunk: the same outputs and final state
    as one unpadded chunk, and as the reference's padded scan."""
    args = _scan_inputs(1, 1, 19, 2, 4, 8)
    y, s = tssm._ssd_scan(*map(torch.as_tensor, args), chunk=chunk)
    y1, s1 = tssm._ssd_scan(*map(torch.as_tensor, args), chunk=19)
    jy, js = jssm._ssd_scan(*map(jnp.asarray, args), chunk=chunk)
    assert y.shape == (1, 19, 2, 4)
    for got, want in ((y, y1), (s, s1), (y, jy), (s, js)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4,
                                   atol=1e-4)


def test_ssd_scan_overflow_above_the_diagonal_is_masked():
    """Strong decay makes exp(cs_t - cs_s) overflow to inf above the
    diagonal; the where drops it, and the outputs stay finite and equal
    to the recurrence."""
    args = _scan_inputs(2, 1, 32, 2, 4, 8, decay=40.0)
    y, s = tssm._ssd_scan(*map(torch.as_tensor, args), chunk=32)
    cs = np.cumsum(args[1][0, :, 0])
    with np.errstate(over="ignore"):
        assert np.exp(np.float32(cs[0] - cs[-1])) == np.inf
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    ny, ns = _naive(*args)
    np.testing.assert_allclose(_np(y), ny, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(s), ns, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("L", [1, 3, 11])
def test_causal_conv_matches_reference(L):
    r = np.random.RandomState(L)
    x = r.randn(2, L, 12).astype(np.float32)
    w = r.randn(4, 12).astype(np.float32)
    b = r.randn(12).astype(np.float32)
    got = tssm._causal_conv(*map(torch.as_tensor, (x, w, b)))
    want = jssm._causal_conv(*map(jnp.asarray, (x, w, b)))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)
    # Causal: the first output sees only the first input.
    np.testing.assert_allclose(_np(got)[:, 0], x[:, 0] * w[-1] + b,
                               rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def mixer():
    """Layer 0's mixer parameters of reduced mamba2-370m (fp32) in both
    packages."""
    jcfg = jax_reduced("mamba2-370m")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(3))
    pre = "blocks/mixer/"
    jsub = {k[len(pre):]: v[0] for k, v in jp.items() if k.startswith(pre)}
    tsub = {k: torch.as_tensor(np.array(v)) for k, v in jsub.items()}
    return jcfg, get_reduced("mamba2-370m"), jsub, tsub


@pytest.mark.parametrize("L", [2, 4, 21])
def test_mamba2_apply_prefill_and_decode_match_reference(mixer, L):
    """Prefill of L tokens (2: shorter than the conv window, whose cache
    is left-padded; 21: past one 16-token chunk), then three decode steps:
    outputs at 1e-4, the conv window in the serve dtype and the fp32
    state against the reference's."""
    jcfg, cfg, jsub, tsub = mixer
    r = np.random.RandomState(L)
    x = r.randn(2, L, cfg.d_model).astype(np.float32)
    want, jc = jssm.mamba2_apply(jsub, jnp.asarray(x), jcfg, mode="prefill")
    got, tc = tssm.mamba2_apply(tsub, torch.as_tensor(x), cfg,
                                mode="prefill")
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)
    assert tc["conv"].shape == (2, cfg.ssm.conv_kernel - 1,
                                jc["conv"].shape[-1])
    assert tc["ssm"].dtype == torch.float32
    for key in ("conv", "ssm"):
        np.testing.assert_allclose(_np(tc[key]), _np(jc[key]), rtol=1e-4,
                                   atol=1e-4)
    if L < cfg.ssm.conv_kernel - 1:
        assert bool((tc["conv"][:, :cfg.ssm.conv_kernel - 1 - L] == 0).all())
    for _ in range(3):
        x1 = r.randn(2, 1, cfg.d_model).astype(np.float32)
        want, jc = jssm.mamba2_apply(jsub, jnp.asarray(x1), jcfg, cache=jc,
                                     mode="decode")
        got, tc = tssm.mamba2_apply(tsub, torch.as_tensor(x1), cfg,
                                    cache=tc, mode="decode")
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4,
                                   atol=1e-4)
        for key in ("conv", "ssm"):
            np.testing.assert_allclose(_np(tc[key]), _np(jc[key]),
                                       rtol=1e-4, atol=1e-4)


def test_mamba2_train_equals_prefill_output(mixer):
    _, cfg, _, tsub = mixer
    x = torch.as_tensor(np.random.RandomState(0).randn(
        1, 9, cfg.d_model).astype(np.float32))
    a, none = tssm.mamba2_apply(tsub, x, cfg, mode="train")
    b, cache = tssm.mamba2_apply(tsub, x, cfg, mode="prefill")
    assert none is None and set(cache) == {"conv", "ssm"}
    assert torch.equal(a, b)


def test_make_ssm_cache_matches_reference():
    jcfg, cfg = jax_reduced("zamba2-7b"), get_reduced("zamba2-7b")
    want = jssm.make_ssm_cache(3, jcfg, jnp.bfloat16)
    got = tssm.make_ssm_cache(3, cfg, torch.bfloat16)
    for key in ("conv", "ssm"):
        assert tuple(got[key].shape) == want[key].shape
        assert not bool(got[key].any())
    assert (got["conv"].dtype, got["ssm"].dtype) \
        == (torch.bfloat16, torch.float32)


# ---------------------------------------------------------------------------
# The Mamba2 init laws (the reference's distributions, drawn from a
# torch.Generator)
# ---------------------------------------------------------------------------

def _draw(init, shape, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return init_one(ParamDef(shape, (None,) * len(shape), init=init), gen,
                    torch.float32, "cpu")


def test_a_log_law():
    """A = -exp(a_log) with -A ~ U[1, 16]."""
    t = _draw("a_log", (20000,))
    u = t.exp()
    assert 1.0 <= float(u.min()) and float(u.max()) <= 16.0
    assert abs(float(u.mean()) - 8.5) < 0.1
    assert abs(float(u.std()) - 15 / math.sqrt(12)) < 0.1


def test_dt_bias_law():
    """softplus(dt_bias) = exp(U[log 1e-3, log 1e-1])."""
    t = _draw("dt_bias", (20000,))
    dt = torch.nn.functional.softplus(t)
    assert 1e-3 * (1 - 1e-4) <= float(dt.min())
    assert float(dt.max()) <= 1e-1 * (1 + 1e-4)
    logs = dt.log()
    mid = (math.log(1e-3) + math.log(1e-1)) / 2
    assert abs(float(logs.mean()) - mid) < 0.05
    assert abs(float(logs.std()) - math.log(100) / math.sqrt(12)) < 0.05


@pytest.mark.parametrize("shape", [(4, 3000), (6, 4, 500)],
                         ids=["one_layer", "stacked"])
def test_conv_law(shape):
    """U[-1/sqrt(fan), 1/sqrt(fan)], fan the def's leading dim (the layer
    count of a stacked def, as in the reference); a stacked leaf drawn a
    layer at a time keeps the law in every layer."""
    t = _draw("conv", shape)
    bound = 1 / math.sqrt(shape[0])
    assert float(t.abs().max()) <= bound
    for part in (t.unbind(0) if len(shape) == 3 else (t,)):
        assert abs(float(part.std()) - bound / math.sqrt(3)) < 0.05 * bound
    assert torch.equal(t, _draw("conv", shape))
    assert not torch.equal(t, _draw("conv", shape, seed=1))


def test_unknown_init_law_raises():
    with pytest.raises(ValueError, match="unknown init law"):
        _draw("orthogonal", (4, 4))
