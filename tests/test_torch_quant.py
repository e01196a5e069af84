"""The port's int8 quantization (``repro_torch.quant``) and its quantized
GEMM programs (K1d ``dqb``, K1e ``dqab``) on the CPU against ``repro.quant``
and the reference kernel in Pallas interpret mode, on the same numpy
inputs.

Tolerances are the reference's own (``tests/test_quant.py``): int8
payloads bit-identical and scales to rtol 1e-6; quantized programs to
rtol 2e-4 and atol 2e-3·max|ref|, the headroom case exact up to the fp32
rescale (rtol 1e-6).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import quant as JQ
from repro.kernels import quant_glu_matmul as jax_quant_glu
from repro.kernels import quant_matmul as jax_quant_matmul
from repro.kernels.epilogue import Epilogue as JEpilogue
from repro.kernels.program import RmsPrologue as JRms
from repro_torch import quant as TQ
from repro_torch.kernels import ca_mmm as K
from repro_torch.kernels import ops as kops
from repro_torch.kernels.epilogue import Epilogue as TEpilogue
from repro_torch.kernels.program import RmsPrologue as TRms
from repro_torch.kernels.program import program_from_tag


def _randn(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _pair(x):
    """The same numpy array for both packages."""
    return jnp.asarray(x), torch.as_tensor(np.array(x))


def _qpair(w, block=0):
    """One weight quantized by both packages (payloads bit-identical)."""
    jw, tw = _pair(w)
    jq = JQ.quantize(jw, axis=-2, block=block)
    tq = TQ.quantize(tw, axis=-2, block=block)
    np.testing.assert_array_equal(tq.data.numpy(), np.asarray(jq.data))
    return jq, tq


def _close(got, want, rtol=2e-4, atol_rel=2e-3):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_rel * np.abs(want).max())


# ---------------------------------------------------------------------------
# scales.py / calibrate.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,block,percentile", [
    ((100, 40), 0, 100.0), ((257, 33), 0, 100.0),
    ((300, 64), 128, 100.0),            # ragged k edge: 128 + 128 + 44
    ((3, 257, 40), 128, 100.0),         # layer-stacked
    ((300, 70), 0, 99.9), ((300, 70), 128, 99.0),
    ((1000, 20), 256, 99.9)])
def test_quantize_matches_reference(shape, block, percentile):
    x = _randn(shape, 1) * (1.0 + 20.0 * (np.arange(shape[-2])[:, None]
                                          >= 128))
    jx, tx = _pair(x)
    jq = JQ.quantize(jx, axis=-2, block=block, percentile=percentile)
    tq = TQ.quantize(tx, axis=-2, block=block, percentile=percentile)
    assert tq.data.dtype == torch.int8 and tq.scale.dtype == torch.float32
    np.testing.assert_array_equal(tq.data.numpy(), np.asarray(jq.data))
    assert tuple(tq.scale.shape) == jq.scale.shape
    np.testing.assert_allclose(tq.scale.numpy(), np.asarray(jq.scale),
                               rtol=1e-6)
    assert (tq.axis, tq.block) == (jq.axis, jq.block)
    np.testing.assert_allclose(tq.dequantize().numpy(),
                               np.asarray(jq.dequantize()), rtol=1e-6)


def test_absmax_scale_bf16_input_is_fp32():
    x = _randn((64, 48), 2)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.as_tensor(x).bfloat16()
    js = JQ.absmax_scale(jx, axis=-2, block=0)
    ts = TQ.absmax_scale(tx, axis=-2, block=0)
    assert ts.dtype == torch.float32
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)


@pytest.mark.parametrize("block", [0, 128])
def test_activation_quantize_matches_reference(block):
    x = _randn((7, 300), 3) * 2.0
    cal = JQ.Calibrator(JQ.QuantConfig(act_fmt="int8"), axis=-1)
    cal.observe(jnp.asarray(x[:3]))       # rows 3.. saturate partly
    s = np.array(cal.static_scale(block))
    jx, tx = _pair(x)
    ts = torch.as_tensor(s)
    np.testing.assert_array_equal(
        TQ.quantize_activation(tx, ts, block).numpy(),
        np.asarray(JQ.quantize_activation(jx, jnp.asarray(s), block)))
    np.testing.assert_array_equal(
        TQ.fake_quant_activation(tx, ts, block).numpy(),
        np.asarray(JQ.fake_quant_activation(jx, jnp.asarray(s), block)))


@pytest.mark.parametrize("method", ["absmax", "percentile"])
@pytest.mark.parametrize("block", [0, 128])
def test_calibrator_static_scale_matches_reference(method, block):
    jc = JQ.QuantConfig(act_fmt="int8", method=method, percentile=99.0)
    tc = TQ.QuantConfig(act_fmt="int8", method=method, percentile=99.0)
    jcal, tcal = JQ.Calibrator(jc, axis=-1), TQ.Calibrator(tc, axis=-1)
    for s in range(3):
        b = _randn((6, 300), 10 + s) * (1.0 + 5.0 * s)
        jb, tb = _pair(b)
        jcal.observe(jb)
        tcal.observe(tb)
    got, want = tcal.static_scale(block), jcal.static_scale(block)
    assert tuple(got.shape) == want.shape == ((3,) if block else ())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_quant_config_checks_raise():
    with pytest.raises(ValueError, match="QNT003"):
        TQ.QuantConfig(block=100)
    with pytest.raises(ValueError, match="QNT003"):
        TQ.QuantConfig(act_block=64)
    with pytest.raises(ValueError, match="QNT003"):
        TQ.QuantConfig(act_fmt="int4")
    with pytest.raises(ValueError, match="QNT003"):
        TQ.QuantConfig(fmt="fp8_e3m4")
    assert TQ.QuantConfig(fmt="fp8_e4m3").fmt == "fp8_e4m3"
    with pytest.raises(ValueError, match="act_fmt"):
        TQ.ActivationCalibration(TQ.QuantConfig())
    with pytest.raises(ValueError, match="at least one batch"):
        TQ.Calibrator().static_scale()


def test_attach_act_scales_and_stacked_slicing():
    q2 = TQ.quantize(torch.as_tensor(_randn((40, 24), 64)))     # k40n24
    q3 = TQ.quantize(torch.as_tensor(_randn((3, 40, 24), 65)))  # stacked
    qo = TQ.quantize(torch.as_tensor(_randn((16, 8), 66)))      # no site
    scales = {TQ.activation_site(q2.shape): torch.tensor(0.05)}
    tree = TQ.attach_act_scales({"a": q2, "b": q3, "c": qo}, scales,
                                block=0)
    assert float(tree["a"].act_scale) == pytest.approx(0.05)
    assert tuple(tree["b"].act_scale.shape) == (3,)
    assert tree["c"].act_scale is None and q2.act_scale is None
    sliced = tree["b"][1]
    assert isinstance(sliced, TQ.QTensor) and sliced.act_scale.dim() == 0
    assert torch.equal(sliced.data, q3.data[1])
    assert torch.equal(sliced.scale, q3.scale[1])


# ---------------------------------------------------------------------------
# Quantized programs: the port's plain version vs the reference kernel in
# Pallas interpret mode.
# ---------------------------------------------------------------------------

QSHAPES = [(37, 96, 100), (5, 130, 70), (1, 128, 128), (16, 64, 300)]


@pytest.mark.parametrize("m,n,k", QSHAPES)
def test_int8w_per_channel_matches_reference_kernel(m, n, k):
    jq, tq = _qpair(_randn((k, n), 11))
    ja, ta = _pair(_randn((m, k), 10))
    want = jax_quant_matmul(ja, jq, interpret=True)
    got = kops.quant_matmul(ta, tq)
    assert got.dtype == torch.float32
    _close(got, want)


def test_int8w_per_tile_ragged_k_matches_reference_kernel():
    m, n, k, g = 37, 64, 300, 128
    w = _randn((k, n), 13) * (1.0 + 50.0 * (np.arange(k)[:, None] >= g))
    jq, tq = _qpair(w, block=g)
    assert tuple(tq.scale.shape) == (3, n)     # 128 + 128 + 44
    ja, ta = _pair(_randn((m, k), 12))
    _close(kops.quant_matmul(ta, tq), jax_quant_matmul(ja, jq,
                                                       interpret=True))


def test_int8w_bf16_activations_match_reference_kernel():
    m, n, k = 21, 128, 96
    jq, tq = _qpair(_randn((k, n), 15))
    a = _randn((m, k), 14)
    want = jax_quant_matmul(jnp.asarray(a, jnp.bfloat16), jq, interpret=True)
    got = kops.quant_matmul(torch.as_tensor(a).bfloat16(), tq)
    assert got.dtype == torch.bfloat16
    _close(got, want)


@pytest.mark.parametrize("full", [False, True], ids=["res", "chain"])
def test_int8w_fused_epilogue_matches_reference_kernel(full):
    m, n, k = 37, 96, 64
    jq, tq = _qpair(_randn((k, n), 17))
    ja, ta = _pair(_randn((m, k), 16))
    res, bias, mul = (_pair(_randn(s, 18 + i)) for i, s in
                      enumerate([(m, n), (n,), (m, n)]))
    jepi = JEpilogue(residual=res[0], bias=bias[0] if full else None,
                     mul=mul[0] if full else None,
                     activation="silu" if full else "none")
    tepi = TEpilogue(residual=res[1], bias=bias[1] if full else None,
                     mul=mul[1] if full else None,
                     activation="silu" if full else "none")
    _close(kops.quant_matmul(ta, tq, tepi),
           jax_quant_matmul(ja, jq, jepi, interpret=True))


def test_int8w_rms_prologue_matches_reference_kernel():
    m, n, k = 9, 64, 96
    jq, tq = _qpair(_randn((k, n), 21))
    ja, ta = _pair(_randn((m, k), 20))
    gain = np.random.RandomState(22).rand(k).astype(np.float32) + 0.5
    want = jax_quant_matmul(ja, jq, interpret=True,
                            prologue=JRms(jnp.asarray(gain)))
    got = kops.quant_matmul(ta, tq, prologue=TRms(torch.as_tensor(gain)))
    _close(got, want)


def _static_scale(a, block=0):
    cal = JQ.Calibrator(JQ.QuantConfig(act_fmt="int8"), axis=-1)
    cal.observe(jnp.asarray(a))
    s = np.array(cal.static_scale(block))
    return jnp.asarray(s), torch.as_tensor(s)


@pytest.mark.parametrize("m,n,k", QSHAPES)
def test_w8a8_per_tensor_matches_reference_kernel(m, n, k):
    jq, tq = _qpair(_randn((k, n), 51))
    a = _randn((m, k), 50)
    js, ts = _static_scale(a)
    ja, ta = _pair(a)
    want = jax_quant_matmul(ja, jq, act_scale=js, interpret=True)
    got = kops.quant_matmul(ta, tq, act_scale=ts)
    assert got.dtype == torch.float32
    _close(got, want)


def test_w8a8_per_tile_a_and_b_match_reference_kernel():
    m, n, k, g = 37, 64, 300, 128
    a = _randn((m, k), 52) * (1.0 + 10.0 * (np.arange(k)[None, :] >= g))
    w = _randn((k, n), 53) * (1.0 + 50.0 * (np.arange(k)[:, None] >= g))
    jq, tq = _qpair(w, block=g)
    js, ts = _static_scale(a, block=g)
    ja, ta = _pair(a)
    want = jax_quant_matmul(ja, jq, act_scale=js, act_block=g,
                            interpret=True)
    _close(kops.quant_matmul(ta, tq, act_scale=ts, act_block=g), want)


def test_w8a8_per_tile_a_per_channel_b_matches_reference_kernel():
    m, n, k, g = 13, 64, 300, 128
    a = _randn((m, k), 54) * (1.0 + 10.0 * (np.arange(k)[None, :] >= g))
    jq, tq = _qpair(_randn((k, n), 55))
    js, ts = _static_scale(a, block=g)
    ja, ta = _pair(a)
    want = jax_quant_matmul(ja, jq, act_scale=js, act_block=g,
                            interpret=True)
    _close(kops.quant_matmul(ta, tq, act_scale=ts, act_block=g), want)


def test_int8w_glu_per_tile_scales_apply_on_both_branches():
    m, n, k, g = 21, 64, 256, 128
    mag = 1.0 + 100.0 * (np.arange(k)[:, None] >= g)
    jg, tg = _qpair(_randn((k, n), 55) * mag, block=g)
    ju, tu = _qpair(_randn((k, n), 56) * mag, block=g)
    ja, ta = _pair(_randn((m, k), 54))
    want = jax_quant_glu(ja, jg, ju, interpret=True)
    _close(kops.quant_glu_matmul(ta, tg, tu), want)


def test_int8w_glu_rms_prologue_matches_reference_kernel():
    m, n, k = 7, 64, 96
    jg, tg = _qpair(_randn((k, n), 61))
    ju, tu = _qpair(_randn((k, n), 62))
    ja, ta = _pair(_randn((m, k), 60))
    gain = np.random.RandomState(63).rand(k).astype(np.float32) + 0.5
    want = jax_quant_glu(ja, jg, ju, interpret=True,
                         prologue=JRms(jnp.asarray(gain)))
    got = kops.quant_glu_matmul(ta, tg, tu,
                                prologue=TRms(torch.as_tensor(gain)))
    _close(got, want)


def test_w8a8_glu_per_tile_matches_reference_kernel():
    m, n, k, g = 13, 96, 256, 128
    jg, tg = _qpair(_randn((k, n), 58), block=g)
    ju, tu = _qpair(_randn((k, n), 59), block=g)
    a = _randn((m, k), 57)
    js, ts = _static_scale(a, block=g)
    ja, ta = _pair(a)
    want = jax_quant_glu(ja, jg, ju, act_scale=js, act_block=g,
                         interpret=True)
    _close(kops.quant_glu_matmul(ta, tg, tu, act_scale=ts, act_block=g),
           want)


def test_w8a8_int32_headroom_k4096_is_exact():
    """k = 4096, every product at 127 · ±127: the int32 sum must be exact,
    so the output is s_a · s_b · sum(x_q · w_q) up to the fp32 rescale."""
    from repro.core.io_model import TileConfig

    m, n, k = 4, 128, 4096
    a = np.full((m, k), 4.0, np.float32)                  # -> +127
    w = (np.where(np.arange(k)[:, None] % 2, 1.0, -1.0)
         * np.ones((k, n))).astype(np.float32)            # -> +-127
    jq, tq = _qpair(w)
    s = np.float32(4.0 / 127.0)
    want = jax_quant_matmul(jnp.asarray(a), jq, act_scale=jnp.asarray(s),
                            interpret=True,
                            tile=TileConfig(bm=8, bn=128, bk=1024))
    got = kops.quant_matmul(torch.as_tensor(a), tq,
                            act_scale=torch.tensor(s)).numpy()
    exact = (float(s) * tq.scale.double().numpy()) * (
        np.full((m, k), 127.0) @ tq.data.double().numpy())
    np.testing.assert_allclose(got, exact.astype(np.float32), rtol=1e-6)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("tag,kw,match", [
    ("dqab", {"a": "float"}, "A must be .* int8"),
    ("dqb", {"a": "int8"}, "A must be .* float32/bfloat16"),
    ("dqb", {"scale_b": (3,)}, "scale_b must be"),
    ("dqb", {"scale_b_block": 100}, "multiple of 128"),
    ("dqb", {"scale_a_block": 128}, "'ab' dequant"),
    ("dqab", {"scale_a": None}, "scale_a must be"),
    ("rms>dqab", {}, "rms prologue"),
    ("glu.silu(dqb|none)", {}, "one dequant stage"),
])
def test_bad_quant_operands_raise(tag, kw, match):
    spec = program_from_tag(tag)
    m, k, n = 4, 256, 8
    int_a = kw.get("a") == "int8" or (spec.branches[0].dequant == "ab"
                                      and kw.get("a") != "float")
    a = torch.ones(m, k, dtype=torch.int8) if int_a else torch.ones(m, k)
    bs = [torch.ones(k, n, dtype=torch.int8)] * spec.n_b
    ops = [{"scale_b": torch.ones(kw.get("scale_b", (n,)))}
           for _ in bs]
    if spec.branches[0].dequant == "ab" and "scale_a" not in kw:
        for d in ops:
            d["scale_a"] = torch.ones(m)
    extra = {}
    if spec.prologue.kind == "rms":
        extra = {"row_scale": torch.ones(m, 1), "gain": torch.ones(k)}
    with pytest.raises(ValueError, match=match):
        K.ca_gemm_program(a, bs, spec=spec, branch_operands=ops,
                          scale_b_block=kw.get("scale_b_block", 0),
                          scale_a_block=kw.get("scale_a_block", 0), **extra)


def test_quant_programs_on_the_cpu_never_count():
    K.reset_launch_counts()
    tq = TQ.quantize(torch.as_tensor(_randn((64, 32), 70)))
    x = torch.as_tensor(_randn((3, 64), 71))
    kops.quant_matmul(x, tq)
    kops.quant_matmul(x, tq, act_scale=torch.tensor(0.02))
    kops.quant_glu_matmul(x, tq, tq)
    assert K.launch_counts == {}


def test_quant_matmul_rejects_wrong_axis_and_fp8():
    tq = TQ.quantize(torch.as_tensor(_randn((32, 64), 72)), axis=-1)
    with pytest.raises(ValueError, match="axis"):
        kops.quant_matmul(torch.ones(8, 32), tq)
    # fp8 payloads quantize, and the kernel refuses them (the reference's
    # kernel does too, tests/test_quant.py:245)
    with pytest.raises(ValueError, match="int8 payloads only"):
        kops.quant_matmul(torch.ones(8, 8),
                          TQ.quantize(torch.ones(8, 8), fmt="fp8_e4m3"))


# ---------------------------------------------------------------------------
# The fp8 emulation formats (fp8 bit patterns on an int8 payload)
# ---------------------------------------------------------------------------

FP8 = ("fp8_e4m3", "fp8_e5m2")


@pytest.mark.parametrize("block", [0, 128], ids=["channel", "tile"])
@pytest.mark.parametrize("fmt", FP8)
def test_fp8_payload_bytes_equal_the_reference(fmt, block):
    """The payload is the reference's bit for bit (outliers included, so
    the grid's top is reached), the scale at rtol 1e-6, the dequantized
    values within rtol 1e-4."""
    w = _randn((300, 48), 90)
    w[3, 5] = 40.0
    jw, tw = _pair(w)
    jq = JQ.quantize(jw, axis=-2, block=block, fmt=fmt)
    tq = TQ.quantize(tw, axis=-2, block=block, fmt=fmt)
    assert tq.data.dtype == torch.int8 and tq.fmt == fmt
    np.testing.assert_array_equal(tq.data.numpy(), np.asarray(jq.data))
    np.testing.assert_allclose(tq.scale.numpy(), np.asarray(jq.scale),
                               rtol=1e-6)
    np.testing.assert_allclose(tq.dequantize().numpy(),
                               np.asarray(jq.dequantize()), rtol=1e-4,
                               atol=0)
    rel = float((tq.dequantize() - tw).abs().max() / tw.abs().max())
    assert rel < (0.08 if fmt == "fp8_e4m3" else 0.16)


@pytest.mark.parametrize("fmt", FP8)
def test_fp8_ca_matmul_serves_through_dequantize(fmt):
    """ca_matmul on an fp8 weight (the reference's oracle path: the norm
    up front, dequantize, a plain product, the epilogue) within rtol 1e-4;
    the GLU pair likewise; no kernel launch, no ledger record."""
    from repro.core import gemm as jg
    from repro_torch import obs
    from repro_torch.core import gemm as tg

    x, w, w2 = _randn((2, 5, 64), 91), _randn((64, 40), 92), \
        _randn((64, 40), 93)
    bias, res, gain = _randn((40,), 94), _randn((2, 5, 40), 95), \
        _randn((64,), 96)
    jx, tx = _pair(x)
    jq = {k: JQ.quantize(jnp.asarray(v), fmt=fmt) for k, v in
          (("w", w), ("w2", w2))}
    tq = {k: TQ.quantize(torch.as_tensor(v), fmt=fmt) for k, v in
          (("w", w), ("w2", w2))}
    K.reset_launch_counts()
    obs.set_ledger(obs.GemmLedger(enabled=True))
    with jg.gemm_mode("xla"):
        want = jg.ca_matmul(jx, quant=jq["w"], epilogue=JEpilogue(
            bias=jnp.asarray(bias), activation="gelu",
            residual=jnp.asarray(res)), prologue=JRms(jnp.asarray(gain)))
        want_glu = jg.ca_glu_matmul(jx, jq["w"], jq["w2"],
                                    prologue=JRms(jnp.asarray(gain)))
    try:
        got = tg.ca_matmul(tx, tq["w"], epilogue=TEpilogue(
            bias=torch.as_tensor(bias), activation="gelu",
            residual=torch.as_tensor(res)),
            prologue=TRms(torch.as_tensor(gain)))
        got_glu = tg.ca_glu_matmul(tx, tq["w"], tq["w2"],
                                   prologue=TRms(torch.as_tensor(gain)))
        assert obs.get_ledger().records == []
    finally:
        obs.reset_ledger()
    _close(got, want, rtol=1e-4, atol_rel=1e-5)
    _close(got_glu, want_glu, rtol=1e-4, atol_rel=1e-5)
    assert K.launch_counts == {}
