"""The port's ca_matmul / ca_glu_matmul against ``repro.core.gemm`` in xla
mode: leading (B, L) dims, the residual epilogue, the rms prologue and an
fp32 out_dtype."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gemm as jg
from repro.kernels.epilogue import Epilogue as JEpilogue
from repro.kernels import ops as jops
from repro.kernels.program import RmsPrologue as JRms
from repro_torch.core import gemm as tg
from repro_torch.kernels import ops as tops
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


# ---------------------------------------------------------------------------
# QTensor weights: int8w (dqb) and w8a8 (dqab), against the reference's
# xla path (dequantize up front, fake-quant activations).
# ---------------------------------------------------------------------------

def _qweights(d, act_scale=None):
    """The reference's quantization of d["w"] / d["w2"], in both
    packages, with an optional static activation scale."""

    from repro.quant import quantize as jquantize
    from repro_torch.quant import QTensor

    out = []
    for name in ("w", "w2"):
        jq = jquantize(jnp.asarray(d[name], jnp.float32), axis=-2)
        tq = QTensor(data=torch.as_tensor(np.array(jq.data)),
                     scale=torch.as_tensor(np.array(jq.scale)))
        if act_scale is not None:
            jq = dataclasses.replace(jq, act_scale=jnp.float32(act_scale))
            tq = dataclasses.replace(tq, act_scale=torch.tensor(
                act_scale, dtype=torch.float32))
        out.append((jq, tq))
    return out


@pytest.mark.parametrize("prologue", [False, True])
@pytest.mark.parametrize("w8a8", [False, True], ids=["int8w", "w8a8"])
def test_ca_matmul_qtensor_residual_epilogue(w8a8, prologue):
    d = _inputs(6)
    (jq, tq), _ = _qweights(d, 0.03 if w8a8 else None)
    jpro = JRms(jnp.asarray(d["gain"], jnp.float32)) if prologue else None
    tpro = TRms(torch.tensor(d["gain"]).float()) if prologue else None
    want = jg.ca_matmul(jnp.asarray(d["x"], jnp.float32), jq, mode="xla",
                        epilogue=JEpilogue(residual=jnp.asarray(
                            d["res"], jnp.float32)), prologue=jpro)
    got = tg.ca_matmul(torch.tensor(d["x"]).float(), tq,
                       epilogue=TEpilogue(residual=torch.tensor(
                           d["res"]).float()), prologue=tpro)
    _close(got, want, rtol=2e-4, atol=2e-3 * float(jnp.abs(want).max()))


@pytest.mark.parametrize("w8a8", [False, True], ids=["int8w", "w8a8"])
def test_ca_glu_matmul_qtensor_rms_prologue(w8a8):
    d = _inputs(7)
    (jg_, tg_), (ju, tu) = _qweights(d, 0.03 if w8a8 else None)
    want = jg.ca_glu_matmul(
        jnp.asarray(d["x"], jnp.float32), jg_, ju, mode="xla",
        prologue=JRms(jnp.asarray(d["gain"], jnp.float32)))
    got = tg.ca_glu_matmul(torch.tensor(d["x"]).float(), tg_, tu,
                           prologue=TRms(torch.tensor(d["gain"]).float()))
    _close(got, want, rtol=2e-4, atol=2e-3 * float(jnp.abs(want).max()))


def test_calibration_records_the_normalized_activation():
    from repro_torch.quant import ActivationCalibration

    d = _inputs(8)
    (_, tq), (_, tu) = _qweights(d)
    x = torch.tensor(d["x"]).float()
    gain = torch.tensor(d["gain"]).float()
    with ActivationCalibration() as ctx:
        tg.ca_matmul(x, tq)
        tg.ca_glu_matmul(x, tq, tu, prologue=TRms(gain))
    assert list(ctx.calibrators) == [f"k{K}n{N}"]
    cal = ctx.calibrators[f"k{K}n{N}"]
    normed = tg._apply_rms(x, TRms(gain))
    assert cal.n_observed == 2
    want = torch.maximum(x.abs().amax(dim=(0, 1)),
                         normed.abs().amax(dim=(0, 1)))
    assert torch.equal(cal._amax, want)
    with pytest.raises(ValueError, match="both GLU weights"):
        tg.ca_glu_matmul(x, tq, torch.tensor(d["w2"]).float())


@pytest.mark.parametrize("change,match", [
    ({"fmt": "fp8_e4m3"}, "int8 payloads only"),
    ({"axis": -1}, "axis"),
    ("stacked", "must be"),
], ids=["fp8", "axis", "stacked"])
def test_quantized_weight_contract_raises(change, match):
    """The kernel's weight contract: an fp8 payload is refused by the
    kernel wrapper (ca_matmul serves it by dequantizing, as the
    reference's oracle path does), a wrong axis or a stacked weight by
    the dispatch itself."""
    from repro_torch.quant import QTensor

    d = _inputs(8)
    (_, tq), _ = _qweights(d)
    x = torch.tensor(d["x"]).float()
    bad = (QTensor(data=tq.data[None], scale=tq.scale[None])
           if change == "stacked" else dataclasses.replace(tq, **change))
    call = tops.quant_matmul if change == {"fmt": "fp8_e4m3"} \
        else tg.ca_matmul
    with pytest.raises(ValueError, match=match):
        call(x, bad)


# ---------------------------------------------------------------------------
# Gradients: the trainable programs (K1f backward) against jax.grad of the
# reference's custom VJPs, run in Pallas interpret mode
# ---------------------------------------------------------------------------

GRAD_EPILOGUES = [                  # tests/test_fused_gemm.py:131-166
    ("bias+gelu", {"activation": "gelu", "bias": True}),
    ("silu+mul", {"activation": "silu", "mul": True}),
    ("res", {"residual": True}),
    ("bias+silu+mul+res", {"activation": "silu", "bias": True, "mul": True,
                           "residual": True}),
]


def _grads_close(got, want):
    # The reference's own tolerance for its VJPs (rtol/atol 1e-3).
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3,
                                   atol=1e-3)


@pytest.mark.parametrize("tag,flags", GRAD_EPILOGUES,
                         ids=[e[0] for e in GRAD_EPILOGUES])
def test_fused_matmul_grads_match_reference(tag, flags):
    m, n, k = 21, 40, 33
    r = np.random.RandomState(12)
    a, b = r.randn(m, k), r.randn(k, n) / np.sqrt(k)
    ops = {name: r.randn(*shape) for name, shape in
           (("bias", (n,)), ("mul", (m, n)), ("residual", (m, n)))
           if flags.get(name)}
    act = flags.get("activation", "none")

    def jloss(a, b, ops):
        epi = JEpilogue(activation=act, **ops)
        assert epi.spec().tag() == tag
        return (jops.fused_matmul(a, b, epi, interpret=True) ** 2).sum()

    f32 = lambda x: jnp.asarray(x, jnp.float32)  # noqa: E731
    want = jax.grad(jloss, argnums=(0, 1, 2))(
        f32(a), f32(b), {k_: f32(v) for k_, v in ops.items()})
    ta, tb = (torch.tensor(x).float().requires_grad_() for x in (a, b))
    tops_ = {k_: torch.tensor(v).float().requires_grad_()
             for k_, v in ops.items()}
    y = tops.fused_matmul(ta, tb, TEpilogue(activation=act, **tops_))
    (y ** 2).sum().backward()
    _grads_close([ta.grad, tb.grad] + [tops_[k_].grad for k_ in sorted(ops)],
                 jax.tree.leaves(want))


@pytest.mark.parametrize("prologue,m", [(False, 21), (True, 19)])
def test_glu_matmul_grads_match_reference(prologue, m):
    """tests/test_program_gemm.py:232-276: the four K1f programs of the
    GLU backward, with and without the rms prologue (whose row factor
    autograd closes through ``rms_row_scale``)."""
    n, k = 48, 64
    r = np.random.RandomState(m)
    x, wg, wu = r.randn(m, k), r.randn(k, n) / 8, r.randn(k, n) / 8
    gain = r.rand(k) + 0.5

    def jloss(x, wg, wu, g):
        pro = JRms(g) if prologue else None
        return (jops.glu_matmul(x, wg, wu, prologue=pro, interpret=True)
                ** 2).sum()

    f32 = lambda v: jnp.asarray(v, jnp.float32)  # noqa: E731
    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(f32(x), f32(wg), f32(wu),
                                                 f32(gain))
    tx, twg, twu, tgain = (torch.tensor(v).float().requires_grad_()
                           for v in (x, wg, wu, gain))
    y = tops.glu_matmul(tx, twg, twu,
                        prologue=TRms(tgain) if prologue else None)
    (y ** 2).sum().backward()
    got = [tx.grad, twg.grad, twu.grad]
    if prologue:
        got.append(tgain.grad)
    _grads_close(got, want[:len(got)])


def test_ca_matmul_qtensor_weight_has_no_backward():
    from repro_torch.quant.calibrate import QuantConfig, quantize_tensor
    qw = quantize_tensor(torch.randn(K, N), QuantConfig(), axis=-2)
    x = torch.randn(B, L, K, requires_grad=True)
    with pytest.raises(ValueError, match="no backward"):
        tg.ca_matmul(x, qw)
    with torch.no_grad():
        assert tg.ca_matmul(x, qw).shape == (B, L, N)


# ---------------------------------------------------------------------------
# The MoE expert loops against the reference's einsum oracle (xla mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lead", [(), (2,)], ids=["ecd", "becd"])
def test_ca_expert_matmul_matches_reference_einsum(lead):
    r = np.random.RandomState(21)
    E, C, d, f = 3, 8, 48, 40
    x = r.randn(*lead, E, C, d).astype(np.float32)
    w = (r.randn(E, d, f) / np.sqrt(d)).astype(np.float32)
    want = jg.ca_expert_matmul(jnp.asarray(x), jnp.asarray(w), mode="xla")
    got = tg.ca_expert_matmul(torch.as_tensor(x), torch.as_tensor(w))
    _close(got, want)


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("lead", [(), (2,)], ids=["ecd", "becd"])
def test_ca_expert_glu_matmul_matches_reference_einsum(lead, act):
    r = np.random.RandomState(22)
    E, C, d, f = 4, 16, 40, 24
    x = r.randn(*lead, E, C, d).astype(np.float32)
    wg, wu = ((r.randn(E, d, f) / np.sqrt(d)).astype(np.float32)
              for _ in range(2))
    want = jg.ca_expert_glu_matmul(jnp.asarray(x), jnp.asarray(wg),
                                   jnp.asarray(wu), activation=act,
                                   mode="xla")
    got = tg.ca_expert_glu_matmul(torch.as_tensor(x), torch.as_tensor(wg),
                                  torch.as_tensor(wu), activation=act)
    _close(got, want)


def test_ca_expert_matmul_runs_one_program_per_expert(monkeypatch):
    """Each expert is one ca_matmul (one K1 launch on the card) of its own
    rows: E calls, each on that expert's (B·C, d) slice."""
    calls = []
    real = tg.ca_matmul

    def spy(x, w, **kw):
        calls.append((tuple(x.shape), tuple(w.shape)))
        return real(x, w, **kw)

    monkeypatch.setattr(tg, "ca_matmul", spy)
    x = torch.randn(2, 5, 8, 16)
    w = torch.randn(5, 16, 12)
    y = tg.ca_expert_matmul(x, w)
    assert y.shape == (2, 5, 8, 12)
    assert calls == [((2, 8, 16), (16, 12))] * 5
    torch.testing.assert_close(y[:, 3], x[:, 3] @ w[3])
    with pytest.raises(ValueError, match="bank"):
        tg.ca_expert_matmul(x, w[:4])
