"""The port's CA-GEMM program on the CPU (its plain version) against the
reference kernel run in Pallas interpret mode, on ragged shapes: the
forward programs (K1a–c), the dequant programs (K1d–e), the backward
programs of training (K1f: nt/tn layouts, the dact prologue,
save_preact), the distance product (K1g) and the k-outer ablation (K4).
The CUDA kernels themselves are held against the plain versions in
test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import distance_product as jax_distance_product
from repro.kernels import ref as jax_ref
from repro.kernels.ca_mmm import ca_gemm_program as jax_program
from repro.kernels.ca_mmm import ca_mmm as jax_ca_mmm
from repro.kernels.ca_mmm import ca_mmm_k_outer as jax_k_outer
from repro.kernels.program import program_from_tag as jax_from_tag
from repro_torch.kernels import ca_mmm as K
from repro_torch.kernels import ops
from repro_torch.kernels import ref as torch_ref
from repro_torch.kernels.program import program_from_tag, rms_row_scale

TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _operands(tag, m, n, k, dtype, seed=0):
    """numpy operands for one program: A, the B branches, the rms
    prologue's gain and each branch's drain operands."""
    r = np.random.RandomState(seed)
    spec = program_from_tag(tag)
    ops = {"a": r.randn(m, k),
           "bs": [r.randn(k, n) / np.sqrt(k) for _ in range(spec.n_b)],
           "gain": r.rand(k) + 0.5 if spec.prologue.kind == "rms" else None,
           "branch": []}
    for b in spec.branches:
        d = {}
        if b.has_bias:
            d["bias"] = r.randn(n)
        if b.has_mul:
            d["mul"] = r.randn(m, n)
        if b.has_residual:
            d["residual"] = r.randn(m, n)
        ops["branch"].append(d)
    return ops


def _run_jax(tag, ops, dtype, out_dtype=None):
    jdt = jnp.dtype(dtype)
    a = jnp.asarray(ops["a"], jdt)
    kw = {}
    if ops["gain"] is not None:
        kw["gain"] = jnp.asarray(ops["gain"], jnp.float32)
        xf = a.astype(jnp.float32)
        kw["row_scale"] = 1.0 / jnp.sqrt(
            jnp.mean(xf * xf, axis=-1, keepdims=True) + 1e-5)
    out = jax_program(
        a, [jnp.asarray(b, jdt) for b in ops["bs"]], spec=jax_from_tag(tag),
        bm=8, bn=128, bk=128, interpret=True, out_dtype=out_dtype,
        branch_operands=[{k: jnp.asarray(v, jdt) for k, v in d.items()}
                         for d in ops["branch"]], **kw)
    return np.asarray(out.astype(jnp.float32))


def _run_torch(tag, ops, dtype, out_dtype=None):
    tdt = TORCH_DT[dtype]
    t = lambda x, dt=tdt: torch.as_tensor(x).to(dtype=dt)
    a = t(ops["a"])
    kw = {}
    if ops["gain"] is not None:
        kw["gain"] = t(ops["gain"], torch.float32)
        kw["row_scale"] = rms_row_scale(a, 1e-5)
    return K.ca_gemm_program(
        a, [t(b) for b in ops["bs"]], spec=program_from_tag(tag),
        out_dtype=out_dtype,
        branch_operands=[{k: t(v) for k, v in d.items()}
                         for d in ops["branch"]], **kw)


FLOAT_TAGS = ["none", "res", "rms>glu.silu(none|none)", "bias+gelu+mul+res"]


@pytest.mark.parametrize("m", [1, 5, 37])
@pytest.mark.parametrize("tag", FLOAT_TAGS)
def test_fp32_matches_reference_kernel(tag, m):
    # n = 200 is not a multiple of 128; bk = 128 does not divide k = 300.
    n, k = 200, 300
    ops = _operands(tag, m, n, k, "float32", seed=m)
    want = _run_jax(tag, ops, "float32")
    got = _run_torch(tag, ops, "float32").numpy()
    assert got.shape == (m, n)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_bf16_rms_glu_matches_reference_kernel():
    # The rms prologue re-rounds A to bf16 and the fp32 sums run in another
    # order, so one bf16 ulp of the output may flip: 2e-2 of max|ref|.
    tag, m, n, k = "rms>glu.silu(none|none)", 37, 200, 300
    ops = _operands(tag, m, n, k, "bfloat16", seed=3)
    want = _run_jax(tag, ops, "bfloat16")
    got = _run_torch(tag, ops, "bfloat16")
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 2e-2 * np.abs(want).max(), err


def test_fp32_out_of_bf16_operands_matches_reference_kernel():
    # The logits head: bf16 operands, fp32 out.
    ops = _operands("none", 5, 200, 300, "bfloat16", seed=4)
    want = _run_jax("none", ops, "bfloat16", out_dtype=jnp.float32)
    got = _run_torch("none", ops, "bfloat16", out_dtype=torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("tag,kw,slice_", [
    # K1d is ported: what still raises is a dqb program with a float B.
    pytest.param("dqb+res", {}, "must be .* int8", id="dqb+res-kw0-K1d"),
    # K1f is ported: what still raises are the reference's own contracts.
    ("dact.silu>none", {}, "needs preact"),
    ("dact.silu>none", {"transpose_a": True}, "dact@a decorates"),
    ("glu.silu(none|none)", {"transpose_b": True}, "multi-branch"),
    ("dqb", {"transpose_b": True}, "quantized streaming"),
    # K1g is ported: what still raises is min_plus on anything but a plain
    # program (the reference's contract) and an unknown semiring.
    ("res", {"semiring": "min_plus"}, "plain"),
    ("none", {"semiring": "min_plus", "transpose_b": True}, "plain"),
    ("none", {"semiring": "max_plus"}, "unknown semiring"),
    ("dual(none|none)", {}, "dual"),
])
def test_unported_programs_raise(tag, kw, slice_):
    spec = program_from_tag(tag)
    a = torch.ones(4, 8)
    bs = [torch.ones(8, 6)] * spec.n_b
    with pytest.raises(ValueError, match=slice_):
        K.ca_gemm_program(a, bs, spec=spec, **kw)


def test_bad_operands_raise_and_cpu_never_counts():
    K.reset_launch_counts()
    a = torch.ones(4, 8)
    with pytest.raises(ValueError, match="B must be"):
        K.ca_gemm_program(a, [torch.ones(8, 6, dtype=torch.bfloat16)])
    with pytest.raises(ValueError, match="contiguous"):
        K.ca_gemm_program(a, [torch.ones(6, 8).t()])
    with pytest.raises(ValueError, match="row_scale"):
        K.ca_gemm_program(a, [torch.ones(8, 6)],
                          spec=program_from_tag("rms>none"))
    K.ca_gemm_program(a, [torch.ones(8, 6)])
    assert K.launch_counts == {}



def _quant_operands(tag, m, n, k, block_b, block_a, seed):
    """numpy operands of one dqb/dqab program: float or int8 A, int8 B
    branches and their positive fp32 scales, per channel / row or per
    tile."""
    r = np.random.RandomState(seed)
    spec = program_from_tag(tag)
    ab = spec.branches[0].dequant == "ab"
    i8 = lambda *s: r.randint(-127, 128, s).astype(np.int8)  # noqa: E731
    ops = {"a": i8(m, k) if ab else r.randn(m, k).astype(np.float32),
           "bs": [i8(k, n) for _ in range(spec.n_b)], "branch": []}
    sa = (r.rand(-(-k // block_a) if block_a else m) * 0.05 + 0.01
          ).astype(np.float32)
    for b in spec.branches:
        d = {"scale_b": (r.rand(*((-(-k // block_b), n) if block_b
                                  else (n,))) * 0.01 + 1e-3
                         ).astype(np.float32)}
        if ab:
            d["scale_a"] = sa
        for name, shape in (("bias", (n,)), ("mul", (m, n)),
                            ("residual", (m, n))):
            if getattr(b, "has_" + name):
                d[name] = r.randn(*shape).astype(np.float32)
        ops["branch"].append(d)
    return ops


@pytest.mark.parametrize("tag,blocks", [
    ("dqb+bias+silu+mul+res", (0, 0)), ("dqb+res", (128, 0)),
    ("glu.gelu(dqb+bias|dqb+bias)", (128, 0)), ("dqab", (0, 0)),
    ("dqab+res", (128, 128)), ("dqab", (0, 128)),
    ("glu.silu(dqab|dqab)", (0, 0)), ("rms>glu.silu(dqb|dqb)", (0, 0))])
@pytest.mark.parametrize("m", [1, 37, 8])
def test_quant_programs_match_reference_kernel(tag, blocks, m):
    """The dequant programs, among them the served int8w GLU with its rms
    prologue (bf16 A, as int8w serving streams it, and fp32 out) and the
    served w8a8 GLU, at decode (m = 1), the 8-token prefill and m = 37."""
    # Ragged n and k: 300 = 128 + 128 + 44 rows of k.
    n, k = 200, 300
    block_b, block_a = blocks
    ops = _quant_operands(tag, m, n, k, block_b, block_a, seed=m)
    spec = program_from_tag(tag)
    j_a, t_a = jnp.asarray(ops["a"]), torch.as_tensor(ops["a"])
    j_kw, t_kw = {}, {}
    if spec.prologue.kind == "rms":
        j_a, t_a = j_a.astype(jnp.bfloat16), t_a.to(torch.bfloat16)
        gain = np.random.RandomState(m + 1).rand(k).astype(np.float32) + 0.5
        xf = j_a.astype(jnp.float32)
        j_kw = {"gain": jnp.asarray(gain), "out_dtype": jnp.float32,
                "row_scale": 1.0 / jnp.sqrt(jnp.mean(
                    xf * xf, axis=-1, keepdims=True) + 1e-5)}
        t_kw = {"gain": torch.as_tensor(gain), "out_dtype": torch.float32,
                "row_scale": rms_row_scale(t_a, 1e-5)}
    want = jax_program(
        j_a, [jnp.asarray(b) for b in ops["bs"]],
        spec=jax_from_tag(tag), bm=8, bn=128, bk=128, interpret=True,
        branch_operands=[{k_: jnp.asarray(v) for k_, v in d.items()}
                         for d in ops["branch"]],
        scale_b_block=block_b, scale_a_block=block_a, **j_kw)
    got = K.ca_gemm_program(
        t_a, [torch.as_tensor(b) for b in ops["bs"]], spec=spec,
        branch_operands=[{k_: torch.as_tensor(v) for k_, v in d.items()}
                         for d in ops["branch"]],
        scale_b_block=block_b, scale_a_block=block_a, **t_kw)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4,
                               atol=2e-3 * np.abs(want).max())


# ---------------------------------------------------------------------------
# K1f: transposed layouts, the dact prologue, save_preact
# ---------------------------------------------------------------------------

def _close(got, want, dtype):
    """fp32: the reference's 1e-4; bf16: one output ulp may flip after the
    prologue's re-rounding, so 2e-2 of max|ref| (``test_fused_gemm.py``)."""
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


@pytest.mark.parametrize("layout", ["nt", "tn"])
@pytest.mark.parametrize("m,n,k", [(37, 64, 50), (16, 40, 96)])
def test_transposed_layouts_match_reference_kernel(m, n, k, layout):
    ta, tb = layout[0] == "t", layout[1] == "t"
    r = np.random.RandomState(m + n)
    a = r.randn(*((k, m) if ta else (m, k))).astype(np.float32)
    b = (r.randn(*((n, k) if tb else (k, n))) / np.sqrt(k)).astype(
        np.float32)
    want = jax_program(jnp.asarray(a), [jnp.asarray(b)], bm=8, bn=128,
                       bk=128, interpret=True, transpose_a=ta,
                       transpose_b=tb)
    got = K.ca_gemm_program(torch.as_tensor(a), [torch.as_tensor(b)],
                            transpose_a=ta, transpose_b=tb)
    _close(got, want, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["silu", "gelu", "relu"])
@pytest.mark.parametrize("operand", ["a", "b"])
def test_dact_prologue_matches_reference_kernel(operand, act, dtype):
    """dact@a on the nt program (dxn = (g·act'(h)) Bᵀ) and dact@b on the
    tn program (dB = Aᵀ (g·act'(h))): the backward GEMMs of a fused
    activation."""
    m, n, k = 37, 64, 50
    r = np.random.RandomState(len(act) + (operand == "b"))
    tag = f"dact.{act}{'@b' if operand == 'b' else ''}>none"
    if operand == "a":      # A = g (m, k), B stored (n, k), h like A
        a, b, h = r.randn(m, k), r.randn(n, k) / np.sqrt(k), r.randn(m, k)
        kw = {"transpose_b": True}
    else:                   # A stored (k, m), B = g (k, n), h like B
        a, b, h = r.randn(k, m), r.randn(k, n) / np.sqrt(k), r.randn(k, n)
        kw = {"transpose_a": True}
    jdt, tdt = jnp.dtype(dtype), TORCH_DT[dtype]
    want = jax_program(jnp.asarray(a, jdt), [jnp.asarray(b, jdt)],
                       spec=jax_from_tag(tag), bm=8, bn=128, bk=128,
                       interpret=True, preact=jnp.asarray(h, jnp.float32),
                       **kw)
    got = K.ca_gemm_program(
        torch.as_tensor(a).to(tdt), [torch.as_tensor(b).to(tdt)],
        spec=program_from_tag(tag), preact=torch.as_tensor(h).float(), **kw)
    assert got.dtype == tdt
    _close(got, want, dtype)


@pytest.mark.parametrize("tag", ["bias+gelu", "glu.silu(none|none)",
                                 "rms>glu.silu(none|none)"])
def test_save_preact_matches_reference_kernel(tag):
    """The forward programs of training drain each branch's fp32 value
    after bias, before the activation, beside the output."""
    m, n, k = 37, 200, 300
    ops = _operands(tag, m, n, k, "float32", seed=11)
    jkw, tkw = {}, {}
    if ops["gain"] is not None:
        a32 = torch.as_tensor(ops["a"]).float()
        tkw = {"gain": torch.as_tensor(ops["gain"]).float(),
               "row_scale": rms_row_scale(a32, 1e-5)}
        jkw = {"gain": jnp.asarray(ops["gain"], jnp.float32),
               "row_scale": jnp.asarray(tkw["row_scale"].numpy())}
    want = jax_program(
        jnp.asarray(ops["a"], jnp.float32),
        [jnp.asarray(b, jnp.float32) for b in ops["bs"]],
        spec=jax_from_tag(tag), bm=8, bn=128, bk=128, interpret=True,
        save_preact=True,
        branch_operands=[{k_: jnp.asarray(v, jnp.float32)
                          for k_, v in d.items()} for d in ops["branch"]],
        **jkw)
    got = K.ca_gemm_program(
        torch.as_tensor(ops["a"]).float(),
        [torch.as_tensor(b).float() for b in ops["bs"]],
        spec=program_from_tag(tag), save_preact=True,
        branch_operands=[{k_: torch.as_tensor(v).float()
                          for k_, v in d.items()} for d in ops["branch"]],
        **tkw)
    spec = program_from_tag(tag)
    assert len(got) == len(want) == 1 + spec.n_b
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w, "float32")


def test_launch_keys_carry_layout_and_save_preact():
    assert K.launch_key("none") == "none"
    assert K.launch_key("dact.silu>none", K.layout_tag(False, True)) \
        == "dact.silu>none nt"
    assert K.launch_key("dact.silu@b>none", K.layout_tag(True, False)) \
        == "dact.silu@b>none tn"
    assert K.launch_key("rms>glu.silu(none|none)", "nn", True) \
        == "rms>glu.silu(none|none) save_preact"


# ---------------------------------------------------------------------------
# ca_mmm: the single-branch builder, keyword by keyword
# ---------------------------------------------------------------------------

def _ca_mmm_operands(case):
    """One ca_mmm case: numpy A and B, the program tag its epilogue and
    prologue come from, the operands' dtype (None: keep numpy's), the
    plain keywords and the array keywords."""
    r = np.random.RandomState(21)
    m, n, k = 37, 200, 300
    f32 = lambda *s: r.randn(*s).astype(np.float32)  # noqa: E731
    a, b = f32(m, k), f32(k, n) / np.float32(np.sqrt(k))
    tag, dtype, kw, arrays = "none", "float32", {}, {}
    if case == "tiles":           # accepted and not read
        kw = {"bm": 16, "bn": 64, "bk": 32}
    elif case == "out_dtype":
        dtype, kw = "bfloat16", {"out_dtype": "float32"}
    elif case == "transpose_a":
        a, kw = np.ascontiguousarray(a.T), {"transpose_a": True}
    elif case == "transpose_b":
        b, kw = np.ascontiguousarray(b.T), {"transpose_b": True}
    elif case == "epilogue":
        tag = "bias+gelu+mul+res"
        arrays = {"bias": f32(n), "mul": f32(m, n), "residual": f32(m, n)}
    elif case == "prologue":
        tag = "rms>none"
        arrays = {"gain": (r.rand(k) + 0.5).astype(np.float32),
                  "row_scale": (1.0 / np.sqrt(
                      (a * a).mean(-1, keepdims=True) + 1e-5)
                  ).astype(np.float32)}
    elif case == "save_preact":
        tag, kw, arrays = "bias+gelu", {"save_preact": True}, {"bias": f32(n)}
    elif case == "preact":
        tag, b = "dact.silu>none", np.ascontiguousarray(b.T)
        kw, arrays = {"transpose_b": True}, {"preact": f32(m, k)}
    elif case in ("scale_b", "scale_a"):
        tag, blocks = (("dqb+res", (128, 0)) if case == "scale_b"
                       else ("dqab", (0, 128)))
        ops_ = _quant_operands(tag, m, n, k, *blocks, seed=21)
        a, b, arrays, dtype = ops_["a"], ops_["bs"][0], ops_["branch"][0], None
        kw = {"scale_b_block": blocks[0], "scale_a_block": blocks[1]}
    elif case == "semiring":
        a = (r.rand(m, k) + 1.0).astype(np.float32)
        b = (r.rand(k, n) + 1.0).astype(np.float32)
        kw = {"semiring": "min_plus"}
    return a, b, tag, dtype, kw, arrays


CA_MMM_CASES = ["tiles", "out_dtype", "transpose_a", "transpose_b",
                "epilogue", "prologue", "save_preact", "preact", "scale_b",
                "scale_a", "semiring"]


@pytest.mark.parametrize("case", CA_MMM_CASES)
def test_ca_mmm_keywords_match_reference_builder(case):
    """Each keyword of the port's ``ca_mmm`` against the reference's
    ``ca_mmm`` in interpret mode, on ragged n and k."""
    a, b, tag, dtype, kw, arrays = _ca_mmm_operands(case)
    spec, jspec = program_from_tag(tag), jax_from_tag(tag)
    jkw = {k_: v for k_, v in kw.items() if k_ not in ("bm", "bn", "bk")}
    tkw = dict(kw)
    if "out_dtype" in kw:
        jkw["out_dtype"] = jnp.dtype(kw["out_dtype"])
        tkw["out_dtype"] = TORCH_DT[kw["out_dtype"]]
    ja, jb = (jnp.asarray(x, dtype and jnp.dtype(dtype)) for x in (a, b))
    ta, tb = (torch.as_tensor(x) for x in (a, b))
    if dtype is not None:
        ta, tb = ta.to(TORCH_DT[dtype]), tb.to(TORCH_DT[dtype])
    want = jax_ca_mmm(
        ja, jb, bm=8, bn=128, bk=128, interpret=True,
        epilogue=jspec.branches[0], prologue=jspec.prologue,
        **{k_: jnp.asarray(v) for k_, v in arrays.items()}, **jkw)
    got = K.ca_mmm(ta, tb, epilogue=spec.branches[0], prologue=spec.prologue,
                   **{k_: torch.as_tensor(v) for k_, v in arrays.items()},
                   **tkw)
    if case == "save_preact":
        assert len(got) == len(want) == 2
    else:
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        w = np.asarray(jnp.asarray(w, jnp.float32))
        if case == "semiring":
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(), w)
        elif dtype is None:       # the dequant programs' tolerance
            np.testing.assert_allclose(g.float().numpy(), w, rtol=2e-4,
                                       atol=2e-3 * np.abs(w).max())
        else:
            _close(g, w, "float32")


# ---------------------------------------------------------------------------
# K1g: the distance product
# ---------------------------------------------------------------------------

def _min_plus_operands(case):
    """numpy (A, B) and their dtype for one distance-product case."""
    r = np.random.RandomState(11)
    m, k, n = {"ref": (65, 33, 47), "ragged_k": (37, 300, 29)}.get(
        case, (20, 45, 30))
    a, b = r.rand(m, k) + 1.0, r.rand(k, n) + 1.0
    if case == "inf":
        a[r.rand(m, k) < 0.3] = np.inf
        b[r.rand(k, n) < 0.3] = np.inf
        a[3] = np.inf               # a row that reaches nothing
    if case == "nan":
        a[4, 7] = np.nan            # row 4 of C is NaN in every column
        b[9, 2] = np.nan            # and column 2 in every row
    return a, b, ("bfloat16" if case == "bf16" else "float32")


@pytest.mark.parametrize("route", ["distance_product", "ca_gemm_program"])
@pytest.mark.parametrize("case", ["ref", "ragged_k", "bf16", "inf", "nan"])
def test_distance_product_matches_reference_kernel_bit_equal(case, route):
    """fp32 adds and minima are exact and order-free: bit-equal to the
    reference kernel (NaN where it has NaN); k = 300 is ragged against any
    bk the reference plans (128, 256 or 384), so its +inf edge fill runs."""
    a, b, dtype = _min_plus_operands(case)
    jdt, tdt = jnp.dtype(dtype), TORCH_DT[dtype]
    want = np.asarray(jax_distance_product(jnp.asarray(a, jdt),
                                           jnp.asarray(b, jdt),
                                           interpret=True))
    ta, tb = torch.as_tensor(a).to(tdt), torch.as_tensor(b).to(tdt)
    K.reset_launch_counts()
    if route == "distance_product":
        got = ops.distance_product(ta, tb)
    else:
        got = K.ca_gemm_program(ta, [tb], semiring="min_plus")
    assert got.dtype == torch.float32 and K.launch_counts == {}
    assert want.dtype == np.float32
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "nan":
        assert np.isnan(want[4]).all() and np.isnan(want[:, 2]).all()
        assert np.isfinite(np.delete(np.delete(want, 4, 0), 2, 1)).all()
    if case == "inf":
        assert np.isinf(want[3]).all()


def test_ref_distance_product_matches_the_reference_oracle():
    """The port's oracle, chunked over k, against the reference's full
    broadcast: bit-equal in fp32 and in bf16 (whose sums round to bf16
    in both)."""
    r = np.random.RandomState(12)
    a, b = r.rand(40, 70) + 1.0, r.rand(70, 30) + 1.0
    for dtype in ("float32", "bfloat16"):
        want = jax_ref.ref_distance_product(jnp.asarray(a, dtype),
                                            jnp.asarray(b, dtype))
        got = torch_ref.ref_distance_product(
            torch.as_tensor(a).to(TORCH_DT[dtype]),
            torch.as_tensor(b).to(TORCH_DT[dtype]))
        assert str(got.dtype) == f"torch.{dtype}"
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))


def test_distance_product_contract_raises():
    a = torch.ones(4, 8)
    with pytest.raises(ValueError, match="writes float32"):
        K.ca_mmm(a, torch.ones(8, 6), semiring="min_plus",
                 out_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="B must be"):
        ops.distance_product(a, torch.ones(7, 6))


@pytest.mark.parametrize("entry", ["distance_product", "ca_mmm_any",
                                   "ca_mmm"])
@pytest.mark.parametrize("dtype", ["float16", "int32", "int8"])
def test_distance_product_casts_operands_like_the_reference(dtype, entry):
    """fp16, int32 and int8 operands are cast to fp32 on entry, as the
    reference's kernel casts them: an fp32 result bit-equal to the
    reference's ``distance_product`` in interpret mode, through each of
    the port's three entry points."""
    r = np.random.RandomState(0)
    a, b = r.rand(13, 20), r.rand(20, 7)
    if dtype != "float16":
        a, b = (a * 100).astype(dtype), (b * 100).astype(dtype)
    a, b = a.astype(dtype), b.astype(dtype)
    want = np.asarray(jax_distance_product(jnp.asarray(a), jnp.asarray(b),
                                           interpret=True))
    assert want.dtype == np.float32 and want.shape == (13, 7)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    assert ta.dtype == getattr(torch, dtype)
    got = {"distance_product": ops.distance_product,
           "ca_mmm_any": lambda x, y: ops.ca_mmm_any(x, y,
                                                     semiring="min_plus"),
           "ca_mmm": lambda x, y: K.ca_mmm(x, y, semiring="min_plus")
           }[entry](ta, tb)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# K4: the k-outer ablation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tiles", [(128, 128, 128), (None, None, None)],
                         ids=["ref_tiles", "port_default"])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_k_outer_matches_reference_kernel(dtype, tiles):
    """The reference's test shape; fp32 to its 1e-4, int8 exactly (int32
    sums).  The reference runs its tiles of 128; the port's default tile
    for these dtypes (64, 64, 32) takes 8 k steps instead of 2 and gives
    the same sums."""
    r = np.random.RandomState(2)
    if dtype == "int8":
        a = r.randint(-127, 128, (256, 256)).astype(np.int8)
        b = r.randint(-127, 128, (256, 128)).astype(np.int8)
    else:
        a, b = r.randn(256, 256), r.randn(256, 128)
    jdt = jnp.dtype(dtype)
    want = np.asarray(jax_k_outer(jnp.asarray(a, jdt), jnp.asarray(b, jdt),
                                  bm=128, bn=128, bk=128, interpret=True))
    bm, bn, bk = tiles
    ta = torch.as_tensor(a).to(getattr(torch, dtype))
    tb = torch.as_tensor(b).to(getattr(torch, dtype))
    K.reset_launch_counts()
    got = K.ca_mmm_k_outer(ta, tb, bm=bm, bn=bn, bk=bk)
    assert K.launch_counts == {}
    if dtype == "int8":
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_k_outer_bf16_casts_after_the_last_step():
    """bf16 operands accumulate in fp32 and the output is cast once at the
    end, to A's dtype by default or to out_dtype."""
    r = np.random.RandomState(3)
    a, b = r.randn(128, 192), r.randn(192, 64)
    ta, tb = torch.as_tensor(a).bfloat16(), torch.as_tensor(b).bfloat16()
    want = jax_k_outer(jnp.asarray(a, jnp.bfloat16),
                       jnp.asarray(b, jnp.bfloat16), bm=64, bn=64, bk=64,
                       interpret=True)
    got = K.ca_mmm_k_outer(ta, tb, bm=64, bn=64, bk=64)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)
    f32 = K.ca_mmm_k_outer(ta, tb, bm=64, bn=64, bk=64,
                           out_dtype=torch.float32)
    np.testing.assert_allclose(f32.numpy(), ta.float().numpy()
                               @ tb.float().numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape,kw,match", [
    (((100, 64), (64, 64)), {}, "tile-divisible"),
    (((64, 64), (64, 64)), {"bm": 48}, "tile-divisible"),
    (((64, 64), (64, 64)), {"bk": -32}, "positive"),
    (((64, 64), (32, 64)), {}, "contraction"),
])
def test_k_outer_contract_raises(shape, kw, match):
    with pytest.raises(ValueError, match=match):
        K.ca_mmm_k_outer(torch.ones(*shape[0]), torch.ones(*shape[1]), **kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["64^3 tiles 32", "8x128 default",
                                  "128^3 default"])
def test_k_outer_takes_any_dividing_tile(case, dtype):
    """Tiles the reference computes: any tile that divides the shape, and
    the default clamped to the shape as the reference clamps it (the
    kernel's own tile for the dtype, e.g. (64, 64, 32) -> (8, 64, 32) at
    m = 8).  fp32 to 1e-4, bf16 to one output ulp."""
    (m, k, n), tiles = {"64^3 tiles 32": ((64, 64, 64), (32, 32, 32)),
                        "8x128 default": ((8, 128, 128), (None,) * 3),
                        "128^3 default": ((128, 128, 128), (None,) * 3)
                        }[case]
    r = np.random.RandomState(4)
    a, b = r.randn(m, k), r.randn(k, n)
    jdt = jnp.dtype(dtype)
    bm, bn, bk = tiles
    want = np.asarray(jax_k_outer(jnp.asarray(a, jdt), jnp.asarray(b, jdt),
                                  bm=bm, bn=bn, bk=bk, interpret=True)
                      .astype(jnp.float32))
    got = K.ca_mmm_k_outer(torch.as_tensor(a).to(TORCH_DT[dtype]),
                           torch.as_tensor(b).to(TORCH_DT[dtype]),
                           bm=bm, bn=bn, bk=bk)
    assert got.dtype == TORCH_DT[dtype] and got.shape == (m, n)
    tol = 1e-4 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("dtype,m,k,n,tiles,route", [
    (torch.bfloat16, 256, 128, 256, (None, None, None), "wgmma"),
    (torch.bfloat16, 256, 256, 256, (256, 128, 128), "wgmma"),
    (torch.bfloat16, 128, 96, 192, (64, 64, 32), "simt"),
    (torch.float32, 256, 256, 256, (128, 128, 64), "simt"),
    (torch.int8, 128, 128, 128, (None, None, None), "simt"),
    (torch.float32, 64, 64, 64, (32, 32, 32), None),
    (torch.bfloat16, 8, 128, 128, (None, None, None), None),
])
def test_k_outer_card_routes_and_refusals(dtype, m, k, n, tiles, route,
                                          monkeypatch):
    """The step the card takes for a tile: wgmma for bf16 whole
    128 x 128 x 64 blocks (the default bf16 tile), SIMT for multiples of
    64 x 64 x 32; a dividing tile neither takes raises naming the tile and
    the shape, before anything is built or launched."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def no_build(*a, **k):
        raise RuntimeError("kernel build reached")

    monkeypatch.setattr(K._build, "load", no_build)
    bm, bn, bk = tiles
    with FakeTensorMode():
        a = torch.empty(m, k, dtype=dtype, device="cuda")
        b = torch.empty(k, n, dtype=dtype, device="cuda")
        _, _, _, cbm, cbn, cbk, _, _ = K._check_k_outer(a, b, bm, bn, bk,
                                                        None)
        assert K.k_outer_route(dtype, cbm, cbn, cbk) == route
        with pytest.raises((ValueError, RuntimeError)) as err:
            K.ca_mmm_k_outer(a, b, bm=bm, bn=bn, bk=bk)
    if route is None:
        assert err.type is ValueError
        assert f"({cbm}, {cbn}, {cbk})" in str(err.value)
        assert f"({m}, {k}) @ ({k}, {n})" in str(err.value)
    else:
        assert "kernel build reached" in str(err.value)


# ---------------------------------------------------------------------------
# CUDA tensors never reach the plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["distance_product", "k_outer"])
def test_cuda_tensors_never_run_the_plain_version(which, monkeypatch):
    """On a CUDA tensor the wrapper launches the kernel or raises; here,
    with no card and no nvcc, it raises and never falls back."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def no_fallback(*a, **k):
        raise AssertionError("the plain version ran on a CUDA tensor")

    for name in ("ca_gemm_program_reference", "ref_distance_product",
                 "ca_mmm_k_outer_reference", "_step_product"):
        monkeypatch.setattr(K, name, no_fallback)
    K.reset_launch_counts()
    with FakeTensorMode():
        a = torch.empty(64, 64, device="cuda")
        b = torch.empty(64, 64, device="cuda")
        with pytest.raises((RuntimeError, AssertionError)) as err:
            if which == "distance_product":
                ops.distance_product(a, b)
            else:
                K.ca_mmm_k_outer(a, b)
    assert "plain version" not in str(err.value)
    assert K.launch_counts == {}


# ---------------------------------------------------------------------------
# Routes: which K1 launches take the TMA + WGMMA main loop
# ---------------------------------------------------------------------------

BF16 = torch.bfloat16
GLU = "rms>glu.silu(none|none)"


def _route(tag, layout, dtypes, m, n, k, *, semiring="plus_times",
           misaligned=False, save_preact=False):
    """k1_route of one call's operands, built as CPU tensors in their
    stored layouts (A (k, m) for t?, B (n, k) for ?t), with A's base moved
    off 16 bytes by one element where ``misaligned``."""
    spec = program_from_tag(tag)
    a_dt, b_dt = dtypes
    a_shape = (k, m) if layout[0] == "t" else (m, k)
    if misaligned:
        a = torch.empty(a_shape[0] * a_shape[1] + 1, dtype=a_dt)[1:]
        a = a.view(a_shape)
    else:
        a = torch.empty(a_shape, dtype=a_dt)
    bs = [torch.empty((n, k) if layout[1] == "t" else (k, n), dtype=b_dt)
          for _ in range(spec.n_b)]
    pro = spec.prologue
    preact = None
    if pro.kind == "dact":
        preact = torch.empty((m, k) if pro.operand == "a" else (k, n))
    return K.k1_route(spec, layout, a_dt, b_dt, m, n, k,
                      K.tma_aligned(a, *bs, preact), semiring,
                      save_preact=save_preact)


@pytest.mark.parametrize("tag,layout,dtypes,m,n,k,kw,want", [
    ("none", "nn", (BF16, BF16), 9, 2048, 2048, {}, "wgmma"),
    ("none", "nn", (BF16, BF16), 8, 2048, 2048, {}, "decode"),
    ("res", "nn", (BF16, BF16), 1, 2048, 5632, {}, "decode"),
    (GLU, "nn", (BF16, BF16), 37, 5632, 2048, {}, "wgmma"),
    ("none", "nn", (torch.float32,) * 2, 1024, 2048, 2048, {}, "simt"),
    ("none nt", "nt", (torch.float32,) * 2, 1024, 2048, 2048, {}, "simt"),
    ("dqb", "nn", (BF16, torch.int8), 1024, 2048, 2048, {}, "simt"),
    ("dqab", "nn", (torch.int8,) * 2, 1024, 2048, 2048, {}, "simt"),
    ("none", "nn", (BF16, BF16), 1024, 2048, 2048,
     {"semiring": "min_plus"}, "simt"),
    ("none", "nn", (BF16, BF16), 1024, 2048, 2052, {}, "simt"),
    ("none", "nn", (BF16, BF16), 1024, 2048, 2048, {"misaligned": True},
     "simt"),
    ("none", "tn", (BF16, BF16), 37, 2048, 1024, {}, "simt"),
    ("none", "tn", (BF16, BF16), 40, 2048, 1024, {}, "wgmma"),
    ("none", "tt", (BF16, BF16), 1024, 2048, 2048, {}, "wgmma"),
    ("dact.silu>none", "nt", (BF16, BF16), 1024, 2048, 5630, {}, "simt"),
    ("glu.silu(none|none)", "nt", (BF16, BF16), 1024, 2048, 2048, {},
     "simt"),
    ("res", "nn", (BF16, BF16), 1000, 2048, 5632, {}, "wgmma"),
], ids=lambda v: str(v).replace("torch.", "") if not isinstance(v, dict)
    else "-".join(v) or "plain")
def test_k1_route(tag, layout, dtypes, m, n, k, kw, want):
    """wgmma for bf16 A and B at m > 8 with TMA-aligned operands (bases and
    row strides on 16 bytes), one branch in any layout or the GLU in nn
    without dact; decode for the same at m <= 8 (serving programs); SIMT
    for fp32, int8, min_plus, a k, m or base off 16 bytes, and the GLU in
    another layout."""
    assert _route(tag.split(" ")[0], layout, dtypes, m, n, k, **kw) == want


# The decode route: stablelm-1.6b's and h2o-danube-3-4b's serving programs
# at m <= 8 (k, n), and the cases at m <= 8 that stay on the SIMT tile.
DECODE_PROGRAMS = [("none", 2048, 2048), ("none", 2048, 100352),
                   ("res", 5632, 2048), (GLU, 2048, 5632),
                   ("bias+gelu+mul+res", 3840, 960),
                   ("glu.gelu(bias|bias)", 3840, 10240)]


@pytest.mark.parametrize("m", [1, 3, 8])
@pytest.mark.parametrize("tag,k,n", DECODE_PROGRAMS,
                         ids=[f"{t} {k}x{n}" for t, k, n in DECODE_PROGRAMS])
def test_k1_route_takes_decode_at_m_up_to_8(tag, k, n, m):
    """bf16, aligned nn serving programs at m <= 8 take the decode route,
    and the same program at m = 9 the wgmma route."""
    assert _route(tag, "nn", (BF16, BF16), m, n, k) == "decode"
    assert _route(tag, "nn", (BF16, BF16), 9, n, k) == "wgmma"


@pytest.mark.parametrize("m", [1, 3, 8])
@pytest.mark.parametrize("case", [
    ("none", "nn", (torch.float32,) * 2, {}),
    ("none", "nn", (BF16, BF16), {"semiring": "min_plus"}),
    ("none", "nn", (BF16, BF16), {"misaligned": True}),
    ("none", "nt", (BF16, BF16), {}),
    ("none", "tn", (BF16, BF16), {}),
    ("dact.silu>none", "nn", (BF16, BF16), {}),
    ("dact.silu@b>none", "nn", (BF16, BF16), {}),
    ("bias+gelu", "nn", (BF16, BF16), {"save_preact": True}),
    (GLU, "nn", (BF16, BF16), {"save_preact": True}),
], ids=["fp32", "min_plus", "misaligned", "nt", "tn", "dact@a", "dact@b",
        "save_preact", "glu save_preact"])
def test_k1_route_keeps_simt_at_m_up_to_8(case, m):
    """fp32, min_plus, misaligned operands and the training flags (a
    transposed layout, dact, save_preact) stay on the SIMT tile at
    m <= 8."""
    tag, layout, dtypes, kw = case
    assert _route(tag, layout, dtypes, m, 2048, 2048, **kw) == "simt"


I8 = torch.int8
# The int8 serving programs of stablelm-1.6b (k, n) and their operand
# types: int8 weights with bf16 activations (dqb, K1d), w8a8 (dqab, K1e).
INT8_DECODE_PROGRAMS = [
    ("dqb", (BF16, I8), 2048, 2048), ("dqab", (I8, I8), 2048, 2048),
    ("dqb", (BF16, I8), 2048, 100352), ("dqab", (I8, I8), 2048, 100352),
    ("dqb+res", (BF16, I8), 5632, 2048), ("dqab+res", (I8, I8), 5632, 2048),
    ("rms>glu.silu(dqb|dqb)", (BF16, I8), 2048, 5632),
    ("glu.silu(dqab|dqab)", (I8, I8), 2048, 5632)]


@pytest.mark.parametrize("m", [1, 3, 8])
@pytest.mark.parametrize("tag,dtypes,k,n", INT8_DECODE_PROGRAMS,
                         ids=[f"{t} {k}x{n}"
                              for t, _, k, n in INT8_DECODE_PROGRAMS])
def test_k1_route_takes_decode_for_int8_at_m_up_to_8(tag, dtypes, k, n, m):
    """Aligned dqb (bf16 A) and dqab serving programs at m <= 8 take the
    decode route (int8 B needs n % 16 == 0, int8 A k % 16 == 0), and the
    same program at m = 9 (prefill) the SIMT tile."""
    assert _route(tag, "nn", dtypes, m, n, k) == "decode"
    assert _route(tag, "nn", dtypes, 9, n, k) == "simt"


@pytest.mark.parametrize("m", [1, 3, 8])
@pytest.mark.parametrize("tag,dtypes,n,k,kw", [
    ("dqb", (BF16, I8), 2056, 2048, {}),
    ("dqab", (I8, I8), 2056, 2048, {}),
    ("dqab", (I8, I8), 2048, 2056, {}),
    ("dqab", (I8, I8), 2048, 2048, {"misaligned": True}),
    ("dqb", (BF16, I8), 2048, 2048, {"misaligned": True}),
    ("dqb", (torch.float32, I8), 2048, 2048, {}),
], ids=["dqb n%16", "dqab n%16", "dqab k%16", "dqab A off 16 bytes",
        "dqb A off 16 bytes", "dqb fp32 A"])
def test_k1_route_keeps_int8_on_simt(tag, dtypes, n, k, kw, m):
    """int8 programs the decode kernel does not take stay on the SIMT
    tile: int8 B with n % 16 != 0, int8 A with k % 16 != 0, an operand's
    base off 16 bytes, and fp32 A with int8 B (the decode kernel stages
    bf16 or int8 A only)."""
    assert _route(tag, "nn", dtypes, m, n, k, **kw) == "simt"


# stablelm-1.6b's training GEMMs at full width, 1024 tokens a step, in the
# kernel's terms (launch key, m, n, k): the forward programs (twice a layer
# with remat), then each one-branch program's nt (dx) and tn (dW), the
# GLU's four backward products and the head's; 627 launches a step.
FULL_WIDTH_TRAIN = [
    ("none", 1024, 2048, 2048), ("none", 1024, 100352, 2048),
    ("res", 1024, 2048, 2048), ("res", 1024, 2048, 5632),
    (GLU + " save_preact", 1024, 5632, 2048),
    ("none nt", 1024, 2048, 2048), ("none nt", 1024, 2048, 5632),
    ("none nt", 1024, 2048, 100352), ("none tn", 2048, 2048, 1024),
    ("none tn", 5632, 2048, 1024), ("none tn", 2048, 100352, 1024),
    ("none tn", 2048, 5632, 1024), ("dact.silu>none nt", 1024, 2048, 5632),
    ("dact.silu@b>none tn", 2048, 5632, 1024)]


@pytest.mark.parametrize("key,m,n,k", FULL_WIDTH_TRAIN,
                         ids=[f"{key} {m}x{n}x{k}"
                              for key, m, n, k in FULL_WIDTH_TRAIN])
def test_k1_route_of_full_width_training_launches(key, m, n, k):
    tag, *rest = key.split(" ")
    layout = next((r for r in rest if r in ("nt", "tn")), "nn")
    assert _route(tag, layout, (BF16, BF16), m, n, k) == "wgmma"
