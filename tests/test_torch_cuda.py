"""The CUDA kernels (CA-GEMM program with its distance product, paged
decode attention, forward flash attention, the k-outer ablation) against
their plain versions, on a card; the trainable programs' backward on the
card against the same on the CPU.

Imports neither JAX nor ``repro``, so it runs on a GPU host without JAX:
``PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
Without a card every case skips with its reason.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ca_mmm as K
from repro_torch.kernels import flash_attn as FA
from repro_torch.kernels import ops
from repro_torch.kernels.epilogue import Epilogue
from repro_torch.kernels.program import (RmsPrologue, program_from_tag,
                                         rms_row_scale)

TAGS = ["none", "res", "rms>glu.silu(none|none)", "bias+gelu+mul+res",
        "glu.gelu(bias|bias)"]


def _program_inputs(tag, m, n, k, dtype, seed):
    r = np.random.RandomState(seed)
    t = lambda *shape, dt=dtype: torch.as_tensor(  # noqa: E731
        r.randn(*shape)).to(device="cuda", dtype=dt)
    spec = program_from_tag(tag)
    a = t(m, k)
    bs = [t(k, n) / np.sqrt(k) for _ in range(spec.n_b)]
    kw = {}
    if spec.prologue.kind == "rms":
        kw["gain"] = t(k, dt=torch.float32).abs() + 0.5
        kw["row_scale"] = rms_row_scale(a, 1e-5)
    ops = []
    for b in spec.branches:
        d = {}
        if b.has_bias:
            d["bias"] = t(n)
        if b.has_mul:
            d["mul"] = t(m, n)
        if b.has_residual:
            d["residual"] = t(m, n)
        ops.append(d)
    return a, bs, dict(spec=spec, branch_operands=ops, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,m,n,k", [(torch.float32, 5, 200, 300),
                                         (torch.bfloat16, 37, 203, 301)])
@pytest.mark.parametrize("tag", TAGS)
def test_cuda_kernel_matches_plain_version(tag, dtype, m, n, k):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    a, bs, kw = _program_inputs(tag, m, n, k, dtype, seed=7)
    K.reset_launch_counts()
    got = K.ca_gemm_program(a, bs, **kw)
    assert K.launch_counts == {tag: 1}
    want = K.ca_gemm_program_reference(a, bs, **kw)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    # fp32: the sums run in another order; bf16: one output ulp may flip.
    scale = want.float().abs().max().item()
    tol = 1e-4 * (1 + scale) if dtype == torch.float32 else 2e-2 * scale
    assert err <= tol, (err, tol)


# Random paged int8 KV pools, numpy only, so both the card's tests here
# and the JAX-side CPU tests (test_torch_flash_attn.py) build their
# inputs from them.  Keys and values are N(0, 1), quantized per page
# under the page's absmax scale as the paged cache stores them.

def random_pool(seed, lens, *, page, n_pages, Hkv, D, Dv=None,
                shuffle=True):
    """A pool holding ``len(lens)`` sequences; sequence ``b`` maps
    ``ceil(lens[b] / page)`` pages (ids drawn in a shuffled order), the
    rest of its block-table row is -1.  Pages no table maps stay zero."""
    Dv = Dv or D
    rng = np.random.RandomState(seed)
    B = len(lens)
    NP = max(1, max(-(-L // page) for L in lens))
    order = rng.permutation(n_pages) if shuffle else np.arange(n_pages)
    pool = {"k": np.zeros((n_pages, page, Hkv, D), np.int8),
            "v": np.zeros((n_pages, page, Hkv, Dv), np.int8),
            "k_scale": np.zeros(n_pages, np.float32),
            "v_scale": np.zeros(n_pages, np.float32),
            "tables": np.full((B, NP), -1, np.int32),
            "lens": np.asarray(lens, np.int32)}
    nxt = 0
    for b, L in enumerate(lens):
        for j in range(-(-L // page)):
            pid = order[nxt]
            nxt += 1
            pool["tables"][b, j] = pid
            for name, d in (("k", D), ("v", Dv)):
                x = rng.randn(page, Hkv, d).astype(np.float32)
                sc = np.float32(max(np.abs(x).max(), 1e-12) / 127.0)
                pool[name][pid] = np.clip(np.round(x / sc), -127, 127)
                pool[name + "_scale"][pid] = sc
    return pool


def poisoned(pool):
    """A copy whose unmapped pages (no table row names them) hold 127 at
    scale 1e6: a freed page's stale bytes, which must never score."""
    out = {k: v.copy() for k, v in pool.items()}
    mapped = set(pool["tables"].ravel().tolist()) - {-1}
    unmapped = [p for p in range(pool["k"].shape[0]) if p not in mapped]
    for name in ("k", "v"):
        out[name][unmapped] = 127
        out[name + "_scale"][unmapped] = 1e6
    return out


def query(seed, B, H, D):
    return np.random.RandomState(seed + 1000).randn(B, H, D).astype(
        np.float32)


# (lens, page, n_pages, H, Hkv, D, window) of the paged attention cases:
# stablelm-1.6b's heads at the serve path's length, danube's GQA heads
# (D = 120) over ragged lengths crossing page boundaries, with a window,
# and danube's serve shape (its analytic page 128 at max_len 320).
PAGED_CASES = {"stablelm": ([1016], 128, 8, 32, 32, 64, None),
               "danube": ([19, 200, 1000], 16, 96, 32, 8, 120, 48),
               "danube serve": ([316], 128, 4, 32, 8, 120, None),
               "granite G48": ([700, 33], 16, 64, 48, 1, 128, None),
               # Head dims above 128, scored once for all of Dv:
               # deepseek-v2-lite's MLA head (D = 192, Dv = 128) and 256.
               "mla D192": ([300, 41], 16, 32, 16, 8, 192, None),
               "D256 window": ([130, 77], 16, 24, 8, 4, 256, 50),
               # The split path: stablelm-1.6b's heads at B = 1 over 4096
               # tokens (8 splits); ragged lengths whose 5 and 0 tokens
               # leave splits empty; a window of 3 that empties most of
               # them; len = 0 beside a live sequence.
               "stablelm S4096": ([4096], 128, 34, 32, 32, 64, None),
               "ragged splits": ([5, 1016, 0], 16, 72, 8, 2, 64, None),
               "window splits": ([1016, 300], 16, 90, 8, 2, 64, 3),
               "len0": ([0, 37], 16, 8, 4, 2, 32, None),
               # Head dims past one CTA at the whole group and all of Dv:
               # deepseek-v2's absorbed MLA head (16 heads over one latent
               # KV head, D = 576, Dv = 512: two column chunks), 64 such
               # heads (two head chunks), and 264-byte rows staged in
               # 16-byte windows in two column chunks, with a window.
               "absorbed mla": ([300, 41], 16, 24, 16, 1, 576, None),
               "G64 D576": ([77, 200], 16, 24, 64, 1, 576, None),
               "D264 shifted": ([130, 45], 16, 16, 4, 2, 264, 30)}
# Dv where it differs from D.
PAGED_DV = {"mla D192": 128, "absorbed mla": 512, "G64 D576": 512}
POOL_KEYS = ("k", "v", "k_scale", "v_scale", "tables", "lens")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", ["stablelm", "danube", "danube serve",
                                  "granite G48", "poisoned", "mla D192",
                                  "D256 window", "stablelm S4096",
                                  "ragged splits", "window splits", "len0",
                                  "repeat", "absorbed mla", "G64 D576",
                                  "D264 shifted"])
def test_paged_attention_kernel_matches_plain_version(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    lens, page, n_pages, H, Hkv, D, window = PAGED_CASES[
        {"poisoned": "danube", "repeat": "ragged splits"}.get(case, case)]
    Dv = PAGED_DV.get(case, D)
    pool = random_pool(11, lens, page=page, n_pages=n_pages, Hkv=Hkv, D=D,
                       Dv=Dv)
    dev = lambda p: [torch.as_tensor(p[k]).cuda() for k in POOL_KEYS]  # noqa: E731
    q = torch.as_tensor(query(11, len(lens), H, D)).to("cuda", dtype)
    FA.reset_launch_counts()
    got = FA.paged_flash_attention(q, *dev(pool), window=window)
    assert FA.launch_counts == {FA.NAME: 1}
    if case in ("poisoned", "repeat"):
        # Free pages never reach the output; two identical calls give the
        # same bits (the splits merge in order, no atomics).
        again = FA.paged_flash_attention(
            q, *dev(poisoned(pool) if case == "poisoned" else pool),
            window=window)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        return
    want = FA.paged_flash_attention_reference(q, *dev(pool), window=window)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (len(lens), H, Dv)
    err = (got.float() - want.float()).abs().max().item()
    # fp32: sums in another order; bf16: the output may flip one ulp.
    scale = want.float().abs().max().item()
    tol = 1e-4 * (1 + scale) if dtype == torch.float32 else 2e-2 * scale
    assert err <= tol, (err, tol)
    for b, L in enumerate(lens):
        if L == 0:
            assert not got[b].any()


# Quantized programs (K1d: dqb, int8 weights; K1e: dqab, w8a8), numpy
# operands: int8 payloads, positive fp32 scales per channel / per row or
# per tile of g rows of k.
QUANT_TAGS = ["dqb", "dqb+res", "rms>glu.silu(dqb|dqb)",
              "dqb+bias+gelu+mul+res", "dqab", "dqab+res",
              "glu.silu(dqab|dqab)"]


def quant_program_inputs(tag, m, n, k, dtype, seed, *, block_b=0,
                         block_a=0, device="cuda"):
    """(a, bs, kwargs) of one dqb/dqab program call: float A of ``dtype``
    for dqb, int8 A for dqab; ``block_b``/``block_a`` select per-tile
    weight / activation scales."""
    r = np.random.RandomState(seed)
    spec = program_from_tag(tag)
    deq = spec.branches[0].dequant
    t = lambda x, dt: torch.as_tensor(x).to(device=device, dtype=dt)  # noqa: E731
    i8 = lambda *shape: t(r.randint(-127, 128, shape), torch.int8)  # noqa: E731
    a = i8(m, k) if deq == "ab" else t(r.randn(m, k), dtype)
    bs = [i8(k, n) for _ in range(spec.n_b)]
    kw = {"spec": spec, "scale_b_block": block_b,
          "scale_a_block": block_a if deq == "ab" else 0}
    if spec.prologue.kind == "rms":
        kw["gain"] = t(r.rand(k) + 0.5, torch.float32)
        kw["row_scale"] = rms_row_scale(a, 1e-5)
    ops = []
    for b in spec.branches:
        d = {"scale_b": t((r.rand(-(-k // block_b), n) if block_b
                           else r.rand(n)) * 0.02 / np.sqrt(k) + 1e-3,
                          torch.float32)}
        if deq == "ab":
            d["scale_a"] = t((r.rand(-(-k // block_a)) if block_a
                              else r.rand(m)) * 0.05 + 0.01, torch.float32)
        if b.has_bias:
            d["bias"] = t(r.randn(n), dtype)
        if b.has_mul:
            d["mul"] = t(r.randn(m, n), dtype)
        if b.has_residual:
            d["residual"] = t(r.randn(m, n), dtype)
        ops.append(d)
    if deq == "ab":      # both branches share the activation's scales
        for d in ops[1:]:
            d["scale_a"] = ops[0]["scale_a"]
    kw["branch_operands"] = ops
    kw["out_dtype"] = dtype
    return a, bs, kw


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [(0, 0), (128, 0), (256, 256), (0, 128)],
                         ids=["channel", "tile128", "tile256", "a-tile128"])
@pytest.mark.parametrize("dtype,m,n,k", [(torch.float32, 5, 200, 300),
                                         (torch.bfloat16, 37, 203, 301),
                                         (torch.bfloat16, 1, 256, 640),
                                         (torch.float32, 40, 264, 520)])
@pytest.mark.parametrize("tag", QUANT_TAGS)
def test_cuda_quant_kernel_matches_plain_version(tag, dtype, m, n, k, blocks):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    block_b, block_a = blocks
    if block_a and not block_b and "dqab" not in tag:
        pytest.skip("per-tile activation scales belong to dqab programs")
    torch.backends.cuda.matmul.allow_tf32 = False
    a, bs, kw = quant_program_inputs(tag, m, n, k, dtype, seed=8,
                                     block_b=block_b, block_a=block_a)
    K.reset_launch_counts()
    got = K.ca_gemm_program(a, bs, **kw)
    assert K.launch_counts == {tag: 1}
    want = K.ca_gemm_program_reference(a, bs, **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (m, n)
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    tol = 1e-4 * (1 + scale) if dtype == torch.float32 else 2e-2 * scale
    assert err <= tol, (err, tol)


@pytest.mark.cuda
def test_cuda_w8a8_int32_headroom_k4096():
    """Every product at the grid's extreme (127 · ±127) over k = 4096:
    the int32 sum must be exact, so the output equals
    s_a · s_b · sum(a_q · b_q) up to the fp32 rescale."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    m, n, k = 4, 128, 4096
    a = torch.full((m, k), 127, dtype=torch.int8, device="cuda")
    sign = torch.where(torch.arange(k) % 2 == 1, 1, -1)
    b = (sign[:, None] * 127 * torch.ones(k, n, dtype=torch.long)).to(
        device="cuda", dtype=torch.int8)
    b[: k // 4] = 127                      # a sum far from 0: 127² · k/4
    sa = torch.full((m,), 4.0 / 127, device="cuda")
    sb = torch.rand(n, device="cuda") + 0.5
    K.reset_launch_counts()
    got = K.ca_gemm_program(a, [b], spec=program_from_tag("dqab"),
                            branch_operands=[{"scale_a": sa,
                                              "scale_b": sb}])
    assert K.route_counts == {"decode dqab": 1}
    exact = (a.double() @ b.double())
    want = (exact.float() * sb[None, :]) * sa[:, None]
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# The decode route for int8 (dqb with bf16 A, dqab) at m <= 8: shapes
# ragged against the 64-column strip (n a multiple of 16, not of 64), the
# cluster's k chunk and the 128 / 256 scale blocks (k = 1000: four CTAs of
# 256, 256, 256, 232 rows; dqab's int8 A needs k % 16 == 0, so it takes
# k = 1008: 256, 256, 256, 240), and one wide enough for no split whose k
# goes through A's shared memory in two pieces at m > 1; per-channel /
# per-row scales and per-tile ones.
INT8_DECODE_SHAPES = {"ragged": (208, 1000), "wide": (16912, 2600)}
INT8_DECODE_BLOCKS = [(tag, blocks) for tag in QUANT_TAGS
                      for blocks in ((0, 0), (128, 0), (256, 256), (0, 128))
                      if "dqab" in tag or not blocks[1]]


@pytest.mark.cuda
@pytest.mark.parametrize("od", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("m", [1, 3, 8])
@pytest.mark.parametrize("shape", list(INT8_DECODE_SHAPES))
@pytest.mark.parametrize("tag,blocks", INT8_DECODE_BLOCKS,
                         ids=[f"{t}-{b[0]}-{b[1]}"
                              for t, b in INT8_DECODE_BLOCKS])
def test_cuda_int8_decode_route_matches_plain_version(tag, blocks, shape, m,
                                                      od):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    n, k = INT8_DECODE_SHAPES[shape]
    if "dqab" in tag:
        k = -(-k // 16) * 16
    a, bs, kw = quant_program_inputs(tag, m, n, k, torch.bfloat16, seed=21,
                                     block_b=blocks[0], block_a=blocks[1])
    kw["out_dtype"] = od
    K.reset_launch_counts()
    got = K.ca_gemm_program(a, bs, **kw)
    assert K.route_counts == {f"decode {tag}": 1}
    again = K.ca_gemm_program(a, bs, **kw)
    want = K.ca_gemm_program_reference(a, bs, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)       # no atomics: the same bits each run
    assert got.shape == (m, n) and got.dtype == od
    if "dqab" in tag and blocks == (0, 0):
        # The int32 sum is exact and rounds once, then the plain version's
        # scales and chain in its order: the same bits.
        assert torch.equal(got, want)
        return
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    # fp32: the sums (and per-tile folds) run in another order; bf16: one
    # output ulp may flip.
    tol = 1e-4 * (1 + scale) if od == torch.float32 else 2e-2 * scale
    assert err <= tol, (err, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 128])
@pytest.mark.parametrize("operand", ["a", "b"])
@pytest.mark.parametrize("tag", ["dqb+res", "dqab"])
def test_cuda_misaligned_int8_decode_takes_the_simt_tile(tag, operand, m):
    """An int8 program at decode (m = 1) or prefill (m = 128) whose A or
    B base is off 16 bytes: the SIMT tile, and the same result (dqab bit
    for bit)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    n, k = 208, 1008
    a, bs, kw = quant_program_inputs(tag, m, n, k, torch.bfloat16, seed=23)
    kw["out_dtype"] = torch.float32

    def off(t):
        o = torch.empty(t.numel() + 1, dtype=t.dtype, device="cuda")[1:]
        return o.view(t.shape).copy_(t)
    args = (off(a), bs) if operand == "a" else (a, [off(b) for b in bs])
    K.reset_launch_counts()
    got = K.ca_gemm_program(*args, **kw)
    assert K.route_counts == {f"simt {tag}": 1}
    want = K.ca_gemm_program_reference(a, bs, **kw)
    torch.cuda.synchronize()
    if "dqab" in tag:
        assert torch.equal(got, want)
        return
    err = (got - want).abs().max().item()
    assert err <= 1e-4 * (1 + want.abs().max().item()), err


# The int8 wgmma route (dqb with bf16 A, dqab) at m > 8: n a multiple of 16
# and not of the tile's 128 (the GLU's 64), k a multiple of 16 and not of a
# stage's 64 (dqb) or 128 (dqab) rows, with a ragged last scale block
# (1008 = 7 x 128 + 112 = 3 x 256 + 240; 2320 = 18 x 128 + 16 = 9 x 256 +
# 16); per-channel / per-row scales and per-tile ones.
INT8_WGMMA_SHAPES = {"ragged": (208, 1008), "wide": (2064, 2320)}


@pytest.mark.cuda
@pytest.mark.parametrize("od", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("m", [9, 128, 200])
@pytest.mark.parametrize("shape", list(INT8_WGMMA_SHAPES))
@pytest.mark.parametrize("tag,blocks", INT8_DECODE_BLOCKS,
                         ids=[f"{t}-{b[0]}-{b[1]}"
                              for t, b in INT8_DECODE_BLOCKS])
def test_cuda_int8_wgmma_route_matches_plain_version(tag, blocks, shape, m,
                                                     od):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    n, k = INT8_WGMMA_SHAPES[shape]
    a, bs, kw = quant_program_inputs(tag, m, n, k, torch.bfloat16, seed=25,
                                     block_b=blocks[0], block_a=blocks[1])
    kw["out_dtype"] = od
    K.reset_launch_counts()
    got = K.ca_gemm_program(a, bs, **kw)
    assert K.route_counts == {f"wgmma {tag}": 1}
    again = K.ca_gemm_program(a, bs, **kw)
    want = K.ca_gemm_program_reference(a, bs, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)       # no atomics: the same bits each run
    assert got.shape == (m, n) and got.dtype == od
    if "dqab" in tag and blocks == (0, 0):
        # The s32 sum is exact and converts once, then the plain version's
        # scales and chain in its order: the same bits.
        assert torch.equal(got, want)
        return
    # The int8 tolerance of the CPU parity tests (fp32 sums in another
    # order, per-tile folds included); a bf16 output may also round to the
    # neighbouring bf16 value, one ulp: at most 2^-7 of |want|.
    g, w = got.float(), want.float()
    bound = 2e-3 * w.abs().max() + (2e-4 if od == torch.float32
                                     else 2.0 ** -7) * w.abs()
    assert bool(((g - w).abs() <= bound).all()), \
        ((g - w).abs() - bound).max().item()


# K1f, the backward programs of training: (tag, layout, save_preact).
K1F_CASES = [("none", "nt", False), ("none", "tn", False),
             ("none", "tt", False), ("bias+gelu", "nt", False),
             ("dact.silu>none", "nt", False), ("dact.gelu>none", "nt", False),
             ("dact.relu>none", "nt", False),
             ("dact.silu@b>none", "tn", False),
             ("dact.gelu@b>none", "tn", False),
             ("dact.relu@b>none", "tn", False),
             ("bias+gelu", "nn", True), ("res", "nn", True),
             ("rms>glu.silu(none|none)", "nn", True)]


def k1f_inputs(tag, layout, m, n, k, dtype, seed, save_preact=False):
    """Operands of one K1f call on the card: A and B in their stored
    layouts (A (k, m) for ``t?``, B (n, k) for ``?t``), the fp32
    pre-activation shaped like the dact prologue's operand."""
    a, bs, kw = _program_inputs(tag, m, n, k, dtype, seed)
    ta, tb = layout[0] == "t", layout[1] == "t"
    if ta:
        a = a.t().contiguous()
    if tb:
        bs = [b.t().contiguous() for b in bs]
    pro = kw["spec"].prologue
    if pro.kind == "dact":
        r = np.random.RandomState(seed + 1)
        shape = (m, k) if pro.operand == "a" else (k, n)
        kw["preact"] = torch.as_tensor(r.randn(*shape)).to(
            device="cuda", dtype=torch.float32)
    kw.update(transpose_a=ta, transpose_b=tb, save_preact=save_preact)
    return a, bs, kw


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,m,n,k", [(torch.float32, 37, 64, 50),
                                         (torch.bfloat16, 130, 203, 301),
                                         (torch.float32, 5, 200, 300)])
@pytest.mark.parametrize("tag,layout,save", K1F_CASES)
def test_cuda_k1f_program_matches_plain_version(tag, layout, save, dtype,
                                                m, n, k):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    a, bs, kw = k1f_inputs(tag, layout, m, n, k, dtype, seed=9,
                           save_preact=save)
    K.reset_launch_counts()
    got = K.ca_gemm_program(a, bs, **kw)
    assert K.launch_counts == {K.launch_key(tag, layout, save): 1}
    want = K.ca_gemm_program_reference(a, bs, **kw)
    torch.cuda.synchronize()
    got = got if save else (got,)
    want = want if save else (want,)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == (m, n) and g.dtype == w.dtype
        err = (g.float() - w.float()).abs().max().item()
        scale = w.float().abs().max().item()
        # The preacts (i > 0) are fp32 whatever the operands' dtype.
        f32 = dtype == torch.float32 or i > 0
        tol = 1e-4 * (1 + scale) if f32 else 2e-2 * scale
        assert err <= tol, (i, err, tol)


# The wgmma route (bf16 at m > 8, TMA-aligned operands): every forward
# program, layout, prologue, GLU and save_preact case, at an aligned shape,
# one ragged in every dim (m, n, k multiples of 8, not of the tile) and
# m = 37 (the t? layouts' A rows are then 74 bytes: the SIMT route).
WGMMA_CASES = [(tag, "nn", False) for tag in TAGS] + K1F_CASES
WGMMA_SHAPES = {"aligned": (256, 256, 320), "ragged": (200, 264, 328),
                "m37": (37, 136, 200)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(WGMMA_SHAPES))
@pytest.mark.parametrize("tag,layout,save", WGMMA_CASES)
def test_cuda_wgmma_route_matches_plain_version(tag, layout, save, shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    m, n, k = WGMMA_SHAPES[shape]
    a, bs, kw = k1f_inputs(tag, layout, m, n, k, torch.bfloat16, seed=13,
                           save_preact=save)
    K.reset_launch_counts()
    got = K.ca_gemm_program(a, bs, **kw)
    route = "simt" if layout[0] == "t" and m % 8 else "wgmma"
    key = K.launch_key(tag, layout, save)
    assert K.launch_counts == {key: 1}
    assert K.route_counts == {f"{route} {key}": 1}
    want = K.ca_gemm_program_reference(a, bs, **kw)
    torch.cuda.synchronize()
    got = got if save else (got,)
    want = want if save else (want,)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == (m, n) and g.dtype == w.dtype
        assert bool(torch.isfinite(g).all())
        err = (g.float() - w.float()).abs().max().item()
        scale = w.float().abs().max().item()
        # A bf16 output may flip one ulp; the fp32 preacts differ in the
        # order of their sums only.
        tol = 1e-4 * (1 + scale) if g.dtype == torch.float32 \
            else 2e-2 * scale
        assert err <= tol, (i, err, tol)


# The decode route (bf16 serving programs at m <= 8): (tag, out dtype),
# the head's none with a bias and fp32 out among them; shapes ragged
# against the 64-column strip (n a multiple of 8, not of 64) and against
# the cluster's k chunk (k = 1000: four CTAs of 256, 256, 256, 232 rows),
# and one wide enough for no split whose k goes through A's shared memory
# in two pieces at m > 1.
DECODE_CASES = [("none", None), ("bias", torch.float32), ("res", None),
                ("rms>glu.silu(none|none)", None),
                ("bias+gelu+mul+res", None), ("glu.gelu(bias|bias)", None)]
DECODE_SHAPES = {"ragged": (200, 1000), "wide": (16904, 2600)}


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 3, 8])
@pytest.mark.parametrize("shape", list(DECODE_SHAPES))
@pytest.mark.parametrize("tag,od", DECODE_CASES,
                         ids=[f"{t}-{str(od)[6:] or 'bf16'}"
                              for t, od in DECODE_CASES])
def test_cuda_decode_route_matches_plain_version(tag, od, shape, m):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    n, k = DECODE_SHAPES[shape]
    a, bs, kw = _program_inputs(tag, m, n, k, torch.bfloat16, seed=17)
    K.reset_launch_counts()
    got = K.ca_gemm_program(a, bs, out_dtype=od, **kw)
    assert K.route_counts == {f"decode {tag}": 1}
    again = K.ca_gemm_program(a, bs, out_dtype=od, **kw)
    want = K.ca_gemm_program_reference(a, bs, out_dtype=od, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)       # no atomics: the same bits each run
    assert got.shape == (m, n) and got.dtype == want.dtype
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    # fp32: the sums run in another order; bf16: one output ulp may flip.
    tol = 1e-4 * (1 + scale) if got.dtype == torch.float32 \
        else 2e-2 * scale
    assert err <= tol, (err, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8])
def test_cuda_misaligned_decode_takes_the_simt_tile(m):
    """A bf16 A whose base is off 16 bytes: the SIMT tile, same result."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    n, k = 200, 1000
    a, bs, kw = _program_inputs("res", m, n, k, torch.bfloat16, seed=19)
    off = torch.empty(m * k + 1, dtype=a.dtype, device="cuda")[1:].view(m, k)
    off.copy_(a)
    K.reset_launch_counts()
    got = K.ca_gemm_program(off, bs, **kw)
    assert K.route_counts == {"simt res": 1}
    want = K.ca_gemm_program_reference(a, bs, **kw)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2e-2 * want.float().abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["fused", "glu"])
def test_cuda_backward_matches_cpu(which):
    """The trainable programs' gradients on the card (K1f launches only,
    never a plain version) against the same on the CPU, fp32, with the
    rms prologue: 1e-4 · (1 + max|cpu|), the sums run in another order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    m, n, k = 37, 96, 80
    r = np.random.RandomState(5)
    data = {"x": r.randn(m, k), "w": r.randn(k, n) / 9, "w2": r.randn(k, n) / 9,
            "gain": r.rand(k) + 0.5, "bias": r.randn(n), "mul": r.randn(m, n),
            "res": r.randn(m, n)}
    out = {}
    for dev in ("cuda", "cpu"):
        t = {name: torch.as_tensor(v).to(device=dev, dtype=torch.float32)
             .requires_grad_() for name, v in data.items()}
        K.reset_launch_counts()
        pro = RmsPrologue(t["gain"])
        if which == "fused":
            y = ops.fused_matmul(t["x"], t["w"], Epilogue(
                bias=t["bias"], activation="gelu", mul=t["mul"],
                residual=t["res"]), prologue=pro)
        else:
            y = ops.glu_matmul(t["x"], t["w"], t["w2"], prologue=pro)
        (y.float() ** 2).sum().backward()
        out[dev] = {name: v.grad for name, v in t.items()
                    if v.grad is not None}
        out[dev]["y"] = y.detach()
        counts = dict(K.launch_counts)
    torch.cuda.synchronize()
    assert counts == {}                                  # the CPU's run
    assert sorted(out["cuda"]) == sorted(out["cpu"])
    for name, g in out["cpu"].items():
        err = (out["cuda"][name].cpu() - g).abs().max().item()
        assert err <= 1e-4 * (1 + g.abs().max().item()), (name, err)


@pytest.mark.cuda
def test_cuda_backward_launches_k1f_programs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    x = torch.randn(64, 32, device="cuda", requires_grad=True)
    wg, wu = (torch.randn(32, 48, device="cuda", requires_grad=True)
              for _ in range(2))
    K.reset_launch_counts()
    ops.glu_matmul(x, wg, wu).sum().backward()
    glu = "glu.silu(none|none)"
    assert K.launch_counts == {f"{glu} save_preact": 1,
                               "dact.silu>none nt": 1, "none nt": 1,
                               "dact.silu@b>none tn": 1, "none tn": 1}


# ---------------------------------------------------------------------------
# K1g: the distance product
# ---------------------------------------------------------------------------

def _bit_equal(got, want):
    """Equal bits, NaN where the other is NaN."""
    return bool(((got == want) | (got.isnan() & want.isnan())).all())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged", "bf16", "mixed", "inf_nan"])
def test_cuda_distance_product_bit_equal(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    r = np.random.RandomState(21)
    m, k, n = (100, 333, 77) if case == "ragged" else (70, 90, 130)
    a = torch.as_tensor(r.rand(m, k) * 2 - 0.5).float().cuda()
    b = torch.as_tensor(r.rand(k, n) * 2 - 0.5).float().cuda()
    if case in ("bf16", "mixed"):
        a = a.bfloat16()
        b = b.bfloat16() if case == "bf16" else b
    if case == "inf_nan":
        a[torch.as_tensor(r.rand(m, k) < 0.3).cuda()] = float("inf")
        b[torch.as_tensor(r.rand(k, n) < 0.3).cuda()] = float("inf")
        a[5] = float("inf")
        a[6, 40] = float("nan")
    K.reset_launch_counts()
    got = ops.distance_product(a, b)
    assert K.launch_counts == {"none min_plus": 1}
    want = K.ca_gemm_program_reference(a, [b], semiring="min_plus")
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (m, n)
    assert _bit_equal(got, want)
    if case == "inf_nan":
        assert bool(got[6].isnan().all()) and bool(got[5].isinf().all())


# ---------------------------------------------------------------------------
# K3: forward flash attention
# ---------------------------------------------------------------------------

FWD_CASES = {  # B, Lq, S, H, Hkv, D, window, causal, holes
    "mha causal": (2, 130, 130, 4, 4, 64, None, True, False),
    "gqa4 window": (1, 100, 300, 8, 2, 120, 37, True, False),
    "holes ragged": (3, 45, 77, 6, 2, 40, None, True, True),
    "non-causal window": (1, 64, 200, 4, 1, 32, 50, False, True),
    # Query heads per KV head past a CTA's rows: head chunks.
    "granite G48": (1, 70, 200, 48, 1, 128, None, True, False),
    "G96 window": (2, 9, 150, 96, 1, 64, 40, True, True),
    # danube's D = 120 (two 64-wide boxes, 8 zero dims), ragged Lq and S.
    "danube D120 ragged": (2, 77, 333, 32, 8, 120, 100, True, True),
    # Head dims above 128 (the SIMT kernel in 128-wide chunks, bf16 too):
    # deepseek-v2-lite's MLA head (D = 192, Dv = 128) and D = Dv = 256.
    "mla D192": (2, 77, 150, 8, 4, 192, None, True, True),
    "D256 window": (1, 100, 300, 8, 4, 256, 37, True, False),
}
# Dv where it differs from D.
FWD_DV = {"mla D192": 128}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", list(FWD_CASES))
def test_cuda_flash_attention_matches_plain_version(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    B, Lq, S, H, Hkv, D, window, causal, holes = FWD_CASES[case]
    Dv = FWD_DV.get(case, D)
    r = np.random.RandomState(31)
    t = lambda *shape: torch.as_tensor(  # noqa: E731
        r.randn(*shape)).to(device="cuda", dtype=dtype)
    q, k, v = t(B, Lq, H, D), t(B, S, Hkv, D), t(B, S, Hkv, Dv)
    kpos = torch.arange(S, dtype=torch.int32).repeat(B, 1)
    qpos = (torch.arange(Lq, dtype=torch.int32) + (S - Lq)).repeat(B, 1)
    if holes:
        kpos[torch.as_tensor(r.rand(B, S) < 0.2)] = -1
        qpos[-1, 0] = -3           # sees no slot: drains 0
    kw = dict(q_positions=qpos.cuda(), kv_positions=kpos.cuda(),
              causal=causal, window=window)
    FA.reset_launch_counts()
    got = FA.flash_attention(q, k, v, **kw)
    assert FA.launch_counts == {FA.FWD_NAME: 1}
    route = "wgmma" if dtype == torch.bfloat16 and max(D, Dv) <= 128 \
        else "simt"
    assert FA.route_counts == {f"{route} {FA.FWD_NAME}": 1}
    want = FA.flash_attention_reference(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    # Each output to its own row's scale (the first causal rows are 10-100x
    # the later ones): fp32 sums in another order, a bf16 output ulp may
    # flip.  Both round p to bf16 at the same running max, so a bf16 flip
    # is rare: the mean error stays under 2^-12 of the mean |want|.
    err = (got.float() - want.float()).abs()
    aw = want.float().abs()
    rtol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    bound = rtol * (aw + aw.amax(dim=-1, keepdim=True))
    assert bool((err <= bound).all()), (err - bound).max().item()
    if dtype == torch.bfloat16:
        mean = err.sum().item() / aw.sum().item()
        assert mean <= 2.0 ** -12, mean
    if holes and causal:
        assert not bool(got[-1, 0].any())


@pytest.mark.cuda
def test_cuda_flash_attention_misaligned_bf16_takes_simt():
    """bf16 q whose base is off 16 bytes: the SIMT route, the same bound."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    B, Lq, S, H, Hkv, D = 1, 40, 90, 8, 2, 64
    r = np.random.RandomState(33)
    t = lambda *shape: torch.as_tensor(  # noqa: E731
        r.randn(*shape)).to(device="cuda", dtype=torch.bfloat16)
    q, k, v = t(B, Lq, H, D), t(B, S, Hkv, D), t(B, S, Hkv, D)
    off = torch.empty(q.numel() + 1, dtype=q.dtype, device="cuda")[1:]
    off = off.view(q.shape)
    off.copy_(q)
    kw = dict(q_positions=(torch.arange(Lq, dtype=torch.int32)
                           + (S - Lq)).repeat(B, 1).cuda(),
              kv_positions=torch.arange(S, dtype=torch.int32)
              .repeat(B, 1).cuda())
    FA.reset_launch_counts()
    got = FA.flash_attention(off, k, v, **kw)
    assert FA.route_counts == {f"simt {FA.FWD_NAME}": 1}
    want = FA.flash_attention_reference(q, k, v, **kw)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    aw = want.float().abs()
    assert bool((err <= 2.0 ** -7 * (aw + aw.amax(dim=-1, keepdim=True)))
                .all())


# ---------------------------------------------------------------------------
# K4: the k-outer ablation
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("tiles", [(64, 64, 32), (128, 192, 96)],
                         ids=["default", "wide"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8],
                         ids=str)
def test_cuda_k_outer_matches_plain_version(dtype, tiles):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    m, n, k = 384, 576, 288
    r = np.random.RandomState(41)
    if dtype == torch.int8:
        a = torch.as_tensor(r.randint(-127, 128, (m, k))).to(dtype).cuda()
        b = torch.as_tensor(r.randint(-127, 128, (k, n))).to(dtype).cuda()
    else:
        a = torch.as_tensor(r.randn(m, k)).to(dtype).cuda()
        b = torch.as_tensor(r.randn(k, n)).to(dtype).cuda()
    # The fp32 C before the cast: both sum in fp32, in another order.
    kw = dict(bm=tiles[0], bn=tiles[1], bk=tiles[2],
              out_dtype=None if dtype == torch.int8 else torch.float32)
    K.reset_launch_counts()
    got = K.ca_mmm_k_outer(a, b, **kw)
    assert K.launch_counts == {K.K_OUTER: k // tiles[2]}
    want = K.ca_mmm_k_outer_reference(a, b, **kw)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype
    if dtype == torch.int8:
        assert torch.equal(got, want)
    else:
        err = (got - want).abs().max().item()
        tol = 1e-4 * want.abs().max().item()
        assert err <= tol, (err, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("tiles", [(None, None, None), (384, 256, 320)],
                         ids=["default", "whole blocks"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8],
                         ids=str)
def test_cuda_k_outer_wgmma_step_matches_plain_version(dtype, tiles):
    """bf16 at whole 128 x 128 x 64 blocks (its default tile, and three
    blocks by two by five) takes the wgmma step; fp32 and int8 the SIMT
    step at the same tiles."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    m, n, k = 384, 512, 320
    r = np.random.RandomState(43)
    if dtype == torch.int8:
        a = torch.as_tensor(r.randint(-127, 128, (m, k))).to(dtype).cuda()
        b = torch.as_tensor(r.randint(-127, 128, (k, n))).to(dtype).cuda()
    else:
        a = torch.as_tensor(r.randn(m, k)).to(dtype).cuda()
        b = torch.as_tensor(r.randn(k, n)).to(dtype).cuda()
    kw = dict(bm=tiles[0], bn=tiles[1], bk=tiles[2],
              out_dtype=None if dtype == torch.int8 else torch.float32)
    bk = tiles[2] or K.K_OUTER_TILES[dtype][2]
    route = "wgmma" if dtype == torch.bfloat16 else "simt"
    K.reset_launch_counts()
    got = K.ca_mmm_k_outer(a, b, **kw)
    assert K.route_counts == {f"{route} {K.K_OUTER}": k // bk}
    want = K.ca_mmm_k_outer_reference(a, b, **kw)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype
    if dtype == torch.int8:
        assert torch.equal(got, want)
    else:
        err = (got - want).abs().max().item()
        tol = 1e-4 * want.abs().max().item()
        assert err <= tol, (err, tol)
