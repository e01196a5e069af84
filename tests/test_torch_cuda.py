"""The CUDA kernels (CA-GEMM program, the distance product, paged decode
attention, forward flash attention, the k-outer ablation) against their
plain versions, on a card; the trainable programs' backward on the card
against the same on the CPU; the guard rails on the card (the launcher's
shared memory against the analyzer's, the preflight, the fault hook).

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
               # K rows past one token group's shared memory (D above
               # ~3,300): staged in 1024-byte chunks, the wide form; 4104
               # ends in an 8-byte chunk (8-byte copies), with a window.
               "D4096 wide": ([300, 41], 16, 24, 8, 2, 4096, None),
               "D4104 wide window": ([77, 130], 16, 16, 4, 2, 4104, 50),
               "D264 shifted": ([130, 45], 16, 16, 4, 2, 264, 30)}
# Dv where it differs from D.
PAGED_DV = {"mla D192": 128, "absorbed mla": 512, "G64 D576": 512,
            "D4096 wide": 256, "D4104 wide window": 264}
POOL_KEYS = ("k", "v", "k_scale", "v_scale", "tables", "lens")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", ["stablelm", "danube", "danube serve",
                                  "granite G48", "poisoned", "mla D192",
                                  "D256 window", "stablelm S4096",
                                  "ragged splits", "window splits", "len0",
                                  "repeat", "absorbed mla", "G64 D576",
                                  "D264 shifted", "D4096 wide",
                                  "D4104 wide window"])
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
    assert FA.route_counts == ({FA.WIDE: 1} if "wide" in case else {})
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
    assert K.route_counts == {"minplus none min_plus": 1}
    want = K.ca_gemm_program_reference(a, [b], semiring="min_plus")
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (m, n)
    assert _bit_equal(got, want)
    if case == "inf_nan":
        assert bool(got[6].isnan().all()) and bool(got[5].isinf().all())


# Dims that straddle the distance product's 128 x 128 x 16 tile and its
# 8-row staging pieces.
STRADDLE = (1, 127, 128, 129, 4095)


@pytest.mark.cuda
@pytest.mark.parametrize("k", STRADDLE)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_cuda_distance_product_straddles_the_tile(dtype, k):
    """Every (m, n) of the straddling dims at this k, bit-equal, and an A
    whose base sits 4 bytes off (the scalar loads)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(k)
    K.reset_launch_counts()
    for m in STRADDLE:
        a = torch.rand(m, k, generator=gen, device="cuda").to(dtype)
        for n in STRADDLE:
            b = torch.rand(k, n, generator=gen, device="cuda").to(dtype)
            got = ops.distance_product(a, b)
            want = K.ca_gemm_program_reference(a, [b], semiring="min_plus")
            assert torch.equal(got, want), (m, n, k)
    assert K.route_counts == {"minplus none min_plus": len(STRADDLE) ** 2}
    a = torch.rand(129 * k + 1, generator=gen, device="cuda")[1:]
    a = a.view(129, k).to(dtype)
    b = torch.rand(k, 131, generator=gen, device="cuda").to(dtype)
    assert torch.equal(ops.distance_product(a, b),
                       K.ca_gemm_program_reference(a, [b],
                                                   semiring="min_plus"))


# F1 and F2: two-output dual programs, and the dequant programs with
# save_preact or a dact prologue (tag, A's dtype, m, save_preact, the
# operand dact decorates, per-tile blocks (b, a)); n = 200, k = 320.
SIMT_FAULT_CASES = [
    ("dual(none|none)", torch.float32, 13, False, None, (0, 0)),
    ("dual(none|bias)", torch.float32, 130, True, None, (0, 0)),
    ("dual(none|none)", torch.bfloat16, 130, False, None, (0, 0)),
    ("dual(none|bias)", torch.bfloat16, 5, True, None, (0, 0)),
    ("dual(dqb|dqb+bias)", torch.bfloat16, 130, True, None, (0, 0)),
    ("dual(dqab|dqab)", torch.int8, 8, False, None, (0, 128)),
    ("dqb+bias+gelu", torch.bfloat16, 37, True, None, (0, 0)),
    ("dqb+bias+gelu", torch.float32, 130, True, None, (128, 0)),
    ("rms>glu.silu(dqb|dqb)", torch.bfloat16, 130, True, None, (0, 0)),
    ("dact.gelu>dqb", torch.bfloat16, 37, False, "a", (0, 0)),
    ("dact.gelu@b>dqb", torch.bfloat16, 130, False, "b", (0, 0)),
    ("dact.gelu>dqab", torch.int8, 130, False, "a", (128, 128)),
    ("dact.silu@b>dqab+res", torch.int8, 1, False, "b", (0, 0)),
    ("dqab+bias", torch.int8, 130, True, None, (0, 0)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SIMT_FAULT_CASES,
                         ids=[f"{c[0]} {str(c[1])[6:]} m={c[2]}"
                              for c in SIMT_FAULT_CASES])
def test_cuda_dual_and_quant_training_programs_match_plain_version(case):
    """Each launch on the SIMT tile, every output (both branches of a dual
    program, the saved pre-activations) against the plain version: float
    programs to their summation order (fp32 1e-4; a bf16 output one ulp),
    dequant ones at the int8 tolerance, 2e-3 of max|ref|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    tag, adt, m, save, operand, (gb, ga) = case
    n, k = 200, 320
    spec = program_from_tag(tag)
    deq = spec.branches[0].dequant
    r = np.random.RandomState(m + n)
    dev = lambda x, dt=torch.float32: torch.as_tensor(x).to("cuda", dt)  # noqa: E731
    i8 = lambda *sh: dev(r.randint(-127, 128, sh), torch.int8)  # noqa: E731
    a = i8(m, k) if adt == torch.int8 else dev(r.randn(m, k), adt)
    bs = [i8(k, n) if deq != "none" else dev(r.randn(k, n) / np.sqrt(k), adt)
          for _ in spec.branches]
    sa = dev(r.rand(-(-k // ga) if ga else m) * 0.05 + 0.01)
    ops_ = []
    for b in spec.branches:
        d = {}
        if deq != "none":
            d["scale_b"] = dev(r.rand(*((-(-k // gb), n) if gb else (n,)))
                               * 0.01 + 1e-3)
        if deq == "ab":
            d["scale_a"] = sa
        if b.has_bias:
            d["bias"] = dev(r.randn(n))
        if b.has_residual:
            d["residual"] = dev(r.randn(m, n))
        ops_.append(d)
    kw = {"spec": spec, "save_preact": save, "branch_operands": ops_,
          "scale_b_block": gb, "scale_a_block": ga}
    if operand is not None:
        kw["preact"] = dev(r.randn(*((m, k) if operand == "a" else (k, n))))
    if spec.prologue.kind == "rms":
        kw["gain"] = dev(r.rand(k) + 0.5)
        kw["row_scale"] = rms_row_scale(a, 1e-5)
    K.reset_launch_counts()
    got = K.ca_gemm_program(a, bs, **kw)
    key = K.launch_key(tag, "nn", save)
    assert K.route_counts == {f"simt {key}": 1}
    want = K.ca_gemm_program_reference(a, bs, **kw)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want) == spec.n_out + save * spec.n_b
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == (m, n)
        err = (g.float() - w.float()).abs().max().item()
        scale = w.float().abs().max().item()
        if g.dtype == torch.bfloat16:
            tol = 2e-2 * scale
        elif deq != "none":
            tol = 2e-3 * scale
        else:
            tol = 1e-4 * (1 + scale)
        assert err <= tol, (err, tol)


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


# ---------------------------------------------------------------------------
# The other architectures' programs and models (granite-20b's GELU MLP,
# deepseek-v2-lite-16b's expert GEMMs, MLA's narrow projections)
# ---------------------------------------------------------------------------

# (tag, k, n): granite's rms-prologue GELU w_up, deepseek's expert GLU
# and down projection (k = 1408 = 11 x 128: a ragged cluster split on the
# decode route), MLA's wkv_a (n = 576, and 288: a ragged 64-column strip
# and a ragged 128-column wgmma tile) and minicpm3's q-LoRA up projection.
ARCH_PROGRAMS = {"granite w_up": ("rms>gelu", 6144, 24576),
                 "deepseek expert glu": ("glu.silu(none|none)", 2048, 1408),
                 "deepseek expert down": ("none", 1408, 2048),
                 "deepseek wkv_a": ("none", 2048, 576),
                 "minicpm3 wkv_a": ("none", 2560, 288),
                 "minicpm3 wq_b": ("none", 768, 3840),
                 # The last four families: the Mamba2 in_proj (n = 4384,
                 # 14576: multiples of 8, not of 64) and out_proj, zamba2's
                 # shared w_in, qwen2-vl's GLU and down projection,
                 # musicgen's GELU w_up.
                 "mamba2 in_proj": ("none", 1024, 4384),
                 "mamba2 out_proj": ("none", 2048, 1024),
                 "zamba2 in_proj": ("none", 3584, 14576),
                 "zamba2 out_proj / w_in": ("none", 7168, 3584),
                 "qwen2-vl glu": ("rms>glu.silu(none|none)", 8192, 29568),
                 "qwen2-vl w_down": ("res", 29568, 8192),
                 "musicgen w_up": ("rms>gelu", 2048, 8192)}


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8, 16, 37])
@pytest.mark.parametrize("case", list(ARCH_PROGRAMS))
def test_cuda_arch_programs_match_plain_version_on_both_routes(case, m):
    """bf16, 16-byte aligned: the decode route at m <= 8, wgmma above."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    tag, k, n = ARCH_PROGRAMS[case]
    a, bs, kw = _program_inputs(tag, m, n, k, torch.bfloat16, seed=23)
    K.reset_launch_counts()
    got = K.ca_gemm_program(a, bs, **kw)
    route = "decode" if m <= 8 else "wgmma"
    assert K.route_counts == {f"{route} {tag}": 1}
    want = K.ca_gemm_program_reference(a, bs, **kw)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2e-2 * want.float().abs().max().item(), err


def _card_vs_cpu_logits(arch):
    """A reduced arch in bf16 on the card and on the CPU from the same
    parameters: prefill logits and the greedy tokens of 6 steps."""
    import dataclasses

    from repro_torch.configs import get_reduced
    from repro_torch.models import model as M
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = dataclasses.replace(get_reduced(arch, compute_dtype="bfloat16"),
                              d_model=256)
    p_gpu = M.init_params(cfg, seed=4)
    p_cpu = {k: v.cpu() for k, v in p_gpu.items()}
    prompt = np.random.RandomState(5).randint(0, cfg.vocab_size, 24)
    toks = torch.as_tensor(prompt)[None]
    K.reset_launch_counts()
    with torch.inference_mode():
        lg, _ = M.prefill(p_gpu, {"tokens": toks.cuda()}, cfg, max_len=40)
        lc, _ = M.prefill(p_cpu, {"tokens": toks}, cfg, max_len=40)
    launches = sum(K.launch_counts.values())
    outs = []
    for params, dev in ((p_gpu, None), (p_cpu, "cpu")):
        eng = ServeEngine(params, cfg, max_len=40, device=dev)
        eng.submit(Request(uid=1, prompt=prompt, max_new_tokens=6))
        outs.append(eng.run()[1].generated)
    return cfg, lg.cpu(), lc, launches, outs


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-20b", "deepseek-v2-lite-16b"])
def test_cuda_reduced_arch_matches_cpu(arch):
    """The model on the card against its plain path on the CPU: prefill
    logits within 5e-2 of their scale (bf16 rounding through two layers),
    every K1 launch of the prefill counted (granite 6 a layer + the head;
    deepseek 3 + 2 a routed expert + 2 shared a layer + the head)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    cfg, lg, lc, launches, (card, cpu) = _card_vs_cpu_logits(arch)
    per_layer = 6 if cfg.moe is None else 3 + 2 * cfg.moe.n_experts + 2
    assert launches == cfg.n_layers * per_layer + 1
    assert bool(torch.isfinite(lg).all())
    err = (lg - lc).abs().max().item()
    assert err <= 5e-2 * lc.abs().max().item(), err
    assert len(card) == len(cpu) == 6


def _k1_per_prefill(cfg):
    """K1 launches of one prefill of a reduced arch: a Mamba2 layer's
    in_proj and out_proj; a shared-block application's w_in, q/k/v, wo,
    MLP and down projection; a transformer layer's six; one head (none
    for codebook heads, an einsum)."""
    if cfg.family in ("ssm", "hybrid"):
        apps = cfg.n_layers // cfg.shared_attn_every \
            if cfg.shared_attn_every else 0
        n = 2 * cfg.n_layers + 7 * apps
    else:
        n = 6 * cfg.n_layers
    return n + (1 if cfg.n_codebooks == 1 else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-7b",
                                  "qwen2-vl-72b", "musicgen-large"])
def test_cuda_reduced_family_matches_cpu(arch):
    """The last four families (reduced, bf16, d_model 256) on the card
    against the plain path on the CPU from the same parameters and
    inputs (the embeds frontend's demo table): prefill logits within 5e-2
    of their scale, every K1 launch of the prefill counted, six greedy
    tokens on each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    import dataclasses

    from repro_torch.configs import get_reduced
    from repro_torch.models import model as M
    from repro_torch.serve.engine import (Request, ServeEngine,
                                          model_inputs, sample_table)

    cfg = dataclasses.replace(get_reduced(arch, compute_dtype="bfloat16"),
                              d_model=256)
    p_gpu = M.init_params(cfg, seed=4)
    p_cpu = {k: v.cpu() for k, v in p_gpu.items()}
    table = sample_table(cfg, "cpu")
    prompt = np.random.RandomState(5).randint(0, cfg.vocab_size, 24)
    toks = torch.as_tensor(prompt)[None]
    K.reset_launch_counts()
    with torch.inference_mode():
        lg, _ = M.prefill(p_gpu, model_inputs(cfg, toks.cuda(), table.cuda()),
                          cfg, max_len=40)
        lc, _ = M.prefill(p_cpu, model_inputs(cfg, toks, table), cfg,
                          max_len=40)
    assert sum(K.launch_counts.values()) == _k1_per_prefill(cfg)
    assert bool(torch.isfinite(lg).all())
    err = (lg.cpu() - lc).abs().max().item()
    assert err <= 5e-2 * lc.abs().max().item(), err
    outs = []
    for params, dev in ((p_gpu, None), (p_cpu, "cpu")):
        eng = ServeEngine(params, cfg, max_len=40, device=dev,
                          sample_table=table)
        eng.submit(Request(uid=1, prompt=prompt, max_new_tokens=6))
        outs.append(eng.run()[1].generated)
    assert len(outs[0]) == len(outs[1]) == 6


# ---------------------------------------------------------------------------
# The plan and observability layer on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def fresh_registry_and_ledger(tmp_path):
    """A registry over an empty cache in tmp (autotune off) and an enabled
    ledger, both process-global for the test, restored after."""
    from repro_torch import obs
    from repro_torch.tuning import KernelRegistry, TuningCache
    from repro_torch.tuning import registry as treg

    treg.set_registry(KernelRegistry(
        cache=TuningCache(tmp_path / "cache.json"), autotune_enabled=False))
    led = obs.GemmLedger(enabled=True)
    obs.set_ledger(led)
    yield led
    treg.reset_registry()
    obs.reset_ledger()


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["bf16", "int8w", "w8a8"])
@pytest.mark.parametrize("m", [1, 37])
def test_cuda_registry_resolves_each_serve_gemm_to_its_route_tile(
        fresh_registry_and_ledger, quant, m):
    """Every GEMM program of full-width stablelm-1.6b's serve path runs
    through core.gemm at the tile the registry resolves; the launch
    checks it against its route's tile (it raises on a mismatch), and the
    ledger's route is the route the launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.configs import get_config
    from repro_torch.core import gemm as tg
    from repro_torch.quant import QuantConfig
    from repro_torch.quant.calibrate import quantize_tensor

    led = fresh_registry_and_ledger
    cfg = get_config("stablelm-1.6b")
    d, f, v = cfg.d_model, cfg.d_ff, cfg.padded_vocab
    r = np.random.RandomState(m)
    t = lambda *shape: torch.as_tensor(  # noqa: E731
        r.randn(*shape) / np.sqrt(shape[0] if len(shape) == 2 else 1)).to(
            device="cuda", dtype=torch.bfloat16)

    def weight(k, n):
        w = t(k, n)
        if quant == "bf16":
            return w
        qw = quantize_tensor(w, QuantConfig())
        if quant == "w8a8":
            import dataclasses

            qw = dataclasses.replace(qw, act_scale=torch.tensor(
                0.05, device="cuda"))
        return qw

    x = t(m, d) * 4
    gain = torch.ones(d, device="cuda", dtype=torch.bfloat16)
    from repro_torch.kernels.program import RmsPrologue

    K.reset_launch_counts()
    tg.ca_matmul(x, weight(d, d))                                 # wq
    tg.ca_matmul(x, weight(d, d), epilogue=Epilogue(residual=x))  # wo
    h = tg.ca_glu_matmul(x, weight(d, f), weight(d, f),
                         prologue=RmsPrologue(gain))              # GLU
    tg.ca_matmul(h, weight(f, d), epilogue=Epilogue(residual=x))  # w_down
    tg.ca_matmul(x, weight(d, v), out_dtype=torch.float32)        # head
    torch.cuda.synchronize()
    assert len(led.records) == 5
    routes = {key.split(" ", 1)[0] for key in K.route_counts}
    assert sum(K.route_counts.values()) == 5
    for rec in led.records:
        tile = (rec.config["bm"], rec.config["bn"], rec.config["bk"])
        assert tile in K.ROUTE_TILES
        assert rec.mode == K.tile_route(tile)
        assert rec.mode in routes
    assert routes == {"decode" if m == 1 else "wgmma"}


@pytest.mark.cuda
def test_cuda_page_size_autotune_times_k2_and_writes_back(tmp_path):
    """With autotune on, the paged tier times K2 itself (CUDA events) over
    the page candidates and writes the winner to the cache; a new
    registry on the same file then serves it from the cache."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K2 has no CPU mode")
    from repro_torch.tuning import KernelRegistry, TuningCache
    from repro_torch.tuning import attention as tattn

    path = tmp_path / "cache.json"
    reg = KernelRegistry(cache=TuningCache(path), autotune_enabled=True)
    FA.reset_launch_counts()
    got = tattn.resolve_page_size(heads=32, kv_heads=32, head_dim=64,
                                  seq_len=160, registry=reg)
    assert got.source == "autotune"
    assert got.config.kv_block in tattn._PAGE_CANDIDATES
    assert FA.launch_counts.get(FA.NAME, 0) > 0
    entry = TuningCache(path).get(got.key)
    assert entry is not None and entry.bn == got.config.kv_block
    assert entry.measured_s > 0 and entry.n_tried >= 2
    again = tattn.resolve_page_size(
        heads=32, kv_heads=32, head_dim=64, seq_len=160,
        registry=KernelRegistry(cache=TuningCache(path),
                                autotune_enabled=True))
    assert again.source == "cache" and again.config == got.config


@pytest.mark.cuda
def test_cuda_ledger_gemm_calls_equal_k1_launches_of_a_decode_step(
        fresh_registry_and_ledger):
    """Full-width stablelm-1.6b, bf16, one prefill and three decode steps
    with the ledger on: each decode step's GEMM calls (145) equal the K1
    launches the step made."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serve.engine import Request, ServeEngine

    led = fresh_registry_and_ledger
    cfg = get_config("stablelm-1.6b")
    params = M.init_params(cfg, seed=0)
    eng = ServeEngine(params, cfg, max_len=64)
    eng.submit(Request(uid=0, prompt=np.arange(20), max_new_tokens=4))
    K.reset_launch_counts()
    eng.run()
    torch.cuda.synchronize()
    steps = led.steps_summary()
    assert steps["decode"]["steps"] == 3
    assert steps["decode"]["gemm_calls"] == 3 * 145
    assert steps["prefill"]["gemm_calls"] == 145
    assert sum(K.launch_counts.values()) == 4 * 145
    program = led._programs["decode"]
    assert sum(r.calls for r in program) == 145
    assert {r.mode for r in program} == {"decode"}
    del eng, params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The guard rails: shared memory, preflight, the fault hook on the card
# ---------------------------------------------------------------------------

# (tag, A dtype, B dtype, m, n, k, scale block) across the three routes.
SMEM_CASES = [("none", torch.bfloat16, torch.bfloat16, 1, 2048, 2048, 0),
              ("none", torch.bfloat16, torch.bfloat16, 8, 6144, 2048, 0),
              ("rms>glu.silu(none|none)", torch.bfloat16, torch.bfloat16,
               128, 5632, 2048, 0),
              ("res", torch.bfloat16, torch.bfloat16, 37, 2048, 64, 0),
              ("dact.silu>none", torch.bfloat16, torch.bfloat16, 1024,
               2048, 5632, 0),
              ("dqb", torch.bfloat16, torch.int8, 1, 2048, 5632, 128),
              ("glu.silu(dqab|dqab)", torch.int8, torch.int8, 1000, 5632,
               2048, 0),
              ("dqab", torch.int8, torch.int8, 5, 100352, 2048, 256),
              ("none", torch.float32, torch.float32, 37, 200, 300, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SMEM_CASES,
                         ids=lambda c: f"{c[0]}-{c[3]}x{c[4]}x{c[5]}")
def test_cuda_launch_smem_equals_route_smem_bytes(case):
    """The dynamic shared memory the built launcher passes equals
    ``route_smem_bytes`` (the analyzer's SMEM001 input) on the route the
    launch takes, with the card's own SM count."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    tag, a_dt, b_dt, m, n, k, block = case
    spec = program_from_tag(tag)
    route = K.k1_route(spec, "nn", a_dt, b_dt, m, n, k, True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    got = K.launch_smem_bytes(route, spec, a_dt, b_dt, m, n, k, block)
    assert got == K.route_smem_bytes(route, spec, a_dt, b_dt, m=m, n=n, k=k,
                                     scale_block=block, sms=sms)
    assert got + K.route_static_smem_bytes(route, spec, a_dt, b_dt, m=m) \
        <= 227 * 1024


@pytest.mark.cuda
def test_cuda_poisoned_cache_entry_raises_before_any_launch(
        fresh_registry_and_ledger):
    """A cache entry over shared memory raises ProgramValidationError
    (SMEM001) at dispatch on the card; K1 never launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.analyze import ProgramValidationError, reset_preflight
    from repro_torch.core.gemm import ca_matmul
    from repro_torch.tuning import get_registry
    from repro_torch.tuning.cache import CacheEntry, cache_key

    reset_preflight()
    reg = get_registry()
    reg.cache.put(cache_key(128, 1024, 1024, "bfloat16", hw=reg.hw),
                  CacheEntry(bm=16384, bn=16384, bk=16384))
    x = torch.randn(128, 1024, device="cuda", dtype=torch.bfloat16)
    w = torch.randn(1024, 1024, device="cuda", dtype=torch.bfloat16)
    K.reset_launch_counts()
    with pytest.raises(ProgramValidationError, match="SMEM001"):
        ca_matmul(x, w)
    assert K.launch_counts == {}


@pytest.mark.cuda
@pytest.mark.parametrize("fatal", [False, True], ids=["recoverable",
                                                      "fatal"])
def test_cuda_injected_failure_relaunches_the_kernel(fatal):
    """With the fallback on, an injected non-fatal failure counts once in
    gemm.fallback_total and the same GEMM launches its kernel on the card
    (no host copy, no plain version): bit-equal to a fault-free call.  A
    fatal one propagates before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch import obs
    from repro_torch.core.gemm import ca_matmul, gemm_fallback
    from repro_torch.runtime.fault import FaultPlan, InjectedKernelFailure

    x = torch.randn(37, 512, device="cuda", dtype=torch.bfloat16)
    w = torch.randn(512, 256, device="cuda", dtype=torch.bfloat16) / 23
    obs.reset_metrics()
    K.reset_launch_counts()
    want = ca_matmul(x, w)
    assert sum(K.launch_counts.values()) == 1
    plan = FaultPlan(kernel_fatal_at=(0,)) if fatal \
        else FaultPlan(kernel_fail_at=(0,))
    with gemm_fallback(True), plan:
        if fatal:
            with pytest.raises(InjectedKernelFailure):
                ca_matmul(x, w)
            assert sum(K.launch_counts.values()) == 1
        else:
            got = ca_matmul(x, w)
            assert got.device.type == "cuda" and got.dtype == want.dtype
            assert torch.equal(got, want)
            assert sum(K.launch_counts.values()) == 2
        ca_matmul(x, w)
    fallbacks = obs.get_metrics().snapshot().get(
        "gemm.fallback_total", {}).get("value", 0)
    assert fallbacks == (0 if fatal else 1)
    assert sum(K.launch_counts.values()) == (2 if fatal else 3)


# ---------------------------------------------------------------------------
# Training the MoE and Mamba2 families on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_expert_backward_matches_plain_version(dtype):
    """The expert loop's backward on the card (each expert's GLU with
    save_preact and its four K1f programs, its down projection and two)
    against the plain versions on the CPU, on a (B, E, C, d) capacity
    buffer: fp32 within 1e-4 · (1 + max|cpu|), bf16 within a relative L2
    error of 2e-2 (a bf16 output may flip an ulp)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.core.gemm import ca_expert_glu_matmul, ca_expert_matmul

    torch.backends.cuda.matmul.allow_tf32 = False
    B, E, C, d, f = 2, 3, 24, 64, 88
    r = np.random.RandomState(17)
    data = {"x": r.randn(B, E, C, d), "wg": r.randn(E, d, f) / 8,
            "wu": r.randn(E, d, f) / 8, "wd": r.randn(E, f, d) / 9,
            "cot": r.randn(B, E, C, d)}
    out = {}
    for dev in ("cuda", "cpu"):
        t = {k: torch.as_tensor(v).to(device=dev, dtype=dtype)
             .requires_grad_(k != "cot") for k, v in data.items()}
        K.reset_launch_counts()
        h = ca_expert_glu_matmul(t["x"], t["wg"], t["wu"], out_dtype=dtype)
        y = ca_expert_matmul(h, t["wd"], out_dtype=dtype)
        (y.float() * t["cot"].float()).sum().backward()
        out[dev] = {k: v.grad.float().cpu() for k, v in t.items()
                    if v.grad is not None}
        out[dev]["y"] = y.detach().float().cpu()
        if dev == "cuda":
            torch.cuda.synchronize()
            assert K.launch_counts == {
                "glu.silu(none|none) save_preact": E, "none": E,
                "dact.silu>none nt": E, "none nt": 2 * E,
                "dact.silu@b>none tn": E, "none tn": 2 * E}
    for name, g in out["cpu"].items():
        got = out["cuda"][name]
        if dtype == torch.float32:
            err = (got - g).abs().max().item()
            assert err <= 1e-4 * (1 + g.abs().max().item()), (name, err)
        else:
            rel = ((got - g).norm() / g.norm()).item()
            assert rel <= 2e-2, (name, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "mamba2-370m"])
def test_cuda_reduced_train_step_matches_cpu(arch):
    """One bf16 train step's loss, aux and every gradient leaf of a
    reduced MoE + MLA arch and of the Mamba2 stack (d_model 256, remat on)
    on the card against the plain path on the CPU from the same fp32
    masters and batch: loss within 1e-2 relative, each leaf within a
    relative L2 error of 5e-2 (chip_smoke.py's TOL_LOSS and TOL_GRAD:
    bf16 rounding through two layers and the backward), and the card's
    K1 launches exactly ``chip_smoke.train_counts_per_step``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    import dataclasses
    import importlib.util
    import pathlib

    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import DataConfig, batch_for_model
    from repro_torch.models import model as M
    from repro_torch.train import step as T

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = dataclasses.replace(get_reduced(arch, compute_dtype="bfloat16"),
                              d_model=256)
    masters = M.init_params(cfg, seed=3, device="cpu", masters=True)
    batch = batch_for_model(cfg, DataConfig(
        vocab_size=cfg.vocab_size, seq_len=32, global_batch=2, seed=3), 0)
    out = {}
    for dev in ("cuda", "cpu"):
        params = T.cast_params({k: v.to(dev) for k, v in masters.items()},
                               cfg)
        K.reset_launch_counts()
        total, metrics = T.loss_fn(params, T.cast_batch(batch, cfg, dev),
                                   cfg)
        keys = sorted(params)
        grads = torch.autograd.grad(total, [params[k] for k in keys])
        if dev == "cuda":
            torch.cuda.synchronize()
            assert K.launch_counts == smoke.train_counts_per_step(cfg)
        out[dev] = ({k: v.item() for k, v in metrics.items()},
                    {k: g.float().cpu() for k, g in zip(keys, grads)})
    (mg, gg), (mc, gc) = out["cuda"], out["cpu"]
    assert abs(mg["loss"] - mc["loss"]) <= 1e-2 * abs(mc["loss"])
    assert abs(mg["aux"] - mc["aux"]) <= 1e-2 * abs(mc["aux"]) + 1e-6
    for k, g in gc.items():
        assert bool(torch.isfinite(gg[k]).all()), k
        rel = ((gg[k] - g).norm() / g.norm()).item()
        assert rel <= 5e-2, (k, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", [(4, 512, 512), (4, 1408, 512),
                                   (500, 1408, 512)])
def test_cuda_dist_local_matmul_launches_k1(m, n, k):
    """A ring step's local GEMM (``core.gemm.dist_local_matmul``) at the
    TP decode block's and dist_matmul's local shapes: one K1 launch of
    the ``none`` program with an fp32 output at the registry's tile,
    against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.core.gemm import dist_local_matmul
    from repro_torch.tuning import get_registry

    torch.backends.cuda.matmul.allow_tf32 = False
    a, bs, _ = _program_inputs("none", m, n, k, torch.bfloat16, seed=27)
    tile = get_registry().resolve_full(m, n, k, dtype=torch.bfloat16,
                                       epilogue="none").config
    K.reset_launch_counts()
    got = dist_local_matmul(a, bs[0], tile=tile)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert K.launch_counts == {"none": 1}
    assert K.shape_counts == {("none", m, n, k): 1}
    want = K.ca_gemm_program_reference(a, (bs[0],), out_dtype=torch.float32)
    assert (got - want).abs().max().item() <= 1e-4 * (
        1 + want.abs().max().item())


# -- the port's examples (examples/torch_port/) on the card -------------------

def _example(name):
    """``examples/torch_port/<name>.py`` as the module
    ``torch_port.<name>``."""
    import importlib
    import pathlib
    import sys

    examples = str(pathlib.Path(__file__).resolve().parents[1] / "examples")
    if examples not in sys.path:
        sys.path.insert(0, examples)
    return importlib.import_module(f"torch_port.{name}")


@pytest.mark.cuda
def test_cuda_quickstart_example_runs_k1(capsys):
    """The quickstart's GEMM is one K1 launch on the SIMT route (fp32),
    within the float tolerance of a float64 host product, and the script
    prints the route it took."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    qs = _example("quickstart")
    K.reset_launch_counts()
    err, route = qs.gemm_check()
    assert K.launch_counts == {"none": 1}
    assert route == "simt none"
    rng = np.random.RandomState(0)
    scale = np.abs(rng.randn(512, 384) @ rng.randn(384, 256)).max()
    assert err <= 1e-4 * (1 + scale), err
    qs.main([])
    out = capsys.readouterr().out
    assert "K1 route: simt none) vs float64 host product" in out
    assert len(out.splitlines()) == 10


def _serve_example_card_and_cpu(quantize, chaos=False):
    """The serve example's stablelm-1.6b from the same seeded weights,
    on the card and on the CPU (the GEMM fallback on, as outside the
    test suite); returns both results and the card run's K1 launches."""
    from repro_torch.configs import get_reduced
    from repro_torch.core.gemm import gemm_fallback
    from repro_torch.models import model as M

    serve = _example("serve_lm").serve_arch
    arch = "stablelm-1.6b"
    p_cpu = M.init_params(get_reduced(arch), seed=0, device="cpu")
    p_gpu = {k: v.cuda() for k, v in p_cpu.items()}
    with gemm_fallback(True):
        K.reset_launch_counts()
        card = serve(arch, p_gpu, quantize=quantize, chaos=chaos)
        torch.cuda.synchronize()
        launches = sum(K.launch_counts.values())
        cpu = serve(arch, p_cpu, quantize=quantize, chaos=chaos,
                    device="cpu")
    return card, cpu, launches


@pytest.mark.cuda
@pytest.mark.parametrize("quantize", ["none", "int8", "w8a8"])
def test_cuda_serve_lm_example_greedy_matches_cpu(quantize):
    """The serve example on the card: every GEMM on K1, the greedy
    tokens identical to the same function's on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    card, cpu, launches = _serve_example_card_and_cpu(quantize)
    assert launches > 0
    assert [card["done"][u].status for u in (0, 1)] == ["done", "done"]
    assert card["done"][0].generated == cpu["done"][0].generated
    assert len(card["done"][1].generated) == 6


@pytest.mark.cuda
def test_cuda_serve_lm_example_chaos_matches_cpu():
    """``--chaos --quantize int8`` on the card: the same statuses, quant
    levels and injections as on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    card, cpu, launches = _serve_example_card_and_cpu("int8", chaos=True)
    assert launches > 0
    outcome = lambda res: [  # noqa: E731
        (u, r.status, r.quant_level, r.degraded_to)
        for u, r in sorted(res["done"].items())]
    assert outcome(card) == outcome(cpu)
    assert [s for _, s, _, _ in outcome(card)] == [
        "failed", "degraded", "degraded", "done"]
    assert sorted(card["plan"].injected) == sorted(cpu["plan"].injected)
