"""The port's attention kernels' wrappers on the CPU against the
reference's Pallas kernels in interpret mode: paged decode attention (K2,
``paged_flash_attention_tpu``) on the same numpy-seeded int8 pools, and
forward flash attention (K3, ``flash_attention_tpu``) on numpy-seeded
q/k/v and positions.  The CUDA kernels themselves are held against the
plain versions in test_torch_cuda.py."""

import functools

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
    one tile, the port's kernel into one CTA, 8 to a warp."""
    pool = random_pool(5, [13, 6], page=4, n_pages=8, Hkv=1, D=128)
    q = query(5, 2, 48, 128)
    want = paged_flash_attention_tpu(jnp.asarray(q), *_jax(pool),
                                     window=window, interpret=True)
    got = FA.paged_flash_attention(torch.as_tensor(q), *_torch(pool),
                                   window=window)
    assert got.shape == (2, 48, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("window", [None, 5], ids=["causal", "sliding"])
@pytest.mark.parametrize("D,Dv", [(192, 128), (256, 256), (576, 512)],
                         ids=["mla-D192-Dv128", "D256", "absorbed-mla"])
def test_paged_attention_wide_head_dims_match_reference_kernel(D, Dv, window):
    """Head dims above 128, which the card takes in one launch:
    deepseek-v2-lite's MLA head (D = 192, Dv = 128), D = Dv = 256, and its
    absorbed form (D = 576, Dv = 512: two 256-wide column chunks on the
    card), GQA 2, ragged lengths over a few pages."""
    Hkv, page = 2, 8
    pool = random_pool(7, [19, 27], page=page, n_pages=8, Hkv=Hkv, D=D,
                       Dv=Dv)
    q = query(7, 2, 2 * Hkv, D)
    want = paged_flash_attention_tpu(jnp.asarray(q), *_jax(pool),
                                     window=window, interpret=True)
    got = FA.paged_flash_attention(torch.as_tensor(q), *_torch(pool),
                                   window=window)
    assert got.shape == (2, 2 * Hkv, Dv)
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
# K2's schedule on the card: the split chooser, each split's token range,
# and a plain model of the splits merged in order
# ---------------------------------------------------------------------------

N_SM = 132  # an H100's SMs


@pytest.mark.parametrize("B,Hkv,G,NP,page", [
    (1, 32, 1, 8, 128), (1, 8, 4, 3, 128), (8, 32, 1, 32, 128),
    (8, 8, 4, 32, 128), (2, 1, 48, 8, 128), (3, 2, 4, 64, 16),
    (1, 4, 1, 0, 16), (64, 32, 1, 256, 16), (1, 1, 1, 1000, 1),
    (1, 1, 96, 40, 16)])
@pytest.mark.parametrize("D,Dv", [(64, 64), (120, 120), (576, 512)])
def test_paged_splits_bounds(B, Hkv, G, NP, page, D, Dv):
    """Between 1 and a cluster's 8; no more CTAs than one wave holds (as
    many an SM as shared memory holds, or one; unless one split already
    gives more); no more splits than table pages, nor than two warp tiles
    of the table's tokens each."""
    plan = FA.paged_plan(G, D, Dv)
    s = FA.paged_splits(B, Hkv, NP, page, N_SM, plan)
    resident = FA.SM_SMEM // (plan.smem + 1024)
    cells = B * Hkv * plan.chunks * plan.vchunks
    assert 1 <= s <= FA.PAGED_MAX_SPLITS
    assert s == 1 or cells * s <= max(1, resident) * N_SM
    assert s == 1 or (s <= NP and s * 2 * FA.PAGED_TILE <= NP * page)


@pytest.mark.parametrize("page", [16, 64, 128])
def test_paged_splits_one_page_sequence_takes_one_split(page):
    assert FA.paged_splits(1, 1, 1, page, N_SM, FA.paged_plan(1, 8, 8)) == 1


def test_paged_splits_at_the_served_shapes():
    """The splits measured fastest on the H100 (``tools/k2_probe.py``): at
    B = 1, 8 over stablelm-1.6b's 8 table pages (4 CTAs an SM), 3 over
    h2o-danube-3-4b's 3; at B = 8 over 4096 tokens, 2 each; granite-20b's
    G = 48 over one KV head at B = 2: 8; deepseek-v2-lite's MLA head
    (D = 192, Dv = 128) at B = 2: 4 (its CTA runs alone on an SM)."""
    lm, danube = FA.paged_plan(1, 64, 64), FA.paged_plan(4, 120, 120, True)
    assert FA.paged_splits(1, 32, 8, 128, N_SM, lm) == 8
    assert FA.paged_splits(1, 8, 3, 128, N_SM, danube) == 3
    assert FA.paged_splits(8, 32, 32, 128, N_SM, lm) == 2
    assert FA.paged_splits(8, 8, 32, 128, N_SM, danube) == 2
    assert FA.paged_splits(2, 1, 8, 128, N_SM,
                           FA.paged_plan(48, 128, 128)) == 8
    assert FA.paged_splits(2, 16, 8, 128, N_SM,
                           FA.paged_plan(1, 192, 128)) == 4


@pytest.mark.parametrize("G,D,Dv", [(1, 64, 64), (4, 120, 120),
                                    (48, 128, 128), (1, 192, 128),
                                    (2, 256, 256), (16, 256, 256),
                                    (64, 128, 128), (2, 8, 8), (3, 36, 20)])
def test_paged_plan_holds_the_whole_group(G, D, Dv):
    """Every served and tested head geometry, and any G up to 64, fits one
    CTA whole (one read of each page byte per KV head and split, all of Dv
    scored once), within shared memory and 8 warps."""
    plan = FA.paged_plan(G, D, Dv)
    assert (plan.group, plan.chunks, plan.dvc, plan.vchunks) == (G, 1, Dv, 1)
    assert plan.smem == FA.paged_smem_bytes(G, D, Dv, False, plan.ng)
    assert plan.smem <= FA.PAGED_SMEM
    wh, _, _, ng = FA._paged_shape(G)
    assert plan.ng == ng and wh * ng <= 8


def test_paged_plan_chunks_a_group_past_64_and_refuses_what_cannot_fit():
    assert FA.paged_plan(128, 128, 128).group == 64
    assert FA.paged_plan(71, 128, 128).group == 36
    with pytest.raises(ValueError, match="does not fit"):
        FA.paged_plan(1, 4096, 256)


@pytest.mark.parametrize("G,D,Dv,shift", [
    (1, 576, 512, False), (16, 576, 512, False), (64, 576, 512, False),
    (128, 576, 512, False), (1, 3000, 3000, False), (4, 1000, 264, True),
    (8, 2048, 300, False), (64, 1024, 128, False)])
def test_paged_plan_fits_large_head_dims(G, D, Dv, shift):
    """Head dims past one CTA's shared memory at the whole group and all
    of Dv still get a plan: fewer token groups, then fewer heads a CTA,
    then Dv in chunks of whole 16-byte units (each at most 256 columns),
    so the card computes every shape the reference does (deepseek-v2's
    absorbed MLA head, D = 576 and Dv = 512, among them)."""
    plan = FA.paged_plan(G, D, Dv, shift)
    assert plan.smem == FA.paged_smem_bytes(plan.group, D, plan.dvc, shift,
                                            plan.ng)
    assert plan.smem <= FA.PAGED_SMEM
    wh, _, _, ng = FA._paged_shape(plan.group)
    assert 1 <= plan.ng <= ng and wh * plan.ng <= 8
    assert plan.chunks == -(-G // plan.group) and plan.group * plan.chunks >= G
    assert plan.dvc <= FA.PAGED_MAX_DV
    assert plan.vchunks == -(-Dv // plan.dvc) and plan.dvc * plan.vchunks >= Dv
    assert plan.vchunks == 1 or plan.dvc % 16 == 0
    if (G, D, Dv) == (16, 576, 512):
        assert (plan.group, plan.dvc, plan.vchunks) == (16, 256, 2)


@pytest.mark.parametrize("D,Dv,Hkv,aligned,want", [
    (120, 120, 8, True, True), (120, 120, 8, False, False),
    (120, 120, 1, True, False), (64, 64, 32, True, False),
    (120, 128, 8, True, False), (24, 40, 2, True, True)])
def test_shifted_rows(D, Dv, Hkv, aligned, want):
    """16-byte windows only for rows of 8 (mod 16) bytes whose token slabs
    are whole 16-byte chunks, in aligned pools."""
    assert FA.shifted_rows(D, Dv, Hkv, aligned) is want


def split_bounds(length, window, table_tokens, splits):
    """The token range ``[begin, end)`` of each split of one sequence, as
    each CTA of the card's kernel computes its own on the device
    (``csrc/paged_flash_attn.cu``): the live range ``[lo, hi) = [max(0,
    length - window), min(length, table_tokens))`` cut into ``splits``
    equal parts of whole ``PAGED_TILE``-token tiles, the last ones short
    or empty."""
    hi = min(length, table_tokens)
    lo = max(0, length - window) if window else 0
    n = max(0, hi - lo)
    per = -(-(-(-n // splits)) // FA.PAGED_TILE) * FA.PAGED_TILE
    return [(lo + min(n, s * per), lo + min(n, (s + 1) * per))
            for s in range(splits)]


@pytest.mark.parametrize("D,Dv,page,shift,vec,want", [
    (64, 64, 128, False, 16, True), (120, 120, 128, True, 16, True),
    (128, 128, 128, False, 16, True), (120, 120, 16, True, 16, False),
    (192, 128, 128, False, 16, False), (64, 64, 128, False, 8, False),
    (32, 32, 32, False, 16, False), (56, 56, 64, True, 16, True)])
def test_tma_rows(D, Dv, page, shift, vec, want):
    """TMA boxes for 16-byte rows of 64 or 128 bytes (or windows of that
    size) in pages of whole 32-token tiles; cp.async for the rest."""
    assert FA.tma_rows(D, Dv, page, shift, vec) is want


@pytest.mark.parametrize("length,window,tokens,splits", [
    (1016, None, 1024, 8), (5, None, 1024, 8), (0, None, 64, 3),
    (1016, 3, 1024, 8), (300, 100, 256, 3), (40, None, 16, 2),
    (37, 50, 48, 1)])
def test_paged_split_bounds_cover_the_live_range_in_order(length, window,
                                                          tokens, splits):
    bounds = split_bounds(length, window, tokens, splits)
    lo = max(0, length - window) if window else 0
    hi = min(length, tokens)
    assert len(bounds) == splits
    assert [t for a, e in bounds for t in range(a, e)] \
        == list(range(lo, max(lo, hi)))
    sizes = [e - a for a, e in bounds]
    nonempty = [x for x in sizes if x]
    assert all(x == sizes[0] for x in nonempty[:-1])
    assert sizes == sorted(sizes, reverse=True)


def _merge(states):
    """(m, l, acc) states merged in order by the rescale exp(m_s - max m)."""
    top = np.max([st[0] for st in states], axis=0)
    den = np.zeros_like(states[0][1])
    num = np.zeros_like(states[0][2])
    for m, l, acc in states:
        f = np.exp(m - top)
        den = den + f * l
        num = num + f[..., None] * acc
    return top, den, num


def split_schedule(q, pool, *, window=None, splits, scale=None):
    """A plain model of the card's schedule (numpy, test only): each split's
    token range as the CTA computes it on the device, its tiles of
    ``PAGED_TILE`` tokens dealt to the CTA's token groups in turn, each
    group's (m, l, acc) by the online softmax, the groups merged in order,
    then the splits merged in split order, each by the rescale
    exp(m_s - max m).  q (B, H, D) fp32; returns (B, H, Dv)."""
    k = pool["k"].astype(np.float32)
    v = pool["v"].astype(np.float32)
    _, page, Hkv, D = k.shape
    Dv = v.shape[-1]
    B, H, _ = q.shape
    G = H // Hkv
    scale = np.float32(D ** -0.5 if scale is None else scale)
    NP = pool["tables"].shape[1]
    ng = FA.paged_plan(G, D, Dv).ng
    out = np.zeros((B, H, Dv), np.float32)
    for b in range(B):
        qb = q[b].reshape(Hkv, G, D)
        states = []
        for a, e in split_bounds(int(pool["lens"][b]), window, NP * page,
                                 splits):
            tiles = list(range(a, e, FA.PAGED_TILE))
            groups = []
            for grp in range(ng):
                m = np.full((Hkv, G), FA.NEG, np.float32)
                l = np.zeros((Hkv, G), np.float32)
                acc = np.zeros((Hkv, G, Dv), np.float32)
                for t0 in tiles[grp::ng]:
                    t = np.arange(t0, min(e, t0 + FA.PAGED_TILE))
                    pid = np.maximum(pool["tables"][b, t // page], 0)
                    s = np.einsum("hgd,thd->hgt", qb, k[pid, t % page]) \
                        * (scale * pool["k_scale"][pid])
                    m_new = np.maximum(m, s.max(-1))
                    p = np.exp(s - m_new[..., None])
                    alpha = np.exp(m - m_new)
                    l = l * alpha + p.sum(-1)
                    acc = acc * alpha[..., None] + np.einsum(
                        "hgt,thd->hgd", p * pool["v_scale"][pid],
                        v[pid, t % page])
                    m = m_new
                groups.append((m, l, acc))
            states.append(_merge(groups))
        _, den, num = _merge(states)
        out[b] = (num / np.maximum(den, 1e-30)[..., None]).reshape(H, Dv)
    return out


# (lens, page, n_pages, H, Hkv, D, Dv, window): ragged lengths that leave
# splits empty (5 tokens over 8 splits), a window of 3 that leaves most of
# them empty, len = 0, granite-20b's 48 query heads over one KV head,
# deepseek-v2-lite's MLA head (D = 192, Dv = 128) and its absorbed form
# (16 heads over one latent KV head, D = 576, Dv = 512).
SPLIT_CASES = {"ragged": ([5, 1016], 64, 20, 4, 2, 32, 32, None),
               "window": ([1016, 300], 64, 24, 4, 2, 32, 32, 3),
               "len0": ([0, 37], 16, 6, 4, 2, 16, 16, None),
               "G48": ([13, 70], 8, 14, 48, 1, 128, 128, None),
               "mla": ([19, 130], 16, 14, 4, 2, 192, 128, None),
               "absorbed mla": ([19, 70], 16, 12, 16, 1, 576, 512, None)}


@functools.lru_cache(maxsize=None)
def _split_case(case):
    lens, page, n_pages, H, Hkv, D, Dv, window = SPLIT_CASES[case]
    pool = random_pool(13, lens, page=page, n_pages=n_pages, Hkv=Hkv, D=D,
                       Dv=Dv)
    q = query(13, len(lens), H, D)
    want = np.asarray(paged_flash_attention_tpu(
        jnp.asarray(q), *_jax(pool), window=window, interpret=True))
    return pool, q, window, want


@pytest.mark.parametrize("splits", [1, 2, 3, 8])
@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_schedule_matches_reference_kernel(case, splits):
    """The card's splits, merged in order, give the reference kernel's
    result (in interpret mode), empty splits and len = 0 included."""
    pool, q, window, want = _split_case(case)
    got = split_schedule(q, pool, window=window, splits=splits)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    if case == "len0":
        assert not got[0].any()


# ---------------------------------------------------------------------------
# K3: forward flash attention
# ---------------------------------------------------------------------------

def fwd_inputs(seed, B, Lq, S, H, Hkv, D, *, holes=False, Dv=None):
    """numpy q (B, Lq, H, D), k (B, S, Hkv, D), v (B, S, Hkv, Dv, default
    D) ~ N(0, 1) and int32 positions: kv slot s at position s, queries
    end-aligned with the keys.  With ``holes`` some kv slots are invalid
    (-1) and the last batch row's first query sits before every kv
    position, so it sees no slot."""
    r = np.random.RandomState(seed)
    q = r.randn(B, Lq, H, D).astype(np.float32)
    k = r.randn(B, S, Hkv, D).astype(np.float32)
    v = r.randn(B, S, Hkv, Dv or D).astype(np.float32)
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


@pytest.mark.parametrize("D,Dv", [(192, 128), (256, 256)],
                         ids=["mla-D192-Dv128", "D256"])
def test_flash_attention_wide_head_dims_match_reference_kernel(D, Dv):
    """Head dims above 128, which the card takes on the SIMT kernel in
    128-wide chunks: deepseek-v2-lite's MLA head (D = 192, Dv = 128) and
    D = Dv = 256, GQA 2, a window, -1 slots and a fully masked row."""
    inputs = fwd_inputs(9, 2, 21, 40, 4, 2, D, holes=True, Dv=Dv)
    got, want = _run_both(inputs, window=13)
    assert got.shape == (2, 21, 4, Dv)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    assert not want[-1, 0].any() and not got[-1, 0].any()


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
    (torch.bfloat16, 128, 128, True, "wgmma"),
    (torch.bfloat16, 192, 128, True, "simt"),
    (torch.bfloat16, 128, 256, True, "simt"),
    (torch.bfloat16, 256, 256, True, "simt"),
], ids=lambda v: str(v).replace("torch.", ""))
def test_fwd_route(dtype, D, Dv, aligned, want):
    """K3's route: wgmma for bf16 whose q, k, v bases are 16-byte aligned
    and whose head dims are multiples of 8 (TMA's row-stride rule) and at
    most 128 (two 64-wide boxes); SIMT for fp32, for larger head dims and
    for bf16 TMA cannot take."""
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
