"""Flash attention kernels (port of ``repro/kernels/flash_attn.py``):
paged int8 decode attention (``paged_flash_attention_tpu``, kernel K2) and
forward flash attention (``flash_attention_tpu``, kernel K3).

K2 is hand-written CUDA C++ for Hopper,
``repro_torch/csrc/paged_flash_attn.cu``, flash-decoding in one launch:
one CTA per (split, KV head, sequence) holds the whole group of G query
heads and computes all of Dv (:func:`paged_plan`; a group past 64, a Dv
past 256 or a CTA past shared memory takes chunks), computes its share of
the sequence's live tokens on the device (the live range cut into
:func:`paged_splits` equal parts, as many as fill one wave of the card),
streams those tokens' int8 K and V rows through rings of 32-token tiles
from the block table (a TMA box a tile where pages hold whole tiles,
:func:`tma_rows`; cp.async otherwise), with the page scales folded into
the running softmax (k-scale into the logit scale, v-scale into the PV
partial), scores each token once for all of its columns, and the splits
of a (KV head, sequence), one thread-block cluster, merge their softmax
states through distributed shared memory in rank order.  It reads the
page ids, the lengths and the scales on the device; the wrapper never
reads them to the host.

K3 is ``repro_torch/csrc/flash_attn_fwd.cu``: one CTA per (batch x KV
head, q block, chunk of the G query heads, so any G) holds the folded
(head, position) query rows of that block, walks the kv slots in blocks of
64 with the fp32 online softmax and stores each output element once; it
reads both position arrays on the device.  Two routes (:func:`fwd_route`,
twinned in the C entry point, which refuses a launch whose route
differs): bf16 operands that meet TMA's address rules take a TMA + WGMMA
kernel (128 rows a CTA, K and V through a ring of TMA stages, Q K^T and
P V on the tensor cores, the softmax in the accumulator's registers);
fp32, head dims above 128 and the rest a SIMT kernel (64 rows, fp32 FMAs;
head dims in 128-wide chunks).  Launches count in
``launch_counts`` and, by route, in ``route_counts``.  No model calls it:
the model's prefill keeps the plain chunked attention of
:mod:`repro_torch.models.attention`, as the reference's does.

Dispatch depends only on where the operands lie: CPU tensors run the plain
torch versions (:func:`paged_flash_attention_reference`,
:func:`flash_attention_reference`); CUDA tensors launch the kernel or
raise.  The kernels are built and bound by
:mod:`repro_torch.kernels._build`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build

SOURCE = _build.CSRC / "paged_flash_attn.cu"
NAME = "paged_flash_attention"
FWD_SOURCE = _build.CSRC / "flash_attn_fwd.cu"
FWD_NAME = "flash_attention"

# Launches of the CUDA kernels.  Only the kernel launches below add to it;
# the plain versions never do.
launch_counts: Dict[str, int] = {}
# K3's launches by route: "wgmma flash_attention", "simt flash_attention".
route_counts: Dict[str, int] = {}

NEG = -1e30
_FLOATS = (torch.float32, torch.bfloat16)
# K3's wgmma route takes head dims up to two 64-wide TMA boxes; larger ones
# run in 128-wide chunks on its SIMT kernel.
WGMMA_MAX_HEAD_DIM = 128
# K3's kv slots per online-softmax step, on both routes; the plain version
# steps through the kv slots in the same blocks.
FWD_KV_BLOCK = 64
_ROUTE_CODES = {"simt": 0, "wgmma": 1}


def reset_launch_counts() -> None:
    launch_counts.clear()
    route_counts.clear()


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.paged_flash_attn_launch
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                   + [ctypes.c_float] + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int


# K2's geometry (twins of the constants of csrc/paged_flash_attn.cu).
PAGED_TILE = 32            # tokens a warp's ring stage holds, one a lane
PAGED_STAGES = 2           # ring depth
PAGED_MAX_SPLITS = 8       # CTAs of a cluster (the portable most)
PAGED_MAX_GROUP = 64       # query heads a CTA holds (8 warps of 8)
PAGED_MAX_DV = 256         # output columns a CTA holds (2 words of V a lane)
PAGED_SMEM = 232448        # dynamic shared memory a CTA may use
SM_SMEM = 233472           # shared memory of one SM (a CTA also takes 1 KB)


def _r16(x: int) -> int:
    return -(-x // 16) * 16


def _paged_shape(group: int) -> Tuple[int, int, int, int]:
    """(warps sharing a token tile, heads a warp holds, those padded to 1,
    2, 4 or 8, token groups) of a CTA holding ``group`` query heads."""
    wh = -(-group // 8)
    hw = -(-group // wh)
    gp = 1 if hw <= 1 else 2 if hw <= 2 else 4 if hw <= 4 else 8
    ng = 4 // wh if wh <= 4 else 1
    return wh, hw, gp, ng


def paged_smem_bytes(group: int, D: int, Dv: int, shift: bool = False,
                     ng: Optional[int] = None) -> int:
    """Dynamic shared memory of a K2 CTA holding ``group`` query heads in
    ``ng`` token groups (default :func:`_paged_shape`'s) and computing
    ``Dv`` output columns (``shift``: rows staged in their 16-byte
    windows): the twin of the CUDA source's ``make_layout``."""
    wh, _, gp, ng0 = _paged_shape(group)
    ng = ng0 if ng is None else ng
    nw, hp, t, stages = ng * wh, wh * gp, PAGED_TILE, PAGED_STAGES
    pad = 8 if shift else 0
    dq = _r16(D)
    rk = _r16(pad + dq)
    rs_k = rk if (rk // 16) % 2 else rk + 16
    rs_v = _r16(Dv + pad)
    ow = 4 * -(-Dv // 4)
    ring = (1024 + -(-ng * stages * t * rs_k // 1024) * 1024
            + -(-ng * stages * t * rs_v // 1024) * 1024)
    merge = ng * hp * (ow + 2) * 4
    return (_r16(hp * dq * 4) + _r16(max(ring, merge)) + 2 * ng * stages * t * 4
            + 2 * ng * 2 * t * 8 + ng * 2 * t * 4 + nw * t * gp * 4
            + _r16(hp * ow * 4) + 3 * _r16(hp * 4)
            + _r16(PAGED_MAX_SPLITS * hp * 4) + _r16(ng * stages * 8))


def _paged_group(G: int) -> Tuple[int, int]:
    """(group, chunks): the query heads a CTA holds, the whole group G up
    to ``PAGED_MAX_GROUP``, else the fewest equal chunks."""
    chunks = -(-G // PAGED_MAX_GROUP)
    group = -(-G // chunks)
    return group, -(-G // group)


class PagedPlan(NamedTuple):
    """How K2 lays out one (sequence, KV head) over CTAs and inside one."""
    group: int     # query heads a CTA holds
    chunks: int    # CTAs over the group, ceil(G / group), each reading the pages
    ng: int        # token groups a CTA holds
    dvc: int       # output columns a CTA computes
    vchunks: int   # CTAs over Dv, ceil(Dv / dvc), each scoring the tokens
    smem: int      # a CTA's dynamic shared memory, bytes


def paged_plan(G: int, D: int, Dv: int, shift: bool = False) -> PagedPlan:
    """K2's plan for G query heads a KV head and head dims D, Dv: the whole
    group in one CTA up to ``PAGED_MAX_GROUP`` and all of Dv up to
    ``PAGED_MAX_DV`` (one read of each page byte per KV head and split,
    the tokens scored once).  Larger Dv takes chunks of whole 16-byte
    units.  Where the CTA's shared memory would not hold that, fewer token
    groups, then half the heads, then half the columns a CTA, until it
    does; a D too large for one token group of one head raises."""
    group, chunks = _paged_group(G)
    vchunks = -(-Dv // PAGED_MAX_DV)
    dvc = Dv if vchunks == 1 else _r16(-(-Dv // vchunks))
    ng = _paged_shape(group)[3]
    while paged_smem_bytes(group, D, dvc, shift, ng) > PAGED_SMEM:
        if ng > 1:
            ng //= 2
        elif group > 1:
            chunks *= 2
            group = -(-G // chunks)
        elif dvc > 16:
            dvc = _r16(-(-dvc // 2))
        else:
            raise ValueError(f"head dim D = {D} does not fit the paged "
                             "kernel's K ring in shared memory")
    return PagedPlan(group, -(-G // group), ng, dvc, -(-Dv // dvc),
                     paged_smem_bytes(group, D, dvc, shift, ng))


def paged_splits(B: int, Hkv: int, NP: int, page: int, n_sm: int,
                 plan: PagedPlan) -> int:
    """Splits of each sequence's tokens over CTAs, from what the host knows
    without a sync: as many as fill one wave of the card's ``n_sm`` SMs
    with the ``B * Hkv * chunks * vchunks`` cells of ``plan``; at most
    ``PAGED_MAX_SPLITS`` (one cluster), and no more than the table's ``NP``
    pages (a page a split) and its ``NP * page`` tokens (two warp tiles a
    split) allow.  A wave counts as many CTAs an SM as its shared memory
    holds where that is four or more (stablelm-1.6b's 64-byte rows), else
    one: the plans with more shared memory (several heads a warp, rows of
    192 bytes, granite-20b's group) ran fastest alone on their SM on the
    H100 (``tools/k2_probe.py``, PERF.md)."""
    cells = max(1, B * Hkv * plan.chunks * plan.vchunks)
    resident = SM_SMEM // (plan.smem + 1024)
    if resident < 4:
        resident = 1
    return max(1, min(resident * n_sm // cells, PAGED_MAX_SPLITS, NP,
                      NP * page // (2 * PAGED_TILE)))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(q, k_pages, v_pages, k_scale, v_scale, block_tables, seq_lens,
           window):
    """Shapes, dtypes and devices both paths take; returns the geometry
    (B, H, D, Dv, page, Hkv, NP)."""
    if q.dim() != 3 or q.dtype not in _FLOATS:
        raise ValueError(f"q must be a (B, H, D) float32/bfloat16 tensor, "
                         f"got {tuple(q.shape)} {q.dtype}")
    if k_pages.dim() != 4 or v_pages.dim() != 4 \
            or k_pages.dtype != torch.int8 or v_pages.dtype != torch.int8:
        raise ValueError("k_pages/v_pages must be (P, page, Hkv, D) int8, "
                         f"got {tuple(k_pages.shape)} {k_pages.dtype} and "
                         f"{tuple(v_pages.shape)} {v_pages.dtype}")
    B, H, D = q.shape
    P, page, Hkv, Dk = k_pages.shape
    Dv = v_pages.shape[-1]
    if tuple(v_pages.shape[:3]) != (P, page, Hkv) or Dk != D:
        raise ValueError(f"pools {tuple(k_pages.shape)} and "
                         f"{tuple(v_pages.shape)} do not fit q {tuple(q.shape)}")
    if H % Hkv:
        raise ValueError(f"GQA heads {H} not divisible by kv heads {Hkv}")
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if tuple(t.shape) != (P,) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be ({P},) float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or block_tables.dtype != torch.int32:
        raise ValueError(f"block_tables must be ({B}, NP) int32, got "
                         f"{tuple(block_tables.shape)} {block_tables.dtype}")
    if tuple(seq_lens.shape) != (B,) or seq_lens.dtype != torch.int32:
        raise ValueError(f"seq_lens must be ({B},) int32, got "
                         f"{tuple(seq_lens.shape)} {seq_lens.dtype}")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    for t in (k_pages, v_pages, k_scale, v_scale, block_tables, seq_lens):
        if t.device != q.device:
            raise ValueError(f"operands on {t.device} and {q.device}")
    return B, H, D, Dv, page, Hkv, block_tables.shape[1]


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def paged_flash_attention_reference(
    q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
    k_scale: torch.Tensor, v_scale: torch.Tensor,
    block_tables: torch.Tensor, seq_lens: torch.Tensor, *,
    window: Optional[int] = None, scale: Optional[float] = None,
) -> torch.Tensor:
    """The same function in plain torch: a loop over the block table's
    slots with the TPU kernel's online softmax, all sequences and heads at
    once.  Returns ``(B, H, Dv)`` in q's dtype."""
    B, H, D, Dv, page, Hkv, NP = _check(q, k_pages, v_pages, k_scale,
                                        v_scale, block_tables, seq_lens,
                                        window)
    G = H // Hkv
    scale = D ** -0.5 if scale is None else scale
    dev = q.device
    qf = q.float().reshape(B, Hkv, G, D)
    ids = block_tables.clamp(min=0).long()
    lens = seq_lens.long()[:, None]
    m = torch.full((B, Hkv, G), NEG, device=dev)
    l = torch.zeros((B, Hkv, G), device=dev)
    acc = torch.zeros((B, Hkv, G, Dv), device=dev)
    for j in range(NP):
        pid = ids[:, j]
        k = k_pages[pid].float()                       # (B, page, Hkv, D)
        v = v_pages[pid].float()
        s = torch.einsum("bhgd,bthd->bhgt", qf, k) \
            * (scale * k_scale[pid])[:, None, None, None]
        kpos = j * page + torch.arange(page, device=dev)[None, :]
        mask = kpos < lens                             # (B, page)
        if window is not None:
            mask = mask & (kpos > lens - 1 - window)
        mask = mask[:, None, None, :]
        s = torch.where(mask, s, NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        p = torch.where(mask, p, 0.0)
        alpha = torch.exp(m - m_new)
        pv = torch.einsum("bhgt,bthd->bhgd", p, v) \
            * v_scale[pid][:, None, None, None]
        acc = acc * alpha[..., None] + pv
        l = l * alpha + p.sum(dim=-1)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, H, Dv).to(q.dtype)


# ---------------------------------------------------------------------------
# Wrapper
# ---------------------------------------------------------------------------

def _load_width(k_pages: torch.Tensor, v_pages: torch.Tensor, D: int,
                Dv: int) -> int:
    """Bytes per copy: the widest of 16, 8, 4 that divides both head dims
    and both pools' addresses, else 1."""
    for w in (16, 8, 4):
        if D % w == 0 and Dv % w == 0 and k_pages.data_ptr() % w == 0 \
                and v_pages.data_ptr() % w == 0:
            return w
    return 1


def shifted_rows(D: int, Dv: int, Hkv: int, aligned: bool) -> bool:
    """Whether K2 copies each K and V row as the 16-byte aligned window
    around it (the row then 0 or 8 bytes into its staged copy): rows of
    D, Dv = 8 (mod 16) bytes (h2o-danube-3-4b's 120), whose tokens' slabs
    of Hkv rows are whole 16-byte chunks (so a window never leaves its
    slab), in 16-byte aligned pools (``aligned``).  Such rows would
    otherwise take 8-byte copies, which allocate in L1."""
    return aligned and D % 16 == 8 and Dv % 16 == 8 \
        and (Hkv * D) % 16 == 0 and (Hkv * Dv) % 16 == 0


def tma_rows(D: int, Dv: int, page: int, shift: bool, vec: int) -> bool:
    """Whether K2 feeds each 32-token tile by two TMA boxes (K and V) in
    place of per-lane cp.async: 16-byte copies, pages of whole tiles (so a
    tile never crosses a page), and rows, or their 16-byte windows, of 64
    or 128 bytes (the spans of the 64- and 128-byte swizzles)."""
    row_k, row_v = (D + 8, Dv + 8) if shift else (D, Dv)
    return vec == 16 and page % PAGED_TILE == 0 and row_k in (64, 128) \
        and row_v in (64, 128)


def _launch(q, k_pages, v_pages, k_scale, v_scale, block_tables, seq_lens,
            window, scale, geometry) -> torch.Tensor:
    B, H, D, Dv, page, Hkv, NP = geometry
    shift = shifted_rows(D, Dv, Hkv, k_pages.data_ptr() % 16 == 0
                         and v_pages.data_ptr() % 16 == 0)
    vec = 16 if shift else _load_width(k_pages, v_pages, D, Dv)
    plan = paged_plan(H // Hkv, D, Dv, shift)
    if B * plan.chunks * plan.vchunks > 65535 or Hkv > 65535:
        raise ValueError(f"B = {B} x {plan.chunks} head chunks x "
                         f"{plan.vchunks} column chunks or Hkv = {Hkv} "
                         "exceeds the kernel's grid")
    for t in (q, k_pages, v_pages, k_scale, v_scale, block_tables, seq_lens):
        if not t.is_contiguous():
            raise ValueError("the kernel takes contiguous operands")
    out = torch.empty((B, H, Dv), dtype=q.dtype, device=q.device)
    if B == 0:
        return out
    index = q.device.index if q.device.index is not None \
        else torch.cuda.current_device()
    splits = paged_splits(B, Hkv, NP, page, _sm_count(index), plan)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _build.load(SOURCE, _bind).paged_flash_attn_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), block_tables.data_ptr(),
        seq_lens.data_ptr(), out.data_ptr(),
        B, H, Hkv, D, Dv, page, NP, window or 0, scale,
        int(q.dtype == torch.bfloat16),
        vec, int(shift), int(plan.vchunks == 1
                             and tma_rows(D, Dv, page, shift, vec)),
        k_pages.shape[0], plan.group, plan.ng, plan.dvc, splits, stream)
    if err != 0:
        raise RuntimeError(f"paged_flash_attention kernel launch failed: "
                           f"CUDA error {err}")
    launch_counts[NAME] = launch_counts.get(NAME, 0) + 1
    return out


def paged_flash_attention(
    q: torch.Tensor,              # (B, H, D), one decode token per sequence
    k_pages: torch.Tensor,        # (P, page, Hkv, D) int8
    v_pages: torch.Tensor,        # (P, page, Hkv, Dv) int8
    k_scale: torch.Tensor,        # (P,) fp32 per-page scales
    v_scale: torch.Tensor,        # (P,) fp32
    block_tables: torch.Tensor,   # (B, NP) int32 page ids; -1 = unmapped
    seq_lens: torch.Tensor,       # (B,) int32 tokens present per sequence
    *,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Decode attention streaming int8 KV pages through a block table.

    Token ``t`` of table slot ``j`` sits at position ``j * page + t``;
    ``kpos < seq_lens[b]`` masks ragged tails and unmapped slots, and
    ``window`` keeps ``kpos > seq_lens[b] - 1 - window``.  Returns
    ``(B, H, Dv)`` in q's dtype.  CPU operands run
    :func:`paged_flash_attention_reference`; CUDA operands launch the
    kernel.
    """
    geometry = _check(q, k_pages, v_pages, k_scale, v_scale, block_tables,
                      seq_lens, window)
    if q.device.type == "cpu":
        return paged_flash_attention_reference(
            q, k_pages, v_pages, k_scale, v_scale, block_tables, seq_lens,
            window=window, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    scale = geometry[2] ** -0.5 if scale is None else scale
    return _launch(q, k_pages, v_pages, k_scale, v_scale, block_tables,
                   seq_lens, window, scale, geometry)


# ---------------------------------------------------------------------------
# Forward flash attention (K3)
# ---------------------------------------------------------------------------

def _bind_fwd(lib: ctypes.CDLL) -> None:
    fn = lib.flash_attn_fwd_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                   + [ctypes.c_float] + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int


def fwd_route(dtype: torch.dtype, D: int, Dv: int, aligned: bool) -> str:
    """The route a K3 launch takes: ``"wgmma"`` for bf16 with D, Dv <=
    ``WGMMA_MAX_HEAD_DIM`` whose q, k and v meet TMA's address rules
    (16-byte aligned bases, ``aligned``, and row strides, so D and Dv
    multiples of 8); ``"simt"`` otherwise (fp32, larger head dims, and bf16
    TMA cannot take).  The C entry point's ``fwd_route`` is its twin and
    refuses a launch whose route differs."""
    if dtype == torch.bfloat16 and aligned and D % 8 == 0 and Dv % 8 == 0 \
            and max(D, Dv) <= WGMMA_MAX_HEAD_DIM:
        return "wgmma"
    return "simt"


def _check_fwd(q, k, v, q_positions, kv_positions, window, q_block,
               kv_block):
    """Shapes, dtypes and devices both paths take; returns
    (B, Lq, S, H, Hkv, D, Dv)."""
    if q.dim() != 4 or q.dtype not in _FLOATS:
        raise ValueError(f"q must be a (B, Lq, H, D) float32/bfloat16 "
                         f"tensor, got {tuple(q.shape)} {q.dtype}")
    B, Lq, H, D = q.shape
    if k.dim() != 4 or v.dim() != 4 or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"k and v must be (B, S, Hkv, D) {q.dtype}, got "
                         f"{tuple(k.shape)} {k.dtype} and {tuple(v.shape)} "
                         f"{v.dtype}")
    _, S, Hkv, Dk = k.shape
    Dv = v.shape[-1]
    if k.shape[0] != B or Dk != D or tuple(v.shape[:3]) != (B, S, Hkv):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"GQA heads {H} not divisible by kv heads {Hkv}")
    for name, t, shape in (("q_positions", q_positions, (B, Lq)),
                           ("kv_positions", kv_positions, (B, S))):
        if tuple(t.shape) != shape or t.dtype != torch.int32:
            raise ValueError(f"{name} must be {shape} int32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    for name, blk in (("q_block", q_block), ("kv_block", kv_block)):
        if blk is not None and blk < 1:
            raise ValueError(f"{name} must be None or >= 1, got {blk}")
    for t in (k, v, q_positions, kv_positions):
        if t.device != q.device:
            raise ValueError(f"operands on {t.device} and {q.device}")
    return B, Lq, S, H, Hkv, D, Dv


def attention_mask(q_positions, kv_positions, causal: bool,
                   window: Optional[int]) -> torch.Tensor:
    """(B, Lq, S) visibility: kv slot in use, causal, inside the window."""
    mask = (kv_positions[:, None, :] >= 0).expand(
        -1, q_positions.shape[1], -1)
    if causal:
        mask = mask & (kv_positions[:, None, :] <= q_positions[:, :, None])
    if window is not None:
        mask = mask & (kv_positions[:, None, :]
                       > q_positions[:, :, None] - window)
    return mask


def chunked_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    q_positions: torch.Tensor, kv_positions: torch.Tensor, causal: bool,
    window: Optional[int], scale: Optional[float], q_chunk: int,
    kv_chunk: int,
) -> torch.Tensor:
    """The TPU kernel's online softmax in plain torch, the model's prefill
    attention and K3's plain version: scores are produced and consumed per
    (q-chunk, kv-chunk) tile while the running max, denominator and output
    accumulator stay resident.  It scales the fp32 dot, masks logits to
    -1e30, zeroes masked probabilities, rounds them to q's dtype before
    the PV product and clamps the denominator at 1e-30; a ragged last
    chunk is sliced rather than padded (padded slots are masked out in the
    reference).  Returns ``(B, Lq, H, Dv)`` in q's dtype."""
    B, Lq, H, Dq = q.shape
    _, S, Hkv, _ = k.shape
    Dv = v.shape[-1]
    G = H // Hkv
    scale = Dq ** -0.5 if scale is None else scale
    dt = q.dtype
    qc = min(q_chunk, Lq)
    kc = max(1, min(kv_chunk, S))
    qg = q.reshape(B, Lq, Hkv, G, Dq)
    outs = []
    for q0 in range(0, Lq, qc):
        q_i = qg[:, q0:q0 + qc].float()
        qpos_i = q_positions[:, q0:q0 + qc]
        c = q_i.shape[1]
        m = torch.full((B, Hkv, G, c), NEG, device=q.device)
        l = torch.zeros((B, Hkv, G, c), device=q.device)
        acc = torch.zeros((B, Hkv, G, c, Dv), device=q.device)
        for k0 in range(0, S, kc):
            k_j = k[:, k0:k0 + kc].float()
            v_j = v[:, k0:k0 + kc].float()
            mask = attention_mask(qpos_i, kv_positions[:, k0:k0 + kc],
                                  causal, window)[:, None, None]
            s = torch.einsum("bqhgd,bkhd->bhgqk", q_i, k_j) * scale
            s = torch.where(mask, s, NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            p = torch.where(mask, p, 0.0)
            alpha = torch.exp(m - m_new)
            pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(dt).float(), v_j)
            acc = acc * alpha[..., None] + pv
            l = l * alpha + p.sum(dim=-1)
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.to(dt))               # (B, Hkv, G, c, Dv)
    out = torch.cat(outs, dim=3)              # (B, Hkv, G, Lq, Dv)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Lq, H, Dv)


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    q_positions: torch.Tensor, kv_positions: torch.Tensor,
    causal: bool = True, window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The same function in plain torch: :func:`chunked_attention` over
    kv blocks of the kernel's size (``FWD_KV_BLOCK``), all query rows at
    once.  Returns ``(B, Lq, H, Dv)`` in q's dtype."""
    _check_fwd(q, k, v, q_positions, kv_positions, window, None, None)
    return chunked_attention(
        q, k, v, q_positions=q_positions, kv_positions=kv_positions,
        causal=causal, window=window, scale=scale, q_chunk=q.shape[1],
        kv_chunk=FWD_KV_BLOCK)


def _launch_fwd(q, k, v, q_positions, kv_positions, causal, window, scale,
                geometry) -> torch.Tensor:
    B, Lq, S, H, Hkv, D, Dv = geometry
    if B * Hkv > 65535:
        raise ValueError(f"B x Hkv = {B * Hkv} exceeds the kernel's grid")
    for t in (q, k, v, q_positions, kv_positions):
        if not t.is_contiguous():
            raise ValueError("the kernel takes contiguous operands")
    out = torch.empty((B, Lq, H, Dv), dtype=q.dtype, device=q.device)
    if B == 0 or Lq == 0:
        return out
    route = fwd_route(q.dtype, D, Dv,
                      all(t.data_ptr() % 16 == 0 for t in (q, k, v)))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _build.load(FWD_SOURCE, _bind_fwd).flash_attn_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_positions.data_ptr(),
        kv_positions.data_ptr(), out.data_ptr(), B, Lq, S, H, Hkv, D, Dv,
        int(causal), window or 0, scale, int(q.dtype == torch.bfloat16),
        _ROUTE_CODES[route], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed ({route} "
                           f"route): CUDA error {err}")
    launch_counts[FWD_NAME] = launch_counts.get(FWD_NAME, 0) + 1
    rkey = f"{route} {FWD_NAME}"
    route_counts[rkey] = route_counts.get(rkey, 0) + 1
    return out


def flash_attention(
    q: torch.Tensor,              # (B, Lq, H, D)
    k: torch.Tensor,              # (B, S, Hkv, D)
    v: torch.Tensor,              # (B, S, Hkv, Dv)
    *,
    q_positions: torch.Tensor,    # (B, Lq) int32
    kv_positions: torch.Tensor,   # (B, S) int32, -1 = invalid
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    q_block: Optional[int] = None,
    kv_block: Optional[int] = None,
) -> torch.Tensor:
    """Forward flash attention with explicit positions (the counterpart of
    the reference's ``flash_attention_tpu``, same arguments).

    A kv slot is visible to a query when its position is >= 0, and
    (``causal``) not after the query's, and (``window``) greater than the
    query's minus ``window``; GQA shares each KV head among H / Hkv query
    heads.  A query that sees no slot gets 0.  Returns ``(B, Lq, H, Dv)``
    in q's dtype; q, k and v share one dtype, fp32 or bf16.

    The kernel's tiles are fixed (128 query rows on the wgmma route, 64
    on the SIMT one, 64 kv slots a step): ``q_block`` and ``kv_block`` are
    accepted and not read, as results do not depend on the blocking beyond
    rounding.  CPU operands run :func:`flash_attention_reference`; CUDA
    operands launch the kernel on the route :func:`fwd_route` gives (any
    head dims, any number of query heads per KV head).
    """
    geometry = _check_fwd(q, k, v, q_positions, kv_positions, window,
                          q_block, kv_block)
    if q.device.type == "cpu":
        return flash_attention_reference(
            q, k, v, q_positions=q_positions, kv_positions=kv_positions,
            causal=causal, window=window, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    scale = geometry[5] ** -0.5 if scale is None else scale
    return _launch_fwd(q, k, v, q_positions, kv_positions, causal, window,
                       scale, geometry)
