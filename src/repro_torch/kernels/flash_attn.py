"""Paged int8 decode attention (port of
``repro/kernels/flash_attn.py:paged_flash_attention_tpu``, kernel K2).

The kernel is hand-written CUDA C++ for Hopper,
``repro_torch/csrc/paged_flash_attn.cu``: one CTA per (sequence, KV head)
holds that head's G query rows, walks the sequence's int8 pages through the
block table with the page scales folded into the running softmax (k-scale
into the logit scale, v-scale into the PV partial), and stores each output
element once.  It reads the page ids, the lengths and the scales on the
device; the wrapper never reads them to the host.

Dispatch depends only on where the operands lie: CPU tensors run the plain
torch version :func:`paged_flash_attention_reference`; CUDA tensors launch
the kernel or raise.  The kernel is built and bound by
:mod:`repro_torch.kernels._build`.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.kernels import _build

SOURCE = _build.CSRC / "paged_flash_attn.cu"
NAME = "paged_flash_attention"

# Launches of the CUDA kernel.  Only the kernel launch below adds to it;
# the plain version never does.
launch_counts: Dict[str, int] = {}

NEG = -1e30
_FLOATS = (torch.float32, torch.bfloat16)
_MAX_HEAD_DIM = 128          # the kernel's register accumulator width
_MAX_GROUP = 8               # query heads per KV head


def reset_launch_counts() -> None:
    launch_counts.clear()


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.paged_flash_attn_launch
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                   + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int


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
    """Bytes per global load: the widest of 16, 8, 4 that divides both
    head dims and both pools' addresses, else 1."""
    for w in (16, 8, 4):
        if D % w == 0 and Dv % w == 0 and k_pages.data_ptr() % w == 0 \
                and v_pages.data_ptr() % w == 0:
            return w
    return 1


def _launch(q, k_pages, v_pages, k_scale, v_scale, block_tables, seq_lens,
            window, scale, geometry) -> torch.Tensor:
    B, H, D, Dv, page, Hkv, NP = geometry
    if D > _MAX_HEAD_DIM or Dv > _MAX_HEAD_DIM or H // Hkv > _MAX_GROUP:
        raise ValueError(f"the kernel takes head dims <= {_MAX_HEAD_DIM} and "
                         f"<= {_MAX_GROUP} query heads per KV head, got "
                         f"D={D} Dv={Dv} G={H // Hkv}")
    if B > 65535:
        raise ValueError(f"B = {B} exceeds the kernel's grid")
    for t in (q, k_pages, v_pages, k_scale, v_scale, block_tables, seq_lens):
        if not t.is_contiguous():
            raise ValueError("the kernel takes contiguous operands")
    out = torch.empty((B, H, Dv), dtype=q.dtype, device=q.device)
    if B == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _build.load(SOURCE, _bind).paged_flash_attn_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), block_tables.data_ptr(),
        seq_lens.data_ptr(), out.data_ptr(),
        B, H, Hkv, D, Dv, page, NP, window or 0, scale,
        int(q.dtype == torch.bfloat16),
        _load_width(k_pages, v_pages, D, Dv), stream)
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
