"""Attention blocking through the kernel-config registry (port of
``repro/tuning/attention.py``).

The GEMM registry's contract — cache > autotune > analytic, persistent
winners, one choke point — extends to the two attention kernels:

* ``arch="flash"`` — K3, :func:`repro_torch.kernels.flash_attn.flash_attention`;
  the tunables are the q/kv block sizes.  K3 runs the blocks its route
  instantiates (128 query rows on the wgmma route, 64 on the SIMT one, 64
  kv slots a step), so on the H100 those are the only candidates.  No
  model path calls K3; its blocking resolves but is wired into nothing.
* ``arch="paged_decode"`` — K2, the paged int8 decode kernel
  (:func:`~repro_torch.kernels.flash_attn.paged_flash_attention`); the kv
  block *is* the page size, so tuning it chooses the pool's page
  geometry, and ``q_block`` is the single decode token.

Entries live in the same :class:`~repro_torch.tuning.cache.TuningCache`
file as GEMM tiles, under keys no GEMM key can collide with (an
``attn.`` arch segment); a :class:`~repro_torch.tuning.cache.CacheEntry`
stores ``bm=q_block``, ``bn=bk=kv_block``, ``order="attn"``, as the
reference's.

Autotuning times the real kernel on the card with CUDA events (K2 on a
synthetic int8 pool for each page candidate, K3 on causal bf16 inputs);
without a card the autotune tier raises.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.hardware import HopperTarget, dtype_name
from repro_torch.tuning.cache import CacheEntry, shape_bucket

_ORDER_TAG = "attn"          # CacheEntry.order marker for attention entries
_TUNE_WARMUP = 1
_TUNE_ITERS = 3

# Page sizes the paged cache is tuned over: 16 keeps tiny-context pools
# from wasting 8x their payload, 256 caps the page a kernel step stages.
_PAGE_CANDIDATES = (16, 32, 64, 128, 256)
# The reference's flash candidates (a target that solves its blocks).
_FLASH_Q = (128, 256, 512)
_FLASH_KV = (128, 256, 512, 1024)


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    """Resolved attention blocking.  For ``paged_decode``, ``kv_block``
    is the page size and ``q_block`` is 1 (one decode token)."""

    q_block: int
    kv_block: int

    def to_entry(self, *, measured_s: float = 0.0, n_tried: int = 0,
                 source: str = "autotune") -> CacheEntry:
        return CacheEntry(bm=self.q_block, bn=self.kv_block,
                          bk=self.kv_block, order=_ORDER_TAG,
                          measured_s=measured_s, n_tried=n_tried,
                          source=source, updated_at=time.time())

    @staticmethod
    def from_entry(entry: CacheEntry) -> "AttnConfig":
        return AttnConfig(q_block=entry.bm, kv_block=entry.bn)


@dataclasses.dataclass(frozen=True)
class AttnResolution:
    config: AttnConfig
    source: str                 # "cache" | "autotune" | "analytic"
    key: str


def attn_cache_key(arch: str, *, heads: int, kv_heads: int, head_dim: int,
                   kv_dtype_str: str, seq_len: int, hw: HopperTarget) -> str:
    """The reference's key: target name, the arch under an ``attn.``
    namespace, the KV storage dtype, the head geometry, the bucketed kv
    length."""
    return (f"{hw.name}/attn.{arch}/{kv_dtype_str}/"
            f"h{heads}kv{kv_heads}d{head_dim}/s{shape_bucket(seq_len)}")


# ---------------------------------------------------------------------------
# Analytic defaults
# ---------------------------------------------------------------------------

def analytic_page_size(seq_len: int) -> int:
    """The analytic page: lane width (128) at most, no larger than about a
    quarter of the context rounded up to a power of two (ragged-tail waste
    and pool granularity), rounded down to a candidate."""
    page = min(128, max(16, shape_bucket(seq_len) // 4))
    return max(p for p in _PAGE_CANDIDATES if p <= page)


def flash_blocks(head_dim: int, v_head_dim: int, dtype) -> AttnConfig:
    """The blocks K3 runs for this head geometry and dtype: its route's
    query rows (:func:`~repro_torch.kernels.flash_attn.fwd_route`, for
    16-byte aligned operands) and its kv step."""
    from repro_torch.kernels import flash_attn as FA

    route = FA.fwd_route(dtype, head_dim, v_head_dim, True)
    return AttnConfig(q_block=FA.FWD_Q_ROWS[route],
                      kv_block=FA.FWD_KV_BLOCK)


def _analytic_config(arch: str, *, heads: int, kv_heads: int, head_dim: int,
                     seq_len: int, kv_dtype, hw: HopperTarget) -> AttnConfig:
    """The always-available floor.  Paged: :func:`analytic_page_size`.
    Flash: on a fixed-tile target K3's own blocks; elsewhere the
    reference's heuristic (grow kv then q blocks while the per-cell
    working set stays within an eighth of the fast memory)."""
    sb = shape_bucket(seq_len)
    if arch == "paged_decode":
        return AttnConfig(q_block=1, kv_block=analytic_page_size(seq_len))
    if hw.route_tiles:
        return flash_blocks(head_dim, head_dim, kv_dtype)

    budget = hw.fast_bytes // 8
    best = (min(_FLASH_Q), min(_FLASH_KV))
    for kv in _FLASH_KV:
        for qb in _FLASH_Q:
            if qb > sb and qb > min(_FLASH_Q):
                continue
            g = max(1, heads // kv_heads)
            foot = 4 * (qb * g * head_dim          # q tile (fp32 rows)
                        + 2 * 2 * kv * head_dim    # k+v tiles, dbl-buffered
                        + qb * g * kv              # score matrix
                        + qb * g * head_dim)       # accumulator
            if foot <= budget and (kv, qb) >= (best[1], best[0]):
                best = (qb, kv)
    return AttnConfig(q_block=best[0], kv_block=min(best[1], sb))


# ---------------------------------------------------------------------------
# Timing the real kernels (on the card)
# ---------------------------------------------------------------------------

def _tune_paged(heads: int, kv_heads: int, head_dim: int,
                seq_len: int) -> Tuple[AttnConfig, float, int]:
    """Time K2 across the page candidates on a synthetic int8 pool shaped
    like the bucketed workload (two sequences, every page mapped), each
    with CUDA events; returns the fastest page."""
    from repro_torch.kernels.flash_attn import paged_flash_attention
    from repro_torch.tuning.autotune import cuda_time_s

    if not torch.cuda.is_available():
        raise RuntimeError("the page-size autotune times K2 on a CUDA card")
    dev = torch.device("cuda")
    sb = max(shape_bucket(seq_len), min(_PAGE_CANDIDATES))
    gen = torch.Generator().manual_seed(0)
    B = 2
    q = torch.randn(B, heads, head_dim, generator=gen).to(
        device=dev, dtype=torch.bfloat16)
    best: Tuple[float, Optional[AttnConfig]] = (float("inf"), None)
    tried = 0
    for page in _PAGE_CANDIDATES:
        if page > sb:
            continue
        NP = sb // page
        P = B * NP
        kp, vp = (torch.randint(-127, 128, (P, page, kv_heads, head_dim),
                                generator=gen, dtype=torch.int8).to(dev)
                  for _ in range(2))
        sc = torch.full((P,), 0.02, device=dev)
        tables = torch.arange(P, dtype=torch.int32, device=dev).reshape(B, NP)
        lens = torch.full((B,), sb, dtype=torch.int32, device=dev)
        t = cuda_time_s(lambda: paged_flash_attention(
            q, kp, vp, sc, sc, tables, lens), _TUNE_WARMUP, _TUNE_ITERS)
        tried += 1
        if t < best[0]:
            best = (t, AttnConfig(q_block=1, kv_block=page))
    return best[1], best[0], tried


def _tune_flash(heads: int, kv_heads: int, head_dim: int, seq_len: int,
                dtype) -> Tuple[AttnConfig, float, int]:
    """Time K3 at its own blocks (its only candidate on the card) on
    causal inputs of the bucketed length, with CUDA events."""
    from repro_torch.kernels.flash_attn import flash_attention
    from repro_torch.tuning.autotune import cuda_time_s

    if not torch.cuda.is_available():
        raise RuntimeError("the flash autotune times K3 on a CUDA card")
    dev = torch.device("cuda")
    cfg = flash_blocks(head_dim, head_dim, dtype)
    sb = max(shape_bucket(seq_len), cfg.q_block)
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, sb, h, head_dim, generator=gen).to(
        device=dev, dtype=dtype) for h in (heads, kv_heads, kv_heads))
    pos = torch.arange(sb, dtype=torch.int32, device=dev)[None, :]
    t = cuda_time_s(lambda: flash_attention(
        q, k, v, q_positions=pos, kv_positions=pos, causal=True,
        q_block=cfg.q_block, kv_block=cfg.kv_block),
        _TUNE_WARMUP, _TUNE_ITERS)
    return cfg, t, 1


# ---------------------------------------------------------------------------
# Resolution (the registry port)
# ---------------------------------------------------------------------------

def _attn_memo(registry) -> Dict[str, AttnResolution]:
    # Lives on the registry instance so set_registry(None) drops attention
    # memos together with GEMM ones.
    return registry.__dict__.setdefault("_attn_mem", {})


def resolve_attention(arch: str, *, heads: int, kv_heads: int, head_dim: int,
                      seq_len: int, kv_dtype=torch.bfloat16,
                      hw: Optional[HopperTarget] = None,
                      registry=None) -> AttnResolution:
    """Resolve attention blocking with the registry's precedence.

    1. cache (in-memory memo, then the persistent tuning-cache file);
    2. autotune when the registry has it enabled — times the real kernel
       on the card and persists the winner;
    3. the analytic default.
    """
    from repro_torch.obs.metrics import get_metrics
    from repro_torch.tuning.registry import get_registry

    registry = registry or get_registry()
    hw = hw or registry.hw
    kv_dtype_str = dtype_name(kv_dtype)
    key = attn_cache_key(arch, heads=heads, kv_heads=kv_heads,
                         head_dim=head_dim, kv_dtype_str=kv_dtype_str,
                         seq_len=seq_len, hw=hw)
    memo = _attn_memo(registry)
    hit = memo.get(key)
    if hit is not None:
        registry.stats["cache"] += 1
        get_metrics().counter(
            "tuning.cache_hit_total",
            "Registry resolutions served from cache").labels(
                tier="memory").inc()
        return hit

    entry = registry.cache.get(key)
    if entry is not None and entry.order == _ORDER_TAG:
        res = AttnResolution(AttnConfig.from_entry(entry), "cache", key)
        memo[key] = res
        registry.stats["cache"] += 1
        get_metrics().counter(
            "tuning.cache_hit_total",
            "Registry resolutions served from cache").labels(
                tier="persistent").inc()
        return res

    if registry.autotune_enabled:
        if arch == "paged_decode":
            cfg, measured, tried = _tune_paged(heads, kv_heads, head_dim,
                                               seq_len)
        else:
            cfg, measured, tried = _tune_flash(heads, kv_heads, head_dim,
                                               seq_len, kv_dtype)
        registry.cache.put(key, cfg.to_entry(measured_s=measured,
                                             n_tried=tried))
        res = AttnResolution(cfg, "autotune", key)
        memo[key] = res
        registry.stats["autotune"] += 1
        get_metrics().counter(
            "tuning.autotune_total",
            "Resolutions answered by a fresh autotune run").inc()
        return res

    cfg = _analytic_config(arch, heads=heads, kv_heads=kv_heads,
                           head_dim=head_dim, seq_len=seq_len,
                           kv_dtype=kv_dtype, hw=hw)
    res = AttnResolution(cfg, "analytic", key)
    memo[key] = res
    registry.stats["analytic"] += 1
    get_metrics().counter(
        "tuning.solver_fallback_total",
        "Resolutions answered by the analytic model").labels(
            tier="attn").inc()
    return res


def resolve_page_size(*, heads: int, kv_heads: int, head_dim: int,
                      seq_len: int, hw: Optional[HopperTarget] = None,
                      registry=None) -> AttnResolution:
    """The serve engine's pool-construction query: the ``paged_decode``
    resolution whose ``kv_block`` is the page size."""
    return resolve_attention("paged_decode", heads=heads, kv_heads=kv_heads,
                             head_dim=head_dim, seq_len=seq_len,
                             kv_dtype=torch.int8, hw=hw, registry=registry)
