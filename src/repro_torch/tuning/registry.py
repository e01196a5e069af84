"""Process-global kernel-config registry (port of
``repro/tuning/registry.py``): every GEMM resolves its tile here.

Resolution precedence (verified by ``tests/test_torch_tuning.py``):

1. **cache hit** — in-memory first, then the persistent
   :class:`repro_torch.tuning.cache.TuningCache`; no kernel is re-timed
   for a key the cache already holds.
2. **autotune** — only when enabled (constructor flag or
   ``REPRO_TORCH_AUTOTUNE=1``); the winner is written back to the
   persistent cache so the next process gets a cache hit.
3. **analytic** — on the H100 the tile the launch's route runs
   (:func:`repro_torch.tuning.space.candidate_tile_configs`); on a target
   that solves its tiles, the paper's
   :func:`~repro_torch.core.io_model.solve_tile_config`, as the
   reference.

``core.gemm``'s dispatch, the serve engine's warmup, the train step and
the ledger share it.  :func:`plan` is the dispatch path's memo: one dict
hit per launch once a signature has resolved.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Dict, Iterable, Optional, Tuple

import torch

from repro_torch.core.hardware import H100, HopperTarget, as_dtype, dtype_name
from repro_torch.core.io_model import TileConfig, solve_tile_config
from repro_torch.obs.metrics import get_metrics
from repro_torch.tuning import autotune as _autotune
from repro_torch.tuning import space as _space
from repro_torch.tuning.cache import CacheEntry, TuningCache, cache_key

_ENV_AUTOTUNE = "REPRO_TORCH_AUTOTUNE"


def _count(name: str, description: str, **labels) -> None:
    """Increment an obs counter (labeled child when labels given)."""
    c = get_metrics().counter(name, description)
    (c.labels(**labels) if labels else c).inc()


@dataclasses.dataclass(frozen=True)
class Resolution:
    """A resolved config plus where it came from."""

    config: TileConfig
    source: str                 # "cache" | "autotune" | "analytic"
    key: str


class KernelRegistry:
    """Thread-safe resolver with cache > autotune > analytic precedence."""

    def __init__(self, cache: Optional[TuningCache] = None,
                 autotune_enabled: Optional[bool] = None,
                 hw: HopperTarget = H100,
                 tuner=None):
        # The persistent cache is created lazily so merely importing the
        # registry never touches the filesystem; reads are harmless and
        # writes only happen after an autotune run.
        self._cache = cache
        if autotune_enabled is None:
            autotune_enabled = os.environ.get(_ENV_AUTOTUNE, "0") == "1"
        self.autotune_enabled = bool(autotune_enabled)
        self.hw = hw
        self._tuner = tuner or _autotune.autotune_gemm
        self._mem: Dict[str, Resolution] = {}
        # Analytic plans are exact-shape: bucketing is sound only for
        # *measured* entries (the tuner's winner transfers across a
        # bucket; a solver answer for (600,600,600) is wrong metadata —
        # and a wrong tile — for (1024,1024,1024)).
        self._analytic: Dict[tuple, Resolution] = {}
        self._lock = threading.RLock()
        self.stats = {"cache": 0, "autotune": 0, "analytic": 0}
        # The dispatch path's memo (:func:`plan`): exact signature ->
        # Resolution, so a launch pays one dict hit once it has resolved.
        self.plans: Dict[tuple, Tuple[Resolution, str]] = {}

    @property
    def cache(self) -> TuningCache:
        with self._lock:
            if self._cache is None:
                self._cache = TuningCache()
            return self._cache

    # -- resolution ----------------------------------------------------------

    def resolve_full(self, m: int, n: int, k: int, dtype=torch.bfloat16,
                     semiring: str = "plus_times",
                     hw: Optional[HopperTarget] = None,
                     epilogue: str = "none",
                     layout: str = "nn",
                     dtype_b=None,
                     dtype_a=None,
                     **tune_kwargs) -> Resolution:
        """``dtype_b`` is the weight/B-operand dtype of a mixed-precision
        (quantized) GEMM; ``dtype_a`` is the *streamed* A/activation
        dtype when it too differs from the serve dtype (the w8a8 path's
        int8 activations).  Either changes the cache key's dtype field
        to the composite form (``"int8w_bf16a"``, ``"int8w_int8a"``) and
        the budgets the analytic/space paths solve under."""
        hw = hw or self.hw
        if dtype_a is not None and dtype_b is None:
            # An int8 A stream only exists on the 'ab' dequant path,
            # which always has an int8 weight too — a lone dtype_a is a
            # caller bug that would mint an unservable key.
            raise ValueError("dtype_a requires dtype_b (w8a8 keys pair "
                             "int8 activations with int8 weights)")
        if dtype_b is not None and (
                dtype_a is not None
                or as_dtype(dtype_b) != as_dtype(dtype)):
            from repro_torch.quant.scales import quant_dtype_str

            dtype_str = quant_dtype_str(
                dtype_name(dtype_a if dtype_a is not None else dtype),
                dtype_name(dtype_b))
        else:
            dtype_str = dtype_name(dtype)
            dtype_b = None
            dtype_a = None
        key = cache_key(m, n, k, dtype_str, semiring, hw, epilogue, layout)
        exact = (m, n, k, dtype_str, semiring, hw.name, epilogue, layout)
        with self._lock:
            hit = self._mem.get(key)
            if hit is not None:
                self.stats["cache"] += 1
                _count("tuning.cache_hit_total",
                       "Registry resolutions served from cache",
                       tier="memory")
                return hit
            hit = self._analytic.get(exact)
            if hit is not None:
                self.stats["analytic"] += 1
                _count("tuning.solver_fallback_total",
                       "Resolutions answered by the analytic model",
                       tier="memo")
                return hit
            # Persistent cache (only ever holds measured results), so a
            # process that tuned yesterday serves hits today without
            # REPRO_TORCH_AUTOTUNE being set.
            entry = self.cache.get(key)
            if entry is not None:
                res = Resolution(entry.to_tile(), "cache", key)
                self._mem[key] = res
                self.stats["cache"] += 1
                _count("tuning.cache_hit_total",
                       "Registry resolutions served from cache",
                       tier="persistent")
                return res
            autotune = self.autotune_enabled
        _count("tuning.cache_miss_total",
               "Resolutions that found no cached config")

        # Tuning (kernel compiles + timed runs, possibly minutes) and the
        # analytic solve both run OUTSIDE the lock so concurrent threads
        # can keep resolving other keys.  Two threads racing on one key
        # tune twice; the writes are idempotent, so that's only waste.
        if autotune:
            if dtype_b is not None:
                tune_kwargs = dict(tune_kwargs, dtype_b=dtype_b)
            if dtype_a is not None:
                tune_kwargs = dict(tune_kwargs, dtype_a=dtype_a)
            result = self._tuner(m, n, k, dtype=dtype, semiring=semiring,
                                 hw=hw, epilogue=epilogue, layout=layout,
                                 **tune_kwargs)
            res = Resolution(result.config, "autotune", key)
            with self._lock:
                prior = self._mem.get(key)
                if prior is not None:  # lost the race: keep the first win
                    self.stats["cache"] += 1
                    _count("tuning.cache_hit_total",
                           "Registry resolutions served from cache",
                           tier="memory")
                    return prior
                self.cache.put(key, CacheEntry.from_tile(
                    result.config, measured_s=result.measured_s,
                    predicted_s=result.predicted_s, n_tried=result.n_tried))
                self._mem[key] = res
                self.stats["autotune"] += 1
                _count("tuning.autotune_total",
                       "Resolutions answered by a fresh autotune run")
                return res

        if semiring == "plus_times" and epilogue == "none" \
                and not hw.route_tiles:
            tile = solve_tile_config(m, n, k, dtype_in=dtype, hw=hw,
                                     dtype_b=dtype_b, dtype_a=dtype_a)
        else:
            # The route's tile on a fixed-tile target; elsewhere the
            # space's top candidate, which models the footprints of
            # min_plus and fused programs that the plain solver does not.
            tile = _space.candidate_tile_configs(
                m, n, k, dtype_in=dtype, hw=hw, top_n=1,
                semiring=semiring, epilogue=epilogue, dtype_b=dtype_b,
                dtype_a=dtype_a, layout=layout)[0]
        res = Resolution(tile, "analytic", key)
        with self._lock:
            self._analytic[exact] = res
            self.stats["analytic"] += 1
        _count("tuning.solver_fallback_total",
               "Resolutions answered by the analytic model", tier="solve")
        return res

    def resolve(self, m: int, n: int, k: int, dtype=torch.bfloat16,
                semiring: str = "plus_times",
                hw: Optional[HopperTarget] = None,
                epilogue: str = "none",
                layout: str = "nn",
                dtype_b=None,
                dtype_a=None,
                **tune_kwargs) -> TileConfig:
        """The everyday entry point: just the tile."""
        return self.resolve_full(m, n, k, dtype, semiring, hw,
                                 epilogue=epilogue, layout=layout,
                                 dtype_b=dtype_b, dtype_a=dtype_a,
                                 **tune_kwargs).config

    def warmup(self, shapes: Iterable[Tuple],
               dtype=torch.bfloat16,
               semiring: str = "plus_times") -> Dict[str, str]:
        """Resolve a batch of GEMM signatures ahead of first use.

        Each entry is ``(m, n, k)``, ``(m, n, k, epilogue, layout)``,
        ``(m, n, k, epilogue, layout, weight_dtype_str)`` or
        ``(m, n, k, epilogue, layout, weight_dtype_str, act_dtype_str)``
        — the longer forms pre-plan fused/transpose-streaming, quantized-
        weight and quantized-activation (w8a8) kernels under their own
        cache keys.  The serve engine calls this at startup so no request
        pays the tuning (or even solver) latency.  Returns {key: source}.
        """
        out = {}
        for entry in shapes:
            m, n, k = entry[:3]
            epilogue, layout = (entry[3], entry[4]) if len(entry) > 3 \
                else ("none", "nn")
            dtype_b = as_dtype(entry[5]) if len(entry) > 5 and entry[5] \
                else None
            dtype_a = as_dtype(entry[6]) if len(entry) > 6 and entry[6] \
                else None
            r = self.resolve_full(m, n, k, dtype, semiring,
                                  epilogue=epilogue, layout=layout,
                                  dtype_b=dtype_b, dtype_a=dtype_a)
            out[r.key] = r.source
        return out

    def clear_memory(self) -> None:
        """Drop the in-process memos (persistent cache untouched)."""
        with self._lock:
            self._mem.clear()
            self._analytic.clear()
            self.plans.clear()


# ---------------------------------------------------------------------------
# Process-global instance
# ---------------------------------------------------------------------------

_global_lock = threading.Lock()
_global: Optional[KernelRegistry] = None


def get_registry() -> KernelRegistry:
    global _global
    with _global_lock:
        if _global is None:
            _global = KernelRegistry()
        return _global


def set_registry(registry: Optional[KernelRegistry]) -> None:
    """Install (or with ``None`` reset) the process-global registry."""
    global _global
    with _global_lock:
        _global = registry


def reset_registry() -> None:
    set_registry(None)


def plan(key: tuple, m: int, n: int, k: int, dtype, make_tag,
         dtype_b=None, dtype_a=None) -> Tuple[Resolution, str]:
    """The dispatch path's resolution of an ``nn`` launch and its program
    tag: ``key`` is a tuple of the launch's shape, dtype and whatever
    fixes its tag (``make_tag()`` builds the tag on a miss), memoized on
    the global registry, so a launch pays one dict hit once its signature
    has resolved through :meth:`KernelRegistry.resolve_full`."""
    reg = _global or get_registry()
    hit = reg.plans.get(key)
    if hit is None:
        tag = make_tag()
        hit = (reg.resolve_full(m, n, k, dtype=dtype, epilogue=tag,
                                dtype_b=dtype_b, dtype_a=dtype_a), tag)
        reg.plans[key] = hit
    return hit
