"""Kernel tuning (port of ``repro.tuning``): model-pruned empirical
autotuning for the K1 routes and the attention kernels.

* :mod:`.space`    — candidate generation: on the H100 the tile each K1
  route instantiates, elsewhere the I/O model's top-N,
* :mod:`.autotune` — CUDA-event timing of the candidates on the card,
* :mod:`.cache`    — persistent, versioned, atomically written JSON cache
  (``REPRO_TORCH_TUNING_CACHE``, default ``build/tuning_cache.json``),
* :mod:`.registry` — process-global resolver (cache > autotune >
  analytic) that ``core.gemm``, the serve engine, the train step and the
  ledger all dispatch through,
* :mod:`.workload` — the GEMM and attention signatures a model issues,
* :mod:`.attention` — K2's page size and K3's blocks through the same
  registry.
"""

from repro_torch.tuning.attention import (AttnConfig, AttnResolution,
                                          attn_cache_key, resolve_attention,
                                          resolve_page_size)
from repro_torch.tuning.autotune import TuneResult, autotune_gemm, time_tile
from repro_torch.tuning.cache import (SCHEMA_VERSION, CacheEntry,
                                      TuningCache, cache_key,
                                      default_cache_path, merge_caches,
                                      shape_bucket)
from repro_torch.tuning.registry import (KernelRegistry, Resolution,
                                         get_registry, reset_registry,
                                         set_registry)
from repro_torch.tuning.space import candidate_tile_configs
from repro_torch.tuning.workload import (model_attention_workloads,
                                         model_gemm_shapes,
                                         model_gemm_workloads,
                                         quantize_workloads,
                                         shard_gemm_workloads,
                                         warmup_attention, warmup_model)

__all__ = [
    "AttnConfig", "AttnResolution", "attn_cache_key", "resolve_attention",
    "resolve_page_size",
    "TuneResult", "autotune_gemm", "time_tile",
    "SCHEMA_VERSION", "CacheEntry", "TuningCache", "cache_key",
    "default_cache_path", "merge_caches", "shape_bucket",
    "KernelRegistry", "Resolution", "get_registry", "reset_registry",
    "set_registry",
    "candidate_tile_configs",
    "model_attention_workloads", "model_gemm_shapes",
    "model_gemm_workloads", "quantize_workloads", "shard_gemm_workloads",
    "warmup_attention", "warmup_model",
]
