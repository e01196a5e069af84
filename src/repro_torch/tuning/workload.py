"""Workload shape extraction (port of ``repro/tuning/workload.py``):
which GEMM signatures a model will issue.

The serve engine and the train step warm the kernel-config registry with
these ahead of the first request or step, so no user-facing call pays
tuning (or even solver) latency.

Only the dominant dense contractions are listed (projections, FFN,
logits, expert FFNs); the cache's power-of-two shape bucketing covers the
nearby shapes.  Entries carry the ``(program_tag, layout)`` fields of the
cache key: the rms-prologue-fused GLU of the dense FFN
(``rms>glu.silu(none|none)``), the per-expert programs of the MoE path,
residual write-backs and, for training, the transposed backward layouts
with their ``dact`` variants.
"""

from __future__ import annotations

from typing import List, Tuple

from repro_torch.configs.base import ModelConfig

GemmShape = Tuple[int, int, int]  # (m, n, k) as resolved by the registry
# (m, n, k, epilogue_tag, layout) — the full registry key minus dtype/hw.
GemmWorkload = Tuple[int, int, int, str, str]


def model_gemm_shapes(cfg: ModelConfig, rows: int) -> List[GemmShape]:
    """(m, n, k) for the model's dense hot-path GEMMs at ``rows`` tokens."""
    return sorted({w[:3] for w in model_gemm_workloads(cfg, rows)})


def quantize_workloads(loads, acts: bool = False) -> List[Tuple]:
    """Rewrite forward workload entries as their int8-weight variants.

    Each ('nn'-layout) entry gains a ``dqb`` dequant stage on *every
    branch* of its program tag (a quantized GLU quantizes both the gate
    and the up weight) and an ``"int8"`` weight-dtype field — the exact
    registry key the quantized serve path resolves, so warmup plans the
    kernels that will actually run.  Backward/transposed layouts pass
    through unquantized (training differentiates dense master weights).

    ``acts=True`` emits the **w8a8** variants instead: ``dqab`` stages,
    a trailing ``"int8"`` *activation*-dtype field (the
    ``int8w_int8a`` composite key), and no rms prologue — the w8a8
    serve path normalizes before quantizing on entry, so the kernel it
    issues carries no ``rms>`` prefix.
    """
    import dataclasses as _dc

    from repro_torch.kernels.program import (NO_PROLOGUE, program_from_tag,
                                             program_tag,
                                             program_with_dequant)

    mode = "ab" if acts else "b"
    out = []
    for (m, n, k, epi, lay) in loads:
        if lay != "nn":
            out.append((m, n, k, epi, lay))
            continue
        tag = program_with_dequant(epi, mode)
        entry = (m, n, k, tag, lay, "int8")
        if acts:
            spec = _dc.replace(program_from_tag(tag), prologue=NO_PROLOGUE)
            entry = (m, n, k, program_tag(spec), lay, "int8", "int8")
        out.append(entry)
    return sorted(out)


def shard_gemm_workloads(loads, dp: int, tp: int, pods: int = 1):
    """Rewrite workload entries to their per-rank ring-step local shapes.

    A tensor-parallel serve path dispatches its projections through
    ``core.distributed.dist_matmul``, whose per-step local GEMM is keyed
    by ``(ceil(m/dp), n/tp, k/(tp·pods))``: warming the registry with the
    global shapes would plan tiles the sharded steps never issue.
    Tag, layout and quant-dtype fields pass through unchanged; entries
    whose n or k do not divide the mesh are dropped (``dist_matmul``
    refuses them too)."""
    out = set()
    pods = max(pods, 1)
    for w in loads:
        m, n, k = w[:3]
        if n % tp or k % (tp * pods):
            continue
        out.add((-(-m // dp), n // tp, k // (tp * pods)) + tuple(w[3:]))
    return sorted(out)


def model_gemm_workloads(cfg: ModelConfig, rows: int,
                         train: bool = False) -> List[GemmWorkload]:
    """Hot-path GEMM signatures with their fused-epilogue/layout variants.

    ``train=True`` adds the backward GEMMs' transposed-operand layouts for
    every forward signature (same shapes, contraction dim rotated).
    """
    from repro_torch.kernels.program import program_activation

    d, f, v = cfg.d_model, cfg.d_ff, cfg.padded_vocab
    act = getattr(cfg, "act", "silu")
    glu = "glu.silu(none|none)"
    loads = {
        (rows, d, d, "none", "nn"),     # attention / mixer projections
        (rows, d, d, "res", "nn"),      # output projection + residual
        (rows, v, d, "none", "nn"),     # logits head
    }
    if f > 0:
        if act == "silu":
            # Gate + up as one rms-prologue-fused dual-branch GLU program
            # (models/common.mlp_apply): x streamed once, norm folded.
            loads.add((rows, f, d, f"rms>{glu}", "nn"))
        else:
            loads.add((rows, f, d, f"rms>{act}", "nn"))  # FFN up + act
        loads.add((rows, d, f, "res", "nn"))            # FFN down + residual
    if cfg.moe is not None and cfg.moe.d_ff_expert:
        fe = cfg.moe.d_ff_expert
        # Routed experts: per-expert GLU + down through the registry
        # (core.gemm.ca_expert_*); m is the nominal token count — the
        # power-of-two bucket covers the capacity-buffer row counts.
        loads.add((rows, fe, d, glu, "nn"))
        loads.add((rows, d, fe, "none", "nn"))
        if cfg.moe.n_shared_experts:
            fs = cfg.moe.n_shared_experts * fe
            # Shared-expert FFN consumes the already-normalized stream
            # (the router needs it as a value), so no rms prologue here.
            loads.add((rows, fs, d, glu, "nn"))
            loads.add((rows, d, fs, "res", "nn"))
    if train:
        # dA = dC @ B^T streams B transposed; dB = A^T @ dC streams A
        # transposed — plan both layouts for every forward signature.
        # Programs with a nonlinearity additionally plan their
        # dact-prologue backward variants (dz folded into the fetch).
        for (m, n, k, epi, _lay) in list(loads):
            loads.add((m, k, n, "none", "nt"))
            loads.add((k, n, m, "none", "tn"))
            act_p = program_activation(epi)
            if act_p != "none":
                loads.add((m, k, n, f"dact.{act_p}>none", "nt"))
                loads.add((k, n, m, f"dact.{act_p}@b>none", "tn"))
    # Architectures may zero a dim out (e.g. SSM configs with d_ff=0 —
    # no dense FFN); a GEMM with an empty dim is not a GEMM.
    return sorted(w for w in loads if all(dim > 0 for dim in w[:3]))


# (arch, heads, kv_heads, head_dim, seq_len, kv_dtype_str) — the
# attention analog of GemmWorkload, resolved by tuning.attention.
AttnWorkload = Tuple[str, int, int, int, int, str]


def model_attention_workloads(cfg: ModelConfig, seq_len: int,
                              paged: bool = False) -> List[AttnWorkload]:
    """Attention signatures the model issues at context ``seq_len``.

    Always the prefill flash kernel in the serve dtype; ``paged=True``
    adds the int8 paged decode kernel (whose resolution also fixes the
    KV pool's page size — see
    :func:`repro_torch.tuning.attention.resolve_page_size`).
    """
    if cfg.attn_kind != "gqa" or cfg.n_heads <= 0:
        return []
    from repro_torch.core.hardware import dtype_name

    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    dtype_str = dtype_name(cfg.dtype())
    loads = [("flash", h, hkv, d, seq_len, dtype_str)]
    if paged:
        loads.append(("paged_decode", h, hkv, d, seq_len, "int8"))
    return sorted(loads)


def warmup_attention(cfg: ModelConfig, seq_len: int, registry=None,
                     paged: bool = False) -> dict:
    """Resolve the model's attention blockings ahead of first dispatch
    (the attention analog of :func:`warmup_model`).  Returns
    {cache_key: source}."""
    from repro_torch.tuning.attention import resolve_attention

    resolved = {}
    for (arch, h, hkv, d, s, dtype_str) in model_attention_workloads(
            cfg, seq_len, paged=paged):
        r = resolve_attention(arch, heads=h, kv_heads=hkv, head_dim=d,
                              seq_len=s, kv_dtype=dtype_str,
                              registry=registry)
        resolved[r.key] = r.source
    return resolved


def warmup_model(cfg: ModelConfig, rows_list, registry=None,
                 train: bool = False, quant=False, shard=None) -> dict:
    """Resolve every hot-path GEMM config for the given row counts.

    ``quant=True`` (or ``"w8"``) plans the int8-weight variants instead
    (dequant-fused epilogue tags, ``int8w_*`` cache keys);
    ``quant="w8a8"`` plans the static-activation variants (``dqab``
    tags, ``int8w_int8a`` keys) — in each case exactly what the
    corresponding serve engine will issue.  ``shard=(dp, tp)`` rewrites
    the shapes to their per-rank ring-step local forms
    (:func:`shard_gemm_workloads`) for a tensor-parallel engine, so the
    registry is warm for what ``dist_matmul``'s local steps resolve.
    Returns {cache_key: source} so callers can log what was tuned, served
    from cache, or fell back to the analytic model.
    """
    if quant not in (False, True, "w8", "w8a8"):
        raise ValueError(f"unknown quant policy {quant!r}")
    if registry is None:
        from repro_torch.tuning.registry import get_registry

        registry = get_registry()
    resolved = {}
    for rows in rows_list:
        if rows <= 0:
            continue
        loads = model_gemm_workloads(cfg, rows, train=train)
        if quant:
            loads = quantize_workloads(loads, acts=(quant == "w8a8"))
        if shard is not None:
            loads = shard_gemm_workloads(loads, *shard)
        resolved.update(registry.warmup(loads, dtype=cfg.dtype()))
    return resolved
