"""Decoder LM (port of ``repro/models/model.py``) for every family: the
dense, MoE, vlm and audio transformers (GQA or MLA attention; M-RoPE;
one logits head or one per codebook), the attention-free Mamba2 stack
(ssm) and zamba2's hybrid of Mamba2 layers and one weight-shared
attention block.  The input is token ids (``tokens``) or precomputed
embeddings (``embeds``).

The layers' parameters are stacked along a leading axis, as in the
reference; a Python loop over layers takes the place of ``lax.scan`` and
threads each layer's cache through prefill and decode (the hybrid's loop
runs the shared block after each full group of layers, where the
reference scans segment by segment).  Caches are stacked over layers
too: the slab KV cache, the paged int8 cache whose pool persists across
requests and is only ever written in place, or a Mamba2 layer's conv
window and SSM state (plus one slab KV cache per shared-block
application).

Serving parameters hold projection matrices and the embedding table in the
compute dtype — cast **once**, at load or init, where the reference casts
at every call (same rounding) — and norm gains in fp32, which is how the
rms chain reads them.  Projection matrices may instead be int8
:class:`~repro_torch.quant.QTensor` s (``models.common.quantize_params``):
layer indexing slices their payload and scales together.  Training keeps
fp32 masters (``init_params(..., masters=True)``) and casts them to those
same dtypes once per step (``train.step``).

In ``mode="train"`` with ``cfg.remat`` each layer runs under
``torch.utils.checkpoint`` (non-reentrant), the counterpart of the
reference's ``jax.checkpoint``: only the layer's input is kept, and the
backward recomputes the layer's forward.  The hybrid nests it as the
reference does: a checkpoint over each segment (its Mamba2 layers and the
shared block after a full group) around the per-layer ones and the
shared block's own.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch import kvcache as kvc
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import blocks as blk
from repro_torch.models import common as cm
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import Defs
from repro_torch.core.distributed import (model_index, model_max,
                                          reduce_from_model)
from repro_torch.quant.scales import QTensor
from repro_torch.sharding.rules import (batch_mean, batch_sum,
                                        recompute_contexts)


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; it raises when CUDA is absent.  Only an
    explicit ``device="cpu"`` runs the plain path on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available: pass device='cpu' "
                               "to run the plain path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _is_ssm(cfg: ModelConfig) -> bool:
    return cfg.family in ("ssm", "hybrid")


def model_defs(cfg: ModelConfig) -> Defs:
    """Every leaf of the reference's tree: the embedding table (the
    ``tokens`` frontend only), the stacked blocks, zamba2's ``shared``
    block, the final norm and the head (``(n_codebooks, d, V)`` with
    several codebooks)."""
    defs: Defs = {}
    if cfg.frontend == "tokens":
        defs.update(cm.prefix_defs(
            "embed", cm.embed_defs(cfg.padded_vocab, cfg.d_model)))
    block = blk.mamba_block_defs(cfg) if _is_ssm(cfg) \
        else blk.transformer_block_defs(cfg)
    defs.update(cm.prefix_defs("blocks", cm.stack_defs(block, cfg.n_layers)))
    if cfg.shared_attn_every:
        defs.update(cm.prefix_defs("shared", blk.shared_block_defs(cfg)))
    defs.update(cm.prefix_defs("norm_f", cm.rms_norm_def(cfg.d_model)))
    defs.update(cm.prefix_defs(
        "head", cm.unembed_defs(cfg.d_model, cfg.padded_vocab,
                                cfg.n_codebooks)))
    return defs


def n_shared_applications(cfg: ModelConfig) -> int:
    """The shared block runs after layers e-1, 2e-1, ... (full groups
    only): zamba2's 81 layers at e = 6 give 13, its last 3 layers none."""
    if not cfg.shared_attn_every:
        return 0
    return cfg.n_layers // cfg.shared_attn_every


# Serving leaves the reference reads in fp32 whatever the compute dtype:
# norm gains (the rms chain runs in fp32), the MoE router (fp32 routing
# logits) and the Mamba2 mixer's vectors and conv (read with
# ``astype(float32)``).
_FP32_LEAVES = ("/scale", "/q_norm", "/kv_norm", "/router", "/norm",
                "/a_log", "/d_skip", "/dt_bias", "/conv_w", "/conv_b")


def _leaf_dtype(name: str, cfg: ModelConfig, masters: bool) -> torch.dtype:
    if masters:
        return cfg.pdtype()
    return torch.float32 if name.endswith(_FP32_LEAVES) else cfg.dtype()


def init_params(cfg: ModelConfig, seed: int = 0, device=None, *,
                masters: bool = False) -> Dict[str, torch.Tensor]:
    """Random parameters drawn from a ``torch.Generator`` seeded with
    ``seed``, by the reference's init laws, in its param dtype: the fp32
    masters of training with ``masters=True``, else stored in the serving
    dtypes as they are drawn (a stacked leaf one layer at a time,
    :func:`~repro_torch.models.common.init_one`)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    defs = model_defs(cfg)
    return {name: cm.init_one(defs[name], gen, cfg.pdtype(), device,
                              _leaf_dtype(name, cfg, masters))
            for name in sorted(defs)}


_QFIELDS = ("data", "scale", "axis", "block", "fmt", "act_scale",
            "act_block")


def qtensor_from_fields(name: str, fields: Mapping, shape, device) -> QTensor:
    """A quantized leaf given as its fields (numpy arrays and ints), with
    its payload and scales unchanged."""
    missing = {"data", "scale"} - set(fields)
    extra = set(fields) - set(_QFIELDS)
    if missing or extra:
        raise ValueError(f"{name}: quantized leaf fields missing "
                         f"{sorted(missing)}, unexpected {sorted(extra)}")
    data = torch.from_numpy(np.array(fields["data"], dtype=np.int8))
    if tuple(data.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(data.shape)}, expected "
                         f"{shape}")
    act = fields.get("act_scale")
    f32 = lambda a: torch.from_numpy(  # noqa: E731
        np.array(a, dtype=np.float32)).to(device)
    return QTensor(data=data.to(device), scale=f32(fields["scale"]),
                   axis=int(fields.get("axis", -2)),
                   block=int(fields.get("block", 0)),
                   fmt=str(fields.get("fmt", "int8")),
                   act_scale=None if act is None else f32(act),
                   act_block=int(fields.get("act_block", 0)))


def params_from_jax(np_params: Mapping[str, object], cfg: ModelConfig,
                    device=None, *, masters: bool = False
                    ) -> Dict[str, object]:
    """The reference's flat parameter dict (numpy arrays, e.g.
    ``blocks/attn/wq`` of shape (L, d, H·Dh)) as serving parameters, or
    with ``masters=True`` as fp32 (param dtype) masters for training.  A
    quantized leaf of the reference's ``quantize_params`` comes as a
    mapping of its fields (``data``, ``scale``, ``axis``, ``block``,
    ``fmt``, ``act_scale``, ``act_block``) and becomes a
    :class:`QTensor` with the same payload and scales."""
    device = resolve_device(device)
    defs = model_defs(cfg)
    if set(np_params) != set(defs):
        raise ValueError(
            f"parameter keys differ: missing {sorted(set(defs) - set(np_params))}"
            f", unexpected {sorted(set(np_params) - set(defs))}")
    out = {}
    for name, arr in np_params.items():
        if isinstance(arr, Mapping):
            out[name] = qtensor_from_fields(name, arr, defs[name].shape,
                                             device)
            continue
        t = torch.from_numpy(np.array(arr, dtype=np.float32))
        if tuple(t.shape) != defs[name].shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{defs[name].shape}")
        out[name] = t.to(device=device,
                         dtype=_leaf_dtype(name, cfg, masters))
    return out


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------

def _stack(one: Dict[str, torch.Tensor], n: int) -> Dict[str, torch.Tensor]:
    return {k: t[None].repeat((n,) + (1,) * t.dim()) for k, t in one.items()}


def _shared_kv_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype,
                     device) -> Dict[str, torch.Tensor]:
    Dh = cfg.resolved_head_dim
    return attn.make_kv_cache(batch, cache_len, cfg.n_kv_heads, Dh, Dh,
                              dtype, device)


def make_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device=None):
    """Decode-time slab cache, stacked over layers: k/v slabs for GQA,
    the compressed ``c``/``k_rope`` slabs for MLA, a Mamba2 layer's
    ``conv`` window and fp32 ``ssm`` state; with a shared block also
    ``shared``, one k/v slab per application."""
    dtype = dtype or cfg.dtype()
    device = resolve_device(device)
    C = attn.cache_len_for(cfg, max_len)
    if not _is_ssm(cfg):
        return {"layers": _stack(attn.make_attn_cache(batch, C, cfg, dtype,
                                                      device), cfg.n_layers)}
    cache = {"layers": _stack(ssm_mod.make_ssm_cache(batch, cfg, dtype,
                                                     device), cfg.n_layers)}
    if cfg.shared_attn_every:
        cache["shared"] = _stack(_shared_kv_cache(cfg, batch, C, dtype,
                                                  device),
                                 n_shared_applications(cfg))
    return cache


def check_pageable(cfg: ModelConfig) -> None:
    """Raise KV005 unless ``cfg`` is a plain GQA transformer (the paged
    cache's one family)."""
    if cfg.attn_kind != "gqa" or _is_ssm(cfg) or cfg.shared_attn_every:
        raise ValueError(
            f"paged caches are GQA-transformer only, got "
            f"attn_kind={cfg.attn_kind!r} family={cfg.family!r} [KV005]")


def make_paged_model_cache(cfg: ModelConfig, batch: int, *, n_pages: int,
                           page_size: int, max_pages: int, device=None):
    """Paged decode cache: per-layer int8 page pools sharing one block
    table of page *ids*, stacked over layers like :func:`make_cache`'s
    slabs — page id ``p`` addresses slot ``p`` in every layer, so the host
    allocator hands out one id list per sequence regardless of depth.
    GQA-family transformers only, as in the reference: MLA compresses its
    cache instead of paging it; a Mamba2 layer's state is not addressed
    by token, and zamba2's shared block would need a pool of its own."""
    check_pageable(cfg)
    Dh = cfg.resolved_head_dim
    return {"layers": _stack(kvc.make_paged_cache(
        n_pages, page_size, cfg.n_kv_heads, Dh, Dh, batch, max_pages,
        resolve_device(device)), cfg.n_layers)}


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def _embed_in(params, batch_in, cfg: ModelConfig) -> torch.Tensor:
    if cfg.frontend == "tokens":
        return cm.embed_apply(cm.subtree(params, "embed"),
                              batch_in["tokens"], cfg.dtype())
    return batch_in["embeds"].to(cfg.dtype())


def _positions(batch_in, cfg: ModelConfig, B: int, L: int, offset: int,
               device) -> torch.Tensor:
    """``batch_in["positions"]`` if given, else ``offset + arange(L)``:
    (B, L), and (B, L, 3) with M-RoPE (all three streams the text
    position)."""
    if "positions" in batch_in:
        return batch_in["positions"]
    pos = (torch.arange(L, device=device)[None, :] + offset).expand(B, L)
    if cfg.rope_kind == "mrope":
        pos = pos[..., None].expand(B, L, 3)
    return pos


def forward(params: Dict[str, torch.Tensor],
            batch_in: Dict[str, torch.Tensor], cfg: ModelConfig, *,
            mode: str = "train", cache: Optional[Dict] = None,
            step: Optional[int] = None, max_len: Optional[int] = None,
            return_aux: bool = False):
    """Returns (logits_fp32, new_cache_or_None), and with ``return_aux``
    also the MoE load-balancing loss summed over layers (0 without MoE),
    the reference's third output.  ``batch_in`` holds ``tokens`` (B, L)
    or ``embeds`` (B, L, d), as ``cfg.frontend`` says.  Logits are
    (B, L, V), or (B, L, n_codebooks, V).  In decode the cache is updated
    in place and returned; so is a paged cache in prefill, whose per-layer
    views are written in place (restacking them would copy the whole
    pool).  A slab prefill builds its cache from the layers'."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown forward mode {mode!r}")
    if mode == "decode" and (cache is None or step is None):
        raise ValueError("decode needs a cache and a step")
    x = _embed_in(params, batch_in, cfg)
    B, L, _ = x.shape
    positions = _positions(batch_in, cfg, B, L,
                           step if mode == "decode" else 0, x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device) \
        if return_aux else None
    if _is_ssm(cfg):
        x, new_cache = _ssm_stack(params, x, cfg, positions=positions,
                                  cache=cache, step=step, mode=mode,
                                  max_len=max_len)
    else:
        x, new_cache, aux = _transformer_stack(
            params, x, cfg, positions=positions, cache=cache, step=step,
            mode=mode, max_len=max_len, aux=aux)

    x = cm.rms_norm(x, params["norm_f/scale"], cfg.norm_eps)
    logits = cm.unembed_apply(cm.subtree(params, "head"), x,
                              cfg.n_codebooks)
    if return_aux:
        return logits.float(), new_cache, aux
    return logits.float(), new_cache


def _transformer_stack(params, x, cfg: ModelConfig, *, positions, cache,
                       step, mode, max_len, aux):
    """The transformer families' layers; returns (x, new_cache, aux)."""
    layers = cache["layers"] if cache is not None else None
    remat = cfg.remat and mode == "train" and torch.is_grad_enabled()
    new_layers = []
    for i, p_i in enumerate(_layer_params(cm.subtree(params, "blocks"),
                                          cfg.n_layers)):
        if remat:
            x, aux_i = torch.utils.checkpoint.checkpoint(
                _train_layer, p_i, x, cfg, positions, use_reentrant=False,
                context_fn=recompute_contexts)
        else:
            cache_i = {k: v[i] for k, v in layers.items()} \
                if layers is not None else None
            x, c_i, aux_i = blk.transformer_block_apply(
                p_i, x, cfg, positions=positions, cache=cache_i, step=step,
                mode=mode, max_len=max_len)
            new_layers.append(c_i)
        if aux is not None:
            aux = aux + aux_i
    new_cache = None
    if mode == "decode" or (mode == "prefill" and layers is not None
                            and kvc.is_paged(layers)):
        new_cache = cache
    elif mode == "prefill":
        new_cache = {"layers": _restack(new_layers)}
    return x, new_cache, aux


def _restack(caches) -> Dict[str, torch.Tensor]:
    return {k: torch.stack([c[k] for c in caches]) for k in caches[0]}


def _ssm_stack(params, x, cfg: ModelConfig, *, positions, cache, step,
               mode, max_len):
    """The Mamba2 layers; for the hybrid, the shared block after each full
    group of ``e = cfg.shared_attn_every`` layers, on the hidden state and
    the embedding stream (application ``j`` after layer ``(j+1)·e - 1``,
    with cache slot ``j``; none after a partial last group).  Decode
    writes each layer's conv window and state, and each application's
    k/v, into the stacked cache in place; prefill builds the cache from
    the layers' and the applications'.  Returns (x, new_cache)."""
    emb0 = x
    e = cfg.shared_attn_every
    shared_p = cm.subtree(params, "shared") if e else None
    if mode == "train":
        return _ssm_train_stack(params, x, emb0, shared_p, cfg, positions), \
            None
    layers = cache["layers"] if cache is not None else None
    new_layers, new_shared = [], []
    for i, p_i in enumerate(_layer_params(cm.subtree(params, "blocks"),
                                          cfg.n_layers)):
        cache_i = {k: v[i] for k, v in layers.items()} \
            if mode == "decode" else None
        x, c_i = blk.mamba_block_apply(p_i, x, cfg, cache=cache_i, mode=mode)
        if mode == "decode":
            for k, t in c_i.items():
                layers[k][i].copy_(t)
        elif mode == "prefill":
            new_layers.append(c_i)
        if e and (i + 1) % e == 0:
            app = i // e
            c_app = {k: v[app] for k, v in cache["shared"].items()} \
                if mode == "decode" else None
            x, c2 = blk.shared_block_apply(
                shared_p, x, emb0, cfg, positions=positions, cache=c_app,
                step=step, mode=mode, max_len=max_len)
            if mode == "prefill":
                new_shared.append(c2)
    if mode != "prefill":
        return x, cache if mode == "decode" else None
    new_cache = {"layers": _restack(new_layers)}
    if e:
        B, L = x.shape[:2]
        C = attn.cache_len_for(cfg, max_len or L)
        new_cache["shared"] = _restack(new_shared) if new_shared else \
            _stack(_shared_kv_cache(cfg, B, C, x.dtype, x.device), 0)
    return x, new_cache


def _ssm_train_stack(params, x, emb0, shared_p, cfg: ModelConfig,
                     positions):
    """The Mamba2 layers (and the hybrid's shared block) in train mode.
    With ``cfg.remat`` each Mamba2 layer runs under a checkpoint, and the
    hybrid remats nested, as the reference does: an outer checkpoint over
    each segment (its ``e`` layers and, after a full group, the shared
    block), the shared block checkpointed on its own inside it, so only
    the segment boundaries stay live through the forward."""
    e = cfg.shared_attn_every
    remat = cfg.remat and torch.is_grad_enabled()
    ckpt = (lambda fn, *a: torch.utils.checkpoint.checkpoint(
        fn, *a, use_reentrant=False, context_fn=recompute_contexts)) \
        if remat else (lambda fn, *a: fn(*a))
    layer_ps = _layer_params(cm.subtree(params, "blocks"), cfg.n_layers)

    def mamba(p_i, h):
        return blk.mamba_block_apply(p_i, h, cfg, mode="train")[0]

    def shared(h):
        return blk.shared_block_apply(shared_p, h, emb0, cfg,
                                      positions=positions, mode="train")[0]

    def segment(h, lo, hi):
        for p_i in layer_ps[lo:hi]:
            h = ckpt(mamba, p_i, h)
        if e and hi - lo == e:
            h = ckpt(shared, h)
        return h

    seg = e or cfg.n_layers
    for lo in range(0, cfg.n_layers, seg):
        hi = min(lo + seg, cfg.n_layers)
        x = ckpt(segment, x, lo, hi) if e else segment(x, lo, hi)
    return x


def _layer_params(blocks, n_layers: int):
    """Each layer's parameters, as views of the stacked leaves: a tensor
    is unbound once (so a backward gathers each stacked gradient in one
    stack, where indexing would add a full-size zero-padded gradient per
    layer); a QTensor is indexed."""
    out = [{} for _ in range(n_layers)]
    for k, v in blocks.items():
        parts = v.unbind(0) if isinstance(v, torch.Tensor) \
            else [v[i] for i in range(n_layers)]
        for p_i, t in zip(out, parts):
            p_i[k] = t
    return out


def _train_layer(p_i, x, cfg: ModelConfig, positions):
    x, _, aux = blk.transformer_block_apply(p_i, x, cfg, positions=positions,
                                            mode="train")
    return x, aux


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def lm_loss(logits: torch.Tensor, labels: torch.Tensor, cfg: ModelConfig,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal LM cross-entropy over (B, L, V) fp32 logits and (B, L)
    labels, or (B, L, Cb, V) and (B, L, Cb) with codebooks: the padded
    vocab entries held at -1e9, an fp32 log-sum-exp, and the mean over
    all entries, or with ``mask`` (B, L) the sum over the masked entries
    over ``mask.sum()`` (codebooks then add up, as in the reference).  In
    a rank-local training step (``sharding.rules.batch_statistics``) the
    numerator and the denominator are sums over the global batch.
    Tensor-parallel (``core.distributed.model_parallel``) the logits are
    this rank's vocab columns; :func:`_vocab_parallel_nll` takes both
    (outside the context its sums over ``model`` are the identity)."""
    nll = _vocab_parallel_nll(logits, labels, cfg)
    if mask is not None:
        mask = mask.to(nll.dtype)
        while mask.dim() < nll.dim():
            mask = mask[..., None]
        return batch_sum((nll * mask).sum()) / torch.clamp(
            batch_sum(mask.sum()), min=1.0)
    return batch_mean(nll.mean())


def _vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor,
                        cfg: ModelConfig) -> torch.Tensor:
    """The per-token cross-entropy from this rank's vocab columns of the
    logits (columns ``index · Vl`` on): the padded entries masked on their
    global indices, this rank's log-sum-exp (one fused pass over its
    columns), the global one from the ranks' (their max, no gradient: it
    cancels; then the fp32 sum of their exponentials over ``model``), and
    the label's logit, taken on the rank that owns it and summed over
    ``model``.  The gradient of each sum passes to every rank's own
    columns.  On one rank the global log-sum-exp is the local one."""
    Vl = logits.shape[-1]
    lo = model_index() * Vl
    z = logits.float()
    if cfg.vocab_size < lo + Vl:
        pad = torch.arange(lo, lo + Vl, device=z.device) >= cfg.vocab_size
        z = z.masked_fill(pad, -1e9)
    lse = torch.logsumexp(z, dim=-1)
    top = model_max(lse).detach()
    lse = top + torch.log(reduce_from_model(torch.exp(lse - top), "loss"))
    lab = labels.long() - lo
    own = (lab >= 0) & (lab < Vl)
    picked = torch.gather(z, -1, torch.where(own, lab, 0)[..., None])[..., 0]
    z_label = reduce_from_model(torch.where(own, picked, 0.0), "loss")
    return lse - z_label


def tp_partial_leaves(cfg: ModelConfig) -> Tuple[str, ...]:
    """The leaves every ``model`` rank holds whole whose gradient each
    rank gets only in part, so a tensor-parallel step sums it over
    ``model``: the pre-FFN norm gain folded into the column-parallel
    GLU's rms prologue (dense FFN, and zamba2's shared block), MLA's
    latent leaves, which only this rank's heads read (``wkv_a``,
    ``kv_norm``; with q-LoRA ``wq_a``, ``q_norm``), and the Mamba2
    mixer's per-head vectors, of which each rank reads its heads'
    entries.  The router's gradient is whole on every rank
    (``models.moe``)."""
    defs = model_defs(cfg)
    names = ["blocks/attn/wkv_a", "blocks/attn/kv_norm", "blocks/attn/wq_a",
             "blocks/attn/q_norm", "blocks/mixer/a_log",
             "blocks/mixer/d_skip", "blocks/mixer/dt_bias",
             "shared/norm_ffn/scale"]
    if not blk._is_moe(cfg):
        names.append("blocks/norm_ffn/scale")
    return tuple(k for k in names if k in defs)


def tp_whole_leaves(cfg: ModelConfig) -> Tuple[str, ...]:
    """The leaves whose state a tensor-parallel step keeps split over
    ``model`` but whose copy each rank's forward reads whole: the Mamba2
    mixer's fused ``[z | x | B | C | dt]`` columns and ``[x | B | C]``
    conv channels, whose contiguous shards do not line up with SSD heads
    (each rank reads its heads' columns and ``B`` and ``C``,
    ``models.ssm.tp_columns``)."""
    defs = model_defs(cfg)
    return tuple(k for k in ("blocks/mixer/in_proj", "blocks/mixer/conv_w",
                             "blocks/mixer/conv_b") if k in defs)


def prefill(params, batch_in, cfg: ModelConfig,
            max_len: Optional[int] = None, cache: Optional[Dict] = None):
    """``cache`` is only passed on the paged path: prefill *inserts into*
    pre-assigned pages instead of building a fresh slab cache."""
    logits, cache = forward(params, batch_in, cfg, mode="prefill",
                            max_len=max_len, cache=cache)
    return logits, cache


def decode_step(params, token_in, cache, step: int, cfg: ModelConfig):
    """One decode step.  token_in: {"tokens": (B, 1)} or {"embeds": (B, 1,
    d)}; ``step`` is the position of the new token."""
    return forward(params, token_in, cfg, mode="decode", cache=cache,
                   step=step)
