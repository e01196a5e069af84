"""Every model input's stand-in and placement (port of
``repro/launch/specs.py``), per (arch x shape x step kind), with no
allocation.

A stand-in is a :class:`~repro_torch.sharding.rules.ShapeDtypeStruct`
(global shape and dtype, the reference's ``jax.ShapeDtypeStruct``); a placement is a
:class:`~repro_torch.sharding.rules.NamedSharding` on the mesh (a named
``DeviceMesh`` or an :class:`~repro_torch.launch.mesh.AbstractMesh`),
whose ``shard_shape`` is each leaf's rank-local shape.  The cache's
stand-ins come from ``models.model.make_cache`` on the meta device.
Trees mirror the reference's: flat dicts for batches and parameters,
``{"layers": {...}, "shared": {...}}`` for caches, and
``train.step.TrainState`` / ``optim.adamw.AdamWState`` for the train
state.  The modality frontends of the vlm and audio archs take
precomputed ``embeds``, as in the reference.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.mesh import axis_sizes, batch_axes
from repro_torch.sharding.rules import NamedSharding, ShapeDtypeStruct


def _sds(shape, dtype) -> ShapeDtypeStruct:
    return ShapeDtypeStruct(tuple(int(s) for s in shape), dtype)


def _batch_spec(mesh, B: int) -> Tuple[Optional[Tuple[str, ...]], int]:
    axes = batch_axes(mesh)
    sizes = axis_sizes(mesh)
    total = 1
    for a in axes:
        total *= sizes[a]
    if axes and B % total == 0 and B >= total:
        return axes, total
    return None, 1


def _placed(mesh, specs: Dict[str, tuple]) -> Dict[str, NamedSharding]:
    return {k: NamedSharding(mesh, s) for k, s in specs.items()}


def _stream_inputs(cfg: ModelConfig, B: int, L: int, mesh):
    """The tokens (or embeds) of ``B`` sequences of ``L`` positions."""
    baxes, _ = _batch_spec(mesh, B)
    if cfg.frontend == "tokens":
        return ({"tokens": _sds((B, L), torch.int32)},
                {"tokens": (baxes, None)})
    return ({"embeds": _sds((B, L, cfg.d_model), cfg.dtype())},
            {"embeds": (baxes, None, None)})


def train_inputs(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """(stand-ins, shardings) of one global train batch."""
    B, L = shape.global_batch, shape.seq_len
    baxes, _ = _batch_spec(mesh, B)
    sds, specs = _stream_inputs(cfg, B, L, mesh)
    if cfg.n_codebooks > 1:
        sds["labels"] = _sds((B, L, cfg.n_codebooks), torch.int32)
        specs["labels"] = (baxes, None, None)
    else:
        sds["labels"] = _sds((B, L), torch.int32)
        specs["labels"] = (baxes, None)
    sds["mask"] = _sds((B, L), torch.float32)
    specs["mask"] = (baxes, None)
    return sds, _placed(mesh, specs)


def prefill_inputs(cfg: ModelConfig, shape: ShapeConfig, mesh):
    sds, specs = _stream_inputs(cfg, shape.global_batch, shape.seq_len, mesh)
    return sds, _placed(mesh, specs)


def decode_token_inputs(cfg: ModelConfig, shape: ShapeConfig, mesh):
    sds, specs = _stream_inputs(cfg, shape.global_batch, 1, mesh)
    return sds, _placed(mesh, specs)


def _cache_leaf_spec(key: str, shp: Tuple[int, ...], B: int,
                     cache_len: int, mesh) -> tuple:
    """Path-aware spec of one cache leaf.

    Dim 0 is the stacked layer (application) dim, replicated.  Dim 1 is
    batch: over the batch axes when divisible; at batch 1 (long_500k) the
    sequence dim shards over ``data`` instead (sequence parallelism).
    The head or feature dim shards over ``model`` when divisible, heads
    first, then the head dim (qwen2-vl's 8 KV heads on a 16-way axis
    shard head_dim 128)."""
    baxes, btotal = _batch_spec(mesh, B)
    sizes = axis_sizes(mesh)
    dsize = sizes.get("data", 1)
    msize = sizes.get("model", 1)
    entries: list = [None] * len(shp)
    batch_sharded = bool(baxes) and shp[1] == B and B % btotal == 0
    if batch_sharded:
        entries[1] = baxes
    # the sequence dim (k/v/pos/c/k_rope caches have it at dim 2)
    seq_dim = 2 if len(shp) > 2 and shp[2] == cache_len else None
    if not batch_sharded and seq_dim is not None and dsize > 1 \
            and cache_len % dsize == 0:
        entries[seq_dim] = "data"
    if msize > 1 and key != "pos":
        if key in ("k", "v"):
            cand = [3, 4] if len(shp) == 5 else [len(shp) - 1]
        elif key == "ssm":
            cand = [2, 3]                # (L, B, H, P, N): heads, head_dim
        elif key in ("conv", "c", "k_rope"):
            cand = [3]                   # channels; lora / rope features
        else:
            cand = [len(shp) - 1]
        for i in cand:
            if i < len(shp) and entries[i] is None and i != seq_dim \
                    and i != 1 and shp[i] % msize == 0 and shp[i] >= msize:
                entries[i] = "model"
                break
    return tuple(entries)


def cache_inputs(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """Stand-ins and shardings of the decode cache tree."""
    from repro_torch.models import attention as A
    from repro_torch.models import model as M

    B, S = shape.global_batch, shape.seq_len
    cache = M.make_cache(cfg, B, S, cfg.dtype(), device="meta")
    C = A.cache_len_for(cfg, S)
    sds, shardings = {}, {}
    for group, leaves in cache.items():
        sds[group] = {k: _sds(t.shape, t.dtype) for k, t in leaves.items()}
        shardings[group] = {
            k: NamedSharding(mesh, _cache_leaf_spec(k, tuple(t.shape), B, C,
                                                    mesh))
            for k, t in leaves.items()}
    return sds, shardings


def param_like_sds(defs, dtype=torch.float32) -> Dict[str, ShapeDtypeStruct]:
    return {k: _sds(d.shape, dtype) for k, d in defs.items()}


def state_inputs(cfg: ModelConfig, mesh, *, fsdp: bool = True):
    """TrainState stand-ins and shardings: fp32 masters and both AdamW
    moments under the parameters' specs (FSDP over the batch axes by
    default), the step and the update count replicated."""
    from repro_torch.models.model import model_defs
    from repro_torch.optim import adamw
    from repro_torch.sharding.rules import pspecs_for_defs
    from repro_torch.train import step as train_mod

    defs = model_defs(cfg)
    pspecs = pspecs_for_defs(defs, mesh, fsdp=fsdp,
                             fsdp_axes=batch_axes(mesh))
    params_sds = param_like_sds(defs)
    params_sh = _placed(mesh, pspecs)
    scalar = _sds((), torch.int32)
    rep = NamedSharding(mesh, ())
    state_sds = train_mod.TrainState(
        step=scalar, params=params_sds,
        opt=adamw.AdamWState(count=scalar, m=dict(params_sds),
                             v=dict(params_sds)))
    state_sh = train_mod.TrainState(
        step=rep, params=params_sh,
        opt=adamw.AdamWState(count=rep, m=dict(params_sh),
                             v=dict(params_sh)))
    return state_sds, state_sh


def serve_param_inputs(cfg: ModelConfig, mesh, *, fsdp: bool = False):
    """Serving weights: every leaf in the compute dtype, as the
    reference's stand-ins, TP-sharded (FSDP only when they do not
    fit)."""
    from repro_torch.models.model import model_defs
    from repro_torch.sharding.rules import pspecs_for_defs

    defs = model_defs(cfg)
    pspecs = pspecs_for_defs(defs, mesh, fsdp=fsdp,
                             fsdp_axes=batch_axes(mesh))
    return param_like_sds(defs, cfg.dtype()), _placed(mesh, pspecs)


def _walk(tree, prefix: str = ""):
    """``(path, leaf)`` pairs, paths joined by ``/`` (the checkpoint's
    keys): dicts in sorted key order, the state's NamedTuples by field."""
    if isinstance(tree, (ShapeDtypeStruct, NamedSharding)):
        yield prefix, tree
        return
    if isinstance(tree, dict):
        kids = sorted(tree.items())
    else:
        kids = zip(tree._fields, tree)
    for k, v in kids:
        yield from _walk(v, f"{prefix}/{k}" if prefix else str(k))


def leaves(sds, shardings):
    """``(path, stand-in, sharding)`` of every leaf of a stand-in tree
    and its sharding tree."""
    placed = dict(_walk(shardings))
    return [(k, s, placed[k]) for k, s in _walk(sds)]


def local_bytes(sds, shardings) -> int:
    """The rank-local bytes of a tree: each leaf's shard shape at its
    dtype's itemsize."""
    total = 0
    for _, s, h in leaves(sds, shardings):
        total += math.prod(h.shard_shape(s.shape)) * s.dtype.itemsize
    return total
