"""Tensor-parallel decode step served through ``dist_matmul`` (port of
``repro/serve/tp.py``).

One transformer decode block whose wq/wk/wv/wo and MLP projections all
dispatch through :func:`repro_torch.core.distributed.dist_matmul` (the
paper's PE-chain ring, each step's local GEMM on K1 at the registry's
tile, every dispatch in the GEMM ledger), with weights placed under
``sharding/rules.py``'s specs.  Weights may be int8
:class:`~repro_torch.quant.QTensor` s (int8w, or w8a8 with a per-tensor
static act scale), whose payloads ride the ring with their scales.

Each rank keeps the residual stream ``x`` (B, d) whole; a projection's
output comes back sharded (dp rows, tp features).  The q/k/v features a
rank holds are whole heads (``n_heads`` divides by tp), so attention over
the KV history runs on the rank's own rows and heads with no
communication, and its output is already the (dp, tp) layout the wo ring
consumes; the same holds for the GLU's gate·up product feeding w_down.
The wo and w_down outputs are gathered whole (:func:`~repro_torch.core.
distributed.full_output`) for the residual add and the next norm.  The
KV history is a ``DTensor`` (B, T, heads, head_dim) sharded over (dp
rows, tp heads).

Held against :func:`tp_decode_reference` (one process, plain products)
and the reference's own ``tp_decode_step`` by ``serve/_tp_check.py`` and
``tests/test_torch_serve_tp.py``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.distributed import (dist_matmul, full_output,
                                          placements_for)
from repro_torch.models import common as cm
from repro_torch.models.common import Defs, ParamDef, rms_norm
from repro_torch.quant.calibrate import active_calibration
from repro_torch.quant.scales import QTensor, fake_quant_activation
from repro_torch.sharding.rules import dist_operand_specs, pspec_for_def


@dataclasses.dataclass(frozen=True)
class TpDecodeConfig:
    """Shape of the minimal TP decode block."""

    d_model: int
    n_heads: int
    d_ff: int
    dp_axis: str = "data"
    tp_axis: str = "model"
    schedule: str = "ring"

    @property
    def head_dim(self) -> int:
        if self.d_model % self.n_heads != 0:
            raise ValueError(f"d_model={self.d_model} not divisible by "
                             f"n_heads={self.n_heads}")
        return self.d_model // self.n_heads


def tp_decode_defs(cfg: TpDecodeConfig) -> Defs:
    """ParamDefs of one decode block (logical axes per sharding rules)."""
    d, f = cfg.d_model, cfg.d_ff
    return {
        "attn/norm": ParamDef((d,), ("embed",), init="ones"),
        "attn/wq": ParamDef((d, d), ("embed", "qkv")),
        "attn/wk": ParamDef((d, d), ("embed", "qkv")),
        "attn/wv": ParamDef((d, d), ("embed", "qkv")),
        "attn/wo": ParamDef((d, d), ("qkv", "embed")),
        "mlp/norm": ParamDef((d,), ("embed",), init="ones"),
        "mlp/w_gate": ParamDef((d, f), ("embed", "mlp")),
        "mlp/w_up": ParamDef((d, f), ("embed", "mlp")),
        "mlp/w_down": ParamDef((f, d), ("mlp", "embed")),
    }


def init_tp_params(cfg: TpDecodeConfig, seed: int = 0,
                   dtype=torch.float32, device=None
                   ) -> Dict[str, torch.Tensor]:
    """Random parameters by the reference's init laws from a
    ``torch.Generator`` seeded with ``seed`` (``jax.random`` gives other
    numbers: :func:`tp_params_from_jax` takes the reference's own), on
    the card unless ``device`` says otherwise."""
    from repro_torch.models.model import resolve_device

    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    defs = tp_decode_defs(cfg)
    return {name: cm.init_one(defs[name], gen, dtype, device)
            for name in sorted(defs)}


def tp_params_from_jax(np_params: Mapping[str, object], cfg: TpDecodeConfig,
                       device=None, dtype=None) -> Dict[str, object]:
    """The reference's TP params (numpy arrays; an int8 ``QTensor`` given
    as a mapping of its fields, as ``models.model.params_from_jax`` takes
    them) as the port's, unplaced.  ``dtype`` casts the float leaves
    (default: their own)."""
    from repro_torch.models.model import qtensor_from_fields, resolve_device

    device = resolve_device(device)
    defs = tp_decode_defs(cfg)
    if set(np_params) != set(defs):
        raise ValueError(f"TP parameter keys differ: {sorted(np_params)}")
    out: Dict[str, object] = {}
    for name, arr in np_params.items():
        if isinstance(arr, Mapping):
            out[name] = qtensor_from_fields(name, arr, defs[name].shape,
                                            device)
            continue
        t = torch.from_numpy(np.array(arr, dtype=np.float32)).to(device)
        if tuple(t.shape) != defs[name].shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{defs[name].shape}")
        out[name] = t.to(dtype) if dtype is not None else t
    return out


def _whole(t) -> torch.Tensor:
    """A replicated parameter's value on this rank (a placed norm gain is
    a replicated ``DTensor``: its local tensor is the whole)."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _placed(t: torch.Tensor, mesh, spec):
    from torch.distributed.tensor import DTensor, Replicate

    full = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)
    return full.redistribute(mesh, placements_for(spec, mesh))


def place_tp_params(params: Dict[str, object], cfg: TpDecodeConfig,
                    mesh) -> Dict[str, object]:
    """Place weights as ``DTensor`` s under the TP rules' specs
    (column-parallel where the logical output axis maps to the model
    axis).  A QTensor's int8 payload takes the weight's spec; its scale
    (small, shaped (1, n) or (k/block, n), so a row-sharded spec need not
    divide it) stays replicated; ``dist_matmul`` re-shards operands on
    entry anyway.  Every rank passes the same full ``params``."""
    defs = tp_decode_defs(cfg)
    out: Dict[str, object] = {}
    for name, p in params.items():
        d = defs[name]
        spec = pspec_for_def(d.axes, d.shape, mesh)
        if isinstance(p, QTensor):
            out[name] = dataclasses.replace(
                p, data=_placed(p.data, mesh, spec),
                scale=_placed(p.scale, mesh, (None,) * p.scale.dim()))
        else:
            out[name] = _placed(p, mesh, spec)
    return out


def _proj(x, w, cfg: TpDecodeConfig, mesh):
    """One projection through the distributed ring."""
    if dist_operand_specs((None, None), tuple(w.shape), mesh,
                          dp_axis=cfg.dp_axis,
                          tp_axis=cfg.tp_axis) is None:
        raise ValueError(f"projection {tuple(w.shape)} not divisible over "
                         f"the {cfg.tp_axis} axis")
    return dist_matmul(x, w, mesh, schedule=cfg.schedule,
                       dp_axis=cfg.dp_axis, tp_axis=cfg.tp_axis,
                       out_dtype=x.dtype)


def _sharded(loc: torch.Tensor, mesh, shape, spec):
    """A rank's (dp rows, tp features/heads) block as the global DTensor
    of ``shape``."""
    from torch.distributed.tensor import DTensor

    stride = tuple(int(np.prod(shape[i + 1:])) for i in range(len(shape)))
    return DTensor.from_local(loc, mesh, placements_for(spec, mesh),
                              run_check=False, shape=torch.Size(shape),
                              stride=stride)


KVCache = Tuple[object, object]  # (K, V): (B, T, heads, head_dim) DTensors


def tp_decode_step(params: Dict[str, object], x: torch.Tensor,
                   kv: Optional[KVCache], cfg: TpDecodeConfig, mesh
                   ) -> Tuple[torch.Tensor, KVCache]:
    """One decode step for the current-token activations ``x`` (B, d),
    the same on every rank.

    Pre-norm attention (q/k/v/o projections via ``dist_matmul``, softmax
    attention over the appended KV history) and a pre-norm SwiGLU MLP,
    both with residuals.  Returns ``(y, kv')``: ``y`` (B, d) whole on
    every rank, ``kv'`` with the new token's K/V appended."""
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    B = x.shape[0]
    rows_heads = (cfg.dp_axis, None, cfg.tp_axis, None)
    rows_feats = (cfg.dp_axis, cfg.tp_axis)
    xn = rms_norm(x, _whole(params["attn/norm"]))
    q, k, v = (_proj(xn, params[f"attn/w{n}"], cfg, mesh).to_local()
               for n in "qkv")
    bl = q.shape[0]
    hl = q.shape[1] // hd                   # this rank's heads
    q = q.reshape(bl, hl, hd)
    k = k.reshape(bl, 1, hl, hd)
    v = v.reshape(bl, 1, hl, hd)
    if kv is not None:
        k = torch.cat([kv[0].to_local(), k], dim=1)
        v = torch.cat([kv[1].to_local(), v], dim=1)
    scores = torch.einsum("bhd,bthd->bht", q, k) / math.sqrt(float(hd))
    probs = torch.softmax(scores.float(), dim=-1)
    attn = torch.einsum("bht,bthd->bhd", probs.to(x.dtype), v)
    attn = _sharded(attn.reshape(bl, hl * hd), mesh, (B, d), rows_feats)
    x = x + full_output(_proj(attn, params["attn/wo"], cfg, mesh), mesh,
                        dp_axis=cfg.dp_axis, tp_axis=cfg.tp_axis)
    hn = rms_norm(x, _whole(params["mlp/norm"]))
    g = _proj(hn, params["mlp/w_gate"], cfg, mesh)
    u = _proj(hn, params["mlp/w_up"], cfg, mesh)
    f = cfg.d_ff
    hid = (torch.nn.functional.silu(g.to_local().float()).to(x.dtype)
           * u.to_local())
    hid = _sharded(hid, mesh, (B, f), rows_feats)
    x = x + full_output(_proj(hid, params["mlp/w_down"], cfg, mesh), mesh,
                        dp_axis=cfg.dp_axis, tp_axis=cfg.tp_axis)
    T = k.shape[1]
    kv = tuple(_sharded(t, mesh, (B, T, h, hd), rows_heads)
               for t in (k, v))
    return x, kv


def tp_decode_reference(params: Dict[str, object], x: torch.Tensor,
                        kv: Optional[Tuple[torch.Tensor, torch.Tensor]],
                        cfg: TpDecodeConfig
                        ) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                       torch.Tensor]]:
    """Single-process oracle: the same math with plain fp32 products on
    unplaced params (QTensor weights follow ``dist_matmul_reference``'s
    fake-quant and dequant semantics), for parity against the TP step.

    Inside an :class:`~repro_torch.quant.calibrate.ActivationCalibration`
    each quantized projection's input is recorded, as ``ca_matmul``
    records it: the w8a8 block's static act scales come from this run."""
    def proj(a, w):
        if isinstance(w, QTensor):
            cal = active_calibration()
            if cal is not None:
                cal.record(w.shape, a)
            if w.act_scale is not None:
                a = fake_quant_activation(a, w.act_scale, w.act_block)
            w = w.dequantize(a.dtype)
        return (a.float() @ w.float()).to(a.dtype)

    d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    B = x.shape[0]
    xn = rms_norm(x, params["attn/norm"])
    q = proj(xn, params["attn/wq"]).reshape(B, h, hd)
    k = proj(xn, params["attn/wk"]).reshape(B, 1, h, hd)
    v = proj(xn, params["attn/wv"]).reshape(B, 1, h, hd)
    if kv is not None:
        k = torch.cat([kv[0], k], dim=1)
        v = torch.cat([kv[1], v], dim=1)
    scores = torch.einsum("bhd,bthd->bht", q, k) / math.sqrt(float(hd))
    probs = torch.softmax(scores.float(), dim=-1)
    attn = torch.einsum("bht,bthd->bhd", probs.to(x.dtype), v)
    x = x + proj(attn.reshape(B, d), params["attn/wo"])
    hn = rms_norm(x, params["mlp/norm"])
    g = proj(hn, params["mlp/w_gate"])
    u = proj(hn, params["mlp/w_up"])
    x = x + proj(torch.nn.functional.silu(g.float()).to(x.dtype) * u,
                 params["mlp/w_down"])
    return x, (k, v)
