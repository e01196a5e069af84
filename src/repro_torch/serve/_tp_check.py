"""End-to-end check of the tensor-parallel decode step on CPU ranks (port
of ``repro/serve/_tp_check.py``): spawns ``world`` gloo ranks (default
8), each running every check; a line is OK when it holds on every rank.

Usage: python -m repro_torch.serve._tp_check [world]
Prints "OK ..." lines; exits nonzero on a mismatch.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import List

import numpy as np
import torch

from repro_torch.core._dist_check import Line, merge, report


def _maxerr(y, y_ref) -> float:
    return float((y.float() - y_ref.float()).abs().max())


def _checks(rank: int, world: int) -> List[Line]:
    from repro_torch.core import distributed as dist
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.obs.ledger import GemmLedger, reset_ledger, set_ledger
    from repro_torch.quant.scales import quantize
    from repro_torch.serve import tp

    out: List[Line] = []
    cfg = tp.TpDecodeConfig(d_model=64, n_heads=4, d_ff=128)
    mesh = make_mesh_compat((2, world // 2), ("data", "model"), device="cpu")
    params = tp.init_tp_params(cfg, seed=0, device="cpu")
    B, T = 4, 3

    # Dense parity: T decode steps with a growing KV cache, the TP step
    # against the single-process oracle.
    placed = tp.place_tp_params(params, cfg, mesh)
    rng = np.random.RandomState(1)
    xs = [torch.tensor(rng.randn(B, cfg.d_model) * 0.1, dtype=torch.float32)
          for _ in range(T)]
    kv = kv_ref = None
    err = 0.0
    for x in xs:
        y, kv = tp.tp_decode_step(placed, x, kv, cfg, mesh)
        y_ref, kv_ref = tp.tp_decode_reference(params, x, kv_ref, cfg)
        err = max(err, _maxerr(y, y_ref))
    out.append(("tp-decode dense parity", err < 1e-3,
                f"maxerr={err:.2e} T={T}"))
    shape = tuple(kv[0].shape)
    out.append(("tp-decode kv shape",
                shape == (B, T, cfg.n_heads, cfg.head_dim), str(shape)))

    # int8w parity: every projection weight quantized per channel, riding
    # the ring with its scales.
    qparams = {k: (quantize(v, axis=-2, block=0) if v.dim() == 2 else v)
               for k, v in params.items()}
    qplaced = tp.place_tp_params(qparams, cfg, mesh)
    kv = kv_ref = None
    err = 0.0
    for x in xs:
        y, kv = tp.tp_decode_step(qplaced, x, kv, cfg, mesh)
        y_ref, kv_ref = tp.tp_decode_reference(qparams, x, kv_ref, cfg)
        err = max(err, _maxerr(y, y_ref))
    out.append(("tp-decode int8w parity", err < 5e-3, f"maxerr={err:.2e}"))

    # w8a8: a per-tensor static act scale on the MLP projections makes
    # their activations ride the ring as int8 payload.
    act_scale = torch.tensor(0.05)
    q8params = dict(qparams)
    for name in ("mlp/w_gate", "mlp/w_up", "mlp/w_down"):
        q8params[name] = dataclasses.replace(
            qparams[name], act_scale=act_scale, act_block=0)
    q8placed = tp.place_tp_params(q8params, cfg, mesh)
    y, _ = tp.tp_decode_step(q8placed, xs[0], None, cfg, mesh)
    y_ref, _ = tp.tp_decode_reference(q8params, xs[0], None, cfg)
    err = _maxerr(y, y_ref)
    out.append(("tp-decode w8a8-ride parity", err < 5e-3,
                f"maxerr={err:.2e}"))

    # Ledger: one `dist` record per projection (7 a step: q/k/v/o,
    # gate/up/down), planned bytes equal to the cost model's and, summed
    # over the step, to the bytes the rings sent.
    led = GemmLedger(enabled=True)
    set_ledger(led)
    try:
        before = dict(dist.wire_bytes)
        tp.tp_decode_step(placed, xs[0], None, cfg, mesh)
        sent = dist.wire_traffic(before)
        recs = [r for r in led.records
                if getattr(r, "schedule", None) == "ring"]
        d, f = cfg.d_model, cfg.d_ff
        want = dist.estimate_cost("ring", B, d, d, 4, 2,
                                  world // 2).comm_bytes
        qkv = [r for r in recs if (r.m, r.n, r.k) == (B, d, d)]
        out.append(("tp-decode ledger records", len(recs) == 7,
                    f"n={len(recs)}"))
        planned = sum(r.planned_bytes for r in recs)
        out.append(("tp-decode ledger planned bytes",
                    len(qkv) == 4 and all(r.planned_bytes == want
                                          for r in qkv)
                    and sent == planned,
                    f"{[r.planned_bytes for r in qkv]} vs {want}; sent "
                    f"{sent:.0f} of {planned:.0f} planned"))
        out.append(("tp-decode ledger shapes",
                    {(r.m, r.n, r.k) for r in recs}
                    == {(B, d, d), (B, f, d), (B, d, f)}, ""))
        out.append(("tp-decode ledger sources",
                    all(r.config_source in ("analytic", "cache", "autotune")
                        for r in recs), ""))
    finally:
        reset_ledger()
    return out


def main(world: int = 8) -> int:
    from repro_torch.launch.mesh import spawn_ranks

    return report(merge(spawn_ranks(_checks, world, timeout=180)))


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 8))
