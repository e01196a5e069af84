"""Distributed CA-GEMM demo: the ring and all-gather schedules on 8 ranks.

Run the paper's chain-vs-broadcast comparison at cluster scale: the ring
(PE-chain analog) and all-gather (broadcast analog) schedules compute the
same product; the artifact is each schedule's wire traffic, counted by
the schedules' own transfers (``core.distributed.wire_bytes``) beside the
cost model's plan.

  PYTHONPATH=src python examples/torch_port/distributed_gemm.py              # the card
  PYTHONPATH=src python examples/torch_port/distributed_gemm.py --device cpu # CPU ranks

The 8 ranks are processes joined by ``torch.distributed`` on a (data 2,
model 4) mesh.  With 8 cards each rank has one, over NCCL; with fewer
the ranks share the cards over gloo (NCCL refuses two ranks on one card):
the panels then travel through pinned host copies while every local GEMM
runs on the card (K1).  ``--device cpu`` runs gloo ranks on the CPU.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import distributed as D
from repro_torch.core.distributed import estimate_cost
from repro_torch.kernels import ca_mmm as K
from repro_torch.launch.mesh import make_mesh_compat, rank_device, spawn_ranks
from repro_torch.models.model import resolve_device

WORLD = 8
MESH = ((2, 4), ("data", "model"))
M_, K_, N_ = 256, 512, 384
SCHEDULES = ("allgather", "ring")


def operands():
    """The reference's operands: A (256, 512), B (512, 384), fp32."""
    rng = np.random.RandomState(0)
    a = rng.randn(M_, K_).astype(np.float32)
    b = rng.randn(K_, N_).astype(np.float32)
    return a, b


def gemm_rank(rank: int, world: int, device: str) -> Dict[str, dict]:
    """One rank: each schedule's product gathered and held against numpy
    (atol 1e-3), the bytes its transfers moved by kind, their
    ``wire_traffic``, and the K1 launches it made."""
    dev = rank_device(rank, dist.get_backend(), device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    mesh = make_mesh_compat(*MESH, device=dev.type)
    a_np, b_np = operands()
    want = a_np @ b_np
    a = torch.from_numpy(a_np).to(dev)
    b = torch.from_numpy(b_np).to(dev)
    out = {}
    for sched in SCHEDULES:
        before = dict(D.wire_bytes)
        launches = sum(K.launch_counts.values())
        c = D.dist_matmul(a, b, mesh, schedule=sched)
        got = D.full_output(c, mesh).cpu().numpy()
        out[sched] = {
            "correct": bool(np.allclose(got, want, atol=1e-3)),
            "max_abs_err": float(np.abs(got - want).max()),
            "wire_bytes": {k: D.wire_bytes[k] - before[k] for k in before},
            "wire_traffic": D.wire_traffic(before),
            "k1_launches": sum(K.launch_counts.values()) - launches}
    return out


def run(device=None) -> List[Dict[str, dict]]:
    """Spawn the 8 ranks on ``device`` (``None`` is the card) and return
    each rank's :func:`gemm_rank` result, in rank order."""
    device = resolve_device(device)
    backend = "gloo"
    if device.type == "cuda":
        from repro_torch.kernels import _build

        _build.build(K.SOURCE)     # once, before the ranks load it
        if torch.cuda.device_count() >= WORLD:
            backend = "nccl"
    return spawn_ranks(gemm_rank, WORLD, (device.type,), timeout=180,
                       backend=backend)


def transport(device) -> str:
    device = resolve_device(device)
    if device.type == "cpu":
        return f"{WORLD} gloo ranks on the CPU"
    cards = torch.cuda.device_count()
    if cards >= WORLD:
        return f"{WORLD} NCCL ranks, one card each"
    return (f"{WORLD} gloo ranks sharing {cards} card(s) "
            f"({torch.cuda.get_device_name(0)}): NCCL refuses two ranks "
            f"on one card")


def main(argv: Optional[list] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' runs CPU ranks; default: the card")
    args = ap.parse_args(argv)
    print(f"# {transport(args.device)}")
    outs = run(args.device)
    dp, tp = MESH[0]
    for sched in SCHEDULES:
        rows = [o[sched] for o in outs]
        r0 = rows[0]
        model = estimate_cost(sched, M_, N_, K_, 4, dp, tp, 1)
        ok = all(r["correct"] for r in rows)
        print(f"{sched:10s} correct={ok}  "
              f"k1_launches={r0['k1_launches']}  "
              f"wire_bytes={r0['wire_bytes']}  "
              f"wire_traffic={r0['wire_traffic']:.2e}  "
              f"(model {model.comm_bytes:.2e})")
    return outs


if __name__ == "__main__":
    main()
