"""Quickstart: the paper's model + kernel in five minutes, on one H100.

1. Solve the I/O-optimal tile plan for a GEMM (paper Eqs. 5-9 on the
   card's constants, ``core/hardware.H100``).
2. Run the CA-MMM kernel (K1, ``csrc/ca_gemm_program.cu``) and check it
   against a float64 product on the host.
3. Show the distributed schedule the cost model picks per mesh shape.

  PYTHONPATH=src python examples/torch_port/quickstart.py              # the card
  PYTHONPATH=src python examples/torch_port/quickstart.py --device cpu # plain path

The card is the default and the script raises without one; only
``--device cpu`` runs the kernel's plain version.
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.distributed import DistributedCost, choose_schedule
from repro_torch.core.hardware import H100, HopperTarget, dtype_name
from repro_torch.core.io_model import (TileConfig,
                                       arithmetic_intensity_ops_per_byte,
                                       io_lower_bound_elements,
                                       io_volume_elements, solve_tile_config)
from repro_torch.kernels import ca_mmm as K
from repro_torch.kernels.ops import ca_mmm_any
from repro_torch.models.model import resolve_device

SIZE = 16384
DTYPES = (torch.bfloat16, torch.float32, torch.int8)
MESHES = ((16, 16, 1), (4, 64, 1), (16, 16, 2))


def tile_table(target: HopperTarget = H100
               ) -> List[Tuple[torch.dtype, TileConfig, float, float, float]]:
    """(dtype, tile, Q bytes, lower-bound bytes, Op/B) of the m = n = k =
    16384 GEMM for each input dtype, on ``target``."""
    m = n = k = SIZE
    rows = []
    for dt in DTYPES:
        size = dt.itemsize
        t = solve_tile_config(m, n, k, dtype_in=dt, hw=target)
        q = io_volume_elements(m, n, k, t.bm, t.bn) * size
        lb = io_lower_bound_elements(m, n, k,
                                     int(0.75 * target.fast_bytes) // 4)
        ai = arithmetic_intensity_ops_per_byte(t.bm, t.bn, size)
        rows.append((dt, t, q, lb * size, ai))
    return rows


def schedules(target: HopperTarget = H100
              ) -> List[Tuple[Tuple[int, int, int], DistributedCost]]:
    """The schedule the Eq. 6 cost model picks for the bf16 m = n = k =
    16384 GEMM on each (dp, tp, pods) mesh, on ``target``."""
    return [((dp, tp, pods),
             choose_schedule(SIZE, SIZE, SIZE, 2, dp, tp, pods, hw=target))
            for dp, tp, pods in MESHES]


def gemm_check(device=None) -> Tuple[float, str]:
    """K1 on the reference's fp32 operands against a float64 product on
    the host: (max |err|, the route ``kernels/ca_mmm`` counted, or
    ``plain`` on the CPU)."""
    device = resolve_device(device)
    rng = np.random.RandomState(0)
    a_np, b_np = rng.randn(512, 384), rng.randn(384, 256)
    a = torch.tensor(a_np, dtype=torch.float32, device=device)
    b = torch.tensor(b_np, dtype=torch.float32, device=device)
    before = dict(K.route_counts)
    c = ca_mmm_any(a, b).cpu().double().numpy()
    ran = [key for key, v in K.route_counts.items() if v != before.get(key)]
    want = a.cpu().double().numpy() @ b.cpu().double().numpy()
    err = float(np.abs(c - want).max())
    return err, ", ".join(ran) if ran else "plain"


def main(argv: Optional[list] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain version; default: the card")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # --- 1. the model ----------------------------------------------------
    for dt, t, q, lb, ai in tile_table():
        print(f"{dtype_name(dt):9s} tile=({t.bm:4d},{t.bn:4d},{t.bk:4d})  "
              f"fast={t.vmem_bytes/2**20:5.1f}MiB  AI={ai:6.0f} Op/B  "
              f"Q={q/1e9:6.1f} GB  (lower bound {lb/1e9:.1f} GB)")

    # --- 2. the kernel (validated against a float64 product) -------------
    err, route = gemm_check(device)
    print(f"\nCA-MMM (K1 route: {route}) vs float64 host product: "
          f"max|err| = {err:.2e}")

    # --- 3. the distributed schedule --------------------------------------
    print("\nschedule chosen by the Eq. 6 cost model (m=n=k=16384, bf16):")
    for (dp, tp, pods), c in schedules():
        print(f"  mesh dp={dp:3d} tp={tp:3d} pods={pods}:  {c.schedule:10s}"
              f"  comm={c.comm_bytes/1e6:8.1f} MB/dev  "
              f"t={c.time_s*1e3:.2f} ms")


if __name__ == "__main__":
    main()
