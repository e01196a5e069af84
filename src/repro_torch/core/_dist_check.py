"""Self-test of the distributed GEMM schedules on CPU ranks (port of
``repro/core/_dist_check.py``): spawns ``world`` gloo ranks (default 8),
each running every check; a line is OK when it holds on every rank.

Usage: python -m repro_torch.core._dist_check [world]
Prints "OK <check> ..." lines; exits nonzero on a mismatch.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import List, Tuple

import numpy as np
import torch

Line = Tuple[str, bool, str]


def _full(c, mesh, **axes) -> np.ndarray:
    from repro_torch.core.distributed import full_output

    return full_output(c, mesh, **axes).float().numpy()


def _close(name: str, got: np.ndarray, want: np.ndarray, atol: float = 1e-3,
           rtol: float = 1e-4) -> Line:
    same = got.shape == want.shape
    ok = same and bool(np.allclose(got, want, atol=atol, rtol=rtol))
    err = f"{np.abs(got - want).max():.3e}" if same else "shape"
    return name, ok, f"maxerr={err}"


def _checks(rank: int, world: int) -> List[Line]:
    """Every check on this rank (the reference's, in its order)."""
    from repro_torch.core import distributed as dist
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.obs.ledger import GemmLedger, reset_ledger, set_ledger
    from repro_torch.quant.scales import fake_quant_activation, quantize

    torch.manual_seed(0)
    out: List[Line] = []
    rng = np.random.RandomState(0)
    m, k, n = 64, 128, 96
    mesh = make_mesh_compat((2, world // 2), ("data", "model"), device="cpu")
    a_np, b_np = rng.randn(m, k), rng.randn(k, n)
    a = torch.tensor(a_np, dtype=torch.float32)
    b = torch.tensor(b_np, dtype=torch.float32)
    want = (a @ b).numpy()
    for sched in ("allgather", "ring", "ring_unpipelined", "auto"):
        got = dist.dist_matmul(a, b, mesh, schedule=sched)
        out.append(_close(f"{sched} 2d", _full(got, mesh), want))

    # 3-D mesh (pod=2, data=2, model=world//4): the 2.5-D schedule.
    if world >= 8:
        mesh3 = make_mesh_compat((2, 2, world // 4), ("pod", "data", "model"),
                                 device="cpu")
        for sched in ("ring", "ring_unpipelined", "summa25d", "allgather"):
            got = dist.dist_matmul(a, b, mesh3, schedule=sched,
                                   pod_axis="pod")
            out.append(_close(f"{sched} 3d", _full(got, mesh3), want))

    # The oracle (DTensor's own matmul, its propagation deciding the
    # collectives) agrees too.
    got = dist.dist_matmul_reference(a, b, mesh)
    out.append(_close("dtensor-reference", _full(got, mesh), want))

    # out_dtype honoured by the schedules and the oracle.
    got = dist.dist_matmul(a, b, mesh, schedule="ring",
                           out_dtype=torch.bfloat16)
    ref = dist.dist_matmul_reference(a, b, mesh, out_dtype=torch.bfloat16)
    ok = (got.dtype == torch.bfloat16 and ref.dtype == torch.bfloat16
          and np.allclose(_full(got, mesh), _full(ref, mesh), atol=1e-3,
                          rtol=2e-2))
    out.append(("out_dtype bf16 ring+reference", ok, ""))

    # Ragged m: rows pad to a dp multiple inside dist_matmul, slice back.
    ar = torch.tensor(rng.randn(37, k), dtype=torch.float32)
    want_r = (ar @ b).numpy()
    for sched in ("ring", "allgather"):
        got = dist.dist_matmul(ar, b, mesh, schedule=sched)
        out.append(_close(f"{sched} ragged-m37", _full(got, mesh), want_r))

    # int8 weights ride the ring (per-channel and per-tile scales).
    for block in (0, 16):   # k/(tp*pods) = 32 on the 2-D mesh: 16 fits
        qb = quantize(b, axis=-2, block=block)
        want_q = (ar @ qb.dequantize()).numpy()
        for sched in ("ring", "allgather"):
            got = dist.dist_matmul(ar, qb, mesh, schedule=sched)
            out.append(_close(f"{sched} int8w block={block}",
                              _full(got, mesh), want_q, 5e-3, 1e-3))
        ref = dist.dist_matmul_reference(ar, qb, mesh)
        out.append(_close(f"reference int8w block={block}",
                          _full(ref, mesh), want_q, 5e-3, 1e-3))

    # w8a8: a per-tensor static act scale makes A ride as int8 payload.
    act_scale = torch.tensor(float(np.abs(ar.numpy()).max()) / 127.0)
    for block in (0, 16):
        qb = dataclasses.replace(quantize(b, axis=-2, block=block),
                                 act_scale=act_scale, act_block=0)
        af = fake_quant_activation(ar, act_scale, 0)
        want_q = (af @ qb.dequantize()).numpy()
        for sched in ("ring", "allgather"):
            got = dist.dist_matmul(ar, qb, mesh, schedule=sched)
            out.append(_close(f"{sched} w8a8-ride block={block}",
                              _full(got, mesh), want_q, 5e-3, 1e-3))
        ref = dist.dist_matmul_reference(ar, qb, mesh)
        out.append(_close(f"reference w8a8-ride block={block}",
                          _full(ref, mesh), want_q, 5e-3, 1e-3))

    # Ledger: one `dist` record per dispatch whose planned bytes equal the
    # cost model's and whose tile came from the registry keyed by the
    # local shape.
    # Each dispatch's counted wire bytes must equal its plan too.
    led = GemmLedger(enabled=True)
    set_ledger(led)
    try:
        sent = []
        before = dict(dist.wire_bytes)
        dist.dist_matmul(a, b, mesh, schedule="ring")
        sent.append(dist.wire_traffic(before))
        qb = dataclasses.replace(quantize(b, axis=-2, block=0),
                                 act_scale=act_scale, act_block=0)
        before = dict(dist.wire_bytes)
        dist.dist_matmul(a, qb, mesh, schedule="ring")
        sent.append(dist.wire_traffic(before))
        recs = [r for r in led.records
                if getattr(r, "schedule", None) == "ring"]
        tp = world // 2
        dense = dist.estimate_cost("ring", m, n, k, 4, 2, tp).comm_bytes
        w8a8 = dist.estimate_cost("ring", m, n, k, 1, 2, tp).comm_bytes
        ok = (len(recs) == 2
              and recs[0].planned_bytes == dense
              and recs[1].planned_bytes == w8a8
              and recs[0].dtype == "float32"
              and recs[1].dtype == "int8w_int8a"
              and recs[1].tag == "dqab"
              and recs[0].config["kstep"] == k // tp
              and sent == [dense, w8a8]
              and all(r.config_source in ("analytic", "cache", "autotune")
                      for r in recs))
        detail = (f"(bytes {recs[0].planned_bytes:.0f}/{dense:.0f}, "
                  f"{recs[1].planned_bytes:.0f}/{w8a8:.0f}; sent "
                  f"{sent[0]:.0f}, {sent[1]:.0f})"
                  if len(recs) == 2 else f"{len(recs)} records")
        out.append(("ledger dist records", ok, detail))
    finally:
        reset_ledger()

    # The ring's local steps run K1's plain version here (its kernel on
    # card operands): the ledger's record says the plain route, one local
    # GEMM a ring step.
    led = GemmLedger(enabled=True)
    set_ledger(led)
    try:
        got = dist.dist_matmul(a, b, mesh, schedule="ring")
    finally:
        reset_ledger()
    name, ok, detail = _close("ring plain-local-step", _full(got, mesh),
                              want)
    (rec,) = led.records
    out.append((name, ok and rec.mode == "plain" and rec.steps == world // 2,
                f"{detail} {rec.mode} local steps={rec.steps}"))

    # choose_schedule consumes registry-resolved local tiles: the compute
    # term comes from the roofline, not the peak rate alone.
    c = dist.choose_schedule(m, n, k, 4, 2, world // 2, use_registry=True,
                             dtype=torch.float32)
    c0 = dist.estimate_cost(c.schedule, m, n, k, 4, 2, world // 2,
                            dtype=torch.float32)
    ok = c.step_compute_s >= c0.step_compute_s > 0 or c.steps == 1
    out.append(("choose_schedule use_registry", ok,
                f"({c.schedule}, step_compute {c.step_compute_s:.3e})"))
    return out


def merge(per_rank: List[List[Line]]) -> List[Line]:
    """One line per check: OK when it held on every rank; the details of
    the first rank where it failed, else rank 0's."""
    lines = []
    for row in zip(*per_rank):
        name = row[0][0]
        if any(r[0] != name for r in row):
            raise RuntimeError(f"ranks ran different checks: {row}")
        bad = [r for r in row if not r[1]]
        lines.append((name, not bad, (bad or row)[0][2]))
    return lines


def report(lines: List[Line]) -> int:
    for name, ok, detail in lines:
        print(f"{'OK' if ok else 'FAIL'} {name}{' ' + detail if detail else ''}")
    return sum(1 for _, ok, _ in lines if not ok)


def main(world: int = 8) -> int:
    from repro_torch.launch.mesh import spawn_ranks

    return report(merge(spawn_ranks(_checks, world, timeout=180)))


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 8))
