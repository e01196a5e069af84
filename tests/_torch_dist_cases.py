"""Shared cases of the distributed parity tests: the inputs (numpy, from
a seed), the ``dist_matmul`` cases and the TP decode runs, read by both
sides.  ``python tests/_torch_dist_cases.py OUT.npz PART`` computes
the reference's side (``repro``, 8 forced host devices) of ``PART``
(``dm``: the dist_matmul cases, ``tp``: the TP decode runs) into
``OUT.npz``; :func:`port_dm_ranks` and :func:`port_tp_ranks` are the
port's side, one call per gloo rank."""

import os
import sys

import numpy as np

M, K, N = 64, 128, 96
MESHES = {"2d": ((2, 4), ("data", "model"), None),
          "3d": ((2, 2, 2), ("pod", "data", "model"), "pod")}
# (mesh, schedule, rows, quant, out dtype): rows "a" (64) or "ar" (37,
# ragged over dp 2); quant None, "int8w" or "w8a8" with its scale block.
CASES = (
    [("2d", s, "a", None, None)
     for s in ("allgather", "ring", "ring_unpipelined", "auto")]
    + [("3d", s, "a", None, None)
       for s in ("ring", "ring_unpipelined", "summa25d", "allgather")]
    + [("2d", "ring", "a", None, "bfloat16")]
    + [("2d", s, "ar", None, None) for s in ("ring", "allgather")]
    + [("2d", s, "ar", (q, block), None)
       for q in ("int8w", "w8a8") for block in (0, 16)
       for s in ("ring", "allgather")])
TP_DIMS = dict(d_model=64, n_heads=4, d_ff=128)
TP_B, TP_T = 4, 3
TP_ACT_SCALE = 0.05
# The reference's side runs its TP block on allgather: its ring retraces
# its shard_map at every dispatch (~2 s each on this CPU, ~13 s a step).
# Its ring is held by the dist_matmul cases; the port's TP block runs
# both schedules against these outputs.
TP_REF_SCHEDULE = "allgather"
TP_SCHEDULES = ("ring", "allgather")


def case_name(case) -> str:
    mesh, sched, rows, quant, out = case
    q = f" {quant[0]} block={quant[1]}" if quant else ""
    return f"{mesh} {sched} {rows}{q}{' ' + out if out else ''}"


def inputs():
    rng = np.random.RandomState(0)
    a = rng.randn(M, K).astype(np.float32)
    b = rng.randn(K, N).astype(np.float32)
    ar = rng.randn(37, K).astype(np.float32)
    act = np.float32(np.abs(ar).max() / 127.0)
    xs = (np.random.RandomState(1).randn(TP_T, TP_B, TP_DIMS["d_model"])
          * 0.1).astype(np.float32)
    return a, b, ar, act, xs


# ---------------------------------------------------------------------------
# The reference's side (run as a script: it forces 8 host devices)
# ---------------------------------------------------------------------------

def _reference(out_path: str, part: str) -> None:
    """``part`` "dm": the dist_matmul cases; "tp": the TP decode runs."""
    from repro.launch.mesh import make_mesh_compat

    meshes = {k: (make_mesh_compat(*v[:2]), v[2]) for k, v in MESHES.items()}
    out = _reference_dm(meshes) if part == "dm" else _reference_tp(meshes)
    np.savez(out_path, **out)


def _reference_dm(meshes):
    import dataclasses

    import jax.numpy as jnp

    from repro.core import distributed as dist
    from repro.quant import quantize

    a, b, ar, act, _ = inputs()
    rows = {"a": jnp.asarray(a), "ar": jnp.asarray(ar)}
    bj = jnp.asarray(b)
    out = {}
    quants = {}
    for block in (0, 16):
        q = quantize(bj, axis=-2, block=block)
        quants[("int8w", block)] = q
        quants[("w8a8", block)] = dataclasses.replace(
            q, act_scale=jnp.asarray(act), act_block=0)
        out[f"qdata{block}"] = np.asarray(q.data)
        out[f"qscale{block}"] = np.asarray(q.scale)
    for case in CASES:
        mesh, sched, r, quant, od = case
        m, pod = meshes[mesh]
        w = quants[quant] if quant else bj
        got = dist.dist_matmul(rows[r], w, m, schedule=sched, pod_axis=pod,
                               out_dtype=None if od is None
                               else jnp.dtype(od))
        out["dm " + case_name(case)] = np.asarray(got, np.float32)
    return out


def _reference_tp(meshes):
    """The TP decode block: dense and int8w over TP_T steps, w8a8 one
    step, with the reference's own params (saved for the port)."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro.quant import quantize
    from repro.serve import tp

    xs = inputs()[4]
    out = {}
    cfg = tp.TpDecodeConfig(**TP_DIMS, schedule=TP_REF_SCHEDULE)
    mesh2 = meshes["2d"][0]
    params = tp.init_tp_params(cfg, jax.random.PRNGKey(0))
    qparams = {k: (quantize(v, axis=-2, block=0) if v.ndim == 2 else v)
               for k, v in params.items()}
    q8params = dict(qparams)
    for name in ("mlp/w_gate", "mlp/w_up", "mlp/w_down"):
        q8params[name] = dataclasses.replace(
            qparams[name], act_scale=jnp.asarray(TP_ACT_SCALE, jnp.float32),
            act_block=0)
    for name, v in params.items():
        out[f"tp param {name}"] = np.asarray(v)
        if v.ndim == 2:
            out[f"tp qdata {name}"] = np.asarray(qparams[name].data)
            out[f"tp qscale {name}"] = np.asarray(qparams[name].scale)
    for label, p, steps in (("dense", params, TP_T), ("int8w", qparams, TP_T),
                            ("w8a8", q8params, 1)):
        placed = tp.place_tp_params(p, cfg, mesh2)
        kv = None
        for t in range(steps):
            y, kv = tp.tp_decode_step(placed, jnp.asarray(xs[t]), kv, cfg,
                                      mesh2)
            out[f"tp {label} y{t}"] = np.asarray(y, np.float32)
        out[f"tp {label} k"] = np.asarray(kv[0], np.float32)
    return out


# ---------------------------------------------------------------------------
# The port's side (one call per gloo rank)
# ---------------------------------------------------------------------------

def _port_meshes():
    from repro_torch.launch.mesh import make_mesh_compat

    return {k: (make_mesh_compat(*v[:2], device="cpu"), v[2])
            for k, v in MESHES.items()}


def port_dm_ranks(rank, world):
    """Every dist_matmul case of the reference's side on the port (full
    outputs and dtypes, every rank; the int8 weights from the port's own
    ``quantize``, whose payloads are the reference's bit for bit), then
    the fault cases."""
    import dataclasses

    import torch

    from repro_torch.core import distributed as dist
    from repro_torch.obs.ledger import GemmLedger, reset_ledger, set_ledger
    from repro_torch.quant.scales import quantize

    a, b, ar, act, _ = inputs()
    rows = {"a": torch.from_numpy(a), "ar": torch.from_numpy(ar)}
    bt = torch.from_numpy(b)
    meshes = _port_meshes()
    out = {}
    quants = {}
    for block in (0, 16):
        q = quantize(bt, axis=-2, block=block)
        quants[("int8w", block)] = q
        quants[("w8a8", block)] = dataclasses.replace(
            q, act_scale=torch.tensor(act), act_block=0)
        out[f"qdata{block}"] = q.data.numpy()
    for case in CASES:
        mesh, sched, r, quant, od = case
        m, pod = meshes[mesh]
        w = quants[quant] if quant else bt
        led = GemmLedger(enabled=True)
        set_ledger(led)
        before = dict(dist.wire_bytes)
        try:
            got = dist.dist_matmul(rows[r], w, m, schedule=sched,
                                   pod_axis=pod,
                                   out_dtype=None if od is None
                                   else getattr(torch, od))
        finally:
            reset_ledger()
        name = case_name(case)
        out["dm " + name] = dist.full_output(got, m).float().numpy()
        out["dtype " + name] = str(got.dtype)
        (rec,) = led.records
        out["wire " + name] = dict(
            sent=dist.wire_traffic(before, 2 if pod else 1),
            planned=rec.planned_bytes, schedule=rec.schedule,
            mloc=rec.config["mloc"], nloc=rec.config["nloc"], k=rec.k)
    out.update(_port_faults(meshes["2d"][0], rows["a"], bt))
    return out


def _port_faults(mesh, a, b):
    """The fault cases on every rank: an injected failure re-dispatches
    the same schedule (counted once), propagates with the policy off,
    and a fatal one always propagates; geometry errors raise DIST004."""
    from repro_torch.analyze.diagnostics import ProgramValidationError
    from repro_torch.core import distributed as dist
    from repro_torch.core.gemm import gemm_fallback
    from repro_torch.obs import get_metrics
    from repro_torch.runtime.fault import FaultPlan, InjectedKernelFailure

    def fallbacks():
        snap = get_metrics().snapshot().get("gemm.fallback_total", {})
        return snap.get("labels", {}).get("stage=dist_matmul", 0)

    def full(c):
        return dist.full_output(c, mesh).numpy()

    out = {}
    y0 = full(dist.dist_matmul(a, b, mesh, schedule="ring"))
    before = fallbacks()
    with gemm_fallback(True), FaultPlan(kernel_fail_at=(1,)) as plan:
        y1 = full(dist.dist_matmul(a, b, mesh, schedule="ring"))
    out["fault redispatch equal"] = bool(np.array_equal(y0, y1))
    out["fault injected"] = [list(e) for e in plan.injected]
    out["fault fallbacks"] = fallbacks() - before
    with gemm_fallback(False), FaultPlan(kernel_fail_at=(0,)):
        try:
            dist.dist_matmul(a, b, mesh, schedule="ring")
            out["fault policy off raises"] = False
        except InjectedKernelFailure:
            out["fault policy off raises"] = True
    with gemm_fallback(True), FaultPlan(kernel_fatal_at=(0,)):
        try:
            dist.dist_matmul(a, b, mesh, schedule="allgather")
            out["fault fatal raises"] = False
        except InjectedKernelFailure as e:
            out["fault fatal raises"] = bool(getattr(e, "fatal", False))
    codes = []
    for kw in (dict(schedule="summa25d"), dict(schedule="ring", b=b[:, :90]),
               dict(schedule="tree")):
        try:
            dist.dist_matmul(a, kw.pop("b", b), mesh, **kw)
            codes.append(None)
        except ProgramValidationError as e:
            codes.append(sorted({d.code for d in e.diagnostics}))
    out["geometry codes"] = codes
    # the group is still usable after every failure
    out["after faults equal"] = bool(np.array_equal(
        y0, full(dist.dist_matmul(a, b, mesh, schedule="ring"))))
    return out


def bad_rank(rank, world):
    """Rank 2 hands dist_matmul a weight whose k does not contract (a
    real error, before any transfer); its peers block in the ring."""
    import torch

    from repro_torch.core import distributed as dist
    from repro_torch.launch.mesh import make_mesh_compat

    mesh = make_mesh_compat((1, world), ("data", "model"), device="cpu")
    k = 64 if rank != 2 else 60
    a = torch.ones(8, 64)
    b = torch.ones(k, 32)
    dist.dist_matmul(a, b, mesh, schedule="ring")
    return rank


def slow_rank(rank, world, seconds):
    import time

    if rank == 1:
        time.sleep(seconds)
    return rank


def port_tp_ranks(rank, world, ref_path):
    """The reference's TP decode runs on the port, from the reference's
    own params, on each of TP_SCHEDULES, beside the port's oracle."""
    import torch

    from repro_torch.core import distributed as dist
    from repro_torch.quant.scales import QTensor
    from repro_torch.serve import tp

    ref = dict(np.load(ref_path))
    xs = inputs()[4]
    mesh2 = _port_meshes()["2d"][0]
    out = {}
    cfg = tp.TpDecodeConfig(**TP_DIMS)
    np_params = {}
    np_q = {}
    for name in tp.tp_decode_defs(cfg):
        np_params[name] = ref[f"tp param {name}"]
        if f"tp qdata {name}" in ref:
            np_q[name] = {"data": ref[f"tp qdata {name}"],
                          "scale": ref[f"tp qscale {name}"]}
        else:
            np_q[name] = ref[f"tp param {name}"]
    params = tp.tp_params_from_jax(np_params, cfg, device="cpu")
    qparams = tp.tp_params_from_jax(np_q, cfg, device="cpu")
    q8params = dict(qparams)
    for name in ("mlp/w_gate", "mlp/w_up", "mlp/w_down"):
        q = qparams[name]
        q8params[name] = QTensor(data=q.data, scale=q.scale, block=q.block,
                                 act_scale=torch.tensor(TP_ACT_SCALE),
                                 act_block=0)
    runs = (("dense", params, TP_T), ("int8w", qparams, TP_T),
            ("w8a8", q8params, 1))
    for sched in TP_SCHEDULES:
        c = tp.TpDecodeConfig(**TP_DIMS, schedule=sched)
        for label, p, steps in runs:
            placed = tp.place_tp_params(p, c, mesh2)
            kv = kv_ref = None
            for t in range(steps):
                x = torch.from_numpy(xs[t])
                y, kv = tp.tp_decode_step(placed, x, kv, c, mesh2)
                y_ref, kv_ref = tp.tp_decode_reference(p, x, kv_ref, c)
                out[f"{sched} tp {label} y{t}"] = y.float().numpy()
                out[f"{sched} tp {label} oracle y{t}"] = \
                    y_ref.float().numpy()
            out[f"{sched} tp {label} k"] = \
                dist._replicated(kv[0]).float().numpy()
            out[f"{sched} tp {label} k shape"] = tuple(kv[0].shape)
    return out


if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                               + os.environ.get("XLA_FLAGS", ""))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    _reference(sys.argv[1], sys.argv[2])
