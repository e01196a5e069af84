"""Shared cases of the distributed training parity tests, read by both
sides: the configurations, the global batch (numpy, from a seed; each
rank's rows hold another count of masked tokens), the starting masters
(the port's ``init_params``, carried to the reference), the compressed
all-reduce's per-rank gradients.

``python tests/_torch_train_dist_cases.py OUT_DIR`` computes the
reference's side (``repro``, 4 forced host devices): its single-device
``build_train_step`` on the whole batch for every case (and the
gradient its AdamW took at the first step), its
``allreduce_compressed`` under ``shard_map`` on 4 devices, and a
checkpoint its ``CheckpointManager`` writes, into ``OUT_DIR``.
:func:`port_ranks` is the port's side, one call per gloo rank."""

import os
import sys
import time

import numpy as np

ARCHS = ("stablelm-1.6b", "deepseek-v2-lite-16b")
MICROBATCHES = (1, 2)
# (name, sub-mesh of the 4 ranks' (pod 2, data 2, model 1) mesh)
MESHES = (("data2", ("data", "model")), ("pod2xdata2", None))
B, L, STEPS = 8, 16, 2
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
MODES = ("none", "bf16", "int8")
EF_ROUNDS = 3
WORLD = 4
REF_CKPT_STEP = 2
DONE = "reference.done"


def case_key(arch, mb, mesh=None):
    return f"{arch} mb{mb}" + (f" {mesh}" if mesh else "")


def small_cfg(arch, package="port"):
    if package == "port":
        from repro_torch.configs import get_reduced
    else:
        from repro.configs import get_reduced
    return get_reduced(arch)


def masters(arch):
    """The fp32 masters both sides start from: the port's seed-0 init."""
    import torch

    from repro_torch.models import model as M

    torch.manual_seed(0)
    return {k: v.numpy() for k, v in M.init_params(
        small_cfg(arch), 0, "cpu", masters=True).items()}


def batch(arch):
    """The global batch: token ids, next-token labels and a mask whose
    count of kept tokens differs from rank to rank (rows 0-1: all, 2-3:
    about 70 %, 4-5: 4 each, 6-7: one row whole, one half)."""
    cfg = small_cfg(arch)
    rng = np.random.RandomState(7)
    toks = rng.randint(0, cfg.vocab_size, (B, L)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1).astype(np.int32)
    mask = np.ones((B, L), np.float32)
    mask[2:4] = (rng.rand(2, L) > 0.3).astype(np.float32)
    mask[4:6] = 0.0
    mask[4:6, :4] = 1.0
    mask[7, L // 2:] = 0.0
    return {"tokens": toks, "labels": labels, "mask": mask}


def compress_inputs():
    """Each rank's gradients and starting residual, EF_ROUNDS rounds:
    (rank, round) -> ({leaf: grad}, and the round-0 residual)."""
    rng = np.random.RandomState(3)
    grads = [[{"w": (rng.randn(6, 5) * 10.0 ** rng.randint(-4, 1)
                     ).astype(np.float32),
               "b": (rng.randn(7) * 1e-3).astype(np.float32)}
              for _ in range(EF_ROUNDS)] for _ in range(WORLD)]
    ef0 = [{"w": (rng.randn(6, 5) * 1e-4).astype(np.float32),
            "b": np.zeros(7, np.float32)} for _ in range(WORLD)]
    return grads, ef0


# ---------------------------------------------------------------------------
# The reference's side (run as a script: it forces 4 host devices)
# ---------------------------------------------------------------------------

def _reference(out_dir):
    import jax.numpy as jnp

    from repro.checkpoint.manager import CheckpointManager
    from repro.optim import adamw
    from repro.train import step as JT

    out = {}
    for arch in ARCHS:
        cfg = small_cfg(arch, "reference")
        p0 = {k: jnp.asarray(v) for k, v in masters(arch).items()}
        b = {k: jnp.asarray(v) for k, v in batch(arch).items()}
        for mb in MICROBATCHES:
            state = JT.TrainState(step=jnp.zeros((), jnp.int32), params=p0,
                                  opt=adamw.init(p0))
            step = JT.build_train_step(cfg, adamw.AdamWConfig(**OPT),
                                       microbatches=mb)
            key = case_key(arch, mb)
            b1 = adamw.AdamWConfig(**OPT).b1
            for i in range(STEPS):
                state, m = step(state, b)
                for name in ("loss", "aux", "grad_norm"):
                    out[f"{key} {name} {i}"] = np.float32(m[name])
                if i == 0:    # the first clipped gradient, from m = (1-b1) g
                    for k, v in state.opt.m.items():
                        out[f"{key} grad0 {k}"] = np.asarray(v) / (1 - b1)
            for k, v in state.params.items():
                out[f"{key} param {k}"] = np.asarray(v)
            if arch == ARCHS[0] and mb == 1:
                CheckpointManager(os.path.join(out_dir, "ref_ckpt")).save(
                    REF_CKPT_STEP, state)
    out.update(_reference_compressed())
    np.savez(os.path.join(out_dir, "ref.npz"), **out)
    with open(os.path.join(out_dir, DONE), "w") as f:
        f.write("ok")


def _reference_compressed():
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.core.distributed import _shard_map
    from repro.launch.mesh import make_mesh_compat
    from repro.optim import adamw

    mesh = make_mesh_compat((WORLD,), ("pod",))
    grads, ef0 = compress_inputs()
    out = {}
    for mode in MODES:
        fn = jax.jit(_shard_map(
            lambda g, e, mode=mode: adamw.allreduce_compressed(
                g, e, "pod", mode), mesh, (P("pod"), P("pod")),
            (P("pod"), P("pod")), check=False))
        ef = {k: jnp.stack([ef0[r][k] for r in range(WORLD)])
              for k in ef0[0]}
        for i in range(EF_ROUNDS):
            g = {k: jnp.stack([grads[r][i][k] for r in range(WORLD)])
                 for k in grads[0][i]}
            red, ef = fn(g, ef)
            for k in red:
                out[f"ar {mode} {i} red {k}"] = np.asarray(red[k])
                out[f"ar {mode} {i} ef {k}"] = np.asarray(ef[k])
    return out


# ---------------------------------------------------------------------------
# The port's side (one call per gloo rank)
# ---------------------------------------------------------------------------

def _meshes():
    from repro_torch.launch.mesh import make_mesh_compat

    full = make_mesh_compat((2, 2, 1), ("pod", "data", "model"),
                            device="cpu")
    return {"pod2xdata2": full, "data2": full["data", "model"],
            "one": full["model"]}


def port_ranks(rank, world, ref_dir):
    import torch

    torch.manual_seed(0)
    meshes = _meshes()
    out = {"rank": rank}
    out.update(_port_compressed(rank))
    out.update(_port_fsdp(meshes))
    out.update(_port_model_axis())
    out.update(_port_port_checkpoint(meshes, os.path.join(
        ref_dir, "port_ckpt"), rank))
    # the reference's checkpoint, once its side has written it
    deadline = time.monotonic() + 150
    while not os.path.exists(os.path.join(ref_dir, DONE)):
        if time.monotonic() > deadline:
            raise TimeoutError("the reference's side did not finish")
        time.sleep(0.2)
    out.update(_port_ref_checkpoint(meshes, os.path.join(ref_dir,
                                                         "ref_ckpt")))
    return out


def _port_compressed(rank):
    import torch

    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.optim import adamw

    mesh = make_mesh_compat((WORLD,), ("pod",), device="cpu")
    grads, ef0 = compress_inputs()
    out = {}
    for mode in MODES:
        ef = {k: torch.from_numpy(v) for k, v in ef0[rank].items()}
        for i in range(EF_ROUNDS):
            g = {k: torch.from_numpy(v) for k, v in grads[rank][i].items()}
            red, ef = adamw.allreduce_compressed(g, ef, "pod", mode, mesh)
            for k in red:
                out[f"ar {mode} {i} red {k}"] = red[k].numpy()
                out[f"ar {mode} {i} ef {k}"] = ef[k].numpy()
    return out


def _port_fsdp(meshes):
    import torch

    from repro_torch.optim import adamw
    from repro_torch.train import fsdp
    from repro_torch.train import step as T

    out = {}
    for arch in ARCHS:
        cfg = small_cfg(arch)
        p0 = {k: torch.from_numpy(v) for k, v in masters(arch).items()}
        b = T.cast_batch(batch(arch), cfg, "cpu")
        for mesh_name, _ in MESHES:
            rp, rg = fsdp.weight_hoist(cfg, meshes[mesh_name])
            lay = rp.layout
            local = lay.local_batch(b)
            out[f"{mesh_name} mask tokens"] = float(local["mask"].sum())
            for mb in MICROBATCHES:
                params = lay.shard(p0)
                state = T.TrainState(torch.zeros((), dtype=torch.int32),
                                     params, adamw.init(params))
                step = T.build_train_step(cfg, adamw.AdamWConfig(**OPT),
                                          microbatches=mb,
                                          reshard_params=rp,
                                          reshard_grads=rg)
                key = case_key(arch, mb, mesh_name)
                for i in range(STEPS):
                    state, m = step(state, local)
                    for name in ("loss", "aux", "grad_norm"):
                        out[f"{key} {name} {i}"] = float(m[name])
                whole = lay.gather_state(state)
                for k, v in whole.params.items():
                    out[f"{key} param {k}"] = v.numpy()
    return out


# The archs a mesh with model > 1 refuses to train, each with the words
# its refusal must name: a layout the step lacks, on the arch's mesh of
# TP_REFUSED_MESH (mamba2-370m's 32 SSD heads on a model axis of 3;
# minicpm3-4b's 40 heads on 16 ranks, 240 query columns a rank against
# heads of 96), else (data 2, model 2).  Every arch steps on (data 2,
# model 2) and (data 1, model 4).
TP_REFUSED = {"mamba2-370m": "SSD heads",
              "minicpm3-4b": "split heads"}
TP_REFUSED_MESH = {"mamba2-370m": (2, 3), "minicpm3-4b": (1, 16)}


def _port_model_axis():
    """On the arch's mesh of ``TP_REFUSED_MESH`` (else (data 2, model
    2)) the hooks of each arch of ``TP_REFUSED`` build (the dry run plans
    with them) and refuse to step: the step builder and the gradient hook
    raise, naming it."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.train import fsdp
    from repro_torch.train import step as T

    out = {}
    for arch in TP_REFUSED:
        mesh = abstract_mesh(TP_REFUSED_MESH.get(arch, (2, 2)),
                             ("data", "model"))
        cfg = get_config(arch)
        rp, rg = fsdp.weight_hoist(cfg, mesh)
        msgs = []
        for call in (lambda: T.build_train_step(cfg, reshard_params=rp,
                                                reshard_grads=rg),
                     lambda: rg({})):
            try:
                call()
                msgs.append(None)
            except ValueError as e:
                msgs.append(str(e))
        out[f"model axis errors {arch}"] = msgs
    return out


def _port_port_checkpoint(meshes, path, rank):
    """A port state saved from the 4 ranks (steps 1 and 2), restored on
    the 2-rank mesh bit-equal; then step 2's shard file corrupted: a
    restore with no step named falls back to step 1."""
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import specs as S
    from repro_torch.obs import get_metrics
    from repro_torch.optim import adamw
    from repro_torch.train import fsdp
    from repro_torch.train import step as T

    arch = ARCHS[0]
    cfg = small_cfg(arch)
    full = meshes["pod2xdata2"]
    rp, rg = fsdp.weight_hoist(cfg, full)
    lay = rp.layout
    state = lay.init_state(5, "cpu")
    step = T.build_train_step(cfg, adamw.AdamWConfig(**OPT),
                              reshard_params=rp, reshard_grads=rg)
    b = lay.local_batch(T.cast_batch(batch(arch), cfg, "cpu"))
    mgr = CheckpointManager(path)
    sds, sh4 = S.state_inputs(cfg, full)
    wholes = {}
    for i in (1, 2):
        state, _ = step(state, b)
        wholes[i] = lay.gather_state(state)
        if i == 1:
            mgr.save(i, state, shardings=sh4)
        else:
            mgr.save_async(i, state, shardings=sh4)
            mgr.wait()
    out = {}
    _, sh2 = S.state_inputs(cfg, meshes["data2"])
    got = mgr.restore(sds, device="cpu", shardings=sh2)
    out["port 4->2 bit-equal"] = _state_equal(got, wholes[2], sh2)
    got4 = mgr.restore(sds, device="cpu", shardings=sh4)
    out["port 4->4 equal own shards"] = _state_equal(got4, wholes[2], sh4)
    torch.distributed.barrier()
    if rank == 0:
        shard = os.path.join(path, "step_0000000002", "host_00000.npz")
        with open(shard, "r+b") as f:
            f.seek(200)
            f.write(b"\0" * 64)
    torch.distributed.barrier()
    snap = get_metrics().snapshot()
    before = snap.get("checkpoint.fallback_total", {}).get("value", 0)
    got = mgr.restore(sds, device="cpu", shardings=sh2)
    snap = get_metrics().snapshot()
    out["fallback count"] = snap.get("checkpoint.fallback_total",
                                     {}).get("value", 0) - before
    out["fallback bit-equal step 1"] = _state_equal(got, wholes[1], sh2)
    return out


def _state_equal(got, whole, shardings):
    """Every leaf of ``got`` (this rank's shards) equal, bit for bit, to
    its slice of the whole state ``whole``."""
    import torch

    from repro_torch.checkpoint.manager import _flatten

    g, w, s = _flatten(got), _flatten(whole), _flatten(shardings)
    return all(torch.equal(g[k], s[k].local(w[k])) for k in w)


def _port_ref_checkpoint(meshes, path):
    """The reference's checkpoint restored on 1, 2 and 4 ranks: each
    rank's shard against its slice of the arrays ``np.load`` reads from
    the reference's file."""
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.manager import _flatten
    from repro_torch.launch import specs as S

    cfg = small_cfg(ARCHS[0])
    mgr = CheckpointManager(path)
    shard = os.path.join(path, f"step_{REF_CKPT_STEP:010d}",
                         "host_00000.npz")
    with np.load(shard) as data:
        want = {k: torch.from_numpy(np.array(data[k])) for k in data.files}
    out = {}
    for name, ranks in (("one", 1), ("data2", 2), ("pod2xdata2", 4)):
        sds, sh = S.state_inputs(cfg, meshes[name])
        got = _flatten(mgr.restore(sds, device="cpu", shardings=sh))
        flat_sh = _flatten(sh)
        out[f"ref ckpt on {ranks}"] = {
            "keys": len(got),
            "equal": all(torch.equal(got[k], flat_sh[k].local(want[k]))
                         for k in got),
            "local elements": sum(v.numel() for v in got.values())}
    return out


if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count="
                               f"{WORLD} " + os.environ.get("XLA_FLAGS", ""))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    _reference(sys.argv[1])
