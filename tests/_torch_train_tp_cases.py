"""Shared cases of the tensor-parallel training parity tests, read by both
sides: the configurations (the reduced ones, a few changed:
``CFG_CHANGES``), meshes and microbatch counts, the global batch (that of
``_torch_train_dist_cases.py``, with embeddings and codebook labels for
the archs that take them) and the starting masters; the optimizer is
``_torch_train_dist_cases.py``'s.

``python tests/_torch_train_tp_cases.py OUT_DIR ARCH`` computes the
reference's side for ``ARCH`` (``repro``, 4 forced host devices) into
``OUT_DIR/ref ARCH.npz`` (one process an arch, run side by side):
its single-device ``build_train_step`` on the whole batch for each
microbatch count (and the first gradient its AdamW took), and its own
weight-hoisted GSPMD step, built as ``lower_cell`` builds it (its
``reshard_params`` / ``reshard_grads`` hooks, the FSDP state specs, the
activation-sharding context) on a (data 2, model 2) CPU mesh and
executed: its metrics, parameters, each device's slice of every leaf,
and the collective bytes its compiled HLO holds.  :func:`port_ranks` is
the port's side, one call per gloo rank."""

import collections
import contextlib
import functools
import json
import os
import sys
import types

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _torch_train_dist_cases as DC  # noqa: E402

# the FSDP cases' archs and the Mamba2 families (test_torch_train_tp.py),
# then the other six (test_torch_train_tp_archs.py): two modules, so that
# the test run's workers take one each
BASE_ARCHS = DC.ARCHS + ("mamba2-370m", "zamba2-7b")
MORE_ARCHS = ("h2o-danube-3-4b", "minicpm3-4b", "mixtral-8x7b",
              "qwen2-vl-72b", "granite-20b", "musicgen-large")
ARCHS = BASE_ARCHS + MORE_ARCHS
MICROBATCHES = DC.MICROBATCHES
B, L, STEPS, OPT = DC.B, DC.L, DC.STEPS, DC.OPT
WORLD = 4
# (name, (data, model)) of the port's 4 ranks
MESHES = {"data2xmodel2": (2, 2), "data1xmodel4": (1, 4)}
CASES = [("stablelm-1.6b", "data2xmodel2"), ("stablelm-1.6b", "data1xmodel4"),
         ("deepseek-v2-lite-16b", "data2xmodel2"),
         ("mamba2-370m", "data2xmodel2"), ("mamba2-370m", "data1xmodel4"),
         ("zamba2-7b", "data2xmodel2"),
         ("h2o-danube-3-4b", "data2xmodel2"), ("minicpm3-4b", "data2xmodel2"),
         ("mixtral-8x7b", "data2xmodel2"), ("mixtral-8x7b", "data1xmodel4"),
         ("qwen2-vl-72b", "data2xmodel2"), ("granite-20b", "data2xmodel2"),
         ("granite-20b", "data1xmodel4"), ("musicgen-large", "data2xmodel2")]
GSPMD_MESH = "data2xmodel2"
CKPT_CASE = ("stablelm-1.6b", GSPMD_MESH, 1)
# What each case's config changes in the reduced config, on both sides:
# a window short enough to mask keys at L = 16, and minicpm3's heads
# made 4 (the reduced 5 split over model = 2; the full config's 40
# divide over 2, 4 and 8).
CFG_CHANGES = {"h2o-danube-3-4b": dict(sliding_window=8),
               "mixtral-8x7b": dict(sliding_window=8),
               "minicpm3-4b": dict(n_heads=4, n_kv_heads=4)}


def case_key(arch, mb, mesh=None):
    return DC.case_key(arch, mb, mesh)


def small_cfg(arch, package="port"):
    """The reduced config of ``arch`` with ``CFG_CHANGES``, from either
    package."""
    import dataclasses

    return dataclasses.replace(DC.small_cfg(arch, package),
                               **CFG_CHANGES.get(arch, {}))


def masters(arch):
    """The fp32 masters both sides start from: the port's seed-0 init of
    :func:`small_cfg`."""
    import torch

    from repro_torch.models import model as M

    torch.manual_seed(0)
    return {k: v.numpy() for k, v in M.init_params(
        small_cfg(arch), 0, "cpu", masters=True).items()}


def batch(arch):
    """``_torch_train_dist_cases.batch``'s global batch; for the
    ``embeds`` frontend the token ids become (B, L, d) embeddings drawn
    from a seed, and with codebooks the labels (B, L, n_codebooks) ids
    drawn from it.  Neither carries positions: the model takes the
    text position, on all three M-RoPE streams, as the reference's
    pipeline (``data.pipeline.batch_for_model``) leaves it to."""
    cfg = small_cfg(arch)
    out = DC.batch(arch)
    if cfg.frontend == "tokens":
        return out
    rng = np.random.RandomState(11)
    out["embeds"] = (rng.randn(B, L, cfg.d_model) * 0.5).astype(np.float32)
    del out["tokens"]
    if cfg.n_codebooks > 1:
        out["labels"] = rng.randint(0, cfg.vocab_size,
                                    (B, L, cfg.n_codebooks)).astype(np.int32)
    return out


# ---------------------------------------------------------------------------
# The reference's side (run as a script: it forces 4 host devices)
# ---------------------------------------------------------------------------

def _reference(out_dir, arch):
    import jax

    jax.devices()   # the backend up, before the dry run's flag is set
    out = {}
    for mb in MICROBATCHES:
        out.update(_reference_single(arch, mb))
    hlo = {}
    for mb in MICROBATCHES:
        got, coll = _reference_gspmd(arch, mb)
        out.update(got)
        hlo[case_key(arch, mb, GSPMD_MESH)] = coll
    out["gspmd collective bytes"] = np.array(json.dumps(hlo))
    np.savez(os.path.join(out_dir, f"ref {arch}.npz"), **out)


def _initial(arch):
    import jax.numpy as jnp

    from repro.optim import adamw
    from repro.train import step as JT

    p0 = {k: jnp.asarray(v) for k, v in masters(arch).items()}
    return JT.TrainState(step=jnp.zeros((), jnp.int32), params=p0,
                         opt=adamw.init(p0))


def _reference_single(arch, mb):
    import jax.numpy as jnp

    from repro.optim import adamw
    from repro.train import step as JT

    cfg = small_cfg(arch, "reference")
    b = {k: jnp.asarray(v) for k, v in batch(arch).items()}
    state = _initial(arch)
    step = JT.build_train_step(cfg, adamw.AdamWConfig(**OPT),
                               microbatches=mb)
    key = case_key(arch, mb)
    b1 = adamw.AdamWConfig(**OPT).b1
    out = {}
    for i in range(STEPS):
        state, m = step(state, b)
        for name in ("loss", "aux", "grad_norm"):
            out[f"{key} {name} {i}"] = np.float32(m[name])
        if i == 0:    # the first clipped gradient, from m = (1-b1) g
            for k, v in state.opt.m.items():
                out[f"{key} grad0 {k}"] = np.asarray(v) / (1 - b1)
    for k, v in state.params.items():
        out[f"{key} param {k}"] = np.asarray(v)
    return out


def _reference_gspmd(arch, mb):
    """The reference's weight-hoisted step as ``lower_cell`` builds it,
    with the dry run's production mesh replaced by a (data 2, model 2)
    mesh of the 4 host devices, its train shape by this batch's and its
    AdamW by ``OPT``; then executed for ``STEPS`` steps."""
    import jax

    from repro.configs.base import ShapeConfig
    from repro.launch import dryrun as RD
    from repro.launch import specs as RS
    from repro.launch.mesh import make_mesh_compat
    from repro.optim import adamw
    from repro.train import step as JT

    cfg = small_cfg(arch, "reference")
    data, model = MESHES[GSPMD_MESH]
    mesh = make_mesh_compat((data, model), ("data", "model"))
    shape = ShapeConfig("tp_case", L, B, "train")
    saved = (RD.make_production_mesh, RD.train_mod, dict(RD.SHAPES))
    RD.make_production_mesh = lambda multi_pod=False: mesh
    RD.train_mod = types.SimpleNamespace(build_train_step=functools.partial(
        JT.build_train_step, opt_cfg=adamw.AdamWConfig(**OPT)))
    RD.SHAPES["tp_case"] = shape
    try:
        art, compiled = RD.lower_cell(arch, "tp_case", False,
                                      cfg_override=cfg, return_compiled=True,
                                      microbatches=mb, weight_hoist=True)
    finally:
        RD.make_production_mesh, RD.train_mod = saved[:2]
        RD.SHAPES.clear()
        RD.SHAPES.update(saved[2])
    _, state_sh = RS.state_inputs(cfg, mesh, fsdp=True)
    _, batch_sh = RS.train_inputs(cfg, shape, mesh)
    state = jax.device_put(_initial(arch), state_sh)
    b = jax.device_put(batch(arch), batch_sh)
    key = case_key(arch, mb, GSPMD_MESH)
    out = {}
    for i in range(STEPS):
        state, m = compiled(state, b)
        for name in ("loss", "aux", "grad_norm"):
            out[f"{key} {name} {i}"] = np.float32(m[name])
    devices = list(mesh.devices.flat)          # rank-major, as the port's
    for k, v in state.params.items():
        out[f"{key} param {k}"] = np.asarray(v)
        where = v.sharding.devices_indices_map(v.shape)
        out[f"{key} slices {k}"] = np.array(
            [[(s.start or 0, v.shape[d] if s.stop is None else s.stop)
              for d, s in enumerate(where[dev])] for dev in devices],
            dtype=np.int64).reshape(len(devices), len(v.shape), 2)
    return out, art["hlo"]["collective_bytes_by_kind"]


# ---------------------------------------------------------------------------
# The port's side (one call per gloo rank)
# ---------------------------------------------------------------------------

def _meshes():
    from repro_torch.launch.mesh import make_mesh_compat

    out = {name: make_mesh_compat(shape, ("data", "model"), device="cpu")
           for name, shape in MESHES.items()}
    # the restore meshes, (data 2) and one rank, each with a model axis
    # of 1: the inner dims of (rep, data, model) meshes
    out["data2"] = make_mesh_compat((2, 2, 1), ("rep", "data", "model"),
                                    device="cpu")["data", "model"]
    out["one"] = make_mesh_compat((4, 1, 1), ("rep", "data", "model"),
                                  device="cpu")["data", "model"]
    return out


def port_ranks(rank, world, ckpt_dir, archs):
    """The cases of ``archs`` on this rank."""
    import torch

    torch.manual_seed(0)
    # two intra-op threads a rank: four ranks of the host's default each
    # oversubscribe its cores several times over
    torch.set_num_threads(2)
    meshes = _meshes()
    out = {"rank": rank}
    for arch, mesh_name in CASES:
        if arch not in archs:
            continue
        for mb in MICROBATCHES:
            got, state = _port_case(arch, meshes[mesh_name], mb)
            out.update({f"{case_key(arch, mb, mesh_name)} {k}": v
                        for k, v in got.items()})
            if (arch, mesh_name, mb) == CKPT_CASE:
                out.update(_port_checkpoint(arch, meshes, mesh_name, state,
                                            ckpt_dir))
    return out


def _port_case(arch, mesh, mb):
    """``STEPS`` tensor-parallel steps from the shared masters on this
    rank's rows: per step the metrics and the bytes each site of the
    ``model`` axis all-reduced; the whole parameters gathered; the state
    leaves held against their slices of ``launch.specs.state_inputs``'s
    shardings (and those slices, for the reference's)."""
    import torch

    from repro_torch.core import distributed as D
    from repro_torch.launch import specs as S
    from repro_torch.optim import adamw
    from repro_torch.train import fsdp
    from repro_torch.train import step as T

    cfg = small_cfg(arch)
    rp, rg = fsdp.weight_hoist(cfg, mesh)
    lay = rp.layout
    params = lay.shard({k: torch.from_numpy(v)
                        for k, v in masters(arch).items()})
    state = T.TrainState(torch.zeros((), dtype=torch.int32), params,
                         adamw.init(params))
    step = T.build_train_step(cfg, adamw.AdamWConfig(**OPT), microbatches=mb,
                              reshard_params=rp, reshard_grads=rg)
    local = lay.local_batch(T.cast_batch(batch(arch), cfg, "cpu"))
    out = {"local rows": int(local["labels"].shape[0])}
    if cfg.rope_kind == "mrope":
        # positions, where a batch carries them, split as its rows: each
        # global row's index in both
        rows = torch.arange(B)[:, None].expand(B, L)
        got = lay.local_batch({"labels": rows, "positions": rows[
            ..., None].expand(B, L, 3)})
        out["positions split as the rows"] = bool(torch.equal(
            got["positions"], got["labels"][..., None].expand(-1, -1, 3)))
    for i in range(STEPS):
        before = dict(D.tp_wire_bytes)
        with _counting_programs() as calls:
            state, m = step(state, local)
        out[f"programs {i}"] = dict(calls)
        for name in ("loss", "aux", "grad_norm"):
            out[f"{name} {i}"] = float(m[name])
        out[f"wire {i}"] = {k: v - before.get(k, 0)
                            for k, v in D.tp_wire_bytes.items()
                            if v != before.get(k, 0)}
    whole = lay.gather_state(state)
    for k, v in whole.params.items():
        out[f"param {k}"] = v.numpy()
    _, sh = S.state_inputs(cfg, mesh)
    out["state is its slices"] = DC._state_equal(state, whole, sh)
    out["slices"] = {k: [(s.start, s.stop) for s in sh.params[k].local_slices(
        tuple(v.shape))] for k, v in whole.params.items()}
    return out, state


@contextlib.contextmanager
def _counting_programs():
    """K1 program calls by launch key (the plain versions here)."""
    from repro_torch.kernels import ca_mmm as K

    calls = collections.Counter()
    orig = K.ca_gemm_program

    def counted(a, bs, **kw):
        calls[K.launch_key(kw.get("spec", K.PLAIN).tag(),
                           K.layout_tag(kw.get("transpose_a", False),
                                        kw.get("transpose_b", False)),
                           kw.get("save_preact", False))] += 1
        return orig(a, bs, **kw)

    K.ca_gemm_program = counted
    try:
        yield calls
    finally:
        K.ca_gemm_program = orig


def _port_checkpoint(arch, meshes, mesh_name, state, path):
    """The state saved from the (data 2, model 2) ranks, restored on the
    (data 2) mesh and on one rank: each rank's leaves bit-equal to their
    slices of the whole state."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import specs as S
    from repro_torch.train import fsdp

    cfg = small_cfg(arch)
    mesh = meshes[mesh_name]
    lay = fsdp.FsdpLayout(cfg, mesh)
    whole = lay.gather_state(state)
    sds, sh = S.state_inputs(cfg, mesh)
    mgr = CheckpointManager(path)
    mgr.save(STEPS, state, shardings=sh)
    out = {}
    for name in ("data2", "one"):
        _, to = S.state_inputs(cfg, meshes[name])
        got = mgr.restore(sds, device="cpu", shardings=to)
        out[f"restore on {name} bit-equal"] = DC._state_equal(got, whole, to)
    return out


if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count="
                               f"{WORLD} " + os.environ.get("XLA_FLAGS", ""))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    _reference(sys.argv[1], sys.argv[2])
