"""The port's tensor-parallel training step (FSDP over the batch axes, TP
over ``model``) against the reference's.

The port's side runs once as 4 gloo ranks (one module-scoped
``spawn_ranks``) while the reference's side runs in a subprocess an
arch, each with 4 forced host devices (``_torch_train_tp_cases.py``),
on the numpy inputs
of ``_torch_train_dist_cases.py`` (reduced configs, fp32, each rank's
mask holding another count of tokens), 2 steps at microbatches 1 and 2:

* reduced stablelm-1.6b and reduced mamba2-370m (the Mamba2 mixer's
  heads split over ``model``) on (data 2, model 2) and (data 1, model
  4), and reduced deepseek-v2-lite-16b (MLA, MoE with a shared expert
  and the aux loss) and reduced zamba2-7b (Mamba2 layers and a
  weight-shared attention block under nested remat) on (data 2, model
  2), each held to two references: the
  reference's single-device ``build_train_step`` on the whole batch, and
  (on (data 2, model 2)) the reference's own weight-hoisted GSPMD step,
  built as its ``lower_cell`` builds it and executed.  Loss, aux and
  ``grad_norm`` at rtol 1e-5; the parameters at
  ``test_torch_train_dist``'s ``TOL``, with its ``NEAR_EPS`` exemption
  (at most one parameter in a thousand, counted and printed).
* The reference's two steps agree with each other at the same
  tolerances.
* Each rank's state leaves are bit-equal to their slices of
  ``launch.specs.state_inputs(cfg, mesh)``'s shardings, which are the
  slices GSPMD gave each device.
* The bytes the ``model`` axis all-reduced on each rank, by site
  (``core.distributed.tp_wire_bytes``), against the dry run's planned
  tensor-parallel all-reduce bytes for the same config, mesh and
  microbatches (``launch.dryrun.tp_reduce_bytes``): the embedding's
  equal; the row-parallel outputs' and the column-parallel input
  gradients' short of the plan by the terms the plan counts and the
  port does not issue (ROADMAP.md §3), and the port's own sites that
  the plan leaves out (the loss statistics, the partial leaves'
  gradients, the Mamba2 gated norm's statistic and the fused Mamba2
  leaves' gather and reduce-scatter), each equal to its formula.
* A state saved from (data 2, model 2) restores bit-equal on (data 2)
  and on one rank."""

import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import _torch_train_tp_cases as C
from _torch_isolation import isolated_port_state  # noqa: F401  (autouse)
from repro_torch.configs import list_archs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import abstract_mesh, spawn_ranks
from repro_torch.train.fsdp import FsdpLayout
from test_torch_train_dist import NEAR_EPS, TOL

REPO = pathlib.Path(__file__).resolve().parents[1]
F32 = 4


def _env():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return env


def run_both(tmp_path_factory, archs):
    """Both sides of the cases of ``archs`` at once: the reference's in a
    subprocess an arch while the port's 4 ranks run."""
    out_dir = tmp_path_factory.mktemp("train_tp")
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "_torch_train_tp_cases.py"),
         str(out_dir), arch], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for arch in archs]
    try:
        port = spawn_ranks(C.port_ranks, C.WORLD,
                           (str(out_dir / "ckpt"), tuple(archs)),
                           timeout=180)
        logs = [proc.communicate(timeout=180)[0] for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    ref, hlo = {}, {}
    for proc, log, arch in zip(procs, logs, archs):
        assert proc.returncode == 0, log
        got = dict(np.load(out_dir / f"ref {arch}.npz"))
        hlo.update(json.loads(str(got.pop("gspmd collective bytes"))))
        ref.update(got)
    ref["gspmd collective bytes"] = json.dumps(hlo)
    return ref, port


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_both(tmp_path_factory, C.BASE_ARCHS)


def _params_close(got, want, grad0, label):
    """Every parameter of ``got`` within ``TOL`` of ``want`` but those
    whose first gradient is nonzero and within ``NEAR_EPS`` and that miss
    it (at most one in a thousand); returns the count exempt.  Adam's
    first update turns such a gradient's rounding into a move of up to
    lr; a near-eps parameter that lands within ``TOL`` is held to it."""
    exempt = near_all = total = 0
    for k, w in want.items():
        g0 = np.abs(grad0[k])
        near = (g0 > 0) & (g0 <= NEAR_EPS)
        miss = near & ~np.isclose(got[k], w, **TOL)
        exempt += int(miss.sum())
        near_all += int(near.sum())
        total += near.size
        np.testing.assert_allclose(got[k][~miss], w[~miss], **TOL,
                                   err_msg=f"{label} {k}")
    print(f"{label}: {exempt} of {total} parameters exempt (first gradient "
          f"within {NEAR_EPS:g}, {near_all} such, and outside TOL)")
    assert exempt <= total // 1000, (exempt, total)
    return exempt


def _metrics_close(got, want, label):
    for name in ("loss", "grad_norm", "aux"):
        for i in range(C.STEPS):
            w = float(want(name, i))
            g = got(name, i)
            if name == "aux" and w == 0.0:
                assert g == 0.0, (label, name, i, g)
            else:
                np.testing.assert_allclose(g, w, rtol=1e-5,
                                           err_msg=f"{label} {name} {i}")


def cases(archs):
    """The (arch, mesh, microbatches) cases of ``archs`` and their ids."""
    out = [(a, m, mb) for a, m in C.CASES if a in archs
           for mb in C.MICROBATCHES]
    return out, [f"{a}-{m}-mb{mb}" for a, m, mb in out]


def gspmd_cases(archs):
    out = [(a, mb) for a in archs for mb in C.MICROBATCHES]
    return out, [f"{a}-mb{mb}" for a, mb in out]


CASES, IDS = cases(C.BASE_ARCHS)


@pytest.mark.parametrize("arch,mesh,mb", CASES, ids=IDS)
def test_tp_step_matches_the_single_device_reference(runs, arch, mesh, mb):
    ref, port = runs
    key, rkey = C.case_key(arch, mb, mesh), C.case_key(arch, mb)
    for out in port:                     # every rank reports the global step
        _metrics_close(lambda n, i, out=out: out[f"{key} {n} {i}"],
                       lambda n, i: ref[f"{rkey} {n} {i}"], key)
    if arch.startswith("deepseek"):
        assert float(ref[f"{rkey} aux 0"]) > 0
    names = [k[len(f"{rkey} param "):] for k in ref
             if k.startswith(f"{rkey} param ")]
    got = {k: port[0][f"{key} param {k}"] for k in names}
    for out in port[1:]:
        for k in names:
            np.testing.assert_array_equal(out[f"{key} param {k}"], got[k])
    _params_close(got, {k: ref[f"{rkey} param {k}"] for k in names},
                  {k: ref[f"{rkey} grad0 {k}"] for k in names},
                  f"{key} vs the single-device step")


GSPMD, GSPMD_IDS = gspmd_cases(C.BASE_ARCHS)


@pytest.mark.parametrize("arch,mb", GSPMD, ids=GSPMD_IDS)
def test_tp_step_matches_the_reference_gspmd_step(runs, arch, mb):
    """On (data 2, model 2): the port's step against the reference's
    weight-hoisted step as ``lower_cell`` builds it, executed."""
    ref, port = runs
    key = C.case_key(arch, mb, C.GSPMD_MESH)
    rkey = C.case_key(arch, mb)
    _metrics_close(lambda n, i: port[0][f"{key} {n} {i}"],
                   lambda n, i: ref[f"{key} {n} {i}"], key)
    names = [k[len(f"{key} param "):] for k in ref
             if k.startswith(f"{key} param ")]
    _params_close({k: port[0][f"{key} param {k}"] for k in names},
                  {k: ref[f"{key} param {k}"] for k in names},
                  {k: ref[f"{rkey} grad0 {k}"] for k in names},
                  f"{key} vs the reference's GSPMD step")


@pytest.mark.parametrize("arch,mb", GSPMD, ids=GSPMD_IDS)
def test_reference_gspmd_step_matches_its_single_device_step(runs, arch, mb):
    ref, _ = runs
    key, rkey = C.case_key(arch, mb, C.GSPMD_MESH), C.case_key(arch, mb)
    _metrics_close(lambda n, i: float(ref[f"{key} {n} {i}"]),
                   lambda n, i: ref[f"{rkey} {n} {i}"], key)
    names = [k[len(f"{rkey} param "):] for k in ref
             if k.startswith(f"{rkey} param ")]
    _params_close({k: ref[f"{key} param {k}"] for k in names},
                  {k: ref[f"{rkey} param {k}"] for k in names},
                  {k: ref[f"{rkey} grad0 {k}"] for k in names},
                  f"{key} the reference's GSPMD vs its single-device step")


@pytest.mark.parametrize("arch,mesh,mb", CASES, ids=IDS)
def test_state_leaves_are_the_slices_of_the_state_specs(runs, arch, mesh,
                                                        mb):
    ref, port = runs
    key = C.case_key(arch, mb, mesh)
    for out in port:
        assert out[f"{key} state is its slices"], out["rank"]
    if mesh != C.GSPMD_MESH:
        return
    for k, sl in port[0][f"{key} slices"].items():
        for r, out in enumerate(port):     # rank r is the mesh's device r
            want = [tuple(int(x) for x in pair)
                    for pair in ref[f"{key} slices {k}"][r]]
            assert [tuple(p) for p in out[f"{key} slices"][k]] == want, (k, r)


def _mamba_forwards(cfg):
    """Each Mamba2 layer's forwards a step: once, twice with remat; a
    hybrid's (a checkpoint a segment around the layers') three times, a
    partial last segment's last layer twice."""
    n, e = cfg.n_layers, cfg.shared_attn_every
    if not cfg.remat:
        return [1] * n
    if not e:
        return [2] * n
    return [2 if i == n - 1 and n % e else 3 for i in range(n)]


def _kv_whole(cfg, model):
    """Whether the step reads the KV projections whole: GQA whose KV
    heads ``model`` splits, each rank's query heads inside one."""
    kv = cfg.n_kv_heads
    return cfg.attn_kind == "gqa" and kv % model and model % kv == 0


def _port_sites(cfg, tokens, fwd, model):
    """The bytes each site of the port's step hands to ``model``, one
    microbatch of ``tokens`` tokens (the formulas the port's layout
    gives, ``core.distributed.tp_wire_bytes``'s docstring); the
    whole-read leaves' once-a-step gather aside (:func:`_whole_gather`)."""
    d, n = cfg.d_model, cfg.n_layers
    act = tokens * d * F32
    # the global max, sum of exponentials and label logit, a codebook
    sites = {"loss": 3 * tokens * max(1, cfg.n_codebooks) * F32}
    if cfg.frontend == "tokens":
        sites["embed"] = act
    if cfg.family in ("ssm", "hybrid"):
        s = cfg.ssm
        h, di = s.n_heads(d), s.d_inner(d)
        apps = n // cfg.shared_attn_every if cfg.shared_attn_every else 0
        forwards = _mamba_forwards(cfg)
        # out_proj's sum: once (a plain recompute stops after its GEMM),
        # a hybrid's segment recompute again; a shared application's as
        # a transformer layer's
        mamba_rows = sum(f - 1 if cfg.remat and apps else 1
                         for f in forwards)
        sites["row"] = (mamba_rows + apps * (fwd + 1)) * act
        # one input gradient a mixer, a shared application's attention
        # and FFN, the head
        sites["col"] = (n + 2 * apps + 1) * act
        # the gated norm's (T,) statistic each forward and the backward
        sites["ssm_norm"] = sum(f + 1 for f in forwards) * tokens * F32
        # a_log, d_skip, dt_bias; the shared block's norm_ffn/scale
        sites["grads"] = (3 * n * h + (d if apps else 0)) * F32
        conv = di + 2 * s.n_groups * s.d_state
        # the whole gradients of in_proj, conv_w, conv_b reduce-scattered
        sites["ssm_fused"] = n * (d * (2 * di + 2 * s.n_groups * s.d_state
                                       + h) + (s.conv_kernel + 1) * conv) \
            * F32
        return sites
    # wo at every forward (a remat recompute too), the FFN's sum once:
    # the recompute stops before it (nothing after saves)
    sites["row"] = n * (fwd + 1) * act
    # one input gradient a region: attention, FFN, the head (the codebook
    # heads one region)
    sites["col"] = (2 * n + 1) * act
    moe = cfg.moe is not None and cfg.moe.n_experts
    grads = 0 if moe else n * d                # norm_ffn/scale
    if cfg.mla is not None:
        m = cfg.mla
        # wkv_a, kv_norm; with q-LoRA wq_a, q_norm
        grads += n * (d * (m.kv_lora_rank + m.qk_rope_dim) + m.kv_lora_rank
                      + (d + 1) * m.q_lora_rank)
    if grads:
        sites["grads"] = grads * F32
    if moe:
        sites["route"] = n * tokens * cfg.moe.top_k * F32
    if _kv_whole(cfg, model):
        # the whole gradients of wk and wv reduce-scattered
        sites["kv_head"] = n * 2 * d * cfg.n_kv_heads \
            * cfg.resolved_head_dim * F32
    return sites


def _whole_gather(cfg, model):
    """The whole-read leaves' all-gather over ``model``: this rank's shard
    of each, once a step, by site."""
    sites = _port_sites(cfg, 1, 1, model)
    return {k: sites[k] // model for k in ("ssm_fused", "kv_head")
            if k in sites}


def _plan_gap(cfg, act, fwd, tokens):
    """What the dry run plans beyond the port's ``row`` and ``col``
    sites, for ``tokens`` tokens of (T, d) activations of ``act`` bytes:
    each FFN's (a dense or MoE layer's, a shared application's) and each
    plain Mamba2 layer's last all-reduce again in the remat recompute,
    which the port stops before (ROADMAP.md §3), less the sum of the
    experts' outputs, which the plan (its k-sharded GEMMs) leaves out
    where no shared expert's down projection carries it; one input
    gradient per column-parallel GEMM (at the GEMM's own k: MLA's wq_b
    reads the q-LoRA rank) where the port sums a region's GEMMs first
    (wq, wk, wv; gate and up or the GELU's up; MLA: wq or wq_b; MoE:
    shared gate and up), the codebook heads' none (the plan takes 2-D
    GEMMs); a Mamba2 mixer has one, in_proj."""
    n, e = cfg.n_layers, cfg.shared_attn_every
    if cfg.family == "ssm":
        return n * (fwd - 1) * act, 0
    if cfg.family == "hybrid":
        apps = n // e
        return (apps + (n % e > 0)) * (fwd - 1) * act, apps * 3 * act
    if cfg.mla is None:
        attn = 3 * act
    elif cfg.mla.q_lora_rank:
        attn = tokens * cfg.mla.q_lora_rank * F32
    else:
        attn = act
    moe = cfg.moe is not None and cfg.moe.n_experts
    if not moe:
        ffn = (2 if cfg.act == "silu" else 1) * act
    else:
        ffn = 2 * act if cfg.moe.n_shared_experts else 0
    head = act if cfg.n_codebooks == 1 else 0
    ffn_row = 0 if moe and not cfg.moe.n_shared_experts else n * fwd * act
    return (n * fwd * act + ffn_row - n * (fwd + 1) * act,
            n * (attn + ffn) + head - (2 * n + 1) * act)


@pytest.mark.parametrize("arch,mesh,mb", CASES, ids=IDS)
def test_tp_wire_bytes_against_the_plan(runs, arch, mesh, mb):
    """Every step, every rank: the counted bytes by site against the dry
    run's plan for this config, mesh and microbatch count."""
    ref, port = runs
    cfg = C.small_cfg(arch)
    data, model = C.MESHES[mesh]
    key = C.case_key(arch, mb, mesh)
    rows = port[0][f"{key} local rows"]
    tokens = rows // mb * C.L
    fwd = 2 if cfg.remat else 1
    amesh = abstract_mesh((data, model), ("data", "model"))
    plan = dryrun.tp_reduce_bytes(cfg, "train", C.L, rows, amesh, mb)
    sites = {k: v * mb for k, v in _port_sites(cfg, tokens, fwd,
                                               model).items()}
    for k, v in _whole_gather(cfg, model).items():
        sites[k] += v
    # the layout's own account (the smoke holds the card's counts to it)
    assert FsdpLayout(cfg, amesh).tp_wire_plan(C.L, rows, mb) == sites
    act = tokens * cfg.d_model * F32 * mb
    row_gap, col_gap = _plan_gap(cfg, act, fwd, tokens * mb)
    assert plan.get("embed", 0) == sites.get("embed", 0)
    assert plan["row"] - sites["row"] == row_gap
    assert plan["col"] - sites["col"] == col_gap
    for i in range(C.STEPS):
        for out in port:
            wire = out[f"{key} wire {i}"]
            norm = wire.pop("norm")
            assert 0 < norm <= 4 * F32, wire
            assert wire == sites, (i, out["rank"], wire, sites)
    hlo = json.loads(str(ref["gspmd collective bytes"])).get(key)
    print(f"{key}: counted {json.dumps(sites)} + norm; planned "
          f"{json.dumps(plan)}; the reference's compiled step (every axis) "
          f"{json.dumps(hlo)}")


def _smoke():
    """``chip_smoke.py`` as a module, for its launch formula."""
    path = REPO / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch,mesh,mb", CASES, ids=IDS)
def test_k1_programs_per_step_match_the_smoke_formula(runs, arch, mesh, mb):
    """Every K1 program a rank's step calls, by launch key, equals
    ``chip_smoke.tp_counts_per_step`` times the microbatches (the count
    the card holds each rank's launches to)."""
    _, port = runs
    key = C.case_key(arch, mb, mesh)
    want = {k: n * mb for k, n in _smoke().tp_counts_per_step(
        C.small_cfg(arch), C.MESHES[mesh][1]).items()}
    for out in port:
        for i in range(C.STEPS):
            assert out[f"{key} programs {i}"] == want, (out["rank"], i)


@pytest.mark.parametrize("arch", C.ARCHS)
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_held_archs_are_not_refused(arch, reduced):
    """The archs these cases hold step tensor-parallel at full width and
    at the cases' reduced width: the refusal reads features, and theirs
    are the ones a case holds."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.train.fsdp import tp_refusal

    cfg = C.small_cfg(arch) if reduced else get_config(arch)
    for shape in ((2, 2), (1, 4)):
        mesh = abstract_mesh(shape, ("data", "model"))
        assert tp_refusal(cfg, mesh) is None, (arch, shape)


@pytest.mark.parametrize("arch", list_archs())
def test_every_arch_steps_tensor_parallel(arch):
    """Every configuration of the port steps tensor-parallel on (data 2,
    model 2) and (data 1, model 4): ``tp_refusal`` finds nothing
    missing."""
    from repro_torch.configs import get_config
    from repro_torch.train.fsdp import tp_refusal

    for shape in ((2, 2), (1, 4)):
        mesh = abstract_mesh(shape, ("data", "model"))
        assert tp_refusal(get_config(arch), mesh) is None, (arch, shape)


@pytest.mark.parametrize("where", ["data2", "one"])
def test_tp_state_restores_on_fewer_ranks(runs, where):
    _, port = runs
    for out in port:
        assert out[f"restore on {where} bit-equal"], out["rank"]
