"""The port's dry run (``launch/dryrun.py``, a plan with no compile)
against the reference's.

Its exact fields equal the reference's compile: the committed artifact
``experiments/dryrun/stablelm-1.6b__decode_32k__16x16.json`` (argument
and alias bytes, chips, shape, parameter counts), and for every cell on
both production meshes the rank-local argument and alias bytes summed
from the reference's own specs through ``NamedSharding.shard_shape``.
The planned GEMM flops of a dense decode cell equal 2 · the rank-local
m·k·n summed over the step's GEMMs, derived here from the reference's
parameter definitions and tensor-parallel specs; the command line
writes one JSON per cell under ``--out``."""

import json
import math
import pathlib

import numpy as np
import pytest
from jax.sharding import NamedSharding as JNamedSharding

from repro.checkpoint.manager import _flatten as jflatten
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.launch import specs as JS
from repro.launch.mesh import abstract_mesh as jabstract_mesh
from repro.models.model import model_defs as jmodel_defs
from repro.sharding.rules import pspecs_for_defs as jpspecs_for_defs
from repro_torch.configs import applicable_shapes, get_config, list_archs
from repro_torch.launch import dryrun as D

REPO = pathlib.Path(__file__).resolve().parents[1]
ARTIFACT = REPO / "experiments" / "dryrun" / \
    "stablelm-1.6b__decode_32k__16x16.json"
MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}


def _ref_bytes(sds, shardings) -> int:
    flat, sh = jflatten(sds), jflatten(shardings)
    return sum(
        math.prod(JNamedSharding(sh[k].mesh, sh[k].spec).shard_shape(
            v.shape)) * np.dtype(v.dtype).itemsize
        for k, v in flat.items())


def _ref_memory(arch, shape_name, multi_pod):
    """The reference's per-device argument and alias bytes of one cell,
    from its specs (its dry run's inputs) on the abstract mesh."""
    cfg, shape = jget_config(arch), JSHAPES[shape_name]
    mesh = jabstract_mesh(*MESHES[multi_pod])
    if shape.kind == "train":
        state = _ref_bytes(*JS.state_inputs(cfg, mesh, fsdp=True))
        return state + _ref_bytes(*JS.train_inputs(cfg, shape, mesh)), state
    params = _ref_bytes(*JS.serve_param_inputs(
        cfg, mesh, fsdp=arch in D.SERVE_FSDP))
    if shape.kind == "prefill":
        return params + _ref_bytes(*JS.prefill_inputs(cfg, shape, mesh)), 0
    cache = _ref_bytes(*JS.cache_inputs(cfg, shape, mesh))
    tokens = _ref_bytes(*JS.decode_token_inputs(cfg, shape, mesh))
    return params + tokens + cache + 4, cache      # + the int32 step


def test_stablelm_decode_reproduces_the_compiled_artifact():
    want = json.loads(ARTIFACT.read_text())
    got = D.plan_cell("stablelm-1.6b", "decode_32k", False)
    assert got["memory"]["argument_bytes"] == 3_452_112_932 == \
        want["memory"]["argument_bytes"]
    assert got["memory"]["alias_bytes"] == 3_246_391_296 == \
        want["memory"]["alias_bytes"]
    assert got["memory"]["temp_bytes"] is None
    for k in ("arch", "shape", "kind", "mesh", "chips", "seq_len",
              "global_batch", "n_params", "n_active_params"):
        assert got[k] == want[k], k
    # planned, not measured: here the plan lands on the compile's own
    # HLO walk (24 x (wo, w_down) + the vocab-sharded lookup = its 49
    # fp32 all-reduces of 8 x 2048; GEMMs plus attention = its flops)
    plan = got["plan"]
    assert plan["collective_bytes_by_kind"] == {
        "all-reduce": want["hlo"]["collective_bytes_by_kind"]["all-reduce"]}
    assert plan["flops_per_device"] == want["hlo"]["flops_per_device"]


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", list_archs())
def test_memory_equals_the_reference_specs_every_cell(arch, multi_pod):
    for shape_name in applicable_shapes(get_config(arch)):
        got = D.plan_cell(arch, shape_name, multi_pod)
        args, alias = _ref_memory(arch, shape_name, multi_pod)
        assert got["memory"]["argument_bytes"] == args, shape_name
        assert got["memory"]["alias_bytes"] == alias, shape_name
        assert got["chips"] == (512 if multi_pod else 256)
        plan = got["plan"]
        assert plan["flops_per_device"] > 0
        if got["kind"] == "train":
            # the weight-hoist hooks' gather and reduce-scatter
            kinds = plan["collective_bytes_by_kind"]
            assert kinds["all-gather"] > 0 and kinds["reduce-scatter"] > 0


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "h2o-danube-3-4b",
                                  "granite-20b"])
def test_dense_decode_gemm_flops_are_the_local_gemms(arch):
    """2 · Σ m·k·n over the step's K1 GEMMs at their rank-local shapes:
    m the rank's 8 decode rows, k and n cut by the reference's
    tensor-parallel specs, each stacked weight once a layer."""
    cfg = jget_config(arch)
    mesh = jabstract_mesh(*MESHES[False])
    specs = jpspecs_for_defs(jmodel_defs(cfg), mesh, fsdp=False)
    sizes = dict(mesh.shape)

    def cut(dim, entry):
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        return dim // math.prod(sizes[a] for a in axes)

    m = JSHAPES["decode_32k"].global_batch // sizes["data"]
    want = 0
    for key, d in jmodel_defs(cfg).items():
        name = key.split("/")[-1]
        if name not in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                        "w") or len(d.shape) not in (2, 3):
            continue
        spec = tuple(specs[key]) + (None,) * (len(d.shape) - len(specs[key]))
        layers = d.shape[0] if len(d.shape) == 3 else 1
        want += 2 * m * cut(d.shape[-2], spec[-2]) * cut(
            d.shape[-1], spec[-1]) * layers
    got = D.plan_cell(arch, "decode_32k", False)["plan"]
    assert got["gemm_flops_per_device"] == pytest.approx(want, rel=1e-12)


def test_cli_writes_one_json_per_cell(tmp_path):
    assert D.main(["--arch", "mamba2-370m", "--shape", "long_500k",
                   "--out", str(tmp_path)]) == 0
    assert D.main(["--all", "--multi-pod", "--shard-count", "9",
                   "--shard-index", "2", "--out", str(tmp_path)]) == 0
    cells = [c for i, c in enumerate(D.all_cells()) if i % 9 == 2]
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == sorted(
        [f"{a}__{s}__2x16x16.json" for a, s in cells]
        + ["mamba2-370m__long_500k__16x16.json"])
    for p in tmp_path.iterdir():
        art = json.loads(p.read_text())
        assert art["memory"]["argument_bytes"] > 0
        assert "hlo" not in art and art["plan"]["flops_per_device"] > 0


def test_default_out_is_not_under_experiments():
    out = pathlib.Path(D.ARTIFACT_DIR).resolve()
    assert out == REPO / "build" / "dryrun"
