"""The port's input stand-ins and placements (``launch/specs.py``)
against the reference's, leaf by leaf, for every arch x applicable shape
on both abstract production meshes: global shape, dtype, spec entries,
and the rank-local shard shape against the reference's
``NamedSharding.shard_shape``; then the reference's own spec cases
(``tests/test_specs.py``) on the port."""

import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding as JNamedSharding

from repro.checkpoint.manager import _flatten as jflatten
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.launch import specs as JS
from repro.launch.mesh import abstract_mesh as jabstract_mesh
from repro_torch.configs import (SHAPES, applicable_shapes, get_config,
                                 list_archs)
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import abstract_mesh

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
SERVE_FSDP = {"qwen2-vl-72b"}


def _entries(spec, ndim):
    """A spec's entries, one a dim; a one-axis tuple as its axis (the
    reference's ``PartitionSpec`` writes ``("data",)`` as ``"data"``)."""
    out = []
    for e in list(spec) + [None] * (ndim - len(spec)):
        if isinstance(e, (tuple, list)):
            e = tuple(e) if len(e) > 1 else e[0]
        out.append(e)
    return out


def _trees(arch, shape_name, mesh_name):
    """(name, port (sds, shardings), reference (sds, shardings)) of every
    input tree of one cell."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    shape, jshape = SHAPES[shape_name], JSHAPES[shape_name]
    m = abstract_mesh(*MESHES[mesh_name])
    jm = jabstract_mesh(*MESHES[mesh_name])
    if shape.kind == "train":
        return [("state", S.state_inputs(cfg, m), JS.state_inputs(jcfg, jm)),
                ("batch", S.train_inputs(cfg, shape, m),
                 JS.train_inputs(jcfg, jshape, jm))]
    fsdp = arch in SERVE_FSDP
    out = [("params", S.serve_param_inputs(cfg, m, fsdp=fsdp),
            JS.serve_param_inputs(jcfg, jm, fsdp=fsdp))]
    if shape.kind == "prefill":
        out.append(("prompt", S.prefill_inputs(cfg, shape, m),
                    JS.prefill_inputs(jcfg, jshape, jm)))
    else:
        out += [("token", S.decode_token_inputs(cfg, shape, m),
                 JS.decode_token_inputs(jcfg, jshape, jm)),
                ("cache", S.cache_inputs(cfg, shape, m),
                 JS.cache_inputs(jcfg, jshape, jm))]
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_specs_match_the_reference_leaf_by_leaf(arch, mesh_name):
    for shape_name in applicable_shapes(get_config(arch)):
        for name, (sds, sh), (jsds, jsh) in _trees(arch, shape_name,
                                                   mesh_name):
            ours = S.leaves(sds, sh)
            jleaves, jsh_flat = jflatten(jsds), jflatten(jsh)
            assert [k for k, _, _ in ours] == list(jleaves), (name, arch)
            for k, s, h in ours:
                js, jh = jleaves[k], jsh_flat[k]
                where = (arch, shape_name, mesh_name, name, k)
                assert s.shape == tuple(js.shape), where
                assert str(s.dtype).removeprefix("torch.") == str(
                    np.dtype(js.dtype)), where
                assert _entries(h.spec, len(s.shape)) == _entries(
                    jh.spec, len(s.shape)), where
                assert h.shard_shape(s.shape) == tuple(
                    JNamedSharding(jh.mesh, jh.spec).shard_shape(js.shape)
                ), where


# -- the reference's own cases (tests/test_specs.py) ------------------------

@pytest.fixture(scope="module")
def mesh():
    return abstract_mesh((16, 16), ("data", "model"))


@pytest.fixture(scope="module")
def mesh3():
    return abstract_mesh((2, 16, 16), ("pod", "data", "model"))


def _check_divisible(sds, shardings, mesh):
    sizes = dict(zip(mesh.axis_names, mesh.axis_sizes))
    for _, leaf, sh in S.leaves(sds, shardings):
        for dim, entry in zip(leaf.shape, sh.spec):
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            assert dim % int(np.prod([sizes[a] for a in axes])) == 0, \
                (leaf.shape, sh.spec)


@pytest.mark.parametrize("arch", list_archs())
def test_cache_specs_divisible_all_cells(arch, mesh, mesh3):
    cfg = get_config(arch)
    for shape_name in applicable_shapes(cfg):
        shape = SHAPES[shape_name]
        if shape.kind != "decode":
            continue
        for m in (mesh, mesh3):
            _check_divisible(*S.cache_inputs(cfg, shape, m), m)


@pytest.mark.parametrize("arch", list_archs())
def test_train_input_specs(arch, mesh3):
    cfg = get_config(arch)
    sds, sh = S.train_inputs(cfg, SHAPES["train_4k"], mesh3)
    assert "labels" in sds and "mask" in sds
    key = "tokens" if cfg.frontend == "tokens" else "embeds"
    assert key in sds
    # global batch 256 shards over pod*data = 32
    assert sh[key].spec[0] == ("pod", "data")
    assert sh[key].shard_shape(sds[key].shape)[0] == 8
    _check_divisible(sds, sh, mesh3)


def test_long500k_batch1_replicated(mesh):
    cfg = get_config("zamba2-7b")
    _, sh = S.decode_token_inputs(cfg, SHAPES["long_500k"], mesh)
    assert sh["tokens"].spec[0] is None  # batch 1 cannot shard


def test_long500k_cache_seq_parallel(mesh):
    """Batch 1: the shared attention cache's sequence dim shards over
    'data' (sequence parallelism)."""
    cfg = get_config("zamba2-7b")
    sds, sh = S.cache_inputs(cfg, SHAPES["long_500k"], mesh)
    spec = sh["shared"]["k"].spec
    assert spec[2] == "data"
    assert sh["shared"]["k"].shard_shape(sds["shared"]["k"].shape)[2] == \
        sds["shared"]["k"].shape[2] // 16


def test_qwen_decode_cache_sharding(mesh):
    """8 KV heads do not divide 16: head_dim (128) takes the model axis."""
    cfg = get_config("qwen2-vl-72b")
    _, sh = S.cache_inputs(cfg, SHAPES["decode_32k"], mesh)
    k_spec = sh["layers"]["k"].spec
    assert k_spec[1] in (("data",), "data")    # batch 128
    assert k_spec[4] == "model"                 # head_dim 128
    assert k_spec[3] is None                    # 8 kv heads


def test_state_inputs_fsdp(mesh):
    cfg = get_config("stablelm-1.6b")
    sds, sh = S.state_inputs(cfg, mesh, fsdp=True)
    specs = [s.spec for s in sh.params.values()]
    assert any("data" in [e for e in spec if isinstance(e, str)]
               or any(isinstance(e, tuple) and "data" in e for e in spec)
               for spec in specs)
    # the moments mirror the parameters' shardings; scalars replicated
    assert sh.opt.m.keys() == sh.params.keys() == sh.opt.v.keys()
    assert sh.step.spec == () and sds.step.dtype == torch.int32
    assert all(sds.params[k].dtype == torch.float32 for k in sds.params)


def test_stand_ins_allocate_nothing():
    """The cache's stand-ins come from the meta device: a 500k-token
    cache of the hybrid costs no memory."""
    cfg = get_config("zamba2-7b")
    sds, _ = S.cache_inputs(cfg, SHAPES["long_500k"],
                            abstract_mesh((16, 16), ("data", "model")))
    leaf = sds["shared"]["k"]
    assert isinstance(leaf, S.ShapeDtypeStruct)
    assert leaf.nbytes == int(np.prod(leaf.shape)) * 2 > 2 ** 30
