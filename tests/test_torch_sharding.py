"""The port's sharding rules against the reference's, on abstract meshes:
the seven cases of ``tests/test_sharding.py`` (each property also over
every architecture's parameter defs), every parameter's spec equal to the
reference's ``PartitionSpec`` for every architecture with and without
FSDP, ``dist_operand_specs``, the placements a spec maps to and the
activation policy.  Comparisons are exact."""

import numpy as np
import pytest

from _torch_isolation import isolated_port_state  # noqa: F401  (autouse)
from repro.configs import get_config as jax_config
from repro.launch.mesh import abstract_mesh as jax_abstract_mesh
from repro.models.model import model_defs as jax_model_defs
from repro.sharding import rules as jrules
from repro_torch.configs import get_config, list_archs
from repro_torch.core.distributed import placements_for
from repro_torch.launch import mesh as tmesh
from repro_torch.models.model import model_defs
from repro_torch.sharding import rules as trules

ARCHS = list_archs()


@pytest.fixture(scope="module")
def mesh():
    return tmesh.abstract_mesh((16, 16), ("data", "model"))


def _used(spec):
    out = []
    for e in spec:
        if e is not None:
            out += list(e) if isinstance(e, tuple) else [e]
    return out


def test_tp_assignment(mesh):
    assert trules.pspec_for_def(("embed", "mlp"), (2048, 5632), mesh) \
        == (None, "model")


def test_fsdp_assignment(mesh):
    assert trules.pspec_for_def(("embed", "mlp"), (2048, 5632), mesh,
                                fsdp=True) == ("data", "model")


def test_nondivisible_dropped(mesh):
    # minicpm3's 40 heads over 16 ranks: dropped, not an error
    assert trules.pspec_for_def(("heads", None), (40, 64), mesh) \
        == (None, None)


def test_expert_parallel_when_divisible(mesh):
    s = trules.pspec_for_def(("expert", "embed", "mlp"), (64, 2048, 1408),
                             mesh)
    assert s[0] == "model" and s[2] is None


def test_tp_fallback_when_experts_dont_divide(mesh):
    s = trules.pspec_for_def(("expert", "embed", "mlp"), (8, 4096, 14336),
                             mesh)
    assert s[0] is None and s[2] == "model"


@pytest.mark.parametrize("arch", ARCHS)
def test_no_axis_reuse(mesh, arch):
    specs = trules.pspecs_for_defs(model_defs(get_config(arch)), mesh,
                                   fsdp=True)
    for k, s in specs.items():
        used = _used(s)
        assert len(used) == len(set(used)), (arch, k, s)


@pytest.mark.parametrize("arch", ARCHS)
def test_all_sharded_dims_divisible(mesh, arch):
    defs = model_defs(get_config(arch))
    specs = trules.pspecs_for_defs(defs, mesh, fsdp=True)
    sizes = tmesh.axis_sizes(mesh)
    for k, d in defs.items():
        for dim, e in zip(d.shape, specs[k]):
            if e is None:
                continue
            total = int(np.prod([sizes[a] for a in
                                 (e if isinstance(e, tuple) else (e,))]))
            assert dim % total == 0, (arch, k, d.shape, specs[k])


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_the_reference(arch, fsdp):
    """Every parameter of every architecture gets the reference's axis
    assignment, on the single-pod and the multi-pod production shapes."""
    assert set(model_defs(get_config(arch))) \
        == set(jax_model_defs(jax_config(arch)))
    for shape, axes in (((16, 16), ("data", "model")),
                        ((2, 16, 16), ("pod", "data", "model"))):
        want = jrules.pspecs_for_defs(jax_model_defs(jax_config(arch)),
                                      jax_abstract_mesh(shape, axes),
                                      fsdp=fsdp, fsdp_axes=("pod", "data"))
        got = trules.pspecs_for_defs(model_defs(get_config(arch)),
                                     tmesh.abstract_mesh(shape, axes),
                                     fsdp=fsdp, fsdp_axes=("pod", "data"))
        assert got == {k: tuple(v) for k, v in want.items()}, (arch, shape)


def test_dist_operand_specs():
    mesh = tmesh.abstract_mesh((1, 1), ("data", "model"))
    assert trules.dist_operand_specs(("embed", "qkv"), (64, 64), mesh) == (
        ("data", "model"), (None, "model"), ("data", "model"))
    # the output axis need not map to the model axis (wo rides too)
    assert trules.dist_operand_specs(("qkv", "embed"), (64, 64),
                                     mesh) is not None
    assert trules.dist_operand_specs(("embed",), (64,), mesh) is None
    no_tp = tmesh.abstract_mesh((1,), ("data",))
    assert trules.dist_operand_specs(("embed", "qkv"), (64, 64),
                                     no_tp) is None
    # and the reference agrees on each
    jmesh = jax_abstract_mesh((4, 4), ("data", "model"))
    for axes, shape in ((("embed", "qkv"), (64, 64)),
                        (("embed", "qkv"), (64, 6)), (("embed",), (64,))):
        want = jrules.dist_operand_specs(axes, shape, jmesh)
        got = trules.dist_operand_specs(
            axes, shape, tmesh.abstract_mesh((4, 4), ("data", "model")))
        assert got == (None if want is None
                       else tuple(tuple(s) for s in want))


class _NamedMesh:
    """The one attribute ``placements_for`` reads of a DeviceMesh."""

    def __init__(self, names):
        self.mesh_dim_names = names


def test_placements_for_specs():
    from torch.distributed.tensor import Replicate, Shard

    m2 = _NamedMesh(("data", "model"))
    assert placements_for(("data", "model"), m2) == [Shard(0), Shard(1)]
    assert placements_for((None, "model"), m2) == [Replicate(), Shard(1)]
    m3 = _NamedMesh(("pod", "data", "model"))
    # k over (pod, model), pod major: both mesh dims shard tensor dim 1
    assert placements_for(("data", ("pod", "model")), m3) == [
        Shard(1), Shard(0), Shard(1)]
    with pytest.raises(ValueError, match="axis order"):
        placements_for(("data", ("model", "pod")), m3)


def test_activation_policy_is_a_noop_outside_the_context():
    import torch

    x = torch.ones(8, 32)
    assert trules.maybe_shard(x, ("batch", None)) is x
    assert trules.activation_spec((8, 32), ("batch", None)) is None
    mesh = tmesh.abstract_mesh((2, 4, 4), ("pod", "data", "model"))
    with trules.activation_sharding(mesh, tmesh.batch_axes(mesh)):
        # batch over (pod, data) = 8 divides 8; model over 32
        assert trules.activation_spec((8, 32), ("batch", "model_dim")) \
            == (("pod", "data"), "model")
        # an axis is used once (first dim wins); 6 does not divide by 8
        assert trules.activation_spec((6, 32, 16),
                                      ("batch", "model_dim", "model_dim")) \
            == (None, "model", None)
        assert trules.maybe_shard(x, ("batch", None)) is x  # plain tensor
    assert trules.activation_spec((8, 32), ("batch",)) is None


def test_production_meshes_and_helpers():
    single = tmesh.make_production_mesh()
    multi = tmesh.make_production_mesh(multi_pod=True)
    assert dict(tmesh.axis_sizes(single)) == {"data": 16, "model": 16}
    assert tmesh.n_chips(multi) == 512
    assert tmesh.batch_axes(multi) == ("pod", "data")
    assert tmesh.batch_axes(single) == ("data",)
