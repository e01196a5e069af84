"""The port's program specs and tags against the reference's: every tag
parses and re-emits byte-identical, with field-equal specs."""

import dataclasses

import pytest

from repro.kernels import program as jprog
from repro_torch.kernels import program as tprog

TAGS = [
    # main path
    "none", "res", "rms>glu.silu(none|none)",
    # single-branch drain chains
    "bias", "gelu", "silu", "relu", "mul", "bias+gelu", "silu+mul",
    "bias+gelu+mul+res", "rms>none", "rms>bias+relu",
    # grammar the later slices run
    "glu.gelu(bias|bias)", "dual(none|bias)", "dact.silu>none",
    "dact.gelu@b>none", "dqb+res", "dqab+bias+silu",
    "rms>glu.silu(dqb|dqb)", "glu.silu(dqab|dqab)",
]


@pytest.mark.parametrize("tag", TAGS)
def test_tag_round_trip_matches_reference(tag):
    want = jprog.program_from_tag(tag)
    got = tprog.program_from_tag(tag)
    assert want.tag() == tag
    assert got.tag() == tag
    assert tprog.program_tag(got) == jprog.program_tag(want)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("tag", ["wat>none", "glu.silu(nonsense|none)",
                                 "glu.silu(none)", "bias+tanh",
                                 "dact.silu@b>glu.silu(none|none)",
                                 "glu.silu(res|none)"])
def test_malformed_tags_raise_in_both(tag):
    with pytest.raises(ValueError):
        jprog.program_from_tag(tag)
    with pytest.raises(ValueError):
        tprog.program_from_tag(tag)


# ---------------------------------------------------------------------------
# The cost half: every tag the reference's tuning/workload.py mints
# ---------------------------------------------------------------------------

def _workload_tags():
    """Every program tag of the reference's workloads on every reduced
    config: forward and training layouts, bf16, w8 and w8a8 (drawn once,
    at import, from the reference's own workload functions)."""
    from repro.configs import get_reduced, list_archs
    from repro.tuning.workload import model_gemm_workloads, quantize_workloads

    tags = set()
    for arch in list_archs():
        cfg = get_reduced(arch)
        for rows in (1, 32):
            loads = model_gemm_workloads(cfg, rows, train=True)
            tags.update(w[3] for w in loads)
            fwd = [w for w in loads if w[4] == "nn"]
            for acts in (False, True):
                tags.update(w[3] for w in quantize_workloads(fwd, acts=acts))
    return sorted(tags)


WORKLOAD_TAGS = _workload_tags()


def test_workload_tags_cover_the_program_kinds():
    kinds = {"none", "res", "rms>glu.silu(none|none)", "glu.silu(dqab|dqab)",
             "rms>glu.silu(dqb|dqb)", "dact.silu@b>none", "dqab+res"}
    assert kinds <= set(WORKLOAD_TAGS), kinds - set(WORKLOAD_TAGS)


@pytest.mark.parametrize("tag", WORKLOAD_TAGS)
def test_program_cost_matches_reference(tag):
    assert dataclasses.asdict(tprog.program_cost(tag)) == \
        dataclasses.asdict(jprog.program_cost(tag))
    assert tprog.program_activation(tag) == jprog.program_activation(tag)
    for mode in ("b", "ab"):
        try:
            want = jprog.program_with_dequant(tag, mode)
        except ValueError:
            with pytest.raises(ValueError):
                tprog.program_with_dequant(tag, mode)
            continue
        assert tprog.program_with_dequant(tag, mode) == want


@pytest.mark.parametrize("tag", WORKLOAD_TAGS)
def test_synthetic_operands_match_reference_shapes_and_dtypes(tag):
    import jax.numpy as jnp
    import torch

    m, n, k = 5, 24, 16
    want = jprog.synthetic_operands(tag, m, n, k, jnp.bfloat16)
    gen = torch.Generator().manual_seed(0)
    got = tprog.synthetic_operands(tag, m, n, k, torch.bfloat16,
                                   generator=gen)
    assert set(got) == set(want)
    for name, t in got.items():
        assert tuple(t.shape) == tuple(want[name].shape), name
        assert str(t.dtype).removeprefix("torch.") == \
            str(want[name].dtype), name
        # drawn from the generator in [0.5, 1.5): positive like the ones
        assert bool(((t.float() >= 0.5) & (t.float() <= 1.5)).all())
