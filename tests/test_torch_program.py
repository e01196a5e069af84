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
