"""The tensor-parallel Mamba2 mixer (``models.ssm.mamba2_apply`` inside
``core.distributed.model_parallel``) against the one-rank mixer, on 4
gloo ranks (one module-scoped ``spawn_ranks``, ``_torch_ssm_tp_cases.py``):
reduced mamba2-370m in fp32, a ``model`` axis of 2 and of 4 ranks, each
rank running its ``h / tp`` heads on the same input and cotangent.

* The output on every rank equals the one-rank mixer's at rtol 1e-5.
* Every gradient, after the partial sums ``train.fsdp`` takes (the fused
  leaves and the per-head vectors summed over ``model``; ``norm`` and
  ``out_proj``'s rows this rank's slices; the input's summed by
  ``copy_to_model``), equals the one-rank mixer's at rtol 1e-5.
* The gated norm's statistic alone, the loss reading none of the last
  rank's channels: that rank's input gradient is not zero and equals the
  one-rank norm's, which it is only if the backward sums the statistic's
  gradient over ``model``.
* The bytes the mixer hands to ``model``: one (B, L, 1) fp32 statistic
  forward and one backward (``ssm_norm``), the input gradient (``col``)
  and the row-parallel output (``row``)."""

import numpy as np
import pytest

import _torch_ssm_tp_cases as C
from _torch_isolation import isolated_port_state  # noqa: F401  (autouse)
from repro_torch.launch.mesh import spawn_ranks

RTOL, ATOL = 1e-5, 1e-6
F32 = 4


@pytest.fixture(scope="module")
def port():
    return spawn_ranks(C.port_ranks, C.WORLD, timeout=180)


def _close(got, want, label):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * scale,
                               err_msg=label)


@pytest.mark.parametrize("tp", sorted(C.MESHES))
def test_tp_mixer_output_matches_one_rank(port, tp):
    for out in port:
        _close(out[tp]["out"], out["one"][0], f"rank {out['rank']} tp {tp}")


@pytest.mark.parametrize("tp", sorted(C.MESHES))
def test_tp_mixer_gradients_match_one_rank(port, tp):
    cfg = C.cfg()
    di = cfg.ssm.d_inner(cfg.d_model)
    for out in port:
        got, want = out[tp], out["one"][1]
        rows = slice(got["index"] * di // tp, (got["index"] + 1) * di // tp)
        label = f"rank {out['rank']} tp {tp}"
        _close(got["grads"]["x"], want["x"], f"{label} x")
        _close(got["grads"]["norm"], want["norm"][rows], f"{label} norm")
        _close(got["grads"]["out_proj"], want["out_proj"][rows],
               f"{label} out_proj")
        for k, v in got["summed"].items():
            _close(v, want[k], f"{label} {k}")
        # a rank's own part of the per-head vectors: its heads alone
        hl = got["heads"]
        mine = slice(got["index"] * hl, (got["index"] + 1) * hl)
        for k in ("a_log", "d_skip", "dt_bias"):
            g = got["grads"][k]
            assert not np.any(np.delete(g, np.r_[mine])), (label, k)


@pytest.mark.parametrize("tp", sorted(C.MESHES))
def test_tp_columns_are_the_heads_of_each_rank(port, tp):
    """Each rank's in_proj columns: its z, x and dt columns and all of
    B and C; the ranks' z, x and dt columns tile the leaf."""
    cfg = C.cfg()
    s = cfg.ssm
    di, h = s.d_inner(cfg.d_model), s.n_heads(cfg.d_model)
    gn = s.n_groups * s.d_state
    owned = set()
    for out in port:
        cols = out[tp]["columns"]["in_proj"]
        width = sum(b - a for a, b in cols)
        assert width == 2 * di // tp + 2 * gn + h // tp
        assert cols[2] == (2 * di, 2 * di + 2 * gn)
        if out["rank"] < tp:            # one model group
            owned.update(i for a, b in cols for i in range(a, b))
    assert owned == set(range(2 * di + 2 * gn + h))


@pytest.mark.parametrize("tp", sorted(C.MESHES))
def test_gated_norm_backward_sums_over_model(port, tp):
    cfg = C.cfg()
    di = cfg.ssm.d_inner(cfg.d_model)
    for out in port:
        got = out[tp]["norm"]
        label = f"rank {out['rank']} tp {tp}"
        _close(got["out"], got["want out"], f"{label} out")
        _close(got["dy"], got["want dy"], f"{label} dy")
        if out[tp]["index"] == tp - 1:   # the loss reads none of these
            assert np.abs(got["dy"]).max() > 0, label
    assert di % tp == 0


@pytest.mark.parametrize("tp", sorted(C.MESHES))
def test_tp_mixer_wire_bytes(port, tp):
    cfg = C.cfg()
    tokens = C.B * C.L
    act = tokens * cfg.d_model * F32
    stat = tokens * F32
    for out in port:
        assert out[tp]["wire"] == {
            "col": act, "row": act,
            # the mixer's statistic forward and backward, then the norm
            # case's
            "ssm_norm": 4 * stat}, out["rank"]
