"""Two tensor-parallel mechanisms of the training forward against the
one-rank modules, on 4 gloo ranks (one module-scoped ``spawn_ranks``,
``_torch_tp_heads_cases.py``), in fp32 on a ``model`` axis of 2 and of
4 ranks, each rank on the same inputs and cotangents:

* GQA attention whose KV heads ``model`` splits (reduced granite-20b's
  one KV head on 2 and 4 ranks, reduced mixtral-8x7b's two on 4), the KV
  projections read whole (``models.attention.kv_whole``): the output on
  every rank equals the one-rank layer's; ``wq``'s columns and ``wo``'s
  rows are this rank's slices of the one-rank gradients; ``wk`` and
  ``wv``'s gradients, summed over ``model`` as ``train.fsdp``'s
  reduce-scatter sums them, equal the one-rank ones, and no rank's own
  part is the whole (its query heads read the KV head in part); the
  input's gradient (summed by ``copy_to_model``) equals the one-rank
  one.
* musicgen-large's codebook heads, each rank its ``vocab`` columns, and
  the vocab-parallel loss over codebook labels and a mask: the loss, the
  heads' gradient (this rank's columns) and the input's gradient, which
  is whole only if the codebook branch sums the ranks' parts
  (``copy_to_model``).
* The bytes each case hands to ``model`` by site."""

import numpy as np
import pytest

import _torch_tp_heads_cases as C
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


ATTN_IDS = [f"{a}-tp{tp}" for a, tp in C.ATTN_CASES]


@pytest.mark.parametrize("arch,tp", C.ATTN_CASES, ids=ATTN_IDS)
def test_whole_kv_head_attention_matches_one_rank(port, arch, tp):
    from repro_torch.models.attention import kv_whole

    assert kv_whole(C.cfg(arch), tp)
    for out in port:
        got = out[tp][arch]
        want_out, want = out["one"][arch]
        label = f"{arch} rank {out['rank']} tp {tp}"
        _close(got["out"], want_out, f"{label} out")
        lo, hi = got["cols"]
        _close(got["grads"]["x"], want["x"], f"{label} x")
        _close(got["grads"]["wq"], want["wq"][:, lo:hi], f"{label} wq")
        _close(got["grads"]["wo"], want["wo"][lo:hi], f"{label} wo")
        for k in ("wk", "wv"):
            _close(got["summed"][k], want[k], f"{label} {k} summed")
            # a rank's own gradient of the whole leaf is a part of it
            assert not np.allclose(got["grads"][k], want[k],
                                   rtol=RTOL), f"{label} {k}"


@pytest.mark.parametrize("arch,tp", C.ATTN_CASES, ids=ATTN_IDS)
def test_whole_kv_head_attention_wire_bytes(port, arch, tp):
    """One input gradient (``col``) and the row-parallel output (``row``),
    both (B, L, d) fp32: the whole KV leaves add nothing in the layer
    (their gather and reduce-scatter are the hooks')."""
    act = C.B * C.L * C.cfg(arch).d_model * F32
    for out in port:
        assert out[tp][arch]["wire"] == {"col": act, "row": act}, \
            out["rank"]


@pytest.mark.parametrize("tp", sorted(C.MESHES))
def test_codebook_heads_and_loss_match_one_rank(port, tp):
    for out in port:
        got = out[tp][C.HEAD_ARCH]
        want_loss, want = out["one"][C.HEAD_ARCH]
        label = f"rank {out['rank']} tp {tp}"
        np.testing.assert_allclose(got["loss"], want_loss, rtol=RTOL,
                                   err_msg=f"{label} loss")
        lo, hi = got["cols"]
        _close(got["grads"]["w"], want["w"][..., lo:hi], f"{label} w")
        _close(got["grads"]["x"], want["x"], f"{label} x")


@pytest.mark.parametrize("tp", sorted(C.MESHES))
def test_codebook_heads_wire_bytes(port, tp):
    """The input's gradient summed once (``col``, (B, L, d) fp32) and the
    loss's three statistics a codebook (``loss``, (B, L, 4) fp32)."""
    cfg = C.cfg(C.HEAD_ARCH)
    tokens = C.B * C.L
    for out in port:
        assert out[tp][C.HEAD_ARCH]["wire"] == {
            "col": tokens * cfg.d_model * F32,
            "loss": 3 * tokens * cfg.n_codebooks * F32}, out["rank"]
