"""The port's checkpointing against the reference's: the tests of
``tests/test_checkpoint.py`` (roundtrip, atomic writes, GC, async,
verified restore with corrupt-step fallback; the elastic re-shard becomes
``device=``), and checkpoints read across the two packages: fp32 and
integer leaves written by either verify and load in the other."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_isolation import isolated_port_state  # noqa: F401
from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro_torch.checkpoint import CheckpointCorruptionError, CheckpointManager
from repro_torch.obs import get_metrics


def _tree():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "nested": {"b": torch.ones((2, 2), dtype=torch.int32)}}


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    return torch.zeros_like(tree)


def test_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    t = _tree()
    mgr.save(5, t)
    r = mgr.restore(_zeros_like(t))
    assert torch.equal(r["a"], t["a"])
    assert torch.equal(r["nested"]["b"], t["nested"]["b"])
    assert r["nested"]["b"].dtype == torch.int32
    assert mgr.latest_step() == 5


def test_keep_last_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree())
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(tmp_path))
    assert steps == [3, 4]


def test_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(9, _tree())
    mgr.wait()
    assert mgr.latest_step() == 9


def test_async_save_snapshots_before_the_write(tmp_path):
    """The host copy is taken before save_async returns: an in-place update
    right after (the next optimizer step) does not reach the file."""
    mgr = CheckpointManager(str(tmp_path))
    t = _tree()
    mgr.save_async(1, t)
    t["a"].add_(100.0)
    mgr.wait()
    r = mgr.restore(_zeros_like(t))
    assert torch.equal(r["a"], torch.arange(12.0).reshape(3, 4))


def test_restore_shape_mismatch_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree())
    bad = {"a": torch.zeros((5, 5)),
           "nested": {"b": torch.zeros((2, 2), dtype=torch.int32)}}
    with pytest.raises(ValueError):
        mgr.restore(bad)


# -- verified restore -------------------------------------------------------

def _tree_v(v: float):
    return {"a": torch.full((3, 4), v, dtype=torch.float32),
            "nested": {"b": torch.ones((2, 2), dtype=torch.int32)}}


def _like():
    return _zeros_like(_tree_v(0))


def _shard_path(tmp_path, step):
    return os.path.join(str(tmp_path), f"step_{step:010d}",
                        "host_00000.npz")


def _manifest_path(tmp_path, step):
    return os.path.join(str(tmp_path), f"step_{step:010d}",
                        "MANIFEST.json")


def _truncate(path):
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size // 2)


@pytest.mark.parametrize("corrupt", ["truncate", "manifest", "checksum"])
def test_corrupt_newest_falls_back_to_previous_step(tmp_path, corrupt):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree_v(1.0))
    mgr.save(2, _tree_v(2.0))
    if corrupt == "truncate":
        _truncate(_shard_path(tmp_path, 2))
    elif corrupt == "manifest":
        with open(_manifest_path(tmp_path, 2), "w") as f:
            f.write("{ this is not json")
    else:  # valid archive, wrong bytes -> checksum mismatch
        np.savez(_shard_path(tmp_path, 2),
                 **{"a": np.full((3, 4), 9.0, np.float32),
                    "nested/b": np.ones((2, 2), np.int32) + 7})
    assert not mgr.verify_step(2)
    assert mgr.verify_step(1)
    with pytest.warns(RuntimeWarning, match="failed verification"):
        assert mgr.latest_verifiable_step() == 1
        r = mgr.restore(_like())  # step=None: silent fallback
    assert torch.equal(r["a"], torch.full((3, 4), 1.0))
    snap = get_metrics().snapshot()
    assert snap["checkpoint.fallback_total"]["value"] == 1
    assert snap["checkpoint.corrupt_total"]["value"] >= 1
    assert snap["checkpoint.verified_total"]["value"] == 1


def test_explicit_corrupt_step_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree_v(1.0))
    _truncate(_shard_path(tmp_path, 1))
    with pytest.raises(CheckpointCorruptionError):
        mgr.restore(_like(), step=1)


def test_no_verifiable_step_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree_v(1.0))
    _truncate(_shard_path(tmp_path, 1))
    with pytest.warns(RuntimeWarning), \
            pytest.raises(CheckpointCorruptionError):
        mgr.restore(_like())


def test_legacy_manifest_without_checksums(tmp_path):
    """Checkpoints without a ``checksums`` map still restore; a truncated
    legacy shard still fails the load-check."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree_v(3.0))
    mpath = _manifest_path(tmp_path, 1)
    with open(mpath) as f:
        manifest = json.load(f)
    del manifest["checksums"]
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    assert mgr.verify_step(1)
    r = mgr.restore(_like())
    assert torch.equal(r["a"], torch.full((3, 4), 3.0))
    _truncate(_shard_path(tmp_path, 1))
    assert not mgr.verify_step(1)


def test_gc_keeps_last_known_good(tmp_path):
    """GC never deletes the step the last restore fell back to, even when
    ``keep_last`` would otherwise drop it."""
    mgr = CheckpointManager(str(tmp_path), keep_last=3)
    for s in (1, 2, 3):
        mgr.save(s, _tree_v(float(s)))
    _truncate(_shard_path(tmp_path, 3))
    with pytest.warns(RuntimeWarning):
        r = mgr.restore(_like())  # falls back to step 2: last-known-good
    assert torch.equal(r["a"], torch.full((3, 4), 2.0))
    mgr.keep_last = 1
    mgr._gc()
    remaining = sorted(int(n.split("_")[1]) for n in os.listdir(tmp_path))
    assert 2 in remaining      # pinned last-known-good survives
    assert 1 not in remaining  # ordinary old step collected


def test_restore_onto_a_device_and_shardings_refused(tmp_path):
    """Leaves land on the named device in the ``like`` dtypes; the
    reference's elastic re-shard (its shardings argument, no longer
    refused) keeps a leaf with no sharding whole and gives a sharded leaf
    this rank's slice (rank 2 of 4 along ``data``: rows 4-5).  Ranks of
    real meshes: ``tests/test_torch_train_dist.py``."""
    from repro_torch.sharding.rules import NamedSharding

    class Rank2Of4:
        mesh_dim_names = ("data",)
        shape = (4,)

        @staticmethod
        def get_local_rank(axis):
            return 2

    mgr = CheckpointManager(str(tmp_path))
    w = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    mgr.save(1, {"w": w})
    r = mgr.restore({"w": torch.zeros(8, 8, dtype=torch.float64)},
                    device="cpu")
    assert r["w"].dtype == torch.float64 and r["w"].device.type == "cpu"
    assert torch.equal(r["w"], w.double())
    r = mgr.restore({"w": torch.zeros(8, 8)}, shardings={"w": None})
    assert torch.equal(r["w"], w)
    r = mgr.restore({"w": torch.zeros(8, 8)}, device="cpu", shardings={
        "w": NamedSharding(Rank2Of4(), ("data", None))})
    assert torch.equal(r["w"], w[4:6])


# -- the port's own trees ---------------------------------------------------

def test_bf16_train_state_and_qtensor_roundtrip(tmp_path):
    from repro_torch.configs import get_reduced
    from repro_torch.models import common as tcm
    from repro_torch.train import step as T

    cfg = get_reduced("stablelm-1.6b")
    state = T.init_state(cfg, 0, "cpu")
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, state)
    like = T.init_state(cfg, 1, "cpu")
    r = mgr.restore(like)
    assert type(r) is type(state) and type(r.opt) is type(state.opt)
    for k in state.params:
        assert torch.equal(r.params[k], state.params[k])
        assert torch.equal(r.opt.m[k], state.opt.m[k])
    assert int(r.step) == int(state.step)
    bf = {k: v.to(torch.bfloat16) for k, v in state.params.items()}
    q = tcm.quantize_params(bf)
    mgr.save(1, q)
    rq = mgr.restore(q)
    manifest = json.load(open(_manifest_path(tmp_path, 1)))
    for k, v in q.items():
        if isinstance(v, torch.Tensor):
            assert rq[k].dtype == v.dtype and torch.equal(rq[k], v)
            if v.dtype == torch.bfloat16:
                assert manifest["dtypes"][k] == "bfloat16"
        else:
            assert torch.equal(rq[k].data, v.data)
            assert torch.equal(rq[k].scale, v.scale)
    # restore_quantized of a dense train state's params
    rq2 = mgr.restore_quantized(bf, step=0, subtree="params")
    for k, v in q.items():
        got = rq2[k]
        if isinstance(v, torch.Tensor):
            assert torch.equal(got, v)
        else:
            assert torch.equal(got.data, v.data)
            assert torch.equal(got.scale, v.scale)


# -- across the two packages ------------------------------------------------

def test_port_checkpoint_loads_in_the_reference(tmp_path):
    CheckpointManager(str(tmp_path)).save(3, _tree_v(4.5))
    jmgr = JCheckpointManager(str(tmp_path))
    assert jmgr.verify_step(3)
    jlike = {"a": jnp.zeros((3, 4), jnp.float32),
             "nested": {"b": jnp.zeros((2, 2), jnp.int32)}}
    r = jmgr.restore(jlike)
    np.testing.assert_array_equal(np.asarray(r["a"]),
                                  np.full((3, 4), 4.5, np.float32))
    np.testing.assert_array_equal(np.asarray(r["nested"]["b"]),
                                  np.ones((2, 2), np.int32))
    assert np.asarray(r["nested"]["b"]).dtype == np.int32


def test_reference_checkpoint_loads_in_the_port(tmp_path):
    jt = {"a": jnp.arange(12, dtype=jnp.float32).reshape(3, 4),
          "nested": {"b": jnp.full((2, 2), 7, jnp.int32)}}
    JCheckpointManager(str(tmp_path)).save(2, jt)
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.verify_step(2)
    r = mgr.restore(_like())
    assert torch.equal(r["a"], torch.arange(12.0).reshape(3, 4))
    assert torch.equal(r["nested"]["b"],
                       torch.full((2, 2), 7, dtype=torch.int32))
    assert get_metrics().snapshot()["checkpoint.verified_total"][
        "value"] == 1


def test_reference_train_state_params_load_in_the_port(tmp_path):
    """The reference's fp32 masters, saved as its train state, restore into
    the port's params by their ``params/<name>`` keys (``subtree``)."""
    from repro.configs import get_reduced as jax_reduced
    from repro.train import step as JT
    from repro_torch.configs import get_reduced
    from repro_torch.models import model as TM

    jstate = JT.init_state(jax_reduced("stablelm-1.6b"),
                           jax.random.PRNGKey(0))
    JCheckpointManager(str(tmp_path)).save(0, jstate)
    jp = {k: np.asarray(v) for k, v in jstate.params.items()}
    like = TM.params_from_jax(jp, get_reduced("stablelm-1.6b"),
                              device="cpu")
    like = {k: torch.zeros_like(v) for k, v in like.items()}
    r = CheckpointManager(str(tmp_path)).restore(like, subtree="params")
    want = TM.params_from_jax(jp, get_reduced("stablelm-1.6b"),
                              device="cpu")
    for k in want:
        assert torch.equal(r[k], want[k].to(like[k].dtype)), k
