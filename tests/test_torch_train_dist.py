"""The port's distributed training path against the reference's.

The compressed gradient reduction's single-rank halves
(``quantize_int8``, ``compress_grads``/``decompress_grads`` with 50
error-feedback steps) are bit-equal to the reference's on seeded numpy
inputs.  Everything else runs once as 4 gloo ranks (one module-scoped
``spawn_ranks``) beside the reference's side in a subprocess with 4
forced host devices (``_torch_train_dist_cases.py``), on the same numpy
inputs:

* ``allreduce_compressed`` over a 4-rank axis in modes none, bf16 and
  int8, three rounds feeding the residual back, against the reference's
  under ``shard_map``: values at rtol 1e-6, residuals to one fp32 ulp of
  each round's largest gradient, summed over the rounds so far (the
  reference's XLA may round ``gf - q · scale`` once where the port
  rounds twice, and a residual carries into the next round).
* The FSDP step (``train.fsdp.weight_hoist``) on (data 2) and (pod 2,
  data 2), microbatches 1 and 2, reduced stablelm-1.6b and
  deepseek-v2-lite-16b (the MoE aux), each rank's mask holding another
  count of tokens, 2 steps, fp32, against the reference's single-device
  ``build_train_step`` on the whole batch: loss and ``grad_norm`` at rtol
  1e-5; the gathered parameters at rtol 2e-4, atol 2e-5, against the
  port's own single-process step on the whole batch and against the
  reference's.  Against the reference, the parameters whose first
  gradient in the reference's step (its first moment over 1 - b1) is
  nonzero and within 10 Adam eps are exempt, and counted (at most one
  in a thousand; 46-108 of 147,776-223,104 here): there Adam's first
  update, g / (|g| + eps), turns any other summation order into a move
  of up to lr (e.g. 4.6e-8 at stablelm's ``blocks/mlp/w_gate[0, 13,
  46]``).  The rule reads the reference's gradient of the same case: a
  MoE step's first gradient depends on its microbatches (deepseek's
  ``blocks/moe/shared/w_down[0, 56, 56]``: 2.0e-4 with 1, 7.7e-9 with
  2).
* On a mesh with model > 1 whose layout the tensor-parallel step lacks
  (SSD heads or query heads split over ``model``) an arch builds its
  hooks (the dry run plans with them) and refuses to step, naming what
  is missing.
* Elastic restore: the reference's checkpoint restores on 1, 2 and 4
  ranks, each rank's shards bit-equal to their slices of what ``np.load``
  reads from its file; a port state saved from 4 ranks (blocking and
  async) restores on 2 and on 4 bit-equal; a corrupt newest step falls
  back to the step before it."""

import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_train_dist_cases as C
from _torch_isolation import isolated_port_state  # noqa: F401  (autouse)
from repro.optim import adamw as jadamw
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.optim import adamw
from repro_torch.train import step as T

REPO = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(rtol=2e-4, atol=2e-5)
# Adam's first update is lr · g / (|g| + eps): where the reference's
# first clipped gradient is nonzero and within 10 eps of zero, any two
# summation orders move it by up to ~lr, so those parameters alone (at
# most one in a thousand) are not held to the reference.
NEAR_EPS = 10 * adamw.AdamWConfig().eps


def test_quantize_int8_is_the_reference_bit_for_bit():
    r = np.random.RandomState(0)
    for scale in (0.01, 1.0, 0.0):
        g = (r.randn(128) * scale).astype(np.float32)
        q, s = adamw.quantize_int8(torch.from_numpy(g))
        jq, js = jadamw.quantize_int8(jnp.asarray(g))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert float(s) == float(js)
        np.testing.assert_array_equal(
            adamw.dequantize_int8(q, s).numpy(),
            np.asarray(jadamw.dequantize_int8(jq, js)))


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_compress_with_error_feedback_is_the_reference_bit_for_bit(mode):
    """The reference's ``tests/test_optim.py`` error-feedback run (50
    steps), both packages side by side: payloads, decompressed values and
    residuals bit-equal; the accumulated compressed signal plus the
    residual is the true sum."""
    r = np.random.RandomState(1)
    ef, jef = {"g": torch.zeros(64)}, {"g": jnp.zeros(64)}
    true_sum = np.zeros(64, np.float32)
    comp_sum = np.zeros(64, np.float32)
    for _ in range(50):
        g = r.randn(64).astype(np.float32) * 1e-3
        payload, ef = adamw.compress_grads({"g": torch.from_numpy(g)}, ef,
                                           mode=mode)
        jpayload, jef = jadamw.compress_grads({"g": jnp.asarray(g)}, jef,
                                              mode=mode)
        deq = adamw.decompress_grads(payload, mode=mode)["g"].numpy()
        jdeq = np.asarray(jadamw.decompress_grads(jpayload, mode=mode)["g"])
        np.testing.assert_array_equal(deq, jdeq)
        np.testing.assert_array_equal(ef["g"].numpy(), np.asarray(jef["g"]))
        true_sum += g
        comp_sum += deq
    np.testing.assert_allclose(comp_sum + ef["g"].numpy(), true_sum,
                               atol=1e-5)
    assert adamw.compress_grads({"g": torch.ones(2)}, ef, "none")[1] is ef


def _env():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides at once: the reference's in a subprocess while the
    port's 4 ranks run (they wait for its checkpoint at the end)."""
    out_dir = tmp_path_factory.mktemp("train_dist")
    proc = subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "_torch_train_dist_cases.py"),
         str(out_dir)], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        port = spawn_ranks(C.port_ranks, C.WORLD, (str(out_dir),),
                           timeout=180)
        log, _ = proc.communicate(timeout=180)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, log
    return dict(np.load(out_dir / "ref.npz")), port


@pytest.fixture(scope="module")
def single():
    """The port's single-process step on the whole batch, each case."""
    out = {}
    for arch in C.ARCHS:
        cfg = C.small_cfg(arch)
        p0 = {k: torch.from_numpy(v) for k, v in C.masters(arch).items()}
        b = T.cast_batch(C.batch(arch), cfg, "cpu")
        for mb in C.MICROBATCHES:
            state = T.TrainState(torch.zeros((), dtype=torch.int32), p0,
                                 adamw.init(p0))
            step = T.build_train_step(cfg, adamw.AdamWConfig(**C.OPT),
                                      microbatches=mb)
            for _ in range(C.STEPS):
                state, _m = step(state, b)
            out[C.case_key(arch, mb)] = {k: v.numpy()
                                         for k, v in state.params.items()}
    return out


@pytest.mark.parametrize("mode", C.MODES)
def test_allreduce_compressed_matches_the_reference(runs, mode):
    ref, port = runs
    grads, _ = C.compress_inputs()
    for leaf in ("w", "b"):
        ulps = 0.0
        for i in range(C.EF_ROUNDS):
            want = ref[f"ar {mode} {i} red {leaf}"]
            # each round's residual carries the rounding of the rounds
            # before it: one ulp of each round's largest gradient
            ulps += float(np.spacing(np.float32(max(
                np.abs(grads[r][i][leaf]).max() for r in range(C.WORLD)))))
            for r, out in enumerate(port):
                np.testing.assert_allclose(out[f"ar {mode} {i} red {leaf}"],
                                           want[r], rtol=1e-6, atol=0)
                np.testing.assert_allclose(
                    out[f"ar {mode} {i} ef {leaf}"],
                    ref[f"ar {mode} {i} ef {leaf}"][r], rtol=0, atol=ulps)


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_allreduce_error_feedback_identity(runs, mode):
    """Over the rounds, the reduced means plus the mean of the residuals
    left equal the mean of the true gradients plus the mean of the
    starting residuals (nothing is lost, only carried)."""
    _, port = runs
    grads, ef0 = C.compress_inputs()
    for leaf in ("w", "b"):
        sent = sum(port[0][f"ar {mode} {i} red {leaf}"].astype(np.float64)
                   for i in range(C.EF_ROUNDS))
        left = np.mean([out[f"ar {mode} {C.EF_ROUNDS - 1} ef {leaf}"]
                        for out in port], axis=0)
        true = np.mean([sum(grads[r][i][leaf].astype(np.float64)
                            for i in range(C.EF_ROUNDS)) + ef0[r][leaf]
                        for r in range(C.WORLD)], axis=0)
        scale = max(np.abs(true).max(), 1e-30)
        np.testing.assert_allclose(sent + left, true, rtol=0,
                                   atol=1e-6 * scale)


def test_every_rank_holds_another_count_of_masked_tokens(runs):
    _, port = runs
    for mesh, _ in C.MESHES:
        counts = [out[f"{mesh} mask tokens"] for out in port]
        assert len(set(counts[:2])) == 2, (mesh, counts)


CASES = [(a, m, mb) for a in C.ARCHS for m, _ in C.MESHES
         for mb in C.MICROBATCHES]


@pytest.mark.parametrize("arch,mesh,mb", CASES,
                         ids=[f"{a}-{m}-mb{mb}" for a, m, mb in CASES])
def test_fsdp_step_matches_the_reference(runs, single, arch, mesh, mb):
    ref, port = runs
    key, rkey = C.case_key(arch, mb, mesh), C.case_key(arch, mb)
    for i in range(C.STEPS):
        for name in ("loss", "grad_norm", "aux"):
            want = float(ref[f"{rkey} {name} {i}"])
            for out in port:           # every rank reports the global step
                got = out[f"{key} {name} {i}"]
                if name == "aux" and want == 0.0:
                    assert got == 0.0
                else:
                    np.testing.assert_allclose(got, want, rtol=1e-5,
                                               err_msg=f"{name} step {i}")
    if arch.startswith("deepseek"):
        assert float(ref[f"{rkey} aux 0"]) > 0
    exempt = total = 0
    for k, one in single[rkey].items():
        got = port[0][f"{key} param {k}"]
        for out in port[1:]:
            np.testing.assert_array_equal(out[f"{key} param {k}"], got)
        np.testing.assert_allclose(got, one, **TOL, err_msg=k)
        g0 = np.abs(ref[f"{rkey} grad0 {k}"])
        near = (g0 > 0) & (g0 <= NEAR_EPS)
        exempt += int(near.sum())
        total += near.size
        want = ref[f"{rkey} param {k}"]
        np.testing.assert_allclose(got[~near], want[~near], **TOL, err_msg=k)
    print(f"{key}: {exempt} of {total} parameters exempt (first gradient "
          f"within {NEAR_EPS:g})")
    assert exempt <= total // 1000, (exempt, total)


def test_model_axis_above_one_refuses_to_step(runs):
    """Each arch on a mesh whose layout the tensor-parallel step lacks
    raises, naming itself and what is missing: mamba2-370m on a model
    axis that does not divide its SSD heads, minicpm3-4b on one that
    splits its query heads."""
    _, port = runs
    for arch, words in C.TP_REFUSED.items():
        for msg in port[0][f"model axis errors {arch}"]:
            assert msg and arch in msg and words in msg, (arch, msg)


@pytest.mark.parametrize("ranks", [1, 2, 4])
def test_reference_checkpoint_restores_on_any_world_size(runs, ranks):
    _, port = runs
    sizes = set()
    for out in port:
        got = out[f"ref ckpt on {ranks}"]
        assert got["equal"] and got["keys"] == 38
        sizes.add(got["local elements"])
    full = port[0]["ref ckpt on 1"]["local elements"]
    # the FSDP leaves split over the ranks; the scalars stay whole
    assert sizes == {port[0][f"ref ckpt on {ranks}"]["local elements"]}
    assert full // ranks <= sizes.pop() <= full // ranks + 2


def test_port_state_saved_on_four_ranks_restores_on_two(runs):
    _, port = runs
    for out in port:
        assert out["port 4->2 bit-equal"]
        assert out["port 4->4 equal own shards"]


def test_corrupt_newest_step_falls_back(runs):
    _, port = runs
    for out in port:
        assert out["fallback count"] == 1
        assert out["fallback bit-equal step 1"]
