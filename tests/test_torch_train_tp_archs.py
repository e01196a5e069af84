"""The port's tensor-parallel training step against the reference's for
the six archs beside ``test_torch_train_tp.py``'s, with that module's
checks and one spawn of its own (a module a test-run worker takes):

* reduced h2o-danube-3-4b (a sliding window of 8 at L = 16), minicpm3-4b
  (q-LoRA MLA, 4 heads), qwen2-vl-72b (M-RoPE over ``embeds``) and
  musicgen-large (the codebook heads and labels over ``embeds``) on
  (data 2, model 2); mixtral-8x7b (experts beside GQA, a window of 8)
  and granite-20b (one KV head, which the step reads whole, and a GELU
  MLP) on (data 2, model 2) and (data 1, model 4); mixtral's 4 experts 2
  and 1 a rank, its 2 KV heads on 4 ranks read whole too.
* Each against the reference's single-device step and, on (data 2,
  model 2), its weight-hoisted GSPMD step; the state slices, the wire
  bytes by site against the plan and the K1 programs of a step, as in
  ``test_torch_train_tp.py``.
* ``FsdpLayout.local_batch`` splits M-RoPE positions, where a batch
  carries them, as it splits the rows."""

import pytest

import _torch_train_tp_cases as C
import test_torch_train_tp as TP
from _torch_isolation import isolated_port_state  # noqa: F401  (autouse)

CASES, IDS = TP.cases(C.MORE_ARCHS)
GSPMD, GSPMD_IDS = TP.gspmd_cases(C.MORE_ARCHS)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return TP.run_both(tmp_path_factory, C.MORE_ARCHS)


@pytest.mark.parametrize("arch,mesh,mb", CASES, ids=IDS)
def test_tp_step_matches_the_single_device_reference(runs, arch, mesh, mb):
    TP.test_tp_step_matches_the_single_device_reference(runs, arch, mesh, mb)


@pytest.mark.parametrize("arch,mb", GSPMD, ids=GSPMD_IDS)
def test_tp_step_matches_the_reference_gspmd_step(runs, arch, mb):
    TP.test_tp_step_matches_the_reference_gspmd_step(runs, arch, mb)


@pytest.mark.parametrize("arch,mb", GSPMD, ids=GSPMD_IDS)
def test_reference_gspmd_step_matches_its_single_device_step(runs, arch, mb):
    TP.test_reference_gspmd_step_matches_its_single_device_step(runs, arch,
                                                                mb)


@pytest.mark.parametrize("arch,mesh,mb", CASES, ids=IDS)
def test_state_leaves_are_the_slices_of_the_state_specs(runs, arch, mesh,
                                                        mb):
    TP.test_state_leaves_are_the_slices_of_the_state_specs(runs, arch, mesh,
                                                           mb)


@pytest.mark.parametrize("arch,mesh,mb", CASES, ids=IDS)
def test_tp_wire_bytes_against_the_plan(runs, arch, mesh, mb):
    TP.test_tp_wire_bytes_against_the_plan(runs, arch, mesh, mb)


@pytest.mark.parametrize("arch,mesh,mb", CASES, ids=IDS)
def test_k1_programs_per_step_match_the_smoke_formula(runs, arch, mesh, mb):
    TP.test_k1_programs_per_step_match_the_smoke_formula(runs, arch, mesh,
                                                         mb)


MROPE = [c for c in CASES if c[0] == "qwen2-vl-72b"]


@pytest.mark.parametrize("arch,mesh,mb", MROPE,
                         ids=[i for c, i in zip(CASES, IDS) if c in MROPE])
def test_local_batch_splits_positions_as_rows(runs, arch, mesh, mb):
    _, port = runs
    key = C.case_key(arch, mb, mesh)
    for out in port:
        assert out[f"{key} positions split as the rows"], out["rank"]
