"""The port's fault-tolerance runtime against the reference's: heartbeat
detection, straggler detection and supervised restart/resize (the tests
of ``tests/test_runtime.py``, each also run through the reference's
classes on the same inputs), and a crash-and-resume run of the port's
training launcher, bit-equal to the uninterrupted run."""

import pytest
import torch

from _torch_isolation import isolated_port_state  # noqa: F401
from repro.runtime import fault as jfault
from repro_torch.checkpoint import CheckpointManager
from repro_torch.obs import get_metrics
from repro_torch.runtime import fault as tfault
from repro_torch.runtime.fault import (HeartbeatMonitor, ResizeEvent,
                                       TrainSupervisor)


@pytest.mark.parametrize("mod", [tfault, jfault], ids=["port", "reference"])
def test_dead_host_detection(mod):
    mon = mod.HeartbeatMonitor(4, timeout_s=10.0, clock=lambda: 0.0)
    for h in range(4):
        mon.beat(h, step=0, now=0.0)
    for h in range(3):
        mon.beat(h, step=1, now=15.0)   # host 3 never beats again
    assert mon.dead_hosts(now=20.0) == [3]
    assert mon.dead_hosts(now=11.0) == [3]
    assert mon.dead_hosts(now=15.5) == [3]


def test_straggler_detection():
    mons = [HeartbeatMonitor(8, straggler_z=2.0),
            jfault.HeartbeatMonitor(8, straggler_z=2.0)]
    t = [0.0] * 8
    for step in range(1, 8):
        for h in range(8):
            dt = 1.0 if h != 5 else 3.0   # host 5 is 3x slower
            t[h] += dt
            for mon in mons:
                mon.beat(h, step=step, now=t[h])
    assert mons[0].stragglers() == mons[1].stragglers() == [5]


def _supervised_run(mod, ckpt, zero, one):
    """The reference test's scenario: a crash at step 5 and a resize to 2
    hosts at step 12 of a 20-step counter run, checkpointed every 4
    steps; returns the report and the (step, hosts) log."""
    inj = mod.FailureInjector({5: "crash", 12: "resize:2"})
    log = []

    def make_runner(start_step, n_hosts):
        def gen():
            state = {"x": zero}
            if ckpt.latest_step() is not None:
                state = ckpt.restore(state)
                start = ckpt.latest_step() + 1
            else:
                start = start_step
            for step in range(start, 20):
                state = {"x": state["x"] + one}
                log.append((step, n_hosts))
                kind = inj.check(step)
                if kind == "crash":
                    raise mod.SimulatedFailure()
                if kind and kind.startswith("resize"):
                    ckpt.save(step, state)
                    raise mod.ResizeEvent(int(kind.split(":")[1]))
                if step % 4 == 0:
                    ckpt.save(step, state)
                yield step
        return gen()

    report = mod.TrainSupervisor(ckpt, save_every=4).run(
        make_runner, total_steps=20, n_hosts=4)
    return report, log


def test_supervisor_restart_and_resize(tmp_path):
    """Injected crash + resize; training state resumes from checkpoint;
    the report and the log equal the reference supervisor's."""
    import jax.numpy as jnp
    from repro.checkpoint.manager import CheckpointManager as JManager

    report, log = _supervised_run(
        tfault, CheckpointManager(str(tmp_path / "port")), torch.zeros(()),
        1)
    jreport, jlog = _supervised_run(
        jfault, JManager(str(tmp_path / "ref")), jnp.zeros(()), 1)
    assert (report.restarts, report.resizes, report.final_step) == (1, 1, 20)
    assert (report.restarts, report.resizes, report.final_step,
            report.events) == (jreport.restarts, jreport.resizes,
                               jreport.final_step, jreport.events)
    assert log == jlog
    assert any(h == 2 for _, h in log)
    assert set(s for s, _ in log) == set(range(20))
    labels = get_metrics().snapshot()["fault.events_total"]["labels"]
    assert labels == {"kind=injected:crash": 1.0,
                      "kind=injected:resize": 1.0, "kind=restart": 1.0,
                      "kind=resize": 1.0}


def test_resume_after_step_zero_checkpoint(tmp_path):
    """A checkpoint at step 0 resumes at step 1."""
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(0, {"x": torch.zeros(())})
    starts, executed = [], []

    def make_runner(start_step, n_hosts):
        def gen():
            starts.append(start_step)
            for step in range(start_step, 4):
                executed.append(step)
                yield step
        return gen()

    report = TrainSupervisor(ckpt).run(make_runner, total_steps=4,
                                       n_hosts=1)
    assert starts == [1]
    assert executed == [1, 2, 3]
    assert report.final_step == 4


def test_resize_storm_is_bounded(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))

    def make_runner(start_step, n_hosts):
        def gen():
            raise ResizeEvent(max(1, n_hosts - 1))
            yield  # pragma: no cover - generator shape
        return gen()

    with pytest.raises(ResizeEvent):
        TrainSupervisor(ckpt, max_resizes=3).run(make_runner,
                                                 total_steps=10, n_hosts=8)


def test_launcher_crash_and_resume_is_bit_equal(tmp_path):
    """run_training with a checkpoint every step and an async save, a crash
    after step 2 has run (before it is saved), then a resume from step
    1's checkpoint: step 2's loss and every leaf of the final state equal
    the uninterrupted run's, bit for bit."""
    from repro_torch.launch.train import run_training

    # One intra-op thread: the CPU's threaded reductions split their sums
    # by thread, which is not what this test is about.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        kw = dict(seq_len=16, global_batch=4, device="cpu", log_every=100)
        want, want_losses = run_training("stablelm-1.6b", 4, **kw)
        ckpt = str(tmp_path / "ckpt")
        with pytest.raises(RuntimeError, match="injected failure at step 2"):
            run_training("stablelm-1.6b", 4, ckpt_dir=ckpt, ckpt_every=1,
                         fail_at=2, **kw)
        assert CheckpointManager(ckpt).latest_step() == 1
        got, losses = run_training("stablelm-1.6b", 4, ckpt_dir=ckpt,
                                   ckpt_every=1, resume=True, **kw)
    finally:
        torch.set_num_threads(threads)
    assert losses == want_losses[2:]
    assert int(got.step) == int(want.step) == 4
    for k in want.params:
        assert torch.equal(got.params[k], want.params[k]), k
        assert torch.equal(got.opt.m[k], want.opt.m[k]), k
        assert torch.equal(got.opt.v[k], want.opt.v[k]), k
    assert torch.equal(got.opt.count, want.opt.count)
    assert CheckpointManager(ckpt).latest_step() == 3
