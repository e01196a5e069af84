"""Training launcher (port of ``repro/launch/train.py``): data pipeline,
train step, checkpoints and a heartbeat for any architecture of
``configs.list_archs()`` (the token families, and the vlm and audio
families over the pipeline's precomputed ``embeds`` and codebook
labels), on the card by default.

  PYTHONPATH=src python -m repro_torch.launch.train --arch ARCH \
      --steps 3 --full [--microbatches 4] [--ckpt-dir DIR --ckpt-every N \
      [--resume]]

``ARCH`` is any of ``configs.list_archs()`` (stablelm-1.6b,
deepseek-v2-lite-16b, mamba2-370m, zamba2-7b, qwen2-vl-72b,
musicgen-large, ...).  Without ``--full`` it trains the reduced config;
with it the published one, whose fp32 masters and AdamW moments
(~16 bytes a parameter) must fit the card.  Each step runs under a
``train.step`` trace span and feeds the metrics registry as the
reference's launcher does: ``train.step_seconds`` (histogram; the step
ends in the loss's read to the host), ``train.steps_total``,
``train.loss`` and ``train.tokens_per_second``; a
:class:`~repro_torch.runtime.fault.HeartbeatMonitor` takes a beat after
each step.  ``--trace PATH`` writes the spans, ``--metrics`` prints the
metrics report at the end.

With ``ckpt_dir`` the state is saved (``CheckpointManager.save_async``)
after every ``ckpt_every``-th step and after the last; ``resume``
restores the newest verified step and continues at its step + 1.  The
batch of step i is a function of i alone (``data.pipeline.batch_at``),
so a resumed run is bit-equal to an uninterrupted one on the same device.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config, get_reduced, list_archs
from repro_torch.data.pipeline import (DataConfig, batch_for_model,
                                      embed_table)
from repro_torch.models.model import resolve_device
from repro_torch.obs import (disable_tracing, enable_tracing, get_metrics,
                             span)
from repro_torch.optim import adamw
from repro_torch.runtime.fault import HeartbeatMonitor
from repro_torch.train import step as T


def run_training(
    arch: str,
    steps: int,
    *,
    full: bool = False,
    seq_len: int = 64,
    global_batch: int = 8,
    microbatches: int = 1,
    lr: float = 1e-3,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 25,
    resume: bool = False,
    seed: int = 0,
    log_every: int = 10,
    fail_at: Optional[int] = None,
    device=None,
    layers: Optional[int] = None,
):
    """Train ``arch`` for ``steps`` steps on ``device`` (``None`` is the
    card); returns the final TrainState and the losses of the steps this
    call ran (from the resumed step on, with ``resume``).  ``fail_at``
    raises after that step has run and before it is saved; ``layers``
    cuts the config's depth and keeps its widths."""
    cfg = get_config(arch) if full else get_reduced(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    device = resolve_device(device)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                          global_batch=global_batch, seed=seed)
    # An embeds frontend's table is drawn once for every step's batch.
    table = (None if cfg.frontend == "tokens"
             else embed_table(data_cfg, cfg.d_model))
    opt_cfg = adamw.AdamWConfig(lr=lr, warmup_steps=max(steps // 20, 1),
                                total_steps=steps)
    # The loop replaces the state every step, so the step consumes it.
    step_fn = T.build_train_step(
        cfg, opt_cfg, microbatches=microbatches,
        warmup_gemm_rows=global_batch * seq_len // microbatches, donate=True)
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    mon = HeartbeatMonitor(n_hosts=1)
    state = T.init_state(cfg, seed, device)
    start = 0
    if resume and mgr is not None and mgr.latest_step() is not None:
        state = mgr.restore(state)
        start = int(state.step)
        print(f"resumed from checkpoint at step {start}")
    saved = None
    losses = []
    obs = get_metrics()
    step_hist = obs.histogram("train.step_seconds",
                              "Wall time of one optimizer step")
    steps_done = obs.counter("train.steps_total", "Optimizer steps run")
    loss_gauge = obs.gauge("train.loss", "Most recent training loss")
    t0 = time.time()
    try:
        for i in range(start, steps):
            t_step = time.perf_counter()
            batch = T.cast_batch(batch_for_model(cfg, data_cfg, i,
                                                 table=table), cfg, device)
            with span("train.step", step=i, arch=arch):
                state, metrics = step_fn(state, batch)
                losses.append(float(metrics["loss"]))
            step_s = time.perf_counter() - t_step
            mon.beat(0, i)
            step_hist.observe(step_s)
            steps_done.inc()
            loss_gauge.set(losses[-1])
            obs.gauge("train.tokens_per_second",
                      "Throughput of the last optimizer step").set(
                          data_cfg.global_batch * data_cfg.seq_len
                          / max(step_s, 1e-9))
            if fail_at is not None and i == fail_at:
                raise RuntimeError(f"injected failure at step {i}")
            if mgr is not None and (i + 1) % ckpt_every == 0:
                mgr.save_async(i, state)
                saved = i
            if (i + 1) % log_every == 0 or i == start:
                dt = (time.time() - t0) / (i - start + 1)
                print(f"step {i+1:5d}  loss {losses[-1]:.4f}  "
                      f"lr {float(metrics['lr']):.2e}  "
                      f"gnorm {float(metrics['grad_norm']):.2f}  "
                      f"{dt*1e3:.0f} ms/step", flush=True)
    finally:
        # An in-flight async write completes before any error
        # propagates, so a resume sees every step saved before it.
        if mgr is not None:
            mgr.wait()
    if mgr is not None and saved != steps - 1 and start < steps:
        mgr.save(steps - 1, state)
    return state, losses


def main(argv: Optional[list] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--full", action="store_true",
                    help="the published config (needs the card)")
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain versions; default: the card")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a crash at this step (fault-tolerance demo)")
    ap.add_argument("--trace", default=None,
                    help="write Chrome-trace spans (JSONL) to this path")
    ap.add_argument("--metrics", action="store_true",
                    help="print the metrics report at the end")
    args = ap.parse_args(argv)
    if args.trace:
        enable_tracing(args.trace)
    try:
        _, losses = run_training(
            args.arch, args.steps, full=args.full, seq_len=args.seq_len,
            global_batch=args.global_batch, microbatches=args.microbatches,
            lr=args.lr, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
            resume=args.resume, fail_at=args.fail_at, device=args.device)
    finally:
        if args.trace:
            disable_tracing()
    if losses:
        print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f})")
    if args.metrics:
        print(get_metrics().report())


if __name__ == "__main__":
    main()
