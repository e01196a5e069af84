"""Training launcher (port of ``repro/launch/train.py``): data pipeline
and train step for one architecture, on the card by default.

  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \
      --steps 3 --full [--microbatches 4]

Without ``--full`` it trains the reduced config.  Each step runs under a
``train.step`` trace span and feeds the metrics registry as the
reference's launcher does: ``train.step_seconds`` (histogram; the step
ends in the loss's read to the host), ``train.steps_total``,
``train.loss`` and ``train.tokens_per_second``.  ``--trace PATH`` writes
the spans, ``--metrics`` prints the metrics report at the end.  The
reference's checkpoints and resume wait for ``checkpoint/manager.py`` and
its heartbeat monitor for ``runtime/``: ``ckpt_dir``/``resume`` raise.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

from repro_torch.configs import get_config, get_reduced
from repro_torch.data.pipeline import DataConfig, batch_for_model
from repro_torch.models.model import resolve_device
from repro_torch.obs import (disable_tracing, enable_tracing, get_metrics,
                             span)
from repro_torch.optim import adamw
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
    resume: bool = False,
    seed: int = 0,
    log_every: int = 10,
    fail_at: Optional[int] = None,
    device=None,
):
    """Train ``arch`` for ``steps`` steps on ``device`` (``None`` is the
    card); returns the final TrainState and the per-step losses."""
    if ckpt_dir is not None or resume:
        raise ValueError("checkpoints and resume are not ported yet: they "
                         "wait for checkpoint/manager.py")
    cfg = get_config(arch) if full else get_reduced(arch)
    T.check_trainable(cfg)
    device = resolve_device(device)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                          global_batch=global_batch, seed=seed)
    opt_cfg = adamw.AdamWConfig(lr=lr, warmup_steps=max(steps // 20, 1),
                                total_steps=steps)
    step_fn = T.build_train_step(
        cfg, opt_cfg, microbatches=microbatches,
        warmup_gemm_rows=global_batch * seq_len // microbatches)
    state = T.init_state(cfg, seed, device)
    losses = []
    obs = get_metrics()
    step_hist = obs.histogram("train.step_seconds",
                              "Wall time of one optimizer step")
    steps_done = obs.counter("train.steps_total", "Optimizer steps run")
    loss_gauge = obs.gauge("train.loss", "Most recent training loss")
    t0 = time.time()
    for i in range(steps):
        t_step = time.perf_counter()
        batch = T.cast_batch(batch_for_model(cfg, data_cfg, i), cfg, device)
        with span("train.step", step=i, arch=arch):
            state, metrics = step_fn(state, batch)
            losses.append(float(metrics["loss"]))
        step_s = time.perf_counter() - t_step
        step_hist.observe(step_s)
        steps_done.inc()
        loss_gauge.set(losses[-1])
        obs.gauge("train.tokens_per_second",
                  "Throughput of the last optimizer step").set(
                      data_cfg.global_batch * data_cfg.seq_len
                      / max(step_s, 1e-9))
        if fail_at is not None and i == fail_at:
            raise RuntimeError(f"injected failure at step {i}")
        if (i + 1) % log_every == 0 or i == 0:
            dt = (time.time() - t0) / (i + 1)
            print(f"step {i+1:5d}  loss {losses[-1]:.4f}  "
                  f"lr {float(metrics['lr']):.2e}  "
                  f"gnorm {float(metrics['grad_norm']):.2f}  "
                  f"{dt*1e3:.0f} ms/step", flush=True)
    return state, losses


def main(argv: Optional[list] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--full", action="store_true",
                    help="the published config (needs the card)")
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain versions; default: the card")
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
            lr=args.lr, fail_at=args.fail_at, device=args.device)
    finally:
        if args.trace:
            disable_tracing()
    print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f})")
    if args.metrics:
        print(get_metrics().report())


if __name__ == "__main__":
    main()
