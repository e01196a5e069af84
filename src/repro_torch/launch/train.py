"""Training launcher (port of ``repro/launch/train.py``): data pipeline
and train step for one architecture, on the card by default.

  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \
      --steps 3 --full [--microbatches 4]

Without ``--full`` it trains the reduced config.  The reference's
checkpoints and resume (``checkpoint/manager.py``, ROADMAP queue 1,
item 9), its heartbeat monitor (item 9) and its observability spans and
metrics (item 8) are not ported yet: ``ckpt_dir``/``resume`` raise.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

from repro_torch.configs import get_config, get_reduced
from repro_torch.data.pipeline import DataConfig, batch_for_model
from repro_torch.models.model import resolve_device
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
        raise ValueError("checkpoints and resume are not ported yet "
                         "(checkpoint/manager.py, ROADMAP queue 1, item 9)")
    cfg = get_config(arch) if full else get_reduced(arch)
    T.check_trainable(cfg)
    device = resolve_device(device)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                          global_batch=global_batch, seed=seed)
    opt_cfg = adamw.AdamWConfig(lr=lr, warmup_steps=max(steps // 20, 1),
                                total_steps=steps)
    step_fn = T.build_train_step(cfg, opt_cfg, microbatches=microbatches)
    state = T.init_state(cfg, seed, device)
    losses = []
    t0 = time.time()
    for i in range(steps):
        batch = T.cast_batch(batch_for_model(cfg, data_cfg, i), cfg, device)
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        if fail_at is not None and i == fail_at:
            raise RuntimeError(f"injected failure at step {i}")
        if (i + 1) % log_every == 0 or i == 0:
            dt = (time.time() - t0) / (i + 1)
            print(f"step {i+1:5d}  loss {losses[-1]:.4f}  "
                  f"lr {float(metrics['lr']):.2e}  "
                  f"gnorm {float(metrics['grad_norm']):.2f}  "
                  f"{dt*1e3:.0f} ms/step", flush=True)
    return state, losses


def main():
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
    args = ap.parse_args()
    _, losses = run_training(
        args.arch, args.steps, full=args.full, seq_len=args.seq_len,
        global_batch=args.global_batch, microbatches=args.microbatches,
        lr=args.lr, fail_at=args.fail_at, device=args.device)
    print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f})")


if __name__ == "__main__":
    main()
