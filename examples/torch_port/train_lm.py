"""End-to-end driver: train an LM for a few hundred steps on the
synthetic pipeline, with checkpointing and an injected crash + restart
halfway: the fault-tolerance path exercised for real.

  PYTHONPATH=src python examples/torch_port/train_lm.py                # ~25M
  PYTHONPATH=src python examples/torch_port/train_lm.py --scale 100m   # the
      ~100M GPT-2-small-class config (12L x 768)
  PYTHONPATH=src python examples/torch_port/train_lm.py --device cpu --steps 8

The card is the default and the script raises without one; only
``--device cpu`` trains through the kernels' plain versions.  A kernel
that fails to build or launch ends the script; only the injected crash
is caught, and training resumes from the last checkpoint.
"""

from __future__ import annotations

import argparse
import dataclasses
import tempfile
from typing import List, Optional

import repro_torch.configs as C
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.train import run_training
from repro_torch.models.model import resolve_device


def example_config(scale: str = "25m") -> ModelConfig:
    """The example's stablelm-shaped config at ``scale``, fp32 compute."""
    base = get_config("stablelm-1.6b")
    if scale == "100m":
        # GPT-2-small-class: 12L x d_model=768
        return dataclasses.replace(
            base, n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
            d_ff=2048, vocab_size=32000, compute_dtype="float32",
            q_chunk=64, kv_chunk=128)
    return dataclasses.replace(
        base, n_layers=8, d_model=384, n_heads=6, n_kv_heads=6,
        d_ff=1024, vocab_size=16384, compute_dtype="float32",
        q_chunk=64, kv_chunk=64)


def register(cfg: ModelConfig, name: str) -> str:
    """Register ``cfg`` as the transient arch ``name`` so that
    ``run_training`` finds it; returns the name."""
    mod = dataclasses.replace(cfg, name=name)
    C._MODULES[name] = type(
        "M", (), {"CONFIG": mod, "reduced": staticmethod(lambda: mod)})
    return name


def crash_and_resume(name: str, steps: int, *, seq_len: int,
                     global_batch: int, ckpt_dir: str, device=None
                     ) -> List[float]:
    """Train ``name`` with a checkpoint every quarter run and a crash
    injected halfway, then resume from the last checkpoint and finish;
    returns the resumed run's losses."""
    half = steps // 2
    kw = dict(seq_len=seq_len, global_batch=global_batch, lr=1e-3,
              ckpt_dir=ckpt_dir, ckpt_every=max(half // 2, 1),
              log_every=25, device=device)
    try:
        run_training(name, steps, fail_at=half, **kw)
    except RuntimeError as e:
        if "injected failure" not in str(e):
            raise
        print(f"!! {e} — restarting from last checkpoint")
    _, losses = run_training(name, steps, resume=True, **kw)
    return losses


def main(argv: Optional[list] = None) -> List[float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--scale", choices=("25m", "100m"), default="25m")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain versions; default: the card")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = example_config(args.scale)
    if args.scale == "100m":
        args.seq_len = max(args.seq_len, 128)
    n = cfg.n_params()
    name = register(cfg, f"stablelm-{args.scale}")
    print(f"training {name}: {n/1e6:.0f}M params, "
          f"{args.steps} steps @ seq={args.seq_len} batch={args.global_batch}")

    with tempfile.TemporaryDirectory() as ckpt:
        losses = crash_and_resume(name, args.steps, seq_len=args.seq_len,
                                  global_batch=args.global_batch,
                                  ckpt_dir=ckpt, device=device)
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({'DECREASED' if losses[-1] < losses[0] else 'no decrease'})")
    return losses


if __name__ == "__main__":
    main()
