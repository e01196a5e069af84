"""Time ``CheckpointManager.restore`` of this tree against another version
of ``src/repro_torch/checkpoint/manager.py``, in one process, in turns
(this, other, other, this per round), on one checkpoint: the train state
of full-width stablelm-1.6b at 2 layers from seed 0 (fp32 masters and
both AdamW moments, 6.2 GB, as the smoke's robust and FSDP phases save
it), written once by this tree.  Each turn restores the whole state onto
the card (the CPU where there is none), verification included, and must
give back the saved leaves bit for bit.  Every read after the save is
warm: the file lies in the page cache.

Run from the repository root, with a copy of the other version::

    python3 tools/ckpt_restore_ab.py OTHER/manager.py [--layers 2] [--rounds 2]

It prints one JSON line: each turn's seconds by version, their medians,
the checkpoint's size, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import pathlib
import shutil
import statistics
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.checkpoint import manager as THIS  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.train import step as T  # noqa: E402


def _load(path: str):
    spec = importlib.util.spec_from_file_location("other_manager", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _card_line() -> str:
    if not torch.cuda.is_available():
        return "no card"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="another version of checkpoint/manager.py")
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's reduced config (a quick check off the "
                         "card)")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)

    dev = "cuda" if torch.cuda.is_available() else "cpu"
    cfg = (get_reduced(args.arch) if args.reduced else
           dataclasses.replace(get_config(args.arch), n_layers=args.layers))
    state = T.init_state(cfg, seed=0, device=dev)
    want = THIS._flatten(state)
    path = ROOT / "build" / "ckpt_restore_ab"
    shutil.rmtree(path, ignore_errors=True)
    versions = {"this": THIS, "other": _load(args.other)}
    seconds = {name: [] for name in versions}
    try:
        THIS.CheckpointManager(str(path)).save(1, state)
        gb = sum(f.stat().st_size for f in path.rglob("*")
                 if f.is_file()) / 1e9
        for name in ["this", "other", "other", "this"] * args.rounds:
            mgr = versions[name].CheckpointManager(str(path))
            if dev == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = mgr.restore(state, step=1)
            if dev == "cuda":
                torch.cuda.synchronize()
            seconds[name].append(time.perf_counter() - t0)
            flat = THIS._flatten(got)
            if not all(torch.equal(flat[k], want[k]) for k in want):
                raise SystemExit(f"{name}: the restored state differs")
            del got, flat
    finally:
        shutil.rmtree(path, ignore_errors=True)
    print(json.dumps({
        "checkpoint_gb": gb, "device": dev, "card": _card_line(),
        "seconds": seconds,
        "median_s": {k: statistics.median(v) for k, v in seconds.items()},
        "other": args.other}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
