"""Time the single-card loss and embedding lookup in their vocab-parallel
forms (whose sums over ``model`` are the identity on one card) against
the plain forms: ``log_softmax`` and a gather for the cross-entropy,
``table[tokens]`` for the lookup.  The model runs the vocab-parallel
loss on one card too, and the plain lookup (``models.common``).  Full
width of stablelm-1.6b (padded vocab 100352, d 2048), fp32 logits, each
measured forward and backward, in turns (vocab-parallel, plain, plain,
vocab-parallel per round), with CUDA events; the two forms' outputs and
gradients are held to each other first.

Run from the repository root::

    python3 tools/loss_forms_ab.py [--tokens 1024 16384] [--rounds 5]

It prints one JSON line: each shape's median milliseconds by form, the
largest difference between the forms, and the card's name and power
limit.  The CPU is used where there is no card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models import model as M  # noqa: E402


def _card_line() -> str:
    if not torch.cuda.is_available():
        return "no card"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()


def plain_nll(logits, labels, cfg):
    """The single-card cross-entropy before the vocab-parallel form."""
    V = cfg.padded_vocab
    pad = torch.arange(V, device=logits.device) >= cfg.vocab_size
    logp = torch.log_softmax(logits.masked_fill(pad, -1e9).float(), dim=-1)
    return -torch.gather(logp, -1, labels.long()[..., None])[..., 0]


def plain_embed(p, tokens, dtype):
    return p["table"][tokens].to(dtype)


def _timed(fn, dev, reps: int) -> float:
    """Median ms of ``reps`` calls of ``fn`` (forward and backward)."""
    out = []
    for _ in range(reps):
        if dev.type == "cuda":
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            out.append(a.elapsed_time(b))
        else:
            t = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t) * 1e3)
    return statistics.median(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tokens", type=int, nargs="+", default=[1024, 16384])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    cfg = get_config("stablelm-1.6b")
    gen = torch.Generator(device="cpu").manual_seed(0)
    V, d = cfg.padded_vocab, cfg.d_model
    table = (torch.randn(V, d, generator=gen) * 0.02).to(dev, torch.bfloat16)
    rows = {}
    for n in args.tokens:
        logits = torch.randn(n, V, generator=gen).to(dev)
        labels = torch.randint(0, cfg.vocab_size, (n,), generator=gen).to(dev)
        tokens = torch.randint(0, cfg.vocab_size, (n,), generator=gen).to(dev)
        forms = {
            "loss": {"vocab_parallel": lambda z: M._vocab_parallel_nll(
                         z, labels, cfg),
                     "plain": lambda z: plain_nll(z, labels, cfg)},
            "embed": {"vocab_parallel": lambda t: cm.vocab_parallel_rows(
                          t, tokens, torch.bfloat16),
                      "plain": lambda t: plain_embed(
                          {"table": t}, tokens, torch.bfloat16)}}
        inputs = {"loss": logits, "embed": table}
        for what, pair in forms.items():
            got = {}
            for form, f in pair.items():
                x = inputs[what].detach().requires_grad_()
                y = f(x)
                y.float().sum().backward()
                got[form] = (y.detach().float(), x.grad.float())
            diff = max(float((got["vocab_parallel"][i]
                              - got["plain"][i]).abs().max())
                       for i in range(2))

            def run(f, what=what):
                x = inputs[what].detach().requires_grad_()
                f(x).float().sum().backward()

            ms = {"vocab_parallel": [], "plain": []}
            for _ in range(args.rounds):
                for form in ("vocab_parallel", "plain", "plain",
                             "vocab_parallel"):
                    ms[form].append(_timed(lambda: run(pair[form]), dev,
                                           args.reps))
            rows[f"{what} tokens={n}"] = {
                "median_ms": {k: statistics.median(v) for k, v in ms.items()},
                "max_abs_diff": diff}
    print(json.dumps({"device": str(dev), "card": _card_line(),
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
