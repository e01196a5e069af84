"""Serving launcher (port of ``repro/launch/serve.py``): random-weight
requests against one architecture, on the card by default.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \
      --requests 4 --prompt-len 16 --max-new 8 [--full] [--paged]

Without ``--full`` it serves the reduced config; ``--device cpu`` runs the
plain versions on the CPU.  Weights are drawn from ``--seed``, prompts
from ``RandomState(seed)``.  The engine serves the requests one at a time,
as the reference's does; its ``batch_size`` (1 here) sizes the GEMM plan
warmup and the default page pool.

``--ledger`` records every GEMM and paged attention dispatch with its
planned bytes (the GEMM ledger, as ``REPRO_TORCH_LEDGER=1`` does),
``--trace PATH`` writes Chrome-trace spans (JSONL, as
``REPRO_TORCH_TRACE=PATH`` does), and ``--metrics`` prints the engine's
``metrics_report()``: TTFT/TPOT percentiles, tokens/s, warmup seconds and,
with the ledger, each step label's planned bytes, achieved GB/s and model
error.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import numpy as np

from repro_torch.configs import get_config, get_reduced
from repro_torch.models import model as M
from repro_torch.obs import disable_tracing, enable_ledger, enable_tracing
from repro_torch.serve.engine import Request, ServeEngine


def run_serving(arch: str, *, full: bool = False, requests: int = 4,
                prompt_len: int = 16, max_new: int = 8,
                temperature: float = 0.0, seed: int = 0, device=None,
                paged: bool = False, report: bool = False):
    """Serve ``requests`` random prompts of ``prompt_len`` tokens, each
    generating ``max_new`` tokens, on ``device`` (``None`` is the card);
    returns the finished requests by uid and the wall seconds of the run
    (weight init and engine start-up excluded).  ``report`` prints the
    engine's ``metrics_report()`` after the run."""
    cfg = get_config(arch) if full else get_reduced(arch)
    params = M.init_params(cfg, seed=seed, device=device)
    eng = ServeEngine(params, cfg, max_len=prompt_len + max_new, seed=seed,
                      device=device, paged_kv=paged)
    rng = np.random.RandomState(seed)
    for uid in range(requests):
        eng.submit(Request(uid=uid,
                           prompt=rng.randint(0, cfg.vocab_size, prompt_len),
                           max_new_tokens=max_new, temperature=temperature))
    t0 = time.perf_counter()
    done: Dict[int, Request] = eng.run()
    seconds = time.perf_counter() - t0
    if report:
        print(eng.metrics_report())
    return done, seconds


def main(argv: Optional[list] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--full", action="store_true",
                    help="the published config (needs the card)")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain versions; default: the card")
    ap.add_argument("--paged", action="store_true",
                    help="serve from the paged int8 KV cache")
    ap.add_argument("--ledger", action="store_true",
                    help="record planned bytes of every dispatch")
    ap.add_argument("--trace", default=None,
                    help="write Chrome-trace spans (JSONL) to this path")
    ap.add_argument("--metrics", action="store_true",
                    help="print the engine's metrics report")
    args = ap.parse_args(argv)
    if args.ledger:
        enable_ledger()
    if args.trace:
        enable_tracing(args.trace)
    try:
        done, seconds = run_serving(
            args.arch, full=args.full, requests=args.requests,
            prompt_len=args.prompt_len, max_new=args.max_new,
            temperature=args.temperature, seed=args.seed,
            device=args.device, paged=args.paged, report=args.metrics)
    finally:
        if args.trace:
            disable_tracing()
    total_new = sum(len(r.generated) for r in done.values())
    for uid, r in sorted(done.items()):
        print(f"req {uid} ({r.status}): {r.generated}")
    print(f"{total_new} tokens in {seconds:.3f} s "
          f"({total_new / seconds:.1f} tok/s)")


if __name__ == "__main__":
    main()
