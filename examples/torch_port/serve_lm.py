"""Serving example: batched requests, greedy + sampled, across families.

  PYTHONPATH=src python examples/torch_port/serve_lm.py
  PYTHONPATH=src python examples/torch_port/serve_lm.py --quantize int8
  PYTHONPATH=src python examples/torch_port/serve_lm.py --quantize w8a8
  PYTHONPATH=src python examples/torch_port/serve_lm.py --device cpu

The card is the default and the script raises without one; only
``--device cpu`` serves through the kernels' plain versions.  A kernel
that fails to build or launch ends the script.

``--quantize int8`` demonstrates the weight-quantized serve path:
init (standing in for a checkpoint restore) -> ``quantize_params``
(every projection the GEMM program serves becomes an int8 QTensor with
fp32 per-channel scales) -> engine startup warmup (the kernel-config
registry plans the ``int8w_*`` dequant programs) -> generate.  The int8
bytes are what streams from HBM; the dequant runs inside the GEMM drain.

``--quantize w8a8`` additionally quantizes activations: the engine runs
a startup calibration pass over sample traffic, attaches static a-scales
to every projection, and serves through the int8 x int8 (``dqab``)
program (``int8w_int8a`` cache keys).

``--chaos`` serves a 4-request queue under a deterministic
:class:`repro_torch.runtime.fault.FaultPlan`: one fatal kernel failure
(fails exactly one request), one recoverable kernel failure
(re-dispatched, ``gemm.fallback_total``), one NaN decode step (walks the
quant degradation ladder, ``serve.degraded_total``), and one slow decode
step.  Statuses print per request; pair with ``--metrics`` to see the
fault counters.

``--trace trace.jsonl`` writes Chrome-trace-event spans (warmup,
calibration, per-request prefill/decode); load the file in Perfetto or
chrome://tracing.  ``--metrics`` prints the engine's metrics report
(TTFT/TPOT histograms, prefill/decode split, tokens/s, plan sources) and
enables the GEMM ledger so the report includes achieved-vs-planned
bytes per serve step.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional

import numpy as np

from repro_torch.configs import get_reduced
from repro_torch.models import common as cm
from repro_torch.models import model as M
from repro_torch.obs import enable_tracing, flush
from repro_torch.obs.ledger import get_ledger
from repro_torch.quant import QTensor, QuantConfig
from repro_torch.runtime.fault import FaultPlan
from repro_torch.serve.engine import Request, ServeEngine

ARCHS = ["stablelm-1.6b", "mamba2-370m", "zamba2-7b"]


def _nbytes(leaf) -> int:
    """Bytes a parameter holds: a QTensor's int8 payload and fp32 scales,
    or a dense tensor's elements."""
    if isinstance(leaf, QTensor):
        n = leaf.data.numel() + 4 * leaf.scale.numel()
        if leaf.act_scale is not None:
            n += 4 * leaf.act_scale.numel()
        return n
    return leaf.numel() * leaf.element_size()


def chaos_plan() -> FaultPlan:
    """Deterministic chaos: dispatch 0 (request 0's first GEMM) is a fatal
    kernel failure, so exactly that request fails; dispatch 1 (request 1)
    is recoverable and re-dispatches the same GEMM (the port's deliberate
    departure: the reference re-dispatches on its XLA oracle, the port has
    none); decode step 5 (request 2's first) goes NaN, so the quant
    ladder degrades and retries; decode step 15 (request 3's first) runs
    slow."""
    return FaultPlan(kernel_fatal_at=(0,), kernel_fail_at=(1,),
                     nan_decode_at=(5,), slow_decode_at={15: 0.05})


def serve_arch(arch: str, params: Dict[str, object], *,
               quantize: str = "none", chaos: bool = False,
               metrics: bool = False, device=None) -> Dict[str, object]:
    """Serve the reduced ``arch`` from dense ``params`` as the example
    does and print its line.  Returns the finished requests (``done``),
    the line and, under ``chaos``, the plan."""
    cfg = get_reduced(arch)
    note = ""
    if quantize != "none":
        dense_bytes = sum(_nbytes(v) for v in params.values())
        params = cm.quantize_params(params, qconfig=QuantConfig())
        q_bytes = sum(_nbytes(v) for v in params.values())
        note = f" int8w params={q_bytes / 1e6:.2f}MB" \
               f" ({q_bytes / dense_bytes:.2f}x of dense)"
    eng = ServeEngine(params, cfg, batch_size=2, max_len=40,
                      quantize_activations=(quantize == "w8a8"),
                      device=device)
    if quantize != "none":
        pat = "int8w_int8a" if quantize == "w8a8" else "int8w_"
        n_q = sum(1 for k in eng.gemm_plan_sources if pat in k)
        note += f" quant-plans={n_q}"
        if quantize == "w8a8":
            note += f" calib-sites={len(eng.calibration_sites)}"
    rng = np.random.RandomState(0)
    out: Dict[str, object] = {}
    if chaos:
        plan = chaos_plan()
        for uid in range(4):
            eng.submit(Request(uid=uid,
                               prompt=rng.randint(0, cfg.vocab_size, 12),
                               max_new_tokens=6))
        with plan:
            done = eng.run()
        stat = " ".join(
            f"req{u}={r.status}"
            + (f"({r.quant_level})" if r.status == "degraded" else "")
            for u, r in sorted(done.items()))
        line = (f"{arch:16s} chaos: {stat} "
                f"injected={sorted(plan.injected)}{note}")
        out["plan"] = plan
    else:
        for uid in range(2):
            eng.submit(Request(uid=uid,
                               prompt=rng.randint(0, cfg.vocab_size, 12),
                               max_new_tokens=6,
                               temperature=0.0 if uid == 0 else 0.7))
        done = eng.run()
        outs = {u: r.generated for u, r in done.items()}
        line = f"{arch:16s} greedy={outs[0]} sampled={outs[1]}{note}"
    print(line, flush=True)
    if metrics:
        print(f"--- metrics ({arch}) ---")
        print(eng.metrics_report())
    out.update(done=done, line=line)
    return out


def main(argv: Optional[list] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quantize", choices=["none", "int8", "w8a8"],
                    default="none",
                    help="weight-quantize the serve params (int8 payload, "
                         "fp32 per-channel scales, drain-fused dequant); "
                         "w8a8 additionally calibrates static activation "
                         "scales and serves int8xint8")
    ap.add_argument("--trace", nargs="?", const="trace.jsonl", default=None,
                    metavar="PATH",
                    help="write Perfetto-loadable trace spans to PATH "
                         "(default trace.jsonl)")
    ap.add_argument("--metrics", action="store_true",
                    help="enable the GEMM ledger and print the metrics "
                         "report after serving")
    ap.add_argument("--chaos", action="store_true",
                    help="serve a 4-request queue under a deterministic "
                         "FaultPlan (fatal kernel, recoverable kernel, "
                         "NaN decode step, slow decode step) and print "
                         "per-request statuses; pair with --quantize so "
                         "the NaN triggers the degradation ladder")
    ap.add_argument("--archs", nargs="+", default=ARCHS,
                    help="reduced configs to serve")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain versions; default: the card")
    args = ap.parse_args(argv)
    device = M.resolve_device(args.device)

    if args.trace:
        print(f"# tracing to {enable_tracing(args.trace)}")
    if args.metrics:
        get_ledger().enable()

    for arch in args.archs:
        # Drawn on the CPU from the seed, so that every device serves the
        # same weights.
        params = {k: v.to(device) for k, v in M.init_params(
            get_reduced(arch), seed=0, device="cpu").items()}
        serve_arch(arch, params, quantize=args.quantize, chaos=args.chaos,
                   metrics=args.metrics, device=device)
    if args.trace:
        flush()
        print(f"# trace written to {args.trace}")


if __name__ == "__main__":
    main()
