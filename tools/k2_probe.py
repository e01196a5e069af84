"""Probe K2, the paged decode attention kernel, on the card: where its time
goes at ``chip_smoke.py``'s timed cases.

For each case it prints one JSON line with
- ``ms``: the kernel's time (``chip_smoke._time_ms``: CUDA-graph replay,
  pools rotated past the 50 MB L2) with the wrapper's own split count, and
  with each count of ``--splits`` forced in its place;
- ``feed_ms``: the time of a feed-only build, the same source with the
  scores, softmax and PV skipped (the feed, by TMA boxes or cp.async, the
  table lookups, the merges and the stores alone);
- ``cycles_per_tile``: the clock64 cycles a warp spends per 32-token tile
  in each phase (waiting for the tile, issuing the next tile's copies and
  looking up its rows, scoring, softmax, PV), from a build with counters,
  summed over the warps and divided by the tiles.

The two variant builds are patched copies of
``src/repro_torch/csrc/paged_flash_attn.cu`` written under ``build/``.
Run from the repository root on the card::

    python3 tools/k2_probe.py [--cases "danube B8 S4096" ...] [--splits 1 2 4 8]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as CS  # noqa: E402  (puts src/ on the path)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attn as FA  # noqa: E402

PHASES = ("wait", "issue", "score", "softmax", "pv")


def _sub(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f"k2_probe: the kernel source changed; no {old!r}")
    return text.replace(old, new, 1)


def variants(out: pathlib.Path):
    """(feed-only source, counted source) written under ``out``."""
    src = FA.SOURCE.read_text()
    out.mkdir(parents=True, exist_ok=True)
    feed = out / "paged_flash_attn_feed.cu"
    feed.write_text(_sub(src, "    if (nh == 0) continue;",
                         "    if (nh >= 0) continue;"))
    t = _sub(src, "namespace {\n\nconstexpr int kTile",
             "__device__ unsigned long long k2_prof[8];\n"
             "namespace {\n\nconstexpr int kTile")
    t = _sub(t, "    if (tma) mbar_wait(bar + i % S",
             "    long long c0 = clock64();\n"
             "    if (tma) mbar_wait(bar + i % S")
    t = _sub(t, "    issue(i + S - 1);\n",
             "    long long c1 = clock64();\n    issue(i + S - 1);\n")
    t = _sub(t, "    entry = table_at(i + S + 1);\n",
             "    entry = table_at(i + S + 1);\n    long long c2 = clock64();\n")
    t = _sub(t, "    // Online softmax over the tile",
             "    long long c3 = clock64();\n    // Online softmax over the tile")
    t = _sub(t, "    __syncwarp();\n\n    // PV:",
             "    __syncwarp();\n    long long c4 = clock64();\n\n    // PV:")
    stamps = "".join(
        f"atomicAdd(&k2_prof[{i}], (unsigned long long)(c{i + 1} - c{i})); "
        for i in range(5))
    t = _sub(t, "  }\n\n  // Each warp's state",
             "    long long c5 = clock64();\n    if (lane == 0) { " + stamps
             + "atomicAdd(&k2_prof[5], 1ull); }\n  }\n\n  // Each warp's state")
    t += ('\nextern "C" int k2_prof_read(unsigned long long* h) {\n'
          "  return (int)cudaMemcpyFromSymbol(h, k2_prof, 8 * sizeof(*h));\n}\n"
          'extern "C" int k2_prof_reset() {\n'
          "  unsigned long long z[8] = {0};\n"
          "  return (int)cudaMemcpyToSymbol(k2_prof, z, sizeof(z));\n}\n")
    counted = out / "paged_flash_attn_counted.cu"
    counted.write_text(t)
    return feed, counted


def inputs(name, gen):
    lens, page, H, Hkv, D, window = CS.ATTN_CASES[name]
    Dv = CS.ATTN_DV.get(name, D)
    per_copy = sum(-(-L // page) for L in lens) * page * Hkv * (D + Dv)
    copies = max(2, math.ceil(120e6 / per_copy))
    pools, tables, lens_t, _ = CS.attn_pool(lens, page, Hkv, D, gen,
                                            copies=copies, Dv=Dv)
    q = torch.randn(len(lens), H, D, generator=gen,
                    device="cuda").to(torch.bfloat16)
    return (lambda i: FA.paged_flash_attention(
        q, *pools[i], tables, lens_t, window=window)), copies


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cases", nargs="*", default=list(CS.ATTN_TIMED))
    ap.add_argument("--splits", nargs="*", type=int, default=[1, 2, 4, 8])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip(), flush=True)
    base, splits0 = FA.SOURCE, FA.paged_splits
    feed, counted = variants(_build.BUILD_DIR / "k2_probe")
    gen = torch.Generator(device="cuda").manual_seed(4)
    for name in args.cases:
        fn, copies = inputs(name, gen)
        used = {}

        def chooser(*a):
            used["splits"] = splits0(*a)
            return used["splits"]

        FA.paged_splits = chooser
        rec = {"case": name, "ms": CS._time_ms(fn, copies)}
        rec["splits"] = used["splits"]
        for s in args.splits:
            FA.paged_splits = lambda *a, s=s: s
            rec[f"ms_splits_{s}"] = CS._time_ms(fn, copies)
        FA.paged_splits = splits0
        FA.SOURCE = feed
        rec["feed_ms"] = CS._time_ms(fn, copies)
        FA.SOURCE = counted
        lib = _build.load(counted, FA._bind)
        lib.k2_prof_read.argtypes = [ctypes.c_void_p]
        fn(0)
        torch.cuda.synchronize()
        lib.k2_prof_reset()
        fn(0)
        torch.cuda.synchronize()
        h = (ctypes.c_ulonglong * 8)()
        lib.k2_prof_read(ctypes.addressof(h))
        tiles = max(1, h[5])
        rec["tiles"] = h[5]
        rec["cycles_per_tile"] = {k: round(h[i] / tiles)
                                  for i, k in enumerate(PHASES)}
        FA.SOURCE = base
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
