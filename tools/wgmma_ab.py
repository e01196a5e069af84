"""Time two versions of the wgmma route's CUDA sources against each other
on the card, in one process: the K1f training GEMMs and the forward
programs at the 1000-token prefill (``chip_smoke.py``'s shapes), K4 at
4096^3 in bf16 (its default tile and 256 x 256 x 128) and K1a at 4096^3.

Version A is a directory holding ``ca_gemm_program.cu``,
``ca_mmm_k_outer.cu`` and the ``wgmma_mainloop.cuh`` they include;
version B is another such directory (``--new``) or the tree's
``src/repro_torch/csrc``.  Each case runs once on
both to compare outputs (bit-equal, and each one's max |error| against
the plain version where it has one), then is timed by CUDA-graph replay
(``chip_smoke._time_ms``) in the order A, B, B, A for two rounds.  One
JSON line per case.  Run from the repository root on the card::

    python3 tools/wgmma_ab.py OLD_CSRC_DIR [--new NEW_CSRC_DIR]
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as CS  # noqa: E402  (puts src/ on the path)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ca_mmm as K  # noqa: E402
from repro_torch.kernels.program import program_from_tag  # noqa: E402


def cases(gen):
    """(name, fn(i) -> output, operand copies, plain version or None)."""
    out = []

    def program(name, a, sets, kw, od, copies):
        out.append((name,
                    lambda i: K.ca_gemm_program(a, sets[i], out_dtype=od,
                                                **kw),
                    copies,
                    lambda: K.ca_gemm_program_reference(a, sets[0],
                                                        out_dtype=od, **kw)))

    for key, name, m, n, k, od in CS.K1F_GEMMS:
        nb = program_from_tag(key.split(" ")[0]).n_b
        copies = max(2, math.ceil(120e6 / (nb * k * n * 2)))
        a, sets, kw = CS.k1f_inputs(key, m, n, k, torch.bfloat16, gen, copies)
        program(f"{key} {name}", a, sets, kw, od, copies)
    for tag, name, k, n, od in CS.GEMMS:
        nb = program_from_tag(tag).n_b
        copies = max(2, math.ceil(120e6 / (nb * k * n * 2)))
        a, sets, kw = CS.program_inputs(tag, 1000, k, n, torch.bfloat16, gen,
                                        copies)
        program(f"{tag} {name} m=1000", a, sets, kw, od, copies)
    x, y = (torch.randn(4096, 4096, generator=gen, device="cuda").bfloat16()
            for _ in range(2))
    out.append(("K4 default tile", lambda i: K.ca_mmm_k_outer(x, y), 1,
                lambda: K.ca_mmm_k_outer_reference(x, y)))
    out.append(("K4 256x256x128",
                lambda i: K.ca_mmm_k_outer(x, y, bm=256, bn=256, bk=128), 1,
                None))
    out.append(("K1a 4096^3 fp32 out",
                lambda i: K.ca_gemm_program(x, [y], out_dtype=torch.float32),
                1, lambda: K.ca_gemm_program_reference(
                    x, [y], out_dtype=torch.float32)))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old_csrc", type=pathlib.Path)
    ap.add_argument("--new", type=pathlib.Path, default=_build.CSRC)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    builds = {tag: (d.resolve() / "ca_gemm_program.cu",
                    d.resolve() / "ca_mmm_k_outer.cu")
              for tag, d in (("A", args.old_csrc), ("B", args.new))}

    def use(tag):
        src, k4 = builds[tag]
        K._library = lambda: _build.load(src, K._bind)
        K.K_OUTER_SOURCE = k4

    gen = torch.Generator(device="cuda").manual_seed(3)
    for name, fn, copies, plain in cases(gen):
        outs = {}
        for tag in "AB":
            use(tag)
            o = fn(0)
            outs[tag] = [t.clone() for t in (o if isinstance(o, tuple)
                                             else (o,))]
        torch.cuda.synchronize()
        errs = {}
        if plain is not None:
            want = plain()
            want = want if isinstance(want, tuple) else (want,)
            for tag in "AB":
                errs[tag] = [(g.double() - w.double()).abs().max().item()
                             for g, w in zip(outs[tag], want)]
        times = {"A": [], "B": []}
        iters = 5 if name.startswith(("K4", "K1a")) else 20
        for _ in range(2):
            for tag in "ABBA":
                use(tag)
                times[tag].append(CS._time_ms(fn, copies, iters=iters,
                                              reps=4))
        print("ab " + json.dumps({
            "case": name,
            "bit_equal": all(torch.equal(p, q)
                             for p, q in zip(outs["A"], outs["B"])),
            "max_abs_err": errs, "A_ms": sorted(times["A"]),
            "B_ms": sorted(times["B"])}), flush=True)


if __name__ == "__main__":
    main()
