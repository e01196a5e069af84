"""Time two versions of the port's redesigned CUDA sources against each
other on the card, in one process: the wgmma route's K1f training GEMMs
and forward programs at the 1000-token prefill, K4 at 4096^3 in bf16 (its
default tile and 256 x 256 x 128) and K1a at 4096^3 (``chip_smoke.py``'s
shapes); the forward programs of stablelm-1.6b and h2o-danube-3-4b at
decode (m = 1); and K3, forward flash attention, in bf16 at
``chip_smoke.py``'s timed shapes.

Version A is a directory holding ``ca_gemm_program.cu``,
``ca_mmm_k_outer.cu``, ``flash_attn_fwd.cu`` and the
``wgmma_mainloop.cuh`` they include; version B is another such directory
(``--new``) or the tree's ``src/repro_torch/csrc``.  A version whose GEMM
source has no decode route runs the m = 1 programs on its SIMT tile (one
without the int8 decode route its int8 ones: K1d and K1e of
stablelm-1.6b at m = 1), and one whose K3 entry point takes no route
argument runs K3 on its SIMT kernel, so the tool also compares a tree
against its parent.  Each case
runs once on both to compare outputs (bit-equal, and each one's max
|error| against the plain version where it has one), then is timed by
CUDA-graph replay (``chip_smoke._time_ms``) in the order A, B, B, A for
two rounds.  One JSON line per case; ``--only K3`` keeps the cases whose
name holds any of the given words.  Run from the repository root on the
card::

    python3 tools/wgmma_ab.py OLD_CSRC_DIR [--new NEW_CSRC_DIR] [--only K3]
"""

from __future__ import annotations

import argparse
import ctypes
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
from repro_torch.kernels import flash_attn as FA  # noqa: E402
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
    for m in (1000, 1):
        for tag, name, k, n, od in CS.GEMMS + (CS.DANUBE_GEMMS if m == 1
                                               else []):
            nb = program_from_tag(tag).n_b
            copies = max(2, math.ceil(120e6 / (nb * k * n * 2)))
            a, sets, kw = CS.program_inputs(tag, m, k, n, torch.bfloat16,
                                            gen, copies)
            program(f"{tag} {name} m={m}", a, sets, kw, od, copies)
    # The int8 programs (K1d, K1e) of stablelm-1.6b at decode.
    for tag, name, k, n, od in CS.GEMMS:
        nb = program_from_tag(tag).n_b
        copies = max(2, math.ceil(120e6 / (nb * k * n)))
        for qtag in CS.QUANT[tag]:
            a, sets, kw, ops = CS.quant_inputs(qtag, 1, k, n, torch.bfloat16,
                                               gen, copies)
            kw = dict(kw, out_dtype=od or torch.bfloat16)
            out.append((f"{qtag} {name} m=1",
                        lambda i, a=a, sets=sets, kw=kw, ops=ops:
                            K.ca_gemm_program(a, sets[i],
                                              branch_operands=ops(i), **kw),
                        copies,
                        lambda a=a, sets=sets, kw=kw, ops=ops:
                            K.ca_gemm_program_reference(
                                a, sets[0], branch_operands=ops(0), **kw)))
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
    for name in CS.FWD_TIMED:
        B, Lq, S, H, Hkv, D, window = CS.FWD_SHAPES[name]
        q, k, v, qpos, kpos = CS.fwd_inputs(B, Lq, S, H, Hkv, D,
                                            torch.bfloat16, gen)
        kw = dict(q_positions=qpos, kv_positions=kpos, window=window)
        out.append((f"K3 {name}",
                    lambda i, q=q, k=k, v=v, kw=kw:
                        FA.flash_attention(q, k, v, **kw), 1,
                    lambda q=q, k=k, v=v, kw=kw:
                        FA.flash_attention_reference(q, k, v, **kw)))
    return out


def _k3_without_route(source: pathlib.Path):
    """K3's launch for an entry point without the route argument (before
    the wgmma route): the wrapper's launch, one int fewer."""
    def bind(lib):
        fn = lib.flash_attn_fwd_launch
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int

    def launch(q, k, v, q_positions, kv_positions, causal, window, scale,
               geometry):
        B, Lq, S, H, Hkv, D, Dv = geometry
        out = torch.empty((B, Lq, H, Dv), dtype=q.dtype, device=q.device)
        err = _build.load(source, bind).flash_attn_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            q_positions.data_ptr(), kv_positions.data_ptr(), out.data_ptr(),
            B, Lq, S, H, Hkv, D, Dv, int(causal), window or 0, scale,
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"flash_attention launch failed: {err}")
        return out
    return launch


def _takes_int8_decode(gemm: pathlib.Path, k1_route) -> bool:
    """Whether the GEMM build of ``gemm`` has the int8 decode route: it
    launches a small dqb program at m = 1 there, or its entry point
    refuses the route (an error returned before any launch)."""
    K._library = lambda: _build.load(gemm, K._bind)
    K.k1_route = k1_route
    gen = torch.Generator(device="cuda").manual_seed(0)
    a, sets, kw, ops = CS.quant_inputs("dqb", 1, 64, 64, torch.bfloat16, gen)
    try:
        K.ca_gemm_program(a, sets[0], branch_operands=ops(0), **kw)
    except RuntimeError:
        return False
    torch.cuda.synchronize()
    return True


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old_csrc", type=pathlib.Path)
    ap.add_argument("--new", type=pathlib.Path, default=_build.CSRC)
    ap.add_argument("--only", nargs="*", default=[],
                    help="keep the cases whose name holds any of these")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    k1_route, launch_fwd = K.k1_route, FA._launch_fwd
    builds = {}
    for tag, d in (("A", args.old_csrc), ("B", args.new)):
        d = d.resolve()
        gemm, fwd = d / "ca_gemm_program.cu", d / "flash_attn_fwd.cu"
        builds[tag] = dict(
            gemm=gemm, k4=d / "ca_mmm_k_outer.cu", fwd=fwd,
            decode="ROUTE_DECODE" in gemm.read_text(),
            fwd_routed="int route," in fwd.read_text())
        builds[tag]["int8_decode"] = (builds[tag]["decode"]
                                      and _takes_int8_decode(gemm, k1_route))
        print(f"build {tag}: {d} (decode route "
              f"{builds[tag]['decode']}, int8 decode "
              f"{builds[tag]['int8_decode']}, K3 routes "
              f"{builds[tag]['fwd_routed']})", flush=True)

    def routed(b):
        """k1_route for build ``b``: m <= 8 on its SIMT tile where it has no
        decode route, or none for int8 B."""
        def route(spec, layout, a_dtype, b_dtype, *args, **kw):
            r = k1_route(spec, layout, a_dtype, b_dtype, *args, **kw)
            takes = b["decode"] and (b_dtype != torch.int8
                                     or b["int8_decode"])
            return "simt" if r == "decode" and not takes else r
        return route

    def use(tag):
        b = builds[tag]
        K._library = lambda: _build.load(b["gemm"], K._bind)
        K.K_OUTER_SOURCE = b["k4"]
        K.k1_route = routed(b)
        FA.FWD_SOURCE = b["fwd"]
        FA._launch_fwd = launch_fwd if b["fwd_routed"] \
            else _k3_without_route(b["fwd"])

    gen = torch.Generator(device="cuda").manual_seed(3)
    for name, fn, copies, plain in cases(gen):
        if args.only and not any(w in name for w in args.only):
            continue
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
        slow = name.startswith(("K4", "K1a")) or name == "K3 stablelm S4096"
        iters = 5 if slow else 20
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
