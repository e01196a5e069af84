"""Time two versions of the port's redesigned CUDA sources against each
other on the card, in one process: the wgmma route's K1f training GEMMs
and forward programs at the 1000-token prefill, K4 at 4096^3 in bf16 (its
default tile and 256 x 256 x 128) and K1a at 4096^3 (``chip_smoke.py``'s
shapes); the forward programs of stablelm-1.6b and h2o-danube-3-4b at
decode (m = 1); K1d and K1e (int8w, w8a8) of stablelm-1.6b at m = 1, 128
and 1000; K3, forward flash attention, in bf16 at ``chip_smoke.py``'s
timed shapes; K2, the paged decode attention, at its timed shapes; and
K1g, the distance product, at 4096^3 in fp32 and bf16 and on a ragged
shape, with the SM clock and board power nvidia-smi reads while each
version's 4096^3 fp32 product runs (``chip_smoke.sustained_clock``).

Version A is a directory holding ``ca_gemm_program.cu``,
``ca_mmm_k_outer.cu``, ``flash_attn_fwd.cu``, ``paged_flash_attn.cu``,
``distance_product.cu`` (where the distance product has a source of its
own; before, it is ``ca_gemm_program.cu``'s ``ca_gemm_min_plus_launch``)
and the ``wgmma_mainloop.cuh`` they include; version B is another such
directory (``--new``) or the tree's ``src/repro_torch/csrc``.  A GEMM
entry point without the dual programs' second output, or a K2 entry
point without the plan's K chunk (``dkc``), is called with that argument
dropped.  A version
whose GEMM source has no decode route runs the m = 1 programs on its SIMT
tile (one without the int8 decode route its int8 ones at m = 1, one
without the int8 wgmma route its int8 ones at m > 8), one whose K3
entry point takes no route argument runs K3 on its SIMT kernel, and one
whose K2 entry point takes no plan (shift, group, splits) runs K2
through its own launch, so the tool also compares a tree against its
parent.  The GEMM source is built only when a GEMM case is kept.  Each case
runs once on both to compare outputs (bit-equal, and each one's max
|error| against the plain version where it has one), then is timed by
CUDA-graph replay (``chip_smoke._time_ms``) in the order A, B, B, A for
two rounds.  One JSON line per case; ``--only K3`` keeps the cases whose
name holds any of the given words (``--only K1g`` builds no GEMM source
but the parent's, which holds its min-plus kernel).  Run from the repository root on the
card::

    python3 tools/wgmma_ab.py OLD_CSRC_DIR [--new NEW_CSRC_DIR] [--only K3]
        [--prefill]

``--prefill`` also times a full-width stablelm-1.6b prefill of a
1000-token prompt in int8w and w8a8 on the host clock (the end-to-end
effect of the int8 GEMMs), builds alternating as above.
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
from repro_torch.kernels import ops as OPS  # noqa: E402
from repro_torch.kernels.program import program_from_tag  # noqa: E402

# K1g's cases: (name, m, k, n, dtype).
K1G_CASES = [("K1g 4096^3 fp32", 4096, 4096, 4096, torch.float32),
             ("K1g 4096^3 bf16", 4096, 4096, 4096, torch.bfloat16),
             ("K1g ragged 1000x333x777 fp32", 1000, 333, 777, torch.float32)]


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
    # The int8 programs (K1d, K1e) of stablelm-1.6b at decode and at the
    # 128- and 1000-token prefills.
    for m, (tag, name, k, n, od) in ((m, g) for m in (1, 128, 1000)
                                     for g in CS.GEMMS):
        nb = program_from_tag(tag).n_b
        copies = max(2, math.ceil(120e6 / (nb * k * n)))
        for qtag in CS.QUANT[tag]:
            a, sets, kw, ops = CS.quant_inputs(qtag, m, k, n, torch.bfloat16,
                                               gen, copies)
            kw = dict(kw, out_dtype=od or torch.bfloat16)
            out.append((f"{qtag} {name} m={m}",
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
    for name, m, k, n, dtype in K1G_CASES:
        a = torch.rand(m, k, generator=gen, device="cuda").to(dtype)
        b = torch.rand(k, n, generator=gen, device="cuda").to(dtype)
        out.append((name, lambda i, a=a, b=b: OPS.distance_product(a, b), 1,
                    lambda a=a, b=b: K.ca_gemm_program_reference(
                        a, [b], semiring="min_plus")))
    for name in CS.ATTN_TIMED:
        lens, page, H, Hkv, D, window = CS.ATTN_CASES[name]
        (pool,), tables, lens_t, _ = CS.attn_pool(
            lens, page, Hkv, D, gen, Dv=CS.ATTN_DV.get(name, D))
        q = torch.randn(len(lens), H, D, generator=gen,
                        device="cuda").to(torch.bfloat16)
        args = (q, *pool, tables, lens_t)
        out.append((f"K2 {name}",
                    lambda i, args=args, w=window:
                        FA.paged_flash_attention(*args, window=w), 1,
                    lambda args=args, w=window:
                        FA.paged_flash_attention_reference(*args, window=w)))
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


def _k2_without_plan(source: pathlib.Path):
    """K2's launch for an entry point without the plan arguments (shift,
    group, splits; before the split redesign): the wrapper's launch,
    three ints fewer."""
    def bind(lib):
        fn = lib.paged_flash_attn_launch
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                       + [ctypes.c_float] + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int

    def launch(q, k_pages, v_pages, k_scale, v_scale, block_tables, seq_lens,
               window, scale, geometry):
        B, H, D, Dv, page, Hkv, NP = geometry
        out = torch.empty((B, H, Dv), dtype=q.dtype, device=q.device)
        err = _build.load(source, bind).paged_flash_attn_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scale.data_ptr(), v_scale.data_ptr(), block_tables.data_ptr(),
            seq_lens.data_ptr(), out.data_ptr(), B, H, Hkv, D, Dv, page, NP,
            window or 0, scale, int(q.dtype == torch.bfloat16),
            FA._load_width(k_pages, v_pages, D, Dv),
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"paged_flash_attention launch failed: {err}")
        return out
    return launch


class _Dropped:
    """An older build's entry point called with this tree's arguments: the
    one at ``index``, which the older build does not take, dropped."""

    def __init__(self, fn, index: int):
        self.fn, self.index = fn, index

    def __call__(self, *args):
        return self.fn(*args[:self.index], *args[self.index + 1:])


def _bind_old_gemm(lib):
    """An older GEMM build's entry points: the program launch without
    ``out1``, and the min-plus launch the distance product had there."""
    fn = lib.ca_gemm_program_launch
    fn.argtypes = ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 20
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    if hasattr(lib, "ca_gemm_min_plus_launch"):
        fn = lib.ca_gemm_min_plus_launch
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int


class _Lib:
    """An older GEMM build seen through this tree's entry point."""

    def __init__(self, lib):
        self.ca_gemm_program_launch = _Dropped(lib.ca_gemm_program_launch, 17)


def _gemm_library(gemm: pathlib.Path):
    """K._library for the GEMM source ``gemm``, older entry points too."""
    if "void* out1" in gemm.read_text():
        return lambda: _build.load(gemm, K._bind)
    return lambda: _Lib(_build.load(gemm, _bind_old_gemm))


def _distance_entry(d: pathlib.Path):
    """K._distance_entry for the sources in ``d``: its own source's entry,
    or (before it had one) the GEMM source's ``ca_gemm_min_plus_launch``,
    which takes the same arguments."""
    own = d / "distance_product.cu"
    if own.exists():
        return lambda: _build.load(own, K._bind_distance).distance_product_launch
    return lambda: _build.load(d / "ca_gemm_program.cu",
                               _bind_old_gemm).ca_gemm_min_plus_launch


def _paged_entry(paged: pathlib.Path):
    """FA._paged_entry for the K2 source ``paged``: one without the plan's
    K chunk is called with ``dkc`` dropped."""
    if "int dkc" in paged.read_text():
        return lambda: _build.load(paged, FA._bind).paged_flash_attn_launch

    def bind(lib):
        fn = lib.paged_flash_attn_launch
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                       + [ctypes.c_float] + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lambda: _Dropped(_build.load(paged, bind).paged_flash_attn_launch,
                            25)


def _takes_int8_decode(gemm: pathlib.Path, k1_route) -> bool:
    """Whether the GEMM build of ``gemm`` has the int8 decode route: it
    launches a small dqb program at m = 1 there, or its entry point
    refuses the route (an error returned before any launch)."""
    K._library = _gemm_library(gemm)
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
    ap.add_argument("--prefill", action="store_true",
                    help="also time full-width stablelm-1.6b prefills of a "
                         "1000-token prompt in int8w and w8a8, wall clock")
    ap.add_argument("--only", nargs="*", default=[],
                    help="keep the cases whose name holds any of these")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    k1_route, launch_fwd, launch_paged = (K.k1_route, FA._launch_fwd,
                                          FA._launch)
    gen = torch.Generator(device="cuda").manual_seed(3)
    kept = [c for c in cases(gen)
            if not args.only or any(w in c[0] for w in args.only)]
    # The GEMM build is probed (and so compiled) only for GEMM cases.
    gemm_cases = any(not c[0].startswith(("K1g", "K2", "K3"))
                     for c in kept) or args.prefill
    builds = {}
    for tag, d in (("A", args.old_csrc), ("B", args.new)):
        d = d.resolve()
        gemm, fwd = d / "ca_gemm_program.cu", d / "flash_attn_fwd.cu"
        paged = d / "paged_flash_attn.cu"
        builds[tag] = dict(
            gemm=gemm, k4=d / "ca_mmm_k_outer.cu", fwd=fwd, paged=paged,
            dist=_distance_entry(d), paged_entry=_paged_entry(paged),
            decode="ROUTE_DECODE" in gemm.read_text(),
            int8_wgmma="ca_gemm_wgmma_int8_kernel" in gemm.read_text(),
            fwd_routed="int route," in fwd.read_text(),
            paged_planned="int splits" in paged.read_text())
        builds[tag]["int8_decode"] = (builds[tag]["decode"] and gemm_cases
                                      and _takes_int8_decode(gemm, k1_route))
        print(f"build {tag}: {d} (decode route "
              f"{builds[tag]['decode']}, int8 decode "
              f"{builds[tag]['int8_decode']}, int8 wgmma "
              f"{builds[tag]['int8_wgmma']}, K3 routes "
              f"{builds[tag]['fwd_routed']}, K2 splits "
              f"{builds[tag]['paged_planned']})", flush=True)

    def routed(b):
        """k1_route for build ``b``: m <= 8 on its SIMT tile where it has no
        decode route, or none for int8 B; int8 B at m > 8 on its SIMT tile
        where it has no int8 wgmma route."""
        def route(spec, layout, a_dtype, b_dtype, *args, **kw):
            r = k1_route(spec, layout, a_dtype, b_dtype, *args, **kw)
            if r == "decode":
                takes = b["decode"] and (b_dtype != torch.int8
                                         or b["int8_decode"])
                return r if takes else "simt"
            if r == "wgmma" and b_dtype == torch.int8 \
                    and not b["int8_wgmma"]:
                return "simt"
            return r
        return route

    def use(tag):
        b = builds[tag]
        K._library = _gemm_library(b["gemm"])
        K._distance_entry = b["dist"]
        FA._paged_entry = b["paged_entry"]
        K.K_OUTER_SOURCE = b["k4"]
        K.k1_route = routed(b)
        FA.FWD_SOURCE = b["fwd"]
        FA.SOURCE = b["paged"]
        FA._launch_fwd = launch_fwd if b["fwd_routed"] \
            else _k3_without_route(b["fwd"])
        FA._launch = launch_paged if b["paged_planned"] \
            else _k2_without_plan(b["paged"])

    for name, fn, copies, plain in kept:
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
        slow = (name.startswith(("K4", "K1a", "K1g 4096"))
                or name == "K3 stablelm S4096"
                or ("dq" in name and name.endswith("m=1000")))
        iters = 5 if slow else 20
        for _ in range(2):
            for tag in "ABBA":
                use(tag)
                times[tag].append(CS._time_ms(fn, copies, iters=iters,
                                              reps=4))
        record = {
            "case": name,
            "bit_equal": all(torch.equal(p, q)
                             for p, q in zip(outs["A"], outs["B"])),
            "max_abs_err": errs, "A_ms": sorted(times["A"]),
            "B_ms": sorted(times["B"])}
        if name == K1G_CASES[0][0]:
            # The clock each version's kernel holds, and its power.
            for tag in "AB":
                use(tag)
                ghz, watts, samples = CS.sustained_clock(lambda: fn(0))
                record[f"{tag}_held_ghz"] = ghz
                record[f"{tag}_held_w"] = watts
        print("ab " + json.dumps(record), flush=True)
    if args.prefill:
        prefill_ab(use)


def prefill_ab(use, rounds=3):
    """The end-to-end effect of the int8 GEMMs: one full-width
    stablelm-1.6b prefill of a 1000-token prompt (random weights from seed
    0, quantized on the card; w8a8 calibrated once on 2 prompts), timed on
    the host clock between two synchronisations, builds A, B, B, A for
    ``rounds`` rounds after one warm-up each; the logits of both builds
    compared."""
    M = CS.M
    cfg = CS.get_config(CS.ARCH)
    qp = CS.CM.quantize_params(M.init_params(cfg, seed=0))
    w8a8 = CS.ServeEngine(qp, cfg, max_len=1040, quantize_activations=True,
                          calibration_batches=2,
                          act_qconfig=CS.QuantConfig(act_fmt="int8")).params
    tokens = torch.as_tensor(
        CS.np.random.RandomState(0).randint(0, cfg.vocab_size, 1000),
        device="cuda")[None]
    for mode, params in (("int8w", qp), ("w8a8", w8a8)):
        def run():
            torch.cuda.synchronize()
            t0 = CS.time.perf_counter()
            with torch.inference_mode():
                logits, _ = M.prefill(params, {"tokens": tokens}, cfg,
                                      max_len=1040)
            torch.cuda.synchronize()
            return logits, (CS.time.perf_counter() - t0) * 1e3
        outs = {}
        for tag in "AB":
            use(tag)
            outs[tag] = run()[0].float()
        times = {"A": [], "B": []}
        for _ in range(rounds):
            for tag in "ABBA":
                use(tag)
                times[tag].append(run()[1])
        scale = outs["A"].abs().max().item()
        print("ab " + json.dumps({
            "case": f"{mode} prefill 1000 tokens (wall)",
            "max_abs_diff_vs_A": (outs["B"] - outs["A"]).abs().max().item(),
            "max_abs_A": scale, "A_ms": sorted(times["A"]),
            "B_ms": sorted(times["B"])}), flush=True)


if __name__ == "__main__":
    main()
