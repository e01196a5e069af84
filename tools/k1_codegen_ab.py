"""Compare two versions of the CA-GEMM program kernel's float path on the
card: the generated code and the time of the same launch.

Builds each given ``ca_gemm_program.cu`` with the port's nvcc flags plus
``-Xptxas -v``, and for the float bf16 instantiations of both tiles
(8 x 16 x 128 for m <= 8, 64 x 64 x 32 above; one and two B branches,
vector B loads) prints

* ptxas's registers, stack frame, spills and shared memory (of every
  instantiation, also written to ``ptxas_A.json``/``ptxas_B.json``);
* the SASS instruction count, the opcode histogram and the opcodes whose
  counts differ between the two builds;
* for every SIMT instantiation the two builds share (in the terms both
  share), and every wgmma one where both builds have that route, whether
  its SASS opcode sequence is the same in both;

then times both builds' launches at the decode shapes (m = 1: wq, w_down
with its residual, the rms GLU) and at m = 128 (wq, w_down) in one
process, each call captured 20 at
a time in a CUDA graph over weight copies that together exceed the 50 MB
L2, the builds alternating A, B, B, A for ``--rounds`` rounds.

Both builds take the same C entry point (17 pointers, 19 ints; a 20th,
the caller's route, since the wgmma route); their SIMT kernels' template
flags differ: ``ABI`` is ``train`` for a build whose last flag is
``TRAIN`` (before the distance product), ``k1g`` for one with a
``MIN_PLUS`` flag after it, ``wgmma`` for one that also has the TMA +
WGMMA route (its SIMT kernels take the ``k1g`` flags, and its
``ca_gemm_wgmma_kernel`` instantiations are the only ones it has alone),
``decode`` for one that also has the split-k decode route (route 2;
its ``ca_gemm_decode_kernel`` instantiations are compared where both
builds have them), ``int8wg`` for one that also takes the int8
programs at m > 8 on the wgmma route (``ca_gemm_wgmma_int8_kernel``,
compared where both builds have it), and ``k1gown`` for one whose
distance product is a source of its own (this tree): its SIMT kernels
drop the ``MIN_PLUS`` flag again (the ``train`` build's terms), and its
C entry point takes an 18th pointer, a dual program's second output.  A ``wgmma``, ``decode`` or ``int8wg`` build runs the
m = 128 shapes on its wgmma route, and a ``decode`` or ``int8wg`` build
the m = 1 shapes on its decode route, so where the two builds' routes
differ the outputs are compared within bf16's rounding (one output ulp,
2^-7 of the largest |output|) rather than bit for bit.

``--attn OLD_CSRC NEW_CSRC`` also builds the two attention sources of each
directory (``paged_flash_attn.cu``, K2; ``flash_attn_fwd.cu``, K3) and
compares the SASS opcode sequence of every kernel both builds have; a
build that takes head dims above 128 carries a trailing ``WIDE`` template
flag on its SIMT kernels, dropped where it is false, and the ``WIDE``
instantiations are its own.  Run from the repository root
on the card::

    python3 tools/k1_codegen_ab.py A.cu:int8wg B.cu:k1gown --out DIR \
        [--attn OLD_CSRC_DIR src/repro_torch/csrc]

The SASS of the compared functions is written under ``--out``.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import difflib
import json
import math
import pathlib
import re
import shutil
import subprocess
import sys

import torch

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# The two tiles' template arguments (BM, BN, BK, TM, TN), as demangled.
TILES = {"8x16x128": "8, 16, 128, 1, 1", "64x64x32": "64, 64, 32, 4, 4"}
# Each ABI's trailing template flags of the float kernels compared:
# VEC_B, TRAIN (and MIN_PLUS).
ABIS = {"train": "true, false", "k1g": "true, false, false",
        "wgmma": "true, false, false", "decode": "true, false, false",
        "int8wg": "true, false, false", "k1gown": "true, false"}
# The ABIs with a wgmma route, those with a decode route too, those with
# the int8 wgmma kernel, and those whose SIMT kernels carry no MIN_PLUS
# flag.
WGMMA_ABIS = {"wgmma", "decode", "int8wg", "k1gown"}
DECODE_ABIS = {"decode", "int8wg", "k1gown"}
INT8WG_ABIS = {"int8wg", "k1gown"}
FLAGLESS_ABIS = {"train", "k1gown"}
# The attention kernels compared by --attn, and the template flag the
# newer ones carry.
ATTN_SOURCES = ("paged_flash_attn.cu", "flash_attn_fwd.cu")
ATTN_KERNELS = ("paged_fa_kernel", "flash_attn_fwd_kernel",
                "flash_attn_wgmma_kernel")
SILU = 3


def _tool(name):
    for cand in (shutil.which(name), f"/usr/local/cuda/bin/{name}",
                 f"/usr/bin/{name}"):
        if cand and pathlib.Path(cand).exists():
            return cand
    raise RuntimeError(f"{name} not found")


def build(src: pathlib.Path, out_dir: pathlib.Path, tag: str):
    lib = out_dir / f"{tag}.so"
    proc = subprocess.run(
        [_tool("nvcc"), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib),
         str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    return lib, proc.stderr


def demangle(names):
    proc = subprocess.run([_tool("c++filt")], input="\n".join(names),
                          capture_output=True, text=True, check=True)
    return dict(zip(names, proc.stdout.splitlines()))


def ptxas_info(log: str):
    """{mangled name: {registers, stack, spill_stores, spill_loads,
    smem}} from ptxas's -v lines."""
    info, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = info.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(s.group(1)) if s else 0
    return info


def sass_functions(lib: pathlib.Path):
    """{mangled name: [SASS instruction lines]} of the library."""
    text = subprocess.run([_tool("cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        if cur is not None and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            cur.append(line.strip())
    return funcs


def opcode(line: str) -> str:
    body = re.sub(r"^/\*[0-9a-f]+\*/\s*", "", line)
    body = re.sub(r"^@!?U?P\w+\s+", "", body)       # predicate guard
    return body.split()[0].rstrip(";") if body.split() else ""


def common_name(demangled: str, abi: str, other: str) -> str:
    """A kernel's demangled name in the terms the two builds share
    (``other`` is the other build's ABI); None for a kernel only this build
    can have.  The wgmma route's kernels are compared where both builds
    have the route, the decode route's and the int8 wgmma kernel's where
    both have theirs.  ``k1g`` to ``int8wg`` builds carry one more
    template flag (``MIN_PLUS``) after ``TRAIN``: against a ``train`` or
    ``k1gown`` build it is dropped, and the ``MIN_PLUS`` instantiation has
    no counterpart."""
    if "ca_gemm_wgmma_kernel" in demangled:
        both = {abi, other} <= WGMMA_ABIS
        return demangled if both else None
    if "ca_gemm_wgmma_int8_kernel" in demangled:
        return demangled if {abi, other} <= INT8WG_ABIS else None
    if "ca_gemm_decode_kernel" in demangled:
        return demangled if {abi, other} <= DECODE_ABIS else None
    if "ca_gemm_program_kernel" not in demangled:
        return None
    if abi in FLAGLESS_ABIS or other not in FLAGLESS_ABIS:
        return demangled
    if ", true>(" in demangled:
        return None
    return demangled.replace(", false>(", ">(")


def select(demangled, tile: str, nb: int, abi: str):
    want = (f"ca_gemm_program_kernel<__nv_bfloat16, __nv_bfloat16, "
            f"{TILES[tile]}, {nb}, {ABIS[abi]}>")
    hits = [k for k, v in demangled.items() if want in v]
    if len(hits) != 1:
        raise RuntimeError(f"{want}: {len(hits)} matches")
    return hits[0]


class Entry:
    """One build's C entry point, called with the float programs'
    arguments."""

    def __init__(self, lib: pathlib.Path, abi: str):
        self.routed = abi in WGMMA_ABIS
        self.decode = abi in DECODE_ABIS
        self.dual = abi == "k1gown"       # the 18th pointer, out1
        self.fn = ctypes.CDLL(str(lib)).ca_gemm_program_launch
        self.fn.argtypes = ([ctypes.c_void_p] * (18 if self.dual else 17)
                            + [ctypes.c_int] * (20 if self.routed else 19)
                            + [ctypes.c_void_p])
        self.fn.restype = ctypes.c_int

    def route(self, m):
        """The route code for these bf16, 16-byte aligned operands (0 SIMT,
        1 wgmma at m > 8, 2 decode at m <= 8 where the build has it), or
        None for a build without routes."""
        if not self.routed:
            return None
        return 1 if m > 8 else 2 if self.decode else 0

    def __call__(self, a, b0, b1, row_scale, gain, residual, out, glu_act):
        m, k = a.shape
        n = out.shape[1]
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        ptrs = [ptr(a), ptr(b0), ptr(b1), ptr(row_scale), ptr(gain), None,
                None, None, ptr(residual), ptr(out)]
        flags = [int(gain is not None and gain.dtype == torch.float32), 0,
                 0, 0, 0, 0, glu_act]      # gain, bias, mul, res, out, act
        # No preact or save_preact outputs, no scales, nn, no dact.
        args = (ptrs + [None] * (8 if self.dual else 7) + [m, n, k, 1, 1]
                + flags
                + [0, 0, 0] + [0, 0, 0, 0])
        if self.routed:
            args += [self.route(m)]
        err = self.fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch returned {err}")


def time_ms(fn, n_sets, iters=20, reps=5):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i % n_sets)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for i in range(iters):
            fn(i % n_sets)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def shapes(gen):
    """(name, m, k, n, operands(i) -> kwargs, copies) of the timed GEMMs."""
    dev, bf = "cuda", torch.bfloat16
    out = []
    for name, m, k, n, nb in (("wq", 1, 2048, 2048, 1),
                              ("w_down", 1, 5632, 2048, 1),
                              ("gate+up", 1, 2048, 5632, 2),
                              ("wq", 128, 2048, 2048, 1),
                              ("w_down", 128, 5632, 2048, 1)):
        copies = max(2, math.ceil(120e6 / (nb * k * n * 2)))
        a = torch.randn(m, k, generator=gen, device=dev).to(bf)
        ws = [[(torch.randn(k, n, generator=gen, device=dev)
                / math.sqrt(k)).to(bf) for _ in range(nb)]
              for _ in range(copies)]
        o = torch.empty(m, n, device=dev, dtype=bf)
        res = (torch.randn(m, n, generator=gen, device=dev).to(bf)
               if name == "w_down" else None)
        rs = (torch.rand(m, generator=gen, device=dev) + 0.5
              if nb == 2 else None)
        gain = (torch.rand(k, generator=gen, device=dev) + 0.5
                if nb == 2 else None)

        def ops(i, a=a, ws=ws, o=o, res=res, rs=rs, gain=gain, nb=nb):
            return dict(a=a, b0=ws[i][0], b1=ws[i][1] if nb == 2 else None,
                        row_scale=rs, gain=gain, residual=res, out=o,
                        glu_act=SILU if nb == 2 else 0)
        out.append((name, m, k, n, ops, copies))
    return out


def attn_name(demangled: str) -> str:
    """An attention kernel's demangled name in the terms both builds
    share: a false trailing ``WIDE`` flag dropped."""
    if any(k in demangled for k in ATTN_KERNELS):
        return demangled.replace(", false>(", ">(")
    return demangled


def compare_attn(old_dir: pathlib.Path, new_dir: pathlib.Path,
                 out_dir: pathlib.Path):
    """The SASS opcode sequences of the attention kernels both builds of
    each source have; a kernel of the older build missing from the newer
    one, or one whose sequence differs, raises."""
    for src in ATTN_SOURCES:
        seqs = []
        for tag, d in (("old", old_dir), ("new", new_dir)):
            lib, log = build(d / src, out_dir, f"{tag}_{pathlib.Path(src).stem}")
            funcs = sass_functions(lib)
            dem = demangle(list(funcs))
            info = ptxas_info(log)
            seqs.append({attn_name(dem[f]): [opcode(x) for x in ls]
                         for f, ls in funcs.items()})
            for f in funcs:
                print(f"  ptxas {tag} {dem[f]}: "
                      f"{json.dumps(info.get(f, {}))}")
        shared = sorted(set(seqs[0]) & set(seqs[1]))
        differ = [k for k in shared if seqs[0][k] != seqs[1][k]]
        missing = sorted(set(seqs[0]) - set(seqs[1]))
        print(f"{src}: kernels in both builds: {len(shared)}; identical "
              f"SASS opcode sequences: {len(shared) - len(differ)}; "
              f"differing: {json.dumps(differ)}; only in the older: "
              f"{json.dumps(missing)}; only in the newer: "
              + json.dumps(sorted(set(seqs[1]) - set(seqs[0]))))
        if differ or missing:
            raise AssertionError(f"{src}: the older build's kernels changed")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("builds", nargs=2, metavar="SRC.cu:ABI")
    ap.add_argument("--out", default="chiprun_out/k1_codegen")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--attn", nargs=2, type=pathlib.Path,
                    metavar=("OLD_CSRC", "NEW_CSRC"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    builds = []
    for tag, spec in zip("AB", args.builds):
        src, abi = spec.rsplit(":", 1)
        if abi not in ABIS:
            sys.exit(f"ABI {abi!r}: one of {sorted(ABIS)}")
        lib, log = build(pathlib.Path(src), out_dir, tag)
        funcs = sass_functions(lib)
        dem = demangle(list(funcs))
        builds.append(dict(tag=tag, src=src, abi=abi, lib=lib,
                           ptxas=ptxas_info(log), funcs=funcs, dem=dem))
        table = {dem[name]: info for name, info in
                 builds[-1]["ptxas"].items() if name in dem}
        (out_dir / f"ptxas_{tag}.json").write_text(
            json.dumps(table, indent=1, sort_keys=True))
        print(f"build {tag}: {src} ({abi} template flags), "
              f"{len(funcs)} kernels")
        for fn, info in sorted(table.items()):
            print(f"  ptxas {tag} {fn.split('ca_gemm_program_kernel')[-1]}"
                  f": {json.dumps(info)}")
    for tile in TILES:
        for nb in (1, 2):
            hist, seqs = [], []
            for b in builds:
                name = select(b["dem"], tile, nb, b["abi"])
                lines = b["funcs"][name]
                (out_dir / f"{b['tag']}_{tile}_nb{nb}.sass").write_text(
                    b["dem"][name] + "\n" + "\n".join(lines) + "\n")
                seqs.append([opcode(x) for x in lines])
                hist.append(collections.Counter(seqs[-1]))
                print(f"{tile} nb={nb} build {b['tag']}: {b['dem'][name]}")
                print(f"  ptxas {json.dumps(b['ptxas'].get(name, {}))}; "
                      f"{len(lines)} SASS instructions")
            diff = {op: (hist[0][op], hist[1][op])
                    for op in sorted(set(hist[0]) | set(hist[1]))
                    if hist[0][op] != hist[1][op]}
            same = sum(blk.size for blk in difflib.SequenceMatcher(
                None, seqs[0], seqs[1], autojunk=False).get_matching_blocks())
            print(f"{tile} nb={nb} opcode counts A vs B where they differ: "
                  + json.dumps(diff) + f"; opcodes in order shared: {same}")
    seqs = []
    for b in builds:
        other = builds[1 - builds.index(b)]["abi"]
        named = {common_name(b["dem"][f], b["abi"], other):
                 [opcode(x) for x in ls]
                 for f, ls in b["funcs"].items()}
        seqs.append({k: v for k, v in named.items() if k is not None})
    shared = sorted(set(seqs[0]) & set(seqs[1]))
    differ = [k for k in shared if seqs[0][k] != seqs[1][k]]
    print(f"instantiations in both builds: {len(shared)}; identical SASS "
          f"opcode sequences: {len(shared) - len(differ)}; differing: "
          + json.dumps(differ) + "; only in A: "
          + json.dumps(sorted(set(seqs[0]) - set(seqs[1]))) + "; only in B: "
          + json.dumps(sorted(set(seqs[1]) - set(seqs[0]))))
    if args.attn:
        compare_attn(*args.attn, out_dir)
    entries = [Entry(b["lib"], b["abi"]) for b in builds]
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, m, k, n, ops, copies in shapes(gen):
        outs = []
        for e in entries:
            e(**ops(0))
            outs.append(ops(0)["out"].clone())
        same = torch.equal(outs[0], outs[1])
        routes = [e.route(m) or 0 for e in entries]
        err = (outs[0].float() - outs[1].float()).abs().max().item()
        scale = outs[0].float().abs().max().item()
        times = {"A": [], "B": []}
        for _ in range(args.rounds):
            for tag in "ABBA":
                e = entries["AB".index(tag)]
                times[tag].append(time_ms(lambda i: e(**ops(i)), copies))
        print(f"time {name} m={m} k={k} n={n}: routes (1 wgmma, 2 decode) "
              f"{routes}; "
              f"outputs bit-equal {same}, max_abs_err {err:.3e}; "
              + json.dumps(times))
        # The same route must give the same bits; SIMT against wgmma sums
        # in another order, so a bf16 output may flip one ulp.
        if (not same) if routes[0] == routes[1] else err > 2.0 ** -7 * scale:
            raise AssertionError(f"{name}: the two builds disagree")


if __name__ == "__main__":
    main()
