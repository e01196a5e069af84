"""Probe K1g, the distance product, on the card: what its time is made of.

It prints
- ``issue``: the issue rate of the kernel's step alone, lane-instructions a
  clock per SM at the card's maximum SM clock, from a microbenchmark of
  register operands only (an FADD stream, an FMNMX.NAN stream, and the
  step, FADD then FMNMX.NAN, as the kernel issues it: 64 terms a thread,
  two CTAs of 256 threads an SM, as the kernel runs);
- ``ptxas``: the registers and spills of every instantiation of each
  build below;
- ``sass``: the opcode counts of this tree's fp32 vector kernel;
- one ``variant`` line per build, its times at 4096^3 (fp32 and bf16,
  CUDA events, builds in turns A B ... B A) and whether its output is the
  tree's bit for bit.

The builds are patched copies of ``src/repro_torch/csrc/distance_product.cu``
written under ``build/k1g_probe/``: ``this`` (the tree's), ``bk16`` (slabs
of 16 rows of k), ``regs_b`` (fp32 B through registers, not cp.async) and
``no_prefetch`` (each k step's fragments read just before its
products).  Run from the repository root on the card::

    python3 tools/k1g_probe.py
"""

from __future__ import annotations

import collections
import concurrent.futures
import ctypes
import json
import pathlib
import re
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ca_mmm as K  # noqa: E402

OUT = _build.BUILD_DIR / "k1g_probe"
N = 4096

MICRO = r"""
#include <cuda_runtime.h>
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
// 64 terms a thread an iteration on register operands; the empty asm makes
// the operands new each iteration without an instruction.
template <int MODE>
__global__ void __launch_bounds__(256, 2) micro(float* out, int iters) {
  float fa[8], fb[8], acc[8][8];
  for (int i = 0; i < 8; ++i) {
    fa[i] = threadIdx.x * 1e-3f + i;
    fb[i] = blockIdx.x * 1e-3f - i;
  }
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 8; ++j) acc[i][j] = 1e30f;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      asm volatile("" : "+f"(fa[i]));
      asm volatile("" : "+f"(fb[i]));
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (MODE == 0) acc[i][j] = __fadd_rn(acc[i][j], fa[i]);
        else if (MODE == 1) acc[i][j] = min_nan(acc[i][j], fb[j]);
        else acc[i][j] = min_nan(acc[i][j], __fadd_rn(fa[i], fb[j]));
      }
  }
  float s = 0.f;
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 8; ++j) s += acc[i][j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int micro_launch(float* out, int mode, int blocks, int iters) {
  if (mode == 0) micro<0><<<blocks, 256>>>(out, iters);
  else if (mode == 1) micro<1><<<blocks, 256>>>(out, iters);
  else micro<2><<<blocks, 256>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def _sub(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f"k1g_probe: the kernel source changed; no {old!r}")
    return text.replace(old, new, 1)


FRAG = """    float fa[2][TM], fb[2][TN];
    frag(buf, 0, fa[0], fb[0]);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {"""
FRAG_NEXT = ("      if (kk + 1 < BK) frag(buf, kk + 1, fa[(kk + 1) & 1], "
             "fb[(kk + 1) & 1]);\n")


def variants():
    """{name: patched source} of the builds compared."""
    src = K.DISTANCE_SOURCE.read_text()
    no_prefetch = _sub(_sub(src, FRAG, """#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float fa[2][TM], fb[2][TN];
      frag(buf, kk, fa[kk & 1], fb[kk & 1]);"""), FRAG_NEXT, "")
    return {
        "this": src,
        "bk16": _sub(src, "return VEC && !(A_F32 && !B_F32) ? 32 : 16;",
                     "return 16;"),
        "regs_b": _sub(src, "constexpr bool ASYNC_B = B_F32 && VEC;",
                       "constexpr bool ASYNC_B = false;"),
        "no_prefetch": no_prefetch,
    }


def _nvcc(name: str, source: str):
    path = OUT / f"{name}.cu"
    path.write_text(source)
    lib = OUT / f"{name}.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas",
                           "-v", "-o", str(lib), str(path)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on {name}:\n{proc.stderr[-4000:]}")
    return name, lib, proc.stderr


def _ptxas(log: str):
    """{kernel: (registers, spill store bytes)} from ptxas's -v lines."""
    info, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and cur:
            info.setdefault(cur, [None, 0])[1] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            info.setdefault(cur, [None, 0])[0] = int(m.group(1))
    return info


def _opcodes(lib: pathlib.Path, want: str):
    sass = subprocess.run(["cuobjdump", "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    counts, cur = collections.Counter(), None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1)
            continue
        if cur and want in cur and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            body = re.sub(r"^\s*/\*[0-9a-f]+\*/\s*", "", line)
            body = re.sub(r"^@!?U?P\w+\s+", "", body)
            counts[body.split()[0].rstrip(";")] += 1
    return dict(counts.most_common())


def _events_ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = dict(variants(), micro=MICRO)
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        built = {name: (lib, log) for name, lib, log in
                 pool.map(lambda kv: _nvcc(*kv), jobs.items())}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ghz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0]) / 1e3
    micro = ctypes.CDLL(str(built["micro"][0])).micro_launch
    micro.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int]
    micro.restype = ctypes.c_int
    blocks, iters = sms * 16, 2000
    out = torch.empty(blocks * 256, device="cuda")
    for mode, name in enumerate(("FADD", "FMNMX.NAN", "FADD+FMNMX.NAN")):
        ms = _events_ms(lambda: micro(out.data_ptr(), mode, blocks, iters),
                        reps=2)
        lanes = blocks * 256 * iters * 64 * (2 if mode == 2 else 1)
        print("issue " + json.dumps({
            "stream": name, "ms": ms,
            "lane_instructions_per_clock_per_sm":
                lanes / (ms * 1e-3) / sms / (ghz * 1e9),
            "sm_clock_max_ghz": ghz}), flush=True)
    for name, (lib, log) in built.items():
        if name != "micro":
            print("ptxas " + json.dumps({"build": name,
                                         "kernels": _ptxas(log)}))
    print("sass " + json.dumps(_opcodes(built["this"][0], "ILb1ELb1ELb1E")))
    entries = {}
    for name, (lib, _) in built.items():
        if name == "micro":
            continue
        fn = ctypes.CDLL(str(lib)).distance_product_launch
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        entries[name] = fn
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand(N, N, generator=gen, device="cuda")
    operands = {"fp32": x, "bf16": x.bfloat16()}

    def run(fn, a):
        o = torch.empty(N, N, device="cuda")
        f32 = int(a.dtype == torch.float32)
        err = fn(a.data_ptr(), a.data_ptr(), o.data_ptr(), N, N, N, f32, f32,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"launch failed: {err}")
        return o

    want = {d: run(entries["this"], a) for d, a in operands.items()}
    times = collections.defaultdict(list)
    order = list(entries)
    for sweep in (order, order[::-1]):
        for name in sweep:
            for d, a in operands.items():
                times[(name, d)].append(
                    _events_ms(lambda: run(entries[name], a)))
    for name, fn in entries.items():
        print("variant " + json.dumps({
            "build": name,
            "bit_equal_to_this": all(torch.equal(run(fn, a), want[d])
                                     for d, a in operands.items()),
            **{f"{d}_ms": sorted(times[(name, d)]) for d in operands}}),
            flush=True)


if __name__ == "__main__":
    main()
