#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. card: prints the card's name and power limit; CUDA must be available.
2. build: compiles the CA-GEMM program kernel with nvcc into build/.
3. kernel parity: each ported program (none, res, rms>glu.silu(none|none))
   on the kernel against its plain version, in bf16 at the main path's
   shapes (m = 1, 37, 128) and in fp32 on a ragged shape.
4. slice: full-width stablelm-1.6b, all 24 layers, random weights from a
   seed, served through ServeEngine (3 requests); the kernel must launch
   exactly 145 times per prefill and per decode step.  torch.profiler then
   splits decode steps' device time by kernel (device busy share), and a
   4-layer full-width model is held against the plain path on the CPU
   (prefill logits, and greedy tokens up to a near tie).
5. times: kernel, plain version, library call and bound per program (each
   timed by replaying a CUDA graph of 20 calls), and the end-to-end
   prefill / decode times of phase 4.

The last two lines are the kernels' JSON record and the result JSON.
"""

import dataclasses
import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ca_mmm as K  # noqa: E402
from repro_torch.kernels.program import (program_from_tag,  # noqa: E402
                                         rms_row_scale)
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

ARCH = "stablelm-1.6b"
HBM_BYTES_PER_S = 3.35e12                     # H100 SXM data sheet
PEAK_OPS = {torch.bfloat16: 989e12,           # dense tensor-core bf16
            torch.float32: 67e12}             # fp32 outside the tensor cores
# Kernel vs plain version: fp32 sums in another order.  A bf16 output may
# flip one ulp (2^-8 relative), so 2e-2 of max|ref|; an fp32 output,
# whatever the inputs' dtype, 1e-4 of (1 + max|ref|).
TOL_BF16, TOL_F32 = 2e-2, 1e-4
# 4-layer bf16 model, card vs CPU plain path: every GEMM output and the
# attention probabilities round to bf16, and a flipped ulp propagates
# through four layers and the head, so 5e-2 of max|logits|.
TOL_MODEL = 5e-2
SOURCE = "src/repro_torch/csrc/ca_gemm_program.cu"
REPLACES = "src/repro/kernels/ca_mmm.py:297"

GLU = "rms>glu.silu(none|none)"
# (program, GEMM, k, n, out_dtype) of one stablelm-1.6b forward step.
GEMMS = [("none", "wq/wk/wv", 2048, 2048, None),
         ("none", "head", 2048, 100352, torch.float32),
         ("res", "wo", 2048, 2048, None),
         ("res", "w_down", 5632, 2048, None),
         (GLU, "gate+up", 2048, 5632, None)]
# The shape each program's JSON record is timed at (decode, m = 1).
RECORD_GEMM = {"none": "wq/wk/wv", "res": "w_down", GLU: "gate+up"}


def phase(name):
    print(f"== {name} ({time.strftime('%H:%M:%S')})", flush=True)


def card():
    phase("card")
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(line)
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: this script needs the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    return line


def build():
    phase("build")
    t0 = time.perf_counter()
    path = K.build()
    print(f"built {path.name} in {time.perf_counter() - t0:.3f} s")


def program_inputs(tag, m, k, n, dtype, gen, copies=1):
    """Operands of one program call (``copies`` distinct weight sets, so
    timed loops can read cold weights)."""
    spec = program_from_tag(tag)
    dev = "cuda"
    a = torch.randn(m, k, generator=gen, device=dev).to(dtype)
    sets = []
    for _ in range(copies):
        bs = [(torch.randn(k, n, generator=gen, device=dev)
               / math.sqrt(k)).to(dtype) for _ in range(spec.n_b)]
        sets.append(bs)
    kw = {"spec": spec}
    if spec.prologue.kind == "rms":
        kw["gain"] = torch.rand(k, generator=gen, device=dev) + 0.5
        kw["row_scale"] = rms_row_scale(a, 1e-5)
    ops = [{} for _ in spec.branches]
    if spec.branches[0].has_residual:
        ops[0]["residual"] = torch.randn(m, n, generator=gen,
                                         device=dev).to(dtype)
    kw["branch_operands"] = ops
    return a, sets, kw


def parity():
    phase("kernel parity")
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {}
    cases = [(tag, name, m, k, n, od, torch.bfloat16)
             for m in (1, 37, 128) for tag, name, k, n, od in GEMMS]
    cases += [(tag, "ragged", 5, 300, 200, None, torch.float32)
              for tag in ("none", "res", GLU)]
    for tag, name, m, k, n, od, dtype in cases:
        a, (bs,), kw = program_inputs(tag, m, k, n, dtype, gen)
        got = K.ca_gemm_program(a, bs, out_dtype=od, **kw)
        want = K.ca_gemm_program_reference(a, bs, out_dtype=od, **kw)
        torch.cuda.synchronize()
        if got.shape != (m, n) or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{tag} {name} m={m}: bad output")
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        # fp32 output (the head, the ragged case) differs from the plain
        # version only in summation order; bf16 output may flip one ulp.
        tol = TOL_F32 * (1 + scale) if (od or dtype) == torch.float32 \
            else TOL_BF16 * scale
        print(f"parity {tag:24s} {name:9s} m={m:<4d} k={k:<5d} n={n:<6d} "
              f"{str(dtype)[6:]:8s} max_abs_err={err:.3e} tol={tol:.3e}")
        if not err <= tol:
            raise AssertionError(f"{tag} {name} m={m}: kernel disagrees "
                                 f"with the plain version ({err} > {tol})")
        worst[tag] = max(worst.get(tag, 0.0), err)
    return worst


def serve_slice(cfg):
    phase("slice: full-width stablelm-1.6b, 24 layers, ServeEngine")
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0)          # device=None: the card
    torch.cuda.synchronize()
    print(f"init {sum(p.numel() for p in params.values())} params in "
          f"{time.perf_counter() - t0:.3f} s")
    eng = ServeEngine(params, cfg, max_len=160)
    # Warm-up request (first cuBLAS calls of the attention, allocator).
    eng.submit(Request(uid=0, prompt=np.arange(4), max_new_tokens=2))
    eng.run()
    rng = np.random.RandomState(0)
    reqs = [Request(uid=1, prompt=rng.randint(0, cfg.vocab_size, 128),
                    max_new_tokens=16),
            Request(uid=2, prompt=rng.randint(0, cfg.vocab_size, 37),
                    max_new_tokens=16),
            Request(uid=3, prompt=rng.randint(0, cfg.vocab_size, 8),
                    max_new_tokens=16, temperature=0.8)]
    for r in reqs:
        eng.submit(r)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(K.launch_counts)

    steps = sum(r.max_new_tokens for r in reqs)  # 1 prefill + n-1 decodes
    L = cfg.n_layers
    per_step = {"none": 3 * L + 1, "res": 2 * L, GLU: L}
    print(f"launches over {steps} forward steps: {counts}")
    if sum(per_step.values()) != 145:
        raise AssertionError(per_step)
    for tag, n in per_step.items():
        if counts.get(tag) != n * steps:
            raise AssertionError(f"{tag}: {counts.get(tag)} launches, "
                                 f"expected {n} x {steps}")
    if set(counts) != set(per_step):
        raise AssertionError(f"unexpected programs launched: {counts}")
    for r in reqs:
        got = done[r.uid]
        if got.status != "done" or len(got.generated) != r.max_new_tokens:
            raise AssertionError(f"request {r.uid}: {got.status}")
        print(f"request {r.uid} prompt={len(r.prompt)} "
              f"temperature={r.temperature} tokens={got.generated}")
    e2e = {"requests": [
        {"uid": r.uid, "prompt": len(r.prompt),
         "prefill_ms": r.prefill_s * 1e3,
         "decode_ms_per_token": r.decode_s * 1e3 / (r.max_new_tokens - 1)}
        for r in reqs],
        "tokens_per_s": sum(len(r.generated) for r in reqs) / wall,
        "run_s": wall}
    e2e["profile"] = profile_decode(params, cfg)
    del eng, params
    torch.cuda.empty_cache()
    return counts, e2e


def _device_us(event):
    t = getattr(event, "self_device_time_total", None)
    return t if t is not None else event.self_cuda_time_total


def profile_decode(params, cfg, steps=8):
    """Device time by kernel over ``steps`` decode steps (torch.profiler),
    and the unprofiled wall time of the same steps."""
    from torch.profiler import ProfilerActivity, profile

    prompt = torch.as_tensor(np.random.RandomState(2).randint(
        0, cfg.vocab_size, 37), device="cuda")[None]

    def decode(n, prof=None):
        with torch.inference_mode():
            logits, cache = M.prefill(params, {"tokens": prompt}, cfg,
                                      max_len=160)
            nxt = int(torch.argmax(logits[0, -1, :cfg.vocab_size]))
            torch.cuda.synchronize()
            if prof is not None:
                prof.start()
            t0 = time.perf_counter()
            for s in range(n):
                logits, cache = M.decode_step(
                    params, {"tokens": torch.full((1, 1), nxt,
                                                  device="cuda")},
                    cache, prompt.shape[1] + s, cfg)
                nxt = int(torch.argmax(logits[0, -1, :cfg.vocab_size]))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if prof is not None:
                prof.stop()
            return wall

    wall = decode(steps)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    decode(steps, prof)
    by_kernel = {}
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            by_kernel[ev.key] = by_kernel.get(ev.key, 0.0) + _device_us(ev)
    total_ms = sum(by_kernel.values()) / 1e3 / steps
    gemm_ms = sum(v for k, v in by_kernel.items()
                  if "ca_gemm_program_kernel" in k) / 1e3 / steps
    wall_ms = wall * 1e3 / steps
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    out = {"decode_wall_ms_per_step": wall_ms,
           "device_ms_per_step": total_ms,
           "gemm_kernel_ms_per_step": gemm_ms,
           "device_busy_share": total_ms / wall_ms}
    print("profile " + json.dumps(out))
    for name, us in top:
        print(f"profile top {us / 1e3 / steps:9.4f} ms/step {name[:90]}")
    return out


def cross_check(cfg):
    phase("4-layer full width: card vs CPU plain path")
    cfg4 = dataclasses.replace(cfg, n_layers=4)
    p_gpu = M.init_params(cfg4, seed=1)
    p_cpu = {k: v.cpu() for k, v in p_gpu.items()}
    prompt = np.random.RandomState(1).randint(0, cfg.vocab_size, 12)
    toks = torch.as_tensor(prompt)[None]
    with torch.inference_mode():
        lg, _ = M.prefill(p_gpu, {"tokens": toks.cuda()}, cfg4, max_len=32)
        lc, _ = M.prefill(p_cpu, {"tokens": toks}, cfg4, max_len=32)
    err = (lg.cpu() - lc).abs().max().item()
    scale = lc.abs().max().item()
    print(f"prefill logits max_abs_err={err:.4e} max|cpu|={scale:.4e} "
          f"tol={TOL_MODEL * scale:.4e}")
    if not (bool(torch.isfinite(lg).all()) and err <= TOL_MODEL * scale):
        raise AssertionError("card and CPU prefill logits disagree")
    outs = []
    for params, dev in ((p_gpu, None), (p_cpu, "cpu")):
        eng = ServeEngine(params, cfg4, max_len=32, device=dev)
        eng.submit(Request(uid=1, prompt=prompt, max_new_tokens=8))
        outs.append(eng.run()[1].generated)
    agree = sum(a == b for a, b in zip(*outs))
    print(f"greedy tokens card={outs[0]} cpu={outs[1]} "
          f"agreement={agree}/{len(outs[0])}")
    if outs[0] != outs[1]:
        # Past the first disagreement the two runs decode different
        # sequences; at it, the card's pick must be a near tie on the CPU.
        i = next(j for j, (a, b) in enumerate(zip(*outs)) if a != b)
        seq = torch.as_tensor(np.concatenate([prompt, outs[1][:i]]))[None]
        with torch.inference_mode():
            row, _ = M.prefill(p_cpu, {"tokens": seq}, cfg4, max_len=32)
        row = row[0, -1, :cfg.vocab_size]
        gap = (row.max() - row[outs[0][i]]).item()
        # Each of the two logits may be off by the prefill tolerance.
        limit = 2 * TOL_MODEL * row.abs().max().item()
        print(f"first disagreement at token {i}: CPU logit gap {gap:.4e} "
              f"(limit {limit:.4e})")
        if not gap <= limit:
            raise AssertionError("card and CPU greedy tokens disagree "
                                 "beyond a near tie")


def _time_ms(fn, n_sets, iters=20, reps=5):
    """Device ms per call.  ``iters`` calls (rotating the weight sets) are
    captured in one CUDA graph and the graph is replayed ``reps`` times
    between two events, so no host work sits between the launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):                 # warm-up outside the capture
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
    del graph
    return start.elapsed_time(end) / (iters * reps)


def _library_call(tag, a, bs, kw, od):
    """One PyTorch call computing the same function, where there is one
    (a yardstick only; the port never calls it)."""
    if tag == "res":
        res = kw["branch_operands"][0]["residual"]
        return lambda i: torch.addmm(res, a, bs[i][0])
    if tag == "none" and od is None:
        return lambda i: torch.matmul(a, bs[i][0])
    if tag == "none":
        try:
            torch.mm(a, bs[0][0], out_dtype=od)
        except (TypeError, NotImplementedError, RuntimeError):
            return None
        return lambda i: torch.mm(a, bs[i][0], out_dtype=od)
    return None


def bound(tag, m, k, n, od, dtype):
    spec = program_from_tag(tag)
    es = torch.finfo(dtype).bits // 8
    oes = torch.finfo(od or dtype).bits // 8
    nbytes = m * k * es + spec.n_b * k * n * es + m * n * oes
    if spec.branches[0].has_residual:
        nbytes += m * n * es
    if spec.prologue.kind == "rms":
        nbytes += 4 * m + 4 * k
    ops = 2 * m * n * k * spec.n_b
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def times():
    phase("times (CUDA graph replay; weights rotated past the 50 MB L2)")
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for m in (1, 128):
        for tag, name, k, n, od in GEMMS:
            nb = program_from_tag(tag).n_b
            copies = max(2, math.ceil(120e6 / (nb * k * n * 2)))
            a, sets, kw = program_inputs(tag, m, k, n, torch.bfloat16, gen,
                                         copies)
            ms = _time_ms(lambda i: K.ca_gemm_program(
                a, sets[i], out_dtype=od, **kw), copies)
            plain = _time_ms(lambda i: K.ca_gemm_program_reference(
                a, sets[i], out_dtype=od, **kw), copies)
            lib_fn = _library_call(tag, a, sets, kw, od)
            lib = _time_ms(lib_fn, copies) if lib_fn is not None else None
            b_ms, b_by = bound(tag, m, k, n, od, torch.bfloat16)
            row = {"program": tag, "gemm": name, "m": m, "k": k, "n": n,
                   "ms": ms, "plain_ms": plain, "library_ms": lib,
                   "bound_ms": b_ms, "bound_by": b_by}
            rows.append(row)
            print("time " + json.dumps(row))
            del a, sets, kw
    return rows


def main():
    t_start = time.perf_counter()
    card_line = card()
    build()
    worst = parity()
    cfg = get_config(ARCH)
    counts, e2e = serve_slice(cfg)
    cross_check(cfg)
    rows = times()
    phase("summary")
    print(f"card: {card_line}")
    for r in e2e["requests"]:
        print(f"e2e request {r['uid']} prompt={r['prompt']}: "
              f"prefill {r['prefill_ms']:.3f} ms, decode "
              f"{r['decode_ms_per_token']:.3f} ms/token")
    print(f"e2e tokens/s {e2e['tokens_per_s']:.3f} over "
          f"{e2e['run_s']:.3f} s; weight-byte bound 0.86 ms/token")
    print("e2e decode profile " + json.dumps(e2e["profile"]))
    kernels = []
    for tag, gemm in RECORD_GEMM.items():
        row = next(r for r in rows if r["program"] == tag
                   and r["gemm"] == gemm and r["m"] == 1)
        kernels.append({
            "name": f"ca_gemm_program[{tag}]", "route": "cuda",
            "source": SOURCE, "replaces": REPLACES,
            "launches": counts[tag], "max_abs_err": worst[tag],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "shape": f"{gemm} m=1 k={row['k']} n={row['n']} bf16"})
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
