#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. card: prints the card's name and power limit; CUDA must be available.
2. build: compiles the four kernel sources (the CA-GEMM program kernel, the
   paged decode-attention kernel, the forward flash-attention kernel and
   the k-outer ablation kernel) with nvcc into build/, one nvcc per
   source, all started together.
3. kernel parity: each float program (none, res, rms>glu.silu(none|none))
   on the kernel against its plain version, in bf16 at the main path's
   shapes (m = 1, 37, 128 and the 1000-token prefill; h2o-danube-3-4b's at
   m = 1), on a ragged bf16 shape (m, n, k multiples of 8, not of the
   tile) and in fp32 on a ragged shape; each call's K1 route is asserted
   (for bf16 wgmma at m > 8 and the split-k decode kernel at m <= 8, SIMT
   for fp32).  The paged attention kernel
   against its plain version in fp32 and bf16 at stablelm-1.6b's and
   danube's serve shapes, at a ragged windowed danube batch, at B = 8,
   S = 4096 for both head geometries, at granite-20b's 48 query heads
   over one KV head (D = 128), at deepseek-v2-lite's MLA head (D = 192,
   Dv = 128) and on its split path (stablelm at B = 1, S = 4096; ragged
   lengths and a window that leave splits empty; len = 0, which drains
   zeros); bit-identical when the pool's free pages are poisoned and
   when a call is repeated.
4. slice: full-width stablelm-1.6b, all 24 layers, random weights from a
   seed, served through ServeEngine (3 requests) on the slab cache; the
   kernel must launch exactly 145 times per prefill and per decode step,
   each prefill of more than 8 tokens on the wgmma route and the 8-token
   prefill and every decode step on the decode route.
   torch.profiler then splits decode steps' device time by kernel (device
   busy share), and a 4-layer full-width model is held against the plain
   path on the CPU (prefill logits, and greedy tokens up to a near tie).
5. paged slice: the same model serves 4 requests on the slab cache and
   with paged_kv=True (int8 pages, decode attention on the paged kernel):
   prefill logits bit-equal, greedy tokens equal up to a near tie, exactly
   24 paged-attention and 145 GEMM launches per decode step and none of
   the first in prefill, routes as in 4; one paged-attention call of the run is replayed
   on the kernel and its plain version.  Host timers split decode steps'
   host time (KV insert, decode attention) slab vs paged, alternating
   over 3 rounds, and count the torch ops of each.  A 4-layer model's
   paged decode logits on the card are held against the CPU's, and
   torch.profiler splits paged decode steps' device time by kernel; then
   full-width h2o-danube-3-4b (GQA, head_dim 120) serves one request both
   ways with the same checks.
6. int8 parity: every dqb (int8 weights, K1d) and dqab (w8a8, K1e)
   program against its plain version: the main path's shapes at m = 1, 5,
   37, 128, 1000 with per-channel scales, ragged n and k with per-tile
   scales (g = 128, 256, ragged last block; per-k-tile activation
   scales), fp32 A and out, and w8a8 at k = 4096 with saturated operands
   at m = 4 and 128, bit-exact; each call's K1 route is asserted (for
   bf16 or int8 A with 16-byte rows, the split-k decode kernel at m <= 8
   and the int8 wgmma kernel above; the SIMT tile otherwise), and dqab
   with per-channel and per-row scales on both routes bit-equal.
7. int8 slice: full-width stablelm-1.6b quantized on the card
   (models.common.quantize_params) serves a 1000-token prompt and the
   phase-4 requests in int8w, then w8a8
   (ServeEngine(quantize_activations=True), 4 calibration prompts):
   exactly 145 dq* launches per forward step; calibration sites and
   seconds, end-to-end times (each request's prefill ms), decode profile
   (K1's device ms, the device's busy ms, aten ops per step) and the
   cosine of prefill logits against the bf16 model; every decode step and
   the 8-token prefill on the decode route, the longer prefills on the
   int8 wgmma route.  A 4-layer model's int8w and
   w8a8 (scales calibrated once on the card, percentile, per k-tile) are
   held against the CPU.
8. K1f parity: each backward program of training (nt, tn, dact@a on nt,
   dact@b on tn) and each save_preact program (the forward GLU, bias+gelu)
   on the kernel against its plain version at stablelm-1.6b's training
   shapes with 1024 tokens, in bf16 (the wgmma route), and on a ragged
   fp32 shape (SIMT).
9. train: full-width stablelm-1.6b, all 24 layers, fp32 masters from seed
   0, remat as configured, trains 3 steps of 4 x 256 SyntheticLM tokens
   through repro_torch.train.step (AdamW, lr 1e-3): finite loss and
   gradient norm at every step, and exactly the K1 launches the model's
   structure gives per step (627, by program and layout), every one on the
   wgmma route; step times,
   tokens/s, peak memory, the share of the model's work, and
   torch.profiler's split of one more step.  Then a 4-layer full-width
   model, the same fp32 masters on the card and on the CPU, one batch of
   2 x 64 tokens: the loss and every leaf's gradient, card vs CPU.
10. times: kernel, plain version, library call (torch._weight_int8pack_mm
   for a per-channel dqb; torch.matmul for the plain nt/tn programs) and
   bound per GEMM program (float at m = 1, 128 and 1000, h2o-danube-3-4b's
   at m = 1, int8 (wo included) at m = 1, 128 and 1000 on its route
   (decode, then wgmma) and on the SIMT tile (A's base off 16 bytes), the
   K1f programs at 1024 tokens) and for the paged kernel at every serving
   and group case (each timed by replaying a CUDA graph of 20 calls), and
   the end-to-end times of the serve and train phases.
11. K1g, the distance product: all-pairs shortest paths on a random
   directed graph of 4096 nodes (out-degree 8, weights in (0, 1]) by 12
   repeated min-plus squarings through kernels.ops.distance_product,
   exactly 12 launches, held against scipy's Dijkstra (the same
   unreachable pairs, rtol 1e-5 on the rest); the kernel bit-equal to its
   plain version at 4096^3, on a ragged shape, in bf16 and with +inf and
   NaN operands; its time against the FP32 issue-rate bound.
12. K3, forward flash attention: kernels.flash_attn.flash_attention on the
   card against its plain version in fp32 and bf16 at the served models'
   full-width prefill shapes (stablelm-1.6b at 1000 tokens, causal;
   h2o-danube-3-4b at 300, GQA 4, D = 120), stablelm at 4096, danube at
   16384 with its window of 8192, and a ragged batch with -1 kv slots and
   a fully masked row (0), granite-20b's 48 query heads over one KV head
   and deepseek-v2-lite's MLA head (D = 192, Dv = 128); one launch per
   call, every bf16 call with head dims up to 128 on the wgmma route and
   every other call on the SIMT route (the MLA head in 128-wide chunks),
   plus one bf16 call whose bases sit off 16 bytes (SIMT); at the
   stablelm shape against the model's own plain
   prefill attention.  Each output is held to its row's scale (bf16 2^-7,
   fp32 1e-4 of |want| + the row's max), and a bf16 kernel's mean error to
   2^-12 of the mean |want|.  Times of both routes on the same bf16
   operands beside the bound and scaled_dot_product_attention.
13. K4, the k-outer ablation: kernels.ca_mmm.ca_mmm_k_outer at
   m = n = k = 4096 against its plain version (fp32 and bf16 to 1e-4 of
   max, int8 exactly) at each dtype's default tile (bf16: K1's wgmma tile
   128 x 128 x 64, k / 64 launches on the wgmma step; fp32, int8:
   64 x 64 x 32 on the SIMT step), and bf16 at a non-default dividing tile
   (256 x 256 x 128, wgmma) and at the SIMT tile; its times beside K1a's
   (the k-inner kernel, same shape, wgmma route), torch.matmul and both
   schedules' device-memory traffic by the reference's formula.

The last two lines are the kernels' JSON record and the result JSON.
"""

import collections
import concurrent.futures
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
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch import kvcache as kvc  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, batch_for_model  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ca_mmm as K  # noqa: E402
from repro_torch.kernels import flash_attn as FA  # noqa: E402
from repro_torch.kernels import ops as OPS  # noqa: E402
from repro_torch.kernels.program import (program_from_tag,  # noqa: E402
                                         rms_row_scale)
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import common as CM  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.quant import QTensor, QuantConfig  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.train import step as T  # noqa: E402
from repro_torch.tuning import resolve_page_size  # noqa: E402

ARCH = "stablelm-1.6b"
DANUBE = "h2o-danube-3-4b"
HBM_BYTES_PER_S = 3.35e12                     # H100 SXM data sheet
PEAK_OPS = {torch.bfloat16: 989e12,           # dense tensor-core bf16
            torch.float32: 67e12,             # fp32 outside the tensor cores
            torch.int8: 1979e12}              # dense tensor-core int8
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
ATTN_SOURCE = "src/repro_torch/csrc/paged_flash_attn.cu"
ATTN_REPLACES = "src/repro/kernels/flash_attn.py:241"
FWD_SOURCE = "src/repro_torch/csrc/flash_attn_fwd.cu"
FWD_REPLACES = "src/repro/kernels/flash_attn.py:83"
K_OUTER_SOURCE = "src/repro_torch/csrc/ca_mmm_k_outer.cu"
K_OUTER_REPLACES = "src/repro/kernels/ca_mmm.py:616"
MIN_PLUS = K.launch_key("none", semiring="min_plus")
# K1g's workload: all-pairs shortest paths over a random directed graph by
# repeated squaring of its distance matrix.
APSP_NODES, APSP_DEGREE = 4096, 8
# K3's shapes (B, Lq, S, H, Hkv, D, window): the served models' full-width
# prefill (stablelm-1.6b at 1000 tokens, causal; h2o-danube-3-4b at 300
# tokens under its config's window of 8192), stablelm at 4096, danube at
# 16384, where the window binds, and granite-20b's 48 query heads over one
# KV head (D = 128) at 1000 tokens, past a CTA's rows on both routes.
FWD_SHAPES = {"stablelm prefill": (1, 1000, 1000, 32, 32, 64, None),
              "danube prefill": (1, 300, 300, 32, 8, 120, 8192),
              "stablelm S4096": (1, 4096, 4096, 32, 32, 64, None),
              "danube S16384": (1, 16384, 16384, 32, 8, 120, 8192),
              "granite G48": (1, 1000, 1000, 48, 1, 128, None),
              "mla D192": (1, 1000, 1000, 16, 16, 192, None)}
FWD_TIMED = ("stablelm prefill", "danube prefill", "stablelm S4096")
# deepseek-v2-lite's MLA head (16 heads, q.k over 192 dims, v of 128):
# past the wgmma route's 128, so its bf16 call takes the SIMT kernel in
# 128-wide chunks (K2's paged case below scores it once, in one launch).
MLA_DV = 128
FWD_DV = {"mla D192": MLA_DV}
# K4 at m = n = k = K_OUTER_MNK, beside K1a at the same shape.
K_OUTER_MNK = 4096

GLU = "rms>glu.silu(none|none)"
# (program, GEMM, k, n, out_dtype) of one stablelm-1.6b forward step.
GEMMS = [("none", "wq/wk/wv", 2048, 2048, None),
         ("none", "head", 2048, 100352, torch.float32),
         ("res", "wo", 2048, 2048, None),
         ("res", "w_down", 5632, 2048, None),
         (GLU, "gate+up", 2048, 5632, None)]
# h2o-danube-3-4b's GEMMs, held against the plain version at m = 1.
DANUBE_GEMMS = [("none", "danube q", 3840, 3840, None),
                ("none", "danube k/v", 3840, 960, None),
                (GLU, "danube gate+up", 3840, 10240, None),
                ("res", "danube down", 10240, 3840, None),
                ("none", "danube head", 3840, 32000, torch.float32)]
# The shape each program's JSON record is timed at (decode, m = 1).
RECORD_GEMM = {"none": "wq/wk/wv", "res": "w_down", GLU: "gate+up"}
# The quantized programs of each float one: int8 weights (K1d) and w8a8
# (K1e, the norm applied before the quantize on entry, so no prologue).
QUANT = {"none": ("dqb", "dqab"), "res": ("dqb+res", "dqab+res"),
         GLU: ("rms>glu.silu(dqb|dqb)", "glu.silu(dqab|dqab)")}
QUANT_TAGS = [t for pair in QUANT.values() for t in pair]
# K1f, the training programs of one stablelm-1.6b step at TOKENS tokens, in
# the kernel's terms: (launch key, GEMM, m, n, k, out dtype).  nt gives a
# layer input's gradient (tokens x k_fwd, over n_fwd, fp32); tn a weight's
# gradient (k_fwd x n_fwd, over the tokens, in the weight's bf16); the
# GLU's gate side folds g·silu'(h0) into the fetch (dact); the forward
# programs of training drain their fp32 pre-activations (save_preact).
TOKENS = 1024
# The train phase: steps of GLOBAL_BATCH x SEQ_LEN = TOKENS tokens.
TRAIN_STEPS, SEQ_LEN, GLOBAL_BATCH = 3, 256, 4
GLU_SAVE = K.launch_key(GLU, "nn", True)
K1F_GEMMS = [("none nt", "wq/wk/wv dx", TOKENS, 2048, 2048, torch.float32),
             ("none tn", "wq/wk/wv dW", 2048, 2048, TOKENS, None),
             ("none nt", "w_down dx", TOKENS, 5632, 2048, torch.float32),
             ("none tn", "w_down dW", 5632, 2048, TOKENS, None),
             ("none nt", "head dx", TOKENS, 2048, 100352, torch.float32),
             ("none tn", "head dW", 2048, 100352, TOKENS, None),
             ("dact.silu>none nt", "gate dx", TOKENS, 2048, 5632,
              torch.float32),
             ("none nt", "up dx", TOKENS, 2048, 5632, torch.float32),
             ("dact.silu@b>none tn", "gate dW", 2048, 5632, TOKENS, None),
             ("none tn", "up dW", 2048, 5632, TOKENS, None),
             (GLU_SAVE, "gate+up fwd", TOKENS, 5632, 2048, None),
             ("bias+gelu save_preact", "bias+gelu fwd", TOKENS, 5632, 2048,
              None)]
# The shape each K1f program's JSON record is timed at.
RECORD_K1F = {"none nt": "w_down dx", "none tn": "w_down dW",
              "dact.silu>none nt": "gate dx",
              "dact.silu@b>none tn": "gate dW", GLU_SAVE: "gate+up fwd"}
# 4-layer bf16 training, card vs CPU: every GEMM output rounds to bf16 and
# the sums run in another order, so a flipped ulp (2^-8) propagates through
# four layers, the head and the backward: each gradient leaf within a
# relative L2 error of 5e-2, the loss within 1e-2 relative.
TOL_GRAD, TOL_LOSS = 5e-2, 1e-2

# Paged attention shapes (lens, page, H, Hkv, D, window): stablelm-1.6b's
# heads at its serve path's length and page (a), danube's GQA heads over
# ragged lengths crossing pages with a window (b), danube's serve shape
# (B = 1, S = 316, its analytic page 128), B = 8, S = 4096 for both,
# granite-20b's 48 query heads over one KV head, deepseek-v2-lite's MLA
# head, and the split path: stablelm at B = 1 over 4096 tokens (8 splits),
# lengths of 5 and 0 tokens beside 1016 (splits left empty, a sequence
# that drains zeros) and a window of 3 (most splits empty); and head dims
# past one CTA at the whole group and all of Dv: deepseek-v2's absorbed
# MLA head (D = 576, Dv = 512, two column chunks), 64 such heads (two
# head chunks), and 264-byte rows in 16-byte windows (two column chunks).
ATTN_CASES = {"a stablelm": ([1016], 128, 32, 32, 64, None),
              "b danube": ([19, 200, 1000], 16, 32, 8, 120, 48),
              "danube serve": ([316], 128, 32, 8, 120, None),
              "stablelm B8 S4096": ([4096] * 8, 128, 32, 32, 64, None),
              "danube B8 S4096": ([4096] * 8, 128, 32, 8, 120, None),
              "granite G48": ([1016, 37], 128, 48, 1, 128, None),
              "mla D192": ([1016, 37], 128, 16, 16, 192, None),
              "stablelm B1 S4096": ([4096], 128, 32, 32, 64, None),
              "ragged splits": ([5, 1016, 0], 16, 8, 2, 64, None),
              "window splits": ([1016, 300], 16, 8, 2, 64, 3),
              "absorbed mla": ([1016, 37], 128, 16, 1, 576, None),
              "G64 D576": ([300, 41], 16, 64, 1, 576, None),
              "D264 shifted": ([130, 45], 16, 4, 2, 264, 30)}
ATTN_DV = {"mla D192": MLA_DV, "absorbed mla": 512, "G64 D576": 512}
# The paged cases timed (the serving calls, the B = 8 batches, the group
# and head-dim cases, the column chunks); "a stablelm" first, the
# kernel's JSON record.
ATTN_TIMED = ("a stablelm", "danube serve", "stablelm B8 S4096",
              "danube B8 S4096", "granite G48", "mla D192",
              "stablelm B1 S4096", "absorbed mla")
# Prompt lengths of the prefill shapes the bf16 GEMMs are held and timed
# at (the served prompts of 37, 128 and 1000 tokens).
PREFILL_M = (37, 128, 1000)


def phase(name):
    print(f"== {name} ({time.strftime('%H:%M:%S')})", flush=True)


def route_delta(before):
    """K1/K4 launches by route and launch key since ``before`` (a copy of
    ``K.route_counts``)."""
    return {k: n - before.get(k, 0) for k, n in K.route_counts.items()
            if n != before.get(k, 0)}


def want_route(dtype, m):
    """The route a float program must take: for bf16 (all operands here
    are TMA-aligned) wgmma at m > 8 and decode at m <= 8; SIMT for fp32."""
    if dtype != torch.bfloat16:
        return "simt"
    return "wgmma" if m > 8 else "decode"


def want_quant_route(a, m, n, k):
    """The route an int8 program must take, for bf16 or int8 A whose rows
    are 16-byte aligned (k % 8 for bf16, k % 16 for int8) with int8 B rows
    too (n % 16): decode at m <= 8, the int8 wgmma kernel above; SIMT
    otherwise (fp32 A, ragged rows).  Every base here is 16-byte
    aligned."""
    if a.dtype == torch.float32 or n % 16 or (k * a.element_size()) % 16:
        return "simt"
    return "decode" if m <= 8 else "wgmma"


def serve_routes(prompt_lens, new_tokens, per_step):
    """The K1 launches by route of requests served one at a time: each
    prefill at m = its prompt's length (wgmma above 8 tokens, in bf16 and
    int8, decode up to 8), each decode step at m = 1 (decode),
    ``per_step`` launches a forward step."""
    steps = {"wgmma": sum(1 for n in prompt_lens if n > 8)}
    steps["decode"] = len(prompt_lens) - steps["wgmma"] + sum(
        n - 1 for n in new_tokens)
    return {f"{route} {tag}": n * k for route, k in steps.items() if k
            for tag, n in per_step.items()}


def check_routes(label, got, want):
    print(f"{label} launches by route: {got}")
    if got != want:
        raise AssertionError(f"{label}: launches by route {got}, expected "
                             f"{want}")


def is_k1(kernel_name):
    return ("ca_gemm_program_kernel" in kernel_name
            or "ca_gemm_wgmma_kernel" in kernel_name
            or "ca_gemm_wgmma_int8_kernel" in kernel_name
            or "ca_gemm_decode_kernel" in kernel_name)


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

    def timed(src):
        t0 = time.perf_counter()
        return _build.build(src), time.perf_counter() - t0

    t0 = time.perf_counter()
    sources = (K.SOURCE, FA.SOURCE, FA.FWD_SOURCE, K.K_OUTER_SOURCE)
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(timed, sources))
    for path, seconds in built:
        print(f"built {path.name} in {seconds:.3f} s")
    print(f"build wall {time.perf_counter() - t0:.3f} s (one nvcc per "
          "source, started together)")


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
             for m in (1,) + PREFILL_M for tag, name, k, n, od in GEMMS]
    cases += [(tag, name, 1, k, n, od, torch.bfloat16)
              for tag, name, k, n, od in DANUBE_GEMMS]
    # Ragged against the wgmma tile in every dim (m, n, k multiples of 8).
    cases += [(tag, "ragged", 200, 328, 264, None, torch.bfloat16)
              for tag in ("none", "res", GLU)]
    cases += [(tag, "ragged", 5, 300, 200, None, torch.float32)
              for tag in ("none", "res", GLU)]
    for tag, name, m, k, n, od, dtype in cases:
        a, (bs,), kw = program_inputs(tag, m, k, n, dtype, gen)
        before = dict(K.route_counts)
        got = K.ca_gemm_program(a, bs, out_dtype=od, **kw)
        check_routes(f"{tag} {name} m={m}", route_delta(before),
                     {f"{want_route(dtype, m)} {tag}": 1})
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
        print(f"parity {tag:24s} {name:14s} m={m:<4d} k={k:<5d} n={n:<6d} "
              f"{str(dtype)[6:]:8s} max_abs_err={err:.3e} tol={tol:.3e}")
        if not err <= tol:
            raise AssertionError(f"{tag} {name} m={m}: kernel disagrees "
                                 f"with the plain version ({err} > {tol})")
        worst[tag] = max(worst.get(tag, 0.0), err)
    return worst


def attn_pool(lens, page, Hkv, D, gen, *, extra_pages=0, copies=1,
              Dv=None):
    """Random int8 page pools on the card for sequences of ``lens`` tokens
    (K rows of D, V rows of Dv, default D).  Each sequence maps
    ceil(len / page) pages in a shuffled order (-1 past them in its table
    row); ``extra_pages`` more pages no table names.  ``copies`` pools (k,
    v, k_scale, v_scale) share the tables; also returns the unmapped page
    ids."""
    B = len(lens)
    counts = [-(-L // page) for L in lens]
    NP, need = max(counts), sum(counts)
    P = need + extra_pages
    perm = torch.randperm(P, generator=gen, device="cuda").to(torch.int32)
    tables = torch.full((B, NP), -1, dtype=torch.int32, device="cuda")
    off = 0
    for b, n in enumerate(counts):
        tables[b, :n] = perm[off:off + n]
        off += n
    pools = []
    for _ in range(copies):
        pools.append(tuple(
            torch.randint(-127, 128, (P, page, Hkv, d), generator=gen,
                          device="cuda", dtype=torch.int8)
            for d in (D, Dv or D)) + tuple(
            torch.rand(P, generator=gen, device="cuda") * 0.03 + 0.005
            for _ in range(2)))
    lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return pools, tables, lens_t, perm[need:].long()


def check_attn(label, q, pool, tables, lens_t, **kw):
    """The paged kernel against its plain version on the same inputs;
    returns the kernel's output and its max abs error."""
    got = FA.paged_flash_attention(q, *pool, tables, lens_t, **kw)
    want = FA.paged_flash_attention_reference(q, *pool, tables, lens_t, **kw)
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != q.dtype \
            or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"paged attention {label}: bad output")
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    tol = TOL_F32 * (1 + scale) if q.dtype == torch.float32 \
        else TOL_BF16 * scale
    print(f"parity paged_flash_attention {label} {str(q.dtype)[6:]:8s} "
          f"max_abs_err={err:.3e} tol={tol:.3e}")
    if not err <= tol:
        raise AssertionError(f"paged attention {label}: kernel disagrees "
                             f"({err} > {tol})")
    return got, err


def attn_parity():
    phase("paged attention parity (kernel vs plain version)")
    gen = torch.Generator(device="cuda").manual_seed(3)
    worst = 0.0
    for name, (lens, page, H, Hkv, D, window) in ATTN_CASES.items():
        Dv = ATTN_DV.get(name, D)
        (pool,), tables, lens_t, unmapped = attn_pool(
            lens, page, Hkv, D, gen, extra_pages=16, Dv=Dv)
        label = (f"{name:17s} B={len(lens)} S={max(lens)} page={page} H={H} "
                 f"Hkv={Hkv} D={D} Dv={Dv} window={window}")
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn(len(lens), H, D, generator=gen,
                            device="cuda").to(dtype)
            got, err = check_attn(label, q, pool, tables, lens_t,
                                  window=window)
            worst = max(worst, err)
            for b, L in enumerate(lens):
                if L == 0 and bool(got[b].any()):
                    raise AssertionError(f"paged attention {name}: len = 0 "
                                         "did not drain zeros")
            # The splits merge in order (no atomics): the same bits again.
            repeat = FA.paged_flash_attention(q, *pool, tables, lens_t,
                                              window=window)
            torch.cuda.synchronize()
            if not torch.equal(got, repeat):
                raise AssertionError(f"paged attention {name}: two identical "
                                     "calls differ")
            # (c) free pages poisoned with 127 at scale 1e6: bit-identical.
            bad = [t.clone() for t in pool]
            for t in bad[:2]:
                t[unmapped] = 127
            for t in bad[2:]:
                t[unmapped] = 1e6
            again = FA.paged_flash_attention(q, *bad, tables, lens_t,
                                             window=window)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"paged attention {name}: poisoned "
                                     "free pages changed the output")
            print(f"parity paged_flash_attention {name:17s} "
                  f"{str(dtype)[6:]:8s} poisoned free pages and a repeated "
                  "call: bit-identical")
    return worst


class Capture:
    """While active, counts the paged attention calls of the serve path
    and keeps a copy of the operands of call number ``at``."""

    def __init__(self, at):
        self.at, self.calls, self.args = at, 0, None

    def __enter__(self):
        self._orig = kvc.paged.paged_flash_attention

        def attend(*a, **k):
            if self.calls == self.at:
                self.args = ([t.clone() for t in a], dict(k))
            self.calls += 1
            return self._orig(*a, **k)

        kvc.paged.paged_flash_attention = attend
        return self

    def __exit__(self, *exc):
        kvc.paged.paged_flash_attention = self._orig


class Recorder:
    """While active, wraps M.prefill and M.decode_step (the engine calls
    them through the module) and keeps each prefill's whole logits and
    each step's sampled row."""

    def __enter__(self):
        self.prefill, self.rows = [], []
        self._orig = (M.prefill, M.decode_step)

        def prefill(*a, **k):
            logits, cache = self._orig[0](*a, **k)
            self.prefill.append(logits.clone())
            self.rows.append(logits[0, -1].clone())
            return logits, cache

        def decode_step(*a, **k):
            logits, cache = self._orig[1](*a, **k)
            self.rows.append(logits[0, -1].clone())
            return logits, cache

        M.prefill, M.decode_step = prefill, decode_step
        return self

    def __exit__(self, *exc):
        M.prefill, M.decode_step = self._orig


def serve_both(cfg, prompts, max_len, profile=False):
    """Full-width ``cfg`` (random weights, seed 0) serves the same greedy
    requests on the slab cache, then with ``paged_kv=True``; checks the
    launch counts, bit-equal prefill logits and greedy tokens up to a
    near tie, and the paged kernel against its plain version on the
    operands of the first request's last paged-attention call.  Returns
    the paged run's paged-attention launches, that call's error, both
    runs' end-to-end times, the host split and (``profile``) the paged
    decode profile."""
    phase(f"paged slice: full-width {cfg.name}, {cfg.n_layers} layers, "
          "slab vs paged_kv=True")
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0)
    torch.cuda.synchronize()
    print(f"init {sum(p.numel() for p in params.values())} params in "
          f"{time.perf_counter() - t0:.3f} s")
    runs = {}
    for paged in (False, True):
        eng = ServeEngine(params, cfg, max_len=max_len, paged_kv=paged)
        eng.submit(Request(uid=0, prompt=np.arange(4), max_new_tokens=2))
        eng.run()
        reqs = [Request(uid=i + 1, prompt=p, max_new_tokens=16)
                for i, p in enumerate(prompts)]
        for r in reqs:
            if not eng.submit(r):
                raise AssertionError(f"request {r.uid} rejected: {r.error}")
        K.reset_launch_counts()
        FA.reset_launch_counts()
        t0 = time.perf_counter()
        # The first request's last decode step, last layer.
        last = cfg.n_layers * (reqs[0].max_new_tokens - 1) - 1
        with Recorder() as rec, Capture(last) as cap:
            eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[paged] = {"reqs": reqs, "k1": dict(K.launch_counts),
                       "routes": dict(K.route_counts),
                       "k2": dict(FA.launch_counts), "rec": rec,
                       "wall": wall, "call": cap.args}
        if paged:
            pool = eng.kv_pool
            print(f"paged pool: {pool.n_pages} pages of {pool.page_size} "
                  f"tokens, {pool.n_free} free after the run")
            if pool.n_free != pool.n_pages:
                raise AssertionError("pages leaked after the run")
        del eng
    (q, *pool, tables, lens_t), kw = runs[True]["call"]
    _, call_err = check_attn(
        f"{cfg.name} serve call B={q.shape[0]} lens={lens_t.tolist()} "
        f"page={pool[0].shape[1]} H={q.shape[1]} Hkv={pool[0].shape[2]} "
        f"D={q.shape[2]} window={kw.get('window')}",
        q, pool, tables, lens_t, **kw)
    split = host_split(params, cfg)
    paged_profile = profile_decode(params, cfg, paged=True) if profile \
        else None
    del params
    torch.cuda.empty_cache()

    L = cfg.n_layers
    reqs = runs[False]["reqs"]
    steps = sum(r.max_new_tokens for r in reqs)
    decodes = steps - len(reqs)
    per_step = {"none": 3 * L + 1, "res": 2 * L, GLU: L}
    for paged, run in runs.items():
        label = "paged" if paged else "slab"
        print(f"{label} launches over {steps} forward steps: "
              f"K1 {run['k1']} K2 {run['k2']}")
        if run["k1"] != {tag: n * steps for tag, n in per_step.items()}:
            raise AssertionError(f"{label}: K1 launches {run['k1']}, "
                                 f"expected {per_step} x {steps}")
        check_routes(f"{cfg.name} {label}", run["routes"], serve_routes(
            [len(r.prompt) for r in reqs], [r.max_new_tokens for r in reqs],
            per_step))
        want_k2 = {FA.NAME: L * decodes} if paged else {}
        if run["k2"] != want_k2:
            raise AssertionError(f"{label}: K2 launches {run['k2']}, "
                                 f"expected {want_k2} (none in prefill)")
    slab, paged = runs[False]["rec"], runs[True]["rec"]
    for r, a, b in zip(reqs, slab.prefill, paged.prefill):
        if not torch.equal(a, b):
            raise AssertionError(f"request {r.uid}: prefill logits of the "
                                 "slab and paged engines differ")
    print(f"prefill logits bit-equal for all {len(reqs)} requests")
    off = 0
    for r, rp in zip(reqs, runs[True]["reqs"]):
        if r.status != "done" or rp.status != "done":
            raise AssertionError(f"request {r.uid}: {r.status}/{rp.status}")
        agree = sum(a == b for a, b in zip(r.generated, rp.generated))
        print(f"request {r.uid} prompt={len(r.prompt)} slab={r.generated} "
              f"paged={rp.generated} agreement={agree}/{len(r.generated)}")
        if r.generated != rp.generated:
            i = next(j for j, (a, b) in enumerate(zip(r.generated,
                                                      rp.generated)) if a != b)
            row = slab.rows[off + i][:cfg.vocab_size].float()
            gap = (row.max() - row[rp.generated[i]]).item()
            limit = 2 * TOL_MODEL * row.abs().max().item()
            print(f"first disagreement at token {i}: slab logit gap "
                  f"{gap:.4e} (limit {limit:.4e})")
            if not gap <= limit:
                raise AssertionError("slab and paged greedy tokens disagree "
                                     "beyond a near tie")
        off += r.max_new_tokens
    e2e = []
    for r, rp in zip(reqs, runs[True]["reqs"]):
        row = {"uid": r.uid, "prompt": len(r.prompt),
               "slab_prefill_ms": r.prefill_s * 1e3,
               "paged_prefill_ms": rp.prefill_s * 1e3,
               "slab_decode_ms_per_token":
                   r.decode_s * 1e3 / (r.max_new_tokens - 1),
               "paged_decode_ms_per_token":
                   rp.decode_s * 1e3 / (rp.max_new_tokens - 1)}
        e2e.append(row)
        print(f"{cfg.name} " + json.dumps(row))
    return (runs[True]["k2"][FA.NAME], call_err, e2e, split, paged_profile,
            runs[True]["routes"])


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
    routes = dict(K.route_counts)
    check_routes("slab serve", routes, serve_routes(
        [len(r.prompt) for r in reqs], [r.max_new_tokens for r in reqs],
        per_step))
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
    return routes, e2e


def _device_us(event):
    t = getattr(event, "self_device_time_total", None)
    return t if t is not None else event.self_cuda_time_total


def decode_run(params, cfg, steps, paged=False, prof=None, device="cuda"):
    """A 37-token prefill (``max_len`` 160), then ``steps`` greedy decode
    steps on the slab cache or (``paged``) on a paged int8 cache of the
    analytic page; ``prof`` (a torch.profiler) records only the steps.
    Returns the steps' wall seconds."""
    prompt = torch.as_tensor(np.random.RandomState(2).randint(
        0, cfg.vocab_size, 37), device=device)[None]
    with torch.inference_mode():
        cache = None
        if paged:
            page = resolve_page_size(160)
            n_pages = kvc.pages_for(160, page)
            cache = M.make_paged_model_cache(
                cfg, 1, n_pages=n_pages, page_size=page, max_pages=n_pages,
                device=device)
            kvc.model_assign_sequence(cache, 0, list(range(n_pages)))
        logits, cache = M.prefill(params, {"tokens": prompt}, cfg,
                                  max_len=160, cache=cache)
        nxt = int(torch.argmax(logits[0, -1, :cfg.vocab_size]))
        _sync(device)
        if prof is not None:
            prof.start()
        t0 = time.perf_counter()
        for s in range(steps):
            logits, cache = M.decode_step(
                params, {"tokens": torch.full((1, 1), nxt, device=device)},
                cache, prompt.shape[1] + s, cfg)
            nxt = int(torch.argmax(logits[0, -1, :cfg.vocab_size]))
        _sync(device)
        wall = time.perf_counter() - t0
        if prof is not None:
            prof.stop()
    return wall


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def profile_decode(params, cfg, steps=8, paged=False):
    """Device time by kernel over ``steps`` decode steps (torch.profiler),
    and the unprofiled wall time of the same steps, on the slab cache or
    (``paged``) on the paged int8 cache."""
    from torch.profiler import ProfilerActivity, profile

    wall = decode_run(params, cfg, steps, paged)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    decode_run(params, cfg, steps, paged, prof)
    by_kernel = {}
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            by_kernel[ev.key] = by_kernel.get(ev.key, 0.0) + _device_us(ev)
    total_ms = sum(by_kernel.values()) / 1e3 / steps
    gemm_ms = sum(v for k, v in by_kernel.items()
                  if is_k1(k)) / 1e3 / steps
    wall_ms = wall * 1e3 / steps
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    out = {"decode_wall_ms_per_step": wall_ms,
           "device_ms_per_step": total_ms,
           "gemm_kernel_ms_per_step": gemm_ms,
           "device_busy_share": total_ms / wall_ms}
    if paged:
        out["paged_attention_kernel_ms_per_step"] = sum(
            v for k, v in by_kernel.items()
            if "paged_fa_kernel" in k) / 1e3 / steps
        if not out["paged_attention_kernel_ms_per_step"] > 0:
            raise AssertionError("the paged decode profile found no "
                                 "paged_fa_kernel time: " + str(top))
    print(f"profile {'paged' if paged else 'slab'} " + json.dumps(out))
    for name, us in top:
        print(f"profile top {us / 1e3 / steps:9.4f} ms/step {name[:90]}")
    return out


class _OpCount(TorchDispatchMode):
    """Counts the aten ops dispatched while active."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


class HostTimers:
    """While active, wraps the decode step and, inside it, the KV-cache
    insert and the decode attention that gqa_apply calls (slab:
    kv_cache_insert, dense_attention; paged: kvcache.paged_decode_insert,
    kvcache.paged_attention), adding the host seconds spent in each.  No
    sync sits inside them, so this is the time spent issuing their work.
    With ``count`` set it also counts the aten ops each dispatches."""

    TARGETS = ((M, "decode_step", "step"),
               (A, "kv_cache_insert", "insert"),
               (A, "dense_attention", "attention"),
               (kvc, "paged_decode_insert", "insert"),
               (kvc, "paged_attention", "attention"))

    def __enter__(self):
        self.count = False
        self.reset()
        self._orig = [getattr(mod, name) for mod, name, _ in self.TARGETS]
        for (mod, name, key), fn in zip(self.TARGETS, self._orig):
            setattr(mod, name, self._wrap(fn, key))
        return self

    def reset(self):
        self.seconds = collections.Counter()
        self.ops = collections.Counter()

    def _wrap(self, fn, key):
        def timed(*a, **k):
            t0 = time.perf_counter()
            if self.count:
                with _OpCount() as ops:
                    out = fn(*a, **k)
                self.ops[key] += ops.n
            else:
                out = fn(*a, **k)
            self.seconds[key] += time.perf_counter() - t0
            return out
        return timed

    def __exit__(self, *exc):
        for (mod, name, _), fn in zip(self.TARGETS, self._orig):
            setattr(mod, name, fn)


def host_split(params, cfg, rounds=3, steps=8, device="cuda"):
    """Host ms per decode step spent issuing the whole step, its KV-cache
    inserts and its decode attention, slab vs paged in the same call:
    ``rounds`` rounds of ``steps`` unprofiled steps each, alternating
    slab and paged; then one counted step of each gives their aten ops.
    Returns the medians over rounds and the op counts."""
    phase(f"host split: {cfg.name} decode steps, slab vs paged")
    rows = {"slab": [], "paged": []}
    with HostTimers() as timers:
        for r in range(rounds):
            for mode in rows:
                timers.reset()
                wall = decode_run(params, cfg, steps, mode == "paged",
                                  device=device)
                row = {"wall_ms_per_step": wall * 1e3 / steps}
                row.update({f"{k}_host_ms_per_step": v * 1e3 / steps
                            for k, v in sorted(timers.seconds.items())})
                rows[mode].append(row)
                print(f"host split {cfg.name} round {r} {mode} "
                      + json.dumps(row))
        ops = {}
        for mode in rows:
            timers.reset()
            timers.count = True
            decode_run(params, cfg, 1, mode == "paged", device=device)
            timers.count = False
            ops[mode] = dict(timers.ops)
    out = {mode: {k: float(np.median([row[k] for row in rs]))
                  for k in rs[0]} for mode, rs in rows.items()}
    for mode in rows:
        out[mode]["aten_ops_per_step"] = ops[mode]
    print(f"host split {cfg.name} median " + json.dumps(out))
    return out


def cross_check(cfg):
    phase("4-layer full width: card vs CPU plain path")
    cfg4 = dataclasses.replace(cfg, n_layers=4)
    p_gpu = M.init_params(cfg4, seed=1)
    p_cpu = {k: v.cpu() for k, v in p_gpu.items()}
    card_vs_cpu(p_gpu, p_cpu, cfg4)


def card_vs_cpu(p_gpu, p_cpu, cfg4, label=""):
    """The same parameters on the card and on the CPU: prefill logits
    within TOL_MODEL, greedy tokens equal up to a near tie."""
    prompt = np.random.RandomState(1).randint(0, cfg4.vocab_size, 12)
    toks = torch.as_tensor(prompt)[None]
    with torch.inference_mode():
        lg, _ = M.prefill(p_gpu, {"tokens": toks.cuda()}, cfg4, max_len=32)
        lc, _ = M.prefill(p_cpu, {"tokens": toks}, cfg4, max_len=32)
    err = (lg.cpu() - lc).abs().max().item()
    scale = lc.abs().max().item()
    print(f"{label}prefill logits max_abs_err={err:.4e} "
          f"max|cpu|={scale:.4e} tol={TOL_MODEL * scale:.4e}")
    if not (bool(torch.isfinite(lg).all()) and err <= TOL_MODEL * scale):
        raise AssertionError(f"{label}card and CPU prefill logits disagree")
    outs = []
    for params, dev in ((p_gpu, None), (p_cpu, "cpu")):
        eng = ServeEngine(params, cfg4, max_len=32, device=dev)
        eng.submit(Request(uid=1, prompt=prompt, max_new_tokens=8))
        outs.append(eng.run()[1].generated)
    agree = sum(a == b for a, b in zip(*outs))
    print(f"{label}greedy tokens card={outs[0]} cpu={outs[1]} "
          f"agreement={agree}/{len(outs[0])}")
    if outs[0] != outs[1]:
        # Past the first disagreement the two runs decode different
        # sequences; at it, the card's pick must be a near tie on the CPU.
        i = next(j for j, (a, b) in enumerate(zip(*outs)) if a != b)
        seq = torch.as_tensor(np.concatenate([prompt, outs[1][:i]]))[None]
        with torch.inference_mode():
            row, _ = M.prefill(p_cpu, {"tokens": seq}, cfg4, max_len=32)
        row = row[0, -1, :cfg4.vocab_size]
        gap = (row.max() - row[outs[0][i]]).item()
        # Each of the two logits may be off by the prefill tolerance.
        limit = 2 * TOL_MODEL * row.abs().max().item()
        print(f"{label}first disagreement at token {i}: CPU logit gap "
              f"{gap:.4e} (limit {limit:.4e})")
        if not gap <= limit:
            raise AssertionError(f"{label}card and CPU greedy tokens "
                                 "disagree beyond a near tie")


def cross_check_paged(cfg):
    phase("4-layer full width, paged path: card vs CPU plain path")
    cfg4 = dataclasses.replace(cfg, n_layers=4)
    p_gpu = M.init_params(cfg4, seed=1)
    p_cpu = {k: v.cpu() for k, v in p_gpu.items()}
    rng = np.random.RandomState(3)
    prompt = rng.randint(0, cfg.vocab_size, 12)
    nxt = rng.randint(0, cfg.vocab_size, 4)
    outs = []
    for params, dev in ((p_gpu, "cuda"), (p_cpu, "cpu")):
        cache = M.make_paged_model_cache(cfg4, 1, n_pages=3, page_size=8,
                                         max_pages=2, device=dev)
        kvc.model_assign_sequence(cache, 0, [2, 0])
        rows = []
        with torch.inference_mode():
            _, cache = M.prefill(params, {"tokens": torch.as_tensor(
                prompt, device=dev)[None]}, cfg4, cache=cache)
            for s, t in enumerate(nxt):
                lg, cache = M.decode_step(
                    params, {"tokens": torch.full((1, 1), int(t),
                                                  device=dev)},
                    cache, len(prompt) + s, cfg4)
                rows.append(lg[0, -1].cpu())
        outs.append(torch.stack(rows))
    err = (outs[0] - outs[1]).abs().max().item()
    scale = outs[1].abs().max().item()
    print(f"paged decode logits over {len(nxt)} steps max_abs_err="
          f"{err:.4e} max|cpu|={scale:.4e} tol={TOL_MODEL * scale:.4e}")
    if not (bool(torch.isfinite(outs[0]).all())
            and err <= TOL_MODEL * scale):
        raise AssertionError("card and CPU paged decode logits disagree")


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
    for m in (1, 128, 1000):
        # h2o-danube-3-4b's five GEMMs at decode too.
        for tag, name, k, n, od in GEMMS + (DANUBE_GEMMS if m == 1 else []):
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
                   "k1_route": want_route(torch.bfloat16, m),
                   "ms": ms, "plain_ms": plain, "library_ms": lib,
                   "bound_ms": b_ms, "bound_by": b_by,
                   "tflops": 2 * m * n * k * nb / ms / 1e9}
            rows.append(row)
            print("time " + json.dumps(row))
            del a, sets, kw
    return rows


def attn_bound(lens, page, H, Hkv, D, window, dtype, Dv=None):
    """Least time for one call: the int8 K/V bytes of the tokens it must
    attend (each read once) plus scales, tables, lengths, q and the
    output, over the memory rate; or its operations (q.k and p.v for
    every query head and token) over the card's peak rate for q's dtype
    (an int8 x bf16 product is exact in bf16, so bf16 q could take the
    tensor cores), whichever is larger."""
    Dv = Dv or D
    B = len(lens)
    NP = max(1, max(-(-L // page) for L in lens))
    tokens = sum(max(0, min(L, NP * page)
                     - (max(0, L - window) if window else 0)) for L in lens)
    pages = sum(-(-L // page) for L in lens)
    es = torch.finfo(dtype).bits // 8
    nbytes = (tokens * Hkv * (D + Dv) + pages * 2 * 4 + B * NP * 4 + B * 4
              + B * H * (D + Dv) * es)
    ops = 2 * tokens * H * (D + Dv)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def attn_times():
    phase("paged attention times (CUDA graph replay; pools rotated past "
          "the 50 MB L2)")
    gen = torch.Generator(device="cuda").manual_seed(4)
    rows = []
    for name in ATTN_TIMED:
        lens, page, H, Hkv, D, window = ATTN_CASES[name]
        Dv = ATTN_DV.get(name, D)
        per_copy = sum(-(-L // page) for L in lens) * page * Hkv * (D + Dv)
        copies = max(2, math.ceil(120e6 / per_copy))
        pools, tables, lens_t, _ = attn_pool(lens, page, Hkv, D, gen,
                                             copies=copies, Dv=Dv)
        q = torch.randn(len(lens), H, D, generator=gen,
                        device="cuda").to(torch.bfloat16)
        ms = _time_ms(lambda i: FA.paged_flash_attention(
            q, *pools[i], tables, lens_t, window=window), copies)
        plain = _time_ms(lambda i: FA.paged_flash_attention_reference(
            q, *pools[i], tables, lens_t, window=window), copies)
        b_ms, b_by = attn_bound(lens, page, H, Hkv, D, window,
                                torch.bfloat16, Dv)
        row = {"kernel": FA.NAME, "case": name, "B": len(lens),
               "S": max(lens), "page": page, "H": H, "Hkv": Hkv, "D": D,
               "Dv": Dv, "ms": ms, "plain_ms": plain, "library_ms": None,
               "bound_ms": b_ms, "bound_by": b_by}
        rows.append(row)
        print("time " + json.dumps(row))
        del pools, tables, lens_t, q
    return rows


# ---------------------------------------------------------------------------
# int8 weights (K1d, dqb) and w8a8 (K1e, dqab)
# ---------------------------------------------------------------------------

def quant_inputs(tag, m, k, n, dtype, gen, copies=1, block_b=0, block_a=0):
    """Operands of one dqb/dqab program call on the card: A in ``dtype``
    (dqb) or int8 (dqab), int8 weights N(0, 1/k) quantized on the grid,
    positive fp32 scales per channel / per row or per tile of
    ``block_b``/``block_a`` rows of k; ``copies`` weight sets."""
    spec = program_from_tag(tag)
    deq = spec.branches[0].dequant
    dev = "cuda"
    if deq == "ab":
        a = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                          dtype=torch.int8)
    else:
        a = torch.randn(m, k, generator=gen, device=dev).to(dtype)
    nblk_b = -(-k // block_b) if block_b else 0
    sets, scales = [], []
    for _ in range(copies):
        sets.append([torch.randint(-127, 128, (k, n), generator=gen,
                                   device=dev, dtype=torch.int8)
                     for _ in range(spec.n_b)])
        scales.append([(torch.rand(*((nblk_b, n) if block_b else (n,)),
                                   generator=gen, device=dev) + 0.5)
                       * (3.0 / 127 / math.sqrt(k))
                       for _ in range(spec.n_b)])
    kw = {"spec": spec, "scale_b_block": block_b,
          "scale_a_block": block_a if deq == "ab" else 0}
    if spec.prologue.kind == "rms":
        kw["gain"] = torch.rand(k, generator=gen, device=dev) + 0.5
        kw["row_scale"] = rms_row_scale(a, 1e-5)
    sa = None
    if deq == "ab":
        sa = (torch.rand(-(-k // block_a) if block_a else m, generator=gen,
                         device=dev) + 0.5) * (3.0 / 127)
    res = (torch.randn(m, n, generator=gen, device=dev).to(dtype)
           if spec.branches[0].has_residual else None)

    def ops(i):
        out = []
        for sb in scales[i]:
            d = {"scale_b": sb}
            if sa is not None:
                d["scale_a"] = sa
            if res is not None:
                d["residual"] = res
            out.append(d)
        return out
    return a, sets, kw, ops


def quant_parity():
    phase("int8 kernel parity (dqb, dqab vs plain version)")
    gen = torch.Generator(device="cuda").manual_seed(6)
    worst = {}
    cases = []
    # The main path's shapes, per-channel scales, bf16 A (dqb) or int8 A
    # (dqab), bf16 out and the head's fp32 out.
    for m in (1, 5, 37, 128, 1000):
        for tag, name, k, n, od in GEMMS:
            for qtag in QUANT[tag]:
                cases.append((qtag, name, m, k, n, od, torch.bfloat16, 0, 0))
    # Ragged n and k with per-tile weight scales, and for dqab per-tile
    # activation scales, k = 1000 (7 x 128 + 104 = 3 x 256 + 232) or 1008
    # (7 x 128 + 112 = 3 x 256 + 240): n = 1000 takes the SIMT tile's scalar
    # B loads, n = 1008 its vector B loads at m > 8 and, at m <= 8, the
    # decode route (int8 B rows of 16-byte multiples; dqab's int8 A rows
    # too only at k = 1008, so k = 1000 keeps it on the SIMT tile).
    for m in (1, 5, 37, 128):
        for qtag in QUANT_TAGS:
            for bb, ba in ((128, 0), (256, 256), (0, 128)):
                if not bb and "dqab" not in qtag:
                    continue    # dqb has no activation scale to tile
                for k, n in ((1000, 1000), (1000, 1008), (1008, 1008)):
                    cases.append((qtag, "ragged", m, k, n, None,
                                  torch.bfloat16, bb, ba))
    # fp32 A and out (dqb) / fp32 out (dqab), ragged.
    for qtag in QUANT_TAGS:
        cases.append((qtag, "ragged f32", 37, 1000, 1000, None,
                      torch.float32, 128, 0))
        cases.append((qtag, "ragged f32", 5, 300, 200, None,
                      torch.float32, 0, 0))
    for qtag, name, m, k, n, od, dtype, bb, ba in cases:
        a, (bs,), kw, ops = quant_inputs(qtag, m, k, n, dtype, gen,
                                         block_b=bb, block_a=ba)
        out = od or dtype
        before = dict(K.route_counts)
        got = K.ca_gemm_program(a, bs, out_dtype=out,
                                branch_operands=ops(0), **kw)
        route = want_quant_route(a, m, n, k)
        check_routes(f"{qtag} {name} m={m} n={n} k={k}", route_delta(before),
                     {f"{route} {qtag}": 1})
        want = K.ca_gemm_program_reference(a, bs, out_dtype=out,
                                           branch_operands=ops(0), **kw)
        torch.cuda.synchronize()
        if got.shape != (m, n) or got.dtype != out \
                or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{qtag} {name} m={m}: bad output")
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        tol = TOL_F32 * (1 + scale) if out == torch.float32 \
            else TOL_BF16 * scale
        print(f"parity {qtag:22s} {name:10s} m={m:<4d} k={k:<5d} n={n:<6d} "
              f"{route:6s} A={str(a.dtype)[6:]:8s} out={str(out)[6:]:8s} "
              f"blocks=({kw['scale_b_block']},{kw['scale_a_block']}) "
              f"max_abs_err={err:.3e} tol={tol:.3e}")
        if not err <= tol:
            raise AssertionError(f"{qtag} {name} m={m}: kernel disagrees "
                                 f"with the plain version ({err} > {tol})")
        # dqab's int32 sum is exact and the decode and wgmma routes round it
        # once, then scale per channel and row as the plain version does:
        # the same bits.
        if route != "simt" and "dqab" in qtag and not (bb or ba) \
                and not torch.equal(got, want):
            raise AssertionError(f"{qtag} {name} m={m}: not bit-equal to "
                                 f"the plain version on the {route} route")
        worst[qtag] = max(worst.get(qtag, 0.0), err)
    # w8a8 headroom: k = 4096, every product 127 * +-127; the int32 sum
    # must be exact, so the output equals s_a * s_b * sum(a_q * b_q) bit for
    # bit after the fp32 rescale, on the decode route (m = 4) and the wgmma
    # route (m = 128).
    n, k = 128, 4096
    for m, route in ((4, "decode"), (128, "wgmma")):
        a = torch.full((m, k), 127, dtype=torch.int8, device="cuda")
        sign = torch.where(torch.arange(k, device="cuda") % 2 == 1, 1, -1)
        b = (sign[:, None] * 127).expand(k, n).clone()
        b[:k // 4] = 127
        b = b.to(torch.int8)
        sa = torch.full((m,), 4.0 / 127, device="cuda")
        sb = torch.rand(n, generator=gen, device="cuda") + 0.5
        before = dict(K.route_counts)
        got = K.ca_gemm_program(a, [b], spec=program_from_tag("dqab"),
                                branch_operands=[{"scale_a": sa,
                                                  "scale_b": sb}])
        check_routes(f"dqab headroom m={m}", route_delta(before),
                     {f"{route} dqab": 1})
        want = ((a.double() @ b.double()).float() * sb[None]) * sa[:, None]
        torch.cuda.synchronize()
        exact = torch.equal(got, want)
        print(f"parity dqab headroom m={m} k={k} saturated ({route}): "
              f"bit-identical={exact} "
              f"max_abs_err={(got - want).abs().max().item():.3e}")
        if not exact:
            raise AssertionError(f"w8a8 headroom case (m = {m}) is not "
                                 "exact")
    return worst


def _cosine(a, b):
    a, b = a.double(), b.double()
    return ((a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1)))


def serve_int8(cfg):
    """Full-width ``cfg`` (random weights, seed 0), quantized to int8 on
    the card, serves the slice's three greedy requests in int8w, then
    w8a8 (calibrated on 4 sample prompts): launches per forward step,
    calibration sites and seconds, end-to-end times and the cosine of
    prefill logits against the bf16 model on the same prompt."""
    phase(f"int8 slice: full-width {cfg.name}, {cfg.n_layers} layers, "
          "int8w then w8a8")
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0)
    qparams = CM.quantize_params(params)
    torch.cuda.synchronize()
    print(f"init + quantize_params in {time.perf_counter() - t0:.3f} s; "
          f"quantized {sorted(k for k, v in qparams.items()
                               if isinstance(v, QTensor))}")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in (128, 37, 8)]
    probe = torch.as_tensor(prompts[1], device="cuda")[None]
    # One 1000-token prompt more: the int8 prefill at the served length.
    prompts.insert(0, rng.randint(0, cfg.vocab_size, 1000))
    with torch.inference_mode():
        dense, _ = M.prefill(params, {"tokens": probe}, cfg, max_len=160)
    dense = dense[0, :, :cfg.vocab_size]
    dense_ops = step_ops(params, cfg)
    print(f"bf16: {dense_ops} aten ops per decode step")
    del params
    torch.cuda.empty_cache()
    L = cfg.n_layers
    out = {}
    for mode in ("int8w", "w8a8"):
        w8a8 = mode == "w8a8"
        eng = ServeEngine(qparams, cfg, max_len=1040,
                          quantize_activations=w8a8, calibration_batches=4,
                          act_qconfig=QuantConfig(act_fmt="int8"))
        print(f"{mode}: calibration sites {eng.calibration_sites} in "
              f"{eng.calibration_s:.3f} s")
        eng.submit(Request(uid=0, prompt=np.arange(4), max_new_tokens=2))
        eng.run()
        reqs = [Request(uid=i + 1, prompt=p, max_new_tokens=16)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        K.reset_launch_counts()
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(K.launch_counts)
        steps = sum(r.max_new_tokens for r in reqs)
        q = {f: QUANT[f][w8a8] for f in QUANT}
        per_step = {q["none"]: 3 * L + 1, q["res"]: 2 * L, q[GLU]: L}
        print(f"{mode} launches over {steps} forward steps: {counts} "
              f"(per step {per_step}, {sum(per_step.values())})")
        if counts != {t: n * steps for t, n in per_step.items()}:
            raise AssertionError(f"{mode}: launches {counts}, expected "
                                 f"{per_step} x {steps}")
        routes = dict(K.route_counts)
        check_routes(mode, routes, serve_routes(
            [len(r.prompt) for r in reqs], [r.max_new_tokens for r in reqs],
            per_step))
        for r in reqs:
            if r.status != "done" or len(r.generated) != r.max_new_tokens:
                raise AssertionError(f"{mode} request {r.uid}: {r.status}")
            print(f"{mode} request {r.uid} prompt={len(r.prompt)} "
                  f"tokens={r.generated}")
        with torch.inference_mode():
            lq, _ = M.prefill(eng.params, {"tokens": probe}, cfg,
                              max_len=160)
        cos = _cosine(lq[0, :, :cfg.vocab_size], dense)
        if not bool(torch.isfinite(lq).all()):
            raise AssertionError(f"{mode}: non-finite prefill logits")
        row = {"mode": mode, "calibration_sites": eng.calibration_sites,
               "calibration_s": eng.calibration_s,
               "requests": [{"uid": r.uid, "prompt": len(r.prompt),
                             "prefill_ms": r.prefill_s * 1e3,
                             "decode_ms_per_token":
                                 r.decode_s * 1e3 / (r.max_new_tokens - 1)}
                            for r in reqs],
               "tokens_per_s": sum(len(r.generated) for r in reqs) / wall,
               "run_s": wall, "launches": counts, "routes": routes,
               "cosine_vs_bf16_min": cos.min().item(),
               "cosine_vs_bf16_mean": cos.mean().item()}
        row["profile"] = profile_decode(eng.params, cfg)
        row["aten_ops_per_decode_step"] = step_ops(eng.params, cfg)
        row["bf16_aten_ops_per_decode_step"] = dense_ops
        print(f"{cfg.name} {mode} " + json.dumps(row))
        out[mode] = row
        del eng
    del qparams
    torch.cuda.empty_cache()
    return out


def step_ops(params, cfg):
    """The aten ops one decode step dispatches (after a 37-token
    prefill): the host work the step issues."""
    with HostTimers() as timers:
        timers.count = True
        decode_run(params, cfg, 1)
    return timers.ops["step"]


def cross_check_int8(cfg):
    """int8w, then w8a8 calibrated once on the card with the other
    calibration options than the serve phase's (2 prompts, percentile,
    per-k-tile activation scales): card vs CPU on the same QTensors."""
    phase("4-layer full width, int8w and w8a8: card vs CPU plain path")
    cfg4 = dataclasses.replace(cfg, n_layers=4)
    q_gpu = CM.quantize_params(M.init_params(cfg4, seed=1))
    for mode in ("int8w", "w8a8"):
        if mode == "w8a8":
            q_gpu = ServeEngine(
                q_gpu, cfg4, max_len=32, quantize_activations=True,
                calibration_batches=2, act_qconfig=QuantConfig(
                    act_fmt="int8", method="percentile", act_block=128)
            ).params
        q_cpu = {k: v.to("cpu") for k, v in q_gpu.items()}
        card_vs_cpu(q_gpu, q_cpu, cfg4, label=f"{mode}: ")


def quant_bound(tag, m, k, n, od, dtype):
    """Least time: int8 B bytes + A (bf16, or int8 for dqab) + output +
    scales (+ residual, rms operands) over the memory rate, or the
    operations over the bf16 (dqb) or int8 (dqab) tensor-core rate."""
    spec = program_from_tag(tag)
    ab = spec.branches[0].dequant == "ab"
    es = 1 if ab else torch.finfo(dtype).bits // 8
    oes = torch.finfo(od or dtype).bits // 8
    nbytes = (m * k * es + spec.n_b * k * n + m * n * oes
              + spec.n_b * n * 4 + (4 * m if ab else 0))
    if spec.branches[0].has_residual:
        nbytes += m * n * torch.finfo(dtype).bits // 8
    if spec.prologue.kind == "rms":
        nbytes += 4 * m + 4 * k
    ops = 2 * m * n * k * spec.n_b
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[torch.int8 if ab else dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _int_mm_ms(a, sets, copies):
    """``torch._int_mm``'s time for one branch's int8 x int8 -> int32, or
    None (with the reason printed) where it refuses the operands."""
    try:
        torch._int_mm(a, sets[0][0])
    except RuntimeError as e:
        print(f"torch._int_mm refused ({a.shape[0]}x{a.shape[1]} @ "
              f"{tuple(sets[0][0].shape)}): {str(e).splitlines()[0]}")
        return None
    return _time_ms(lambda i: torch._int_mm(a, sets[i][0]), copies)


def _int8pack_ms(a, sets, ops, copies, iters=20, reps=5):
    """``torch._weight_int8pack_mm``'s time for a per-channel ``dqb``:
    bf16 A times an (n, k) int8 weight (a transposed copy) times bf16
    per-channel scales, bf16 out; None (with the reason printed) where it
    refuses the operands."""
    wt = [s[0].t().contiguous() for s in sets]
    sc = [ops(i)[0]["scale_b"].to(a.dtype) for i in range(copies)]
    try:
        torch._weight_int8pack_mm(a, wt[0], sc[0])
    except (RuntimeError, NotImplementedError) as e:
        print(f"torch._weight_int8pack_mm refused ({a.shape[0]}x"
              f"{a.shape[1]} @ {tuple(wt[0].shape)}^T): "
              f"{str(e).splitlines()[0]}")
        return None
    ms = _time_ms(lambda i: torch._weight_int8pack_mm(a, wt[i], sc[i]),
                  copies, iters, reps)
    del wt, sc
    return ms


def quant_times(float_rows):
    phase("int8 times (CUDA graph replay; weights rotated past the 50 MB L2)")
    gen = torch.Generator(device="cuda").manual_seed(7)
    rows = []
    for m in (1, 128, 1000):
        # Millisecond-scale calls at m = 1000: fewer in each graph.
        iters, reps = (5, 2) if m == 1000 else (20, 5)
        for tag, name, k, n, od in GEMMS:
            nb = program_from_tag(tag).n_b
            copies = max(2, math.ceil(120e6 / (nb * k * n)))
            k1a = next(r["ms"] for r in float_rows if r["program"] == tag
                       and r["gemm"] == name and r["m"] == m)
            for qtag in QUANT[tag]:
                a, sets, kw, ops = quant_inputs(qtag, m, k, n,
                                                torch.bfloat16, gen, copies)
                out = od or torch.bfloat16

                def call(i, a=a):
                    return K.ca_gemm_program(
                        a, sets[i], out_dtype=out, branch_operands=ops(i),
                        **kw)
                ms = _time_ms(call, copies, iters, reps)
                plain = _time_ms(lambda i: K.ca_gemm_program_reference(
                    a, sets[i], out_dtype=out, branch_operands=ops(i),
                    **kw), copies, iters, reps)
                b_ms, b_by = quant_bound(qtag, m, k, n, od, torch.bfloat16)
                # One library call computes a per-channel dqb (no res, no
                # GLU); it returns bf16 where the head's program writes fp32.
                lib = (_int8pack_ms(a, sets, ops, copies, iters, reps)
                       if qtag == "dqb" else None)
                row = {"program": qtag, "gemm": name, "m": m, "k": k,
                       "n": n, "k1_route": want_quant_route(a, m, n, k),
                       "ms": ms, "plain_ms": plain, "library_ms": lib,
                       "bound_ms": b_ms, "bound_by": b_by,
                       "k1a_ms_same_shape": k1a}
                # The SIMT tile on the same operands, A's base off 16 bytes,
                # in the same process.
                am = misaligned(a)
                before = dict(K.route_counts)
                call(0, am)
                check_routes(f"{qtag} {name} m={m} A off 16 bytes",
                             route_delta(before), {f"simt {qtag}": 1})
                row["simt_ms"] = _time_ms(lambda i: call(i, am), copies,
                                          iters, reps)
                del am
                if "dqab" in qtag and m == 128:
                    # The int32 contraction alone (one branch, no dequant):
                    # a note, not a library equivalent.
                    row["int_mm_ms_one_branch"] = _int_mm_ms(a, sets, copies)
                rows.append(row)
                print("time " + json.dumps(row))
                del a, sets, kw, ops
    return rows


# ---------------------------------------------------------------------------
# Training (K1f)
# ---------------------------------------------------------------------------

def _parse_key(key):
    """(tag, transpose_a, transpose_b, save_preact) of a launch key."""
    tag, *rest = key.split(" ")
    layout = next((r for r in rest if r in ("nt", "tn", "tt")), "nn")
    return tag, layout[0] == "t", layout[1] == "t", "save_preact" in rest


def k1f_inputs(key, m, n, k, dtype, gen, copies=1):
    """Operands of one K1f program call on the card, A and B in their
    stored layouts (A (k, m) for tn, B (n, k) for nt), the dact prologue's
    fp32 pre-activation shaped like its operand; ``copies`` B sets."""
    tag, ta, tb, save = _parse_key(key)
    spec = program_from_tag(tag)
    dev = "cuda"
    a = torch.randn(*((k, m) if ta else (m, k)), generator=gen,
                    device=dev).to(dtype)
    sets = [[(torch.randn(*((n, k) if tb else (k, n)), generator=gen,
                          device=dev) / math.sqrt(k)).to(dtype)
             for _ in range(spec.n_b)] for _ in range(copies)]
    kw = {"spec": spec, "transpose_a": ta, "transpose_b": tb,
          "save_preact": save}
    pro = spec.prologue
    if pro.kind == "dact":
        shape = (m, k) if pro.operand == "a" else (k, n)
        kw["preact"] = torch.randn(*shape, generator=gen, device=dev)
    if pro.kind == "rms":
        kw["gain"] = torch.rand(k, generator=gen, device=dev) + 0.5
        kw["row_scale"] = rms_row_scale(a, 1e-5)
    ops = [{} for _ in spec.branches]
    if spec.branches[0].has_bias:
        ops[0]["bias"] = torch.randn(n, generator=gen, device=dev).to(dtype)
    kw["branch_operands"] = ops
    return a, sets, kw


def k1f_parity():
    phase("K1f parity: training programs vs plain version")
    gen = torch.Generator(device="cuda").manual_seed(8)
    worst = {}
    cases = [(key, name, m, n, k, od, torch.bfloat16)
             for key, name, m, n, k, od in K1F_GEMMS]
    cases += [(key, "ragged f32", 37, 64, 50, None, torch.float32)
              for key in dict.fromkeys(g[0] for g in K1F_GEMMS)]
    for key, name, m, n, k, od, dtype in cases:
        a, (bs,), kw = k1f_inputs(key, m, n, k, dtype, gen)
        before = dict(K.route_counts)
        got = K.ca_gemm_program(a, bs, out_dtype=od, **kw)
        check_routes(f"{key} {name}", route_delta(before),
                     {f"{want_route(dtype, m)} {key}": 1})
        want = K.ca_gemm_program_reference(a, bs, out_dtype=od, **kw)
        torch.cuda.synchronize()
        if not kw["save_preact"]:
            got, want = (got,), (want,)
        errs = []
        for i, (g, w) in enumerate(zip(got, want)):
            if g.shape != (m, n) or g.dtype != w.dtype \
                    or not bool(torch.isfinite(g).all()):
                raise AssertionError(f"{key} {name}: bad output {i}")
            err = (g.float() - w.float()).abs().max().item()
            scale = w.float().abs().max().item()
            # fp32 outputs (nt's dx, the preacts) differ from the plain
            # version only in summation order; a bf16 output may flip an ulp.
            tol = TOL_F32 * (1 + scale) if g.dtype == torch.float32 \
                else TOL_BF16 * scale
            if not err <= tol:
                raise AssertionError(f"{key} {name} output {i}: kernel "
                                     f"disagrees ({err} > {tol})")
            errs.append(f"{err:.3e}/{tol:.3e}")
            worst[key] = max(worst.get(key, 0.0), err)
        print(f"parity {key:38s} {name:14s} m={m:<5d} n={n:<6d} k={k:<6d} "
              f"{str(dtype)[6:]:8s} max_abs_err/tol " + " ".join(errs))
    return worst


def train_counts_per_step(cfg):
    """K1 launches of one train step, by launch key: per layer 3 ``none``,
    2 ``res`` and the GLU with save_preact forward (twice with remat), and
    backward nt + tn per one-branch program and 4 for the GLU; the head's
    ``none`` forward and its nt + tn."""
    L, fwd = cfg.n_layers, 2 if cfg.remat else 1
    return {"none": 3 * L * fwd + 1, "res": 2 * L * fwd, GLU_SAVE: L * fwd,
            "none nt": 6 * L + 1, "none tn": 6 * L + 1,
            "dact.silu>none nt": L, "dact.silu@b>none tn": L}


def train_slice(cfg):
    steps = TRAIN_STEPS
    phase(f"train: full-width {cfg.name}, {cfg.n_layers} layers, {steps} "
          f"steps of {GLOBAL_BATCH} x {SEQ_LEN} tokens, remat={cfg.remat}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = T.init_state(cfg, seed=0)            # device=None: the card
    torch.cuda.synchronize()
    print(f"init {sum(p.numel() for p in state.params.values())} fp32 "
          f"master params in {time.perf_counter() - t0:.3f} s")
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ_LEN,
                          global_batch=GLOBAL_BATCH, seed=0)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=max(steps // 20, 1),
                                total_steps=steps)
    step_fn = T.build_train_step(cfg, opt_cfg, microbatches=1)
    want = train_counts_per_step(cfg)
    print(f"expected K1 launches per step: {sum(want.values())} {want}")
    tokens = SEQ_LEN * GLOBAL_BATCH
    rows = []
    K.reset_launch_counts()
    for i in range(steps):
        batch = T.cast_batch(batch_for_model(cfg, data_cfg, i), cfg)
        before = dict(K.launch_counts)
        routes_before = dict(K.route_counts)
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, metrics = step_fn(state, batch)
        row = {"step": i + 1, "loss": float(metrics["loss"]),
               "grad_norm": float(metrics["grad_norm"]),
               "lr": float(metrics["lr"])}
        torch.cuda.synchronize()
        row["ms"] = (time.perf_counter() - t) * 1e3
        row["tokens_per_s"] = tokens / row["ms"] * 1e3
        delta = {key: n - before.get(key, 0)
                 for key, n in K.launch_counts.items()
                 if n != before.get(key, 0)}
        print("train " + json.dumps(row) + f" launches {delta}")
        if not (math.isfinite(row["loss"]) and math.isfinite(row["grad_norm"])):
            raise AssertionError(f"step {i + 1}: non-finite loss or norm")
        if delta != want:
            raise AssertionError(f"step {i + 1}: K1 launches {delta}, "
                                 f"expected {want}")
        check_routes(f"train step {i + 1}", route_delta(routes_before),
                     {f"wgmma {key}": n for key, n in want.items()})
        rows.append(row)
    counts = dict(K.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    step_ms = float(np.median([r["ms"] for r in rows[1:]]))
    n_mult = cfg.n_params() - cfg.padded_vocab * cfg.d_model
    n_layers_mult = n_mult - cfg.d_model * cfg.padded_vocab
    bound_ms = 6 * n_mult * tokens / PEAK_OPS[torch.bfloat16] * 1e3
    remat_ms = (2 * n_layers_mult * tokens / PEAK_OPS[torch.bfloat16] * 1e3
                if cfg.remat else 0.0)
    summary = {"steps": rows, "step_ms_steps_2_3": [r["ms"] for r in rows[1:]],
               "tokens_per_s_steps_2_3": [r["tokens_per_s"] for r in rows[1:]],
               "peak_memory_gb": peak / 1e9,
               "model_work_share": bound_ms / step_ms,
               "model_bound_ms": bound_ms, "remat_work_ms": remat_ms,
               "launches_per_step": sum(want.values())}
    summary["profile"] = profile_train_step(step_fn, state, cfg, data_cfg,
                                            steps, step_ms)
    print("train summary " + json.dumps(summary))
    del state, step_fn
    torch.cuda.empty_cache()
    return counts, summary


def profile_train_step(step_fn, state, cfg, data_cfg, step, step_ms):
    """torch.profiler over one more step: device time by kernel, its busy
    share of the unprofiled step time, and K1's share."""
    from torch.profiler import ProfilerActivity, profile

    batch = T.cast_batch(batch_for_model(cfg, data_cfg, step), cfg)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    torch.cuda.synchronize()
    prof.start()
    _, metrics = step_fn(state, batch)
    float(metrics["loss"])
    torch.cuda.synchronize()
    prof.stop()
    by_kernel = {}
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            by_kernel[ev.key] = by_kernel.get(ev.key, 0.0) + _device_us(ev)
    device_ms = sum(by_kernel.values()) / 1e3
    k1_ms = sum(v for k, v in by_kernel.items() if is_k1(k)) / 1e3
    out = {"device_ms": device_ms, "k1_ms": k1_ms,
           "device_busy_share": device_ms / step_ms,
           "k1_share_of_step": k1_ms / step_ms,
           "k1_share_of_device": k1_ms / device_ms if device_ms else None}
    print("profile train step " + json.dumps(out))
    for name, us in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]:
        print(f"profile train top {us / 1e3:10.3f} ms {name[:90]}")
    return out


def cross_check_train(cfg):
    """The same fp32 masters (4 layers, full width) and one batch of
    2 x 64 tokens on the card and on the CPU (plain versions): the loss and
    each leaf's gradient of the step's bf16 compute copy."""
    phase("4-layer full width training: card vs CPU plain path")
    cfg4 = dataclasses.replace(cfg, n_layers=4)
    masters = M.init_params(cfg4, seed=1, masters=True)
    batch = batch_for_model(cfg4, DataConfig(
        vocab_size=cfg4.vocab_size, seq_len=64, global_batch=2, seed=1), 0)
    out = {}
    for dev in ("cuda", "cpu"):
        params = T.cast_params({k: v.to(dev) for k, v in masters.items()},
                               cfg4)
        t0 = time.perf_counter()
        loss, _ = T.loss_fn(params, T.cast_batch(batch, cfg4, dev), cfg4)
        keys = sorted(params)
        grads = torch.autograd.grad(loss, [params[k] for k in keys])
        out[dev] = (loss.item(), {k: g.float().cpu()
                                  for k, g in zip(keys, grads)})
        print(f"{dev}: loss {out[dev][0]:.6f} and {len(keys)} gradients in "
              f"{time.perf_counter() - t0:.3f} s")
        del params, grads
    (lg, gg), (lc, gc) = out["cuda"], out["cpu"]
    rel_loss = abs(lg - lc) / abs(lc)
    print(f"loss card {lg:.6f} cpu {lc:.6f} relative {rel_loss:.3e} "
          f"(tol {TOL_LOSS})")
    if not (math.isfinite(lg) and rel_loss <= TOL_LOSS):
        raise AssertionError("card and CPU training losses disagree")
    worst = 0.0
    for k in sorted(gc):
        a, b = gg[k].double(), gc[k].double()
        rel = ((a - b).norm() / b.norm()).item()
        cos = (a.flatten() @ b.flatten() / (a.norm() * b.norm())).item()
        print(f"grad {k:24s} rel_l2={rel:.3e} cosine={cos:.6f}")
        if not (bool(torch.isfinite(a).all()) and rel <= TOL_GRAD):
            raise AssertionError(f"{k}: card and CPU gradients disagree "
                                 f"({rel} > {TOL_GRAD})")
        worst = max(worst, rel)
    print(f"gradients: worst relative L2 error {worst:.3e} (tol {TOL_GRAD})")
    return {"loss_rel_err": rel_loss, "grad_rel_l2_worst": worst}


def k1f_bound(key, m, n, k, od, dtype):
    """Least time: A, B, the output, the preact operand and outputs (fp32)
    and the bias or rms operands over the memory rate; or 2 m n k per
    branch over the bf16 tensor-core rate, whichever is larger."""
    tag, _, _, save = _parse_key(key)
    spec = program_from_tag(tag)
    es = torch.finfo(dtype).bits // 8
    oes = torch.finfo(od or dtype).bits // 8
    nbytes = m * k * es + spec.n_b * k * n * es + m * n * oes
    if spec.prologue.kind == "dact":
        nbytes += 4 * (m * k if spec.prologue.operand == "a" else k * n)
    if spec.prologue.kind == "rms":
        nbytes += 4 * m + 4 * k
    if save:
        nbytes += spec.n_b * m * n * 4
    if spec.branches[0].has_bias:
        nbytes += n * es
    ops = 2 * m * n * k * spec.n_b
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def k1f_times():
    phase("K1f times at 1024 tokens (CUDA graph replay; B operands rotated "
          "past the 50 MB L2)")
    gen = torch.Generator(device="cuda").manual_seed(9)
    rows = []
    for key, name, m, n, k, od in K1F_GEMMS:
        tag, ta, tb, save = _parse_key(key)
        nb = program_from_tag(tag).n_b
        copies = max(2, math.ceil(120e6 / (nb * k * n * 2)))
        a, sets, kw = k1f_inputs(key, m, n, k, torch.bfloat16, gen, copies)
        ms = _time_ms(lambda i: K.ca_gemm_program(a, sets[i], out_dtype=od,
                                                  **kw), copies)
        plain = _time_ms(lambda i: K.ca_gemm_program_reference(
            a, sets[i], out_dtype=od, **kw), copies)
        # One PyTorch call for the plain nt/tn programs (bf16 out where the
        # nt program writes fp32); none computes dact or save_preact.
        lib = None
        if tag == "none" and tb:
            lib = _time_ms(lambda i: torch.matmul(a, sets[i][0].T), copies)
        elif tag == "none" and ta:
            lib = _time_ms(lambda i: torch.matmul(a.T, sets[i][0]), copies)
        b_ms, b_by = k1f_bound(key, m, n, k, od, torch.bfloat16)
        row = {"program": key, "gemm": name, "m": m, "n": n, "k": k,
               "out": str(od or torch.bfloat16)[6:], "ms": ms,
               "plain_ms": plain, "library_ms": lib, "bound_ms": b_ms,
               "bound_by": b_by, "tflops": 2 * m * n * k * nb / ms / 1e9}
        rows.append(row)
        print("time " + json.dumps(row))
        del a, sets, kw
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# K1g (distance product), K3 (forward flash attention), K4 (k-outer)
# ---------------------------------------------------------------------------

def _event_ms(fn, reps=2):
    """Device ms per call of a function that launches too many kernels to
    capture in a graph: one warm-up call, then ``reps`` calls between two
    events."""
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


def sm_clock_ghz():
    """The card's maximum SM clock, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    return float(out) / 1e3


def apsp_graph(n, degree, seed):
    """Distance matrix of a random directed graph: n * degree edges drawn
    uniformly (self loops dropped, the lighter of two parallel edges
    kept), fp32 weights in (0, 1], +inf where there is no edge, 0 on the
    diagonal."""
    rng = np.random.RandomState(seed)
    src = rng.randint(0, n, n * degree)
    dst = rng.randint(0, n, n * degree)
    w = (1.0 - rng.rand(n * degree)).astype(np.float32)
    keep = src != dst
    d = np.full((n, n), np.inf, dtype=np.float32)
    np.minimum.at(d, (src[keep], dst[keep]), w[keep])
    np.fill_diagonal(d, 0.0)
    return d


def check_min_plus(label, a, b):
    """The distance-product kernel against its plain version: bit-equal,
    NaN where it has NaN; returns the kernel's output and its max abs
    error over the finite entries."""
    got = OPS.distance_product(a, b)
    want = K.ca_gemm_program_reference(a, [b], semiring="min_plus")
    torch.cuda.synchronize()
    same = bool(((got == want) | (got.isnan() & want.isnan())).all())
    fin = torch.isfinite(got) & torch.isfinite(want)
    err = (got[fin] - want[fin]).abs().max().item() if bool(fin.any()) \
        else 0.0
    print(f"parity distance_product {label}: bit-equal {same}, "
          f"max_abs_err={err:.3e}, {int(got.isinf().sum())} inf, "
          f"{int(got.isnan().sum())} NaN")
    if got.shape != want.shape or got.dtype != torch.float32 or not same:
        raise AssertionError(f"distance_product {label}: the kernel is not "
                             "bit-equal to its plain version")
    return got, err


def min_plus_phase():
    phase("K1g: all-pairs shortest paths by repeated min-plus squaring")
    n = APSP_NODES
    d0 = apsp_graph(n, APSP_DEGREE, seed=0)
    steps = math.ceil(math.log2(n - 1))
    dist = torch.from_numpy(d0).cuda()
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        dist = OPS.distance_product(dist, dist)
        if i == 2:
            mid = dist              # a dense step's operand, for parity
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    counts = dict(K.launch_counts)
    print(f"APSP n={n} edges={int(np.isfinite(d0).sum()) - n}: {steps} "
          f"squarings in {wall_ms:.3f} ms, launches {counts}")
    if counts != {MIN_PLUS: steps}:
        raise AssertionError(f"K1g launches {counts}, expected "
                             f"{ {MIN_PLUS: steps} }")
    check_routes("APSP", dict(K.route_counts), {f"simt {MIN_PLUS}": steps})
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import shortest_path

    rows, cols = np.nonzero(np.isfinite(d0) & ~np.eye(n, dtype=bool))
    graph = csr_matrix((d0[rows, cols].astype(np.float64), (rows, cols)),
                       shape=(n, n))
    t0 = time.perf_counter()
    want = shortest_path(graph, method="D", directed=True)
    scipy_s = time.perf_counter() - t0
    got = dist.cpu().numpy()
    fin = np.isfinite(want)
    same_inf = bool(np.array_equal(np.isinf(got), ~fin)) \
        and not np.isnan(got).any()
    rel = float(np.max(np.abs(got[fin] - want[fin])
                       / np.maximum(want[fin], np.finfo(np.float32).tiny)))
    print(f"APSP vs scipy Dijkstra ({scipy_s:.3f} s): unreachable pairs "
          f"{int((~fin).sum())}, same set {same_inf}; max relative error "
          f"{rel:.3e} (rtol 1e-5)")
    if not same_inf or not np.allclose(got[fin], want[fin], rtol=1e-5,
                                       atol=0.0):
        raise AssertionError("APSP by min-plus squaring disagrees with "
                             "Dijkstra")
    gen = torch.Generator(device="cuda").manual_seed(11)
    _, worst = check_min_plus(f"{n}^3 fp32 (squaring 4's operand)", mid,
                              mid)
    a = torch.rand(1000, 333, generator=gen, device="cuda")
    b = torch.rand(333, 777, generator=gen, device="cuda")
    for label, x, y in (("ragged fp32 (1000, 333, 777)", a, b),
                        ("ragged bf16 (1000, 333, 777)", a.bfloat16(),
                         b.bfloat16())):
        worst = max(worst, check_min_plus(label, x, y)[1])
    a[torch.rand(a.shape, generator=gen, device="cuda") < 0.3] = math.inf
    b[torch.rand(b.shape, generator=gen, device="cuda") < 0.3] = math.inf
    a[5] = math.inf                    # a row that reaches nothing
    a[7, 11] = math.nan
    got, err = check_min_plus("ragged fp32, 30 % +inf and one NaN", a, b)
    worst = max(worst, err)
    if not (bool(got[7].isnan().all()) and bool(got[5].isinf().all())):
        raise AssertionError("a NaN (+inf row) in A did not reach its row "
                             "of C")
    ms = _time_ms(lambda i: OPS.distance_product(mid, mid), 1, iters=5,
                  reps=4)
    plain = _event_ms(lambda: K.ca_gemm_program_reference(
        mid, [mid], semiring="min_plus"))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ghz = sm_clock_ghz()
    # 2 m n k FP32 instructions (FADD + FMNMX), 128 lanes a clock per SM
    # (FMNMX's own pipe takes 64: the same m n k / 64 per SM-clock).
    t_ops = 2 * n ** 3 / (128 * sms * ghz * 1e9)
    t_bytes = 3 * n * n * 4 / HBM_BYTES_PER_S
    row = {"case": f"m=n=k={n} fp32", "ms": ms, "plain_ms": plain,
           "library_ms": None, "bound_ms": max(t_ops, t_bytes) * 1e3,
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "sms": sms, "sm_clock_max_ghz": ghz,
           "issue_bound_ms": t_ops * 1e3, "byte_bound_ms": t_bytes * 1e3}
    print("time distance_product " + json.dumps(row))
    del dist, mid, a, b, got
    torch.cuda.empty_cache()
    return {"launches": steps, "max_abs_err": worst, "row": row,
            "apsp_ms": wall_ms, "scipy_s": scipy_s, "max_rel_err": rel}


def fwd_inputs(B, Lq, S, H, Hkv, D, dtype, gen, Dv=None):
    """Random q/k/v on the card (N(0, 1) in ``dtype``; v of Dv, default D),
    kv slot s at position s, queries end-aligned with the keys."""
    q = torch.randn(B, Lq, H, D, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, S, Hkv, D, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, S, Hkv, Dv or D, generator=gen,
                    device="cuda").to(dtype)
    kpos = torch.arange(S, dtype=torch.int32, device="cuda").repeat(B, 1)
    qpos = (torch.arange(Lq, dtype=torch.int32, device="cuda")
            + (S - Lq)).repeat(B, 1)
    return q, k, v, qpos, kpos


# K3 against a plain attention, element by element: each output is held to
# rtol x (|want| + max |want| over its row's Dv values).  The row's own
# scale, not the tensor's: under causal masking the first rows (one slot:
# out = v) are 10-100x the later ones, which average hundreds of slots.
# bf16: one output ulp, 2^-7; fp32: 1e-4.
FWD_RTOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-4}
# bf16 kernel vs plain version only: both round p to bf16 at the same
# running max (the same kv blocks), so outputs differ only where an fp32
# sum lands across a rounding point.  The mean error over the tensor must
# stay under 2^-12 of the mean |want|; p left unrounded moves about a third
# of the outputs by an ulp and exceeds it several times over.
FWD_MEAN_TOL = 2.0 ** -12


def fwd_within(label, got, want, mean_check):
    """Hold ``got`` to ``want`` by the K3 bounds above; raises, or returns
    (max abs error, max error / bound, mean error / mean |want|)."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    aw = w.abs()
    bound = FWD_RTOL[want.dtype] * (aw + aw.amax(dim=-1, keepdim=True))
    over = err > bound
    ratio = (err / bound.clamp(min=1e-30)).max().item()
    mean = err.sum().item() / max(aw.sum().item(), 1e-30)
    late = aw[:, aw.shape[1] // 2:]
    print(f"   {label}: max_abs_err={err.max().item():.3e}, worst "
          f"err/bound={ratio:.3f} (rtol {FWD_RTOL[want.dtype]:.3g}), mean "
          f"err/mean |want|={mean:.3e}; later half of the rows: median "
          f"|want|={late.median().item():.3e}, median bound="
          f"{bound[:, aw.shape[1] // 2:].median().item():.3e}")
    if bool(over.any()):
        raise AssertionError(f"{label}: {int(over.sum())} outputs outside "
                             f"the bound (worst err/bound {ratio})")
    if mean_check and want.dtype == torch.bfloat16 and mean > FWD_MEAN_TOL:
        raise AssertionError(f"{label}: mean error {mean} > {FWD_MEAN_TOL} "
                             "of the mean |want|")
    return err.max().item(), ratio, mean


def check_fwd(label, q, k, v, **kw):
    """The K3 kernel against its plain version on the same inputs; returns
    the kernel's output and its max abs error."""
    got = FA.flash_attention(q, k, v, **kw)
    want = FA.flash_attention_reference(q, k, v, **kw)
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != q.dtype \
            or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"flash_attention {label}: bad output")
    print(f"parity flash_attention {label} {str(q.dtype)[6:]}")
    err, _, _ = fwd_within("kernel vs plain version", got, want, True)
    return got, err


def visible_pairs(qpos, kpos, window):
    """(query, kv slot) pairs the causal and window masks leave, summed
    over the batch: the work the attention must do on these inputs."""
    return sum(int(FA.attention_mask(qpos[:, q0:q0 + 1024], kpos, True,
                                     window).sum())
               for q0 in range(0, qpos.shape[1], 1024))


def fwd_bound(B, Lq, S, H, Hkv, D, pairs, dtype):
    """Least time for one call: q, k, v and out once (plus positions)
    over the memory rate, or 4 D H (visible pairs) operations (q.k and
    p.v) over the bf16 tensor-core rate, whichever is larger."""
    es = torch.finfo(dtype).bits // 8
    nbytes = (2 * B * Lq * H * D + 2 * B * S * Hkv * D) * es \
        + 4 * B * (Lq + S)
    ops = 4 * D * pairs * H
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def misaligned(t):
    """A copy of ``t`` whose base sits one element off 16 bytes: operands
    TMA cannot take, so a bf16 K3 call or an int8 K1 decode on them runs
    the SIMT route."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    out = out.view(t.shape)
    out.copy_(t)
    return out


def flash_fwd_phase():
    phase("K3: forward flash attention (kernel vs plain version)")
    gen = torch.Generator(device="cuda").manual_seed(13)
    FA.reset_launch_counts()
    calls, worst, timed = collections.Counter(), {}, {}

    def check(label, route, q, k, v, **kw):
        got, err = check_fwd(label, q, k, v, **kw)
        calls[route] += 1
        worst[route] = max(worst.get(route, 0.0), err)
        return got

    for name, (B, Lq, S, H, Hkv, D, window) in FWD_SHAPES.items():
        Dv = FWD_DV.get(name, D)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, qpos, kpos = fwd_inputs(B, Lq, S, H, Hkv, D, dtype, gen,
                                             Dv)
            kw = dict(q_positions=qpos, kv_positions=kpos, window=window)
            # Every operand here is aligned: bf16 takes the wgmma route
            # where its head dims fit it.
            got = check(f"{name:16s} B={B} Lq={Lq} S={S} H={H} Hkv={Hkv} "
                        f"D={D} Dv={Dv} window={window}",
                        FA.fwd_route(dtype, D, Dv, True), q, k, v, **kw)
            if name == "stablelm prefill":
                # The model's own plain prefill attention (q chunks of 512,
                # kv chunks of 1024: other rescale points, same function).
                # Its p rounds at other running maxima, so the element
                # bound holds here and the mean one does not.
                fwd_within("cross-check vs models.attention.flash_attention",
                           got, A.flash_attention(q, k, v, **kw), False)
            if dtype == torch.bfloat16 and name in FWD_TIMED:
                timed[name] = (q, k, v, kw)
            del got
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, qpos, kpos = fwd_inputs(3, 300, 1000, 32, 32, 64, dtype, gen)
        kpos[torch.rand(kpos.shape, generator=gen, device="cuda") < 0.1] = -1
        qpos[2, 0] = -3                # before every kv slot: sees none
        got = check("ragged B=3 Lq=300 S=1000, -1 slots, a masked row",
                    "wgmma" if dtype == torch.bfloat16 else "simt", q, k, v,
                    q_positions=qpos, kv_positions=kpos)
        if bool(got[2, 0].any()):
            raise AssertionError("the fully masked query row is not 0")
    # bf16 whose bases sit off 16 bytes: the SIMT route.
    q, k, v, kw = timed["danube prefill"]
    check("danube prefill, bf16 bases off 16 bytes", "simt",
          *(misaligned(t) for t in (q, k, v)), **kw)
    counts, routes = dict(FA.launch_counts), dict(FA.route_counts)
    n_calls = sum(calls.values())
    print(f"K3 launches over {n_calls} calls: {counts}")
    check_routes(f"K3 over {n_calls} calls", routes,
                 {f"{r} {FA.FWD_NAME}": n for r, n in calls.items()})
    if counts != {FA.FWD_NAME: n_calls}:
        raise AssertionError(f"K3 launches {counts}, expected {n_calls}")
    phase("K3 times (CUDA graph replay): the wgmma route, the SIMT route "
          "(the same bf16 operands, bases off 16 bytes)")
    rows = []
    for name in FWD_TIMED:
        B, Lq, S, H, Hkv, D, window = FWD_SHAPES[name]
        q, k, v, kw = timed[name]
        ms = _time_ms(lambda i: FA.flash_attention(q, k, v, **kw), 1)
        qm, km, vm = (misaligned(t) for t in (q, k, v))
        simt_ms = _time_ms(lambda i: FA.flash_attention(qm, km, vm, **kw), 1,
                           iters=5, reps=2)
        del qm, km, vm
        plain = _time_ms(lambda i: FA.flash_attention_reference(
            q, k, v, **kw), 1, iters=5, reps=2)
        lib = None
        if window is None or window >= S:
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            lib = _time_ms(lambda i: torch.nn.functional
                           .scaled_dot_product_attention(
                               qt, kt, vt, is_causal=True, enable_gqa=True),
                           1)
        pairs = visible_pairs(kw["q_positions"], kw["kv_positions"], window)
        b_ms, b_by = fwd_bound(B, Lq, S, H, Hkv, D, pairs, torch.bfloat16)
        row = {"kernel": FA.FWD_NAME, "case": name, "B": B, "Lq": Lq,
               "S": S, "H": H, "Hkv": Hkv, "D": D, "window": window,
               "visible_pairs": pairs, "fwd_route": "wgmma", "ms": ms,
               "simt_ms": simt_ms, "plain_ms": plain, "library_ms": lib,
               "bound_ms": b_ms, "bound_by": b_by,
               "tflops": 4 * D * pairs * H / ms / 1e9,
               "simt_tflops": 4 * D * pairs * H / simt_ms / 1e9}
        rows.append(row)
        print("time " + json.dumps(row))
    del timed
    torch.cuda.empty_cache()
    return {"launches": dict(calls), "max_abs_err": worst, "rows": rows}


def k_outer_phase():
    phase(f"K4: the k-outer ablation at m = n = k = {K_OUTER_MNK} (kernel "
          "vs plain version)")
    n = K_OUTER_MNK
    gen = torch.Generator(device="cuda").manual_seed(17)
    K.reset_launch_counts()
    worst = 0.0
    # Each dtype at its default tile; bf16 also at a non-default dividing
    # tile of whole wgmma blocks and at the SIMT tile.
    cases = [(torch.float32, None), (torch.bfloat16, None),
             (torch.int8, None), (torch.bfloat16, (256, 256, 128)),
             (torch.bfloat16, K.SIMT_TILE)]
    want = {}
    for dtype, tiles in cases:
        if dtype == torch.int8:
            a, b = (torch.randint(-127, 128, (n, n), generator=gen,
                                  device="cuda", dtype=torch.int8)
                    for _ in range(2))
        else:
            a, b = (torch.randn(n, n, generator=gen, device="cuda").to(dtype)
                    for _ in range(2))
        bm, bn, bk = tiles or K.K_OUTER_TILES[dtype]
        route = K.k_outer_route(dtype, bm, bn, bk)
        rkey = f"{route} {K.K_OUTER}"
        want[rkey] = want.get(rkey, 0) + n // bk
        # Float inputs: compare the fp32 C before any cast.
        od = None if dtype == torch.int8 else torch.float32
        got = K.ca_mmm_k_outer(a, b, bm=bm, bn=bn, bk=bk, out_dtype=od)
        ref = K.ca_mmm_k_outer_reference(a, b, bm=bm, bn=bn, bk=bk,
                                         out_dtype=od)
        torch.cuda.synchronize()
        err = (got.double() - ref.double()).abs().max().item()
        tol = 0.0 if dtype == torch.int8 \
            else 1e-4 * ref.abs().max().item()
        print(f"parity ca_mmm_k_outer {str(dtype)[6:]:8s} {n}^3 tile "
              f"({bm}, {bn}, {bk}) {route} out {str(got.dtype)[6:]} "
              f"max_abs_err={err:.3e} tol={tol:.3e}")
        if got.dtype != ref.dtype or not err <= tol:
            raise AssertionError(f"ca_mmm_k_outer {dtype} {tiles}: kernel "
                                 f"disagrees ({err} > {tol})")
        worst = max(worst, err)
        del a, b, got, ref
    calls = sum(want.values())
    check_routes(f"K4 over {len(cases)} calls", dict(K.route_counts), want)
    if K.launch_counts != {K.K_OUTER: calls}:
        raise AssertionError(f"K4 launches {K.launch_counts}, expected "
                             f"{calls}")
    phase("K4 times beside K1a's (CUDA graph replay, bf16)")
    a, b = (torch.randn(n, n, generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    ms = _time_ms(lambda i: K.ca_mmm_k_outer(a, b), 1, iters=5, reps=4)
    wide_ms = _time_ms(lambda i: K.ca_mmm_k_outer(
        a, b, bm=256, bn=256, bk=128), 1, iters=5, reps=4)
    simt_ms = _time_ms(lambda i: K.ca_mmm_k_outer(
        a, b, bm=K.SIMT_TILE[0], bn=K.SIMT_TILE[1], bk=K.SIMT_TILE[2]), 1,
        iters=5, reps=4)
    k1_ms = _time_ms(lambda i: K.ca_gemm_program(a, [b]), 1, iters=5, reps=4)
    plain = _time_ms(lambda i: K.ca_mmm_k_outer_reference(a, b), 1, iters=2,
                     reps=2)
    lib = _time_ms(lambda i: torch.matmul(a, b), 1)
    b_ms, b_by = bound("none", n, n, n, None, torch.bfloat16)
    # The reference's traffic formulas (benchmarks/bench_intensity.py), in
    # bytes, at K4's default bf16 tile, which is K1a's wgmma tile
    # (128 x 128, 64 rows of k a stage): the same bf16 panels, K1's bf16 C
    # written once, K4's fp32 C read and written every k step.
    es = 2
    bm, bn, bk = K.K_OUTER_TILES[torch.bfloat16]
    gm, gn, gk = n // bm, n // bn, n // bk
    panels = gm * gn * gk * (bm * bk + bk * bn) * es
    q_k4 = panels + 2 * n * n * gk * 4
    q_k1 = panels + n * n * es
    row = {"case": f"m=n=k={n} bf16", "tile": [bm, bn, bk],
           "k_outer_route": K.k_outer_route(torch.bfloat16, bm, bn, bk),
           "launches_per_call": gk, "ms": ms, "k1a_ms": k1_ms,
           "ms_tile_256_256_128": wide_ms,
           "ms_simt_tile_64_64_32": simt_ms,
           "plain_ms": plain, "library_ms": lib, "bound_ms": b_ms,
           "bound_by": b_by, "traffic_bytes_k_outer": q_k4,
           "traffic_bytes_k1": q_k1,
           "traffic_ms_k_outer": q_k4 / HBM_BYTES_PER_S * 1e3,
           "traffic_ms_k1": q_k1 / HBM_BYTES_PER_S * 1e3}
    print("time ca_mmm_k_outer " + json.dumps(row))
    del a, b
    torch.cuda.empty_cache()
    return {"launches": calls, "max_abs_err": worst, "row": row}


def main():
    t_start = time.perf_counter()
    card_line = card()
    build()
    worst = parity()
    worst.update(quant_parity())
    worst.update(k1f_parity())
    worst_attn = attn_parity()
    cfg = get_config(ARCH)
    routes, e2e = serve_slice(cfg)
    cross_check(cfg)
    int8 = serve_int8(cfg)
    cross_check_int8(cfg)
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in (1000, 128, 37, 8)]
    (attn_launches, call_err, paged_e2e, split, paged_profile,
     paged_routes) = serve_both(cfg, prompts, max_len=1056, profile=True)
    cross_check_paged(cfg)
    dcfg = get_config(DANUBE)
    _, danube_call_err, danube_e2e, danube_split, _, _ = serve_both(
        dcfg, [rng.randint(0, dcfg.vocab_size, 300)], max_len=320)
    worst_attn = max(worst_attn, call_err, danube_call_err)
    train_launches, train = train_slice(cfg)
    train_check = cross_check_train(cfg)
    rows = times()
    qrows = quant_times(rows)
    attn_rows = attn_times()
    frows = k1f_times()
    k1g = min_plus_phase()
    k3 = flash_fwd_phase()
    k4 = k_outer_phase()
    phase("summary")
    print(f"card: {card_line}")
    for r in e2e["requests"]:
        print(f"e2e request {r['uid']} prompt={r['prompt']}: "
              f"prefill {r['prefill_ms']:.3f} ms, decode "
              f"{r['decode_ms_per_token']:.3f} ms/token")
    print(f"e2e tokens/s {e2e['tokens_per_s']:.3f} over "
          f"{e2e['run_s']:.3f} s; weight-byte bound 0.86 ms/token")
    print("e2e decode profile " + json.dumps(e2e["profile"]))
    for mode, row in int8.items():
        for r in row["requests"]:
            print(f"e2e {mode} request {r['uid']} prompt={r['prompt']}: "
                  f"prefill {r['prefill_ms']:.3f} ms, decode "
                  f"{r['decode_ms_per_token']:.3f} ms/token")
        print(f"e2e {mode} tokens/s {row['tokens_per_s']:.3f} over "
              f"{row['run_s']:.3f} s; calibration {row['calibration_s']:.3f} "
              f"s over {len(row['calibration_sites'])} sites; prefill logits "
              f"cosine vs bf16 min {row['cosine_vs_bf16_min']:.6f} mean "
              f"{row['cosine_vs_bf16_mean']:.6f}; weight-byte bound 0.43 "
              "ms/token")
        print(f"e2e {mode} decode profile " + json.dumps(row["profile"])
              + f"; aten ops per decode step {row['aten_ops_per_decode_step']}"
              f" (bf16 {row['bf16_aten_ops_per_decode_step']})")
    print("e2e paged decode profile " + json.dumps(paged_profile))
    for name, sp in ((ARCH, split), (DANUBE, danube_split)):
        print(f"e2e {name} host split (median of 3 rounds) "
              + json.dumps(sp))
    for name, runs in ((ARCH, paged_e2e), (DANUBE, danube_e2e)):
        for r in runs:
            print(f"e2e {name} request {r['uid']} prompt={r['prompt']}: "
                  f"decode slab {r['slab_decode_ms_per_token']:.3f} / paged "
                  f"{r['paged_decode_ms_per_token']:.3f} ms/token, prefill "
                  f"slab {r['slab_prefill_ms']:.3f} / paged "
                  f"{r['paged_prefill_ms']:.3f} ms")
    kernels = []
    for tag, gemm in RECORD_GEMM.items():
        row = next(r for r in rows if r["program"] == tag
                   and r["gemm"] == gemm and r["m"] == 1)
        kernels.append({
            "name": f"ca_gemm_program[{tag}] decode", "route": "cuda",
            "source": SOURCE, "replaces": REPLACES,
            "launches": routes[f"decode {tag}"], "max_abs_err": worst[tag],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "k1_route": "decode",
            "shape": f"{gemm} m=1 k={row['k']} n={row['n']} bf16"})
    # The same programs at the 1000-token prefill (the wgmma route); their
    # launches are the paged slice's prefills of more than 8 tokens.
    for tag, gemm in RECORD_GEMM.items():
        row = next(r for r in rows if r["program"] == tag
                   and r["gemm"] == gemm and r["m"] == 1000)
        kernels.append({
            "name": f"ca_gemm_program[{tag}] prefill", "route": "cuda",
            "source": SOURCE, "replaces": REPLACES,
            "launches": paged_routes[f"wgmma {tag}"],
            "max_abs_err": worst[tag], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "k1_route": "wgmma",
            "shape": f"{gemm} m=1000 k={row['k']} n={row['n']} bf16"})
    # The int8 programs at decode (m = 1, the decode route) and at the
    # served 1000-token prefill (the int8 wgmma route), the SIMT tile's
    # time on the same operands beside each; launches by route from the
    # int8 slice.
    for step, m in (("decode", 1), ("prefill", 1000)):
        for tag, gemm in RECORD_GEMM.items():
            for mode, qtag in zip(("int8w", "w8a8"), QUANT[tag]):
                row = next(r for r in qrows if r["program"] == qtag
                           and r["gemm"] == gemm and r["m"] == m)
                route = row["k1_route"]
                record = {
                    "name": f"ca_gemm_program[{qtag}] {step}",
                    "route": "cuda", "source": SOURCE, "replaces": REPLACES,
                    "launches": int8[mode]["routes"][f"{route} {qtag}"],
                    "max_abs_err": worst[qtag], "ms": row["ms"],
                    "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                    "bound_by": row["bound_by"],
                    "library_ms": row["library_ms"], "k1_route": route,
                    "simt_ms": row["simt_ms"],
                    "shape": f"{gemm} m={m} k={row['k']} n={row['n']} int8 "
                             "B, " + ("int8 A" if "dqab" in qtag
                                      else "bf16 A")}
                kernels.append(record)
    for key, gemm in RECORD_K1F.items():
        row = next(r for r in frows if r["program"] == key
                   and r["gemm"] == gemm)
        kernels.append({
            "name": f"ca_gemm_program[{key}]", "route": "cuda",
            "source": SOURCE, "replaces": REPLACES,
            "launches": train_launches[key], "max_abs_err": worst[key],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "k1_route": "wgmma",
            "shape": f"{gemm} m={row['m']} n={row['n']} k={row['k']} bf16, "
                     f"{row['out']} out"})
    arow = attn_rows[0]
    kernels.append({
        "name": FA.NAME, "route": "cuda", "source": ATTN_SOURCE,
        "replaces": ATTN_REPLACES, "launches": attn_launches,
        "max_abs_err": worst_attn, "ms": arow["ms"],
        "plain_ms": arow["plain_ms"], "bound_ms": arow["bound_ms"],
        "bound_by": arow["bound_by"], "library_ms": None,
        "shape": f"B={arow['B']} S={arow['S']} page={arow['page']} "
                 f"H={arow['H']} Hkv={arow['Hkv']} D={arow['D']} bf16"})
    grow = k1g["row"]
    kernels.append({
        "name": f"ca_gemm_program[{MIN_PLUS}]", "route": "cuda",
        "source": SOURCE, "replaces": REPLACES, "launches": k1g["launches"],
        "max_abs_err": k1g["max_abs_err"], "ms": grow["ms"],
        "plain_ms": grow["plain_ms"], "bound_ms": grow["bound_ms"],
        "bound_by": grow["bound_by"], "library_ms": None,
        "k1_route": "simt", "shape": grow["case"]})
    frow = k3["rows"][0]
    for fr, suffix, key in (("wgmma", "", "ms"), ("simt", "[simt]",
                                                   "simt_ms")):
        kernels.append({
            "name": FA.FWD_NAME + suffix, "route": "cuda",
            "source": FWD_SOURCE, "replaces": FWD_REPLACES,
            "launches": k3["launches"][fr],
            "max_abs_err": k3["max_abs_err"][fr], "ms": frow[key],
            "plain_ms": frow["plain_ms"], "bound_ms": frow["bound_ms"],
            "bound_by": frow["bound_by"], "library_ms": frow["library_ms"],
            "fwd_route": fr,
            "shape": f"{frow['case']} B={frow['B']} Lq={frow['Lq']} "
                     f"S={frow['S']} H={frow['H']} Hkv={frow['Hkv']} "
                     f"D={frow['D']} causal bf16"
                     + ("" if fr == "wgmma" else ", bases off 16 bytes")})
    orow = k4["row"]
    kernels.append({
        "name": "ca_mmm_k_outer", "route": "cuda", "source": K_OUTER_SOURCE,
        "replaces": K_OUTER_REPLACES, "launches": k4["launches"],
        "max_abs_err": k4["max_abs_err"], "ms": orow["ms"],
        "plain_ms": orow["plain_ms"], "bound_ms": orow["bound_ms"],
        "bound_by": orow["bound_by"], "library_ms": orow["library_ms"],
        "k_outer_route": orow["k_outer_route"],
        "shape": f"{orow['case']}, tile {orow['tile']}, "
                 f"{orow['launches_per_call']} launches a call"})
    print(f"e2e K1g APSP {APSP_NODES} nodes: {k1g['launches']} squarings in "
          f"{k1g['apsp_ms']:.3f} ms (scipy Dijkstra {k1g['scipy_s']:.3f} s "
          f"on the host), max relative error {k1g['max_rel_err']:.3e}")
    print(f"e2e K4 vs K1a at {K_OUTER_MNK}^3 bf16: k-outer {orow['ms']:.3f} "
          f"ms (tile {orow['tile']}; {orow['ms_tile_256_256_128']:.3f} at "
          f"256 x 256 x 128, {orow['ms_simt_tile_64_64_32']:.3f} on the "
          f"SIMT step), k-inner {orow['k1a_ms']:.3f} ms; traffic "
          f"{orow['traffic_bytes_k_outer'] / 1e9:.3f} vs "
          f"{orow['traffic_bytes_k1'] / 1e9:.3f} GB")
    print(f"e2e train step ms (steps 2-3) {train['step_ms_steps_2_3']}, "
          f"tokens/s {train['tokens_per_s_steps_2_3']}, peak memory "
          f"{train['peak_memory_gb']:.3f} GB, model-work share "
          f"{train['model_work_share']:.4f} (bound {train['model_bound_ms']:.3f}"
          f" ms per step, remat adds {train['remat_work_ms']:.3f} ms), "
          f"{train['launches_per_step']} K1 launches per step")
    print("e2e train step profile " + json.dumps(train["profile"]))
    print("e2e train 4-layer card vs CPU " + json.dumps(train_check))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
