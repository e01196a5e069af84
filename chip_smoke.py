#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. card: prints the card's name and power limit; CUDA must be available.
2. build: compiles the five kernel sources (the CA-GEMM program kernel,
   the distance product, the paged decode-attention kernel, the forward
   flash-attention kernel and the k-outer ablation kernel) with nvcc into
   build/, one nvcc per source, all started together.
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
   zeros), at D = 4096 (K rows staged in 1024-byte chunks, the wide
   form); bit-identical when the pool's free pages are poisoned and
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
   fp32 shape (SIMT).  Then the two-output dual programs and the dequant
   programs with save_preact or a dact prologue (on A, on the int8 B, on
   dqab's int8 A) against their plain versions, fp32 and bf16, ragged and
   at the 1000-token prefill, each launch on the SIMT tile; the time of
   one of each beside its bound.
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
   exactly 12 launches on its own kernel, held against scipy's Dijkstra
   (the same unreachable pairs, rtol 1e-5 on the rest); the kernel
   bit-equal to its plain version at 4096^3, on shapes that straddle its
   128 x 128 x 8 tile (m, n, k of 1, 127, 128, 129 and 4095), in bf16 and
   fp32, and with +inf and NaN operands; its time against the FP32
   issue-rate bound at the card's maximum SM clock and at the clock
   nvidia-smi reads while it runs.
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

14. architectures: K1 on the new programs and shapes against its plain
   version, routes asserted (granite-20b's rms-prologue GELU w_up at
   m = 1, 37, 128, k 6144, n 24576; deepseek-v2-lite's expert GLU and
   down projection at its capacity rows m = 8 and 16; MLA's wkv_a, n =
   576 and 288, and minicpm3's q-LoRA projections; mixtral's expert GLU
   at m = 8).  Then, one model on the card at a time, full width, random
   weights from seed 0, bf16: granite-20b (6 of its 52 layers),
   deepseek-v2-lite-16b (2 of 27), minicpm3-4b (8 of 62; these three cut
   to keep the script inside its time limit) and mixtral-8x7b (4 of its 32
   layers: 93 GB in bf16 does not fit) serve prompts of 128, 37 and 8
   tokens (mixtral also 4200, past its 4096-token window), 8 new tokens
   each, through
   ServeEngine on the slab cache; granite and mixtral also with
   paged_kv=True.  Every forward step's K1 launches by route and program
   (37 / 267 / 49 / 81 a step; the routed experts at their capacity
   rows), K2's (one a layer a paged decode step, none in prefill), slab vs
   paged prefill logits bit-equal and greedy tokens up to a near tie, one
   K2 call of the run replayed against its plain version; decode and
   prefill times, torch.profiler's split of 8 decode steps, peak memory
   beside the card's and the weight-byte bound (deepseek also with only
   its active experts).  Each arch at full width and 2 layers (minicpm3
   4) is held against the CPU's plain path (prefill logits, greedy tokens
   up to a near tie).  Last, the new shapes' times.
   The last four families join the same phase: K1 at their new shapes
   (the Mamba2 in_proj, n 4384 and 14576, and out_proj; zamba2's shared
   w_in; qwen2-vl's GLU, k 8192, n 29568, and w_down; musicgen's GELU
   w_up) and K2 at their paged shapes (qwen2-vl G = 8, D = 128; musicgen
   G = 1, D = 64); mamba2-370m (12 of its 48 layers, 25 K1 launches a
   step) and zamba2-7b (12 of 81 layers and 2 shared-block applications,
   39) on the
   slab cache with a 600-token prompt besides (three 256-token SSD
   chunks, not a multiple of one); qwen2-vl-72b (12 of its 80 layers:
   145 GB in bf16 does not fit; 73) over the embeds frontend's demo
   table and musicgen-large (12 of 48 layers, four codebook heads, 72)
   on the
   slab and the paged cache; held against the CPU at 2 layers (zamba2 7:
   one full group and a partial one).
   ``python3 chip_smoke.py --only archs [ARCH ...]`` runs the card and
   build phases and this one alone (no kernels line, no result).
15. obs (run after phase 5): full-width stablelm-1.6b, bf16, served slab
   and paged (prompts of 128, 37 and 8 tokens, 16 new tokens each) with
   the GEMM ledger and tracing on (repro_torch.obs; traces under
   chiprun_out/): the engine's metrics_report() (TTFT and TPOT
   percentiles, tokens/s, warmup seconds), each step label's ledger
   aggregates (steps, GEMM calls, planned bytes, achieved GB/s, model
   error), the trace's span counts; the ledger's GEMM calls must equal
   K1's launches over the run and 145 a decode step, the paged path's
   attention records one a layer a decode step, and one decode step's
   planned GEMM bytes are printed split into the weights (held equal to
   the K1 weights' bytes from the params, beside PERF.md's 2.88 GB), the
   A re-reads at the resolved tiles and the rest.  Then one engine's
   decode ms/token with obs off and on, in turns (off, on, on, off).
   The card's peaks throughout the script are the port's hardware target
   (repro_torch.core.hardware.H100), the constants the ledger plans with.
16. robust (run after phase 15): full-width stablelm-1.6b, random weights
   from seed 0.  Chaos serve, int8w, 24 layers: 4 requests (prompts 128,
   37, 8, 8; 8 new tokens each) under FaultPlan(kernel_fatal_at=(0,),
   kernel_fail_at=(1,), nan_decode_at=(7,)) with the fallback on, beside
   a fault-free engine on the same params: statuses failed / degraded /
   degraded / done, request 3's tokens equal, request 1's (its failed
   GEMM counted and launched again on the card) tokens and sampled rows
   bit-equal, request 2's dense attempt (against a bf16 engine on the
   dequantized weights) equal up to a near tie, every counter exact, and
   145 K1 launches by every forward step.  Paged admission, bf16: a pool of two sequences'
   pages, max_queue 2, shed_oldest; 5 submits give one kv_pages and two
   shed rejections; a transient decode failure retries once; no page
   leaks; 24 K2 launches a decode step.  Preflight: plans validated, no
   violation; a poisoned tuning-cache entry raises SMEM001 with no
   launch; every launch signature's dynamic shared memory (the built
   launcher's ca_gemm_program_smem) equals kernels.ca_mmm.route_smem_bytes.
   Checkpoint and resume, full width at 2 layers, fp32 masters, AdamW,
   4 x 256 tokens: 3 steps, then a run that saves every step (async) and
   crashes after step 2, and a resume: step 2's loss and every leaf
   bit-equal; the checkpoint's GB and its save, verify and restore
   seconds; restore_quantized serves one request with the tokens of
   quantize_params of the uninterrupted state.  At the end of the script
   gemm.fallback_total reads the chaos plan's 1: no other GEMM fell back.
   ``python3 chip_smoke.py --only robust`` runs the card and build phases
   and this one alone (no kernels line, no result).

17. train archs (run after phase 9): K1f at the programs and shapes the
   other families train with, against their plain versions, each
   call's route asserted and printed (wgmma: bf16 operands with 16-byte
   rows at m > 8): deepseek-v2-lite-16b's expert GLU with save_preact, its dact
   nt / tn and its down projection's nt / tn at the capacity rows of a
   4 x 256-token step (128), mixtral-8x7b's expert GLU at 320 rows, the
   ragged n of MLA's wkv_a (576, 288) and of the Mamba2 in_proj (4384,
   14576) in dx and dW, musicgen-large's rms>gelu w_up with save_preact
   and its dact.gelu nt / tn.  Then each of the seven other
   configurations trains at full width, one at a time, fp32 masters from
   seed 0, AdamW on the donated state: mamba2-370m (48 layers),
   musicgen-large (48), deepseek-v2-lite-16b (2 of 27), zamba2-7b (12 of
   81: two full groups, the shared block applied twice), minicpm3-4b (8
   of 62), mixtral-8x7b and qwen2-vl-72b (2 each), 2 steps of 4 x 256
   tokens: finite loss, aux and grad_norm at each step and exactly
   ``train_counts_per_step``'s K1 launches by key; routes by key,
   launches by shape (each timed shape must be one its run launched), step ms,
   tokens/s, peak memory, the bound (6 N_active T, remat's 2 N T, for
   MoE the capacity loop's expert work) and one profiled step's busy and
   K1 shares.  Each family's 2-layer model (zamba2 7: one full group
   and a partial one) is held against the CPU on data seed 1 (loss,
   aux, every gradient leaf); an MoE arch's CPU run takes the card's
   routed choices, each choice its own top-k would change must be a
   near tie, and an fp32 forward on the CPU with the card's choices is
   the witness both runs' router inputs, outputs and probabilities are
   printed against (``routing_witness``).  Then the new shapes' times
   (kernel, plain version, the same layout's torch.matmul, bound).
   ``python3 chip_smoke.py --only train [ARCH ...]`` runs the card and
   K1's build and this phase alone (no kernels line, no result).

18. dist (run last): eight ranks (``launch.mesh.spawn_ranks``), under
   NCCL one a card where the host has eight cards, else all on the one
   card over gloo (the ring's and the gather's buffers through pinned
   host copies, every local GEMM on the card); the backend and card
   count are printed.  Each rank: ``core.distributed.dist_matmul`` at a
   full-width stablelm-1.6b w_up shape (k 2048, n 5632, bf16) at m = 8
   and 1000 on the (data 2, model 4) and (pod 2, data 2, model 2)
   meshes, every schedule and auto, against the single-card K1 product
   of the same operands (1e-3 of max|want| plus 1e-2 of each element),
   exactly tp K1 launches a ring dispatch and 1 an allgather, the bytes
   its transfers moved (``distributed.wire_bytes``) equal to its plan
   plus the pod traffic the plan leaves out, one wall a schedule; K1
   at each ring-step local shape against its plain version (one rank at
   a time), timed beside torch.matmul and the bound by each rank with a
   card of its own, by rank 0 alone where the ranks share one; the
   tensor-parallel decode block (``serve.tp``) at stablelm-1.6b's full
   width, bf16 weights from seed 0, B = 8 on the 2-D mesh, 16 steps with
   the KV history, on ring, allgather and int8w (bf16 activations) and
   w8a8-ride (fp32 and bf16 activations, its act scales calibrated per
   projection on the oracle's int8w run), each step against
   ``tp_decode_reference`` on the card, exactly 7·tp K1 launches a ring
   step, 7 an allgather step, none for int8 partials; w8a8-ride's block
   also allowed what one ulp of input moves the oracle itself (the
   witness: codes flipped, output moved, printed), its three
   projections held without it on the oracle's own inputs; the ledger's 7
   dist records' planned bytes equal to ``estimate_cost``'s and their
   sum to the bytes the rings sent; one step under
   ``FaultPlan(kernel_fail_at=...)`` re-dispatched bit-equal.  Then
   the same spawn's ranks 0-3 train (``fsdp_rank``): full-width
   stablelm-1.6b at 2 of its 24 layers (fp32 masters from seed 0, the
   whole vocab), 2 steps of 8 x 128 tokens, each rank's mask holding
   another count of tokens, with the FSDP hooks
   (``train.fsdp.weight_hoist``) on (data 2) and (pod 2, data 2) at
   microbatches 1 and 2: every rank's K1 launches equal
   ``train_counts_per_step`` times the microbatches, all on the wgmma
   route; loss and grad_norm within TOL_LOSS of the single-process card
   step on the whole batch (run once, by rank 0, which gathers each
   run's parameters), each leaf's change within TOL_GRAD relative L2 of
   its change or twice its witness (the single-process step on the batch
   with its rows reversed); the step walls (the gloo transport's).
   ``allreduce_compressed`` in int8 and bf16 over ``pod`` on card
   tensors against the plain mean, with the error-feedback identity.
   The state saved from the 4 ranks (6.2 GB under build/, removed),
   restored on 2 ranks and on 1 rank at once, every chunk of every leaf
   checksummed in each layout (``_digest``: 64-bit sums of its bits)
   and all equal, rank 0's chunk bit-equal to its restore.  Then the
   same four ranks train FSDP x TP on (data 2, model 2)
   (``tp_train_part``): full-width stablelm-1.6b at 2 layers,
   deepseek-v2-lite-16b (MLA, 64 experts, 32 a rank) at 1, mamba2-370m
   at 2 (16 SSD heads a rank) and zamba2-7b at 6 (one full group, one
   shared-block application), bf16 at microbatches 1 and 2 (the Mamba2
   archs: 1) and fp32 at 1; h2o-danube-3-4b, minicpm3-4b and
   musicgen-large at 2 layers, granite-20b (its one KV head read whole),
   mixtral-8x7b (4 experts a rank) and qwen2-vl-72b at 1, bf16 at
   microbatch 1 (granite and musicgen also fp32): loss and grad_norm
   within TOL_LOSS (TOL_F32 in fp32) of the single-process card step
   (stablelm's the FSDP part's), each leaf's first gradient within the
   larger of TOL_GRAD (TOL_F32) and twice its witness, each leaf's
   change within the larger of TOL_GRAD and twice the larger of its two
   witnesses (rows reversed; masters perturbed by 2^-20, PERTURB), every
   rank's K1 launches equal to ``tp_counts_per_step`` (every local GEMM
   of forward and backward on K1: bf16 wgmma, fp32 SIMT), its
   ``model``-axis bytes by site equal to ``FsdpLayout.tp_wire_plan``
   (the dry run's planned bytes printed beside them), its walls
   printed; K1 at stablelm's, mamba2's and granite's local shapes
   against its plain version, timed beside the same layout's
   torch.matmul.  Any
   rank's failure fails the script.  ``python3 chip_smoke.py --only dist`` runs the
   card and K1's build and this phase alone, ``--only fsdp`` its FSDP
   part alone, ``--only tp [ARCH ...]`` its TP part alone, of the
   configurations named (default all; no kernels line, no result).

The last two lines are the kernels' JSON record and the result JSON.
"""

import collections
import concurrent.futures
import dataclasses
import gc
import json
import math
import os
import pathlib
import subprocess
import sys
import time
import warnings

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch import kvcache as kvc  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.hardware import H100  # noqa: E402
from repro_torch.data.pipeline import (  # noqa: E402
    DataConfig, batch_for_model)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ca_mmm as K  # noqa: E402
from repro_torch.kernels import flash_attn as FA  # noqa: E402
from repro_torch.kernels import ops as OPS  # noqa: E402
from repro_torch.kernels.program import (program_cost,  # noqa: E402
                                         program_from_tag, rms_row_scale)
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import common as CM  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.quant import QTensor, QuantConfig  # noqa: E402
from repro_torch.serve.engine import (Request, ServeEngine,  # noqa: E402
                                      model_inputs)
from repro_torch.train import step as T  # noqa: E402
from repro_torch.tuning import resolve_page_size  # noqa: E402

ARCH = "stablelm-1.6b"
DANUBE = "h2o-danube-3-4b"
# The card's data-sheet rates, from the port's one hardware target (the
# ledger's planned seconds read the same constants).
HBM_BYTES_PER_S = H100.hbm_bandwidth
PEAK_OPS = {dt: H100.peak_flops(dt)           # bf16 and int8 tensor cores,
            for dt in (torch.bfloat16,        # fp32 outside them
                       torch.float32, torch.int8)}
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
DISTANCE_SOURCE = "src/repro_torch/csrc/distance_product.cu"
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
              "D264 shifted": ([130, 45], 16, 4, 2, 264, 30),
              "D4096 wide": ([300, 41], 16, 8, 2, 4096, None),
              # The paged serve calls of qwen2-vl-72b and musicgen-large:
              # the first request's last decode step (128 + 15 tokens) on
              # the analytic page for max_len 144.
              "qwen2-vl G8": ([143], 64, 64, 8, 128, None),
              "musicgen G1": ([143], 64, 32, 32, 64, None)}
ATTN_DV = {"mla D192": MLA_DV, "absorbed mla": 512, "G64 D576": 512,
           "D4096 wide": 256}
# The case past one token group's K row (PagedPlan.dkc < D): timed beside
# the others, its launches counted as K2's wide form.
ATTN_WIDE = "D4096 wide"
# The paged cases timed (the serving calls, the B = 8 batches, the group
# and head-dim cases, the column chunks); "a stablelm" first, the
# kernel's JSON record.
ATTN_TIMED = ("a stablelm", "danube serve", "stablelm B8 S4096",
              "danube B8 S4096", "granite G48", "mla D192",
              "stablelm B1 S4096", "absorbed mla", "qwen2-vl G8",
              "musicgen G1")
# Prompt lengths of the prefill shapes the bf16 GEMMs are held and timed
# at (the served prompts of 37, 128 and 1000 tokens).
PREFILL_M = (37, 128, 1000)


def phase(name):
    print(f"== {name} ({time.strftime('%H:%M:%S')})", flush=True)


# The embeds frontend's two tables of a configuration: the train steps'
# (data.pipeline.embed_table of data seed 0, fp32) and the served demo
# table (serve.engine.sample_table, the serve dtype).  Both are
# RandomState(0)'s normal stream times 0.02, in two roundings, so one draw
# of the stream gives both.  qwen2-vl-72b's (152064 x 8192) takes tens of
# seconds on the host: main() starts its draw in a background thread (the
# draw releases the GIL), which the build and the parity checks hide.
TABLE_ROWS = 4096
PREFETCH_TABLES = ("qwen2-vl-72b",)
_TABLES = {}


def draw_embeds_tables(cfg):
    """{"train": embed_table's fp32 numpy table, "serve": sample_table's
    table on the host} of ``cfg``, bit for bit, from one pass over the
    stream in chunks of rows (the legacy normal stream continues across
    calls, and both roundings are elementwise)."""
    rng = np.random.RandomState(0)
    v, d = cfg.vocab_size, cfg.d_model
    train = np.empty((v, d), np.float32)
    serve = torch.empty((v, d), dtype=cfg.dtype())
    for lo in range(0, v, TABLE_ROWS):
        raw = rng.randn(min(TABLE_ROWS, v - lo), d)
        train[lo:lo + len(raw)] = raw.astype(np.float32) * 0.02
        serve[lo:lo + len(raw)] = torch.from_numpy(raw * 0.02).to(cfg.dtype())
    return {"train": train, "serve": serve}


def prefetch_tables(names=PREFETCH_TABLES):
    """Start drawing ``names``' tables in one background thread."""
    pool = concurrent.futures.ThreadPoolExecutor(1)
    for name in names:
        _TABLES[name] = pool.submit(draw_embeds_tables, get_config(name))
    pool.shutdown(wait=False)


def wait_tables():
    """Wait for the background draw to end, so that it runs beside the
    build and the parity checks only, never beside a timed phase or the
    CPU checks' threads."""
    t0 = time.perf_counter()
    for fut in _TABLES.values():
        fut.result()
    print(f"embeds tables {sorted(_TABLES)} ready after a "
          f"{time.perf_counter() - t0:.3f} s wait")


def embeds_table(cfg, kind):
    """``cfg``'s ``kind`` ("train" or "serve") table: the prefetched one
    (waited for, then let go of, so each is held only until its phase
    takes it), else drawn now."""
    t0 = time.perf_counter()
    fut = _TABLES.get(cfg.name)
    tables = fut.result() if fut is not None else draw_embeds_tables(cfg)
    table = tables.pop(kind)
    if fut is not None and not tables:
        del _TABLES[cfg.name]
    print(f"{cfg.name}: the embeds frontend's {kind} table ({cfg.vocab_size}"
          f" x {cfg.d_model}, {table.nbytes / 1e9:.3f} GB) "
          + ("waited for " if fut is not None else "drawn in ")
          + f"{time.perf_counter() - t0:.3f} s"
          + (" (drawn in the background since the start)" if fut is not None
             else ""))
    return table


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
          f"count {torch.cuda.device_count()}; host cores "
          f"{len(os.sched_getaffinity(0))} of {os.cpu_count()}, torch CPU "
          f"threads {torch.get_num_threads()}")
    return line


def build(sources=None):
    phase("build")

    def timed(src):
        t0 = time.perf_counter()
        return _build.build(src), time.perf_counter() - t0

    t0 = time.perf_counter()
    sources = sources or (K.SOURCE, K.DISTANCE_SOURCE, FA.SOURCE,
                          FA.FWD_SOURCE, K.K_OUTER_SOURCE)
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(timed, sources))
    for (path, seconds), src in zip(built, sources):
        parts = _build.PART_SECONDS.get(src.name, [])
        print(f"built {path.name} in {seconds:.3f} s"
              + (f" ({len(parts)} parts side by side, each "
                 + " ".join(f"{p:.1f}" for p in parts) + " s)"
                 if len(parts) > 1 else ""))
    print(f"build wall {time.perf_counter() - t0:.3f} s (one nvcc per "
          "source or part, started together)")


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
        err = check_program(tag, name, m, k, n, od, dtype, gen)
        worst[tag] = max(worst.get(tag, 0.0), err)
    return worst


def check_program(tag, name, m, k, n, od, dtype, gen):
    """One program call on the kernel against its plain version on the
    same operands, its K1 route asserted; returns the max abs error."""
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
    return err


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
    """K2 against its plain version on every case; returns the worst error
    and the wide case's."""
    phase("paged attention parity (kernel vs plain version)")
    gen = torch.Generator(device="cuda").manual_seed(3)
    worst = worst_wide = 0.0
    for name, (lens, page, H, Hkv, D, window) in ATTN_CASES.items():
        Dv = ATTN_DV.get(name, D)
        (pool,), tables, lens_t, unmapped = attn_pool(
            lens, page, Hkv, D, gen, extra_pages=16, Dv=Dv)
        label = (f"{name:17s} B={len(lens)} S={max(lens)} page={page} H={H} "
                 f"Hkv={Hkv} D={D} Dv={Dv} window={window}")
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn(len(lens), H, D, generator=gen,
                            device="cuda").to(dtype)
            wide = FA.route_counts.get(FA.WIDE, 0)
            got, err = check_attn(label, q, pool, tables, lens_t,
                                  window=window)
            if (FA.route_counts.get(FA.WIDE, 0) > wide) != (
                    name == ATTN_WIDE):
                raise AssertionError(f"paged attention {name}: the wide "
                                     "form ran where it should not, or not "
                                     "where it should")
            worst = max(worst, err)
            if name == ATTN_WIDE:
                worst_wide = max(worst_wide, err)
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
    return worst, worst_wide


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


def sampled_row(logits):
    """The logits row the engine samples: the last position's, codebook
    0's with codebook heads (padded vocab included)."""
    row = logits[0, -1]
    return row[0] if row.dim() == 2 else row


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
            self.rows.append(sampled_row(logits).clone())
            return logits, cache

        def decode_step(*a, **k):
            logits, cache = self._orig[1](*a, **k)
            self.rows.append(sampled_row(logits).clone())
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
        served(eng)
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
            served(eng)
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
    check_slab_vs_paged(cfg, runs)
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


def check_slab_vs_paged(cfg, runs):
    """The slab run's and the paged run's prefill logits bit-equal (both
    attend over the unquantized prompt k/v), and their greedy tokens equal
    up to a near tie at the first disagreement (decode attention reads
    int8 pages on the paged path)."""
    reqs = runs[False]["reqs"]
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
            if not gap <= limit and not router_near_tie(
                    cfg, runs, off, off + i):
                raise AssertionError("slab and paged greedy tokens disagree "
                                     "beyond a near tie")
        off += r.max_new_tokens


def router_near_tie(cfg, runs, first, last):
    """For an MoE arch whose runs recorded their routing: whether the
    first routed choice that differs between the slab and the paged run,
    over forward steps ``first``..``last``, was a near tie in the slab
    run (the probabilities of the two swapped experts within 2 TOL_MODEL
    of that token's top probability).  Past a flipped choice the two runs
    compute different expert outputs, so their logits may differ by more
    than the prefill tolerance; the flip itself is what must be a tie."""
    if cfg.moe is None or "routing" not in runs[False]:
        return False
    L = cfg.n_layers
    slab, paged = runs[False]["routing"], runs[True]["routing"]
    for call in range(first * L, (last + 1) * L):
        (pa, ia), (_, ib) = ((t.cpu() for t in c)
                             for c in (slab[call], paged[call]))
        diff = (ia.sort(-1).values != ib.sort(-1).values).any(-1)
        if not bool(diff.any()):
            continue
        t = tuple(int(x) for x in diff.nonzero()[0])
        p = pa[t]
        swapped_out = sorted(set(ia[t].tolist()) - set(ib[t].tolist()))
        swapped_in = sorted(set(ib[t].tolist()) - set(ia[t].tolist()))
        gap = (p[swapped_out].min() - p[swapped_in].max()).item()
        limit = 2 * TOL_MODEL * p.max().item()
        print(f"first routing flip at forward step {call // L}, layer "
              f"{call % L}, token {t}: experts {swapped_out} -> "
              f"{swapped_in}, slab probability gap {gap:.4e} (limit "
              f"{limit:.4e})")
        return gap <= limit
    print("no routing flip before the disagreement")
    return False


class RouteRecorder:
    """While active, keeps every MoE layer's routing (its fp32 router
    probabilities, recomputed beside the layer's own, and top-k expert
    ids) in call order, on the device: no read to the host in the step."""

    def __enter__(self):
        from repro_torch.models import moe as MOE

        self.calls, self._mod = [], MOE
        self._orig = MOE.route

        def route(x, router, cfg):
            top_i, top_w, aux = self._orig(x, router, cfg)
            probs = torch.softmax(torch.einsum(
                "bld,de->ble", x.float(), router.float()), dim=-1)
            self.calls.append((probs, top_i))
            return top_i, top_w, aux

        MOE.route = route
        return self

    def __exit__(self, *exc):
        self._mod.route = self._orig


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
    served(eng)
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
    done = served(eng)
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


# ---------------------------------------------------------------------------
# Observability: the serve path with the ledger and the trace on
# ---------------------------------------------------------------------------

# The weights K1 launches read (the ``core.gemm`` callers of a dense GQA
# model): projections, the GLU's two, w_down, the 2-D logits head.
K1_WEIGHTS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
OBS_NEW_TOKENS = 16
OBS_TURNS = ("off", "on", "on", "off")


def k1_weight_bytes(params):
    return sum(t.numel() * t.element_size() for name, t in params.items()
               if name.split("/")[-1] in K1_WEIGHTS or name == "head/w")


def decode_split(program):
    """One decode step's planned GEMM bytes split as the ledger composes
    them: the B stream (the weights, once at m <= bm), the A panel's
    re-reads (once per bn columns) and the rest (outputs, epilogue reads,
    the rms vectors); and its attention records' KV bytes apart."""
    b_term = a_term = 0.0
    gemms = [r for r in program if isinstance(r, obs.GemmRecord)]
    attn = sum(r.planned_bytes * r.calls for r in program
               if isinstance(r, obs.AttnRecord))
    for r in gemms:
        it = 2 if r.dtype == "bfloat16" else 4
        mnk = r.m * r.n * r.k
        b_term += r.calls * mnk * program_cost(r.tag).n_b * it / min(
            r.config["bm"], r.m)
        a_term += r.calls * mnk * it / min(r.config["bn"], r.n)
    planned = sum(r.planned_bytes * r.calls for r in gemms)
    return planned, b_term, a_term, planned - b_term - a_term, attn


def obs_phase(cfg, device=None):
    """Full-width stablelm-1.6b, bf16, slab and paged, served with the
    GEMM ledger and tracing on: the engine's metrics report, each step
    label's ledger aggregates, the trace's span counts, one decode step's
    planned bytes beside its weight bytes, the ledger's GEMM calls against
    K1's launches; then the decode ms/token of one engine with obs off and
    on, in turns."""
    phase("obs: stablelm-1.6b slab and paged with the ledger and tracing")
    params = M.init_params(cfg, seed=0, device=device)
    weights = k1_weight_bytes(params)
    # wq, wk, wv, wo, the GLU and w_down a layer, and the head: 145 for
    # stablelm-1.6b's 24 layers.
    per_step = 6 * cfg.n_layers + 1
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in (128, 37, 8)]
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    led = obs.enable_ledger()
    res = {}
    for paged in (False, True):
        mode = "paged" if paged else "slab"
        trace = out_dir / f"obs_trace_{mode}.jsonl"
        check_guarded(f"obs {mode}: before the reset")
        obs.reset_metrics()
        led.reset()
        obs.enable_tracing(str(trace))
        eng = ServeEngine(params, cfg, max_len=160, paged_kv=paged,
                          device=device)
        for uid, p in enumerate(prompts):
            eng.submit(Request(uid=uid, prompt=p,
                               max_new_tokens=OBS_NEW_TOKENS))
        K.reset_launch_counts()
        FA.reset_launch_counts()
        done = served(eng)
        _sync(params["head/w"].device)
        launches = sum(K.launch_counts.values())
        obs.disable_tracing()
        print(f"-- {mode} metrics_report\n{eng.metrics_report()}")
        steps = led.steps_summary()
        for label in ("prefill", "decode"):
            agg = steps[label]
            print(f"ledger {mode} {label}: steps {agg['steps']}, gemm calls "
                  f"{agg['gemm_calls']}, attn calls {agg['attn_calls']}, "
                  f"planned {agg['planned_bytes'] / 1e9:.6f} GB, achieved "
                  f"{agg['achieved_gbps']:.3f} GB/s, model error "
                  f"{agg['model_error']:.3f}x")
            if not (agg["achieved_gbps"] > 0 and agg["model_error"] > 0):
                raise AssertionError(f"{mode} {label}: {agg}")
        calls = sum(a["gemm_calls"] for a in steps.values())
        if params["head/w"].is_cuda and calls != launches:
            raise AssertionError(f"{mode}: ledger gemm calls {calls} != "
                                 f"K1 launches {launches}")
        program = led._programs["decode"]
        step_calls = sum(r.calls for r in program
                         if isinstance(r, obs.GemmRecord))
        if step_calls != per_step:
            raise AssertionError(f"{mode}: a decode step records "
                                 f"{step_calls} GEMM calls, not {per_step}")
        if paged and steps["decode"]["attn_calls"] != \
                cfg.n_layers * steps["decode"]["steps"]:
            raise AssertionError(f"paged attention records {steps}")
        planned, b_term, a_term, rest, attn = decode_split(program)
        print(f"decode step planned GEMM bytes {planned / 1e9:.6f} GB "
              f"({mode}): weights by the plan {b_term / 1e9:.6f} GB, A "
              f"re-reads {a_term / 1e9:.6f} GB ({a_term / b_term:.4%} of "
              f"the weights), outputs/epilogue/norm {rest / 1e9:.6f} GB; "
              f"K1 weight bytes from the params {weights / 1e9:.6f} GB "
              f"(PERF.md: 2.88 GB); paged attention KV "
              f"{attn / 1e9:.6f} GB")
        if abs(b_term - weights) > 1e-9 * weights or planned < weights:
            raise AssertionError(f"planned {planned} vs weights {weights}")
        mets = eng.metrics_snapshot()["metrics"]
        for name in ("serve.ttft_seconds", "serve.tpot_seconds"):
            if not mets[name]["count"] or mets[name]["min"] <= 0:
                raise AssertionError(f"{name}: {mets[name]}")
        spans = collections.Counter(e["name"] for e in
                                    obs.read_trace(str(trace)))
        print(f"trace {mode} spans: {dict(sorted(spans.items()))}")
        want = {"serve.request": 3, "serve.prefill": 3, "serve.decode": 3,
                "serve.warmup": 1}
        if any(spans[k] != v for k, v in want.items()):
            raise AssertionError(f"{mode} spans {spans}")
        for r in done.values():
            if r.status != "done" or len(r.generated) != OBS_NEW_TOKENS:
                raise AssertionError(f"{mode} request {r.uid}: {r.status}")
        res[mode] = {
            "ttft_p50_s": mets["serve.ttft_seconds"]["p50"],
            "ttft_p99_s": mets["serve.ttft_seconds"]["p99"],
            "tpot_p50_s": mets["serve.tpot_seconds"]["p50"],
            "tpot_p99_s": mets["serve.tpot_seconds"]["p99"],
            "tokens_per_s": mets["serve.tokens_per_second"]["value"],
            "warmup_s": mets["serve.warmup_seconds"]["value"],
            "steps": {k: {f: v[f] for f in (
                "steps", "gemm_calls", "attn_calls", "planned_bytes",
                "achieved_gbps", "model_error")} for k, v in steps.items()},
            "decode_planned_bytes": planned, "decode_a_rereads": a_term,
            "decode_attn_kv_bytes": attn,
            "k1_weight_bytes": weights, "spans": dict(spans)}
        del eng
    # The same engine with obs off and on, in turns: decode ms/token.
    eng = ServeEngine(params, cfg, max_len=160, device=device)
    prompt = np.random.RandomState(8).randint(0, cfg.vocab_size, 37)
    turns = []
    for i, state in enumerate(OBS_TURNS):
        if state == "on":
            led.enable()
            obs.enable_tracing(str(out_dir / f"obs_trace_turn{i}.jsonl"))
        else:
            led.disable()
            obs.disable_tracing()
        eng.submit(Request(uid=100 + i, prompt=prompt,
                           max_new_tokens=OBS_NEW_TOKENS))
        r = served(eng)[100 + i]
        _sync(params["head/w"].device)
        turns.append((state, r.decode_s * 1e3 / (OBS_NEW_TOKENS - 1)))
    led.disable()
    obs.disable_tracing()
    print("decode ms/token obs off/on in turns: " + ", ".join(
        f"{st} {ms:.3f}" for st, ms in turns))
    res["turns"] = turns
    del eng, params
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return res


def _device_us(event):
    t = getattr(event, "self_device_time_total", None)
    return t if t is not None else event.self_cuda_time_total


def decode_run(params, cfg, steps, paged=False, prof=None, device="cuda",
               table=None):
    """A 37-token prefill (``max_len`` 160), then ``steps`` greedy decode
    steps on the slab cache or (``paged``) on a paged int8 cache of the
    analytic page; ``prof`` (a torch.profiler) records only the steps.
    ``table`` feeds an embeds-frontend arch (the engine's demo table).
    Returns the steps' wall seconds."""
    prompt = torch.as_tensor(np.random.RandomState(2).randint(
        0, cfg.vocab_size, 37), device=device)[None]
    with torch.inference_mode():
        cache = None
        if paged:
            page = resolve_page_size(
                heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
                head_dim=cfg.resolved_head_dim,
                seq_len=160).config.kv_block
            n_pages = kvc.pages_for(160, page)
            cache = M.make_paged_model_cache(
                cfg, 1, n_pages=n_pages, page_size=page, max_pages=n_pages,
                device=device)
            kvc.model_assign_sequence(cache, 0, list(range(n_pages)))
        logits, cache = M.prefill(params, model_inputs(cfg, prompt, table),
                                  cfg, max_len=160, cache=cache)
        nxt = int(torch.argmax(sampled_row(logits)[:cfg.vocab_size]))
        _sync(device)
        if prof is not None:
            prof.start()
        t0 = time.perf_counter()
        for s in range(steps):
            logits, cache = M.decode_step(
                params, model_inputs(cfg, torch.full((1, 1), nxt,
                                                     device=device), table),
                cache, prompt.shape[1] + s, cfg)
            nxt = int(torch.argmax(sampled_row(logits)[:cfg.vocab_size]))
        _sync(device)
        wall = time.perf_counter() - t0
        if prof is not None:
            prof.stop()
    return wall


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def profile_decode(params, cfg, steps=8, paged=False, table=None):
    """Device time by kernel over ``steps`` decode steps (torch.profiler),
    and the unprofiled wall time of the same steps, on the slab cache or
    (``paged``) on the paged int8 cache."""
    from torch.profiler import ProfilerActivity, profile

    wall = decode_run(params, cfg, steps, paged, table=table)
    # CUDA activity alone: only the kernels' device times are read, and
    # recording every host op as well multiplies key_averages' time.
    prof = profile(activities=[ProfilerActivity.CUDA])
    decode_run(params, cfg, steps, paged, prof, table=table)
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


def card_vs_cpu(p_gpu, p_cpu, cfg4, label="", table=None):
    """The same parameters on the card and on the CPU: prefill logits
    within TOL_MODEL, greedy tokens equal up to a near tie.  ``table``
    (on the card) feeds an embeds-frontend arch on both."""
    prompt = np.random.RandomState(1).randint(0, cfg4.vocab_size, 12)
    toks = torch.as_tensor(prompt)[None]
    tables = {"cuda": table, "cpu": None if table is None else table.cpu()}
    with torch.inference_mode():
        lg, _ = M.prefill(p_gpu, model_inputs(cfg4, toks.cuda(),
                                              tables["cuda"]),
                          cfg4, max_len=32)
        lc, _ = M.prefill(p_cpu, model_inputs(cfg4, toks, tables["cpu"]),
                          cfg4, max_len=32)
    err = (lg.cpu() - lc).abs().max().item()
    scale = lc.abs().max().item()
    print(f"{label}prefill logits max_abs_err={err:.4e} "
          f"max|cpu|={scale:.4e} tol={TOL_MODEL * scale:.4e}")
    if not (bool(torch.isfinite(lg).all()) and err <= TOL_MODEL * scale):
        raise AssertionError(f"{label}card and CPU prefill logits disagree")
    outs = []
    for params, dev in ((p_gpu, None), (p_cpu, "cpu")):
        eng = ServeEngine(params, cfg4, max_len=32, device=dev,
                          sample_table=tables[dev or "cuda"])
        eng.submit(Request(uid=1, prompt=prompt, max_new_tokens=8))
        outs.append(served(eng)[1].generated)
    agree = sum(a == b for a, b in zip(*outs))
    print(f"{label}greedy tokens card={outs[0]} cpu={outs[1]} "
          f"agreement={agree}/{len(outs[0])}")
    if outs[0] != outs[1]:
        # Past the first disagreement the two runs decode different
        # sequences; at it, the card's pick must be a near tie on the CPU.
        i = next(j for j, (a, b) in enumerate(zip(*outs)) if a != b)
        seq = torch.as_tensor(np.concatenate(
            [prompt, np.asarray(outs[1][:i], dtype=prompt.dtype)]))[None]
        with torch.inference_mode():
            row, _ = M.prefill(p_cpu, model_inputs(cfg4, seq, tables["cpu"]),
                               cfg4, max_len=32)
        row = sampled_row(row)[:cfg4.vocab_size]
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
    for name in ATTN_TIMED + (ATTN_WIDE,):
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
        served(eng)
        reqs = [Request(uid=i + 1, prompt=p, max_new_tokens=16)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        K.reset_launch_counts()
        t0 = time.perf_counter()
        served(eng)
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
# Robustness: faults, admission, preflight, checkpoint and resume
# ---------------------------------------------------------------------------

# The chaos serve's requests (prompt lengths; 8 new tokens each) and plan:
# dispatch 0 is request 0's first GEMM (fatal), dispatch 1 request 1's
# first (recoverable: counted, then the same kernel launched), decode step 7
# request 2's first (requests 0 and 1 took 0 and 7 steps): NaN logits walk
# it from int8w to dense.
CHAOS_PROMPTS = (128, 37, 8, 8)
CHAOS_NEW = 8
CHAOS_PLAN = dict(kernel_fatal_at=(0,), kernel_fail_at=(1,),
                  nan_decode_at=(7,))
# The paged admission case: (prompt, new tokens, max_retries) of 5 submits
# into a pool of two sequences' pages, max_queue 2, shed_oldest; the third
# asks for more pages than a sequence may hold.
ADMISSION = ((37, 8, 0), (8, 8, 0), (200, 8, 0), (128, 8, 1), (8, 8, 0))
ADMISSION_MAX_LEN = 160
# The checkpoint case: full width, 2 layers, 3 steps of 4 x 256 tokens.
CKPT_LAYERS = 2


def metric_value(name, label=None):
    """A counter's total, or one labelled child's value (0 if absent)."""
    snap = obs.get_metrics().snapshot().get(name, {})
    if label is None:
        return snap.get("value", 0)
    return snap.get("labels", {}).get(label, 0)


# Counters that read 0 wherever no fault plan is active: a request that
# failed or stepped down the ladder, a plan the preflight refused, a GEMM
# re-dispatched after an injected failure.
GUARDED = ("serve.requests_failed_total", "serve.degraded_total",
           "analyze.violations_total", "gemm.fallback_total")
# What the robust phase's plans leave in them: chaos request 0 failed,
# request 2 stepped down once, request 1's GEMM re-dispatched once, the
# poisoned tuning-cache entry refused once (SMEM001; its repeat comes from
# the memo and is not counted again).
ROBUST_GUARDED = {"serve.requests_failed_total": 1,
                  "serve.degraded_total": 1,
                  "analyze.violations_total": 1,
                  "gemm.fallback_total": 1}


def check_guarded(where, want=None):
    """The GUARDED counters read ``want`` (default all 0); raises, naming
    ``where``, before a reset could wipe a phase's failures."""
    want = want or dict.fromkeys(GUARDED, 0)
    got = {n: metric_value(n) for n in GUARDED}
    if got != want:
        snap = obs.get_metrics().snapshot()
        raise AssertionError(f"{where}: guarded counters {got}, expected "
                             f"{want}: " + json.dumps(
                                 {n: snap.get(n) for n in GUARDED}))
    return got


def served(eng):
    """``eng.run()``, raising unless every request it holds is done (a
    request the engine isolated as failed, degraded or rejected would not
    stop ``run()``)."""
    done = eng.run()
    bad = {u: (r.status, r.error) for u, r in done.items()
           if r.status != "done"}
    if bad:
        raise AssertionError(f"requests not done: {bad}")
    return done


class StepLaunches:
    """While active, wraps M.prefill and M.decode_step (the engine calls
    them through the module) and keeps the K1 launches of each forward
    step that returned."""

    def __enter__(self):
        self.steps = []
        self._orig = (M.prefill, M.decode_step)

        def wrap(fn):
            def run(*a, **k):
                before = sum(K.launch_counts.values())
                out = fn(*a, **k)
                self.steps.append(sum(K.launch_counts.values()) - before)
                return out
            return run

        M.prefill, M.decode_step = wrap(self._orig[0]), wrap(self._orig[1])
        return self

    def __exit__(self, *exc):
        M.prefill, M.decode_step = self._orig


class LaunchShapes:
    """While active, wraps K1's launcher and keeps each launch's route,
    program, operand dtypes, shape and scale block, to hold the launcher's
    dynamic shared memory against kernels.ca_mmm.route_smem_bytes."""

    def __enter__(self):
        self.seen = set()
        self._orig = K._launch

        def launch(a, bs, spec, out_dtype, row_scale, gain, branch_operands,
                   m, n, k, scale_b_block, scale_a_block, transpose_a,
                   transpose_b, save_preact, preact, tile=None):
            layout = K.layout_tag(transpose_a, transpose_b)
            route = K.k1_route(spec, layout, a.dtype, bs[0].dtype, m, n, k,
                               K.tma_aligned(a, *bs, preact),
                               save_preact=save_preact)
            self.seen.add((route, spec.tag(), a.dtype, bs[0].dtype, m, n, k,
                           scale_b_block or scale_a_block))
            return self._orig(a, bs, spec, out_dtype, row_scale, gain,
                              branch_operands, m, n, k, scale_b_block,
                              scale_a_block, transpose_a, transpose_b,
                              save_preact, preact, tile)

        K._launch = launch
        return self

    def __exit__(self, *exc):
        K._launch = self._orig


def first_disagreement(label, got, want, rows, vocab):
    """Greedy tokens ``got`` against ``want`` up to a near tie: at the
    first token that differs, ``want``'s run's logit gap to ``got``'s pick
    is within 2 TOL_MODEL of that row's largest |logit| (``rows``: that
    run's sampled rows, in order)."""
    if got == want:
        return 0.0
    i = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
    row = rows[i][:vocab].float()
    gap = (row.max() - row[got[i]]).item()
    limit = 2 * TOL_MODEL * row.abs().max().item()
    print(f"{label}: first disagreement at token {i}: logit gap {gap:.4e} "
          f"(limit {limit:.4e})")
    if not gap <= limit:
        raise AssertionError(f"{label}: tokens {got} vs {want} disagree "
                             "beyond a near tie")
    return gap


def chaos_serve(cfg):
    """Full-width int8w stablelm-1.6b serves CHAOS_PROMPTS under
    CHAOS_PLAN beside a fault-free engine on the same params."""
    from repro_torch.core.gemm import gemm_fallback
    from repro_torch.runtime.fault import FaultPlan

    params = M.init_params(cfg, seed=0)
    qparams = CM.quantize_params(params)
    del params
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in CHAOS_PROMPTS]

    def reqs():
        return [Request(uid=u, prompt=p, max_new_tokens=CHAOS_NEW)
                for u, p in enumerate(prompts)]

    clean = ServeEngine(qparams, cfg, max_len=160)
    for r in reqs():
        clean.submit(r)
    with Recorder() as rec_clean:
        want = served(clean)
    base = {n: metric_value(n) for n in (
        "serve.requests_total", "serve.requests_failed_total",
        "serve.degraded_total", "gemm.fallback_total")}
    eng = ServeEngine(qparams, cfg, max_len=160)
    for r in reqs():
        eng.submit(r)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    with gemm_fallback(True), FaultPlan(**CHAOS_PLAN) as plan, \
            StepLaunches() as steps, Recorder() as rec_chaos:
        done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    statuses = [done[u].status for u in range(4)]
    print(f"chaos statuses {statuses}; injected {sorted(plan.injected)}; "
          f"attempts {[done[u].attempts for u in range(4)]}; errors "
          f"{[done[u].error for u in range(4)]}")
    if statuses != ["failed", "degraded", "degraded", "done"]:
        raise AssertionError(f"chaos statuses {statuses}")
    if sorted(plan.injected) != [("kernel", 1), ("kernel_fatal", 0),
                                 ("nan", 7)]:
        raise AssertionError(f"injected {plan.injected}")
    if not done[0].error.startswith("kernel: injected fatal") \
            or done[0].generated != []:
        raise AssertionError(f"request 0: {done[0].error}")
    if done[1].fallbacks != 1 or done[1].degraded_to is not None:
        raise AssertionError(f"request 1: {done[1].fallbacks} fallbacks")
    if (done[2].degraded_to, done[2].quant_level, done[2].attempts) != (
            "dense", "dense", 2):
        raise AssertionError(f"request 2: {done[2]}")
    if done[3].generated != want[3].generated:
        raise AssertionError(f"request 3: {done[3].generated} vs "
                             f"{want[3].generated}")
    counters = {
        "failed_kernel": metric_value("serve.requests_failed_total",
                                      "reason=kernel"),
        "fallback": metric_value("gemm.fallback_total") - base[
            "gemm.fallback_total"],
        "fallback_stage": obs.get_metrics().snapshot()[
            "gemm.fallback_total"].get("labels", {}),
        "degraded_int8w_dense": metric_value(
            "serve.degraded_total", "from=int8w,to=dense"),
        "served": metric_value("serve.requests_total") - base[
            "serve.requests_total"],
        "fault_events": obs.get_metrics().snapshot()[
            "fault.events_total"]["labels"]}
    print("chaos counters " + json.dumps(counters))
    want_counters = (1, 1, 1, 3, {"kind=injected:kernel": 1.0,
                                  "kind=injected:kernel_fatal": 1.0,
                                  "kind=injected:nan": 1.0})
    if (counters["failed_kernel"], counters["fallback"],
            counters["degraded_int8w_dense"], counters["served"],
            counters["fault_events"]) != want_counters:
        raise AssertionError(f"chaos counters {counters}")
    # Request 1's failed dispatch launched its kernel again on the card:
    # its tokens and every sampled row equal the fault-free run's bits.
    rows1 = rec_chaos.rows[:CHAOS_NEW]
    rows1_clean = rec_clean.rows[CHAOS_NEW:2 * CHAOS_NEW]
    if done[1].generated != want[1].generated or not all(
            torch.equal(a, b) for a, b in zip(rows1, rows1_clean)):
        raise AssertionError(f"request 1: {done[1].generated} vs "
                             f"{want[1].generated} (rows bit-equal: "
                             f"{[torch.equal(a, b) for a, b in zip(rows1, rows1_clean)]})")
    # Request 2's dense attempt against a bf16 engine on the dense rung's
    # params (the int8 weights dequantized).
    dense = ServeEngine(eng._params_for("dense"), cfg, max_len=160)
    dense.submit(reqs()[2])
    with Recorder() as rec_dense:
        want2 = served(dense)[2].generated
    gap2 = first_disagreement("request 2 dense vs bf16 engine",
                              done[2].generated, want2, rec_dense.rows,
                              cfg.vocab_size)
    # Launches: request 0 none, every other forward step 145 (request
    # 1's failed dispatch launched once, on its re-dispatch).
    want_steps = [145] * CHAOS_NEW + [145, 145] + [145] * CHAOS_NEW * 2
    print(f"chaos K1 launches by forward step {steps.steps}")
    if steps.steps != want_steps:
        raise AssertionError(f"chaos launches by step {steps.steps}, "
                             f"expected {want_steps}")
    out = {"statuses": statuses, "wall_s": wall, "counters": counters,
           "request1_bit_equal": True, "request2_gap": gap2,
           "request2_equal_bf16": done[2].generated == want2}
    del clean, eng, dense, qparams
    torch.cuda.empty_cache()
    return out


def paged_admission(cfg):
    """Full-width bf16 stablelm-1.6b on a paged pool of two sequences'
    pages, max_queue 2, shed_oldest: ADMISSION's 5 submits, then a run in
    which request 3's first decode step fails transiently and its one
    retry succeeds; no page leaks."""
    from repro_torch.runtime.fault import FaultPlan

    params = M.init_params(cfg, seed=0)
    page = resolve_page_size(heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
                             head_dim=cfg.resolved_head_dim,
                             seq_len=ADMISSION_MAX_LEN).config.kv_block
    per_seq = kvc.pages_for(ADMISSION_MAX_LEN, page)
    eng = ServeEngine(params, cfg, max_len=ADMISSION_MAX_LEN, paged_kv=True,
                      kv_pool_pages=2 * per_seq, max_queue=2,
                      overflow="shed_oldest", retry_backoff_s=0.01)
    rng = np.random.RandomState(11)
    admitted = []
    for uid, (n, new, retries) in enumerate(ADMISSION):
        admitted.append(eng.submit(Request(
            uid=uid, prompt=rng.randint(0, cfg.vocab_size, n),
            max_new_tokens=new, max_retries=retries)))
    rejected = {u: eng.done[u].error for u in sorted(eng.done)}
    print(f"admission: page {page}, pool {eng.kv_pool.n_pages} pages, "
          f"per-seq cap {eng.kv_max_pages_per_seq}; admitted {admitted}; "
          f"queue {[r.uid for r in eng.queue]}; rejected {rejected}")
    if admitted != [True, True, False, True, True] \
            or [r.uid for r in eng.queue] != [3, 4] \
            or sorted(rejected) != [0, 1, 2] \
            or not rejected[2].startswith("kv pages"):
        raise AssertionError("admission outcomes")
    K.reset_launch_counts()
    FA.reset_launch_counts()
    with FaultPlan(transient_decode_at=(0,)) as plan:
        done = eng.run()
    torch.cuda.synchronize()
    k2 = FA.launch_counts.get(FA.NAME, 0)
    decodes = sum(ADMISSION[u][1] - 1 for u in (3, 4))
    out = {"rejected": {"kv_pages": metric_value(
        "serve.rejected_total", "policy=kv_pages"),
        "shed_oldest": metric_value("serve.rejected_total",
                                    "policy=shed_oldest")},
        "retries": metric_value("serve.retries_total"),
        "attempts": {u: done[u].attempts for u in (3, 4)},
        "statuses": {u: done[u].status for u in sorted(done)},
        "free_pages": eng.kv_pool.n_free, "pages": eng.kv_pool.n_pages,
        "k2_launches": k2, "injected": plan.injected}
    print("admission run " + json.dumps(out, default=str))
    if out["rejected"] != {"kv_pages": 1, "shed_oldest": 2} \
            or out["retries"] != 1 or out["attempts"] != {3: 2, 4: 1} \
            or [done[u].status for u in (3, 4)] != ["done", "done"] \
            or eng.kv_pool.n_free != eng.kv_pool.n_pages \
            or k2 != cfg.n_layers * decodes:
        raise AssertionError(f"admission run {out}")
    del eng, params
    torch.cuda.empty_cache()
    return out


def poisoned_cache():
    """A tuning-cache entry over shared memory raises
    ProgramValidationError (SMEM001) at dispatch, before any launch."""
    from repro_torch.analyze import ProgramValidationError
    from repro_torch.core.gemm import ca_matmul
    from repro_torch.tuning import registry as TREG
    from repro_torch.tuning.cache import CacheEntry, TuningCache, cache_key

    m, n, k = 96, 1536, 1024
    x = torch.randn(m, k, device="cuda", dtype=torch.bfloat16)
    w = torch.randn(k, n, device="cuda", dtype=torch.bfloat16)
    prev = TREG.get_registry()
    d = ROOT / "build" / "poisoned_cache.json"
    reg = TREG.KernelRegistry(cache=TuningCache(d, autosave=False),
                              autotune_enabled=False)
    TREG.set_registry(reg)
    codes = []
    try:
        reg.cache.put(cache_key(m, n, k, "bfloat16", hw=reg.hw),
                      CacheEntry(bm=16384, bn=16384, bk=16384,
                                 measured_s=1e-3))
        before = sum(K.launch_counts.values())
        for _ in range(2):   # the second raise comes from the memo
            try:
                ca_matmul(x, w)
            except ProgramValidationError as e:
                codes.append(e.codes)
        moved = sum(K.launch_counts.values()) - before
    finally:
        TREG.set_registry(prev)
    print(f"poisoned cache entry: codes {codes}, K1 launches moved by "
          f"{moved}")
    if codes != [("SMEM001",), ("SMEM001",)] or moved:
        raise AssertionError("the poisoned cache entry was not refused "
                             "before its launch")
    return {"codes": codes[0], "launches_moved": moved}


def guard_overhead(cfg, device="cuda", iters=20000):
    """Host seconds this slice adds to a fault-free dispatch, at the decode
    wq signature (m = 1, d_model x d_model, rms prologue): the fault hook's
    wrapper with no plan active (around a dispatch that does nothing) and a
    memoized preflight hit; then both times the GEMM dispatches of one
    decode step (6 a layer and the head)."""
    from repro_torch.core import gemm as G
    from repro_torch.kernels.epilogue import IDENTITY

    d = cfg.d_model
    x = torch.zeros(1, d, device=device, dtype=torch.bfloat16)
    res, tag = G._dense_plan(1, d, d, torch.bfloat16, IDENTITY, True)
    G._preflight(res, tag, 1, d, d, torch.bfloat16)   # fills the memo

    def noop(t):
        return t

    t0 = time.perf_counter()
    for _ in range(iters):
        G._dispatch("matmul", noop, x)
    hook = (time.perf_counter() - t0) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        G._preflight(res, tag, 1, d, d, torch.bfloat16)
    pre = (time.perf_counter() - t0) / iters
    per_step = 6 * cfg.n_layers + 1
    step_ms = (hook + pre) * per_step * 1e3
    print(f"guard host cost a dispatch: fault hook {hook * 1e6:.3f} us, "
          f"preflight memo hit {pre * 1e6:.3f} us; x {per_step} GEMM "
          f"dispatches = {step_ms:.4f} ms a decode step")
    return {"hook_us": hook * 1e6, "preflight_us": pre * 1e6,
            "dispatches_a_step": per_step, "ms_a_decode_step": step_ms}


def check_launch_smem(seen):
    """For every K1 launch signature the phase made: the dynamic shared
    memory the built launcher computes equals route_smem_bytes."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for route, tag, a_dt, b_dt, m, n, k, block in sorted(seen, key=str):
        spec = program_from_tag(tag)
        got = K.launch_smem_bytes(route, spec, a_dt, b_dt, m, n, k, block)
        want = K.route_smem_bytes(route, spec, a_dt, b_dt, m=m, n=n, k=k,
                                  scale_block=block, sms=sms)
        rows.append((route, tag, str(a_dt), str(b_dt), m, n, k, got, want))
        if got != want:
            raise AssertionError(f"{route} {tag} {a_dt} {b_dt} m={m} n={n} "
                                 f"k={k}: launcher {got} B, route_smem_bytes"
                                 f" {want} B")
    by_route = collections.Counter(r[0] for r in rows)
    print(f"launch shared memory equal to route_smem_bytes for "
          f"{len(rows)} signatures ({dict(by_route)}; {sms} SMs, target "
          f"{H100.sms}); largest {max(r[7] for r in rows)} B")
    return {"signatures": len(rows), "by_route": dict(by_route),
            "sms": sms, "max_bytes": max(r[7] for r in rows)}


def checkpoint_resume(cfg):
    """Full width, CKPT_LAYERS layers, fp32 masters and AdamW: 3 steps
    uninterrupted, then with a checkpoint every step (async), a crash after
    step 2 has run and a resume from step 1's checkpoint; step 2's loss and
    every leaf after it bit-equal.  Then restore_quantized of the last
    checkpoint serves one request, against quantize_params of the
    uninterrupted state."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint import manager as CKM
    from repro_torch.launch.train import run_training

    kw = dict(full=True, layers=CKPT_LAYERS, seq_len=SEQ_LEN,
              global_batch=GLOBAL_BATCH, log_every=100)
    want, want_losses = run_training(ARCH, 3, **kw)
    torch.cuda.synchronize()
    tmp = tempfile.mkdtemp(prefix="robust_ckpt_", dir=ROOT / "build")
    times = {"save": [], "write": []}
    orig = (CKM.CheckpointManager.save, CKM.CheckpointManager._write)

    def timed(key, fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            times[key].append(time.perf_counter() - t0)
            return out
        return run

    try:
        CKM.CheckpointManager.save = timed("save", orig[0])
        CKM.CheckpointManager._write = timed("write", orig[1])
        try:
            run_training(ARCH, 3, ckpt_dir=tmp, ckpt_every=1, fail_at=2,
                         **kw)
        except RuntimeError as e:
            if "injected failure at step 2" not in str(e):
                raise
        else:
            raise AssertionError("the injected crash did not fire")
        mgr = CheckpointManager(tmp)
        if mgr.latest_step() != 1:
            raise AssertionError(f"latest step {mgr.latest_step()}")
        got, losses = run_training(ARCH, 3, ckpt_dir=tmp, ckpt_every=1,
                                   resume=True, **kw)
        torch.cuda.synchronize()
        CKM.CheckpointManager.save, CKM.CheckpointManager._write = orig
        if losses != want_losses[2:]:
            raise AssertionError(f"resumed losses {losses} vs "
                                 f"{want_losses[2:]}")
        leaves = 0
        for a, b in ((got.params, want.params), (got.opt.m, want.opt.m),
                     (got.opt.v, want.opt.v)):
            for k in b:
                leaves += 1
                if not torch.equal(a[k], b[k]):
                    raise AssertionError(f"leaf {k} differs after resume")
        if int(got.step) != 3 or not torch.equal(got.opt.count,
                                                 want.opt.count):
            raise AssertionError("step counters differ after resume")
        step = mgr.latest_step()
        d = pathlib.Path(mgr._step_dir(step))
        gb = sum(f.stat().st_size for f in d.iterdir()) / 1e9
        t0 = time.perf_counter()
        if not mgr.verify_step(step):
            raise AssertionError(f"step {step} does not verify")
        verify_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        restored = mgr.restore(want)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        if not all(torch.equal(restored.params[k], got.params[k])
                   for k in got.params):
            raise AssertionError("restore differs from the saved state")
        del restored
        cfg2 = dataclasses.replace(cfg, n_layers=CKPT_LAYERS)
        like = M.init_params(cfg2, seed=1)
        t0 = time.perf_counter()
        qp = mgr.restore_quantized(like, subtree="params")
        torch.cuda.synchronize()
        restore_q_s = time.perf_counter() - t0
        qwant = CM.quantize_params({k: want.params[k].to(like[k].dtype)
                                    for k in like})
        prompt = np.random.RandomState(3).randint(0, cfg.vocab_size, 37)
        outs = []
        for p in (qp, qwant):
            eng = ServeEngine(p, cfg2, max_len=64)
            eng.submit(Request(uid=0, prompt=prompt, max_new_tokens=8))
            r = eng.run()[0]
            if r.status != "done":
                raise AssertionError(f"restored serve: {r.status}")
            outs.append(r.generated)
        print(f"restore_quantized serve tokens {outs[0]} vs quantize_params"
              f" {outs[1]}")
        if outs[0] != outs[1]:
            raise AssertionError("restore_quantized tokens differ")
    finally:
        CKM.CheckpointManager.save, CKM.CheckpointManager._write = orig
        shutil.rmtree(tmp, ignore_errors=True)
    out = {"losses": want_losses, "leaves_bit_equal": leaves,
           "checkpoint_gb": gb, "saves": len(times["save"]),
           "save_call_s": times["save"], "write_s": times["write"],
           "verify_s": verify_s, "restore_s": restore_s,
           "restore_quantized_s": restore_q_s, "tokens": outs[0]}
    print("checkpoint " + json.dumps(out))
    del want, got, qp, qwant, like
    torch.cuda.empty_cache()
    return out


def robust_phase(cfg):
    phase("robust: chaos serve, paged admission, preflight, checkpoint and "
          "resume")
    from repro_torch.analyze import preflight_stats

    t0 = time.perf_counter()
    check_guarded("robust: before the reset")
    obs.reset_metrics()
    with LaunchShapes() as shapes:
        chaos = chaos_serve(cfg)
        admission = paged_admission(cfg)
        stats = preflight_stats()
        print(f"preflight after the serve phases {stats}")
        if stats["validated"] <= 0 or metric_value(
                "analyze.violations_total"):
            raise AssertionError(f"preflight {stats}, violations "
                                 f"{metric_value('analyze.violations_total')}")
        poisoned = poisoned_cache()
        ckpt = checkpoint_resume(cfg)
    smem = check_launch_smem(shapes.seen)
    overhead = guard_overhead(cfg)
    print("robust guarded counters " + json.dumps(
        check_guarded("robust: after its plans", ROBUST_GUARDED)))
    out = {"chaos": chaos, "admission": admission, "preflight": stats,
           "poisoned": poisoned, "smem": smem, "checkpoint": ckpt,
           "guard_overhead": overhead,
           "phase_s": time.perf_counter() - t0}
    print(f"robust phase {out['phase_s']:.1f} s")
    return out


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


def k1f_parity(cases=None, label="training programs", seed=8):
    """Each case (key, GEMM, m, n, k, out dtype, dtype; default stablelm's
    shapes in bf16 and a ragged fp32 one a key) on the kernel against its
    plain version, its route asserted and printed: wgmma for bf16, whose
    operands here are 16-byte aligned, at m > 8, SIMT for fp32.  Returns
    the worst error by (key, GEMM)."""
    phase(f"K1f parity: {label} vs plain version")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    worst = {}
    if cases is None:
        cases = [(key, name, m, n, k, od, torch.bfloat16)
                 for key, name, m, n, k, od in K1F_GEMMS]
        cases += [(key, "ragged f32", 37, 64, 50, None, torch.float32)
                  for key in dict.fromkeys(g[0] for g in K1F_GEMMS)]
    for key, name, m, n, k, od, dtype in cases:
        a, (bs,), kw = k1f_inputs(key, m, n, k, dtype, gen)
        route = want_route(dtype, m)
        before = dict(K.route_counts)
        got = K.ca_gemm_program(a, bs, out_dtype=od, **kw)
        check_routes(f"{key} {name}", route_delta(before),
                     {f"{route} {key}": 1})
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
            worst[key, name] = max(worst.get((key, name), 0.0), err)
        print(f"parity {key:38s} {name:24s} m={m:<5d} n={n:<6d} k={k:<6d} "
              f"{str(dtype)[6:]:8s} route {route:6s} max_abs_err/tol "
              + " ".join(errs))
        del a, bs, kw, got, want
    torch.cuda.empty_cache()
    return worst


def train_counts_per_step(cfg, batch=GLOBAL_BATCH, seq=SEQ_LEN):
    """K1 launches of one train step of ``batch`` sequences of ``seq``
    tokens, by launch key.  Forward, per layer: a transformer's
    attention projections (GQA: wq, wk, wv ``none``; MLA: wq or wq_a and
    wq_b, and wkv_a) and its ``res`` wo; a dense FFN's ``rms>glu.silu`` or
    ``rms>gelu`` with save_preact and its ``res`` w_down; a MoE FFN's
    per-expert ``glu.silu`` with save_preact and ``none`` down at the
    capacity rows (``batch`` x capacity, every expert launched), and the
    shared experts' GLU and ``res`` down; a Mamba2 layer's in_proj and
    out_proj; each zamba2 shared-block application's w_in, wq, wk, wv,
    its ``res`` wo and w_down and its GLU; the single head's ``none``
    (codebook heads are an einsum).  Backward: ``none nt`` + ``none tn``
    per one-branch program (``dact.gelu>none nt`` + ``dact.gelu@b>none
    tn`` for a GELU one), and ``dact.silu>none nt``, ``none nt``,
    ``dact.silu@b>none tn`` and ``none tn`` per GLU.  Remat reruns the
    forward: twice a layer, and for the hybrid (an outer checkpoint a
    segment, the layers and the shared block checkpointed inside it)
    three times a Mamba2 layer and twice the shared block and a partial
    last segment's last layer: the outer segment's recompute stops early
    (``torch.utils.checkpoint``'s default) once it has rebuilt the
    inputs of the checkpoints inside it.  The token count
    only sizes the GEMMs: the counts depend on ``batch`` and ``seq`` not
    at all (every expert launches at its capacity rows)."""
    del batch, seq
    L = cfg.n_layers
    counts = collections.Counter()
    remat = cfg.remat

    def one(tag, n, fwd, save=False):
        counts[K.launch_key(tag, "nn", save)] += n * fwd
        act = program_from_tag(tag).branches[0].activation
        if act == "none":
            counts["none nt"] += n
            counts["none tn"] += n
        else:
            counts[f"dact.{act}>none nt"] += n
            counts[f"dact.{act}@b>none tn"] += n

    def glu(tag, n, fwd):
        counts[K.launch_key(tag, "nn", True)] += n * fwd
        for key in ("dact.silu>none nt", "none nt", "dact.silu@b>none tn",
                    "none tn"):
            counts[key] += n

    def ffn(n, fwd):                             # pre-norm in the prologue
        if cfg.act == "silu":
            glu(GLU, n, fwd)
        else:
            one(GELU, n, fwd, save=True)
        one("res", n, fwd)                        # w_down

    if cfg.family in ("ssm", "hybrid"):
        apps = M.n_shared_applications(cfg)
        if not remat:
            one("none", 2 * L, 1)                # in_proj, out_proj
        elif not cfg.shared_attn_every:
            one("none", 2 * L, 2)
        else:
            # A partial last segment's last layer feeds no checkpoint
            # inside the segment: the outer recompute stops before it.
            r = L % cfg.shared_attn_every
            one("none", 2 * (L - (r > 0)), 3)
            one("none", 2 * (r > 0), 2)
        if apps:
            fwd = 2 if remat else 1
            one("none", 4 * apps, fwd)            # w_in, wq, wk, wv
            one("res", apps, fwd)                 # wo
            ffn(apps, fwd)
    else:
        fwd = 2 if remat else 1
        if cfg.attn_kind == "mla":
            one("none", L * (3 if cfg.mla.q_lora_rank else 2), fwd)
        else:
            one("none", 3 * L, fwd)
        one("res", L, fwd)                        # wo
        if cfg.moe is not None and cfg.moe.n_experts:
            E = cfg.moe.n_experts
            glu(EXPERT_GLU, E * L, fwd)
            one("none", E * L, fwd)               # the experts' down
            if cfg.moe.n_shared_experts:
                glu(EXPERT_GLU, L, fwd)
                one("res", L, fwd)
        else:
            ffn(L, fwd)
    if cfg.n_codebooks == 1:
        one("none", 1, 1)                         # the head
    return {k: v for k, v in counts.items() if v}


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


def profile_train_step(step_fn, state, cfg, data_cfg, step, step_ms,
                       table=None):
    """torch.profiler over one more step: device time by kernel, its busy
    share of the unprofiled step time, and K1's share."""
    from torch.profiler import ProfilerActivity, profile

    batch = T.cast_batch(batch_for_model(cfg, data_cfg, step, table=table),
                         cfg)
    # CUDA activity alone (as profile_decode): with the host ops recorded
    # too, key_averages took 17.3 s instead of 4.8 s over a 48-layer
    # mamba2-370m step on the H100's host, for the same kernels' device
    # time (210.9 and 210.1 ms).
    prof = profile(activities=[ProfilerActivity.CUDA])
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


class MoeProbe:
    """While active, keeps each MoE layer call's routing in call order
    (remat's recomputes after the forward's), on the host: the router
    input rows, their fp32 router probabilities, the top-k the layer
    would choose, the experts it routed by, and the layer's output rows
    less the residual.  With ``choices``, call ``i`` routes its tokens
    to ``choices[i]``'s experts, in that order: the weights are its own
    probabilities at those experts, renormalised, and the aux loss
    counts those choices (``torch.topk`` inside ``moe.route`` answers
    with the given ids)."""

    def __init__(self, choices=None):
        self.choices, self.calls = choices, []

    def __enter__(self):
        self._route, self._apply = MOE.route, MOE.moe_apply

        def route(x, router, cfg):
            probs = torch.softmax(torch.einsum(
                "bld,de->ble", x.float(), router.float()), dim=-1)
            call = {"x": x.detach().cpu(), "probs": probs.detach().cpu(),
                    "own": torch.topk(probs, cfg.moe.top_k,
                                      dim=-1).indices.cpu()}
            self.calls.append(call)
            topk = torch.topk
            if self.choices is not None:
                forced = self.choices[len(self.calls) - 1].to(x.device)
                torch.topk = lambda probs, k, dim=-1: (  # noqa: E731
                    probs.gather(dim, forced), forced)
            try:
                out = self._route(x, router, cfg)
            finally:
                torch.topk = topk
            call["ids"] = out[0].cpu()
            return out

        def moe_apply(p, x, cfg, residual=None):
            y, aux = self._apply(p, x, cfg, residual=residual)
            own = y.detach().float()
            if residual is not None:
                own = own - residual.detach().float()
            self.calls[-1]["y"] = own.cpu()
            return y, aux

        MOE.route, MOE.moe_apply = route, moe_apply
        return self

    def __exit__(self, *exc):
        MOE.route, MOE.moe_apply = self._route, self._apply


def forward_calls(calls, n):
    """The forward's ``n`` MoE calls of a training step's record.  Remat
    recomputes them after, in reverse layer order, and each must route
    its tokens as the forward did."""
    fwd, rec = calls[:n], calls[n:]
    if rec and len(rec) != n:
        raise AssertionError(f"{len(calls)} MoE calls for {n} MoE layers")
    for j, call in enumerate(rec):
        if not torch.equal(call["ids"], fwd[n - 1 - j]["ids"]):
            raise AssertionError(f"MoE call {n + j}, the recompute of call "
                                 f"{n - 1 - j}, routed otherwise")
    return fwd


def _token_err(got, ref):
    """Each token's relative L2 error of ``got`` against ``ref`` (B, L)."""
    got, ref = got.float(), ref.float()
    return (got - ref).norm(dim=-1) / ref.norm(dim=-1).clamp_min(1e-30)


def _worst_token(err):
    i = int(err.argmax())
    return err.flatten()[i].item(), divmod(i, err.shape[-1])


def routing_witness(card, cpu, exact):
    """The MoE calls of the card's and the CPU's bf16 runs against an fp32
    witness that took the card's routes (each a list of ``MoeProbe``
    calls, the forward's): for each call, each token's relative error of
    the router input and of the layer's output and the largest deviation
    of its router probabilities, and every flip, a token whose top-k on
    the CPU differs from the card's: the CPU's probability gap between
    the experts swapped out and in, the limit a near tie must be within
    (2 TOL_MODEL of the token's top probability, as the serve phase's
    ``router_near_tie``), the witness's gap and how far the card's and
    the CPU's probabilities at the token are from the witness's."""
    flips, stats = [], []
    for c, (g, h, w) in enumerate(zip(card, cpu, exact)):
        dev = {name: (run["probs"] - w["probs"]).abs().amax(-1)
               for name, run in (("card", g), ("cpu", h))}
        row = {"call": c}
        for name, run in (("card", g), ("cpu", h)):
            for part in ("x", "y"):
                err, tok = _worst_token(_token_err(run[part], w[part]))
                row[f"{part}_err_{name}"] = err
                row[f"{part}_err_{name}_token"] = tok
            row[f"prob_dev_{name}"], row[f"prob_dev_{name}_token"] = \
                _worst_token(dev[name])
        stats.append(row)
        ia, ib = g["ids"], h["own"]
        diff = (ia.sort(-1).values != ib.sort(-1).values).any(-1)
        for t in map(tuple, diff.nonzero().tolist()):
            out_ = sorted(set(ib[t].tolist()) - set(ia[t].tolist()))
            in_ = sorted(set(ia[t].tolist()) - set(ib[t].tolist()))
            p, p32 = h["probs"][t], w["probs"][t]
            gap = (p[out_].min() - p[in_].max()).item()
            gap32 = (p32[out_].min() - p32[in_].max()).item()
            limit = 2 * TOL_MODEL * p.max().item()
            flips.append({"call": c, "token": t, "cpu": out_, "card": in_,
                          "gap": gap, "limit": limit, "gap_fp32": gap32,
                          "card_prob_dev": dev["card"][t].item(),
                          "cpu_prob_dev": dev["cpu"][t].item(),
                          "card_x_err": _token_err(g["x"][t], w["x"][t]
                                                   ).item(),
                          "cpu_x_err": _token_err(h["x"][t], w["x"][t]
                                                  ).item()})
    return flips, stats


def cross_check_train(cfg, layers=4, table=None):
    """The same fp32 masters (``layers`` layers, full width) and one batch
    of 2 x 64 tokens of data seed 1 (an embeds frontend's embeddings from
    ``table``, and codebook labels where the config takes them) on the
    card and on the CPU (plain versions): the loss, the MoE aux loss and
    each leaf's gradient of the step's bf16 compute copy.  An MoE arch's
    CPU run takes the card's routed choices, so both compute the same
    experts' outputs; every choice where the CPU's own top-k differs
    must be a near tie, and an fp32 forward on the CPU with the card's
    choices is the witness both runs' routing is printed against
    (``routing_witness``)."""
    phase(f"{layers}-layer full width {cfg.name} training: card vs CPU "
          "plain path")
    cfg4 = dataclasses.replace(cfg, n_layers=layers)
    masters = M.init_params(cfg4, seed=1, masters=True)
    batch = batch_for_model(cfg4, DataConfig(
        vocab_size=cfg4.vocab_size, seq_len=64, global_batch=2, seed=1), 0,
        table=table)
    moe = cfg.moe is not None and cfg.moe.n_experts > 0
    # The CPU's copy: the fp32 masters where the MoE witness runs on them,
    # else only the compute copy, cast on the card (the same bits) so that
    # half the bytes cross to the host.
    with torch.no_grad():
        host = ({k: v.cpu() for k, v in masters.items()} if moe else
                {k: v.cpu() for k, v in T.cast_params(masters, cfg4).items()})
    out, probes = {}, {}
    for dev in ("cuda", "cpu"):
        params = T.cast_params(masters if dev == "cuda" else host, cfg4)
        t0 = time.perf_counter()
        choices = [c["ids"] for c in probes["cuda"].calls] \
            if dev == "cpu" and moe else None
        with MoeProbe(choices) as probe:
            loss, metrics = T.loss_fn(
                params, T.cast_batch(batch, cfg4, dev), cfg4)
            keys = sorted(params)
            grads = torch.autograd.grad(loss, [params[k] for k in keys])
        probes[dev] = probe
        # The gradients stay where they were computed, in the compute
        # dtype, until they are compared.
        out[dev] = (metrics["loss"].item(), metrics["aux"].item(),
                    dict(zip(keys, grads)))
        print(f"{dev}: loss {out[dev][0]:.6f} aux {out[dev][1]:.6e} and "
              f"{len(keys)} gradients in {time.perf_counter() - t0:.3f} s"
              + (f" ({len(probe.calls)} MoE layer calls)" if probe.calls
                 else ""))
        del params, grads, loss, metrics
    flips, stats = [], []
    if moe:
        t0 = time.perf_counter()
        cfg32 = dataclasses.replace(cfg4, compute_dtype="float32")
        with torch.no_grad(), MoeProbe(
                [c["ids"] for c in probes["cuda"].calls]) as exact:
            T.loss_fn(host, T.cast_batch(batch, cfg32, "cpu"), cfg32)
        n = len(exact.calls)
        flips, stats = routing_witness(
            forward_calls(probes["cuda"].calls, n),
            forward_calls(probes["cpu"].calls, n), exact.calls)
        print(f"fp32 witness on the CPU, the card's routes: {n} MoE layer "
              f"calls in {time.perf_counter() - t0:.3f} s")
        for row in stats:
            print("MoE call vs fp32 witness " + json.dumps(row))
    for f in flips:
        print("routing flip " + json.dumps(f))
    del masters, host, probes
    torch.cuda.empty_cache()
    if any(not f["gap"] <= f["limit"] for f in flips):
        raise AssertionError("a routed choice flipped between the card "
                             "and the CPU away from a near tie")
    (lg, ag, gg), (lc, ac, gc) = out.pop("cuda"), out.pop("cpu")
    rel_loss = abs(lg - lc) / abs(lc)
    rel_aux = abs(ag - ac) / abs(ac) if ac else abs(ag)
    print(f"loss card {lg:.6f} cpu {lc:.6f} relative {rel_loss:.3e}; aux "
          f"card {ag:.6e} cpu {ac:.6e} relative {rel_aux:.3e} (tol "
          f"{TOL_LOSS})")
    if not (math.isfinite(lg) and rel_loss <= TOL_LOSS
            and rel_aux <= TOL_LOSS):
        raise AssertionError("card and CPU training losses disagree")
    worst = 0.0
    for k in sorted(gc):
        # fp32 norms, on the card (the CPU's gradient copied there in its
        # compute dtype): a relative error held to 5e-2 needs no more, and
        # fp32 copies of billion-entry banks take seconds each on the host.
        # The cosine comes from the three norms: an fp32 dot product over a
        # billion entries loses more than the cosine shows.
        a, b = gg[k].float(), gc.pop(k).cuda().float()
        na, nb, nd = (t.norm().item() for t in (a, b, a - b))
        rel = nd / nb
        cos = (na * na + nb * nb - nd * nd) / (2 * na * nb)
        print(f"grad {k:32s} rel_l2={rel:.3e} cosine={cos:.6f}")
        if not (bool(torch.isfinite(a).all()) and rel <= TOL_GRAD):
            raise AssertionError(f"{k}: card and CPU gradients disagree "
                                 f"({rel} > {TOL_GRAD})")
        worst = max(worst, rel)
        del a, b
    del gg
    torch.cuda.empty_cache()
    print(f"gradients: worst relative L2 error {worst:.3e} (tol {TOL_GRAD})")
    return {"loss_rel_err": rel_loss, "aux_rel_err": rel_aux,
            "grad_rel_l2_worst": worst, "routing_flips": len(flips),
            "worst_flip_gap_over_limit": max(
                (f["gap"] / f["limit"] for f in flips), default=None)}


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


def k1f_times(gemms=None, label="K1f times at 1024 tokens"):
    """Kernel, plain version, library call (``torch.matmul`` for the
    plain nt/tn programs; none computes dact or save_preact) and the same
    layout's ``torch.matmul`` of the product alone (one a branch), beside
    the bound, for each (key, GEMM, m, n, k, out dtype) in bf16."""
    phase(f"{label} (CUDA graph replay; B operands rotated past the 50 MB "
          "L2)")
    gen = torch.Generator(device="cuda").manual_seed(9)
    rows = []
    for key, name, m, n, k, od in gemms or K1F_GEMMS:
        tag, ta, tb, save = _parse_key(key)
        nb = program_from_tag(tag).n_b
        copies = max(2, math.ceil(120e6 / (nb * k * n * 2)))
        a, sets, kw = k1f_inputs(key, m, n, k, torch.bfloat16, gen, copies)
        ms = _time_ms(lambda i: K.ca_gemm_program(a, sets[i], out_dtype=od,
                                                  **kw), copies)
        plain = _time_ms(lambda i: K.ca_gemm_program_reference(
            a, sets[i], out_dtype=od, **kw), copies)
        a_op = a.T if ta else a
        mm = _time_ms(lambda i: [torch.matmul(a_op, b.T if tb else b)
                                 for b in sets[i]], copies)
        lib = mm if tag == "none" and (ta or tb) else None
        b_ms, b_by = k1f_bound(key, m, n, k, od, torch.bfloat16)
        row = {"program": key, "gemm": name, "m": m, "n": n, "k": k,
               "out": str(od or torch.bfloat16)[6:], "ms": ms,
               "plain_ms": plain, "library_ms": lib, "matmul_ms": mm,
               "bound_ms": b_ms, "bound_by": b_by,
               "tflops": 2 * m * n * k * nb / ms / 1e9}
        rows.append(row)
        print("time " + json.dumps(row))
        del a, sets, kw
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# Two-output dual programs (F1) and dequant programs with a training flag (F2)
# ---------------------------------------------------------------------------

# (tag, A's dtype, m, n, k, save_preact, the operand dact decorates, per-tile
# scale blocks (b, a)): ragged shapes, the 1000-token prefill, both dtypes.
FAULT_CASES = [
    ("dual(none|none)", torch.float32, 13, 40, 24, False, None, (0, 0)),
    ("dual(none|bias)", torch.float32, 200, 264, 328, True, None, (0, 0)),
    ("dual(none|none)", torch.bfloat16, 1000, 2048, 2048, False, None,
     (0, 0)),
    ("dual(none|bias)", torch.bfloat16, 5, 256, 512, True, None, (0, 0)),
    ("dual(dqb|dqb+bias)", torch.bfloat16, 130, 200, 320, True, None,
     (0, 0)),
    ("dual(dqab|dqab)", torch.int8, 8, 200, 320, False, None, (0, 128)),
    ("dqb+bias+gelu", torch.bfloat16, 1000, 5632, 2048, True, None, (0, 0)),
    ("dqb+bias+gelu", torch.float32, 130, 200, 320, True, None, (128, 0)),
    ("rms>glu.silu(dqb|dqb)", torch.bfloat16, 130, 200, 320, True, None,
     (0, 0)),
    ("dact.gelu>dqb", torch.bfloat16, 37, 200, 320, False, "a", (0, 0)),
    ("dact.gelu@b>dqb", torch.bfloat16, 130, 200, 320, False, "b", (0, 0)),
    ("dact.gelu>dqab", torch.int8, 130, 200, 320, False, "a", (128, 128)),
    ("dact.silu@b>dqab+res", torch.int8, 1, 200, 320, False, "b", (0, 0)),
    ("dqab+bias", torch.int8, 130, 200, 320, True, None, (0, 0)),
]
# The case of each family timed for its kernel record.
FAULT_TIMED = {"F1": 2, "F2": 6}


def fault_inputs(case, gen, copies=1):
    """Operands of one F1/F2 case on the card: A, ``copies`` B sets (int8
    for a dequant program) and the keywords, each B set's branch operands
    (scales, bias, residual) behind ``kw["branch_operands"][i]``."""
    tag, adt, m, n, k, save, operand, (gb, ga) = case
    spec = program_from_tag(tag)
    dev = "cuda"
    deq = spec.branches[0].dequant
    if adt == torch.int8:
        a = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                          dtype=torch.int8)
    else:
        a = torch.randn(m, k, generator=gen, device=dev).to(adt)
    sets, ops = [], []
    for _ in range(copies):
        if deq == "none":
            sets.append([(torch.randn(k, n, generator=gen, device=dev)
                          / math.sqrt(k)).to(adt) for _ in spec.branches])
        else:
            sets.append([torch.randint(-127, 128, (k, n), generator=gen,
                                       device=dev, dtype=torch.int8)
                         for _ in spec.branches])
        sa = torch.rand(-(-k // ga) if ga else m, generator=gen,
                        device=dev) * 0.05 + 0.01
        branch = []
        for b in spec.branches:
            d = {}
            if deq != "none":
                d["scale_b"] = torch.rand(
                    *((-(-k // gb), n) if gb else (n,)), generator=gen,
                    device=dev) * 0.01 + 1e-3
            if deq == "ab":
                d["scale_a"] = sa
            if b.has_bias:
                d["bias"] = torch.randn(n, generator=gen, device=dev)
            if b.has_residual:
                d["residual"] = torch.randn(m, n, generator=gen, device=dev)
            branch.append(d)
        ops.append(branch)
    kw = {"spec": spec, "save_preact": save, "scale_b_block": gb,
          "scale_a_block": ga}
    if operand is not None:
        kw["preact"] = torch.randn(*((m, k) if operand == "a" else (k, n)),
                                   generator=gen, device=dev)
    if spec.prologue.kind == "rms":
        kw["gain"] = torch.rand(k, generator=gen, device=dev) + 0.5
        kw["row_scale"] = rms_row_scale(a, 1e-5)
    return a, sets, ops, kw


def fault_bound(case):
    """Least time of one F1/F2 call: A, the B branches, the scales, bias,
    residual and preact operands read once, the outputs and saved preacts
    written once, over the memory rate; or 2 m n k a branch over the
    tensor-core rate of the products' type (bf16 for float or int8 B
    widened to bf16, fp32's 67 TFLOP/s for fp32 A, int8 for dqab),
    whichever is larger."""
    tag, adt, m, n, k, save, operand, (gb, ga) = case
    spec = program_from_tag(tag)
    deq = spec.branches[0].dequant
    es = 1 if adt == torch.int8 else torch.finfo(adt).bits // 8
    oes = 4 if adt in (torch.int8, torch.float32) else 2
    nbytes = m * k * es + spec.n_b * k * n * (1 if deq != "none" else es)
    nbytes += spec.n_out * m * n * oes + (spec.n_b * m * n * 4 if save else 0)
    if operand is not None:
        nbytes += 4 * (m * k if operand == "a" else k * n)
    for b in spec.branches:
        if deq != "none":
            nbytes += 4 * ((-(-k // gb)) * n if gb else n)
        nbytes += 4 * (n * b.has_bias + m * n * b.has_residual)
    ops = 2 * m * n * k * spec.n_b
    peak = PEAK_OPS[torch.int8 if deq == "ab" else
                    (torch.float32 if adt == torch.float32 else
                     torch.bfloat16)]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def fault_phase():
    """F1 and F2 against their plain versions, every launch on the SIMT
    tile (the route ``k1_route`` names); then one case of each timed.
    Returns {family: record fields}."""
    phase("F1 dual programs and F2 dequant training programs vs plain "
          "version")
    gen = torch.Generator(device="cuda").manual_seed(12)
    K.reset_launch_counts()
    worst = {"F1": 0.0, "F2": 0.0}
    for case in FAULT_CASES:
        tag, adt, m, n, k, save, operand, blocks = case
        fam = "F1" if tag.startswith("dual(") else "F2"
        a, (bs,), (ops,), kw = fault_inputs(case, gen)
        key = K.launch_key(tag, "nn", save)
        before = dict(K.route_counts)
        got = K.ca_gemm_program(a, bs, branch_operands=ops, **kw)
        check_routes(f"{key} m={m}", route_delta(before), {f"simt {key}": 1})
        want = K.ca_gemm_program_reference(a, bs, branch_operands=ops, **kw)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        spec = kw["spec"]
        if len(got) != spec.n_out + save * spec.n_b:
            raise AssertionError(f"{key}: {len(got)} outputs")
        for i, (g, w) in enumerate(zip(got, want)):
            if g.shape != (m, n) or g.dtype != w.dtype \
                    or not bool(torch.isfinite(g).all()):
                raise AssertionError(f"{key} m={m}: bad output {i}")
            err = (g.float() - w.float()).abs().max().item()
            scale = w.float().abs().max().item()
            # Float programs: summation order only (fp32 1e-4; a bf16 output
            # may flip an ulp).  Dequant ones at the int8 tolerance, 2e-3 of
            # max|ref|: a dact on an int8 operand rounds g * act'(h) to int8
            # after an act' whose last bit the card's tanh/exp may flip.
            if g.dtype == torch.bfloat16:
                tol = TOL_BF16 * scale
            elif fam == "F2" or "dq" in tag:
                tol = 2e-3 * scale
            else:
                tol = TOL_F32 * (1 + scale)
            print(f"parity {key:34s} A={str(adt)[6:]:8s} m={m:<4d} n={n:<5d} "
                  f"k={k:<5d} blocks={blocks} output {i} "
                  f"max_abs_err={err:.3e} tol={tol:.3e}")
            if not err <= tol:
                raise AssertionError(f"{key} m={m} output {i}: kernel "
                                     f"disagrees ({err} > {tol})")
            worst[fam] = max(worst[fam], err)
    launches = {"F1": 0, "F2": 0}
    for key, c in K.route_counts.items():
        launches["F1" if "dual(" in key else "F2"] += c
    print(f"F1/F2 launches by route: {dict(K.route_counts)}")
    out = {}
    for fam, idx in FAULT_TIMED.items():
        case = FAULT_CASES[idx]
        tag, adt, m, n, k, save = case[:6]
        nb = program_from_tag(tag).n_b
        copies = max(2, math.ceil(120e6 / (nb * k * n)))
        a, sets, ops, kw = fault_inputs(case, gen, copies)
        ms = _time_ms(lambda i: K.ca_gemm_program(
            a, sets[i], branch_operands=ops[i], **kw), copies, iters=5)
        plain = _time_ms(lambda i: K.ca_gemm_program_reference(
            a, sets[i], branch_operands=ops[i], **kw), copies, iters=5)
        b_ms, b_by = fault_bound(case)
        row = {"family": fam, "program": K.launch_key(tag, "nn", save),
               "m": m, "n": n, "k": k, "A": str(adt)[6:], "ms": ms,
               "plain_ms": plain, "library_ms": None, "bound_ms": b_ms,
               "bound_by": b_by, "launches": launches[fam],
               "max_abs_err": worst[fam]}
        print("time " + json.dumps(row))
        out[fam] = row
        del a, sets, ops, kw
    torch.cuda.empty_cache()
    return out


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


def sustained_clock(fn, seconds=3.0):
    """The SM clock and board power that ``fn``'s kernels hold: ``fn`` runs
    back to back for ``seconds`` while nvidia-smi samples clocks.sm and
    power.draw every 100 ms; the medians of the samples after the first
    third (the clock settles as the power rises).  Returns (GHz, W, the
    number of samples)."""
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(4):
                fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out = smi.communicate(timeout=60)[0]
    samples = []
    for line in out.strip().splitlines():
        try:
            samples.append(tuple(float(v) for v in line.split(",")))
        except ValueError:
            continue          # a partial line at the terminate
    steady = samples[len(samples) // 3:] or samples
    if not steady:
        raise AssertionError("nvidia-smi gave no clock samples")
    return (float(np.median([c for c, _ in steady])) / 1e3,
            float(np.median([w for _, w in steady])), len(samples))


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


# Dims that straddle the distance product's 128 x 128 x 16 tile (and its
# 8-row staging pieces): every (m, n, k) of them is held bit for bit.
STRADDLE = (1, 127, 128, 129, 4095)


def min_plus_phase():
    phase("K1g: all-pairs shortest paths by repeated min-plus squaring")
    n = APSP_NODES
    d0 = apsp_graph(n, APSP_DEGREE, seed=0)
    steps = math.ceil(math.log2(n - 1))
    dist = torch.from_numpy(d0).cuda()
    OPS.distance_product(dist[:8, :8].contiguous(),     # load the library
                         dist[:8, :8].contiguous())
    K.reset_launch_counts()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for i in range(steps):
        dist = OPS.distance_product(dist, dist)
        if i == 2:
            mid = dist              # a dense step's operand, for parity
    end.record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    device_ms = start.elapsed_time(end)
    counts = dict(K.launch_counts)
    print(f"APSP n={n} edges={int(np.isfinite(d0).sum()) - n}: {steps} "
          f"squarings in {wall_ms:.3f} ms (host clock), {device_ms:.3f} ms "
          f"between events, launches {counts}")
    if counts != {MIN_PLUS: steps}:
        raise AssertionError(f"K1g launches {counts}, expected "
                             f"{ {MIN_PLUS: steps} }")
    check_routes("APSP", dict(K.route_counts), {f"minplus {MIN_PLUS}": steps})
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
                         b.bfloat16()),
                        ("bf16 A, fp32 B (1000, 333, 777)", a.bfloat16(),
                         b)):
        worst = max(worst, check_min_plus(label, x, y)[1])
    # Every (m, n, k) of the straddling dims, fp32 and bf16; the scalar
    # (unaligned) loads on an A whose base sits 4 bytes off.
    t0 = time.perf_counter()
    same = 0
    for dtype in (torch.float32, torch.bfloat16):
        for m in STRADDLE:
            for k in STRADDLE:
                x = torch.rand(m, k, generator=gen, device="cuda").to(dtype)
                for nn_ in STRADDLE:
                    y = torch.rand(k, nn_, generator=gen,
                                   device="cuda").to(dtype)
                    got = OPS.distance_product(x, y)
                    ref = K.ca_gemm_program_reference(x, [y],
                                                      semiring="min_plus")
                    if not torch.equal(got, ref):
                        raise AssertionError(
                            f"distance_product ({m}, {k}) x ({k}, {nn_}) "
                            f"{str(dtype)[6:]}: not bit-equal")
                    same += 1
    x = torch.rand(129 * 127 + 1, generator=gen, device="cuda")[1:]
    x = x.view(129, 127)
    worst = max(worst, check_min_plus("A 4 bytes off (129, 127, 4095)", x,
                                      torch.rand(127, 4095, generator=gen,
                                                 device="cuda"))[1])
    print(f"parity distance_product: {same} straddling shapes "
          f"{STRADDLE}^3 in fp32 and bf16 bit-equal "
          f"({time.perf_counter() - t0:.1f} s)")
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
    mid_bf16 = mid.bfloat16()
    ms_bf16 = _time_ms(lambda i: OPS.distance_product(mid_bf16, mid_bf16), 1,
                       iters=5, reps=4)
    plain = _event_ms(lambda: K.ca_gemm_program_reference(
        mid, [mid], semiring="min_plus"))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ghz = sm_clock_ghz()
    held_ghz, held_w, samples = sustained_clock(
        lambda: OPS.distance_product(mid, mid))
    print(f"K1g holds {held_ghz:.3f} GHz at {held_w:.1f} W while it runs "
          f"({samples} nvidia-smi samples; maximum {ghz:.3f} GHz)")
    # 2 m n k FP32 instructions (FADD + FMNMX), 128 lanes a clock per SM
    # (FMNMX's own pipe takes 64: the same m n k / 64 per SM-clock).
    t_ops = 2 * n ** 3 / (128 * sms * ghz * 1e9)
    t_ops_held = 2 * n ** 3 / (128 * sms * held_ghz * 1e9)
    t_bytes = 3 * n * n * 4 / HBM_BYTES_PER_S
    row = {"case": f"m=n=k={n} fp32", "ms": ms, "ms_bf16": ms_bf16,
           "plain_ms": plain, "library_ms": None,
           "bound_ms": max(t_ops, t_bytes) * 1e3,
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "sms": sms, "sm_clock_max_ghz": ghz, "sm_clock_held_ghz": held_ghz,
           "power_held_w": held_w, "issue_bound_ms": t_ops * 1e3,
           "issue_bound_held_ms": t_ops_held * 1e3,
           "byte_bound_ms": t_bytes * 1e3,
           "share_of_bound": max(t_ops, t_bytes) * 1e3 / ms}
    print("time distance_product " + json.dumps(row))
    del dist, mid, mid_bf16, a, b, got
    torch.cuda.empty_cache()
    return {"launches": steps, "max_abs_err": worst, "row": row,
            "apsp_ms": wall_ms, "apsp_device_ms": device_ms,
            "scipy_s": scipy_s, "max_rel_err": rel}


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


# ---------------------------------------------------------------------------
# The other architectures on the serve path: granite-20b, deepseek-v2-lite-
# 16b, minicpm3-4b, mixtral-8x7b; mamba2-370m, zamba2-7b, qwen2-vl-72b,
# musicgen-large
# ---------------------------------------------------------------------------

GELU = "rms>gelu"
EXPERT_GLU = "glu.silu(none|none)"
# K1 at the new programs and shapes (program, GEMM, k, n, m values):
# granite's rms-prologue GELU w_up, deepseek's expert GEMMs at the
# capacity rows of a decode step (8) and of a 128-token prefill (16),
# MLA's wkv_a and minicpm3's q-LoRA projections, mixtral's expert GLU;
# the Mamba2 in_proj (n = 4384, 14576) and out_proj (zamba2's also the
# shape of its shared w_in), qwen2-vl's GLU and down projection,
# musicgen's GELU w_up.
ARCH_GEMMS = [(GELU, "granite w_up", 6144, 24576, (1, 37, 128)),
              (EXPERT_GLU, "deepseek expert glu", 2048, 1408, (8, 16)),
              ("none", "deepseek expert down", 1408, 2048, (8, 16)),
              ("none", "deepseek wkv_a", 2048, 576, (1, 128)),
              ("none", "minicpm3 wkv_a", 2560, 288, (1, 128)),
              ("none", "minicpm3 wq_a", 2560, 768, (1, 128)),
              ("none", "minicpm3 wq_b", 768, 3840, (1, 128)),
              (EXPERT_GLU, "mixtral expert glu", 4096, 14336, (8,)),
              ("none", "mamba2 in_proj", 1024, 4384, (1, 37, 128)),
              ("none", "mamba2 out_proj", 2048, 1024, (1, 128)),
              ("none", "zamba2 in_proj", 3584, 14576, (1, 128)),
              ("none", "zamba2 out_proj", 7168, 3584, (1, 128)),
              (GLU, "qwen2-vl glu", 8192, 29568, (1, 128)),
              ("res", "qwen2-vl w_down", 29568, 8192, (1, 128)),
              (GELU, "musicgen w_up", 2048, 8192, (1, 128))]
# The shapes timed for the kernel table: (program, GEMM, m).
ARCH_TIMED = [(GELU, "granite w_up", 1), (GELU, "granite w_up", 128),
              (EXPERT_GLU, "deepseek expert glu", 8),
              (EXPERT_GLU, "deepseek expert glu", 16),
              ("none", "deepseek expert down", 8),
              ("none", "deepseek expert down", 16),
              ("none", "deepseek wkv_a", 1), ("none", "minicpm3 wkv_a", 1),
              ("none", "mamba2 in_proj", 1), ("none", "mamba2 in_proj", 128),
              ("none", "mamba2 out_proj", 1), ("none", "zamba2 in_proj", 1),
              ("none", "zamba2 out_proj", 1), (GLU, "qwen2-vl glu", 1),
              (GLU, "qwen2-vl glu", 128), ("res", "qwen2-vl w_down", 1),
              (GELU, "musicgen w_up", 1)]
# Each architecture served: its layers on the card (None: all), whether
# it also serves on the paged cache, its prompts (ARCH_NEW_TOKENS new
# tokens each), the K1 launches of one forward step and the layers of its card-vs-CPU model.
# The deep ones serve at a cut depth so that the whole script, with the
# train archs phase, stays inside its time limit (their decode steps are
# host-bound, so the phase's time goes with depth; cut again to make room
# for the FSDP part of the dist phase): granite-20b 6 of 52 layers,
# deepseek-v2-lite-16b 2 of 27, minicpm3-4b 8 of 62, mamba2-370m and
# musicgen-large 12 of 48, zamba2-7b 12 of 81 (two full groups, two
# shared-block applications).  mixtral-8x7b's 32 layers are 93 GB in
# bf16: 4 of them are served, and its 4200-token prompt runs past the
# 4096-token window.  qwen2-vl-72b's 80 layers are 145 GB in bf16: 12 of
# them are served.  The SSM archs' 600-token prompt spans three 256-token
# SSD chunks, not a multiple of one; zamba2 on the CPU at 7 layers runs
# one full group of 6 and a partial one.
SERVED_ARCHS = {
    "granite-20b": dict(layers=6, paged=True, prompts=(128, 37, 8),
                        per_step=37, cpu_layers=2),
    "deepseek-v2-lite-16b": dict(layers=2, paged=False,
                                 prompts=(128, 37, 8), per_step=267,
                                 cpu_layers=2),
    "minicpm3-4b": dict(layers=8, paged=False, prompts=(128, 37, 8),
                        per_step=49, cpu_layers=4),
    "mixtral-8x7b": dict(layers=4, paged=True, prompts=(128, 37, 8, 4200),
                         per_step=81, cpu_layers=2),
    "mamba2-370m": dict(layers=12, paged=False, prompts=(128, 37, 8, 600),
                        per_step=25, cpu_layers=2),
    "zamba2-7b": dict(layers=12, paged=False, prompts=(128, 37, 8, 600),
                      per_step=39, cpu_layers=7),
    "qwen2-vl-72b": dict(layers=12, paged=True, prompts=(128, 37, 8),
                         per_step=73, cpu_layers=2),
    "musicgen-large": dict(layers=12, paged=True, prompts=(128, 37, 8),
                           per_step=72, cpu_layers=2),
}
ARCH_NEW_TOKENS = 8


def arch_parity():
    phase("architectures: K1 parity at the new programs and shapes")
    gen = torch.Generator(device="cuda").manual_seed(6)
    worst = {}
    for tag, name, k, n, ms in ARCH_GEMMS:
        for m in ms:
            err = check_program(tag, name, m, k, n, None, torch.bfloat16,
                                gen)
            worst[name] = max(worst.get(name, 0.0), err)
    return worst


def arch_times():
    phase("architectures: K1 times at the new shapes (CUDA graph replay; "
          "weights rotated past the 50 MB L2)")
    gen = torch.Generator(device="cuda").manual_seed(7)
    shapes = {name: (k, n) for _, name, k, n, _ in ARCH_GEMMS}
    rows = []
    for tag, name, m in ARCH_TIMED:
        k, n = shapes[name]
        nb = program_from_tag(tag).n_b
        copies = max(2, math.ceil(120e6 / (nb * k * n * 2)))
        a, sets, kw = program_inputs(tag, m, k, n, torch.bfloat16, gen,
                                     copies)
        ms = _time_ms(lambda i: K.ca_gemm_program(a, sets[i], **kw), copies)
        plain = _time_ms(lambda i: K.ca_gemm_program_reference(
            a, sets[i], **kw), copies)
        # No single PyTorch call applies the rms prologue and the GELU, or
        # the GLU; torch.matmul computes the plain product.
        lib_fn = _library_call(tag, a, sets, kw, None)
        lib = _time_ms(lib_fn, copies) if lib_fn is not None else None
        b_ms, b_by = bound(tag, m, k, n, None, torch.bfloat16)
        row = {"program": tag, "gemm": name, "m": m, "k": k, "n": n,
               "k1_route": want_route(torch.bfloat16, m), "ms": ms,
               "plain_ms": plain, "library_ms": lib, "bound_ms": b_ms,
               "bound_by": b_by}
        rows.append(row)
        print("time " + json.dumps(row))
        del a, sets, kw
    return rows


def arch_step_routes(cfg, L):
    """K1 launches by route and program of one forward step over ``L``
    tokens of one sequence: the attention and dense GEMMs at m = L, the
    routed experts' at m = their capacity rows (each expert's buffer is a
    16-byte aligned slice), a Mamba2 layer's in_proj and out_proj, each
    shared-block application's w_in, q/k/v, wo, MLP and down projection,
    and the head at m = L (none for codebook heads: an einsum, as in the
    reference)."""
    from repro_torch.models import moe as MOE

    def route(m):
        return "wgmma" if m > 8 else "decode"

    steps = collections.Counter()

    def add(tag, m, times=cfg.n_layers):
        steps[f"{route(m)} {tag}"] += times

    mlp = GLU if cfg.act == "silu" else GELU
    if cfg.family in ("ssm", "hybrid"):
        add("none", L, 2 * cfg.n_layers)             # in_proj, out_proj
        apps = M.n_shared_applications(cfg)
        if apps:
            add("none", L, 4 * apps)                 # w_in, wq, wk, wv
            add("res", L, 2 * apps)                  # wo, w_down
            add(mlp, L, apps)
    else:
        if cfg.attn_kind == "mla":
            add("none", L, cfg.n_layers * (3 if cfg.mla.q_lora_rank else 2))
        else:
            add("none", L, cfg.n_layers * 3)
        add("res", L)                                # wo
        if cfg.moe is not None:
            E, cap = cfg.moe.n_experts, MOE.capacity(cfg, L)
            add(EXPERT_GLU, cap, cfg.n_layers * E)
            add("none", cap, cfg.n_layers * E)
            if cfg.moe.n_shared_experts:
                add(EXPERT_GLU, L)
                add("res", L)
        else:
            add(mlp, L)
            add("res", L)                            # w_down
    if cfg.n_codebooks == 1:
        add("none", L, 1)                            # the head
    return steps


def weight_bound_ms(params, cfg):
    """The weight bytes a decode step reads (every leaf once, one row of
    the embedding table, or for the embeds frontend one row of the demo
    table) over the memory rate; the same counting only the routed experts
    a token takes (top_k of n_experts); and counting the shared block
    once per application (zamba2: 13 reads of it a step)."""
    routed = {"blocks/moe/w_gate", "blocks/moe/w_up", "blocks/moe/w_down"}
    apps = M.n_shared_applications(cfg)
    row = cfg.d_model * torch.finfo(cfg.dtype()).bits // 8
    total = active = applied = 0.0 if cfg.frontend == "tokens" else row
    for name, t in params.items():
        nb = t.numel() * t.element_size()
        if name == "embed/table":
            nb = t.shape[1] * t.element_size()
        total += nb
        active += nb * (cfg.moe.top_k / cfg.moe.n_experts
                        if name in routed else 1)
        applied += nb * (apps if name.startswith("shared/") else 1)
    return (total / HBM_BYTES_PER_S * 1e3, active / HBM_BYTES_PER_S * 1e3,
            total, applied / HBM_BYTES_PER_S * 1e3)


def serve_arch(name, spec, table=None):
    """Full width (``spec["layers"]`` of the config's layers), random
    weights from seed 0, served through ServeEngine on the slab cache and
    (``spec["paged"]``) the paged int8 cache, an embeds-frontend arch fed
    from ``table``: the K1 launches by route and program of every forward
    step, K2's launches (one a layer a paged decode step, none in
    prefill), slab vs paged prefill logits bit-equal and greedy tokens
    equal up to a near tie, one K2 call of the run replayed against its
    plain version; times, the decode profile, peak memory and the
    weight-byte bound."""
    cfg = get_config(name)
    if spec["layers"]:
        full = cfg
        cfg = dataclasses.replace(cfg, n_layers=spec["layers"])
        print(f"{name}: depth cut to {cfg.n_layers} of {full.n_layers} "
              f"layers (the full model is {full.n_params() * 2 / 1e9:.1f} "
              "GB in bf16)")
    phase(f"architectures: full-width {name}, {cfg.n_layers} layers, "
          + ("slab vs paged_kv=True" if spec["paged"] else "slab"))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    bound_ms, active_ms, wbytes, applied_ms = weight_bound_ms(params, cfg)
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    print(f"init {sum(p.numel() for p in params.values())} params "
          f"({wbytes / 1e9:.3f} GB read a decode step) in {init_s:.3f} s, "
          f"peak {init_peak / 1e9:.3f} GB of the card's "
          f"{card_bytes / 1e9:.3f} GB")
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in spec["prompts"]]
    max_len = max(spec["prompts"]) + ARCH_NEW_TOKENS
    L = cfg.n_layers
    print(f"{name}: K1 launches by route and program of a decode step "
          f"{dict(arch_step_routes(cfg, 1))}, of a {prompts[0].size}-token "
          f"prefill {dict(arch_step_routes(cfg, prompts[0].size))}")
    runs = {}
    for paged in ((False, True) if spec["paged"] else (False,)):
        eng = ServeEngine(params, cfg, max_len=max_len, paged_kv=paged,
                          sample_table=table)
        eng.submit(Request(uid=0, prompt=np.arange(4), max_new_tokens=2))
        served(eng)
        reqs = [Request(uid=i + 1, prompt=p, max_new_tokens=ARCH_NEW_TOKENS)
                for i, p in enumerate(prompts)]
        for r in reqs:
            if not eng.submit(r):
                raise AssertionError(f"request {r.uid} rejected: {r.error}")
        K.reset_launch_counts()
        FA.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        last = L * (ARCH_NEW_TOKENS - 1) - 1
        t0 = time.perf_counter()
        with Recorder() as rec, Capture(last) as cap, \
                RouteRecorder() as routing:
            served(eng)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        label = f"{name} {'paged' if paged else 'slab'}"
        want = collections.Counter()
        for r in reqs:
            want += arch_step_routes(cfg, len(r.prompt))
            for _ in range(r.max_new_tokens - 1):
                want += arch_step_routes(cfg, 1)
        check_routes(label, dict(K.route_counts), dict(want))
        per_step = sum(arch_step_routes(cfg, 1).values())
        steps = sum(r.max_new_tokens for r in reqs)
        print(f"{label}: {per_step} K1 launches a forward step, "
              f"{sum(K.launch_counts.values())} over {steps} steps")
        if per_step != spec["per_step"] or sum(
                K.launch_counts.values()) != per_step * steps:
            raise AssertionError(f"{label}: K1 launches a step "
                                 f"{per_step}, expected {spec['per_step']}")
        decodes = steps - len(reqs)
        want_k2 = {FA.NAME: L * decodes} if paged else {}
        print(f"{label}: K2 launches {dict(FA.launch_counts)}")
        if dict(FA.launch_counts) != want_k2:
            raise AssertionError(f"{label}: K2 launches "
                                 f"{dict(FA.launch_counts)}, expected "
                                 f"{want_k2} (none in prefill)")
        runs[paged] = {"reqs": reqs, "rec": rec, "wall": wall,
                       "routing": routing.calls,
                       "routes": dict(K.route_counts),
                       "k2": dict(FA.launch_counts), "call": cap.args,
                       "peak": torch.cuda.max_memory_allocated()}
        for r in reqs:
            print(f"{label} request {r.uid} prompt={len(r.prompt)} "
                  f"prefill {r.prefill_s * 1e3:.3f} ms, decode "
                  f"{r.decode_s * 1e3 / (r.max_new_tokens - 1):.3f} ms/token"
                  f", tokens={r.generated}")
        del eng
    call_err = None
    if spec["paged"]:
        check_slab_vs_paged(cfg, runs)
        (q, *pool, tables, lens_t), kw = runs[True]["call"]
        _, call_err = check_attn(
            f"{name} serve call B={q.shape[0]} lens={lens_t.tolist()} "
            f"page={pool[0].shape[1]} H={q.shape[1]} Hkv={pool[0].shape[2]}"
            f" D={q.shape[2]} window={kw.get('window')}",
            q, pool, tables, lens_t, **kw)
    profile = profile_decode(params, cfg, table=table)
    del params
    torch.cuda.empty_cache()
    out = {"arch": name, "layers": L, "init_s": init_s,
           "init_peak_gb": init_peak / 1e9,
           "serve_peak_gb": max(r["peak"] for r in runs.values()) / 1e9,
           "card_gb": card_bytes / 1e9, "weight_gb": wbytes / 1e9,
           "weight_bound_ms": bound_ms, "active_weight_bound_ms": active_ms,
           "applied_weight_bound_ms": applied_ms,
           "k1_per_step": sum(arch_step_routes(cfg, 1).values()),
           "profile": profile, "k2_call_err": call_err,
           "routes": {p: r["routes"] for p, r in runs.items()},
           "k2": {p: r["k2"] for p, r in runs.items()}, "requests": []}
    for paged, run in runs.items():
        for r in run["reqs"]:
            out["requests"].append({
                "cache": "paged" if paged else "slab", "uid": r.uid,
                "prompt": len(r.prompt), "prefill_ms": r.prefill_s * 1e3,
                "decode_ms_per_token":
                    r.decode_s * 1e3 / (r.max_new_tokens - 1)})
    print(f"{name} summary " + json.dumps(
        {k: v for k, v in out.items() if k not in ("routes", "k2")}))
    return out


def cross_check_arch(name, spec, table=None):
    cfg = dataclasses.replace(get_config(name), n_layers=spec["cpu_layers"])
    phase(f"architectures: {name} at full width, {cfg.n_layers} layers: "
          "card vs CPU plain path")
    p_gpu = M.init_params(cfg, seed=1)
    p_cpu = {k: v.cpu() for k, v in p_gpu.items()}
    card_vs_cpu(p_gpu, p_cpu, cfg, label=f"{name} ", table=table)
    del p_gpu, p_cpu
    torch.cuda.empty_cache()


def architectures(names=None):
    """The architectures phase: K1 parity at the new shapes, then each
    architecture (``names``, default all) served on the card and held
    against the CPU, one model on the card at a time, then the new
    shapes' times."""
    t0 = time.perf_counter()
    worst = arch_parity()
    served = {}
    for name in names or SERVED_ARCHS:
        spec = SERVED_ARCHS[name]
        table = None
        cfg = get_config(name)
        if cfg.frontend == "embeds":
            # sample_table(cfg)'s values, on the card.
            table = embeds_table(cfg, "serve").cuda()
        served[name] = serve_arch(name, spec, table)
        cross_check_arch(name, spec, table)
        del table
        torch.cuda.empty_cache()
    rows = arch_times()
    seconds = time.perf_counter() - t0
    print(f"architectures phase {seconds:.1f} s")
    return {"worst": worst, "served": served, "rows": rows,
            "seconds": seconds}


def arch_kernel_records(archs, attn_rows):
    """The kernels line's records of the new K1 shapes (launches from the
    served runs by route and program) and of K2 on granite's paged path."""
    worst, served = archs["worst"], archs["served"]
    source_run = {"granite w_up": "granite-20b",
                  "deepseek expert glu": "deepseek-v2-lite-16b",
                  "deepseek expert down": "deepseek-v2-lite-16b",
                  "deepseek wkv_a": "deepseek-v2-lite-16b",
                  "minicpm3 wkv_a": "minicpm3-4b",
                  "mamba2 in_proj": "mamba2-370m",
                  "mamba2 out_proj": "mamba2-370m",
                  "zamba2 in_proj": "zamba2-7b",
                  "zamba2 out_proj": "zamba2-7b",
                  "qwen2-vl glu": "qwen2-vl-72b",
                  "qwen2-vl w_down": "qwen2-vl-72b",
                  "musicgen w_up": "musicgen-large"}
    records = []
    for row in archs["rows"]:
        arch = source_run[row["gemm"]]
        key = f"{row['k1_route']} {row['program']}"
        records.append({
            "name": f"ca_gemm_program[{row['program']}] {row['gemm']} "
                    f"m={row['m']}", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES,
            "launches": served[arch]["routes"][False].get(key, 0),
            "max_abs_err": worst[row["gemm"]], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "k1_route": row["k1_route"],
            "shape": f"{row['gemm']} m={row['m']} k={row['k']} "
                     f"n={row['n']} bf16; launches: {key} over the "
                     f"{arch} slab run"})
    for case, arch in (("granite G48", "granite-20b"),
                       ("qwen2-vl G8", "qwen2-vl-72b"),
                       ("musicgen G1", "musicgen-large")):
        arow = next(r for r in attn_rows if r["case"] == case)
        run = served[arch]
        records.append({
            "name": f"{FA.NAME} ({arch} G{arow['H'] // arow['Hkv']} paged "
                    "path)", "route": "cuda",
            "source": ATTN_SOURCE, "replaces": ATTN_REPLACES,
            "launches": run["k2"][True][FA.NAME],
            "max_abs_err": run["k2_call_err"], "ms": arow["ms"],
            "plain_ms": arow["plain_ms"], "bound_ms": arow["bound_ms"],
            "bound_by": arow["bound_by"], "library_ms": None,
            "shape": f"B={arow['B']} S={arow['S']} page={arow['page']} "
                     f"H={arow['H']} Hkv={arow['Hkv']} D={arow['D']} bf16"})
    return records


def print_archs(archs, card_line):
    for name, out in archs["served"].items():
        prof = out["profile"]
        print(f"e2e {name} ({out['layers']} layers; {card_line}): "
              f"weight-byte bound {out['weight_bound_ms']:.3f} ms/token "
              f"({out['weight_gb']:.3f} GB), active-parameter bound "
              f"{out['active_weight_bound_ms']:.3f}, shared block read "
              f"once an application {out['applied_weight_bound_ms']:.3f} "
              "ms/token; "
              f"{out['k1_per_step']} K1 launches a decode step; decode "
              f"profile {prof['decode_wall_ms_per_step']:.3f} ms/step wall, "
              f"device {prof['device_ms_per_step']:.3f} (K1 "
              f"{prof['gemm_kernel_ms_per_step']:.3f}), busy share "
              f"{prof['device_busy_share']:.4f}; peak memory init "
              f"{out['init_peak_gb']:.3f} / serve {out['serve_peak_gb']:.3f}"
              f" GB of {out['card_gb']:.3f}")
        for r in out["requests"]:
            print(f"e2e {name} {r['cache']} request {r['uid']} "
                  f"prompt={r['prompt']}: prefill {r['prefill_ms']:.3f} ms, "
                  f"decode {r['decode_ms_per_token']:.3f} ms/token")
    print(f"e2e architectures phase {archs['seconds']:.1f} s")


# ---------------------------------------------------------------------------
# Training the other seven configurations (train_archs)
# ---------------------------------------------------------------------------

# Each configuration trained at full width: its layers (None: all).  The
# depth is cut only where fp32 masters and AdamW's two moments plus the
# step's bf16 copy and gradients, about 16 bytes a parameter, would not
# fit the card's 80 GB: deepseek-v2-lite-16b 16.2 B parameters (4 of 27
# layers: 2.76 B), zamba2-7b 6.8 B (12 of 81: two full groups of 6, the
# shared block applied twice; 1.40 B), minicpm3-4b 4.3 B (16 of 62: 1.38
# B), mixtral-8x7b 46.7 B (2 of 32: 3.17 B), qwen2-vl-72b 74 B (2 of 80:
# 3.00 B).  mamba2-370m (0.42 B) and musicgen-large (2.43 B) train whole.
# deepseek-v2-lite-16b (2) and minicpm3-4b (8) are cut again, to make
# room for the FSDP part of the dist phase.
TRAIN_ARCHS = {"mamba2-370m": None, "musicgen-large": None,
               "deepseek-v2-lite-16b": 2, "zamba2-7b": 12,
               "minicpm3-4b": 8, "mixtral-8x7b": 2, "qwen2-vl-72b": 2}
TRAIN_ARCH_STEPS = 2
# The card-vs-CPU check of each family trains this many layers: 2, and
# zamba2 7 (one full group of 6, so the shared block applies, and a
# partial one).
TRAIN_CHECK_LAYERS = {"zamba2-7b": 7}

# Training rows of the expert GEMMs: a step's 4 sequences times each
# expert's capacity over one 256-token sequence.
DS_ROWS = GLOBAL_BATCH * MOE.capacity(get_config("deepseek-v2-lite-16b"),
                                      SEQ_LEN)
MIX_ROWS = GLOBAL_BATCH * MOE.capacity(get_config("mixtral-8x7b"), SEQ_LEN)
EXPERT_GLU_SAVE = K.launch_key("glu.silu(none|none)", "nn", True)
GELU_SAVE = K.launch_key("rms>gelu", "nn", True)
F32 = torch.float32
# K1f at the programs and shapes the new families train with, 4 x 256
# tokens a step (key, GEMM, m, n, k, out dtype): deepseek's expert GLU
# with save_preact and its dact nt / tn, and its down projection's nt /
# tn, at the capacity rows (m = 4 x 32); mixtral's expert GLU at its
# capacity rows (4 x 80; n 14336); the ragged n of MLA's wkv_a (576, 288)
# and of the Mamba2 in_proj (4384, 14576) in dx and dW; musicgen's
# rms>gelu w_up with save_preact and its dact.gelu programs.
K1F_ARCH_GEMMS = [
    (EXPERT_GLU_SAVE, "deepseek expert glu fwd", DS_ROWS, 1408, 2048, None),
    ("dact.silu>none nt", "deepseek expert gate dx", DS_ROWS, 2048, 1408,
     F32),
    ("dact.silu@b>none tn", "deepseek expert gate dW", 2048, 1408, DS_ROWS,
     None),
    ("none nt", "deepseek expert down dx", DS_ROWS, 1408, 2048, F32),
    ("none tn", "deepseek expert down dW", 1408, 2048, DS_ROWS, None),
    (EXPERT_GLU_SAVE, "mixtral expert glu fwd", MIX_ROWS, 14336, 4096, None),
    ("dact.silu>none nt", "mixtral expert gate dx", MIX_ROWS, 4096, 14336,
     F32),
    ("dact.silu@b>none tn", "mixtral expert gate dW", 4096, 14336, MIX_ROWS,
     None),
    ("none nt", "deepseek wkv_a dx", TOKENS, 2048, 576, F32),
    ("none tn", "deepseek wkv_a dW", 2048, 576, TOKENS, None),
    ("none nt", "minicpm3 wkv_a dx", TOKENS, 2560, 288, F32),
    ("none tn", "minicpm3 wkv_a dW", 2560, 288, TOKENS, None),
    ("none nt", "mamba2 in_proj dx", TOKENS, 1024, 4384, F32),
    ("none tn", "mamba2 in_proj dW", 1024, 4384, TOKENS, None),
    ("none nt", "zamba2 in_proj dx", TOKENS, 3584, 14576, F32),
    ("none tn", "zamba2 in_proj dW", 3584, 14576, TOKENS, None),
    (GELU_SAVE, "musicgen w_up fwd", TOKENS, 8192, 2048, None),
    ("dact.gelu>none nt", "musicgen w_up dx", TOKENS, 2048, 8192, F32),
    ("dact.gelu@b>none tn", "musicgen w_up dW", 2048, 8192, TOKENS, None)]
# The train run whose launches each shape's record counts.
K1F_ARCH_RUN = {"deepseek": "deepseek-v2-lite-16b", "mixtral": "mixtral-8x7b",
                "minicpm3": "minicpm3-4b", "mamba2": "mamba2-370m",
                "zamba2": "zamba2-7b", "musicgen": "musicgen-large"}
ROUTED = ("blocks/moe/w_gate", "blocks/moe/w_up", "blocks/moe/w_down")


def train_work(cfg, tokens, batch=GLOBAL_BATCH, seq=SEQ_LEN):
    """The bound of one train step over ``tokens``: 6 · N_active · T over
    the bf16 peak, N_active the multiplied parameters a token meets
    (every matrix but the embedding table and the Mamba2 conv kernel; a
    routed bank at top_k / n_experts; zamba2's shared block once an
    application), remat's extra forward 2 · N_layers · T (the layers'
    part); for MoE also the expert work the capacity loop really does
    (every expert at its capacity rows, forward, backward and remat's
    forward) beside the routed tokens' share of it."""
    apps = M.n_shared_applications(cfg)
    active = layers = 0.0
    for name, d in M.model_defs(cfg).items():
        if len(d.shape) < 2 or name == "embed/table" \
                or name.endswith("conv_w"):
            continue
        n = float(math.prod(d.shape))
        if name in ROUTED:
            n *= cfg.moe.top_k / cfg.moe.n_experts
        if name.startswith("shared/"):
            n *= apps
        active += n
        layers += 0.0 if name.startswith("head/") else n
    peak = PEAK_OPS[torch.bfloat16]
    out = {"active_params": active,
           "bound_ms": 6 * active * tokens / peak * 1e3,
           "remat_ms": 2 * layers * tokens / peak * 1e3 if cfg.remat
           else 0.0}
    if cfg.moe is not None and cfg.moe.n_experts:
        mo = cfg.moe
        per_row = 3 * cfg.d_model * mo.d_ff_expert * cfg.n_layers
        passes = 6 + (2 if cfg.remat else 0)
        rows = mo.n_experts * batch * MOE.capacity(cfg, seq)
        out["expert_capacity_ms"] = passes * rows * per_row / peak * 1e3
        out["expert_routed_ms"] = (passes * tokens * mo.top_k * per_row
                                   / peak * 1e3)
    return out


def train_arch(name, layers, table):
    """Full width (``layers`` of the config's layers), fp32 masters from
    seed 0, AdamW: TRAIN_ARCH_STEPS steps of GLOBAL_BATCH x SEQ_LEN tokens
    (an embeds frontend's from ``table``) through ``train.step`` with the
    GEMM plans warmed up, each with a finite loss and grad_norm and
    exactly ``train_counts_per_step``'s K1 launches by key; routes by
    key, launches by shape, step ms and tokens/s, peak memory, the bound,
    and one profiled step."""
    cfg = get_config(name)
    full = cfg
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    phase(f"train archs: full-width {name}, {cfg.n_layers} of "
          f"{full.n_layers} layers, {TRAIN_ARCH_STEPS} steps of "
          f"{GLOBAL_BATCH} x {SEQ_LEN} tokens, remat={cfg.remat}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = T.init_state(cfg, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in state.params.values())
    print(f"init {n_params} fp32 master params (full config "
          f"{full.n_params()}) in {time.perf_counter() - t0:.3f} s")
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ_LEN,
                          global_batch=GLOBAL_BATCH, seed=0)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1,
                                total_steps=TRAIN_ARCH_STEPS)
    t0 = time.perf_counter()
    step_fn = T.build_train_step(cfg, opt_cfg, warmup_gemm_rows=TOKENS,
                                 donate=True)
    warm_s = time.perf_counter() - t0
    want = train_counts_per_step(cfg)
    print(f"expected K1 launches per step: {sum(want.values())} {want}; "
          f"plans warmed up in {warm_s:.3f} s")
    rows, routes = [], collections.Counter()
    K.reset_launch_counts()
    for i in range(TRAIN_ARCH_STEPS):
        batch = T.cast_batch(batch_for_model(cfg, data_cfg, i, table=table),
                             cfg)
        before = dict(K.launch_counts)
        routes_before = dict(K.route_counts)
        shapes_before = dict(K.shape_counts)
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, metrics = step_fn(state, batch)
        row = {"step": i + 1, "loss": float(metrics["loss"]),
               "aux": float(metrics["aux"]),
               "grad_norm": float(metrics["grad_norm"])}
        torch.cuda.synchronize()
        row["ms"] = (time.perf_counter() - t) * 1e3
        row["tokens_per_s"] = TOKENS / row["ms"] * 1e3
        delta = {key: n - before.get(key, 0)
                 for key, n in K.launch_counts.items()
                 if n != before.get(key, 0)}
        step_routes = route_delta(routes_before)
        routes.update(step_routes)
        if i == 0:
            shapes_per_step = {
                key: n - shapes_before.get(key, 0)
                for key, n in K.shape_counts.items()
                if n != shapes_before.get(key, 0)}
        print(f"train {name} " + json.dumps(row))
        print(f"train {name} step {i + 1} K1 launches by route "
              f"{step_routes}")
        if not all(math.isfinite(row[k]) for k in ("loss", "aux",
                                                   "grad_norm")):
            raise AssertionError(f"{name} step {i + 1}: non-finite loss, "
                                 "aux or grad_norm")
        if delta != want:
            raise AssertionError(f"{name} step {i + 1}: K1 launches "
                                 f"{delta}, expected {want}")
        rows.append(row)
    peak = torch.cuda.max_memory_allocated()
    step_ms = rows[-1]["ms"]
    work = train_work(cfg, TOKENS)
    summary = {"arch": name, "layers": cfg.n_layers,
               "params": n_params, "steps": rows,
               "step_ms": step_ms, "tokens_per_s": rows[-1]["tokens_per_s"],
               "peak_memory_gb": peak / 1e9,
               "launches_per_step": sum(want.values()),
               "model_work_share": work["bound_ms"] / step_ms, **work}
    summary["profile"] = profile_train_step(step_fn, state, cfg, data_cfg,
                                            TRAIN_ARCH_STEPS, step_ms, table)
    print(f"train {name} summary " + json.dumps(summary))
    summary["routes"] = dict(routes)
    # By (key, m, n, k): the whole run's (its steps and the profiled one)
    # and the first step's.
    summary["shape_launches"] = dict(K.shape_counts)
    summary["shape_launches_per_step"] = shapes_per_step
    del state, step_fn
    torch.cuda.empty_cache()
    return summary


def train_archs(names=None):
    """The train_archs phase: K1f parity at the new training shapes, then
    each configuration (``names``, default all) trained on the card and
    its two-layer model held against the CPU, one model on the card at a
    time; then the new shapes' times."""
    t0 = time.perf_counter()
    worst = k1f_parity(
        [g + (torch.bfloat16,) for g in K1F_ARCH_GEMMS],
        "the other families' training programs and shapes", seed=10)
    trained, checks = {}, {}
    for name in names or TRAIN_ARCHS:
        cfg = get_config(name)
        # An embeds frontend's table, of the train steps' data seed 0, is
        # drawn once: the steps, the profiled step and the cross-check
        # index it (qwen2-vl's is drawn in the background, embeds_table).
        table = (None if cfg.frontend == "tokens"
                 else embeds_table(cfg, "train"))
        trained[name] = train_arch(name, TRAIN_ARCHS[name], table)
        checks[name] = cross_check_train(cfg, TRAIN_CHECK_LAYERS.get(name, 2),
                                         table)
        del table
    rows = k1f_times(K1F_ARCH_GEMMS, "K1f times at the other families' "
                     "training shapes")
    seconds = time.perf_counter() - t0
    print(f"train archs phase {seconds:.1f} s")
    return {"worst": worst, "trained": trained,
            "checks": checks, "rows": rows, "seconds": seconds}


def train_arch_records(tarchs):
    """The kernels line's records of the new K1f shapes, launches from the
    train run of the family they come from: that key at that (m, n, k)
    over its steps and the profiled one, and in its first step."""
    records = []
    for row in tarchs["rows"]:
        run = tarchs["trained"].get(K1F_ARCH_RUN[row["gemm"].split()[0]])
        shape = (row["program"], row["m"], row["n"], row["k"])
        launches, per_step = ((run["shape_launches"].get(shape, 0),
                               run["shape_launches_per_step"].get(shape, 0))
                              if run else (0, 0))
        if run and not launches:
            raise AssertionError(f"{row['gemm']}: the {run['arch']} train "
                                 f"run launched no {shape}")
        records.append({
            "name": f"ca_gemm_program[{row['program']}] {row['gemm']}",
            "route": "cuda", "source": SOURCE, "replaces": REPLACES,
            "launches": launches, "launches_per_step": per_step,
            "max_abs_err": tarchs["worst"][row["program"], row["gemm"]],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "matmul_ms": row["matmul_ms"],
            "k1_route": want_route(torch.bfloat16, row["m"]),
            "shape": f"{row['gemm']} m={row['m']} n={row['n']} "
                     f"k={row['k']} bf16, {row['out']} out; launches: "
                     f"{row['program']} at this m, n, k over the "
                     f"{run['arch'] if run else '(not run)'} train run"})
    return records


def print_train_archs(tarchs, card_line):
    for name, out in tarchs["trained"].items():
        prof = out["profile"]
        line = (f"e2e train {name} ({out['layers']} layers; {card_line}): "
                f"step {out['step_ms']:.3f} ms, "
                f"{out['tokens_per_s']:.1f} tokens/s, bound "
                f"{out['bound_ms']:.3f} ms (remat adds "
                f"{out['remat_ms']:.3f}), model-work share "
                f"{out['model_work_share']:.4f}, busy share "
                f"{prof['device_busy_share']:.4f}, K1 share of the step "
                f"{prof['k1_share_of_step']:.4f}, peak "
                f"{out['peak_memory_gb']:.3f} GB, "
                f"{out['launches_per_step']} K1 launches a step")
        if "expert_capacity_ms" in out:
            line += (f"; the expert loop's capacity work "
                     f"{out['expert_capacity_ms']:.3f} ms vs the routed "
                     f"tokens' {out['expert_routed_ms']:.3f}")
        print(line)
        print(f"e2e train {name} routes {out['routes']}")
    for name, chk in tarchs["checks"].items():
        print(f"e2e train {name} {TRAIN_CHECK_LAYERS.get(name, 2)}-layer "
              "card vs CPU " + json.dumps(chk))
    print(f"e2e train archs phase {tarchs['seconds']:.1f} s")


# ---------------------------------------------------------------------------
# dist: the distributed serve path (dist_matmul and the TP decode block)
# ---------------------------------------------------------------------------

# Eight ranks: one a card under NCCL where the host has as many cards,
# else all on the one card over gloo (NCCL refuses two ranks on a card),
# the ring's and the gather's buffers through pinned host copies.
DIST_WORLD = 8
# dist_matmul at a full-width stablelm-1.6b w_up shape, bf16: decode-sized
# and prefill-sized m, on the 2-D (data 2, model 4) and 3-D (pod 2, data
# 2, model 2) meshes.
DIST_M, DIST_K, DIST_N = (8, 1000), 2048, 5632
DIST_MESHES = (("2d", (2, 4), ("data", "model"), None),
               ("3d", (2, 2, 2), ("pod", "data", "model"), "pod"))
# A distributed product against the single-card K1 product of the same
# bf16 operands: fp32 partials summed in another order and rounded once
# to bf16, so 1e-3 of max|want| plus 1e-2 of each element.
DIST_ATOL, DIST_RTOL = 1e-3, 1e-2
# The TP decode block at stablelm-1.6b's full width, B = 8 (4 rows a
# rank, K1's decode route), 16 steps with the KV history appended.
TP_DIMS = dict(d_model=2048, n_heads=32, d_ff=5632)
TP_BATCH, TP_STEPS = 8, 16
# Against tp_decode_reference on the card: _tp_check's limits (1e-3 dense,
# 5e-3 int8w / w8a8), scaled to max|y_ref|.  In bf16 each projection's
# output and each residual add round to bf16, and an fp32 sum in another
# order (or the oracle's weights dequantized to bf16, where the ring's
# int8 partials take them in fp32) may round an ulp apart at each, which
# the attention and the residual carry on, so four bf16 ulps at the max
# (2^-6 of it) are added.  w8a8-ride runs with fp32 and with bf16
# activations, its per-tensor act scales calibrated per projection on the
# oracle's int8w run.  An activation a hair from a code boundary flips its
# int8 code on either side of an ulp of difference upstream, so its block
# is also allowed what one ulp of input moves the oracle itself (the
# witness, measured in the same run and printed), and each of its three
# projections is held without that allowance on the oracle's own inputs,
# where both sides take the same codes.
TP_LIMIT = {"ring": 1e-3, "allgather": 1e-3, "int8w": 5e-3,
            "w8a8-ride fp32": 5e-3, "w8a8-ride": 5e-3}
TP_ULPS = {"ring": 2.0 ** -6, "allgather": 2.0 ** -6, "int8w": 2.0 ** -6,
           "w8a8-ride fp32": 0.0, "w8a8-ride": 2.0 ** -6}
# The w8a8 projections, by their place among a step's 7 (q, k, v, o,
# gate, up, down).
TP_W8A8 = {"mlp/w_gate": 4, "mlp/w_up": 5, "mlp/w_down": 6}
# The fault step: the injected failure hits the 10th dispatch (wv's
# second ring step); its re-dispatch must be bit-equal.
TP_FAULT_AT = 9
# The ring-step local shapes of the phase, timed on each rank in turn:
# (m/dp, n/tp, k/tp) of the TP block's projections and of dist_matmul at
# m = 1000 on the 2-D mesh.
RING_SHAPES = (("tp q/k/v/o", 4, 512, 512), ("tp gate/up", 4, 1408, 512),
               ("tp down", 4, 512, 1408), ("dist m=1000", 500, 1408, 512))
DIST_WALL_REPS = 3


def _dist_inputs(m, dev, seed):
    gen = torch.Generator().manual_seed(seed)
    a = torch.randn(m, DIST_K, generator=gen).to(dev, torch.bfloat16)
    b = (torch.randn(DIST_K, DIST_N, generator=gen)
         / math.sqrt(DIST_K)).to(dev, torch.bfloat16)
    return a, b


def _k1_total():
    return sum(K.launch_counts.values())


def _pod_extra(schedule, pods, mloc, nloc, k, itemsize):
    """Wire bytes a dispatch moves over the pod axis past its plan: the
    cost model (the reference's) charges the pod axis only to summa25d,
    while allgather also gathers the A panel over pod and ring and
    ring_unpipelined also all-reduce the fp32 C block over pod."""
    if pods == 1 or schedule == "summa25d":
        return 0.0
    if schedule == "allgather":
        return float((pods - 1) * mloc * (k // pods) * itemsize)
    return 2.0 * (pods - 1) / pods * mloc * nloc * 4


def _dist_matmul_checks(dev, meshes, tp_of):
    """Every schedule and auto on both meshes at both m, against the
    single-card K1 product; each dispatch's K1 launches and the bytes
    its transfers moved against its plan; one wall a schedule (all ranks
    in step, between barriers; auto's is the schedule it ran)."""
    import torch.distributed as tdist

    from repro_torch.core import distributed as D

    rows = []
    for m in DIST_M:
        a, b = _dist_inputs(m, dev, 11 + m)
        want = OPS.fused_matmul(a, b, out_dtype=torch.float32)
        wmax = float(want.abs().max())
        for mname, (mesh, pod) in meshes.items():
            kspec = (pod, "model") if pod else "model"
            a_dt = _as_dtensor(a, mesh, ("data", kspec))
            b_dt = _as_dtensor(b, mesh, (None, "model"))
            for s in [s for s in D.SCHEDULES if s != "summa25d" or pod] + [
                    "auto"]:
                led = obs.GemmLedger(enabled=True)
                obs.set_ledger(led)
                before = _k1_total()
                before_w = dict(D.wire_bytes)
                got = D.dist_matmul(a_dt, b_dt, mesh, schedule=s,
                                    pod_axis=pod)
                launches = _k1_total() - before
                pods = 2 if pod else 1
                sent = D.wire_traffic(before_w, pods)
                rec = led.records[-1]
                ran = rec.schedule
                want_sent = rec.planned_bytes + _pod_extra(
                    ran, pods, rec.config["mloc"], rec.config["nloc"],
                    rec.k, 2)
                obs.reset_ledger()
                full = D.full_output(got, mesh).float()
                err = (full - want).abs()
                ok = bool((err <= DIST_ATOL * wmax
                           + DIST_RTOL * want.abs()).all())
                want_launches = tp_of[mname] if ran != "allgather" else 1
                wall = None
                if s != "auto":
                    tdist.barrier()
                    t0 = time.perf_counter()
                    for _ in range(DIST_WALL_REPS):
                        D.dist_matmul(a_dt, b_dt, mesh, schedule=ran,
                                      pod_axis=pod)
                    torch.cuda.synchronize()
                    wall = (time.perf_counter() - t0) / DIST_WALL_REPS * 1e3
                rows.append({"m": m, "mesh": mname, "schedule": s,
                             "ran": ran, "max_abs_err": float(err.max()),
                             "max_want": wmax, "ok": ok,
                             "launches": launches,
                             "want_launches": want_launches,
                             "sent_bytes": sent, "want_sent": want_sent,
                             "planned_bytes": rec.planned_bytes,
                             "wall_ms": wall})
    return rows


def _as_dtensor(full, mesh, spec):
    """The global value ``full`` (the same on every rank) as a DTensor
    placed by ``spec``: each rank keeps its chunk, no collective."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.core.distributed import placements_for

    return DTensor.from_local(full, mesh, [Replicate()] * mesh.ndim,
                              run_check=False).redistribute(
        mesh, placements_for(spec, mesh))


def _ring_shape_times(dev, timed):
    """K1 at each ring-step local shape against its plain version, and
    when ``timed`` its time, the plain version's, torch.matmul's (bf16
    out) and the bound."""
    from repro_torch.core.gemm import dist_local_matmul
    from repro_torch.tuning import get_registry

    gen = torch.Generator(device=dev).manual_seed(13)
    rows = []
    for name, m, n, k in RING_SHAPES:
        copies = max(2, math.ceil(120e6 / (k * n * 2))) if timed else 1
        a = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
        bs = [(torch.randn(k, n, generator=gen, device=dev)
               / math.sqrt(k)).to(torch.bfloat16) for _ in range(copies)]
        tile = get_registry().resolve_full(m, n, k, dtype=torch.bfloat16,
                                           epilogue="none").config
        got = dist_local_matmul(a, bs[0], tile=tile)
        ref = K.ca_gemm_program_reference(a, (bs[0],),
                                          out_dtype=torch.float32)
        err = float((got - ref).abs().max())
        ms = plain = lib = None
        if timed:
            ms = _time_ms(lambda i: dist_local_matmul(a, bs[i], tile=tile),
                          copies)
            plain = _time_ms(lambda i: K.ca_gemm_program_reference(
                a, (bs[i],), out_dtype=torch.float32), copies)
            lib = _time_ms(lambda i: torch.matmul(a, bs[i]), copies)
        b_ms, b_by = bound("none", m, k, n, torch.float32, torch.bfloat16)
        rows.append({"shape": name, "m": m, "n": n, "k": k,
                     "k1_route": K.tile_route((tile.bm, tile.bn, tile.bk)),
                     "ms": ms, "plain_ms": plain, "library_ms": lib,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "max_abs_err": err,
                     "tol": TOL_F32 * (1 + float(ref.abs().max()))})
        del a, bs
    return rows


def _taps():
    """An activation calibration that also keeps every input it records,
    in order (7 a TP decode step: q, k, v, o, gate, up, down)."""
    from repro_torch.quant.calibrate import ActivationCalibration, QuantConfig

    class Taps(ActivationCalibration):
        def __init__(self):
            super().__init__(QuantConfig(act_fmt="int8"))
            self.inputs = []

        def record(self, weight_shape, x):
            super().record(weight_shape, x)
            self.inputs.append(x)

    return Taps()


def _tp_oracle_run(p, xs, cfg, taps):
    """tp_decode_reference over the steps of ``xs`` with its KV history,
    inside ``taps``: the outputs."""
    from repro_torch.serve import tp as TP

    ys, kv = [], None
    with taps:
        for x in xs:
            y, kv = TP.tp_decode_reference(p, x, kv, cfg)
            ys.append(y)
    return ys


def _one_ulp_up(x):
    """``x`` with each nonzero element one ulp larger in magnitude."""
    bits = x.view({torch.bfloat16: torch.int16,
                   torch.float32: torch.int32}[x.dtype])
    return torch.where(x != 0, bits + 1, bits).view(x.dtype)


def _w8a8_witness(p, xs, cfg):
    """What one ulp of input moves in the w8a8 oracle itself: the oracle
    run on ``xs`` and on ``xs`` one ulp larger; the activation codes of
    the three w8a8 projections that change, and the output's move over
    max|y|.  Also returns the first run's recorded inputs."""
    from repro_torch.quant.scales import quantize_activation

    runs = []
    for inputs in (xs, [_one_ulp_up(x) for x in xs]):
        taps = _taps()
        runs.append((_tp_oracle_run(p, inputs, cfg, taps), taps.inputs))
    (y0, in0), (y1, in1) = runs
    flipped = {}
    for name, pos in TP_W8A8.items():
        s = p[name].act_scale
        codes = [(quantize_activation(in0[7 * t + pos], s, 0),
                  quantize_activation(in1[7 * t + pos], s, 0))
                 for t in range(len(xs))]
        flipped[name] = [sum(int((a != b).sum()) for a, b in codes),
                         sum(a.numel() for a, _ in codes)]
    move = max(float((a.float() - b.float()).abs().max())
               / float(a.float().abs().max()) for a, b in zip(y0, y1))
    return {"codes_flipped_of": flipped, "y_move_over_max": move}, in0


def _w8a8_ride_checks(p, placed, inputs, mesh):
    """Each w8a8 projection through dist_matmul (ring) on the oracle's
    own inputs of the first and last step, against the oracle's product
    of the same inputs: the same activation codes on both sides."""
    from repro_torch.core import distributed as D
    from repro_torch.quant.scales import fake_quant_activation

    rows = []
    for t in (0, TP_STEPS - 1):
        for name, pos in TP_W8A8.items():
            a, w = inputs[7 * t + pos], p[name]
            before = _k1_total()
            got = D.full_output(D.dist_matmul(a, placed[name], mesh,
                                              schedule="ring",
                                              out_dtype=a.dtype),
                                mesh).float()
            launches = _k1_total() - before
            want = (fake_quant_activation(a, w.act_scale, w.act_block)
                    .float() @ w.dequantize(a.dtype).float()).to(a.dtype)
            wmax = float(want.float().abs().max())
            err = float((got - want.float()).abs().max())
            rows.append({"step": t, "proj": name,
                         "max_err_over_max": err / wmax,
                         "launches": launches,
                         "ok": launches == 0 and err <= (
                             TP_LIMIT["w8a8-ride"]
                             + TP_ULPS["w8a8-ride"]) * wmax})
    return rows


def _tp_decode_checks(dev, mesh, tp):
    """The TP decode block at full width: ring, allgather, int8w and
    w8a8-ride (fp32 and bf16), 16 steps each against tp_decode_reference
    (w8a8-ride's allowed its witness); K1 launches a step; the w8a8
    projections on the oracle's inputs; the ledger's records against the
    cost model and the bytes sent; a fault step."""
    from repro_torch.core import distributed as D
    from repro_torch.core.gemm import gemm_fallback
    from repro_torch.quant.calibrate import activation_site
    from repro_torch.quant.scales import quantize
    from repro_torch.runtime.fault import FaultPlan
    from repro_torch.serve import tp as TP

    cfg = TP.TpDecodeConfig(**TP_DIMS)
    params = TP.init_tp_params(cfg, 0, torch.bfloat16, dev)
    rng = np.random.RandomState(12)
    xs = [torch.tensor(rng.randn(TP_BATCH, cfg.d_model) * 0.1,
                       dtype=torch.float32, device=dev)
          for _ in range(TP_STEPS)]
    xs16 = [x.to(torch.bfloat16) for x in xs]
    # int8w: the bf16 weights quantized per channel, beside the bf16 norm
    # gains (or fp32 ones for the fp32 block).
    q16 = {k: (quantize(v.float(), axis=-2, block=0) if v.dim() == 2
               else v) for k, v in params.items()}
    q32 = {k: (v if v.ndim == 2 else v.float()) for k, v in q16.items()}
    # w8a8: each MLP projection's per-tensor act scale calibrated on the
    # oracle's fp32 int8w run over the phase's inputs.
    cal = _taps()
    _tp_oracle_run(q32, xs, cfg, cal)
    scales = cal.scales()

    def w8a8(q):
        return dict(q, **{n: dataclasses.replace(
            q[n], act_scale=scales[activation_site(q[n].shape)],
            act_block=0) for n in TP_W8A8})

    q8_32, q8_16 = w8a8(q32), w8a8(q16)
    # The witness: what one ulp of input moves in the w8a8 oracle itself.
    witness16, taps16 = _w8a8_witness(q8_16, xs16, cfg)
    witness = {"bf16": witness16, "fp32": _w8a8_witness(q8_32, xs, cfg)[0]}
    allow = {"w8a8-ride": witness16["y_move_over_max"],
             "w8a8-ride fp32": witness["fp32"]["y_move_over_max"]}
    variants = (("ring", params, "ring", 7 * tp, xs16),
                ("allgather", params, "allgather", 7, xs16),
                ("int8w", q16, "ring", 0, xs16),
                ("w8a8-ride fp32", q8_32, "ring", 0, xs),
                ("w8a8-ride", q8_16, "ring", 0, xs16))
    out = {"variants": {}, "w8a8_witness": witness,
           "act_scales": {k: float(v) for k, v in scales.items()}}
    K.reset_launch_counts()
    placed_by = {}
    for name, p, sched, per_step, inputs in variants:
        c = dataclasses.replace(cfg, schedule=sched)
        placed = TP.place_tp_params(p, c, mesh)
        if name in ("ring", "w8a8-ride"):
            placed_by[name] = placed
        kv = kv_ref = None
        worst, launches, within, ok = 0.0, [], True, True
        t0 = time.perf_counter()
        for x in inputs:
            before = _k1_total()
            y, kv = TP.tp_decode_step(placed, x, kv, c, mesh)
            launches.append(_k1_total() - before)
            y_ref, kv_ref = TP.tp_decode_reference(p, x, kv_ref, c)
            yf, rf = y.float(), y_ref.float()
            err = (yf - rf).abs()
            rmax = float(rf.abs().max())
            limit = TP_LIMIT[name] + TP_ULPS[name]
            within = within and float(err.max()) <= limit * rmax
            ok = ok and float(err.max()) <= (limit
                                              + allow.get(name, 0.0)) * rmax
            worst = max(worst, float(err.max()) / rmax)
        torch.cuda.synchronize()
        out["variants"][name] = {
            "schedule": sched, "ok": ok and tuple(kv[0].shape) == (
                TP_BATCH, TP_STEPS, cfg.n_heads, cfg.head_dim)
            and bool(torch.isfinite(y.float()).all()),
            "within_limit": within, "witness_allowance": allow.get(name),
            "max_err_over_max": worst, "launches_per_step": launches,
            "want_per_step": per_step,
            "step_ms_with_reference": (time.perf_counter() - t0) * 1e3
            / TP_STEPS}
    out["k1_launches"] = dict(K.launch_counts)
    out["k1_shapes"] = {f"{key} m={m} n={n} k={k}": c for (key, m, n, k), c
                        in K.shape_counts.items()}
    # The w8a8 projections on the oracle's own bf16 inputs.
    out["w8a8_rides"] = _w8a8_ride_checks(q8_16, placed_by["w8a8-ride"],
                                          taps16, mesh)
    # The ledger: one dist record a projection, its planned bytes the
    # cost model's, their sum the bytes the rings sent.
    placed_ring = placed_by["ring"]
    led = obs.GemmLedger(enabled=True)
    obs.set_ledger(led)
    before = dict(D.wire_bytes)
    TP.tp_decode_step(placed_ring, xs16[0], None, cfg, mesh)
    sent = D.wire_traffic(before)
    obs.reset_ledger()
    recs = [r for r in led.records if getattr(r, "schedule", None)]
    dp = 2
    planned = sum(r.planned_bytes for r in recs)
    bytes_ok = len(recs) == 7 and sent == planned and all(
        r.planned_bytes == D.estimate_cost("ring", r.m, r.n, r.k, 2, dp,
                                           tp).comm_bytes for r in recs)
    out["ledger"] = {"records": len(recs), "ok": bytes_ok,
                     "planned_bytes": [r.planned_bytes for r in recs],
                     "sent_bytes": sent,
                     "modes": sorted({r.mode for r in recs})}
    # The fault step: an injected failure re-dispatches the same
    # schedule on every rank, bit-equal to a fault-free step.
    y0, _ = TP.tp_decode_step(placed_ring, xs16[0], None, cfg, mesh)
    fb0 = metric_value("gemm.fallback_total", "stage=dist_matmul")
    with gemm_fallback(True), FaultPlan(kernel_fail_at=(TP_FAULT_AT,)) \
            as plan:
        y1, _ = TP.tp_decode_step(placed_ring, xs16[0], None, cfg, mesh)
    out["fault"] = {
        "injected": [list(e) for e in plan.injected],
        "fallbacks": metric_value("gemm.fallback_total",
                                  "stage=dist_matmul") - fb0,
        "bit_equal": bool(torch.equal(y0, y1))}
    return out


def dist_rank(rank, world, backend, parts=("dist", "fsdp", "tp"),
              tp_archs=None):
    """One rank of the dist phase (run by ``spawn_ranks``): the
    distributed GEMM and TP decode checks, then the FSDP part and the
    tensor-parallel training part (of ``tp_archs``, default all of
    ``TP_ARCHS``)."""
    import torch.distributed as tdist

    from repro_torch.launch.mesh import make_mesh_compat, rank_device

    dev = rank_device(rank, backend)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"rank": rank, "device": str(dev),
           "backend": tdist.get_backend()}
    if "dist" in parts:
        out.update(_dist_rank_checks(rank, world, backend, dev))
    if "fsdp" in parts or "tp" in parts:
        out["fsdp"] = fsdp_rank(rank, world, dev, parts, tp_archs)
        tdist.barrier()
    return out


def _dist_rank_checks(rank, world, backend, dev):
    import torch.distributed as tdist

    from repro_torch.launch.mesh import make_mesh_compat

    t0 = time.perf_counter()
    meshes = {name: (make_mesh_compat(shape, axes), pod)
              for name, shape, axes, pod in DIST_MESHES}
    tp_of = {name: dict(zip(axes, shape))["model"]
             for name, shape, axes, _ in DIST_MESHES}
    out = {"rank": rank}
    out["dist_matmul"] = _dist_matmul_checks(dev, meshes, tp_of)
    # The ring-step shapes, one rank at a time: each rank checks K1
    # against its plain version; each rank with a card of its own times
    # them, and where the ranks share one card rank 0 alone does.
    timed = backend == "nccl" or rank == 0
    for r in range(world):
        tdist.barrier()
        if r == rank:
            out["ring_shapes"] = _ring_shape_times(dev, timed)
    tdist.barrier()
    out["tp"] = _tp_decode_checks(dev, meshes["2d"][0], tp_of["2d"])
    out["seconds"] = time.perf_counter() - t0
    return out


def _dist_failures(outs):
    bad = []
    for o in outs:
        r = o["rank"]
        for row in o["dist_matmul"]:
            if not row["ok"] or row["launches"] != row["want_launches"] \
                    or row["sent_bytes"] != row["want_sent"]:
                bad.append(f"rank {r} dist_matmul {row}")
        for row in o["ring_shapes"]:
            if row["max_abs_err"] > row["tol"]:
                bad.append(f"rank {r} ring-step K1 vs plain {row}")
        tp = o["tp"]
        for name, v in tp["variants"].items():
            if not v["ok"] or any(n != v["want_per_step"]
                                  for n in v["launches_per_step"]):
                bad.append(f"rank {r} tp {name} {v}")
        for row in tp["w8a8_rides"]:
            if not row["ok"]:
                bad.append(f"rank {r} w8a8 ride on the oracle's inputs {row}")
        if not tp["ledger"]["ok"]:
            bad.append(f"rank {r} ledger {tp['ledger']}")
        f = tp["fault"]
        if f["injected"] != [["kernel", TP_FAULT_AT]] \
                or f["fallbacks"] != 1 or not f["bit_equal"]:
            bad.append(f"rank {r} fault step {f}")
    return bad


def dist_phase(card_line, parts=("dist", "fsdp", "tp"), tp_archs=None):
    """The dist phase: eight ranks drive dist_matmul at every schedule and
    the full-width TP decode block, then four of them the FSDP part
    (``fsdp_rank``) and the tensor-parallel training part
    (``tp_train_part``, of ``tp_archs``, default all); any rank's failure
    fails it."""
    from repro_torch.launch.mesh import spawn_ranks

    phase("dist: dist_matmul and the tensor-parallel decode block, "
          f"{DIST_WORLD} ranks; then FSDP and FSDP x TP training on "
          f"{FSDP_RANKS} of them"
          if "dist" in parts else f"{' and '.join(parts)}: {DIST_WORLD} "
          f"ranks, {FSDP_RANKS} of them training")
    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= DIST_WORLD else "gloo"
    transport = ("NCCL, one rank a card" if backend == "nccl" else
                 "gloo transport, ranks sharing one card")
    print(f"dist backend {backend} ({transport}), cards {cards}, ranks "
          f"{DIST_WORLD}; {card_line}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    outs = spawn_ranks(dist_rank, DIST_WORLD, (backend, parts, tp_archs),
                       timeout=900, backend=backend)
    seconds = time.perf_counter() - t0
    res = {"outs": outs, "seconds": seconds, "backend": backend,
           "transport": transport}
    if "dist" in parts:
        _print_dist(outs, transport, card_line)
    if "fsdp" in parts:
        fsdp_s = max(o["fsdp"]["seconds"] for o in outs if o.get("fsdp"))
        res["fsdp"] = print_fsdp(outs, card_line)
        res["fsdp_seconds"] = fsdp_s
        print(f"fsdp phase {fsdp_s:.1f} s (the ranks' part; the spawn "
              f"{seconds:.1f} s in all; {card_line})")
    if "tp" in parts:
        tp_s = max(o["fsdp"]["tp"]["seconds"] for o in outs
                   if o.get("fsdp"))
        res["tp"] = print_tp(outs, card_line)
        res["tp_seconds"] = tp_s
        print(f"tp part {tp_s:.1f} s (the ranks' part; the spawn "
              f"{seconds:.1f} s in all; {card_line})")
    return res


def _print_dist(outs, transport, card_line):
    for o in outs:
        r = o["rank"]
        print(f"dist rank {r} on {o['device']} ({o['backend']}), "
              f"{o['seconds']:.1f} s")
        for row in o["ring_shapes"]:
            print(f"dist rank {r} ring-step K1 " + json.dumps(row))
        for row in o["dist_matmul"]:
            print(f"dist rank {r} dist_matmul " + json.dumps(row))
        tp = o["tp"]
        for name, v in tp["variants"].items():
            print(f"dist rank {r} tp {name} " + json.dumps(v))
        print(f"dist rank {r} tp w8a8 act scales "
              + json.dumps(tp["act_scales"]) + "; witness (one ulp of "
              "input, the oracle against itself) "
              + json.dumps(tp["w8a8_witness"]))
        for row in tp["w8a8_rides"]:
            print(f"dist rank {r} tp w8a8 ride on the oracle's bf16 inputs "
                  + json.dumps(row))
        print(f"dist rank {r} tp k1 launches {json.dumps(tp['k1_launches'])}"
              f" by shape {json.dumps(tp['k1_shapes'])}")
        print(f"dist rank {r} ledger {json.dumps(tp['ledger'])}; fault "
              + json.dumps(tp["fault"]))
    bad = _dist_failures(outs)
    if bad:
        raise AssertionError("dist phase:\n" + "\n".join(bad))
    walls = {}
    for o in outs:
        for row in o["dist_matmul"]:
            if row["wall_ms"] is None:
                continue
            key = (row["m"], row["mesh"], row["schedule"])
            walls[key] = max(walls.get(key, 0.0), row["wall_ms"])
    for row in outs[0]["dist_matmul"]:
        if row["schedule"] == "auto":
            print(f"e2e dist auto m={row['m']} {row['mesh']}: ran "
                  f"{row['ran']}")
    for (m, mesh, s), ms in sorted(walls.items()):
        print(f"e2e dist wall ({transport}; {card_line}) m={m} {mesh} {s}: "
              f"{ms:.3f} ms (slowest rank, mean of {DIST_WALL_REPS})")
    print(f"dist phase {max(o['seconds'] for o in outs):.1f} s (the "
          "ranks' dist checks)")


def dist_kernel_records(dres):
    """The kernels line's record of K1 at the TP block's ring-step shapes:
    launches from the float TP runs (rank 0; every rank launches the
    same), time at the gate/up step's local shape."""
    o = dres["outs"][0]
    row = next(r for r in o["ring_shapes"] if r["shape"] == "tp gate/up")
    err = max(r["max_abs_err"] for out in dres["outs"]
              for r in out["ring_shapes"])
    return [{
        "name": "ca_gemm_program[none] ring step", "route": "cuda",
        "source": SOURCE, "replaces": REPLACES,
        "launches": o["tp"]["k1_launches"].get("none", 0),
        "max_abs_err": err, "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": row["library_ms"], "k1_route": row["k1_route"],
        "shape": f"{row['shape']} m={row['m']} n={row['n']} k={row['k']} "
                 f"bf16, fp32 out ({dres['transport']})"}]


# ---------------------------------------------------------------------------
# FSDP training (run by the dist phase's ranks 0-3)
# ---------------------------------------------------------------------------

# Full-width stablelm-1.6b at 2 of its 24 layers (fp32 masters and both
# AdamW moments of the whole vocab: 6.2 GB a state), 2 steps of 8 x 128
# tokens, each rank's mask holding another count of tokens.  The dist
# phase's 8 ranks build a (rep 2, pod 2, data 2, model 1) mesh; rep 0's
# four ranks train, on (data 2) (pod 0's pair) and on (pod 2, data 2).
FSDP_LAYERS, FSDP_BATCH, FSDP_SEQ, FSDP_STEPS = 2, 8, 128, 2
FSDP_RANKS = 4
FSDP_MESHES = (("data2", 2), ("pod2xdata2", 4))
FSDP_MB = (1, 2)
FSDP_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
# The FSDP step against the single-process card step on the whole batch,
# PR 26's card tolerances for this family (TOL_LOSS, TOL_GRAD): the loss
# and grad_norm within TOL_LOSS relative; each leaf's change over the
# steps within TOL_GRAD relative L2 of the single-process step's change,
# or within FSDP_WITNESS_X times its witness where that is larger.  Both
# sum bf16 gradients in other orders (a rank's rows, then the fp32 mean
# over the ranks, against one GEMM over every row), and Adam's first
# update, g / (|g| + eps), turns a near-zero gradient's rounding into a
# move of up to lr: the witness is how far the single-process step
# itself moves on the same batch with its rows reversed (the same loss,
# its sums over rows in another order), measured in the same run and
# printed.  The FSDP step and the single-process step are two such
# orders, so their distance is held to twice the witness's (the
# embedding table's change: 5.3-5.9 % apart, its witness 4.0 %, every
# other leaf within TOL_GRAD, on an H100 80GB HBM3 at 700 W).
FSDP_WITNESS_X = 2.0
FSDP_COMPRESS_ROUNDS = 3


def _fsdp_cfg():
    return dataclasses.replace(get_config(ARCH), n_layers=FSDP_LAYERS)


def _fsdp_batch(cfg, step):
    """Global batch ``step``: SyntheticLM tokens (an ``embeds``
    frontend's rows from :class:`_EmbedRows`), a mask keeping all of
    rows 0-1, ~70 % of rows 2-3, 16 tokens of rows 4-5 and half of row 7,
    so the ranks' counts differ."""
    b = batch_for_model(cfg, DataConfig(
        vocab_size=cfg.vocab_size, seq_len=FSDP_SEQ,
        global_batch=FSDP_BATCH, seed=0), step,
        table=None if cfg.frontend == "tokens" else _EmbedRows(cfg.d_model))
    rng = np.random.RandomState(step)
    mask = np.ones((FSDP_BATCH, FSDP_SEQ), np.float32)
    mask[2:4] = (rng.rand(2, FSDP_SEQ) > 0.3).astype(np.float32)
    mask[4:6, 16:] = 0.0
    mask[7, FSDP_SEQ // 2:] = 0.0
    b["mask"] = mask
    return b


class _EmbedRows:
    """The embeds frontend's table for the FSDP x TP batches: the first
    TABLE_ROWS rows of ``data.pipeline.embed_table``'s (its
    ``RandomState(0)`` stream), a token's row at its id modulo TABLE_ROWS.
    The whole table (qwen2-vl-72b's 152064 x 8192) takes tens of seconds
    on the host, and each rank draws its batches itself."""

    _rows = {}

    def __init__(self, d):
        if d not in self._rows:
            self._rows[d] = (np.random.RandomState(0).randn(TABLE_ROWS, d)
                             .astype(np.float32) * 0.02)
        self.rows = self._rows[d]

    def __getitem__(self, tokens):
        return self.rows[tokens % TABLE_ROWS]


def _digest(t):
    """Two 64-bit checksums of a tensor's bits: their sum, and their sum
    weighted by position (wrapping), in chunks of 2^24 elements."""
    flat = t.detach().contiguous().view(-1)
    ints = {4: torch.int32, 2: torch.int16, 1: torch.int8}[
        flat.element_size()]
    bits = flat.view(ints)
    plain = weighted = 0
    step = 1 << 24
    for lo in range(0, bits.numel(), step):
        x = bits[lo:lo + step].long()
        idx = torch.arange(lo, lo + x.numel(), device=x.device,
                           dtype=torch.int64)
        plain += int(x.sum())
        weighted += int((x * ((idx * 2654435761 + 97) % 4294967291)).sum())
    return [plain % 2 ** 64, weighted % 2 ** 64]


def _chunk_digests(layout, tree, parts, first):
    """Digests of each leaf's chunks along its FSDP dim: the leaf held
    here is ``parts`` of the 4-way split starting at chunk ``first`` (a
    leaf held whole by every rank: one entry, ``"all"``)."""
    from repro_torch.checkpoint.manager import _flatten

    out = {}
    for key, t in _flatten(tree).items():
        name = key.split("/", 2)[-1] if key.startswith("opt/") else \
            key.split("/", 1)[-1]
        d = layout.dims.get(name) if key.startswith(("params/", "opt/m/",
                                                     "opt/v/")) else None
        if d is None:
            out[f"{key} all"] = _digest(t)
            continue
        n = t.shape[d] // parts
        for i in range(parts):
            out[f"{key} {first + i}"] = _digest(t.narrow(d, i * n, n))
    return out


# The second witness of the TP part: the fp32 masters scaled by
# 1 + PERTURB · N(0, 1) (seed 7), which moves about one bf16 weight in
# 4096 by an ulp, so every activation and gradient downstream rounds
# elsewhere, as the tensor-parallel step's partial sums do.
PERTURB = 2.0 ** -20


def _fsdp_single(cfg, dev, keep=None, tp=False, mbs=FSDP_MB):
    """The single-process card step on the whole batch, each microbatch
    count of ``mbs`` (run by rank 0 alone): its metrics, its final
    parameters (on the card or on ``keep``: the host, for a state too
    large to keep beside the ranks') and each leaf's squared change from
    the starting masters (``chg2``).  Then the witness: the same step
    with the batch's rows reversed (the same loss, every sum over rows
    in another order), each leaf's squared distance from the first run.
    With ``tp`` also each run's first clipped gradient (its first moment
    over 1 - b1) and a second witness, the step with its masters
    perturbed by ``PERTURB``: each leaf's squared distance from the
    first run in its change (``perturbed2``) and in its first gradient
    (``perturbed_grad2``, beside the first run's squared norm,
    ``grad_norm2``).  The starting masters are drawn again on the card
    where a distance needs them (:func:`_start_masters`), never kept."""
    keep = keep or dev
    b1 = adamw.AdamWConfig(**FSDP_OPT).b1

    def kept(tree):
        return {k: v.to(keep) for k, v in tree.items()}

    out = {}
    for mb in mbs + (("reversed", "perturbed") if tp else ("reversed",)):
        state = T.init_state(cfg, seed=0, device=dev)
        if mb == "perturbed":
            _perturb_(state.params, dev)
        step_fn = T.build_train_step(
            cfg, adamw.AdamWConfig(**FSDP_OPT),
            microbatches=mb if mb in mbs else 1, donate=True)
        metrics = []
        for i in range(FSDP_STEPS):
            b = T.cast_batch(_fsdp_batch(cfg, i), cfg, dev)
            if mb == "reversed":
                b = {k: v.flip(0) for k, v in b.items()}
            state, m = step_fn(state, b)
            metrics.append({k: float(v) for k, v in m.items()})
            if i == 0 and tp and mb in mbs:
                out[f"grad0 {mb}"] = kept({k: v / (1 - b1) for k, v in
                                           state.opt.m.items()})
            if i == 0 and tp and mb == mbs[0]:
                out["grad_norm2"] = {k: _sq_norm([(1, v / (1 - b1))], dev)
                                     for k, v in state.opt.m.items()}
            if i == 0 and mb == "perturbed":
                g0 = out[f"grad0 {mbs[0]}"]
                out["perturbed_grad2"] = {k: _sq_norm(
                    [(1, v / (1 - b1)), (-1, g0[k])], dev)
                    for k, v in state.opt.m.items()}
        one = out[mbs[0]]["final"] if mb not in mbs else None
        if mb == "perturbed":
            start = _start_masters(cfg, dev, perturbed=True)
            st = _start_masters(cfg, dev)
            out["perturbed2"] = {k: _sq_norm(
                [(1, state.params[k]), (-1, start[k]), (-1, one[k]),
                 (1, st[k])], dev) for k in one}
            del start, st
        elif mb == "reversed":
            # the witness now, so that the reversed run's parameters are
            # let go of before the next run
            out["witness2"] = {k: _sq_norm(
                [(1, state.params[k]), (-1, one[k])], dev) for k in one}
            out["reversed_metrics"] = metrics
        else:
            st = _start_masters(cfg, dev)
            out[mb] = {"metrics": metrics, "final": kept(state.params),
                       "chg2": {k: _sq_norm([(1, v), (-1, st[k])], dev)
                                for k, v in state.params.items()}}
            del st
        del state, step_fn
        torch.cuda.empty_cache()
    return out


def _start_masters(cfg, dev, perturbed=False):
    """The fp32 masters every single-process run starts from
    (``train.step.init_state``'s, seed 0), drawn again on the card: as
    quick as a copy kept on the host is to bring back (qwen2-vl-72b's
    8.5 GB), and nothing held between; ``perturbed``: the perturbed
    run's (:func:`_perturb_`)."""
    params = M.init_params(cfg, 0, dev, masters=True)
    if perturbed:
        _perturb_(params, dev)
    return params


def _perturb_(params, dev):
    """Each of the masters scaled in place by 1 + PERTURB · N(0, 1), from
    one generator of seed 7 in the tree's order."""
    gen = torch.Generator(device=dev).manual_seed(7)
    for v in params.values():
        v.mul_(1 + PERTURB * torch.randn(v.shape, generator=gen,
                                         device=dev))


def _sq_norm(terms, dev, chunk=1 << 26):
    """The fp64 sum of squares of ``sum(c * t for c, t in terms)`` (the
    tensors of one shape, on the card or the host), summed over chunks of
    ``chunk`` elements moved to ``dev``: a whole fp64 copy of qwen2-vl's
    head (1.25 G elements) alone would take 10 GB of the card."""
    flat = [(c, t.reshape(-1)) for c, t in terms]
    total = 0.0
    for lo in range(0, flat[0][1].numel(), chunk):
        x = sum(c * t[lo:lo + chunk].to(dev).double() for c, t in flat)
        total += float((x * x).sum())
    return total


def _fsdp_run(cfg, dev, layout, hooks, mb, group):
    """FSDP steps of one (mesh, microbatch count): per step the global
    metrics, the wall (all ranks in step), this rank's K1 launches and
    routes."""
    import torch.distributed as tdist

    state = layout.init_state(0, dev)
    step_fn = T.build_train_step(cfg, adamw.AdamWConfig(**FSDP_OPT),
                                 microbatches=mb, reshard_params=hooks[0],
                                 reshard_grads=hooks[1], donate=True)
    want = {k: n * mb for k, n in train_counts_per_step(cfg).items()}
    steps = []
    for i in range(FSDP_STEPS):
        b = layout.local_batch(T.cast_batch(_fsdp_batch(cfg, i), cfg, dev))
        before, routes = dict(K.launch_counts), dict(K.route_counts)
        tdist.barrier(group=group)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, b)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launches = {k: n - before.get(k, 0) for k, n in
                    K.launch_counts.items() if n != before.get(k, 0)}
        steps.append({"step": i + 1, "wall_ms": wall,
                      "metrics": {k: float(v) for k, v in m.items()},
                      "local_tokens": int(b["labels"].shape[0]
                                          * b["labels"].shape[1]),
                      "mask_tokens": float(b["mask"].sum()),
                      "launches": launches, "want": want,
                      "routes": route_delta(routes)})
    return {"steps": steps}, state


def _fsdp_compressed(dev, mesh4, rank):
    """``allreduce_compressed`` over ``pod`` on card tensors (shapes of
    two stablelm shards, gradients of mixed scales), three rounds feeding
    the residual back: against the plain mean (``none``), within half an
    int8 step or half a bf16 ulp of the largest value a rank sent; the
    error-feedback identity (the sum of the compressed reductions plus
    the residuals equals the true sum)."""
    from repro_torch.core.distributed import _Axis

    gen = torch.Generator(device=dev).manual_seed(100 + rank)
    ax = _Axis(mesh4, "pod", dev)
    out = {}
    for mode in ("int8", "bf16"):
        ef = {"w_up": torch.zeros(2, 512, 5632, device=dev),
              "norm": torch.zeros(2, 512, device=dev)}
        worst, worst_ef = 0.0, 0.0
        for r in range(FSDP_COMPRESS_ROUNDS):
            g = {k: torch.randn(v.shape, generator=gen, device=dev)
                 * 10.0 ** (-3 - r) for k, v in ef.items()}
            gf = {k: g[k] + ef[k] for k in g}
            mean, _ = adamw.allreduce_compressed(gf, {}, "pod", "none",
                                                 mesh4)
            red, new_ef = adamw.allreduce_compressed(g, ef, "pod", mode,
                                                     mesh4)
            for k in g:
                top = float(ax.all_reduce(gf[k].abs().max(),
                                          op=torch.distributed.ReduceOp.MAX))
                # a rank's rounding: half an int8 step of the shared
                # scale, or half a bf16 ulp (2^-8 relative)
                lim = (0.5 * top / 127.0 if mode == "int8"
                       else 2.0 ** -8 * top) * (1 + 1e-5) + 1e-6 * top
                worst = max(worst, float((red[k] - mean[k]).abs().max())
                            / lim)
                # n·red + Σ residuals = Σ (g + ef): nothing lost
                lhs = red[k] * ax.size + ax.all_reduce(new_ef[k])
                rhs = ax.all_reduce(gf[k])
                worst_ef = max(worst_ef, float((lhs - rhs).abs().max())
                               / (1e-6 * ax.size * top))
            ef = new_ef
        out[mode] = {"worst_over_limit": worst,
                     "ef_identity_over_limit": worst_ef}
    return out


def _fsdp_checkpoint(cfg, dev, state, layouts, meshes, rank, group):
    """The (pod 2, data 2) state saved from the 4 ranks, then restored on
    2 ranks (pod 0's pair, on the (data 2) mesh) and on 1 rank (rank 2,
    a one-rank mesh) at once; every chunk's digest of each layout, and
    on rank 0 its own chunk against its 2-rank restore, bit for bit."""
    import shutil

    import torch.distributed as tdist

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import specs as S

    path = ROOT / "build" / "fsdp_ckpt"
    if rank == 0:
        shutil.rmtree(path, ignore_errors=True)
    tdist.barrier(group=group)
    mgr = CheckpointManager(str(path))
    out = {}
    sds, sh4 = S.state_inputs(cfg, meshes["pod2xdata2"])
    lay4 = layouts["pod2xdata2"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.save(FSDP_STEPS, state, shardings=sh4)
    out["save_s"] = time.perf_counter() - t0
    out["live"] = _chunk_digests(lay4, state, 1, rank)
    t0 = time.perf_counter()
    if rank in (0, 1):
        _, sh2 = S.state_inputs(cfg, meshes["data2"])
        got = mgr.restore(sds, device=dev, shardings=sh2)
        torch.cuda.synchronize()
        out["restore2_s"] = time.perf_counter() - t0
        out["restore2"] = _chunk_digests(lay4, got, 2, 2 * rank)
        if rank == 0:
            from repro_torch.checkpoint.manager import _flatten

            live, back = _flatten(state), _flatten(got)
            equal = True
            for key, t in live.items():
                if t.dim() and t.shape != back[key].shape:
                    d = next(i for i, (a, b) in enumerate(
                        zip(t.shape, back[key].shape)) if a != b)
                    equal &= bool(torch.equal(
                        t, back[key].narrow(d, 0, t.shape[d])))
                else:
                    equal &= bool(torch.equal(t, back[key]))
            out["rank0_chunk_bit_equal"] = equal
        del got
    if rank == 2:
        _, sh1 = S.state_inputs(cfg, meshes["one"])
        got = mgr.restore(sds, device=dev, shardings=sh1)
        torch.cuda.synchronize()
        out["restore1_s"] = time.perf_counter() - t0
        out["restore1"] = _chunk_digests(lay4, got, 4, 0)
        del got
    torch.cuda.empty_cache()
    tdist.barrier(group=group)
    out["checkpoint_gb"] = sum(
        f.stat().st_size for f in path.rglob("*") if f.is_file()) / 1e9
    tdist.barrier(group=group)
    if rank == 0:
        shutil.rmtree(path, ignore_errors=True)
    return out


def fsdp_rank(rank, world, dev, parts=("fsdp", "tp"), tp_archs=None):
    """This rank's part of the FSDP phase and of the tensor-parallel
    training part of ``tp_archs`` (default all of ``TP_ARCHS``; every
    dist rank calls it: the meshes and the group are built by all; ranks
    past FSDP_RANKS wait)."""
    import torch.distributed as tdist

    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.train import fsdp

    t_start = time.perf_counter()
    # the dist checks' cached blocks back to the card, on every rank
    gc.collect()
    torch.cuda.empty_cache()
    full = make_mesh_compat((world // FSDP_RANKS, 2, 2, 1),
                            ("rep", "pod", "data", "model"))
    tp_mesh = make_mesh_compat((world // FSDP_RANKS, 2, 2),
                               ("rep", "data", "model"))["data", "model"]
    group = tdist.new_group(list(range(FSDP_RANKS)))
    if rank >= FSDP_RANKS:
        return None
    meshes = {"pod2xdata2": full["pod", "data", "model"],
              "data2": full["data", "model"], "one": full["model"]}
    cfg = _fsdp_cfg()
    hooks = {name: fsdp.weight_hoist(cfg, meshes[name])
             for name, _ in FSDP_MESHES}
    layouts = {name: h[0].layout for name, h in hooks.items()}
    pod = full.get_local_rank("pod")
    # the single-process step once, on rank 0, which gathers each FSDP
    # run's parameters to hold them against it
    tp_archs = tuple(tp_archs or TP_ARCHS)
    t0 = time.perf_counter()
    single = (_fsdp_single(cfg, dev, tp="tp" in parts) if rank == 0 and (
        "fsdp" in parts or ARCH in tp_archs) else None)
    out = {"rank": rank, "single_s": time.perf_counter() - t0, "runs": {}}
    if single is not None:
        out["single"] = {mb: single[mb]["metrics"] for mb in FSDP_MB}
        out["reversed"] = single["reversed_metrics"]
    tdist.barrier(group=group)
    last = None
    for name, ranks in (FSDP_MESHES if "fsdp" in parts else ()):
        for mb in FSDP_MB:
            if ranks == 2 and pod != 0:
                tdist.barrier(group=group)
                continue
            lay = layouts[name]
            run, state = _fsdp_run(cfg, dev, lay, hooks[name], mb,
                                   group if ranks == 4 else
                                   meshes["data2"].get_group("data"))
            # each leaf's squared distance from the single-process step's
            dist = _sq_dists(lay, state.params,
                             single[mb]["final"] if rank == 0 else None)
            if rank == 0:
                run["dist2"] = {k: d2 for k, (d2, _) in dist.items()}
                run["chg2"] = single[mb]["chg2"]
                run["witness2"] = single["witness2"]
            out["runs"][f"{name} mb{mb}"] = run
            if name == "pod2xdata2" and mb == FSDP_MB[-1]:
                last = state
            else:
                del state
            torch.cuda.empty_cache()
            if ranks == 2:
                tdist.barrier(group=group)
    if "tp" in parts:
        # the TP part drops stablelm's single-process step once it has
        # used it
        box = [single]
        del single
        out["tp"] = tp_train_part(rank, dev, tp_mesh, box, group,
                                  tp_archs)
    else:
        del single
    torch.cuda.empty_cache()
    if "fsdp" in parts:
        out["compressed"] = _fsdp_compressed(dev, meshes["pod2xdata2"],
                                             rank)
        out["checkpoint"] = _fsdp_checkpoint(cfg, dev, last, layouts,
                                             meshes, rank, group)
    del last
    torch.cuda.empty_cache()
    # the FSDP part's own seconds (the TP part reports its own)
    out["seconds"] = time.perf_counter() - t_start - out.get(
        "tp", {}).get("seconds", 0.0)
    return out


def _fsdp_failures(outs):
    """Every check of the FSDP phase, against the single-process step and
    across ranks; returns (failures, summary)."""
    bad = []
    fs = [o["fsdp"] for o in outs if o.get("fsdp")]
    single = fs[0]["single"]
    summary = {}
    for name, ranks in FSDP_MESHES:
        for mb in FSDP_MB:
            key = f"{name} mb{mb}"
            runs = [f["runs"][key] for f in fs[:ranks]]
            worst_metric = 0.0
            for i in range(FSDP_STEPS):
                want = single[mb][i]
                for r, run in enumerate(runs):
                    s = run["steps"][i]
                    for m in ("loss", "grad_norm"):
                        rel = abs(s["metrics"][m] - want[m]) / abs(want[m])
                        worst_metric = max(worst_metric, rel)
                        if not (math.isfinite(s["metrics"][m])
                                and rel <= TOL_LOSS):
                            bad.append(f"{key} rank {r} step {i + 1} {m} "
                                       f"{s['metrics'][m]} vs {want[m]}")
                    if s["launches"] != s["want"]:
                        bad.append(f"{key} rank {r} step {i + 1} K1 "
                                   f"launches {s['launches']} != "
                                   f"{s['want']}")
                    if s["routes"] != {f"wgmma {k}": n
                                       for k, n in s["want"].items()}:
                        bad.append(f"{key} rank {r} step {i + 1} routes "
                                   f"{s['routes']}")
            worst_leaf, worst_over = 0.0, 0.0
            run0 = runs[0]          # rank 0 holds the whole leaves
            witness = {k: math.sqrt(run0["witness2"][k] / c2) if c2 else 0.0
                       for k, c2 in run0["chg2"].items()}
            for k, d2 in run0["dist2"].items():
                c2 = run0["chg2"][k]
                rel = math.sqrt(d2 / c2) if c2 else math.sqrt(d2)
                lim = max(TOL_GRAD, FSDP_WITNESS_X * witness[k])
                worst_leaf = max(worst_leaf, rel)
                worst_over = max(worst_over, rel / lim)
                if not rel <= lim:
                    bad.append(f"{key} {k}: change {rel} > {lim} "
                               f"(the larger of {TOL_GRAD} and "
                               f"{FSDP_WITNESS_X} times its witness)")
            counts = sorted({run["steps"][0]["mask_tokens"] for run in runs})
            if len(counts) < 2:
                bad.append(f"{key}: every rank holds {counts} mask tokens")
            summary[key] = {
                "ranks": ranks, "local_tokens":
                    runs[0]["steps"][0]["local_tokens"],
                "mask_tokens_by_rank": [run["steps"][0]["mask_tokens"]
                                        for run in runs],
                "worst_metric_rel": worst_metric,
                "worst_leaf_change_rel_l2": worst_leaf,
                "worst_leaf_over_limit": worst_over,
                "witness_rel_l2_by_leaf": witness,
                "k1_launches_per_step": sum(runs[0]["steps"][0][
                    "launches"].values()),
                "step_wall_ms": [max(run["steps"][i]["wall_ms"]
                                     for run in runs)
                                 for i in range(FSDP_STEPS)]}
    for f in fs:
        for mode, c in f["compressed"].items():
            if not (c["worst_over_limit"] <= 1.0
                    and c["ef_identity_over_limit"] <= 1.0):
                bad.append(f"rank {f['rank']} compressed {mode} {c}")
    digests = {}
    for f in fs:
        ck = f["checkpoint"]
        for part in ("live", "restore2", "restore1"):
            for key, d in ck.get(part, {}).items():
                digests.setdefault(key, {})[(f["rank"], part)] = tuple(d)
    parts_seen = collections.Counter()
    for key, seen in digests.items():
        if len(set(seen.values())) != 1:
            bad.append(f"checkpoint {key}: digests differ {seen}")
        for (_, part) in seen:
            parts_seen[part] += 1
    if not fs[0]["checkpoint"].get("rank0_chunk_bit_equal"):
        bad.append("checkpoint: rank 0's chunk differs from its restore")
    if not (parts_seen["live"] and parts_seen["restore2"]
            and parts_seen["restore1"]):
        bad.append(f"checkpoint: digests missing {dict(parts_seen)}")
    summary["checkpoint"] = {
        "gb": fs[0]["checkpoint"]["checkpoint_gb"],
        "save_s": max(f["checkpoint"]["save_s"] for f in fs),
        "restore_on_2_s": max(f["checkpoint"].get("restore2_s", 0.0)
                              for f in fs),
        "restore_on_1_s": max(f["checkpoint"].get("restore1_s", 0.0)
                              for f in fs),
        "chunks_compared": len(digests), "digests": dict(parts_seen)}
    summary["compressed"] = {f"rank {f['rank']}": f["compressed"]
                             for f in fs}
    return bad, summary


def print_fsdp(outs, card_line):
    phase(f"fsdp: full-width {ARCH} at {FSDP_LAYERS} of its 24 layers, "
          f"FSDP on (data 2) and (pod 2, data 2), {FSDP_STEPS} steps of "
          f"{FSDP_BATCH} x {FSDP_SEQ} tokens; compressed all-reduce; "
          "elastic restore")
    fs = [o["fsdp"] for o in outs if o.get("fsdp")]
    for f in fs:
        print(f"fsdp rank {f['rank']}: {f['seconds']:.1f} s" + (
            f" (single-process steps {f['single_s']:.1f} s)"
            if f["rank"] == 0 else ""))
        for key, run in f["runs"].items():
            for s in run["steps"]:
                print(f"fsdp rank {f['rank']} {key} step {s['step']} "
                      + json.dumps({k: s[k] for k in (
                          "metrics", "wall_ms", "local_tokens",
                          "mask_tokens", "launches", "routes")}))
    print("fsdp single-process card step on the whole batch "
          + json.dumps(fs[0]["single"]) + "; its rows reversed (the "
          "witness) " + json.dumps(fs[0]["reversed"]))
    bad, summary = _fsdp_failures(outs)
    for key, row in summary.items():
        print(f"fsdp summary {key} " + json.dumps(row))
    print(f"e2e fsdp step walls (gloo transport through pinned host copies, "
          f"ranks sharing one card, not NVLink; {card_line}): "
          + json.dumps({k: v["step_wall_ms"] for k, v in summary.items()
                        if "step_wall_ms" in v}))
    if bad:
        raise AssertionError("fsdp phase:\n" + "\n".join(bad))
    return summary


def fsdp_kernel_records(outs, fsdp_seconds):
    """The kernels line's record of K1 on the FSDP path: the forward GLU
    with save_preact at the (pod 2, data 2) ranks' 256 local tokens,
    against its plain version and timed here; launches are rank 0's over
    its FSDP runs."""
    m = FSDP_BATCH * FSDP_SEQ // 4
    worst = k1f_parity([(GLU_SAVE, "fsdp gate+up fwd", m, 5632, 2048, None,
                         torch.bfloat16)], "the FSDP rank-local shape", 15)
    (row,) = k1f_times([(GLU_SAVE, "fsdp gate+up fwd", m, 5632, 2048,
                         None)], "K1 at the FSDP rank-local shape")
    f0 = next(o["fsdp"] for o in outs if o.get("fsdp"))
    launches = sum(s["launches"].get(GLU_SAVE, 0)
                   for run in f0["runs"].values() for s in run["steps"])
    return [{
        "name": f"ca_gemm_program[{GLU_SAVE}] fsdp step", "route": "cuda",
        "source": SOURCE, "replaces": REPLACES, "launches": launches,
        "max_abs_err": max(worst.values()), "ms": row["ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        "k1_route": "wgmma",
        "shape": f"gate+up m={m} n=5632 k=2048 bf16 (rank 0 of (pod 2, data "
                 f"2); the phase {fsdp_seconds:.1f} s)"}]


# ---------------------------------------------------------------------------
# FSDP x TP training (run by the dist phase's ranks 0-3, after the FSDP part)
# ---------------------------------------------------------------------------

# Full width, FSDP over data 2 and tensor parallelism over model 2: the
# dense GQA stablelm-1.6b at the FSDP part's 2 of 24 layers (its
# single-process card step is the FSDP part's), the MoE + MLA
# deepseek-v2-lite-16b at 1 of its 27 (its fp32 state, 12 GB at one
# layer with 64 experts, whole on rank 0 for the single-process step and
# kept on the host beside the four ranks' quarters; 2 layers fit, 11.7
# GB a rank, but cost the smoke its time limit), the Mamba2 stack
# mamba2-370m at 2 of its 48 layers (16 SSD heads a rank) and zamba2-7b
# at 6 of its 81 (one full group: one shared-block application; 56 SSD
# heads a rank).  Each in the compute dtype of its config (bf16) at
# microbatches 1 and 2 (the Mamba2 archs: 1, for the smoke's time; the
# CPU tests hold their microbatches), and in fp32 at microbatch 1.  Then
# h2o-danube-3-4b (a window of 8192, past the 128 tokens), minicpm3-4b
# (q-LoRA MLA, 20 heads a rank) and musicgen-large (the codebook heads
# over embeds) at 2 layers; granite-20b (one KV head, read whole; a GELU
# MLP), mixtral-8x7b (4 of its 8 experts a rank beside GQA: 1.71 B
# parameters at one layer) and qwen2-vl-72b (M-RoPE over embeds; its
# 1.25 B-parameter head: 2.12 B at one layer) at 1, the single-process
# step's results kept on the host: bf16 at microbatch 1, and granite and
# musicgen, which carry the whole KV head and the codebook heads'
# input-gradient sum, fp32 at microbatch 1 too.
TP_ARCHS = {ARCH: FSDP_LAYERS, "deepseek-v2-lite-16b": 1,
            "mamba2-370m": 2, "zamba2-7b": 6, "h2o-danube-3-4b": 2,
            "minicpm3-4b": 2, "musicgen-large": 2, "granite-20b": 1,
            "mixtral-8x7b": 1, "qwen2-vl-72b": 1}
TP_MESH = (2, 2)
# The single-process step's results (its start, finals and first
# gradients) stay on the card for a configuration of at most this many
# parameters (mixtral-8x7b at one layer, 1.72 G: 20.6 GB beside the four
# ranks' 11 GB each), and on the host above it (qwen2-vl-72b at one
# layer, 2.12 G: its ranks take 15.3 GB each), where each run moves
# them over PCIe both ways (mixtral's, kept there: the single-process
# steps 26.1 s and the checks 12.3 s of its 51.5 s on an H100).
TP_REF_ON_CARD = 1.8e9
# (dtype, microbatches) of each arch's runs.  The fp32 step holds the
# layout to TOL_F32, where the bf16 steps' limits take witnesses: for
# deepseek it is the one exact check of the MoE path (router and routing
# gradients, the experts' split, MLA's partial leaves).
TP_RUNS = {ARCH: [("bfloat16", 1), ("bfloat16", 2), ("float32", 1)],
           "deepseek-v2-lite-16b": [("bfloat16", 1), ("bfloat16", 2),
                                    ("float32", 1)],
           "mamba2-370m": [("bfloat16", 1), ("float32", 1)],
           "zamba2-7b": [("bfloat16", 1), ("float32", 1)],
           "h2o-danube-3-4b": [("bfloat16", 1)],
           "minicpm3-4b": [("bfloat16", 1)],
           "musicgen-large": [("bfloat16", 1), ("float32", 1)],
           "granite-20b": [("bfloat16", 1), ("float32", 1)],
           "mixtral-8x7b": [("bfloat16", 1)],
           "qwen2-vl-72b": [("bfloat16", 1)]}


def tp_counts_per_step(cfg, tp):
    """K1 launches of one tensor-parallel train step of a rank:
    ``train_counts_per_step``'s at the rank's local shapes, the experts
    ``E / tp`` of them, and each row-parallel projection (``wo``,
    ``w_down``, the shared experts' down) K1's ``none`` program with an
    fp32 output where the single-card step drains the residual (``res``):
    the same count of launches, keyed ``none``.  A Mamba2 layer's
    in_proj is one launch on its heads' columns and its out_proj one
    row-parallel ``none``, as on one card."""
    if cfg.moe is not None and cfg.moe.n_experts:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=cfg.moe.n_experts // tp))
    counts = collections.Counter(train_counts_per_step(cfg))
    counts["none"] += counts.pop("res", 0)
    return dict(counts)


def _tp_init(lay, dev, group):
    """The layout's train state, drawn one rank at a time (each rank
    draws the whole fp32 masters before keeping its quarter)."""
    import torch.distributed as tdist

    state = None
    for r in range(FSDP_RANKS):
        tdist.barrier(group=group)
        if r == tdist.get_rank():
            state = lay.init_state(0, dev)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
    tdist.barrier(group=group)
    return state


def _sq_dists(lay, tree, want, scale=1.0):
    """Each leaf of the rank-local ``tree`` (times ``scale``): its squared
    distance from ``want``'s leaf and ``want``'s squared norm, on the
    mesh's first rank (a collective of the mesh's ranks).  Each slice of
    a leaf goes once, from the first rank that holds it, to the first
    rank, which sums over the slices on the card: no leaf is assembled
    whole (``NamedSharding.gather``'s cats and copies cost the host more
    than the transfer)."""
    import torch.distributed as tdist

    grid = lay.mesh.mesh
    ranks = [int(r) for r in grid.flatten()]
    coords = {r: dict(zip(lay.mesh.mesh_dim_names,
                          (int(i) for i in (grid == r).nonzero()[0])))
              for r in ranks}
    me, first = tdist.get_rank(), ranks[0]
    out = {}
    for k in sorted(tree):
        shape = lay.defs[k].shape
        holder = {}           # each distinct slice -> the first rank with it
        for r in ranks:
            sl = lay.shardings[k].local_slices(shape, coords[r])
            holder.setdefault(tuple((s.start, s.stop) for s in sl), r)
        local = (tree[k] * scale).contiguous()
        pinned = local.is_cuda
        if me != first:
            if me in holder.values():
                buf = torch.empty(local.shape, dtype=local.dtype,
                                  pin_memory=pinned)
                tdist.send(buf.copy_(local), dst=first)
            continue
        w = want[k] if want is not None else None    # the card or the host
        d2 = 0.0
        for sl, r in holder.items():
            blk = local
            if r != first:
                buf = torch.empty(local.shape, dtype=local.dtype,
                                  pin_memory=pinned)
                tdist.recv(buf, src=r)
                blk = buf.to(local.device, non_blocking=True)
            if w is not None:
                d2 += _sq_norm([(1, blk), (-1, w[tuple(
                    slice(a, b) for a, b in sl)])], local.device)
        if w is not None:
            out[k] = [d2, _sq_norm([(1, w)], local.device)]
    return out


def _tp_run(cfg, dev, lay, hooks, mb, group, ref):
    """Tensor-parallel steps of one microbatch count: per step the global
    metrics, the wall (all ranks in step), this rank's K1 launches and
    routes, and the bytes each ``model``-axis site all-reduced; after the
    first step each leaf's clipped gradient, and after the last its
    parameters, held on rank 0 against ``ref``'s (the single-process
    step's; the seconds those checks take, ``check_s``)."""
    import torch.distributed as tdist

    from repro_torch.core import distributed as D

    state = _tp_init(lay, dev, group)
    opt = adamw.AdamWConfig(**FSDP_OPT)
    step_fn = T.build_train_step(cfg, opt, microbatches=mb,
                                 reshard_params=hooks[0],
                                 reshard_grads=hooks[1], donate=True)
    want = {k: n * mb for k, n in tp_counts_per_step(cfg,
                                                     lay.model).items()}
    route = "wgmma" if cfg.dtype() == torch.bfloat16 else "simt"
    steps = []
    run = {"route": route}
    torch.cuda.reset_peak_memory_stats()
    for i in range(FSDP_STEPS):
        b = lay.local_batch(T.cast_batch(_fsdp_batch(cfg, i), cfg, dev))
        before, routes = dict(K.launch_counts), dict(K.route_counts)
        wire = dict(D.tp_wire_bytes)
        tdist.barrier(group=group)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, b)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launches = {k: n - before.get(k, 0) for k, n in
                    K.launch_counts.items() if n != before.get(k, 0)}
        steps.append({"step": i + 1, "wall_ms": wall,
                      "metrics": {k: float(v) for k, v in m.items()},
                      "local_tokens": int(b["labels"].shape[0]
                                          * b["labels"].shape[1]),
                      "mask_tokens": float(b["mask"].sum()),
                      "launches": launches, "want": want,
                      "routes": route_delta(routes),
                      "wire": {k: v - wire.get(k, 0) for k, v in
                               D.tp_wire_bytes.items()
                               if v != wire.get(k, 0)},
                      "want_wire": lay.tp_wire_plan(
                          FSDP_SEQ, int(b["labels"].shape[0]), mb)})
        if i == 0:
            t0 = time.perf_counter()
            run["grad2"] = _sq_dists(lay, state.opt.m, ref and ref[
                f"grad0 {mb}"], 1.0 / (1 - opt.b1))
            run["check_s"] = time.perf_counter() - t0
    run["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    t0 = time.perf_counter()
    run["final2"] = _sq_dists(lay, state.params,
                              ref and ref[mb]["final"])
    run["check_s"] += time.perf_counter() - t0
    run["steps"] = steps
    del state, step_fn
    torch.cuda.empty_cache()
    return run


def tp_train_part(rank, dev, mesh, box, group, archs):
    """This rank's part of the tensor-parallel training check: for each
    of ``archs`` and each (dtype, microbatches) of ``TP_RUNS``, the
    single-process card step on the whole batch (on rank 0; stablelm's
    bf16 one is the FSDP part's, ``box``'s one item, dropped after use;
    the others kept on the host), then the FSDP x TP steps, each leaf's
    gradient and parameters sent to rank 0 slice by slice
    (:func:`_sq_dists`) to hold them against the single-process
    step's."""
    import torch.distributed as tdist

    from repro_torch.train import fsdp

    t_start = time.perf_counter()
    # Segments that grow in place: the single-process step of
    # qwen2-vl-72b (its 1.25 G-parameter head's AdamW temporaries, 4.64
    # GiB each) otherwise finds the card's free memory in blocks too
    # small, beside the other seven ranks' contexts.
    with warnings.catch_warnings():     # renamed, not yet gone
        warnings.simplefilter("ignore", FutureWarning)
        torch.cuda.memory._set_allocator_settings(
            "expandable_segments:True")
    out = {"rank": rank, "archs": archs, "runs": {}, "single_s": {},
           "single": {}, "reversed": {}}
    for name in archs:
        layers = TP_ARCHS[name]
        for dt in dict.fromkeys(d for d, _ in TP_RUNS[name]):
            cfg = dataclasses.replace(get_config(name), n_layers=layers,
                                      compute_dtype=dt)
            mbs = tuple(mb for d, mb in TP_RUNS[name] if d == dt)
            key = f"{name} {dt}"
            if name == ARCH and dt == get_config(name).compute_dtype:
                ref = box.pop()
            else:
                t0 = time.perf_counter()
                on_card = sum(math.prod(d.shape) for d in M.model_defs(
                    cfg).values()) <= TP_REF_ON_CARD
                ref = (_fsdp_single(cfg, dev, None if on_card else "cpu",
                                    tp=True, mbs=mbs)
                       if rank == 0 else None)
                out["single_s"][key] = time.perf_counter() - t0
                tdist.barrier(group=group)
            if rank == 0:
                out["single"][key] = {mb: ref[mb]["metrics"] for mb in mbs}
                out["reversed"][key] = ref["reversed_metrics"]
            hooks = fsdp.weight_hoist(cfg, mesh)
            lay = hooks[0].layout
            t0 = time.perf_counter()
            for mb in mbs:
                run = _tp_run(cfg, dev, lay, hooks, mb, group, ref)
                if rank == 0:
                    run["chg2"] = ref[mb]["chg2"]
                    for w in ("witness2", "perturbed2", "grad_norm2",
                              "perturbed_grad2"):
                        run[w] = ref[w]
                out["runs"][f"{key} mb{mb}"] = run
            if rank == 0:
                print(f"tp {key}: the single-process steps "
                      f"{out['single_s'].get(key, 0.0):.1f} s, the TP runs "
                      f"{time.perf_counter() - t0:.1f} s (at "
                      f"{time.perf_counter() - t_start:.1f} s)", flush=True)
            del ref
            torch.cuda.empty_cache()
            tdist.barrier(group=group)
    out["seconds"] = time.perf_counter() - t_start
    return out


def _tp_failures(outs):
    """Every check of the tensor-parallel part, against the
    single-process step and across ranks; returns (failures, summary).
    Each leaf: its first clipped gradient within the larger of TOL_GRAD
    (TOL_F32 in fp32) and FSDP_WITNESS_X times its witness (the
    single-process step with its masters perturbed by PERTURB) relative
    L2 of the single-process step's, and its change over the steps
    within the larger of TOL_GRAD and FSDP_WITNESS_X times the larger of
    its two witnesses (the batch's rows reversed, the FSDP part's; the
    masters perturbed: the tensor-parallel step's partial sums round its
    bf16 activations and gradients elsewhere, which the row order alone
    does not, and an MoE step then routes some tokens elsewhere)."""
    bad = []
    tps = [o["fsdp"]["tp"] for o in outs if o.get("fsdp")]
    summary = {}
    for name in tps[0]["archs"]:
        layers = TP_ARCHS[name]
        for dt, mb in TP_RUNS[name]:
            key = f"{name} {dt} mb{mb}"
            single = tps[0]["single"][f"{name} {dt}"]
            runs = [t["runs"][key] for t in tps]
            f32 = dt == "float32"
            tol_metric = TOL_F32 if f32 else TOL_LOSS
            worst_metric = 0.0
            for i in range(FSDP_STEPS):
                want = single[mb][i]
                for r, run in enumerate(runs):
                    s = run["steps"][i]
                    for m in ("loss", "grad_norm"):
                        rel = abs(s["metrics"][m] - want[m]) / abs(want[m])
                        worst_metric = max(worst_metric, rel)
                        if not (math.isfinite(s["metrics"][m])
                                and rel <= tol_metric):
                            bad.append(f"tp {key} rank {r} step {i + 1} "
                                       f"{m} {s['metrics'][m]} vs {want[m]}")
                    if s["launches"] != s["want"]:
                        bad.append(f"tp {key} rank {r} step {i + 1} K1 "
                                   f"launches {s['launches']} != "
                                   f"{s['want']}")
                    if s["routes"] != {f"{run['route']} {k}": n
                                       for k, n in s["want"].items()}:
                        bad.append(f"tp {key} rank {r} step {i + 1} routes "
                                   f"{s['routes']}")
                    wire = dict(s["wire"])
                    norm = wire.pop("norm", 0)
                    if wire != s["want_wire"] or not 0 < norm <= 16:
                        bad.append(f"tp {key} rank {r} step {i + 1} wire "
                                   f"bytes {s['wire']} != {s['want_wire']}"
                                   " (+ the norm's two scalars)")
            run0 = runs[0]          # rank 0 holds the whole leaves
            tol_grad = TOL_F32 if f32 else TOL_GRAD
            worst_grad = worst_leaf = worst_over = 0.0
            witness, grad_over = {}, {}
            for k, (d2, w2) in run0["grad2"].items():
                rel = math.sqrt(d2 / w2) if w2 else math.sqrt(d2)
                n2 = run0["grad_norm2"][k]
                wit = math.sqrt(run0["perturbed_grad2"][k] / n2) if n2 \
                    else 0.0
                lim = max(tol_grad, FSDP_WITNESS_X * wit)
                worst_grad = max(worst_grad, rel)
                grad_over[k] = rel / lim
                if not rel <= lim:
                    bad.append(f"tp {key} {k}: first gradient {rel} > {lim} "
                               f"relative L2 (the larger of {tol_grad} and "
                               f"{FSDP_WITNESS_X} times its witness {wit})")
            for k, (d2, _) in run0["final2"].items():
                c2 = run0["chg2"][k]
                wit = [math.sqrt(run0[w][k] / c2) if c2 else 0.0
                       for w in ("witness2", "perturbed2")]
                witness[k] = wit
                rel = math.sqrt(d2 / c2) if c2 else math.sqrt(d2)
                lim = max(TOL_GRAD, FSDP_WITNESS_X * max(wit))
                worst_leaf = max(worst_leaf, rel)
                worst_over = max(worst_over, rel / lim)
                if not rel <= lim:
                    bad.append(f"tp {key} {k}: change {rel} > {lim} "
                               f"(the larger of {TOL_GRAD} and "
                               f"{FSDP_WITNESS_X} times its witnesses "
                               f"{wit})")
            summary[key] = {
                "layers": layers, "mesh": "data 2, model 2",
                "local_tokens": runs[0]["steps"][0]["local_tokens"],
                "mask_tokens_by_rank": [run["steps"][0]["mask_tokens"]
                                        for run in runs],
                "worst_metric_rel": worst_metric,
                "worst_first_gradient_rel_l2": worst_grad,
                "worst_first_gradient_over_limit": max(grad_over.values()),
                "first_gradient_over_limit_by_leaf": grad_over,
                "worst_leaf_change_rel_l2": worst_leaf,
                "worst_leaf_over_limit": worst_over,
                "witnesses_rel_l2_by_leaf (rows reversed, masters "
                "perturbed)": witness,
                "k1_launches_per_step": sum(runs[0]["steps"][0][
                    "launches"].values()),
                "tp_wire_bytes_per_step": runs[0]["steps"][0]["wire"],
                "peak_gb_by_rank": [run["peak_gb"] for run in runs],
                "step_wall_ms_by_rank": [[s["wall_ms"] for s in run["steps"]]
                                         for run in runs],
                "step_wall_ms": [max(run["steps"][i]["wall_ms"]
                                     for run in runs)
                                 for i in range(FSDP_STEPS)]}
    return bad, summary


def tp_planned_bytes(name, layers, rows, mb):
    """The dry run's planned tensor-parallel all-reduce bytes of the same
    config, mesh and microbatch count (``launch.dryrun.tp_reduce_bytes``),
    printed beside the counted ones (ROADMAP.md §3 reconciles them)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import abstract_mesh

    cfg = dataclasses.replace(get_config(name), n_layers=layers)
    return dryrun.tp_reduce_bytes(cfg, "train", FSDP_SEQ, rows,
                                  abstract_mesh(TP_MESH, ("data", "model")),
                                  mb)


def print_tp(outs, card_line):
    tps = [o["fsdp"]["tp"] for o in outs if o.get("fsdp")]
    phase("tp: FSDP x TP on (data 2, model 2), full width: "
          + ", ".join(f"{n} at {TP_ARCHS[n]} of {get_config(n).n_layers} "
                      "layers" for n in tps[0]["archs"])
          + f"; {FSDP_STEPS} steps of {FSDP_BATCH} x {FSDP_SEQ} tokens")
    for t in tps:
        print(f"tp rank {t['rank']}: {t['seconds']:.1f} s" + (
            f" (single-process steps {json.dumps(t['single_s'])} s; "
            "the checks of the first gradients and the parameters "
            + json.dumps({k: r["check_s"] for k, r in t["runs"].items()})
            + " s)" if t["rank"] == 0 else ""))
        for key, run in t["runs"].items():
            for s in run["steps"]:
                print(f"tp rank {t['rank']} {key} step {s['step']} "
                      + json.dumps({k: s[k] for k in (
                          "metrics", "wall_ms", "local_tokens",
                          "mask_tokens", "launches", "routes", "wire")}))
    print("tp single-process card step on the whole batch "
          + json.dumps(tps[0]["single"]) + "; its rows reversed (the "
          "witness) " + json.dumps(tps[0]["reversed"]))
    bad, summary = _tp_failures(outs)
    for key, row in summary.items():
        name, dt, mb = key.split(" ")
        row["planned_tp_bytes_per_step"] = tp_planned_bytes(
            name, TP_ARCHS[name], FSDP_BATCH // TP_MESH[0], int(mb[2:]))
        print(f"tp summary {key} " + json.dumps(row))
    print(f"e2e tp step walls by rank (gloo transport through pinned host "
          f"copies, ranks sharing one card, not NVLink; {card_line}): "
          + json.dumps({k: v["step_wall_ms_by_rank"]
                        for k, v in summary.items()}))
    if bad:
        raise AssertionError("tp part:\n" + "\n".join(bad))
    return summary


# (key, GEMM, m, n, k, out dtype) of K1 at stablelm-1.6b's,
# mamba2-370m's and granite-20b's local shapes on (data 2, model 2): 4 x
# 128 tokens a rank, n or k halved; mamba2's in_proj on its 16 heads'
# columns (z and x 1024 each, B and C 256, dt 16); granite's GELU w_up
# with its rms prologue and saved preacts, and its row-parallel w_down.
TP_K1_GEMMS = [
    ("none", "tp wq fwd", 512, 1024, 2048, None),
    ("none nt", "tp wq dx", 512, 2048, 1024, torch.float32),
    ("none tn", "tp wq dW", 2048, 1024, 512, None),
    (GLU_SAVE, "tp gate+up fwd", 512, 2816, 2048, None),
    ("none", "tp wo row-parallel", 512, 2048, 1024, torch.float32),
    ("none", "tp w_down row-parallel", 512, 2048, 2816, torch.float32),
    ("none", "tp head", 512, 50176, 2048, torch.float32),
    ("none", "tp mamba2 in_proj fwd", 512, 2320, 1024, None),
    ("none nt", "tp mamba2 in_proj dx", 512, 1024, 2320, torch.float32),
    ("none tn", "tp mamba2 in_proj dW", 1024, 2320, 512, None),
    ("none", "tp mamba2 out_proj row-parallel", 512, 1024, 1024,
     torch.float32),
    (GELU_SAVE, "tp granite w_up fwd", 512, 12288, 6144, None),
    ("none", "tp granite w_down row-parallel", 512, 6144, 12288,
     torch.float32)]


def tp_kernel_records(outs, tp_seconds):
    """K1 at the tensor-parallel local shapes against its plain version
    and timed (kernel, plain version, the same layout's torch.matmul,
    bound); the kernels line's records are the row-parallel w_down's,
    its launches rank 0's ``none`` launches over its bf16 runs;
    mamba2-370m's local in_proj's, its launches rank 0's ``none``
    launches over mamba2-370m's bf16 runs (in_proj, out_proj and the
    head); and granite-20b's local GELU w_up with its saved preacts and
    its row-parallel w_down, their launches rank 0's ``rms>gelu``
    save_preact and ``none`` launches over granite's bf16 runs (the
    latter also its q, k, v, o and head)."""
    cases = [(key, name, m, n, k, od, torch.bfloat16)
             for key, name, m, n, k, od in TP_K1_GEMMS]
    worst = k1f_parity(cases, "the tensor-parallel local shapes", 16)
    rows = k1f_times(TP_K1_GEMMS, "K1 at the tensor-parallel local shapes")
    t0 = next(o["fsdp"]["tp"] for o in outs if o.get("fsdp"))

    def launches(key, arch=None):
        return sum(s["launches"].get(key, 0)
                   for run_key, run in t0["runs"].items()
                   if "bfloat16" in run_key
                   and (arch is None or run_key.startswith(arch + " "))
                   for s in run["steps"])

    def record(name, gemm, n_launches, shape, library="library_ms",
               extra=None):
        row = next(r for r in rows if r["gemm"] == gemm)
        return dict({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES, "launches": n_launches,
            "max_abs_err": max(worst.values()), "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row[library],
            "k1_route": "wgmma",
            "shape": shape.format(**row)}, **(extra or {}))

    out = [record(
        "ca_gemm_program[none] tp row-parallel", "tp w_down row-parallel",
        launches("none"),
        "w_down m={m} n={n} k={k} bf16, fp32 out (rank 0 of (data 2, "
        f"model 2); the part {tp_seconds:.1f} s)",
        extra={"matmul_bf16_out_ms": next(
            r for r in rows if r["gemm"] == "tp w_down row-parallel")[
                "matmul_ms"]})]
    mamba = launches("none", "mamba2-370m")
    if mamba:
        # torch.matmul of the same bf16 operands, bf16 out: the function
        out.append(record(
            "ca_gemm_program[none] tp mamba2 in_proj",
            "tp mamba2 in_proj fwd", mamba,
            "in_proj m={m} n={n} k={k} bf16 (16 heads' z, x, dt columns "
            "and B, C whole; rank 0 of (data 2, model 2))",
            library="matmul_ms"))
    granite = launches(GELU_SAVE, "granite-20b")
    if granite:
        out += [record(
            f"ca_gemm_program[{GELU_SAVE}] tp granite w_up",
            "tp granite w_up fwd", granite,
            "w_up m={m} n={n} k={k} bf16, the rms prologue, GELU and the "
            "fp32 preacts saved (rank 0 of (data 2, model 2))"), record(
            "ca_gemm_program[none] tp granite row-parallel",
            "tp granite w_down row-parallel",
            launches("none", "granite-20b"),
            "w_down m={m} n={n} k={k} bf16, fp32 out (rank 0 of (data 2, "
            "model 2))")]
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    t_start = time.perf_counter()
    card_line = card()
    if argv == ["--only", "robust"]:
        # A partial run for work on the robust phase alone: the two
        # sources its paths launch, no kernels line, no result.
        build((K.SOURCE, FA.SOURCE))
        res = robust_phase(get_config(ARCH))
        print("e2e robust " + json.dumps(res, default=str))
        print(f"total {time.perf_counter() - t_start:.1f} s (partial run)")
        return
    if argv[:2] == ["--only", "train"]:
        # A partial run for work on the train_archs phase alone (the
        # configurations named after it, default all): only K1's source,
        # no kernels line, no result.
        prefetch_tables([n for n in PREFETCH_TABLES
                         if n in (argv[2:] or TRAIN_ARCHS)])
        build((K.SOURCE,))
        wait_tables()
        tarchs = train_archs(argv[2:])
        print_train_archs(tarchs, card_line)
        for record in train_arch_records(tarchs):
            print("record " + json.dumps(record))
        print(f"total {time.perf_counter() - t_start:.1f} s (partial run)")
        return
    if argv in (["--only", "dist"], ["--only", "fsdp"]) or (
            argv[:2] == ["--only", "tp"]
            and set(argv[2:]) <= set(TP_ARCHS)):
        # A partial run for work on the dist phase alone (with its FSDP
        # and TP parts), or on the FSDP part or the TP part alone (of the
        # configurations named after it, default all): only K1's source,
        # no kernels line, no result.
        build((K.SOURCE,))
        parts = {"dist": ("dist", "fsdp", "tp"), "fsdp": ("fsdp",),
                 "tp": ("tp",)}[argv[1]]
        dres = dist_phase(card_line, parts, tuple(argv[2:]) or None)
        records = []
        if "dist" in parts:
            records += dist_kernel_records(dres)
        if "fsdp" in parts:
            records += fsdp_kernel_records(dres["outs"],
                                           dres["fsdp_seconds"])
        if "tp" in parts:
            records += tp_kernel_records(dres["outs"], dres["tp_seconds"])
        for record in records:
            print("record " + json.dumps(record))
        print(f"total {time.perf_counter() - t_start:.1f} s (partial run)")
        return
    if argv[:2] == ["--only", "archs"]:
        # A partial run for work on the architectures phase alone (the
        # architectures named after it, default all): only the two
        # sources its paths launch, no kernels line, no result.
        prefetch_tables([n for n in PREFETCH_TABLES
                         if n in (argv[2:] or SERVED_ARCHS)])
        build((K.SOURCE, FA.SOURCE))
        wait_tables()
        print_archs(architectures(argv[2:]), card_line)
        print(f"total {time.perf_counter() - t_start:.1f} s (partial run)")
        return
    if argv:
        raise SystemExit("usage: chip_smoke.py [--only archs [ARCH ...] | "
                         "--only train [ARCH ...] | --only robust | "
                         f"--only dist | --only fsdp | --only tp [ARCH ...]], "
                         f"got {argv}")
    prefetch_tables()
    build()
    worst = parity()
    worst.update(quant_parity())
    for (key, _), err in k1f_parity().items():
        worst[key] = max(worst.get(key, 0.0), err)
    faults = fault_phase()
    FA.reset_launch_counts()
    worst_attn, worst_wide = attn_parity()
    wide_launches = FA.route_counts.get(FA.WIDE, 0)
    wait_tables()
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
    obs_res = obs_phase(cfg)
    robust = robust_phase(cfg)
    train_launches, train = train_slice(cfg)
    train_check = cross_check_train(cfg)
    tarchs = train_archs()
    rows = times()
    qrows = quant_times(rows)
    attn_rows = attn_times()
    frows = k1f_times()
    k1g = min_plus_phase()
    k3 = flash_fwd_phase()
    k4 = k_outer_phase()
    archs = architectures()
    dres = dist_phase(card_line)
    phase("summary")
    print(f"card: {card_line}")
    print_archs(archs, card_line)
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
    print("e2e obs " + json.dumps(obs_res))
    print("e2e robust " + json.dumps(robust, default=str))
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
        "name": f"distance_product[{MIN_PLUS}]", "route": "cuda",
        "source": DISTANCE_SOURCE, "replaces": REPLACES,
        "launches": k1g["launches"], "max_abs_err": k1g["max_abs_err"],
        "ms": grow["ms"], "plain_ms": grow["plain_ms"],
        "bound_ms": grow["bound_ms"], "bound_by": grow["bound_by"],
        "library_ms": None, "k1_route": "minplus",
        "bound_ms_at_held_clock": grow["issue_bound_held_ms"],
        "shape": grow["case"]})
    for fam, frow in faults.items():
        kernels.append({
            "name": f"ca_gemm_program[{frow['program']}] ({fam})",
            "route": "cuda", "source": SOURCE, "replaces": REPLACES,
            "launches": frow["launches"], "max_abs_err": frow["max_abs_err"],
            "ms": frow["ms"], "plain_ms": frow["plain_ms"],
            "bound_ms": frow["bound_ms"], "bound_by": frow["bound_by"],
            "library_ms": None, "k1_route": "simt",
            "shape": f"m={frow['m']} n={frow['n']} k={frow['k']} "
                     f"A {frow['A']}"})
    wrow = next(r for r in attn_rows if r["case"] == ATTN_WIDE)
    kernels.append({
        "name": f"{FA.NAME}[wide D] (F3)", "route": "cuda",
        "source": ATTN_SOURCE, "replaces": ATTN_REPLACES,
        "launches": wide_launches, "max_abs_err": worst_wide,
        "ms": wrow["ms"], "plain_ms": wrow["plain_ms"],
        "bound_ms": wrow["bound_ms"], "bound_by": wrow["bound_by"],
        "library_ms": None,
        "shape": f"B={wrow['B']} S={wrow['S']} page={wrow['page']} "
                 f"H={wrow['H']} Hkv={wrow['Hkv']} D={wrow['D']} "
                 f"Dv={wrow['Dv']} bf16"})
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
          f"{k1g['apsp_ms']:.3f} ms wall ({k1g['apsp_device_ms']:.3f} ms "
          f"between events; scipy Dijkstra {k1g['scipy_s']:.3f} s on the "
          f"host), max relative error {k1g['max_rel_err']:.3e}")
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
    print_train_archs(tarchs, card_line)
    kernels += arch_kernel_records(archs, attn_rows)
    kernels += train_arch_records(tarchs)
    kernels += dist_kernel_records(dres)
    kernels += fsdp_kernel_records(dres["outs"], dres["fsdp_seconds"])
    kernels += tp_kernel_records(dres["outs"], dres["tp_seconds"])
    # Only the robust phase's plans failed, degraded, refused or
    # re-dispatched anything: every later phase added nothing.
    print("guarded counters at the end " + json.dumps(
        check_guarded("end of the script", ROBUST_GUARDED)))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
