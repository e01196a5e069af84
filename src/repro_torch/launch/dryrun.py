"""The multi-pod dry run as a plan (port of ``repro/launch/dryrun.py``):
every (arch x shape x mesh) cell reported per device, with no compile.

The reference lowers and compiles each cell with XLA on the production
mesh (16 x 16, or 2 x 16 x 16 with ``--multi-pod``) and reads its
artifact from the compiled program.  The port has no compiled program
to read, so it reports from the plan, for the same cells, meshes and
command line:

* **exact**, equal to the reference's compile: ``memory.argument_bytes``
  (the rank-local shard bytes of every input, from ``launch.specs``:
  the train state and batch; the serve weights and the prompt; the
  weights, the decode token, the cache and the step scalar),
  ``memory.alias_bytes`` (the donated inputs: the state for train, the
  cache for decode), ``chips``, ``seq_len``, ``global_batch``,
  ``n_params`` and ``n_active_params``.
* **planned**, under ``plan``: ``flops_per_device``, each K1 GEMM of the
  step at its rank-local shape (m the rank's tokens, n and k cut by the
  tensor-parallel specs; a train step's forward, its remat recompute and
  the two backward GEMMs, for every microbatch; routed experts at their
  capacity rows) plus attention (QK^T and PV over the visible keys; x3
  in training, x4 with remat).  The plain einsums the reference also
  compiles (the router, MLA's ``wkv_b`` expansion, the SSD scan, the
  codebook heads) are not counted.  ``collective_bytes_by_kind``: the
  bytes a rank sends for the weight-hoist hooks' FSDP all-gather,
  reduce-scatter and whole-leaf all-reduce
  (``train.fsdp.FsdpLayout.step_bytes``), and the all-reduces the
  tensor-parallel specs imply (each row-parallel GEMM's output, in
  training also each column-parallel GEMM's input gradient, and the
  vocab-sharded embedding lookup), each at its fp32 buffer's bytes as
  the reference's HLO walk counts them.  ``dist_matmul``: for each serve
  GEMM that can ride ``core.distributed.dist_matmul``
  (``sharding.rules.dist_operand_specs``), the schedule
  ``choose_schedule`` picks at the cell's global shape and its planned
  wire bytes (``estimate_cost``), a per-GEMM schedule report apart from
  the totals.
* ``memory.temp_bytes`` is null: it is the compiled program's scratch,
  and nothing here schedules buffers.

Usage:
  python -m repro_torch.launch.dryrun --arch mixtral-8x7b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import traceback
from typing import Dict, List, Optional

import torch

from repro_torch.configs import (SHAPES, ModelConfig, applicable_shapes,
                                 get_config, list_archs)
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import (axis_sizes, batch_axes,
                                     make_production_mesh, n_chips)
from repro_torch.sharding.rules import (NamedSharding, dist_operand_specs,
                                        pspecs_for_defs, spec_axes)

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "build", "dryrun")

# Serving weights only FSDP-shard when TP alone does not fit HBM.
SERVE_FSDP = {"qwen2-vl-72b"}

# Per-arch microbatch counts for train_4k (the reference's).  Default 8.
TRAIN_MICROBATCHES = {"zamba2-7b": 16}

# The weights each step runs through K1, by the last part of their key
# (the router, MLA's wkv_b, the SSD scan and the codebook heads are
# einsums) and the program each runs in.
GEMM_TAGS = {"wq": "none", "wk": "none", "wv": "none", "wq_a": "none",
             "wq_b": "none", "wkv_a": "none", "wo": "res",
             "w_gate": "glu", "w_up": "glu", "w_down": "res",
             "in_proj": "none", "out_proj": "none", "w_in": "none",
             "w": "none"}
F32 = 4


def _size(sizes, entry) -> int:
    return math.prod(sizes[a] for a in spec_axes(entry))


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def _microbatches(arch: str, shape, mesh, microbatches=None) -> int:
    """The reference's count, cut so each microbatch still splits over
    every batch shard."""
    if microbatches is None:
        microbatches = TRAIN_MICROBATCHES.get(arch, 8)
    sizes = axis_sizes(mesh)
    shards = math.prod(sizes[a] for a in batch_axes(mesh))
    return min(microbatches, max(1, shape.global_batch // shards))


def _local_rows(B: int, mesh) -> int:
    """Sequences a rank holds of a global batch of ``B`` (the specs'
    batch split, or all of them)."""
    baxes, total = S._batch_spec(mesh, B)
    return B // total if baxes else B


def step_gemms(cfg: ModelConfig, kind: str, seq_len: int, rows: int,
               mesh) -> List[Dict]:
    """The K1 GEMMs of one forward pass over ``rows`` sequences of
    ``seq_len`` positions a rank (decode: one position), at their
    rank-local shapes: ``{"weight", "tag", "m", "n", "k", "count",
    "k_sharded", "n_sharded"}``."""
    from repro_torch.models import moe as MOE
    from repro_torch.models.model import model_defs, n_shared_applications

    sizes = axis_sizes(mesh)
    defs = model_defs(cfg)
    tp = pspecs_for_defs(defs, mesh, fsdp=False)
    tokens = rows * (1 if kind == "decode" else seq_len)
    out = []
    for key, d in defs.items():
        name = key.split("/")[-1]
        if name not in GEMM_TAGS or (name == "w" and len(d.shape) != 2):
            continue
        spec = tp[key]
        k = d.shape[-2] // _size(sizes, spec[-2])
        n = d.shape[-1] // _size(sizes, spec[-1])
        count = 1
        if d.axes[0] == "layers":
            count = d.shape[0]
        elif key.startswith("shared/"):
            count = n_shared_applications(cfg)
        m = tokens
        if "expert" in d.axes:
            i = d.axes.index("expert")
            count *= d.shape[i] // _size(sizes, spec[i])
            # every expert at its capacity rows: a group a sequence, one
            # group of the batch's tokens at decode
            m = (MOE.capacity(cfg, rows) if kind == "decode"
                 else rows * MOE.capacity(cfg, seq_len))
        out.append({"weight": key, "tag": GEMM_TAGS[name], "m": m, "n": n,
                    "k": k, "count": count,
                    "k_sharded": _size(sizes, spec[-2]) > 1,
                    "n_sharded": _size(sizes, spec[-1]) > 1})
    return out


def attention_flops(cfg: ModelConfig, kind: str, seq_len: int, rows: int,
                    mesh) -> float:
    """QK^T and PV of one forward pass a rank: causal (or windowed)
    visible pairs in prefill and train, the cache's keys at decode; heads
    cut by the model axis where the query projection's heads divide."""
    from repro_torch.models import attention as A
    from repro_torch.models.model import n_shared_applications

    if cfg.family == "ssm":
        return 0.0
    layers = (n_shared_applications(cfg) if cfg.shared_attn_every
              else cfg.n_layers)
    H = cfg.n_heads
    tp = axis_sizes(mesh).get("model", 1)
    if H % tp == 0:
        H //= tp
    if cfg.attn_kind == "mla":
        dqk = cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim
        dv = cfg.mla.v_head_dim
    else:
        dqk = dv = cfg.resolved_head_dim
    window = cfg.sliding_window
    if kind == "decode":
        pairs = A.cache_len_for(cfg, seq_len)
    elif window is None:
        pairs = seq_len * (seq_len + 1) / 2
    else:
        w = min(window, seq_len)
        pairs = w * (w + 1) / 2 + (seq_len - w) * w
    return 2.0 * rows * H * pairs * (dqk + dv) * layers


def _embed_sharded(cfg: ModelConfig, mesh) -> bool:
    from repro_torch.models.model import model_defs

    specs = pspecs_for_defs(model_defs(cfg), mesh)
    return ("embed/table" in specs
            and _size(axis_sizes(mesh), specs["embed/table"][0]) > 1)


def tp_reduce_bytes(cfg: ModelConfig, kind: str, seq_len: int, rows: int,
                    mesh, microbatches: int = 1,
                    gemms: Optional[List[Dict]] = None) -> Dict[str, float]:
    """The all-reduce bytes a rank sends over the tensor-parallel specs
    of one step (a train step's ``microbatches`` microbatches of
    ``rows // microbatches`` of the rank's ``rows`` sequences), by term:
    ``row`` each row-parallel (k-sharded) GEMM's output, ``col`` in
    training each column-parallel (n-sharded) GEMM's input gradient, and
    ``embed`` the vocab-sharded embedding lookup; each at its fp32
    buffer's bytes, as the reference's HLO walk counts them.  A remat
    forward doubles the layers' ``row`` term."""
    mrows = rows // microbatches
    if gemms is None:
        gemms = step_gemms(cfg, kind, seq_len, mrows, mesh)
    fwd = 2 if kind == "train" and cfg.remat else 1
    out = {"row": 0.0, "col": 0.0, "embed": 0.0}
    for g in gemms:
        if g["k_sharded"]:
            out["row"] += g["m"] * g["n"] * F32 * g["count"] * (
                (1 if g["weight"] == "head/w" else fwd)
                if kind == "train" else 1)
        if kind == "train" and g["n_sharded"]:
            out["col"] += g["m"] * g["k"] * F32 * g["count"]
    if _embed_sharded(cfg, mesh):
        tokens = mrows * (1 if kind == "decode" else seq_len)
        out["embed"] = tokens * cfg.d_model * F32
    return {k: v * microbatches for k, v in out.items() if v}


def _dist_report(gemms, mesh, cfg, tokens_global: int) -> Dict:
    """The schedule ``choose_schedule`` picks for each serve GEMM that can
    ride ``dist_matmul``, at the global shape, and its planned bytes."""
    from repro_torch.core.distributed import choose_schedule
    from repro_torch.models.model import model_defs

    sizes = axis_sizes(mesh)
    if "model" not in sizes:
        return {"gemms": [], "bytes_per_device": 0.0}
    defs = model_defs(cfg)
    dp, tp = sizes.get("data", 1), sizes["model"]
    pods = sizes.get("pod", 1)
    comp = cfg.dtype().itemsize
    rows, total = [], 0.0
    for g in gemms:
        d = defs[g["weight"]]
        if "expert" in d.axes:
            continue
        K, N = d.shape[-2], d.shape[-1]
        if dist_operand_specs(d.axes[-2:], (K, N), mesh) is None:
            continue
        c = choose_schedule(tokens_global, N, K, comp, dp, tp, pods)
        rows.append({"weight": g["weight"], "m": tokens_global, "n": N,
                     "k": K, "schedule": c.schedule,
                     "comm_bytes": c.comm_bytes, "time_s": c.time_s,
                     "count": g["count"]})
        total += c.comm_bytes * g["count"]
    return {"gemms": rows, "bytes_per_device": total}


def plan_cell(arch: str, shape_name: str, multi_pod: bool,
              cfg_override: Optional[ModelConfig] = None,
              microbatches: Optional[int] = None) -> Dict:
    """One cell's artifact (see the module docstring)."""
    cfg = cfg_override or get_config(arch)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    B, L = shape.global_batch, shape.seq_len
    rows = _local_rows(B, mesh)
    mb = 1
    if shape.kind == "train":
        from repro_torch.train.fsdp import weight_hoist

        mb = _microbatches(arch, shape, mesh, microbatches)
        state = S.state_inputs(cfg, mesh, fsdp=True)
        batch = S.train_inputs(cfg, shape, mesh)
        alias = S.local_bytes(*state)
        args = alias + S.local_bytes(*batch)
        reshard_params, _ = weight_hoist(cfg, mesh)
        by_kind = dict(reshard_params.layout.step_bytes(mb))
    else:
        params = S.serve_param_inputs(cfg, mesh, fsdp=arch in SERVE_FSDP)
        args = S.local_bytes(*params)
        alias = 0
        by_kind = {}
        if shape.kind == "prefill":
            args += S.local_bytes(*S.prefill_inputs(cfg, shape, mesh))
        else:
            cache = S.cache_inputs(cfg, shape, mesh)
            alias = S.local_bytes(*cache)
            args += (S.local_bytes(*S.decode_token_inputs(cfg, shape, mesh))
                     + alias + S.local_bytes(
                         {"step": S.ShapeDtypeStruct((), torch.int32)},
                         {"step": NamedSharding(mesh, ())}))
    gemm_rows = rows // mb
    gemms = step_gemms(cfg, shape.kind, L, gemm_rows, mesh)
    fwd = 2 if shape.kind == "train" and cfg.remat else 1
    gemm_flops = attn = 0.0
    for g in gemms:
        # the head is outside remat; training adds the dx and dW GEMMs
        passes = 1
        if shape.kind == "train":
            passes = (1 if g["weight"] == "head/w" else fwd) + 2
        gemm_flops += 2.0 * g["m"] * g["n"] * g["k"] * g["count"] * passes
    attn = attention_flops(cfg, shape.kind, L, gemm_rows, mesh) * (
        fwd + 2 if shape.kind == "train" else 1)
    gemm_flops *= mb
    attn *= mb
    reduce_bytes = sum(tp_reduce_bytes(cfg, shape.kind, L, rows, mesh,
                                       mb, gemms).values())
    if reduce_bytes:
        by_kind["all-reduce"] = by_kind.get("all-reduce", 0.0) + reduce_bytes
    art = {
        "arch": arch,
        "shape": shape_name,
        "kind": shape.kind,
        "mesh": _mesh_name(multi_pod),
        "chips": n_chips(mesh),
        "seq_len": L,
        "global_batch": B,
        "memory": {"argument_bytes": args, "alias_bytes": alias,
                   "temp_bytes": None},
        "plan": {
            "flops_per_device": gemm_flops + attn,
            "gemm_flops_per_device": gemm_flops,
            "attention_flops_per_device": attn,
            "microbatches": mb,
            "gemms": gemms,
            "collective_bytes_per_device": sum(by_kind.values()),
            "collective_bytes_by_kind": by_kind,
            "dist_matmul": (_dist_report(gemms, mesh, cfg, B * (
                1 if shape.kind == "decode" else L))
                if shape.kind != "train" else None),
        },
        "n_params": cfg.n_params(),
        "n_active_params": cfg.active_params(),
    }
    return art


def run_cells(cells, multi_pod: bool, out_dir: str) -> int:
    os.makedirs(out_dir, exist_ok=True)
    failures = 0
    for arch, shape_name in cells:
        tag = f"{arch}__{shape_name}__{_mesh_name(multi_pod)}"
        out_path = os.path.join(out_dir, tag + ".json")
        try:
            art = plan_cell(arch, shape_name, multi_pod)
            with open(out_path, "w") as f:
                json.dump(art, f, indent=1)
            # a later success supersedes an earlier failure's record
            if os.path.exists(out_path + ".err"):
                os.remove(out_path + ".err")
            plan = art["plan"]
            print(f"OK   {tag}  args/dev="
                  f"{art['memory']['argument_bytes'] / 2 ** 30:.2f}GiB "
                  f"flops/dev={plan['flops_per_device']:.3e} "
                  f"coll/dev={plan['collective_bytes_per_device']:.3e}",
                  flush=True)
        except Exception as e:  # repro: noqa RPR004 -- sweep isolation: record the cell's failure and continue
            failures += 1
            with open(out_path + ".err", "w") as f:
                f.write(traceback.format_exc())
            print(f"FAIL {tag}  {type(e).__name__}: {str(e)[:200]}",
                  flush=True)
    return failures


def all_cells():
    return [(arch, s) for arch in list_archs()
            for s in applicable_shapes(get_config(arch))]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=ARTIFACT_DIR)
    ap.add_argument("--shard-index", type=int, default=0,
                    help="process this cell subset (round-robin)")
    ap.add_argument("--shard-count", type=int, default=1)
    args = ap.parse_args(argv)
    if args.all:
        cells = all_cells()
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")
    cells = [c for i, c in enumerate(cells)
             if i % args.shard_count == args.shard_index]
    print(f"dry-run (plan): {len(cells)} cells on "
          f"{_mesh_name(args.multi_pod)}", flush=True)
    return run_cells(cells, args.multi_pod, args.out)


if __name__ == "__main__":
    sys.exit(main())
