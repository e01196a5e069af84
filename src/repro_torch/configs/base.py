"""Model/config system (port of ``repro/configs/base.py``): one dataclass
covers every assigned architecture; ``dtype()``/``pdtype()`` return torch
dtypes.

Each architecture file in this package instantiates ``ModelConfig`` with
the exact published dimensions and provides ``reduced()`` for CPU smoke
tests.  The assigned input shapes of the dry run (``launch/dryrun.py``)
live in ``SHAPES``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch


def round_up(v: int, q: int) -> int:
    return ((v + q - 1) // q) * q


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0          # routed experts
    top_k: int = 0
    d_ff_expert: int = 0
    n_shared_experts: int = 0   # dense experts applied to every token
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01
    # "expert" shards the expert dim (EP) when divisible by the model axis;
    # "ffn" tensor-parallelizes d_ff_expert instead (TP fallback).
    sharding: str = "auto"


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2 / MiniCPM3)."""
    q_lora_rank: int = 0        # 0 = full-rank Q projection
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) mixer."""
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_kernel: int = 4
    chunk: int = 256
    n_groups: int = 1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    # attention
    attn_kind: str = "gqa"       # gqa | mla | none
    head_dim: Optional[int] = None
    sliding_window: Optional[int] = None
    rope_theta: float = 10000.0
    rope_kind: str = "rope"      # rope | mrope
    mrope_sections: Tuple[int, ...] = (16, 24, 24)

    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None

    # hybrid (zamba2-style): one weight-shared attention+MLP block applied
    # every ``shared_attn_every`` SSM layers.
    shared_attn_every: int = 0

    # modality frontend: "tokens" embeds ids; "embeds" takes precomputed
    # frame/patch embeddings (the spec's frontend STUB for [audio]/[vlm]).
    frontend: str = "tokens"
    n_codebooks: int = 1         # musicgen: parallel output heads

    act: str = "silu"            # silu (SwiGLU) | gelu (plain MLP)
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    vocab_round_to: int = 512

    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # training-time behavior
    remat: bool = True
    q_chunk: int = 512
    kv_chunk: int = 1024

    # Set False for pure full-attention archs: long_500k is skipped
    # (quadratic decode at 524k), per DESIGN.md §Arch-applicability.
    subquadratic: bool = False

    @property
    def padded_vocab(self) -> int:
        return round_up(self.vocab_size, self.vocab_round_to)

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // self.n_heads

    @property
    def attn_free(self) -> bool:
        return self.attn_kind == "none"

    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def n_params(self) -> int:
        """Approximate parameter count (used for 6ND model flops)."""
        d, f, V = self.d_model, self.d_ff, self.padded_vocab
        L = self.n_layers
        Dh = self.resolved_head_dim if self.n_heads else 0
        per_layer = 0
        if self.attn_kind == "gqa":
            per_layer += d * self.n_heads * Dh + 2 * d * self.n_kv_heads * Dh
            per_layer += self.n_heads * Dh * d
        elif self.attn_kind == "mla":
            m = self.mla
            qdim = self.n_heads * (m.qk_nope_dim + m.qk_rope_dim)
            per_layer += (d * m.q_lora_rank + m.q_lora_rank * qdim
                          if m.q_lora_rank else d * qdim)
            per_layer += d * (m.kv_lora_rank + m.qk_rope_dim)
            per_layer += m.kv_lora_rank * self.n_heads * (m.qk_nope_dim + m.v_head_dim)
            per_layer += self.n_heads * m.v_head_dim * d
        if self.ssm is not None:
            di = self.ssm.d_inner(d)
            n = self.ssm.d_state
            g = self.ssm.n_groups
            heads = self.ssm.n_heads(d)
            per_layer_ssm = d * (2 * di + 2 * g * n + heads) + di * d
            if self.family == "ssm":
                per_layer = per_layer_ssm
            else:  # hybrid: ssm layers dominate; attn counted via shared block
                per_layer = per_layer_ssm
        if self.moe is not None and self.moe.n_experts:
            fe = self.moe.d_ff_expert
            per_layer += 3 * d * fe * (self.moe.n_experts
                                       + self.moe.n_shared_experts)
            per_layer += d * self.moe.n_experts  # router
        elif self.ssm is None or self.family == "hybrid":
            mult = 3 if self.act == "silu" else 2
            if self.family != "hybrid":
                per_layer += mult * d * f
        total = L * per_layer
        if self.shared_attn_every:
            # one shared attention+MLP block (weights counted once)
            mult = 3 if self.act == "silu" else 2
            total += (2 * d) * d + 4 * d * d + mult * d * self.d_ff
        total += V * d * (1 if self.tie_embeddings else 2)
        total += self.n_codebooks * d * V if self.frontend == "embeds" else 0
        return int(total)

    def active_params(self) -> int:
        """Params touched per token (MoE: routed top-k + shared only)."""
        if self.moe is None or not self.moe.n_experts:
            return self.n_params()
        d = self.d_model
        fe = self.moe.d_ff_expert
        dense_like = dataclasses.replace(self, moe=None)
        base = dense_like.n_params()
        active_ffn = 3 * d * fe * (self.moe.top_k + self.moe.n_shared_experts)
        return int(base + self.n_layers * (active_ffn + d * self.moe.n_experts))


# ---------------------------------------------------------------------------
# Assigned input shapes (same set for every LM arch).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def applicable_shapes(cfg: ModelConfig) -> Sequence[str]:
    """The (arch x shape) cells that are well-defined for this arch."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.subquadratic:
        names.append("long_500k")
    return names
