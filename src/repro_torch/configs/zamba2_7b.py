"""Zamba2-7B [arXiv:2411.15242] — Mamba2 backbone + shared attention.

81 Mamba2 layers (d_model=3584, d_inner=7168, 112 SSD heads, state=64)
with ONE weight-shared attention+MLP block (32 heads, d_ff=14336) applied
every 6 layers on concat(hidden, embedding) — Zamba2's concatenation
trick.  Hybrid: long_500k runs (SSM decode is O(1); the shared attention
cache is sequence-sharded over 'data').
"""
import dataclasses
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab_size=32000, head_dim=112,
    subquadratic=True, shared_attn_every=6,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, conv_kernel=4,
                  chunk=256),
)

def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=512, shared_attn_every=2,
        ssm=SSMConfig(d_state=16, head_dim=16, expand=2, conv_kernel=4,
                      chunk=16),
        q_chunk=32, kv_chunk=32)
