"""Mixtral 8x7B [arXiv:2401.04088; hf] — 8 experts top-2, SWA.

8 experts do not divide the 16-way model axis: expert FFN weights are
TP-sharded on d_ff (rule-engine fallback), not EP-sharded.  Sliding-window
attention makes long_500k decode runnable (rolling cache = window).
"""
import dataclasses
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=32000, head_dim=128,
    sliding_window=4096, subquadratic=True,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=14336),
    rope_theta=1e6,
)

def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512, sliding_window=32,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=128),
        q_chunk=32, kv_chunk=32)
