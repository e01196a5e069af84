"""DeepSeek-V2-Lite 16B [arXiv:2405.04434; hf] — MoE with MLA.

64 routed experts (top-6) + 2 shared experts, d_ff_expert=1408;
MLA with kv_lora_rank=512 (no q compression in the Lite variant).
The assignment line lists both "64e" and "160 routed"; the published
V2-Lite checkpoint has 64 routed experts — we use 64 (DESIGN.md).
"""
import dataclasses
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=102400,
    attn_kind="mla",
    mla=MLAConfig(q_lora_rank=0, kv_lora_rank=512, qk_nope_dim=128,
                  qk_rope_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408,
                  n_shared_experts=2),
    rope_theta=10000.0,
)

def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=64, vocab_size=512,
        mla=MLAConfig(q_lora_rank=0, kv_lora_rank=32, qk_nope_dim=16,
                      qk_rope_dim=8, v_head_dim=16),
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=64,
                      n_shared_experts=1),
        q_chunk=32, kv_chunk=32)
