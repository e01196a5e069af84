"""MiniCPM3-4B [hf:openbmb/MiniCPM3-4B] — dense with MLA.

62 layers, d_model=2560, 40 heads (NOT divisible by the 16-way model
axis: head dims stay replicated over 'model'; fused projections still
TP-shard — DESIGN.md §Arch-applicability).  MLA q_lora=768, kv_lora=256.
Full attention: long_500k skipped.
"""
import dataclasses
from repro_torch.configs.base import MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b", family="dense",
    n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=6400, vocab_size=73448,
    attn_kind="mla",
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256, qk_nope_dim=64,
                  qk_rope_dim=32, v_head_dim=64),
)

def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=5, n_kv_heads=5,
        d_ff=128, vocab_size=512,
        mla=MLAConfig(q_lora_rank=48, kv_lora_rank=32, qk_nope_dim=16,
                      qk_rope_dim=8, v_head_dim=16),
        q_chunk=32, kv_chunk=32)
