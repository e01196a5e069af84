"""Granite-20B code [arXiv:2405.04324; hf] — llama-arch with MQA (kv=1).

52 layers, d_model=6144, 48 heads, single KV head (replicated over the
model axis), d_ff=24576 with GELU MLP (GPT-BigCode lineage).
Full attention: long_500k skipped.
"""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab_size=49152, head_dim=128, act="gelu",
)

def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
        head_dim=16, d_ff=256, vocab_size=512, q_chunk=32, kv_chunk=32)
