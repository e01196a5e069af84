"""Qwen2-VL-72B [arXiv:2409.12191; hf] — VLM backbone with M-RoPE.

80 layers, d_model=8192, 64 heads (kv=8), d_ff=29568, vocab=152064.
The vision frontend is a stub: the `embeds` frontend takes precomputed
patch embeddings; M-RoPE sections (16, 24, 24) over the
64-lane half-dim are exercised with text positions.
Full attention: long_500k skipped.
"""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=29568, vocab_size=152064, head_dim=128,
    rope_kind="mrope", mrope_sections=(16, 24, 24), rope_theta=1e6,
    frontend="embeds",
)

def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, mrope_sections=(2, 3, 3), d_ff=128, vocab_size=512,
        q_chunk=32, kv_chunk=32)
