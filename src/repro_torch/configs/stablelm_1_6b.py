"""StableLM-2-1.6B [hf:stabilityai/stablelm-2-1_6b] — dense GQA.

24 layers, d_model=2048, 32 heads (kv=32), d_ff=5632, vocab=100352.
Full attention: long_500k skipped.
"""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b", family="dense",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=5632, vocab_size=100352,
)

def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=512, q_chunk=32, kv_chunk=32)
