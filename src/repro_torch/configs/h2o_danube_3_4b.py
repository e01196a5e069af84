"""H2O-Danube3-4B [arXiv:2401.16818] — llama+mistral mix with SWA.

24 layers, d_model=3840, 32 heads (kv=8, head_dim=120), d_ff=10240,
vocab=32000, sliding window 8192 -> long_500k runs with rolling cache.
"""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b", family="dense",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8,
    d_ff=10240, vocab_size=32000, head_dim=120,
    sliding_window=8192, subquadratic=True,
)

def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512, sliding_window=32,
        q_chunk=32, kv_chunk=32)
