"""MusicGen-large [arXiv:2306.05284; hf] — decoder-only over EnCodec tokens.

48 layers, d_model=2048, 32 heads, d_ff=8192 (GELU MLP), vocab=2048 per
codebook, 4 codebooks (parallel output heads; delay-pattern interleaving
is a data-pipeline concern).  The EnCodec frontend is a stub:
the `embeds` frontend takes precomputed frame embeddings.  RoPE replaces MusicGen's learned
sinusoidal embedding, as in the reference.
Full attention: long_500k skipped.
"""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=2048, act="gelu",
    frontend="embeds", n_codebooks=4,
)

def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=128, q_chunk=32, kv_chunk=32)
