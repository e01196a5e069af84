"""Mamba2-370m [arXiv:2405.21060] — attention-free SSD.

48 layers, d_model=1024, d_inner=2048, head_dim=64 (32 heads),
d_state=128.  Linear-time decode: long_500k runs.
"""
import dataclasses
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=50280,
    attn_kind="none", subquadratic=True,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_kernel=4,
                  chunk=256),
)

def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, vocab_size=512,
        ssm=SSMConfig(d_state=16, head_dim=16, expand=2, conv_kernel=4,
                      chunk=16))
