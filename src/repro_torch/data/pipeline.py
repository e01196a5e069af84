"""Deterministic synthetic LM data (port of ``repro/data/pipeline.py``), in
numpy: the same batches, byte for byte, as the reference's.

The stream has learnable structure (a noisy affine-mod-vocab next-token
process), so training shows a real loss decrease, and it is deterministic
across restarts: the batch of step N depends only on the config and N.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    noise: float = 0.1          # fraction of uniformly random tokens
    n_hosts: int = 1
    host_id: int = 0


class SyntheticLM:
    """Affine next-token process: x_{t+1} = (a*x_t + b) % V with noise."""

    def __init__(self, cfg: DataConfig):
        if cfg.global_batch % cfg.n_hosts != 0:
            raise ValueError(f"global_batch={cfg.global_batch} must "
                             f"divide over n_hosts={cfg.n_hosts}")
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.n_hosts
        self.a = 31
        self.b = 17

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Deterministic batch for a given global step (restart-safe)."""
        c = self.cfg
        rng = np.random.RandomState(
            (c.seed + step * 1_000_003 + c.host_id * 7919) % (2 ** 31))
        B, L, V = self.local_batch, c.seq_len, c.vocab_size
        x = np.empty((B, L + 1), np.int32)
        x[:, 0] = rng.randint(0, V, B)
        noise = rng.rand(B, L) < c.noise
        rand_tok = rng.randint(0, V, (B, L))
        for t in range(L):
            nxt = (self.a * x[:, t] + self.b) % V
            x[:, t + 1] = np.where(noise[:, t], rand_tok[:, t], nxt)
        return {
            "tokens": x[:, :-1],
            "labels": x[:, 1:],
            "mask": np.ones((B, L), np.float32),
        }


def embed_table(data_cfg: DataConfig, d: int) -> np.ndarray:
    """The stubbed modalities' embedding table of ``data_cfg``'s seed,
    (vocab, ``d``) fp32.  It is the slow part of a batch at a large
    vocabulary (152064 x 8192 for qwen2-vl-72b: tens of seconds on the
    host), so a caller that makes many batches draws it once and passes
    it to :func:`batch_for_model`."""
    rng = np.random.RandomState(data_cfg.seed)
    return rng.randn(data_cfg.vocab_size, d).astype(np.float32) * 0.02


def batch_for_model(cfg: ModelConfig, data_cfg: DataConfig, step: int,
                    embed_dim: Optional[int] = None,
                    table: Optional[np.ndarray] = None
                    ) -> Dict[str, np.ndarray]:
    """The token stream adapted to the arch's frontend: the stubbed
    modalities (``embeds``) get hashed embeddings from ``table`` (default
    :func:`embed_table`, drawn from ``RandomState(seed)``), labels taken
    mod the vocab; musicgen gets one label stream per codebook, each a
    seeded permutation of the vocab."""
    src = SyntheticLM(data_cfg).batch_at(step)
    if cfg.frontend == "tokens":
        return src
    if table is None:
        table = embed_table(data_cfg, embed_dim or cfg.d_model)
    out = {"embeds": table[src["tokens"]], "mask": src["mask"]}
    if cfg.n_codebooks > 1:
        rngs = [np.random.RandomState(data_cfg.seed + i + 1)
                for i in range(cfg.n_codebooks)]
        perms = [r.permutation(cfg.vocab_size) for r in rngs]
        lbl = np.stack([p[src["labels"] % cfg.vocab_size] for p in perms],
                       axis=-1)
        out["labels"] = lbl.astype(np.int32)
    else:
        out["labels"] = src["labels"] % cfg.vocab_size
    return out
