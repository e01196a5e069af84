"""Serving engine (port of ``repro/serve/engine.py``): per-request prefill
on a batch of 1, then the decode loop over the slab KV cache.

Sampling is greedy (argmax over the real vocabulary) or temperature-based,
drawn from a ``torch.Generator`` seeded with ``seed`` — deterministic,
though its numbers are not ``jax.random``'s.  The reference's paged KV
cache, w8a8 calibration, tensor parallelism, bounded admission, metrics
and fault handling are later slices (ROADMAP) and raise here when asked
for.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M


class NonFiniteLogits(RuntimeError):
    """The sampled logits row held NaN or Inf."""


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray              # (Lp,) int token ids
    max_new_tokens: int = 16
    temperature: float = 0.0
    generated: Optional[List[int]] = None
    status: str = "pending"         # pending -> queued -> running -> done
    # Host wall seconds of prefill + first sample, and of the decode loop;
    # both end in the sample's device-to-host read, so they cover the
    # device work.
    prefill_s: float = 0.0
    decode_s: float = 0.0


class ServeEngine:
    """Single-card engine: ``submit`` requests, then ``run`` serves the
    queue in order."""

    def __init__(self, params: Dict[str, torch.Tensor], cfg: ModelConfig, *,
                 max_len: int, seed: int = 0,
                 device=None, paged_kv: bool = False,
                 quantize_activations: bool = False, tp_local=None,
                 max_queue: int = 0):
        later = {"paged_kv": (paged_kv, "queue 1 item 6"),
                 "quantize_activations": (quantize_activations,
                                          "queue 1 item 7"),
                 "tp_local": (tp_local, "queue 1 item 14"),
                 "max_queue": (max_queue, "queue 1 item 9")}
        for name, (value, where) in later.items():
            if value:
                raise ValueError(f"ServeEngine({name}=...) is not ported yet "
                                 f"(ROADMAP {where})")
        self.device = M.resolve_device(device)
        for name, t in params.items():
            if t.device.type != self.device.type:
                raise ValueError(f"param {name} lies on {t.device}, the "
                                 f"engine on {self.device}")
        self.params = params
        self.cfg = cfg
        self.max_len = max_len
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.queue: Deque[Request] = collections.deque()
        self.done: Dict[int, Request] = {}

    def submit(self, req: Request) -> bool:
        req.generated = []
        req.status = "queued"
        self.queue.append(req)
        return True

    def _sample(self, logits: torch.Tensor, temperature: float) -> int:
        row = logits[0, -1, :self.cfg.vocab_size]
        if not bool(torch.isfinite(row).all()):
            raise NonFiniteLogits("non-finite logits in sampled row")
        if temperature <= 0:
            return int(torch.argmax(row))
        probs = torch.softmax(row / temperature, dim=-1)
        return int(torch.multinomial(probs, 1, generator=self.generator))

    def run(self) -> Dict[int, Request]:
        """Serve everything in the queue: prefill on a batch of 1 and
        sample, then one decode step per further token."""
        with torch.inference_mode():
            while self.queue:
                req = self.queue.popleft()
                req.status = "running"
                self._serve_one(req)
                req.status = "done"
                self.done[req.uid] = req
        return self.done

    def _tokens(self, ids) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ids, dtype=np.int64),
                               device=self.device).reshape(1, -1)

    def _serve_one(self, req: Request) -> None:
        t0 = time.perf_counter()
        toks = self._tokens(req.prompt)
        logits, cache = M.prefill(self.params, {"tokens": toks}, self.cfg,
                                  max_len=self.max_len)
        nxt = self._sample(logits, req.temperature)
        t1 = time.perf_counter()
        req.prefill_s = t1 - t0
        req.generated.append(nxt)
        pos = toks.shape[1]
        for _ in range(req.max_new_tokens - 1):
            logits, cache = M.decode_step(self.params,
                                          {"tokens": self._tokens([nxt])},
                                          cache, pos, self.cfg)
            nxt = self._sample(logits, req.temperature)
            req.generated.append(nxt)
            pos += 1
        req.decode_s = time.perf_counter() - t1
