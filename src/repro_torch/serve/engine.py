"""Serving engine (port of ``repro/serve/engine.py``): per-request prefill
on a batch of 1, then the decode loop over the slab KV cache or, with
``paged_kv=True``, over the paged int8 KV cache.

Sampling is greedy (argmax over the real vocabulary) or temperature-based,
drawn from a ``torch.Generator`` seeded with ``seed`` — deterministic,
though its numbers are not ``jax.random``'s.  With several codebooks
(musicgen) codebook 0 is sampled.  An ``embeds``-frontend arch (the
stubbed vision and audio frontends) is fed rows of the reference's demo
table (:func:`sample_table`) for its prompt and sampled tokens.

The cache follows the arch: slab KV, MLA's compressed slab, or a Mamba2
layer's conv window and SSM state (plus zamba2's shared-block slabs);
the paged pool serves the GQA transformers only (KV005 otherwise).

Weight-quantized parameters (``models.common.quantize_params``) serve
int8 weights; with ``quantize_activations=True`` the engine first runs a
static calibration pass over sample prompts and then serves w8a8; a
failed calibration raises.

Before the first request the engine resolves every hot-path GEMM tile
through the kernel-config registry (``tuning.warmup_model`` over 1 and
``max_len`` rows, for its quant policy) and, on the paged path, the
attention blockings (``tuning.warmup_attention``, whose paged entry is the
page size).  ``run`` is instrumented as the reference's: queue wait, TTFT
(dequeue to first sampled token), per-output-token decode latency (TPOT),
tokens and requests counters and tokens/s in the metrics registry
(``repro_torch.obs``); each request, prefill and decode loop runs under a
trace span, and each prefill and decode step under a GEMM-ledger step, so
:meth:`ServeEngine.metrics_report` states achieved bytes/s against the
planned I/O model.  A step's wall ends in the sampled token's read to the
host, which already waits for the device; nothing adds a synchronise.

The reference's degradation ladder (w8a8 → int8w → dense), bounded
admission, retries and fault injection wait for ``runtime/fault.py``, and
tensor parallelism for ``serve/tp.py``; the arguments that ask for them
raise here.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch import kvcache as kvc
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.obs import get_ledger, get_metrics, span
from repro_torch.quant.calibrate import (ActivationCalibration, QuantConfig,
                                         attach_act_scales)
from repro_torch.quant.scales import QTensor
from repro_torch.tuning import (resolve_page_size, warmup_attention,
                                warmup_model)


class NonFiniteLogits(RuntimeError):
    """The sampled logits row held NaN or Inf."""


# Rows of the demo table drawn at a time (qwen2-vl-72b's 152064 x 8192
# table would be 10 GB of float64 on the host in one draw).
_TABLE_ROWS = 4096


def sample_table(cfg: ModelConfig, device=None) -> torch.Tensor:
    """The ``embeds`` frontend's demo embedding table, the reference's:
    ``np.random.RandomState(0).randn(vocab, d) * 0.02`` in the serve
    dtype.  Drawn in chunks of rows (the legacy normal stream continues
    across calls, so the values are the single draw's) and moved to
    ``device`` chunk by chunk."""
    rng = np.random.RandomState(0)
    out = torch.empty((cfg.vocab_size, cfg.d_model), dtype=cfg.dtype(),
                      device=M.resolve_device(device))
    for lo in range(0, cfg.vocab_size, _TABLE_ROWS):
        rows = min(_TABLE_ROWS, cfg.vocab_size - lo)
        out[lo:lo + rows] = torch.from_numpy(
            rng.randn(rows, cfg.d_model) * 0.02).to(cfg.dtype())
    return out


def model_inputs(cfg: ModelConfig, ids: torch.Tensor,
                 table: Optional[torch.Tensor] = None
                 ) -> Dict[str, torch.Tensor]:
    """The model's input for token ids (B, L): the ids themselves, or for
    the ``embeds`` frontend their rows of ``table`` (:func:`sample_table`)."""
    if cfg.frontend == "tokens":
        return {"tokens": ids}
    return {"embeds": table[ids]}


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray              # (Lp,) int token ids
    max_new_tokens: int = 16
    temperature: float = 0.0
    generated: Optional[List[int]] = None
    # pending -> queued -> running -> done; a request rejected at
    # admission goes straight to done with status "rejected" and ``error``.
    status: str = "pending"
    error: Optional[str] = None
    # Host wall seconds of prefill + first sample (the TTFT), and of the
    # decode loop; both end in the sample's device-to-host read, so they
    # cover the device work.
    prefill_s: float = 0.0
    decode_s: float = 0.0


class ServeEngine:
    """Single-card engine: ``submit`` requests, then ``run`` serves the
    queue in order.

    With ``paged_kv=True`` the KV cache is a pool of int8 pages
    (:mod:`repro_torch.kvcache`) that admits requests by pages instead of
    a ``max_len`` slab: ``kv_page_size`` tokens per page (0: the analytic
    page for ``max_len``, :func:`repro_torch.tuning.resolve_page_size`),
    and the pages one sequence of ``max_len`` tokens needs, since requests
    are served one at a time.  The pool lives on the engine's device for
    its whole life and is written in place.

    ``sample_table`` is the ``embeds`` frontend's table (default: built
    on first use, :func:`sample_table`); passing one shares it between
    engines of the same arch.
    """

    def __init__(self, params: Dict[str, object], cfg: ModelConfig, *,
                 max_len: int, seed: int = 0,
                 device=None, paged_kv: bool = False, kv_page_size: int = 0,
                 quantize_activations: bool = False,
                 calibration_batches: int = 4,
                 act_qconfig: Optional[QuantConfig] = None, tp_local=None,
                 max_queue: int = 0,
                 sample_table: Optional[torch.Tensor] = None):
        later = {"tp_local": (tp_local, "serve/tp.py"),
                 "max_queue": (max_queue, "runtime/fault.py")}
        for name, (value, module) in later.items():
            if value:
                raise ValueError(f"ServeEngine({name}=...) is not ported yet: "
                                 f"it waits for {module}")
        self.device = M.resolve_device(device)
        for name, t in params.items():
            if t.device.type != self.device.type:
                raise ValueError(f"param {name} lies on {t.device}, the "
                                 f"engine on {self.device}")
        self.params = params
        self.cfg = cfg
        self.max_len = max_len
        self._table = None if sample_table is None \
            else sample_table.to(self.device)
        self.quantized = any(isinstance(t, QTensor) for t in params.values())
        # Static activation quantization (w8a8): calibrate on sample
        # prompts first, then every quantized GEMM runs int8 x int8.
        self.w8a8 = False
        self.calibration_sites: List[str] = []
        self.calibration_s = 0.0
        metrics = get_metrics()
        if quantize_activations:
            if not self.quantized:
                raise ValueError(
                    "quantize_activations requires weight-quantized params "
                    "(models.common.quantize_params first)")
            self.act_qconfig = act_qconfig or QuantConfig(act_fmt="int8")
            if not self.act_qconfig.quantize_activations:
                raise ValueError("act_qconfig has no activation format: "
                                 f"{self.act_qconfig}")
            t0 = time.perf_counter()
            with span("serve.calibrate", batches=calibration_batches):
                self.params = self._calibrate_activations(
                    calibration_batches)
            self.calibration_s = time.perf_counter() - t0
            self.w8a8 = True
            metrics.gauge(
                "serve.calibration_seconds",
                "Wall time of the w8a8 static-activation calibration "
                "pass").set(self.calibration_s)
        # Resolve every hot-path GEMM tile before the first request, for
        # the programs this engine's quant policy issues.
        quant_mode = "w8a8" if self.w8a8 else self.quantized
        t0 = time.perf_counter()
        with span("serve.warmup", quant=str(quant_mode)):
            self.gemm_plan_sources: Dict[str, str] = warmup_model(
                cfg, [1, max_len], quant=quant_mode)
        metrics.gauge(
            "serve.warmup_seconds",
            "Wall time of the GEMM plan warmup (registry prewarm)").set(
                time.perf_counter() - t0)
        plan_counter = metrics.counter(
            "serve.gemm_plan_total",
            "Warmup-resolved GEMM plans by source (cache/autotune/"
            "analytic)")
        for src in self.gemm_plan_sources.values():
            plan_counter.labels(source=src).inc()
        self.attn_plan_sources: Dict[str, str] = {}
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.queue: Deque[Request] = collections.deque()
        self.done: Dict[int, Request] = {}
        self._submit_t: Dict[int, float] = {}
        self.kv_pool: Optional[kvc.PagePool] = None
        self.kv_cache = None
        if paged_kv:
            M.check_pageable(cfg)
            # The page size resolves through the registry like every GEMM
            # tile: the paged_decode entry's kv_block is the page.
            t0 = time.perf_counter()
            with span("serve.attn_warmup", paged=True):
                self.attn_plan_sources = warmup_attention(cfg, max_len,
                                                          paged=True)
            metrics.gauge(
                "serve.attn_warmup_seconds",
                "Wall time of the attention blocking warmup").set(
                    time.perf_counter() - t0)
            page = kv_page_size or resolve_page_size(
                heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
                head_dim=cfg.resolved_head_dim,
                seq_len=max_len).config.kv_block
            n_pages = kvc.pages_for(max_len, page)
            self.kv_pool = kvc.PagePool(n_pages, page)
            self.kv_cache = M.make_paged_model_cache(
                cfg, 1, n_pages=n_pages, page_size=page, max_pages=n_pages,
                device=self.device)

    def _calibrate_activations(self, n_batches: int) -> Dict[str, object]:
        """Post-training static calibration: prefill ``n_batches`` sample
        prompts (the reference's: ``RandomState(1234)``, length
        ``max(2, min(8, max_len - 1))``) under an
        :class:`ActivationCalibration` recording every quantized GEMM's
        input, then return the params with each site's static a-scale
        attached to its weights."""
        rng = np.random.RandomState(1234)
        length = max(2, min(8, self.max_len - 1))
        with torch.inference_mode(), \
                ActivationCalibration(self.act_qconfig) as ctx:
            for _ in range(max(1, n_batches)):
                toks = self._tokens(rng.randint(0, self.cfg.vocab_size,
                                                (1, length)))
                M.prefill(self.params, self._inputs(toks), self.cfg,
                          max_len=self.max_len)
            scales = ctx.scales()
        self.calibration_sites = sorted(ctx.calibrators)
        return attach_act_scales(self.params, scales,
                                 block=self.act_qconfig.act_block)

    def submit(self, req: Request) -> bool:
        """Queue a request (True).  On the paged path a request whose
        prompt plus full generation budget can never fit the pool is
        rejected instead (False): it lands in ``done``
        with status ``"rejected"`` and the reason in ``error``."""
        req.generated = []
        if self.kv_pool is not None:
            need = self.kv_pool.pages_for(
                len(req.prompt) + req.max_new_tokens)
            if need > self.kv_pool.n_pages:
                req.status = "rejected"
                req.error = (f"kv pages: need {need} pages, pool holds "
                             f"{self.kv_pool.n_pages}")
                self.done[req.uid] = req
                return False
        req.status = "queued"
        self.queue.append(req)
        self._submit_t[req.uid] = time.perf_counter()
        return True

    def _sample(self, logits: torch.Tensor, temperature: float) -> int:
        """Sample the last position's real vocabulary: (1, L, V) logits,
        or (1, L, Cb, V) with codebooks, of which codebook 0 is sampled
        (every codebook's row is checked finite)."""
        row = logits[0, -1, ..., :self.cfg.vocab_size]
        if not bool(torch.isfinite(row).all()):
            raise NonFiniteLogits("non-finite logits in sampled row")
        if self.cfg.n_codebooks > 1:
            row = row[0]
        if temperature <= 0:
            return int(torch.argmax(row))
        probs = torch.softmax(row / temperature, dim=-1)
        return int(torch.multinomial(probs, 1, generator=self.generator))

    def run(self) -> Dict[int, Request]:
        """Serve everything in the queue: prefill on a batch of 1 and
        sample, then one decode step per further token.

        Instrumented as the reference's ``run``: queue wait, TTFT (dequeue
        to first sampled token), TPOT (one decode step + sample), the
        prefill/decode wall split, tokens and requests land in the
        metrics registry, and ``serve.tokens_per_second`` is the output
        tokens over this call's wall time."""
        metrics = get_metrics()
        self._h = {
            "queue_wait": metrics.histogram(
                "serve.queue_wait_seconds", "submit() to dequeue latency"),
            "ttft": metrics.histogram(
                "serve.ttft_seconds", "Dequeue to first sampled token"),
            "tpot": metrics.histogram(
                "serve.tpot_seconds",
                "Per-output-token decode latency (decode step + sample)"),
            "prefill_s": metrics.counter(
                "serve.prefill_seconds_total",
                "Wall time in prefill+sample"),
            "decode_s": metrics.counter(
                "serve.decode_seconds_total",
                "Wall time in the decode loop"),
            "tokens": metrics.counter(
                "serve.tokens_generated_total", "Sampled output tokens"),
            "n_requests": metrics.counter(
                "serve.requests_total", "Requests served to completion"),
        }
        tokens = self._h["tokens"]
        before = tokens.value
        t_run = time.perf_counter()
        with torch.inference_mode():
            while self.queue:
                req = self.queue.popleft()
                t_req = time.perf_counter()
                submitted = self._submit_t.pop(req.uid, None)
                if submitted is not None:
                    self._h["queue_wait"].observe(t_req - submitted)
                req.status = "running"
                with span("serve.request", uid=req.uid,
                          prompt_len=len(req.prompt),
                          max_new_tokens=req.max_new_tokens):
                    self._serve_one(req)
                req.status = "done"
                self.done[req.uid] = req
                self._h["n_requests"].inc()
        elapsed = time.perf_counter() - t_run
        if elapsed > 0:
            metrics.gauge(
                "serve.tokens_per_second",
                "Output tokens over the last run()'s wall time").set(
                    (tokens.value - before) / elapsed)
        return self.done

    def _tokens(self, ids) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ids, dtype=np.int64),
                               device=self.device).reshape(1, -1)

    def _inputs(self, toks: torch.Tensor) -> Dict[str, torch.Tensor]:
        if self.cfg.frontend != "tokens" and self._table is None:
            self._table = sample_table(self.cfg, self.device)
        return model_inputs(self.cfg, toks, self._table)

    def _serve_one(self, req: Request) -> None:
        """Prefill and sample, then one decode step per further token.  On
        the paged path the request's pages (prompt plus full generation
        budget) are allocated before prefill and held for exactly this
        call: the ``finally`` unmaps and frees them whatever happens."""
        h = self._h
        ledger = get_ledger()
        paged = self.kv_pool is not None
        try:
            t0 = time.perf_counter()
            toks = self._tokens(req.prompt)
            with span("serve.prefill", uid=req.uid, length=toks.shape[1],
                      paged=paged), ledger.step("prefill"):
                cache = None
                if paged:
                    page_ids = self.kv_pool.alloc(
                        req.uid, len(req.prompt) + req.max_new_tokens)
                    cache = kvc.model_assign_sequence(self.kv_cache, 0,
                                                      page_ids)
                logits, cache = M.prefill(self.params, self._inputs(toks),
                                          self.cfg, max_len=self.max_len,
                                          cache=cache)
                nxt = self._sample(logits, req.temperature)
            t1 = time.perf_counter()
            req.prefill_s = t1 - t0
            h["ttft"].observe(req.prefill_s)
            h["prefill_s"].inc(req.prefill_s)
            h["tokens"].inc()
            req.generated.append(nxt)
            pos = toks.shape[1]
            with span("serve.decode", uid=req.uid,
                      tokens=req.max_new_tokens - 1):
                for _ in range(req.max_new_tokens - 1):
                    t_tok = time.perf_counter()
                    with ledger.step("decode"):
                        logits, cache = M.decode_step(
                            self.params, self._inputs(self._tokens([nxt])),
                            cache, pos, self.cfg)
                        nxt = self._sample(logits, req.temperature)
                    dt = time.perf_counter() - t_tok
                    h["tpot"].observe(dt)
                    h["decode_s"].inc(dt)
                    h["tokens"].inc()
                    req.generated.append(nxt)
                    pos += 1
            req.decode_s = time.perf_counter() - t1
        finally:
            if self.kv_pool is not None:
                kvc.model_release_sequence(self.kv_cache, 0)
                self.kv_pool.free(req.uid)

    # -- observability -------------------------------------------------------

    def metrics_snapshot(self) -> Dict[str, dict]:
        """JSON-ready view of everything observed: the metrics registry,
        the warmup's plan sources and the GEMM ledger's per-step
        aggregates (``get_ledger().snapshot()`` has the records)."""
        led = get_ledger()
        return {
            "metrics": get_metrics().snapshot(),
            "gemm_plan_sources": dict(self.gemm_plan_sources),
            "attn_plan_sources": dict(self.attn_plan_sources),
            "ledger": {"enabled": led.enabled,
                       "aggregate": led.aggregate(),
                       "steps": led.steps_summary()},
        }

    def metrics_report(self) -> str:
        """Human-readable serve report: the metric lines (TTFT/TPOT
        histograms, prefill/decode split, tokens/s, plan sources), then
        one line per ledger step label with its planned bytes, achieved
        GB/s and model error when the ledger is enabled."""
        lines = [get_metrics().report()]
        led = get_ledger()
        steps = led.steps_summary() if led.enabled else {}
        for label, agg in sorted(steps.items()):
            line = (f"ledger.{label}: steps={agg['steps']} "
                    f"gemms={agg['gemm_calls']} "
                    f"planned={agg['planned_bytes'] / 1e6:.2f}MB")
            if agg.get("attn_calls"):
                line += f" attn={agg['attn_calls']}"
            if "achieved_gbps" in agg:
                line += f" achieved={agg['achieved_gbps']:.3f}GB/s"
            if "model_error" in agg:
                line += f" model_error={agg['model_error']:.3g}x"
            lines.append(line)
        return "\n".join(line for line in lines if line)
