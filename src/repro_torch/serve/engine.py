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
failed calibration degrades the engine to weight-only int8 with a
``RuntimeWarning`` (``serve.degraded_total{from=w8a8,to=int8w}``).

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

Fault tolerance, as the reference's: every request is isolated.  A
kernel error or non-finite logits fails *that* request
(``serve.requests_failed_total{reason}``) while the rest of the queue
completes.  Admission is bounded by KV pages (a request whose prompt
plus generation budget can never fit the pool or the per-sequence cap is
rejected) and by queue (``max_queue`` with ``reject`` or ``shed_oldest``
backpressure, ``serve.rejected_total{policy}``); requests carry a queue
TTL and a decode deadline; transient failures retry with exponential
backoff (``serve.retries_total``); non-finite logits walk the
per-request quant ladder w8a8 → int8w → dense
(``serve.degraded_total{from,to}``).  An injected non-fatal kernel
failure is counted and that GEMM dispatched again (``core.gemm``,
``gemm.fallback_total``), which marks its request ``degraded``.  All of it
is driven deterministically by :class:`repro_torch.runtime.fault.FaultPlan`;
with no plan active a step does exactly the work it did without it.
Tensor parallelism waits for ``serve/tp.py``: ``tp_local`` raises.
"""

from __future__ import annotations

import collections
import dataclasses
import time
import warnings
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import kvcache as kvc
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.obs import get_ledger, get_metrics, span
from repro_torch.quant.calibrate import (ActivationCalibration, QuantConfig,
                                         attach_act_scales)
from repro_torch.quant.scales import QTensor
from repro_torch.runtime.fault import (InjectedKernelFailure,
                                       TransientServeError,
                                       active_fault_plan)
from repro_torch.tuning import (resolve_page_size, warmup_attention,
                                warmup_model)

# Per-request quant degradation ladder, most- to least-quantized.  A
# request whose logits go non-finite is retried one rung down (dense: the
# config dtype, QTensors dequantized); past the last rung it fails.
QUANT_LEVELS = ("w8a8", "int8w", "dense")

_FAILED_DESC = "Requests failed, by reason (kernel/nonfinite/deadline/...)"
_DEGRADED_DESC = ("Quant degradations, by from/to level (per-request "
                  "ladder steps and engine-init calibration fallback)")
_REJECTED_DESC = "Requests rejected/shed at admission, by policy"
_FALLBACK_DESC = ("Injected kernel failures re-dispatched on the plain "
                  "version, by dispatch stage")


class NonFiniteLogits(RuntimeError):
    """The sampled logits row held NaN or Inf: the quant ladder's
    trigger."""


class DeadlineExceeded(RuntimeError):
    """A request ran past its decode deadline."""


def _next_level(level: str) -> Optional[str]:
    i = QUANT_LEVELS.index(level)
    return QUANT_LEVELS[i + 1] if i + 1 < len(QUANT_LEVELS) else None


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
    # -- lifecycle ----------------------------------------------------------
    # pending -> queued -> running -> done | degraded | failed; rejected
    # requests (admission) never run.  ``degraded`` is a successful
    # terminal state: the output exists but was served below the engine's
    # base quant level and/or through a GEMM's plain re-dispatch.
    status: str = "pending"
    error: Optional[str] = None
    deadline_s: Optional[float] = None   # decode wall budget (from dequeue)
    queue_ttl_s: Optional[float] = None  # max submit() -> dequeue wait
    max_retries: int = 0                 # transient-failure retry budget
    attempts: int = 0                    # serve attempts consumed
    quant_level: Optional[str] = None    # level of the last attempt
    degraded_to: Optional[str] = None    # set when the ladder stepped down
    fallbacks: int = 0                   # plain re-dispatches while serving
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
    and ``kv_pool_pages`` pages in all (0: the pages ``batch_size``
    sequences of ``max_len`` tokens need, the reference's default), at
    most ``kv_max_pages_per_seq`` a sequence (0: the pages of one such
    sequence).  The pool lives on the engine's device for its whole life
    and is written in place.

    ``batch_size`` (default 1, so that callers written before it keep
    their behaviour; the reference has no default) sizes the GEMM plan
    warmup, rows ``[batch_size, batch_size·max_len]``, and the default
    page pool.  Requests are served one at a time, as the reference's
    ``run`` serves them.  ``warmup_gemms=False`` skips the warmup.
    ``tp_local=(dp, tp)`` also warms the per-device ring-step local
    shapes that a tensor-parallel serve path
    (:mod:`repro_torch.serve.tp`, ``core.distributed.dist_matmul``)
    resolves.

    ``max_queue`` bounds the queue (0: unbounded), ``overflow`` picks the
    backpressure (``"reject"`` the new request or ``"shed_oldest"``);
    ``retry_backoff_s`` is the first transient retry's wait (doubling);
    ``check_finite`` turns the non-finite logits check (the ladder's
    trigger) on.

    ``sample_table`` is the ``embeds`` frontend's table (default: built
    on first use, :func:`sample_table`); passing one shares it between
    engines of the same arch.
    """

    def __init__(self, params: Dict[str, object], cfg: ModelConfig, *,
                 max_len: int, batch_size: int = 1, seed: int = 0,
                 warmup_gemms: bool = True,
                 device=None, paged_kv: bool = False, kv_page_size: int = 0,
                 quantize_activations: bool = False,
                 calibration_batches: int = 4,
                 act_qconfig: Optional[QuantConfig] = None,
                 tp_local: Optional[Tuple[int, int]] = None,
                 max_queue: int = 0, overflow: str = "reject",
                 retry_backoff_s: float = 0.05, check_finite: bool = True,
                 kv_pool_pages: int = 0, kv_max_pages_per_seq: int = 0,
                 sample_table: Optional[torch.Tensor] = None):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if overflow not in ("reject", "shed_oldest"):
            raise ValueError(f"unknown overflow policy {overflow!r}")
        self.max_queue = max_queue          # 0: unbounded admission
        self.overflow = overflow
        self.retry_backoff_s = retry_backoff_s
        self.check_finite = check_finite
        self.device = M.resolve_device(device)
        for name, t in params.items():
            if t.device.type != self.device.type:
                raise ValueError(f"param {name} lies on {t.device}, the "
                                 f"engine on {self.device}")
        self.params = params
        self.cfg = cfg
        self.B = batch_size
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
            try:
                with span("serve.calibrate", batches=calibration_batches):
                    self.params = self._calibrate_activations(
                        calibration_batches)
                self.w8a8 = True
            except Exception as e:  # repro: noqa RPR004 -- documented degradation: w8a8 -> int8w, counted in serve.degraded_total
                warnings.warn(
                    f"activation calibration failed ({e!r}); degrading "
                    "engine to weight-only int8 serving", RuntimeWarning)
                metrics.counter("serve.degraded_total",
                                _DEGRADED_DESC).labels(
                    **{"from": "w8a8", "to": "int8w"}).inc()
            self.calibration_s = time.perf_counter() - t0
            metrics.gauge(
                "serve.calibration_seconds",
                "Wall time of the w8a8 static-activation calibration "
                "pass").set(self.calibration_s)
        # Resolve every hot-path GEMM tile before the first request, for
        # the programs this engine's quant policy issues.
        quant_mode = "w8a8" if self.w8a8 else self.quantized
        t0 = time.perf_counter()
        rows = [batch_size, batch_size * max_len]
        with span("serve.warmup", quant=str(quant_mode)):
            self.gemm_plan_sources: Dict[str, str] = (
                warmup_model(cfg, rows, quant=quant_mode)
                if warmup_gemms else {})
            # A tensor-parallel engine also warms the per-device ring-step
            # local shapes that ``core.distributed.dist_matmul`` resolves:
            # tp_local=(dp, tp) rewrites each workload to
            # (ceil(m/dp), n/tp, k/tp).
            if warmup_gemms and tp_local is not None:
                self.gemm_plan_sources.update(warmup_model(
                    cfg, rows, quant=quant_mode, shard=tuple(tp_local)))
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
            per_seq = kvc.pages_for(max_len, page)
            self.kv_max_pages_per_seq = kv_max_pages_per_seq or per_seq
            self.kv_pool = kvc.PagePool(kv_pool_pages or batch_size * per_seq,
                                        page)
            metrics.gauge("serve.kv_pool_pages",
                          "Page count of the serve KV pool").set(
                              self.kv_pool.n_pages)
            self.kv_cache = M.make_paged_model_cache(
                cfg, 1, n_pages=self.kv_pool.n_pages, page_size=page,
                max_pages=self.kv_max_pages_per_seq, device=self.device)
        self.base_level = ("w8a8" if self.w8a8
                           else "int8w" if self.quantized else "dense")
        self._level_params: Dict[str, Dict[str, object]] = {
            self.base_level: self.params}

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

    # -- degradation ladder -------------------------------------------------

    def _params_for(self, level: str) -> Dict[str, object]:
        """The params serving quant ``level`` (built on first use, cached):
        ``int8w`` strips the calibrated ``act_scale`` from every QTensor
        (weight-only int8), ``dense`` dequantizes every QTensor to the
        config dtype."""
        params = self._level_params.get(level)
        if params is not None:
            return params
        base = self._level_params[self.base_level]
        if level == "int8w":
            params = {k: dataclasses.replace(v, act_scale=None, act_block=0)
                      if isinstance(v, QTensor) and v.act_scale is not None
                      else v for k, v in base.items()}
        elif level == "dense":
            dt = self.cfg.dtype()
            params = {k: v.dequantize(dt) if isinstance(v, QTensor) else v
                      for k, v in base.items()}
        else:
            raise ValueError(f"cannot degrade to level {level!r}")
        self._level_params[level] = params
        return params

    # -- admission ----------------------------------------------------------

    def submit(self, req: Request) -> bool:
        """Admit a request (True) or reject it under backpressure (False).

        On the paged path a request whose prompt plus full generation
        budget can never fit the pool, or the per-sequence cap, is
        rejected up front (``serve.rejected_total{policy=kv_pages}``).
        With ``max_queue`` set, a full queue either rejects the new
        request (``overflow="reject"``) or sheds the oldest queued one to
        admit it (``overflow="shed_oldest"``).  Every rejected request
        lands in ``done`` with status ``"rejected"`` and its reason in
        ``error``."""
        req.generated = []

        def rejected(policy):
            return get_metrics().counter(
                "serve.rejected_total", _REJECTED_DESC).labels(policy=policy)

        if self.kv_pool is not None:
            need = self.kv_pool.pages_for(
                len(req.prompt) + req.max_new_tokens)
            if need > min(self.kv_pool.n_pages, self.kv_max_pages_per_seq):
                req.status = "rejected"
                req.error = (f"kv pages: need {need} pages, pool holds "
                             f"{self.kv_pool.n_pages} "
                             f"(per-seq cap {self.kv_max_pages_per_seq})")
                rejected("kv_pages").inc()
                self.done[req.uid] = req
                return False
        if self.max_queue and len(self.queue) >= self.max_queue:
            if self.overflow == "reject":
                req.status = "rejected"
                req.error = f"queue full ({len(self.queue)}/{self.max_queue})"
                rejected("reject").inc()
                self.done[req.uid] = req
                return False
            old = self.queue.popleft()
            self._submit_t.pop(old.uid, None)
            old.status = "rejected"
            old.error = "shed: queue full and a newer request arrived"
            rejected("shed_oldest").inc()
            self.done[old.uid] = old
        req.status = "queued"
        self.queue.append(req)
        self._submit_t[req.uid] = time.perf_counter()
        return True

    def _sample(self, logits: torch.Tensor, temperature: float) -> int:
        """Sample the last position's real vocabulary: (1, L, V) logits,
        or (1, L, Cb, V) with codebooks, of which codebook 0 is sampled.
        With ``check_finite`` every codebook's row is checked first and a
        non-finite one raises :class:`NonFiniteLogits` (the check rides
        the sample's read to the host)."""
        row = logits[0, -1, ..., :self.cfg.vocab_size]
        if self.check_finite and not bool(torch.isfinite(row).all()):
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
        tokens over this call's wall time.  Each request is served under
        the isolation wrapper (:meth:`_serve_with_recovery`): a failure
        marks that request failed and the loop goes on."""
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
            "failed": metrics.counter(
                "serve.requests_failed_total", _FAILED_DESC),
            "degraded": metrics.counter(
                "serve.degraded_total", _DEGRADED_DESC),
            "retries": metrics.counter(
                "serve.retries_total",
                "Transient-failure retries (exponential backoff)"),
            "fallback": metrics.counter(
                "gemm.fallback_total", _FALLBACK_DESC),
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
                    wait = t_req - submitted
                    self._h["queue_wait"].observe(wait)
                    if req.queue_ttl_s is not None \
                            and wait > req.queue_ttl_s:
                        self._finish_failed(
                            req, "queue_ttl",
                            f"queued {wait:.3f}s > ttl {req.queue_ttl_s}s")
                        continue
                req.status = "running"
                self._serve_with_recovery(req, t_req)
        elapsed = time.perf_counter() - t_run
        if elapsed > 0:
            metrics.gauge(
                "serve.tokens_per_second",
                "Output tokens over the last run()'s wall time").set(
                    (tokens.value - before) / elapsed)
        return self.done

    def _finish_failed(self, req: Request, reason: str, msg: str) -> None:
        req.status = "failed"
        req.error = f"{reason}: {msg}" if msg else reason
        self._h["failed"].labels(reason=reason).inc()
        self.done[req.uid] = req

    @staticmethod
    def _failure_reason(exc: Exception) -> str:
        if isinstance(exc, InjectedKernelFailure):
            return "kernel"
        if isinstance(exc, DeadlineExceeded):
            return "deadline"
        if isinstance(exc, NonFiniteLogits):
            return "nonfinite"
        if getattr(exc, "transient", False):
            return "transient"
        return type(exc).__name__

    def _serve_with_recovery(self, req: Request, t_req: float) -> None:
        """Serve one request under the isolation wrapper: transient
        failures retry with exponential backoff, non-finite logits walk
        the quant ladder down, everything else fails exactly this
        request.  Terminal status, error and counters are set here."""
        level = self.base_level
        deadline_t = (t_req + req.deadline_s
                      if req.deadline_s is not None else None)
        fb0 = self._h["fallback"].value
        retries = 0
        backoff = self.retry_backoff_s
        while True:
            req.attempts += 1
            req.generated = []
            req.quant_level = level
            try:
                with span("serve.request", uid=req.uid,
                          attempt=req.attempts, level=level,
                          prompt_len=len(req.prompt),
                          max_new_tokens=req.max_new_tokens):
                    self._serve_one(req, self._params_for(level),
                                    deadline_t)
                break
            except NonFiniteLogits as e:
                nxt = _next_level(level)
                if nxt is None:
                    self._finish_failed(req, "nonfinite", str(e))
                    return
                self._h["degraded"].labels(
                    **{"from": level, "to": nxt}).inc()
                req.degraded_to = nxt
                level = nxt
            except Exception as e:  # repro: noqa RPR004 -- request isolation: failure lands on this request via _finish_failed, not the engine
                if getattr(e, "transient", False) \
                        and retries < req.max_retries:
                    retries += 1
                    self._h["retries"].inc()
                    time.sleep(backoff)
                    backoff *= 2
                    continue
                self._finish_failed(req, self._failure_reason(e), str(e))
                return
        req.error = None
        req.fallbacks = int(self._h["fallback"].value - fb0)
        req.status = ("degraded" if req.degraded_to or req.fallbacks
                      else "done")
        self.done[req.uid] = req
        self._h["n_requests"].inc()

    def _tokens(self, ids) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ids, dtype=np.int64),
                               device=self.device).reshape(1, -1)

    def _inputs(self, toks: torch.Tensor) -> Dict[str, torch.Tensor]:
        if self.cfg.frontend != "tokens" and self._table is None:
            self._table = sample_table(self.cfg, self.device)
        return model_inputs(self.cfg, toks, self._table)

    def _serve_one(self, req: Request, params: Dict[str, object],
                   deadline_t: Optional[float]) -> None:
        """One serve attempt.  On the paged path the request's pages
        (prompt plus full generation budget) are held for exactly the
        attempt: the ``finally`` unmaps and frees them whatever happens
        (freeing a sequence that holds none is a no-op), so a failed or
        retried attempt leaks no pool capacity."""
        if self.kv_pool is None:
            self._serve_attempt(req, params, deadline_t, paged=False)
            return
        try:
            self._serve_attempt(req, params, deadline_t, paged=True)
        finally:
            kvc.model_release_sequence(self.kv_cache, 0)
            self.kv_pool.free(req.uid)

    def _serve_attempt(self, req: Request, params: Dict[str, object],
                       deadline_t: Optional[float], *, paged: bool) -> None:
        """Prefill and sample, then one decode step per further token.
        Raises on poisoned logits, a deadline overrun or an injected
        fault; appends sampled tokens to ``req.generated`` as it goes (a
        deadline failure keeps the partial output).  Each decode step
        first consults the active fault plan
        (:meth:`~repro_torch.runtime.fault.FaultPlan.decode_fault`)."""
        h = self._h
        ledger = get_ledger()
        plan = active_fault_plan()
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
            logits, cache = M.prefill(params, self._inputs(toks), self.cfg,
                                      max_len=self.max_len, cache=cache)
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
                if deadline_t is not None \
                        and time.perf_counter() > deadline_t:
                    raise DeadlineExceeded(
                        f"decode deadline {req.deadline_s}s exceeded "
                        f"after {len(req.generated)} tokens")
                t_tok = time.perf_counter()
                fault = plan.decode_fault() if plan is not None else None
                if fault is not None and fault.slow_s:
                    time.sleep(fault.slow_s)
                if fault is not None and fault.transient:
                    raise TransientServeError(
                        f"injected transient failure (request {req.uid})")
                with ledger.step("decode"):
                    logits, cache = M.decode_step(
                        params, self._inputs(self._tokens([nxt])), cache,
                        pos, self.cfg)
                    if fault is not None and fault.nan:
                        logits = torch.full_like(logits, float("nan"))
                    nxt = self._sample(logits, req.temperature)
                dt = time.perf_counter() - t_tok
                h["tpot"].observe(dt)
                h["decode_s"].inc(dt)
                h["tokens"].inc()
                req.generated.append(nxt)
                pos += 1
        req.decode_s = time.perf_counter() - t1

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
