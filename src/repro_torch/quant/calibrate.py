"""Calibration: turn observed tensors into quantization scales (port of
``repro/quant/calibrate.py``).

* **Weights** are static — :func:`quantize_tensor` computes scales from
  the tensor itself (absmax or percentile), per-channel or per-tile.
* **Activations** are a stream — :class:`Calibrator` folds a running
  channel-wise absmax over sample batches (percentile mode keeps a bounded
  reservoir instead) and emits the static scale at the end.

The static-activation (w8a8) flow: an :class:`ActivationCalibration`
context records the input activation of every ``ca_matmul`` call that
consumes a quantized weight into a per-site :class:`Calibrator`;
:func:`attach_act_scales` then writes each site's static scale onto the
matching :class:`~repro_torch.quant.scales.QTensor` weights, and from then
on the serve path quantizes activations on entry and runs the int8×int8
(``dqab``) programs.  The port's forward is eager, so the context records
directly (the reference routes through ``io_callback`` because its
forward is traced).

Sites are keyed by the projection signature ``k{k}n{n}``: projections
with identical shapes (and every layer of a stack) share one conservative
scale.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.quant.scales import (QTensor, _FMT_MAX, _percentile,
                                      check_format, quantize)

# Percentile mode: bounded count of per-batch |x| snapshots kept for the
# final quantile, a uniform reservoir subsample of the whole stream
# (deterministic seed).
_MAX_RESERVOIR = 64

ACT_FORMATS = ("none", "int8")


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """One knob bundle for a quantization policy.

    ``fmt``        — "int8" | "fp8_e4m3" | "fp8_e5m2" (the fp8 emulation
                     formats, served by dequantizing).
    ``method``     — "absmax" | "percentile".
    ``percentile`` — used when method == "percentile".
    ``block``      — 0 = per-channel; g > 0 = per-tile with k-blocks of g
                     rows (a multiple of 128).
    ``act_fmt``    — "none" (weight-only) or "int8" (static activation
                     quantization, the w8a8 serve path).
    ``act_block``  — 0 = one per-tensor a-scale; g > 0 = per-k-tile
                     a-scales of block g (a multiple of 128).
    """

    fmt: str = "int8"
    method: str = "absmax"
    percentile: float = 99.9
    block: int = 0
    act_fmt: str = "none"
    act_block: int = 0

    def __post_init__(self):
        check_format(self.fmt)
        if self.method not in ("absmax", "percentile"):
            raise ValueError(f"unknown calibration method {self.method!r}")
        if self.block % 128 != 0:
            raise ValueError(f"per-tile block {self.block} must be "
                             "bk-aligned (128-multiple) [QNT003]")
        if self.act_fmt not in ACT_FORMATS:
            raise ValueError(f"unknown activation format {self.act_fmt!r} "
                             "[QNT003]")
        if self.act_block % 128 != 0:
            raise ValueError(f"per-tile act_block {self.act_block} must "
                             "be bk-aligned (128-multiple) [QNT003]")

    @property
    def effective_percentile(self) -> float:
        return self.percentile if self.method == "percentile" else 100.0

    @property
    def quantize_activations(self) -> bool:
        return self.act_fmt != "none"


def quantize_tensor(w: torch.Tensor, cfg: QuantConfig = QuantConfig(),
                    axis: int = -2) -> QTensor:
    """Quantize a (weight) tensor under ``cfg`` along its contraction axis."""
    return quantize(w, axis=axis, block=cfg.block,
                    percentile=cfg.effective_percentile, fmt=cfg.fmt)


class Calibrator:
    """Streaming scale estimation for activation tensors.

    ``observe`` batches of shape (..., k); ``static_scale(block)`` returns
    the static activation scale of the w8a8 path over everything seen: a
    per-tensor scalar (``block=0``) or per-k-tile ``(ceil(k/block),)``
    vector.
    """

    def __init__(self, cfg: QuantConfig = QuantConfig(), axis: int = -1):
        self.cfg = cfg
        self.axis = axis
        self._amax: Optional[torch.Tensor] = None
        self._reservoir: List[torch.Tensor] = []
        # Reservoir-sampling RNG: the reference's seed, so both keep the
        # same subsample of the same stream.
        self._rng = np.random.RandomState(0)
        self.n_observed = 0

    def observe(self, x: torch.Tensor) -> None:
        self.n_observed += 1
        axis = x.dim() + self.axis if self.axis < 0 else self.axis
        red = tuple(i for i in range(x.dim()) if i != axis)
        xa = x.float().abs()
        amax = xa.amax(dim=red) if red else xa
        if self.cfg.method == "percentile":
            flat = torch.movedim(xa, axis, -1).reshape(-1, x.shape[axis])
            if len(self._reservoir) < _MAX_RESERVOIR:
                self._reservoir.append(flat)
            else:
                j = int(self._rng.randint(0, self.n_observed))
                if j < _MAX_RESERVOIR:
                    self._reservoir[j] = flat
        self._amax = amax if self._amax is None \
            else torch.maximum(self._amax, amax)

    def _stacked_reservoir(self) -> torch.Tensor:
        if not self._reservoir:
            raise RuntimeError(
                "percentile calibration has an empty reservoir: observe() "
                "batches in percentile mode before asking for a scale")
        return torch.cat(self._reservoir, dim=0)

    def static_scale(self, block: int = 0) -> torch.Tensor:
        """Static activation scale over everything seen, on the activation
        format's grid: shape ``()`` (``block=0``) or ``(ceil(k/block),)``."""
        if self.n_observed <= 0:
            raise ValueError("observe() at least one batch first")
        act_fmt = self.cfg.act_fmt if self.cfg.act_fmt != "none" \
            else self.cfg.fmt
        fmt_max = _FMT_MAX[act_fmt]
        if self.cfg.method == "percentile":
            stacked = self._stacked_reservoir()  # (rows, k)
            k = stacked.shape[-1]
            if not block:
                amax = _percentile(stacked, self.cfg.percentile)
            else:
                amax = torch.stack([
                    _percentile(stacked[:, i:i + block], self.cfg.percentile)
                    for i in range(0, k, block)])
        else:
            am = self._amax  # (k,)
            k = am.shape[-1]
            if not block:
                amax = am.max()
            else:
                amax = torch.stack([am[i:i + block].max()
                                    for i in range(0, k, block)])
        return torch.clamp_min(amax, 1e-12) / fmt_max


# ---------------------------------------------------------------------------
# Activation-calibration recording (the w8a8 serve path's observe phase)
# ---------------------------------------------------------------------------

_tls = threading.local()


def activation_site(weight_shape: Tuple[int, ...]) -> str:
    """Calibration site key for the GEMM a weight serves: ``k{k}n{n}``."""
    return f"k{weight_shape[-2]}n{weight_shape[-1]}"


def active_calibration() -> Optional["ActivationCalibration"]:
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


class ActivationCalibration:
    """Context manager (per thread): while active, every ``ca_matmul`` call
    consuming a quantized weight hands its input activation to a per-site
    :class:`Calibrator`."""

    def __init__(self, cfg: QuantConfig = QuantConfig(act_fmt="int8")):
        if not cfg.quantize_activations:
            raise ValueError(
                "ActivationCalibration needs cfg.act_fmt != 'none'")
        self.cfg = cfg
        self.calibrators: Dict[str, Calibrator] = {}

    def __enter__(self):
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc):
        _tls.stack.pop()

    def record(self, weight_shape: Tuple[int, ...], x: torch.Tensor) -> None:
        """Record activation ``x`` (shape (..., k)) for the site of a
        weight with ``weight_shape`` (..., k, n)."""
        site = activation_site(weight_shape)
        cal = self.calibrators.setdefault(site, Calibrator(self.cfg, axis=-1))
        cal.observe(x)

    def scales(self) -> Dict[str, torch.Tensor]:
        """{site: static a-scale} under the config's ``act_block``."""
        return {site: cal.static_scale(self.cfg.act_block)
                for site, cal in self.calibrators.items()}


def attach_act_scales(params: Dict[str, object],
                      scales: Dict[str, torch.Tensor],
                      block: int = 0) -> Dict[str, object]:
    """Write calibrated static a-scales onto the matching QTensor weights.

    Each int8 QTensor whose :func:`activation_site` appears in ``scales``
    gains ``act_scale`` (+ ``act_block``); layer-stacked (3-D) weights get
    the scale repeated over the layers axis, so indexing a layer slices
    it.  Leaves without a calibrated site keep serving weight-only.
    Returns a new dict; the input is not modified.
    """
    out = {}
    for key, leaf in params.items():
        s = scales.get(activation_site(leaf.shape)) \
            if isinstance(leaf, QTensor) and leaf.fmt == "int8" else None
        if s is None:
            out[key] = leaf
            continue
        s = torch.as_tensor(s, dtype=torch.float32, device=leaf.device)
        if leaf.ndim == 3:
            s = s.expand((leaf.shape[0],) + tuple(s.shape)).contiguous()
        out[key] = dataclasses.replace(leaf, act_scale=s, act_block=block)
    return out
