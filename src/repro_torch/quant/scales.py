"""Scale computation and the QTensor (port of ``repro/quant/scales.py``).

Scale layouts (for a weight ``w`` of shape ``(..., k, n)``, contraction
axis ``k`` = ``axis=-2``):

* **per-channel** (``block=0``): one fp32 scale per output channel —
  ``scale.shape = (..., 1, n)``.  The dequant ``acc * s_b`` is a column
  broadcast, applied in the GEMM drain.
* **per-tile** (``block=g``): the contraction axis is split into
  ``ceil(k/g)`` blocks, one scale row per block —
  ``scale.shape = (..., ceil(k/g), n)``.  ``g`` is a multiple of 128, so
  each k slab the kernel streams lies in one block and the kernel scales
  that block's partial product.

``fmt="fp8_e4m3"`` / ``"fp8_e5m2"`` is the reference's fp8-via-int8
emulation: the scaled value is rounded onto the fp8 grid
(``torch.float8_e4m3fn`` / ``torch.float8_e5m2``) and the payload holds
its **bit pattern** viewed as int8, so the streamed bytes are int8's while
the value grid is floating point.  The kernel takes int8 payloads only;
an fp8 weight is served by :meth:`QTensor.dequantize` and a plain product
(``core.gemm``), as the reference's oracle path serves it.

The op order of :func:`quantize` is the reference's (``x.float() / s``,
then round half to even and clamp to ±127, or the fp8 cast), so the
payloads come out bit-identical.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

INT_FORMATS = ("int8",)
FP8_FORMATS = ("fp8_e4m3", "fp8_e5m2")
FORMATS = INT_FORMATS + FP8_FORMATS

# Largest representable magnitude per format: int8 symmetric [-127, 127]
# (−128 is excluded so the grid is symmetric), fp8 per its finite range.
_FMT_MAX = {"int8": 127.0, "fp8_e4m3": 448.0, "fp8_e5m2": 57344.0}


def check_format(fmt: str) -> None:
    if fmt not in FORMATS:
        raise ValueError(f"unknown quant format {fmt!r} "
                         f"(valid: {FORMATS}) [QNT003]")


def _fp8_dtype(fmt: str) -> torch.dtype:
    return torch.float8_e4m3fn if fmt == "fp8_e4m3" else torch.float8_e5m2



def dtype_short(dtype) -> str:
    """Short dtype name used in mixed-precision cache keys (the
    reference's spelling)."""
    name = dtype if isinstance(dtype, str) else \
        str(dtype).removeprefix("torch.")
    return {"bfloat16": "bf16", "float32": "f32", "float16": "f16",
            "float64": "f64"}.get(name, name)


def quant_dtype_str(act_dtype, weight_dtype) -> str:
    """Cache-key dtype string for a mixed-precision GEMM, byte-identical to
    the reference's: ``quant_dtype_str(torch.bfloat16, torch.int8) ==
    "int8w_bf16a"`` — weight dtype first, activation second."""
    return f"{dtype_short(weight_dtype)}w_{dtype_short(act_dtype)}a"

def _norm_axis(ndim: int, axis: int) -> int:
    norm = axis if axis >= 0 else ndim + axis
    if not 0 <= norm < ndim:
        raise ValueError(f"axis {axis} out of range for ndim {ndim}")
    return norm


def _percentile(x: torch.Tensor, p: float, dim: Optional[int] = None,
                keepdim: bool = False, counted: bool = False) -> torch.Tensor:
    """The 'linear' percentile of fp32 ``x`` along ``dim`` (all elements
    when None), by sorting (``torch.quantile`` refuses inputs past 2^24
    elements), with the reference's fp32 interpolation,
    ``low·(1 − w) + high·w``.  The index ``(p / 100)·(n − 1)`` is taken
    as XLA rewrites it in fp32: ``p · ((n − 1) · 0.01)`` when ``n`` is a
    shape, ``(p · 0.01) · (n − 1)`` when it is counted at run time
    (``counted``: the reference's ``nanpercentile`` of per-tile blocks).
    The plain fp32 chain lands one ulp of the index off these for some
    ``n``, which moves the scale by up to 1e-5 relative."""
    if dim is None:
        x, dim = x.reshape(-1), 0
    v = torch.sort(x, dim=dim).values
    n = v.shape[dim]
    f32 = lambda t: torch.tensor(t, dtype=torch.float32)  # noqa: E731
    index = (f32(p) * f32(0.01) * f32(n - 1) if counted
             else f32(p) * (f32(n - 1) * f32(0.01)))
    lo = int(torch.floor(index))
    hi = min(int(torch.ceil(index)), n - 1)
    w_hi = index - f32(lo)
    w_lo = f32(1.0) - w_hi
    out = (v.narrow(dim, lo, 1) * w_lo.to(v.device)
           + v.narrow(dim, hi, 1) * w_hi.to(v.device))
    return out if keepdim else out.squeeze(dim)


def _block_amax(xa: torch.Tensor, axis: int, block: int,
                pct: float) -> torch.Tensor:
    """Per-block max (or percentile) of ``|x|`` along ``axis``; the ragged
    last block reduces over its real rows only."""
    d = xa.shape[axis]
    rows = []
    for start in range(0, d, block):
        blk = xa.narrow(axis, start, min(block, d - start))
        rows.append(blk.amax(dim=axis, keepdim=True) if pct >= 100.0
                    else _percentile(blk, pct, axis, keepdim=True,
                                    counted=True))
    return torch.cat(rows, dim=axis)


def absmax_scale(x: torch.Tensor, axis: int = -2, block: int = 0,
                 percentile: float = 100.0, fmt: str = "int8",
                 eps: float = 1e-12) -> torch.Tensor:
    """fp32 scales such that ``x / scale`` fits the format's grid;
    ``percentile < 100`` clips outliers into saturation."""
    check_format(fmt)
    axis = _norm_axis(x.dim(), axis)
    xa = x.float().abs()
    if block:
        amax = _block_amax(xa, axis, block, percentile)
    elif percentile >= 100.0:
        amax = xa.amax(dim=axis, keepdim=True)
    else:
        amax = _percentile(xa, percentile, axis, keepdim=True)
    return torch.clamp_min(amax, eps) / _FMT_MAX[fmt]


def _expand_scale(scale: torch.Tensor, shape: Tuple[int, ...], axis: int,
                  block: int) -> torch.Tensor:
    """Broadcast a (per-channel or per-tile) scale over the full shape."""
    if not block:
        return scale  # keepdims layout broadcasts directly
    rep = torch.repeat_interleave(scale, block, dim=axis)
    return rep.narrow(axis, 0, shape[axis])


@dataclasses.dataclass
class QTensor:
    """Quantized tensor: int8 payload + fp32 scales.

    ``data``  — int8, the logical tensor's shape (for an fp8 ``fmt``, the
    fp8 bit pattern).
    ``scale`` — fp32; per-channel ``(..., 1, n)`` or per-tile
    ``(..., ceil(k/block), n)``.
    ``act_scale`` (optional) — a calibrated static activation scale for
    the GEMM this weight serves: a per-tensor scalar (``act_block=0``) or
    a per-k-tile ``(ceil(k/act_block),)`` vector, fp32.  A weight carrying
    it makes ``ca_matmul`` quantize the activation on entry and run the
    int8×int8 (``dqab``) program.  Layer-stacked weights carry a leading
    layers axis on ``act_scale`` too, and indexing slices it alongside.
    """

    data: torch.Tensor
    scale: torch.Tensor
    axis: int = -2
    block: int = 0
    fmt: str = "int8"
    act_scale: Optional[torch.Tensor] = None
    act_block: int = 0

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.data.shape)

    @property
    def ndim(self) -> int:
        return self.data.dim()

    @property
    def device(self) -> torch.device:
        return self.data.device

    def to(self, device) -> "QTensor":
        """The same payload and scales on ``device``."""
        return dataclasses.replace(
            self, data=self.data.to(device), scale=self.scale.to(device),
            act_scale=None if self.act_scale is None
            else self.act_scale.to(device))

    def __getitem__(self, idx) -> "QTensor":
        """Leading-axis indexing (layer-stacked weights): payload and
        scales slice together — valid because the quantization axis is
        stored from the end (negative)."""
        return QTensor(data=self.data[idx], scale=self.scale[idx],
                       axis=self.axis, block=self.block, fmt=self.fmt,
                       act_scale=None if self.act_scale is None
                       else self.act_scale[idx],
                       act_block=self.act_block)

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        check_format(self.fmt)
        axis = _norm_axis(self.ndim, self.axis)
        if self.fmt in FP8_FORMATS:
            vals = self.data.view(_fp8_dtype(self.fmt)).float()
        else:
            vals = self.data.float()
        s = _expand_scale(self.scale, self.shape, axis, self.block)
        return (vals * s).to(dtype)


def quantize(x: torch.Tensor, axis: int = -2, block: int = 0,
             percentile: float = 100.0, fmt: str = "int8") -> QTensor:
    """Quantize ``x`` along ``axis`` (the GEMM contraction dim).

    int8: symmetric round-to-nearest-even onto [-127, 127].  fp8 formats:
    cast onto the fp8 grid, payload = its bit pattern as int8."""
    check_format(fmt)
    axis = _norm_axis(x.dim(), axis)
    scale = absmax_scale(x, axis=axis, block=block, percentile=percentile,
                         fmt=fmt)
    s = _expand_scale(scale, tuple(x.shape), axis, block)
    scaled = x.float() / s
    if fmt in FP8_FORMATS:
        data = scaled.to(_fp8_dtype(fmt)).view(torch.int8)
    else:
        data = torch.clamp(torch.round(scaled), -127, 127).to(torch.int8)
    return QTensor(data=data, scale=scale, axis=axis - x.dim(),
                   block=block, fmt=fmt)


# ---------------------------------------------------------------------------
# Static activation quantization (the w8a8 serve path's quantize-on-entry)
# ---------------------------------------------------------------------------

def dequantize(q: QTensor, dtype=torch.float32) -> torch.Tensor:
    """The values ``q`` stands for, in ``dtype`` (:meth:`QTensor.dequantize`)."""
    return q.dequantize(dtype)


def expand_act_scale(scale, k: int, block: int = 0,
                     device=None) -> torch.Tensor:
    """Broadcast a static activation scale over the contraction axis: a
    per-tensor scalar (``block=0``) or a per-k-tile ``(ceil(k/block),)``
    vector; the result broadcasts against a ``(..., k)`` activation."""
    s = torch.as_tensor(scale, dtype=torch.float32, device=device)
    if not block:
        return s.reshape(())
    nb = -(-k // block)
    if s.numel() != nb:
        raise ValueError(f"activation scale has {s.numel()} entries, want "
                         f"ceil({k}/{block}) = {nb} [QNT003]")
    return torch.repeat_interleave(s.reshape(nb), block)[:k]


def quantize_activation(x: torch.Tensor, scale,
                        block: int = 0) -> torch.Tensor:
    """Quantize an activation with a *static* (calibrated) scale: values
    past the calibrated range saturate."""
    s = expand_act_scale(scale, x.shape[-1], block, x.device)
    scaled = x.float() / s
    return torch.clamp(torch.round(scaled), -127, 127).to(torch.int8)


def fake_quant_activation(x: torch.Tensor, scale,
                          block: int = 0) -> torch.Tensor:
    """Quantize-dequantize round trip: the oracle of the w8a8 path's
    quantize-on-entry (same grid, same saturation, fp32 math)."""
    s = expand_act_scale(scale, x.shape[-1], block, x.device)
    q = quantize_activation(x, scale, block)
    return (q.float() * s).to(x.dtype)
