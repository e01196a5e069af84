"""repro_torch.quant (port of ``repro.quant``): int8 quantization for the
CA-GEMM stack.

* :mod:`.scales`    — per-channel / per-tile scale math, the
  :class:`QTensor` (int8 payload + fp32 scales) and static activation
  quantization.
* :mod:`.calibrate` — absmax / percentile calibration, :class:`QuantConfig`
  and the w8a8 calibration context.

The consumer side is the kernel: the dequant runs inside the CA-GEMM
program (``dqb`` / ``dqab`` epilogue stages), so quantization changes only
the streamed bytes.  The fp8 emulation formats (``fp8_e4m3``,
``fp8_e5m2``: fp8 bit patterns on an int8 payload) quantize as the
reference's do and are served by dequantizing onto a plain product, as
the reference's oracle path serves them; the kernel refuses them.
"""

from repro_torch.quant.scales import (QTensor, absmax_scale,
                                      fake_quant_activation, quantize,
                                      quantize_activation)
from repro_torch.quant.calibrate import (ActivationCalibration, Calibrator,
                                         QuantConfig, activation_site,
                                         active_calibration,
                                         attach_act_scales, quantize_tensor)

__all__ = [
    "QTensor", "absmax_scale", "quantize",
    "quantize_activation", "fake_quant_activation",
    "Calibrator", "QuantConfig", "quantize_tensor",
    "ActivationCalibration", "activation_site", "active_calibration",
    "attach_act_scales",
]
