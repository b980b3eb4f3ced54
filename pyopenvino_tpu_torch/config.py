"""Typed engine configuration: execution backend and quantization mode.

Counterpart of ``pyopenvino_tpu/config.py``.  ``Backend.TORCH`` plays the
part of the JAX package's ``XLA`` (plain PyTorch operators) and
``Backend.KERNELS`` the part of ``PALLAS`` (the hot ops run through the
port's hand-written CUDA/Triton kernels).  The reference's ``kernel_type``
strings keep their meaning.
"""

from __future__ import annotations

import dataclasses
import enum


class Backend(enum.Enum):
    INTERPRETER = "interpreter"
    TORCH = "torch"
    KERNELS = "kernels"


class QuantMode(enum.Enum):
    NONE = "none"          # FP32 weights/activations
    BF16 = "bf16"          # bfloat16 weights + activations
    INT8_WEIGHT = "int8w"  # INT8 weight-only, per-output-channel scales
    INT8_FULL = "int8"     # INT8 weights + activations (calibrated scales)


KERNEL_TYPE_TO_BACKEND = {
    "naive": Backend.INTERPRETER,
    "numpy": Backend.INTERPRETER,
    "special": Backend.TORCH,
    "interpreter": Backend.INTERPRETER,
    "xla": Backend.TORCH,
    "pallas": Backend.KERNELS,
    "torch": Backend.TORCH,
    "kernels": Backend.KERNELS,
}

# Where each mode that the port does not run yet is planned (ROADMAP.md,
# "Port slices").
_NOT_YET = {
    Backend.INTERPRETER: "port slice 4 (INT8-FULL, which brings the numpy "
                         "interpreter)",
    QuantMode.INT8_FULL: "port slice 4 (INT8-FULL)",
    QuantMode.BF16: "port slice 6 (the rest of the queue: bf16 compute)",
}


_DEPTHWISE_MODES = ("native", "shifted_mac")


def check_supported(config: "Config") -> None:
    """Raise NotImplementedError for a backend, quant mode or option that
    the port does not run yet, naming the ROADMAP item that brings it."""
    for what in (config.backend, config.quant):
        if what in _NOT_YET:
            raise NotImplementedError(
                f"{what} is not ported yet: ROADMAP.md {_NOT_YET[what]}"
            )
    if config.bias_correction:
        raise NotImplementedError(
            "Config.bias_correction is not ported yet: ROADMAP.md port slice "
            "4 (it runs the numpy interpreter over calibration samples)")
    if config.compute_dtype != "float32":
        raise NotImplementedError(
            f"Config.compute_dtype={config.compute_dtype!r} is not ported "
            f"yet: ROADMAP.md {_NOT_YET[QuantMode.BF16]}")
    if config.depthwise_mode not in _DEPTHWISE_MODES:
        raise ValueError(
            f"Config.depthwise_mode {config.depthwise_mode!r}: one of "
            f"{_DEPTHWISE_MODES}")


@dataclasses.dataclass
class Config:
    backend: Backend = Backend.TORCH
    quant: QuantMode = QuantMode.NONE
    # The JAX package's Config fields, with its defaults and meaning:
    # weights with fewer elements than this stay float under INT8 (0 =
    # quantize every weight; passes/quantize.py).
    quant_min_elems: int = 0
    # GroupConvolution emission: "native" (grouped F.conv2d) or
    # "shifted_mac" (kh·kw shifted multiply-adds, ops/conv.py).
    depthwise_mode: str = "native"
    # Not ported yet: setting either raises (check_supported).
    bias_correction: bool = False
    compute_dtype: str = "float32"

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)
