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
    QuantMode.INT8_WEIGHT: "port slice 2 (INT8 weight-only)",
    QuantMode.INT8_FULL: "port slice 4 (INT8-FULL)",
    QuantMode.BF16: "port slice 6 (the rest of the queue: bf16 compute)",
}


def check_supported(config: "Config") -> None:
    """Raise NotImplementedError for a backend or quant mode that the port
    does not run yet, naming the ROADMAP item that brings it."""
    for what in (config.backend, config.quant):
        if what in _NOT_YET:
            raise NotImplementedError(
                f"{what} is not ported yet: ROADMAP.md {_NOT_YET[what]}"
            )


@dataclasses.dataclass
class Config:
    backend: Backend = Backend.TORCH
    quant: QuantMode = QuantMode.NONE

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)
