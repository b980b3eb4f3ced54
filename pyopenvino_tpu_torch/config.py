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
    BF16 = "bf16"          # named as in the JAX package; alone it changes
                           # nothing there either (compute_dtype does)
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

COMPUTE_DTYPES = ("float32", "bfloat16")
_DEPTHWISE_MODES = ("native", "shifted_mac")


def check_supported(config: "Config") -> None:
    """Raise ValueError for an option value the engine does not know.

    ``QuantMode.BF16`` is accepted and, as in the JAX package, changes
    nothing by itself (no pass reads it): bfloat16 compute is
    ``compute_dtype="bfloat16"``, in any quant mode."""
    if config.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(
            f"Config.compute_dtype {config.compute_dtype!r}: one of {COMPUTE_DTYPES}")
    if config.depthwise_mode not in _DEPTHWISE_MODES:
        raise ValueError(
            f"Config.depthwise_mode {config.depthwise_mode!r}: one of "
            f"{_DEPTHWISE_MODES}")
    for axis in ("mesh_data", "mesh_model", "mesh_spatial"):
        size = getattr(config, axis)
        if not isinstance(size, int) or size < 1:
            raise ValueError(f"Config.{axis} {size!r}: a positive int")
    buckets = config.batch_buckets
    if (not isinstance(buckets, tuple) or not buckets
            or any(not isinstance(b, int) or b < 1 for b in buckets)
            or list(buckets) != sorted(set(buckets))):
        raise ValueError(
            f"Config.batch_buckets {buckets!r}: a non-empty tuple of positive "
            f"ints in ascending order")


@dataclasses.dataclass
class Config:
    backend: Backend = Backend.TORCH
    quant: QuantMode = QuantMode.NONE
    # Device mesh axes (parallel/mesh.py): data = batch blocks (DP), model =
    # output-channel shards (TP, EP on an expert stack), spatial = image-row
    # blocks (SP, halo exchanges).  (1, 1, 1) is one device; a larger mesh
    # is built on the default devices of the network's device type and
    # attached by compile_model.  model > 1 and spatial > 1 cannot be
    # combined, as in the JAX package.
    mesh_data: int = 1
    mesh_model: int = 1
    mesh_spatial: int = 1
    # The JAX package's Config fields, with its defaults and meaning:
    # weights with fewer elements than this stay float under INT8 (0 =
    # quantize every weight; passes/quantize.py).
    quant_min_elems: int = 0
    # GroupConvolution emission: "native" (grouped F.conv2d) or
    # "shifted_mac" (kh·kw shifted multiply-adds, ops/conv.py).
    depthwise_mode: str = "native"
    # Fold E[(W − deq(W_q))·x] over the calibration samples into each fused
    # layer's bias (passes/bias_correct.py); INT8 weight-only and INT8-FULL.
    bias_correction: bool = False
    # "float32" or "bfloat16": float weights, scales and activations in
    # this dtype, every product summed in float32 (runtime/compiler.py).
    compute_dtype: str = "float32"
    # INT8-FULL: store qualifying activation edges as int8 between ops
    # (runtime/compiler.py _find_int8_edges; the TORCH backend only, as the
    # JAX package does it on XLA only).
    int8_dataflow: bool = True
    # INT8-FULL calibration: clipping percentile of |activation| (100 =
    # max-abs) for method "percentile", or "kl" (entropy calibration;
    # passes/calibrate.py).
    calibration_percentile: float = 100.0
    calibration_method: str = "percentile"
    # Serving (serving/server.py): a coalesced batch is padded up to the
    # smallest of these that holds it, so the compiled network bakes one
    # model per bucket and steady-state serving bakes nothing new.
    batch_buckets: tuple = (1, 2, 4, 8, 16, 32)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)
