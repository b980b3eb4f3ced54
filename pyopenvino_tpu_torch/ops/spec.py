"""Op registry and the value that flows between emitted ops.

Counterpart of ``pyopenvino_tpu/ops/spec.py``.  Each op registers a typed
implementation with three entry points:

  * ``infer_shapes`` — static shape inference plus value propagation for
    statically known tensors (reshape targets and the like);
  * ``ref_compute``  — numpy, the same code as the JAX package's, for the
    interpreter backend (runtime/interpreter.py) and activation calibration;
  * ``emit``         — eager PyTorch on the compiled network's device.

Layout: every activation is its LOGICAL (IR-declared, NCHW) tensor.  4-D
activations are kept in ``torch.channels_last`` memory format, which is
what the JAX package's "CL" tag stood for: convs and pools run NHWC in
memory, a 1×1 conv's GEMM operand is a view, and a Reshape still flattens in
logical order.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch


class TValue:
    """An emitted tensor with the INT8 slots of the JAX package's TValue.

    ``qscale``: per-output-channel dequant scales when ``arr`` holds int8
    weights; ``act_scale``: per-tensor storage scale when ``arr`` holds int8
    activation codes (INT8-FULL storage, runtime/compiler.py
    ``_find_int8_edges``), x ≈ arr · act_scale."""

    __slots__ = ("arr", "qscale", "act_scale")

    def __init__(self, arr, qscale=None, act_scale=None):
        self.arr = arr
        self.qscale = qscale
        self.act_scale = act_scale

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.arr.shape)

    @property
    def dtype(self):
        return self.arr.dtype

    @staticmethod
    def quantize(x, scale):
        """round(x / scale) clipped to the symmetric ±127 code domain, in the
        JAX package's order (a float32 multiply by the Python float
        ``1.0 / scale``; ``torch.round`` rounds half to even like
        ``jnp.round``): the single inverse of ``dequant``."""
        return torch.clamp(torch.round(x.float() * (1.0 / scale)), -127, 127).to(torch.int8)

    def dequant(self, compute_dtype=None) -> "TValue":
        """Dequantized copy when ``arr`` holds int8 activation codes
        (act_scale set); self otherwise.  The product is float32, then cast
        to ``compute_dtype`` when one is given (the JAX package's order)."""
        if self.act_scale is None:
            return self
        arr = self.arr.float() * self.act_scale
        if compute_dtype is not None:
            arr = arr.to(compute_dtype)
        return TValue(arr, qscale=self.qscale)

    def __repr__(self):
        return f"TValue({self.shape}, {self.dtype})"


def int8_operand(ctx, node, x: TValue, w: TValue):
    """INT8-FULL: (int8 codes of the data input ``x``, their scale s_x) when
    the conv-family or MatMul ``node`` runs int8 × int8, else None.

    It does when ``w`` holds int8 codes and ``x`` either arrives stored as
    int8 (its storage scale is s_x) or has a calibrated activation scale,
    with which it is quantized here (the JAX ops' condition)."""
    stored = x.act_scale
    s_x = stored if stored is not None else (
        ctx.act_scale(node) if getattr(ctx, "full_int8", False) else None)
    if s_x is None or w.qscale is None:
        return None
    return (x.arr if stored is not None else TValue.quantize(x.arr, s_x)), s_x


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype (an IR port's declared type)."""
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


def int8_out_dtype(ctx, x: TValue):
    """The dtype an int8 × int8 conv or MatMul writes, the JAX package's
    rule: the compute dtype when its input ``x`` arrived stored as int8,
    else the dtype of the float input it quantized."""
    return ctx.compute_dtype if x.act_scale is not None else x.arr.dtype


@dataclasses.dataclass
class ShapeResult:
    """Outcome of shape inference: {out_port: shape} plus, when the op's
    output is statically computable, {out_port: value}."""

    shapes: Dict[int, Tuple[int, ...]]
    values: Dict[int, np.ndarray] = dataclasses.field(default_factory=dict)


class Op:
    """Base class; subclasses set ``type_name`` and override the hooks."""

    type_name: str = ""

    # Input ports whose ``emit`` takes an int8-stored activation (a TValue
    # with act_scale set): a tuple of port numbers, or "all".  The compiler
    # dequantizes an int8 value reaching any other port, so this is a
    # performance contract, never a correctness requirement.
    int8_ports = ()

    def ref_compute(self, node, inputs: Dict[int, np.ndarray]) -> Dict[int, np.ndarray]:
        raise NotImplementedError(f"{self.type_name}.ref_compute")

    def emit(self, ctx, node, inputs: Dict[int, TValue]) -> Dict[int, TValue]:
        raise NotImplementedError(f"{self.type_name}.emit")

    def infer_shapes(
        self,
        node,
        in_shapes: Dict[int, Tuple[int, ...]],
        in_values: Dict[int, Optional[np.ndarray]],
    ) -> ShapeResult:
        raise NotImplementedError(f"{self.type_name}.infer_shapes")


REGISTRY: Dict[str, Op] = {}


def register(cls):
    """Class decorator: instantiate and register by type_name."""
    inst = cls()
    if not inst.type_name:
        raise ValueError(f"{cls.__name__} has no type_name")
    REGISTRY[inst.type_name] = inst
    return cls


def get_op(type_name: str) -> Op:
    if type_name not in REGISTRY:
        raise KeyError(f"unsupported op type: {type_name!r}")
    return REGISTRY[type_name]


def supported_ops() -> Tuple[str, ...]:
    return tuple(sorted(REGISTRY))
