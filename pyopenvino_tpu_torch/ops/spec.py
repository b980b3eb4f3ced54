"""Op registry and the value that flows between emitted ops.

Counterpart of ``pyopenvino_tpu/ops/spec.py``.  Each op registers a typed
implementation with two entry points:

  * ``infer_shapes`` — static shape inference plus value propagation for
    statically known tensors (reshape targets and the like);
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


class TValue:
    """An emitted tensor with the INT8 slots of the JAX package's TValue.

    ``qscale``: per-output-channel dequant scales when ``arr`` holds int8
    weights; ``act_scale``: per-tensor storage scale when ``arr`` holds an
    int8 activation.  Both stay None until the INT8 slices."""

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

    def __repr__(self):
        return f"TValue({self.shape}, {self.dtype})"


@dataclasses.dataclass
class ShapeResult:
    """Outcome of shape inference: {out_port: shape} plus, when the op's
    output is statically computable, {out_port: value}."""

    shapes: Dict[int, Tuple[int, ...]]
    values: Dict[int, np.ndarray] = dataclasses.field(default_factory=dict)


class Op:
    """Base class; subclasses set ``type_name`` and override the hooks."""

    type_name: str = ""

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
