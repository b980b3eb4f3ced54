"""ReduceMean and Swish, the extension ops that EfficientNet-B0 and
``shapes_resnet`` need.

The port's own copy of the parts of ``pyopenvino_tpu/ops/extended.py`` it
runs (opset1 ReduceMean, opset4 Swish), with the same numpy
``ref_compute``; the rest of that registry (Split and the others) comes
with later port slices (ROADMAP.md).  Neither op takes an int8-stored
activation: under INT8-FULL the compiler dequantizes one reaching them.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from pyopenvino_tpu_torch.ops.elementwise import _Unary
from pyopenvino_tpu_torch.ops.spec import Op, ShapeResult, TValue, register


def _norm_axis(value, rank, op):
    """Negative-axis normalization with a range check: ``% rank`` alone
    would wrap an out-of-range positive axis onto the batch dim."""
    axis = int(np.asarray(value).reshape(()))
    if not -rank <= axis < rank:
        raise ValueError(f"{op}: axis {axis} out of range for rank {rank}")
    return axis % rank


@register
class ReduceMean(Op):
    """opset1 ReduceMean over constant axes (input 1) with the keep_dims
    attribute.  Global average pooling is ReduceMean over (2, 3)."""

    type_name = "ReduceMean"

    @staticmethod
    def _keep(node) -> bool:
        return str(node.attrs.get("keep_dims", "true")).lower() in ("1", "true")

    @staticmethod
    def _axes(source, rank):
        if source is None:
            raise ValueError("Reduce: axes are not constant")
        return tuple(sorted(
            _norm_axis(a, rank, "Reduce") for a in np.asarray(source).reshape(-1)))

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        in_shape = in_shapes[0]
        axes = self._axes(in_values.get(1), len(in_shape))
        if self._keep(node):
            shape = tuple(1 if i in axes else d for i, d in enumerate(in_shape))
        else:
            shape = tuple(d for i, d in enumerate(in_shape) if i not in axes)
        res = ShapeResult({node.out_port: shape})
        if in_values.get(0) is not None:
            res.values[node.out_port] = np.mean(in_values[0], axis=axes,
                                                keepdims=self._keep(node))
        return res

    def ref_compute(self, node, inputs) -> Dict[int, np.ndarray]:
        axes = self._axes(inputs[1], inputs[0].ndim)
        out = np.mean(inputs[0], axis=axes, keepdims=self._keep(node))
        return {node.out_port: np.asarray(out, dtype=inputs[0].dtype)}

    def emit(self, ctx, node, inputs) -> Dict[int, TValue]:
        # the axes come from the compile-time value, never from the device
        x = inputs[0].arr
        axes = self._axes(ctx.static_value(node, 1), x.dim())
        return {node.out_port: TValue(torch.mean(x, dim=axes, keepdim=self._keep(node)))}


def _sigmoid(x, m):
    return 1.0 / (1.0 + m.exp(-x))


@register
class Swish(_Unary):
    """opset4 Swish: x·sigmoid(beta·x), beta from the attribute (default 1),
    in the JAX package's formula on numpy arrays and tensors alike."""

    type_name = "Swish"

    @staticmethod
    def _formula(node, x, m):
        beta = float(node.attrs.get("beta", 1.0))
        return x * _sigmoid(beta * x, m)

    def ref_compute(self, node, inputs):
        x = inputs[0]
        return {node.out_port: self._formula(node, x, np).astype(x.dtype)}

    def emit(self, ctx, node, inputs):
        return {node.out_port: TValue(self._formula(node, inputs[0].arr, torch))}
