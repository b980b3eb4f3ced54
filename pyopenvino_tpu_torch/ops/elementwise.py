"""Add (numpy broadcast), ReLU, Clamp and SoftMax.

Counterpart of the matching ops of ``pyopenvino_tpu/ops/elementwise.py``.
Activations are logical tensors, so a (1, C, 1, 1) constant broadcasts over
the channel axis whatever the memory format.  SoftMax honours its declared
axis and subtracts the row max; on the KERNELS backend a 2-D softmax over
axis 1 runs the softmax_rows kernel, under the same condition as the JAX
package's Pallas route.
"""

from __future__ import annotations

import numpy as np
import torch

from pyopenvino_tpu_torch.ir import attrs as A
from pyopenvino_tpu_torch.ops.spec import Op, ShapeResult, TValue, register


@register
class Add(Op):
    type_name = "Add"

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        out = tuple(np.broadcast_shapes(in_shapes[0], in_shapes[1]))
        res = ShapeResult({node.out_port: out})
        if in_values.get(0) is not None and in_values.get(1) is not None:
            res.values[node.out_port] = in_values[0] + in_values[1]
        return res

    def emit(self, ctx, node, inputs):
        return {node.out_port: TValue(inputs[0].arr + inputs[1].arr)}


class _Unary(Op):
    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        return ShapeResult({node.out_port: in_shapes[0]})


@register
class ReLU(_Unary):
    type_name = "ReLU"

    def emit(self, ctx, node, inputs):
        return {node.out_port: TValue(torch.relu(inputs[0].arr))}


@register
class Clamp(_Unary):
    """Clamp to [min, max] (ReLU6 in MobileNet-v2).  After a conv or MatMul
    it is usually fused as the ("clamp", min, max) epilogue
    (passes/fuse.py); this is the standalone op."""

    type_name = "Clamp"

    def emit(self, ctx, node, inputs):
        lo = A.get_float(node.attrs, "min")
        hi = A.get_float(node.attrs, "max")
        return {node.out_port: TValue(torch.clamp(inputs[0].arr, lo, hi))}


@register
class SoftMax(_Unary):
    type_name = "SoftMax"

    def emit(self, ctx, node, inputs):
        axis = A.get_int(node.attrs, "axis", 1)
        x = inputs[0].arr
        if ctx.use_kernels and x.dim() == 2 and axis in (1, -1):
            from pyopenvino_tpu_torch.kernels.softmax import softmax_rows

            return {node.out_port: TValue(softmax_rows(x))}
        return {node.out_port: TValue(torch.softmax(x, dim=axis))}
