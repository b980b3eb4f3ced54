"""Reshape.

Counterpart of the Reshape part of ``pyopenvino_tpu/ops/shape_ops.py``.
The target shape is consumed at compile time (a static port); the
activation is reshaped in logical order, which ``torch.reshape`` does
whatever the tensor's memory format.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from pyopenvino_tpu_torch.ir import attrs as A
from pyopenvino_tpu_torch.ops.spec import Op, ShapeResult, TValue, register


def resolve_reshape_dims(
    in_shape: Tuple[int, ...], target: np.ndarray, special_zero: bool
) -> Tuple[int, ...]:
    """OpenVINO reshape semantics: 0 copies the input dim at the same (left-
    aligned) position when special_zero, a single -1 is inferred."""
    total = 1
    for d in in_shape:
        total *= d
    dims: List[int] = []
    deferred = -1
    remaining = total
    for idx, d in enumerate(int(t) for t in target):
        if d == 0 and special_zero:
            d = in_shape[idx]
        if d == -1:
            if deferred != -1:
                raise ValueError("Reshape: multiple -1 dims in target")
            deferred = idx
            dims.append(-1)
            continue
        if d == 0 or remaining % d:
            raise ValueError(
                f"Reshape: dim {d} does not divide {remaining} "
                f"(input {in_shape}, target "
                f"{tuple(int(t) for t in target)})")
        dims.append(d)
        remaining //= d
    if deferred != -1:
        dims[deferred] = remaining
    elif remaining != 1:
        raise ValueError(
            f"Reshape: target {tuple(int(t) for t in target)} covers "
            f"{total // remaining} of {total} elements of {in_shape}")
    return tuple(dims)


def _dims(node, in_shape, target):
    special_zero = A.get_bool(node.attrs, "special_zero", False)
    return resolve_reshape_dims(tuple(in_shape), np.asarray(target), special_zero)


@register
class Reshape(Op):
    type_name = "Reshape"

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        target = in_values.get(1)
        if target is None:
            raise ValueError(f"Reshape {node.name}: target shape is not constant")
        out = _dims(node, in_shapes[0], target)
        res = ShapeResult({node.out_port: out})
        if in_values.get(0) is not None:
            res.values[node.out_port] = in_values[0].reshape(out)
        return res

    def emit(self, ctx, node, inputs):
        x = inputs[0].arr
        dims = _dims(node, x.shape, ctx.static_value(node, 1))
        return {node.out_port: TValue(x.reshape(dims))}
