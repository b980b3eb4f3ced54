"""Reshape, Transpose, Unsqueeze, StridedSlice, ShapeOf and Concat.

Counterpart of ``pyopenvino_tpu/ops/shape_ops.py``, whose numpy
``ref_compute`` and value propagation each op repeats.  Reshape targets,
Transpose orders, Unsqueeze axes and StridedSlice bounds are consumed at
compile time (static ports of runtime/compiler.py); the activation is
handled in logical order, which ``torch.reshape`` and ``permute`` do
whatever the tensor's memory format (a 4-D Reshape result that has to be
copied is copied into channels_last memory, ``reshaped``).  In SSD the
ShapeOf → StridedSlice → PriorBoxClustered → Unsqueeze → Concat chains
fold completely at compile time (passes/shape_infer.py): none of them runs
per call.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

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

    def ref_compute(self, node, inputs):
        return {node.out_port: inputs[0].reshape(_dims(node, inputs[0].shape, inputs[1]))}

    def emit(self, ctx, node, inputs):
        x = inputs[0].arr
        dims = _dims(node, x.shape, ctx.static_value(node, 1))
        return {node.out_port: TValue(reshaped(x, dims))}


def reshaped(x, dims):
    """``x.reshape(dims)`` in logical order.  A view where one exists (the
    first Reshape of a channel shuffle splits the channels of a
    channels_last tensor, (N, C, H, W) → (N, g, C/g, H, W), in place);
    otherwise a 4-D result is written once in channels_last memory, the
    port's layout of 4-D activations (the shuffle's last Reshape,
    (N, C/g, g, H, W) → (N, C, H, W), whose plain reshape would leave an
    NCHW-contiguous tensor for every later op to convert)."""
    try:
        return x.view(dims)
    except RuntimeError:
        pass
    if len(dims) == 4:
        out = torch.empty(dims, dtype=x.dtype, device=x.device,
                          memory_format=torch.channels_last)
        try:
            out.view(x.shape).copy_(x)
            return out
        except RuntimeError:
            pass  # x's shape does not refine the channels_last layout
    return x.reshape(dims)


@register
class Transpose(Op):
    type_name = "Transpose"

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        axes = in_values.get(1)
        if axes is None:
            raise ValueError(f"Transpose {node.name}: axes are not constant")
        axes = tuple(int(a) for a in axes)
        res = ShapeResult({node.out_port: tuple(in_shapes[0][a] for a in axes)})
        if in_values.get(0) is not None:
            res.values[node.out_port] = in_values[0].transpose(axes)
        return res

    def ref_compute(self, node, inputs):
        return {node.out_port: inputs[0].transpose(tuple(int(a) for a in inputs[1]))}

    def emit(self, ctx, node, inputs):
        axes = tuple(int(a) for a in ctx.static_value(node, 1))
        return {node.out_port: TValue(inputs[0].arr.permute(axes))}


def _unsqueezed(in_shape, axes):
    out_rank = len(in_shape) + len(axes)
    axes = tuple(a % out_rank for a in axes)
    it = iter(in_shape)
    return tuple(1 if i in axes else next(it) for i in range(out_rank))


@register
class Unsqueeze(Op):
    type_name = "Unsqueeze"

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        axes = in_values.get(1)
        if axes is None:
            raise ValueError(f"Unsqueeze {node.name}: axes are not constant")
        out = _unsqueezed(in_shapes[0], tuple(int(a) for a in axes))
        res = ShapeResult({node.out_port: out})
        if in_values.get(0) is not None:
            res.values[node.out_port] = in_values[0].reshape(out)
        return res

    def ref_compute(self, node, inputs):
        out = _unsqueezed(inputs[0].shape, tuple(int(a) for a in inputs[1]))
        return {node.out_port: inputs[0].reshape(out)}

    def emit(self, ctx, node, inputs):
        axes = tuple(int(a) for a in ctx.static_value(node, 1))
        x = inputs[0].arr
        return {node.out_port: TValue(x.reshape(_unsqueezed(tuple(x.shape), axes)))}


def _strided_slice_spec(node, in_rank, begin, end, strides):
    """A numpy index list honouring the opset1 masks: begin/end (bit 1 →
    the bound is ignored), new_axis (a unit dim that consumes no input
    axis), shrink_axis (an integer index), ellipsis (at most one bit)."""
    begin_mask = A.get_int_tuple(node.attrs, "begin_mask", ())
    end_mask = A.get_int_tuple(node.attrs, "end_mask", ())
    new_axis = A.get_int_tuple(node.attrs, "new_axis_mask", ())
    shrink = A.get_int_tuple(node.attrs, "shrink_axis_mask", ())
    ellipsis = A.get_int_tuple(node.attrs, "ellipsis_mask", ())

    def bit(mask, i):
        return mask[i] if i < len(mask) else 0

    def bounds(i):
        b = None if bit(begin_mask, i) else int(begin[i])
        e = None if bit(end_mask, i) else int(end[i])
        s = int(strides[i]) if strides is not None and i < len(strides) else 1
        return slice(b, e, s)

    if any(ellipsis):
        if sum(1 for i in range(len(begin)) if bit(ellipsis, i)) > 1:
            raise ValueError("StridedSlice: at most one ellipsis_mask bit is allowed")
        spec = []
        for i in range(len(begin)):
            if bit(ellipsis, i):
                spec.append(Ellipsis)
            elif bit(new_axis, i):
                spec.append(None)
            elif bit(shrink, i):
                spec.append(int(begin[i]))
            else:
                spec.append(bounds(i))
        return spec

    spec = []
    in_axis = 0
    for i in range(len(begin)):
        if bit(new_axis, i):
            spec.append(None)
            continue
        if in_axis >= in_rank:
            break
        spec.append(int(begin[i]) if bit(shrink, i) else bounds(i))
        in_axis += 1
    while in_axis < in_rank:
        spec.append(slice(None))
        in_axis += 1
    return spec


@register
class StridedSlice(Op):
    type_name = "StridedSlice"

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        begin, end = in_values.get(1), in_values.get(2)
        if begin is None or end is None:
            raise ValueError(f"StridedSlice {node.name}: bounds are not constant")
        spec = _strided_slice_spec(node, len(in_shapes[0]), begin, end, in_values.get(3))
        res = ShapeResult({node.out_port: np.empty(in_shapes[0], np.int8)[tuple(spec)].shape})
        if in_values.get(0) is not None:
            res.values[node.out_port] = in_values[0][tuple(spec)]
        return res

    def ref_compute(self, node, inputs):
        spec = _strided_slice_spec(node, inputs[0].ndim, inputs[1], inputs[2],
                                   inputs.get(3))
        return {node.out_port: inputs[0][tuple(spec)]}

    def emit(self, ctx, node, inputs):
        x = inputs[0].arr
        strides = ctx.static_value(node, 3) if 3 in ctx.model.in_edges[node.id] else None
        spec = _strided_slice_spec(node, x.dim(), ctx.static_value(node, 1),
                                   ctx.static_value(node, 2), strides)
        return {node.out_port: TValue(x[tuple(spec)])}


@register
class ShapeOf(Op):
    type_name = "ShapeOf"

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        shape = np.array(in_shapes[0], dtype=np.int64)
        return ShapeResult({node.out_port: (len(in_shapes[0]),)}, {node.out_port: shape})

    def ref_compute(self, node, inputs):
        dtype = node.outputs[node.out_port].dtype
        return {node.out_port: np.array(inputs[0].shape, dtype=dtype)}

    def emit(self, ctx, node, inputs):
        dtype = np.dtype(node.outputs[node.out_port].dtype)
        shape = np.array(inputs[0].shape, dtype=dtype)
        return {node.out_port: TValue(torch.from_numpy(shape).to(inputs[0].arr.device))}


@register
class Concat(Op):
    """An int8 carry when every input arrives stored at one scale (the
    storage analysis gives a Concat's inputs its output's scale); mixed
    inputs are dequantized first."""

    type_name = "Concat"
    int8_ports = "all"

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        axis = A.get_int(node.attrs, "axis")
        ports = sorted(in_shapes)
        base = list(in_shapes[ports[0]])
        axis = axis % len(base)
        base[axis] = sum(in_shapes[p][axis] for p in ports)
        res = ShapeResult({node.out_port: tuple(base)})
        if all(in_values.get(p) is not None for p in ports):
            res.values[node.out_port] = np.concatenate(
                [in_values[p] for p in ports], axis=axis)
        return res

    def ref_compute(self, node, inputs):
        axis = A.get_int(node.attrs, "axis")
        return {node.out_port: np.concatenate([inputs[p] for p in sorted(inputs)], axis=axis)}

    def emit(self, ctx, node, inputs):
        axis = A.get_int(node.attrs, "axis")
        tvs = [inputs[p] for p in sorted(inputs)]
        scales = {t.act_scale for t in tvs}
        carry = scales.pop() if len(scales) == 1 else None
        if carry is None and scales != {None}:
            tvs = [t.dequant(ctx.compute_dtype) for t in tvs]
        out = torch.cat([t.arr for t in tvs], dim=axis % tvs[0].arr.dim())
        return {node.out_port: TValue(out, act_scale=carry)}
