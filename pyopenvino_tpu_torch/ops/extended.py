"""ReduceMean, Swish, Split, VariadicSplit and FakeQuantize: the
extension ops that EfficientNet-B0, ``shapes_resnet``, ShuffleNet-v2 and
POT-quantized IRs need.

The port's own copy of the parts of ``pyopenvino_tpu/ops/extended.py`` it
runs (opset1 ReduceMean, opset4 Swish, opset1 Split, VariadicSplit and
FakeQuantize), with the same numpy ``ref_compute``; the rest of that
registry comes with later port slices (ROADMAP.md).  None of these ops
takes an int8-stored activation: under INT8-FULL the compiler dequantizes
one reaching them.
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


@register
class Split(Op):
    """opset1 Split: ``num_splits`` equal parts along a constant axis
    (input 1), one output port per part.  The parts are views of the input:
    a channel half of a channels_last activation steps the full channel
    count between pixels, which the GEMM kernels take as a row stride."""

    type_name = "Split"

    @staticmethod
    def _num(node) -> int:
        return int(node.attrs["num_splits"])

    @staticmethod
    def _ports(node, n):
        """Output port ids: the declared ones when the node carries all n
        (a parsed IR: Split's parts follow its two inputs, ports 2 and 3),
        else consecutive from the first output port."""
        ports = sorted(node.outputs)
        if len(ports) == n:
            return ports
        return [node.out_port + i for i in range(n)]

    @staticmethod
    def _axis(source, rank):
        if source is None:
            raise ValueError("Split: axis is not constant")
        return _norm_axis(source, rank, "Split")

    def _lengths_for(self, node, source, extent):
        n = self._num(node)
        if extent % n:
            raise ValueError(
                f"Split: axis extent {extent} not divisible by num_splits {n}")
        return [extent // n] * n

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        axis = self._axis(in_values.get(1), len(in_shapes[0]))
        lengths = self._lengths_for(node, in_values.get(2), in_shapes[0][axis])
        ports = self._ports(node, len(lengths))
        res = ShapeResult({})
        for p, ln in zip(ports, lengths):
            piece = list(in_shapes[0])
            piece[axis] = ln
            res.shapes[p] = tuple(piece)
        if in_values.get(0) is not None:
            cuts = np.cumsum(lengths)[:-1]
            for p, part in zip(ports, np.split(in_values[0], cuts, axis=axis)):
                res.values[p] = part
        return res

    def ref_compute(self, node, inputs) -> Dict[int, np.ndarray]:
        axis = self._axis(inputs.get(1), inputs[0].ndim)
        lengths = self._lengths_for(node, inputs.get(2), inputs[0].shape[axis])
        cuts = np.cumsum(lengths)[:-1]
        return dict(zip(self._ports(node, len(lengths)),
                        np.split(inputs[0], cuts, axis=axis)))

    def emit(self, ctx, node, inputs) -> Dict[int, TValue]:
        x = inputs[0].arr
        axis = self._axis(ctx.static_value(node, 1), x.dim())
        source = ctx.static_value(node, 2) if 2 in ctx.model.in_edges[node.id] else None
        lengths = self._lengths_for(node, source, x.shape[axis])
        return {p: TValue(part) for p, part in zip(
            self._ports(node, len(lengths)), torch.split(x, lengths, dim=axis))}


@register
class VariadicSplit(Split):
    """opset1 VariadicSplit: parts of the constant lengths of input 2 along
    a constant axis (input 1); one length may be -1 and takes the rest."""

    type_name = "VariadicSplit"

    def _lengths_for(self, node, source, extent):
        if source is None:
            raise ValueError("VariadicSplit: split_lengths is not constant")
        lengths = [int(v) for v in np.asarray(source).reshape(-1)]
        wild = [i for i, v in enumerate(lengths) if v == -1]
        if len(wild) > 1:
            raise ValueError("VariadicSplit: at most one split length may be -1")
        fixed = sum(v for v in lengths if v != -1)
        if wild:
            if fixed > extent:
                raise ValueError(
                    f"VariadicSplit: lengths {lengths} exceed axis extent {extent}")
            lengths[wild[0]] = extent - fixed
        elif fixed != extent:
            raise ValueError(
                f"VariadicSplit: lengths {lengths} sum to {fixed}, axis extent "
                f"is {extent}")
        return lengths


@register
class FakeQuantize(Op):
    """opset1 FakeQuantize, the op POT/NNCF-quantized IRs are built from.
    Inputs: x, input_low, input_high, output_low, output_high (1-4
    broadcastable to x); attribute ``levels``.  In the JAX package's order
    of operations, on numpy arrays and tensors alike:

        q = round(clip(x, il, ih)·(steps/(ih−il)) − il·(steps/(ih−il)))
        y = q·((oh−ol)/steps) + ol,        steps = levels − 1

    with round half to even (``np.round``, ``torch.round``).  No kernel: a
    plain elementwise pass.  Weight FakeQuantizes fold at compile time
    (passes/fold_fq.py); under INT8-FULL the symmetric activation ones
    become activation scales."""

    type_name = "FakeQuantize"

    @staticmethod
    def _levels(node) -> int:
        levels = int(node.attrs.get("levels", 256))
        if levels < 2:
            raise ValueError(f"FakeQuantize: levels must be >= 2, got {levels}")
        return levels

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        self._levels(node)
        out = tuple(np.broadcast_shapes(*in_shapes.values()))
        if out != tuple(in_shapes[0]):
            raise ValueError(
                f"FakeQuantize: ranges broadcast the data from "
                f"{tuple(in_shapes[0])} to {out}")
        return ShapeResult({node.out_port: out})

    def _apply(self, node, x, il, ih, ol, oh, m):
        steps = self._levels(node) - 1
        q = m.round(m.clip(x, il, ih) * (steps / (ih - il))
                    - il * (steps / (ih - il)))
        return q * ((oh - ol) / steps) + ol

    def ref_compute(self, node, inputs) -> Dict[int, np.ndarray]:
        out = self._apply(node, *(inputs[i] for i in range(5)), np)
        return {node.out_port: out.astype(inputs[0].dtype)}

    def emit(self, ctx, node, inputs) -> Dict[int, TValue]:
        return {node.out_port: TValue(
            self._apply(node, *(inputs[i].arr for i in range(5)), torch))}
