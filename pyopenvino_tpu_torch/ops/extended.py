"""ReduceMean, ReduceSum, Swish, Gelu, MVN, Tile, ConvolutionBackpropData,
PReLU, Split, VariadicSplit, FakeQuantize, Exp, Maximum and GreaterEqual:
the extension ops that EfficientNet-B0, ``shapes_resnet``, ShuffleNet-v2,
POT-quantized IRs, U-Net, ViT-tiny, MoE-MLP, yolo-tiny and yolo-v2's
on-device decode need; Subtract, Divide, Convert, Gather and Interpolate:
the ops that ``preprocess.py`` (PrePostProcessor) inserts.

The port's own copy of the parts of ``pyopenvino_tpu/ops/extended.py`` it
runs (opset1 ReduceMean and ReduceSum, opset4 Swish, Gelu in its erf and
tanh forms, opset1 MVN, Tile, ConvolutionBackpropData and PReLU, Split,
VariadicSplit, FakeQuantize, Subtract, Divide, Convert, Gather,
Interpolate, Exp, Maximum and GreaterEqual), with the same numpy
``ref_compute``; the rest of that registry
comes with later port slices (ROADMAP.md).  None of these ops takes an
int8-stored activation: under INT8-FULL the compiler dequantizes one
reaching them.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

import torch.nn.functional as F

from pyopenvino_tpu_torch.ir import attrs as A
from pyopenvino_tpu_torch.ir.model import ELEMENT_TYPE_TO_DTYPE
from pyopenvino_tpu_torch.ops.conv import _float32_sum
from pyopenvino_tpu_torch.ops.elementwise import _Binary, _Unary
from pyopenvino_tpu_torch.ops.spec import Op, ShapeResult, TValue, register, torch_dtype


def _norm_axis(value, rank, op):
    """Negative-axis normalization with a range check: ``% rank`` alone
    would wrap an out-of-range positive axis onto the batch dim."""
    axis = int(np.asarray(value).reshape(()))
    if not -rank <= axis < rank:
        raise ValueError(f"{op}: axis {axis} out of range for rank {rank}")
    return axis % rank


class _Reduce(Op):
    """opset1 reductions over constant axes (input 1) with the keep_dims
    attribute, ``np_fn`` on numpy arrays and ``torch_fn`` on tensors (the
    result in the input's dtype)."""

    np_fn = None     # e.g. np.mean
    torch_fn = None  # e.g. torch.mean

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
            res.values[node.out_port] = self.np_fn(in_values[0], axis=axes,
                                                   keepdims=self._keep(node))
        return res

    def ref_compute(self, node, inputs) -> Dict[int, np.ndarray]:
        axes = self._axes(inputs[1], inputs[0].ndim)
        out = self.np_fn(inputs[0], axis=axes, keepdims=self._keep(node))
        return {node.out_port: np.asarray(out, dtype=inputs[0].dtype)}

    def emit(self, ctx, node, inputs) -> Dict[int, TValue]:
        # the axes come from the compile-time value, never from the device
        x = inputs[0].arr
        axes = self._axes(ctx.static_value(node, 1), x.dim())
        return {node.out_port: TValue(self.torch_fn(x, dim=axes, keepdim=self._keep(node)))}


@register
class ReduceMean(_Reduce):
    """Global average pooling is ReduceMean over (2, 3)."""

    type_name = "ReduceMean"
    np_fn = staticmethod(np.mean)
    torch_fn = staticmethod(torch.mean)


@register
class ReduceSum(_Reduce):
    """MoE-MLP's gated combine over the expert axis."""

    type_name = "ReduceSum"
    np_fn = staticmethod(np.sum)
    torch_fn = staticmethod(torch.sum)


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
class Gelu(_Unary):
    """Gelu, ``approximation_mode`` erf (the default) or tanh.  The erf form
    is ``jax.nn.gelu(x, approximate=False)``'s formula, 0.5·x·erfc(−x·√½)
    with √½ in x's dtype, and its numpy twin scipy's erf, as in the JAX
    package; the tanh form is the JAX package's formula on either."""

    type_name = "Gelu"

    @staticmethod
    def _tanh(node):
        return node.attrs.get("approximation_mode", "erf").lower() == "tanh"

    @staticmethod
    def _tanh_formula(x, m):
        c = 0.7978845608028654  # sqrt(2/pi)
        return 0.5 * x * (1.0 + m.tanh(c * (x + 0.044715 * x ** 3)))

    def ref_compute(self, node, inputs):
        x = inputs[0]
        if self._tanh(node):
            out = self._tanh_formula(x, np)
        else:
            from scipy.special import erf

            out = 0.5 * x * (1.0 + erf(x / np.sqrt(2.0)))
        return {node.out_port: out.astype(x.dtype)}

    def emit(self, ctx, node, inputs):
        x = inputs[0].arr
        if self._tanh(node):
            out = self._tanh_formula(x, torch)
        else:
            sqrt_half = torch.tensor(np.sqrt(0.5), dtype=x.dtype, device=x.device)
            out = 0.5 * x * torch.erfc(-x * sqrt_half)
        return {node.out_port: TValue(out.to(x.dtype))}


@register
class MVN(Op):
    """opset1 MVN: per-example mean (and, with ``normalize_variance``,
    variance) normalization over the channel and spatial axes
    (``across_channels``) or the axes after the channel axis; ``eps`` is
    added to the variance.  On a rank-3 (B, N, C) tensor without
    across_channels it is LayerNorm over C (ViT-tiny)."""

    type_name = "MVN"

    @staticmethod
    def _cfg(node):
        across = str(node.attrs.get("across_channels", "0")).lower() in ("1", "true")
        normalize = str(node.attrs.get("normalize_variance", "1")).lower() in ("1", "true")
        return across, normalize, float(node.attrs.get("eps", 1e-9))

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        return ShapeResult({node.out_port: in_shapes[0]})

    def _apply(self, node, x, mean, sqrt):
        across, normalize, eps = self._cfg(node)
        axes = tuple(range(1, x.ndim)) if across else tuple(range(2, x.ndim))
        out = x - mean(x, axes)
        if normalize:
            out = out / sqrt(mean(out * out, axes) + eps)
        return out

    def ref_compute(self, node, inputs) -> Dict[int, np.ndarray]:
        x = inputs[0]
        out = self._apply(node, x, lambda v, a: np.mean(v, axis=a, keepdims=True), np.sqrt)
        return {node.out_port: out.astype(x.dtype)}

    def emit(self, ctx, node, inputs) -> Dict[int, TValue]:
        x = inputs[0].arr
        out = self._apply(node, x, lambda v, a: torch.mean(v, dim=a, keepdim=True), torch.sqrt)
        return {node.out_port: TValue(out.to(x.dtype))}


@register
class Tile(Op):
    """opset1 Tile: ``data`` repeated along each axis by the constant
    ``repeats`` (input 1); the shorter of (rank, len(repeats)) is
    left-padded with 1s, numpy's and OpenVINO's rule."""

    type_name = "Tile"

    @staticmethod
    def _reps(source):
        if source is None:
            raise ValueError("Tile: repeats are not constant")
        reps = tuple(int(r) for r in np.asarray(source).reshape(-1))
        if any(r < 1 for r in reps):
            raise ValueError(f"Tile: repeats must be >= 1, got {reps}")
        return reps

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        reps = self._reps(in_values.get(1))
        shp = tuple(in_shapes[0])
        n = max(len(shp), len(reps))
        shp = (1,) * (n - len(shp)) + shp
        reps = (1,) * (n - len(reps)) + reps
        res = ShapeResult({node.out_port: tuple(d * r for d, r in zip(shp, reps))})
        if in_values.get(0) is not None:
            res.values[node.out_port] = np.tile(in_values[0], reps)
        return res

    def ref_compute(self, node, inputs) -> Dict[int, np.ndarray]:
        return {node.out_port: np.tile(inputs[0], self._reps(inputs[1]))}

    def emit(self, ctx, node, inputs) -> Dict[int, TValue]:
        x = inputs[0].arr
        reps = self._reps(ctx.static_value(node, 1))
        # Tensor.repeat takes at least x's rank of repeats and left-pads x
        return {node.out_port: TValue(x.repeat(*((1,) * (x.dim() - len(reps)) + reps)))}


@register
class ConvolutionBackpropData(Op):
    """opset1 ConvolutionBackpropData, the transposed convolution of U-Net's
    up-convolutions.  Weights come as (Ci, Co, kH, kW), the layout of
    ``F.conv_transpose2d``.  The output covers
    (H−1)·s + d·(k−1) + 1 positions, cropped by ``pads_begin`` and
    ``pads_end`` and extended by ``output_padding`` at the bottom and right
    (which shrinks the end crop: rows still on the canvas are computed
    values, zeros beyond it).  The constant ``output_shape`` (input 2) must
    equal the attribute-derived size (explicit pads only, as in the JAX
    package).

    ``ref_compute`` is the JAX package's numpy scatter formulation.
    ``emit``: ``F.conv_transpose2d`` without padding (it pads only
    symmetrically) on the full canvas, then the crop; no kernel, as the JAX
    package runs ``lax.conv_general_dilated`` here.  An int8 weight is
    dequantized in float32 and cast to x's dtype (the JAX emit's order);
    the sum is float32 (TF32 off under float32; bfloat16 operands widened),
    rounded once to x's dtype.  The result is channels_last."""

    type_name = "ConvolutionBackpropData"

    @staticmethod
    def _cfg(node):
        return (
            A.get_int_tuple(node.attrs, "strides", (1, 1)),
            A.get_int_tuple(node.attrs, "dilations", (1, 1)),
            A.get_int_tuple(node.attrs, "pads_begin", (0, 0)),
            A.get_int_tuple(node.attrs, "pads_end", (0, 0)),
            A.get_int_tuple(node.attrs, "output_padding", (0, 0)),
        )

    def _out_hw(self, node, in_hw, k_hw):
        (sh, sw), (dh, dw), pb, pe, op = self._cfg(node)
        oh = (in_hw[0] - 1) * sh - pb[0] - pe[0] + dh * (k_hw[0] - 1) + 1 + op[0]
        ow = (in_hw[1] - 1) * sw - pb[1] - pe[1] + dw * (k_hw[1] - 1) + 1 + op[1]
        if oh <= 0 or ow <= 0:
            raise ValueError(
                f"ConvolutionBackpropData {node.name}: non-positive output "
                f"{oh}x{ow} (pads exceed the dilated kernel span)")
        return oh, ow

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        n, _, h, w = in_shapes[0]
        ci_w, co, kh, kw = in_shapes[1]
        if ci_w != in_shapes[0][1]:
            raise ValueError(
                f"ConvolutionBackpropData {node.name}: weight Ci {ci_w} != "
                f"input C {in_shapes[0][1]} (weights must be (Ci,Co,kH,kW))")
        oh, ow = self._out_hw(node, (h, w), (kh, kw))
        if 2 in in_shapes:
            tgt = in_values.get(2)
            if tgt is None:
                raise ValueError(
                    f"ConvolutionBackpropData {node.name}: output_shape "
                    "input must be constant")
            tgt = tuple(int(t) for t in np.asarray(tgt).reshape(-1))
            if tgt != (oh, ow):
                raise ValueError(
                    f"ConvolutionBackpropData {node.name}: output_shape "
                    f"{tgt} inconsistent with attrs-derived ({oh}, {ow}); "
                    "auto_pad solving is not supported")
        return ShapeResult({node.out_port: (n, co, oh, ow)})

    def ref_compute(self, node, inputs) -> Dict[int, np.ndarray]:
        x, wgt = inputs[0], inputs[1]
        (sh, sw), (dh, dw), pb, pe, opad = self._cfg(node)
        n, ci, h, w = x.shape
        _, co, kh, kw = wgt.shape
        # the full canvas, one (Ci → Co) contraction per kernel tap added
        # at its dilated offset
        fh = (h - 1) * sh + dh * (kh - 1) + 1
        fw = (w - 1) * sw + dw * (kw - 1) + 1
        buf = np.zeros((n, co, fh + opad[0], fw + opad[1]), np.float32)
        for i in range(kh):
            for j in range(kw):
                tap = np.einsum("nchw,co->nohw", x, wgt[:, :, i, j], optimize=True)
                buf[:, :, i * dh: i * dh + (h - 1) * sh + 1: sh,
                    j * dw: j * dw + (w - 1) * sw + 1: sw] += tap
        out = buf[:, :, pb[0]: fh - pe[0] + opad[0], pb[1]: fw - pe[1] + opad[1]]
        return {node.out_port: out.astype(x.dtype)}

    def emit(self, ctx, node, inputs) -> Dict[int, TValue]:
        x = inputs[0].arr
        (sh, sw), (dh, dw), pb, pe, opad = self._cfg(node)
        tv_w = inputs[1]
        wgt = tv_w.arr
        if tv_w.qscale is not None:
            wgt = wgt.float() * tv_w.qscale
        wgt = wgt.to(x.dtype)
        out = _float32_sum(x, wgt, None, None, lambda x, w, b: F.conv_transpose2d(
            x, w, stride=(sh, sw), dilation=(dh, dw)))
        fh, fw = out.shape[2:]
        # output_padding past the canvas reads zeros
        extra_h, extra_w = max(0, opad[0] - pe[0]), max(0, opad[1] - pe[1])
        if extra_h or extra_w:
            out = F.pad(out, (0, extra_w, 0, extra_h))
        out = out[:, :, pb[0]: fh - pe[0] + opad[0], pb[1]: fw - pe[1] + opad[1]]
        return {node.out_port: TValue(out.contiguous(memory_format=torch.channels_last))}


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
        x = inputs[0].arr
        return {node.out_port: TValue(
            self._apply(node, x, *(inputs[i].arr for i in range(1, 5)), torch).to(x.dtype))}


@register
class Subtract(_Binary):
    type_name = "Subtract"
    fn = staticmethod(lambda a, b: a - b)


@register
class Divide(_Binary):
    type_name = "Divide"
    fn = staticmethod(lambda a, b: a / b)


@register
class Maximum(_Binary):
    """opset1 Maximum, numpy broadcast; mixed integer widths promote as
    both libraries promote them (yolo-v2 clamps NonMaxSuppression's box
    indices, -1 on pad rows, at 0)."""

    type_name = "Maximum"

    @staticmethod
    def fn(a, b):
        if isinstance(a, np.ndarray):
            return np.maximum(a, b)
        return torch.maximum(a, b)


@register
class GreaterEqual(_Binary):
    """opset1 GreaterEqual: a boolean mask, numpy broadcast."""

    type_name = "GreaterEqual"
    fn = staticmethod(lambda a, b: a >= b)


@register
class Exp(_Unary):
    """opset1 Exp, in the input's dtype (yolo-v2's box sizes against the
    anchor priors)."""

    type_name = "Exp"

    def ref_compute(self, node, inputs):
        return {node.out_port: np.exp(inputs[0])}

    def emit(self, ctx, node, inputs):
        return {node.out_port: TValue(torch.exp(inputs[0].arr))}


@register
class PReLU(_Binary):
    """opset1 PReLU: x > 0 → x, else slope·x, the slope (input 1)
    broadcast numpy-style: yolo-tiny's is a rank-0 Const (its XML declares
    shape "1" and a port with no dims), a per-channel one is (C, 1, 1)."""

    type_name = "PReLU"

    @staticmethod
    def fn(x, slope):
        if isinstance(x, np.ndarray):
            return np.where(x > 0, x, slope * x)
        return torch.where(x > 0, x, slope * x)


@register
class Convert(Op):
    """opset1 Convert: element-wise cast to ``destination_type``.  A float
    destination lands on the compute dtype (as in the JAX package: the
    Results cast to their declared dtypes at the end); an integer or bool
    one is exact, float → int rounding toward zero."""

    type_name = "Convert"

    @staticmethod
    def _dest(node):
        name = node.attrs.get("destination_type")
        if name not in ELEMENT_TYPE_TO_DTYPE:
            raise ValueError(
                f"Convert {node.name}: unsupported destination_type "
                f"{name!r} (supported: {sorted(ELEMENT_TYPE_TO_DTYPE)})")
        return np.dtype(ELEMENT_TYPE_TO_DTYPE[name])

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        res = ShapeResult({node.out_port: in_shapes[0]})
        if in_values.get(0) is not None:
            res.values[node.out_port] = np.asarray(in_values[0]).astype(self._dest(node))
        return res

    def ref_compute(self, node, inputs) -> Dict[int, np.ndarray]:
        return {node.out_port: np.asarray(inputs[0]).astype(self._dest(node))}

    def emit(self, ctx, node, inputs) -> Dict[int, TValue]:
        dest = self._dest(node)
        out_dtype = ctx.compute_dtype if np.issubdtype(dest, np.floating) else torch_dtype(dest)
        return {node.out_port: TValue(inputs[0].arr.to(out_dtype))}


def _take(x, idx, axis):
    """``np.take(x, idx, axis)`` on a tensor: numpy's shape, negative
    indices counted from the end."""
    idx = torch.as_tensor(idx, device=x.device).long()
    idx = torch.where(idx < 0, idx + x.shape[axis], idx)
    out = x.index_select(axis, idx.reshape(-1))
    return out.reshape(tuple(x.shape[:axis]) + tuple(idx.shape) + tuple(x.shape[axis + 1:]))


@register
class Gather(Op):
    """opset1 Gather: select indices along a constant axis (input 2)."""

    type_name = "Gather"

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        axis_v = in_values.get(2)
        if axis_v is None:
            raise ValueError(f"Gather {node.name}: axis is not constant")
        data, idx = in_shapes[0], in_shapes[1]
        axis = _norm_axis(axis_v, len(data), "Gather")
        out = tuple(data[:axis]) + tuple(idx) + tuple(data[axis + 1:])
        res = ShapeResult({node.out_port: out})
        if in_values.get(0) is not None and in_values.get(1) is not None:
            res.values[node.out_port] = np.take(
                in_values[0], in_values[1].astype(np.int64), axis=axis)
        return res

    def ref_compute(self, node, inputs) -> Dict[int, np.ndarray]:
        axis = _norm_axis(inputs[2], inputs[0].ndim, "Gather")
        return {node.out_port: np.take(inputs[0], inputs[1].astype(np.int64), axis=axis)}

    def emit(self, ctx, node, inputs) -> Dict[int, TValue]:
        x = inputs[0].arr
        axis = _norm_axis(ctx.static_value(node, 2), x.dim(), "Gather")
        return {node.out_port: TValue(_take(x, inputs[1].arr, axis))}


def _interp_axis_plan(in_len: int, out_len: int, mode: str, align_corners: bool):
    """Static per-axis resample plan, the JAX package's: nearest → (idx,)
    gather indices; linear → (lo, hi, w) with out = (1-w)·x[lo] + w·x[hi].
    The numpy ``ref_compute`` and ``emit`` consume the same arrays."""
    i = np.arange(out_len, dtype=np.float64)
    if align_corners and out_len > 1:
        pos = i * (in_len - 1) / (out_len - 1)
    else:
        pos = (i + 0.5) * (in_len / out_len) - 0.5
    if mode == "nearest":
        idx = np.clip(np.floor(pos + 0.5), 0, in_len - 1).astype(np.int64)
        return (idx,)
    lo = np.clip(np.floor(pos), 0, in_len - 1).astype(np.int64)
    hi = np.minimum(lo + 1, in_len - 1)
    w = np.clip(pos - lo, 0.0, 1.0).astype(np.float32)
    return lo, hi, w


def _pad_tensor(x, pads):
    """Zero padding of a tensor of any rank, ``pads`` numpy's ((b, e), ...)."""
    flat = []
    for b, e in reversed(pads):
        flat += [b, e]
    return F.pad(x, flat)


@register
class Interpolate(Op):
    """opset1 Interpolate, nearest/linear over constant target dims
    (input 1).  attrs: axes, mode, align_corners (default 1: an omitted
    attribute means corner-aligned), pads_begin/pads_end (zeros before
    resampling); antialias raises.  A linear resample of a bfloat16 tensor
    mixes it with float32 weights, in float32, then casts back (JAX's
    promotion and ``astype(x.dtype)``)."""

    type_name = "Interpolate"

    @staticmethod
    def _cfg(node):
        axes = A.get_int_tuple(node.attrs, "axes", (2, 3))
        mode = node.attrs.get("mode", "nearest")
        if mode not in ("nearest", "linear"):
            raise ValueError(f"Interpolate: unsupported mode {mode!r}")
        align = str(node.attrs.get("align_corners", "1")).lower() in ("1", "true")
        if str(node.attrs.get("antialias", "0")).lower() in ("1", "true"):
            raise ValueError("Interpolate: antialias is not supported")
        pads_b = A.get_int_tuple(node.attrs, "pads_begin", (0,))
        pads_e = A.get_int_tuple(node.attrs, "pads_end", (0,))
        return axes, mode, align, pads_b, pads_e

    @staticmethod
    def _axis_pads(pads, rank):
        pads = tuple(int(p) for p in pads)
        if len(pads) == 1:
            pads = pads * rank
        if len(pads) != rank:
            raise ValueError(f"Interpolate: {len(pads)} pad entries for rank {rank}")
        return pads

    def _padded_shape(self, node, in_shape):
        _, _, _, pads_b, pads_e = self._cfg(node)
        b = self._axis_pads(pads_b, len(in_shape))
        e = self._axis_pads(pads_e, len(in_shape))
        return tuple(d + pb + pe for d, pb, pe in zip(in_shape, b, e)), b, e

    def _out_shape(self, node, in_shape, target):
        axes = self._cfg(node)[0]
        if target is None:
            raise ValueError(f"Interpolate {node.name}: target shape is not constant")
        target = [int(t) for t in np.asarray(target).reshape(-1)]
        if len(target) != len(axes):
            raise ValueError(f"Interpolate: {len(axes)} axes but {len(target)} target dims")
        out = list(self._padded_shape(node, in_shape)[0])
        for a, t in zip(axes, target):
            out[_norm_axis(a, len(in_shape), "Interpolate")] = t
        return tuple(out)

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        return ShapeResult({node.out_port: self._out_shape(
            node, in_shapes[0], in_values.get(1))})

    def _resample(self, x, node, target, take, pad, asarray):
        axes, mode, align, _, _ = self._cfg(node)
        rank = x.ndim
        _, b, e = self._padded_shape(node, x.shape)
        if any(b) or any(e):
            x = pad(x, tuple(zip(b, e)))
        target = [int(t) for t in np.asarray(target).reshape(-1)]
        for a, t in zip(axes, target):
            a = _norm_axis(a, rank, "Interpolate")
            plan = _interp_axis_plan(x.shape[a], t, mode, align)
            if mode == "nearest":
                x = take(x, plan[0], a)
            else:
                lo, hi, w = plan
                shape = [1] * rank
                shape[a] = t
                w = asarray(w.reshape(shape))
                x = take(x, lo, a) * (1 - w) + take(x, hi, a) * w
        return x

    def ref_compute(self, node, inputs) -> Dict[int, np.ndarray]:
        out = self._resample(inputs[0], node, inputs[1],
                             take=lambda x, i, a: np.take(x, i, axis=a),
                             pad=np.pad, asarray=np.asarray)
        return {node.out_port: out.astype(inputs[0].dtype)}

    def emit(self, ctx, node, inputs) -> Dict[int, TValue]:
        x = inputs[0].arr
        out = self._resample(x, node, ctx.static_value(node, 1), take=_take, pad=_pad_tensor,
                             asarray=lambda w: torch.from_numpy(w).to(x.device))
        return {node.out_port: TValue(out.to(x.dtype))}
