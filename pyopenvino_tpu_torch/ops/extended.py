"""The port's own copy of ``pyopenvino_tpu/ops/extended.py``, every one of
its op types: for each, the JAX op's numpy ``ref_compute`` (the
interpreter's and calibration's), its shape inference and value
propagation (constant folding where the JAX op folds), and an ``emit`` on
tensors.

The ops the families need (ReduceMean, ReduceSum, Swish, Gelu, MVN, Tile,
ConvolutionBackpropData, PReLU, Split, VariadicSplit, FakeQuantize, Exp,
Maximum, GreaterEqual; Subtract, Divide, Convert, Gather and Interpolate,
which ``preprocess.py`` inserts), and the types no in-repo family uses
(Model-Optimizer IRs carry them, ``tools/torch_convert.py`` emits HSwish
and Elu):

  * unary math: Sqrt, Tanh, Erf, Log, Abs, Negative, Floor, Ceiling, Sin,
    Cos, Tan, Asin, Acos, Atan, Sinh, Cosh, Asinh, Acosh, Atanh, Sign and
    Round (both modes);
  * activations: Elu, SoftPlus, HSwish, HSigmoid, Mish, HardSigmoid,
    LogSoftmax, Selu and SoftSign;
  * binary: Minimum, Power, FloorMod, Mod and SquaredDifference;
  * comparison and logic (bool outputs): Equal, NotEqual, Greater, Less,
    LessEqual, LogicalAnd, LogicalOr, LogicalXor, LogicalNot, and Select;
  * reductions: ReduceMax, ReduceMin, ReduceProd, ReduceL1, ReduceL2,
    ReduceLogicalAnd and ReduceLogicalOr;
  * normalization: NormalizeL2, BatchNormInference, GroupNormalization;
  * layout and data: Squeeze, Pad (constant, edge, reflect, symmetric),
    DepthToSpace, SpaceToDepth, SpaceToBatch, BatchToSpace,
    ShuffleChannels, Broadcast (numpy, bidirectional, explicit), Range
    (always folded), ReverseSequence, CumSum and OneHot;
  * gather and scatter: GatherND, GatherElements, ScatterNDUpdate,
    ScatterElementsUpdate and EmbeddingBagOffsetsSum;
  * selection and decoding: TopK, Einsum and CTCGreedyDecoder.

The formulas of the JAX package's ``_UnaryAttr`` ops (and Selu's,
HardSigmoid's) run step by step in the input's dtype on either side, so a
bfloat16 input rounds after every step, as XLA's steps do; a fused torch
call (``F.hardswish``, ``F.mish``, ...) would round once.  Where the JAX op
orders ties (TopK: the lower index first; CTCGreedyDecoder's argmax: the
first maximum) the port uses a stable sort or torch's first-maximum argmax,
on the card too.  None of these ops takes an int8-stored activation: under
INT8-FULL the compiler dequantizes one reaching them.
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
    torch_fn = None  # e.g. torch.mean, called as fn(x, dim=axes, keepdim=keep)

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
        if not axes:  # numpy reduces over no axis; torch's dim=() means every axis
            return {node.out_port: TValue(self.torch_fn(x[None], dim=(0,), keepdim=False))}
        return {node.out_port: TValue(self.torch_fn(x, dim=axes, keepdim=self._keep(node)))}


# -- shared forms: a formula on numpy arrays and tensors, a binary fn ------------

class _TorchMath:
    """numpy's names for the ufuncs the shared formulas call, on tensors: a
    formula written once runs on numpy arrays (``m`` = np) and on tensors
    (``m`` = _TM), one elementwise step per call, each in the tensor's
    dtype.  ``minimum``/``maximum``/``clip`` take Python bounds."""

    where = staticmethod(torch.where)
    log1p = staticmethod(torch.log1p)
    abs = staticmethod(torch.abs)
    tanh = staticmethod(torch.tanh)
    sin = staticmethod(torch.sin)
    cos = staticmethod(torch.cos)
    tan = staticmethod(torch.tan)
    arcsin = staticmethod(torch.asin)
    arccos = staticmethod(torch.acos)
    arctan = staticmethod(torch.atan)
    sinh = staticmethod(torch.sinh)
    cosh = staticmethod(torch.cosh)
    arcsinh = staticmethod(torch.asinh)
    arccosh = staticmethod(torch.acosh)
    arctanh = staticmethod(torch.atanh)
    sign = staticmethod(torch.sign)
    floor = staticmethod(torch.floor)
    rint = staticmethod(torch.round)  # half to even, as np.rint

    @staticmethod
    def exp(x):
        # the module's torch, read at the call: Swish's exp follows it
        # (tests/test_torch_port_efficientnet_int8full.py swaps in XLA's)
        return torch.exp(x)

    @staticmethod
    def minimum(x, bound):
        return torch.clamp(x, max=bound)

    @staticmethod
    def maximum(x, bound):
        return torch.clamp(x, min=bound)

    @staticmethod
    def clip(x, lo, hi):
        return torch.clamp(x, lo, hi)


_TM = _TorchMath


def _typed(value, x):
    """A Python constant of a formula as JAX's weak typing applies it to x:
    in x's dtype.  A bfloat16 x multiplies by the constant rounded to
    bfloat16, where torch would take the float32 value."""
    if isinstance(x, torch.Tensor) and x.dtype != torch.float32:
        return torch.tensor(value, dtype=x.dtype, device=x.device)
    return value


class _UnaryAttr(_Unary):
    """A unary op defined once as ``_formula(node, x, m)`` on numpy arrays
    and tensors, the result cast back to x's dtype (the JAX package's
    ``_UnaryAttr``)."""

    def _formula(self, node, x, m):
        raise NotImplementedError

    def ref_compute(self, node, inputs):
        x = inputs[0]
        return {node.out_port: self._formula(node, x, np).astype(x.dtype)}

    def emit(self, ctx, node, inputs):
        x = inputs[0].arr
        return {node.out_port: TValue(self._formula(node, x, _TM).to(x.dtype))}


class _Elementwise(_Unary):
    """A unary op that is one numpy function (``np_fn``) and one torch
    function (``torch_fn``); an integer tensor passes Floor and Ceiling
    unchanged, as ``jnp.floor`` returns it."""

    np_fn = None
    torch_fn = None
    keeps_integers = False

    def ref_compute(self, node, inputs):
        return {node.out_port: self.np_fn(inputs[0])}

    def emit(self, ctx, node, inputs):
        x = inputs[0].arr
        if self.keeps_integers and not x.is_floating_point():
            return {node.out_port: TValue(x)}
        return {node.out_port: TValue(self.torch_fn(x))}


def _elementwise(name, np_fn, torch_fn, keeps_integers=False, doc=None):
    return register(type(name, (_Elementwise,), {
        "type_name": name, "__doc__": doc, "np_fn": staticmethod(np_fn),
        "torch_fn": staticmethod(torch_fn), "keeps_integers": keeps_integers}))


def _formula_op(name, formula, doc=None):
    """Register a ``_UnaryAttr`` op whose formula takes (x, m) alone."""
    return register(type(name, (_UnaryAttr,), {
        "type_name": name, "__doc__": doc,
        "_formula": lambda self, node, x, m: formula(x, m)}))


def _dual(np_fn, torch_fn):
    """A binary fn for numpy arrays (``ref_compute``, folding) and tensors."""

    def fn(a, b):
        if isinstance(a, np.ndarray) and isinstance(b, np.ndarray):
            return np_fn(a, b)
        return torch_fn(a, b)
    return staticmethod(fn)


def _floor_mod(a, b):
    """Python's %, the remainder with the divisor's sign, as ``jnp.mod``
    forms it: C's truncated remainder, plus the divisor where the two signs
    differ."""
    r = torch.fmod(a, b)
    return torch.where((r != 0) & ((r < 0) != (b < 0)), r + b, r)


def _binary(name, np_fn, torch_fn, doc=None):
    return register(type(name, (_Binary,), {
        "type_name": name, "__doc__": doc, "fn": _dual(np_fn, torch_fn)}))


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
class Swish(_UnaryAttr):
    """opset4 Swish: x·sigmoid(beta·x), beta from the attribute (default 1),
    in the JAX package's formula on numpy arrays and tensors alike."""

    type_name = "Swish"

    def _formula(self, node, x, m):
        beta = float(node.attrs.get("beta", 1.0))
        return x * _sigmoid(beta * x, m)


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


_binary("Maximum", np.maximum, torch.maximum,
        "opset1 Maximum, numpy broadcast; mixed integer widths promote as both "
        "libraries promote them (yolo-v2 clamps NonMaxSuppression's box indices, -1 "
        "on pad rows, at 0).")


@register
class GreaterEqual(_Binary):
    """opset1 GreaterEqual: a boolean mask, numpy broadcast."""

    type_name = "GreaterEqual"
    fn = staticmethod(lambda a, b: a >= b)


_elementwise("Exp", np.exp, torch.exp,
             doc="opset1 Exp, in the input's dtype (yolo-v2's box sizes against the "
                 "anchor priors).")


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


# -- unary math and activations ----------------------------------------------

_elementwise("Sqrt", np.sqrt, torch.sqrt)
_elementwise("Tanh", np.tanh, torch.tanh)
_elementwise("Log", np.log, torch.log)
_elementwise("Abs", np.abs, torch.abs)
_elementwise("Negative", lambda x: -x, lambda x: -x)
_elementwise("Floor", np.floor, torch.floor, keeps_integers=True)
_elementwise("Ceiling", np.ceil, torch.ceil, keeps_integers=True)


@register
class Erf(_Unary):
    """scipy's erf in ``ref_compute``, as the JAX package's (whose emit is
    ``jax.scipy.special.erf``)."""

    type_name = "Erf"

    def ref_compute(self, node, inputs):
        from scipy.special import erf

        x = inputs[0]
        return {node.out_port: erf(x).astype(x.dtype)}

    def emit(self, ctx, node, inputs):
        return {node.out_port: TValue(torch.erf(inputs[0].arr))}


for _name, _fn in (("Sin", "sin"), ("Cos", "cos"), ("Tan", "tan"), ("Asin", "arcsin"),
                   ("Acos", "arccos"), ("Atan", "arctan"), ("Sinh", "sinh"),
                   ("Cosh", "cosh"), ("Asinh", "arcsinh"), ("Acosh", "arccosh"),
                   ("Atanh", "arctanh"), ("Sign", "sign")):
    _formula_op(_name, lambda x, m, fn=_fn: getattr(m, fn)(x))
del _name, _fn


def _softplus(x, m):
    """ln(1 + e^x), computed stably."""
    return m.maximum(x, 0.0) + m.log1p(m.exp(-m.abs(x)))


_formula_op("SoftPlus", _softplus, "opset4 SoftPlus: ln(1 + e^x), computed stably.")
_formula_op("HSwish", lambda x, m: x * m.clip(x + 3.0, 0.0, 6.0) / 6.0,
            "opset4 HSwish: x·min(max(x + 3, 0), 6)/6.")
_formula_op("HSigmoid", lambda x, m: m.clip(x + 3.0, 0.0, 6.0) / 6.0,
            "opset5 HSigmoid: min(max(x + 3, 0), 6)/6.")
_formula_op("Mish", lambda x, m: x * m.tanh(_softplus(x, m)), "opset4 Mish: x·tanh(softplus(x)).")
_formula_op("SoftSign", lambda x, m: x / (1.0 + m.abs(x)), "opset9 SoftSign: x / (1 + |x|).")


@register
class Elu(_UnaryAttr):
    """opset1 Elu: x > 0 → x, else alpha·(e^x − 1)."""

    type_name = "Elu"

    def _formula(self, node, x, m):
        alpha = _typed(float(node.attrs.get("alpha", 1.0)), x)
        return m.where(x > 0, x, alpha * (m.exp(m.minimum(x, 0.0)) - 1.0))


@register
class Round(_UnaryAttr):
    """opset5 Round: half_to_even (the default, ``np.rint``, ``torch.round``)
    or half_away_from_zero, sign(x)·floor(|x| + 0.5)."""

    type_name = "Round"

    @staticmethod
    def _mode(node):
        mode = A.get_str(node.attrs, "mode", "half_to_even")
        if mode not in ("half_to_even", "half_away_from_zero"):
            raise ValueError(f"Round: unknown mode {mode!r}")
        return mode

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        self._mode(node)
        return super().infer_shapes(node, in_shapes, in_values)

    def _formula(self, node, x, m):
        if self._mode(node) == "half_to_even":
            return m.rint(x)
        return m.sign(x) * m.floor(m.abs(x) + 0.5)


class _ConstArgs(Op):
    """An activation with two scalar constant inputs (ports 1 and 2)."""

    what = ""

    def _args(self, vals, node):
        a, b = vals.get(1), vals.get(2)
        if a is None or b is None:
            raise ValueError(f"{self.type_name} {node.name}: {self.what} must be constant")
        return float(np.asarray(a).reshape(())), float(np.asarray(b).reshape(()))

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        return ShapeResult({node.out_port: in_shapes[0]})


@register
class HardSigmoid(_ConstArgs):
    """opset1 HardSigmoid: clamp(alpha·x + beta, 0, 1), alpha and beta the
    constant inputs 1 and 2."""

    type_name = "HardSigmoid"
    what = "alpha/beta"

    def ref_compute(self, node, inputs):
        a, b = self._args(inputs, node)
        return {node.out_port: np.clip(a * inputs[0] + b, 0.0, 1.0).astype(inputs[0].dtype)}

    def emit(self, ctx, node, inputs):
        x = inputs[0].arr
        a, b = (_typed(v, x) for v in self._args({i: ctx.static_value(node, i)
                                                   for i in (1, 2)}, node))
        return {node.out_port: TValue(torch.clamp(a * x + b, 0.0, 1.0))}


@register
class Selu(_ConstArgs):
    """opset1 Selu: lambda·(x > 0 ? x : alpha·(e^x − 1)), alpha and lambda
    the constant inputs 1 and 2."""

    type_name = "Selu"
    what = "alpha/lambda"

    @staticmethod
    def _apply(x, a, lam, where, exp, min0):
        return lam * where(x > 0, x, a * (exp(min0(x)) - 1))

    def ref_compute(self, node, inputs):
        a, lam = self._args(inputs, node)
        x = inputs[0]
        out = self._apply(x, a, lam, np.where, np.exp, lambda v: np.minimum(v, 0))
        return {node.out_port: out.astype(x.dtype)}

    def emit(self, ctx, node, inputs):
        x = inputs[0].arr
        a, lam = (_typed(v, x) for v in self._args({i: ctx.static_value(node, i)
                                                     for i in (1, 2)}, node))
        return {node.out_port: TValue(self._apply(x, a, lam, torch.where, torch.exp,
                                                  lambda v: torch.clamp(v, max=0)))}


@register
class LogSoftmax(Op):
    """opset5 LogSoftmax along the ``axis`` attribute (default 1), max
    subtracted: ``ref_compute`` in float64 as the JAX package's;
    ``emit`` ``torch.log_softmax`` in float32 and, in a narrower dtype,
    ``jax.nn.log_softmax``'s steps in that dtype, each rounded there."""

    type_name = "LogSoftmax"

    @staticmethod
    def _axis(node, rank):
        return _norm_axis(A.get_int(node.attrs, "axis", 1), rank, "LogSoftmax")

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        self._axis(node, len(in_shapes[0]))
        return ShapeResult({node.out_port: in_shapes[0]})

    def ref_compute(self, node, inputs):
        ax = self._axis(node, inputs[0].ndim)
        x = inputs[0].astype(np.float64)
        z = x - x.max(axis=ax, keepdims=True)
        out = z - np.log(np.exp(z).sum(axis=ax, keepdims=True))
        return {node.out_port: out.astype(inputs[0].dtype)}

    def emit(self, ctx, node, inputs):
        x = inputs[0].arr
        ax = self._axis(node, x.dim())
        if x.dtype == torch.float32:
            return {node.out_port: TValue(torch.log_softmax(x, dim=ax))}
        z = x - x.amax(dim=ax, keepdim=True)
        return {node.out_port: TValue(z - torch.log(torch.exp(z).sum(dim=ax, keepdim=True)))}


# -- binary, comparison and logic ----------------------------------------------

_binary("Minimum", np.minimum, torch.minimum)
_binary("Power", lambda a, b: a ** b, lambda a, b: a ** b,
        "opset1 Power: element-wise x ** exponent.")
_binary("FloorMod", np.mod, _floor_mod,
        "opset1 FloorMod: the remainder with the divisor's sign (Python's %).")
_binary("Mod", np.fmod, torch.fmod,
        "opset1 Mod: C's truncated remainder, with the dividend's sign.")
_binary("SquaredDifference", lambda a, b: (a - b) * (a - b), lambda a, b: (a - b) * (a - b))
for _name, _np, _t in (("Equal", np.equal, torch.eq), ("NotEqual", np.not_equal, torch.ne),
                       ("Greater", np.greater, torch.gt), ("Less", np.less, torch.lt),
                       ("LessEqual", np.less_equal, torch.le),
                       ("LogicalAnd", np.logical_and, torch.logical_and),
                       ("LogicalOr", np.logical_or, torch.logical_or),
                       ("LogicalXor", np.logical_xor, torch.logical_xor)):
    _binary(_name, _np, _t, f"opset1 {_name}: a boolean result, numpy broadcast.")
del _name, _np, _t
_elementwise("LogicalNot", np.logical_not, torch.logical_not)


@register
class Select(Op):
    """opset1 Select: cond ? then : else, numpy broadcast over the three."""

    type_name = "Select"

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        shape = tuple(int(d) for d in np.broadcast_shapes(*in_shapes.values()))
        res = ShapeResult({node.out_port: shape})
        if all(in_values.get(i) is not None for i in range(3)):
            res.values[node.out_port] = np.where(
                np.asarray(in_values[0], bool), in_values[1], in_values[2])
        return res

    def ref_compute(self, node, inputs):
        return {node.out_port: np.where(np.asarray(inputs[0], bool), inputs[1], inputs[2])}

    def emit(self, ctx, node, inputs):
        cond, a, b = (inputs[i].arr for i in range(3))
        return {node.out_port: TValue(torch.where(cond.bool(), a, b))}


# -- reductions ------------------------------------------------------------------

def _each_dim(fn):
    """A reduction over several dims from ``fn(x, dim, keepdim)`` that takes
    one: the dims one at a time, the highest first."""

    def reduce(x, dim, keepdim):
        for d in sorted(dim, reverse=True):
            x = fn(x, d, True)
        return x if keepdim else x.squeeze(dim)
    return staticmethod(reduce)


def _reduce(name, np_fn, torch_fn):
    return register(type(name, (_Reduce,), {
        "type_name": name, "np_fn": staticmethod(np_fn), "torch_fn": torch_fn}))


_reduce("ReduceMax", np.max, staticmethod(torch.amax))
_reduce("ReduceMin", np.min, staticmethod(torch.amin))
_reduce("ReduceProd", np.prod, _each_dim(lambda x, d, k: torch.prod(x, dim=d, keepdim=k)))
_reduce("ReduceL1", lambda x, axis, keepdims: np.sum(np.abs(x), axis=axis, keepdims=keepdims),
        staticmethod(lambda x, dim, keepdim: torch.sum(torch.abs(x), dim=dim, keepdim=keepdim)))
_reduce("ReduceL2",
        lambda x, axis, keepdims: np.sqrt(np.sum(np.square(x), axis=axis, keepdims=keepdims)),
        staticmethod(lambda x, dim, keepdim: torch.sqrt(torch.sum(x * x, dim=dim,
                                                                  keepdim=keepdim))))
_reduce("ReduceLogicalAnd", np.all, _each_dim(lambda x, d, k: torch.all(x, dim=d, keepdim=k)))
_reduce("ReduceLogicalOr", np.any, _each_dim(lambda x, d, k: torch.any(x, dim=d, keepdim=k)))


# -- normalization ---------------------------------------------------------------

@register
class NormalizeL2(Op):
    """opset1 NormalizeL2: x / sqrt(Σ x² over the constant axes (input 1),
    combined with ``eps`` by ``eps_mode``: add → Σ + eps, max →
    max(Σ, eps)).  SSD-VGG normalizes conv4_3 across channels."""

    type_name = "NormalizeL2"

    @staticmethod
    def _cfg(node):
        eps = float(node.attrs.get("eps", 1e-10))
        mode = str(node.attrs.get("eps_mode", "add")).lower()
        if mode not in ("add", "max"):
            raise ValueError(f"NormalizeL2: unsupported eps_mode {mode!r}")
        return eps, mode

    @staticmethod
    def _axes(source, rank):
        if source is None:
            raise ValueError("NormalizeL2: axes are not constant")
        return tuple(sorted(_norm_axis(a, rank, "NormalizeL2")
                            for a in np.asarray(source).reshape(-1)))

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        self._cfg(node)
        self._axes(in_values.get(1), len(in_shapes[0]))
        return ShapeResult({node.out_port: in_shapes[0]})

    def ref_compute(self, node, inputs):
        eps, mode = self._cfg(node)
        x = inputs[0]
        ss = np.sum(x * x, axis=self._axes(inputs[1], x.ndim), keepdims=True)
        denom = np.sqrt(ss + eps) if mode == "add" else np.sqrt(np.maximum(ss, eps))
        return {node.out_port: (x / denom).astype(x.dtype)}

    def emit(self, ctx, node, inputs):
        eps, mode = self._cfg(node)
        x = inputs[0].arr
        ss = torch.sum(x * x, dim=self._axes(ctx.static_value(node, 1), x.dim()), keepdim=True)
        denom = torch.sqrt(ss + eps) if mode == "add" else torch.sqrt(torch.clamp(ss, min=eps))
        return {node.out_port: TValue((x / denom).to(x.dtype))}


@register
class BatchNormInference(Op):
    """opset5 BatchNormInference: x·s + (beta − mean·s) per channel (axis 1),
    s = gamma / sqrt(var + epsilon); inputs x, gamma, beta, mean, var.
    ``ref_compute`` in float64, ``emit`` in float32, both cast back to x's
    dtype, as in the JAX package."""

    type_name = "BatchNormInference"

    @staticmethod
    def _eps(node) -> float:
        return A.get_float(node.attrs, "epsilon", 1e-5)

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        c = in_shapes[0][1]
        for i in range(1, 5):
            if int(np.prod(in_shapes[i])) != c:
                raise ValueError(f"BatchNormInference {node.name}: input {i} has "
                                 f"{in_shapes[i]} elements for C={c}")
        return ShapeResult({node.out_port: in_shapes[0]})

    @staticmethod
    def _bn(sqrt, x, g, b, mean, var, eps):
        view = (1, -1) + (1,) * (x.ndim - 2)
        s = (g / sqrt(var + eps)).reshape(view)
        sh = (b - mean * (g / sqrt(var + eps))).reshape(view)
        return x * s + sh

    def ref_compute(self, node, inputs):
        x = inputs[0]
        args = [np.asarray(inputs[i], np.float64).reshape(-1) for i in range(1, 5)]
        out = self._bn(np.sqrt, x.astype(np.float64), *args, self._eps(node))
        return {node.out_port: out.astype(x.dtype)}

    def emit(self, ctx, node, inputs):
        x = inputs[0].arr
        args = [inputs[i].arr.float().reshape(-1) for i in range(1, 5)]
        out = self._bn(torch.sqrt, x.float(), *args, self._eps(node))
        return {node.out_port: TValue(out.to(x.dtype))}


@register
class GroupNormalization(Op):
    """opset12 GroupNormalization: mean and variance per (sample, group of
    C/num_groups channels), then a per-channel scale and bias (inputs 1 and
    2); float64 in ``ref_compute``, float32 in ``emit``."""

    type_name = "GroupNormalization"

    @staticmethod
    def _p(node):
        return A.get_int(node.attrs, "num_groups"), A.get_float(node.attrs, "epsilon", 1e-5)

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        g, _ = self._p(node)
        if in_shapes[0][1] % g:
            raise ValueError(f"GroupNormalization {node.name}: C={in_shapes[0][1]} "
                             f"not divisible by num_groups {g}")
        return ShapeResult({node.out_port: in_shapes[0]})

    @staticmethod
    def _gn(sqrt, mean, x, scale, bias, g, eps):
        n, c = x.shape[:2]
        rest = tuple(x.shape[2:])
        xg = x.reshape((n, g, c // g) + rest)
        axes = tuple(range(2, xg.ndim))
        mu = mean(xg, axes)
        var = mean((xg - mu) ** 2, axes)
        y = ((xg - mu) / sqrt(var + eps)).reshape(tuple(x.shape))
        view = (1, c) + (1,) * len(rest)
        return y * scale.reshape(view) + bias.reshape(view)

    def ref_compute(self, node, inputs):
        g, eps = self._p(node)
        out = self._gn(np.sqrt, lambda v, a: v.mean(axis=a, keepdims=True),
                       inputs[0].astype(np.float64),
                       np.asarray(inputs[1], np.float64).reshape(-1),
                       np.asarray(inputs[2], np.float64).reshape(-1), g, eps)
        return {node.out_port: out.astype(inputs[0].dtype)}

    def emit(self, ctx, node, inputs):
        g, eps = self._p(node)
        x = inputs[0].arr
        out = self._gn(torch.sqrt, lambda v, a: v.mean(dim=a, keepdim=True), x.float(),
                       inputs[1].arr.float().reshape(-1), inputs[2].arr.float().reshape(-1),
                       g, eps)
        return {node.out_port: TValue(_cl(out.to(x.dtype)))}


# -- layout and data ---------------------------------------------------------------

def _cl(x):
    """A 4-D result in channels_last memory, the port's layout of 4-D
    activations; any other rank as it is."""
    return x.contiguous(memory_format=torch.channels_last) if x.dim() == 4 else x


@register
class Squeeze(Op):
    """opset1 Squeeze: drop the unit dims at the constant axes (input 1), or
    every unit dim without that input."""

    type_name = "Squeeze"

    @staticmethod
    def _out_shape(in_shape, axes):
        if axes is None:
            return tuple(d for d in in_shape if d != 1)
        rank = len(in_shape)
        axes = {a % rank for a in axes}
        for a in axes:
            if in_shape[a] != 1:
                raise ValueError(f"Squeeze: axis {a} has extent {in_shape[a]} != 1")
        return tuple(d for i, d in enumerate(in_shape) if i not in axes)

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        axes = in_values.get(1)
        if 1 in in_shapes and axes is None:
            raise ValueError(f"Squeeze {node.name}: axes are not constant")
        out = self._out_shape(in_shapes[0], None if axes is None else
                              tuple(int(a) for a in axes))
        res = ShapeResult({node.out_port: out})
        if in_values.get(0) is not None:
            res.values[node.out_port] = in_values[0].reshape(out)
        return res

    def ref_compute(self, node, inputs):
        axes = tuple(int(a) for a in inputs[1]) if 1 in inputs else None
        return {node.out_port: inputs[0].reshape(self._out_shape(inputs[0].shape, axes))}

    def emit(self, ctx, node, inputs):
        from pyopenvino_tpu_torch.ops.shape_ops import reshaped

        axes = (tuple(int(a) for a in ctx.static_value(node, 1)) if 1 in inputs else None)
        x = inputs[0].arr
        return {node.out_port: TValue(reshaped(x, self._out_shape(tuple(x.shape), axes)))}


@register
class Pad(Op):
    """opset1 Pad: constant (fill value input 3, default 0), edge, reflect
    or symmetric padding by the constant pads_begin and pads_end (inputs 1
    and 2).  ``emit`` pads with a constant through ``F.pad`` and gathers the
    other modes: each padded axis reads the indices ``np.pad`` gives
    ``arange(n)`` in that mode, so every mode equals numpy's on any axis and
    memory format (``F.pad`` has no symmetric mode and reflects only the
    last dims)."""

    type_name = "Pad"

    @staticmethod
    def _mode(node) -> str:
        mode = node.attrs.get("pad_mode", "constant")
        if mode not in ("constant", "edge", "reflect", "symmetric"):
            raise ValueError(f"Pad: unsupported pad_mode {mode!r}")
        return mode

    @staticmethod
    def _pads(source, what):
        if source is None:
            raise ValueError(f"Pad: {what} is not constant")
        return tuple(int(v) for v in np.asarray(source).reshape(-1))

    @staticmethod
    def _check_rank(b, e, rank):
        if len(b) != rank or len(e) != rank:
            raise ValueError(f"Pad: pads_begin/pads_end have {len(b)}/{len(e)} entries "
                             f"for a rank-{rank} input")

    def _cfg(self, node, get, rank):
        b = self._pads(get(1), "pads_begin")
        e = self._pads(get(2), "pads_end")
        self._check_rank(b, e, rank)
        mode = self._mode(node)
        fill = get(3) if mode == "constant" else None
        return b, e, mode, 0.0 if fill is None else float(np.asarray(fill).reshape(()))

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        b, e, _, _ = self._cfg(node, in_values.get, len(in_shapes[0]))
        return ShapeResult({node.out_port: tuple(
            d + pb + pe for d, pb, pe in zip(in_shapes[0], b, e))})

    def ref_compute(self, node, inputs):
        b, e, mode, fill = self._cfg(node, inputs.get, inputs[0].ndim)
        kw = {"constant_values": fill} if mode == "constant" else {}
        return {node.out_port: np.pad(inputs[0], tuple(zip(b, e)), mode=mode, **kw)}

    def emit(self, ctx, node, inputs):
        x = inputs[0].arr
        b, e, mode, fill = self._cfg(
            node, lambda p: ctx.static_value(node, p) if p in inputs else None, x.dim())
        if mode == "constant":
            flat = [v for pb, pe in reversed(list(zip(b, e))) for v in (pb, pe)]
            return {node.out_port: TValue(_cl(F.pad(x, flat, value=fill)))}
        for axis, (pb, pe) in enumerate(zip(b, e)):
            if pb or pe:
                idx = np.pad(np.arange(x.shape[axis]), (pb, pe), mode=mode)
                x = x.index_select(axis, torch.from_numpy(idx).to(x.device))
        return {node.out_port: TValue(_cl(x))}


class _BlockSpatial(Op):
    """DepthToSpace and SpaceToDepth: a rank-4 reshape, transpose, reshape
    with the blocks_first (DCR) or depth_first (CRD) element order."""

    @staticmethod
    def _cfg(node):
        b = int(node.attrs.get("block_size", 1))
        if b < 1:
            raise ValueError(f"block_size must be >= 1, got {b}")
        mode = str(node.attrs.get("mode", "blocks_first")).lower()
        if mode not in ("blocks_first", "depth_first"):
            raise ValueError(f"unsupported mode {mode!r}")
        return b, mode

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        return ShapeResult({node.out_port: self._out_shape(node, in_shapes[0])})

    def ref_compute(self, node, inputs):
        return {node.out_port: self._rearrange(node, inputs[0], np.transpose)}

    def emit(self, ctx, node, inputs):
        return {node.out_port: TValue(_cl(self._rearrange(node, inputs[0].arr, torch.permute)))}


@register
class DepthToSpace(_BlockSpatial):
    """opset1 DepthToSpace: (N, C, H, W) → (N, C/b², H·b, W·b)."""

    type_name = "DepthToSpace"

    def _out_shape(self, node, s):
        b, _ = self._cfg(node)
        n, c, h, w = s
        if c % (b * b):
            raise ValueError(f"DepthToSpace: C={c} not divisible by block^2={b * b}")
        return (n, c // (b * b), h * b, w * b)

    def _rearrange(self, node, x, transpose):
        b, mode = self._cfg(node)
        n, c, h, w = x.shape
        co = c // (b * b)
        if mode == "blocks_first":  # DCR
            t = transpose(x.reshape(n, b, b, co, h, w), (0, 3, 4, 1, 5, 2))
        else:                       # CRD
            t = transpose(x.reshape(n, co, b, b, h, w), (0, 1, 4, 2, 5, 3))
        return t.reshape(n, co, h * b, w * b)


@register
class SpaceToDepth(_BlockSpatial):
    """opset1 SpaceToDepth: (N, C, H, W) → (N, C·b², H/b, W/b)."""

    type_name = "SpaceToDepth"

    def _out_shape(self, node, s):
        b, _ = self._cfg(node)
        n, c, h, w = s
        if h % b or w % b:
            raise ValueError(f"SpaceToDepth: H={h}/W={w} not divisible by block={b}")
        return (n, c * b * b, h // b, w // b)

    def _rearrange(self, node, x, transpose):
        b, mode = self._cfg(node)
        n, c, h, w = x.shape
        xr = x.reshape(n, c, h // b, b, w // b, b)
        perm = (0, 3, 5, 1, 2, 4) if mode == "blocks_first" else (0, 1, 3, 5, 2, 4)
        return transpose(xr, perm).reshape(n, c * b * b, h // b, w // b)


def _zero_pad(x, pads):
    """``np.pad(x, pads)``'s zeros on a numpy array or a tensor."""
    if isinstance(x, np.ndarray):
        return np.pad(x, pads)
    return F.pad(x, [v for pb, pe in reversed(pads) for v in (pb, pe)])


def _transpose(x, perm):
    return np.transpose(x, perm) if isinstance(x, np.ndarray) else x.permute(perm)


def _s2b_compute(x, block, pads_begin, pads_end):
    """SpaceToBatch on a numpy array or a tensor: pad, split each dim by its
    block factor, move the factors into the batch (TF's space_to_batch_nd
    for any rank; block[0] == 1)."""
    rank = x.ndim
    xpad = _zero_pad(x, [(int(pads_begin[i]), int(pads_end[i])) for i in range(rank)])
    s = tuple(xpad.shape)
    split = [s[0]]
    for i in range(1, rank):
        split += [s[i] // int(block[i]), int(block[i])]
    perm = [2 * i for i in range(1, rank)] + [0] + [2 * i - 1 for i in range(1, rank)]
    y = _transpose(xpad.reshape(split), perm)
    out_shape = [int(np.prod([int(b) for b in block])) * s[0]]
    out_shape += [s[i] // int(block[i]) for i in range(1, rank)]
    return y.reshape(out_shape)


def _b2s_compute(x, block, crops_begin, crops_end):
    """BatchToSpace, the inverse of ``_s2b_compute``."""
    rank = x.ndim
    nb = int(np.prod([int(b) for b in block]))
    n0 = x.shape[0] // nb
    lead = [int(block[i]) for i in range(1, rank)] + [n0]
    y = x.reshape(lead + list(x.shape[1:]))
    perm = [rank - 1] + [v for i in range(1, rank) for v in (rank - 1 + i, i - 1)]
    merged = [n0] + [x.shape[i] * int(block[i]) for i in range(1, rank)]
    y = _transpose(y, perm).reshape(merged)
    sl = [slice(None)] + [slice(int(crops_begin[i]), merged[i] - int(crops_end[i]))
                          for i in range(1, rank)]
    return y[tuple(sl)]


class _BlockOp(Op):
    """SpaceToBatch and BatchToSpace: three constant int64 inputs (block
    shape, begin, end)."""

    core = None

    @staticmethod
    def _consts(node, vals):
        out = []
        for i in (1, 2, 3):
            v = vals.get(i)
            if v is None:
                raise ValueError(f"{node.op_type} {node.name}: input {i} must be constant")
            out.append(np.asarray(v, np.int64).reshape(-1))
        return out

    def ref_compute(self, node, inputs):
        return {node.out_port: type(self).core(inputs[0], *self._consts(node, inputs))}

    def emit(self, ctx, node, inputs):
        consts = self._consts(node, {i: ctx.static_value(node, i) for i in (1, 2, 3)})
        return {node.out_port: TValue(_cl(type(self).core(inputs[0].arr, *consts)))}


@register
class SpaceToBatch(_BlockOp):
    type_name = "SpaceToBatch"
    core = staticmethod(_s2b_compute)

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        block, pb, pe = self._consts(node, in_values)
        shape = in_shapes[0]
        if int(block[0]) != 1 or int(pb[0]) or int(pe[0]):
            raise ValueError(f"SpaceToBatch {node.name}: block[0] must be 1 and the "
                             "batch dim unpadded (spec)")
        out = [int(np.prod(block)) * shape[0]]
        for i in range(1, len(shape)):
            padded = shape[i] + int(pb[i]) + int(pe[i])
            if padded % int(block[i]):
                raise ValueError(f"SpaceToBatch {node.name}: padded dim {i} = {padded} "
                                 f"not divisible by block {int(block[i])}")
            out.append(padded // int(block[i]))
        return ShapeResult({node.out_port: tuple(out)})


@register
class BatchToSpace(_BlockOp):
    type_name = "BatchToSpace"
    core = staticmethod(_b2s_compute)

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        block, cb, ce = self._consts(node, in_values)
        shape = in_shapes[0]
        nb = int(np.prod(block))
        if int(block[0]) != 1 or int(cb[0]) or int(ce[0]):
            raise ValueError(f"BatchToSpace {node.name}: block[0] must be 1 and the "
                             "batch dim uncropped (spec)")
        if shape[0] % nb:
            raise ValueError(f"BatchToSpace {node.name}: batch {shape[0]} not "
                             f"divisible by prod(block) {nb}")
        out = [shape[0] // nb]
        for i in range(1, len(shape)):
            out.append(shape[i] * int(block[i]) - int(cb[i]) - int(ce[i]))
        return ShapeResult({node.out_port: tuple(out)})


@register
class ShuffleChannels(Op):
    """opset1 ShuffleChannels: (…, g, C/g, …) → (…, C/g, g, …) along
    ``axis`` (ShuffleNet-v2's channel shuffle with ``group`` 2)."""

    type_name = "ShuffleChannels"

    @staticmethod
    def _ag(node, rank):
        return (_norm_axis(A.get_int(node.attrs, "axis", 1), rank, "ShuffleChannels"),
                A.get_int(node.attrs, "group", 1))

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        axis, g = self._ag(node, len(in_shapes[0]))
        if in_shapes[0][axis] % g:
            raise ValueError(f"ShuffleChannels {node.name}: axis extent "
                             f"{in_shapes[0][axis]} not divisible by group {g}")
        return ShapeResult({node.out_port: in_shapes[0]})

    @staticmethod
    def _shuffle(x, axis, g):
        s = tuple(x.shape)
        split = s[:axis] + (g, s[axis] // g) + s[axis + 1:]
        perm = list(range(len(split)))
        perm[axis], perm[axis + 1] = perm[axis + 1], perm[axis]
        return _transpose(x.reshape(split), perm).reshape(s)

    def ref_compute(self, node, inputs):
        return {node.out_port: self._shuffle(inputs[0], *self._ag(node, inputs[0].ndim))}

    def emit(self, ctx, node, inputs):
        x = inputs[0].arr
        return {node.out_port: TValue(_cl(self._shuffle(x, *self._ag(node, x.dim()))))}


@register
class Broadcast(Op):
    """opset3 Broadcast to a constant target shape (input 1), numpy,
    bidirectional or explicit; explicit's axes_mapping (input 2) pins each
    input dim to a target axis, the input permuted into target order first."""

    type_name = "Broadcast"

    @staticmethod
    def _mode(node) -> str:
        mode = A.get_str(node.attrs, "mode", "numpy")
        if mode not in ("numpy", "bidirectional", "explicit"):
            raise ValueError(f"Broadcast: unknown mode {mode!r}")
        return mode

    def _target(self, node, in_shape, tval):
        if tval is None:
            raise ValueError("Broadcast: target shape must be constant")
        t = tuple(int(d) for d in np.asarray(tval).reshape(-1))
        if self._mode(node) == "bidirectional":
            return tuple(int(d) for d in np.broadcast_shapes(tuple(in_shape), t))
        return t

    @staticmethod
    def _explicit_plan(in_shape, target, aval):
        """(input permutation, interim shape) of the explicit mode."""
        if aval is None:
            raise ValueError("Broadcast explicit: axes_mapping (input 2) must be constant")
        axes = tuple(int(a) for a in np.asarray(aval).reshape(-1))
        if len(axes) != len(in_shape):
            raise ValueError(f"Broadcast explicit: axes_mapping {axes} rank != input "
                             f"{tuple(in_shape)}")
        if len(set(axes)) != len(axes):
            raise ValueError(f"Broadcast explicit: duplicate axes in {axes}")
        perm = tuple(int(i) for i in np.argsort(axes))
        interim = [1] * len(target)
        for a, d in zip(axes, in_shape):
            if not 0 <= a < len(target):
                raise ValueError(f"Broadcast explicit: axis {a} out of range for {target}")
            if target[a] != d and d != 1:
                raise ValueError(f"Broadcast explicit: input dim {d} pinned to target "
                                 f"axis {a} of extent {target[a]}")
            interim[a] = d
        return perm, tuple(interim)

    def _apply(self, node, x, tval, aval):
        out = self._target(node, tuple(x.shape), tval)
        if self._mode(node) == "explicit":
            perm, interim = self._explicit_plan(tuple(x.shape), out, aval)
            x = _transpose(x, perm).reshape(interim)
        return x, out

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        out = self._target(node, in_shapes[0], in_values.get(1))
        if self._mode(node) == "explicit":
            self._explicit_plan(in_shapes[0], out, in_values.get(2))
        res = ShapeResult({node.out_port: out})
        if in_values.get(0) is not None:
            v, out = self._apply(node, in_values[0], in_values.get(1), in_values.get(2))
            res.values[node.out_port] = np.broadcast_to(v, out)
        return res

    def ref_compute(self, node, inputs):
        x, out = self._apply(node, inputs[0], inputs[1], inputs.get(2))
        return {node.out_port: np.ascontiguousarray(np.broadcast_to(x, out))}

    def emit(self, ctx, node, inputs):
        x, out = self._apply(node, inputs[0].arr, ctx.static_value(node, 1),
                             ctx.static_value(node, 2) if 2 in inputs else None)
        return {node.out_port: TValue(_cl(x.expand(out).contiguous()))}


@register
class Range(Op):
    """opset4 Range over constant start, stop and step: always folded at
    compile time, the result in ``output_type``."""

    type_name = "Range"

    @staticmethod
    def _fold(vals, node):
        vals = [vals.get(i) for i in range(3)]
        if any(v is None for v in vals):
            raise ValueError(f"Range {node.name}: start/stop/step must be constant")
        start, stop, step = (float(np.asarray(v).reshape(())) for v in vals)
        dt = np.dtype(ELEMENT_TYPE_TO_DTYPE[A.get_str(node.attrs, "output_type", "f32")])
        return np.arange(start, stop, step).astype(dt)

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        out = self._fold(in_values, node)
        return ShapeResult({node.out_port: out.shape}, {node.out_port: out})

    def ref_compute(self, node, inputs):
        return {node.out_port: self._fold(inputs, node)}

    def emit(self, ctx, node, inputs):
        out = self._fold({i: ctx.static_value(node, i) for i in range(3)}, node)
        return {node.out_port: TValue(torch.from_numpy(out).to(inputs[0].arr.device))}


@register
class ReverseSequence(Op):
    """opset1 ReverseSequence: in each row of ``batch_axis``, the first
    seq_lengths[b] elements along ``seq_axis`` reversed (a gather with
    index len − 1 − t below the length, t from it on)."""

    type_name = "ReverseSequence"

    @staticmethod
    def _axes(node, rank):
        return (_norm_axis(A.get_int(node.attrs, "batch_axis", 0), rank, "ReverseSequence"),
                _norm_axis(A.get_int(node.attrs, "seq_axis", 1), rank, "ReverseSequence"))

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        ba, sa = self._axes(node, len(in_shapes[0]))
        if ba == sa:
            raise ValueError("ReverseSequence: batch_axis == seq_axis")
        if in_shapes[1][0] != in_shapes[0][ba]:
            raise ValueError(f"ReverseSequence: seq_lengths size {in_shapes[1][0]} != "
                             f"batch extent {in_shapes[0][ba]}")
        return ShapeResult({node.out_port: in_shapes[0]})

    @staticmethod
    def _index(t, lens, shape, ba, sa):
        view_t = [1] * len(shape)
        view_t[sa] = shape[sa]
        view_l = [1] * len(shape)
        view_l[ba] = shape[ba]
        tt, ll = t.reshape(view_t), lens.reshape(view_l)
        return tt, ll

    def ref_compute(self, node, inputs):
        x = inputs[0]
        ba, sa = self._axes(node, x.ndim)
        tt, ll = self._index(np.arange(x.shape[sa]), np.asarray(inputs[1], np.int64),
                             x.shape, ba, sa)
        idx = np.broadcast_to(np.where(tt < ll, ll - 1 - tt, tt), x.shape)
        return {node.out_port: np.take_along_axis(x, idx, axis=sa)}

    def emit(self, ctx, node, inputs):
        x = inputs[0].arr
        ba, sa = self._axes(node, x.dim())
        tt, ll = self._index(torch.arange(x.shape[sa], device=x.device),
                             inputs[1].arr.long(), tuple(x.shape), ba, sa)
        idx = torch.where(tt < ll, ll - 1 - tt, tt).expand(x.shape)
        return {node.out_port: TValue(_cl(torch.gather(x, sa, idx)))}


@register
class CumSum(Op):
    """opset3 CumSum along a constant axis (input 1, default 0), with the
    ``exclusive`` and ``reverse`` attributes, in the input's dtype.
    ``torch.cumsum`` scans in its own order on the card: float sums agree
    with the JAX package's within the tolerance, integer ones exactly."""

    type_name = "CumSum"

    @staticmethod
    def _flags(node):
        return (A.get_bool(node.attrs, "exclusive", False),
                A.get_bool(node.attrs, "reverse", False))

    @staticmethod
    def _axis(source, rank):
        return 0 if source is None else _norm_axis(source, rank, "CumSum")

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        return ShapeResult({node.out_port: in_shapes[0]})

    def ref_compute(self, node, inputs):
        ex, rev = self._flags(node)
        x = inputs[0]
        ax = self._axis(inputs.get(1), x.ndim)
        v = np.flip(x, axis=ax) if rev else x
        out = np.cumsum(v, axis=ax)
        if ex:
            pad = [(0, 0)] * x.ndim
            pad[ax] = (1, 0)
            sl = [slice(None)] * x.ndim
            sl[ax] = slice(0, x.shape[ax])
            out = np.pad(out, pad)[tuple(sl)]
        if rev:
            out = np.flip(out, axis=ax)
        return {node.out_port: out.astype(x.dtype)}

    def emit(self, ctx, node, inputs):
        ex, rev = self._flags(node)
        x = inputs[0].arr
        ax = self._axis(ctx.static_value(node, 1) if 1 in inputs else None, x.dim())
        v = torch.flip(x, dims=(ax,)) if rev else x
        out = torch.cumsum(v, dim=ax).to(x.dtype)
        if ex:
            out = torch.cat([torch.zeros_like(out.narrow(ax, 0, 1)),
                             out.narrow(ax, 0, x.shape[ax] - 1)], dim=ax)
        if rev:
            out = torch.flip(out, dims=(ax,))
        return {node.out_port: TValue(_cl(out))}


@register
class OneHot(Op):
    """opset1 OneHot: indices → on_value where the index equals the position
    along the new ``axis``, off_value elsewhere; depth (input 1) constant,
    on and off values inputs 2 and 3, whose dtype the result takes."""

    type_name = "OneHot"

    @staticmethod
    def _axis(node):
        return A.get_int(node.attrs, "axis", -1)

    @staticmethod
    def _depth(vals, node):
        d = vals.get(1)
        if d is None:
            raise ValueError(f"OneHot {node.name}: depth must be constant")
        return int(np.asarray(d).reshape(()))

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        depth = self._depth(in_values, node)
        axis = self._axis(node) % (len(in_shapes[0]) + 1)
        shape = tuple(in_shapes[0])
        return ShapeResult({node.out_port: shape[:axis] + (depth,) + shape[axis:]})

    def ref_compute(self, node, inputs):
        depth = self._depth(inputs, node)
        axis = self._axis(node) % (inputs[0].ndim + 1)
        on = np.asarray(inputs[2]).reshape(())
        off = np.asarray(inputs[3]).reshape(())
        idx = np.asarray(inputs[0], np.int64)
        eye = np.moveaxis(idx[..., None] == np.arange(depth), -1, axis)
        return {node.out_port: np.where(eye, on, off).astype(on.dtype)}

    def emit(self, ctx, node, inputs):
        depth = self._depth({1: ctx.static_value(node, 1)}, node)
        idx = inputs[0].arr.long()
        axis = self._axis(node) % (idx.dim() + 1)
        eye = torch.movedim(idx[..., None] == torch.arange(depth, device=idx.device), -1, axis)
        on, off = inputs[2].arr.reshape(()), inputs[3].arr.reshape(())
        return {node.out_port: TValue(_cl(torch.where(eye, on, off)))}


# -- gather and scatter --------------------------------------------------------------

def _wrapped(idx, extent):
    """Negative indices counted from the end, as numpy and JAX index."""
    idx = idx.long()
    return torch.where(idx < 0, idx + extent, idx)


@register
class GatherND(Op):
    """GatherND: slices addressed by the trailing dim of ``indices``, the
    first ``batch_dims`` axes shared.  opset8 keeps the batch dims in the
    output; a layer of version opset5 (the parser's ``_opset``) flattens
    them."""

    type_name = "GatherND"

    @staticmethod
    def _bd(node) -> int:
        return A.get_int(node.attrs, "batch_dims", 0)

    @staticmethod
    def _flat5(node) -> bool:
        return node.attrs.get("_opset") == "opset5"

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        data, idx = in_shapes[0], in_shapes[1]
        bd = self._bd(node)
        k = idx[-1]
        if bd + k > len(data):
            raise ValueError(f"GatherND: indices depth {k} + batch_dims {bd} exceeds "
                             f"data rank {len(data)}")
        out = tuple(idx[:-1]) + tuple(data[bd + k:])
        if bd and self._flat5(node):
            out = (int(np.prod(out[:bd])),) + tuple(out[bd:])
        return ShapeResult({node.out_port: out})

    def _finish(self, node, out, bd):
        if bd and self._flat5(node):
            out = out.reshape((-1,) + tuple(out.shape[bd:]))
        return out

    def ref_compute(self, node, inputs):
        data, idx, bd = inputs[0], np.asarray(inputs[1], np.int64), self._bd(node)
        k = idx.shape[-1]
        if bd == 0:
            out = data[tuple(idx[..., i] for i in range(k))]
        else:
            b = int(np.prod(data.shape[:bd]))
            dflat = data.reshape((b,) + tuple(data.shape[bd:]))
            iflat = idx.reshape((b,) + tuple(idx.shape[bd:]))
            brange = np.arange(b).reshape((b,) + (1,) * (iflat.ndim - 2))
            tup = (np.broadcast_to(brange, iflat.shape[:-1]),) + tuple(
                iflat[..., i] for i in range(k))
            out = dflat[tup].reshape(tuple(idx.shape[:-1]) + tuple(data.shape[bd + k:]))
        return {node.out_port: self._finish(node, out, bd)}

    def emit(self, ctx, node, inputs):
        data, idx, bd = inputs[0].arr, inputs[1].arr.long(), self._bd(node)
        k = idx.shape[-1]
        b = int(np.prod(data.shape[:bd]))
        dflat = data.reshape((b,) + tuple(data.shape[bd:]))
        iflat = idx.reshape((b,) + tuple(idx.shape[bd:]))
        brange = torch.arange(b, device=data.device).reshape((b,) + (1,) * (iflat.dim() - 2))
        tup = (brange.expand(iflat.shape[:-1]),) + tuple(
            _wrapped(iflat[..., i], dflat.shape[1 + i]) for i in range(k))
        out = dflat[tup].reshape(tuple(idx.shape[:-1]) + tuple(data.shape[bd + k:]))
        return {node.out_port: TValue(_cl(self._finish(node, out, bd)))}


@register
class GatherElements(Op):
    """opset6 GatherElements: take_along_axis on the ``axis`` attribute."""

    type_name = "GatherElements"

    @staticmethod
    def _axis(node, rank):
        return _norm_axis(A.get_int(node.attrs, "axis", 0), rank, "GatherElements")

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        data, idx = in_shapes[0], in_shapes[1]
        ax = self._axis(node, len(data))
        if len(idx) != len(data) or any(
                i != ax and idx[i] != data[i] for i in range(len(data))):
            raise ValueError(f"GatherElements: indices shape {tuple(idx)} must match "
                             f"data {tuple(data)} on every axis except {ax}")
        return ShapeResult({node.out_port: in_shapes[1]})

    def ref_compute(self, node, inputs):
        ax = self._axis(node, inputs[0].ndim)
        return {node.out_port: np.take_along_axis(
            inputs[0], np.asarray(inputs[1], np.int64), axis=ax)}

    def emit(self, ctx, node, inputs):
        data = inputs[0].arr
        ax = self._axis(node, data.dim())
        return {node.out_port: TValue(_cl(torch.gather(
            data, ax, _wrapped(inputs[1].arr, data.shape[ax]))))}


@register
class ScatterNDUpdate(Op):
    """opset4 ScatterNDUpdate: data with the slices at ``indices`` replaced by
    ``updates``.  Where two indices name one slice, numpy's ``ref_compute``
    keeps the last write and the JAX emit leaves the winner unspecified, as
    ``index_put_`` on the card does (ROADMAP.md §3)."""

    type_name = "ScatterNDUpdate"

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        data, idx, upd = (in_shapes[i] for i in range(3))
        k = idx[-1]
        if k > len(data):
            raise ValueError(f"ScatterNDUpdate: indices depth {k} exceeds data rank "
                             f"{len(data)}")
        want = tuple(idx[:-1]) + tuple(data[k:])
        if tuple(upd) != want:
            raise ValueError(f"ScatterNDUpdate: updates shape {tuple(upd)} != "
                             f"{want} implied by data/indices")
        return ShapeResult({node.out_port: data})

    def ref_compute(self, node, inputs):
        data = np.array(inputs[0])
        idx = np.asarray(inputs[1], np.int64)
        data[tuple(idx[..., i] for i in range(idx.shape[-1]))] = inputs[2]
        return {node.out_port: data}

    def emit(self, ctx, node, inputs):
        data = inputs[0].arr.clone()
        idx = inputs[1].arr
        data[tuple(_wrapped(idx[..., i], data.shape[i]) for i in range(idx.shape[-1]))] = (
            inputs[2].arr.to(data.dtype))
        return {node.out_port: TValue(_cl(data))}


@register
class ScatterElementsUpdate(Op):
    """opset3 ScatterElementsUpdate: put_along_axis over a constant axis
    (input 3); duplicate indices as ScatterNDUpdate's."""

    type_name = "ScatterElementsUpdate"

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        if tuple(in_shapes[1]) != tuple(in_shapes[2]):
            raise ValueError(f"ScatterElementsUpdate: indices {tuple(in_shapes[1])} "
                             f"!= updates {tuple(in_shapes[2])}")
        ax = in_values.get(3)
        if ax is None:
            raise ValueError("ScatterElementsUpdate: axis must be constant")
        _norm_axis(ax, len(in_shapes[0]), "ScatterElementsUpdate")
        return ShapeResult({node.out_port: in_shapes[0]})

    def ref_compute(self, node, inputs):
        ax = _norm_axis(inputs[3], inputs[0].ndim, "ScatterElementsUpdate")
        data = np.array(inputs[0])
        np.put_along_axis(data, np.asarray(inputs[1], np.int64), inputs[2], axis=ax)
        return {node.out_port: data}

    def emit(self, ctx, node, inputs):
        data = inputs[0].arr
        ax = _norm_axis(ctx.static_value(node, 3), data.dim(), "ScatterElementsUpdate")
        out = torch.scatter(data, ax, _wrapped(inputs[1].arr, data.shape[ax]),
                            inputs[2].arr.to(data.dtype))
        return {node.out_port: TValue(_cl(out))}


@register
class EmbeddingBagOffsetsSum(Op):
    """opset3 EmbeddingBagOffsetsSum: inputs table (V, E), indices (I,),
    offsets (N,) [, default_index, per_sample_weights (I,)].  Bag b sums
    the (weighted) rows indices[offsets[b] : offsets[b + 1]]; an empty bag
    reads the default_index row, or zeros.  As in the JAX package, a
    weighted segment sum: each index position's bag from ``searchsorted``,
    then one (N, I) × (I, E) product in float32 (the JAX emit's
    full-precision einsum), a fixed order on the card, cast back to the
    table's dtype."""

    type_name = "EmbeddingBagOffsetsSum"

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        return ShapeResult({node.out_port: (in_shapes[2][0], in_shapes[0][1])})

    def ref_compute(self, node, inputs):
        table = np.asarray(inputs[0], np.float64)
        indices = np.asarray(inputs[1], np.int64)
        offsets = np.asarray(inputs[2], np.int64)
        n, i = offsets.shape[0], indices.shape[0]
        seg = np.searchsorted(offsets, np.arange(i), side="right") - 1
        rows = np.take(table, indices, axis=0)
        if inputs.get(4) is not None:
            rows = rows * np.asarray(inputs[4], np.float64)[:, None]
        onehot = seg[:, None] == np.arange(n)[None, :]
        out = np.einsum("ie,ib->be", rows, onehot.astype(rows.dtype))
        empty = np.concatenate([offsets[1:], np.asarray([i])]) == offsets
        if inputs.get(3) is not None:
            fill = np.take(table, np.asarray(inputs[3], np.int64).reshape(()), axis=0)
            out = np.where(empty[:, None], fill[None, :], out)
        else:
            out = np.where(empty[:, None], 0.0, out)
        return {node.out_port: out.astype(np.asarray(inputs[0]).dtype)}

    def emit(self, ctx, node, inputs):
        table = inputs[0].arr
        t32 = table.float()
        indices, offsets = inputs[1].arr.long(), inputs[2].arr.long()
        n, i = offsets.shape[0], indices.shape[0]
        seg = torch.searchsorted(offsets, torch.arange(i, device=t32.device), right=True) - 1
        rows = t32.index_select(0, _wrapped(indices, t32.shape[0]))
        if 4 in inputs:
            rows = rows * inputs[4].arr.float()[:, None]
        onehot = (seg[:, None] == torch.arange(n, device=t32.device)[None, :]).float()
        out = onehot.t() @ rows
        empty = torch.cat([offsets[1:], offsets.new_tensor([i])]) == offsets
        if 3 in inputs:
            fill = t32[_wrapped(inputs[3].arr.reshape(()), t32.shape[0])]
            out = torch.where(empty[:, None], fill[None, :], out)
        else:
            out = torch.where(empty[:, None], torch.zeros_like(out), out)
        return {node.out_port: TValue(out.to(table.dtype))}


# -- selection and decoding --------------------------------------------------------

@register
class TopK(Op):
    """opset3 TopK: the k largest (``mode`` max) or smallest along ``axis``
    → (values, indices), k (input 1) constant; ``sort`` value or index;
    indices in ``index_element_type``.  Ties resolve to the lower index, as
    numpy's stable argsort and ``lax.top_k`` resolve them: ``emit`` takes a
    stable sort, on the card too (``torch.topk`` there promises no tie
    order)."""

    type_name = "TopK"

    @staticmethod
    def _params(node):
        return (A.get_int(node.attrs, "axis"), A.get_str(node.attrs, "mode", "max"),
                A.get_str(node.attrs, "sort", "value"),
                A.get_str(node.attrs, "index_element_type", "i32"))

    @staticmethod
    def _ports(node):
        ports = sorted(node.outputs)
        return ports if len(ports) == 2 else [node.out_port, node.out_port + 1]

    @staticmethod
    def _k(value):
        if value is None:
            raise ValueError("TopK: k (input 1) must be a constant")
        return int(np.asarray(value).reshape(()))

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        axis = _norm_axis(self._params(node)[0], len(in_shapes[0]), "TopK")
        k = self._k(in_values.get(1))
        shape = list(in_shapes[0])
        if k > shape[axis]:
            raise ValueError(f"TopK: k={k} exceeds axis extent {shape[axis]}")
        shape[axis] = k
        return ShapeResult({p: tuple(shape) for p in self._ports(node)})

    def ref_compute(self, node, inputs):
        axis, mode, sort, itype = self._params(node)
        x = inputs[0]
        axis = _norm_axis(axis, x.ndim, "TopK")
        k = self._k(inputs[1])
        if mode != "max":
            key = x
        elif np.issubdtype(x.dtype, np.integer):
            key = ~x  # a decreasing order that cannot overflow
        else:
            key = -x
        idx = np.take(np.argsort(key, axis=axis, kind="stable"), np.arange(k), axis=axis)
        if sort == "index":
            idx = np.sort(idx, axis=axis)
        vals = np.take_along_axis(x, idx, axis=axis)
        vp, ip = self._ports(node)
        return {vp: vals, ip: idx.astype(np.int64 if itype == "i64" else np.int32)}

    def emit(self, ctx, node, inputs):
        axis, mode, sort, itype = self._params(node)
        x = inputs[0].arr
        axis = _norm_axis(axis, x.dim(), "TopK")
        k = self._k(ctx.static_value(node, 1))
        idx = torch.sort(x, dim=axis, descending=mode == "max", stable=True)[1].narrow(axis, 0, k)
        if sort == "index":
            idx = torch.sort(idx, dim=axis)[0]
        vals = torch.gather(x, axis, idx)
        vp, ip = self._ports(node)
        return {vp: TValue(_cl(vals)),
                ip: TValue(_cl(idx.to(torch.int64 if itype == "i64" else torch.int32)))}


def _einsum_out_shape(eq, shapes):
    """Einsum's output shape from label arithmetic (nothing is computed):
    explicit and implicit outputs, one ellipsis per operand broadcast as
    numpy broadcasts."""
    lhs, rhs = eq.split("->") if "->" in eq else (eq, None)
    terms = lhs.split(",")
    if len(terms) != len(shapes):
        raise ValueError(f"{len(terms)} equation operands != {len(shapes)} inputs")
    dims, counts, batch_shape = {}, {}, ()
    for term, shape in zip(terms, shapes):
        if "..." in term:
            head, tail = term.split("...")
            labels = list(head) + list(tail)
            if len(labels) > len(shape):
                raise ValueError(f"term {term!r} too long for {shape}")
            n_ell = len(shape) - len(labels)
            batch_shape = tuple(int(d) for d in np.broadcast_shapes(
                batch_shape, shape[len(head):len(head) + n_ell]))
            axes = list(shape[:len(head)]) + list(shape[len(head) + n_ell:])
        else:
            labels = list(term)
            if len(labels) != len(shape):
                raise ValueError(f"term {term!r} rank != {shape}")
            axes = list(shape)
        for lab, d in zip(labels, axes):
            if lab in dims and dims[lab] != d:
                raise ValueError(f"label {lab!r} bound to both {dims[lab]} and {d}")
            dims[lab] = int(d)
            counts[lab] = counts.get(lab, 0) + 1
    if rhs is None:
        rhs = ("..." if any("..." in t for t in terms) else "") + "".join(
            sorted(lab for lab, c in counts.items() if c == 1))
    out = []
    for part in rhs.split("..."):
        for lab in part:
            if lab not in dims:
                raise ValueError(f"output label {lab!r} not present in inputs")
        out.append(tuple(dims[lab] for lab in part))
    return out[0] + batch_shape + out[1] if "..." in rhs else out[0]


@register
class Einsum(Op):
    """opset7 Einsum over any number of inputs.  ``emit`` contracts in
    float32 (TF32 off under float32: ``runtime/compiler.py``) and rounds
    once to the first input's dtype, as the JAX emit's
    ``preferred_element_type=float32`` at ``Precision.HIGHEST`` does; a
    bfloat16 operand widens exactly."""

    type_name = "Einsum"

    @staticmethod
    def _eq(node) -> str:
        return A.get_str(node.attrs, "equation").replace(" ", "")

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        shapes = [tuple(in_shapes[i]) for i in sorted(in_shapes)]
        try:
            out = _einsum_out_shape(self._eq(node), shapes)
        except ValueError as e:
            raise ValueError(f"Einsum {node.name}: bad equation {self._eq(node)!r} for "
                             f"input shapes {shapes}: {e}") from None
        return ShapeResult({node.out_port: out})

    def ref_compute(self, node, inputs):
        arrs = [inputs[i] for i in sorted(inputs)]
        out = np.einsum(self._eq(node), *arrs, optimize=True)
        return {node.out_port: np.asarray(out, dtype=arrs[0].dtype)}

    def emit(self, ctx, node, inputs):
        arrs = [inputs[i].arr for i in sorted(inputs)]
        out = torch.einsum(self._eq(node), *(a.float() for a in arrs))
        return {node.out_port: TValue(_cl(out.to(arrs[0].dtype)))}


@register
class CTCGreedyDecoder(Op):
    """opset1 CTCGreedyDecoder: per-frame argmax (the first maximum), repeats
    merged (``ctc_merge_repeated``, default true), the blank (class C − 1)
    dropped; (N, T, 1, 1) class ids padded with −1, as float32.  Inputs:
    probabilities (T, N, C) and a (T, N) mask of 1s and 0s.  The kept
    frames move to the front with a stable sort of their positions."""

    type_name = "CTCGreedyDecoder"

    @staticmethod
    def _merge(node) -> bool:
        return A.get_bool(node.attrs, "ctc_merge_repeated", True)

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        t, n, _c = in_shapes[0]
        return ShapeResult({node.out_port: (n, t, 1, 1)})

    @staticmethod
    def _keep(cls, mask, c, merge, cat, full):
        prev = cat([full, cls[:-1]])
        keep = (mask > 0.5) & (cls != (c - 1))
        return keep & (cls != prev) if merge else keep

    def ref_compute(self, node, inputs):
        probs = np.asarray(inputs[0], np.float64)
        t, n, c = probs.shape
        cls = np.argmax(probs, axis=2)
        keep = self._keep(cls, np.asarray(inputs[1]), c, self._merge(node),
                          lambda v: np.concatenate(v, axis=0), np.full((1, n), -1, cls.dtype))
        key = np.where(keep, np.arange(t)[:, None], t + 1)
        cls_sorted = np.take_along_axis(cls, np.argsort(key, axis=0, stable=True), axis=0)
        out = np.where(np.arange(t)[:, None] < keep.sum(axis=0)[None, :], cls_sorted, -1)
        return {node.out_port: out.T.reshape(n, t, 1, 1).astype(np.float32)}

    def emit(self, ctx, node, inputs):
        probs = inputs[0].arr.float()
        t, n, c = probs.shape
        cls = torch.argmax(probs, dim=2)
        keep = self._keep(cls, inputs[1].arr, c, self._merge(node),
                          lambda v: torch.cat(v, dim=0), cls.new_full((1, n), -1))
        rank = torch.arange(t, device=cls.device)[:, None]
        key = torch.where(keep, rank, t + 1)
        cls_sorted = torch.gather(cls, 0, torch.argsort(key, dim=0, stable=True))
        out = torch.where(rank < keep.sum(dim=0)[None, :], cls_sorted, -1)
        return {node.out_port: TValue(_cl(out.t().reshape(n, t, 1, 1).float()))}
