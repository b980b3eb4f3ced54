"""Add and Multiply (numpy broadcast), ReLU, Clamp, Sigmoid, SoftMax and LRN.

Counterpart of the matching ops of ``pyopenvino_tpu/ops/elementwise.py``,
whose numpy ``ref_compute`` each op repeats.  ReLU carries an int8-stored
activation exactly (max(x, 0) commutes with the positive dequant scale).
Activations are logical tensors, so a (1, C, 1, 1) constant broadcasts over
the channel axis whatever the memory format.  SoftMax honours its declared
axis and subtracts the row max; on the KERNELS backend a 2-D softmax over
axis 1 runs the softmax_rows kernel, under the same condition as the JAX
package's Pallas route.  LRN follows the JAX package's CPU lowering (a
float32 window sum of squares over channels, then ``x·(bias + α·Σ)^(−β)``)
and takes an int8-stored input, dequantized on read; a bfloat16 input is
squared in bfloat16, as the JAX package's chip lowering (``_lrn_banded``)
does, and summed and normalized in float32.
"""

from __future__ import annotations

import numpy as np
import torch

from pyopenvino_tpu_torch.ir import attrs as A
from pyopenvino_tpu_torch.ops.spec import Op, ShapeResult, TValue, register


class _Binary(Op):
    """A numpy-broadcast binary op whose ``fn`` takes numpy arrays and
    tensors alike."""

    fn = None

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        out = tuple(np.broadcast_shapes(in_shapes[0], in_shapes[1]))
        res = ShapeResult({node.out_port: out})
        if in_values.get(0) is not None and in_values.get(1) is not None:
            res.values[node.out_port] = self.fn(in_values[0], in_values[1])
        return res

    def ref_compute(self, node, inputs):
        return {node.out_port: self.fn(inputs[0], inputs[1])}

    def emit(self, ctx, node, inputs):
        return {node.out_port: TValue(self.fn(inputs[0].arr, inputs[1].arr))}


@register
class Add(_Binary):
    type_name = "Add"
    fn = staticmethod(lambda a, b: a + b)


@register
class Multiply(_Binary):
    """SSD's input scaling (``image_tensor · c``, then Add): its producer is
    the Parameter, not a conv, so there is nothing to fold into a weight."""

    type_name = "Multiply"
    fn = staticmethod(lambda a, b: a * b)


class _Unary(Op):
    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        return ShapeResult({node.out_port: in_shapes[0]})


@register
class ReLU(_Unary):
    type_name = "ReLU"
    int8_ports = (0,)  # exact int8 carry: the codes keep their scale

    def ref_compute(self, node, inputs):
        return {node.out_port: np.maximum(inputs[0], 0)}

    def emit(self, ctx, node, inputs):
        tv = inputs[0]
        return {node.out_port: TValue(torch.relu(tv.arr), act_scale=tv.act_scale)}


@register
class Clamp(_Unary):
    """Clamp to [min, max] (ReLU6 in MobileNet-v2).  After a conv or MatMul
    it is usually fused as the ("clamp", min, max) epilogue
    (passes/fuse.py); this is the standalone op."""

    type_name = "Clamp"

    def ref_compute(self, node, inputs):
        lo = A.get_float(node.attrs, "min")
        hi = A.get_float(node.attrs, "max")
        return {node.out_port: np.clip(inputs[0], lo, hi)}

    def emit(self, ctx, node, inputs):
        lo = A.get_float(node.attrs, "min")
        hi = A.get_float(node.attrs, "max")
        return {node.out_port: TValue(torch.clamp(inputs[0].arr, lo, hi))}


@register
class Sigmoid(_Unary):
    type_name = "Sigmoid"

    def ref_compute(self, node, inputs):
        x = inputs[0]
        return {node.out_port: (1.0 / (1.0 + np.exp(-x.astype(np.float64)))).astype(x.dtype)}

    def emit(self, ctx, node, inputs):
        # jax.nn.sigmoid's bits: torch.sigmoid in float32, XLA's three
        # rounded steps in bfloat16 (``sigmoid`` below)
        return {node.out_port: TValue(sigmoid(inputs[0].arr))}


@register
class SoftMax(_Unary):
    type_name = "SoftMax"

    def ref_compute(self, node, inputs):
        x = inputs[0]
        axis = A.get_int(node.attrs, "axis", 1)
        m = x.max(axis=axis, keepdims=True)
        e = np.exp(x - m)
        return {node.out_port: (e / e.sum(axis=axis, keepdims=True)).astype(x.dtype)}

    def emit(self, ctx, node, inputs):
        axis = A.get_int(node.attrs, "axis", 1)
        x = inputs[0].arr
        if ctx.use_kernels and x.dim() == 2 and axis in (1, -1):
            from pyopenvino_tpu_torch.kernels.softmax import softmax_rows

            return {node.out_port: TValue(softmax_rows(x))}
        return {node.out_port: TValue(softmax(x, axis))}


def sigmoid(x):
    """``jax.nn.sigmoid``, which XLA expands to 1 / (1 + exp(−x)):
    ``torch.sigmoid`` in float32 (nearer XLA's bits, whose exp is not
    PyTorch's, than the expansion on PyTorch's exp), and in a narrower dtype
    the expansion's steps in that dtype, each rounded there, as XLA's
    bfloat16 logistic on the CPU rounds them."""
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return 1.0 / (1.0 + torch.exp(-x))


def softmax(x, dim):
    """``jax.nn.softmax`` over ``dim``: ``torch.softmax`` in float32, and in
    a narrower dtype its steps in that dtype, each rounded there."""
    if x.dtype == torch.float32:
        return torch.softmax(x, dim=dim)
    e = torch.exp(x - x.amax(dim=dim, keepdim=True))
    return e / e.sum(dim=dim, keepdim=True)


@register
class LRN(Op):
    """opset1 LRN across channels: x / (bias + α·Σ x²)^β, the sum over the
    channels [c − size//2, c + size//2] with zeros outside (α is not
    divided by ``size``, unlike ``torch.nn.functional.local_response_norm``).

    ``emit`` is the JAX package's CPU lowering, not its TPU one (a banded
    bfloat16 channel matmul): the window sum adds the ``size`` shifted
    slices of the zero-padded float32 squares in channel order, as a
    reduce window does (a cumulative-sum difference would lose digits to
    cancellation), then multiplies by (bias + α·Σ)^(−β).  The squares are
    taken in the input's dtype: under ``compute_dtype="bfloat16"`` they
    round to bfloat16, as the TPU lowering's ``sq = x * x`` does
    (pyopenvino_tpu/ops/elementwise.py:226-236); the rest is float32, and
    the result takes the compute dtype."""

    type_name = "LRN"
    int8_ports = (0,)  # an accepter: an int8-stored input is dequantized on read

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        return ShapeResult({node.out_port: in_shapes[0]})

    @staticmethod
    def _params(node):
        return (A.get_float(node.attrs, "alpha"), A.get_float(node.attrs, "beta"),
                A.get_float(node.attrs, "bias"), A.get_int(node.attrs, "size"))

    def ref_compute(self, node, inputs):
        x = inputs[0]
        alpha, beta, bias, size = self._params(node)
        c = x.shape[1]
        sq = x.astype(np.float64) ** 2
        denom = np.empty_like(sq)
        for ch in range(c):
            lo, hi = max(0, ch - size // 2), min(c, ch + size // 2 + 1)
            denom[:, ch] = (bias + alpha * sq[:, lo:hi].sum(axis=1)) ** beta
        return {node.out_port: (x / denom).astype(x.dtype)}

    def emit(self, ctx, node, inputs):
        alpha, beta, bias, size = self._params(node)
        tv = inputs[0]
        out_dtype = ctx.compute_dtype if tv.act_scale is not None else tv.arr.dtype
        x = tv.dequant().arr
        half, c = size // 2, x.shape[1]
        sq = torch.nn.functional.pad((x * x).float(), (0, 0, 0, 0, half, half))
        window = sq[:, 0:c]
        for k in range(1, 2 * half + 1):
            window = window + sq[:, k:k + c]
        out = x.float() * torch.pow(bias + alpha * window, -beta)
        return {node.out_port: TValue(out.to(out_dtype))}
