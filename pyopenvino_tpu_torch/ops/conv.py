"""Convolution, FP32.

Counterpart of ``Convolution`` in ``pyopenvino_tpu/ops/conv.py``:

  * KERNELS backend, 1×1 conv with co >= 128 and ci >= 64 (the JAX
    package's Pallas condition, ops/conv.py:253): ``conv2d_fused``, the
    patches + fused_gemm kernel with bias and activation in its epilogue;
  * otherwise ``F.conv2d`` (cuDNN on the card, TF32 off — see
    runtime/compiler.py) with the bias passed to the conv and the
    activation applied after it.

Activations arrive as logical NCHW tensors in channels_last memory format,
so ``x.permute(0, 2, 3, 1)`` is the contiguous NHWC tensor that
``conv2d_fused`` takes, and its NHWC result permuted back is again a
channels_last NCHW tensor.  GroupConvolution, the TPU-specific
space-to-depth stem rewrite and the INT8 branches are not ported yet.
"""

from __future__ import annotations

import torch.nn.functional as F

from pyopenvino_tpu_torch.ir import attrs as A
from pyopenvino_tpu_torch.kernels.gemm import apply_act
from pyopenvino_tpu_torch.ops.padding import conv_padding
from pyopenvino_tpu_torch.ops.spec import Op, ShapeResult, TValue, register


@register
class Convolution(Op):
    type_name = "Convolution"

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        n, _, h, w = in_shapes[0]
        co, _, kh, kw = in_shapes[1]
        pad = conv_padding(node.attrs, (h, w), (kh, kw))
        return ShapeResult({node.out_port: (n, co, pad.out_h, pad.out_w)})

    def emit(self, ctx, node, inputs):
        return self.emit_fused(ctx, node, inputs)

    def emit_fused(self, ctx, node, inputs, bias=None, act=None):
        x = inputs[0].arr
        w = inputs[1].arr
        co, ci, kh, kw = w.shape
        strides = A.get_int_tuple(node.attrs, "strides", (1, 1))
        dilations = A.get_int_tuple(node.attrs, "dilations", (1, 1))
        pad = conv_padding(node.attrs, tuple(x.shape[2:]), (kh, kw))

        if ctx.use_kernels and kh == kw == 1 and co >= 128 and ci >= 64:
            from pyopenvino_tpu_torch.kernels.conv import (
                conv2d_fused, conv_weight_matrix,
            )

            wmat = ctx.derived_weight(node, 1, "gemm_kn", conv_weight_matrix)
            out = conv2d_fused(
                x.permute(0, 2, 3, 1), w, bias=bias, act=act,
                strides=strides, dilations=dilations, pads=pad.pads,
                wmat=wmat,
            )
            return {node.out_port: TValue(out.permute(0, 3, 1, 2))}

        (pt, pb), (pl, pr) = pad.pads
        if pt == pb and pl == pr:
            padding = (pt, pl)
        else:
            x = F.pad(x, (pl, pr, pt, pb))
            padding = (0, 0)
        out = F.conv2d(x, w, bias, stride=strides, padding=padding,
                       dilation=dilations)
        return {node.out_port: TValue(apply_act(out, act))}
