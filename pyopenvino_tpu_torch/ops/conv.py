"""Convolution and GroupConvolution, FP32 and INT8 weight-only.

Counterpart of ``pyopenvino_tpu/ops/conv.py`` (without its INT8-FULL
branches and the TPU-specific space-to-depth stem rewrite):

  * Convolution on the KERNELS backend, 1×1 conv with co >= 128 and
    ci >= 64 (the JAX package's Pallas condition, ops/conv.py:253):
    ``conv2d_fused``, the patches + fused_gemm kernel with bias and
    activation in its epilogue; an int8 weight stays int8 in the cached
    (K, N) matrix and its per-channel scale multiplies the accumulator;
  * every other conv: ``F.conv2d`` (cuDNN on the card, TF32 off — see
    runtime/compiler.py) on ``ctx.weight_for`` (an int8 weight dequantized
    on every call), with the bias passed to the conv and the activation
    applied after it;
  * GroupConvolution (depthwise in MobileNet-v2): grouped ``F.conv2d`` on
    the (G·Co, Ci, kh, kw) weight, or with ``Config.depthwise_mode =
    "shifted_mac"`` the kh·kw shifted multiply-adds of the JAX package's
    ``_depthwise_shifted_mac``; the Pallas backend has no kernel for it
    either.

Activations arrive as logical NCHW tensors in channels_last memory format,
so ``x.permute(0, 2, 3, 1)`` is the contiguous NHWC tensor that
``conv2d_fused`` takes, and its NHWC result permuted back is again a
channels_last NCHW tensor.
"""

from __future__ import annotations

import torch.nn.functional as F

from pyopenvino_tpu_torch.ir import attrs as A
from pyopenvino_tpu_torch.kernels.gemm import apply_act
from pyopenvino_tpu_torch.ops.padding import conv_padding
from pyopenvino_tpu_torch.ops.spec import Op, ShapeResult, TValue, register


def _conv_attrs(node):
    return (
        A.get_int_tuple(node.attrs, "strides", (1, 1)),
        A.get_int_tuple(node.attrs, "dilations", (1, 1)),
    )


def _conv2d(x, w, bias, strides, dilations, pads, groups=1):
    """``F.conv2d`` with explicit (top, bottom), (left, right) pads."""
    (pt, pb), (pl, pr) = pads
    if pt == pb and pl == pr:
        padding = (pt, pl)
    else:
        x = F.pad(x, (pl, pr, pt, pb))
        padding = (0, 0)
    return F.conv2d(x, w, bias, stride=strides, padding=padding,
                    dilation=dilations, groups=groups)


def _depthwise_shifted_mac(x, w, strides, dilations, pads):
    """Depthwise conv as kh·kw shifted multiply-adds.

    x: (N, C, H, W); w: (C, 1, 1, kh, kw).  out[n,c,y,x] =
    Σ_{i,j} xpad[n, c, y·sh+i·dh, x·sw+j·dw] · w[c,0,0,i,j], each (i, j)
    term a strided slice times a (1, C, 1, 1) vector, summed in the JAX
    package's order."""
    (sh, sw), (dh, dw) = strides, dilations
    (pt, pb), (pl, pr) = pads
    c, _, _, kh, kw = w.shape
    if pt or pb or pl or pr:
        x = F.pad(x, (pl, pr, pt, pb))
    h, wd = x.shape[2:]
    oh = (h - (dh * (kh - 1) + 1)) // sh + 1
    ow = (wd - (dw * (kw - 1) + 1)) // sw + 1
    taps = w.reshape(c, kh, kw)
    acc = None
    for i in range(kh):
        for j in range(kw):
            i0, j0 = i * dh, j * dw
            sl = x[:, :, i0 : i0 + sh * (oh - 1) + 1 : sh,
                   j0 : j0 + sw * (ow - 1) + 1 : sw]
            term = sl * taps[:, i, j].reshape(1, c, 1, 1)
            acc = term if acc is None else acc + term
    return acc


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
        tv_w = inputs[1]
        co, ci, kh, kw = tv_w.shape
        strides, dilations = _conv_attrs(node)
        pad = conv_padding(node.attrs, tuple(x.shape[2:]), (kh, kw))

        if ctx.use_kernels and kh == kw == 1 and co >= 128 and ci >= 64:
            from pyopenvino_tpu_torch.kernels.conv import (
                conv2d_fused, conv_weight_matrix,
            )

            wmat = ctx.derived_weight(node, 1, "gemm_kn", conv_weight_matrix)
            scale = tv_w.qscale.reshape(-1) if tv_w.qscale is not None else None
            out = conv2d_fused(
                x.permute(0, 2, 3, 1), tv_w.arr, scale=scale, bias=bias,
                act=act, strides=strides, dilations=dilations, pads=pad.pads,
                wmat=wmat,
            )
            return {node.out_port: TValue(out.permute(0, 3, 1, 2))}

        w = ctx.weight_for(node, tv_w)  # OIHW, dequantized if int8
        out = _conv2d(x, w, bias, strides, dilations, pad.pads)
        return {node.out_port: TValue(apply_act(out, act))}


@register
class GroupConvolution(Op):
    type_name = "GroupConvolution"

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        n, _, h, w = in_shapes[0]
        g, co, _, kh, kw = in_shapes[1]
        pad = conv_padding(node.attrs, (h, w), (kh, kw))
        return ShapeResult({node.out_port: (n, g * co, pad.out_h, pad.out_w)})

    def emit(self, ctx, node, inputs):
        return self.emit_fused(ctx, node, inputs)

    def emit_fused(self, ctx, node, inputs, bias=None, act=None):
        x = inputs[0].arr
        g, co, ci, kh, kw = inputs[1].shape
        strides, dilations = _conv_attrs(node)
        pad = conv_padding(node.attrs, tuple(x.shape[2:]), (kh, kw))
        w = ctx.weight_for(node, inputs[1])  # (G, Co, Ci, kh, kw)

        if co == 1 and ci == 1 and ctx.depthwise_mode == "shifted_mac":
            out = _depthwise_shifted_mac(x, w, strides, dilations, pad.pads)
            if bias is not None:
                out = out + bias.reshape(1, -1, 1, 1)
        else:
            out = _conv2d(x, w.reshape(g * co, ci, kh, kw), bias, strides,
                          dilations, pad.pads, groups=g)
        return {node.out_port: TValue(apply_act(out, act))}
