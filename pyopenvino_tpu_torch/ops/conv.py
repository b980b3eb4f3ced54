"""Convolution and GroupConvolution: FP32, INT8 weight-only and INT8-FULL.

Counterpart of ``pyopenvino_tpu/ops/conv.py`` (without the TPU-specific
space-to-depth stem rewrite).  ``ref_compute`` is the JAX package's numpy
im2col + einsum.  ``emit`` (``kernel_route`` names the kernel a Convolution
takes on KERNELS):

  * INT8-FULL (a calibrated activation scale s_x and an int8 weight): the
    input is quantized to int8 codes (or arrives stored as int8, its
    storage scale then being s_x), the int32 sum is exact, and the epilogue
    is ``sum · (qscale · s_x)``, then the bias, then the activation:
      - TORCH (the XLA part): the convolution of the codes in float64, every
        partial sum an integer below 2^53, rounded to int32 (float32 cuDNN
        on the codes could pick Winograd or FFT, which are not exact on
        integers, and K·127² passes 2^24);
      - KERNELS (the Pallas part): a stride-1, dilation-1 conv with a
        spatial kernel → ``conv2d_direct``; every other Convolution (1×1,
        the strided 3×3, the 7×7 and 3×3 stems) → ``conv2d_fused`` on int8
        patches → fused_gemm's int8 × int8 variant; both take the cached
        K-major weight matrix; GroupConvolution has no kernel (an XLA conv
        in the JAX package too) and takes the TORCH route;
  * Convolution on the KERNELS backend otherwise, 1×1 conv with co >= 128
    and ci >= 64 (the JAX package's Pallas condition, ops/conv.py:253):
    ``conv2d_fused``, the patches + fused_gemm kernel with bias and
    activation in its epilogue; an int8 weight stays int8 in the cached
    (K, N) matrix and its per-channel scale multiplies the accumulator;
  * every other conv: ``F.conv2d`` (cuDNN on the card, TF32 off — see
    runtime/compiler.py) on ``ctx.weight_for`` (an int8 weight dequantized
    on every call), with the bias passed to the conv and the activation
    applied after it; bfloat16 operands are widened and summed in float32,
    then rounded once (``_float32_sum``, XLA's
    ``preferred_element_type=float32``);
  * every result is in the compute dtype: an int8 × int8 one in
    ``ops/spec.py::int8_out_dtype``'s, rounded once after the float32
    epilogue;
  * GroupConvolution (depthwise in MobileNet-v2): grouped ``F.conv2d`` on
    the (G·Co, Ci, kh, kw) weight, or with ``Config.depthwise_mode =
    "shifted_mac"`` the kh·kw shifted multiply-adds of the JAX package's
    ``_depthwise_shifted_mac``.

Activations arrive as logical NCHW tensors in channels_last memory format,
so ``x.permute(0, 2, 3, 1)`` is the contiguous NHWC tensor that
``conv2d_fused`` takes, and its NHWC result permuted back is again a
channels_last NCHW tensor.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from pyopenvino_tpu_torch.ir import attrs as A
from pyopenvino_tpu_torch.kernels.gemm import apply_act, conv2d_int32, epilogue
from pyopenvino_tpu_torch.ops.padding import conv_padding
from pyopenvino_tpu_torch.ops.spec import (
    Op,
    ShapeResult,
    TValue,
    int8_operand,
    int8_out_dtype,
    register,
)


def _im2col(x: np.ndarray, kh, kw, sh, sw, dh, dw, pads, pad_value=0.0):
    """(N, C, H, W) → (N, C, kh, kw, OH, OW) patch tensor (batched,
    dilated): the JAX package's numpy ``_im2col``."""
    (pt, pb), (pl, pr) = pads
    xp = np.pad(
        x, ((0, 0), (0, 0), (pt, pb), (pl, pr)), constant_values=pad_value
    )
    H, W = xp.shape[2:]
    oh = (H - (dh * (kh - 1) + 1)) // sh + 1
    ow = (W - (dw * (kw - 1) + 1)) // sw + 1
    n, c = x.shape[:2]
    cols = np.empty((n, c, kh, kw, oh, ow), dtype=x.dtype)
    for i in range(kh):
        for j in range(kw):
            i0, j0 = i * dh, j * dw
            cols[:, :, i, j] = xp[
                :, :, i0 : i0 + sh * (oh - 1) + 1 : sh, j0 : j0 + sw * (ow - 1) + 1 : sw
            ]
    return cols


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


def _int8_epilogue(acc, w_scale, bias, act, out_dtype):
    """act(acc · w_scale + bias) over the channel axis of an NCHW int32
    accumulator in float32, each step rounded on its own as in the kernels,
    then one cast to ``out_dtype``.  The result is channels_last, as every
    4-D activation of the port is: a float conv that reads it (SSD's
    depthwise convs and heads keep float weights) then runs the same cuDNN
    algorithm, and sums in the same order, as after the KERNELS route."""
    out = epilogue(acc.permute(0, 2, 3, 1).float(), w_scale, bias, act).permute(0, 3, 1, 2)
    return out.contiguous(memory_format=torch.channels_last).to(out_dtype)


def _float32_sum(x, w, bias, act, conv):
    """A float conv as XLA runs ``preferred_element_type=float32``: the
    operands widened to float32 (exact), the sum, bias and activation in
    float32, then one rounding to the activations' dtype.  In float32 this
    is ``conv`` itself.  On the card, bfloat16 operands may take cuDNN's
    TF32 tensor cores: a bfloat16 value is exact in TF32, so each product
    is exact and the sums stay float32."""
    if x.dtype == torch.float32:
        return apply_act(conv(x, w, bias), act)
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=True):
        out = conv(x.float(), w.float(), None if bias is None else bias.float())
    return apply_act(out, act).to(x.dtype)


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


def kernel_route(w_shape, strides, dilations, int8_acts: bool, int8_weight: bool):
    """The kernel a Convolution launches once per forward on the KERNELS
    backend, named as its launch counter is, or None for the cuDNN route.

    ``int8_acts``: INT8-FULL, the conv runs int8 × int8 (``int8_operand``).
    Then a stride-1, dilation-1 conv with a spatial kernel takes
    ``conv2d_direct`` and every other one ``fused_gemm_i8i8`` (through
    ``conv2d_fused``).  Otherwise a 1×1 conv with co >= 128 and ci >= 64
    takes ``fused_gemm`` (``fused_gemm_i8w`` for an int8 weight).  Under
    ``compute_dtype="bfloat16"`` each route takes its bfloat16 variant."""
    co, ci, kh, kw = w_shape
    if int8_acts:
        return ("conv2d_direct" if strides == (1, 1) and dilations == (1, 1) and kh * kw > 1
                else "fused_gemm_i8i8")
    if kh == kw == 1 and co >= 128 and ci >= 64:
        return "fused_gemm_i8w" if int8_weight else "fused_gemm"
    return None


@register
class Convolution(Op):
    type_name = "Convolution"
    int8_ports = (0,)  # takes int8 codes on the integer path

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        n, _, h, w = in_shapes[0]
        co, _, kh, kw = in_shapes[1]
        pad = conv_padding(node.attrs, (h, w), (kh, kw))
        return ShapeResult({node.out_port: (n, co, pad.out_h, pad.out_w)})

    def ref_compute(self, node, inputs) -> Dict[int, np.ndarray]:
        x, wgt = inputs[0], inputs[1]
        (sh, sw), (dh, dw) = _conv_attrs(node)
        co, ci, kh, kw = wgt.shape
        pad = conv_padding(node.attrs, x.shape[2:], (kh, kw))
        cols = _im2col(x, kh, kw, sh, sw, dh, dw, pad.pads)
        out = np.einsum("nchwij,ochw->noij", cols, wgt, optimize=True)
        return {node.out_port: out.astype(x.dtype)}

    def emit(self, ctx, node, inputs):
        return self.emit_fused(ctx, node, inputs)

    def emit_fused(self, ctx, node, inputs, bias=None, act=None):
        tv_w = inputs[1]
        kh, kw = tv_w.shape[2:]
        strides, dilations = _conv_attrs(node)
        pad = conv_padding(node.attrs, inputs[0].shape[2:], (kh, kw))

        q = int8_operand(ctx, node, inputs[0], tv_w)
        out_dtype = int8_out_dtype(ctx, inputs[0]) if q is not None else None
        if q is not None and not ctx.use_kernels:
            xq, s_x = q
            acc = conv2d_int32(xq, tv_w.arr, strides, dilations, pad.pads)
            w_scale = tv_w.qscale.reshape(-1).float() * s_x
            return {node.out_port: TValue(_int8_epilogue(acc, w_scale, bias, act, out_dtype))}
        route = kernel_route(tv_w.shape, strides, dilations, q is not None,
                             tv_w.qscale is not None) if ctx.use_kernels else None
        if route is not None:
            from pyopenvino_tpu_torch.kernels.conv import (
                conv2d_fused, conv_weight_matrix, conv_weight_matrix_nk,
            )

            # the int8 × int8 routes take their B K-major; the others (K, N)
            wmat = (ctx.derived_weight(node, 1, "gemm_nk", conv_weight_matrix_nk).t()
                    if q is not None
                    else ctx.derived_weight(node, 1, "gemm_kn", conv_weight_matrix))
            if q is not None:
                x_nhwc = q[0].permute(0, 2, 3, 1)
                scale = tv_w.qscale.reshape(-1).float() * q[1]
            else:
                x_nhwc = inputs[0].dequant(ctx.compute_dtype).arr.permute(0, 2, 3, 1)
                scale = tv_w.qscale.reshape(-1) if tv_w.qscale is not None else None
            if route == "conv2d_direct":
                from pyopenvino_tpu_torch.kernels.conv_direct import conv2d_direct

                out = conv2d_direct(x_nhwc.contiguous(), tv_w.arr, scale, bias, act,
                                    pad.pads, wmat=wmat, out_dtype=out_dtype)
            else:
                out = conv2d_fused(x_nhwc, tv_w.arr, scale=scale, bias=bias, act=act,
                                   strides=strides, dilations=dilations, pads=pad.pads,
                                   wmat=wmat, out_dtype=out_dtype)
            return {node.out_port: TValue(out.permute(0, 3, 1, 2))}

        x = inputs[0].dequant(ctx.compute_dtype).arr
        w = ctx.weight_for(node, tv_w)  # OIHW, dequantized if int8
        out = _float32_sum(x, w, bias, act, lambda x, w, b: _conv2d(
            x, w, b, strides, dilations, pad.pads))
        return {node.out_port: TValue(out)}


@register
class GroupConvolution(Op):
    type_name = "GroupConvolution"
    int8_ports = (0,)  # takes int8 codes on the integer path

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        n, _, h, w = in_shapes[0]
        g, co, _, kh, kw = in_shapes[1]
        pad = conv_padding(node.attrs, (h, w), (kh, kw))
        return ShapeResult({node.out_port: (n, g * co, pad.out_h, pad.out_w)})

    def ref_compute(self, node, inputs) -> Dict[int, np.ndarray]:
        x, wgt = inputs[0], inputs[1]
        (sh, sw), (dh, dw) = _conv_attrs(node)
        g, co, ci, kh, kw = wgt.shape
        pad = conv_padding(node.attrs, x.shape[2:], (kh, kw))
        cols = _im2col(x, kh, kw, sh, sw, dh, dw, pad.pads)
        n = x.shape[0]
        cols = cols.reshape(n, g, ci, kh, kw, *cols.shape[-2:])
        out = np.einsum("ngchwij,gochw->ngoij", cols, wgt, optimize=True)
        out = out.reshape(n, g * co, *out.shape[-2:])
        return {node.out_port: out.astype(x.dtype)}

    def emit(self, ctx, node, inputs):
        return self.emit_fused(ctx, node, inputs)

    def emit_fused(self, ctx, node, inputs, bias=None, act=None):
        g, co, ci, kh, kw = inputs[1].shape
        strides, dilations = _conv_attrs(node)
        pad = conv_padding(node.attrs, inputs[0].shape[2:], (kh, kw))

        q = int8_operand(ctx, node, inputs[0], inputs[1])
        if q is not None:  # both backends: the exact float64 route
            xq, s_x = q
            w_scale = inputs[1].qscale.reshape(-1).float() * s_x
            acc = conv2d_int32(xq, inputs[1].arr.reshape(g * co, ci, kh, kw), strides,
                               dilations, pad.pads, groups=g)
            return {node.out_port: TValue(_int8_epilogue(
                acc, w_scale, bias, act, int8_out_dtype(ctx, inputs[0])))}

        x = inputs[0].dequant(ctx.compute_dtype).arr
        w = ctx.weight_for(node, inputs[1])  # (G, Co, Ci, kh, kw)
        if co == 1 and ci == 1 and ctx.depthwise_mode == "shifted_mac":
            def conv(x, w, b):
                out = _depthwise_shifted_mac(x, w, strides, dilations, pad.pads)
                return out if b is None else out + b.reshape(1, -1, 1, 1)
        else:
            def conv(x, w, b):
                return _conv2d(x, w.reshape(g * co, ci, kh, kw), b, strides,
                               dilations, pad.pads, groups=g)
        return {node.out_port: TValue(_float32_sum(x, w, bias, act, conv))}
