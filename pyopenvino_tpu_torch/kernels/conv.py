"""Convolution as patch extraction + the fused_gemm kernel.

Counterpart of ``pyopenvino_tpu/kernels/conv.py`` (``extract_patches`` and
``conv2d_fused``).  This is a Python wrapper with no kernel of its own: the
patches are formed with tensor slicing and the product, bias and activation
run in one launch of fused_gemm (kernels/gemm.py).

For a 1×1 convolution with stride 1 the patch matrix is the NHWC input
itself, a view.  With stride 2 (ResNet-18's projection shortcuts) the
sliced input ``x[:, ::2, ::2, :]`` steps 2·C between neighbouring pixels of
a row and 2·W·C between rows, which no single row stride (``lda``) can
express, so the wrapper copies it with ``.contiguous()`` — a quarter of the
input — and hands the kernel a dense (N·OH·OW, Ci) matrix.

An int8 weight (INT8 weight-only) stays int8 in its (K, N) matrix, and its
per-output-channel scale goes to the kernel's epilogue.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from pyopenvino_tpu_torch.kernels.gemm import fused_gemm


def extract_patches(x, kh, kw, sh, sw, dh, dw, pads):
    """(N, H, W, C) → ((N, OH, OW, kh*kw*C) patches, oh, ow).

    Patch features are ordered (kh, kw, C), matching an OIHW weight taken
    through ``conv_weight_matrix``."""
    (pt, pb), (pl, pr) = pads
    if pt or pb or pl or pr:
        x = F.pad(x, (0, 0, pl, pr, pt, pb))
    h, w = x.shape[1:3]
    oh = (h - (dh * (kh - 1) + 1)) // sh + 1
    ow = (w - (dw * (kw - 1) + 1)) // sw + 1
    if kh == kw == 1:
        return x[:, : sh * (oh - 1) + 1 : sh, : sw * (ow - 1) + 1 : sw, :], oh, ow
    parts = []
    for i in range(kh):
        for j in range(kw):
            i0, j0 = i * dh, j * dw
            parts.append(
                x[:, i0 : i0 + sh * (oh - 1) + 1 : sh,
                  j0 : j0 + sw * (ow - 1) + 1 : sw, :]
            )
    return torch.cat(parts, dim=-1), oh, ow


def conv_weight_matrix(w):
    """OIHW weight → the (kh·kw·Ci, Co) row-major GEMM operand, in the
    weight's dtype (float32 or int8)."""
    co, ci, kh, kw = w.shape
    return w.permute(2, 3, 1, 0).reshape(kh * kw * ci, co).contiguous()


def conv2d_fused(
    x,                      # (N, H, W, C) activations, channels-last
    w,                      # (O, I, Kh, Kw) weights, float32 or int8
    scale=None,             # (O,) per-output-channel scales (int8 w: required)
    bias=None,              # (O,) bias, fused into the epilogue
    act: Optional[tuple] = None,   # None | ("relu",0,0) | ("clamp",lo,hi)
    strides: Tuple[int, int] = (1, 1),
    dilations: Tuple[int, int] = (1, 1),
    pads=((0, 0), (0, 0)),
    wmat=None,              # conv_weight_matrix(w), when the caller caches it
):
    """Returns (N, OH, OW, O), contiguous."""
    n = x.shape[0]
    co, ci, kh, kw = w.shape
    (sh, sw), (dh, dw) = strides, dilations
    patches, oh, ow = extract_patches(x, kh, kw, sh, sw, dh, dw, pads)
    a = patches.contiguous().view(n * oh * ow, kh * kw * ci)
    if wmat is None:
        wmat = conv_weight_matrix(w)
    out = fused_gemm(a, wmat, scale=scale, bias=bias, act=act)
    return out.view(n, oh, ow, co)
