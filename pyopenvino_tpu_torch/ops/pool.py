"""MaxPool and AvgPool.

Counterpart of ``pyopenvino_tpu/ops/pool.py``: ``ref_compute`` is its numpy
``_pool_ref``, ``emit`` its ``_pool_emit``.  Under INT8-FULL a MaxPool whose
input is stored as int8 carries it exactly: max commutes with the positive
dequant scale, so the codes are pooled (widened to float32, which holds them
exactly, since PyTorch has no int8 max-pool on CUDA) and stay int8 at the
same scale.  Padding
follows ops/padding.py: MaxPool pads with -inf; AvgPool with exclude-pad
divides each window by the number of real input elements in it, and ceil
rounding's extended end padding never counts.

``F.max_pool2d``/``F.avg_pool2d`` take only symmetric padding of at most
half the kernel.  ResNet-18's pools (3×3/s2 pads 1,1 floor; 7×7 global
average) fit that, so they call PyTorch directly.  Any other padding is
applied with an explicit ``F.pad`` first: -inf for max; for average, zeros
and a division by a window-count map.

A bfloat16 average pool sums as the JAX package's ``lax.reduce_window``
does in bfloat16: the window's values added one at a time in row-major
window order, each partial sum rounded to bfloat16, then divided in
bfloat16 (``_window_sum_bf16``).  Summing in float32 instead lands nearer
to the float32 result than the reference does (ResNet-18's 7×7 global
pool: about 4e-3 of the mean |output| from float32 against the JAX
package's 6e-3, on the CPU).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from pyopenvino_tpu_torch.ir import attrs as A
from pyopenvino_tpu_torch.ops.padding import pool_padding, pool_torch_padding
from pyopenvino_tpu_torch.ops.spec import Op, ShapeResult, TValue, register


def _pool_ref(node, x: np.ndarray, mode: str, exclude_pad: bool) -> np.ndarray:
    kh, kw = A.get_int_tuple(node.attrs, "kernel")
    sh, sw = A.get_int_tuple(node.attrs, "strides", (1, 1))
    pad = pool_padding(node.attrs, x.shape[2:])
    neutral = -np.inf if mode == "max" else 0.0
    xp = np.pad(x, ((0, 0), (0, 0), *pad.pads), constant_values=neutral)
    # validity mask distinguishes real input from padding (for avg divisor)
    valid = np.pad(
        np.ones(x.shape[2:], dtype=np.float32), pad.pads, constant_values=0.0
    )
    n, c = x.shape[:2]
    out = np.empty((n, c, pad.out_h, pad.out_w), dtype=x.dtype)
    for i in range(pad.out_h):
        for j in range(pad.out_w):
            win = xp[:, :, i * sh : i * sh + kh, j * sw : j * sw + kw]
            vwin = valid[i * sh : i * sh + kh, j * sw : j * sw + kw]
            if mode == "max":
                out[:, :, i, j] = win.max(axis=(2, 3))
            else:
                s = win.sum(axis=(2, 3))
                count = vwin.sum() if exclude_pad else float(kh * kw)
                out[:, :, i, j] = s / count
    return out


def _window_sum_bf16(x, kernel, strides, pads):
    """Σ over each pooling window of the zero-padded ``x``, in ``x``'s
    dtype, one window position at a time in row-major order (each partial
    sum rounded, as a bfloat16 ``lax.reduce_window`` add is)."""
    (kh, kw), (sh, sw), ((pt, pb), (pl, pr)) = kernel, strides, pads
    xp = F.pad(x, (pl, pr, pt, pb))
    oh = (xp.shape[2] - kh) // sh + 1
    ow = (xp.shape[3] - kw) // sw + 1
    acc = None
    for i in range(kh):
        for j in range(kw):
            sl = xp[:, :, i:i + sh * (oh - 1) + 1:sh, j:j + sw * (ow - 1) + 1:sw]
            acc = sl if acc is None else acc + sl
    return acc


def _pool_emit(node, x, mode: str, exclude_pad: bool):
    kernel = A.get_int_tuple(node.attrs, "kernel")
    strides = A.get_int_tuple(node.attrs, "strides", (1, 1))
    pad = pool_padding(node.attrs, tuple(x.shape[2:]))
    direct = pool_torch_padding(pad.pads, kernel)
    (pt, pb), (pl, pr) = pad.pads
    if mode == "max":
        if direct is None:
            x = F.pad(x, (pl, pr, pt, pb), value=float("-inf"))
            direct = (0, 0)
        return F.max_pool2d(x, kernel, strides, padding=direct)
    if x.dtype == torch.bfloat16:
        sums = _window_sum_bf16(x, kernel, strides, pad.pads)
        if not exclude_pad:
            return sums / float(kernel[0] * kernel[1])
        ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype, device=x.device)
        return sums / _window_sum_bf16(ones, kernel, strides, pad.pads)
    if direct is not None:
        return F.avg_pool2d(x, kernel, strides, padding=direct,
                            count_include_pad=not exclude_pad)
    area = float(kernel[0] * kernel[1])
    sums = F.avg_pool2d(F.pad(x, (pl, pr, pt, pb)), kernel, strides) * area
    if not exclude_pad:
        return sums / area
    ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype, device=x.device)
    counts = F.avg_pool2d(F.pad(ones, (pl, pr, pt, pb)), kernel, strides) * area
    return sums / counts


class _Pool(Op):
    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        n, c, h, w = in_shapes[0]
        pad = pool_padding(node.attrs, (h, w))
        return ShapeResult({node.out_port: (n, c, pad.out_h, pad.out_w)})


@register
class MaxPool(_Pool):
    type_name = "MaxPool"
    int8_ports = (0,)  # exact int8 carry

    def ref_compute(self, node, inputs) -> Dict[int, np.ndarray]:
        return {node.out_port: _pool_ref(node, inputs[0], "max", False)}

    def emit(self, ctx, node, inputs):
        tv = inputs[0]
        if tv.act_scale is not None:
            out = _pool_emit(node, tv.arr.float(), "max", False).to(torch.int8)
            return {node.out_port: TValue(out, act_scale=tv.act_scale)}
        return {node.out_port: TValue(_pool_emit(node, tv.arr, "max", False))}


@register
class AvgPool(_Pool):
    type_name = "AvgPool"

    def ref_compute(self, node, inputs) -> Dict[int, np.ndarray]:
        excl = A.get_bool(node.attrs, "exclude-pad", True)
        return {node.out_port: _pool_ref(node, inputs[0], "avg", excl)}

    def emit(self, ctx, node, inputs):
        excl = A.get_bool(node.attrs, "exclude-pad", True)
        return {node.out_port: TValue(_pool_emit(node, inputs[0].arr, "avg", excl))}
