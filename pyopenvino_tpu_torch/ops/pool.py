"""MaxPool and AvgPool.

Counterpart of ``pyopenvino_tpu/ops/pool.py`` (``_pool_emit``).  Padding
follows ops/padding.py: MaxPool pads with -inf; AvgPool with exclude-pad
divides each window by the number of real input elements in it, and ceil
rounding's extended end padding never counts.

``F.max_pool2d``/``F.avg_pool2d`` take only symmetric padding of at most
half the kernel.  ResNet-18's pools (3×3/s2 pads 1,1 floor; 7×7 global
average) fit that, so they call PyTorch directly.  Any other padding is
applied with an explicit ``F.pad`` first: -inf for max; for average, zeros
and a division by a window-count map.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pyopenvino_tpu_torch.ir import attrs as A
from pyopenvino_tpu_torch.ops.padding import pool_padding, pool_torch_padding
from pyopenvino_tpu_torch.ops.spec import Op, ShapeResult, TValue, register


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

    def emit(self, ctx, node, inputs):
        return {node.out_port: TValue(_pool_emit(node, inputs[0].arr, "max", False))}


@register
class AvgPool(_Pool):
    type_name = "AvgPool"

    def emit(self, ctx, node, inputs):
        excl = A.get_bool(node.attrs, "exclude-pad", True)
        return {node.out_port: TValue(_pool_emit(node, inputs[0].arr, "avg", excl))}
