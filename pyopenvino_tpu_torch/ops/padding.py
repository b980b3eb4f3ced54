"""Spatial padding and output-shape rules of conv and pool ops.

Counterpart of ``pyopenvino_tpu/ops/padding.py`` (OpenVINO opset1
semantics):

auto_pad ∈ {explicit, valid, same_upper, same_lower}
rounding_type ∈ {floor, ceil}   (ceil only meaningful for explicit pads)

In ceil mode the end padding is extended so that a dense windowed
implementation sees enough input; pool emitters mask that extension out of
both the max and the average divisor.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

from pyopenvino_tpu_torch.ir import attrs as A


@dataclasses.dataclass(frozen=True)
class Padding2D:
    """Resolved padding for one 2-D spatial op."""

    out_h: int
    out_w: int
    pad_top: int
    pad_bottom: int
    pad_left: int
    pad_right: int

    @property
    def pads(self) -> Tuple[Tuple[int, int], Tuple[int, int]]:
        return ((self.pad_top, self.pad_bottom), (self.pad_left, self.pad_right))


def _axis(
    in_size: int,
    kernel: int,
    stride: int,
    dilation: int,
    pad_begin: int,
    pad_end: int,
    auto_pad: str,
    rounding: str,
) -> Tuple[int, int, int]:
    """Return (out, pad_begin, pad_end) for one spatial axis."""
    eff_k = dilation * (kernel - 1) + 1
    if auto_pad in ("same_upper", "same_lower"):
        out = -(-in_size // stride)  # ceil(in/stride)
        total = max(0, (out - 1) * stride + eff_k - in_size)
        if auto_pad == "same_upper":
            pb = total // 2
            pe = total - pb
        else:
            pe = total // 2
            pb = total - pe
        return out, pb, pe
    if auto_pad == "valid":
        pad_begin = pad_end = 0
    numer = in_size + pad_begin + pad_end - eff_k
    if rounding == "ceil":
        out = -(-numer // stride) + 1
        needed = (out - 1) * stride + eff_k - (in_size + pad_begin)
        pad_end = max(pad_end, needed)
    else:
        out = numer // stride + 1
    return out, pad_begin, pad_end


def resolve_padding_2d(
    in_hw: Sequence[int],
    kernel_hw: Sequence[int],
    strides: Sequence[int],
    dilations: Sequence[int],
    pads_begin: Sequence[int],
    pads_end: Sequence[int],
    auto_pad: str = "explicit",
    rounding: str = "floor",
) -> Padding2D:
    oh, pt, pb = _axis(
        in_hw[0], kernel_hw[0], strides[0], dilations[0],
        pads_begin[0], pads_end[0], auto_pad, rounding,
    )
    ow, pl, pr = _axis(
        in_hw[1], kernel_hw[1], strides[1], dilations[1],
        pads_begin[1], pads_end[1], auto_pad, rounding,
    )
    return Padding2D(oh, ow, pt, pb, pl, pr)


def conv_padding(node_attrs, in_hw, kernel_hw) -> Padding2D:
    """Padding resolution for Convolution attrs."""
    return resolve_padding_2d(
        in_hw,
        kernel_hw,
        A.get_int_tuple(node_attrs, "strides", (1, 1)),
        A.get_int_tuple(node_attrs, "dilations", (1, 1)),
        A.get_int_tuple(node_attrs, "pads_begin", (0, 0)),
        A.get_int_tuple(node_attrs, "pads_end", (0, 0)),
        A.get_str(node_attrs, "auto_pad", "explicit"),
        A.get_str(node_attrs, "rounding_type", "floor"),
    )


def pool_padding(node_attrs, in_hw) -> Padding2D:
    """Padding resolution for MaxPool/AvgPool attrs (kernel is an attr)."""
    kernel_hw = A.get_int_tuple(node_attrs, "kernel")
    return resolve_padding_2d(
        in_hw,
        kernel_hw,
        A.get_int_tuple(node_attrs, "strides", (1, 1)),
        (1, 1),
        A.get_int_tuple(node_attrs, "pads_begin", (0, 0)),
        A.get_int_tuple(node_attrs, "pads_end", (0, 0)),
        A.get_str(node_attrs, "auto_pad", "explicit"),
        A.get_str(node_attrs, "rounding_type", "floor"),
    )


def pool_torch_padding(pads, kernel_hw):
    """``padding`` argument for ``F.max_pool2d``/``F.avg_pool2d`` when
    those can take ``pads`` directly: symmetric on each axis and at most
    half the kernel.  None when the caller must pad explicitly first."""
    (pt, pb), (pl, pr) = pads
    if pt == pb and pl == pr and 2 * pt <= kernel_hw[0] and 2 * pl <= kernel_hw[1]:
        return (pt, pl)
    return None
