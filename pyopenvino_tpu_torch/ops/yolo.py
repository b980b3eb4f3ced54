"""RegionYolo (the YOLO v2/v3 region-head activation, opset1) and ReorgYolo
(the YOLO-v2 passthrough reorg, opset2).

Counterpart of ``pyopenvino_tpu/ops/yolo.py``, whose numpy
``region_yolo_ref`` and ReorgYolo ``ref_compute`` the port repeats.

RegionYolo, on (N, C, H, W) with C = na·(coords + 1 + classes), where na is
``num`` under ``do_softmax`` and len(``mask``) otherwise; per anchor block:
logistic on x, y (channels 0, 1) and the objectness (channel ``coords``);
the class channels a softmax over the block's class axis (axis 2 of the
rank-5 view) under ``do_softmax`` (YOLO v2), else logistic (YOLO v3); w, h
pass through.  Under ``do_softmax`` the output flattens the dims [axis,
end_axis] (YOLO v2's (N, C·H·W) region blob), else it keeps NCHW.  The class
softmax is ``ops/elementwise.py::softmax``, never the softmax_rows kernel,
in either package: it is not a row softmax of a 2-D tensor; the logistic is
``ops/elementwise.py::sigmoid``.  ``anchors`` is
an attribute for the host-side decoder (metrics.py ``decode_region_yolo``).

ReorgYolo: darknet's reorg as yolov2 ships it, run "backward" (its
``reorg_cpu`` with forward = 0), which is what OpenVINO implements and NOT a
SpaceToDepth: the input buffer read as (N, C/s², H·s, W·s) and
``out[n, c, h, w] = src[n, c % oc, h·s + (c//oc)//s, w·s + (c//oc)%s]``
over the input dims, the result buffer read flat as (N, C·s², H/s, W/s).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from pyopenvino_tpu_torch.ir import attrs as A
from pyopenvino_tpu_torch.ops.elementwise import sigmoid, softmax
from pyopenvino_tpu_torch.ops.extended import _norm_axis
from pyopenvino_tpu_torch.ops.shape_ops import reshaped
from pyopenvino_tpu_torch.ops.spec import Op, ShapeResult, TValue, register


def _params(node):
    a = node.attrs
    return dict(
        coords=A.get_int(a, "coords", 4),
        classes=A.get_int(a, "classes", 80),
        num=A.get_int(a, "num", 5),
        do_softmax=A.get_bool(a, "do_softmax", True),
        mask=A.get_int_tuple(a, "mask", ()),
        axis=A.get_int(a, "axis", 1),
        end_axis=A.get_int(a, "end_axis", 3),
    )


def _flatten_shape(shape, p):
    """The output shape after the do_softmax [axis, end_axis] flatten."""
    axis = _norm_axis(p["axis"], len(shape), "RegionYolo")
    end = _norm_axis(p["end_axis"], len(shape), "RegionYolo")
    return (tuple(shape[:axis]) + (int(np.prod(shape[axis:end + 1])),)
            + tuple(shape[end + 1:]))


def _n_anchors(p) -> int:
    if p["do_softmax"] or not p["mask"]:
        return p["num"]
    return len(p["mask"])


def _check_channels(c, p, name):
    na = _n_anchors(p)
    block = p["coords"] + 1 + p["classes"]
    if c != na * block:
        raise ValueError(
            f"RegionYolo {name}: C={c} != anchors {na} × "
            f"(coords {p['coords']} + 1 + classes {p['classes']})")
    return na, block


def region_yolo_ref(x: np.ndarray, p) -> np.ndarray:
    """Numpy reference activation (reshape and flatten applied)."""
    n, c, h, w = x.shape
    na, block = _check_channels(c, p, "")
    xb = x.reshape(n, na, block, h, w).astype(np.float64)
    out = xb.copy()
    sig = lambda v: 1.0 / (1.0 + np.exp(-v))  # noqa: E731
    out[:, :, 0] = sig(xb[:, :, 0])
    out[:, :, 1] = sig(xb[:, :, 1])
    out[:, :, p["coords"]] = sig(xb[:, :, p["coords"]])
    cls = xb[:, :, p["coords"] + 1:]
    if p["do_softmax"]:
        m = cls.max(axis=2, keepdims=True)
        e = np.exp(cls - m)
        out[:, :, p["coords"] + 1:] = e / e.sum(axis=2, keepdims=True)
    else:
        out[:, :, p["coords"] + 1:] = sig(cls)
    out = out.reshape(n, c, h, w).astype(x.dtype)
    if p["do_softmax"]:
        out = out.reshape(_flatten_shape(out.shape, p))
    return out


@register
class RegionYolo(Op):
    type_name = "RegionYolo"

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        p = _params(node)
        shape = in_shapes[0]
        _check_channels(shape[1], p, node.name)
        if p["do_softmax"]:
            shape = _flatten_shape(shape, p)
        return ShapeResult({node.out_port: tuple(shape)})

    def ref_compute(self, node, inputs) -> Dict[int, np.ndarray]:
        return {node.out_port: region_yolo_ref(inputs[0], _params(node))}

    def emit(self, ctx, node, inputs) -> Dict[int, TValue]:
        p = _params(node)
        x = inputs[0].arr
        n, c, h, w = x.shape
        na, block = _check_channels(c, p, node.name)
        xb = x.reshape(n, na, block, h, w)
        coords = p["coords"]
        cls = xb[:, :, coords + 1:]
        out = torch.cat([
            sigmoid(xb[:, :, :2]),
            xb[:, :, 2:coords],
            sigmoid(xb[:, :, coords:coords + 1]),
            softmax(cls, 2) if p["do_softmax"] else sigmoid(cls),
        ], dim=2)
        if p["do_softmax"]:
            return {node.out_port: TValue(out.reshape(_flatten_shape((n, c, h, w), p)))}
        return {node.out_port: TValue(reshaped(out, (n, c, h, w)))}


def _reorg(x, s: int):
    """The darknet reorg of an (N, C, H, W) tensor, vectorized: the input
    read as (n, c/s², h, s, w, s), its axes moved to (n, dy, dx, c/s², h,
    w), the result read flat as (N, C·s², H/s, W/s)."""
    n, c, h, w = x.shape
    v = x.reshape(n, c // (s * s), h, s, w, s).permute(0, 3, 5, 1, 2, 4)
    return reshaped(v, (n, c * s * s, h // s, w // s))


@register
class ReorgYolo(Op):
    """(N, C, H, W) → (N, C·s², H/s, W/s) with darknet's channel interleave
    (a SpaceToDepth gives another channel order, and silently wrong fused
    features)."""

    type_name = "ReorgYolo"

    @staticmethod
    def _stride(node) -> int:
        s = A.get_int(node.attrs, "stride", 2)
        if s < 1:
            raise ValueError(f"ReorgYolo: bad stride {s}")
        return s

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        n, c, h, w = in_shapes[0]
        s = self._stride(node)
        if c % (s * s) or h % s or w % s:
            raise ValueError(
                f"ReorgYolo {node.name}: shape {(n, c, h, w)} not divisible by stride {s} "
                f"(C by s², H/W by s)")
        return ShapeResult({node.out_port: (n, c * s * s, h // s, w // s)})

    def ref_compute(self, node, inputs) -> Dict[int, np.ndarray]:
        # the kernel's per-channel index loop, literally (the specification);
        # emit runs the vectorized _reorg, and the tests hold the two together
        s = self._stride(node)
        x = inputs[0]
        n, c, h, w = x.shape
        oc = c // (s * s)
        src = x.reshape(n, oc, h * s, w * s)
        out = np.empty_like(x)
        for cc in range(c):
            off, c2 = cc // oc, cc % oc
            out[:, cc] = src[:, c2, off // s::s, off % s::s]
        return {node.out_port: out.reshape(n, c * s * s, h // s, w // s)}

    def emit(self, ctx, node, inputs) -> Dict[int, TValue]:
        return {node.out_port: TValue(_reorg(inputs[0].arr, self._stride(node)))}
