"""ROIAlign (opset3), the pooling of two-stage detectors (Faster and Mask
R-CNN: Proposal → ROIAlign → the box head).

Counterpart of ``pyopenvino_tpu/ops/roi.py``.  R rois, each pooled to a
static ``pooled_h × pooled_w`` grid of bins, each bin the average (or the
largest) of ``sampling_ratio²`` bilinear samples at the bin's interior
half-offsets; roi corners [x1, y1, x2, y2] scale by ``spatial_scale``.  A
sample beyond [-1, size] contributes zero (the Caffe2/OpenVINO convention),
an in-range one clamps to the border.  ``sampling_ratio`` must be at least
1: the adaptive 0 sizes the grid per roi at run time.

``ref_compute`` is the JAX package's numpy code.  ``emit`` is plain PyTorch
on the device tensor, as the JAX package's is XLA (no TPU kernel): float32
sample points in the JAX emit's order of operations, the four corners of
every sample gathered as C-vectors from the NHWC data, rois taken in chunks
(``_CHUNK_ELEMS`` elements a corner) so that a large batch of rois never
holds all its samples at once; the result is cast back to the data's
dtype.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from pyopenvino_tpu_torch.ir import attrs as A
from pyopenvino_tpu_torch.ops.spec import Op, ShapeResult, TValue, register

# elements of one gathered corner in one chunk of rois (256 MiB in float32)
_CHUNK_ELEMS = 1 << 26


def _params(node):
    a = node.attrs
    p = dict(
        pooled_h=A.get_int(a, "pooled_h"),
        pooled_w=A.get_int(a, "pooled_w"),
        sampling_ratio=A.get_int(a, "sampling_ratio", 1),
        spatial_scale=A.get_float(a, "spatial_scale", 1.0),
        mode=A.get_str(a, "mode", "avg"),
    )
    if p["sampling_ratio"] < 1:
        raise NotImplementedError(
            "ROIAlign sampling_ratio=0 (adaptive per-roi grids) has no "
            "static-shape compilation — set an explicit ratio")
    if p["mode"] not in ("avg", "max"):
        raise ValueError(f"ROIAlign: unknown mode {p['mode']!r}")
    return p


def _sample_points(roi, p):
    """Sample coordinates of one roi (numpy), or of a (R, 4) tensor of rois
    (torch, float32): ys (…, PH·sr) and xs (…, PW·sr)."""
    ph, pw, sr = p["pooled_h"], p["pooled_w"], p["sampling_ratio"]
    if isinstance(roi, torch.Tensor):
        x1, y1, x2, y2 = (roi[:, k:k + 1] for k in range(4))
        iy = torch.arange(ph * sr, device=roi.device)
        ix = torch.arange(pw * sr, device=roi.device)
        cell = (lambda i: (i // sr).float(), lambda i: (i % sr).float() + 0.5)
    else:
        x1, y1, x2, y2 = roi[0], roi[1], roi[2], roi[3]
        iy, ix = np.arange(ph * sr), np.arange(pw * sr)
        cell = (lambda i: i // sr, lambda i: (i % sr) + 0.5)
    rh = (y2 - y1) * p["spatial_scale"]
    rw = (x2 - x1) * p["spatial_scale"]
    bin_h, bin_w = rh / ph, rw / pw
    ys = y1 * p["spatial_scale"] + cell[0](iy) * bin_h + cell[1](iy) * (bin_h / sr)
    xs = x1 * p["spatial_scale"] + cell[0](ix) * bin_w + cell[1](ix) * (bin_w / sr)
    return ys, xs


def _bilinear_np(img, ys, xs):
    """img (C, H, W), ys (A,), xs (B,) → (C, A, B) bilinear samples, zero
    beyond [-1, size], clamped to the border inside it."""
    c, h, w = img.shape
    valid = ((ys >= -1.0) & (ys <= h))[:, None] & ((xs >= -1.0) & (xs <= w))[None, :]
    y = np.clip(ys, 0, h - 1)
    x = np.clip(xs, 0, w - 1)
    y0 = np.floor(y).astype(np.int64)
    x0 = np.floor(x).astype(np.int64)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (y - y0)[None, :, None]
    wx = (x - x0)[None, None, :]
    top = (1 - wx) * img[:, y0][:, :, x0] + wx * img[:, y0][:, :, x1]
    bot = (1 - wx) * img[:, y1][:, :, x0] + wx * img[:, y1][:, :, x1]
    return ((1 - wy) * top + wy * bot) * valid[None]


def roi_align_ref(data, rois, batch_idx, p) -> np.ndarray:
    """(N, C, H, W), (R, 4), (R,) → (R, C, pooled_h, pooled_w)."""
    ph, pw, sr = p["pooled_h"], p["pooled_w"], p["sampling_ratio"]
    out = np.empty((len(rois), data.shape[1], ph, pw), dtype=np.float32)
    for r in range(len(rois)):
        ys, xs = _sample_points(rois[r].astype(np.float64), p)
        s = _bilinear_np(data[int(batch_idx[r])].astype(np.float64), ys, xs)
        s = s.reshape(data.shape[1], ph, sr, pw, sr)
        out[r] = s.mean(axis=(2, 4)) if p["mode"] == "avg" else s.max(axis=(2, 4))
    return out.astype(data.dtype)


def roi_align_torch(data, rois, bidx, p) -> torch.Tensor:
    """data (N, C, H, W) float32, rois (R, 4) float32, bidx (R,) int64 →
    (R, C, pooled_h, pooled_w) float32."""
    n, c, h, w = data.shape
    ph, pw, sr = p["pooled_h"], p["pooled_w"], p["sampling_ratio"]
    nhwc = data.permute(0, 2, 3, 1)
    chunk = max(1, _CHUNK_ELEMS // (c * ph * sr * pw * sr))
    outs = []
    for r0 in range(0, rois.shape[0], chunk):
        ys, xs = _sample_points(rois[r0:r0 + chunk], p)      # (r, PH·sr), (r, PW·sr)
        b = bidx[r0:r0 + chunk, None, None]
        valid = (((ys >= -1.0) & (ys <= h))[:, :, None]
                 & ((xs >= -1.0) & (xs <= w))[:, None, :])
        y = ys.clamp(0, h - 1)
        x = xs.clamp(0, w - 1)
        y0 = torch.floor(y).long()
        x0 = torch.floor(x).long()
        y1 = torch.clamp(y0 + 1, max=h - 1)
        x1 = torch.clamp(x0 + 1, max=w - 1)
        wy = (y - y0)[:, :, None, None]
        wx = (x - x0)[:, None, :, None]

        def g(yy, xx):  # (r, A, B, C): the C-vector of every sample's corner
            return nhwc[b, yy[:, :, None], xx[:, None, :]]

        top = (1 - wx) * g(y0, x0) + wx * g(y0, x1)
        bot = (1 - wx) * g(y1, x0) + wx * g(y1, x1)
        s = ((1 - wy) * top + wy * bot) * valid[..., None]
        s = s.reshape(-1, ph, sr, pw, sr, c)
        s = s.mean(dim=(2, 4)) if p["mode"] == "avg" else s.amax(dim=(2, 4))
        outs.append(s.permute(0, 3, 1, 2))
    return torch.cat(outs)


@register
class ROIAlign(Op):
    type_name = "ROIAlign"

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        p = _params(node)
        return ShapeResult({node.out_port: (in_shapes[1][0], in_shapes[0][1],
                                            p["pooled_h"], p["pooled_w"])})

    def ref_compute(self, node, inputs) -> Dict[int, np.ndarray]:
        return {node.out_port: roi_align_ref(inputs[0], inputs[1], inputs[2], _params(node))}

    def emit(self, ctx, node, inputs) -> Dict[int, TValue]:
        data = inputs[0].arr
        out = roi_align_torch(data.float(), inputs[1].arr.float(), inputs[2].arr.long(),
                              _params(node))
        return {node.out_port: TValue(out.to(data.dtype) if data.is_floating_point() else out)}
