"""Proposal (opset4, Caffe/Faster R-CNN semantics): the RPN's box
proposals.

Counterpart of ``pyopenvino_tpu/ops/proposal.py``.  The op always emits
``N · post_nms_topn`` rois, zero rows past the kept count, so its shapes are
static: anchors (``len(ratio) · len(scale)`` boxes on a ``base_size``
window, the classic generate_anchors, shifted by ``feat_stride`` a cell),
foreground scores from channels [A, 2A) of input 0, deltas decoded
CENTER_SIZE-style and clipped to the image, a min-size filter at
``min_size · im_scale``, the ``pre_nms_topn`` best by score, greedy NMS at
``nms_thresh`` and the first ``post_nms_topn`` kept.  Outputs: rois
(N·post, 5) [batch, x1, y1, x2, y2] and their scores (N·post,).

``framework="tensorflow"`` sets the OpenVINO plugin's knobs for the TF
Object Detection API: coordinates_offset 0, unrounded anchor ratios,
anchors centred on zero and clipped to the image before decoding, and
im_info's height and width swapped.  ``_params`` derives the knobs, and
both implementations read them.

``ref_compute`` is the JAX package's numpy code.  ``emit`` is plain PyTorch
on the device tensor, as the JAX package's is XLA (no TPU kernel), every
image of the batch at once where the JAX emit vmaps: float32 whatever the
compute dtype (bf16 scores widen before the sort, so bf16 ties sort by
index), a stable sort on the negated scores as ``jnp.argsort(...,
stable=True)`` does, the IoU in the JAX emit's operations and order, and
``ops/nms.py``'s ``greedy_nms_sweep``: one step per candidate, a few device
operations each, nothing read back to the host.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from pyopenvino_tpu_torch.ir import attrs as A
from pyopenvino_tpu_torch.ops.nms import greedy_nms_sweep
from pyopenvino_tpu_torch.ops.spec import Op, ShapeResult, TValue, register


def _params(node):
    a = node.attrs
    p = dict(
        base_size=A.get_int(a, "base_size"),
        pre_nms_topn=A.get_int(a, "pre_nms_topn"),
        post_nms_topn=A.get_int(a, "post_nms_topn"),
        nms_thresh=A.get_float(a, "nms_thresh"),
        feat_stride=A.get_int(a, "feat_stride"),
        min_size=A.get_int(a, "min_size"),
        ratio=A.get_float_tuple(a, "ratio"),
        scale=A.get_float_tuple(a, "scale"),
        clip_before_nms=A.get_bool(a, "clip_before_nms", True),
        clip_after_nms=A.get_bool(a, "clip_after_nms", False),
        normalize=A.get_bool(a, "normalize", False),
        box_size_scale=A.get_float(a, "box_size_scale", 1.0),
        box_coordinate_scale=A.get_float(a, "box_coordinate_scale", 1.0),
        framework=A.get_str(a, "framework", ""),
    )
    if p["framework"] not in ("", "caffe", "tensorflow"):
        raise NotImplementedError(
            f"Proposal framework={p['framework']!r} unsupported (caffe "
            "and tensorflow conventions only)")
    tf = p["framework"] == "tensorflow"
    p["co"] = 0.0 if tf else 1.0          # coordinates_offset
    p["round_ratios"] = not tf
    p["shift_anchors"] = tf
    p["initial_clip"] = tf
    p["swap_xy"] = tf
    return p


def _anchors(p) -> np.ndarray:
    """(A, 4) corner anchors around the base window (generate_anchors),
    float64, on the coordinates_offset, rounding and shift knobs."""
    base = float(p["base_size"])
    co = p["co"]
    out = []
    cx = cy = 0.5 * (base - co)
    area = base * base
    for r in p["ratio"]:
        size_r = area / r
        if p["round_ratios"]:
            ws = round(np.sqrt(size_r))
            hs = round(ws * r)
        else:
            ws = np.sqrt(size_r)
            hs = ws * r
        for s in p["scale"]:
            w2, h2 = 0.5 * (ws * s - co), 0.5 * (hs * s - co)
            out.append([cx - w2, cy - h2, cx + w2, cy + h2])
    anchors = np.asarray(out, np.float64)
    if p["shift_anchors"]:
        anchors -= base / 2.0
    return anchors


def _ports(node):
    ports = sorted(node.outputs)
    if len(ports) == 2:
        return ports
    return [node.out_port, node.out_port + 1]


def proposal_ref(probs, deltas, im_info, p) -> tuple:
    """Numpy reference.  probs (N, 2A, H, W), deltas (N, 4A, H, W),
    im_info (3,)|(4,) → (rois (N·post, 5), scores (N·post,))."""
    n, _, h, w = probs.shape
    anchors = _anchors(p)
    na = len(anchors)
    co = p["co"]
    img_h, img_w = float(im_info[0]), float(im_info[1])
    if p["swap_xy"]:
        img_h, img_w = img_w, img_h
    scale_h = float(im_info[2]) if len(im_info) > 2 else 1.0
    scale_w = float(im_info[3]) if len(im_info) > 3 else scale_h
    post = p["post_nms_topn"]

    rois = np.zeros((n * post, 5), np.float32)
    out_scores = np.zeros((n * post,), np.float32)
    for b in range(n):
        sc = probs[b, na:].astype(np.float64).reshape(na, h * w)
        dl = deltas[b].astype(np.float64).reshape(na, 4, h * w)
        xs = np.tile(np.arange(w) * p["feat_stride"], h)
        ys = np.repeat(np.arange(h) * p["feat_stride"], w)
        ax1 = anchors[:, 0, None] + xs
        ay1 = anchors[:, 1, None] + ys
        ax2 = anchors[:, 2, None] + xs
        ay2 = anchors[:, 3, None] + ys
        if p["initial_clip"]:
            ax1 = np.clip(ax1, 0, img_w)
            ay1 = np.clip(ay1, 0, img_h)
            ax2 = np.clip(ax2, 0, img_w)
            ay2 = np.clip(ay2, 0, img_h)
        aw = ax2 - ax1 + co
        ah = ay2 - ay1 + co
        acx = ax1 + 0.5 * (aw - co)
        acy = ay1 + 0.5 * (ah - co)
        dx = dl[:, 0] / p["box_coordinate_scale"]
        dy = dl[:, 1] / p["box_coordinate_scale"]
        dw = dl[:, 2] / p["box_size_scale"]
        dh = dl[:, 3] / p["box_size_scale"]
        cx = dx * aw + acx
        cy = dy * ah + acy
        bw = np.exp(dw) * aw
        bh = np.exp(dh) * ah
        x1 = cx - 0.5 * (bw - co)
        y1 = cy - 0.5 * (bh - co)
        x2 = cx + 0.5 * (bw - co)
        y2 = cy + 0.5 * (bh - co)
        if p["clip_before_nms"]:
            x1 = np.clip(x1, 0, img_w - co)
            y1 = np.clip(y1, 0, img_h - co)
            x2 = np.clip(x2, 0, img_w - co)
            y2 = np.clip(y2, 0, img_h - co)
        keep_sz = (((x2 - x1 + co) >= p["min_size"] * scale_w)
                   & ((y2 - y1 + co) >= p["min_size"] * scale_h))
        s = np.where(keep_sz, sc, -np.inf).reshape(-1)
        boxes = np.stack([x1, y1, x2, y2], axis=-1).reshape(-1, 4)
        order = np.argsort(-s, kind="stable")[: p["pre_nms_topn"]]
        order = order[np.isfinite(s[order])]
        kept = []
        for i in order:
            bi = boxes[i]
            ok = True
            for j in kept:
                bj = boxes[j]
                ix1, iy1 = max(bi[0], bj[0]), max(bi[1], bj[1])
                ix2, iy2 = min(bi[2], bj[2]), min(bi[3], bj[3])
                iw_ = max(0.0, ix2 - ix1 + co)
                ih_ = max(0.0, iy2 - iy1 + co)
                inter = iw_ * ih_
                ai = (bi[2] - bi[0] + co) * (bi[3] - bi[1] + co)
                aj = (bj[2] - bj[0] + co) * (bj[3] - bj[1] + co)
                if inter / (ai + aj - inter) > p["nms_thresh"]:
                    ok = False
                    break
            if ok:
                kept.append(int(i))
            if len(kept) >= post:
                break
        for k, i in enumerate(kept):
            bx = boxes[i]
            if p["clip_after_nms"]:
                bx = np.clip(bx, [0, 0, 0, 0],
                             [img_w - co, img_h - co, img_w - co, img_h - co])
            if p["normalize"]:
                bx = bx / [img_w, img_h, img_w, img_h]
            rois[b * post + k] = [b, *bx]
            out_scores[b * post + k] = s[i]
    return rois, out_scores


def proposal_torch(probs, deltas, im_info, p):
    """The emit's computation on float32 tensors, every image at once:
    probs (N, 2A, H, W), deltas (N, 4A, H, W), im_info (3,)|(4,) → (rois
    (N·post, 5), scores (N·post,))."""
    n, _, h, w = probs.shape
    dev = probs.device
    anchors = torch.from_numpy(_anchors(p)).to(device=dev, dtype=torch.float32)
    na = anchors.shape[0]
    co = p["co"]
    img_h, img_w = im_info[0], im_info[1]
    if p["swap_xy"]:
        img_h, img_w = img_w, img_h
    one = torch.ones((), device=dev)
    scale_h = im_info[2] if im_info.shape[0] > 2 else one
    scale_w = im_info[3] if im_info.shape[0] > 3 else scale_h
    post = p["post_nms_topn"]
    pool = na * h * w
    pre = min(p["pre_nms_topn"], pool)

    xs = (torch.arange(w, device=dev, dtype=torch.float32) * p["feat_stride"]).repeat(h)
    ys = (torch.arange(h, device=dev, dtype=torch.float32) * p["feat_stride"]).repeat_interleave(w)
    sc = probs[:, na:].reshape(n, na, h * w)
    dl = deltas.reshape(n, na, 4, h * w)
    ax1 = anchors[:, 0, None] + xs
    ay1 = anchors[:, 1, None] + ys
    ax2 = anchors[:, 2, None] + xs
    ay2 = anchors[:, 3, None] + ys
    zero = torch.zeros((), device=dev)
    if p["initial_clip"]:
        ax1 = torch.clamp(ax1, zero, img_w)
        ay1 = torch.clamp(ay1, zero, img_h)
        ax2 = torch.clamp(ax2, zero, img_w)
        ay2 = torch.clamp(ay2, zero, img_h)
    aw = ax2 - ax1 + co
    ah = ay2 - ay1 + co
    acx = ax1 + 0.5 * (aw - co)
    acy = ay1 + 0.5 * (ah - co)
    cx = dl[:, :, 0] / p["box_coordinate_scale"] * aw + acx
    cy = dl[:, :, 1] / p["box_coordinate_scale"] * ah + acy
    bw = torch.exp(dl[:, :, 2] / p["box_size_scale"]) * aw
    bh = torch.exp(dl[:, :, 3] / p["box_size_scale"]) * ah
    x1 = cx - 0.5 * (bw - co)
    y1 = cy - 0.5 * (bh - co)
    x2 = cx + 0.5 * (bw - co)
    y2 = cy + 0.5 * (bh - co)
    if p["clip_before_nms"]:
        x1 = torch.clamp(x1, zero, img_w - co)
        y1 = torch.clamp(y1, zero, img_h - co)
        x2 = torch.clamp(x2, zero, img_w - co)
        y2 = torch.clamp(y2, zero, img_h - co)
    valid = (((x2 - x1 + co) >= p["min_size"] * scale_w)
             & ((y2 - y1 + co) >= p["min_size"] * scale_h))
    s = torch.where(valid, sc, torch.full((), float("-inf"), device=dev)).reshape(n, -1)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1).reshape(n, -1, 4)

    order = torch.sort(-s, dim=-1, stable=True).indices[:, :pre]
    bs = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    ss = torch.gather(s, 1, order)
    area = (bs[..., 2] - bs[..., 0] + co) * (bs[..., 3] - bs[..., 1] + co)
    ix1 = torch.maximum(bs[..., :, None, 0], bs[..., None, :, 0])
    iy1 = torch.maximum(bs[..., :, None, 1], bs[..., None, :, 1])
    ix2 = torch.minimum(bs[..., :, None, 2], bs[..., None, :, 2])
    iy2 = torch.minimum(bs[..., :, None, 3], bs[..., None, :, 3])
    inter = torch.clamp(ix2 - ix1 + co, min=0) * torch.clamp(iy2 - iy1 + co, min=0)
    union = area[..., :, None] + area[..., None, :] - inter
    iou = torch.where(union > 0, inter / union, zero)
    keep, _cnt = greedy_nms_sweep(iou, torch.isfinite(ss), p["nms_thresh"], post)

    # the kept candidates in score order, then padding, the first ``post``
    padn = max(post, pre)
    pos = torch.arange(pre, device=dev).expand(n, pre)
    rank_key = torch.cat([torch.where(keep, pos, padn + 1),
                          torch.full((n, padn - pre), padn + 1, device=dev)], dim=1)
    sel = torch.sort(rank_key, dim=-1, stable=True).indices[:, :post]
    keep_p = torch.cat([keep, torch.zeros((n, padn - pre), dtype=torch.bool, device=dev)], 1)
    bs_p = torch.cat([bs, torch.zeros((n, padn - pre, 4), device=dev)], 1)
    ss_p = torch.cat([ss, torch.zeros((n, padn - pre), device=dev)], 1)
    ok = torch.gather(keep_p, 1, sel)
    out_boxes = torch.gather(bs_p, 1, sel[..., None].expand(-1, -1, 4))
    if p["clip_after_nms"]:
        hi = torch.stack([img_w - co, img_h - co, img_w - co, img_h - co])
        out_boxes = torch.clamp(out_boxes, torch.zeros(4, device=dev), hi)
    if p["normalize"]:
        out_boxes = out_boxes / torch.stack([img_w, img_h, img_w, img_h])
    out_boxes = torch.where(ok[..., None], out_boxes, zero)
    out_scores = torch.where(ok, torch.gather(ss_p, 1, sel), zero)
    # padding rows are all zero, the batch column too
    bcol = (torch.arange(n, device=dev, dtype=torch.float32).repeat_interleave(post)
            * ok.reshape(-1))[:, None]
    return torch.cat([bcol, out_boxes.reshape(n * post, 4)], dim=1), out_scores.reshape(-1)


@register
class Proposal(Op):
    type_name = "Proposal"

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        p = _params(node)
        n = in_shapes[0][0]
        p0, p1 = _ports(node)
        return ShapeResult({p0: (n * p["post_nms_topn"], 5), p1: (n * p["post_nms_topn"],)})

    def ref_compute(self, node, inputs) -> Dict[int, np.ndarray]:
        rois, scores = proposal_ref(inputs[0], inputs[1], np.asarray(inputs[2]).reshape(-1),
                                    _params(node))
        p0, p1 = _ports(node)
        return {p0: rois, p1: scores}

    def emit(self, ctx, node, inputs) -> Dict[int, TValue]:
        rois, scores = proposal_torch(inputs[0].arr.float(), inputs[1].arr.float(),
                                      inputs[2].arr.reshape(-1).float(), _params(node))
        p0, p1 = _ports(node)
        return {p0: TValue(rois), p1: TValue(scores)}
