"""SSD head ops: PriorBox, PriorBoxClustered and DetectionOutput.

Counterpart of ``pyopenvino_tpu/ops/ssd.py``.  PriorBox (opset1, Caffe
SSD300's anchor generator: per min_size a square, the sqrt(min·max) square,
then the aspect-ratio boxes, flipped too) and PriorBoxClustered (explicit
widths and heights) build the anchor table from static shapes, so in a
compiled network they fold at compile time with the ShapeOf → StridedSlice
chains that feed them.
DetectionOutput turns the box deltas, class scores and anchors into the
fixed-shape record table (1, 1, keep_top_k, 7) of
[image, class, confidence, xmin, ymin, xmax, ymax] rows, closed by a -1 row.

DetectionOutput has three implementations of one function:

  * ``detection_output_ref``: numpy, the JAX package's code (the
    interpreter and calibration run it, so both packages' interpreters
    agree bit for bit);
  * ``detection_output_torch``: batched PyTorch, the counterpart of
    ``detection_output_jax_batched``.  It keeps the top_k candidates of each
    example (ranked by confidence, ties to the lower prior index), decides
    suppression in row tiles of (B, tile, top_k) pairs with
    ``inter > thr · union`` and the ``union > 0`` guard, and ranks the
    survivors again.  Both rankings are a stable sort on the negated
    confidence, which breaks ties by the lower index as ``lax.top_k`` does
    (``torch.topk`` does not promise that order on the card).

Suppression is the reference's: box i dies iff a valid box j with IoU above
the threshold has a higher confidence, or the same confidence and a lower
index.  DetectionOutput is plain PyTorch here as it is XLA in the JAX
package: no TPU kernel to port.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from pyopenvino_tpu_torch.ir import attrs as A
from pyopenvino_tpu_torch.ops.spec import Op, ShapeResult, TValue, register


# -- PriorBoxClustered ---------------------------------------------------------


def prior_boxes_clustered(grid_hw, image_hw, widths, heights, step, step_h, step_w,
                          offset, variance, img_h, img_w) -> np.ndarray:
    """(2, 4·gh·gw·len(widths)) float32: row 0 the corner boxes normalized
    by the image size, row 1 the tiled variances."""
    gh, gw = int(grid_hw[0]), int(grid_hw[1])
    ih, iw = int(image_hw[0]), int(image_hw[1])
    img_h = float(ih) if img_h == 0 else img_h
    img_w = float(iw) if img_w == 0 else img_w
    sh = step if step_h == 0 else step_h
    sw = step if step_w == 0 else step_w
    sh = img_h / gh if sh == 0 else sh
    sw = img_w / gw if sw == 0 else sw

    widths = np.asarray(widths, dtype=np.float64)
    heights = np.asarray(heights, dtype=np.float64)
    npriors = len(widths)

    cx = (np.arange(gw, dtype=np.float64) + offset) * sw
    cy = (np.arange(gh, dtype=np.float64) + offset) * sh
    cx = cx[None, :, None]
    cy = cy[:, None, None]
    xmin = (cx - widths / 2) / img_w
    ymin = (cy - heights / 2) / img_h
    xmax = (cx + widths / 2) / img_w
    ymax = (cy + heights / 2) / img_h
    boxes = np.stack(
        [np.broadcast_to(v, (gh, gw, npriors)) for v in (xmin, ymin, xmax, ymax)],
        axis=-1,
    ).reshape(-1)
    variances = np.tile(np.asarray(variance, dtype=np.float64), gh * gw * npriors)
    return np.stack([boxes, variances]).astype(np.float32)


def _pbc_params(node):
    return dict(
        widths=A.get_float_tuple(node.attrs, "width", (1.0,)),
        heights=A.get_float_tuple(node.attrs, "height", (1.0,)),
        step=A.get_float(node.attrs, "step", 0.0),
        step_h=A.get_float(node.attrs, "step_h", 0.0),
        step_w=A.get_float(node.attrs, "step_w", 0.0),
        offset=A.get_float(node.attrs, "offset"),
        variance=A.get_float_tuple(node.attrs, "variance", ()),
        img_h=A.get_float(node.attrs, "img_h", 0.0),
        img_w=A.get_float(node.attrs, "img_w", 0.0),
    )


@register
class PriorBoxClustered(Op):
    type_name = "PriorBoxClustered"

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        grid = in_values.get(0)
        if grid is None:
            raise ValueError(f"PriorBoxClustered {node.name}: grid is not static")
        p = _pbc_params(node)
        n = 4 * int(grid[0]) * int(grid[1]) * len(p["widths"])
        res = ShapeResult({node.out_port: (2, n)})
        if in_values.get(1) is not None:
            res.values[node.out_port] = prior_boxes_clustered(grid, in_values[1], **p)
        return res

    def ref_compute(self, node, inputs) -> Dict[int, np.ndarray]:
        return {node.out_port: prior_boxes_clustered(inputs[0], inputs[1], **_pbc_params(node))}

    def emit(self, ctx, node, inputs):
        out = prior_boxes_clustered(ctx.static_value(node, 0), ctx.static_value(node, 1),
                                    **_pbc_params(node))
        return {node.out_port: TValue(torch.from_numpy(out).to(ctx.device))}


# -- PriorBox ------------------------------------------------------------------


def prior_boxes(grid_hw, image_hw, p) -> np.ndarray:
    """(2, 4·gh·gw·P) float32 anchors of opset1 PriorBox: row 0 the corner
    boxes normalized by the image size (clipped to [0, 1] with ``clip``),
    row 1 the tiled variances; per cell the boxes of ``_pb_wh_list``."""
    gh, gw = int(grid_hw[0]), int(grid_hw[1])
    ih, iw = int(image_hw[0]), int(image_hw[1])
    step = p["step"]
    # step 0: cell-sized steps with OpenVINO's fixed 0.5 centre offset (the
    # offset attribute applies only with an explicit step)
    sh = ih / gh if step == 0 else step
    sw = iw / gw if step == 0 else step
    offset = 0.5 if step == 0 else p["offset"]

    wh = _pb_wh_list(p)
    npriors = len(wh)
    cx = (np.arange(gw, dtype=np.float64) + offset) * sw
    cy = (np.arange(gh, dtype=np.float64) + offset) * sh
    ws = np.asarray([w for w, _ in wh], np.float64)
    hs = np.asarray([h for _, h in wh], np.float64)
    cx = cx[None, :, None]
    cy = cy[:, None, None]
    xmin = (cx - ws / 2) / iw
    ymin = (cy - hs / 2) / ih
    xmax = (cx + ws / 2) / iw
    ymax = (cy + hs / 2) / ih
    boxes = np.stack(
        [np.broadcast_to(v, (gh, gw, npriors)) for v in (xmin, ymin, xmax, ymax)], axis=-1)
    if p["clip"]:
        boxes = np.clip(boxes, 0.0, 1.0)
    boxes = boxes.reshape(-1)
    variance = p["variance"] or (0.1,)
    if len(variance) not in (1, 4):
        raise ValueError(f"PriorBox: variance must have 1 or 4 entries, got {len(variance)}")
    variances = np.tile(np.asarray(variance, np.float64),
                        gh * gw * npriors * (4 // len(variance)))
    return np.stack([boxes, variances]).astype(np.float32)


def _pb_params(node):
    for unsupported in ("fixed_size", "fixed_ratio", "density"):
        if A.get_float_tuple(node.attrs, unsupported, ()):
            raise NotImplementedError(
                f"PriorBox: attribute {unsupported!r} is not supported — "
                "anchors would be silently generated from min/max/aspect "
                "only (densified fixed-size anchors are a Caffe-SSD "
                "variant this build does not implement)")
    return dict(
        min_size=A.get_float_tuple(node.attrs, "min_size", ()),
        max_size=A.get_float_tuple(node.attrs, "max_size", ()),
        aspect_ratio=A.get_float_tuple(node.attrs, "aspect_ratio", ()),
        flip=A.get_bool(node.attrs, "flip", False),
        clip=A.get_bool(node.attrs, "clip", False),
        step=A.get_float(node.attrs, "step", 0.0),
        offset=A.get_float(node.attrs, "offset"),
        variance=A.get_float_tuple(node.attrs, "variance", ()),
        scale_all_sizes=A.get_bool(node.attrs, "scale_all_sizes", True),
    )


def _pb_wh_list(p):
    """Per-cell (w, h) anchors in the spec's order, in pixels: the one
    enumeration that the generator and shape inference both read.

    scale_all_sizes (the default): per min_size the square min box, the
    sqrt(min·max) square where a max_size pairs with it, then the
    aspect-ratio boxes.  Without it (the Caffe/MxNet-SSD layout) max_size
    is ignored: one square per min_size, then the aspect-ratio boxes of
    min_size[0] alone."""
    ars = [1.0]
    for ar in p["aspect_ratio"]:
        if any(abs(ar - a) < 1e-6 for a in ars):
            continue
        ars.append(float(ar))
        if p["flip"] and abs(ar) > 1e-6:
            ars.append(1.0 / float(ar))

    def add_ar(out, m):
        for ar in ars:
            if abs(ar - 1.0) < 1e-6:
                continue
            r = float(np.sqrt(ar))
            out.append((m * r, m / r))

    wh = []
    min_sizes = list(p["min_size"])
    max_sizes = list(p["max_size"])
    if p["scale_all_sizes"]:
        for i, m in enumerate(min_sizes):
            wh.append((m, m))
            if i < len(max_sizes):
                s = float(np.sqrt(m * max_sizes[i]))
                wh.append((s, s))
            add_ar(wh, m)
    else:
        for m in min_sizes:
            wh.append((m, m))
        if min_sizes:
            add_ar(wh, min_sizes[0])
    return wh


def _pb_num_priors(p) -> int:
    return len(_pb_wh_list(p))


@register
class PriorBox(Op):
    type_name = "PriorBox"

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        grid = in_values.get(0)
        if grid is None:
            raise ValueError(f"PriorBox {node.name}: grid is not static")
        p = _pb_params(node)
        res = ShapeResult({node.out_port: (2, 4 * int(grid[0]) * int(grid[1]) * _pb_num_priors(p))})
        if in_values.get(1) is not None:
            res.values[node.out_port] = prior_boxes(grid, in_values[1], p)
        return res

    def ref_compute(self, node, inputs) -> Dict[int, np.ndarray]:
        return {node.out_port: prior_boxes(inputs[0], inputs[1], _pb_params(node))}

    def emit(self, ctx, node, inputs):
        out = prior_boxes(ctx.static_value(node, 0), ctx.static_value(node, 1), _pb_params(node))
        return {node.out_port: TValue(torch.from_numpy(out).to(ctx.device))}


# -- DetectionOutput -----------------------------------------------------------


def _do_params(node):
    a = node.attrs
    return dict(
        num_classes=A.get_int(a, "num_classes"),
        background_label_id=A.get_int(a, "background_label_id", 0),
        top_k=A.get_int(a, "top_k", -1),
        variance_encoded_in_target=A.get_bool(a, "variance_encoded_in_target"),
        keep_top_k=A.get_int_tuple(a, "keep_top_k"),
        code_type=A.get_str(a, "code_type", "caffe.PriorBoxParameter.CORNER"),
        share_location=A.get_bool(a, "share_location", True),
        nms_threshold=A.get_float(a, "nms_threshold"),
        confidence_threshold=A.get_float(a, "confidence_threshold", 0.0),
        clip_after_nms=A.get_bool(a, "clip_after_nms"),
        clip_before_nms=A.get_bool(a, "clip_before_nms"),
        decrease_label_id=A.get_bool(a, "decrease_label_id"),
        normalized=A.get_bool(a, "normalized"),
        input_height=A.get_int(a, "input_height", 1),
        input_width=A.get_int(a, "input_width", 1),
    )


def _output_shape(p, num_prior_boxes) -> tuple:
    shape = (1, 1, p["num_classes"] * num_prior_boxes, 7)
    if p["keep_top_k"][0] > 0:
        shape = (1, 1, p["keep_top_k"][0], 7)
    elif p["keep_top_k"][0] == -1 and p["top_k"] > 0:
        shape = (1, 1, p["top_k"] * p["num_classes"], 7)
    return shape


def _decode(xp, boxes, logits, variances, p):
    """Box decode over the last axis (4 corner or delta values), numpy or
    torch (``xp``); leading axes broadcast.  Returns [xmin, ymin, xmax,
    ymax] on the last axis."""
    bx0, by0, bx1, by1 = (boxes[..., i] for i in range(4))
    lx0, ly0, lx1, ly1 = (logits[..., i] for i in range(4))
    if not p["normalized"]:
        bx0 = bx0 / p["input_width"]
        by0 = by0 / p["input_height"]
        bx1 = bx1 / p["input_width"]
        by1 = by1 / p["input_height"]
    vet = p["variance_encoded_in_target"]
    if p["code_type"] == "caffe.PriorBoxParameter.CORNER":
        if vet:
            out = (bx0 + lx0, by0 + ly0, bx1 + lx1, by1 + ly1)
        else:
            out = (bx0 + variances[..., 0] * lx0, by0 + variances[..., 1] * ly0,
                   bx1 + variances[..., 2] * lx1, by1 + variances[..., 3] * ly1)
        return xp.stack(out, -1)
    # CENTER_SIZE
    pw, ph = bx1 - bx0, by1 - by0
    pcx, pcy = (bx0 + bx1) / 2, (by0 + by1) / 2
    if vet:
        cx = lx0 * pw + pcx
        cy = ly0 * ph + pcy
        w = xp.exp(lx1) * pw
        h = xp.exp(ly1) * ph
    else:
        cx = variances[..., 0] * lx0 * pw + pcx
        cy = variances[..., 1] * ly0 * ph + pcy
        w = xp.exp(variances[..., 2] * lx1) * pw
        h = xp.exp(variances[..., 3] * ly1) * ph
    return xp.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def _iou_matrix(b):
    """Pairwise IoU of (P, 4) corner boxes → (P, P), numpy."""
    area = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    x0 = np.maximum(b[:, None, 0], b[None, :, 0])
    y0 = np.maximum(b[:, None, 1], b[None, :, 1])
    x1 = np.minimum(b[:, None, 2], b[None, :, 2])
    y1 = np.minimum(b[:, None, 3], b[None, :, 3])
    w = x1 - x0
    h = y1 - y0
    # 0 when w or h is negative, as in the reference
    inter = np.where((w < 0) | (h < 0), 0.0, w * h)
    union = area[:, None] + area[None, :] - inter
    return inter / union


def _top_k_prefilter_np(valid, conf, p):
    """The spec's ``top_k``: only the top_k candidates (by confidence, ties
    to the lower prior index) enter NMS.  Exact for every surviving record:
    a box is killed only by a valid box of higher rank, which is itself a
    top_k candidate."""
    top_k = p["top_k"]
    P = conf.shape[-1]
    if top_k <= 0 or top_k >= P:
        return valid
    order = np.argsort(np.where(valid, -conf, np.inf), kind="stable")
    sel = np.zeros(P, dtype=bool)
    sel[order[:top_k]] = True
    return valid & sel


def detection_output_ref(box_logits, class_pred, proposals, p) -> np.ndarray:
    """Numpy, one example: (1, 1, K, 7) records."""
    want_rows = 1 if p["variance_encoded_in_target"] else 2
    assert proposals.shape[1] == want_rows, (
        f"proposals rows {proposals.shape[1]} != {want_rows} for "
        f"variance_encoded_in_target={p['variance_encoded_in_target']}")
    prior_box_size = 4 if p["normalized"] else 5
    P = proposals.shape[2] // prior_box_size
    nc = p["num_classes"]

    logits = box_logits.reshape(P, 4).astype(np.float64)
    scores = class_pred.reshape(P, nc)
    boxes_p = proposals[0, 0].reshape(P, prior_box_size).astype(np.float64)
    boxes_v = (np.zeros((P, prior_box_size))
               if p["variance_encoded_in_target"]
               else proposals[0, 1].reshape(P, prior_box_size).astype(np.float64))

    cls = scores.argmax(axis=1)
    conf = scores[np.arange(P), cls]
    valid = (conf > p["confidence_threshold"]) & (cls != 0)
    valid = _top_k_prefilter_np(valid, conf, p)

    offset = 0 if p["normalized"] else 1
    decoded = _decode(np, boxes_p[:, offset:offset + 4], logits, boxes_v, p)
    if p["clip_before_nms"]:
        decoded = np.clip(decoded, 0.0, 1.0)

    iou = _iou_matrix(decoded)
    j_less = np.arange(P)[None, :] < np.arange(P)[:, None]
    beats = (conf[None, :] > conf[:, None]) | ((conf[None, :] == conf[:, None]) & j_less)
    overlap = iou > p["nms_threshold"]
    np.fill_diagonal(overlap, False)
    kill = (overlap & beats & valid[None, :]).any(axis=1)
    keep = valid & ~kill

    if p["clip_after_nms"]:
        decoded = np.clip(decoded, 0.0, 1.0)

    out_shape = _output_shape(p, P)
    max_record = out_shape[2]
    res = np.zeros(out_shape, dtype=np.float32)
    order = np.argsort(np.where(keep, -conf, np.inf), kind="stable")
    num_keep = int(keep.sum())
    for n in range(min(max_record, num_keep)):
        i = order[n]
        res[0, 0, n] = [n, cls[i], conf[i], *decoded[i]]
    if num_keep < max_record:
        res[0, 0, num_keep] = [-1, 0, 0, 0, 0, 0, 0]
    return res


def _ranked(v):
    """Indices that sort each row of ``v`` from high to low, ties to the
    lower index (a stable sort of -v; -inf entries last)."""
    return torch.argsort(-v, dim=1, stable=True)


def _gather_rows(v, idx):
    """v (B, P, ...) at the per-example indices idx (B, k)."""
    return v.gather(1, idx.reshape(idx.shape + (1,) * (v.dim() - 2)).expand(
        idx.shape + v.shape[2:]))


def detection_output_torch(box_logits, class_pred, proposals, p, row_tile: int = 64):
    """Batched PyTorch: box_logits (B, P·4), class_pred (B, P·nc), proposals
    (1 or B, rows, P·pbs) → (B, 1, 1, K, 7) float32 records, example by
    example equal to ``detection_output_ref`` up to float32 rounding."""
    B = box_logits.shape[0]
    prior_box_size = 4 if p["normalized"] else 5
    P = proposals.shape[-1] // prior_box_size
    nc = p["num_classes"]
    dev = box_logits.device
    inf = float("inf")

    logits = box_logits.reshape(B, P, 4).float()
    scores = class_pred.reshape(B, P, nc)
    rows = 1 if p["variance_encoded_in_target"] else 2
    props = proposals.reshape(-1, rows, P, prior_box_size).float()
    boxes_p = props[:, 0]
    boxes_v = torch.zeros_like(boxes_p) if p["variance_encoded_in_target"] else props[:, 1]

    cls = torch.argmax(scores, dim=2)  # the first maximum, as jnp.argmax
    conf = torch.amax(scores, dim=2)
    valid = (conf > p["confidence_threshold"]) & (cls != 0)

    offset = 0 if p["normalized"] else 1
    decoded = _decode(torch, boxes_p[..., offset:offset + 4], logits, boxes_v, p)
    decoded = decoded.expand(B, P, 4)
    if p["clip_before_nms"]:
        decoded = decoded.clamp(0.0, 1.0)

    # the output geometry is the full prior count's, fixed before compaction
    out_shape = _output_shape(p, P)

    # the spec's top_k before NMS: keep each example's top_k candidates
    if 0 < p["top_k"] < P:
        masked = torch.where(valid, conf, -inf)
        cand = _ranked(masked)[:, :p["top_k"]]
        conf = masked.gather(1, cand)
        valid = conf > p["confidence_threshold"]  # -inf rows drop out
        cls = cls.gather(1, cand)
        decoded = _gather_rows(decoded, cand)
        P = p["top_k"]

    # suppression in row tiles: (B, tile, P) pairs at a time
    idx = torch.arange(P, device=dev)
    area_all = (decoded[..., 2] - decoded[..., 0]) * (decoded[..., 3] - decoded[..., 1])
    kills = []
    for r0 in range(0, P, row_tile):
        rows_b = decoded[:, r0:r0 + row_tile]
        conf_rows = conf[:, r0:r0 + row_tile]
        row_ids = idx[r0:r0 + row_tile]
        x0 = torch.maximum(rows_b[..., 0:1], decoded[:, None, :, 0])
        y0 = torch.maximum(rows_b[..., 1:2], decoded[:, None, :, 1])
        x1 = torch.minimum(rows_b[..., 2:3], decoded[:, None, :, 2])
        y1 = torch.minimum(rows_b[..., 3:4], decoded[:, None, :, 3])
        inter = (x1 - x0).clamp(min=0.0) * (y1 - y0).clamp(min=0.0)
        area_r = (rows_b[..., 2] - rows_b[..., 0]) * (rows_b[..., 3] - rows_b[..., 1])
        union = area_r[..., None] + area_all[:, None, :] - inter
        j_less = idx[None, :] < row_ids[:, None]
        beats = (conf[:, None, :] > conf_rows[..., None]) | (
            (conf[:, None, :] == conf_rows[..., None]) & j_less[None])
        # union > 0: a half-inverted box has a negative area, and 0 > thr·union
        # must not count as overlap (the numpy twin's inter / union is NaN)
        overlap = ((inter > p["nms_threshold"] * union) & (union > 0)
                   & (idx[None, None, :] != row_ids[None, :, None]))
        kills.append((overlap & beats & valid[:, None, :]).any(dim=2))
    keep = valid & ~torch.cat(kills, dim=1)

    if p["clip_after_nms"]:
        decoded = decoded.clamp(0.0, 1.0)

    max_record = out_shape[2]
    num_keep = keep.sum(dim=1)
    k = min(max_record, P)
    masked = torch.where(keep, conf, -inf)
    top = _ranked(masked)[:, :k]
    rank = torch.arange(k, device=dev)
    is_det = rank[None, :] < torch.clamp(num_keep, max=k)[:, None]
    is_term = rank[None, :] == num_keep[:, None]
    dec_top = _gather_rows(decoded, top)
    records = torch.cat([
        rank.float().expand(B, k)[..., None],
        cls.gather(1, top).float()[..., None],
        masked.gather(1, top)[..., None],
        dec_top,
    ], dim=2)
    term = torch.zeros((k, 7), device=dev)
    term[:, 0] = -1.0
    out = torch.where(is_det[..., None], records,
                      torch.where(is_term[..., None], term, torch.zeros((), device=dev)))
    if k < max_record:
        # the -1 row may fall after the top-k block when num_keep == k
        pad = torch.zeros((B, max_record - k, 7), device=dev)
        pad[..., 0] = -(torch.arange(k, max_record, device=dev)[None, :]
                        == num_keep[:, None]).float()
        out = torch.cat([out, pad], dim=1)
    return out.reshape((B,) + out_shape)


@register
class DetectionOutput(Op):
    type_name = "DetectionOutput"

    @staticmethod
    def _baked_batch(node) -> int:
        """The batch carried in the graph's shapes, stamped by bake_batch
        (passes/shape_infer.py), so that a batch-N IR declared as (1, 1,
        N·K, 7) is never misread as baked."""
        return int(node.attrs.get("_baked_batch", 1))

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        p = _do_params(node)
        prior_box_size = 4 if p["normalized"] else 5
        out = _output_shape(p, in_shapes[2][2] // prior_box_size)
        n = self._baked_batch(node)
        if n > 1:
            # per-example tables on the leading axis, the declared unit
            # batch dropped: the layout infer_batch returns
            out = (n,) + out[1:]
        return ShapeResult({node.out_port: out})

    def ref_compute(self, node, inputs) -> Dict[int, np.ndarray]:
        p = _do_params(node)
        n = self._baked_batch(node)
        if n > 1:
            rows = [detection_output_ref(inputs[0][i:i + 1], inputs[1][i:i + 1], inputs[2], p)
                    for i in range(n)]
            return {node.out_port: np.concatenate([r.reshape((1,) + r.shape[1:]) for r in rows])}
        return {node.out_port: detection_output_ref(inputs[0], inputs[1], inputs[2], p)}

    def emit(self, ctx, node, inputs):
        p = _do_params(node)
        loc, conf, prop = inputs[0].arr, inputs[1].arr, inputs[2].arr
        n = self._baked_batch(node)
        if loc.shape[0] != n:
            raise ValueError(
                f"DetectionOutput {node.name!r}: {loc.shape[0]} examples in a graph "
                f"compiled for {n}")
        out = detection_output_torch(loc, conf, prop, p)  # (n, 1, 1, K, 7)
        return {node.out_port: TValue(out.reshape((n,) + out.shape[2:]))}
