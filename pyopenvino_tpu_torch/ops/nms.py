"""NonMaxSuppression (opset9).

The port's own copy of ``pyopenvino_tpu/ops/nms.py``: sequential greedy NMS
per (batch, class), as the opset specifies it (a box suppressed by an
already-suppressed box survives), in both twins:

  * ``ref_compute``: the JAX package's numpy reference, line for line;
  * ``emit``: on device tensors, batched over every (batch, class) slice at
    once where the JAX package vmaps its ``lax.fori_loop``: the IoU matrix
    of each image, each slice's candidates sorted by score, then one step
    per sorted candidate (``greedy_nms_sweep``).  Nothing is read back to
    the host: the Python loop only issues device operations.

Outputs have the opset's static bound, ``S = N · C · min(num_boxes,
max_output_boxes_per_class)`` rows, padded with -1 past ``valid_outputs``:
selected_indices (S, 3) [batch, class, box] in ``output_type``,
selected_scores (S, 3) float32 [batch, class, score], valid_outputs (1,).
``soft_nms_sigma`` > 0 is Soft-NMS with Gaussian weighting (every pick
decays the other candidates by ``exp(-0.5·iou²/σ)``, zero past the IoU
threshold; the reported scores are the decayed ones).
``sort_result_descending`` sorts the valid rows by score across classes;
otherwise they group by (batch, class) in score order.

The order of ties is the JAX package's: candidates sort by a stable
ascending sort on ``-score`` and the rows by stable sorts on the same keys,
so a tie keeps (batch, class, box) order; the IoU takes the same operations
in the same order, so an IoU at the threshold falls on the same side.
Boxes and scores are taken in float32 in every compute dtype, as the JAX
op casts them.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from pyopenvino_tpu_torch.ir import attrs as A
from pyopenvino_tpu_torch.ops.spec import Op, ShapeResult, TValue, register, torch_dtype


def _params(node):
    a = node.attrs
    return dict(
        box_encoding=A.get_str(a, "box_encoding", "corner"),
        sort_result_descending=A.get_bool(a, "sort_result_descending", True),
        output_type=A.get_str(a, "output_type", "i64"),
    )


def _corner(boxes, encoding):
    """(…, 4) → corner (y1, x1, y2, x2) with min/max normalized (the spec
    accepts flipped corners), on numpy arrays and tensors alike."""
    m = np if isinstance(boxes, np.ndarray) else torch
    if encoding == "center":
        cx, cy, w, h = (boxes[..., 0], boxes[..., 1], boxes[..., 2], boxes[..., 3])
        return m.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2], -1)
    y1 = m.minimum(boxes[..., 0], boxes[..., 2])
    x1 = m.minimum(boxes[..., 1], boxes[..., 3])
    y2 = m.maximum(boxes[..., 0], boxes[..., 2])
    x2 = m.maximum(boxes[..., 1], boxes[..., 3])
    return m.stack([y1, x1, y2, x2], -1)


def _iou_np(b):
    area = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    y1 = np.maximum(b[:, None, 0], b[None, :, 0])
    x1 = np.maximum(b[:, None, 1], b[None, :, 1])
    y2 = np.minimum(b[:, None, 2], b[None, :, 2])
    x2 = np.minimum(b[:, None, 3], b[None, :, 3])
    inter = np.clip(y2 - y1, 0, None) * np.clip(x2 - x1, 0, None)
    union = area[:, None] + area[None, :] - inter
    return np.where(union > 0, inter / union, 0.0)


def iou_matrices(b):
    """(N, B, B) IoU of each image's (N, B, 4) corner boxes, in the JAX
    emit's operations and order, in b's dtype."""
    area = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    yy1 = torch.maximum(b[..., :, None, 0], b[..., None, :, 0])
    xx1 = torch.maximum(b[..., :, None, 1], b[..., None, :, 1])
    yy2 = torch.minimum(b[..., :, None, 2], b[..., None, :, 2])
    xx2 = torch.minimum(b[..., :, None, 3], b[..., None, :, 3])
    inter = torch.clamp(yy2 - yy1, min=0) * torch.clamp(xx2 - xx1, min=0)
    union = area[..., :, None] + area[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros((), dtype=b.dtype, device=b.device))


def _static_inputs(node, in_values, inputs=None):
    """(max_boxes_per_class, iou_thr, score_thr, soft_sigma) from the
    optional constant inputs 2..5 (the spec's defaults where absent)."""
    def val(i, default):
        v = None
        if inputs is not None and i in inputs:
            v = inputs[i]
        elif in_values is not None:
            v = in_values.get(i)
        if v is None:
            if i in node.inputs:  # connected but not statically known
                raise ValueError(
                    f"NonMaxSuppression {node.name}: input {i} must be "
                    "constant (static output shapes)")
            return default
        return float(np.asarray(v).reshape(()))

    max_boxes = int(val(2, 0))
    iou_thr = val(3, 0.0)
    score_thr = val(4, 0.0)
    sigma = val(5, 0.0)
    if sigma < 0.0:
        raise ValueError("NonMaxSuppression: soft_nms_sigma must be non-negative")
    return max_boxes, iou_thr, score_thr, sigma


def _sel_bound(node, in_shapes, in_values):
    n, num_boxes, _ = in_shapes[0]
    _, classes, _ = in_shapes[1]
    max_boxes, _, _, _ = _static_inputs(node, in_values)
    per_class = num_boxes if max_boxes <= 0 else min(max_boxes, num_boxes)
    return int(n * classes * per_class)


def _ports(node):
    ports = sorted(node.outputs)
    if len(ports) == 3:
        return ports
    return [node.out_port + i for i in range(3)]


def greedy_nms_sweep(iou_sorted, valid_sorted, iou_thr, max_keep):
    """Sequential greedy NMS over candidates already sorted by descending
    score, batched over the leading dims: iou_sorted (..., n, n),
    valid_sorted (..., n) bool.  A candidate is kept iff it is valid, the
    keep budget ``max_keep`` is not spent, and no kept earlier candidate
    overlaps it beyond ``iou_thr``.  One step per candidate, each a few
    device operations on every slice at once (the JAX package's
    ``lax.fori_loop`` under vmap).  The budget is applied after the sweep:
    until it is spent the kept set is the one the budgeted sweep keeps,
    and after it nothing is kept, so the budgeted keep mask is the
    unbudgeted one's first ``max_keep`` candidates.  Returns (keep mask
    (..., n), kept count (...,) int32)."""
    n = iou_sorted.shape[-1]
    earlier = torch.ones(n, n, dtype=torch.bool, device=iou_sorted.device).tril(-1)
    overlaps = (iou_sorted > iou_thr) & earlier  # [i, j]: j before i, IoU past the threshold
    keep = torch.zeros(valid_sorted.shape, dtype=torch.bool, device=iou_sorted.device)
    for i in range(n):
        keep[..., i] = valid_sorted[..., i] & ~(overlaps[..., i, :] & keep).any(-1)
    keep &= keep.cumsum(-1) <= max_keep
    return keep, keep.sum(-1, dtype=torch.int32)


def nms_greedy_np(boxes, scores, max_boxes, iou_thr, score_thr, p, sigma=0.0):
    """Reference sequential greedy NMS.  boxes (N, B, 4), scores (N, C, B) →
    (indices (S, 3), sel_scores (S, 3), valid).  ``sigma`` > 0 is Soft-NMS
    with Gaussian weighting: each pick decays every surviving candidate by
    ``exp(-0.5·iou²/σ)`` (zero past ``iou_threshold``), selection stops
    when the best decayed score drops to ``score_threshold``, and the
    reported score is the decayed one."""
    n, num_boxes, _ = boxes.shape
    classes = scores.shape[1]
    per_class = num_boxes if max_boxes <= 0 else min(max_boxes, num_boxes)
    rows = []
    for b in range(n):
        corner = _corner(boxes[b].astype(np.float64), p["box_encoding"])
        iou = _iou_np(corner)
        for c in range(classes):
            s = scores[b, c].astype(np.float64)
            if sigma > 0.0:
                w_mat = np.where(iou <= iou_thr, np.exp(-0.5 * iou * iou / sigma), 0.0)
                s = s.copy()
                for _ in range(per_class):
                    i = int(np.argmax(s))
                    if not s[i] > score_thr:
                        break
                    rows.append((b, c, i, s[i]))
                    s = s * w_mat[i]
                    s[i] = -np.inf
                continue
            order = np.argsort(-s, kind="stable")
            kept = []
            for i in order:
                if s[i] <= score_thr or len(kept) >= per_class:
                    continue  # the spec's strictly-greater score filter
                if any(iou[i, j] > iou_thr for j in kept):
                    continue
                kept.append(int(i))
            rows.extend((b, c, i, s[i]) for i in kept)
    if p["sort_result_descending"]:
        rows.sort(key=lambda r: (-r[3], r[0], r[1], r[2]))
    S = n * classes * per_class
    idx = np.full((S, 3), -1, np.int64)
    sel = np.full((S, 3), -1.0, np.float32)
    for k, (b, c, i, sc) in enumerate(rows):
        idx[k] = (b, c, i)
        sel[k] = (b, c, sc)
    return idx, sel, np.asarray([len(rows)], np.int64)


def _stable_order(key):
    return torch.sort(key, dim=-1, stable=True).indices


def _gather_rows(iou, order):
    """iou (N, B, B) seen from each (batch, class) slice in its own sorted
    order: (N, C, B, B) with [b, c, i, j] = iou[b, order[b, c, i], order[b, c, j]]."""
    n, classes, num_boxes = order.shape
    full = iou[:, None].expand(n, classes, num_boxes, num_boxes)
    rows = torch.gather(full, 2, order[..., :, None].expand(-1, -1, -1, num_boxes))
    return torch.gather(rows, 3, order[..., None, :].expand(-1, -1, num_boxes, -1))


def _records(b_idx, c_idx, i_idx, scores, valid, order):
    """The padded (S, 3) outputs from flat candidates ranked by ``order``."""
    ok = valid[order][:, None]
    idx = torch.stack([b_idx[order], c_idx[order], i_idx[order]], 1)
    sel = torch.stack([b_idx[order].float(), c_idx[order].float(), scores[order]], 1)
    return (torch.where(ok, idx, torch.full_like(idx, -1)),
            torch.where(ok, sel, torch.full_like(sel, -1.0)))


@register
class NonMaxSuppression(Op):
    type_name = "NonMaxSuppression"

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        S = _sel_bound(node, in_shapes, in_values)
        p0, p1, p2 = _ports(node)
        return ShapeResult({p0: (S, 3), p1: (S, 3), p2: (1,)})

    def ref_compute(self, node, inputs) -> Dict[int, np.ndarray]:
        p = _params(node)
        max_boxes, iou_thr, score_thr, sigma = _static_inputs(node, None, inputs)
        idx, sel, valid = nms_greedy_np(inputs[0], inputs[1], max_boxes, iou_thr, score_thr,
                                        p, sigma=sigma)
        if p["output_type"] == "i32":
            idx = idx.astype(np.int32)
            valid = valid.astype(np.int32)
        p0, p1, p2 = _ports(node)
        return {p0: idx, p1: sel, p2: valid}

    def emit(self, ctx, node, inputs) -> Dict[int, TValue]:
        p = _params(node)
        max_boxes, iou_thr, score_thr, sigma = _static_inputs(
            node, {i: ctx.static_value(node, i) for i in (2, 3, 4, 5) if i in node.inputs})
        boxes = inputs[0].arr.float()    # (N, B, 4)
        scores = inputs[1].arr.float()   # (N, C, B)
        n, num_boxes, _ = boxes.shape
        classes = scores.shape[1]
        per_class = num_boxes if max_boxes <= 0 else min(max_boxes, num_boxes)
        iou = iou_matrices(_corner(boxes, p["box_encoding"]))  # (N, B, B)
        dev = scores.device
        out_dt = torch_dtype(np.int32 if p["output_type"] == "i32" else np.int64)
        p0, p1, p2 = _ports(node)
        if sigma > 0.0:
            idx, sel, total = self._emit_soft(p, iou, scores, per_class, iou_thr, score_thr,
                                              sigma)
        else:
            order = _stable_order(-scores)                       # (N, C, B)
            valid_sorted = torch.gather(scores, -1, order) > score_thr
            keep_sorted, cnt = greedy_nms_sweep(_gather_rows(iou, order), valid_sorted,
                                                iou_thr, per_class)
            keep = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
            # rank every (b, c, box) by validity, then score (or, grouped,
            # by (b, c) block and rank within its class), take the first S
            S = n * classes * per_class
            flat = torch.arange(n * classes * num_boxes, device=dev)
            b_idx = flat // (classes * num_boxes)
            c_idx = flat // num_boxes % classes
            i_idx = flat % num_boxes
            valid = keep.reshape(-1)
            flat_scores = scores.reshape(-1)
            if p["sort_result_descending"]:
                inf = torch.full_like(flat_scores, float("inf"))
                rank = _stable_order(torch.where(valid, -flat_scores, inf))[:S]
            else:
                rank_in = _stable_order(_stable_order(-scores)).reshape(-1)
                key = (b_idx * classes + c_idx) * num_boxes + rank_in
                rank = _stable_order(torch.where(
                    valid, key, torch.full_like(key, n * classes * num_boxes + 1)))[:S]
            idx, sel = _records(b_idx, c_idx, i_idx, flat_scores, valid, rank)
            total = cnt.sum().reshape(1)
        return {p0: TValue(idx.to(out_dt)), p1: TValue(sel), p2: TValue(total.to(out_dt))}

    @staticmethod
    def _emit_soft(p, iou, scores, per_class, iou_thr, score_thr, sigma):
        """Soft-NMS: per (batch, class), ``per_class`` picks of the argmax
        of the decayed scores (the first of equal ones), each decaying the
        others by its row of ``exp(-0.5·iou²/σ)`` (0 past the threshold),
        every slice at once."""
        n, classes, num_boxes = scores.shape
        w_mat = torch.where(iou <= iou_thr, torch.exp(-0.5 * iou * iou / sigma),
                            torch.zeros((), device=iou.device))     # (N, B, B)
        w_mat = w_mat[:, None].expand(n, classes, num_boxes, num_boxes)
        s_cur = scores.clone()
        sel_i = torch.full((n, classes, per_class), -1, dtype=torch.int64, device=scores.device)
        sel_s = torch.full((n, classes, per_class), -1.0, device=scores.device)
        cnt = torch.zeros((n, classes), dtype=torch.int32, device=scores.device)
        for k in range(per_class):
            i = torch.argmax(s_cur, -1, keepdim=True)             # (N, C, 1)
            best = torch.gather(s_cur, -1, i)
            ok = best > score_thr
            sel_i[..., k:k + 1] = torch.where(ok, i, torch.full_like(i, -1))
            sel_s[..., k:k + 1] = torch.where(ok, best, torch.full_like(best, -1.0))
            row = torch.gather(w_mat, 2, i[..., None].expand(-1, -1, 1, num_boxes))[..., 0, :]
            decayed = (s_cur * row).scatter(-1, i, float("-inf"))
            s_cur = torch.where(ok, decayed, s_cur)
            cnt += ok[..., 0]
        S = n * classes * per_class
        flat = torch.arange(S, device=scores.device)
        b_idx = flat // (classes * per_class)
        c_idx = flat // per_class % classes
        flat_i, flat_s = sel_i.reshape(-1), sel_s.reshape(-1)
        valid = flat_i >= 0
        if p["sort_result_descending"]:
            rank = _stable_order(torch.where(valid, -flat_s, torch.full_like(flat_s, float("inf"))))
        else:
            # the slots are already in (b, c, pick) order: pack each class's
            # valid prefix to the front
            rank = _stable_order((~valid).to(torch.int8))
        idx, sel = _records(b_idx, c_idx, flat_i, flat_s, valid, rank)
        return idx, sel, cnt.sum().reshape(1)
