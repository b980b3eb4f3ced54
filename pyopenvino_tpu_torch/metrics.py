"""Accuracy metrics: top-1 agreement and accuracy, DetectionOutput record
tables and mean average precision.

The port's copy of ``pyopenvino_tpu/metrics.py`` (numpy only): top-k labels,
top-1 accuracy against labels and agreement between two runs; records parsed
up to the -1 row, greedy confidence-ordered matching (each ground-truth box
matched at most once), COCO's 101-point interpolated AP, averaged over the
classes present in the ground truth and over the IoU thresholds asked for
(``coco_map``: COCO's grid 0.50:0.95:0.05 by default); FP32 detections
as pseudo-ground-truth (``detections_as_gt``); and the host-side YOLO-v2
box decode of a RegionYolo output (``decode_region_yolo``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

# One detection: (class_id, confidence, (xmin, ymin, xmax, ymax))
Detection = Tuple[int, float, Tuple[float, float, float, float]]
# One ground-truth box: (class_id, (xmin, ymin, xmax, ymax))
GtBox = Tuple[int, Tuple[float, float, float, float]]

COCO_IOU_THRESHOLDS = tuple(np.round(np.arange(0.50, 1.00, 0.05), 2))


def topk_labels(logits: np.ndarray, k: int = 1) -> np.ndarray:
    """(N, C) scores → (N, k) class ids, best first."""
    logits = np.asarray(logits).reshape(logits.shape[0], -1)
    return np.argsort(logits, axis=1)[:, ::-1][:, :k]


def top1_accuracy(logits: np.ndarray, labels: Sequence[int]) -> float:
    """Fraction of examples whose argmax is the label."""
    return float(np.mean(topk_labels(logits, 1)[:, 0] == np.asarray(labels)))


def top1_agreement(ref_logits: np.ndarray, test_logits: np.ndarray) -> float:
    """Top-1 agreement of two runs over one image set: the first run's
    predictions as labels (delta = 1 - agreement)."""
    return top1_accuracy(test_logits, topk_labels(ref_logits, 1)[:, 0])


def parse_detection_records(records: np.ndarray) -> List[Detection]:
    """One (…, K, 7) record table [n, class_id, conf, xmin, ymin, xmax, ymax]
    up to its -1 row."""
    out: List[Detection] = []
    for row in np.asarray(records).reshape(-1, 7):
        if row[0] < 0:
            break
        out.append((int(row[1]), float(row[2]),
                    (float(row[3]), float(row[4]), float(row[5]), float(row[6]))))
    return out


def _iou_1many(box, boxes: np.ndarray) -> np.ndarray:
    if boxes.size == 0:
        return np.zeros((0,))
    x0 = np.maximum(box[0], boxes[:, 0])
    y0 = np.maximum(box[1], boxes[:, 1])
    x1 = np.minimum(box[2], boxes[:, 2])
    y1 = np.minimum(box[3], boxes[:, 3])
    inter = np.clip(x1 - x0, 0, None) * np.clip(y1 - y0, 0, None)
    a = (box[2] - box[0]) * (box[3] - box[1])
    b = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    return inter / np.maximum(a + b - inter, 1e-12)


def _ap_101(tp: np.ndarray, n_gt: int) -> float:
    """COCO 101-point interpolated AP of confidence-sorted TP flags."""
    if n_gt == 0:
        return float("nan")
    if tp.size == 0:
        return 0.0
    cum_tp = np.cumsum(tp)
    cum_fp = np.cumsum(1 - tp)
    recall = cum_tp / n_gt
    precision = cum_tp / np.maximum(cum_tp + cum_fp, 1e-12)
    prec_env = np.maximum.accumulate(precision[::-1])[::-1]
    idx = np.searchsorted(recall, np.linspace(0, 1, 101), side="left")
    p = np.where(idx < prec_env.size, prec_env[np.minimum(idx, prec_env.size - 1)], 0.0)
    return float(p.mean())


def average_precision(gt_by_img: Dict[object, List[GtBox]],
                      det_by_img: Dict[object, List[Detection]],
                      class_id: int, iou_thr: float) -> float:
    """AP of one class at one IoU threshold over an image set."""
    dets = [(conf, img, box) for img, dlist in det_by_img.items()
            for cls, conf, box in dlist if cls == class_id]
    dets.sort(key=lambda t: -t[0])
    gts = {img: np.asarray([b for c, b in boxes if c == class_id], dtype=np.float64)
           for img, boxes in gt_by_img.items()}
    n_gt = sum(g.shape[0] for g in gts.values())
    matched = {img: np.zeros(g.shape[0], dtype=bool) for img, g in gts.items()}
    tp = np.zeros(len(dets))
    for i, (_conf, img, box) in enumerate(dets):
        g = gts.get(img)
        if g is None or g.size == 0:
            continue
        ious = np.where(matched[img], -1.0, _iou_1many(np.asarray(box, dtype=np.float64), g))
        j = int(np.argmax(ious))
        if ious[j] >= iou_thr:
            tp[i] = 1.0
            matched[img][j] = True
    return _ap_101(tp, n_gt)


def mean_average_precision(gt_by_img: Dict[object, List[GtBox]],
                           det_by_img: Dict[object, List[Detection]],
                           iou_thresholds: Sequence[float] = (0.5,)) -> float:
    """mAP in percent, over the classes present in the ground truth and the
    given IoU thresholds (COCO's grid is 0.50:0.95:0.05)."""
    classes = sorted({c for boxes in gt_by_img.values() for c, _ in boxes})
    aps = [ap for thr in iou_thresholds for cls in classes
           if not np.isnan(ap := average_precision(gt_by_img, det_by_img, cls, float(thr)))]
    return float(np.mean(aps) * 100.0) if aps else float("nan")


def coco_map(gt_by_img: Dict[object, List[GtBox]],
             det_by_img: Dict[object, List[Detection]],
             iou_thresholds: Sequence[float] = COCO_IOU_THRESHOLDS) -> float:
    """mAP in percent over the classes present in the ground truth and
    COCO's IoU grid 0.50:0.95:0.05 (NaN without ground-truth classes)."""
    return mean_average_precision(gt_by_img, det_by_img, iou_thresholds)


def detections_as_gt(det_by_img: Dict[object, List[Detection]]) -> Dict[object, List[GtBox]]:
    """FP32 detections → pseudo-ground-truth boxes (confidences dropped)."""
    return {img: [(cls, box) for cls, _conf, box in dets]
            for img, dets in det_by_img.items()}


def decode_region_yolo(
    blob: np.ndarray,
    grid_hw,
    anchors,
    classes: int,
    coords: int = 4,
    conf_threshold: float = 0.3,
    iou_threshold: float = 0.45,
) -> List[Detection]:
    """YOLO-v2 host-side box decode of a RegionYolo output (what the OMZ
    demos do on the host after the region activation, ops/yolo.py).

    blob: the flattened (1, C·H·W) do_softmax layout or (1, C, H, W);
    anchors: [(aw, ah), ...] in grid units.  Returns [(class, score, (x0,
    y0, x1, y1))], normalized, NMS'd per class at ``iou_threshold``, sorted
    by score."""
    h, w = (int(d) for d in grid_hw)
    na = len(anchors)
    block = coords + 1 + classes
    t = np.asarray(blob, np.float32).reshape(na, block, h, w)

    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    aw = np.asarray([a[0] for a in anchors], np.float32).reshape(na, 1, 1)
    ah = np.asarray([a[1] for a in anchors], np.float32).reshape(na, 1, 1)
    bx = (t[:, 0] + xs) / w           # the op applied the logistic
    by = (t[:, 1] + ys) / h
    bw = np.exp(t[:, 2]) * aw / w
    bh = np.exp(t[:, 3]) * ah / h
    obj = t[:, coords]
    score = obj[:, None] * t[:, coords + 1:]  # (na, classes, h, w)

    dets: List[Detection] = []
    for a, c, y, x in np.argwhere(score > conf_threshold):
        cx, cy = float(bx[a, y, x]), float(by[a, y, x])
        bw_, bh_ = float(bw[a, y, x]), float(bh[a, y, x])
        dets.append((int(c), float(score[a, c, y, x]),
                     (cx - bw_ / 2, cy - bh_ / 2, cx + bw_ / 2, cy + bh_ / 2)))
    dets.sort(key=lambda d: -d[1])

    kept: List[Detection] = []
    for c in {d[0] for d in dets}:
        boxes = [d for d in dets if d[0] == c]
        arr = np.asarray([d[2] for d in boxes], np.float32)
        sel: List[Detection] = []
        for i, d in enumerate(boxes):
            if sel and (_iou_1many(arr[i], np.asarray([s[2] for s in sel], np.float32))
                        > iou_threshold).any():
                continue
            sel.append(d)
        kept.extend(sel)
    kept.sort(key=lambda d: -d[1])
    return kept
