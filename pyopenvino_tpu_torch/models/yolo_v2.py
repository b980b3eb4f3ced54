"""Weights of the port's yolo-v2 (``models/yolo_v2.xml``).

The IR is the YOLO-v2 detector of the JAX package's ``tools/gen_yolo.py``
(``build_yolo_v2``, version 201 in ``__graft_entry__``): yolo-tiny's 160×160
trunk to the 5×5 grid (six 3×3 conv / bias / PReLU(0.1) blocks of 16, 32,
64, 128, 256, 256 channels, the first five with a 2×2 stride-2 MaxPool),
the ReorgYolo passthrough of the 128-channel 10×10 map concatenated with
the trunk (768 channels), a 1×1 fuse conv of 256 with a PReLU, a 1×1 head
of 45 channels with a bias, RegionYolo (5 anchors, 4 classes, 4
coordinates, ``do_softmax``), then the box decode and NonMaxSuppression on
the device (``append_yolo_decode``): a VariadicSplit of the region blob
into x, y, w, h, objectness and classes, grid offsets, ``exp`` of the sizes
against the anchor priors, corners, per-class confidences
objectness·class, NonMaxSuppression (12 boxes a class, IoU 0.45, score
0.25, sorted by score, ``output_type`` i32) and a gather of the kept
corners into a (48, 7) record table [image, class, confidence, x0, y0, x1,
y1], pad rows -1 (their corners multiplied by the GreaterEqual mask).  The
XML is the one that generator writes; this module is the port's numpy-only
replay of its draws, byte for byte the same ``.bin``:

  * one ``np.random.default_rng(seed)``, seed 20260820, consumed in build
    order: each block's He-init weight N(0, 1)·√(2/(9·Ci)) (the first
    divided by 255, the input scale folded in) and its bias U(−0.05, 0.05);
    the fuse weight N(0, 1)·√(2/768); the head's N(0, 1)·√(2/256)·0.6 with
    each anchor's objectness row ×4.5 and class rows ×3, and a zero bias
    with −2 on each objectness channel;
  * the rest are constants: the slopes 0.1, the decode's split lengths,
    grid offsets, 1/5 scales, anchor priors over the grid, 0.5, the
    Reshape and Transpose targets, NonMaxSuppression's limits and the
    gathers' indices and axes.

Consts are written in node-id order, the generator's creation order, at
the offsets the XML declares.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from pyopenvino_tpu_torch.models.synth import MODELS_DIR, replay_blob, replayed_bin
from pyopenvino_tpu_torch.models.yolo_tiny import ANCHORS, CLASSES, COORDS, GRID, IMG  # noqa: F401

YOLO_V2_XML = os.path.join(MODELS_DIR, "yolo_v2.xml")
SEED = 20260820
WIDTHS = (3, 16, 32, 64, 128, 256, 256)
MAX_OUT, IOU_THRESHOLD, SCORE_THRESHOLD = 12, 0.45, 0.25
RECORDS = MAX_OUT * CLASSES


def _i64(*v):
    return np.asarray(v, np.int64)


def const_values(seed: int = SEED) -> List[np.ndarray]:
    """Every Const of the network in creation order."""
    rng = np.random.default_rng(seed)

    def he(shape, fan_in, scale=1.0):
        return (rng.standard_normal(shape) * np.sqrt(2.0 / fan_in) * scale).astype(np.float32)

    slope = np.full((1,), 0.1, np.float32)
    out: List[np.ndarray] = []
    for i, (ci, co) in enumerate(zip(WIDTHS, WIDTHS[1:])):
        w = he((co, ci, 3, 3), ci * 9)
        if i == 0:
            w = w / 255.0
        out += [w, rng.uniform(-0.05, 0.05, (1, co, 1, 1)).astype(np.float32), slope]
    out += [he((256, 768, 1, 1), 768), slope]
    block = COORDS + 1 + CLASSES
    na, co = len(ANCHORS), len(ANCHORS) * block
    head_w = he((co, 256, 1, 1), 256, scale=0.6)
    head_b = np.zeros((1, co, 1, 1), np.float32)
    for a in range(na):
        head_w[a * block + COORDS] *= 4.5
        head_b[0, a * block + COORDS, 0, 0] = -2.0
        head_w[a * block + COORDS + 1:(a + 1) * block] *= 3.0
    out += [head_w, head_b]
    # the decode (append_yolo_decode)
    h = w = GRID
    cells = na * h * w
    scale = np.full((1,), np.float32(1.0 / w), np.float32)
    out += [_i64(na, block, h, w), _i64(1), _i64(1, 1, 1, COORDS - 3, 1, CLASSES),
            np.full((1,), 0.5, np.float32),
            np.tile(np.arange(w, dtype=np.float32), (h, 1)).reshape(1, 1, h, w), scale,
            np.repeat(np.arange(h, dtype=np.float32), w).reshape(1, 1, h, w), scale,
            np.asarray([a[0] for a in ANCHORS], np.float32).reshape(na, 1, 1, 1) / w,
            np.asarray([a[1] for a in ANCHORS], np.float32).reshape(na, 1, 1, 1) / h,
            _i64(0, 2, 3, 1), _i64(1, cells, 4), _i64(1, 0, 2, 3), _i64(1, CLASSES, cells),
            _i64(MAX_OUT), np.full((1,), IOU_THRESHOLD, np.float32),
            np.full((1,), SCORE_THRESHOLD, np.float32),
            _i64(cells, 4), _i64(2), _i64(1), np.zeros((1, 1), np.int32), _i64(-1), _i64(0),
            _i64(0), _i64(1), np.zeros((1, 1), np.float32)]
    return out


def generate_weights(xml_text: str, seed: int = SEED) -> bytes:
    """The ``.bin`` blob for the XML (``models/synth.py::replay_blob``)."""
    return replay_blob(xml_text, const_values(seed=seed), "yolo_v2")


def yolo_v2_paths(seed: int = SEED) -> Tuple[str, str]:
    """(xml, bin) of yolo-v2; the ``.bin`` is written to
    ``build/models/yolo_v2-seed<seed>.bin`` unless it exists."""
    return YOLO_V2_XML, replayed_bin(YOLO_V2_XML, lambda: const_values(seed=seed),
                                     f"yolo_v2-seed{seed}.bin")
