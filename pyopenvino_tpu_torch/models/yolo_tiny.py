"""Weights of the port's yolo-tiny (``models/yolo_tiny.xml``).

The IR is the tiny YOLO-v2 detector of the JAX package's
``tools/gen_yolo.py`` (``build_yolo_tiny``): a 1×3×160×160 input, seven
blocks of a 3×3 stride-1 conv (pads 1), a per-channel bias Add and a PReLU
with a rank-0 slope of 0.1 (16, 32, 64, 128, 256, 256, 256 channels), the
first five followed by a 2×2 stride-2 MaxPool, the sixth by yolo-v2-tiny's
stride-1 "same" 2×2 MaxPool (pads (0, 1)), down to a 5×5 grid; a 1×1 head
of 45 channels with a bias, and RegionYolo (5 anchors, 4 classes, 4
coordinates, ``do_softmax``) whose (1, 1125) region blob is the output.
The XML is the one that generator writes; this module is the port's
numpy-only replay of its draws, byte for byte the same ``.bin``:

  * one ``np.random.default_rng(seed)``, seed 20260820, consumed in build
    order;
  * a block draws its He-init weight N(0, 1)·√(2/(9·Ci)) (the first
    block's divided by 255, the input scale folded in), then its bias
    U(−0.05, 0.05); its slope is the constant 0.1, which the XML declares
    with shape "1";
  * the head draws N(0, 1)·√(2/256)·0.6 weights, multiplies each anchor's
    objectness row by 4.5 and its class rows by 3, and takes a zero bias
    with −2 on each objectness channel (a random input fires a sparse set
    of cells).

Consts are written in node-id order, which is the generator's creation
order, at the offsets the XML declares.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from pyopenvino_tpu_torch.models.synth import MODELS_DIR, replay_blob, replayed_bin

YOLO_TINY_XML = os.path.join(MODELS_DIR, "yolo_tiny.xml")
SEED = 20260820
IMG, GRID, CLASSES, COORDS = 160, 5, 4, 4
# (aw, ah) in grid units, as the IR's RegionYolo ``anchors`` attribute holds them
ANCHORS = ((0.6, 0.8), (1.2, 1.2), (2.0, 1.5), (1.5, 2.4), (3.2, 3.0))
WIDTHS = (3, 16, 32, 64, 128, 256, 256, 256)


def const_values(seed: int = SEED) -> List[np.ndarray]:
    """Every Const of the network in creation order."""
    rng = np.random.default_rng(seed)

    def he(shape, fan_in, scale=1.0):
        return (rng.standard_normal(shape) * np.sqrt(2.0 / fan_in) * scale).astype(np.float32)

    out: List[np.ndarray] = []
    for i, (ci, co) in enumerate(zip(WIDTHS, WIDTHS[1:])):
        w = he((co, ci, 3, 3), ci * 9)
        if i == 0:
            w = w / 255.0
        out += [w, rng.uniform(-0.05, 0.05, (1, co, 1, 1)).astype(np.float32),
                np.full((1,), 0.1, np.float32)]
    block = COORDS + 1 + CLASSES
    co = len(ANCHORS) * block
    head_w = he((co, 256, 1, 1), 256, scale=0.6)
    head_b = np.zeros((1, co, 1, 1), np.float32)
    for a in range(len(ANCHORS)):
        head_w[a * block + COORDS] *= 4.5
        head_b[0, a * block + COORDS, 0, 0] = -2.0
        head_w[a * block + COORDS + 1:(a + 1) * block] *= 3.0
    return out + [head_w, head_b]


def generate_weights(xml_text: str, seed: int = SEED) -> bytes:
    """The ``.bin`` blob for the XML (``models/synth.py::replay_blob``)."""
    return replay_blob(xml_text, const_values(seed=seed), "yolo_tiny")


def yolo_tiny_paths(seed: int = SEED) -> Tuple[str, str]:
    """(xml, bin) of yolo-tiny; the ``.bin`` is written to
    ``build/models/yolo_tiny-seed<seed>.bin`` unless it exists."""
    return YOLO_TINY_XML, replayed_bin(YOLO_TINY_XML, lambda: const_values(seed=seed),
                                       f"yolo_tiny-seed{seed}.bin")
