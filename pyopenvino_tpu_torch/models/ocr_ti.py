"""Weights of the port's ocr-ti (``models/ocr_ti.xml``).

The IR is the text-line OCR sequence model of the JAX package's
``tools/gen_ocr.py`` (``GENERATOR_VERSION`` 1): a (1, 24, 32) feature strip
(24 frames of 32 features), a forward and a reverse TensorIterator whose
body is one LSTMCell of hidden size 48 (the frame sliced along axis 1,
``start=-1, end=0, stride=-1`` for the reverse one; back edges carry (h, c)
from zero initial states), a Concat of the two (1, 24, 48) sequences, a
per-frame 27-class MatMul head with a (1, 27) bias, a Transpose to
(1, 27, 24) and a SoftMax over the classes (26 letters and the CTC blank).
The XML is the one that generator writes; this module is the port's
numpy-only replay of its draws, byte for byte the same ``.bin``:

  * one ``np.random.default_rng(seed)`` consumed in build order: the
    forward cell's W (4H, F) from N(0, 1)·√(1/F)/255 (the 0..255 input
    scale folded in), R (4H, H) from N(0, 1)·√(1/H), B (4H) from
    N(0, 1)·0.05 with 1 added to the forget gate's biases (the first H of
    fico), then the reverse cell's, then the head's (2H, 27) weights from
    N(0, 1)·√(1/2H) and (1, 27) biases from N(0, 1)·0.05;
  * the zero initial states (1, 48) and the integer Consts: each body's
    Reshape targets (1, 32) and (1, 1, 48), the outer Reshape targets
    (24, 96) and (1, 24, 27), the Transpose order (0, 2, 1).

The Consts are written in the IR writer's order (node-id order, each
TensorIterator's body Consts where its layer is written; models/synth.py
``writer_order_consts``), at the offsets the XML declares.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from pyopenvino_tpu_torch.models.synth import MODELS_DIR, replay_blob, replayed_bin

OCR_TI_XML = os.path.join(MODELS_DIR, "ocr_ti.xml")
FRAMES, FEATURES, HIDDEN, CLASSES = 24, 32, 48, 27


def _cell_weights(rng, in_dim, hidden, in_scale=1.0):
    w = (rng.standard_normal((4 * hidden, in_dim)) * np.sqrt(1.0 / in_dim)
         * in_scale).astype(np.float32)
    r = (rng.standard_normal((4 * hidden, hidden)) * np.sqrt(1.0 / hidden)).astype(np.float32)
    bias = (rng.standard_normal(4 * hidden) * 0.05).astype(np.float32)
    bias[:hidden] += 1.0  # the forget gate (fico)
    return w, r, bias


def const_values(seed: int = 0) -> List[np.ndarray]:
    """Every Const of the network in the writer's order."""
    rng = np.random.default_rng(seed)
    zeros = np.zeros((1, HIDDEN), np.float32)
    out: List[np.ndarray] = []
    for _direction in ("fwd", "bwd"):
        w, r, bias = _cell_weights(rng, FEATURES, HIDDEN, in_scale=1.0 / 255.0)
        out += [zeros, zeros,  # h0, c0
                np.asarray((1, FEATURES), np.int64), w, r, bias,
                np.asarray((1, 1, HIDDEN), np.int64)]
    w_out = (rng.standard_normal((2 * HIDDEN, CLASSES)) * np.sqrt(1.0 / (2 * HIDDEN))
             ).astype(np.float32)
    b_out = (rng.standard_normal((1, CLASSES)) * 0.05).astype(np.float32)
    return out + [np.asarray((FRAMES, 2 * HIDDEN), np.int64), w_out, b_out,
                  np.asarray((1, FRAMES, CLASSES), np.int64), np.asarray((0, 2, 1), np.int64)]


def generate_weights(xml_text: str, seed: int = 0) -> bytes:
    """The ``.bin`` blob for the XML (``models/synth.py::replay_blob``)."""
    return replay_blob(xml_text, const_values(seed=seed), "ocr_ti")


def ocr_ti_paths(seed: int = 0) -> Tuple[str, str]:
    """(xml, bin) of ocr-ti; the ``.bin`` is written to
    ``build/models/ocr_ti-seed<seed>.bin`` unless it exists."""
    return OCR_TI_XML, replayed_bin(OCR_TI_XML, lambda: const_values(seed=seed),
                                    f"ocr_ti-seed{seed}.bin")
