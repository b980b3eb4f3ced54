"""Weights of the port's lstm-tiny (``models/lstm_tiny.xml``).

The IR is the speech-command-style sequence classifier of the JAX package's
``tools/gen_lstm.py``: a (1, 32, 40) feature input (32 frames of 40
features), a bidirectional LSTMSequence of hidden size 64, a Transpose and
Reshape to (1, 32, 128) (the two directions side by side per frame), a
forward LSTMSequence of hidden size 64 whose final hidden state, reshaped to
(1, 64), feeds a 30-class MatMul head with a (1, 30) bias and a SoftMax.
The sequence lengths are a (1,) Const of 32 and the initial states zero
Consts.  The XML is the one that generator writes; this module is the
port's numpy-only replay of its draws, byte for byte the same ``.bin``:

  * one ``np.random.default_rng(seed)`` consumed in build order: the first
    layer's forward then reverse weights, the second layer's, the head;
  * an LSTM layer draws W (4H, I) from N(0, 1)·√(1/I)·scale (scale
    8/255 in the first layer, the input scale folded in, else 1), R (4H, H)
    from N(0, 1)·√(1/H), B (4H) from N(0, 1)·0.05, then adds 1 to the
    forget gate's biases (the first H of fico);
  * the head draws N(0, 1/64) weights, N(0, 0.02) biases, then four "hot"
    classes that get +8, +6, +4.5 and +3.5;
  * the integer Consts: the sequence lengths (32,), the Transpose order
    (0, 2, 1, 3), the Reshape targets (1, 32, 128) and (1, 64).

Consts are written in node-id order, which is the generator's creation
order, at the offsets the XML declares.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from pyopenvino_tpu_torch.models.synth import MODELS_DIR, replay_blob, replayed_bin

LSTM_TINY_XML = os.path.join(MODELS_DIR, "lstm_tiny.xml")
FRAMES, FEATURES, HIDDEN = 32, 40, 64


def _lstm_weights(rng, in_dim, hidden, scale=1.0):
    w = (rng.standard_normal((4 * hidden, in_dim)) * np.sqrt(1.0 / in_dim)
         * scale).astype(np.float32)
    r = (rng.standard_normal((4 * hidden, hidden)) * np.sqrt(1.0 / hidden)).astype(np.float32)
    bias = (rng.standard_normal(4 * hidden) * 0.05).astype(np.float32)
    bias[:hidden] += 1.0
    return w, r, bias


def const_values(num_classes: int = 30, seed: int = 0) -> List[np.ndarray]:
    """Every Const of the network in creation order."""
    rng = np.random.default_rng(seed)
    zeros2 = np.zeros((1, 2, HIDDEN), np.float32)
    zeros1 = np.zeros((1, 1, HIDDEN), np.float32)
    fwd = _lstm_weights(rng, FEATURES, HIDDEN, scale=1.0 / 255.0 * 8)
    rev = _lstm_weights(rng, FEATURES, HIDDEN, scale=1.0 / 255.0 * 8)
    out = [np.full((1,), FRAMES, np.int32), zeros2, zeros2]
    out += [np.stack([f, r]) for f, r in zip(fwd, rev)]
    out += [np.asarray((0, 2, 1, 3), np.int64), np.asarray((1, FRAMES, 2 * HIDDEN), np.int64)]
    second = _lstm_weights(rng, 2 * HIDDEN, HIDDEN)
    out += [zeros1, zeros1] + [v[None] for v in second]
    out.append(np.asarray((1, HIDDEN), np.int64))
    w = rng.normal(0, np.sqrt(1.0 / HIDDEN), (HIDDEN, num_classes)).astype(np.float32)
    bias = rng.normal(0, 0.02, (1, num_classes)).astype(np.float32)
    hot = rng.choice(num_classes, 4, replace=False)
    bias[0, hot] += np.array([8.0, 6.0, 4.5, 3.5], np.float32)
    return out + [w, bias]


def generate_weights(xml_text: str, seed: int = 0) -> bytes:
    """The ``.bin`` blob for the XML (``models/synth.py::replay_blob``)."""
    return replay_blob(xml_text, const_values(seed=seed), "lstm_tiny")


def lstm_tiny_paths(seed: int = 0) -> Tuple[str, str]:
    """(xml, bin) of lstm-tiny; the ``.bin`` is written to
    ``build/models/lstm_tiny-seed<seed>.bin`` unless it exists."""
    return LSTM_TINY_XML, replayed_bin(LSTM_TINY_XML, lambda: const_values(seed=seed),
                                       f"lstm_tiny-seed{seed}.bin")
