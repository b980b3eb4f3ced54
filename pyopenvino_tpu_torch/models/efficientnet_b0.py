"""Weights of the port's EfficientNet-B0 (``models/efficientnet_b0.xml``).

The IR is the EfficientNet-B0 classifier at its published width (224×224,
1000 classes, 5.26 M parameters): MBConv blocks (1×1 expand, k×k depthwise,
a squeeze-and-excitation gate ReduceMean → 1×1 → Swish → 1×1 → Sigmoid →
Multiply, 1×1 linear project, identity residual at stride 1) with Swish
activations and folded batch norm.  The XML is the one that the JAX
package's ``tools/gen_efficientnet.py`` writes; this module is the port's
numpy-only replay of that generator's weight draws, byte for byte the same
``.bin``:

  * one ``np.random.default_rng(seed)`` consumed in build order: the stem,
    the 16 blocks, the 1×1 head, then the classifier;
  * a conv draws its He-init weight, then its N(0, 0.02) bias; the stem's
    weight is scaled by 1/255 (the input scale folded in) and every
    project conv's by 0.6; the SE convs have no bias;
  * the classifier draws 8·N(0, 1/1280) weights, N(0, 0.002) biases, then
    four "hot" classes that get +8, +6, +4.5 and +3.5: a bias ladder that
    keeps the top classes of a random deep net apart, so INT8 agreement
    measures the engine and not near-ties;
  * the integer Consts are the ReduceMean axes (2, 3).

The generic ``models/synth.py`` (He-init per .bin region, no ladder) would
give a different, near-tied network, and it refuses integer Consts that
feed a ReduceMean.  Consts are written in node-id order, which is the
generator's creation order, at the offsets the XML declares.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from pyopenvino_tpu_torch.models.synth import MODELS_DIR, replay_blob, replayed_bin

EFFICIENTNET_B0_XML = os.path.join(MODELS_DIR, "efficientnet_b0.xml")

# (expansion t, out channels c, repeats n, first stride s, kernel k)
BLOCKS = [(1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 2, 2, 5), (6, 80, 3, 2, 3),
          (6, 112, 3, 1, 5), (6, 192, 4, 2, 5), (6, 320, 1, 1, 3)]
_AXES = np.asarray((2, 3), np.int64)


def const_values(num_classes: int = 1000, seed: int = 0) -> List[np.ndarray]:
    """Every Const of the network in creation order."""
    rng = np.random.default_rng(seed)
    out: List[np.ndarray] = []

    def conv(ci, co, k, in_scale=1.0):
        w = rng.normal(0, np.sqrt(2.0 / (ci * k * k)), (co, ci, k, k)).astype(
            np.float32) * in_scale
        out.extend((w, rng.normal(0, 0.02, (1, co, 1, 1)).astype(np.float32)))

    def depthwise(c, k):
        w = rng.normal(0, np.sqrt(2.0 / (k * k)), (c, 1, 1, k, k)).astype(np.float32)
        out.extend((w, rng.normal(0, 0.02, (1, c, 1, 1)).astype(np.float32)))

    def se(c, se_ch):
        out.append(_AXES)
        out.append(rng.normal(0, np.sqrt(2.0 / c), (se_ch, c, 1, 1)).astype(np.float32))
        out.append(rng.normal(0, np.sqrt(2.0 / se_ch), (c, se_ch, 1, 1)).astype(np.float32))

    conv(3, 32, 3, in_scale=1.0 / 255.0)
    ci = 32
    for t, co, n, _s, k in BLOCKS:
        for _ in range(n):
            mid = ci * t
            if t != 1:
                conv(ci, mid, 1)
            depthwise(mid, k)
            se(mid, max(1, ci // 4))
            conv(mid, co, 1, in_scale=0.6)
            ci = co
    conv(ci, 1280, 1)
    out.append(_AXES)
    wf = (8.0 * rng.normal(0, np.sqrt(1.0 / 1280), (1280, num_classes))).astype(np.float32)
    bf = rng.normal(0, 0.002, (1, num_classes)).astype(np.float32)
    hot = rng.choice(num_classes, 4, replace=False)
    bf[0, hot] += np.array([8.0, 6.0, 4.5, 3.5], np.float32)
    out.extend((wf, bf))
    return out


def generate_weights(xml_text: str, seed: int = 0) -> bytes:
    """The ``.bin`` blob for the XML (``models/synth.py::replay_blob``)."""
    return replay_blob(xml_text, const_values(seed=seed), "efficientnet_b0")


def efficientnet_b0_paths(seed: int = 0) -> Tuple[str, str]:
    """(xml, bin) of full-width EfficientNet-B0; the ``.bin`` is written to
    ``build/models/efficientnet_b0-seed<seed>.bin`` unless it exists."""
    return EFFICIENTNET_B0_XML, replayed_bin(
        EFFICIENTNET_B0_XML, lambda: const_values(seed=seed),
        f"efficientnet_b0-seed{seed}.bin")
