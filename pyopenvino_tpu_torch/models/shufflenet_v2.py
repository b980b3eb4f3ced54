"""Weights of the port's ShuffleNet-v2 1.0× (``models/shufflenet_v2.xml``).

The IR is ShuffleNet-v2 at its published width (224×224, 1000 classes,
stages of 116, 232 and 464 channels with 4, 8 and 4 units, a 1024-wide
1×1 head, 2.3 M parameters): a stride-2 3×3 stem and a 3×3/2 MaxPool, then
per stage one downsampling unit (two branches, no Split) and basic units
(Split into halves → identity ‖ 1×1 · 3×3 depthwise · 1×1 → Concat), each
unit ending in a channel shuffle (Reshape (1, 2, C/2, H, W) → Transpose
(0, 2, 1, 3, 4) → Reshape (1, C, H, W)), global average pooling as
ReduceMean over (2, 3), a MatMul classifier and SoftMax.  The XML is the
one the JAX package's ``tools/gen_shufflenet.py`` writes; this module is
the port's numpy-only replay of that generator's draws, byte for byte the
same ``.bin``:

  * one ``np.random.default_rng(seed)`` consumed in build order;
  * a conv draws its He-init weight, then its N(0, 0.02) bias; the stem's
    weight is scaled by 1/255 (the input scale folded in) and each basic
    unit's closing 1×1 by 0.8; a depthwise conv draws N(0, 1/9) weights
    (no activation follows it), then its bias;
  * the classifier draws 8·N(0, 1/1024) weights, N(0, 0.002) biases,
    then four "hot" classes that get +8, +6, +4.5 and +3.5: a bias ladder
    that keeps the top classes of a random deep net apart, so INT8
    agreement measures the engine and not near-ties;
  * the integer Consts: each Split's axis (1), each shuffle's two Reshape
    targets and its Transpose order, the ReduceMean axes (2, 3).

``models/synth.py`` refuses this IR's integer Consts that feed a Split or
a Transpose.  Consts are written in node-id order, which is the
generator's creation order, at the offsets the XML declares.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from pyopenvino_tpu_torch.models.synth import MODELS_DIR, replay_blob, replayed_bin

SHUFFLENET_V2_XML = os.path.join(MODELS_DIR, "shufflenet_v2.xml")

# ShuffleNet-v2 1.0×: (out channels, units) per stage
STAGES = [(116, 4), (232, 8), (464, 4)]


def const_values(num_classes: int = 1000, seed: int = 0) -> List[np.ndarray]:
    """Every Const of the network in creation order."""
    rng = np.random.default_rng(seed)
    out: List[np.ndarray] = []

    def i64(*v):
        return np.asarray(v, np.int64)

    def conv(ci, co, k, in_scale=1.0):
        w = rng.normal(0, np.sqrt(2.0 / (ci * k * k)), (co, ci, k, k)).astype(
            np.float32) * in_scale
        out.extend((w, rng.normal(0, 0.02, (1, co, 1, 1)).astype(np.float32)))

    def depthwise(c):
        w = rng.normal(0, np.sqrt(1.0 / 9.0), (c, 1, 1, 3, 3)).astype(np.float32)
        out.extend((w, rng.normal(0, 0.02, (1, c, 1, 1)).astype(np.float32)))

    def shuffle(c, hw):
        out.extend((i64(1, 2, c // 2, hw, hw), i64(0, 2, 1, 3, 4), i64(1, c, hw, hw)))

    conv(3, 24, 3, in_scale=1.0 / 255.0)
    ci, hw = 24, 56
    for co, n in STAGES:
        half, hw = co // 2, hw // 2
        depthwise(ci)                 # left: 3×3/2 depthwise, 1×1
        conv(ci, half, 1)
        conv(ci, half, 1)             # right: 1×1, 3×3/2 depthwise, 1×1
        depthwise(half)
        conv(half, half, 1)
        shuffle(co, hw)
        for _ in range(n - 1):
            out.append(i64(1))        # the Split's axis
            conv(half, half, 1)
            depthwise(half)
            conv(half, half, 1, in_scale=0.8)
            shuffle(co, hw)
        ci = co
    conv(ci, 1024, 1)
    out.append(i64(2, 3))
    wf = (8.0 * rng.normal(0, np.sqrt(1.0 / 1024), (1024, num_classes))).astype(np.float32)
    bf = rng.normal(0, 0.002, (1, num_classes)).astype(np.float32)
    hot = rng.choice(num_classes, 4, replace=False)
    bf[0, hot] += np.array([8.0, 6.0, 4.5, 3.5], np.float32)
    out.extend((wf, bf))
    return out


def generate_weights(xml_text: str, seed: int = 0) -> bytes:
    """The ``.bin`` blob for the XML (``models/synth.py::replay_blob``)."""
    return replay_blob(xml_text, const_values(seed=seed), "shufflenet_v2")


def shufflenet_v2_paths(seed: int = 0) -> Tuple[str, str]:
    """(xml, bin) of full-width ShuffleNet-v2 1.0×; the ``.bin`` is written
    to ``build/models/shufflenet_v2-seed<seed>.bin`` unless it exists."""
    return SHUFFLENET_V2_XML, replayed_bin(
        SHUFFLENET_V2_XML, lambda: const_values(seed=seed), f"shufflenet_v2-seed{seed}.bin")
