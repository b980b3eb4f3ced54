"""Weights of the port's U-Net (``models/unet.xml``).

The IR is the segmentation U-Net of the JAX package's ``tools/gen_unet.py``
(a 1×3×128×128 input, base width 16 doubling per level, 15 convs, three 2×2
stride-2 ConvolutionBackpropData up-convolutions, three skip Concats, an
8-class 1×1 head and a SoftMax over the channel axis of the rank-4 logits).
The XML is the one that generator writes; this module is the port's
numpy-only replay of its weight draws, byte for byte the same ``.bin``:

  * one ``np.random.default_rng(seed)`` consumed in build order: the three
    encoder levels and the bottleneck (two 3×3 convs each), then per
    decoder level the up-convolution before its two convs, then the head;
  * a 3×3 conv draws its He-init weight, then its N(0, 0.02) bias; the
    stem's weight is scaled by 1/255 (the input scale folded in) and the
    head's by 2.5 (a gain that gives the argmax map margins);
  * an up-convolution draws (Ci, Co, 2, 2) weights from N(0, 1/Ci), then
    its N(0, 0.02) bias.

The network has no integer Consts.  Consts are written in node-id order,
which is the generator's creation order, at the offsets the XML declares.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from pyopenvino_tpu_torch.models.synth import MODELS_DIR, replay_blob, replayed_bin

UNET_XML = os.path.join(MODELS_DIR, "unet.xml")
BASE = 16


def const_values(num_classes: int = 8, seed: int = 0) -> List[np.ndarray]:
    """Every Const of the network in creation order."""
    rng = np.random.default_rng(seed)
    out: List[np.ndarray] = []

    def conv(ci, co, k=3, in_scale=1.0, w_scale=1.0):
        w = rng.normal(0, np.sqrt(2.0 / (ci * k * k)), (co, ci, k, k)).astype(
            np.float32) * (in_scale * w_scale)
        out.extend((w, rng.normal(0, 0.02, (1, co, 1, 1)).astype(np.float32)))

    def double(ci, co, in_scale=1.0):
        conv(ci, co, in_scale=in_scale)
        conv(co, co)

    def up(ci, co):
        w = rng.normal(0, np.sqrt(1.0 / ci), (ci, co, 2, 2)).astype(np.float32)
        out.extend((w, rng.normal(0, 0.02, (1, co, 1, 1)).astype(np.float32)))

    double(3, BASE, in_scale=1.0 / 255.0)
    double(BASE, 2 * BASE)
    double(2 * BASE, 4 * BASE)
    double(4 * BASE, 8 * BASE)
    for co in (4 * BASE, 2 * BASE, BASE):  # up-conv, Concat with the skip
        up(2 * co, co)
        double(2 * co, co)
    conv(BASE, num_classes, k=1, w_scale=2.5)
    return out


def generate_weights(xml_text: str, seed: int = 0) -> bytes:
    """The ``.bin`` blob for the XML (``models/synth.py::replay_blob``)."""
    return replay_blob(xml_text, const_values(seed=seed), "unet")


def unet_paths(seed: int = 0) -> Tuple[str, str]:
    """(xml, bin) of the U-Net; the ``.bin`` is written to
    ``build/models/unet-seed<seed>.bin`` unless it exists."""
    return UNET_XML, replayed_bin(UNET_XML, lambda: const_values(seed=seed),
                                  f"unet-seed{seed}.bin")
