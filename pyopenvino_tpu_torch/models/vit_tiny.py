"""Weights of the port's ViT-tiny (``models/vit_tiny.xml``).

The IR is the tiny Vision Transformer of the JAX package's
``tools/gen_vit.py``: a 1×3×64×64 input, an 8×8 stride-8 patch-embedding
conv to 64 tokens of width 128, a learned position embedding, four pre-LN
blocks (MVN over the embedding axis with an affine Multiply and Add; four
heads of 32 with Q·Kᵀ and attn·V as MatMuls of two activations, an axis-3
SoftMax; an MLP of 512 with the erf Gelu), a final LayerNorm, a token
mean (ReduceMean over axis 1), a 100-class MatMul head and SoftMax.  The
XML is the one that generator writes; this module is the port's
numpy-only replay of its draws, byte for byte the same ``.bin``:

  * one ``np.random.default_rng(seed)`` consumed in build order: the patch
    embedding's He-init weight (scaled by 1/255, the input scale folded in)
    and N(0, 0.02) bias, the position embedding N(0, 0.02), then per block
    LayerNorm, Q, K, V, the projection, LayerNorm, fc1 and fc2, then the
    final LayerNorm and the head;
  * a LayerNorm draws its gain 1 + N(0, 0.02), then its shift N(0, 0.02);
    a linear layer its (Ci, Co) weight from N(0, 1/Ci) (fc1 N(0, 2/128)),
    then its (1, 1, Co) bias from N(0, 0.02); the attention scale 1/√32 is
    a constant;
  * the head draws N(0, 1/128) weights, N(0, 0.02) biases, then four "hot"
    classes that get +8, +6, +4.5 and +3.5 (a bias ladder that keeps the
    top classes of a random network apart);
  * the integer Consts: the token Reshape (1, 128, 64) and Transpose
    (0, 2, 1), each head split's Reshape (1, 64, 4, 32) and Transpose
    (0, 2, 1, 3), each merge's Transpose and Reshape (1, 64, 128), the
    pooling axes (1,).

Consts are written in node-id order, which is the generator's creation
order, at the offsets the XML declares.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from pyopenvino_tpu_torch.models.synth import MODELS_DIR, replay_blob, replayed_bin

VIT_TINY_XML = os.path.join(MODELS_DIR, "vit_tiny.xml")
DIM, HEADS, TOKENS, DEPTH = 128, 4, 64, 4
HDIM, MLP = DIM // HEADS, 4 * DIM


def _i64(*v):
    return np.asarray(v, np.int64)


def const_values(num_classes: int = 100, seed: int = 0) -> List[np.ndarray]:
    """Every Const of the network in creation order."""
    rng = np.random.default_rng(seed)
    out: List[np.ndarray] = []

    def linear(ci, co, std=None):
        std = std if std is not None else np.sqrt(1.0 / ci)
        out.append(rng.normal(0, std, (ci, co)).astype(np.float32))
        out.append(rng.normal(0, 0.02, (1, 1, co)).astype(np.float32))

    def layernorm():
        out.append((1.0 + rng.normal(0, 0.02, (1, 1, DIM))).astype(np.float32))
        out.append(rng.normal(0, 0.02, (1, 1, DIM)).astype(np.float32))

    out.append(rng.normal(0, np.sqrt(2.0 / (3 * 8 * 8)), (DIM, 3, 8, 8)).astype(
        np.float32) / 255.0)
    out.append(rng.normal(0, 0.02, (1, DIM, 1, 1)).astype(np.float32))
    out.extend((_i64(1, DIM, TOKENS), _i64(0, 2, 1)))
    out.append(rng.normal(0, 0.02, (1, TOKENS, DIM)).astype(np.float32))
    for _ in range(DEPTH):
        layernorm()
        for _qkv in range(3):
            linear(DIM, DIM)
        for _qkv in range(3):
            out.extend((_i64(1, TOKENS, HEADS, HDIM), _i64(0, 2, 1, 3)))
        out.append(np.full((1, 1, 1, 1), 1.0 / np.sqrt(HDIM), np.float32))
        out.extend((_i64(0, 2, 1, 3), _i64(1, TOKENS, DIM)))
        linear(DIM, DIM)
        layernorm()
        linear(DIM, MLP, std=np.sqrt(2.0 / DIM))
        linear(MLP, DIM)
    layernorm()
    out.append(_i64(1))
    w = rng.normal(0, np.sqrt(1.0 / DIM), (DIM, num_classes)).astype(np.float32)
    bias = rng.normal(0, 0.02, (1, num_classes)).astype(np.float32)
    hot = rng.choice(num_classes, 4, replace=False)
    bias[0, hot] += np.array([8.0, 6.0, 4.5, 3.5], np.float32)
    out.extend((w, bias))
    return out


def generate_weights(xml_text: str, seed: int = 0) -> bytes:
    """The ``.bin`` blob for the XML (``models/synth.py::replay_blob``)."""
    return replay_blob(xml_text, const_values(seed=seed), "vit_tiny")


def vit_tiny_paths(seed: int = 0) -> Tuple[str, str]:
    """(xml, bin) of ViT-tiny; the ``.bin`` is written to
    ``build/models/vit_tiny-seed<seed>.bin`` unless it exists."""
    return VIT_TINY_XML, replayed_bin(VIT_TINY_XML, lambda: const_values(seed=seed),
                                      f"vit_tiny-seed{seed}.bin")
