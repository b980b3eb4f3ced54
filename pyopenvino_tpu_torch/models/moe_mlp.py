"""Weights of the port's MoE-MLP (``models/moe_mlp.xml``).

The IR is the dense-gated mixture-of-experts classifier of the JAX
package's ``tools/gen_moe.py``: a 1×3×32×32 input, two 3×3 stride-2 convs
(32 and 64 channels, ReLU), global average pooling (ReduceMean over
(2, 3)) to a (1, 64) token, two MoE layers of 8 experts (a softmax router
(1, 8); the token Reshaped to (1, 1, 64) and Tiled to (8, 1, 64); a batched
MatMul with one rank-3 (8, 64, 128) expert Const, the erf Gelu, a batched
MatMul with (8, 128, 64); the gate Transposed and Reshaped to (8, 1, 1),
multiplied in and ReduceSum'd over the experts; a residual Add and ReLU),
a 100-class MatMul head and SoftMax.  The XML is the one that generator
writes; this module is the port's numpy-only replay of its draws, byte for
byte the same ``.bin``:

  * one ``np.random.default_rng(seed)`` consumed in build order (the
    generator's seed is 2024): each conv's He-init weight, then its
    N(0, 0.05) bias; per MoE layer the router's N(0, 1/64) weights, the
    input experts' N(0, 1/64) and the output experts' N(0, 1/128); the
    head's N(0, 1/64) weights and N(0, 0.02) bias;
  * the integer Consts: the pooling axes (2, 3), and per MoE layer the
    token Reshape (1, 1, 64), the Tile repeats (8, 1, 1), the gate's
    Transpose (1, 0) and Reshape (8, 1, 1), the ReduceSum axes (0,).

Consts are written in node-id order, which is the generator's creation
order, at the offsets the XML declares.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from pyopenvino_tpu_torch.models.synth import MODELS_DIR, replay_blob, replayed_bin

MOE_MLP_XML = os.path.join(MODELS_DIR, "moe_mlp.xml")
DIM, HIDDEN, EXPERTS, LAYERS, CLASSES = 64, 128, 8, 2, 100
SEED = 2024  # tools/gen_moe.py's


def _i64(*v):
    return np.asarray(v, np.int64)


def const_values(seed: int = SEED) -> List[np.ndarray]:
    """Every Const of the network in creation order."""
    rng = np.random.default_rng(seed)
    out: List[np.ndarray] = []
    ci = 3
    for co in (32, DIM):
        out.append(rng.normal(0, np.sqrt(2.0 / (ci * 9)), (co, ci, 3, 3)).astype(np.float32))
        out.append(rng.normal(0, 0.05, (1, co, 1, 1)).astype(np.float32))
        ci = co
    out.append(_i64(2, 3))
    for _ in range(LAYERS):
        out.append(rng.normal(0, np.sqrt(1.0 / DIM), (DIM, EXPERTS)).astype(np.float32))
        out.extend((_i64(1, 1, DIM), _i64(EXPERTS, 1, 1)))
        out.append(rng.normal(0, np.sqrt(1.0 / DIM), (EXPERTS, DIM, HIDDEN)).astype(np.float32))
        out.append(rng.normal(0, np.sqrt(1.0 / HIDDEN), (EXPERTS, HIDDEN, DIM)).astype(np.float32))
        out.extend((_i64(1, 0), _i64(EXPERTS, 1, 1), _i64(0)))
    out.append(rng.normal(0, np.sqrt(1.0 / DIM), (DIM, CLASSES)).astype(np.float32))
    out.append(rng.normal(0, 0.02, (1, CLASSES)).astype(np.float32))
    return out


def generate_weights(xml_text: str, seed: int = SEED) -> bytes:
    """The ``.bin`` blob for the XML (``models/synth.py::replay_blob``)."""
    return replay_blob(xml_text, const_values(seed=seed), "moe_mlp")


def moe_mlp_paths(seed: int = SEED) -> Tuple[str, str]:
    """(xml, bin) of MoE-MLP; the ``.bin`` is written to
    ``build/models/moe_mlp-seed<seed>.bin`` unless it exists."""
    return MOE_MLP_XML, replayed_bin(MOE_MLP_XML, lambda: const_values(seed=seed),
                                     f"moe_mlp-seed{seed}.bin")
