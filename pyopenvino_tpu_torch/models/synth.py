"""Synthesize a deterministic .bin for an IR whose weights are not shipped.

The port's own copy of ``tools/gen_weights.py::generate_weights`` for the
constant roles that ResNet-18 and MobileNet-v2 have, byte for byte the same
blob:

  * float constants, one numpy generator per .bin region seeded with
    ``seed * 1_000_003 + offset``: He-init normal for Convolution,
    GroupConvolution and MatMul weights (fan-in of a (G, Co, Ci, kh, kw)
    depthwise weight: Ci·kh·kw), N(1, 0.02) for Multiply scales,
    N(0, 0.02) for Add biases, N(0, 0.05) otherwise;
  * integer constants feeding a Reshape's target port get the consumer's
    declared output shape (-1 on an axis where consumers differ).

Roles this copy does not have yet (Transpose/Unsqueeze/StridedSlice/LRN
integer inputs, SSD class heads) raise NotImplementedError rather than
produce a blob that differs from the JAX package's.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from pyopenvino_tpu_torch.ir.model import ELEMENT_TYPE_TO_DTYPE, Model, Node
from pyopenvino_tpu_torch.ir.xml_parser import parse_ir

MODELS_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(MODELS_DIR)),
                         "build", "models")
RESNET18_XML = os.path.join(MODELS_DIR, "resnet18.xml")
MOBILENET_V2_XML = os.path.join(MODELS_DIR, "mobilenet_v2.xml")


def _int_const_value(model: Model, nodes, shape) -> np.ndarray:
    edges = [e for node in nodes for e in model.out_edges[node.id]]
    reshape_outs = [
        tuple(model.nodes[dst].outputs[model.nodes[dst].out_port].shape)
        for _, dst, dport in edges
        if model.nodes[dst].op_type == "Reshape" and dport == 1
    ]
    if not reshape_outs or len(reshape_outs) != len(edges):
        raise NotImplementedError(
            f"integer Const {nodes[0].name!r} feeds something other than a "
            f"Reshape target; its synthesis role is not ported yet")
    dims = []
    for axis_vals in zip(*reshape_outs):
        dims.append(axis_vals[0] if len(set(axis_vals)) == 1 else -1)
    if dims.count(-1) <= 1 and len(set(len(o) for o in reshape_outs)) == 1:
        return np.array(dims, dtype=np.int64)
    dims = [reshape_outs[0][0]] + [-1] * (len(reshape_outs[0]) - 1)
    return np.array(dims, dtype=np.int64)


def _float_const_value(model: Model, node: Node, shape, rng) -> np.ndarray:
    for _, dst, dport in model.out_edges[node.id]:
        consumer = model.nodes[dst]
        if consumer.op_type in ("Convolution", "GroupConvolution") and dport == 1:
            fan_in = int(np.prod(shape[-3:]))  # (I|Ci, Kh, Kw)
            return rng.normal(0.0, np.sqrt(2.0 / max(fan_in, 1)), size=shape)
        if consumer.op_type == "MatMul" and dport == 1:
            fan_in = shape[0]
            return rng.normal(0.0, np.sqrt(2.0 / max(fan_in, 1)), size=shape)
        if consumer.op_type == "Multiply":
            return 1.0 + rng.normal(0.0, 0.02, size=shape)
        if consumer.op_type == "Add":
            return rng.normal(0.0, 0.02, size=shape)
    return rng.normal(0.0, 0.05, size=shape)


def generate_weights(model: Model, seed: int = 0) -> bytes:
    """The full .bin blob for every Const (offset/size layout from the XML)."""
    if model.find_by_type("DetectionOutput"):
        raise NotImplementedError(
            "detection-head weight roles are not ported yet (ROADMAP.md, "
            "port slice 5: SSD)")
    total = 0
    groups = {}  # (offset, size) → [Const nodes aliasing that region]
    for node in model.find_by_type("Const"):
        offset = int(node.attrs["offset"])
        size = int(node.attrs["size"])
        groups.setdefault((offset, size), []).append(node)
        total = max(total, offset + size)

    blob = bytearray(total)
    for (offset, size), nodes in groups.items():
        node = nodes[0]
        dtype = np.dtype(ELEMENT_TYPE_TO_DTYPE[node.attrs["element_type"]])
        shape = tuple(
            int(t) for t in node.attrs.get("shape", "").split(",") if t.strip()
        )
        rng = np.random.default_rng(seed * 1_000_003 + offset)
        if np.issubdtype(dtype, np.floating):
            arr = _float_const_value(model, node, shape, rng).astype(dtype)
        else:
            arr = _int_const_value(model, nodes, shape).astype(dtype)
            arr = arr.reshape(shape) if shape else arr.reshape(())
        raw = np.ascontiguousarray(arr).tobytes()
        if len(raw) != size:
            raise ValueError(
                f"{node.name}: generated {len(raw)} bytes, layout wants {size}")
        blob[offset : offset + size] = raw
    return bytes(blob)


def synthesize_bin(xml_path: str, seed: int = 0) -> str:
    """Write the synthesized .bin for ``xml_path`` to
    ``build/models/<name>-seed<seed>.bin`` beside the package unless it
    exists; returns its path."""
    name = os.path.splitext(os.path.basename(xml_path))[0]
    out_path = os.path.join(BUILD_DIR, f"{name}-seed{seed}.bin")
    if not os.path.exists(out_path):
        with open(xml_path, "r", encoding="utf-8") as f:
            model = parse_ir(f.read(), None, name=name)  # structure only
        blob = generate_weights(model, seed)
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out_path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, out_path)
    return out_path


def resnet18_paths(seed: int = 0) -> Tuple[str, str]:
    """(xml, bin) of full-width ResNet-18 with weights synthesized from
    ``seed``."""
    return RESNET18_XML, synthesize_bin(RESNET18_XML, seed=seed)


def mobilenet_v2_paths(seed: int = 0) -> Tuple[str, str]:
    """(xml, bin) of full-width MobileNet-v2 (224×224, 1000 classes) with
    weights synthesized from ``seed``."""
    return MOBILENET_V2_XML, synthesize_bin(MOBILENET_V2_XML, seed=seed)
