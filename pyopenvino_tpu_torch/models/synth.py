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
            "detection-head weight roles are not ported: the port's SSD "
            "(assets/trained/ssd_shapes_ms) runs its trained weights, and the "
            "published-width SSD waits for its IR (ROADMAP.md)")
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


def _write_once(out_path: str, make_blob) -> str:
    """Write ``make_blob()`` to ``out_path`` unless it exists (through a
    temporary file, so a concurrent reader never sees half a blob)."""
    if not os.path.exists(out_path):
        blob = make_blob()
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        tmp = f"{out_path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, out_path)
    return out_path


def writer_order_consts(model: Model):
    """Every Const of ``model`` in the order the IR writer packs them: node-id
    order, a TensorIterator's, Loop's or If's body Consts (then_body before
    else_body) where its layer is written, nested bodies likewise."""
    out = []
    for nid in sorted(model.nodes):
        node = model.nodes[nid]
        if node.op_type == "Const":
            out.append(node)
        for sg in (node.subgraphs or {}).values():
            out += writer_order_consts(sg.model)
    return out


def replay_blob(xml_text: str, values, name: str) -> bytes:
    """The ``.bin`` blob of an IR whose Consts, in the writer's order
    (``writer_order_consts``), take ``values`` (a generator's replay,
    models/efficientnet_b0.py, models/ocr_ti.py): each value at the offset
    the XML declares, checked against its element type, shape and size."""
    model = parse_ir(xml_text, None, name=name)  # structure only
    consts = writer_order_consts(model)
    if len(consts) != len(values):
        raise ValueError(f"the XML has {len(consts)} Consts, the replay {len(values)}")
    total = max(int(n.attrs["offset"]) + int(n.attrs["size"]) for n in consts)
    blob = bytearray(total)
    for node, value in zip(consts, values):
        dtype = np.dtype(ELEMENT_TYPE_TO_DTYPE[node.attrs["element_type"]])
        shape = tuple(int(t) for t in node.attrs["shape"].split(",") if t.strip())
        if value.dtype != dtype or value.shape != shape:
            raise ValueError(f"{node.name}: replay gives {value.dtype}{value.shape}, the "
                             f"XML declares {dtype}{shape}")
        raw = value.tobytes()
        offset = int(node.attrs["offset"])
        if len(raw) != int(node.attrs["size"]):
            raise ValueError(f"{node.name}: {len(raw)} bytes, the XML declares "
                             f"{node.attrs['size']}")
        blob[offset:offset + len(raw)] = raw
    return bytes(blob)


def replayed_bin(xml_path: str, make_values, bin_name: str) -> str:
    """``build/models/<bin_name>``, written from ``replay_blob`` of the
    values ``make_values()`` gives unless it exists; returns its path."""
    def make_blob():
        with open(xml_path, "r", encoding="utf-8") as f:
            return replay_blob(f.read(), make_values(), os.path.basename(xml_path))
    return _write_once(os.path.join(BUILD_DIR, bin_name), make_blob)


def synthesize_bin(xml_path: str, seed: int = 0) -> str:
    """Write the synthesized .bin for ``xml_path`` to
    ``build/models/<name>-seed<seed>.bin`` beside the package unless it
    exists; returns its path."""
    name = os.path.splitext(os.path.basename(xml_path))[0]

    def make_blob():
        with open(xml_path, "r", encoding="utf-8") as f:
            return generate_weights(parse_ir(f.read(), None, name=name), seed)
    return _write_once(os.path.join(BUILD_DIR, f"{name}-seed{seed}.bin"), make_blob)


def resnet18_paths(seed: int = 0) -> Tuple[str, str]:
    """(xml, bin) of full-width ResNet-18 with weights synthesized from
    ``seed``."""
    return RESNET18_XML, synthesize_bin(RESNET18_XML, seed=seed)


def mobilenet_v2_paths(seed: int = 0) -> Tuple[str, str]:
    """(xml, bin) of full-width MobileNet-v2 (224×224, 1000 classes) with
    weights synthesized from ``seed``."""
    return MOBILENET_V2_XML, synthesize_bin(MOBILENET_V2_XML, seed=seed)
