"""OpenVINO IR v10 writer: Model → ``.xml`` topology + ``.bin`` weights.

The port's own copy of ``pyopenvino_tpu/ir/writer.py`` (``serialize_ir``,
``write_ir_model``), so that an IR the port makes (a POT-quantized one,
tools/pot_quantize.py) re-enters through ``IECore.read_network``.  Consts
are packed in node-id order at 64-byte aligned offsets, a TensorIterator's,
Loop's or If's body Consts while its layer is written (its port maps, back
edges and nested <body>, <then_body> and <else_body> follow its ports);
every layer is written with ``version="opset1"``.  ``with_f16_consts``
declares a model's float32 Consts f16, so that the IR is written with fp16
weights.

One difference: node attributes whose name begins with ``_`` are the
engine's own annotations (``_baked_batch`` from ``bake_batch``, the parsed
layer version ``_opset``), not IR attributes, and are not written.  Apart
from them the XML is the JAX package's writer's, byte for byte.
"""

from __future__ import annotations

import dataclasses
import os
import xml.etree.ElementTree as ET
from typing import Dict, Optional, Tuple

import numpy as np

from pyopenvino_tpu_torch.ir.model import (
    ELEMENT_TYPE_TO_DTYPE,
    PRECISION_TO_DTYPE,
    Model,
    Node,
    TensorInfo,
)

_DTYPE_TO_ELEMENT_TYPE = {np.dtype(v): k for k, v in ELEMENT_TYPE_TO_DTYPE.items()}
_DTYPE_TO_PRECISION = {np.dtype(v): k for k, v in PRECISION_TO_DTYPE.items()}


def _ports_xml(parent, tag: str, ports: Dict[int, TensorInfo]):
    if not ports:
        return
    section = ET.SubElement(parent, tag)
    for pid in sorted(ports):
        info = ports[pid]
        attrs = {"id": str(pid), "precision": _DTYPE_TO_PRECISION[np.dtype(info.dtype)]}
        if info.names:
            attrs["names"] = ",".join(info.names)
        port = ET.SubElement(section, "port", attrs)
        for d in info.shape:
            ET.SubElement(port, "dim").text = str(int(d))


def _align(n: int, a: int = 64) -> int:
    return -(-n // a) * a


def _pack_const(node: Node, blob: bytearray) -> Dict[str, str]:
    if node.const is None:
        raise ValueError(f"Const {node.name!r} has no weights to serialize")
    arr = np.ascontiguousarray(node.const)
    # keep the declared on-disk dtype where the decoded array was upcast
    if np.dtype(node.outputs[node.out_port].dtype) == np.float16 and arr.dtype == np.float32:
        arr = arr.astype(np.float16)
    offset = _align(len(blob))
    blob.extend(b"\x00" * (offset - len(blob)))
    raw = arr.tobytes()
    blob.extend(raw)
    return {
        "element_type": _DTYPE_TO_ELEMENT_TYPE[arr.dtype],
        "shape": ",".join(str(int(d)) for d in arr.shape),
        "offset": str(offset),
        "size": str(len(raw)),
    }


def _port_map_xml(layer, tag: str, sg):
    pm = ET.SubElement(layer, tag)
    for kind, entries in (("input", sg.inputs), ("output", sg.outputs)):
        for e in entries:
            a = {"external_port_id": str(e.external_port_id),
                 "internal_layer_id": str(e.internal_layer_id)}
            if e.axis is not None:
                a.update(axis=str(e.axis), start=str(e.start), end=str(e.end),
                         stride=str(e.stride), part_size=str(e.part_size))
            if e.purpose:
                a["purpose"] = e.purpose
            ET.SubElement(pm, kind, a)


def _subgraphs_xml(layer, node: Node, blob: bytearray):
    if node.op_type == "If":
        for bname, pm_tag in (("then_body", "then_port_map"), ("else_body", "else_port_map")):
            sg = node.subgraphs[bname]
            _port_map_xml(layer, pm_tag, sg)
            _graph_xml(ET.SubElement(layer, bname), sg.model, blob)
        return
    sg = node.subgraphs["body"]
    _port_map_xml(layer, "port_map", sg)
    if sg.back_edges:
        be = ET.SubElement(layer, "back_edges")
        for frm, to in sg.back_edges:
            ET.SubElement(be, "edge", {"from-layer": str(frm), "to-layer": str(to)})
    _graph_xml(ET.SubElement(layer, "body"), sg.model, blob)


def _graph_xml(parent, model: Model, blob: bytearray):
    layers = ET.SubElement(parent, "layers")
    for nid in sorted(model.nodes):
        node = model.nodes[nid]
        layer = ET.SubElement(layers, "layer", {
            "id": str(node.id), "name": node.name, "type": node.op_type,
            "version": "opset1"})
        attrs = {k: v for k, v in node.attrs.items() if not k.startswith("_")}
        if node.op_type == "Const":
            attrs.update(_pack_const(node, blob))
        if attrs:
            ET.SubElement(layer, "data", {k: str(v) for k, v in attrs.items()})
        _ports_xml(layer, "input", node.inputs)
        _ports_xml(layer, "output", node.outputs)
        if node.subgraphs:
            _subgraphs_xml(layer, node, blob)
    edges = ET.SubElement(parent, "edges")
    for e in model.edges:
        ET.SubElement(edges, "edge", {
            "from-layer": str(e.src), "from-port": str(e.src_port),
            "to-layer": str(e.dst), "to-port": str(e.dst_port)})


def serialize_ir(model: Model) -> Tuple[bytes, bytes]:
    """(xml bytes, bin bytes)."""
    blob = bytearray()
    root = ET.Element("net", {"name": model.name, "version": "10"})
    _graph_xml(root, model, blob)
    ET.indent(root)
    return ET.tostring(root, encoding="utf-8", xml_declaration=True), bytes(blob)


def with_f16_consts(model: Model) -> Model:
    """A copy of ``model`` whose float32 Consts (outside bodies) are
    declared f16 on their output ports: ``write_ir_model`` then stores each
    rounded to fp16, as an IR converted with FP16 weights holds them, and
    the parser decodes them back to float32."""
    f16 = np.dtype(np.float16)
    nodes = {}
    for nid, node in model.nodes.items():
        if node.op_type == "Const" and node.const is not None and node.const.dtype == np.float32:
            node = dataclasses.replace(node, outputs={
                p: dataclasses.replace(info, dtype=f16) for p, info in node.outputs.items()})
        nodes[nid] = node
    return Model(model.name, nodes, list(model.edges))


def write_ir_model(model: Model, xml_path: str, bin_path: Optional[str] = None):
    """Write ``model`` to ``xml_path`` and its weights to ``bin_path``
    (default: the ``.xml`` path with a ``.bin`` suffix, as ``read_ir_model``
    derives it)."""
    if bin_path is None:
        bin_path = os.path.splitext(xml_path)[0] + ".bin"
    xml_bytes, bin_bytes = serialize_ir(model)
    with open(xml_path, "wb") as f:
        f.write(xml_bytes)
    with open(bin_path, "wb") as f:
        f.write(bin_bytes)
