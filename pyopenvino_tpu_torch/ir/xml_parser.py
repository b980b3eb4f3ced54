"""OpenVINO IR v10 front-end: .xml topology + .bin weights → Model.

Counterpart of ``pyopenvino_tpu/ir/xml_parser.py``:
  * <layers>: id/name/type + <data> attrs + per-port dims/precision/names;
  * <edges>: from-layer/from-port/to-layer/to-port quadruples;
  * Const decode: the .bin sliced by offset/size, dtype from element_type,
    reshaped to the declared shape, decoded once at load;
  * a missing .bin gives a weightless structural model (Consts without
    data), which weight synthesis (models/synth.py) reads;
  * TensorIterator and Loop layers: their <body>, <port_map> and
    <back_edges>; If layers: <then_body> and <else_body> with
    <then_port_map> and <else_port_map> (ir/subgraph.py), each body parsed
    as a graph of its own whose Consts decode from the same .bin.

fp16 constants decode to float32 once, at load, through the port's native
threaded decoder (``native.fp16_to_fp32``: bit-exact, every fp16 value is a
float32 value; the library is built by g++ on the first fp16 IR).
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

import numpy as np

from pyopenvino_tpu_torch.ir.model import (
    ELEMENT_TYPE_TO_DTYPE,
    PRECISION_TO_DTYPE,
    Edge,
    Model,
    Node,
    TensorInfo,
)
from pyopenvino_tpu_torch.ir.subgraph import PortMapEntry, SubGraph


def _parse_ports(section) -> Dict[int, TensorInfo]:
    ports: Dict[int, TensorInfo] = {}
    if section is None:
        return ports
    for port in section.findall("port"):
        pid = int(port.attrib["id"])
        dims = tuple(int(d.text) for d in port.findall("dim"))
        prec = port.attrib.get("precision", "FP32")
        names = tuple(
            t.strip() for t in port.attrib.get("names", "").split(",") if t.strip()
        )
        ports[pid] = TensorInfo(
            shape=dims, dtype=np.dtype(PRECISION_TO_DTYPE[prec]), names=names
        )
    return ports


def _decode_const(attrs: Dict[str, str], blob: Optional[bytes]) -> Optional[np.ndarray]:
    if blob is None or "offset" not in attrs:
        return None
    offset = int(attrs["offset"])
    size = int(attrs["size"])
    dtype = np.dtype(ELEMENT_TYPE_TO_DTYPE[attrs["element_type"]])
    shape = tuple(
        int(t) for t in attrs.get("shape", "").split(",") if t.strip()
    )
    raw = blob[offset : offset + size]
    if len(raw) != size:
        raise ValueError(
            f"const at offset {offset} wants {size} bytes, "
            f".bin has only {len(raw)} past that offset"
        )
    arr = np.frombuffer(raw, dtype=dtype)
    if dtype == np.float16:
        from pyopenvino_tpu_torch import native

        arr = native.fp16_to_fp32(arr)
    return arr.reshape(shape) if shape else arr.reshape(())


def _parse_port_map(section) -> Tuple[list, list]:
    """<port_map> → (input entries, output entries)."""
    ins, outs = [], []
    if section is None:
        return ins, outs
    for tag, dest in (("input", ins), ("output", outs)):
        for el in section.findall(tag):
            a = el.attrib
            dest.append(PortMapEntry(
                external_port_id=int(a.get("external_port_id", -1)),
                internal_layer_id=int(a["internal_layer_id"]),
                axis=int(a["axis"]) if "axis" in a else None,
                start=int(a.get("start", 0)),
                end=int(a.get("end", -1)),
                stride=int(a.get("stride", 1)),
                part_size=int(a.get("part_size", 1)),
                purpose=a.get("purpose", ""),
            ))
    return ins, outs


def _parse_subgraphs(layer, op_type: str, blob: Optional[bytes]) -> Dict[str, SubGraph]:
    """The bodies of a TensorIterator, Loop or If layer with their port maps
    (and a TensorIterator's or Loop's back edges), each validated."""
    name = layer.attrib.get("name", "?")

    def body_from(body_tag: str, pm_tag: str) -> Optional[SubGraph]:
        body_el = layer.find(body_tag)
        if body_el is None:
            return None
        model = _parse_graph(body_el, blob, f"{name}/{body_tag}")
        ins, outs = _parse_port_map(layer.find(pm_tag))
        back = []
        be_el = layer.find("back_edges")
        if be_el is not None and body_tag == "body":
            back = [(int(e.attrib["from-layer"]), int(e.attrib["to-layer"]))
                    for e in be_el.findall("edge")]
        sg = SubGraph(model=model, inputs=ins, outputs=outs, back_edges=back)
        sg.validate(f"{op_type} {name} {body_tag}")
        return sg

    if op_type in ("TensorIterator", "Loop"):
        sg = body_from("body", "port_map")
        if sg is None:
            raise ValueError(f"{op_type} layer has no <body>")
        return {"body": sg}
    subs = {}
    for tag, pm in (("then_body", "then_port_map"), ("else_body", "else_port_map")):
        sg = body_from(tag, pm)
        if sg is None:
            raise ValueError(f"If layer has no <{tag}>")
        subs[tag] = sg
    return subs


def _parse_graph(root, blob: Optional[bytes], net_name: str) -> Model:
    """One <net> or body element (layers and edges) → Model: the top level
    and every nested body."""
    layers = root.find("layers")
    if layers is None:
        raise ValueError("IR file has no <layers> section")
    nodes: Dict[int, Node] = {}
    for layer in layers.findall("layer"):
        nid = int(layer.attrib["id"])
        if nid in nodes:
            raise ValueError(f"duplicate layer id {nid} in IR")
        op_type = layer.attrib["type"]
        data = layer.find("data")
        attrs = dict(data.attrib) if data is not None else {}
        # the opset version, for version-sensitive ops
        if "version" in layer.attrib:
            attrs.setdefault("_opset", layer.attrib["version"])
        nodes[nid] = Node(
            id=nid,
            name=layer.attrib.get("name", str(nid)),
            op_type=op_type,
            attrs=attrs,
            inputs=_parse_ports(layer.find("input")),
            outputs=_parse_ports(layer.find("output")),
            const=_decode_const(attrs, blob) if op_type == "Const" else None,
            subgraphs=(_parse_subgraphs(layer, op_type, blob)
                       if op_type in ("TensorIterator", "Loop", "If") else None),
        )

    edges: List[Edge] = []
    edges_el = root.find("edges")
    if edges_el is not None:
        for e in edges_el.findall("edge"):
            edges.append(
                Edge(
                    src=int(e.attrib["from-layer"]),
                    src_port=int(e.attrib["from-port"]),
                    dst=int(e.attrib["to-layer"]),
                    dst_port=int(e.attrib["to-port"]),
                )
            )
    return Model(net_name, nodes, edges)


def parse_ir(xml_text: str, blob: Optional[bytes], name: Optional[str] = None) -> Model:
    root = ET.fromstring(xml_text)
    if root.tag != "net":
        raise ValueError(f"not an OpenVINO IR file (root tag {root.tag!r})")
    net_name = name or root.attrib.get("name", "net")
    return _parse_graph(root, blob, net_name)


def read_ir_model(model_path: str, weights_path: Optional[str] = None) -> Model:
    """Load IR from files.  ``weights_path`` defaults to the .xml basename
    with a .bin suffix; a missing .bin yields a weightless structural model."""
    if weights_path is None:
        weights_path = os.path.splitext(model_path)[0] + ".bin"
    with open(model_path, "r", encoding="utf-8") as f:
        xml_text = f.read()
    blob = None
    if os.path.exists(weights_path):
        with open(weights_path, "rb") as f:
            blob = f.read()
    name = os.path.splitext(os.path.basename(model_path))[0]
    return parse_ir(xml_text, blob, name=name)
