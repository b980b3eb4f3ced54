"""OpenVINO IR v10 front-end: .xml topology + .bin weights → Model.

Counterpart of ``pyopenvino_tpu/ir/xml_parser.py``:
  * <layers>: id/name/type + <data> attrs + per-port dims/precision/names;
  * <edges>: from-layer/from-port/to-layer/to-port quadruples;
  * Const decode: the .bin sliced by offset/size, dtype from element_type,
    reshaped to the declared shape, decoded once at load;
  * a missing .bin gives a weightless structural model (Consts without
    data), which weight synthesis (models/synth.py) reads.

fp16 constants decode to float32 in numpy (exact: every fp16 value is a
float32 value).  Nested bodies (TensorIterator, Loop, If) are not parsed yet.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional

import numpy as np

from pyopenvino_tpu_torch.ir.model import (
    ELEMENT_TYPE_TO_DTYPE,
    PRECISION_TO_DTYPE,
    Edge,
    Model,
    Node,
    TensorInfo,
)

_SUBGRAPH_OPS = ("TensorIterator", "Loop", "If")


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
        arr = arr.astype(np.float32)
    return arr.reshape(shape) if shape else arr.reshape(())


def _parse_graph(root, blob: Optional[bytes], net_name: str) -> Model:
    layers = root.find("layers")
    if layers is None:
        raise ValueError("IR file has no <layers> section")
    nodes: Dict[int, Node] = {}
    for layer in layers.findall("layer"):
        nid = int(layer.attrib["id"])
        if nid in nodes:
            raise ValueError(f"duplicate layer id {nid} in IR")
        op_type = layer.attrib["type"]
        if op_type in _SUBGRAPH_OPS:
            raise NotImplementedError(
                f"{op_type} bodies are not parsed by the port yet "
                f"(ROADMAP.md, port slice 6: the rest of the op registry)"
            )
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
