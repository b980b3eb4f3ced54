"""The benchmark's own reading of an OpenVINO IR ``.xml``: layers, edges and
the Const layout of the ``.bin``, in topological order.

It reads only what the benchmark needs (the reference's walk, the weight
maker's roles and the work counter's shapes) and imports nothing of the
program under test.
"""

from __future__ import annotations

import dataclasses
import xml.etree.ElementTree as ET
from typing import Dict, List, Tuple

import numpy as np

ELEMENT_TYPES = {"f32": np.float32, "f16": np.float16, "i64": np.int64, "i32": np.int32,
                 "u8": np.uint8, "i8": np.int8}


@dataclasses.dataclass
class Layer:
    id: int
    name: str
    type: str
    attrs: Dict[str, str]
    in_shapes: List[Tuple[int, ...]]           # by input index (port order)
    out_shapes: Dict[int, Tuple[int, ...]]     # by output port id
    inputs: List[Tuple[int, int]] = dataclasses.field(default_factory=list)  # (src, port)
    consumers: List[Tuple[int, int]] = dataclasses.field(default_factory=list)  # (dst, index)

    def ints(self, key: str) -> Tuple[int, ...]:
        return tuple(int(v) for v in self.attrs[key].split(",") if v.strip())

    @property
    def out_shape(self) -> Tuple[int, ...]:
        return self.out_shapes[min(self.out_shapes)]

    @property
    def const_shape(self) -> Tuple[int, ...]:
        return self.ints("shape") if self.attrs.get("shape") else ()


@dataclasses.dataclass
class Graph:
    name: str
    layers: Dict[int, Layer]
    order: List[int]

    def __iter__(self):
        return (self.layers[i] for i in self.order)

    def of_type(self, *types: str) -> List[Layer]:
        return [layer for layer in self if layer.type in types]

    def src(self, layer: Layer, index: int) -> Layer:
        return self.layers[layer.inputs[index][0]]

    def single_consumer(self, layer: Layer):
        return self.layers[layer.consumers[0][0]] if len(layer.consumers) == 1 else None

    @property
    def blob_size(self) -> int:
        return max(int(c.attrs["offset"]) + int(c.attrs["size"]) for c in self.of_type("Const"))


def _dims(port) -> Tuple[int, ...]:
    return tuple(int(d.text) for d in port.findall("dim"))


def parse(path: str) -> Graph:
    root = ET.parse(path).getroot()
    layers: Dict[int, Layer] = {}
    in_index: Dict[Tuple[int, int], int] = {}
    for el in root.find("layers"):
        lid = int(el.get("id"))
        data = el.find("data")
        ins = el.find("input")
        outs = el.find("output")
        in_ports = [] if ins is None else list(ins.findall("port"))
        for i, port in enumerate(in_ports):
            in_index[(lid, int(port.get("id")))] = i
        layers[lid] = Layer(
            id=lid, name=el.get("name"), type=el.get("type"),
            attrs={} if data is None else dict(data.attrib),
            in_shapes=[_dims(p) for p in in_ports],
            out_shapes={} if outs is None else {int(p.get("id")): _dims(p)
                                                 for p in outs.findall("port")})
    for layer in layers.values():
        layer.inputs = [None] * len(layer.in_shapes)
    for e in root.find("edges"):
        src, sport = int(e.get("from-layer")), int(e.get("from-port"))
        dst, dport = int(e.get("to-layer")), int(e.get("to-port"))
        index = in_index[(dst, dport)]
        layers[dst].inputs[index] = (src, sport)
        layers[src].consumers.append((dst, index))
    # Kahn's order, smallest id first among the ready layers
    pending = {lid: len(layer.inputs) for lid, layer in layers.items()}
    ready = sorted(lid for lid, n in pending.items() if n == 0)
    order = []
    while ready:
        lid = ready.pop(0)
        order.append(lid)
        for dst, _ in layers[lid].consumers:
            pending[dst] -= 1
            if pending[dst] == 0:
                ready.append(dst)
                ready.sort()
    if len(order) != len(layers):
        raise ValueError(f"{path}: the graph has a cycle or a dangling edge")
    return Graph(root.get("name"), layers, order)
