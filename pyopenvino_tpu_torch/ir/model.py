"""Typed graph IR: nodes with declared per-port tensor metadata and
(src, src_port, dst, dst_port) edges.

Counterpart of ``pyopenvino_tpu/ir/model.py``.  The port keeps its own copy
so that it never imports the JAX package; subgraph bodies (TensorIterator,
Loop, If) and ``extract_subgraph`` come with later slices.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

# IR element_type / port precision → numpy dtype.
ELEMENT_TYPE_TO_DTYPE = {
    "f64": np.float64,
    "f32": np.float32,
    "f16": np.float16,
    "i64": np.int64,
    "i32": np.int32,
    "i16": np.int16,
    "i8": np.int8,
    "u8": np.uint8,
    "boolean": np.bool_,
}

PRECISION_TO_DTYPE = {
    "FP64": np.float64,
    "FP32": np.float32,
    "FP16": np.float16,
    "I64": np.int64,
    "I32": np.int32,
    "I16": np.int16,
    "I8": np.int8,
    "U8": np.uint8,
    "BOOL": np.bool_,
}


@dataclasses.dataclass(frozen=True)
class TensorInfo:
    """Declared metadata of one port: shape + dtype (+ optional tensor names)."""

    shape: Tuple[int, ...]
    dtype: np.dtype
    names: Tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class Edge:
    src: int
    src_port: int
    dst: int
    dst_port: int


@dataclasses.dataclass
class Node:
    """One IR layer.  ``attrs`` holds the raw <data> strings (parsed per op
    through ir/attrs.py); ``const`` holds the decoded .bin tensor of a Const
    node, or None for a weightless structural parse."""

    id: int
    name: str
    op_type: str
    attrs: Dict[str, str]
    inputs: Dict[int, TensorInfo]
    outputs: Dict[int, TensorInfo]
    const: Optional[np.ndarray] = None

    @property
    def out_port(self) -> int:
        """Primary (first) output port id."""
        if not self.outputs:
            raise ValueError(
                f"{self.op_type} node {self.name!r} has no output ports"
            )
        return next(iter(self.outputs))

    def __repr__(self) -> str:
        return f"Node({self.id}, {self.op_type!r}, {self.name!r})"


class Model:
    """A DAG of Nodes, immutable after construction."""

    def __init__(self, name: str, nodes: Dict[int, Node], edges: List[Edge]):
        self.name = name
        self.nodes = nodes
        self.edges = edges

        # dst node id → {dst_port: (src node id, src_port)}
        self.in_edges: Dict[int, Dict[int, Tuple[int, int]]] = {
            nid: {} for nid in nodes
        }
        # src node id → [(src_port, dst, dst_port)]
        self.out_edges: Dict[int, List[Tuple[int, int, int]]] = {
            nid: [] for nid in nodes
        }
        for e in edges:
            if e.dst_port in self.in_edges[e.dst]:
                raise ValueError(
                    f"duplicate edge into node {e.dst} port {e.dst_port}"
                )
            self.in_edges[e.dst][e.dst_port] = (e.src, e.src_port)
            self.out_edges[e.src].append((e.src_port, e.dst, e.dst_port))

        self._topo = self._toposort()

    def find_by_type(self, op_type: str) -> List[Node]:
        return [n for n in self.nodes.values() if n.op_type == op_type]

    def find_by_name(self, name: str) -> Optional[Node]:
        for n in self.nodes.values():
            if n.name == name:
                return n
        return None

    @property
    def parameters(self) -> List[Node]:
        return self.find_by_type("Parameter")

    @property
    def results(self) -> List[Node]:
        return self.find_by_type("Result")

    def topo_order(self) -> List[int]:
        return list(self._topo)

    def __iter__(self) -> Iterator[Node]:
        for nid in self._topo:
            yield self.nodes[nid]

    def _toposort(self) -> List[int]:
        """Deterministic Kahn topological sort, the same order as the JAX
        package's, so both emit the graph node for node alike."""
        indeg = {nid: len(self.in_edges[nid]) for nid in self.nodes}
        ready = deque(sorted(nid for nid, d in indeg.items() if d == 0))
        order: List[int] = []
        while ready:
            nid = ready.popleft()
            order.append(nid)
            for _, dst, _ in sorted(self.out_edges[nid]):
                indeg[dst] -= 1
                if indeg[dst] == 0:
                    ready.append(dst)
        if len(order) != len(self.nodes):
            raise ValueError("graph contains a cycle")
        return order


def ancestors(model: Model, target_ids) -> set:
    """Transitive input closure of ``target_ids`` (inclusive)."""
    keep = set()
    stack = list(target_ids)
    while stack:
        nid = stack.pop()
        if nid in keep:
            continue
        keep.add(nid)
        for src, _ in model.in_edges[nid].values():
            stack.append(src)
    return keep
