"""Nested body subgraphs of TensorIterator, Loop and If.

The port's own copy of ``pyopenvino_tpu/ir/subgraph.py``.  A body is a full
nested :class:`~pyopenvino_tpu_torch.ir.model.Model` carried on
``Node.subgraphs``, with the opset's port-map metadata:

  * ``PortMapEntry``: one ``<port_map>`` row binding an external port of the
    enclosing node to an internal body layer.  A sliced entry (``axis`` set)
    cuts the external tensor into per-iteration chunks of ``part_size``
    along ``axis``; ``start`` and ``end`` are inclusive and count from the
    back when negative, as in the opset (``end=-1`` is the last element;
    ``stride < 0`` walks backwards).  On outputs the same attributes
    describe the concatenation of the per-iteration results.
  * ``SubGraph``: the body model, its input and output port maps, and the
    back edges (body Result layer → body Parameter layer) that carry state
    between iterations.

Layer ids are scoped per body: a body's layer 0 is unrelated to the outer
graph's layer 0, as in OpenVINO IR.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from pyopenvino_tpu_torch.ir.model import Model


@dataclasses.dataclass(frozen=True)
class PortMapEntry:
    external_port_id: int          # port on the enclosing node; -1 = none
    internal_layer_id: int         # body Parameter (inputs) / Result (outputs)
    axis: Optional[int] = None     # None = invariant / last-value
    start: int = 0
    end: int = -1
    stride: int = 1
    part_size: int = 1
    purpose: str = ""              # Loop: current_iteration / execution_condition

    def iter_range(self, size: int) -> Tuple[int, int, int]:
        """(first, count, step) of part-start offsets along an axis of
        ``size``, in the opset's semantics: negative start/end count from
        the back with -1 the LAST element (inclusive), so (0, -1, 1) walks
        forward over everything and (-1, 0, -1) walks backward."""
        lo = self.start if self.start >= 0 else size + self.start
        hi = self.end if self.end >= 0 else size + self.end
        step = self.stride
        if step == 0:
            raise ValueError("port_map stride must be non-zero")
        if abs(step) != self.part_size:
            # a strided-sampling walk (|stride| != part_size) would need a
            # gather, and the contiguous chunking would mis-slice it
            raise NotImplementedError(
                f"port_map: part_size={self.part_size} with stride={step} "
                f"is not supported (only |stride| == part_size)")
        span = (hi - lo) if step > 0 else (lo - hi)
        if span < 0 or (span + 1) % self.part_size:
            raise ValueError(
                f"port_map range [{self.start}, {self.end}] stride {step} "
                f"does not tile axis extent {size} by part_size "
                f"{self.part_size}")
        count = (span + 1) // self.part_size
        first = lo if step > 0 else lo - self.part_size + 1
        return first, count, step


@dataclasses.dataclass
class SubGraph:
    """One body: nested model, port maps and back edges."""

    model: Model
    inputs: List[PortMapEntry]
    outputs: List[PortMapEntry]
    # (from body Result layer id, to body Parameter layer id)
    back_edges: List[Tuple[int, int]] = dataclasses.field(default_factory=list)

    def validate(self, where: str = "subgraph"):
        nodes = self.model.nodes
        for e in self.inputs:
            n = nodes.get(e.internal_layer_id)
            if n is None or n.op_type != "Parameter":
                raise ValueError(
                    f"{where}: input port_map layer {e.internal_layer_id} "
                    f"is not a body Parameter")
        for e in self.outputs:
            n = nodes.get(e.internal_layer_id)
            if n is None or n.op_type != "Result":
                raise ValueError(
                    f"{where}: output port_map layer {e.internal_layer_id} "
                    f"is not a body Result")
        for frm, to in self.back_edges:
            fn, tn = nodes.get(frm), nodes.get(to)
            if fn is None or fn.op_type != "Result":
                raise ValueError(
                    f"{where}: back edge from layer {frm} is not a body Result")
            if tn is None or tn.op_type != "Parameter":
                raise ValueError(
                    f"{where}: back edge to layer {to} is not a body Parameter")
        mapped = {e.internal_layer_id for e in self.inputs}
        carried = {to for _, to in self.back_edges}
        for p in self.model.parameters:
            if p.id not in mapped and p.id not in carried:
                raise ValueError(
                    f"{where}: body Parameter {p.name!r} (layer {p.id}) is "
                    f"neither port-mapped nor a back-edge target")

    def result_source(self, result_layer_id: int) -> Tuple[int, int]:
        """(producer node id, port) feeding a body Result layer."""
        return self.model.in_edges[result_layer_id][0]
