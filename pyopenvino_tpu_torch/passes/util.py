"""Shared helpers for graph-rewrite passes.

Counterpart of ``pyopenvino_tpu/passes/util.py``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from pyopenvino_tpu_torch.ir.model import Model, ancestors


# ops whose output element reads only the same index of each input,
# broadcast operands aside (BatchNormInference and PReLU broadcast their
# per-channel operands along axis 1): a spatial row block runs them alone
# (parallel/mesh.py), and a baked batch may pass them on any axis
# (passes/shape_infer.py)
ELEMENTWISE = frozenset({
    "Abs", "Acos", "Acosh", "Add", "Asin", "Asinh", "Atan", "Atanh",
    "BatchNormInference", "Ceiling", "Clamp", "Convert", "Cos", "Cosh", "Divide", "Elu",
    "Equal", "Erf", "Exp", "FakeQuantize", "Floor", "FloorMod", "Gelu", "Greater",
    "GreaterEqual", "HSigmoid", "HSwish", "HardSigmoid", "Less", "LessEqual", "Log",
    "LogicalAnd", "LogicalNot", "LogicalOr", "LogicalXor", "Maximum", "Minimum", "Mish",
    "Mod", "Multiply", "Negative", "NotEqual", "PReLU", "Power", "ReLU", "Round", "Select",
    "Selu", "Sigmoid", "Sign", "Sin", "Sinh", "SoftPlus", "SoftSign", "Sqrt",
    "SquaredDifference", "Subtract", "Swish", "Tan", "Tanh",
})


def single_consumer(model: Model, nid: int) -> Optional[Tuple[object, int]]:
    """The unique (node, in_port) consuming nid's output, or None."""
    edges = model.out_edges[nid]
    if len(edges) != 1:
        return None
    _, dst, dport = edges[0]
    return model.nodes[dst], dport


def channel_aligned(shape, channels: int, rank: int = 4) -> bool:
    """True iff a const of ``shape``, numpy-broadcast against a rank-``rank``
    NCHW tensor, applies a length-``channels`` vector along the channel axis
    (dim 1) and nothing else.  A rank-1 (C,) vector right-aligns to W, not
    C, so it is channel-aligned only as a scalar."""
    if int(np.prod(shape)) != channels:
        return False
    if len(shape) > rank:
        return False
    full = (1,) * (rank - len(shape)) + tuple(int(d) for d in shape)
    return full[1] == channels and all(
        d == 1 for i, d in enumerate(full) if i != 1
    )


def prune_dead_nodes(model: Model) -> Tuple[Model, int]:
    """Drop nodes that cannot reach any Result or Assign (dead branches).
    An Assign is a sink like a Result: its write is read back at the next
    inference, so the subgraph that produces it is live.  Parameters are
    always kept.  Returns (model, dropped_count); the input model is
    returned unchanged when nothing is dead."""
    sinks = [n.id for n in model.results] + [n.id for n in model.find_by_type("Assign")]
    keep = ancestors(model, sinks)
    keep |= {n.id for n in model.parameters}
    dropped = len(model.nodes) - len(keep)
    if not dropped:
        return model, 0
    nodes = {nid: model.nodes[nid] for nid in keep}
    edges = [e for e in model.edges if e.src in keep and e.dst in keep]
    return Model(model.name, nodes, edges), dropped


def folded_nodes(model: Model, analysis) -> set:
    """Runtime nodes whose every output is statically known: the compiler
    never emits them, and consumers read the folded value instead."""
    out = set()
    for node in model:
        if node.op_type in ("Const", "Parameter", "Result"):
            continue
        if node.outputs and all(
            (node.id, p) in analysis.values for p in node.outputs
        ):
            out.add(node.id)
    return out
