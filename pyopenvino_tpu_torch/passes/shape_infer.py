"""Static shape inference, compile-time value propagation, and the batch
rule that compiles a graph at batch B.

Counterpart of ``pyopenvino_tpu/passes/shape_infer.py``.  Shapes are
computed from the op semantics in topological order; statically known
values (Const, and small tensors computed from them) propagate so the
compiler can consume them at compile time.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from pyopenvino_tpu_torch.ir.model import Model, TensorInfo
from pyopenvino_tpu_torch.ops import get_op

PortKey = Tuple[int, int]  # (node_id, port_id)


@dataclasses.dataclass
class ShapeAnalysis:
    shapes: Dict[PortKey, Tuple[int, ...]]
    values: Dict[PortKey, np.ndarray]

    def shape(self, nid: int, port: int) -> Tuple[int, ...]:
        return self.shapes[(nid, port)]

    def value(self, nid: int, port: int) -> Optional[np.ndarray]:
        return self.values.get((nid, port))


# Value propagation is only worthwhile for small tensors (shape vectors,
# anchor tables): never fold a conv output by accident.
_MAX_FOLD_ELEMS = 1 << 20


def _propagate(model: Model, hook=None) -> ShapeAnalysis:
    """One topological walk.  ``hook(model, node, in_shapes, in_values,
    values)`` may rewrite a node's inputs before its op sees them (the
    batch rule below)."""
    shapes: Dict[PortKey, Tuple[int, ...]] = {}
    values: Dict[PortKey, np.ndarray] = {}
    for node in model:
        ins = sorted(model.in_edges[node.id].items())
        in_shapes = {p: shapes[k] for p, k in ins}
        in_values = {p: values.get(k) for p, k in ins}
        if hook is not None:
            hook(model, node, in_shapes, in_values, values)
        res = get_op(node.op_type).infer_shapes(node, in_shapes, in_values)
        for port, shape in res.shapes.items():
            shapes[(node.id, port)] = tuple(int(d) for d in shape)
        for port, val in res.values.items():
            if val is not None and val.size <= _MAX_FOLD_ELEMS:
                values[(node.id, port)] = np.asarray(val)
    return ShapeAnalysis(shapes, values)


def infer_shapes(model: Model) -> ShapeAnalysis:
    return _propagate(model)


def bake_batch(model: Model, batch: int) -> Model:
    """Return a model with ``batch`` in every Parameter and in every
    shape-capturing Reshape target whose leading dim is the unit batch.

    The rule is the JAX package's: inference walks the graph with the
    batched Parameters, and a Reshape whose DATA input now leads with the
    batch while its constant target still leads with 1 gets that 1
    rewritten to ``batch`` (ResNet-18's flatten target (1, 512) becomes
    (B, 512)).  A leading -1 is accepted only when the rest of the target
    covers exactly one example.  A batch-carrying Reshape whose target
    cannot be patched (shared or non-constant) raises."""
    if batch < 1:
        raise ValueError(f"bake_batch: bad batch {batch}")
    nodes = dict(model.nodes)
    for p in model.parameters:
        shape = (batch,) + tuple(p.outputs[p.out_port].shape[1:])
        outs = {
            port: dataclasses.replace(info, shape=shape)
            for port, info in p.outputs.items()
        }
        nodes[p.id] = dataclasses.replace(p, outputs=outs)
    m = Model(model.name, nodes, list(model.edges))

    def patch_reshape(m, node, in_shapes, in_values, values):
        if (node.op_type != "Reshape" or batch == 1
                or not in_shapes.get(0) or in_shapes[0][0] != batch
                or in_values.get(1) is None):
            return
        t = [int(v) for v in np.asarray(in_values[1]).reshape(-1)]
        if t[0] == -1:
            per_ex = int(np.prod(in_shapes[0][1:]))
            rest = 1
            for i, v in enumerate(t[1:], start=1):
                if v == -1:
                    rest = -1  # a second -1: underdetermined
                    break
                if v == 0:
                    v = in_shapes[0][i] if i < len(in_shapes[0]) else 0
                rest *= v
            if rest != per_ex:
                raise ValueError(
                    f"bake_batch: Reshape {node.name!r} consumes the batch "
                    f"through a leading -1 target")
            return
        if t[0] != 1:
            return
        src, _sport = m.in_edges[node.id][1]
        cn = m.nodes[src]
        if (cn.op_type != "Const" or cn.const is None
                or len(m.out_edges[src]) != 1):
            raise ValueError(
                f"bake_batch: Reshape {node.name!r} consumes the batch but "
                f"its target is shared or non-constant")
        new = np.asarray(cn.const).copy().reshape(-1)
        new[0] = batch
        # replace, never mutate: the nodes dict shares Node objects with
        # the caller's model
        m.nodes[src] = dataclasses.replace(
            cn, const=new,
            outputs={cn.out_port: TensorInfo(shape=new.shape, dtype=new.dtype)})
        values[(src, cn.out_port)] = new
        in_values[1] = new

    _propagate(m, patch_reshape)
    return rederive_ports(m)


def rederive_ports(model: Model) -> Model:
    """Re-run shape inference and rewrite every declared port dim so the
    model stays self-consistent."""
    analysis = infer_shapes(model)
    final = {}
    for nid, node in model.nodes.items():
        ins = {
            port: dataclasses.replace(
                info, shape=analysis.shape(*model.in_edges[nid][port]))
            for port, info in node.inputs.items()
        }
        outs = {
            port: dataclasses.replace(info, shape=analysis.shape(nid, port))
            for port, info in node.outputs.items()
        }
        final[nid] = dataclasses.replace(node, inputs=ins, outputs=outs)
    return Model(model.name, final, list(model.edges))
