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
    (B, 512); SSD's (1, -1) loc and conf targets become (B, -1)).  A
    leading -1 is accepted only when the rest of the target covers exactly
    one example.  A batch-carrying Reshape whose target cannot be patched
    (shared or non-constant) raises.  DetectionOutput, whose output layout
    depends on the batch, gets the batch as its ``_baked_batch`` attribute
    (ops/ssd.py), so that it never guesses it from shapes.  The bodies of
    TensorIterator, Loop and If are not rewritten: their Parameters keep
    the declared batch, so a TensorIterator over a batch-1 body refuses the
    batched input (a ValueError) and the network runs one example at a
    time (runtime/compiler.py ``_batched_plan``).  So does a graph in which
    an op consumes the batch (``_check_batch_kept``), which the JAX
    package's rule lets through: its ``infer_batch`` vmaps the declared
    graph and bakes only where a caller asks."""
    if batch < 1:
        raise ValueError(f"bake_batch: bad batch {batch}")
    nodes = dict(model.nodes)
    for n in model.nodes.values():
        if n.op_type == "DetectionOutput":
            nodes[n.id] = dataclasses.replace(
                n, attrs={**n.attrs, "_baked_batch": str(batch)})
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
    baked = rederive_ports(m)
    if batch > 1:
        _check_batch_kept(model, baked)
    return baked


def _check_batch_kept(declared: Model, baked: Model) -> None:
    """Raise where a tensor computed from the inputs has the same shape in
    the baked graph as in the declared one: its op consumed the batch (a
    Gather, a reduction or a Reshape along it), so the baked graph would mix
    examples, which the JAX package's vmap over the examples never does
    (``_random_graph``'s TopK gate: a (B, 1) → (B,) Reshape, then a Gather
    of index 0).  A tensor with a value at compile time (a ShapeOf chain)
    is not one."""
    before, after = infer_shapes(declared), infer_shapes(baked)
    live = {p.id for p in baked.parameters}
    for node in baked:
        if node.id in live or not any(src in live for src, _ in baked.in_edges[node.id].values()):
            continue
        live.add(node.id)
        for port in node.outputs:
            key = (node.id, port)
            if after.value(*key) is None and after.shape(*key) == before.shape(*key):
                raise ValueError(
                    f"bake_batch: {node.op_type} {node.name!r} consumes the batch (its "
                    f"output is {after.shape(*key)} at batch 1 and at the baked batch)")


def reshape_model(model: Model, new_shapes: Dict[str, Tuple[int, ...]]) -> Model:
    """A new Model with the named Parameters' shapes replaced and every
    declared port shape derived again by shape inference: OpenVINO's
    ``IENetwork.reshape``.  A graph with shape-capturing constants (a fixed
    Reshape target, PriorBox anchors) raises its op's own shape error.  A
    stateful graph reshaped to a batch of N runs N streams in lockstep, its
    variables at the assigned (batched) shape (ops/state_ops.py)."""
    by_name = {n.name: n for n in model.parameters}
    unknown = sorted(set(new_shapes) - set(by_name))
    if unknown:
        raise ValueError(f"reshape: not Parameter inputs: {unknown}; "
                         f"inputs are {sorted(by_name)}")
    nodes = dict(model.nodes)
    for name, shape in new_shapes.items():
        p = by_name[name]
        outs = {port: dataclasses.replace(info, shape=tuple(int(d) for d in shape))
                for port, info in p.outputs.items()}
        nodes[p.id] = dataclasses.replace(p, outputs=outs)
    return rederive_ports(Model(model.name, nodes, list(model.edges)))


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
