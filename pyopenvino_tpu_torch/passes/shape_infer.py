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

from pyopenvino_tpu_torch.ir import attrs as A
from pyopenvino_tpu_torch.ir.model import Model, TensorInfo
from pyopenvino_tpu_torch.ops import get_op
from pyopenvino_tpu_torch.passes.util import ELEMENTWISE

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
    time (runtime/compiler.py ``_batched_plan``).  So does a graph whose
    bake would mix examples (``_check_batch_axes``: an op that consumes or
    merges the batch, reads across it, or sees it off axis 0), which the
    JAX package's rule lets through: its ``infer_batch`` vmaps the declared
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
        _check_batch_axes(model, baked, batch)
    return baked


# ops that may carry the batch on any axis: each output element reads the
# same index of each input
_PER_INDEX = (ELEMENTWISE - {"BatchNormInference", "PReLU"}) | {"Transpose"}


def _batch_axis(declared, baked, batch) -> Optional[int]:
    """The axis of a baked tensor that carries the batch: the one axis where
    ``baked`` differs from ``declared``, declared 1 and baked ``batch``, or a
    leading ``batch`` before the whole declared shape (a Squeeze dropped the
    declared unit batch).  None where the shapes differ otherwise (the batch
    merged into another axis) or not at all (an op consumed it)."""
    declared, baked = tuple(declared), tuple(baked)
    if len(baked) == len(declared) + 1 and baked == (batch,) + declared:
        return 0
    diff = [k for k in range(len(declared)) if len(baked) == len(declared)
            and declared[k] != baked[k]]
    if len(diff) == 1 and declared[diff[0]] == 1 and baked[diff[0]] == batch:
        return diff[0]
    return None


def _axes_read(node, model, analysis) -> Dict[int, set]:
    """{input port: the axes of that input which ``node`` reads across}
    for the ops that read along an axis: a softmax, a reduction, a
    normalization, a scan, TopK, a Gather or Scatter, Concat, Split, the
    contracted axes of MatMul and Einsum, ReverseSequence's sequence.  An op
    not listed reads each index of its leading axis on its own (convs,
    pools, elementwise, layout ops within an example)."""
    t = node.op_type
    edges = model.in_edges[node.id]

    def rank(port):
        return len(analysis.shape(*edges[port]))

    def static(port):
        if port not in edges:
            return None
        val = analysis.value(*edges[port])
        return None if val is None else [int(v) for v in np.asarray(val).reshape(-1)]

    def norm(axes, port=0):
        return {a % max(rank(port), 1) for a in axes}

    if t in ("SoftMax", "LogSoftmax"):
        return {0: norm([A.get_int(node.attrs, "axis", 1)])}
    if t.startswith("Reduce") or t in ("NormalizeL2", "LRN", "MVN"):
        axes = static(1)
        if axes is None and t == "MVN":  # opset 2: every axis from 1 or 2 on
            return {0: set()}
        return {0: norm(axes if axes is not None else range(rank(0)))}
    if t == "CumSum":
        return {0: norm(static(1) or [0])}
    if t == "TopK":
        return {0: norm([A.get_int(node.attrs, "axis")])}
    if t == "Gather":
        return {0: norm(static(2))}
    if t == "GatherElements":
        axis = A.get_int(node.attrs, "axis", 0)
        return {0: norm([axis]), 1: norm([axis], 1)}
    if t == "ScatterElementsUpdate":
        return {p: norm(static(3), p) for p in (0, 1, 2)}
    if t == "GatherND":
        depth = analysis.shape(*edges[1])[-1]
        lead = A.get_int(node.attrs, "batch_dims", 0)
        return {0: set(range(lead, lead + depth))}
    if t == "ScatterNDUpdate":
        return {0: set(range(analysis.shape(*edges[1])[-1]))}
    if t == "Concat":
        return {p: norm([A.get_int(node.attrs, "axis")], p) for p in edges} if len(edges) > 1 else {}
    if t in ("Split", "VariadicSplit"):
        return {0: norm(static(1))}
    if t == "ReverseSequence":
        return {0: norm([A.get_int(node.attrs, "seq_axis", 1)])}
    if t == "MatMul":
        out = {}
        for port, flag, inner in ((0, "transpose_a", -1), (1, "transpose_b", -2)):
            r = rank(port)
            k = inner if r > 1 else -1
            if A.get_bool(node.attrs, flag, False) and r > 1:
                k = -3 - inner  # -1 <-> -2
            out[port] = norm([k], port)
        return out
    if t == "Einsum":
        eq = A.get_str(node.attrs, "equation").replace(" ", "")
        lhs, _, rhs = eq.partition("->")
        out = {}
        for port, term in zip(sorted(edges), lhs.split(",")):
            if "..." in term:
                # the labels before and after the ellipsis from each end
                head, _, tail = term.partition("...")
                r = rank(port)
                labels = list(head) + ["..."] * (r - len(head) - len(tail)) + list(tail)
            else:
                labels = list(term)
            out[port] = {k for k, lab in enumerate(labels)
                         if (lab == "..." and "..." not in rhs) or (lab != "..." and lab not in rhs)}
        return out
    return {}


def _check_batch_axes(declared: Model, baked: Model, batch: int) -> None:
    """Raise where the baked graph would mix examples, which the JAX
    package's vmap over the examples never does.  The walk tracks the axis
    that carries the batch in every tensor computed from the inputs (axis 0
    of each Parameter; ``_batch_axis`` of each output, by its shape at 1 and
    at ``batch``), and refuses:

      * a tensor whose batch is merged into another axis or consumed (its
        shape the same at 1 and at the baked batch: ``_random_graph``'s TopK
        gate reshapes (B, 1) to (B,) and Gathers index 0);
      * a tensor whose batch has left axis 0, unless every op that reads it
        reads index by index (elementwise, Transpose) or takes the batch
        there by its definition (CTCGreedyDecoder's (T, N, C)); a Result
        must see it on axis 0;
      * an op that reads across the batch axis (``_axes_read``).

    DetectionOutput's baked tables ((1, 1, K, 7) → (B, 1, K, 7), ops/ssd.py)
    and the Reshapes ``patch_reshape`` patched keep the batch on axis 0.  A
    tensor with a value at compile time (a ShapeOf chain) is not tracked."""
    before, after = infer_shapes(declared), infer_shapes(baked)
    axis = {(p.id, port): 0 for p in baked.parameters for port in p.outputs}
    for node in baked:
        edges = baked.in_edges[node.id]
        ins = {port: axis[src] for port, src in edges.items() if src in axis}
        if node.op_type == "Parameter" or not ins:
            continue
        where = f"bake_batch: {node.op_type} {node.name!r}"
        if node.op_type == "Result":
            if ins[0] != 0:
                raise ValueError(f"{where} would return the batch on axis {ins[0]}")
            continue
        for port, read in _axes_read(node, baked, after).items():
            if port in ins and ins[port] in read:
                raise ValueError(f"{where} reads across the batch (axis {ins[port]} of "
                                 f"input {port})")
        outs = {}
        for port in node.outputs:
            key = (node.id, port)
            if after.value(*key) is not None:
                continue
            a = _batch_axis(before.shape(*key), after.shape(*key), batch)
            if a is None:
                raise ValueError(
                    f"{where} consumes or merges the batch (its output is "
                    f"{before.shape(*key)} at batch 1 and {after.shape(*key)} at {batch})")
            outs[port] = a
        if node.op_type == "CTCGreedyDecoder":
            ok = set(ins.values()) == {1} and set(outs.values()) <= {0}
        else:
            ok = node.op_type in _PER_INDEX or all(
                a == 0 for a in list(ins.values()) + list(outs.values()))
        if not ok:
            raise ValueError(f"{where} reads the batch off axis 0 (inputs {ins}, "
                             f"outputs {outs})")
        axis.update({(node.id, port): a for port, a in outs.items()})


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
