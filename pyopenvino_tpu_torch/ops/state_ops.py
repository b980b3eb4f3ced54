"""Stateful-inference ops: ReadValue and Assign (OpenVINO opset6 variables).

Counterpart of ``pyopenvino_tpu/ops/state_ops.py``.  ReadValue reads the
variable ``variable_id``, falling back to its init input (port 0) before the
first Assign or after a reset; Assign writes the variable, and the write is
visible to ReadValue on the NEXT inference.  A streaming model (a speech or
keyword-spotting network after OpenVINO's LowLatency2 transform) carries its
recurrent state this way from one call to the next.

Like Parameter, Const and Result, the two ops are run by the executors
themselves: the numpy interpreter keeps a ``state`` dict across ``run()``
calls (runtime/interpreter.py), and a CompiledNetwork keeps a dict of device
tensors across calls, reads it at each ReadValue, stages each Assign's write
and commits the staged writes after the walk (runtime/compiler.py).  So
``ref_compute`` and ``emit`` here refuse, and only shape inference is real.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from pyopenvino_tpu_torch.ops.spec import Op, ShapeResult, register


def variable_id(node) -> str:
    vid = node.attrs.get("variable_id", "")
    if not vid:
        raise ValueError(f"{node.op_type} node {node.name!r} has no variable_id attribute")
    return vid


@register
class ReadValue(Op):
    """Read variable ``variable_id``; before the first Assign (or after a
    reset) its value is the init input on port 0."""

    type_name = "ReadValue"

    def ref_compute(self, node, inputs):
        raise RuntimeError("ReadValue is run by the interpreter's state (runtime/interpreter.py)")

    def emit(self, ctx, node, inputs):
        raise RuntimeError("ReadValue is run by the compiled network's state "
                           "(runtime/compiler.py)")

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        if 0 in in_shapes:
            # no value, even where the init is a folded constant: the value
            # at run time is the variable's, which equals the init only
            # before the first Assign (a propagated value would fold every
            # read to the init)
            return ShapeResult({node.out_port: tuple(in_shapes[0])})
        # an init-less opset6 ReadValue takes its declared output shape
        # (zeros at reset)
        info = node.outputs.get(node.out_port)
        if info is None or info.shape == ():
            raise ValueError(f"ReadValue {node.name!r}: no init input and no declared "
                             "output shape to size the variable from")
        return ShapeResult({node.out_port: tuple(info.shape)})


@register
class Assign(Op):
    """Write input port 0 into variable ``variable_id``, visible to
    ReadValue on the NEXT inference.  A graph sink, like Result."""

    type_name = "Assign"

    def ref_compute(self, node, inputs):
        raise RuntimeError("Assign is run by the interpreter's state (runtime/interpreter.py)")

    def emit(self, ctx, node, inputs):
        raise RuntimeError("Assign is run by the compiled network's state "
                           "(runtime/compiler.py)")

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        return ShapeResult({})


def model_variables(model, analysis=None) -> Dict[str, dict]:
    """{variable_id: {"shape", "dtype", "init", "dynamic_init", "read",
    "assign"}} of every variable of ``model``: the one definition that both
    executors and the API's VariableState use.

    ``init`` is the statically known init value (None: zeros at reset);
    ``read`` and ``assign`` are node ids (``assign`` None for a read-only
    variable, whose state then stays as it is).  ``dynamic_init`` marks a
    ReadValue whose init input exists but is not statically known (an
    input-dependent init subgraph): the executors initialize such a
    variable from the init's value at the first run after a reset.

    A batch-baked graph (``IENetwork.reshape`` of a stateful IR) keeps the
    init at its unbatched shape while the Assign writes the batched tensor:
    N streams in lockstep, each starting from the broadcast init.  The
    variable then takes the assigned shape where the read shape broadcasts
    to it, and a mismatch raises."""
    variables: Dict[str, dict] = {}
    for node in model.find_by_type("ReadValue"):
        vid = variable_id(node)
        if vid in variables:
            raise ValueError(f"duplicate ReadValue for variable {vid!r}")
        info = node.outputs[node.out_port]
        init = None
        dynamic = False
        if analysis is not None and 0 in model.in_edges[node.id]:
            src, sport = model.in_edges[node.id][0]
            init = analysis.value(src, sport)
            dynamic = init is None
        variables[vid] = {
            "shape": tuple(info.shape),
            "dtype": np.dtype(info.dtype),
            "init": None if init is None else np.asarray(init),
            "dynamic_init": dynamic,
            "read": node.id,
            "assign": None,
        }
    for node in model.find_by_type("Assign"):
        vid = variable_id(node)
        if vid not in variables:
            raise ValueError(f"Assign {node.name!r} writes variable {vid!r} with no "
                             "matching ReadValue")
        if variables[vid]["assign"] is not None:
            raise ValueError(f"duplicate Assign for variable {vid!r}")
        variables[vid]["assign"] = node.id
    for vid, v in variables.items():
        if v["assign"] is None:
            continue
        info = model.nodes[v["assign"]].inputs.get(0)
        ashape = tuple(info.shape) if info is not None else ()
        if not ashape or ashape == v["shape"]:
            continue
        try:
            bshape = tuple(np.broadcast_shapes(v["shape"], ashape))
        except ValueError:
            bshape = None
        if bshape != ashape:
            raise ValueError(f"variable {vid!r}: Assign shape {ashape} is not a "
                             f"broadcast of the ReadValue shape {v['shape']}")
        v["shape"] = ashape
    return variables


def initial_state(variables: Dict[str, dict]) -> Dict[str, np.ndarray]:
    """A fresh {variable_id: array}: the init value where it is statically
    known (broadcast over the batch of a batch-baked variable), zeros
    otherwise.  A ``dynamic_init`` variable gets zeros here; the executors
    compute its init at the first run."""
    state = {}
    for vid, v in variables.items():
        if v["init"] is not None:
            init = np.asarray(v["init"], dtype=v["dtype"])
            if init.size == np.prod(v["shape"], dtype=int):
                state[vid] = init.reshape(v["shape"])
            else:
                state[vid] = np.ascontiguousarray(np.broadcast_to(init, v["shape"]))
        else:
            state[vid] = np.zeros(v["shape"], dtype=v["dtype"])
    return state
