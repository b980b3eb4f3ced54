"""Numpy interpreter backend: the differential-testing twin of the compiled
path, and the walker that activation calibration and bias correction run.

Counterpart of ``pyopenvino_tpu/runtime/interpreter.py``: walks the
topological order, gathers each node's inputs per edge, calls the op's numpy
``ref_compute`` and stores the results per (node, port).  The ops'
``ref_compute`` is the JAX package's numpy code, so the two interpreters
agree bit for bit.  TensorIterator, Loop and If drive an Interpreter of
their own over each body (ops/subgraph.py), so calibration under INT8-FULL
runs them here too.  ReadValue and Assign read and write ``state``, a
{variable_id: ndarray} dict kept across ``run()`` calls (ops/state_ops.py):
Assigns are staged during the walk and committed after it, so a write is
seen by the NEXT run even where an Assign comes before its ReadValue in
topological order.  Calibration walks its samples through one Interpreter,
so a stateful network's state carries from sample to sample, as in the JAX
package.

It keeps the JAX interpreter's debugging hooks: ``last_timings``, each
node's (id, type, name, seconds) of the last run (``get_perf_counts`` on
``kernel_type = "numpy"``); ``expected_result``, {node name: golden array
or (precision, dims, array)} checked on every output port of the named
nodes by ``utils/compare.compare_golden`` at ``expected_rtol``, with the
names that differ in ``last_compare_failures``; and
``capture_node_args``, node ids whose (node, inputs) pairs ``run``
appends to ``captured``.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from pyopenvino_tpu_torch.ir.model import Model
from pyopenvino_tpu_torch.ops import get_op
from pyopenvino_tpu_torch.ops.state_ops import initial_state, model_variables, variable_id
from pyopenvino_tpu_torch.passes.shape_infer import infer_shapes
from pyopenvino_tpu_torch.utils.compare import compare_golden


class Interpreter:
    def __init__(self, model: Model):
        self.model = model
        self.state: Dict[str, np.ndarray] = {}
        self._variables = None
        self.expected_result: Optional[Dict[str, object]] = None
        self.expected_rtol: float = 1.0
        self.last_compare_failures: List[str] = []
        self.capture_node_args: List[int] = []
        self.captured: List[Tuple[object, dict]] = []
        self.last_timings: List[Tuple[int, str, str, float]] = []

    def run(self, inputs: Dict[str, np.ndarray], verbose: bool = False,
            observe=None) -> Dict[str, np.ndarray]:
        """Run the numpy twin; returns {Result name: ndarray}.  ``verbose``
        prints each node's wall-clock seconds.  ``observe(node,
        node_inputs, outs)`` is called after every op that computes (not
        Parameter, Const or Result): the per-node hook of calibration
        (passes/calibrate.py) and bias correction."""
        model = self.model
        params = {}
        for node in model.parameters:
            if node.name not in inputs:
                raise KeyError(f"missing input for Parameter {node.name!r}")
            info = node.outputs[node.out_port]
            params[node.id] = (
                np.asarray(inputs[node.name]).reshape(info.shape).astype(info.dtype)
            )

        store: Dict[Tuple[int, int], np.ndarray] = {}
        results: Dict[str, np.ndarray] = {}
        pending_state: Dict[str, np.ndarray] = {}
        self.last_timings = []
        failures = []
        for node in model:
            node_inputs = {
                port: store[(src, sport)]
                for port, (src, sport) in sorted(model.in_edges[node.id].items())
            }
            t0 = time.perf_counter()
            if node.op_type == "Parameter":
                outs = {node.out_port: params[node.id]}
            elif node.op_type == "Const":
                if node.const is None:
                    raise RuntimeError(f"Const {node.name!r}: weights not loaded")
                outs = {node.out_port: node.const}
            elif node.op_type == "Result":
                results[node.name] = node_inputs[0]
                outs = {}
            elif node.op_type == "ReadValue":
                vid = variable_id(node)
                if vid not in self.state:
                    info = node.outputs[node.out_port]
                    init = (node_inputs[0].astype(info.dtype) if 0 in node_inputs
                            else np.zeros(info.shape, dtype=info.dtype))
                    self.state[vid] = init.reshape(info.shape)
                outs = {node.out_port: self.state[vid]}
            elif node.op_type == "Assign":
                pending_state[variable_id(node)] = node_inputs[0]
                outs = {}
            else:
                if node.id in self.capture_node_args:
                    self.captured.append((node, dict(node_inputs)))
                outs = get_op(node.op_type).ref_compute(node, node_inputs)
                if observe is not None:
                    observe(node, node_inputs, outs)
            dt = time.perf_counter() - t0
            self.last_timings.append((node.id, node.op_type, node.name, dt))
            if verbose:
                print(f"{node.id} {node.op_type} {node.name} {dt:.6f}")
            for port, arr in outs.items():
                store[(node.id, port)] = arr
                if self.expected_result and node.name in self.expected_result:
                    if not compare_golden(node.name, arr, self.expected_result[node.name],
                                          rtol=self.expected_rtol, verbose=verbose):
                        failures.append(node.name)
        self.state.update(pending_state)
        self.last_compare_failures = failures
        return results

    # -- variable state (ops/state_ops.py) -------------------------------------

    def variables(self) -> Dict[str, dict]:
        if self._variables is None:
            self._variables = model_variables(self.model, infer_shapes(self.model))
        return self._variables

    def reset_state(self):
        """Forget every variable: the next run initializes each from its
        ReadValue's init input."""
        self.state.clear()

    def reset_variable(self, vid: str):
        """Forget one variable, the others untouched: the next run
        recomputes its init, a static or an input-dependent one."""
        if vid not in self.variables():
            raise KeyError(f"unknown variable {vid!r}")
        self.state.pop(vid, None)

    def query_state(self) -> Dict[str, np.ndarray]:
        """{variable_id: value}; a variable no run has touched yet reports
        its initial value, as the compiled network does."""
        out = initial_state(self.variables())
        out.update({k: np.asarray(v) for k, v in self.state.items()})
        return out

    def set_state(self, values: Dict[str, np.ndarray]):
        variables = self.variables()
        for vid, val in values.items():
            if vid not in variables:
                raise KeyError(f"unknown variable {vid!r}")
            var = variables[vid]
            self.state[vid] = np.asarray(val, dtype=var["dtype"]).reshape(var["shape"])
