"""Numpy interpreter backend: the differential-testing twin of the compiled
path, and the walker that activation calibration and bias correction run.

Counterpart of ``pyopenvino_tpu/runtime/interpreter.py``: walks the
topological order, gathers each node's inputs per edge, calls the op's numpy
``ref_compute`` and stores the results per (node, port).  The ops'
``ref_compute`` is the JAX package's numpy code, so the two interpreters
agree bit for bit.  TensorIterator, Loop and If drive an Interpreter of
their own over each body (ops/subgraph.py), so calibration under INT8-FULL
runs them here too.  The state ops (ReadValue/Assign) and the golden
feature-map hook come with the ops that need them (ROADMAP.md §1).
"""

from __future__ import annotations

import time
from typing import Dict, Tuple

import numpy as np

from pyopenvino_tpu_torch.ir.model import Model
from pyopenvino_tpu_torch.ops import get_op


class Interpreter:
    def __init__(self, model: Model):
        self.model = model

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
            else:
                outs = get_op(node.op_type).ref_compute(node, node_inputs)
                if observe is not None:
                    observe(node, node_inputs, outs)
            if verbose:
                print(f"{node.id} {node.op_type} {node.name} "
                      f"{time.perf_counter() - t0:.6f}")
            for port, arr in outs.items():
                store[(node.id, port)] = arr
        return results
