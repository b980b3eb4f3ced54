"""OpenVINO-compatible facade of the port.

Counterpart of ``pyopenvino_tpu/api.py`` (IECore, IENetwork,
ExecutableNetwork):

    ie = IECore()
    net = ie.read_network(xml, bin)         # → IENetwork
    exe = ie.load_network(net, "GPU")       # → ExecutableNetwork
    exe.kernel_type = "pallas"              # or "kernels"; "xla"/"torch";
                                            # "numpy" (the host interpreter)
    exe.set_calibration(samples)            # INT8-FULL: [{input_name: blob}];
                                            # a POT IR's FakeQuantizes carry them
    res = exe.infer({input_name: blob})     # {result_node_name: ndarray}
    res = exe.infer_batch({input_name: (B, ...) blob})

Inputs bind by Parameter node name and outputs key by Result node name.  A
stateful network (ReadValue/Assign) keeps its variables between calls:
``exe.query_state()`` lists a ``VariableState`` per variable (``name``, the
``state`` getter and setter, ``reset()``), ``exe.reset_state()`` resets
them all, and ``net.reshape({input_name: (N, ...)})`` before
``load_network`` runs N streams in lockstep.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from pyopenvino_tpu_torch.config import (
    KERNEL_TYPE_TO_BACKEND,
    Backend,
    Config,
    check_supported,
)
from pyopenvino_tpu_torch.ir import Model, read_ir_model
from pyopenvino_tpu_torch.ops import supported_ops
from pyopenvino_tpu_torch.runtime.interpreter import Interpreter


class IENetwork:
    """The typed Model with the reference's net.inputs / net.outputs."""

    def __init__(self, model: Model):
        self._set_model(model)

    def _set_model(self, model: Model):
        self.model = model
        self.name = model.name
        self.inputs = [
            {"id": n.id, "name": n.name, "shape": n.outputs[n.out_port].shape}
            for n in model.parameters
        ]
        self.outputs = [
            {"id": n.id, "name": n.name, "shape": n.inputs[0].shape}
            for n in model.results
        ]

    def reshape(self, new_shapes: Dict[str, tuple]) -> "IENetwork":
        """Change input shapes before ``load_network`` (OpenVINO's
        ``IENetwork.reshape``): shape inference derives every port again,
        and an op that captured the old shape raises its own error."""
        from pyopenvino_tpu_torch.passes.shape_infer import reshape_model

        self._set_model(reshape_model(self.model, new_shapes))
        return self


class ExecutableNetwork:
    """A loaded network on one device with a selectable backend.
    Compilation is lazy and cached per configuration: setting
    ``kernel_type`` switches the backend that ``infer`` uses.  The
    INTERPRETER backend runs the numpy interpreter on the host."""

    def __init__(self, network: IENetwork, config: Config, device: torch.device):
        self.ienet = network
        self.config = config
        self.device = device
        self._compiled = {}
        self._interpreter: Optional[Interpreter] = None
        self._calibration = None

    @property
    def kernel_type(self) -> str:
        return self.config.backend.value

    @kernel_type.setter
    def kernel_type(self, value: str):
        if value not in KERNEL_TYPE_TO_BACKEND:
            raise ValueError(
                f"unknown kernel_type {value!r}; "
                f"accepted: {sorted(KERNEL_TYPE_TO_BACKEND)}"
            )
        self.config = self.config.replace(backend=KERNEL_TYPE_TO_BACKEND[value])

    def set_calibration(self, samples):
        """Representative {input_name: blob} dicts for INT8-FULL activation
        calibration (passes/calibrate.py) and bias correction; the compiled
        networks are dropped, since the scales change them.  A POT/NNCF IR
        whose activation FakeQuantizes give every conv and MatMul its scale
        compiles under INT8-FULL without them (passes/fold_fq.py)."""
        self._calibration = list(samples)
        self._compiled.clear()

    def compiled(self):
        """The CompiledNetwork of the current configuration."""
        check_supported(self.config)
        key = dataclasses.astuple(self.config)
        if key not in self._compiled:
            from pyopenvino_tpu_torch.runtime.compiler import compile_model

            self._compiled[key] = compile_model(
                self.ienet.model, self.config, device=self.device,
                calibration_samples=self._calibration)
        return self._compiled[key]

    def _get_interpreter(self) -> Interpreter:
        if self._interpreter is None:
            self._interpreter = Interpreter(self.ienet.model)
        return self._interpreter

    def infer(self, inputs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        if self.config.backend == Backend.INTERPRETER:
            return self._get_interpreter().run(inputs)
        return self.compiled().infer(inputs)

    def infer_batch(self, inputs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        if self.config.backend == Backend.INTERPRETER:
            # the interpreter runs the declared (batch-1) graph once per
            # example; rows reshape to the declared input shape and the
            # outputs drop the declared unit batch dim, as on the compiled
            # path
            it = self._get_interpreter()
            declared = {p.name: p.outputs[p.out_port].shape
                        for p in self.ienet.model.parameters}
            n = np.asarray(next(iter(inputs.values()))).shape[0]
            per = [it.run({k: np.asarray(v[i]).reshape(declared[k])
                           for k, v in inputs.items()})
                   for i in range(n)]
            return {k: np.stack([p[k][0] for p in per], axis=0) for k in per[0]}
        return self.compiled().infer_batch(inputs)

    # -- variable state (ReadValue/Assign, ops/state_ops.py) -----------------

    def _state_holder(self):
        """The executor that carries the variables of this configuration:
        the numpy interpreter, or the compiled network (its state on the
        device)."""
        if self.config.backend == Backend.INTERPRETER:
            return self._get_interpreter()
        return self.compiled()

    @property
    def stateful(self) -> bool:
        return bool(self.ienet.model.find_by_type("ReadValue"))

    def query_state(self) -> list:
        """One VariableState per variable, sorted by variable id."""
        holder = self._state_holder()
        return [VariableState(holder, vid) for vid in sorted(holder.query_state())]

    def reset_state(self):
        """Every variable back to its init."""
        self._state_holder().reset_state()


class VariableState:
    """One ReadValue/Assign variable, OpenVINO's ``VariableState``: ``name``,
    ``state`` (get and set) and ``reset()``, on the executor that holds it."""

    def __init__(self, holder, name: str):
        self._holder = holder
        self.name = name

    @property
    def state(self) -> np.ndarray:
        return self._holder.query_state()[self.name]

    @state.setter
    def state(self, value):
        self._holder.set_state({self.name: value})

    def reset(self):
        """This variable back to its init, the others untouched; a dynamic
        (input-dependent) init is computed again at the next inference."""
        self._holder.reset_variable(self.name)

    def __repr__(self):
        return f"VariableState({self.name!r})"


class IECore:
    def __init__(self):
        self.supported = set(supported_ops())

    def read_network(self, model: str, weights: Optional[str] = None) -> IENetwork:
        return IENetwork(read_ir_model(model, weights))

    def check_nodes(self, network: IENetwork):
        """Fail-fast unsupported-op check, nested bodies included."""
        def op_types(model):
            for n in model.nodes.values():
                yield n.op_type
                for sg in (n.subgraphs or {}).values():
                    yield from op_types(sg.model)

        unsupported = set(op_types(network.model)) - self.supported
        if unsupported:
            raise ValueError(f"unsupported node types: {sorted(unsupported)}")

    def load_network(
        self,
        network: IENetwork,
        device_name: str = "GPU",
        config: Optional[Config] = None,
    ) -> ExecutableNetwork:
        """``"GPU"`` runs on ``torch.device("cuda")`` and raises when PyTorch
        sees no CUDA device.  ``"CPU"`` runs the same compiled path on CPU
        tensors, where each kernel wrapper takes its plain PyTorch version.
        (In the JAX package ``"CPU"`` selects the numpy interpreter; here
        ``kernel_type = "numpy"`` does, on either device.)"""
        self.check_nodes(network)
        name = device_name.upper()
        if name == "GPU":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "load_network(..., 'GPU'): PyTorch sees no CUDA device")
            device = torch.device("cuda")
        elif name == "CPU":
            device = torch.device("cpu")
        else:
            raise ValueError(f"unknown device {device_name!r}: 'GPU' or 'CPU'")
        return ExecutableNetwork(network, config or Config(), device)
