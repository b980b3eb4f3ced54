"""OpenVINO-compatible facade of the port.

Counterpart of ``pyopenvino_tpu/api.py`` (IECore, IENetwork,
ExecutableNetwork):

    ie = IECore()
    net = ie.read_network(xml, bin)         # → IENetwork
    exe = ie.load_network(net, "GPU")       # → ExecutableNetwork
    exe.kernel_type = "pallas"              # or "kernels"; "xla"/"torch"
    res = exe.infer({input_name: blob})     # {result_node_name: ndarray}
    res = exe.infer_batch({input_name: (B, ...) blob})

Inputs bind by Parameter node name and outputs key by Result node name.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from pyopenvino_tpu_torch.config import (
    KERNEL_TYPE_TO_BACKEND,
    Config,
    check_supported,
)
from pyopenvino_tpu_torch.ir import Model, read_ir_model
from pyopenvino_tpu_torch.ops import supported_ops


class IENetwork:
    """The typed Model with the reference's net.inputs / net.outputs."""

    def __init__(self, model: Model):
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


class ExecutableNetwork:
    """A loaded network on one device with a selectable backend.
    Compilation is lazy and cached per configuration: setting
    ``kernel_type`` switches the backend that ``infer`` uses."""

    def __init__(self, network: IENetwork, config: Config, device: torch.device):
        self.ienet = network
        self.config = config
        self.device = device
        self._compiled = {}

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

    def compiled(self):
        """The CompiledNetwork of the current configuration."""
        check_supported(self.config)
        key = dataclasses.astuple(self.config)
        if key not in self._compiled:
            from pyopenvino_tpu_torch.runtime.compiler import compile_model

            self._compiled[key] = compile_model(
                self.ienet.model, self.config, device=self.device)
        return self._compiled[key]

    def infer(self, inputs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        return self.compiled().infer(inputs)

    def infer_batch(self, inputs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        return self.compiled().infer_batch(inputs)


class IECore:
    def __init__(self):
        self.supported = set(supported_ops())

    def read_network(self, model: str, weights: Optional[str] = None) -> IENetwork:
        return IENetwork(read_ir_model(model, weights))

    def check_nodes(self, network: IENetwork):
        """Fail-fast unsupported-op check."""
        unsupported = {
            n.op_type
            for n in network.model.nodes.values()
            if n.op_type not in self.supported
        }
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
        (In the JAX package ``"CPU"`` selects the numpy interpreter, which
        the port does not have yet.)"""
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
