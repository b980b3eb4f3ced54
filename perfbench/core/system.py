"""The system under test, ``pyopenvino_tpu_torch``, through its public entry
points: ``IECore.read_network`` → ``PrePostProcessor`` → ``load_network`` →
``set_calibration`` → ``infer_batch``.

The only module of the benchmark that imports the program.  It hands the
program the IR, the ``.bin`` and the calibration frames, and reads back
answers.
"""

from __future__ import annotations

from typing import List

import numpy as np


def load(cfg: dict, xml: str, bin_path: str, calibration: List[np.ndarray], device: str):
    """An ExecutableNetwork of configuration ``cfg`` (its ``mode``),
    calibrated on ``calibration`` (u8 frames, each of the input's shape
    without its batch) and compiled."""
    from pyopenvino_tpu_torch import IECore, PrePostProcessor
    from pyopenvino_tpu_torch.config import Config, QuantMode

    mode = cfg["mode"]
    ie = IECore()
    net = ie.read_network(xml, bin_path)
    if mode["ingress"] != "f32":
        ppp = PrePostProcessor(net)
        ppp.input().tensor().set_element_type(mode["ingress"])
        net = ppp.build()
    exe = ie.load_network(net, "GPU" if device == "cuda" else "CPU", config=Config(
        quant=QuantMode(mode["quant"]), compute_dtype=mode["compute_dtype"]))
    exe.kernel_type = mode["kernel_type"]
    name = input_name(exe)
    if calibration:
        exe.set_calibration([{name: frame[None]} for frame in calibration])
    exe.compiled()
    return exe


def input_name(exe) -> str:
    return exe.ienet.inputs[0]["name"]


def result_name(exe) -> str:
    return exe.ienet.outputs[0]["name"]
