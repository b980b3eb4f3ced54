"""The plain PyTorch reference of ``resnet18.int8full.bf16``: ResNet-18 (He et al. 2015) at its published widths,
INT8-FULL with bfloat16 compute, from the IR in configs/, the benchmark's
weights and its calibration frames alone (``core/int8full.py``: the
activation scales and weight codes worked out again, exact integer sums,
float32 epilogues rounded once).  Imports nothing of the program."""

import torch

from perfbench.core.int8full import Int8FullReference


class Reference(Int8FullReference):
    def __init__(self, graph, consts, calibration, dtype=torch.bfloat16):
        super().__init__(graph, consts, calibration, dtype)
