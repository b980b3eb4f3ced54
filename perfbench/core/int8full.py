"""The plain PyTorch reference of an INT8-FULL network, from the IR, the
float weights and the calibration frames alone.

It works out again what the program's set-up derives: each Convolution,
GroupConvolution and MatMul input's per-tensor scale (max |x| / 127 over
the calibration frames, a float32 walk), each weight's per-output-channel
codes and scales, and then walks the frames with ``plain.int8_root``,
every other operation rounded to the compute dtype.  ``dtype`` float8
(e4m3) in place of bfloat16 is the control.  A configuration's reference
subclasses it, and gives in ``OPS`` the operations its topology has beyond
``core/plain.py``'s (``plain.OpFn``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from perfbench.core import plain
from perfbench.core.ir import Graph


class Int8FullReference:
    OPS: plain.Ops = {}

    def __init__(self, graph: Graph, consts: Dict[int, torch.Tensor],
                 calibration_frames: torch.Tensor, dtype: torch.dtype = torch.bfloat16):
        self.graph, self.consts, self.dtype = graph, consts, dtype
        self.act_scales = plain.calibrate(graph, consts, calibration_frames, ops=self.OPS)
        self.codes = {layer.id: plain.quantize_weight(layer, consts[layer.inputs[1][0]])
                      for layer in graph.of_type(*plain.ROOTS)}
        softmax = graph.of_type("SoftMax")
        self.logits_name = graph.src(softmax[0], 0).name if softmax else None
        self.result = graph.of_type("Result")[0].name

    def __call__(self, frames_u8: torch.Tensor, block: int = 32) -> Tuple[np.ndarray, np.ndarray]:
        """(answers, logits) of ``frames_u8``, float32 numpy, in blocks of
        ``block`` frames."""
        root = plain.int8_root(self.act_scales, self.codes, self.dtype)
        keep = (self.logits_name,) if self.logits_name else ()
        answers, logits = [], []
        with torch.no_grad(), plain.no_tf32():
            for i in range(0, frames_u8.shape[0], block):
                x = plain.to_input(frames_u8[i:i + block], self.dtype)
                out = plain.walk(self.graph, self.consts, x, dtype=self.dtype, root_fn=root,
                                 keep=keep, ops=self.OPS)
                answers.append(plain.numpy_f32(out[self.result]))
                logits.append(plain.numpy_f32(out[self.logits_name or self.result]))
        return np.concatenate(answers), np.concatenate(logits)
