"""Epilogue fusion: Conv/GroupConv/MatMul → Add(const bias) → ReLU/Clamp.

Counterpart of ``pyopenvino_tpu/passes/fuse.py``.  The chains are found at
compile time; the compiler emits the root with the bias and activation as
its epilogue (inside the fused_gemm kernel on the KERNELS backend, or as the
bias argument of ``F.conv2d`` plus the activation otherwise) and
skips the absorbed nodes.  MobileNet-v2's residual Adds stay unfused: the
bias Add after a linear bottleneck's 1×1 conv fuses, and the Add of the
skip connection that follows it has no Const operand.

A chain fuses only when each intermediate output has exactly one consumer
and the Add's second operand is a Const broadcasting purely over the
channel dimension.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from pyopenvino_tpu_torch.ir import attrs as A
from pyopenvino_tpu_torch.ir.model import Model
from pyopenvino_tpu_torch.passes.util import channel_aligned, single_consumer

_ROOTS = ("Convolution", "GroupConvolution", "MatMul")


@dataclasses.dataclass
class Fusion:
    root: int                                # conv/matmul node id
    bias_src: Optional[Tuple[int, int]]      # (const node id, out port)
    act: Optional[tuple]                     # ("relu",0,0) | ("clamp",lo,hi)
    out_key: Tuple[int, int]                 # (node id, port) to register under
    skip: Tuple[int, ...]                    # absorbed node ids


def _out_channels(analysis, node) -> int:
    shape = analysis.shape(node.id, node.out_port)
    if node.op_type in ("Convolution", "GroupConvolution"):
        return shape[1]  # NCHW
    return shape[-1]  # MatMul


def _bias_ok(bias_shape, channels: int, root_type: str) -> bool:
    """Const must broadcast over the channel dim only."""
    if int(np.prod(bias_shape)) != channels:
        return False
    if root_type == "MatMul":
        return bias_shape[-1] == channels
    return channel_aligned(bias_shape, channels)


def find_fusions(model: Model, analysis) -> Dict[int, Fusion]:
    fusions: Dict[int, Fusion] = {}
    for node in model:
        if node.op_type not in _ROOTS:
            continue
        channels = _out_channels(analysis, node)
        chain_end, bias_src, act = node, None, None
        skip = []

        nxt = single_consumer(model, chain_end.id)
        if nxt is not None and nxt[0].op_type == "Add":
            add_node, data_port = nxt[0], nxt[1]
            src, sport = model.in_edges[add_node.id][1 - data_port]
            if model.nodes[src].op_type == "Const" and _bias_ok(
                analysis.shape(src, sport), channels, node.op_type
            ):
                bias_src = (src, sport)
                skip.append(add_node.id)
                chain_end = add_node
                nxt = single_consumer(model, chain_end.id)

        if nxt is not None and nxt[1] == 0:
            act_node = nxt[0]
            if act_node.op_type == "ReLU":
                act = ("relu", 0.0, 0.0)
            elif act_node.op_type == "Clamp":
                act = (
                    "clamp",
                    A.get_float(act_node.attrs, "min"),
                    A.get_float(act_node.attrs, "max"),
                )
            if act is not None:
                skip.append(act_node.id)
                chain_end = act_node

        if skip:
            fusions[node.id] = Fusion(
                root=node.id,
                bias_src=bias_src,
                act=act,
                out_key=(chain_end.id, chain_end.out_port),
                skip=tuple(skip),
            )
    return fusions
