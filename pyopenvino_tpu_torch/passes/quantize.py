"""INT8 weight-only quantization (per-output-channel, symmetric).

The port's own copy of ``pyopenvino_tpu/passes/quantize.py``, code for code,
so both packages give the same int8 codes and float32 scales.  For every
Const that feeds only weight ports (Convolution/GroupConvolution/MatMul and
the rest of the table below), store ``round(w / s)`` as int8 with
``s = max|w| / 127`` per output channel; the scale keeps the weight's rank
(keepdims), e.g. (Co, 1, 1, 1) for an OIHW conv weight.

The TORCH backend dequantizes each weight on every call
(runtime/compiler.py ``EmitCtx.weight_for``); the KERNELS backend hands the
int8 codes and the per-column scale to fused_gemm, which applies the scale
to the finished accumulator (kernels/gemm.py).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from pyopenvino_tpu_torch.ir import attrs as A
from pyopenvino_tpu_torch.ir.model import Model

# weight ports eligible for quantization: (op_type, input_port)
_WEIGHT_PORTS = {("Convolution", 1), ("GroupConvolution", 1), ("MatMul", 1),
                 ("ConvolutionBackpropData", 1),
                 # recurrent W/R matrices; biases stay float
                 ("LSTMCell", 3), ("LSTMCell", 4),
                 ("GRUCell", 2), ("GRUCell", 3),
                 ("RNNCell", 2), ("RNNCell", 3),
                 ("LSTMSequence", 4), ("LSTMSequence", 5),
                 ("GRUSequence", 3), ("GRUSequence", 4)}

_RECURRENT = {"LSTMCell", "GRUCell", "RNNCell",
              "LSTMSequence", "GRUSequence"}


def _quantize_array(
    w: np.ndarray, channel_axes: Tuple[int, ...]
) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-channel int8.  channel_axes: axes that index output
    channels (kept in the scale's shape); all others are reduced."""
    reduce_axes = tuple(a for a in range(w.ndim) if a not in channel_axes)
    absmax = np.abs(w).max(axis=reduce_axes, keepdims=True)
    scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return q, scale


def _channel_axes(consumer, ndim: int) -> Tuple[int, ...]:
    if consumer.op_type == "Convolution":
        return (0,)  # OIHW → per-O
    if consumer.op_type == "GroupConvolution":
        return (0, 1)  # GOIHW → per-(G, O)
    if consumer.op_type == "ConvolutionBackpropData":
        return (1,)  # IOHW → per-O
    if consumer.op_type in _RECURRENT:
        return tuple(range(ndim - 1))  # per output row (and direction)
    # MatMul: output channels are rows when transposed, columns when not
    tb = A.get_bool(consumer.attrs, "transpose_b", False)
    return (ndim - 2 if tb else ndim - 1,)


def quantize_weights(
    model: Model, min_elems: int = 0
) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    """Return {const_node_id: (int8 weights, float32 per-channel scales)}.

    ``min_elems`` (Config.quant_min_elems): weights with fewer elements
    stay float.  A Const read by anything but a weight port, or by
    consumers that disagree on its channel axes (two MatMuls with opposite
    ``transpose_b``), stays float."""
    out: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    for node in model.find_by_type("Const"):
        if node.const is None or not np.issubdtype(node.const.dtype, np.floating):
            continue
        if min_elems and node.const.size < min_elems:
            continue
        consumers = [
            (model.nodes[dst], dport)
            for _, dst, dport in model.out_edges[node.id]
        ]
        if not consumers:
            continue
        if not all((c.op_type, p) in _WEIGHT_PORTS for c, p in consumers):
            continue
        w = np.asarray(node.const, dtype=np.float32)
        axes = {_channel_axes(c, w.ndim) for c, _ in consumers}
        if len(axes) != 1:
            continue
        out[node.id] = _quantize_array(w, axes.pop())
    return out
