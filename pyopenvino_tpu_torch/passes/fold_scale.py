"""Fold per-channel Multiply constants back into convolution weights.

Counterpart of ``pyopenvino_tpu/passes/fold_scale.py``, on the port's own
``ir.model``.  A batch norm exported by Model Optimizer arrives as
Conv → Add(bias) → MaxPool → Multiply(s) → Add(shift) chains with
per-channel constants (``assets/trained/mnist_bn.xml``).  Per-channel
scaling commutes with the channel-wise ops in between:

    MaxPool(x)·s ≡ MaxPool(x·s)   and   ReLU(x)·s ≡ ReLU(x·s)   for s > 0
    (Add c)·s    ≡ Add (c·s) after scaling the producer

so when every element of s is positive (checked numerically at compile
time: BN scales γ/σ may in general be negative) the Multiply folds all the
way back into the conv weights (W[o] *= s[o]) and any traversed bias consts
(c *= s), and the node disappears.  Folding runs before INT8 quantization,
so the quantizer sees the effective weights.

Safety conditions: every hop in the chain is single-consumer, the scale
Const feeds only the Multiply, and the conv's weight Const feeds only that
conv.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from pyopenvino_tpu_torch.ir.model import Edge, Model
from pyopenvino_tpu_torch.passes.util import channel_aligned, single_consumer

# ops a positive per-channel scale commutes through (channel-preserving)
_COMMUTES_POSITIVE = ("MaxPool", "ReLU")


def _channel_scale(const_node, channels: int) -> Optional[np.ndarray]:
    """The (C,) scale vector if the const broadcasts per-channel, else None."""
    if const_node.const is None or not channel_aligned(const_node.const.shape, channels):
        return None
    return np.asarray(const_node.const, np.float32).reshape(-1)


def _trace_to_conv(model: Model, mul, data_port: int):
    """Walk the Multiply's producer chain back to a conv.

    Returns (conv_node, [bias const node ids to rescale], needs_positive)
    or None when the chain is not foldable."""
    src, _ = model.in_edges[mul.id][data_port]
    bias_consts: List[int] = []
    needs_positive = False
    for _ in range(8):  # chains are short; bound the walk
        node = model.nodes[src]
        if single_consumer(model, src) is None:
            return None  # someone else reads this intermediate
        if node.op_type in ("Convolution", "GroupConvolution"):
            return node, bias_consts, needs_positive
        if node.op_type in _COMMUTES_POSITIVE:
            needs_positive = True
            src, _ = model.in_edges[src][0]
            continue
        if node.op_type != "Add":
            return None
        # one side must be a single-use Const (a bias)
        for port in (0, 1):
            c_src, _ = model.in_edges[src][port]
            c_node = model.nodes[c_src]
            if (c_node.op_type == "Const" and c_node.const is not None
                    and len(model.out_edges[c_src]) == 1):
                bias_consts.append(c_src)
                src, _ = model.in_edges[src][1 - port]
                break
        else:
            return None
    return None


def fold_scale_into_conv(model: Model) -> Model:
    """Return a rewritten Model (the input untouched) with per-channel
    Multiply constants folded into conv weights and traversed biases, or
    the input itself when nothing folds."""
    nodes = dict(model.nodes)
    edges = list(model.edges)
    removed = set()

    for mul in model.find_by_type("Multiply"):
        const_port = next((p for p in (0, 1)
                           if model.nodes[model.in_edges[mul.id][p][0]].op_type == "Const"),
                          None)
        if const_port is None:
            continue
        s_src, _ = model.in_edges[mul.id][const_port]
        if len(model.out_edges[s_src]) != 1:
            continue
        traced = _trace_to_conv(model, mul, 1 - const_port)
        if traced is None:
            continue
        conv, bias_consts, needs_positive = traced

        w_src, _ = model.in_edges[conv.id][1]
        w_node = model.nodes[w_src]
        if w_node.const is None or len(model.out_edges[w_src]) != 1:
            continue
        if conv.op_type == "Convolution":
            channels = w_node.const.shape[0]
            scale_shape = (-1, 1, 1, 1)
        else:  # (G, Co, Ci, Kh, Kw): per g·co channel
            g, co = w_node.const.shape[:2]
            channels = g * co
            scale_shape = (g, co, 1, 1, 1)
        s = _channel_scale(model.nodes[s_src], channels)
        if s is None or (needs_positive and not np.all(s > 0)):
            continue  # max/relu do not commute with non-positive scales
        # every traversed bias must itself be channel-aligned; check them
        # all before changing anything
        if not all(channel_aligned(nodes[b].const.shape, channels) for b in bias_consts):
            continue

        w2 = (np.asarray(w_node.const, np.float32) * s.reshape(scale_shape)
              ).astype(w_node.const.dtype)
        nodes[w_src] = dataclasses.replace(w_node, const=w2)
        for b_src in bias_consts:
            b_node = nodes[b_src]
            # bias consts broadcast per channel like the scale: same layout
            b2 = (np.asarray(b_node.const, np.float32) * s.reshape(b_node.const.shape)
                  ).astype(b_node.const.dtype)
            nodes[b_src] = dataclasses.replace(b_node, const=b2)

        # rewire: the Multiply's consumers read its data producer directly
        d_src, d_sport = model.in_edges[mul.id][1 - const_port]
        edges = [Edge(d_src, d_sport, e.dst, e.dst_port) if e.src == mul.id else e
                 for e in edges if e.dst != mul.id]
        removed.update((mul.id, s_src))

    if not removed:
        return model
    for nid in removed:
        nodes.pop(nid, None)
    return Model(model.name, nodes, edges)
