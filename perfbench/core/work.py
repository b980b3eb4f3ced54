"""The work a forward needs, counted from the IR's shapes: multiply-adds and
bytes of every Convolution, GroupConvolution and MatMul, whatever
implements them.

Bytes count each input, weight, bias and output once, at the sizes the
configuration states for them (``work_bytes``: INT8-FULL reads int8
activation codes and int8 weights and writes the compute dtype).  A node's
bound is max(2 · MACs / peak operations, bytes / peak bandwidth).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from perfbench.core.ir import Graph

ROOTS = ("Convolution", "GroupConvolution", "MatMul")


def nodes(graph: Graph, batch: int, sizes: Dict[str, int]) -> List[dict]:
    """{name, type, macs, bytes} of each root at ``batch`` (the IR declares
    batch 1)."""
    out = []
    for layer in graph.of_type(*ROOTS):
        x, w = layer.in_shapes[0], layer.in_shapes[1]
        y = layer.out_shape
        if layer.type == "MatMul":
            k = x[-2] if layer.attrs.get("transpose_a") == "true" else x[-1]
            macs = int(np.prod(y)) * k
        else:  # output elements × the inputs each reads: Ci (of its group) · kh · kw
            macs = int(np.prod(y)) * int(np.prod(w[-3:]))
        macs *= batch
        bias = int(np.prod(y[1:2])) if layer.type != "MatMul" else int(y[-1])
        nbytes = (int(np.prod(x)) * batch * sizes["input"] + int(np.prod(w)) * sizes["weight"]
                  + bias * sizes["bias"] + int(np.prod(y)) * batch * sizes["output"])
        out.append({"name": layer.name, "type": layer.type, "macs": macs, "bytes": nbytes})
    return out


def macs_per_image(graph: Graph) -> int:
    return sum(n["macs"] for n in nodes(graph, 1, {"input": 0, "weight": 0, "bias": 0,
                                                    "output": 0}))


def bound_seconds(graph: Graph, batch: int, sizes: Dict[str, int], peak_ops: float,
                  bandwidth: float) -> float:
    """Σ over the roots of each one's bound at ``batch``."""
    return sum(max(2.0 * n["macs"] / peak_ops, n["bytes"] / bandwidth)
               for n in nodes(graph, batch, sizes))
