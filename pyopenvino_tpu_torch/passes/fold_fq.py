"""FakeQuantize at compile time: weight-side folding and IR-carried
activation scales.

The port's own copy of ``pyopenvino_tpu/passes/fold_fq.py``, step for step.
POT/NNCF-quantized IRs wrap every conv/matmul weight in a Const →
FakeQuantize(levels, constant ranges) → consumer chain.  A FakeQuantize of
a constant with constant ranges is a constant: ``fold_fake_quantize``
evaluates it once through the op's own numpy ``ref_compute`` (so folding
and emulation cannot disagree, and the folded weights are the JAX
package's byte for byte) and rewires its consumers to the data Const, which
now holds the grid-snapped values.  ``passes/quantize.py`` then sees plain
Const → weight-port edges, and a 256-level symmetric grid survives its
int8 requantization (both are 255-step lattices).

Activation-side FakeQuantizes stay and run as elementwise emulation
(ops/extended.py), except under QuantMode.INT8_FULL, where
``extract_act_scales`` turns symmetric zero-exact grids (il =
−(L/2)/(L/2−1)·ih, the convention POT/NNCF and tools/pot_quantize.py emit)
into per-tensor activation scales and drops the nodes: the consumers then
quantize to the same ±127-code lattice themselves, and a POT IR runs
INT8-FULL with no calibration samples.

The data Const and the FakeQuantize must be single-consumer; a range Const
is dropped only when nothing else reads it.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from pyopenvino_tpu_torch.ir.model import Edge, Model
from pyopenvino_tpu_torch.ops import get_op


def _bypass(model: Model, fq, edges):
    """``edges`` with ``fq`` cut out: its consumers read its data input.
    Returns (edges, the node ids to remove: fq and its range Consts that
    only it reads)."""
    ins = model.in_edges[fq.id]
    d_src, d_sport = ins[0]
    edges = [e for e in edges if e.dst != fq.id]
    edges = [Edge(d_src, d_sport, e.dst, e.dst_port) if e.src == fq.id else e
             for e in edges]
    removed = {fq.id}
    for p in range(1, 5):
        rid = ins[p][0]
        if all(e.dst == fq.id for e in model.edges if e.src == rid):
            removed.add(rid)
    return edges, removed


def fold_fake_quantize(model: Model) -> Model:
    """A rewritten Model (``model`` untouched) with every FakeQuantize of a
    single-consumer weight Const evaluated into that Const and removed."""
    nodes = dict(model.nodes)
    edges = list(model.edges)
    removed = set()
    for fq in model.find_by_type("FakeQuantize"):
        ins = model.in_edges[fq.id]
        srcs = {port: model.nodes[src] for port, (src, _) in ins.items()}
        if any(srcs[p].op_type != "Const" or srcs[p].const is None for p in range(5)):
            continue  # activation FakeQuantize (or a structural parse)
        data_id = ins[0][0]
        if len(model.out_edges[data_id]) != 1:
            continue  # a shared weight: folding would change its other readers
        out = get_op("FakeQuantize").ref_compute(
            fq, {p: np.asarray(srcs[p].const) for p in range(5)})[fq.out_port]
        nodes[data_id] = dataclasses.replace(nodes[data_id],
                                             const=np.ascontiguousarray(out))
        edges, gone = _bypass(model, fq, edges)
        removed |= gone
    if not removed:
        return model
    for nid in removed:
        nodes.pop(nid, None)
    return Model(model.name, nodes, edges)


def _symmetric_scale(srcs, levels: int):
    """The per-tensor int8 scale when the FakeQuantize encodes the
    zero-exact symmetric grid (equal scalar input and output ranges,
    il = −(L/2)·step, ih = (L/2 − 1)·step), else None."""
    try:
        il, ih, ol, oh = (float(np.asarray(srcs[p].const).reshape(()))
                          for p in (1, 2, 3, 4))
    except ValueError:
        return None  # per-channel ranges
    if (il, ih) != (ol, oh) or ih <= 0 or il >= 0:
        return None
    half = levels // 2
    step = ih / (half - 1)
    if abs(il + half * step) > 1e-6 * max(abs(il), step):
        return None  # zero is not on the grid: not the engine's lattice
    return step


def extract_act_scales(model: Model, quantizable) -> tuple:
    """(model', {consumer node id: scale}): every symmetric activation
    FakeQuantize whose consumers are all data ports (port 0) of
    ``quantizable`` op types is removed and becomes their per-tensor
    activation scale, the table ``passes/calibrate.py`` produces."""
    edges = list(model.edges)
    removed = set()
    scales = {}
    for fq in model.find_by_type("FakeQuantize"):
        ins = model.in_edges[fq.id]
        srcs = {port: model.nodes[src] for port, (src, _) in ins.items()}
        if srcs[0].op_type == "Const":
            continue  # a weight FakeQuantize: fold_fake_quantize's job
        if any(srcs[p].op_type != "Const" or srcs[p].const is None for p in range(1, 5)):
            continue
        consumers = [(dst, dport) for _, dst, dport in model.out_edges[fq.id]]
        if not consumers or any(model.nodes[d].op_type not in quantizable or p != 0
                                for d, p in consumers):
            continue  # it feeds something the int8 path cannot honour
        scale = _symmetric_scale(srcs, int(fq.attrs.get("levels", 256)))
        if scale is None:
            continue
        edges, gone = _bypass(model, fq, edges)
        removed |= gone
        for d, _ in consumers:
            scales[d] = max(scale, scales.get(d, 0.0))
    if not scales:
        return model, {}
    nodes = {nid: n for nid, n in model.nodes.items() if nid not in removed}
    return Model(model.name, nodes, edges), scales
