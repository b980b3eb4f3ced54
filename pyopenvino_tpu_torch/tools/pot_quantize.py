"""Offline post-training quantizer: any IR → an IR with FakeQuantize nodes,
the POT/NNCF-style artifact that ``passes/fold_fq.py`` consumes.

The port's own copy of ``tools/pot_quantize.py`` on the port's
``passes/calibrate.py`` and ``ir/writer.py``, so the two give the same
FakeQuantize nodes and ranges for the same model and samples.

Scheme (symmetric, the engine's native grid):

  * weights (a Const feeding the weight port of Convolution,
    GroupConvolution, ConvolutionBackpropData or MatMul): a per-output-
    channel 256-level FakeQuantize for the conv family (OIHW axis 0, GOIHW
    axes 0 and 1, IOHW axis 1), per-tensor for MatMul;
  * activations (the data port of a quantizable op): a per-tensor
    FakeQuantize whose range is the interpreter-observed max-abs over the
    calibration samples (``calibrate_activations``, percentile-clipped as
    POT's default calibrator can be); consumers of one tensor share one
    node, at the widest of their ranges.

Ranges follow the symmetric-int8 convention of POT/NNCF: for a max-abs
``hi`` and L levels, il = −(L/2)/(L/2−1)·hi and ih = hi, so step =
hi/127 at L = 256, zero lies on the grid (post-ReLU zeros stay exact) and
the lattice is the engine's own ±127-code grid (``fold_fq`` →
``quantize_weights`` requantizes a conv weight losslessly).  Write the
result with ``ir/writer.py::write_ir_model``; ``models/pot.py`` does so for
ResNet-18.  Calibration inputs are uniform in [0, 255) (``gen_samples``),
the range of the models that take raw pixels.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np

from pyopenvino_tpu_torch.ir.model import Edge, Model, Node, TensorInfo

# (consumer op type) → per-output-channel axes of its weight, or None for
# per-tensor; the axes of passes/quantize.py
_WEIGHT_AXES = {
    "Convolution": (0,),              # OIHW
    "GroupConvolution": (0, 1),       # GOIHW
    "ConvolutionBackpropData": (1,),  # IOHW
    "MatMul": None,                   # per-tensor (transpose_b varies)
}


def _per_channel_hi(w: np.ndarray, axes) -> np.ndarray:
    """max |w| over every axis not in ``axes``, keepdims."""
    reduce_axes = tuple(i for i in range(w.ndim) if i not in axes)
    hi = np.abs(w).max(axis=reduce_axes, keepdims=True)
    return np.maximum(hi, 1e-12).astype(np.float32)


def _sym_ranges(hi: np.ndarray, levels: int):
    """(lo, hi) of the zero-exact symmetric grid: step = hi/(L/2 − 1),
    lo = −(L/2)·step."""
    half = levels // 2
    step = hi / (half - 1)
    return (-half * step).astype(np.float32), hi.astype(np.float32)


class _Surgeon:
    """Insert-only graph editing on copies of a model's nodes and edges."""

    def __init__(self, model: Model):
        self.model = model
        self.nodes: Dict[int, Node] = dict(model.nodes)
        self.edges = list(model.edges)
        self._next = max(model.nodes) + 1

    def add_const(self, value: np.ndarray, name: str) -> int:
        nid = self._next
        self._next += 1
        info = TensorInfo(tuple(value.shape), np.dtype(value.dtype))
        self.nodes[nid] = Node(nid, name, "Const", {}, {}, {0: info},
                               const=np.ascontiguousarray(value))
        return nid

    def insert_fq(self, src: int, sport: int, dsts, lo: np.ndarray, hi: np.ndarray,
                  levels: int, name: str) -> int:
        """Splice a FakeQuantize between (src, sport) and the (dst, dport)
        consumer edges ``dsts``; returns its node id."""
        data_info = self.model.nodes[src].outputs[sport]
        rid_lo = self.add_const(lo, f"{name}/low")
        rid_hi = self.add_const(hi, f"{name}/high")
        fq_id = self._next
        self._next += 1
        rinfo = TensorInfo(tuple(lo.shape), np.dtype(np.float32))
        self.nodes[fq_id] = Node(
            fq_id, name, "FakeQuantize", {"levels": str(levels)},
            {0: data_info, 1: rinfo, 2: rinfo, 3: rinfo, 4: rinfo}, {5: data_info})
        drop = set(dsts)
        self.edges = [e for e in self.edges
                      if not (e.src == src and e.src_port == sport
                              and (e.dst, e.dst_port) in drop)]
        self.edges += [Edge(src, sport, fq_id, 0),
                       Edge(rid_lo, 0, fq_id, 1), Edge(rid_hi, 0, fq_id, 2),
                       Edge(rid_lo, 0, fq_id, 3), Edge(rid_hi, 0, fq_id, 4)]
        self.edges += [Edge(fq_id, 5, d, p) for d, p in dsts]
        return fq_id

    def build(self) -> Model:
        return Model(self.model.name, self.nodes, self.edges)


def quantize_ir(model: Model, samples: Optional[Iterable[Dict[str, np.ndarray]]] = None,
                levels: int = 256, percentile: float = 100.0,
                activations: bool = True) -> Model:
    """A new Model with FakeQuantize nodes inserted.  ``samples``
    (calibration input dicts) are required when ``activations``."""
    s = _Surgeon(model)

    # weights: one FakeQuantize per Const → weight-port edge group
    for const in model.find_by_type("Const"):
        group = [(dst, dport) for _, dst, dport in model.out_edges[const.id]
                 if dport == 1 and model.nodes[dst].op_type in _WEIGHT_AXES]
        if not group or const.const is None:
            continue
        w = np.asarray(const.const, np.float32)
        axes = _WEIGHT_AXES[model.nodes[group[0][0]].op_type]
        if len({model.nodes[d].op_type for d, _ in group}) > 1:
            axes = None  # shared across op types: per-tensor is safe
        hi = (_per_channel_hi(w, axes) if axes is not None
              else np.array([max(float(np.abs(w).max()), 1e-12)], np.float32))
        lo, hi = _sym_ranges(hi, levels)
        s.insert_fq(const.id, 0, group, lo, hi, levels, f"{const.name}/fq")

    # activations: a per-tensor FakeQuantize on quantizable data inputs
    if activations:
        if samples is None:
            raise ValueError("activation quantization needs samples")
        from pyopenvino_tpu_torch.passes.calibrate import (
            QUANTIZABLE,
            calibrate_activations,
        )

        scales = calibrate_activations(model, samples, percentile=percentile)
        # consumers of one produced tensor share ONE FakeQuantize (the
        # widest observed range wins)
        by_src: Dict[tuple, list] = {}
        for node in model:
            if node.op_type not in QUANTIZABLE or node.id not in scales:
                continue
            src, sport = model.in_edges[node.id][0]
            if model.nodes[src].op_type == "FakeQuantize":
                continue  # already quantized upstream (a POT IR again)
            by_src.setdefault((src, sport), []).append(node.id)
        for (src, sport), consumers in by_src.items():
            hi_v = max(scales[c] for c in consumers) * ((levels // 2) - 1)
            lo, hi = _sym_ranges(np.array([hi_v], np.float32), levels)
            s.insert_fq(src, sport, [(c, 0) for c in consumers], lo, hi, levels,
                        f"{model.nodes[src].name}/act_fq")
    return s.build()


def gen_samples(model: Model, n: int, seed: int = 0):
    """``n`` calibration input dicts, uniform in [0, 255) at each
    Parameter's declared shape, from ``seed``."""
    rng = np.random.default_rng(seed)
    return [{p.name: rng.uniform(0, 255, p.outputs[0].shape).astype(np.float32)
             for p in model.parameters}
            for _ in range(n)]
