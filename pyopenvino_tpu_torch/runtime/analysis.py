"""The compiled network's cost and memory analyses, from the port's own walk.

Counterparts of ``pyopenvino_tpu/runtime/compiler.py``'s
``CompiledNetwork.cost_analysis`` and ``memory_analysis`` (lines 1127-1145),
which read XLA's reports of the jitted program at B = 1.  The port runs no
XLA program, so both walk the compiled graph at its declared shapes, in the
order ``CompiledNetwork._run`` emits it: the folded nodes and the nodes a
fused chain absorbs do not run, a fused chain runs once at its root, and a
TensorIterator's, Loop's or If's body runs once an iteration.  Nothing is
launched: both work on the CPU as on the card.

``cost_analysis`` → {"flops", "transcendentals", "bytes accessed"}:

  * Convolution, GroupConvolution, ConvolutionBackpropData and MatMul:
    2 flops a multiply-add, every tap of the kernel window counted, those
    in the padding too (the port's kernels and cuDNN compute them), and
    the recurrent cells' and sequences' gate products the same way; a
    fused chain adds one flop an output element for its bias and one for
    its ReLU or Clamp.  XLA leaves the padding's taps out, which puts the
    port's count of shapes_resnet (3×3 convs on 8×8 to 32×32 maps) 7.8 %
    above XLA's CPU count and mnist_bn's 0.1 %;
  * the elementwise ops: the flops and transcendentals an output element
    of ``_ELEMENTWISE`` (one flop for arithmetic, comparisons and
    selects; one transcendental for exp, log, sqrt, pow, tanh, the
    logistic, erf and the trigonometric functions, plus the flops around
    them in Swish, Gelu, SoftPlus, Mish, Elu and Selu);
  * MaxPool and AvgPool: one flop a window element an output element
    (AvgPool one more for the divide); the reductions one flop an input
    element (ReduceMean one more an output element);
  * SoftMax: the max, subtract, sum and divide (four flops an element) and
    one exp an element; MVN, NormalizeL2 and GroupNormalization their sums
    and one square root a row of the last axis;
  * LRN: the port's window sum (``size`` adds an element), the square,
    α, the bias and the product (four more) and one transcendental an
    element, the power, as XLA counts the JAX package's LRN (its 200,704
    elements and the softmax's 10 are googlenet_shapes' whole count).
    XLA also counts that LRN's window sum as a banded channel matmul (2·C
    flops an element), which with the padding's taps puts the port's
    googlenet_shapes 3.2 % below XLA's;
  * every other op (data movement, gathers, sorts, NMS and the detection
    post-processing) counts no flops, and neither do INT8-FULL's
    quantize and dequantize steps;
  * "bytes accessed": what each step reads and writes as the port issues
    it: its inputs as stored (a weight's int8 codes and its scale, an
    int8-stored edge at a byte an element, a float tensor in the compute
    dtype) and its outputs, a fused chain's bias read once.

``memory_analysis`` → the JAX package's five keys:

  * ``argument_size_in_bytes``: the resident weight tensors, counted once a
    storage (the GEMM operands that the KERNELS routes derive and cache on
    their first forward are counted once they exist, so read it after a
    forward), plus each input as it lies on the device (a float input in
    the compute dtype, a u8 image at a byte a pixel);
  * ``output_size_in_bytes``: what ``infer`` returns, each Result at its
    declared shape and dtype;
  * ``temp_size_in_bytes``: ``_run`` keeps every value it emits until the
    walk ends, so the sum of them (a body's own values, freed when its run
    returns, and an op's transients inside its emit are not counted);
  * ``alias_size_in_bytes``: 0;
  * ``generated_code_size_in_bytes``: the bytes of the CUDA libraries that
    the network's kernel routes load (``kernels/build.py``), 0 on TORCH and
    on the CPU; the Triton softmax's JIT code is not counted.
"""

from __future__ import annotations

import collections
from typing import Dict, Iterator, List, Tuple

import numpy as np

from pyopenvino_tpu_torch.ir import attrs as A

PortKey = Tuple[int, int]

_TRIG = ("Sin", "Cos", "Tan", "Asin", "Acos", "Atan", "Sinh", "Cosh", "Tanh",
         "Asinh", "Acosh", "Atanh")

# (flops, transcendentals) an output element
_ELEMENTWISE: Dict[str, Tuple[int, int]] = {
    **dict.fromkeys((
        "Add", "Subtract", "Multiply", "Divide", "Maximum", "Minimum", "Abs", "Negative",
        "Floor", "Ceiling", "Round", "Sign", "Mod", "FloorMod", "ReLU", "Clamp", "Equal",
        "NotEqual", "Greater", "GreaterEqual", "Less", "LessEqual", "LogicalAnd",
        "LogicalOr", "LogicalXor", "LogicalNot", "Select", "CumSum"), (1, 0)),
    **dict.fromkeys(("Exp", "Log", "Sqrt", "Power", "Erf", "Sigmoid", *_TRIG), (0, 1)),
    "SquaredDifference": (2, 0), "PReLU": (2, 0), "HSigmoid": (3, 0),
    "HardSigmoid": (3, 0), "HSwish": (4, 0), "SoftSign": (3, 0),
    "BatchNormInference": (2, 0), "FakeQuantize": (6, 0),
    "Swish": (2, 1), "SoftPlus": (1, 2), "Mish": (2, 3), "Elu": (2, 1), "Selu": (3, 1),
}

# the weight's input port of each recurrent op, and (gates, transcendentals
# a hidden unit a step)
_RECURRENT = {"LSTMCell": (3, 4, 5), "GRUCell": (2, 3, 3), "RNNCell": (2, 1, 1),
              "LSTMSequence": (4, 4, 5), "GRUSequence": (3, 3, 3)}
_REDUCTIONS = ("ReduceSum", "ReduceMean", "ReduceMax", "ReduceMin", "ReduceProd",
               "ReduceL1", "ReduceL2", "ReduceLogicalAnd", "ReduceLogicalOr")
_ACT_FLOPS = {"relu": 1, "clamp": 1}
# flops an element (sums, centring, squares, the divide, GroupNormalization's
# scale and shift); one square root a row of the last axis
_NORMALIZATIONS = {"MVN": 5, "NormalizeL2": 3, "GroupNormalization": 7}


def _elems(shape) -> int:
    return int(np.prod(shape, dtype=np.int64))


def _op_cost(node, in_shapes: Dict[int, tuple], out_shape: tuple) -> Tuple[int, int]:
    """(flops, transcendentals) of one run of ``node`` (no fused epilogue)."""
    t, e = node.op_type, _elems(out_shape)
    if t == "Convolution":
        return 2 * e * _elems(in_shapes[1][1:]), 0
    if t == "GroupConvolution":
        return 2 * e * _elems(in_shapes[1][2:]), 0
    if t == "ConvolutionBackpropData":  # (Ci, Co, kh, kw): every input element scattered
        return 2 * _elems(in_shapes[0]) * _elems(in_shapes[1][1:]), 0
    if t == "MatMul":
        a = in_shapes[0]
        k = a[-2] if A.get_bool(node.attrs, "transpose_a", False) else a[-1]
        return 2 * e * int(k), 0
    if t in _ELEMENTWISE:
        f, tr = _ELEMENTWISE[t]
        return f * e, tr * e
    if t in ("MaxPool", "AvgPool"):
        kh, kw = A.get_int_tuple(node.attrs, "kernel")
        return e * kh * kw + (e if t == "AvgPool" else 0), 0
    if t in _REDUCTIONS:
        n_in = _elems(in_shapes[0])
        return n_in + (e if t == "ReduceMean" else 0), (e if t == "ReduceL2" else 0)
    if t == "SoftMax":
        return 4 * e, e
    if t == "LogSoftmax":
        return 4 * e, 2 * e
    if t == "LRN":
        return (A.get_int(node.attrs, "size") + 4) * e, e
    if t in _NORMALIZATIONS:
        return _NORMALIZATIONS[t] * e, e // max(1, out_shape[-1])
    if t == "Gelu":
        return (7 if A.get_str(node.attrs, "approximation_mode", "erf").lower() == "tanh"
                else 4) * e, e
    if t in _RECURRENT:
        wport, gates, trans = _RECURRENT[t]
        w, r = in_shapes[wport], in_shapes[wport + 1]
        hidden = r[-1]
        x = in_shapes[0]
        steps = x[1] if t.endswith("Sequence") else 1
        dirs = w[0] if t.endswith("Sequence") else 1
        units = dirs * steps * x[0] * hidden  # hidden units a forward
        return (2 * units * gates * (w[-1] + r[-1]) + 4 * gates * units), trans * units
    return 0, 0


# one emitted step of a walk: the node, its inputs' (port, key), its bias
# key and activation (a fused chain's root) and the keys it stores
_Step = collections.namedtuple("_Step", "node ins bias act outs")


def _steps(net, model, analysis, prefix="") -> Iterator[_Step]:
    """The steps ``_run`` (``prefix`` "") or a ``BodyWalk`` emits."""
    from pyopenvino_tpu_torch.passes.util import folded_nodes
    from pyopenvino_tpu_torch.runtime.compiler import STATIC_PORTS

    body = bool(prefix)
    skip = folded_nodes(model, analysis) if body else net._folded_nodes | net._fused_skip
    fusions = {} if body else net._fusions
    for node in model:
        if node.op_type in ("Parameter", "Const", "Result", "ReadValue", "Assign") or (
                node.id in skip):
            continue
        ins = [(port, key) for port, key in sorted(model.in_edges[node.id].items())
               if (node.op_type, port) not in STATIC_PORTS]
        f = fusions.get(node.id)
        if f is not None:
            yield _Step(node, ins, f.bias_src, f.act, [f.out_key])
        else:
            yield _Step(node, ins, None, None, [(node.id, p) for p in node.outputs])


class _Walk:
    """Byte sizes of one graph's tensors as ``_run`` holds them."""

    def __init__(self, net, model, analysis, prefix=""):
        self.net, self.model, self.analysis, self.prefix = net, model, analysis, prefix
        self.cdt_bytes = net.compute_dtype.itemsize
        self.int8_edges = {} if prefix else net._int8_edges

    def value_bytes(self, key: PortKey) -> int:
        """A tensor the walk holds: an int8-stored edge at a byte an
        element, a float one in the compute dtype, any other in its
        declared dtype."""
        src, sport = key
        n = _elems(self.analysis.shape(src, sport))
        if key in self.int8_edges:
            return n
        info = self.model.nodes[src].outputs.get(sport)
        if info is None or np.issubdtype(info.dtype, np.floating):
            return n * self.cdt_bytes
        return n * np.dtype(info.dtype).itemsize

    def input_bytes(self, key: PortKey) -> int:
        """What a step reads at ``key``: a weight as stored (int8 codes
        and their scale), a folded value as materialized, else the held
        tensor."""
        src, sport = key
        weights = self.net.weights
        wkey = self.prefix + str(src)
        if self.model.nodes[src].op_type == "Const" and wkey in weights:
            scale = weights.get(f"{wkey}.scale")
            return weights[wkey].nbytes + (scale.nbytes if scale is not None else 0)
        folded = weights.get(f"folded.{src}.{sport}")
        if folded is not None and not self.prefix:
            return folded.nbytes
        val = self.analysis.value(src, sport)
        if val is not None:
            return int(np.asarray(val).nbytes)
        return self.value_bytes(key)


def _iterations(node, analysis, model) -> int:
    """How many times a TensorIterator or Loop runs its body: the sliced
    inputs' count, else a Loop's static trip count, else once."""
    from pyopenvino_tpu_torch.ops.subgraph import _validate_inputs

    in_shapes = {p: analysis.shape(*k) for p, k in model.in_edges[node.id].items()}
    sg = node.subgraphs["body"]
    data = in_shapes if node.op_type == "TensorIterator" else {
        p: s for p, s in in_shapes.items() if p >= 2}
    iters = _validate_inputs(node, sg, data)
    if iters < 0 and node.op_type == "Loop":
        tc = analysis.value(*model.in_edges[node.id][0])
        iters = int(np.asarray(tc).reshape(())) if tc is not None else 1
    return max(1, iters)


def _graph_cost(net, model, analysis, prefix="") -> List[int]:
    """[flops, transcendentals, bytes accessed] of one run of a graph."""
    from pyopenvino_tpu_torch.ops.subgraph import body_analysis

    walk = _Walk(net, model, analysis, prefix)
    total = [0, 0, 0]
    for step in _steps(net, model, analysis, prefix):
        node = step.node
        in_shapes = {p: analysis.shape(*k) for p, k in step.ins}
        out_shape = analysis.shape(node.id, node.out_port) if node.outputs else ()
        flops, trans = _op_cost(node, in_shapes, out_shape)
        if step.bias is not None:
            flops += _elems(out_shape)
        if step.act is not None:
            flops += _ACT_FLOPS.get(step.act[0], 1) * _elems(out_shape)
        nbytes = (sum(walk.input_bytes(k) for _, k in step.ins)
                  + (walk.input_bytes(step.bias) if step.bias is not None else 0)
                  + sum(walk.value_bytes(k) for k in step.outs))
        total = [total[0] + flops, total[1] + trans, total[2] + nbytes]
        if node.subgraphs:
            bodies = [_graph_cost(net, sg.model, body_analysis(sg),
                                  f"{prefix}sub.{node.id}.{bname}.")
                      for bname, sg in node.subgraphs.items()]
            if node.op_type == "If":  # the dearer branch
                bodies = [max(bodies)]
            reps = 1 if node.op_type == "If" else _iterations(node, analysis, model)
            for body in bodies:
                total = [t + reps * b for t, b in zip(total, body)]
    return total


def cost_analysis(net) -> Dict[str, float]:
    flops, trans, nbytes = _graph_cost(net, net.model, net.analysis)
    return {"flops": float(flops), "transcendentals": float(trans),
            "bytes accessed": float(nbytes)}


def _resident_bytes(tensors) -> int:
    """Bytes of the distinct storages under ``tensors`` (a cached GEMM
    operand that is a view of its weight shares the weight's)."""
    seen, total = set(), 0
    for t in tensors:
        storage = t.untyped_storage()
        key = (storage.data_ptr(), t.device)
        if key not in seen:
            seen.add(key)
            total += storage.nbytes()
    return total


def _kernel_sources(net) -> List[str]:
    """The ``csrc`` sources whose libraries the network's kernel routes
    load: ``ops/conv.py::kernel_route`` for a Convolution, fused_gemm for a
    MatMul on a 2-D weight."""
    from pyopenvino_tpu_torch.config import Backend, QuantMode
    from pyopenvino_tpu_torch.ops.conv import _conv_attrs, kernel_route

    if net.config.backend != Backend.KERNELS or net.device.type != "cuda":
        return []
    model, sources = net.model, set()
    for step in _steps(net, model, net.analysis):
        node = step.node
        if node.op_type not in ("Convolution", "MatMul"):
            continue
        w_src, w_port = model.in_edges[node.id][1]
        w_shape = net.analysis.shape(w_src, w_port)
        if node.op_type == "MatMul":
            if len(w_shape) == 2:
                sources.add("fused_gemm.cu")
            continue
        int8_w = w_src in net._quantized
        int8_acts = (int8_w and net.config.quant == QuantMode.INT8_FULL
                     and node.id in net.act_scales)
        route = kernel_route(w_shape, *_conv_attrs(node), int8_acts, int8_w)
        if route is not None:
            sources.add("conv_direct.cu" if route == "conv2d_direct" else "fused_gemm.cu")
    return sorted(sources)


def memory_analysis(net) -> Dict[str, int]:
    from pyopenvino_tpu_torch.kernels import build

    walk = _Walk(net, net.model, net.analysis)
    inputs = sum(walk.value_bytes((p.id, p.out_port)) for p in net.model.parameters)
    outputs = 0
    for r in net.model.results:
        info = r.inputs[0]
        outputs += _elems(net.analysis.shape(*net.model.in_edges[r.id][0])) * np.dtype(
            info.dtype).itemsize
    temp = sum(walk.value_bytes(k) for step in _steps(net, net.model, net.analysis)
               for k in step.outs)
    code = sum(build.compile_source(src)[0].stat().st_size for src in _kernel_sources(net))
    return {
        "argument_size_in_bytes": _resident_bytes(
            [*net.weights.values(), *net._derived.values()]) + inputs,
        "output_size_in_bytes": outputs,
        "temp_size_in_bytes": temp,
        "alias_size_in_bytes": 0,
        "generated_code_size_in_bytes": code,
    }
