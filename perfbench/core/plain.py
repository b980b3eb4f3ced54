"""Plain PyTorch semantics of the IR's operations, for the benchmark's own
uses: the weight maker's float walk, the references' calibration and their
INT8-FULL walk.  Nothing here imports the program under test.

Every value is held as a float32 tensor.  ``walk`` rounds each operation's
result to the stated compute dtype (``round_to``), so one walk serves
float32, bfloat16 and the float8 control alike.  A Convolution,
GroupConvolution or MatMul takes the Add of a per-channel Const and a
ReLU or Clamp right after it into its result before the one rounding,
as the configuration states ("every product summed in float32, rounded
once after its epilogue").

The walk knows the operations of the configurations it was written for.  A
configuration whose topology has others gives their semantics in its own
reference (``reference/<name>.py``: ``Reference.OPS``, {type: OpFn}), which
the walk takes before its own; no file here changes for it.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.core.ir import Graph, Layer

ROOTS = ("Convolution", "GroupConvolution", "MatMul")
_FP8_MAX = 448.0  # float8_e4m3fn's largest finite value


def round_to(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` rounded to nearest even in ``dtype``, held in float32.  Float8
    saturates at its largest finite value instead of giving NaN."""
    if dtype == torch.float32:
        return t.float()
    if dtype == torch.float8_e4m3fn:
        t = t.float().clamp(-_FP8_MAX, _FP8_MAX)
    return t.to(dtype).float()


def epilogue(graph: Graph, root: Layer):
    """(bias Const, the layers taken in, activation layer) of the Add(Const)
    and ReLU / Clamp that follow ``root``, each taken only where it is the
    single consumer of what comes before it."""
    bias = act = None
    taken = []
    end = root
    nxt = graph.single_consumer(end)
    if nxt is not None and nxt.type == "Add":
        other = graph.src(nxt, 1 - end.consumers[0][1])
        if other.type == "Const":
            bias, end = other, nxt
            taken.append(nxt)
            nxt = graph.single_consumer(end)
    if nxt is not None and nxt.type in ("ReLU", "Clamp") and end.consumers[0][1] == 0:
        act = nxt
        taken.append(nxt)
    return bias, taken, act


def activation(layer: Optional[Layer], y: torch.Tensor) -> torch.Tensor:
    if layer is None:
        return y
    if layer.type == "ReLU":
        return torch.relu(y)
    return torch.clamp(y, float(layer.attrs["min"]), float(layer.attrs["max"]))


def channel_axes(layer: Layer, ndim: int) -> Tuple[int, ...]:
    """The weight axes that index output channels (per-channel scales)."""
    if layer.type == "Convolution":
        return (0,)
    if layer.type == "GroupConvolution":
        return (0, 1)
    tb = layer.attrs.get("transpose_b", "false") == "true"
    return (ndim - 2,) if tb else (ndim - 1,)


def quantize_weight(layer: Layer, w: torch.Tensor, qmax: int = 127):
    """Symmetric per-output-channel codes of a float32 weight and their
    float32 scales (max |w| / qmax, keepdims; 1 where a channel is zero)."""
    axes = channel_axes(layer, w.dim())
    reduce = tuple(a for a in range(w.dim()) if a not in axes)
    absmax = w.abs().amax(dim=reduce, keepdim=True)
    scale = torch.where(absmax > 0, absmax / qmax, torch.ones_like(absmax))
    return torch.clamp(torch.round(w / scale), -qmax, qmax), scale


def _pads(layer: Layer):
    return layer.ints("pads_begin"), layer.ints("pads_end")


def conv(layer: Layer, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The convolution of ``x`` by ``w`` in ``x``'s dtype (float64 on codes
    is exact), explicit pads read as zeros."""
    if layer.attrs.get("auto_pad", "explicit") not in ("explicit", "notset"):
        raise NotImplementedError(f"{layer.name}: auto_pad {layer.attrs['auto_pad']}")
    (pt, pl), (pb, pr) = _pads(layer)
    x = F.pad(x, (pl, pr, pt, pb))
    groups = 1
    if layer.type == "GroupConvolution":
        g, co, ci, kh, kw = w.shape
        w, groups = w.reshape(g * co, ci, kh, kw), g
    return F.conv2d(x, w.to(x.dtype), stride=layer.ints("strides"),
                    dilation=layer.ints("dilations"), groups=groups)


def matmul(layer: Layer, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if layer.attrs.get("transpose_a", "false") == "true":
        a = a.transpose(-1, -2)
    if layer.attrs.get("transpose_b", "false") == "true":
        b = b.transpose(-1, -2)
    return a.matmul(b.to(a.dtype))


def root_float(layer: Layer, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return conv(layer, x, w) if layer.type != "MatMul" else matmul(layer, x, w)


def _pool(layer: Layer, x: torch.Tensor) -> torch.Tensor:
    kernel, strides = layer.ints("kernel"), layer.ints("strides")
    (pt, pl), (pb, pr) = _pads(layer)
    if layer.attrs.get("rounding_type", "floor") != "floor":
        raise NotImplementedError(f"{layer.name}: rounding_type {layer.attrs['rounding_type']}")
    if layer.type == "MaxPool":
        return F.max_pool2d(F.pad(x, (pl, pr, pt, pb), value=float("-inf")), kernel, strides)
    if (pt, pl) != (pb, pr):
        raise NotImplementedError(f"{layer.name}: asymmetric AvgPool pads")
    exclude = layer.attrs.get("exclude-pad", "false") == "true"
    return F.avg_pool2d(x, kernel, strides, padding=(pt, pl), count_include_pad=not exclude)


def _reshape(layer: Layer, x: torch.Tensor) -> torch.Tensor:
    """The declared output shape with the batch of ``x`` in front: the IR
    declares batch 1, and a batch runs natively in N."""
    return x.reshape((x.shape[0],) + tuple(layer.out_shape[1:]))


RootFn = Callable[[Layer, torch.Tensor, torch.Tensor], torch.Tensor]
# op(layer, its inputs, dtype): the output of its first port, or {port: output}.
# A float input comes rounded to dtype; an integer Const comes as None.
OpFn = Callable[[Layer, List[Optional[torch.Tensor]], torch.dtype],
                Union[torch.Tensor, Dict[int, torch.Tensor]]]
Ops = Dict[str, OpFn]


def walk(graph: Graph, consts: Dict[int, torch.Tensor], x: torch.Tensor, *,
         dtype: torch.dtype = torch.float32, root_fn: Optional[RootFn] = None,
         keep: Tuple[str, ...] = (), ops: Optional[Ops] = None) -> Dict[str, torch.Tensor]:
    """One forward of ``graph`` on the batch ``x`` (float32, NCHW, already
    rounded to ``dtype``).  ``root_fn(layer, x, w)`` gives a root's float32
    result before its bias and activation (float by default); it may also
    change ``consts``, which the bias is read from after it returns.
    ``ops`` give the operations of other types, and override the walk's own.
    Returns {Result name: value} and {name: value} of the layers named in
    ``keep`` (a root under the name of its chain's end)."""
    root_fn = root_fn or root_float
    ops = ops or {}
    values: Dict[Tuple[int, int], torch.Tensor] = {}
    out: Dict[str, torch.Tensor] = {}
    skip = set()

    def arg(layer: Layer, index: int) -> Optional[torch.Tensor]:
        src, port = layer.inputs[index]
        if graph.layers[src].type == "Const":
            return round_to(consts[src], dtype) if src in consts else None
        return values[(src, port)]

    for layer in graph:
        if layer.id in skip:
            continue
        t = layer.type
        port = min(layer.out_shapes) if layer.out_shapes else 0
        if t in ops:
            y = ops[t](layer, [arg(layer, i) for i in range(len(layer.inputs))], dtype)
            if isinstance(y, dict):
                values.update({(layer.id, p): v for p, v in y.items()})
                if layer.name in keep:
                    out[layer.name] = y[port]
                continue
        elif t == "Parameter":
            y = x
        elif t == "Const":
            continue
        elif t == "Result":
            out[layer.name] = arg(layer, 0)
            continue
        elif t in ROOTS:
            bias, taken, act = epilogue(graph, layer)
            y = root_fn(layer, arg(layer, 0), consts[layer.inputs[1][0]])
            if bias is not None:
                b = round_to(consts[bias.id], dtype)
                y = y + (b.reshape(1, -1, 1, 1) if y.dim() == 4 else b.reshape(1, -1))
            y = round_to(activation(act, y), dtype)
            if taken:
                end = taken[-1]
                skip.update(lyr.id for lyr in taken)
                values[(end.id, min(end.out_shapes))] = y
                if end.name in keep:
                    out[end.name] = y
                continue
        elif t == "Add":
            y = round_to(arg(layer, 0) + arg(layer, 1), dtype)
        elif t in ("ReLU", "Clamp"):
            y = activation(layer, arg(layer, 0))
        elif t in ("MaxPool", "AvgPool"):
            y = round_to(_pool(layer, arg(layer, 0)), dtype)
        elif t == "Reshape":
            y = _reshape(layer, arg(layer, 0))
        elif t == "SoftMax":
            y = round_to(torch.softmax(arg(layer, 0), dim=int(layer.attrs.get("axis", 1))), dtype)
        else:
            raise NotImplementedError(f"the plain walk has no {t} ({layer.name})")
        values[(layer.id, port)] = y
        if layer.name in keep:
            out[layer.name] = y
    return out


def to_input(frames_u8: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """u8 NCHW frames as the network's float input in ``dtype``."""
    return round_to(frames_u8.float(), dtype)


def calibrate(graph: Graph, consts: Dict[int, torch.Tensor], frames_u8: torch.Tensor,
              qmax: int = 127, ops: Optional[Ops] = None) -> Dict[int, float]:
    """{root id: max |input| / qmax} over ``frames_u8`` (one at a time) of a
    float32 walk: the per-tensor activation scales of INT8-FULL."""
    absmax: Dict[int, float] = {}

    def observe(layer, x, w):
        absmax[layer.id] = max(absmax.get(layer.id, 0.0), float(x.abs().max()))
        return root_float(layer, x, w)

    with no_tf32():
        for i in range(frames_u8.shape[0]):
            walk(graph, consts, to_input(frames_u8[i:i + 1], torch.float32), root_fn=observe,
                 ops=ops)
    return {lid: (m / qmax if m > 0 else 1.0) for lid, m in absmax.items()}


class no_tf32:
    """float32 products in full float32 (TF32 off) inside the block, and the
    process's settings back after it."""

    def __enter__(self):
        self._saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self._saved


def int8_root(act_scales: Dict[int, float], codes: Dict[int, tuple], dtype: torch.dtype,
              qmax: int = 127) -> RootFn:
    """INT8-FULL: the input quantized with its calibrated scale s_x to codes
    in [-qmax, qmax] (round half to even), the exact integer sum of codes
    (float64 holds every partial sum), then sum · (s_w · s_x) in float32,
    with s_w, the per-channel weight scale, rounded to ``dtype`` as the
    configuration keeps its scales."""
    def root(layer, x, _w):
        s_x = act_scales[layer.id]
        xq = torch.clamp(torch.round(x / s_x), -qmax, qmax)
        wq, s_w = codes[layer.id]
        acc = root_float(layer, xq.double(), wq.double()).float()
        s = round_to(s_w.reshape(-1), dtype) * s_x
        return acc * (s.reshape(1, -1, 1, 1) if acc.dim() == 4 else s.reshape(1, -1))
    return root


def numpy_f32(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()
