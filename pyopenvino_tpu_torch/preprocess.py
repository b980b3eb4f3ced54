"""PrePostProcessor: OpenVINO 2.0-style preprocessing baked into the graph.

Counterpart of ``pyopenvino_tpu/preprocess.py``, the port's own copy of it.
Every declared step is inserted into the typed graph as ordinary ops
(Convert / Gather / Transpose / Interpolate / Subtract / Divide), so it

  * runs on the card inside the compiled network, where the first conv
    reads its result (a u8 image crosses to the device at 1 byte a pixel
    and is cast there, ``runtime/compiler.py``), with no host
    preprocessing pass,
  * works on every backend including the numpy interpreter, and
  * serializes through ir/writer.py like any other graph.

Supported surface (the subset real CNN pipelines use):

    ppp = PrePostProcessor(net)                      # Model or IENetwork
    ppp.input().tensor()                             # what callers will feed
        .set_element_type("u8")
        .set_layout("NHWC")
        .set_spatial_static_shape(480, 640)
        .set_color_format("BGR")
    ppp.input().preprocess()                         # steps, in call order
        .convert_element_type("f32")
        .convert_color("RGB")
        .resize("linear")                            # → model spatial dims
        .convert_layout()                            # → model layout
        .mean([123.675, 116.28, 103.53])
        .scale([58.395, 57.12, 57.375])
    ppp.output().postprocess().convert_element_type("f16")
    net2 = ppp.build()                               # same type as input

Missing steps are completed implicitly like real OpenVINO: an integer
tensor is converted to float before any arithmetic/linear-resize step, the
layout is converted to the model layout at the end if no explicit
convert_layout ran, and a trailing Convert restores the model's declared
input dtype.  A spatial mismatch without an explicit resize() raises —
silent resampling is never implied.  The graph built is the JAX package's,
node for node.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from pyopenvino_tpu_torch.ir.model import (
    ELEMENT_TYPE_TO_DTYPE, Edge, Model, Node, TensorInfo,
)

_LAYOUTS = ("NCHW", "NHWC")


def _as_dtype(element_type) -> np.dtype:
    """'u8' / np dtype / np type → np.dtype, with the IR's vocabulary."""
    if isinstance(element_type, str):
        if element_type not in ELEMENT_TYPE_TO_DTYPE:
            raise ValueError(
                f"unknown element type {element_type!r}; "
                f"known: {sorted(ELEMENT_TYPE_TO_DTYPE)}")
        return np.dtype(ELEMENT_TYPE_TO_DTYPE[element_type])
    return np.dtype(element_type)


def _element_name(dtype: np.dtype) -> str:
    from pyopenvino_tpu_torch.ir.writer import _DTYPE_TO_ELEMENT_TYPE

    return _DTYPE_TO_ELEMENT_TYPE[np.dtype(dtype)]


def _check_layout(layout: str) -> str:
    layout = str(layout).upper()
    if layout not in _LAYOUTS:
        raise ValueError(f"unsupported layout {layout!r}; use NCHW or NHWC")
    return layout


class _TensorSpec:
    """What the caller will actually feed (the tensor side)."""

    def __init__(self):
        self.element_type: Optional[np.dtype] = None
        self.layout: Optional[str] = None
        self.spatial: Optional[Tuple[int, int]] = None
        self.color_format: Optional[str] = None

    def set_element_type(self, element_type) -> "_TensorSpec":
        self.element_type = _as_dtype(element_type)
        return self

    def set_layout(self, layout: str) -> "_TensorSpec":
        self.layout = _check_layout(layout)
        return self

    def set_spatial_static_shape(self, height: int, width: int) -> "_TensorSpec":
        self.spatial = (int(height), int(width))
        return self

    def set_color_format(self, fmt: str) -> "_TensorSpec":
        fmt = str(fmt).upper()
        if fmt not in ("BGR", "RGB"):
            raise ValueError(f"unsupported color format {fmt!r}")
        self.color_format = fmt
        return self


class _ModelSpec:
    """The model side: how the graph's Parameter is laid out."""

    def __init__(self):
        self.layout: Optional[str] = None

    def set_layout(self, layout: str) -> "_ModelSpec":
        self.layout = _check_layout(layout)
        return self


class _Steps:
    """Ordered preprocessing steps (applied in call order, like OpenVINO)."""

    def __init__(self):
        self.steps: List[Tuple[str, object]] = []

    def convert_element_type(self, element_type="f32") -> "_Steps":
        self.steps.append(("convert", _as_dtype(element_type)))
        return self

    def convert_color(self, fmt: str) -> "_Steps":
        fmt = str(fmt).upper()
        if fmt not in ("BGR", "RGB"):
            raise ValueError(f"unsupported color format {fmt!r}")
        self.steps.append(("color", fmt))
        return self

    def convert_layout(self, layout: Optional[str] = None) -> "_Steps":
        self.steps.append(
            ("layout", _check_layout(layout) if layout else None))
        return self

    def resize(self, mode: str = "linear") -> "_Steps":
        if mode not in ("linear", "nearest"):
            raise ValueError(f"unsupported resize mode {mode!r}")
        self.steps.append(("resize", mode))
        return self

    def mean(self, values) -> "_Steps":
        self.steps.append(("mean", np.asarray(values, np.float32)))
        return self

    def scale(self, values) -> "_Steps":
        """Divide by ``values`` (OpenVINO semantics: x = (x - mean)/scale)."""
        self.steps.append(("scale", np.asarray(values, np.float32)))
        return self


class _InputInfo:
    def __init__(self):
        self._tensor = _TensorSpec()
        self._steps = _Steps()
        self._model = _ModelSpec()

    def tensor(self) -> _TensorSpec:
        return self._tensor

    def preprocess(self) -> _Steps:
        return self._steps

    def model(self) -> _ModelSpec:
        return self._model


class _PostSteps:
    def __init__(self):
        self.element_type: Optional[np.dtype] = None

    def convert_element_type(self, element_type) -> "_PostSteps":
        self.element_type = _as_dtype(element_type)
        return self


class _OutputInfo:
    def __init__(self):
        self._post = _PostSteps()

    def postprocess(self) -> _PostSteps:
        return self._post


class _Graph:
    """Mutable (nodes, edges) workspace with fresh-id node construction."""

    def __init__(self, model: Model):
        self.nodes: Dict[int, Node] = dict(model.nodes)
        self.edges: List[Edge] = list(model.edges)
        self._next = max(self.nodes) + 1

    def const(self, value: np.ndarray, name: str) -> Tuple[int, int]:
        value = np.asarray(value)
        nid = self._next
        self._next += 1
        self.nodes[nid] = Node(
            id=nid, name=name, op_type="Const", attrs={},
            inputs={}, outputs={0: TensorInfo(value.shape, value.dtype)},
            const=value,
        )
        return nid, 0

    def op(self, op_type: str, name: str, srcs, attrs: Dict[str, str],
           out_shape, out_dtype) -> Tuple[int, int]:
        """One op node fed by ``srcs`` [(nid, port), ...].  Port shapes are
        placeholders — build() re-derives every dim via rederive_ports —
        but dtypes are authoritative (shape inference never rewrites them)."""
        nid = self._next
        self._next += 1
        ins = {}
        for i, (s, sp) in enumerate(srcs):
            info = self.nodes[s].outputs[sp]
            ins[i] = TensorInfo(info.shape, info.dtype)
            self.edges.append(Edge(s, sp, nid, i))
        out_port = len(srcs)
        self.nodes[nid] = Node(
            id=nid, name=name, op_type=op_type,
            attrs={k: str(v) for k, v in attrs.items()},
            inputs=ins,
            outputs={out_port: TensorInfo(tuple(out_shape),
                                          np.dtype(out_dtype))},
        )
        return nid, out_port

    def rewire_consumers(self, old, new, skip_ids=frozenset()):
        """Every edge reading ``old`` (src, port) now reads ``new``, except
        edges into ``skip_ids`` (the inserted chain itself)."""
        out = []
        for e in self.edges:
            if (e.src, e.src_port) == old and e.dst not in skip_ids:
                out.append(Edge(new[0], new[1], e.dst, e.dst_port))
            else:
                out.append(e)
        self.edges = out


def _dims(shape, layout):
    """(N, C, H, W) logical dims of a 4-D shape in ``layout``."""
    n, a, b, c = shape
    return (n, a, b, c) if layout == "NCHW" else (n, c, a, b)


def _assemble(n, c, h, w, layout):
    return (n, c, h, w) if layout == "NCHW" else (n, h, w, c)


_PERM = {
    ("NCHW", "NHWC"): (0, 2, 3, 1),
    ("NHWC", "NCHW"): (0, 3, 1, 2),
}


class PrePostProcessor:
    """Bake tensor-side preprocessing / postprocessing into the graph.

    Accepts a typed ``Model`` or the facade's ``IENetwork``; ``build()``
    returns the same kind it was given."""

    def __init__(self, model):
        self._ienet = None
        if hasattr(model, "model"):  # IENetwork facade
            self._ienet = model
            model = model.model
        self._model: Model = model
        self._inputs: Dict[str, _InputInfo] = {}
        self._outputs: Dict[str, _OutputInfo] = {}

    # -- declaration --------------------------------------------------------

    def input(self, name: Optional[str] = None) -> _InputInfo:
        params = self._model.parameters
        if name is None:
            if len(params) != 1:
                raise ValueError(
                    f"model has {len(params)} inputs — name one of "
                    f"{[p.name for p in params]}")
            name = params[0].name
        elif not any(p.name == name for p in params):
            raise ValueError(
                f"no Parameter named {name!r}; "
                f"inputs are {[p.name for p in params]}")
        return self._inputs.setdefault(name, _InputInfo())

    def output(self, name: Optional[str] = None) -> _OutputInfo:
        results = self._model.results
        if name is None:
            if len(results) != 1:
                raise ValueError(
                    f"model has {len(results)} outputs — name one of "
                    f"{[r.name for r in results]}")
            name = results[0].name
        elif not any(r.name == name for r in results):
            raise ValueError(
                f"no Result named {name!r}; "
                f"outputs are {[r.name for r in results]}")
        return self._outputs.setdefault(name, _OutputInfo())

    # -- build --------------------------------------------------------------

    def build(self):
        g = _Graph(self._model)
        for name, info in self._inputs.items():
            self._apply_input(g, name, info)
        for name, info in self._outputs.items():
            self._apply_output(g, name, info)

        from pyopenvino_tpu_torch.passes.shape_infer import rederive_ports

        new_model = rederive_ports(
            Model(self._model.name, g.nodes, g.edges))
        if self._ienet is not None:
            self._ienet.__init__(new_model)
            return self._ienet
        return new_model

    def _apply_input(self, g: _Graph, name: str, info: _InputInfo):
        param = next(p for p in self._model.parameters if p.name == name)
        pid = param.id
        declared = param.outputs[param.out_port]
        model_dtype = declared.dtype

        is_4d = len(declared.shape) == 4
        model_layout = info._model.layout or "NCHW"
        if not is_4d:
            for field, what in ((info._tensor.layout, "layout"),
                                (info._tensor.spatial, "spatial shape"),
                                (info._tensor.color_format, "color format")):
                if field is not None:
                    raise ValueError(
                        f"input {name!r} is rank-{len(declared.shape)}: "
                        f"tensor {what} applies to 4-D inputs only")

        if is_4d:
            n, c, mh, mw = _dims(declared.shape, model_layout)
            cur_layout = info._tensor.layout or model_layout
            cur_spatial = info._tensor.spatial or (mh, mw)
            tensor_shape = _assemble(n, c, *cur_spatial, cur_layout)
        else:
            cur_layout = None
            cur_spatial = n = c = mh = mw = None
            tensor_shape = declared.shape
        cur_dtype = np.dtype(info._tensor.element_type or model_dtype)
        cur_color = info._tensor.color_format

        # retype/reshape the Parameter itself to the tensor-side spec
        new_info = TensorInfo(tuple(tensor_shape), cur_dtype, declared.names)
        attrs = dict(param.attrs)
        attrs["element_type"] = _element_name(cur_dtype)
        attrs["shape"] = ",".join(str(int(d)) for d in tensor_shape)
        g.nodes[pid] = dataclasses.replace(
            param, attrs=attrs, outputs={param.out_port: new_info})

        cur = (pid, param.out_port)
        inserted = set()
        k = 0

        def emit(op_type, srcs, attrs, shape, dtype):
            nonlocal cur, k
            nid, port = g.op(op_type, f"{name}/ppp/{op_type.lower()}_{k}",
                             srcs, attrs, shape, dtype)
            inserted.add(nid)
            for s, _ in srcs:
                inserted.add(s)
            cur = (nid, port)
            k += 1

        def cur_shape():
            return (_assemble(n, c, *cur_spatial, cur_layout)
                    if is_4d else tensor_shape)

        def to_float():
            nonlocal cur_dtype
            if not np.issubdtype(cur_dtype, np.floating):
                emit("Convert", [cur], {"destination_type": "f32"},
                     cur_shape(), np.float32)
                cur_dtype = np.dtype(np.float32)

        def chan_vector(values, what):
            """Broadcastable per-channel const for the current layout."""
            values = np.asarray(values, np.float32).reshape(-1)
            if not is_4d:
                if values.size != 1:
                    raise ValueError(
                        f"{what}: per-channel values need a 4-D input")
                return values.reshape(())
            if values.size not in (1, c):
                raise ValueError(
                    f"{what}: {values.size} values for {c} channels")
            shape = [1, 1, 1, 1]
            shape[1 if cur_layout == "NCHW" else 3] = values.size
            return values.reshape(shape)

        for step, arg in info._steps.steps:
            if step == "convert":
                if np.dtype(arg) != cur_dtype:
                    emit("Convert", [cur],
                         {"destination_type": _element_name(arg)},
                         cur_shape(), arg)
                    cur_dtype = np.dtype(arg)
            elif step == "color":
                if cur_color is None:
                    raise ValueError(
                        "convert_color: set_color_format() on the tensor "
                        "side first")
                if arg != cur_color:
                    axis = 1 if cur_layout == "NCHW" else 3
                    if c != 3:
                        raise ValueError(
                            f"convert_color: channel dim is {c}, not 3")
                    idx = g.const(np.array([2, 1, 0], np.int64),
                                  f"{name}/ppp/color_idx")
                    ax = g.const(np.array(axis, np.int64),
                                 f"{name}/ppp/color_axis")
                    emit("Gather", [cur, idx, ax], {}, cur_shape(),
                         cur_dtype)
                    cur_color = arg
            elif step == "layout":
                target = arg or model_layout
                if not is_4d:
                    raise ValueError("convert_layout needs a 4-D input")
                if target != cur_layout:
                    perm = g.const(
                        np.asarray(_PERM[(cur_layout, target)], np.int64),
                        f"{name}/ppp/perm_{k}")
                    cur_layout = target
                    emit("Transpose", [cur, perm], {}, cur_shape(),
                         cur_dtype)
            elif step == "resize":
                if not is_4d:
                    raise ValueError("resize needs a 4-D input")
                if cur_spatial != (mh, mw):
                    if arg == "linear":
                        to_float()
                    axes = (2, 3) if cur_layout == "NCHW" else (1, 2)
                    t = g.const(np.asarray([mh, mw], np.int64),
                                f"{name}/ppp/size_{k}")
                    cur_spatial = (mh, mw)
                    emit("Interpolate", [cur, t], {
                        "axes": ",".join(str(a) for a in axes),
                        "mode": arg, "align_corners": "1",
                    }, cur_shape(), cur_dtype)
            elif step == "mean":
                to_float()
                cv = g.const(chan_vector(arg, "mean"), f"{name}/ppp/mean_{k}")
                emit("Subtract", [cur, cv], {"auto_broadcast": "numpy"},
                     cur_shape(), cur_dtype)
            elif step == "scale":
                to_float()
                cv = g.const(chan_vector(arg, "scale"),
                             f"{name}/ppp/scale_{k}")
                emit("Divide", [cur, cv], {"auto_broadcast": "numpy"},
                     cur_shape(), cur_dtype)
            else:  # pragma: no cover — steps are constructed above
                raise AssertionError(step)

        # implicit completion (OpenVINO inserts the same conversions)
        if is_4d and cur_spatial != (mh, mw):
            raise ValueError(
                f"input {name!r}: tensor spatial {cur_spatial} != model "
                f"{(mh, mw)} and no resize() step was declared")
        if is_4d and cur_layout != model_layout:
            perm = g.const(
                np.asarray(_PERM[(cur_layout, model_layout)], np.int64),
                f"{name}/ppp/perm_final")
            cur_layout = model_layout
            emit("Transpose", [cur, perm], {}, cur_shape(), cur_dtype)
        if cur_dtype != model_dtype:
            emit("Convert", [cur],
                 {"destination_type": _element_name(model_dtype)},
                 cur_shape(), model_dtype)
            cur_dtype = model_dtype

        if cur != (pid, param.out_port):
            g.rewire_consumers((pid, param.out_port), cur, inserted)

    def _apply_output(self, g: _Graph, name: str, info: _OutputInfo):
        dest = info._post.element_type
        if dest is None:
            return
        result = next(r for r in self._model.results if r.name == name)
        src, sport = self._model.in_edges[result.id][0]
        declared = result.inputs[0]
        if np.dtype(dest) == declared.dtype:
            return
        nid, port = g.op(
            "Convert", f"{name}/ppp/convert_out", [(src, sport)],
            {"destination_type": _element_name(dest)},
            declared.shape, dest)
        g.edges = [e for e in g.edges
                   if not (e.dst == result.id and e.dst_port == 0)]
        g.edges.append(Edge(nid, port, result.id, 0))
        g.nodes[result.id] = dataclasses.replace(
            result, inputs={0: TensorInfo(declared.shape, np.dtype(dest),
                                          declared.names)})
