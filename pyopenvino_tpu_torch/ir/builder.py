"""Programmatic graph builder: IR Models built in Python.

The port's own copy of ``pyopenvino_tpu/ir/builder.py``, with the same
methods and signatures, so that a graph recipe written against either
builder (``models/op_graphs.py``) runs on both.  The builder makes the same
typed Model the parser produces: built graphs serialize through
``ir/writer.py``, re-enter through ``IECore.read_network`` and compile on
every backend.  Each node's declared output shapes come from the port's
own op shape inference (``ops/``), so a built graph passes the same shape
cross-checks as a parsed one; an op type the port does not have yet
(ReadValue, Assign, ROIAlign, Proposal, PriorBox) raises
``get_op``'s "unsupported op type" KeyError before the builder records
anything of the node.

    b = GraphBuilder("mynet")
    x = b.parameter("input", (1, 1, 28, 28))
    w = b.const(conv_weights)                      # (Co, Ci, Kh, Kw)
    y = b.conv2d(x, w, strides=(1, 1), pads=((0, 0), (0, 0)))
    y = b.relu(b.add(y, b.const(bias.reshape(1, -1, 1, 1))))
    b.result(y)
    model = b.build()
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from pyopenvino_tpu_torch.ir.model import Edge, Model, Node, TensorInfo


class Port:
    """A producer handle: (node id, port id) plus inferred metadata."""

    __slots__ = ("nid", "port", "shape", "dtype")

    def __init__(self, nid: int, port: int, shape, dtype):
        self.nid = nid
        self.port = port
        self.shape = tuple(int(d) for d in shape)
        self.dtype = np.dtype(dtype)


class GraphBuilder:
    def __init__(self, name: str = "net"):
        self.name = name
        self._nodes: Dict[int, Node] = {}
        self._edges = []
        self._next_id = 0
        self._next_name: Dict[str, int] = {}

    # -- plumbing ----------------------------------------------------------

    def _fresh(self, op_type: str, name: Optional[str]) -> Tuple[int, str]:
        nid = self._next_id
        self._next_id += 1
        if name is None:
            k = self._next_name.get(op_type, 0)
            self._next_name[op_type] = k + 1
            name = f"{op_type.lower()}_{k}"
        return nid, name

    def _add_node(
        self, op_type: str, inputs: Sequence[Port], attrs: Dict[str, str],
        name: Optional[str] = None, n_outputs: int = 1,
        out_dtype=None,
    ) -> Port:
        from pyopenvino_tpu_torch.ops import get_op

        op = get_op(op_type)  # an unported type raises before anything is recorded
        nid, name = self._fresh(op_type, name)
        in_infos: Dict[int, TensorInfo] = {}
        for i, p in enumerate(inputs):
            in_infos[i] = TensorInfo(shape=p.shape, dtype=p.dtype)
            self._edges.append(Edge(p.nid, p.port, nid, i))
        out_port = len(inputs)
        out_dtype0 = inputs[0].dtype if inputs else np.dtype(np.float32)
        node = Node(
            id=nid, name=name, op_type=op_type,
            attrs={k: str(v) for k, v in attrs.items()},
            inputs=in_infos,
            # placeholders so op shape inference can read node.out_port
            # and, for multi-output ops, the full declared port set
            outputs={out_port + i: TensorInfo(shape=(), dtype=out_dtype0)
                     for i in range(n_outputs)},
        )
        self._nodes[nid] = node

        # run the op's own shape inference to fill the declared output port
        in_shapes = {i: p.shape for i, p in enumerate(inputs)}
        in_values = {
            i: (self._nodes[p.nid].const
                if self._nodes[p.nid].op_type == "Const" else None)
            for i, p in enumerate(inputs)
        }
        res = op.infer_shapes(node, in_shapes, in_values)
        if out_dtype is None:
            out_dtype = inputs[0].dtype if inputs else np.float32
        out_dtype = np.dtype(out_dtype)
        ports = {
            k: TensorInfo(shape=tuple(int(d) for d in shape),
                          dtype=out_dtype)
            for k, shape in res.shapes.items()
        }
        node.outputs = ports
        out = [Port(nid, k, ports[k].shape, out_dtype)
               for k in sorted(ports)]
        return out[0] if len(out) == 1 else out

    # -- graph sources/sinks ----------------------------------------------

    def parameter(self, name: str, shape, dtype=np.float32) -> Port:
        from pyopenvino_tpu_torch.ir.writer import _DTYPE_TO_ELEMENT_TYPE

        nid, _ = self._fresh("Parameter", name)
        info = TensorInfo(shape=tuple(shape), dtype=np.dtype(dtype))
        self._nodes[nid] = Node(
            id=nid, name=name, op_type="Parameter",
            attrs={"element_type": _DTYPE_TO_ELEMENT_TYPE[np.dtype(dtype)],
                   "shape": ",".join(str(int(d)) for d in shape)},
            inputs={}, outputs={0: info},
        )
        return Port(nid, 0, shape, dtype)

    def const(self, value: np.ndarray, name: Optional[str] = None) -> Port:
        value = np.asarray(value)
        nid, name = self._fresh("Const", name)
        info = TensorInfo(shape=value.shape, dtype=value.dtype)
        self._nodes[nid] = Node(
            id=nid, name=name, op_type="Const", attrs={},
            inputs={}, outputs={0: info}, const=value,
        )
        return Port(nid, 0, value.shape, value.dtype)

    def result(self, src: Port, name: Optional[str] = None) -> None:
        nid, name = self._fresh("Result", name)
        self._nodes[nid] = Node(
            id=nid, name=name, op_type="Result", attrs={},
            inputs={0: TensorInfo(shape=src.shape, dtype=src.dtype)},
            outputs={},
        )
        self._edges.append(Edge(src.nid, src.port, nid, 0))

    # -- variable state (ReadValue/Assign: not in the port yet) --------------

    def read_value(self, init: Port, variable_id: str,
                   name: Optional[str] = None) -> Port:
        """Read variable ``variable_id``; before the first assign (or after
        reset_state) its value is ``init``."""
        return self._add_node(
            "ReadValue", [init], {"variable_id": variable_id}, name
        )

    def assign(self, src: Port, variable_id: str,
               name: Optional[str] = None) -> None:
        """Write ``src`` into variable ``variable_id`` (a graph sink;
        visible to read_value on the NEXT inference)."""
        self._add_node(
            "Assign", [src], {"variable_id": variable_id}, name
        )

    # -- recurrent ops (ops/recurrent.py — opset gate orders fico/zrh) ------

    def lstm_cell(self, x, h, c, w, r, bias, hidden_size, name=None,
                  **attrs):
        """Returns (Ho, Co).  w:[4H,I] r:[4H,H] bias:[4H], gates fico."""
        return self._add_node(
            "LSTMCell", [x, h, c, w, r, bias],
            {"hidden_size": hidden_size, **attrs}, name, n_outputs=2,
        )

    def gru_cell(self, x, h, w, r, bias, hidden_size, name=None, **attrs):
        """w:[3H,I] r:[3H,H] bias:[3H] (or [4H] with
        linear_before_reset=1), gates zrh."""
        return self._add_node(
            "GRUCell", [x, h, w, r, bias],
            {"hidden_size": hidden_size, **attrs}, name,
        )

    def rnn_cell(self, x, h, w, r, bias, hidden_size, name=None, **attrs):
        return self._add_node(
            "RNNCell", [x, h, w, r, bias],
            {"hidden_size": hidden_size, **attrs}, name,
        )

    def lstm_sequence(self, x, h, c, seq_lens, w, r, bias, hidden_size,
                      direction="forward", name=None, **attrs):
        """Returns (Y [B,D,T,H], Ho, Co).  x:[B,T,I], states:[B,D,H],
        w:[D,4H,I] r:[D,4H,H] bias:[D,4H]."""
        return self._add_node(
            "LSTMSequence", [x, h, c, seq_lens, w, r, bias],
            {"hidden_size": hidden_size, "direction": direction, **attrs},
            name, n_outputs=3,
        )

    def gru_sequence(self, x, h, seq_lens, w, r, bias, hidden_size,
                     direction="forward", name=None, **attrs):
        """Returns (Y [B,D,T,H], Ho)."""
        return self._add_node(
            "GRUSequence", [x, h, seq_lens, w, r, bias],
            {"hidden_size": hidden_size, "direction": direction, **attrs},
            name, n_outputs=2,
        )

    # -- ops ----------------------------------------------------------------

    def conv2d(self, x, w, strides=(1, 1), pads=((0, 0), (0, 0)),
               dilations=(1, 1), name=None) -> Port:
        (pt, pb), (pl, pr) = pads
        return self._add_node("Convolution", [x, w], {
            "strides": f"{strides[0]},{strides[1]}",
            "dilations": f"{dilations[0]},{dilations[1]}",
            "pads_begin": f"{pt},{pl}", "pads_end": f"{pb},{pr}",
            "auto_pad": "explicit",
        }, name)

    def max_pool(self, x, kernel=(2, 2), strides=(2, 2),
                 pads=((0, 0), (0, 0)), rounding="floor", name=None) -> Port:
        (pt, pb), (pl, pr) = pads
        return self._add_node("MaxPool", [x], {
            "kernel": f"{kernel[0]},{kernel[1]}",
            "strides": f"{strides[0]},{strides[1]}",
            "pads_begin": f"{pt},{pl}", "pads_end": f"{pb},{pr}",
            "rounding_type": rounding, "auto_pad": "explicit",
        }, name)

    def avg_pool(self, x, kernel=(2, 2), strides=(2, 2),
                 pads=((0, 0), (0, 0)), name=None) -> Port:
        (pt, pb), (pl, pr) = pads
        return self._add_node("AvgPool", [x], {
            "kernel": f"{kernel[0]},{kernel[1]}",
            "strides": f"{strides[0]},{strides[1]}",
            "pads_begin": f"{pt},{pl}", "pads_end": f"{pb},{pr}",
            "rounding_type": "floor", "exclude-pad": "true",
            "auto_pad": "explicit",
        }, name)

    def add(self, a, b, name=None) -> Port:
        return self._add_node("Add", [a, b], {"auto_broadcast": "numpy"}, name)

    def multiply(self, a, b, name=None) -> Port:
        return self._add_node("Multiply", [a, b],
                              {"auto_broadcast": "numpy"}, name)

    def subtract(self, a, b, name=None) -> Port:
        return self._add_node("Subtract", [a, b],
                              {"auto_broadcast": "numpy"}, name)

    def divide(self, a, b, name=None) -> Port:
        return self._add_node("Divide", [a, b],
                              {"auto_broadcast": "numpy"}, name)

    def maximum(self, a, b, name=None) -> Port:
        return self._add_node("Maximum", [a, b],
                              {"auto_broadcast": "numpy"}, name)

    def minimum(self, a, b, name=None) -> Port:
        return self._add_node("Minimum", [a, b],
                              {"auto_broadcast": "numpy"}, name)

    def power(self, a, b, name=None) -> Port:
        return self._add_node("Power", [a, b],
                              {"auto_broadcast": "numpy"}, name)

    def sqrt(self, x, name=None) -> Port:
        return self._add_node("Sqrt", [x], {}, name)

    def exp(self, x, name=None) -> Port:
        return self._add_node("Exp", [x], {}, name)

    def tanh(self, x, name=None) -> Port:
        return self._add_node("Tanh", [x], {}, name)

    def convert(self, x, destination_type, name=None) -> Port:
        """Element-wise cast (opset1 Convert).  ``destination_type`` is an
        IR element-type string ("f32", "u8", ...) or a numpy dtype."""
        from pyopenvino_tpu_torch.ir.model import ELEMENT_TYPE_TO_DTYPE
        from pyopenvino_tpu_torch.ir.writer import _DTYPE_TO_ELEMENT_TYPE

        if not isinstance(destination_type, str):
            destination_type = _DTYPE_TO_ELEMENT_TYPE[
                np.dtype(destination_type)]
        return self._add_node(
            "Convert", [x], {"destination_type": destination_type}, name,
            out_dtype=ELEMENT_TYPE_TO_DTYPE[destination_type])

    def squeeze(self, x, axes=None, name=None) -> Port:
        ins = [x]
        if axes is not None:
            ins.append(self.const(np.asarray(axes, np.int64)))
        return self._add_node("Squeeze", ins, {}, name)

    def unsqueeze(self, x, axes, name=None) -> Port:
        ax = self.const(np.asarray(axes, np.int64))
        return self._add_node("Unsqueeze", [x, ax], {}, name)

    def proposal(self, probs, deltas, im_info, base_size, feat_stride,
                 ratio, scale, pre_nms_topn=6000, post_nms_topn=300,
                 nms_thresh=0.7, min_size=16, framework="", name=None):
        """opset4 Proposal → [rois (N*post, 5), scores (N*post,)] (not in
        the port yet)."""
        attrs = {
            "base_size": str(int(base_size)),
            "feat_stride": str(int(feat_stride)),
            "ratio": ",".join(str(float(r)) for r in ratio),
            "scale": ",".join(str(float(s)) for s in scale),
            "pre_nms_topn": str(int(pre_nms_topn)),
            "post_nms_topn": str(int(post_nms_topn)),
            "nms_thresh": str(float(nms_thresh)),
            "min_size": str(int(min_size)),
        }
        if framework:
            attrs["framework"] = framework
        idx, sc = self._add_node("Proposal", [probs, deltas, im_info],
                                 attrs, name, n_outputs=2)
        return [idx, sc]

    def roi_align(self, data, rois, batch_indices, pooled_h, pooled_w,
                  sampling_ratio=2, spatial_scale=1.0, mode="avg",
                  name=None) -> Port:
        """opset3 ROIAlign (not in the port yet)."""
        return self._add_node("ROIAlign", [data, rois, batch_indices], {
            "pooled_h": str(int(pooled_h)),
            "pooled_w": str(int(pooled_w)),
            "sampling_ratio": str(int(sampling_ratio)),
            "spatial_scale": str(float(spatial_scale)),
            "mode": mode,
        }, name)

    def prior_box(self, grid_hw, image_hw, min_size, max_size=(),
                  aspect_ratio=(), flip=False, clip=False, step=0.0,
                  offset=0.5, variance=(0.1, 0.1, 0.2, 0.2),
                  scale_all_sizes=True, name=None) -> Port:
        """opset1 PriorBox, the classic SSD300-VGG anchor generator (not in
        the port yet)."""
        g = self.const(np.asarray(grid_hw, np.int64), "pb_grid")
        im = self.const(np.asarray(image_hw, np.int64), "pb_image")
        return self._add_node("PriorBox", [g, im], {
            "min_size": ",".join(str(float(v)) for v in min_size),
            "max_size": ",".join(str(float(v)) for v in max_size),
            "aspect_ratio": ",".join(str(float(v)) for v in aspect_ratio),
            "flip": "1" if flip else "0",
            "clip": "1" if clip else "0",
            "step": str(float(step)),
            "offset": str(float(offset)),
            "variance": ",".join(str(float(v)) for v in variance),
            "scale_all_sizes": "1" if scale_all_sizes else "0",
        }, name, out_dtype=np.float32)

    def prior_box_clustered(self, grid_hw, image_hw, widths, heights,
                            step=0.0, offset=0.5,
                            variance=(0.1, 0.1, 0.2, 0.2),
                            name=None) -> Port:
        """SSD anchor generator (ops/ssd.py prior_boxes_clustered): grid
        and image sizes as I64 consts (the reference derives them from a
        ShapeOf→StridedSlice chain, which constant-folds to the same
        thing — SURVEY.md §3.5)."""
        g = self.const(np.asarray(grid_hw, np.int64), "pbc_grid")
        im = self.const(np.asarray(image_hw, np.int64), "pbc_image")
        return self._add_node("PriorBoxClustered", [g, im], {
            "width": ",".join(str(float(w)) for w in widths),
            "height": ",".join(str(float(h)) for h in heights),
            "step": str(float(step)),
            "offset": str(float(offset)),
            "variance": ",".join(str(float(v)) for v in variance),
        }, name, out_dtype=np.float32)

    def detection_output(self, loc, conf, priors, num_classes,
                         keep_top_k=100, top_k=-1, nms_threshold=0.45,
                         confidence_threshold=0.01,
                         code_type="caffe.PriorBoxParameter.CENTER_SIZE",
                         name=None) -> Port:
        """SSD postprocess → (1, 1, keep_top_k, 7) record table."""
        return self._add_node("DetectionOutput", [loc, conf, priors], {
            "num_classes": str(int(num_classes)),
            "background_label_id": "0",
            "top_k": str(int(top_k)),
            "keep_top_k": str(int(keep_top_k)),
            "nms_threshold": str(float(nms_threshold)),
            "confidence_threshold": str(float(confidence_threshold)),
            "code_type": code_type,
            "share_location": "1",
            "variance_encoded_in_target": "0",
            "clip_after_nms": "0",
            "clip_before_nms": "0",
            "decrease_label_id": "0",
            "normalized": "1",
        }, name)

    def region_yolo(self, x, classes, num, anchors, coords=4,
                    do_softmax=True, mask=(), name=None) -> Port:
        """YOLO region head (ops/yolo.py); anchors in grid units, carried
        as an attribute for the host-side decoder."""
        attrs = {
            "coords": str(int(coords)), "classes": str(int(classes)),
            "num": str(int(num)),
            "do_softmax": "1" if do_softmax else "0",
            "axis": "1", "end_axis": "3",
            "anchors": ",".join(str(float(a)) for a in anchors),
        }
        if mask:
            attrs["mask"] = ",".join(str(int(m)) for m in mask)
        return self._add_node("RegionYolo", [x], attrs, name)

    def top_k(self, x, k, axis=-1, mode="max", sort="value", name=None):
        kc = self.const(np.asarray(k, np.int64))
        vals, idx = self._add_node("TopK", [x, kc], {
            "axis": str(int(axis)), "mode": mode, "sort": sort,
            "index_element_type": "i32",
        }, name, n_outputs=2)
        # indices port is i32 regardless of the data dtype
        node = self._nodes[idx.nid]
        info = node.outputs[idx.port]
        node.outputs[idx.port] = TensorInfo(
            shape=info.shape, dtype=np.dtype(np.int32))
        return [vals, Port(idx.nid, idx.port, idx.shape, np.dtype(np.int32))]

    def compare(self, op_type, a, b, name=None) -> Port:
        """Equal / NotEqual / Greater / GreaterEqual / Less / LessEqual /
        LogicalAnd / LogicalOr / LogicalXor — bool output."""
        return self._add_node(op_type, [a, b],
                              {"auto_broadcast": "numpy"}, name,
                              out_dtype=np.bool_)

    def logical_not(self, x, name=None) -> Port:
        return self._add_node("LogicalNot", [x], {}, name,
                              out_dtype=np.bool_)

    def select(self, cond, a, b, name=None) -> Port:
        return self._add_node("Select", [cond, a, b],
                              {"auto_broadcast": "numpy"}, name,
                              out_dtype=a.dtype)

    def non_max_suppression(self, boxes, scores, max_boxes=0,
                            iou_threshold=0.5, score_threshold=0.0,
                            box_encoding="corner",
                            sort_result_descending=True,
                            soft_nms_sigma=0.0, name=None):
        """opset9 NonMaxSuppression → [selected_indices, selected_scores,
        valid_outputs] (ops/nms.py; padded static shapes).  A nonzero
        ``soft_nms_sigma`` selects Soft-NMS Gaussian decay."""
        ins = [boxes, scores,
               self.const(np.asarray(max_boxes, np.int64)),
               self.const(np.asarray(iou_threshold, np.float32)),
               self.const(np.asarray(score_threshold, np.float32))]
        if soft_nms_sigma:
            ins.append(self.const(np.asarray(soft_nms_sigma, np.float32)))
        idx, sel, valid = self._add_node("NonMaxSuppression", ins, {
            "box_encoding": box_encoding,
            "sort_result_descending":
                "1" if sort_result_descending else "0",
            "output_type": "i32",
        }, name, n_outputs=3)
        node = self._nodes[idx.nid]
        out = []
        for port, dt in ((idx, np.int32), (sel, np.float32),
                         (valid, np.int32)):
            info = node.outputs[port.port]
            node.outputs[port.port] = TensorInfo(
                shape=info.shape, dtype=np.dtype(dt))
            out.append(Port(port.nid, port.port, port.shape, np.dtype(dt)))
        return out

    def range_(self, start, stop, step, output_type="f32",
               name=None) -> Port:
        from pyopenvino_tpu_torch.ir.model import ELEMENT_TYPE_TO_DTYPE

        dt = np.dtype(ELEMENT_TYPE_TO_DTYPE[output_type])
        return self._add_node("Range", [
            self.const(np.asarray(start, dt)),
            self.const(np.asarray(stop, dt)),
            self.const(np.asarray(step, dt)),
        ], {"output_type": output_type}, name, out_dtype=dt)

    def space_to_batch(self, x, block, pads_begin, pads_end,
                       name=None) -> Port:
        return self._add_node("SpaceToBatch", [
            x, self.const(np.asarray(block, np.int64)),
            self.const(np.asarray(pads_begin, np.int64)),
            self.const(np.asarray(pads_end, np.int64)),
        ], {}, name)

    def batch_to_space(self, x, block, crops_begin, crops_end,
                       name=None) -> Port:
        return self._add_node("BatchToSpace", [
            x, self.const(np.asarray(block, np.int64)),
            self.const(np.asarray(crops_begin, np.int64)),
            self.const(np.asarray(crops_end, np.int64)),
        ], {}, name)

    def gather_elements(self, data, indices, axis=0, name=None) -> Port:
        return self._add_node("GatherElements", [data, indices],
                              {"axis": str(int(axis))}, name,
                              out_dtype=data.dtype)

    def scatter_nd_update(self, data, indices, updates, name=None) -> Port:
        return self._add_node("ScatterNDUpdate", [data, indices, updates],
                              {}, name, out_dtype=data.dtype)

    def gather_nd(self, data, indices, batch_dims=0, name=None) -> Port:
        return self._add_node("GatherND", [data, indices],
                              {"batch_dims": str(int(batch_dims))}, name,
                              out_dtype=data.dtype)

    def gather(self, x, indices, axis=0, name=None) -> Port:
        idx = (indices if isinstance(indices, Port)
               else self.const(np.asarray(indices, np.int64)))
        ax = self.const(np.asarray(axis, np.int64))
        return self._add_node("Gather", [x, idx, ax], {}, name,
                              out_dtype=x.dtype)

    def pad(self, x, pads_begin, pads_end, mode="constant", value=None,
            name=None) -> Port:
        ins = [x, self.const(np.asarray(pads_begin, np.int64)),
               self.const(np.asarray(pads_end, np.int64))]
        if value is not None:
            ins.append(self.const(np.asarray(value, np.float32)))
        return self._add_node("Pad", ins, {"pad_mode": mode}, name)

    def interpolate(self, x, sizes, axes=(2, 3), mode="nearest",
                    align_corners=False, name=None) -> Port:
        t = self.const(np.asarray(sizes, np.int64))
        return self._add_node("Interpolate", [x, t], {
            "axes": ",".join(str(a) for a in axes), "mode": mode,
            "align_corners": "1" if align_corners else "0",
        }, name)

    def reduce(self, kind, x, axes, keep_dims=True, name=None) -> Port:
        """kind ∈ {mean, max, sum} → Reduce{Mean,Max,Sum}."""
        a = self.const(np.asarray(axes, np.int64))
        return self._add_node(f"Reduce{kind.capitalize()}", [x, a], {
            "keep_dims": "true" if keep_dims else "false",
        }, name)

    def split(self, x, axis=1, num_splits=2, name=None):
        """Returns a list of num_splits Ports (equal parts along axis)."""
        ax = self.const(np.asarray(axis, np.int64))
        out = self._add_node("Split", [x, ax], {"num_splits": num_splits},
                             name, n_outputs=num_splits)
        return out if isinstance(out, list) else [out]

    def variadic_split(self, x, axis, lengths, name=None):
        """opset1 VariadicSplit: parts of the given lengths along axis
        (one length may be -1)."""
        ax = self.const(np.asarray(axis, np.int64))
        ln = self.const(np.asarray(lengths, np.int64))
        out = self._add_node("VariadicSplit", [x, ax, ln], {}, name,
                             n_outputs=len(lengths))
        return out if isinstance(out, list) else [out]

    def reorg_yolo(self, x, stride=2, name=None) -> Port:
        """opset2 ReorgYolo (ops/yolo.py) — the yolo-v2 passthrough."""
        return self._add_node("ReorgYolo", [x], {"stride": str(int(stride))},
                              name)

    def elu(self, x, alpha=1.0, name=None) -> Port:
        return self._add_node("Elu", [x], {"alpha": alpha}, name)

    def gelu(self, x, mode="erf", name=None) -> Port:
        return self._add_node("Gelu", [x],
                              {"approximation_mode": mode}, name)

    def softplus(self, x, name=None) -> Port:
        return self._add_node("SoftPlus", [x], {}, name)

    def swish(self, x, beta=1.0, name=None) -> Port:
        return self._add_node("Swish", [x], {"beta": beta}, name)

    def hswish(self, x, name=None) -> Port:
        return self._add_node("HSwish", [x], {}, name)

    def hsigmoid(self, x, name=None) -> Port:
        return self._add_node("HSigmoid", [x], {}, name)

    def mish(self, x, name=None) -> Port:
        return self._add_node("Mish", [x], {}, name)

    def prelu(self, x, slope, name=None) -> Port:
        return self._add_node("PReLU", [x, self.const(
            np.asarray(slope, np.float32))], {}, name)

    def unary(self, op_type, x, name=None) -> Port:
        """Attr-free unary op by type name (Erf/Log/Abs/Negative/
        Floor/Ceiling/...)."""
        return self._add_node(op_type, [x], {}, name)

    def tile(self, x, repeats, name=None) -> Port:
        r = self.const(np.asarray(repeats, np.int64))
        return self._add_node("Tile", [x, r], {}, name)

    def normalize_l2(self, x, axes, eps=1e-10, eps_mode="add",
                     name=None) -> Port:
        a = self.const(np.asarray(axes, np.int64))
        return self._add_node("NormalizeL2", [x, a], {
            "eps": eps, "eps_mode": eps_mode,
        }, name)

    def fake_quantize(self, x, input_low, input_high, output_low,
                      output_high, levels=256, name=None) -> Port:
        ins = [x] + [self.const(np.asarray(v, np.float32))
                     for v in (input_low, input_high, output_low,
                               output_high)]
        return self._add_node("FakeQuantize", ins, {"levels": levels}, name)

    def depth_to_space(self, x, block_size, mode="blocks_first",
                       name=None) -> Port:
        return self._add_node("DepthToSpace", [x], {
            "block_size": block_size, "mode": mode}, name)

    def space_to_depth(self, x, block_size, mode="blocks_first",
                       name=None) -> Port:
        return self._add_node("SpaceToDepth", [x], {
            "block_size": block_size, "mode": mode}, name)

    def mvn(self, x, across_channels=False, normalize_variance=True,
            eps=1e-9, name=None) -> Port:
        return self._add_node("MVN", [x], {
            "across_channels": "1" if across_channels else "0",
            "normalize_variance": "1" if normalize_variance else "0",
            "eps": eps,
        }, name)

    def relu(self, x, name=None) -> Port:
        return self._add_node("ReLU", [x], {}, name)

    def clamp(self, x, lo, hi, name=None) -> Port:
        return self._add_node("Clamp", [x], {"min": lo, "max": hi}, name)

    def sigmoid(self, x, name=None) -> Port:
        return self._add_node("Sigmoid", [x], {}, name)

    def softmax(self, x, axis=1, name=None) -> Port:
        return self._add_node("SoftMax", [x], {"axis": axis}, name)

    def matmul(self, a, b, transpose_a=False, transpose_b=False,
               name=None) -> Port:
        return self._add_node("MatMul", [a, b], {
            "transpose_a": str(transpose_a).lower(),
            "transpose_b": str(transpose_b).lower(),
        }, name)

    def reshape(self, x, target, name=None) -> Port:
        t = self.const(np.asarray(target, np.int64))
        return self._add_node("Reshape", [x, t],
                              {"special_zero": "true"}, name)

    def concat(self, xs, axis=1, name=None) -> Port:
        return self._add_node("Concat", list(xs), {"axis": axis}, name)

    def transpose(self, x, perm, name=None) -> Port:
        p = self.const(np.asarray(perm, np.int64))
        return self._add_node("Transpose", [x, p], {}, name)

    def group_conv2d(self, x, w, strides=(1, 1), pads=((0, 0), (0, 0)),
                     dilations=(1, 1), name=None) -> Port:
        """w: (G, Co_per_group, Ci_per_group, Kh, Kw) — depthwise when
        Co_per_group == Ci_per_group == 1."""
        (pt, pb), (pl, pr) = pads
        return self._add_node("GroupConvolution", [x, w], {
            "strides": f"{strides[0]},{strides[1]}",
            "dilations": f"{dilations[0]},{dilations[1]}",
            "pads_begin": f"{pt},{pl}", "pads_end": f"{pb},{pr}",
            "auto_pad": "explicit",
        }, name)

    def conv_transpose2d(self, x, w, strides=(1, 1), pads=((0, 0), (0, 0)),
                         dilations=(1, 1), output_padding=(0, 0),
                         name=None) -> Port:
        """w: (Ci, Co, Kh, Kw) — transposed relative to conv2d's weight."""
        (pt, pb), (pl, pr) = pads
        return self._add_node("ConvolutionBackpropData", [x, w], {
            "strides": f"{strides[0]},{strides[1]}",
            "dilations": f"{dilations[0]},{dilations[1]}",
            "pads_begin": f"{pt},{pl}", "pads_end": f"{pb},{pr}",
            "output_padding": f"{output_padding[0]},{output_padding[1]}",
            "auto_pad": "explicit",
        }, name)

    def lrn(self, x, size=5, alpha=1e-4, beta=0.75, bias=1.0,
            name=None) -> Port:
        axes = self.const(np.asarray([1], np.int64))
        return self._add_node("LRN", [x, axes], {
            "size": size, "alpha": alpha, "beta": beta, "bias": bias,
        }, name)

    # -- control-flow subgraphs (ops/subgraph.py) ---------------------------

    @staticmethod
    def _pm_entry(body: Model, spec, ext_port: int, kind: str):
        """One port-map entry from a friendly spec: a body layer NAME, or
        (name, {axis/start/end/stride/part_size/purpose})."""
        from pyopenvino_tpu_torch.ir.subgraph import PortMapEntry

        opts = {}
        if isinstance(spec, tuple):
            spec, opts = spec
        layer = body.find_by_name(spec)
        if layer is None:
            raise KeyError(f"body has no layer named {spec!r}")
        want = "Parameter" if kind == "input" else "Result"
        if layer.op_type != want:
            raise ValueError(
                f"port-map {kind} {spec!r} is a {layer.op_type}, "
                f"expected {want}")
        return PortMapEntry(external_port_id=ext_port,
                            internal_layer_id=layer.id, **opts)

    def _layer_id(self, body: Model, name: str, want: str) -> int:
        layer = body.find_by_name(name)
        if layer is None or layer.op_type != want:
            raise ValueError(f"body has no {want} named {name!r}")
        return layer.id

    def _add_subgraph_node(self, op_type: str, inputs, subgraphs,
                           name: Optional[str]):
        """Like _add_node but with node.subgraphs populated BEFORE shape
        inference (subgraph ops infer from their bodies) and per-port
        output dtypes taken from the body Result declarations."""
        from pyopenvino_tpu_torch.ops import get_op

        nid, name = self._fresh(op_type, name)
        in_infos = {}
        for i, p in enumerate(inputs):
            in_infos[i] = TensorInfo(shape=p.shape, dtype=p.dtype)
            self._edges.append(Edge(p.nid, p.port, nid, i))
        node = Node(
            id=nid, name=name, op_type=op_type, attrs={},
            inputs=in_infos, outputs={}, subgraphs=subgraphs,
        )
        self._nodes[nid] = node
        in_shapes = {i: p.shape for i, p in enumerate(inputs)}
        in_values = {
            i: (self._nodes[p.nid].const
                if self._nodes[p.nid].op_type == "Const" else None)
            for i, p in enumerate(inputs)
        }
        res = get_op(op_type).infer_shapes(node, in_shapes, in_values)
        # output dtype per port from the mapped body Result declaration
        dtypes = {}
        for sg in subgraphs.values():
            for e in sg.outputs:
                if e.external_port_id >= 0:
                    r = sg.model.nodes[e.internal_layer_id]
                    dtypes[e.external_port_id] = r.inputs[0].dtype
        node.outputs = {
            port: TensorInfo(shape=tuple(int(d) for d in shape),
                             dtype=dtypes.get(port, np.dtype(np.float32)))
            for port, shape in res.shapes.items()
        }
        outs = [Port(nid, port, info.shape, info.dtype)
                for port, info in sorted(node.outputs.items())]
        return outs[0] if len(outs) == 1 else outs

    def tensor_iterator(self, inputs: Sequence[Port], body: Model,
                        input_map, output_map, back_edges=(),
                        name: Optional[str] = None):
        """opset1 TensorIterator.  ``input_map`` aligns with ``inputs``:
        each element is a body Parameter name, or (name, {"axis": ...})
        for sliced entries.  ``output_map`` lists body Result names (or
        (name, {...})) — one outer output port each, numbered after the
        inputs.  ``back_edges`` is [(result_name, param_name), ...]."""
        from pyopenvino_tpu_torch.ir.subgraph import SubGraph

        if len(input_map) != len(inputs):
            raise ValueError("input_map must align with inputs")
        ins = [self._pm_entry(body, spec, i, "input")
               for i, spec in enumerate(input_map)]
        outs = [self._pm_entry(body, spec, len(inputs) + k, "output")
                for k, spec in enumerate(output_map)]
        back = [(self._layer_id(body, r, "Result"),
                 self._layer_id(body, p, "Parameter"))
                for r, p in back_edges]
        sg = SubGraph(model=body, inputs=ins, outputs=outs, back_edges=back)
        sg.validate(f"TensorIterator {name or '?'}")
        return self._add_subgraph_node(
            "TensorIterator", inputs, {"body": sg}, name)

    def loop(self, trip_count: Port, condition: Port,
             inputs: Sequence[Port], body: Model, input_map, output_map,
             back_edges=(), current_iteration: Optional[str] = None,
             condition_result: str = "cond",
             name: Optional[str] = None):
        """opset5 Loop.  ``input_map`` aligns with ``inputs`` (node ports
        2..); ``condition_result`` names the body Result carrying the
        continue-condition; ``current_iteration`` optionally names a body
        Parameter receiving the iteration index."""
        from pyopenvino_tpu_torch.ir.subgraph import PortMapEntry, SubGraph

        if len(input_map) != len(inputs):
            raise ValueError("input_map must align with inputs")
        all_inputs = [trip_count, condition] + list(inputs)
        ins = [self._pm_entry(body, spec, 2 + i, "input")
               for i, spec in enumerate(input_map)]
        if current_iteration is not None:
            ins.append(PortMapEntry(
                external_port_id=-1,
                internal_layer_id=self._layer_id(
                    body, current_iteration, "Parameter"),
                purpose="current_iteration"))
        outs = [self._pm_entry(body, spec, len(all_inputs) + k, "output")
                for k, spec in enumerate(output_map)]
        outs.append(PortMapEntry(
            external_port_id=-1,
            internal_layer_id=self._layer_id(
                body, condition_result, "Result"),
            purpose="execution_condition"))
        back = [(self._layer_id(body, r, "Result"),
                 self._layer_id(body, p, "Parameter"))
                for r, p in back_edges]
        sg = SubGraph(model=body, inputs=ins, outputs=outs, back_edges=back)
        sg.validate(f"Loop {name or '?'}")
        return self._add_subgraph_node(
            "Loop", all_inputs, {"body": sg}, name)

    def if_op(self, condition: Port, inputs: Sequence[Port],
              then_body: Model, else_body: Model,
              then_input_map, else_input_map,
              then_output_map, else_output_map,
              name: Optional[str] = None):
        """opset8 If.  Input maps align with ``inputs`` (node ports 1..);
        output maps align with each other — entry k of both feeds outer
        output port len(inputs)+1+k."""
        from pyopenvino_tpu_torch.ir.subgraph import SubGraph

        subs = {}
        n_in = 1 + len(inputs)
        for bname, body, imap, omap in (
                ("then_body", then_body, then_input_map, then_output_map),
                ("else_body", else_body, else_input_map, else_output_map)):
            if len(imap) != len(inputs):
                raise ValueError(f"{bname}: input map must align with inputs")
            ins = [self._pm_entry(body, spec, 1 + i, "input")
                   for i, spec in enumerate(imap)]
            outs = [self._pm_entry(body, spec, n_in + k, "output")
                    for k, spec in enumerate(omap)]
            sg = SubGraph(model=body, inputs=ins, outputs=outs)
            sg.validate(f"If {name or '?'} {bname}")
            subs[bname] = sg
        return self._add_subgraph_node(
            "If", [condition] + list(inputs), subs, name)

    # -- finalize ------------------------------------------------------------

    def build(self) -> Model:
        return Model(self.name, self._nodes, self._edges)
