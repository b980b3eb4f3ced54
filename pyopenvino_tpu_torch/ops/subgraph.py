"""Control-flow subgraph ops: TensorIterator (opset1), Loop (opset5) and If
(opset8).

The port's own copy of ``pyopenvino_tpu/ops/subgraph.py``.  A body is a
nested :class:`Model` (ir/subgraph.py) and each op has the usual twins:

  * ``ref_compute``: a Python loop driving the numpy Interpreter over the
    body once per iteration, the JAX package's code;
  * ``emit``: a Python loop over the iterations on device tensors, each
    iteration running the body through the compiler's body walk
    (``ctx.run_body``; runtime/compiler.py ``BodyWalk``), which is built
    once when the network is compiled: its order, its static values and
    the inputs it skips (``STATIC_PORTS``).  Where the JAX package traces
    the body once into one ``lax.scan`` (TensorIterator), ``lax.while_loop``
    (Loop) or ``lax.cond`` (If), the port issues the body's device
    operations once per iteration.

Iteration counts come from static shapes: a TensorIterator's from its
sliced inputs' extents, a Loop's from its constant trip count.  A Loop's
execution condition and an If's predicate live on the device; the port
reads each on the host, once a step (``lax.while_loop`` and ``lax.cond``
keep them on the device), and an If runs only the branch the predicate
picks, as ``lax.cond`` does.

Body Const weights are entries of the compiled network's weight dict under
the JAX package's keys, ``sub.<node id>.<body name>.<const id>`` (the
prefix chaining through nested bodies; runtime/compiler.py
``body_const_weights``), so checkpoints move between the two packages.

Refusals, each with the JAX package's message:
  * ReadValue/Assign inside a body;
  * a port map whose ``part_size`` is not ``|stride|``;
  * a Loop with a dynamic trip count and sliced inputs or concatenated
    outputs (no static shape for them);
  * If branches whose output shapes or dtypes differ;
  * body Parameters neither port-mapped nor fed by a back edge
    (ir/subgraph.py ``SubGraph.validate``);
  * ``purpose`` entries on a TensorIterator.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from pyopenvino_tpu_torch.ops.spec import Op, ShapeResult, TValue, register, torch_dtype


def _sub(node, key: str):
    if not node.subgraphs or key not in node.subgraphs:
        raise ValueError(
            f"{node.op_type} {node.name!r}: missing {key!r} subgraph "
            f"(IR <{key}> element)")
    return node.subgraphs[key]


def body_analysis(sg):
    """The body's shape analysis, cached on the SubGraph instance."""
    if not hasattr(sg, "_shape_analysis"):
        from pyopenvino_tpu_torch.passes.shape_infer import infer_shapes

        _check_body(sg)
        sg._shape_analysis = infer_shapes(sg.model)
    return sg._shape_analysis


def _check_body(sg):
    for n in sg.model.nodes.values():
        if n.op_type in ("ReadValue", "Assign"):
            raise NotImplementedError(
                f"subgraph body contains {n.op_type} {n.name!r}: "
                f"per-iteration variable state inside a loop body has no "
                f"defined opset semantics — hoist the variable out of the "
                f"body")


def _float(dt) -> bool:
    return np.issubdtype(np.dtype(dt), np.floating)


def _result_shape(sg, rid: int) -> Tuple[int, ...]:
    return body_analysis(sg).shape(*sg.result_source(rid))


def _carried_params(sg) -> Dict[int, int]:
    """{body Parameter layer id: body Result layer id} per back edge."""
    return {to: frm for frm, to in sg.back_edges}


def _slice_shape(shape: Tuple[int, ...], axis: int, part: int):
    s = list(shape)
    if axis < 0:
        axis += len(s)
    if not 0 <= axis < len(s):
        raise ValueError(f"port_map axis {axis} out of range for {shape}")
    s[axis] = part
    return tuple(s), axis


def _validate_inputs(node, sg, in_shapes) -> int:
    """Cross-check every port-map input entry against the body Parameter
    shapes and derive the iteration count from the sliced entries (-1 when
    there are none)."""
    body = sg.model
    carried = _carried_params(sg)
    iters = -1
    for e in sg.inputs:
        if e.purpose == "current_iteration":
            continue
        if e.external_port_id not in in_shapes:
            raise ValueError(
                f"{node.op_type} {node.name!r}: port_map references input "
                f"port {e.external_port_id} but the node has no such edge")
        x_shape = in_shapes[e.external_port_id]
        p = body.nodes[e.internal_layer_id]
        p_shape = tuple(p.outputs[p.out_port].shape)
        if e.axis is not None:
            want, axis = _slice_shape(x_shape, e.axis, e.part_size)
            _, count, _ = e.iter_range(x_shape[axis])
            if count <= 0:
                raise ValueError(
                    f"{node.op_type} {node.name!r}: sliced input iterates "
                    f"{count} times")
            if iters not in (-1, count):
                raise ValueError(
                    f"{node.op_type} {node.name!r}: sliced inputs disagree "
                    f"on iteration count ({iters} vs {count})")
            iters = count
            if p_shape != want:
                raise ValueError(
                    f"{node.op_type} {node.name!r}: body Parameter "
                    f"{p.name!r} declares {p_shape}, sliced input provides "
                    f"{want}")
        elif p_shape != tuple(x_shape):
            # an invariant or a back edge's initial value: shapes must match
            raise ValueError(
                f"{node.op_type} {node.name!r}: body Parameter {p.name!r} "
                f"declares {p_shape}, input port {e.external_port_id} "
                f"provides {tuple(x_shape)}")
        if e.axis is None and e.internal_layer_id in carried:
            # the back edge's source Result must give the shape it feeds
            r_shape = _result_shape(sg, carried[e.internal_layer_id])
            if r_shape != p_shape:
                raise ValueError(
                    f"{node.op_type} {node.name!r}: back edge carries "
                    f"{r_shape} into Parameter {p.name!r} of shape "
                    f"{p_shape}")
    return iters


def _output_shapes(node, sg, iters: int) -> Dict[int, Tuple[int, ...]]:
    out = {}
    for e in sg.outputs:
        if e.purpose == "execution_condition":
            continue
        per_iter = _result_shape(sg, e.internal_layer_id)
        if e.axis is None:
            out[e.external_port_id] = per_iter
        else:
            if iters < 0:
                raise ValueError(
                    f"{node.op_type} {node.name!r}: concatenated output "
                    f"needs a static iteration count")
            shape, axis = _slice_shape(per_iter, e.axis, e.part_size)
            if tuple(per_iter) != shape:
                raise ValueError(
                    f"{node.op_type} {node.name!r}: concat output expects "
                    f"the body to produce {e.part_size} elements at axis "
                    f"{axis}, body Result gives {per_iter}")
            full = list(per_iter)
            full[axis] = iters * e.part_size
            out[e.external_port_id] = tuple(full)
    if not out:
        raise ValueError(f"{node.op_type} {node.name!r}: port_map maps no outputs")
    return out


def _classify(sg, inputs_by_port):
    """(sliced [(entry, x)], invariant {pid: x}, initial {pid: x})."""
    carried = _carried_params(sg)
    sliced, invariant, init = [], {}, {}
    for e in sg.inputs:
        if e.purpose:  # current_iteration is fed by the loop itself
            continue
        x = inputs_by_port[e.external_port_id]
        if e.axis is not None:
            sliced.append((e, x))
        elif e.internal_layer_id in carried:
            init[e.internal_layer_id] = x
        else:
            invariant[e.internal_layer_id] = x
    missing = set(carried) - set(init)
    if missing:
        names = [sg.model.nodes[p].name for p in sorted(missing)]
        raise ValueError(
            f"back-edge Parameters with no initial-value port-map entry: {names}")
    return sliced, invariant, init


def _param_info(sg, pid):
    n = sg.model.nodes[pid]
    return n.outputs[n.out_port]


# -- numpy twin ----------------------------------------------------------------


def _np_cast(arr, info):
    return np.asarray(arr).reshape(info.shape).astype(info.dtype)


def _run_body_np(interp, sg, feeds_by_layer: Dict[int, np.ndarray]):
    body = sg.model
    res = interp.run({body.nodes[lid].name: v for lid, v in feeds_by_layer.items()})
    return {r.id: res[r.name] for r in body.results}


def _np_slices(e, x):
    """Per-iteration chunks of x along e.axis, in iteration order."""
    first, count, step = e.iter_range(x.shape[e.axis])
    chunks = []
    for i in range(count):
        lo = first + i * step
        sl = [slice(None)] * x.ndim
        sl[e.axis] = slice(lo, lo + e.part_size)
        chunks.append(x[tuple(sl)])
    return chunks


def _np_concat(e, ys: List[np.ndarray]):
    if e.stride < 0:
        ys = ys[::-1]
    return np.concatenate(ys, axis=e.axis)


def _np_run(sg, sliced, invariant, carry, limit, cond=True, cur_id=None, cond_id=None):
    """Drive the numpy Interpreter over the body while ``it < limit`` and
    ``cond``: {Result layer id: [per-iteration values]}."""
    from pyopenvino_tpu_torch.runtime.interpreter import Interpreter

    chunk_lists = {e.internal_layer_id: _np_slices(e, np.asarray(x)) for e, x in sliced}
    carry = {pid: _np_cast(v, _param_info(sg, pid)) for pid, v in carry.items()}
    interp = Interpreter(sg.model)
    collected = {e.internal_layer_id: [] for e in sg.outputs}
    it = 0
    while it < limit and cond:
        feed = dict(invariant)
        feed.update(carry)
        feed.update({pid: chunks[it] for pid, chunks in chunk_lists.items()})
        if cur_id is not None:
            info = _param_info(sg, cur_id)
            feed[cur_id] = np.full(info.shape or (), it, info.dtype)
        res = _run_body_np(interp, sg, feed)
        if cond_id is not None:
            cond = bool(np.asarray(res[cond_id]).reshape(()))
        carry = {to: res[frm] for frm, to in sg.back_edges}
        for rid in collected:
            collected[rid].append(res[rid])
        it += 1
    return collected


# -- device twin ---------------------------------------------------------------


def _chunked(e, x, axis: int):
    """(iters, per-iteration slice) view of ``x``, iteration-major: the
    chunks of a sliced input, reversed for a negative stride."""
    first, count, step = e.iter_range(x.shape[axis])
    xm = torch.movedim(x, axis, 0)
    lo = min(first, first + (count - 1) * step)
    region = xm[lo:lo + count * e.part_size]
    chunks = region.reshape((count, e.part_size) + tuple(xm.shape[1:]))
    if step < 0:
        chunks = chunks.flip(0)
    # the part axis back at its body position: each chunk has the body
    # Parameter's shape
    return torch.movedim(chunks, 1, axis + 1)


def _merge_concat(e, y, axis: int):
    """Stacked per-iteration results (iterations leading) → one tensor
    joined at ``axis`` in port-map order."""
    if e.stride < 0:
        y = y.flip(0)
    y = torch.movedim(y, 0, axis)  # (..., iters, part, ...)
    shape = list(y.shape)
    return y.reshape(shape[:axis] + [shape[axis] * shape[axis + 1]] + shape[axis + 2:])


def _concat_out(e, y):
    _, axis = _slice_shape(tuple(y.shape[1:]), e.axis, e.part_size)
    return TValue(_merge_concat(e, y, axis))


def _cast_init(ctx, sg, pid, v):
    """A back edge's initial value in the body Parameter's shape, its float
    values in the compute dtype."""
    info = _param_info(sg, pid)
    return v.reshape(info.shape).to(ctx.compute_dtype if _float(info.dtype)
                                    else torch_dtype(info.dtype))


def _device_chunks(sliced):
    out = {}
    for e, x in sliced:
        _, axis = _slice_shape(tuple(x.shape), e.axis, e.part_size)
        out[e.internal_layer_id] = _chunked(e, x, axis)
    return out


def _host_bool(t) -> bool:
    """One read of a device scalar on the host."""
    return bool(t.reshape(()).item())


@register
class TensorIterator(Op):
    """opset1 TensorIterator: the body once per slice of the sliced inputs.

    The sliced inputs are chunked iteration-major (reversed for a negative
    stride); the back edges carry the state, each initial value cast as
    the body Parameter declares it; a concatenated output stacks the
    iterations' results and merges them at its axis; a last-value output
    takes the final iteration's result and is never stacked."""

    type_name = "TensorIterator"

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        sg = _sub(node, "body")
        body_analysis(sg)  # validates the body and refuses state ops
        iters = _validate_inputs(node, sg, in_shapes)
        if iters < 0:
            raise ValueError(
                f"TensorIterator {node.name!r}: no sliced input — the "
                f"iteration count is underivable (use Loop with a trip "
                f"count instead)")
        for e in sg.inputs + sg.outputs:
            if e.purpose:
                raise ValueError(
                    f"TensorIterator {node.name!r}: purpose="
                    f"{e.purpose!r} entries are Loop-only")
        return ShapeResult(_output_shapes(node, sg, iters))

    def ref_compute(self, node, inputs) -> Dict[int, np.ndarray]:
        sg = _sub(node, "body")
        sliced, invariant, carry = _classify(sg, inputs)
        iters = _validate_inputs(node, sg, {p: np.asarray(v).shape for p, v in inputs.items()})
        collected = _np_run(sg, sliced, invariant, carry, iters)
        out = {}
        for e in sg.outputs:
            ys = collected[e.internal_layer_id]
            out[e.external_port_id] = ys[-1] if e.axis is None else _np_concat(e, ys)
        return out

    def emit(self, ctx, node, inputs) -> Dict[int, TValue]:
        sg = _sub(node, "body")
        sliced, invariant, init = _classify(sg, {p: tv.arr for p, tv in inputs.items()})
        xs = _device_chunks(sliced)
        iters = next(iter(xs.values())).shape[0]
        carry = {pid: _cast_init(ctx, sg, pid, v) for pid, v in init.items()}
        stacked = {e.internal_layer_id: [] for e in sg.outputs if e.axis is not None}
        res = {}
        for it in range(iters):
            feeds = dict(invariant)
            feeds.update(carry)
            feeds.update({pid: chunks[it] for pid, chunks in xs.items()})
            res = ctx.run_body(node, "body", feeds)
            carry = {to: res[frm] for frm, to in sg.back_edges}
            for rid, ys in stacked.items():
                ys.append(res[rid])
        return {e.external_port_id: (TValue(res[e.internal_layer_id]) if e.axis is None
                                     else _concat_out(e, torch.stack(stacked[e.internal_layer_id])))
                for e in sg.outputs}


@register
class Loop(Op):
    """opset5 Loop with a static trip-count bound.

    Input 0 is the trip count, input 1 the initial execution condition; the
    body may take a ``current_iteration`` Parameter and must give an
    ``execution_condition`` Result (``purpose`` in the port map).  With
    concatenated outputs the trip count must be a compile-time constant:
    their buffers are allocated at [trip_count, ...] before the first step
    and written a step at a time (slots of steps never run stay zero).  A
    dynamic trip count (or -1, run until the condition) is taken for
    last-value-only Loops.  The condition is read on the host once a step
    (``lax.while_loop`` keeps it on the device)."""

    type_name = "Loop"

    @staticmethod
    def _special(sg):
        cur = [e for e in sg.inputs if e.purpose == "current_iteration"]
        cond = [e for e in sg.outputs if e.purpose == "execution_condition"]
        if len(cond) != 1:
            raise ValueError("Loop body must declare exactly one execution_condition output")
        if len(cur) > 1:
            raise ValueError("Loop body declares multiple current_iteration inputs")
        return (cur[0].internal_layer_id if cur else None, cond[0].internal_layer_id)

    @staticmethod
    def _trip_count(node, in_values):
        tc = in_values.get(0)
        if tc is None:
            return None
        return int(np.asarray(tc).reshape(()))

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        sg = _sub(node, "body")
        body_analysis(sg)
        self._special(sg)
        data_shapes = {p: s for p, s in in_shapes.items() if p >= 2}
        iters = _validate_inputs(node, sg, data_shapes)
        tc = self._trip_count(node, in_values)
        if iters >= 0:
            if tc is None:
                raise ValueError(
                    f"Loop {node.name!r}: sliced inputs need a "
                    f"compile-time-constant trip count")
            if tc != iters:
                raise ValueError(
                    f"Loop {node.name!r}: trip count {tc} != sliced-input "
                    f"iteration count {iters}")
        n = iters if iters >= 0 else (tc if tc is not None and tc >= 0 else -1)
        return ShapeResult(_output_shapes(node, sg, n))

    def ref_compute(self, node, inputs) -> Dict[int, np.ndarray]:
        sg = _sub(node, "body")
        body = sg.model
        cur_id, cond_id = self._special(sg)
        tc = int(np.asarray(inputs[0]).reshape(()))
        cond = bool(np.asarray(inputs[1]).reshape(()))
        sliced, invariant, carry = _classify(sg, {p: v for p, v in inputs.items() if p >= 2})
        collected = _np_run(sg, sliced, invariant, carry, tc if tc >= 0 else (1 << 62),
                            cond, cur_id, cond_id)
        out = {}
        for e in sg.outputs:
            if e.purpose == "execution_condition":
                continue
            ys = collected[e.internal_layer_id]
            per_iter = _result_shape(sg, e.internal_layer_id)
            decl_dtype = body.nodes[e.internal_layer_id].inputs[0].dtype
            if e.axis is None:
                out[e.external_port_id] = ys[-1] if ys else np.zeros(per_iter, decl_dtype)
            else:
                # padded with zeros to the declared static extent (trip count)
                full, axis = _slice_shape(per_iter, e.axis, e.part_size)
                buf = np.zeros(full[:axis] + (tc * e.part_size,) + full[axis + 1:], decl_dtype)
                if ys:
                    cat = _np_concat(e, ys)
                    sl = [slice(None)] * buf.ndim
                    sl[axis] = (slice(buf.shape[axis] - cat.shape[axis], None) if e.stride < 0
                                else slice(0, cat.shape[axis]))
                    buf[tuple(sl)] = cat
                out[e.external_port_id] = buf
        return out

    def emit(self, ctx, node, inputs) -> Dict[int, TValue]:
        sg = _sub(node, "body")
        body = sg.model
        cur_id, cond_id = self._special(sg)
        tc_static = ctx.analysis.value(*ctx.model.in_edges[node.id][0])
        tc_static = int(np.asarray(tc_static).reshape(())) if tc_static is not None else None
        sliced, invariant, init = _classify(
            sg, {p: tv.arr for p, tv in inputs.items() if p >= 2})
        out_entries = [e for e in sg.outputs if not e.purpose]
        if tc_static is None and (sliced or any(e.axis is not None for e in out_entries)):
            raise ValueError(
                f"Loop {node.name!r}: dynamic trip count with sliced "
                f"inputs or concatenated outputs has no static shape")
        xs = _device_chunks(sliced)
        carry = {pid: _cast_init(ctx, sg, pid, v) for pid, v in init.items()}
        if tc_static is not None:
            limit = tc_static if tc_static >= 0 else np.iinfo(np.int32).max
        else:
            tc = int(inputs[0].arr.reshape(()).item())
            limit = np.iinfo(np.int32).max if tc < 0 else tc

        def slot0(e):
            per = _result_shape(sg, e.internal_layer_id)
            decl = body.nodes[e.internal_layer_id].inputs[0].dtype
            dt = ctx.compute_dtype if _float(decl) else torch_dtype(decl)
            shape = per if e.axis is None else (tc_static,) + tuple(per)
            return torch.zeros(shape, dtype=dt, device=ctx.device)

        slots = {e.internal_layer_id: slot0(e) for e in out_entries}
        cond, it = _host_bool(inputs[1].arr), 0
        while it < limit and cond:
            feeds = dict(invariant)
            feeds.update(carry)
            feeds.update({pid: chunks[it] for pid, chunks in xs.items()})
            if cur_id is not None:
                info = _param_info(sg, cur_id)
                feeds[cur_id] = torch.full(info.shape or (), it, dtype=torch_dtype(info.dtype),
                                           device=ctx.device)
            res = ctx.run_body(node, "body", feeds)
            carry = {to: res[frm] for frm, to in sg.back_edges}
            for e in out_entries:
                if e.axis is None:
                    slots[e.internal_layer_id] = res[e.internal_layer_id]
                else:
                    slots[e.internal_layer_id][it] = res[e.internal_layer_id]
            cond = _host_bool(res[cond_id])
            it += 1
        return {e.external_port_id: (TValue(slots[e.internal_layer_id]) if e.axis is None
                                     else _concat_out(e, slots[e.internal_layer_id]))
                for e in out_entries}


@register
class If(Op):
    """opset8 If: the then/else port maps bind the node's data inputs
    (ports >= 1) to each body's Parameters; both bodies must give the same
    output shapes and dtypes (checked by shape inference).  The predicate
    is read on the host, and only the branch it picks runs, as under
    ``lax.cond``."""

    type_name = "If"

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        shapes, dtypes = {}, {}
        for bname in ("then_body", "else_body"):
            sg = _sub(node, bname)
            body_analysis(sg)
            if sg.back_edges:
                raise ValueError(f"If {node.name!r}: {bname} has back edges")
            for e in sg.inputs + sg.outputs:
                if e.axis is not None or e.purpose:
                    raise ValueError(
                        f"If {node.name!r}: {bname} port map entries must "
                        f"be plain (no axis/purpose)")
            _validate_inputs(node, sg, {p: s for p, s in in_shapes.items() if p >= 1})
            got = _output_shapes(node, sg, -1)
            got_dt = {e.external_port_id: sg.model.nodes[e.internal_layer_id].inputs[0].dtype
                      for e in sg.outputs}
            if not shapes:
                shapes, dtypes = got, got_dt
            elif got != shapes:
                raise ValueError(
                    f"If {node.name!r}: then/else output shapes disagree "
                    f"({shapes} vs {got})")
            elif got_dt != dtypes:
                raise ValueError(
                    f"If {node.name!r}: then/else output dtypes disagree "
                    f"({dtypes} vs {got_dt})")
        if tuple(in_shapes.get(0, ())) not in ((), (1,)):
            raise ValueError(
                f"If {node.name!r}: condition must be a scalar boolean, "
                f"got shape {in_shapes[0]}")
        return ShapeResult(shapes)

    @staticmethod
    def _feeds(sg, data):
        return {e.internal_layer_id: data[e.external_port_id] for e in sg.inputs}

    def ref_compute(self, node, inputs) -> Dict[int, np.ndarray]:
        from pyopenvino_tpu_torch.runtime.interpreter import Interpreter

        pred = bool(np.asarray(inputs[0]).reshape(()))
        sg = _sub(node, "then_body" if pred else "else_body")
        feeds = {pid: _np_cast(v, _param_info(sg, pid))
                 for pid, v in self._feeds(sg, {p: v for p, v in inputs.items() if p >= 1}).items()}
        res = _run_body_np(Interpreter(sg.model), sg, feeds)
        return {e.external_port_id: res[e.internal_layer_id] for e in sg.outputs}

    def emit(self, ctx, node, inputs) -> Dict[int, TValue]:
        then_sg, else_sg = _sub(node, "then_body"), _sub(node, "else_body")
        if (sorted(e.external_port_id for e in then_sg.outputs)
                != sorted(e.external_port_id for e in else_sg.outputs)):
            raise ValueError(f"If {node.name!r}: then/else map different output ports")
        bname = "then_body" if _host_bool(inputs[0].arr) else "else_body"
        sg = node.subgraphs[bname]
        res = ctx.run_body(node, bname, self._feeds(
            sg, {p: tv.arr for p, tv in inputs.items() if p >= 1}))
        return {e.external_port_id: TValue(res[e.internal_layer_id]) for e in sg.outputs}
