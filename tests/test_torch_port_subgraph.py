"""TensorIterator, Loop and If (ops/subgraph.py) and their IR support
(ir/subgraph.py, the parser's and writer's bodies) on the port against the
JAX package, every case of tests/test_subgraph.py but its export one:

  * each graph is built with the JAX package's GraphBuilder, written by its
    writer and read by the port's parser, then run on the port's TORCH and
    KERNELS backends (CPU tensors: the kernels' plain versions) and its
    numpy interpreter, against the JAX package's XLA backend and its
    interpreter at rtol 1e-5 in float32 (the port's interpreter equal to
    the JAX package's bit for bit), and against a numpy golden where the
    JAX test has one;
  * the bodies are the JAX test's own: its tanh RNN cell, its Negative
    branch, its Less and Greater conditions;
  * the refusals are built with the port's IR classes where the JAX
    builder refuses the graph itself, and each raises the JAX package's
    error with its message."""

import numpy as np
import pytest
import torch

import pyopenvino_tpu.ir.model as jax_ir
from pyopenvino_tpu.config import Backend as JaxBackend
from pyopenvino_tpu.config import Config as JaxConfig
from pyopenvino_tpu.ir.builder import GraphBuilder
from pyopenvino_tpu.ir.writer import serialize_ir as jax_serialize
from pyopenvino_tpu.runtime.compiler import compile_model as jax_compile
from pyopenvino_tpu.runtime.interpreter import Interpreter as JaxInterpreter

from pyopenvino_tpu_torch.config import Backend, Config
from pyopenvino_tpu_torch.ir import Edge, Model, Node, TensorInfo, parse_ir
from pyopenvino_tpu_torch.ir.subgraph import PortMapEntry, SubGraph
from pyopenvino_tpu_torch.ir.writer import serialize_ir
from pyopenvino_tpu_torch.ops import subgraph as subgraph_ops
from pyopenvino_tpu_torch.passes.shape_infer import bake_batch, infer_shapes
from pyopenvino_tpu_torch.passes.util import folded_nodes
from pyopenvino_tpu_torch.runtime.compiler import compile_model
from pyopenvino_tpu_torch.runtime.interpreter import Interpreter
import test_torch_port_threads  # noqa: F401  (this worker's torch threads)

RTOL, ATOL = 1e-5, 1e-6
I, H, T, B = 6, 10, 5, 2
BACKENDS = [Backend.TORCH, Backend.KERNELS]


def _rng(seed):
    return np.random.default_rng(seed)


def to_port(jax_model):
    """The JAX package's model through its writer and the port's parser."""
    xml, blob = jax_serialize(jax_model)
    return parse_ir(xml.decode("utf-8"), blob, name=jax_model.name)


def check_against_jax(jax_model, feed, golden=None):
    """The port (TORCH, KERNELS, interpreter) against the JAX package (XLA,
    interpreter) and ``golden``; returns the port's compiled TORCH net."""
    model = to_port(jax_model)
    want = jax_compile(jax_model, JaxConfig(backend=JaxBackend.XLA))(feed)
    jax_ref = JaxInterpreter(jax_model).run(feed)
    ref = Interpreter(model).run(feed)
    assert sorted(ref) == sorted(want)
    for k in ref:
        np.testing.assert_array_equal(ref[k], jax_ref[k])
        np.testing.assert_allclose(want[k], ref[k], rtol=RTOL, atol=ATOL)
        if golden is not None:
            np.testing.assert_allclose(ref[k], golden[k], rtol=RTOL, atol=ATOL)
    nets = {}
    for backend in BACKENDS:
        nets[backend] = compile_model(model, Config(backend=backend), device="cpu")
        got = nets[backend](feed)
        for k in ref:
            assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(got[k], ref[k], rtol=RTOL, atol=ATOL)
    return nets[Backend.TORCH]


# -- graphs (tests/test_subgraph.py's, on the port's op types) ----------------


def _rnn_body(W, R, bias, b=B):
    bb = GraphBuilder("body")
    xt = bb.parameter("x_t", (b, 1, I))
    h = bb.parameter("h_in", (b, H))
    xf = bb.reshape(xt, (b, I))
    z = bb.add(bb.add(bb.matmul(xf, bb.const(W)), bb.matmul(h, bb.const(R))), bb.const(bias))
    h2 = bb.tanh(z)
    bb.result(h2, "h_out")
    bb.result(bb.reshape(h2, (b, 1, H)), "y_out")
    return bb.build()


def _weights(seed=7):
    rng = _rng(seed)
    W = rng.standard_normal((I, H)).astype(np.float32) * 0.3
    R = rng.standard_normal((H, H)).astype(np.float32) * 0.3
    bias = rng.standard_normal((1, H)).astype(np.float32) * 0.1
    return W, R, bias


def _ti_model(W, R, bias, reverse=False, b=B):
    sl = {"axis": 1, "start": -1, "end": 0, "stride": -1} if reverse else {"axis": 1}
    gb = GraphBuilder("outer")
    x = gb.parameter("x", (b, T, I))
    h0 = gb.parameter("h0", (b, H))
    outs = gb.tensor_iterator(
        [x, h0], _rnn_body(W, R, bias, b),
        input_map=[("x_t", sl), "h_in"], output_map=[("y_out", sl), "h_out"],
        back_edges=[("h_out", "h_in")])
    gb.result(outs[0], "Y")
    gb.result(outs[1], "H_last")
    return gb.build()


def _golden_rnn(x, h0, W, R, bias, reverse=False):
    hh = h0.astype(np.float64)
    ys = [None] * x.shape[1]
    order = range(x.shape[1] - 1, -1, -1) if reverse else range(x.shape[1])
    for t in order:
        hh = np.tanh(x[:, t] @ W + hh @ R + bias)
        ys[t] = hh[:, None]
    return {"Y": np.concatenate(ys, 1), "H_last": hh}


def _feed(seed=1, b=B):
    rng = _rng(seed)
    return {"x": rng.standard_normal((b, T, I)).astype(np.float32),
            "h0": rng.standard_normal((b, H)).astype(np.float32)}


def _loop_counter_model(tc_value):
    bb = GraphBuilder("lbody")
    s = bb.parameter("s_in", (B, H))
    inc = bb.parameter("inc", (B, H))
    bb.result(bb.add(s, inc), "s_out")
    bb.result(bb.const(np.asarray(True).reshape(())), "cond")
    body = bb.build()
    gb = GraphBuilder("outer")
    tc = gb.const(np.asarray(tc_value, np.int64).reshape(()))
    ec = gb.const(np.asarray(True).reshape(()))
    s0 = gb.parameter("s0", (B, H))
    i0 = gb.parameter("inc0", (B, H))
    out = gb.loop(tc, ec, [s0, i0], body, input_map=["s_in", "inc"], output_map=["s_out"],
                  back_edges=[("s_out", "s_in")], condition_result="cond")
    gb.result(out, "final")
    return gb.build()


def _loop_until_model():
    """trip_count -1: the body's condition ends the loop (s2 < 7)."""
    bb = GraphBuilder("lbody")
    s = bb.parameter("s_in", (1, 1))
    s2 = bb.add(s, bb.const(np.ones((1, 1), np.float32)))
    bb.result(s2, "s_out")
    c = bb._add_node("Less", [s2, bb.const(np.full((1, 1), 7.0, np.float32))], {},
                     out_dtype=np.bool_)
    bb.result(bb.reshape(c, ()), "cond")
    body = bb.build()
    gb = GraphBuilder("outer")
    tc = gb.const(np.asarray(-1, np.int64).reshape(()))
    ec = gb.const(np.asarray(True).reshape(()))
    s0 = gb.parameter("s0", (1, 1))
    out = gb.loop(tc, ec, [s0], body, input_map=["s_in"], output_map=["s_out"],
                  back_edges=[("s_out", "s_in")], condition_result="cond")
    gb.result(out, "final")
    return gb.build()


def _loop_concat_model(n):
    bb = GraphBuilder("lbody")
    it = bb.parameter("iter", (), dtype=np.int32)
    x = bb.parameter("x_in", (1, 3))
    itf = bb.convert(it, "f32")
    y = bb.add(x, bb.reshape(itf, (1, 1)))
    bb.result(bb.reshape(y, (1, 1, 3)), "y_step")
    bb.result(bb.const(np.asarray(True).reshape(())), "cond")
    body = bb.build()
    gb = GraphBuilder("outer")
    tc = gb.const(np.asarray(n, np.int64).reshape(()))
    ec = gb.const(np.asarray(True).reshape(()))
    x0 = gb.parameter("x", (1, 3))
    out = gb.loop(tc, ec, [x0], body, input_map=["x_in"], output_map=[("y_step", {"axis": 1})],
                  current_iteration="iter", condition_result="cond")
    gb.result(out, "ys")
    return gb.build()


def _if_model():
    tb = GraphBuilder("then")
    xp = tb.parameter("xa", (B, H))
    tb.result(tb.relu(xp), "r")
    eb = GraphBuilder("else")
    xq = eb.parameter("xb", (B, H))
    eb.result(eb.unary("Negative", xq), "r")
    gb = GraphBuilder("ifnet")
    cond = gb.parameter("c", (), dtype=np.bool_)
    xv = gb.parameter("x", (B, H))
    gb.result(gb.if_op(cond, [xv], tb.build(), eb.build(), ["xa"], ["xb"], ["r"], ["r"]), "out")
    return gb.build()


def _nested_model(F=3, steps=4):
    tb = GraphBuilder("then")
    xa = tb.parameter("xa", (B, F))
    tb.result(tb.multiply(xa, tb.const(np.float32(2).reshape(()))), "r")
    eb = GraphBuilder("else")
    xb = eb.parameter("xb", (B, F))
    eb.result(eb.add(xb, eb.const(np.float32(10).reshape(()))), "r")
    bb = GraphBuilder("tibody")
    xt = bb.parameter("x_t", (B, 1, F))
    s = bb.parameter("s_in", (B, F))
    xf = bb.reshape(xt, (B, F))
    ssum = bb.reduce("Sum", s, axes=(0, 1), keep_dims=False)
    cond = bb.compare("Greater", ssum, bb.const(np.float32(0).reshape(())))
    y = bb.if_op(cond, [xf], tb.build(), eb.build(), ["xa"], ["xb"], ["r"], ["r"])
    bb.result(bb.add(s, xf), "s_out")
    bb.result(bb.reshape(y, (B, 1, F)), "y_out")
    gb = GraphBuilder("outer")
    x = gb.parameter("x", (B, steps, F))
    s0 = gb.parameter("s0", (B, F))
    outs = gb.tensor_iterator(
        [x, s0], bb.build(), input_map=[("x_t", {"axis": 1}), "s_in"],
        output_map=[("y_out", {"axis": 1}), "s_out"], back_edges=[("s_out", "s_in")])
    gb.result(outs[0], "Y")
    gb.result(outs[1], "S")
    return gb.build()


# -- the cases -----------------------------------------------------------------


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_tensor_iterator_rnn_golden_and_parity(reverse):
    W, R, bias = _weights()
    feed = _feed()
    check_against_jax(_ti_model(W, R, bias, reverse), feed,
                      _golden_rnn(feed["x"], feed["h0"], W, R, bias, reverse))


def test_tensor_iterator_part_size_chunks():
    """part_size 2 with stride 2: the body takes 2-wide chunks, and the
    concatenated output puts them back in order."""
    bb = GraphBuilder("chunkbody")
    xt = bb.parameter("x_t", (B, 2, I))
    bb.result(bb.multiply(xt, bb.const(np.float32(2.0).reshape(()))), "y")
    gb = GraphBuilder("outer")
    x = gb.parameter("x", (B, 6, I))
    y = gb.tensor_iterator(
        [x], bb.build(), input_map=[("x_t", {"axis": 1, "part_size": 2, "stride": 2})],
        output_map=[("y", {"axis": 1, "part_size": 2, "stride": 2})])
    gb.result(y, "out")
    feed = {"x": _rng(2).standard_normal((B, 6, I)).astype(np.float32)}
    check_against_jax(gb.build(), feed, {"out": feed["x"] * 2})


def test_tensor_iterator_body_weights_in_the_weight_dict(tmp_path):
    """Body Consts are weights of the compiled network under the JAX
    package's keys, ``sub.<node id>.body.<const id>``, in the compute
    dtype, the Reshape targets not among them; a JAX ``save_weights``
    checkpoint loads as is, and new values change the answer."""
    W, R, bias = _weights()
    jax_model = _ti_model(W, R, bias)
    jax_net = jax_compile(jax_model, JaxConfig(backend=JaxBackend.XLA))
    net = compile_model(to_port(jax_model), Config(), device="cpu")
    sub_keys = sorted(k for k in net.weights if k.startswith("sub."))
    assert len(sub_keys) == 3, sub_keys  # W, R and the bias
    assert sub_keys == sorted(k for k in jax_net.weights if k.startswith("sub."))
    assert sorted(net.weights) == sorted(jax_net.weights)
    assert sum(net.weights[k].numel() for k in sub_keys) == W.size + R.size + bias.size
    for k in sub_keys:
        assert net.weights[k].dtype == torch.float32
        np.testing.assert_array_equal(net.weights[k].numpy(), np.asarray(jax_net.weights[k]))
    feed = _feed()
    before = net(feed)
    ckpt = str(tmp_path / "ti.npz")
    jax_net.save_weights(ckpt)
    net.load_weights(ckpt)
    for k, v in net(feed).items():
        np.testing.assert_array_equal(v, before[k])
    net.load_weights({k: (v.numpy() * 2 if k in sub_keys else v.numpy())
                      for k, v in net.weights.items()})
    assert not np.array_equal(net(feed)["Y"], before["Y"])
    bf16 = compile_model(to_port(jax_model), Config(compute_dtype="bfloat16"), device="cpu")
    assert all(bf16.weights[k].dtype == torch.bfloat16 for k in sub_keys)


def test_tensor_iterator_infer_batch_runs_per_example():
    """A batch-1 body cannot carry a batch in N: bake_batch leaves the body
    alone and the TensorIterator refuses the batched input with a
    ValueError, so infer_batch runs the examples one at a time (the JAX
    package vmaps over them), each against the golden and the JAX
    package's infer_batch."""
    W, R, bias = _weights()
    jax_model = _ti_model(W, R, bias, b=1)
    model = to_port(jax_model)
    with pytest.raises(ValueError, match="sliced input provides"):
        bake_batch(model, 4)
    rng = _rng(3)
    xs = rng.standard_normal((4, 1, T, I)).astype(np.float32)
    h0s = rng.standard_normal((4, 1, H)).astype(np.float32)
    want = jax_compile(jax_model, JaxConfig(backend=JaxBackend.XLA)).infer_batch(
        {"x": xs, "h0": h0s})
    for backend in BACKENDS:
        net = compile_model(model, Config(backend=backend), device="cpu")
        out = net.infer_batch({"x": xs, "h0": h0s})
        assert net._batched_plan(4) is None
        for k in ("Y", "H_last"):
            assert out[k].shape == np.asarray(want[k]).shape
            np.testing.assert_allclose(out[k], np.asarray(want[k]), rtol=RTOL, atol=ATOL)
        for i in range(4):
            golden = _golden_rnn(xs[i], h0s[i], W, R, bias)
            np.testing.assert_allclose(out["Y"][i], golden["Y"][0], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("tc", [5, 0, 1], ids=["five", "zero", "one"])
def test_loop_static_trip_count(tc):
    rng = _rng(4)
    feed = {"s0": rng.standard_normal((B, H)).astype(np.float32),
            "inc0": rng.standard_normal((B, H)).astype(np.float32)}
    golden = {"final": feed["s0"] + tc * feed["inc0"] if tc else np.zeros((B, H), np.float32)}
    check_against_jax(_loop_counter_model(tc), feed, golden)


def test_loop_runs_until_condition():
    """0 → 1 → … → 7: the first value not below 7 ends the loop after it is
    produced; the condition is read on the host once a step."""
    feed = {"s0": np.zeros((1, 1), np.float32)}
    net = check_against_jax(_loop_until_model(), feed, {"final": np.full((1, 1), 7.0)})
    reads = []
    real = subgraph_ops._host_bool

    def counted(t):
        reads.append(t)
        return real(t)

    subgraph_ops._host_bool = counted
    try:
        net(feed)
    finally:
        subgraph_ops._host_bool = real
    assert len(reads) == 1 + 7  # the initial condition, then one a step


def test_loop_current_iteration_and_concat():
    """The body reads the iteration index; the concatenated output stacks
    each step's result in its preallocated buffer."""
    n = 4
    want = np.stack([np.ones((1, 3)) + i for i in range(n)], axis=1).astype(np.float32)
    check_against_jax(_loop_concat_model(n), {"x": np.ones((1, 3), np.float32)}, {"ys": want})


@pytest.mark.parametrize("cv", [True, False], ids=["then", "else"])
def test_if_branches(cv):
    xval = _rng(5).standard_normal((B, H)).astype(np.float32)
    feed = {"c": np.asarray(cv), "x": xval}
    check_against_jax(_if_model(), feed, {"out": np.maximum(xval, 0) if cv else -xval})


def test_if_runs_only_the_chosen_branch():
    """As under lax.cond, one branch runs: the other's body is never
    walked."""
    net = compile_model(to_port(_if_model()), Config(), device="cpu")
    runs = []
    for (prefix, nid, bname), walk in net._bodies.items():
        real = walk.run
        walk.run = (lambda real, bname: lambda feeds: runs.append(bname) or real(feeds))(
            real, bname)
    net({"c": np.asarray(False), "x": np.ones((B, H), np.float32)})
    assert runs == ["else_body"]


def _round_trip_cases():
    W, R, bias = _weights()
    return {"ti": (_ti_model(W, R, bias), _feed()),
            "if": (_if_model(), {"c": np.asarray(True),
                                 "x": _rng(6).standard_normal((B, H)).astype(np.float32)}),
            "loop": (_loop_concat_model(3), {"x": np.ones((1, 3), np.float32)}),
            "nested": (_nested_model(), {"x": _rng(8).standard_normal((B, 4, 3)).astype(
                np.float32), "s0": _rng(9).standard_normal((B, 3)).astype(np.float32)})}


@pytest.mark.parametrize("case", ["ti", "if", "loop", "nested"])
def test_subgraph_ir_round_trip(case, tmp_path):
    """Bodies, port maps and back edges read by the port's parser and
    written by its writer give back the JAX writer's XML and .bin byte for
    byte, body Consts packed where their layer is written; read again they
    compute what the original does."""
    jax_model, feed = _round_trip_cases()[case]
    want_xml, want_bin = jax_serialize(jax_model)
    model = to_port(jax_model)
    xml, blob = serialize_ir(model)
    assert (xml, blob) == (want_xml, want_bin)
    again = parse_ir(xml.decode("utf-8"), blob, name=model.name)
    ref = Interpreter(model).run(feed)
    got = compile_model(again, Config(), device="cpu")(feed)
    for k in ref:
        np.testing.assert_array_equal(Interpreter(again).run(feed)[k], ref[k])
        np.testing.assert_allclose(got[k], ref[k], rtol=RTOL, atol=ATOL)


def test_ti_last_value_not_stacked(monkeypatch):
    """A last-value output takes the final iteration's result and is never
    stacked: the TensorIterator stacks exactly one output (the
    concatenated Y), as the JAX package's scan carries H_last (JAX's
    test_ti_last_value_not_stacked)."""
    W, R, bias = _weights()
    jax_model = _ti_model(W, R, bias)
    stacks = []

    class StackSpy:
        def __getattr__(self, name):
            return getattr(torch, name)

        @staticmethod
        def stack(ts, *args, **kwargs):
            stacks.append(len(ts))
            return torch.stack(ts, *args, **kwargs)

    monkeypatch.setattr(subgraph_ops, "torch", StackSpy())
    net = check_against_jax(jax_model, _feed())
    stacks.clear()
    net(_feed())
    assert stacks == [T]


def test_nested_if_inside_tensor_iterator():
    """An If whose condition follows the carried state, inside a
    TensorIterator body: both executors recurse, and the nested bodies'
    Consts join the weight dict under chained sub.* keys."""
    model_j = _nested_model()
    _, feed = _round_trip_cases()["nested"]
    net = check_against_jax(model_j, feed)
    jax_net = jax_compile(model_j, JaxConfig(backend=JaxBackend.XLA))
    assert sorted(net.weights) == sorted(jax_net.weights)
    nested = [k for k in net.weights if k.count("sub.") == 2]
    assert len(nested) == 2 and {k.split(".")[-2] for k in nested} == {"then_body", "else_body"}
    assert len(net._bodies) == 3


def test_body_analysis_folds_and_caches():
    """Shape inference of a TensorIterator runs on its body's own analysis,
    cached on the SubGraph; folded_nodes works on a body (its Reshape
    targets are static)."""
    W, R, bias = _weights()
    model = to_port(_ti_model(W, R, bias))
    infer_shapes(model)
    sg = model.find_by_type("TensorIterator")[0].subgraphs["body"]
    analysis = sg._shape_analysis
    infer_shapes(model)
    assert sg._shape_analysis is analysis
    assert folded_nodes(sg.model, analysis) == set()
    consts = sg.model.find_by_type("Const")
    assert sum(analysis.value(c.id, c.out_port) is not None for c in consts) == len(consts)


# -- refusals ------------------------------------------------------------------


def _port_body(build):
    bb = GraphBuilder("body")
    build(bb)
    return to_port(bb.build())


def _port_node(nid, op_type, in_shapes, subgraphs, dtype=np.float32):
    return Node(id=nid, name=op_type.lower(), op_type=op_type, attrs={},
                inputs={p: TensorInfo(tuple(s), np.dtype(d)) for p, (s, d) in in_shapes.items()},
                outputs={}, subgraphs=subgraphs)


def _port_param(nid, name, shape, dtype=np.float32):
    return Node(id=nid, name=name, op_type="Parameter", attrs={}, inputs={},
                outputs={0: TensorInfo(tuple(shape), np.dtype(dtype))})


def _outer(nodes, edges):
    return Model("outer", {n.id: n for n in nodes}, [Edge(*e) for e in edges])


def _ti_outer(body, x_shape, inputs, outputs):
    """A TensorIterator over one Parameter ``x`` of ``x_shape``."""
    sg = SubGraph(model=body, inputs=inputs, outputs=outputs)
    ti = _port_node(1, "TensorIterator", {0: (x_shape, np.float32)}, {"body": sg})
    return _outer([_port_param(0, "x", x_shape), ti], [(0, 0, 1, 0)])


def _layer(body, name):
    return body.find_by_name(name).id


def test_body_with_state_ops_refused():
    def build(bb):
        xt = bb.parameter("x_t", (B, 1, I))
        bb.result(bb.read_value(bb.reshape(xt, (B, I)), "v0"), "y")

    gb = GraphBuilder("outer")
    x = gb.parameter("x", (B, T, I))
    body = GraphBuilder("body")
    build(body)
    with pytest.raises(NotImplementedError, match="ReadValue"):
        gb.tensor_iterator([x], body.build(), input_map=[("x_t", {"axis": 1})],
                           output_map=[("y", {"axis": 1})])
    body = _port_body(build)
    model = _ti_outer(body, (B, T, I), [PortMapEntry(0, _layer(body, "x_t"), axis=1)],
                      [PortMapEntry(1, _layer(body, "y"), axis=1)])
    with pytest.raises(NotImplementedError, match="ReadValue"):
        infer_shapes(model)


def test_unmapped_body_parameter_refused():
    def build(bb):
        xt = bb.parameter("x_t", (B, 1, I))
        other = bb.parameter("dangling", (B, H))
        bb.result(bb.reshape(xt, (B, I)), "y")
        bb.result(other, "z")

    gb = GraphBuilder("outer")
    x = gb.parameter("x", (B, T, I))
    body = GraphBuilder("body")
    build(body)
    with pytest.raises(ValueError, match="dangling"):
        gb.tensor_iterator([x], body.build(), input_map=[("x_t", {"axis": 1})],
                           output_map=["y"])
    body = _port_body(build)
    sg = SubGraph(model=body, inputs=[PortMapEntry(0, _layer(body, "x_t"), axis=1)],
                  outputs=[PortMapEntry(1, _layer(body, "y"))])
    with pytest.raises(ValueError, match="dangling"):
        sg.validate()


@pytest.mark.parametrize("part,stride,in_stride,match", [
    (3, 1, 1, "part_size"),   # part_size 3 walked by 1
    (1, 2, 2, "stride"),      # strided sampling
], ids=["part_size", "strided_sampling"])
def test_bad_port_map_walks_refused(part, stride, in_stride, match):
    """A walk whose |stride| is not its part_size needs a gather: refused,
    never mis-sliced."""
    def build(bb):
        bb.result(bb.parameter("x_t", (B, part, I)), "y")

    gb = GraphBuilder("outer")
    x = gb.parameter("x", (B, 6, I))
    body = GraphBuilder("body")
    build(body)
    with pytest.raises(NotImplementedError, match=match):
        gb.tensor_iterator(
            [x], body.build(),
            input_map=[("x_t", {"axis": 1, "part_size": part, "stride": in_stride})],
            output_map=[("y", {"axis": 1, "part_size": part, "stride": stride})])
    body = _port_body(build)
    model = _ti_outer(
        body, (B, 6, I),
        [PortMapEntry(0, _layer(body, "x_t"), axis=1, part_size=part, stride=in_stride)],
        [PortMapEntry(1, _layer(body, "y"), axis=1, part_size=part, stride=stride)])
    with pytest.raises(NotImplementedError, match=match):
        infer_shapes(model)


def test_loop_dynamic_trip_count_with_concat_refused():
    def build(bb):
        x = bb.parameter("x_in", (1, 3))
        bb.result(bb.reshape(x, (1, 1, 3)), "y_step")
        bb.result(bb.const(np.asarray(True).reshape(())), "cond")

    gb = GraphBuilder("outer")
    tc = gb.parameter("tc", (), dtype=np.int64)
    ec = gb.const(np.asarray(True).reshape(()))
    x0 = gb.parameter("x", (1, 3))
    body = GraphBuilder("lbody")
    build(body)
    with pytest.raises(ValueError, match="static iteration count"):
        gb.loop(tc, ec, [x0], body.build(), input_map=["x_in"],
                output_map=[("y_step", {"axis": 1})], condition_result="cond")
    body = _port_body(build)
    sg = SubGraph(model=body, inputs=[PortMapEntry(2, _layer(body, "x_in"))],
                  outputs=[PortMapEntry(3, _layer(body, "y_step"), axis=1),
                           PortMapEntry(-1, _layer(body, "cond"),
                                        purpose="execution_condition")])
    cond = Node(id=1, name="ec", op_type="Const", attrs={}, inputs={},
                outputs={0: TensorInfo((), np.dtype(np.bool_))}, const=np.asarray(True))
    loop = _port_node(3, "Loop", {0: ((), np.int64), 1: ((), np.bool_), 2: ((1, 3), np.float32)},
                      {"body": sg})
    model = _outer([_port_param(0, "tc", (), np.int64), cond, _port_param(2, "x", (1, 3)), loop],
                   [(0, 0, 3, 0), (1, 0, 3, 1), (2, 0, 3, 2)])
    with pytest.raises(ValueError, match="static iteration count"):
        infer_shapes(model)


def _if_branches(then_build, else_build):
    subs = {}
    for bname, build, pname in (("then_body", then_build, "xa"), ("else_body", else_build, "xb")):
        body = _port_body(build)
        subs[bname] = SubGraph(model=body, inputs=[PortMapEntry(1, _layer(body, pname))],
                               outputs=[PortMapEntry(2, _layer(body, "r"))])
    node = _port_node(2, "If", {0: ((), np.bool_), 1: ((B, H), np.float32)}, subs)
    return _outer([_port_param(0, "c", (), np.bool_), _port_param(1, "x", (B, H)), node],
                  [(0, 0, 2, 0), (1, 0, 2, 1)])


@pytest.mark.parametrize("case,match", [("shapes", "shapes disagree"),
                                        ("dtypes", "dtypes disagree")])
def test_if_mismatched_branches_refused(case, match):
    def then_build(bb):
        xp = bb.parameter("xa", (B, H))
        bb.result(bb.relu(xp) if case == "dtypes" else xp, "r")

    def else_build(bb):
        xq = bb.parameter("xb", (B, H))
        bb.result(bb.convert(bb.relu(xq), "i32") if case == "dtypes"
                  else bb.reshape(xq, (B * H,)), "r")

    gb = GraphBuilder("ifnet")
    cond = gb.parameter("c", (), dtype=np.bool_)
    xv = gb.parameter("x", (B, H))
    tb, eb = GraphBuilder("then"), GraphBuilder("else")
    then_build(tb)
    else_build(eb)
    with pytest.raises(ValueError, match=match):
        gb.if_op(cond, [xv], tb.build(), eb.build(), ["xa"], ["xb"], ["r"], ["r"])
    with pytest.raises(ValueError, match=match):
        infer_shapes(_if_branches(then_build, else_build))


def test_ti_output_purpose_refused():
    """purpose entries are Loop-only: a TensorIterator with one fails shape
    inference, in both packages."""
    from pyopenvino_tpu.ir.subgraph import PortMapEntry as JaxEntry
    from pyopenvino_tpu.ir.subgraph import SubGraph as JaxSubGraph
    from pyopenvino_tpu.ops.subgraph import TensorIterator as JaxTI

    def build(bb):
        bb.result(bb.parameter("x_t", (B, 1, I)), "y")

    jb = GraphBuilder("body")
    build(jb)
    jbody = jb.build()
    rid, pid = jbody.results[0].id, jbody.parameters[0].id
    jsg = JaxSubGraph(model=jbody, inputs=[JaxEntry(0, pid, axis=1)],
                      outputs=[JaxEntry(1, rid, axis=1),
                               JaxEntry(-1, rid, purpose="execution_condition")])
    jnode = jax_ir.Node(id=0, name="ti", op_type="TensorIterator", attrs={},
                        inputs={0: jax_ir.TensorInfo((B, 5, I), np.dtype(np.float32))},
                        outputs={}, subgraphs={"body": jsg})
    with pytest.raises(ValueError, match="Loop-only"):
        JaxTI().infer_shapes(jnode, {0: (B, 5, I)}, {})
    body = _port_body(build)
    model = _ti_outer(body, (B, 5, I), [PortMapEntry(0, _layer(body, "x_t"), axis=1)],
                      [PortMapEntry(1, _layer(body, "y"), axis=1),
                       PortMapEntry(-1, _layer(body, "y"), purpose="execution_condition")])
    with pytest.raises(ValueError, match="Loop-only"):
        infer_shapes(model)


def test_load_network_rejects_an_unported_op_in_a_body(tmp_path):
    """The public API's fail-fast op check reads the bodies too: a body
    layer of a type neither package has (an ROIAlign renamed ROIPooling
    once the graph is built) is refused."""
    from pyopenvino_tpu.ir.writer import write_ir_model

    from pyopenvino_tpu_torch import IECore

    bb = GraphBuilder("body")
    data = bb.reshape(bb.parameter("x_t", (B, 1, I)), (1, 1, B, I))
    rois = bb.const(np.tile(np.asarray([0, 0, 1, 1], np.float32), (B, 1)))
    roi = bb.roi_align(data, rois, bb.const(np.zeros(B, np.int32)), 1, I)
    bb.result(bb.reshape(roi, (B, 1, I)), "y")
    gb = GraphBuilder("outer")
    x = gb.parameter("x", (B, T, I))
    gb.result(gb.tensor_iterator([x], bb.build(), input_map=[("x_t", {"axis": 1})],
                                 output_map=[("y", {"axis": 1})]), "out")
    model = gb.build()
    body = model.find_by_type("TensorIterator")[0].subgraphs["body"].model
    body.find_by_type("ROIAlign")[0].op_type = "ROIPooling"
    xml = str(tmp_path / "roi_pooling_ti.xml")
    write_ir_model(model, xml)
    ie = IECore()
    with pytest.raises(ValueError, match="ROIPooling"):
        ie.load_network(ie.read_network(xml), "CPU")
