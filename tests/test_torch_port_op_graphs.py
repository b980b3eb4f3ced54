"""The port's GraphBuilder (``ir/builder.py``) and the nine graph recipes of
``models/op_graphs.py`` against the JAX package, at a small width:

  * each recipe built with the port's GraphBuilder and written by the
    port's writer gives the same ``.xml`` and ``.bin`` bytes as the JAX
    package's GraphBuilder and writer (at full width too: the bytes only);
  * the graph read back through the port's parser runs on the port's TORCH
    backend (CPU tensors) against the JAX package's XLA backend in FP32,
    INT8 weight-only and INT8-FULL (calibrated on seeded samples): float
    outputs within rtol 1e-5 of each output's largest value, integer and
    bool outputs equal (TopK's indices behind the FC, ``Recipe.loose``,
    agree on 0.9 of their rows); KERNELS (its plain versions on the CPU)
    against TORCH likewise; ``infer_batch`` against one ``infer`` an
    example (a stateful recipe refuses it); and the port's interpreter
    equal to the JAX package's bit for bit;
  * every one of the 75 op types appears in its recipe, and so do the
    state ops (``lstm_stream``) and the detector ops (``two_stage``,
    ``single_shot``);
  * a TensorIterator, a Loop and an If built with either builder write
    the same bytes;
  * the builder's refusals: the JAX tests' error cases
    (tests/test_ops_extended.py:67, :1218, :1445, :1761) raise the same
    errors through the port's builder; and the builder methods of the state
    and detector ops record the JAX builder's node and shapes."""

import dataclasses

import numpy as np
import pytest

from pyopenvino_tpu.config import Backend as JaxBackend
from pyopenvino_tpu.config import Config as JaxConfig
from pyopenvino_tpu.config import QuantMode as JaxQuantMode
from pyopenvino_tpu.ir.builder import GraphBuilder as JaxGraphBuilder
from pyopenvino_tpu.ir.writer import serialize_ir as jax_serialize
from pyopenvino_tpu.runtime.compiler import compile_model as jax_compile
from pyopenvino_tpu.runtime.interpreter import Interpreter as JaxInterpreter

from pyopenvino_tpu_torch.config import Backend, Config, QuantMode
from pyopenvino_tpu_torch.ir import parse_ir
from pyopenvino_tpu_torch.ir.builder import GraphBuilder
from pyopenvino_tpu_torch.ir.writer import serialize_ir
from pyopenvino_tpu_torch.models import op_graphs
from pyopenvino_tpu_torch.runtime.compiler import compile_model
from pyopenvino_tpu_torch.runtime.interpreter import Interpreter
from test_torch_port_ops_extended3 import SLICE_OPS
import test_torch_port_threads  # noqa: F401  (this worker's torch threads)

WIDTH = 8
RTOL = 1e-5
MODES = {"none": (QuantMode.NONE, JaxQuantMode.NONE),
         "int8w": (QuantMode.INT8_WEIGHT, JaxQuantMode.INT8_WEIGHT),
         "int8": (QuantMode.INT8_FULL, JaxQuantMode.INT8_FULL)}
CALIBRATION = 4


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def agree(got, want, loose=False):
    """Float outputs within RTOL of the largest value, the rest equal;
    ``loose``: integer rows equal on at least 0.9 of the rows."""
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape)
    if loose:
        rows = (got.reshape(got.shape[0], -1) == want.reshape(want.shape[0], -1)).all(axis=1)
        assert rows.mean() >= 0.9
    elif np.issubdtype(want.dtype, np.floating):
        assert _rel(got, want) <= RTOL, _rel(got, want)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module", params=sorted(op_graphs.RECIPES))
def recipe(request):
    """(name, JAX model, port model read back from the port's bytes, Recipe,
    the port's and the JAX package's bytes)."""
    name = request.param
    jax_model, _ = op_graphs.build(JaxGraphBuilder, name, width=WIDTH)
    port_built, rec = op_graphs.build(GraphBuilder, name, width=WIDTH)
    xml, blob = serialize_ir(port_built)
    return (name, jax_model, parse_ir(xml.decode("utf-8"), blob, name=name), rec, (xml, blob),
            jax_serialize(jax_model))


def test_recipes_cover_every_new_op_type(recipe):
    name, _, model, _, _, _ = recipe
    types = {n.op_type for n in model.nodes.values()}
    assert set(op_graphs.COVERS[name]) <= types
    assert sorted(t for n, ts in op_graphs.COVERS.items() for t in ts
                  if n not in op_graphs.STATE_AND_DETECTION) == sorted(SLICE_OPS)
    assert sorted(t for n in op_graphs.STATE_AND_DETECTION for t in op_graphs.COVERS[n]) == [
        "Assign", "PriorBox", "Proposal", "ROIAlign", "ReadValue"]


def test_builder_and_writer_bytes_equal_jax(recipe):
    _, _, _, _, port_bytes, jax_bytes = recipe
    assert port_bytes[0] == jax_bytes[0]
    assert port_bytes[1] == jax_bytes[1]


@pytest.mark.parametrize("name", sorted(op_graphs.RECIPES))
def test_full_width_bytes_equal_jax(name):
    jm, _ = op_graphs.build(JaxGraphBuilder, name)
    pm, _ = op_graphs.build(GraphBuilder, name)
    assert serialize_ir(pm) == jax_serialize(jm)


def _feeds(rec, seed, n=1):
    return rec.inputs(np.random.default_rng(seed), n)


def test_interpreter_equals_jax(recipe):
    _, jax_model, model, rec, _, _ = recipe
    feed = _feeds(rec, 1)
    got = Interpreter(model).run(feed)
    want = JaxInterpreter(jax_model).run(feed)
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_torch_matches_the_interpreter(recipe):
    """The gate phase 4e holds on the card: TORCH's FP32 float32 answers
    against the port's numpy interpreter, outputs of the same dtypes."""
    _, _, model, rec, _, _ = recipe
    feed = _feeds(rec, 5)
    got = compile_model(model, Config(backend=Backend.TORCH), device="cpu")(feed)
    want = Interpreter(model).run(feed)
    assert sorted(got) == sorted(want)
    for k in got:
        agree(got[k], want[k], k in rec.loose)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_torch_matches_jax_xla(recipe, mode):
    """TORCH against XLA, KERNELS (plain versions) against TORCH."""
    _, jax_model, model, rec, _, _ = recipe
    quant, jquant = MODES[mode]
    cal = [_feeds(rec, 100 + i) for i in range(CALIBRATION)] if mode == "int8" else None
    feed = _feeds(rec, 2)
    want = jax_compile(jax_model, JaxConfig(backend=JaxBackend.XLA, quant=jquant),
                       calibration_samples=cal)(feed)
    torch_net = compile_model(model, Config(backend=Backend.TORCH, quant=quant), device="cpu",
                              calibration_samples=cal)
    got = torch_net(feed)
    kernels = compile_model(model, Config(backend=Backend.KERNELS, quant=quant), device="cpu",
                            calibration_samples=cal)(feed)
    assert sorted(got) == sorted(want) == sorted(kernels)
    for k in got:
        agree(got[k], want[k], k in rec.loose)
        agree(kernels[k], got[k], k in rec.loose)


def test_infer_batch_matches_each_example(recipe):
    """A batch of three baked into the graph (or, for gather_scatter's and
    two_stage's batch-1 graphs, one example at a time) equals three
    requests; a stateful recipe refuses a batch of examples."""
    name, _, model, rec, _, _ = recipe
    net = compile_model(model, Config(backend=Backend.KERNELS), device="cpu")
    rows = _feeds(rec, 3, n=3)
    if name == "lstm_stream":
        with pytest.raises(NotImplementedError):
            net.infer_batch(rows)
        return
    got = net.infer_batch(rows)
    for i in range(3):
        one = net.infer({k: v[i:i + 1] for k, v in rows.items()})
        for k in one:
            if got[k].shape[0] == 3 and one[k].shape[:1] == (1,):
                agree(got[k][i:i + 1], one[k], k in rec.loose)


# -- the builder's refusals ----------------------------------------------------------

def test_squeeze_non_unit_axis_rejected():
    b = GraphBuilder("t")
    x = b.parameter("in", (1, 4, 1, 6))
    with pytest.raises(ValueError, match="extent"):
        b.squeeze(x, axes=(1,))


def test_block_op_and_scatter_validation():
    b = GraphBuilder("v")
    x = b.parameter("x", (2, 4))
    with pytest.raises(ValueError, match="block\\[0\\] must be 1"):
        b.space_to_batch(x, (2, 2), (0, 0), (0, 0))
    with pytest.raises(ValueError, match="not divisible by block"):
        b.space_to_batch(x, (1, 3), (0, 0), (0, 0))
    x5 = b.parameter("x5", (5, 4))
    with pytest.raises(ValueError, match="not\\s+divisible by prod"):
        b.batch_to_space(x5, (1, 2), (0, 0), (0, 0))
    d = b.parameter("d", (4, 3))
    i3 = b.parameter("i3", (2, 3), dtype=np.int32)
    u = b.parameter("u", (2,))
    with pytest.raises(ValueError, match="exceeds data rank"):
        b.scatter_nd_update(d, i3, u)
    ib = b.parameter("ib", (5, 2), dtype=np.int32)
    with pytest.raises(ValueError, match="must match"):
        b.gather_elements(d, ib, axis=1)
    r = b.range_(0, 4, 1, output_type="i32")
    assert r.dtype == np.int32 and r.shape == (4,)
    blk = b.parameter("blk", (4,), dtype=np.int64)
    x4 = b.parameter("x4", (2, 3, 4, 4))
    zero = b.const(np.zeros(4, np.int64))
    with pytest.raises(ValueError, match="must be"):
        b._add_node("SpaceToBatch", [x4, blk, zero, zero], {}, "s")


def test_round_bad_mode_and_einsum_and_broadcast_refusals():
    b = GraphBuilder("rm")
    x = b.parameter("x", (1, 4))
    with pytest.raises(ValueError, match="unknown mode"):
        b._add_node("Round", [x], {"mode": "half_down"})
    y = b.parameter("y", (2, 3))
    with pytest.raises(ValueError, match="bad equation"):
        b._add_node("Einsum", [y], {"equation": "ij,jk->ik"})
    v = b.parameter("v", (16,))
    t = b.const(np.asarray([2, 8, 3], np.int64))
    am = b.const(np.asarray([1], np.int64))
    with pytest.raises(ValueError, match="pinned to target"):
        b._add_node("Broadcast", [v, t, am], {"mode": "explicit"})
    s = b.parameter("s", (1, 10, 2, 2))
    with pytest.raises(ValueError, match="not divisible"):
        b._add_node("ShuffleChannels", [s], {"axis": "1", "group": "3"})
    xr, lr = b.parameter("xr", (2, 5)), b.parameter("lr", (3,), dtype=np.int32)
    with pytest.raises(ValueError, match="batch extent"):
        b._add_node("ReverseSequence", [xr, lr], {})


def test_builder_methods_match_jax():
    """The same public methods, with the same signatures."""
    import inspect

    names = {n for n in dir(JaxGraphBuilder) if not n.startswith("__")}
    assert names == {n for n in dir(GraphBuilder) if not n.startswith("__")}
    for n in names:
        a, b = getattr(JaxGraphBuilder, n), getattr(GraphBuilder, n)
        if callable(a):
            assert inspect.signature(a) == inspect.signature(b), n


@pytest.mark.parametrize("method", ["read_value", "assign", "proposal", "roi_align",
                                    "prior_box"])
def test_unported_op_types_raise_before_recording(method):
    """The builder methods of the five op types the port once lacked now
    record what the JAX builder's record: the same node (type, name,
    attributes, port shapes and dtypes) and edges, and the same bytes."""
    def build(cls):
        b = cls("u")
        x = b.parameter("x", (1, 18, 8, 8))
        d = b.parameter("d", (1, 36, 8, 8))
        rois = b.parameter("rois", (5, 4))
        idx = b.parameter("idx", (5,), dtype=np.int32)
        info = b.const(np.asarray([128.0, 128.0, 1.0], np.float32))
        call = {"read_value": lambda: b.read_value(b.const(np.zeros((1, 4), np.float32)), "v"),
                "assign": lambda: b.assign(b.reshape(x, (1, -1)), "v"),
                "proposal": lambda: b.proposal(x, d, info, 16, 16, (0.5, 1.0, 2.0),
                                               (8.0, 16.0, 32.0), post_nms_topn=20),
                "roi_align": lambda: b.roi_align(x, rois, idx, 2, 3, spatial_scale=0.25),
                "prior_box": lambda: b.prior_box((8, 8), (64, 64), (16.0,), (32.0,), (2.0,),
                                                 flip=True, step=8.0)}[method]
        out = call()
        for i, port in enumerate(out if isinstance(out, (list, tuple)) else [out]):
            if port is not None:
                b.result(port, f"out{i}")
        return b.build()

    port, jax = build(GraphBuilder), build(JaxGraphBuilder)
    assert serialize_ir(port) == jax_serialize(jax)
    assert sorted(port.nodes) == sorted(jax.nodes)
    for nid, jn in jax.nodes.items():
        pn = port.nodes[nid]
        assert (pn.op_type, pn.name, pn.attrs) == (jn.op_type, jn.name, jn.attrs)
        for mine, theirs in ((pn.inputs, jn.inputs), (pn.outputs, jn.outputs)):
            assert {k: (tuple(v.shape), np.dtype(v.dtype)) for k, v in mine.items()} == {
                k: (tuple(v.shape), np.dtype(v.dtype)) for k, v in theirs.items()}
    assert [dataclasses.astuple(e) for e in port.edges] == [dataclasses.astuple(e) for e in jax.edges]
    assert method in ("assign", "read_value") or port.find_by_type(
        {"proposal": "Proposal", "roi_align": "ROIAlign", "prior_box": "PriorBox"}[method])


def test_built_graph_runs_through_iecore(tmp_path):
    """GraphBuilder → write_ir_model → IECore.read_network → load_network on
    the CPU, the path ``chip_smoke.py`` phase 4e takes on the card."""
    from pyopenvino_tpu_torch import IECore
    from pyopenvino_tpu_torch.ir.writer import write_ir_model

    model, rec = op_graphs.build(GraphBuilder, "heads", width=WIDTH)
    xml = str(tmp_path / "heads.xml")
    write_ir_model(model, xml)
    ie = IECore()
    exe = ie.load_network(ie.read_network(xml), "CPU")
    feed = _feeds(rec, 4)
    got = exe.infer(feed)
    want = Interpreter(model).run(feed)
    for k in want:
        agree(got[k], want[k], k in rec.loose)


def _control_flow(builder_cls):
    """A TensorIterator over an RNN body, a Loop to a condition with its
    iteration counter, and an If, built with ``builder_cls``."""
    rng = np.random.default_rng(11)
    body = builder_cls("body")
    xt, h = body.parameter("x_t", (2, 1, 3)), body.parameter("h_in", (2, 4))
    z = body.add(body.matmul(body.reshape(xt, (2, 3)), body.const(
        rng.standard_normal((3, 4)).astype(np.float32))), body.matmul(h, body.const(
            rng.standard_normal((4, 4)).astype(np.float32))))
    h2 = body.tanh(z)
    body.result(h2, "h_out")
    body.result(body.reshape(h2, (2, 1, 4)), "y_out")
    lb = builder_cls("lbody")
    it, s = lb.parameter("iter", (), dtype=np.int32), lb.parameter("s_in", (1, 1))
    s2 = lb.add(s, lb.reshape(lb.convert(it, "f32"), (1, 1)))
    lb.result(s2, "s_out")
    lb.result(lb.reshape(lb._add_node("Less", [s2, lb.const(np.full((1, 1), 7.0, np.float32))],
                                      {}, out_dtype=np.bool_), ()), "cond")
    tb, eb = builder_cls("then"), builder_cls("else")
    tb.result(tb.relu(tb.parameter("xa", (2, 4))), "r")
    eb.result(eb.unary("Negative", eb.parameter("xb", (2, 4))), "r")
    b = builder_cls("flow")
    x, h0 = b.parameter("x", (2, 5, 3)), b.parameter("h0", (2, 4))
    ys, last = b.tensor_iterator([x, h0], body.build(), input_map=[("x_t", {"axis": 1}), "h_in"],
                                 output_map=[("y_out", {"axis": 1}), "h_out"],
                                 back_edges=[("h_out", "h_in")])
    b.result(ys, "ys")
    s0 = b.parameter("s0", (1, 1))
    b.result(b.loop(b.const(np.asarray(-1, np.int64).reshape(())),
                    b.const(np.asarray(True).reshape(())), [s0], lb.build(),
                    input_map=["s_in"], output_map=["s_out"], back_edges=[("s_out", "s_in")],
                    current_iteration="iter", condition_result="cond"), "count")
    c = b.parameter("c", (), dtype=np.bool_)
    b.result(b.if_op(c, [last], tb.build(), eb.build(), ["xa"], ["xb"], ["r"], ["r"]), "branch")
    return b.build()


def test_control_flow_builders_write_the_same_bytes():
    """The port's tensor_iterator, loop and if_op build what the JAX
    builder's do: the same bytes through either writer, the same answers."""
    port_model = _control_flow(GraphBuilder)
    assert serialize_ir(port_model) == jax_serialize(_control_flow(JaxGraphBuilder))
    rng = np.random.default_rng(12)
    feed = {"x": rng.standard_normal((2, 5, 3)).astype(np.float32),
            "h0": rng.standard_normal((2, 4)).astype(np.float32),
            "s0": np.zeros((1, 1), np.float32), "c": np.asarray(False)}
    got = compile_model(port_model, Config(), device="cpu")(feed)
    want = Interpreter(port_model).run(feed)
    for k in want:
        agree(got[k], want[k])
