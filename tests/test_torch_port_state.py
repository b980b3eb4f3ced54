"""Stateful inference in the port (ReadValue/Assign, ``ops/state_ops.py``;
the state of ``runtime/interpreter.py`` and ``runtime/compiler.py``; the
API's ``query_state``, ``reset_state``, ``VariableState`` and
``IENetwork.reshape``) against the JAX package.

Every case of ``tests/test_stateful.py`` that needs no InferRequest,
AsyncInferQueue, export or ``verify_against_interpreter`` runs here through
both packages on graphs that both GraphBuilders build node for node: the
accumulator, the EMA, const and dynamic init, set and reset, a read-only
variable, the guards, pruning, the IR round trip, the batch-baked lockstep
and the delay line (an Assign before its ReadValue).  The per-request state
that InferRequest will carry (``fresh_state``, ``step``) is tested on its
own.  ``models/op_graphs.py``'s ``lstm_stream`` (hidden 16) runs 4 chunks
against the JAX package in three modes: FP32 and INT8 weight-only within
RTOL of the largest output, INT8-FULL's logits bit for bit with XLA's fused
multiply-add epilogue (ROADMAP.md §3 fault 1; its probabilities and states
within RTOL: the softmax's and the recurrences' float32 exp, tanh and
logistic differ from XLA's in the last bits, fault 7); its 4 chunks of 8 frames
equal one stateless 32-frame run of the same weights."""

import numpy as np
import pytest

from pyopenvino_tpu.config import Backend as JaxBackend
from pyopenvino_tpu.config import Config as JaxConfig
from pyopenvino_tpu.config import QuantMode as JaxQuantMode
from pyopenvino_tpu.ir.builder import GraphBuilder as JaxGraphBuilder
from pyopenvino_tpu.passes.shape_infer import reshape_model as jax_reshape_model
from pyopenvino_tpu.runtime.compiler import compile_model as jax_compile_model
from pyopenvino_tpu.runtime.interpreter import Interpreter as JaxInterpreter

from pyopenvino_tpu_torch import IECore, IENetwork
from pyopenvino_tpu_torch.config import Backend, Config, QuantMode
from pyopenvino_tpu_torch.ir.builder import GraphBuilder
from pyopenvino_tpu_torch.models import op_graphs
from pyopenvino_tpu_torch.passes.shape_infer import reshape_model
from pyopenvino_tpu_torch.passes.util import prune_dead_nodes
from pyopenvino_tpu_torch.runtime.compiler import compile_model
from pyopenvino_tpu_torch.runtime.interpreter import Interpreter
from test_torch_port_int8full import xla_fma_epilogue
import test_torch_port_threads  # noqa: F401  (this worker's torch threads)

RTOL = 1e-5


def port_compile(model, calibration_samples=None, **config):
    return compile_model(model, Config(**config), device="cpu",
                         calibration_samples=calibration_samples)


def jax_compile(model, calibration_samples=None, **config):
    return jax_compile_model(model, JaxConfig(backend=JaxBackend.XLA, **config),
                             calibration_samples=calibration_samples)


def accumulator_model(cls, shape=(1, 4), init=None):
    """out = x + var; var' = out (a running sum across inferences)."""
    b = cls("acc")
    x = b.parameter("x", shape)
    init_c = b.const(np.zeros(shape, np.float32) if init is None else init, name="init")
    v = b.read_value(init_c, "acc_var", name="read")
    s = b.add(x, v, name="sum")
    b.assign(s, "acc_var", name="write")
    b.result(s, name="out")
    return b.build()


def ema_model(cls, shape=(1, 3), alpha=0.25):
    """y = a·x + (1 − a)·var; var' = y."""
    b = cls("ema")
    x = b.parameter("x", shape)
    v = b.read_value(b.const(np.zeros(shape, np.float32), name="init"), "ema", name="read")
    ax = b.multiply(x, b.const(np.float32(alpha)), name="ax")
    av = b.multiply(v, b.const(np.float32(1 - alpha)), name="av")
    y = b.add(ax, av, name="y")
    b.assign(y, "ema", name="write")
    b.result(y, name="out")
    return b.build()


def dynamic_init_model(cls, shape=(1, 4)):
    """An init that depends on the input: var is 2·x at the first infer
    after a reset, then var' = var + x."""
    b = cls("dyn")
    x = b.parameter("x", shape)
    init = b.multiply(x, b.const(np.float32(2.0)), name="init2x")
    v = b.read_value(init, "m", name="read")
    s = b.add(v, x, name="s")
    b.assign(s, "m", name="write")
    b.result(s, name="out")
    return b.build()


def delay_line_model(cls):
    """An Assign before its ReadValue in topological order: out = v
    (dynamic init 2·x), v' = 3·x."""
    b = cls("delay")
    x = b.parameter("x", (1, 4))
    b.assign(b.multiply(x, b.const(np.float32(3.0)), name="a3"), "v", name="write")
    v = b.read_value(b.multiply(x, b.const(np.float32(2.0)), name="init2x"), "v", name="read")
    b.result(b.add(v, b.const(np.zeros((1, 4), np.float32)), name="o"), name="out")
    return b.build()


def both(make, *args, **kw):
    return make(GraphBuilder, *args, **kw), make(JaxGraphBuilder, *args, **kw)


def test_interpreter_accumulates():
    port, jax = both(accumulator_model)
    its = Interpreter(port), JaxInterpreter(jax)
    x = np.ones((1, 4), np.float32)
    for step in range(1, 4):
        for it in its:
            np.testing.assert_array_equal(it.run({"x": x})["out"], step * x)
    for it in its:
        it.reset_state()
        np.testing.assert_array_equal(it.run({"x": x})["out"], x)


def test_compiled_accumulates_and_resets():
    port, jax = both(accumulator_model)
    nets = port_compile(port), jax_compile(jax)
    assert set(nets[0].variables) == set(nets[1].variables) == {"acc_var"}
    x = np.ones((1, 4), np.float32)
    for step in range(1, 4):
        for net in nets:
            np.testing.assert_array_equal(net.infer({"x": x})["out"], step * x)
    for net in nets:
        net.reset_state()
        np.testing.assert_array_equal(net.infer({"x": x})["out"], x)


def test_const_init_value_used():
    init = np.arange(4, dtype=np.float32).reshape(1, 4)
    port, jax = both(accumulator_model, init=init)
    x = np.ones((1, 4), np.float32)
    for out in (port_compile(port).infer({"x": x}), jax_compile(jax).infer({"x": x}),
                Interpreter(port).run({"x": x})):
        np.testing.assert_array_equal(out["out"], init + 1)


def test_differential_ema_sequence():
    rng = np.random.default_rng(0)
    seq = [rng.standard_normal((1, 3)).astype(np.float32) for _ in range(6)]
    port, jax = both(ema_model)
    net, jnet, it = port_compile(port), jax_compile(jax), Interpreter(port)
    for x in seq:
        got = net.infer({"x": x})["out"]
        np.testing.assert_allclose(got, jnet.infer({"x": x})["out"], rtol=RTOL, atol=1e-7)
        np.testing.assert_allclose(got, it.run({"x": x})["out"], rtol=RTOL, atol=1e-7)


def test_query_and_set_state():
    port, jax = both(accumulator_model)
    x = np.full((1, 4), 2.0, np.float32)
    for net in (port_compile(port), jax_compile(jax), Interpreter(port)):
        run = net.run if isinstance(net, Interpreter) else net.infer
        run({"x": x})
        np.testing.assert_array_equal(net.query_state()["acc_var"], x)
        net.set_state({"acc_var": np.full((1, 4), 10.0, np.float32)})
        np.testing.assert_array_equal(run({"x": x})["out"], 12.0)
        with pytest.raises(KeyError):
            net.set_state({"nope": x})


@pytest.mark.parametrize("kernel_type", ["pallas", "torch", "numpy"])
def test_api_variable_state(kernel_type):
    """query_state's VariableStates (name, state get and set, reset) and
    reset_state on each executor, as the JAX package's ExecutableNetwork
    gives them (its interpreter backend: test_api_interpreter_backend_state)."""
    from pyopenvino_tpu.api import IECore as JaxIECore
    from pyopenvino_tpu.api import IENetwork as JaxIENetwork

    port, jax = both(accumulator_model)
    exe = IECore().load_network(IENetwork(port), "CPU")
    exe.kernel_type = kernel_type
    jexe = JaxIECore().load_network(JaxIENetwork(jax), "CPU")
    assert exe.stateful and jexe.stateful
    x = np.ones((1, 4), np.float32)
    for e in (exe, jexe):
        e.infer({"x": x})
        e.infer({"x": x})
        states = e.query_state()
        assert [s.name for s in states] == ["acc_var"]
        np.testing.assert_array_equal(states[0].state, 2 * x)
        states[0].state = np.zeros((1, 4), np.float32)
        np.testing.assert_array_equal(e.infer({"x": x})["out"], x)
        states[0].reset()
        np.testing.assert_array_equal(e.infer({"x": x})["out"], x)
        e.reset_state()
        np.testing.assert_array_equal(e.query_state()[0].state, 0 * x)
    assert repr(exe.query_state()[0]) == "VariableState('acc_var')"


def test_readonly_variable_passes_through():
    def make(cls):
        b = cls("ro")
        x = b.parameter("x", (1, 4))
        v = b.read_value(b.const(np.full((1, 4), 3.0, np.float32)), "bias")
        b.result(b.add(x, v), name="out")
        return b.build()

    port, jax = both(make)
    xin = np.ones((1, 4), np.float32)
    for net in (port_compile(port), jax_compile(jax)):
        np.testing.assert_array_equal(net.infer({"x": xin})["out"], 4.0)
        np.testing.assert_array_equal(net.infer({"x": xin})["out"], 4.0)
        np.testing.assert_array_equal(net.query_state()["bias"], 3.0)


def test_stateful_guards():
    """A stateful network answers no batch of examples (the JAX package's
    batched_fn refuses the same)."""
    port, jax = both(accumulator_model)
    net = port_compile(port)
    with pytest.raises(NotImplementedError, match="IENetwork.reshape"):
        net.infer_batch({"x": np.ones((4, 1, 4), np.float32)})
    with pytest.raises(NotImplementedError):
        jax_compile(jax).batched_fn(4)
    assert net.state is None  # the refusal touched no state


def test_assign_subgraph_not_pruned():
    def make(cls):
        b = cls("p")
        x = b.parameter("x", (1, 4))
        v = b.read_value(b.const(np.zeros((1, 4), np.float32)), "m")
        b.result(b.add(x, v), name="out")
        b.assign(b.multiply(x, b.const(np.float32(2.0))), "m")
        return b.build()

    from pyopenvino_tpu.passes.util import prune_dead_nodes as jax_prune

    port, jax = both(make)
    model, dropped = prune_dead_nodes(port)
    assert dropped == jax_prune(jax)[1] == 0
    xin = np.ones((1, 4), np.float32)
    for net in (port_compile(model), jax_compile(jax)):
        np.testing.assert_array_equal(net.infer({"x": xin})["out"], 1.0)
        np.testing.assert_array_equal(net.infer({"x": xin})["out"], 3.0)
    # a branch that reaches neither a Result nor an Assign still goes
    b = GraphBuilder("dead")
    x = b.parameter("x", (1, 4))
    b.multiply(x, b.const(np.float32(5.0)))
    b.result(x, name="out")
    assert prune_dead_nodes(b.build())[1] == 2


def test_dynamic_init_interpreter_vs_compiled():
    rng = np.random.default_rng(1)
    seq = [rng.standard_normal((1, 4)).astype(np.float32) for _ in range(4)]
    port, jax = both(dynamic_init_model)
    net, jnet, it = port_compile(port), jax_compile(jax), Interpreter(port)
    assert net.variables["m"]["dynamic_init"] and jnet.variables["m"]["dynamic_init"]
    for x in seq:
        got = net.infer({"x": x})["out"]
        np.testing.assert_allclose(got, jnet.infer({"x": x})["out"], rtol=RTOL)
        np.testing.assert_allclose(got, it.run({"x": x})["out"], rtol=RTOL)
    for e in (net, jnet, it):
        e.reset_state()
    x = seq[2]
    np.testing.assert_allclose(net.infer({"x": x})["out"], 3 * x, rtol=RTOL)
    np.testing.assert_allclose(jnet.infer({"x": x})["out"], 3 * x, rtol=RTOL)
    np.testing.assert_allclose(it.run({"x": x})["out"], 3 * x, rtol=RTOL)


def test_dynamic_init_set_state_wins():
    port, jax = both(dynamic_init_model)
    x = np.ones((1, 4), np.float32)
    for net in (port_compile(port), jax_compile(jax)):
        net.set_state({"m": np.full((1, 4), 10.0, np.float32)})
        np.testing.assert_array_equal(net.infer({"x": x})["out"], 11.0)


def test_dynamic_init_reset_variable_rearms():
    port, jax = both(dynamic_init_model)
    x1, x2 = np.ones((1, 4), np.float32), np.full((1, 4), 2.0, np.float32)
    for net in (port_compile(port), jax_compile(jax), Interpreter(port)):
        run = net.run if isinstance(net, Interpreter) else net.infer
        run({"x": x1})                                   # var = 3
        net.reset_variable("m")                          # the next call recomputes the init
        np.testing.assert_array_equal(run({"x": x2})["out"], 6.0)   # 2·2 + 2
        with pytest.raises(KeyError):
            net.reset_variable("nope")


def test_per_request_state_step():
    """Two caller-owned states advance independently through ``step``, the
    network's own state untouched: the unit of a request's state.  A
    dynamic-init variable's fresh flag travels with its state."""
    net = port_compile(accumulator_model(GraphBuilder))
    r0, r1 = net.fresh_state(), net.fresh_state()
    x = np.ones((1, 4), np.float32)
    out, r0 = net.step({"x": x}, r0)
    np.testing.assert_array_equal(out["out"], 1.0)
    before = net.state_to_host(r0)
    out, r0_next = net.step({"x": x}, r0)
    np.testing.assert_array_equal(out["out"], 2.0)
    np.testing.assert_array_equal(net.state_to_host(r0)["acc_var"], before["acc_var"])  # kept
    out, r1 = net.step({"x": x}, r1)
    np.testing.assert_array_equal(out["out"], 1.0)
    np.testing.assert_array_equal(net.state_to_host(r0_next)["acc_var"], 2 * x)
    np.testing.assert_array_equal(net.state_to_host(net.state_with(r1, {"acc_var": 5 * x}))
                                  ["acc_var"], 5 * x)
    np.testing.assert_array_equal(net.state_to_host(net.state_with_reset(r0_next, "acc_var"))
                                  ["acc_var"], 0 * x)
    assert net.state is None
    dyn = port_compile(dynamic_init_model(GraphBuilder))
    fresh = dyn.fresh_state()
    assert fresh["m::fresh"] is True and set(dyn.state_to_host(fresh)) == {"m"}
    out, st = dyn.step({"x": x}, fresh)
    np.testing.assert_array_equal(out["out"], 3.0)
    assert st["m::fresh"] is False and fresh["m::fresh"] is True
    assert dyn.state_with_reset(st, "m")["m::fresh"] is True
    assert dyn.state_with(fresh, {"m": x})["m::fresh"] is False


def test_ir_roundtrip_stateful(tmp_path):
    from pyopenvino_tpu.ir.writer import serialize_ir as jax_serialize

    from pyopenvino_tpu_torch.ir.writer import serialize_ir, write_ir_model
    from pyopenvino_tpu_torch.ir.xml_parser import read_ir_model

    port, jax = both(accumulator_model)
    assert serialize_ir(port) == jax_serialize(jax)
    write_ir_model(port, str(tmp_path / "acc.xml"), str(tmp_path / "acc.bin"))
    re = read_ir_model(str(tmp_path / "acc.xml"), str(tmp_path / "acc.bin"))
    assert {n.attrs["variable_id"] for n in re.nodes.values()
            if n.op_type in ("ReadValue", "Assign")} == {"acc_var"}
    net = port_compile(re)
    x = np.ones((1, 4), np.float32)
    np.testing.assert_array_equal(net.infer({"x": x})["out"], x)
    np.testing.assert_array_equal(net.infer({"x": x})["out"], 2 * x)


def test_batch_baked_stateful_lockstep_parity():
    """IENetwork.reshape bakes N streams into a stateful IR: row i of the
    lockstep run equals stream i run alone, on the compiled path, the
    interpreter and the public API, and equals the JAX package's lockstep
    run."""
    n, steps = 4, 3
    xs = np.random.default_rng(7).standard_normal((steps, n, 3)).astype(np.float32)
    net = port_compile(reshape_model(ema_model(GraphBuilder), {"x": (n, 3)}))
    assert net.variables["ema"]["shape"] == (n, 3)
    lockstep = [net.infer({"x": xs[t]})["out"] for t in range(steps)]
    jnet = jax_compile(jax_reshape_model(ema_model(JaxGraphBuilder), {"x": (n, 3)}))
    for t in range(steps):
        np.testing.assert_allclose(jnet.infer({"x": xs[t]})["out"], lockstep[t], rtol=RTOL,
                                   atol=1e-7)
    for i in range(n):
        single = port_compile(ema_model(GraphBuilder))
        for t in range(steps):
            np.testing.assert_allclose(lockstep[t][i:i + 1],
                                       single.infer({"x": xs[t, i:i + 1]})["out"],
                                       rtol=RTOL, atol=1e-7)
    it = Interpreter(reshape_model(ema_model(GraphBuilder), {"x": (n, 3)}))
    ie = IECore()
    exe = ie.load_network(IENetwork(ema_model(GraphBuilder)).reshape({"x": (n, 3)}), "CPU")
    for t in range(steps):
        np.testing.assert_allclose(it.run({"x": xs[t]})["out"], lockstep[t], rtol=RTOL,
                                   atol=1e-7)
        np.testing.assert_allclose(exe.infer({"x": xs[t]})["out"], lockstep[t], rtol=RTOL,
                                   atol=1e-7)
    with pytest.raises(ValueError, match="not Parameter"):
        IENetwork(ema_model(GraphBuilder)).reshape({"y": (n, 3)})


def test_batch_baked_dynamic_init():
    n = 3
    xs = np.random.default_rng(9).standard_normal((2, n, 4)).astype(np.float32)
    net = port_compile(reshape_model(dynamic_init_model(GraphBuilder), {"x": (n, 4)}))
    jnet = jax_compile(jax_reshape_model(dynamic_init_model(JaxGraphBuilder), {"x": (n, 4)}))
    lock = [net.infer({"x": xs[t]})["out"] for t in range(2)]
    for t in range(2):
        np.testing.assert_allclose(jnet.infer({"x": xs[t]})["out"], lock[t], rtol=RTOL)
    for i in range(n):
        single = port_compile(dynamic_init_model(GraphBuilder))
        for t in range(2):
            np.testing.assert_allclose(lock[t][i:i + 1], single.infer({"x": xs[t, i:i + 1]})["out"],
                                       rtol=RTOL, atol=1e-7)


def test_assign_shape_mismatch_fails_fast():
    def make(cls):
        b = cls("bad")
        x = b.parameter("x", (2, 3))
        v = b.read_value(b.const(np.zeros((4, 3), np.float32)), "v", name="r")
        b.assign(b.add(x, b.const(np.zeros((2, 3), np.float32)), name="s"), "v", name="w")
        b.result(b.add(v, b.const(np.zeros((4, 3), np.float32)), name="o2"), name="out")
        return b.build()

    port, jax = both(make)
    for compile_ in (lambda: port_compile(port), lambda: jax_compile(jax)):
        with pytest.raises(ValueError, match="not a broadcast"):
            compile_()


def test_assign_emitted_before_readvalue_not_clobbered():
    port, jax = both(delay_line_model)
    order = [n.op_type for n in port]
    assert order.index("Assign") < order.index("ReadValue")  # the hazard
    net, jnet, it = port_compile(port), jax_compile(jax), Interpreter(port)
    xs = [np.random.default_rng(3).standard_normal((1, 4)).astype(np.float32)
          for _ in range(3)]
    xs = [x * (i + 1) for i, x in enumerate(xs)]
    for i, x in enumerate(xs):
        got = net.infer({"x": x})["out"]
        np.testing.assert_allclose(got, it.run({"x": x})["out"], rtol=RTOL, err_msg=f"step {i}")
        np.testing.assert_allclose(got, jnet.infer({"x": x})["out"], rtol=RTOL)
    # the first step read the dynamic init (2·x0), each later one the
    # previous step's assignment (3·x_{k-1})
    np.testing.assert_allclose(net.infer({"x": xs[0]})["out"], 3 * xs[2], rtol=RTOL)


def test_readvalue_is_never_folded():
    """A ReadValue of a Const init propagates no value: were it folded, every
    read would be frozen at the init."""
    net = port_compile(accumulator_model(GraphBuilder))
    read = net.model.find_by_name("read")
    assert read.id not in net._folded_nodes
    assert (read.id, read.out_port) not in net.analysis.values
    assert net.model.find_by_name("init").id not in net._runtime_consts


# -- lstm_stream (models/op_graphs.py) ---------------------------------------------------

WIDTH = 8          # hidden 16 (op_graphs.lstm_hidden)
CHUNKS = 4
MODES = {"none": (QuantMode.NONE, JaxQuantMode.NONE),
         "int8w": (QuantMode.INT8_WEIGHT, JaxQuantMode.INT8_WEIGHT),
         "int8": (QuantMode.INT8_FULL, JaxQuantMode.INT8_FULL)}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _chunks(rec, seed, n=CHUNKS):
    rng = np.random.default_rng(seed)
    return [rec.inputs(rng, 1) for _ in range(n)]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_lstm_stream_matches_jax(mode, monkeypatch):
    xla_fma_epilogue(monkeypatch)
    quant, jquant = MODES[mode]
    port, rec = op_graphs.build(GraphBuilder, "lstm_stream", width=WIDTH)
    jax, _ = op_graphs.build(JaxGraphBuilder, "lstm_stream", width=WIDTH)
    assert op_graphs.lstm_hidden(WIDTH) == 16
    cal = _chunks(rec, 100) if mode == "int8" else None
    nets = {"torch": port_compile(port, quant=quant, calibration_samples=cal),
            "kernels": port_compile(port, backend=Backend.KERNELS, quant=quant,
                                    calibration_samples=cal),
            "xla": jax_compile(jax, quant=jquant, calibration_samples=cal)}
    if mode == "int8":
        assert nets["torch"].act_scales == pytest.approx(nets["xla"].act_scales, rel=0, abs=0)
    for i, chunk in enumerate(_chunks(rec, 1)):
        out = {k: net.infer(chunk) for k, net in nets.items()}
        for k in ("logits", "probs"):
            for got in (out["torch"][k], out["kernels"][k]):
                if mode == "int8" and k == "logits":
                    np.testing.assert_array_equal(got, out["xla"][k], err_msg=f"chunk {i}")
                else:
                    assert _rel(got, out["xla"][k]) <= RTOL, (i, k)
    states = {k: net.query_state() for k, net in nets.items()}
    assert sorted(states["torch"]) == sorted(op_graphs.LSTM_VARIABLES)
    for vid, want in states["xla"].items():
        assert _rel(states["torch"][vid], want) <= RTOL and _rel(states["kernels"][vid], want) <= RTOL


def test_lstm_stream_chunks_equal_one_stateless_run():
    """Four chunks of 8 frames, each call on the previous call's state, give
    the answer and the state of one stateless run over the 32 frames."""
    port, rec = op_graphs.build(GraphBuilder, "lstm_stream", width=WIDTH)
    b = GraphBuilder("lstm_full")
    op_graphs.lstm_stream(b, np.random.default_rng(0), 1, WIDTH, frames=op_graphs.LSTM_FRAMES,
                          stateful=False)
    full = b.build()
    assert not full.find_by_type("ReadValue") and not full.find_by_type("Assign")
    chunks = _chunks(rec, 2)
    whole = {"x": np.concatenate([c["x"] for c in chunks], axis=1)}
    assert whole["x"].shape == (1, op_graphs.LSTM_FRAMES, op_graphs.LSTM_FEATURES)
    for make in (lambda m: port_compile(m), lambda m: port_compile(m, backend=Backend.KERNELS)):
        net = make(port)
        for c in chunks:
            got = net.infer(c)
        want = make(full).infer(whole)
        for k in want:
            assert _rel(got[k], want[k]) <= 1e-6, k
    it = Interpreter(port)
    for c in chunks:
        got = it.run(c)
    want = Interpreter(full).run(whole)
    for k in want:
        assert _rel(got[k], want[k]) <= 1e-6, k


def test_lstm_stream_lockstep_and_reset():
    """64 streams reshaped into the IR in lockstep: rows equal streams run
    alone; reset_state starts every stream again; infer_batch refuses."""
    port, rec = op_graphs.build(GraphBuilder, "lstm_stream", width=WIDTH)
    n = 64
    rng = np.random.default_rng(4)
    xs = [rec.inputs(rng, n) for _ in range(CHUNKS)]
    exe = IECore().load_network(IENetwork(port).reshape({"x": (n, op_graphs.CHUNK,
                                                              op_graphs.LSTM_FEATURES)}), "CPU")
    lock = [exe.infer(x)["probs"] for x in xs]
    assert {s.state.shape for s in exe.query_state()} == {(n, 1, 16)}
    for i in (0, 37):
        single = port_compile(port)
        for t, x in enumerate(xs):
            assert _rel(lock[t][i:i + 1], single.infer({"x": x["x"][i:i + 1]})["probs"]) <= RTOL
    exe.reset_state()
    np.testing.assert_allclose(exe.infer(xs[0])["probs"], lock[0], rtol=RTOL, atol=1e-7)
    with pytest.raises(NotImplementedError):
        port_compile(port).infer_batch({"x": xs[0]["x"][:, None]})
