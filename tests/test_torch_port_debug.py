"""The port's per-layer debugging surface against the JAX package's:
``CompiledNetwork.capture_activations``, ``verify_against_interpreter``
and ``profile``; ``ExecutableNetwork.expected_result`` /
``last_compare_failures`` and ``get_perf_counts`` (with
``InferRequest.get_perf_counts``); the interpreter's ``last_timings``,
``expected_result`` and ``capture_node_args``; ``runtime/profiling.py``'s
``aggregate``, ``node_scope`` and ``format_table``; ``utils/compare.py``
and ``utils/platform.py``.

The cases of ``tests/test_debug_api.py`` (capture, verify passing and a
planted divergence, ``expected_result`` on both paths, perf counts),
``tests/test_profiling.py``'s aggregate cases and the verify case of
``tests/test_stateful.py`` run here on ``assets/trained/mnist_bn`` and
``shapes_resnet`` with seeded images.  The port's compiled path captures a
fused chain under its last node (the JAX package's capture build runs
unfused), so the port compares the names it emits and skips those it fused
away or folded, as the JAX verify skips folded ones.  On a CPU network
``profile`` credits each top-level operator's host time to its node's
range; the rows and ``"(unattributed)"`` add up to the profiler's total."""

import numpy as np
import pytest
import torch

from pyopenvino_tpu import IECore as JaxIECore
from pyopenvino_tpu.config import Backend as JaxBackend
from pyopenvino_tpu.config import Config as JaxConfig
from pyopenvino_tpu.ir import read_ir_model as jax_read
from pyopenvino_tpu.ir.builder import GraphBuilder as JaxGraphBuilder
from pyopenvino_tpu.runtime import profiling as jax_profiling
from pyopenvino_tpu.runtime.compiler import compile_model as jax_compile_model
from pyopenvino_tpu.runtime.interpreter import Interpreter as JaxInterpreter
from pyopenvino_tpu.utils import compare as jax_compare

from pyopenvino_tpu_torch import IECore, InferRequest
from pyopenvino_tpu_torch.config import Backend, Config
from pyopenvino_tpu_torch.ir import read_ir_model
from pyopenvino_tpu_torch.ir.builder import GraphBuilder
from pyopenvino_tpu_torch.runtime import profiling
from pyopenvino_tpu_torch.runtime.compiler import CompiledNetwork, compile_model
from pyopenvino_tpu_torch.runtime.interpreter import Interpreter
from pyopenvino_tpu_torch.utils import compare, select_device
from test_torch_port_export import MNIST, RESNET, _images
from test_torch_port_state import dynamic_init_model, ema_model
import test_torch_port_threads  # noqa: F401  (this worker's torch threads)

IN = "conv2d_input"
# tests/test_profiling.py's synthetic rows (the JAX package's form)
JAX_ROWS = [
    {"category": "convolution", "hlo_op": "fusion.1",
     "framework_op": "jit(fn)/Convolution_5/conv_general_dilated:",
     "occurrences": 2, "self_us": 100.0, "bound_by": "Compute"},
    {"category": "convolution", "hlo_op": "fusion.2",
     "framework_op": "jit(fn)/Convolution_9/conv_general_dilated:",
     "occurrences": 1, "self_us": 50.0, "bound_by": "HBM"},
    {"category": "loop fusion", "hlo_op": "fusion.3",
     "framework_op": "jit(fn)/MaxPool_7/reduce_window:",
     "occurrences": 1, "self_us": 25.0, "bound_by": "HBM"},
    {"category": "copy", "hlo_op": "copy.1", "framework_op": "",
     "occurrences": 3, "self_us": 25.0, "bound_by": "HBM"},
]
# the same work in the port's form (CompiledNetwork.profile's rows)
PORT_ROWS = [
    {"node": "Convolution_5", "category": "conv2d_direct", "self_us": 60.0,
     "occurrences": 1, "kernel": "conv2d_direct_i8_kernel"},
    {"node": "Convolution_5", "category": "elementwise", "self_us": 40.0,
     "occurrences": 1, "kernel": "vectorized_elementwise_kernel"},
    {"node": "Convolution_9", "category": "fused_gemm_i8i8", "self_us": 50.0,
     "occurrences": 1, "kernel": "i8i8_mma_kernel"},
    {"node": "MaxPool_7", "category": "pool", "self_us": 25.0, "occurrences": 1,
     "kernel": "max_pool_forward_nhwc"},
    {"node": None, "category": "copy", "self_us": 25.0, "occurrences": 3,
     "kernel": "Memcpy HtoD (Pageable -> Device)"},
]


@pytest.fixture(scope="module")
def mnist():
    """(port network on the CPU, TORCH; JAX network, XLA), the same IR."""
    return (compile_model(read_ir_model(*MNIST), Config(), device="cpu"),
            jax_compile_model(jax_read(*MNIST), JaxConfig(backend=JaxBackend.XLA)))


def _chain_ends(net, types=("Convolution",)):
    """Names of the last nodes of the fused chains whose root is one of
    ``types``: what the port captures for those roots."""
    return sorted(net.model.nodes[f.out_key[0]].name for f in net._fusions.values()
                  if net.model.nodes[f.root].op_type in types)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# -- tests/test_debug_api.py ---------------------------------------------------------

def test_capture_activations(mnist):
    port, jax = mnist
    names = _chain_ends(port) + [n.name for n in port.model if n.op_type == "MaxPool"]
    assert len(names) == 5
    x = _images(1, 0)[0]
    acts = port.capture_activations({IN: x}, names)
    want = jax.capture_activations({IN: x}, names)
    assert set(acts) == set(want) == set(names)
    for name, arr in acts.items():
        assert arr.ndim == 4 and np.isfinite(arr).all()
        assert arr.shape == want[name].shape
        assert _rel(arr, want[name]) < 1e-5, name
    # a root whose value lives in its epilogue has none of its own
    fused_root = next(port.model.nodes[r].name for r in port._fusions)
    assert fused_root not in port.emitted_names()
    with pytest.raises(KeyError, match="fused"):
        port.capture_activations({IN: x}, [fused_root])


@pytest.mark.parametrize("backend", ["torch", "kernels"])
@pytest.mark.parametrize("which", ["mnist_bn", "shapes_resnet"])
def test_verify_against_interpreter_passes(which, backend):
    paths = MNIST if which == "mnist_bn" else RESNET
    net = compile_model(read_ir_model(*paths), Config(backend=Backend(backend)), device="cpu")
    p = net.model.parameters[0]
    x = _images(1, 1, p.outputs[p.out_port].shape)[0]
    diffs = net.verify_against_interpreter({p.name: x})
    runs = {n.name for n in net.model if n.op_type not in ("Const", "Parameter", "Result")}
    assert set(diffs) == runs & net.emitted_names()
    assert len(diffs) >= 5 and max(diffs.values()) < 1e-3
    if which == "mnist_bn" and backend == "torch":
        jdiffs = jax_compile_model(jax_read(*paths), JaxConfig(backend=JaxBackend.XLA)
                                   ).verify_against_interpreter({p.name: x})
        assert set(diffs) <= set(jdiffs)
        for name, d in diffs.items():
            assert d <= max(10 * jdiffs[name], 1e-4), name


def test_verify_catches_divergence():
    """A weight changed on the device after compile (the interpreter reads
    the IR's) fails the per-layer check, and names the layer."""
    c = compile_model(read_ir_model(*MNIST), Config(), device="cpu")
    key = next(k for k, v in c.weights.items() if v.dim() == 4)
    c.weights[key] = c.weights[key] + 1.0
    with pytest.raises(AssertionError, match="layer mismatches vs interpreter"):
        c.verify_against_interpreter({IN: _images(1, 2)[0]})


def test_verify_against_interpreter_stateful():
    """tests/test_stateful.py's case: from the initial state on both sides,
    and again after calls have moved the state; a dynamic init too."""
    x = np.ones((1, 3), np.float32)
    for make, inp in ((ema_model, x), (dynamic_init_model, np.ones((1, 4), np.float32))):
        net = compile_model(make(GraphBuilder), device="cpu")
        diffs = net.verify_against_interpreter({"x": inp})
        jdiffs = jax_compile_model(make(JaxGraphBuilder), JaxConfig(
            backend=JaxBackend.XLA)).verify_against_interpreter({"x": inp})
        assert diffs and set(diffs) <= set(jdiffs)
        for _ in range(3):
            net.infer({"x": inp})
        assert net.verify_against_interpreter({"x": inp}) == diffs


def test_expected_result_on_both_paths(mnist):
    """The golden hook on the compiled path (one run: results and the
    named activations) and on the interpreter, against the JAX package's
    interpreter on the same goldens."""
    port, _ = mnist
    x = _images(1, 3)[0]
    name = _chain_ends(port)[0]
    golden = port.capture_activations({IN: x}, [name])[name]
    mul = next(n for n in read_ir_model(*MNIST) if n.op_type == "Multiply")
    folded, zeros = mul.name, np.zeros(mul.outputs[mul.out_port].shape, np.float32)
    ie = IECore()
    exe = ie.load_network(ie.read_network(*MNIST), "CPU")
    want = exe.infer({IN: x})
    exe.expected_result = {name: golden, folded: zeros}
    out = exe.infer({IN: x})
    for k in want:
        np.testing.assert_array_equal(out[k], want[k])
    assert exe.last_compare_failures == []  # the folded Multiply is skipped
    exe.expected_result = {name: -golden - 1e3}
    exe.infer({IN: x})
    assert exe.last_compare_failures == [name]
    # the (precision, dims, array) record form
    exe.expected_result = {name: ("FP32", golden.shape, golden.ravel())}
    exe.infer({IN: x})
    assert exe.last_compare_failures == []

    # the interpreter, against the JAX interpreter
    exe.kernel_type = "numpy"
    jit = JaxInterpreter(jax_read(*MNIST))
    for goldens in ({name: golden}, {name: -golden - 1e3, folded: zeros}):
        exe.expected_result = goldens
        exe.infer({IN: x})
        jit.expected_result = goldens
        jit.run({IN: x})
        assert exe.last_compare_failures == jit.last_compare_failures
    assert sorted(exe.last_compare_failures) == sorted([name, folded])


def test_interpreter_hooks_match_jax():
    """last_timings, capture_node_args and expected_result of the port's
    interpreter against the JAX interpreter's on one IR."""
    model, jmodel = read_ir_model(*MNIST), jax_read(*MNIST)
    it, jit = Interpreter(model), JaxInterpreter(jmodel)
    convs = [n.id for n in model if n.op_type == "Convolution"]
    it.capture_node_args = jit.capture_node_args = convs
    x = _images(1, 4)[0]
    out, jout = it.run({IN: x}), jit.run({IN: x})
    for k in jout:
        np.testing.assert_array_equal(out[k], jout[k])
    assert [t[:3] for t in it.last_timings] == [t[:3] for t in jit.last_timings]
    assert all(t[3] >= 0.0 for t in it.last_timings)
    assert [n.id for n, _ in it.captured] == [n.id for n, _ in jit.captured] == convs
    for (_, ins), (_, jins) in zip(it.captured, jit.captured):
        assert sorted(ins) == sorted(jins)
        for p in ins:
            np.testing.assert_array_equal(ins[p], jins[p])
    assert it.last_compare_failures == []


def test_perf_counts_interpreter():
    ie, jie = IECore(), JaxIECore()
    exe = ie.load_network(ie.read_network(*MNIST), "CPU")
    exe.kernel_type = "numpy"
    jexe = jie.load_network(jie.read_network(*MNIST), "CPU")
    with pytest.raises(RuntimeError, match="infer"):
        exe.get_perf_counts()  # nothing ran yet
    x = _images(1, 5)[0]
    exe.infer({IN: x})
    jexe.infer({IN: x})
    counts, jcounts = exe.get_perf_counts(), jexe.get_perf_counts()
    assert sorted(counts) == sorted(jcounts)
    for name, row in counts.items():
        assert row["layer_type"] == jcounts[name]["layer_type"]
        assert (row["status"], row["exec_type"]) == ("EXECUTED", "numpy_ref")
        assert row["real_time_us"] >= 0.0
    assert sum(r["real_time_us"] for r in counts.values()) > 0.0


@pytest.mark.parametrize("backend", ["torch", "kernels"])
def test_perf_counts_compiled_on_the_cpu(backend):
    """A CPU network's counts: inputs required; every layer the JAX
    interpreter times (but Const, Parameter and Result) with its type;
    folded and fused layers NOT_RUN; each EXECUTED layer's time its node's
    rows, and the rows and the unattributed time the profiler's total."""
    ie, jie = IECore(), JaxIECore()
    exe = ie.load_network(ie.read_network(*MNIST), "CPU")
    exe.kernel_type = backend
    with pytest.raises(ValueError, match="inputs"):
        exe.get_perf_counts()
    x = _images(1, 6)[0]
    counts = exe.get_perf_counts({IN: x})
    jexe = jie.load_network(jie.read_network(*MNIST), "CPU")
    jexe.infer({IN: x})
    jcounts = {k: v for k, v in jexe.get_perf_counts().items()
               if v["layer_type"] not in ("Const", "Parameter", "Result")}
    assert sorted(counts) == sorted(jcounts)
    for name, row in counts.items():
        assert row["layer_type"] == jcounts[name]["layer_type"]
    net = exe.compiled()
    fused = {net.model.nodes[i].name for f in net._fusions.values() for i in f.skip}
    for name, row in counts.items():
        node = exe.ienet.model.find_by_name(name)
        ran = node.id in net.model.nodes and name not in fused
        assert row["status"] == ("EXECUTED" if ran else "NOT_RUN"), name
        if node.op_type in ("Convolution", "MatMul", "MaxPool", "SoftMax"):
            assert row["status"] == "EXECUTED" and row["exec_type"].startswith("aten::"), name
    assert {r["layer_type"] for r in counts.values() if r["status"] == "NOT_RUN"} == {
        "Multiply", "Add", "ReLU"}
    rows = net.profile({IN: x})
    agg = profiling.aggregate(rows, by="node")
    total = sum(r["self_us"] for r in rows)
    assert total == pytest.approx(net.last_profile_us, rel=1e-9)
    assert sum(r["self_us"] for r in agg) == pytest.approx(total, rel=1e-3)
    scopes = {r["node"] for r in agg} - {"(unattributed)"}
    assert scopes == {f"{n.op_type}_{n.id}" for n in net.model
                      if n.op_type not in ("Const", "Parameter", "Result")
                      and n.id not in net._folded_nodes | net._fused_skip}
    # InferRequest delegates to its network
    req = InferRequest(exe).get_perf_counts({IN: x})
    assert sorted(req) == sorted(counts)
    assert {k: v["status"] for k, v in req.items()} == {k: v["status"] for k, v in counts.items()}


def test_perf_counts_empty_profile_raises(monkeypatch):
    """An empty profile never reads as 'every layer NOT_RUN'."""
    ie = IECore()
    exe = ie.load_network(ie.read_network(*MNIST), "CPU")
    monkeypatch.setattr(CompiledNetwork, "profile", lambda self, inputs, batch_size=None: [])
    with pytest.raises(RuntimeError, match="empty"):
        exe.get_perf_counts({IN: _images(1, 7)[0]})


def test_profile_ranges_only_while_profiling(mnist):
    """A normal infer enters no node range; profile does, at B = 1 and for a
    batch, and leaves them off again."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    port, _ = mnist
    x = _images(1, 8)[0]
    with torch_profile(activities=[ProfilerActivity.CPU]) as prof:
        port.infer({IN: x})
    assert not [e for e in prof.events() if profiling.node_scope({"node": e.name})
                and profiling._RANGE_RE.match(e.name)]
    rows = port.profile({IN: x})
    assert not port._ranges and rows
    batch = np.concatenate(_images(4, 9))
    brows = port.profile({IN: batch}, batch_size=4)
    assert {r["node"] for r in brows} == {r["node"] for r in rows}
    assert port.last_profile_us > 0


# -- tests/test_profiling.py -------------------------------------------------------

def test_aggregate_matches_jax_on_jax_rows():
    for by in ("category", "node"):
        got = profiling.aggregate(JAX_ROWS, by)
        want = jax_profiling.aggregate(JAX_ROWS, by)
        assert [{k: v for k, v in r.items() if k != "kernel"} for r in got] == want
    assert profiling.node_scope(JAX_ROWS[2]) == jax_profiling.node_scope(JAX_ROWS[2]) == "MaxPool_7"
    assert profiling.format_table(profiling.aggregate(JAX_ROWS)) == jax_profiling.format_table(
        jax_profiling.aggregate(JAX_ROWS))


def test_aggregate_by_category():
    agg = profiling.aggregate(PORT_ROWS, "category")
    assert agg[0]["category"] == "conv2d_direct" and agg[0]["self_us"] == 60.0
    assert agg[0]["pct"] == 30.0 and agg[0]["kernel"] == "conv2d_direct_i8_kernel"
    assert abs(sum(r["pct"] for r in agg) - 100.0) < 0.1


def test_aggregate_by_node_scope():
    agg = profiling.aggregate(PORT_ROWS, "node")
    assert [r["node"] for r in agg] == ["Convolution_5", "Convolution_9", "MaxPool_7",
                                        "(unattributed)"]
    conv = agg[0]
    assert (conv["self_us"], conv["occurrences"], conv["kernel"]) == (
        100.0, 2, "conv2d_direct_i8_kernel")
    assert profiling.node_scope(PORT_ROWS[3]) == "MaxPool_7"
    assert profiling.node_scope(PORT_ROWS[4]) is None
    # the port's kernel names the layer, quantization beside it aside
    assert profiling.exec_types(PORT_ROWS) == {
        "Convolution_5": ("conv2d_direct", 100.0), "Convolution_9": ("fused_gemm_i8i8", 50.0),
        "MaxPool_7": ("max_pool_forward_nhwc", 25.0)}


def test_format_table_runs():
    out = profiling.format_table(profiling.aggregate(PORT_ROWS, "category"))
    assert "conv2d_direct" in out and "30.00" in out
    assert "Convolution_5" in profiling.format_table(profiling.aggregate(PORT_ROWS, "node"),
                                                     by="node")


# -- utils ---------------------------------------------------------------------------

def test_compare_helpers_match_jax(capsys):
    arr = np.arange(6, dtype=np.float32).reshape(2, 3)
    for want in (arr, ("FP32", (2, 3), arr.ravel()), ("FP32", (), arr)):
        np.testing.assert_array_equal(compare.golden_array(want), jax_compare.golden_array(want))
    for got, rtol in ((arr, 1.0), (arr + 1e3, 1.0), (arr * 1.01, 1e-3), (arr * 1.01, 0.1)):
        assert compare.compare_golden("n", got, arr, rtol=rtol) == jax_compare.compare_golden(
            "n", got, arr, rtol=rtol)
    assert compare.compare_golden("layer", arr, arr, verbose=True)
    assert "layer : (2, 3) / (2, 3) MATCH" in capsys.readouterr().out


def test_select_device():
    assert select_device("cpu") == torch.device("cpu")
    assert select_device("CPU").type == "cpu"
    with pytest.raises(ValueError, match="unknown device"):
        select_device("tpu")
    if torch.cuda.is_available():
        assert select_device("gpu").type == select_device("auto").type == "cuda"
    else:
        for name in ("gpu", "auto"):
            with pytest.raises(RuntimeError, match="CUDA"):
                select_device(name)


def test_node_rows_credit_device_activity_by_correlation():
    """node_rows on a CUDA network's events (synthetic here): each host
    event's correlated activities (``kernels``) go to the innermost node
    range around it, an id two host events share counts once, a range's
    device-side span is no activity, a range that launched nothing is
    host_only, what no range encloses is unattributed, and a host event
    that is no operator (a CUDA API call, the profiler's own) launches
    nothing even where its id is a range's."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    def host(eid, name, parent=None, kernels=()):
        return SimpleNamespace(id=eid, name=name, cpu_parent=parent, device_type=DeviceType.CPU,
                               kernels=[SimpleNamespace(name=n, duration=us) for n, us in kernels])

    launched = [("conv2d_direct_i8_wgmma<ConvAIm2col>", 30.0), ("Convolution_5", 45.0)]
    conv = host(1, "Convolution_5", kernels=launched)
    quant = host(2, "aten::round", conv, kernels=[("vectorized_elementwise_kernel", 4.0)])
    reshape = host(3, "Reshape_7")
    copy = host(4, "aten::copy_", kernels=[("Memcpy HtoD (Pageable -> Device)", 16.0)])
    twin = host(4, "aten::to", kernels=[("Memcpy HtoD (Pageable -> Device)", 16.0)])
    # another numbering's event with a range's id: the range keeps its own
    other = host(1, "Activity Buffer Request", copy, kernels=launched)
    device = SimpleNamespace(name="conv2d_direct_i8_wgmma<ConvAIm2col>", device_type=DeviceType.CUDA,
                             time_range=SimpleNamespace(elapsed_us=lambda: 30.0))
    span = SimpleNamespace(name="Convolution_5", device_type=DeviceType.CUDA,
                           time_range=SimpleNamespace(elapsed_us=lambda: 45.0))
    rows = profiling.node_rows([conv, quant, reshape, copy, twin, other, device, span], cuda=True)
    got = sorted((r["node"] or "", r["kernel"], r["self_us"], r["occurrences"]) for r in rows)
    assert got == [("", "Memcpy HtoD (Pageable -> Device)", 16.0, 1),
                   ("Convolution_5", "conv2d_direct_i8_wgmma<ConvAIm2col>", 30.0, 1),
                   ("Convolution_5", "vectorized_elementwise_kernel", 4.0, 1),
                   ("Reshape_7", "", 0.0, 0)]
    assert profiling.device_us([device, span, conv]) == 30.0
    assert profiling.exec_types(rows)["Convolution_5"] == ("conv2d_direct", 34.0)
    assert profiling.exec_types(rows)["Reshape_7"] == ("host_only", 0.0)
