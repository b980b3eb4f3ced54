"""The port's async request API (``InferRequest``, ``AsyncInferQueue``,
``CompiledModel``, ``Core`` and the async half of ``ExecutableNetwork`` in
``pyopenvino_tpu_torch/api.py``) against the JAX package's, XLA backend, on
the CPU.

Every case of ``tests/test_async_queue.py`` runs here through both packages
on ``assets/trained/mnist_bn`` and seeded images (that file reads the MNIST
image from outside the repository): callbacks with userdata, slots that
block when full, a submit-time error that returns its slot, indexable
requests, a legacy ExecutableNetwork.  So do the three InferRequest cases of
``tests/test_stateful.py`` on the accumulator both GraphBuilders build (each
request's own state, four requests stepped from four threads, the queue
inline on a stateful network), and ``models/op_graphs.py``'s lstm_stream
stepped by two requests from two threads against each stream alone and the
JAX package's requests.  Answers are held to the families' limits:
``mnist_bn`` TORCH against XLA 1e-4 / 1e-5, lstm_stream 1e-5 of the largest
output (``test_torch_port_state.py``).  Also: ``__all__`` equal to the JAX
package's, the AST scan over ``serving/``, ``IECore.get_metric``,
``query_network`` and ``load_network(num_requests=)``, ``Core`` and
``CompiledModel``, the server closed by ``set_calibration`` and rebuilt for a
new compiled network, ``"GPU"`` refused where PyTorch sees no card, and a
stress run of more submitting threads than cores on one queue."""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

import pyopenvino_tpu
from pyopenvino_tpu import AsyncInferQueue as JaxQueue
from pyopenvino_tpu import Config as JaxConfig
from pyopenvino_tpu import Core as JaxCore
from pyopenvino_tpu import IECore as JaxIECore
from pyopenvino_tpu import IENetwork as JaxIENetwork
from pyopenvino_tpu.ir.builder import GraphBuilder as JaxGraphBuilder

import pyopenvino_tpu_torch
from pyopenvino_tpu_torch import (AsyncInferQueue, CompiledModel, Config, Core, IECore,
                                  IENetwork, InferRequest, QuantMode)
from pyopenvino_tpu_torch.ir.builder import GraphBuilder
from pyopenvino_tpu_torch.models import op_graphs
import test_torch_port_ir as port_ir
from test_torch_port_state import accumulator_model
import test_torch_port_threads  # noqa: F401  (this worker's torch threads)

OUT_RTOL, OUT_ATOL = 1e-4, 1e-5   # mnist_bn, TORCH against XLA
STREAM_RTOL = 1e-5                # lstm_stream, of the largest output
MNIST = ("assets/trained/mnist_bn.xml", "assets/trained/mnist_bn.bin")
IN = "conv2d_input"
BUCKETS = (1, 2, 4, 8)
# each package's classes and the device name its compiled path takes here
PACKAGES = {"port": (Core, IECore, IENetwork, AsyncInferQueue, Config, GraphBuilder, "CPU"),
            "jax": (JaxCore, JaxIECore, JaxIENetwork, JaxQueue, JaxConfig, JaxGraphBuilder,
                    "TPU")}


def _images(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 255, (1, 1, 28, 28)).astype(np.float32) for _ in range(n)]


@pytest.fixture(scope="module", params=sorted(PACKAGES))
def pkg(request):
    """(package name, its CompiledModel of mnist_bn with buckets 1–8)."""
    core_cls, _, _, _, config_cls, _, device = PACKAGES[request.param]
    core = core_cls()
    compiled = core.compile_model(core.read_model(*MNIST), device,
                                  config=config_cls(batch_buckets=BUCKETS))
    yield request.param, compiled
    compiled._exe.close()


def _queue_answers(name, compiled, blobs, jobs=4):
    """{userdata: output_blobs} of every blob through an AsyncInferQueue."""
    q = PACKAGES[name][3](compiled, jobs=jobs)
    got, lock = {}, threading.Lock()

    def cb(request, userdata):
        with lock:
            got[userdata] = dict(request.output_blobs)

    q.set_callback(cb)
    assert len(q) == jobs and q.is_ready()
    for i, x in enumerate(blobs):
        q.start_async({IN: x}, userdata=i)
    q.wait_all()
    return got


def test_callbacks_and_userdata():
    """12 seeded images through each package's queue: every userdata once,
    each answer the JAX package's and the port's direct infer()'s, and the
    port's server coalesced the slots."""
    blobs = _images(12, 0)
    answers, servers = {}, {}
    for name in PACKAGES:
        core_cls, _, _, _, config_cls, _, device = PACKAGES[name]
        core = core_cls()
        compiled = core.compile_model(core.read_model(*MNIST), device,
                                      config=config_cls(batch_buckets=BUCKETS))
        answers[name] = _queue_answers(name, compiled, blobs)
        servers[name] = compiled._exe._server.stats
        if name == "port":
            direct = [compiled({IN: x}) for x in blobs]
        compiled._exe.close()
    assert sorted(answers["port"]) == sorted(answers["jax"]) == list(range(12))
    assert servers["port"].requests == 12 and servers["port"].batches < 12
    assert servers["jax"].requests >= 12
    for i in range(12):
        got, want = answers["port"][i], answers["jax"][i]
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].shape == want[k].shape == (1, 10)
            np.testing.assert_allclose(got[k], want[k], rtol=OUT_RTOL, atol=OUT_ATOL)
            np.testing.assert_allclose(got[k], direct[i][k], rtol=1e-6, atol=1e-7)
            assert got[k].argmax() == want[k].argmax()


def test_start_async_blocks_until_slot_free(pkg):
    name, compiled = pkg
    q = PACKAGES[name][3](compiled, jobs=2)
    x = _images(1, 1)[0]
    release = threading.Event()
    q.set_callback(lambda request, userdata: release.wait(timeout=30))
    q.start_async({IN: x}, userdata=0)
    q.start_async({IN: x}, userdata=1)
    third = threading.Event()

    def submit_third():
        q.start_async({IN: x}, userdata=2)
        third.set()

    t = threading.Thread(target=submit_third)
    t.start()
    time.sleep(0.3)
    # both slots busy (their callbacks parked): the third submission waits
    assert not third.is_set()
    assert not q.is_ready()
    release.set()
    t.join(timeout=30)
    assert third.is_set()
    q.wait_all()


def test_error_surfaces_at_start_async(pkg):
    """A malformed input raises in start_async (the server refuses it before
    it can fail a coalesced batch), and its slot returns to the pool."""
    name, compiled = pkg
    q = PACKAGES[name][3](compiled, jobs=2)
    with pytest.raises(ValueError, match="served shapes"):
        q.start_async({IN: np.zeros((1, 1, 5, 5), np.float32)})
    assert q.is_ready()
    q.wait_all()  # nothing in flight
    q.start_async({IN: _images(1, 2)[0]})
    q.wait_all()


def test_wait_all_raises_the_first_callback_error(pkg):
    name, compiled = pkg
    q = PACKAGES[name][3](compiled, jobs=2)

    def cb(request, userdata):
        raise ZeroDivisionError(userdata)

    q.set_callback(cb)
    q.start_async({IN: _images(1, 3)[0]}, userdata="first")
    with pytest.raises(ZeroDivisionError):
        q.wait_all()
    assert q.is_ready()


def test_requests_indexable(pkg):
    name, compiled = pkg
    q = PACKAGES[name][3](compiled, jobs=3)
    q.start_async({IN: _images(1, 4)[0]})
    q.wait_all()
    assert len(list(iter(q))) == 3
    done = [q[i].output_blobs for i in range(3) if q[i].output_blobs]
    assert len(done) == 1  # exactly the one submitted job produced outputs


def test_accepts_legacy_executable_network():
    x = _images(1, 5)[0]
    seen = {}
    for name in PACKAGES:
        _, ie_cls, _, queue_cls, _, _, device = PACKAGES[name]
        ie = ie_cls()
        exe = ie.load_network(ie.read_network(*MNIST), device)
        q = queue_cls(exe, jobs=2)
        got = []
        q.set_callback(lambda r, u: got.append((u, dict(r.output_blobs))))
        q.start_async({IN: x}, userdata="a")
        q.wait_all()
        assert [u for u, _ in got] == ["a"]
        seen[name] = got[0][1]
        exe.close()
        with pytest.raises(TypeError):
            queue_cls(object())
    for k, want in seen["jax"].items():
        np.testing.assert_allclose(seen["port"][k], want, rtol=OUT_RTOL, atol=OUT_ATOL)


def test_queue_stress_more_threads_than_cores():
    """More submitting threads than cores on one queue, with a short switch
    interval: the network compiles once, every userdata is answered once
    with its own image's answer, the server counts every request and no
    job is left in flight."""
    n_threads = (os.cpu_count() or 1) + 2
    blobs = _images(2 * n_threads, 10)
    ie = IECore()
    exe = ie.load_network(ie.read_network(*MNIST), "CPU", config=Config(batch_buckets=BUCKETS))
    q = AsyncInferQueue(exe, jobs=BUCKETS[-1])
    got, lock = {}, threading.Lock()

    def cb(request, userdata):
        with lock:
            assert userdata not in got
            got[userdata] = request.output_blobs

    q.set_callback(cb)
    nets = []

    def client(i):
        nets.append(exe.compiled())
        for j in (2 * i, 2 * i + 1):
            q.start_async({IN: blobs[j]}, userdata=j)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        q.wait_all(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len({id(n) for n in nets}) == 1 and len(exe._compiled) == 1
    assert sorted(got) == list(range(len(blobs))) and q._inflight == 0 and q.is_ready()
    assert exe._server.stats.requests == len(blobs)
    for j, blob in enumerate(blobs):
        for k, v in exe.infer({IN: blob}).items():
            np.testing.assert_allclose(got[j][k], v, rtol=1e-6, atol=1e-7)
    exe.close()


# -- stateful requests (tests/test_stateful.py:239, :260, :292) ------------------------------

def _stateful_exe(name, num_requests=1, **config):
    _, ie_cls, net_cls, _, config_cls, builder, device = PACKAGES[name]
    return ie_cls().load_network(net_cls(accumulator_model(builder)), device,
                                 num_requests=num_requests, config=config_cls(**config))


@pytest.mark.parametrize("name", sorted(PACKAGES))
def test_per_request_state_isolated(name):
    """Each InferRequest owns its variables: two slots advance apart, and
    reset_state on one leaves the other as it was."""
    exe = _stateful_exe(name, num_requests=2)
    r0, r1 = exe.requests
    assert exe._server is None  # stateful requests run inline
    x = np.ones((1, 4), np.float32)
    np.testing.assert_array_equal(r0.infer({"x": x})["out"], x)
    np.testing.assert_array_equal(r0.infer({"x": x})["out"], 2 * x)
    np.testing.assert_array_equal(r1.infer({"x": x})["out"], x)
    np.testing.assert_array_equal(r0.query_state()[0].state, 2 * x)
    np.testing.assert_array_equal(r1.query_state()[0].state, x)
    r0.reset_state()
    np.testing.assert_array_equal(r0.infer({"x": x})["out"], x)
    np.testing.assert_array_equal(r1.infer({"x": x})["out"], 2 * x)
    # a VariableState of one request sets only that request's variable
    r1.query_state()[0].state = np.full((1, 4), 10.0, np.float32)
    np.testing.assert_array_equal(r1.infer({"x": x})["out"], 11 * x)
    np.testing.assert_array_equal(r0.infer({"x": x})["out"], 2 * x)
    # the network's own stream is apart from every request's
    np.testing.assert_array_equal(exe.infer({"x": x})["out"], x)


@pytest.mark.parametrize("name", sorted(PACKAGES))
def test_per_request_state_concurrent_no_corruption(name):
    """Four requests stepped from four threads each see exactly their own
    running sum: no request's state is written by another's step."""
    exe = _stateful_exe(name, num_requests=4)
    reqs = exe.requests
    (exe.compiled if name == "port" else exe._get_compiled)()
    errors = []

    def drive(i):
        try:
            x = np.full((1, 4), float(i + 1), np.float32)
            for step in range(1, 9):
                np.testing.assert_array_equal(reqs[i].infer({"x": x})["out"], step * x)
        except Exception as e:  # noqa: BLE001 — raised below
            errors.append(e)

    threads = [threading.Thread(target=drive, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    for i, r in enumerate(reqs):
        np.testing.assert_array_equal(r.query_state()[0].state, np.full((1, 4), 8.0 * (i + 1)))


@pytest.mark.parametrize("name", sorted(PACKAGES))
def test_async_queue_stateful_inline(name):
    """A queue on a stateful network runs inline on its slot's own stream,
    never through the server."""
    exe = _stateful_exe(name)
    q = PACKAGES[name][3](exe, jobs=1)
    seen = []
    q.set_callback(lambda req, userdata: seen.append((userdata, req.output_blobs["out"])))
    x = np.ones((1, 4), np.float32)
    for i in range(3):
        q.start_async({"x": x}, userdata=i)
    q.wait_all()
    assert exe._server is None
    assert [u for u, _ in seen] == [0, 1, 2]
    for i, (_, out) in enumerate(seen, start=1):
        np.testing.assert_array_equal(out, i * x)


def test_stateful_request_on_the_numpy_interpreter():
    """kernel_type "numpy": each request's stream is a private Interpreter,
    as the JAX package's "CPU" (interpreter) requests are."""
    exe = _stateful_exe("port", num_requests=2)
    exe.kernel_type = "numpy"
    jexe = JaxIECore().load_network(JaxIENetwork(accumulator_model(JaxGraphBuilder)), "CPU",
                                    num_requests=2)
    x = np.arange(4, dtype=np.float32).reshape(1, 4)
    for (r0, r1), label in ((exe.requests, "port"), (jexe.requests, "jax")):
        assert r0._stream._interp is None
        outs = [r0.infer({"x": x})["out"], r0.infer({"x": x})["out"], r1.infer({"x": x})["out"]]
        assert r0._stream._interp is not None and r0._stream._interp is not r1._stream._interp
        for out, want in zip(outs, (x, 2 * x, x)):
            np.testing.assert_array_equal(out, want, err_msg=label)
        r0.query_state()[0].reset()
        np.testing.assert_array_equal(r0.infer({"x": x})["out"], x, err_msg=label)


def test_lstm_stream_requests_from_two_threads():
    """lstm_stream (hidden 16): two requests stepped in turn from two threads,
    four chunks each, equal to each stream run alone and to the JAX
    package's requests; query_state per request; reset_state on one request
    leaves the other as it was."""
    width = 8
    port, rec = op_graphs.build(GraphBuilder, "lstm_stream", width=width)
    jax, _ = op_graphs.build(JaxGraphBuilder, "lstm_stream", width=width)
    rng = np.random.default_rng(9)
    chunks = [[rec.inputs(rng, 1) for _ in range(4)] for _ in range(2)]
    exe = IECore().load_network(IENetwork(port), "CPU", num_requests=2)
    jexe = JaxIECore().load_network(JaxIENetwork(jax), "TPU", num_requests=2)
    alone = IECore().load_network(IENetwork(port), "CPU")

    def rel(got, want):
        return float(np.abs(got - want).max() / np.abs(want).max())

    want = []
    for stream in chunks:  # each stream alone, on the network's own state
        alone.reset_state()
        want.append([alone.infer(c) for c in stream] + [{
            v.name: v.state for v in alone.query_state()}])
    reqs, got, turn = exe.requests, [[], []], threading.Condition()
    step = [0]

    def drive(i):
        for j, c in enumerate(chunks[i]):
            with turn:  # in turn: request 0's chunk j, then request 1's
                turn.wait_for(lambda: step[0] == 2 * j + i)
                got[i].append(reqs[i].infer(c))
                step[0] += 1
                turn.notify_all()
        got[i].append({v.name: v.state for v in reqs[i].query_state()})

    threads = [threading.Thread(target=drive, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    jgot = [[jexe.requests[i].infer(c) for c in chunks[i]] for i in range(2)]
    for i in range(2):
        assert len(got[i]) == 5
        for j, (g, w) in enumerate(zip(got[i], want[i])):
            assert sorted(g) == sorted(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=f"request {i} step {j} {k}")
                if j < 4:
                    assert rel(g[k], jgot[i][j][k]) <= STREAM_RTOL, (i, j, k)
    # reset one request: the other goes on from where it was
    before = {v.name: v.state for v in reqs[1].query_state()}
    reqs[0].reset_state()
    assert all(np.array_equal(v.state, before[v.name]) for v in reqs[1].query_state())
    np.testing.assert_array_equal(reqs[0].infer(chunks[0][0])["logits"], want[0][0]["logits"])


# -- the package surface ---------------------------------------------------------------------

def test_all_matches_the_jax_package():
    assert pyopenvino_tpu_torch.__all__ == pyopenvino_tpu.__all__
    for name in pyopenvino_tpu_torch.__all__:
        assert getattr(pyopenvino_tpu_torch, name).__name__ == name


def test_ast_scan_covers_serving():
    """The port's import scan reads the serving layer, and it passes."""
    paths = port_ir._port_sources()
    for module in ("serving/__init__.py", "serving/server.py", "api.py"):
        assert f"{port_ir.PORT}/{module}" in paths
    port_ir.test_port_imports_nothing_of_jax_or_the_jax_package()


def test_get_metric_and_query_network():
    ie, jie = IECore(), JaxIECore()
    assert ie.get_metric("CPU", "AVAILABLE_DEVICES") == ["0"]
    assert ie.get_metric("CPU", "FULL_DEVICE_NAME") == "CPU"
    assert (ie.get_metric("CPU", "SUPPORTED_METRICS")
            == jie.get_metric("TPU", "SUPPORTED_METRICS"))
    assert Core().get_property("CPU", "FULL_DEVICE_NAME") == "CPU"
    for core in (ie, jie):
        with pytest.raises(ValueError, match="unsupported metric"):
            core.get_metric("CPU", "OPTIMIZATION_CAPABILITIES")
    if torch.cuda.is_available():
        assert ie.get_metric("GPU", "FULL_DEVICE_NAME") == (
            f"GPU:{torch.cuda.get_device_name(0)}")
        assert len(ie.get_metric("GPU", "AVAILABLE_DEVICES")) == torch.cuda.device_count()
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ie.get_metric("GPU", "FULL_DEVICE_NAME")
    got = ie.query_network(ie.read_network(*MNIST), "CPU")
    want = jie.query_network(jie.read_network(*MNIST), "CPU")
    assert got == want and len(got) > 10


def test_load_network_num_requests():
    ie = IECore()
    exe = ie.load_network(ie.read_network(*MNIST), "CPU", 3, Config(batch_buckets=(1, 2)))
    assert exe.num_requests == 3 and exe.config.batch_buckets == (1, 2)
    reqs = exe.requests
    assert len(reqs) == 3 and all(isinstance(r, InferRequest) for r in reqs)
    assert exe._server is not None and exe._server.buckets == (1, 2)
    assert sorted(exe._server._nets[None]._batched) == [1, 2]  # warmed up
    x = _images(3, 6)
    for r, blob in zip(reqs, x):
        r.start_async({IN: blob})
    for r, blob in zip(reqs, x):
        assert r.wait() == 0
        for k, v in exe.infer({IN: blob}).items():
            np.testing.assert_allclose(r.output_blobs[k], v, rtol=1e-6, atol=1e-7)
    with pytest.raises(RuntimeError, match="wait"):
        reqs[0].start_async({IN: x[0]}).start_async({IN: x[0]})
    reqs[0].wait()
    exe.close()
    assert exe._server is None and exe._requests is None


def test_server_follows_the_compiled_network():
    """The server is rebuilt when the configuration yields another compiled
    network, and set_calibration closes it (its scales are stale)."""
    ie = IECore()
    exe = ie.load_network(ie.read_network(*MNIST), "CPU", config=Config(batch_buckets=(1,)))
    x = _images(1, 7)[0]
    first = exe._ensure_server()
    assert exe._ensure_server() is first
    exe.kernel_type = "kernels"
    second = exe._ensure_server()
    assert second is not first and not first._running and second.compiled is exe.compiled()
    InferRequest(exe).infer({IN: x})
    exe.config = exe.config.replace(quant=QuantMode.INT8_FULL)
    exe.set_calibration([{IN: x}])
    assert exe._server is None and not second._running
    served = InferRequest(exe).infer({IN: x})
    assert exe._server.compiled.act_scales
    for k, v in exe.infer({IN: x}).items():
        np.testing.assert_array_equal(served[k], v)
    exe.close()


def test_core_and_compiled_model(tmp_path):
    core, jcore = Core(), JaxCore()
    model, jmodel = core.read_model(*MNIST), jcore.read_model(*MNIST)
    if torch.cuda.is_available():
        assert core.compile_model(model)._exe.device.type == "cuda"
    else:  # "GPU" is the default device, and it is refused without a card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            core.compile_model(model)
    # a properties dict goes to set_property: CACHE_DIR is taken (the
    # runtime extras), any other key raises, as in the JAX package
    core.compile_model(model, "CPU", {"CACHE_DIR": str(tmp_path)})
    assert core.get_property("CPU", "CACHE_DIR") == str(tmp_path)
    core.set_property({"CACHE_DIR": ""})
    with pytest.raises(ValueError, match="unsupported config key 'PERFORMANCE_HINT'"):
        core.compile_model(model, "CPU", {"PERFORMANCE_HINT": "x"})
    with pytest.raises(ValueError, match="unsupported config key 'PERFORMANCE_HINT'"):
        jcore.compile_model(jmodel, "TPU", {"PERFORMANCE_HINT": "x"})
    compiled = core.compile_model(model, "CPU", {})
    jcompiled = jcore.compile_model(jmodel, "TPU")
    assert isinstance(compiled, CompiledModel) and compiled._exe.device.type == "cpu"
    assert compiled.inputs == jcompiled.inputs and compiled.outputs == jcompiled.outputs
    x = _images(1, 8)[0]
    want = jcompiled({IN: x})
    for got in (compiled({IN: x}), compiled.infer_new_request({IN: x}),
                compiled.create_infer_request().infer({IN: x})):
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=OUT_RTOL, atol=OUT_ATOL)
    compiled._exe.close()
    jcompiled._exe.close()
