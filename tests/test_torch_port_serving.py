"""The port's continuous-batching server (``pyopenvino_tpu_torch/serving``)
against the JAX package's (``pyopenvino_tpu/serving``), XLA backend, on the
CPU.

Every case of ``tests/test_serving.py`` but the sharded, pipelined and
``AsyncLoader`` ones runs here through both servers on the same seeded
inputs: one request, coalescing, padding masked out of the answers, errors
raised in the submitting thread, orphans failed on ``stop``, many client
threads, submit after stop, multi-resolution routing and its refusal.  The
models are in-repo: ``assets/trained/mnist_bn`` (the family's TORCH-vs-XLA
limit, ``test_torch_port_fold_scale.py``'s 1e-4 / 1e-5),
``assets/trained/shapes_ssd`` (records as ``test_torch_port_ssd.py`` holds
them) and an SSD head built node for node by both GraphBuilders.
``shapes_ssd`` flattens its heads to a fixed (1, 1728), so neither package
can reshape it: multi-resolution serving runs on the built head, whose
flattens keep the batch dim (special_zero) and whose PriorBoxClustered reads
its grid and image sizes through ShapeOf → Gather, so the anchor chain folds
again at each (H, W).  The port's server also warms every bucket before its
thread starts and computes in full float32 (TF32 off) on that thread."""

import dataclasses
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from pyopenvino_tpu.config import Backend as JaxBackend
from pyopenvino_tpu.config import Config as JaxConfig
from pyopenvino_tpu.ir import read_ir_model as jax_read
from pyopenvino_tpu.ir.builder import GraphBuilder as JaxGraphBuilder
from pyopenvino_tpu.runtime.compiler import compile_model as jax_compile_model
from pyopenvino_tpu.serving import InferenceServer as JaxServer

from pyopenvino_tpu_torch.config import Config, QuantMode, check_supported
from pyopenvino_tpu_torch.ir import read_ir_model
from pyopenvino_tpu_torch.ir.builder import GraphBuilder
from pyopenvino_tpu_torch.runtime.compiler import compile_model
from pyopenvino_tpu_torch.serving import InferenceServer, ServerStats
from test_torch_port_ssd import RECORD_ATOL, check_records
import test_torch_port_threads  # noqa: F401  (this worker's torch threads)

# mnist_bn, TORCH (CPU) against XLA (CPU): float32 sums in another order
OUT_RTOL, OUT_ATOL = 1e-4, 1e-5
MNIST = ("assets/trained/mnist_bn.xml", "assets/trained/mnist_bn.bin")
SSD = ("assets/trained/shapes_ssd.xml", "assets/trained/shapes_ssd.bin")
IN = "conv2d_input"


def _images(n, seed, shape=(1, 1, 28, 28)):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 255, shape).astype(np.float32) for _ in range(n)]


@pytest.fixture(scope="module")
def mnist():
    """(port network on the CPU, JAX network on XLA), the same IR."""
    return (compile_model(read_ir_model(*MNIST), Config(), device="cpu"),
            jax_compile_model(jax_read(*MNIST), JaxConfig(backend=JaxBackend.XLA)))


def _served(server_cls, net, blobs, name=IN, **kw):
    """Every blob submitted at once; (answers, the server's stats)."""
    with server_cls(net, **kw) as srv:
        futs = [srv.submit({name: b}) for b in blobs]
        outs = [f.result(timeout=120) for f in futs]
    return outs, srv.stats


def _close(got, want, rtol=OUT_RTOL, atol=OUT_ATOL):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol)


def test_single_request(mnist):
    port, jax = mnist
    x = _images(1, 0)[0]
    (got,), _ = _served(InferenceServer, port, [x], buckets=(1, 2, 4))
    (want,), _ = _served(JaxServer, jax, [x], buckets=(1, 2, 4))
    _close(got, want)
    k = next(iter(want))
    assert got[k].shape == (1, 10)
    assert list(np.argsort(got[k][0])[::-1][:3]) == list(np.argsort(want[k][0])[::-1][:3])
    _close(got, port.infer({IN: x}), rtol=1e-6, atol=1e-7)


def test_concurrent_coalescing(mnist):
    """8 requests inside one generous window: fewer than 8 batches, every
    answer the JAX server's for the same image."""
    port, jax = mnist
    blobs = _images(8, 1)
    got, stats = _served(InferenceServer, port, blobs, buckets=(1, 2, 4, 8),
                         max_delay_ms=250.0)
    want, jstats = _served(JaxServer, jax, blobs, buckets=(1, 2, 4, 8), max_delay_ms=250.0)
    assert stats.requests == 8 and stats.batches < 8
    assert jstats.requests == 8
    for g, w in zip(got, want):
        _close(g, w)


def test_partial_batch_padding_masked(mnist):
    """Three requests in a bucket of 4: one padded slot (a copy of the last
    example), masked out; each answer is its own image's."""
    port, jax = mnist
    blobs = _images(3, 2)
    got, stats = _served(InferenceServer, port, blobs, buckets=(4,), max_delay_ms=250.0)
    want, jstats = _served(JaxServer, jax, blobs, buckets=(4,), max_delay_ms=250.0)
    assert (stats.batches, stats.padded_slots) == (jstats.batches, jstats.padded_slots) == (1, 1)
    for x, g, w in zip(blobs, got, want):
        _close(g, w)
        _close(g, port.infer({IN: x}), rtol=1e-6, atol=1e-7)
    # a single request pads 3 slots, the answer still its own
    (one,), stats = _served(InferenceServer, port, blobs[:1], buckets=(4,), max_delay_ms=1.0)
    assert stats.padded_slots == 3
    _close(one, want[0])


@pytest.mark.parametrize("server_cls,which", [(InferenceServer, 0), (JaxServer, 1)],
                         ids=["port", "jax"])
def test_error_propagation(mnist, server_cls, which):
    """A malformed request is refused at submit(), in the caller's thread,
    with the same exception in both packages; a valid one after it serves."""
    net = mnist[which]
    with server_cls(net, buckets=(1,)) as srv:
        with pytest.raises(KeyError):
            srv.submit({"wrong_name": np.zeros((1, 1, 28, 28), np.float32)})
        with pytest.raises(ValueError, match="served shapes"):
            srv.submit({IN: np.zeros((2, 28, 28), np.float32)})
        assert srv.infer({IN: np.zeros((1, 1, 28, 28), np.float32)})
        assert srv.stats.requests == 1


@pytest.mark.parametrize("server_cls,which", [(InferenceServer, 0), (JaxServer, 1)],
                         ids=["port", "jax"])
def test_stop_fails_orphaned_requests(mnist, server_cls, which):
    """A request that lands in the queue after the scheduler left gets its
    Future failed, not left waiting for ever."""
    srv = server_cls(mnist[which], buckets=(1,)).start()
    srv.infer({IN: np.zeros((1, 1, 28, 28), np.float32)})
    srv.stop()
    fut = Future()
    srv._queue.put(({IN: np.zeros((1, 1, 28, 28))}, fut, time.perf_counter(), None))
    srv._fail_orphans()
    with pytest.raises(RuntimeError, match="server stopped"):
        fut.result(timeout=10)


def test_many_clients_threads(mnist):
    """20 client threads, each its own image, against the JAX server's
    answers to the same images."""
    port, jax = mnist
    blobs = _images(20, 3)
    want, _ = _served(JaxServer, jax, blobs, buckets=(1, 2, 4, 8, 16), max_delay_ms=5.0)
    srv = InferenceServer(port, buckets=(1, 2, 4, 8, 16), max_delay_ms=5.0).start()
    got, errors = [None] * len(blobs), []

    def client(i):
        try:
            got[i] = srv.infer({IN: blobs[i]})
        except Exception as e:  # noqa: BLE001 — raised below
            errors.append(e)

    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(blobs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errors, errors
        assert srv.stats.requests == 20
        assert srv.stats.summary()["p50_ms"] > 0
    finally:
        srv.stop()
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("server_cls,which", [(InferenceServer, 0), (JaxServer, 1)],
                         ids=["port", "jax"])
def test_submit_after_stop(mnist, server_cls, which):
    srv = server_cls(mnist[which]).start()
    srv.stop()
    with pytest.raises(RuntimeError, match="not started"):
        srv.submit({IN: _images(1, 4)[0]})


def test_warmup_bakes_every_bucket_in_the_callers_thread(mnist):
    """start(warmup=True) bakes each bucket's model before the scheduler
    thread exists, so no request pays a bake; the stats stay empty."""
    port = compile_model(read_ir_model(*MNIST), Config(), device="cpu")
    baked_in = []
    real = port._batched_plan

    def plan(batch):
        baked_in.append((batch, threading.current_thread().name))
        return real(batch)

    port._batched_plan = plan
    with InferenceServer(port, buckets=(1, 2, 4)).start(warmup=True) as srv:
        assert sorted(port._batched) == [1, 2, 4]
        assert {t for _, t in baked_in} == {threading.current_thread().name}
        assert srv.stats.summary() == ServerStats().summary()
        srv.infer({IN: _images(1, 5)[0]})
    assert sorted(port._batched) == [1, 2, 4]


def test_scheduler_thread_computes_in_full_float32(mnist):
    """The TF32 switches are process-wide: the scheduler thread's forwards
    see them off, as the caller's do."""
    port = mnist[0]
    seen = []
    real = port.infer_batch

    def infer_batch(inputs):
        seen.append((threading.current_thread() is threading.main_thread(),
                     torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
                     torch.get_float32_matmul_precision()))
        return real(inputs)

    port.infer_batch = infer_batch
    try:
        _served(InferenceServer, port, _images(2, 6), buckets=(1, 2))
    finally:
        del port.infer_batch
    assert seen and all(s == (False, False, False, "highest") for s in seen), seen


def test_ssd_served_equals_direct_infer():
    """shapes_ssd at its declared 96×96: each served answer has a direct
    infer()'s (1, 1, 20, 7) shape and records, and the JAX server's records."""
    from tools.datasets import shapes_det

    x, _ = shapes_det(6, 7)
    blobs = [x[i:i + 1] for i in range(len(x))]
    port = compile_model(read_ir_model(*SSD), Config(), device="cpu")
    jax = jax_compile_model(jax_read(*SSD), JaxConfig(backend=JaxBackend.XLA))
    got, stats = _served(InferenceServer, port, blobs, name="data", buckets=(1, 2, 4, 8),
                         max_delay_ms=250.0)
    want, _ = _served(JaxServer, jax, blobs, name="data", buckets=(1, 2, 4, 8),
                      max_delay_ms=250.0)
    assert stats.requests == 6 and stats.batches < 6
    records = 0
    for blob, g, w in zip(blobs, got, want):
        direct = port.infer({"data": blob})["detections"]
        assert g["detections"].shape == direct.shape == w["detections"].shape == (1, 1, 20, 7)
        check_records(g["detections"], direct, atol=1e-5)
        check_records(g["detections"], w["detections"], atol=RECORD_ATOL)
        records += int((g["detections"][..., 0] >= 0).sum())
    assert records > 0


def ssd_head_model(cls, hw=(64, 64), classes=3):
    """An SSD head on one stride-2 feature map, resolution-free: loc and
    conf flattened with the batch dim kept (special_zero), the conf softmax
    over classes, PriorBoxClustered on the feature map's and the image's
    (H, W) read through ShapeOf → Gather, DetectionOutput.  A builder infers
    each node's shapes as it adds it, from constant inputs only, so the
    PriorBoxClustered is added on constant sizes and its two inputs are moved
    to the ShapeOf → Gather chains after the build (the constants then feed
    nothing, and the compiler prunes them)."""
    rng = np.random.default_rng(17)
    widths, heights = (12.0, 24.0), (16.0, 10.0)
    n_pri, c = len(widths), 8
    b = cls("ssd_head")
    x = b.parameter("data", (1, 3, *hw))

    def conv(src, ci, co, stride, scale):
        w = (rng.standard_normal((co, ci, 3, 3)) * scale).astype(np.float32)
        bias = (rng.standard_normal(co) * 0.1).astype(np.float32)
        return b.add(b.conv2d(src, b.const(w), strides=(stride, stride), pads=((1, 1), (1, 1))),
                     b.const(bias.reshape(1, -1, 1, 1)))

    feat = b.relu(conv(x, 3, c, 2, 0.01))
    loc = b.reshape(b.transpose(conv(feat, c, 4 * n_pri, 1, 0.1), (0, 2, 3, 1)), (0, -1))
    conf = b.transpose(conv(feat, c, classes * n_pri, 1, 0.5), (0, 2, 3, 1))
    conf = b.reshape(b.softmax(b.reshape(conf, (0, -1, classes)), axis=2), (0, -1))

    def hw_of(t):
        shape = b._add_node("ShapeOf", [t], {"output_type": "i64"}, out_dtype=np.int64)
        return b.gather(shape, [2, 3])

    sizes = hw_of(feat), hw_of(x)
    priors = b.prior_box_clustered((hw[0] // 2, hw[1] // 2), hw, widths, heights)
    b.result(b.detection_output(loc, conf, b.unsqueeze(priors, (0,)), classes, keep_top_k=16,
                                confidence_threshold=0.3), "detections")
    model = b.build()
    edges = [e if e.dst != priors.nid else
             dataclasses.replace(e, src=sizes[e.dst_port].nid, src_port=sizes[e.dst_port].port)
             for e in model.edges]
    return type(model)(model.name, model.nodes, edges)


def test_multi_resolution_serving():
    """One server, three resolutions: a reshaped network per extra (H, W),
    whose PriorBoxClustered chain folds again there; requests route by
    shape and batch only with their own resolution; each answer is the
    direct infer()'s of its resolution's network and the JAX server's."""
    port = compile_model(ssd_head_model(GraphBuilder), Config(), device="cpu")
    jax = jax_compile_model(ssd_head_model(JaxGraphBuilder), JaxConfig(backend=JaxBackend.XLA))
    rng = np.random.default_rng(0)
    blobs = {hw: [rng.uniform(0, 255, (1, 3, *hw)).astype(np.float32) for _ in range(3)]
             for hw in ((64, 64), (48, 80), (96, 96))}
    extra = [(48, 80), (96, 96)]
    answers = {}
    for name, server_cls, net in (("port", InferenceServer, port), ("jax", JaxServer, jax)):
        with server_cls(net, buckets=(1, 2, 4), resolutions=extra) as srv:
            futs = {hw: [srv.submit({"data": x}) for x in xs] for hw, xs in blobs.items()}
            answers[name] = {hw: [f.result(timeout=120)["detections"] for f in fs]
                             for hw, fs in futs.items()}
            with pytest.raises(ValueError, match="served shapes"):
                srv.submit({"data": np.zeros((1, 3, 50, 50), np.float32)})
        assert srv.stats.requests == 9 and srv.stats.batches >= 3
        if name == "port":
            nets = srv._nets
    priors = {}
    for hw, xs in blobs.items():
        net = nets[None if hw == (64, 64) else hw]
        assert net.config is port.config
        folded = [v for (src, _), v in net.analysis.values.items()
                  if net.model.nodes[src].op_type == "PriorBoxClustered"]
        priors[hw] = folded[0].shape
        records = 0
        for x, got, want in zip(xs, answers["port"][hw], answers["jax"][hw]):
            direct = net.infer({"data": x})["detections"]
            assert got.shape == direct.shape == want.shape == (1, 1, 16, 7)
            check_records(got, direct, atol=1e-5)
            check_records(got, want, atol=RECORD_ATOL)
            records += int((got[..., 0] >= 0).sum())
        assert records > 0
    # the anchors folded at each resolution: 2 priors a cell of the (H/2, W/2) map
    assert priors == {hw: (2, 4 * 2 * (hw[0] // 2) * (hw[1] // 2)) for hw in blobs}


def test_resolutions_keep_the_quantization_state():
    """An INT8-FULL network's extra resolutions compile with its codes,
    activation scales and bias corrections."""
    model = ssd_head_model(GraphBuilder)
    rng = np.random.default_rng(3)
    cal = [{"data": rng.uniform(0, 255, (1, 3, 64, 64)).astype(np.float32)} for _ in range(2)]
    port = compile_model(model, Config(quant=QuantMode.INT8_FULL, bias_correction=True),
                         device="cpu", calibration_samples=cal)
    srv = InferenceServer(port, buckets=(1, 2), resolutions=[(32, 32)])
    net = srv._nets[(32, 32)]
    assert port.act_scales and port._quantized and port._bias_corr
    assert (net.act_scales, net._quantized, net._bias_corr) == (
        port.act_scales, port._quantized, port._bias_corr)
    assert net.config is port.config and net.device == port.device
    x = rng.uniform(0, 255, (1, 3, 32, 32)).astype(np.float32)
    with srv:
        check_records(srv.infer({"data": x})["detections"], net.infer({"data": x})["detections"],
                      atol=1e-5)


def _vector_model(cls):
    b = cls("vec")
    x = b.parameter("x", (1, 4))
    b.result(b.add(x, b.const(np.ones((1, 4), np.float32))), "out")
    return b.build()


def test_multi_resolution_refuses_non_image_models():
    port = compile_model(_vector_model(GraphBuilder), Config(), device="cpu")
    jax = jax_compile_model(_vector_model(JaxGraphBuilder), JaxConfig(backend=JaxBackend.XLA))
    for server_cls, net in ((InferenceServer, port), (JaxServer, jax)):
        with pytest.raises(NotImplementedError, match="rank-4"):
            server_cls(net, resolutions=[(16, 40)])


@pytest.mark.parametrize("buckets", [(), (2, 1), (0, 1), (1, 1, 2), [1, 2], (1, 2.0)],
                         ids=["empty", "unsorted", "zero", "repeated", "list", "float"])
def test_batch_buckets_refused(buckets):
    with pytest.raises(ValueError, match="batch_buckets"):
        check_supported(Config(batch_buckets=buckets))


def test_batch_buckets_default_is_the_jax_packages():
    assert Config().batch_buckets == JaxConfig().batch_buckets == (1, 2, 4, 8, 16, 32)
    check_supported(Config(batch_buckets=(4,)))
