"""The port's native host library (``pyopenvino_tpu_torch/native``) against
the JAX package's (``pyopenvino_tpu/native``) on the CPU.

Every case of ``tests/test_native.py`` and
``tests/test_review_fixes.py::test_native_bias_only`` runs on the port, its
answers held against the JAX package's library on the same seeded inputs
(both built by g++ with the same flags from the same arithmetic, so bit for
bit) and against the port's plain versions:

  * fp16 over all 65,536 bit patterns, bit-equal to the JAX package's
    decode and to numpy's, NaNs as NaNs; an fp16 Const through the parser;
  * ``preprocess_batch`` in float32 (scale and bias, bias alone, the
    identity resize) and in u8, bit-equal to the JAX package's library and
    within 1e-4 of ``_preprocess_numpy`` (u8 within one step of the rounded
    float32); ``stack_f32`` exact;
  * the loader: order and parity, variable batch sizes, backpressure at
    depth 1, close releasing a blocked submitter, the bad-shape and
    after-close errors, u8 mode, each on the native ``AsyncLoader`` and on
    its plain Python-thread version ``_ThreadLoader``, which gives the
    native one's blobs;
  * a source that does not compile and a library of another ABI raise with
    the reason, and no public call answers from numpy;
  * the JAX package's ``test_async_loader_feeds_server`` against the port's
    ``InferenceServer`` on ``assets/trained/mnist_bn`` with seeded frames;
  * an fp16 IR: ``shapes_resnet``'s float Consts declared f16 and written
    by the port's writer, parsed bit-equal by both packages, the port's
    TORCH FP32 answer within the FP32 gate of the JAX package's XLA one.
"""

import os
import threading
import time

import numpy as np
import pytest

from pyopenvino_tpu import native as jax_native
from pyopenvino_tpu.config import Backend as JaxBackend
from pyopenvino_tpu.config import Config as JaxConfig
from pyopenvino_tpu.ir import read_ir_model as jax_read
from pyopenvino_tpu.runtime.compiler import compile_model as jax_compile

from pyopenvino_tpu_torch import native
from pyopenvino_tpu_torch.config import Config
from pyopenvino_tpu_torch.ir import read_ir_model
from pyopenvino_tpu_torch.ir.writer import with_f16_consts, write_ir_model
from pyopenvino_tpu_torch.runtime.compiler import compile_model
from pyopenvino_tpu_torch.serving import InferenceServer
from test_torch_port_googlenet import _assert_matches
import test_torch_port_threads  # noqa: F401  (this worker's torch threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAINED = os.path.join(REPO, "assets", "trained")
MNIST = tuple(os.path.join(TRAINED, f"mnist_bn.{e}") for e in ("xml", "bin"))
RESNET = tuple(os.path.join(TRAINED, f"shapes_resnet.{e}") for e in ("xml", "bin"))
# mnist_bn, TORCH (CPU) against XLA (CPU): float32 sums in another order
OUT_RTOL, OUT_ATOL = 1e-4, 1e-5
LOADERS = [native.AsyncLoader, native._ThreadLoader]


def _bits_equal(a, b):
    """Equal bits, any NaN matching any NaN."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    if a.dtype.kind == "f":
        same = a.view(f"u{a.itemsize}") == b.view(f"u{b.itemsize}")
        return bool((same | (np.isnan(a) & np.isnan(b))).all())
    return bool(np.array_equal(a, b))


def test_native_builds_and_loads():
    assert native.available() and jax_native.available()
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.name.startswith("preprocess-") and path.suffix == ".so"
    # the port never loads the JAX package's library
    assert "pyopenvino_tpu/native" not in str(path)


def test_fp16_decode_all_bit_patterns():
    allh = np.arange(65536, dtype=np.uint16).view(np.float16)
    got = native.fp16_to_fp32(allh)
    assert got.dtype == np.float32
    assert _bits_equal(got, allh.astype(np.float32))
    assert _bits_equal(got, jax_native.fp16_to_fp32(allh))
    assert np.isnan(got).sum() == np.isnan(allh).sum() == 2046


def test_preprocess_matches_numpy_reference():
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (4, 123, 77, 3), np.uint8)
    scale = np.array([1 / 255.0, 0.5, 2.0], np.float32)
    bias = np.array([-0.5, 0.0, 1.0], np.float32)
    got = native.preprocess_batch(imgs, (64, 96), scale=scale, bias=bias)
    assert got.shape == (4, 3, 64, 96) and got.dtype == np.float32
    assert _bits_equal(got, jax_native.preprocess_batch(imgs, (64, 96), scale=scale, bias=bias))
    np.testing.assert_allclose(got, native._preprocess_numpy(imgs, (64, 96), scale, bias),
                               atol=1e-4)


def test_native_bias_only():
    """bias without scale is applied."""
    rng = np.random.default_rng(1)
    imgs = rng.integers(0, 256, (2, 16, 16, 3), np.uint8)
    bias = np.array([10.0, 20.0, 30.0], np.float32)
    got = native.preprocess_batch(imgs, (16, 16), bias=bias)
    assert _bits_equal(got, jax_native.preprocess_batch(imgs, (16, 16), bias=bias))
    np.testing.assert_allclose(got, native._preprocess_numpy(imgs, (16, 16), None, bias),
                               atol=1e-4)


def test_preprocess_identity_resize():
    rng = np.random.default_rng(1)
    imgs = rng.integers(0, 256, (2, 28, 28, 1), np.uint8)
    out = native.preprocess_batch(imgs, (28, 28))
    assert _bits_equal(out, jax_native.preprocess_batch(imgs, (28, 28)))
    np.testing.assert_array_equal(out, imgs.astype(np.float32).transpose(0, 3, 1, 2))


def test_preprocess_batch_u8_mode():
    """u8_out keeps the blob uint8, the float32 resize rounded half up."""
    rng = np.random.default_rng(3)
    imgs = rng.integers(0, 256, (2, 13, 17, 3), dtype=np.uint8)
    f32 = native.preprocess_batch(imgs, (8, 8))
    u8 = native.preprocess_batch(imgs, (8, 8), u8_out=True)
    assert u8.dtype == np.uint8 and u8.shape == f32.shape
    assert _bits_equal(u8, jax_native.preprocess_batch(imgs, (8, 8), u8_out=True))
    assert np.abs(u8.astype(np.float32) - np.round(f32)).max() <= 1
    assert np.abs(u8.astype(np.int16) - native._preprocess_numpy_u8(imgs, (8, 8))).max() <= 1
    same = native.preprocess_batch(imgs, (13, 17), u8_out=True)
    np.testing.assert_array_equal(same, imgs.transpose(0, 3, 1, 2))
    with pytest.raises(ValueError, match="on-device"):
        native.preprocess_batch(imgs, (8, 8), scale=[1.0] * 3, u8_out=True)
    with pytest.raises(ValueError, match="on-device"):
        native.preprocess_batch(imgs, (8, 8), bias=[1.0] * 3, u8_out=True)


def test_preprocess_rejects_bad_shapes():
    with pytest.raises(ValueError, match="B, H, W, C"):
        native.preprocess_batch(np.zeros((8, 8, 3), np.uint8), (4, 4))
    with pytest.raises(ValueError, match="channels"):
        native.preprocess_batch(np.zeros((1, 8, 8, 3), np.uint8), (4, 4), scale=[1.0, 2.0])


def test_stack_exact():
    rng = np.random.default_rng(2)
    blobs = [rng.standard_normal((3, 8, 8)).astype(np.float32) for _ in range(7)]
    got = native.stack_f32(blobs)
    np.testing.assert_array_equal(got, np.stack(blobs))
    assert _bits_equal(got, jax_native.stack_f32(blobs))


def test_fp16_const_roundtrip_through_parser():
    """An IR with an fp16 Const decodes to the exact float32 values."""
    vals = np.array([1.5, -2.25, 6e-8, 65504.0], np.float16)
    xml = """<net name="t" version="10">
      <layers>
        <layer id="0" type="Const" version="opset1">
          <data element_type="f16" shape="4" offset="0" size="8"/>
          <output><port id="0" precision="FP16"><dim>4</dim></port></output>
        </layer>
        <layer id="1" type="Result" version="opset1">
          <input><port id="0" precision="FP16"><dim>4</dim></port></input>
        </layer>
      </layers>
      <edges><edge from-layer="0" from-port="0" to-layer="1" to-port="0"/></edges>
    </net>"""
    from pyopenvino_tpu_torch.ir.xml_parser import parse_ir

    const = parse_ir(xml, vals.tobytes()).nodes[0].const
    assert const.dtype == np.float32
    np.testing.assert_array_equal(const, vals.astype(np.float32))


# ---------------------------------------------------------------------------
# the loader, native and plain
# ---------------------------------------------------------------------------


def _loader_batches(n=8, batch=4, shape=(32, 24, 3), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (batch,) + shape, dtype=np.uint8) for _ in range(n)]


def _drain(ld, batches):
    """Submit ``batches`` from a producer thread, then close; every blob
    the consumer takes, in order."""
    t = threading.Thread(target=lambda: ([ld.submit(b) for b in batches], ld.close()))
    t.start()
    outs = list(ld)
    t.join()
    return outs


@pytest.mark.parametrize("loader", LOADERS)
def test_async_loader_order_and_parity(loader):
    """Blobs come back in submission order, bit-equal to the synchronous
    native path (the plain loader within the plain version's 1e-4)."""
    scale = np.full(3, 1 / 255, np.float32)
    batches = _loader_batches()
    with loader((32, 24, 3), (56, 56), scale=scale, depth=3) as ld:
        assert ld.native == (loader is native.AsyncLoader)
        outs = _drain(ld, batches)
        assert ld.next() is None and ld.next() is None  # drained state is sticky
    assert len(outs) == len(batches)
    for got, imgs in zip(outs, batches):
        want = native.preprocess_batch(imgs, (56, 56), scale=scale)
        assert got.shape == want.shape and got.dtype == want.dtype
        if ld.native:
            assert _bits_equal(got, want)
            assert _bits_equal(got, jax_native.preprocess_batch(imgs, (56, 56), scale=scale))
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("loader", LOADERS)
def test_async_loader_variable_batch_sizes(loader):
    rng = np.random.default_rng(1)
    sizes = [1, 3, 2, 5]
    with loader((16, 16, 1), (8, 8)) as ld:
        for b in sizes:
            ld.submit(rng.integers(0, 256, (b, 16, 16, 1), dtype=np.uint8))
        ld.close()
        got = [blob.shape[0] for blob in ld]
    assert got == sizes


@pytest.mark.parametrize("loader", LOADERS)
def test_async_loader_backpressure_then_drain(loader):
    """depth=1: the producer is never more than one batch ahead of the
    consumer, and everything submitted is retrievable after close()."""
    batches = _loader_batches(n=6, batch=2)
    submitted, ahead = [], []
    with loader((32, 24, 3), (16, 16), depth=1) as ld:
        def producer():
            for b in batches:
                ld.submit(b)
                submitted.append(1)
            ld.close()

        t = threading.Thread(target=producer)
        t.start()
        outs = []
        for blob in ld:
            time.sleep(0.01)  # a slow consumer: the producer waits on it
            ahead.append(len(submitted) - len(outs))
            outs.append(blob)
        t.join()
    assert len(outs) == 6 and len(submitted) == 6
    assert max(ahead) <= 2  # the batch taken and at most one in flight


@pytest.mark.parametrize("loader", LOADERS)
def test_async_loader_rejects_after_close_and_bad_shape(loader):
    ld = loader((8, 8, 3), (4, 4))
    with pytest.raises(ValueError, match="shape"):
        ld.submit(np.zeros((1, 9, 8, 3), np.uint8))
    ld.close()
    with pytest.raises(RuntimeError, match="loader is closed"):
        ld.submit(np.zeros((1, 8, 8, 3), np.uint8))
    ld.__exit__()


@pytest.mark.parametrize("loader", LOADERS)
def test_async_loader_close_releases_blocked_submitter(loader):
    """close() releases a producer blocked on a full window (RuntimeError
    "loader is closed"), and tearing the loader down after it is safe."""
    imgs = np.zeros((2, 16, 16, 1), np.uint8)
    ld = loader((16, 16, 1), (8, 8), depth=1)
    ld.submit(imgs)  # fills the window (nobody consumes)
    state = {}

    def blocked_producer():
        try:
            ld.submit(imgs)  # blocks on backpressure
            state["result"] = "submitted"
        except RuntimeError as e:
            state["result"] = str(e)

    t = threading.Thread(target=blocked_producer)
    t.start()
    time.sleep(0.2)  # let it reach the blocking wait
    assert t.is_alive() and not state
    ld.close()
    t.join(timeout=10)
    assert not t.is_alive(), "close() did not release the blocked submit"
    assert state["result"] == "loader is closed"
    assert ld.next() is not None  # what made it in
    assert ld.next() is None
    ld.__exit__()


@pytest.mark.parametrize("loader", LOADERS)
def test_async_loader_u8_mode(loader):
    rng = np.random.default_rng(4)
    imgs = rng.integers(0, 256, (3, 12, 12, 3), dtype=np.uint8)
    want = native.preprocess_batch(imgs, (6, 6), u8_out=True)
    with loader((12, 12, 3), (6, 6), u8_out=True) as ld:
        ld.submit(imgs)
        got = ld.next()
    assert got.dtype == np.uint8 and got.shape == want.shape
    if loader is native.AsyncLoader:
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got.astype(np.int16) - want).max() <= 1
    with pytest.raises(ValueError, match="on-device"):
        loader((12, 12, 3), (6, 6), scale=[1.0] * 3, u8_out=True)


def test_thread_loader_equals_native_loader():
    """The plain loader and the native one hand back the same batches in
    the same order: float32 within the plain version's 1e-4, u8 within one
    step (a float32 sum on either side of a .5)."""
    scale = np.full(3, 2.0, np.float32)
    bias = np.full(3, -1.0, np.float32)
    batches = _loader_batches(n=4, batch=3, seed=2)
    for kw in ({"scale": scale, "bias": bias}, {"u8_out": True}):
        outs = {}
        for loader in LOADERS:
            with loader((32, 24, 3), (48, 48), depth=2, **kw) as ld:
                outs[loader] = _drain(ld, batches)
        got, want = outs[native._ThreadLoader], outs[native.AsyncLoader]
        assert [g.shape for g in got] == [w.shape for w in want]
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            if kw.get("u8_out"):
                assert np.abs(g.astype(np.int16) - w).max() <= 1
            else:
                np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-4)


# ---------------------------------------------------------------------------
# no fallback: a build or load that fails raises
# ---------------------------------------------------------------------------


@pytest.fixture
def isolated_build(tmp_path, monkeypatch):
    """The module pointed at a source and a build directory in tmp_path,
    with no library loaded; the real ones come back afterwards."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")

    def use(source_text):
        src = tmp_path / "preprocess.cpp"
        src.write_text(source_text)
        monkeypatch.setattr(native, "SOURCE", src)

    return use


def test_failed_build_raises_with_gxx_log(isolated_build):
    isolated_build('extern "C" int ov_native_abi_version() { return 3 }\n')  # no ';'
    imgs = np.zeros((1, 8, 8, 3), np.uint8)
    for call in (lambda: native.preprocess_batch(imgs, (4, 4)),
                 lambda: native.preprocess_batch(imgs, (4, 4), u8_out=True),
                 lambda: native.fp16_to_fp32(np.zeros(4, np.float16)),
                 lambda: native.stack_f32([np.zeros(3, np.float32)]),
                 lambda: native.AsyncLoader((8, 8, 3), (4, 4))):
        with pytest.raises(RuntimeError, match=r"g\+\+ failed(.|\n)*error"):
            call()
    assert not native.available()
    assert not list(native.BUILD_DIR.glob("*.so"))


def test_wrong_abi_raises(isolated_build):
    with open(os.path.join(REPO, "pyopenvino_tpu_torch", "native", "preprocess.cpp")) as f:
        text = f.read()
    isolated_build(text.replace("int ov_native_abi_version() { return 3; }",
                                "int ov_native_abi_version() { return 2; }"))
    with pytest.raises(RuntimeError, match="ABI version 2"):
        native.fp16_to_fp32(np.zeros(4, np.float16))


# ---------------------------------------------------------------------------
# the loader into the port's server; an fp16 IR
# ---------------------------------------------------------------------------


def test_async_loader_feeds_server():
    """Raw uint8 frames → the native AsyncLoader (in order) → one submit a
    row into the port's continuous-batching server: each answer within
    rtol 1e-4 / atol 1e-5 of the port's direct infer and of the JAX
    package's XLA answer on the same blob."""
    port = compile_model(read_ir_model(*MNIST), Config(), device="cpu")
    jax = jax_compile(jax_read(*MNIST), JaxConfig(backend=JaxBackend.XLA))
    rng = np.random.default_rng(8)
    batches = [rng.integers(0, 256, (4, 28, 28, 1), dtype=np.uint8) for _ in range(3)]
    with native.AsyncLoader((28, 28, 1), (28, 28), depth=2) as loader, \
            InferenceServer(port, buckets=(1, 2, 4, 8), max_delay_ms=5.0) as srv:
        t = threading.Thread(target=lambda: (
            [loader.submit(b) for b in batches], loader.close()))
        t.start()
        futs, reqs = [], []
        for blob in loader:  # (4, 1, 28, 28) float32, in order
            for row in blob:
                req = row.reshape(1, 1, 28, 28)
                futs.append(srv.submit({"conv2d_input": req}))
                reqs.append(req)
        t.join()
        assert len(futs) == 12
        for fut, req, imgs in zip(futs, reqs, (b[i] for b in batches for i in range(4))):
            np.testing.assert_array_equal(req[0, 0], imgs[..., 0])  # the identity resize
            got = fut.result(timeout=60)
            for ref in (port({"conv2d_input": req}), jax({"conv2d_input": req})):
                assert sorted(got) == sorted(ref)
                for k in ref:
                    np.testing.assert_allclose(got[k], ref[k], rtol=OUT_RTOL, atol=OUT_ATOL)
    assert srv.stats.requests == 12


def test_fp16_ir_parses_bit_equal_and_matches_jax(tmp_path):
    model = with_f16_consts(read_ir_model(*RESNET))
    xml, binp = str(tmp_path / "r16.xml"), str(tmp_path / "r16.bin")
    write_ir_model(model, xml, binp)
    port, jax = read_ir_model(xml, binp), jax_read(xml, binp)
    consts = [n for n in port.nodes.values() if n.op_type == "Const"]
    f16 = {n.id for n in consts if n.outputs[n.out_port].dtype == np.float16}
    assert len(f16) >= 10
    for node in consts:
        want = model.nodes[node.id].const
        if node.id in f16:
            want = want.astype(np.float16).astype(np.float32)
        assert node.const.dtype == jax.nodes[node.id].const.dtype == want.dtype
        assert _bits_equal(node.const, jax.nodes[node.id].const)
        assert _bits_equal(node.const, want)
    param = port.parameters[0]
    name = param.name
    x = np.random.default_rng(5).uniform(0, 255, param.outputs[param.out_port].shape).astype(
        np.float32)
    out = port.results[0].name
    got = compile_model(port, Config(), device="cpu").infer({name: x})[out]
    want = jax_compile(jax, JaxConfig(backend=JaxBackend.XLA)).infer({name: x})[out]
    _assert_matches(got, want)
    # and the float32 IR's answer moved: the weights are fp16 roundings
    f32 = compile_model(read_ir_model(*RESNET), Config(), device="cpu").infer({name: x})[out]
    assert not np.array_equal(got, f32)
