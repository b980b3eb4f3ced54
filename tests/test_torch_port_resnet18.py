"""Slices 1 and 2 end to end: full-width ResNet-18 (224×224, 1000 classes,
FP32 and INT8 weight-only, the IR and weights of
``_model_paths("resnet18")``) through the port's public API on the CPU,
against the JAX package's XLA and Pallas (interpret) backends on the same
IR, weights and inputs.

Tolerances are those of tests/test_resnet18.py (rtol 1e-3, atol 1e-5),
with identical top-5 classes."""

import numpy as np
import pytest

from pyopenvino_tpu.config import Backend as JaxBackend
from pyopenvino_tpu.config import Config as JaxConfig
from pyopenvino_tpu.config import QuantMode as JaxQuantMode
from pyopenvino_tpu.ir import read_ir_model as jax_read
from pyopenvino_tpu.runtime.compiler import compile_model as jax_compile

from pyopenvino_tpu_torch import IECore
from pyopenvino_tpu_torch.config import Config, QuantMode
from pyopenvino_tpu_torch.kernels import gemm, softmax
import test_torch_port_threads  # noqa: F401  (this worker's torch threads)

RTOL, ATOL = 1e-3, 1e-5


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    """The IR that ``__graft_entry__._model_paths("resnet18")`` writes
    (same builder, same writer), written to a private directory: parallel
    test workers never race on the shared assets/ files."""
    from pyopenvino_tpu.ir.writer import write_ir_model
    from tools.gen_resnet import build_resnet18

    xml = str(tmp_path_factory.mktemp("resnet18") / "resnet18.xml")
    write_ir_model(build_resnet18(), xml)
    return xml, xml[:-4] + ".bin"


@pytest.fixture(scope="module")
def blobs():
    rng = np.random.default_rng(7)
    return rng.uniform(0, 255, (2, 3, 224, 224)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_refs(paths, blobs):
    """{backend: (batch-1 output, batch-2 infer_batch output)}."""
    model = jax_read(*paths)
    refs = {}
    for be in (JaxBackend.XLA, JaxBackend.PALLAS):
        net = jax_compile(model, JaxConfig(backend=be))
        refs[be] = (net.infer({"data": blobs[:1]})["prob"],
                    net.infer_batch({"data": blobs})["prob"])
    return refs


@pytest.fixture(scope="module")
def exe(paths):
    ie = IECore()
    exe = ie.load_network(ie.read_network(*paths), "CPU")
    exe.kernel_type = "pallas"
    return exe


def _assert_matches(got, want):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    for g, w in zip(got, want):
        assert list(np.argsort(g)[::-1][:5]) == list(np.argsort(w)[::-1][:5])


@pytest.mark.parametrize("jax_backend", [JaxBackend.XLA, JaxBackend.PALLAS])
def test_kernels_backend_batch1(exe, blobs, jax_refs, jax_backend):
    got = exe.infer({"data": blobs[:1]})
    assert set(got) == {"prob"}
    _assert_matches(got["prob"], jax_refs[jax_backend][0])


@pytest.mark.parametrize("jax_backend", [JaxBackend.XLA, JaxBackend.PALLAS])
def test_kernels_backend_infer_batch(exe, blobs, jax_refs, jax_backend):
    got = exe.infer_batch({"data": blobs})
    assert got["prob"].shape == (2, 1000)
    _assert_matches(got["prob"], jax_refs[jax_backend][1])


def test_torch_backend_matches_xla(paths, blobs, jax_refs):
    ie = IECore()
    exe = ie.load_network(ie.read_network(*paths), "CPU")
    exe.kernel_type = "xla"
    _assert_matches(exe.infer({"data": blobs[:1]})["prob"],
                    jax_refs[JaxBackend.XLA][0])
    _assert_matches(exe.infer_batch({"data": blobs})["prob"],
                    jax_refs[JaxBackend.XLA][1])


@pytest.mark.parametrize("batch", [1, 2])
def test_kernels_route_reaches_both_wrappers(exe, blobs, monkeypatch, batch):
    """4 fused_gemm calls (3 projection shortcuts + the FC) and 1
    softmax_rows call per forward, at any batch: on the CPU each wrapper
    hands its call to the plain version, which is counted here."""
    calls = {"gemm": 0, "softmax": 0}
    plain_gemm, plain_softmax = gemm.fused_gemm_plain, softmax.softmax_rows_plain

    def counting_gemm(*args, **kw):
        calls["gemm"] += 1
        return plain_gemm(*args, **kw)

    def counting_softmax(*args, **kw):
        calls["softmax"] += 1
        return plain_softmax(*args, **kw)

    monkeypatch.setattr(gemm, "fused_gemm_plain", counting_gemm)
    monkeypatch.setattr(softmax, "softmax_rows_plain", counting_softmax)
    if batch == 1:
        exe.infer({"data": blobs[:1]})
    else:
        exe.infer_batch({"data": blobs[:batch]})
    assert calls == {"gemm": 4, "softmax": 1}


def test_capture_logits_matches_jax(paths, exe, blobs):
    """The logits (the FC's fused bias Add, ``add_28``) against the JAX
    package's per-node capture."""
    ref = jax_compile(jax_read(*paths), JaxConfig(backend=JaxBackend.XLA))
    _, want = ref.infer_with_capture({"data": blobs[:1]}, ["add_28"])
    out, got = exe.compiled().infer_with_capture({"data": blobs[:1]}, ["add_28"])
    np.testing.assert_allclose(got["add_28"], want["add_28"], rtol=RTOL,
                               atol=1e-4 * np.abs(want["add_28"]).max())
    with pytest.raises(KeyError, match="fused epilogue"):
        exe.compiled().infer_with_capture({"data": blobs[:1]}, ["matmul_0"])


def test_load_weights_from_jax_checkpoint(paths, blobs, tmp_path):
    """JAX save_weights of seeded-perturbed weights → port load_weights →
    the JAX package's perturbed outputs (and the cached GEMM matrices are
    rebuilt, not reused)."""
    ref = jax_compile(jax_read(*paths), JaxConfig(backend=JaxBackend.XLA))
    rng = np.random.default_rng(123)
    ref.weights = {
        k: v * np.float32(rng.uniform(0.8, 1.2)) if v.dtype == np.float32 else v
        for k, v in ref.weights.items()
    }
    ckpt = str(tmp_path / "resnet18_perturbed.npz")
    ref.save_weights(ckpt)
    want = ref.infer({"data": blobs[:1]})["prob"]

    ie = IECore()
    exe = ie.load_network(ie.read_network(*paths), "CPU")
    exe.kernel_type = "kernels"
    before = exe.infer({"data": blobs[:1]})["prob"]  # fills the GEMM caches
    assert np.abs(before - want).max() > 1e-3
    net = exe.compiled()
    net.load_weights(ckpt)
    _assert_matches(exe.infer({"data": blobs[:1]})["prob"], want)

    with np.load(ckpt) as data:
        arrays = {k: data[k] for k in data.files}
    net.load_weights(arrays)
    _assert_matches(exe.infer({"data": blobs[:1]})["prob"], want)
    first = sorted(arrays)[0]
    with pytest.raises(KeyError, match="missing"):
        net.load_weights({k: v for k, v in arrays.items() if k != first})
    with pytest.raises(KeyError, match="unknown weight"):
        net.load_weights({**arrays, "999": arrays[first]})
    with pytest.raises(ValueError, match="checkpoint"):
        net.load_weights({**arrays, first: arrays[first][:1]})


# -- INT8 weight-only (slice 2) -------------------------------------------

@pytest.fixture(scope="module")
def jax_int8w_refs(paths, blobs):
    """{backend: (batch-1 output, batch-2 infer_batch output)}, INT8_WEIGHT."""
    model = jax_read(*paths)
    refs = {}
    for be in (JaxBackend.XLA, JaxBackend.PALLAS):
        net = jax_compile(model, JaxConfig(backend=be, quant=JaxQuantMode.INT8_WEIGHT))
        refs[be] = (net.infer({"data": blobs[:1]})["prob"],
                    net.infer_batch({"data": blobs})["prob"])
    return refs


def _int8w_exe(paths, kernel_type):
    ie = IECore()
    exe = ie.load_network(ie.read_network(*paths), "CPU",
                          config=Config(quant=QuantMode.INT8_WEIGHT))
    exe.kernel_type = kernel_type
    return exe


@pytest.mark.parametrize("kernel_type,jax_backend", [
    ("torch", JaxBackend.XLA), ("kernels", JaxBackend.PALLAS)])
def test_int8w_matches_jax(paths, blobs, jax_int8w_refs, kernel_type, jax_backend):
    """TORCH dequantizes each weight before its conv (the XLA route);
    KERNELS scales the int8 GEMMs' accumulators (the Pallas route)."""
    exe = _int8w_exe(paths, kernel_type)
    _assert_matches(exe.infer({"data": blobs[:1]})["prob"], jax_int8w_refs[jax_backend][0])
    _assert_matches(exe.infer_batch({"data": blobs})["prob"], jax_int8w_refs[jax_backend][1])


def test_int8w_kernels_route_takes_int8_operands(paths, blobs, monkeypatch):
    """The 3 projection shortcuts and the FC reach fused_gemm with an int8
    B and an (N,) scale, at the shapes chip_smoke.py checks and times."""
    import chip_smoke

    seen = []
    plain_gemm = gemm.fused_gemm_plain

    def recording_gemm(a, b, scale=None, *args, **kw):
        seen.append((str(b.dtype), a.shape[0], tuple(b.shape), tuple(scale.shape)))
        return plain_gemm(a, b, scale, *args, **kw)

    monkeypatch.setattr(gemm, "fused_gemm_plain", recording_gemm)
    _int8w_exe(paths, "kernels").infer_batch({"data": blobs})
    assert seen == [("torch.int8", m, (k, n), (n,))
                    for m, k, n, _ in chip_smoke.resnet18_gemms(len(blobs))]


def test_int8w_top1_equals_fp32(exe, paths, blobs):
    """As tests/test_resnet18.py asserts for the JAX package."""
    int8w = _int8w_exe(paths, "kernels").infer_batch({"data": blobs})["prob"]
    fp32 = exe.infer_batch({"data": blobs})["prob"]
    assert (int8w.argmax(1) == fp32.argmax(1)).all()
    assert np.abs(int8w - fp32).max() > 0
