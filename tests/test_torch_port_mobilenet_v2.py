"""Slice 2 end to end: full-width MobileNet-v2 (224×224, 1000 classes, the IR
and weights of ``_model_paths("mobilenet-v2")``) in FP32 and INT8 weight-only
through the port's public API on the CPU, against the JAX package on the
same IR, weights and inputs: the port's TORCH backend against the JAX
package's XLA backend, and its KERNELS backend (each kernel wrapper taking
its plain version on the CPU) against the Pallas backend in interpret mode.

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
from pyopenvino_tpu_torch.kernels import conv, gemm, softmax
import test_torch_port_threads  # noqa: F401  (this worker's torch threads)

RTOL, ATOL = 1e-3, 1e-5
QUANTS = {QuantMode.NONE: JaxQuantMode.NONE,
          QuantMode.INT8_WEIGHT: JaxQuantMode.INT8_WEIGHT}
# port kernel_type → the JAX backend it is held against
PAIRS = [("torch", JaxBackend.XLA), ("kernels", JaxBackend.PALLAS)]


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    """The IR that ``__graft_entry__._model_paths("mobilenet-v2")`` writes
    (same builder, same writer), written to a private directory: parallel
    test workers never race on the shared assets/ files."""
    from pyopenvino_tpu.ir.writer import write_ir_model
    from tools.gen_mobilenet import build_mobilenet_v2

    xml = str(tmp_path_factory.mktemp("mobilenet-v2") / "mobilenet-v2.xml")
    write_ir_model(build_mobilenet_v2(), xml)
    return xml, xml[:-4] + ".bin"


@pytest.fixture(scope="module")
def blobs():
    rng = np.random.default_rng(7)
    return rng.uniform(0, 255, (2, 3, 224, 224)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_refs(paths, blobs):
    """{(quant, JAX backend): (batch-1 output, batch-2 infer_batch output)}."""
    model = jax_read(*paths)
    refs = {}
    for quant, jax_quant in QUANTS.items():
        for _, be in PAIRS:
            net = jax_compile(model, JaxConfig(backend=be, quant=jax_quant))
            refs[quant, be] = (net.infer({"data": blobs[:1]})["prob"],
                               net.infer_batch({"data": blobs})["prob"])
    return refs


@pytest.fixture(scope="module")
def net(paths):
    return IECore().read_network(*paths)


def _exe(net, quant, kernel_type, **config):
    exe = IECore().load_network(net, "CPU", config=Config(quant=quant, **config))
    exe.kernel_type = kernel_type
    return exe


def _assert_matches(got, want):
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    for g, w in zip(got, want):
        assert list(np.argsort(g)[::-1][:5]) == list(np.argsort(w)[::-1][:5])


@pytest.mark.parametrize("kernel_type,jax_backend", PAIRS)
@pytest.mark.parametrize("quant", list(QUANTS))
def test_port_matches_jax(net, blobs, jax_refs, quant, kernel_type, jax_backend):
    exe = _exe(net, quant, kernel_type)
    want_one, want_batch = jax_refs[quant, jax_backend]
    got = exe.infer({"data": blobs[:1]})
    assert set(got) == {"prob"}
    _assert_matches(got["prob"], want_one)
    _assert_matches(exe.infer_batch({"data": blobs})["prob"], want_batch)


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("quant", list(QUANTS))
def test_kernels_route_reaches_the_wrappers(net, blobs, monkeypatch, quant, batch):
    """15 1×1 convs (co >= 128, ci >= 64) through conv2d_fused, and 16
    fused_gemm calls (those 15 + the classifier), all with an int8 B under
    INT8 weight-only; 1 softmax_rows call.  On the CPU each wrapper hands
    its call to the plain version, which is counted here.  The (M, K, N)
    of the GEMMs are the shapes chip_smoke.py checks and times."""
    import chip_smoke

    calls = {"conv": 0, "gemm": 0, "gemm_int8": 0, "softmax": 0}
    shapes = []
    plain_gemm, plain_softmax = gemm.fused_gemm_plain, softmax.softmax_rows_plain
    conv2d_fused = conv.conv2d_fused

    def counting_conv(*args, **kw):
        calls["conv"] += 1
        return conv2d_fused(*args, **kw)

    def counting_gemm(a, b, *args, **kw):
        calls["gemm"] += 1
        calls["gemm_int8"] += int(str(b.dtype) == "torch.int8")
        shapes.append((a.shape[0], *b.shape))
        return plain_gemm(a, b, *args, **kw)

    def counting_softmax(*args, **kw):
        calls["softmax"] += 1
        return plain_softmax(*args, **kw)

    monkeypatch.setattr(conv, "conv2d_fused", counting_conv)
    monkeypatch.setattr(gemm, "fused_gemm_plain", counting_gemm)
    monkeypatch.setattr(softmax, "softmax_rows_plain", counting_softmax)
    exe = _exe(net, quant, "kernels")
    if batch == 1:
        exe.infer({"data": blobs[:1]})
    else:
        exe.infer_batch({"data": blobs[:batch]})
    int8 = 16 if quant == QuantMode.INT8_WEIGHT else 0
    assert calls == {"conv": 15, "gemm": 16, "gemm_int8": int8, "softmax": 1}
    assert sorted(shapes) == sorted(
        (m, k, n) for m, k, n, count in chip_smoke.mobilenet_v2_gemms(batch)
        for _ in range(count))


@pytest.mark.parametrize("quant", list(QUANTS))
def test_depthwise_modes_agree(net, blobs, jax_refs, quant):
    """``depthwise_mode="shifted_mac"`` (17 depthwise convs as 9 shifted
    multiply-adds each) against the native grouped conv and the JAX
    package's XLA backend."""
    native = _exe(net, quant, "torch").infer_batch({"data": blobs})["prob"]
    shifted = _exe(net, quant, "torch", depthwise_mode="shifted_mac")
    got = shifted.infer_batch({"data": blobs})["prob"]
    _assert_matches(got, native)
    _assert_matches(got, jax_refs[quant, JaxBackend.XLA][1])


def test_int8w_top1_equals_fp32(net, blobs):
    """As tests/test_mobilenet_v2.py asserts for the JAX package."""
    fp32 = _exe(net, QuantMode.NONE, "kernels").infer_batch({"data": blobs})["prob"]
    int8w = _exe(net, QuantMode.INT8_WEIGHT, "kernels").infer_batch({"data": blobs})["prob"]
    assert (fp32.argmax(1) == int8w.argmax(1)).all()
    assert np.abs(int8w - fp32).max() > 0  # the weights really were quantized


def test_fusions_match_jax(paths):
    """17 depthwise Conv → Add(bias) → Clamp chains fuse; the residual Adds
    after the linear bottlenecks do not."""
    from pyopenvino_tpu.passes.fuse import find_fusions as jax_find_fusions
    from pyopenvino_tpu.passes.shape_infer import infer_shapes as jax_infer_shapes

    from pyopenvino_tpu_torch.ir import read_ir_model
    from pyopenvino_tpu_torch.passes.fuse import find_fusions
    from pyopenvino_tpu_torch.passes.shape_infer import infer_shapes

    port, ref = read_ir_model(*paths), jax_read(*paths)
    got = find_fusions(port, infer_shapes(port))
    want = jax_find_fusions(ref, jax_infer_shapes(ref))
    assert {k: (f.bias_src, f.act, f.out_key, f.skip) for k, f in got.items()} == {
        k: (f.bias_src, f.act, f.out_key, f.skip) for k, f in want.items()}
    group_roots = [k for k in got if port.nodes[k].op_type == "GroupConvolution"]
    assert len(group_roots) == 17
    assert all(got[k].act == ("clamp", 0.0, 6.0) for k in group_roots)
    skipped = {nid for f in got.values() for nid in f.skip}
    residual = [n for n in port.find_by_type("Add")
                if all(port.nodes[s].op_type != "Const"
                       for s, _ in port.in_edges[n.id].values())]
    assert len(residual) == 10 and not skipped & {n.id for n in residual}


def test_shipped_xml_is_what_the_generator_writes(paths):
    from pyopenvino_tpu_torch.models.synth import MOBILENET_V2_XML

    with open(paths[0], "rb") as f, open(MOBILENET_V2_XML, "rb") as g:
        assert f.read() == g.read()


def test_synthesized_weights_equal_gen_weights(tmp_path):
    from pyopenvino_tpu.ir import read_ir_model as jax_read_ir
    from tools.gen_weights import generate_weights as jax_generate

    from pyopenvino_tpu_torch.ir import read_ir_model
    from pyopenvino_tpu_torch.models.synth import MOBILENET_V2_XML, generate_weights

    missing = str(tmp_path / "no-such.bin")
    port = generate_weights(read_ir_model(MOBILENET_V2_XML, missing), seed=3)
    assert port == jax_generate(jax_read_ir(MOBILENET_V2_XML, missing), seed=3)
    assert len(port) == 13951392
