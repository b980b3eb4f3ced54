"""Slice 3 end to end: full-width EfficientNet-B0 (224×224, 1000 classes,
the port's ``models/efficientnet_b0.xml`` with the weights that
``models/efficientnet_b0.py`` writes, byte for byte those of
``tools/gen_efficientnet.py``) in FP32 and INT8 weight-only through the
port's public API on the CPU, against the JAX package on the same IR,
weights and inputs: TORCH against XLA and KERNELS (each kernel wrapper
taking its plain version on the CPU) against Pallas in interpret mode,
probabilities at rtol 1e-3 / atol 1e-5 with the same top-5 (the tolerances
of tests/test_efficientnet_b0.py); the numpy interpreter bit for bit; the
fusion plan equal to the JAX package's; the kernels' launches at the shapes
chip_smoke.py checks and times."""

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
from pyopenvino_tpu_torch.models.efficientnet_b0 import efficientnet_b0_paths
import test_torch_port_threads  # noqa: F401  (this worker's torch threads)

RTOL, ATOL = 1e-3, 1e-5
QUANTS = {QuantMode.NONE: JaxQuantMode.NONE,
          QuantMode.INT8_WEIGHT: JaxQuantMode.INT8_WEIGHT}
PAIRS = [("torch", JaxBackend.XLA), ("kernels", JaxBackend.PALLAS)]


@pytest.fixture(scope="module")
def paths():
    return efficientnet_b0_paths(seed=0)


@pytest.fixture(scope="module")
def blobs():
    rng = np.random.default_rng(7)
    return rng.uniform(0, 255, (2, 3, 224, 224)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_refs(paths, blobs):
    """{(quant, JAX backend): (B, 1000) outputs of the JAX package's batch-1
    ``infer``, one image at a time (one compile per network)."""
    model = jax_read(*paths)
    refs = {}
    for quant, jax_quant in QUANTS.items():
        for _, be in PAIRS:
            net = jax_compile(model, JaxConfig(backend=be, quant=jax_quant))
            refs[quant, be] = np.concatenate(
                [net.infer({"data": blobs[i:i + 1]})["prob"] for i in range(len(blobs))])
    return refs


@pytest.fixture(scope="module")
def net(paths):
    return IECore().read_network(*paths)


def _exe(net, quant, kernel_type):
    exe = IECore().load_network(net, "CPU", config=Config(quant=quant))
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
    want = jax_refs[quant, jax_backend]
    got = exe.infer({"data": blobs[:1]})
    assert set(got) == {"prob"}
    _assert_matches(got["prob"], want[:1])
    _assert_matches(exe.infer_batch({"data": blobs})["prob"], want)


def test_int8_weight_keeps_the_ranking(net, blobs):
    """The hot-bias ladder keeps the top classes apart: INT8 weight-only
    gives FP32's top-1 on both images (tests/test_efficientnet_b0.py's
    check on the port)."""
    fp32 = _exe(net, QuantMode.NONE, "torch").infer_batch({"data": blobs})["prob"]
    int8w = _exe(net, QuantMode.INT8_WEIGHT, "torch").infer_batch({"data": blobs})["prob"]
    assert (fp32.argmax(1) == int8w.argmax(1)).all()


def test_interpreter_matches_jax_bit_for_bit(net, paths, blobs):
    from pyopenvino_tpu.runtime.interpreter import Interpreter as JaxInterpreter

    exe = _exe(net, QuantMode.NONE, "numpy")
    got = exe.infer({"data": blobs[:1]})
    want = JaxInterpreter(jax_read(*paths)).run({"data": blobs[:1]})
    assert set(got) == set(want) == {"prob"}
    np.testing.assert_array_equal(got["prob"], want["prob"])


def test_fusions_match_jax(paths):
    """The same epilogue fusions as the JAX package: Conv → Add(bias)
    roots, none into a Swish; the SE convs, which have no bias, unfused."""
    from pyopenvino_tpu.passes.fuse import find_fusions as jax_find_fusions
    from pyopenvino_tpu.passes.shape_infer import infer_shapes as jax_infer_shapes

    from pyopenvino_tpu_torch.ir import read_ir_model
    from pyopenvino_tpu_torch.passes.fuse import find_fusions
    from pyopenvino_tpu_torch.passes.shape_infer import infer_shapes

    model, jmodel = read_ir_model(*paths), jax_read(*paths)
    got = find_fusions(model, infer_shapes(model))
    want = jax_find_fusions(jmodel, jax_infer_shapes(jmodel))
    assert {k: (f.bias_src, f.act, f.out_key, f.skip) for k, f in got.items()} == {
        k: (f.bias_src, f.act, f.out_key, f.skip) for k, f in want.items()}
    assert all(f.act is None for f in got.values())
    assert len(got) == 65 - 32 + 16 + 1  # biased convs, depthwise convs, the FC


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("quant", list(QUANTS))
def test_kernels_route_reaches_the_wrappers(net, blobs, monkeypatch, quant, batch):
    """The 1×1 convs with co >= 128 and ci >= 64 through conv2d_fused, and
    one fused_gemm call more (the classifier), all with an int8 B under
    INT8 weight-only; 1 softmax_rows call.  On the CPU each wrapper hands
    its call to the plain version, which is counted here.  The (M, K, N)
    are those that chip_smoke.py reads from the compiled network."""
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
    table = chip_smoke.launch_table(exe.compiled(), quant.value)
    name = "fused_gemm_i8w" if quant == QuantMode.INT8_WEIGHT else "fused_gemm"
    assert set(table) == {name}
    n_gemm = sum(c for *_, c in table[name])
    assert n_gemm == 17
    int8 = n_gemm if quant == QuantMode.INT8_WEIGHT else 0
    assert calls == {"conv": n_gemm - 1, "gemm": n_gemm, "gemm_int8": int8, "softmax": 1}
    assert sorted(shapes) == sorted(
        (m * batch, k, n) for m, k, n, count in table[name] for _ in range(count))
