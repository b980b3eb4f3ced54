"""The port's numpy interpreter and quantize against the JAX package's, the
INT8-FULL facade, and full-width MobileNet-v2 INT8-FULL end to end (its
heavy cases live here so that ``--dist loadfile`` runs them beside
ResNet-18's, in test_torch_port_int8full.py, and calibration's, in
test_torch_port_calibration.py).

Inputs are made with numpy from a seed and handed to both packages."""

import numpy as np
import pytest
import torch

from pyopenvino_tpu.ir import read_ir_model as jax_read

from pyopenvino_tpu_torch import IECore
from pyopenvino_tpu_torch.config import Backend, Config, QuantMode
from pyopenvino_tpu_torch.ir import read_ir_model
from pyopenvino_tpu_torch.kernels import conv_direct, gemm
from pyopenvino_tpu_torch.models import synth
from pyopenvino_tpu_torch.ops.spec import TValue
from pyopenvino_tpu_torch.runtime.interpreter import Interpreter
from test_torch_port_int8full import (
    BACKEND_PAIRS,
    Int8FullCase,
    check_int8full_case,
    small_net,
    small_samples,
)
import test_torch_port_threads  # noqa: F401  (this worker's torch threads)

MODELS = ["resnet18", "mobilenet_v2"]


def _paths(name):
    return getattr(synth, f"{name}_paths")(seed=0)


def _images(n, seed):
    rng = np.random.default_rng(seed)
    return [{"data": rng.uniform(0, 1, (1, 3, 224, 224)).astype(np.float32)}
            for _ in range(n)]


def test_quantize_matches_jax_byte_for_byte():
    """Random float32 values plus exact .5 ties (half to even in both) and
    values beyond ±127 codes, at scales whose reciprocal is and is not
    exact."""
    import jax.numpy as jnp

    from pyopenvino_tpu.ops.spec import TValue as JaxTValue

    rng = np.random.default_rng(11)
    for scale in (1.0, 0.5, 0.1, 1 / 7, 0.0123):
        x = (rng.standard_normal(50000) * 60 * scale).astype(np.float32)
        ties = (np.arange(-130, 130) + 0.5).astype(np.float32) * np.float32(scale)
        x = np.concatenate([x, ties])
        want = np.asarray(JaxTValue.quantize(jnp.asarray(x), scale))
        got = TValue.quantize(torch.from_numpy(x), scale)
        assert got.dtype == torch.int8
        assert got.numpy().tobytes() == want.tobytes()
    codes = TValue(torch.tensor([-127, 0, 5], dtype=torch.int8), act_scale=0.25)
    assert codes.dequant().arr.tolist() == [-31.75, 0.0, 1.25]


@pytest.mark.parametrize("name", MODELS)
def test_interpreter_matches_jax_bit_for_bit(name):
    from pyopenvino_tpu.runtime.interpreter import Interpreter as JaxInterpreter

    paths = _paths(name)
    x = _images(1, seed=2)[0]
    seen = []
    got = Interpreter(read_ir_model(*paths)).run(
        x, observe=lambda node, ins, outs: seen.append(node.op_type))
    want = JaxInterpreter(jax_read(*paths)).run(x)
    assert set(got) == set(want) == {"prob"}
    np.testing.assert_array_equal(got["prob"], want["prob"])
    assert got["prob"].shape == (1, 1000)
    assert "Parameter" not in seen and "Const" not in seen and "Result" not in seen


# -- the facade ---------------------------------------------------------------

def test_facade_int8full_set_calibration(tmp_path):
    """INT8_FULL needs samples; ``set_calibration`` provides them, drops
    the compiled networks, and ``infer`` then runs the calibrated network
    on either backend."""
    from pyopenvino_tpu_torch.runtime.compiler import compile_model

    paths = small_net(tmp_path)
    samples = small_samples(2, seed=2)
    x = small_samples(1, seed=3)[0]
    ie = IECore()
    exe = ie.load_network(ie.read_network(*paths), "CPU",
                          config=Config(quant=QuantMode.INT8_FULL))
    with pytest.raises(ValueError, match="calibration"):
        exe.infer(x)
    exe.set_calibration(iter(samples))
    want = compile_model(read_ir_model(*paths), Config(quant=QuantMode.INT8_FULL),
                         device="cpu", calibration_samples=samples).infer(x)["prob"]
    np.testing.assert_array_equal(exe.infer(x)["prob"], want)
    assert exe.compiled()._int8_edges
    exe.kernel_type = "pallas"
    kernels = exe.infer(x)["prob"]
    assert kernels.argmax() == want.argmax()
    exe.set_calibration(small_samples(2, seed=9))
    assert not exe._compiled
    assert exe.compiled().act_scales != compile_model(
        read_ir_model(*paths), Config(quant=QuantMode.INT8_FULL), device="cpu",
        calibration_samples=samples).act_scales


def test_facade_numpy_kernel_type_runs_the_interpreter(tmp_path):
    from pyopenvino_tpu.runtime.interpreter import Interpreter as JaxInterpreter

    paths = small_net(tmp_path)
    xs = np.concatenate([s["data"] for s in small_samples(3, seed=5)])
    ie = IECore()
    exe = ie.load_network(ie.read_network(*paths), "CPU")
    exe.kernel_type = "numpy"
    assert exe.config.backend == Backend.INTERPRETER
    jax_it = JaxInterpreter(jax_read(*paths))
    one = exe.infer({"data": xs[:1]})
    np.testing.assert_array_equal(one["prob"], jax_it.run({"data": xs[:1]})["prob"])
    batch = exe.infer_batch({"data": xs})
    assert batch["prob"].shape == (3, 10)
    for i in range(3):
        np.testing.assert_array_equal(batch["prob"][i],
                                      jax_it.run({"data": xs[i:i + 1]})["prob"][0])
    assert not exe._compiled


# -- full-width MobileNet-v2 ------------------------------------------------

@pytest.fixture(scope="module")
def mobilenet_v2_case():
    return Int8FullCase(synth.mobilenet_v2_paths(seed=0), seed=0)


@pytest.mark.parametrize("backend,jax_backend", BACKEND_PAIRS)
def test_mobilenet_v2_int8full_matches_jax(mobilenet_v2_case, backend, jax_backend,
                                           monkeypatch):
    check_int8full_case(mobilenet_v2_case, backend, jax_backend, monkeypatch)


def test_mobilenet_v2_kernels_route_counts(mobilenet_v2_case, monkeypatch):
    """36 int8 × int8 fused_gemm calls per forward (the 3×3/s2 stem, the 34
    1×1 convs, the classifier) at chip_smoke.py's shapes, no conv2d_direct:
    the depthwise convs take the exact library route."""
    import chip_smoke

    seen = []
    plain = gemm.fused_gemm_plain

    def gemm_spy(a, b, *args, **kw):
        seen.append((str(a.dtype), str(b.dtype), a.shape[0], tuple(b.shape)))
        return plain(a, b, *args, **kw)

    def direct_spy(*args, **kw):
        raise AssertionError("conv2d_direct on MobileNet-v2")

    monkeypatch.setattr(gemm, "fused_gemm_plain", gemm_spy)
    monkeypatch.setattr(conv_direct, "conv2d_direct_plain", direct_spy)
    mobilenet_v2_case.port(Backend.KERNELS)
    assert sorted(seen) == sorted(
        ("torch.int8", "torch.int8", m, (k, n))
        for m, k, n, count in chip_smoke.i8i8_gemms("mobilenet_v2", 1) for _ in range(count))
