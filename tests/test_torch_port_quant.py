"""INT8 weight-only in the port against the JAX package: weight quantization,
the int8-B fused_gemm and conv2d_fused (plain versions on the CPU) against
the Pallas kernels in interpret mode, checkpoints written by the JAX
package, the ops' int8 and depthwise routes, and the options that are not
ported yet.

Inputs are made with numpy from a seed and handed to both packages."""

import types

import numpy as np
import pytest
import torch

from pyopenvino_tpu.config import Backend as JaxBackend
from pyopenvino_tpu.config import Config as JaxConfig
from pyopenvino_tpu.config import QuantMode as JaxQuantMode
from pyopenvino_tpu.ir import read_ir_model as jax_read
from pyopenvino_tpu.runtime.compiler import compile_model as jax_compile

from pyopenvino_tpu_torch import IECore
from pyopenvino_tpu_torch.config import Config, QuantMode
from pyopenvino_tpu_torch.ir import read_ir_model
from pyopenvino_tpu_torch.kernels.conv import conv2d_fused
from pyopenvino_tpu_torch.kernels.gemm import fused_gemm, fused_gemm_plain
from pyopenvino_tpu_torch.passes.quantize import quantize_weights
import test_torch_port_threads  # noqa: F401  (this worker's torch threads)

# f32 products of int8-valued operands summed in another order than the
# interpreted Pallas kernel's; 1e-4 of the output's largest magnitude is
# tests/test_pallas.py's tolerance for the same kernel.
GEMM_RTOL = 1e-4
RTOL, ATOL = 1e-3, 1e-5


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _write(tmp_path_factory, name, build):
    """The IR that ``__graft_entry__._model_paths(name)`` writes (same
    builder, same writer), in a private directory: parallel test workers
    never race on the shared assets/ files."""
    from pyopenvino_tpu.ir.writer import write_ir_model

    xml = str(tmp_path_factory.mktemp(name) / f"{name}.xml")
    write_ir_model(build(), xml)
    return xml, xml[:-4] + ".bin"


@pytest.fixture(scope="module")
def model_paths(tmp_path_factory):
    from tools.gen_mobilenet import build_mobilenet_v2
    from tools.gen_resnet import build_resnet18

    return {
        "resnet18": _write(tmp_path_factory, "resnet18", build_resnet18),
        "mobilenet-v2": _write(tmp_path_factory, "mobilenet-v2",
                               build_mobilenet_v2),
    }


def _assert_same_quantization(got, want):
    assert sorted(got) == sorted(want)
    for nid, (codes, scales) in want.items():
        mine, my_scales = got[nid]
        assert mine.dtype == codes.dtype == np.int8
        assert mine.shape == codes.shape
        assert mine.tobytes() == codes.tobytes()
        assert my_scales.dtype == scales.dtype == np.float32
        assert my_scales.shape == scales.shape
        assert my_scales.tobytes() == scales.tobytes()


@pytest.mark.parametrize("name,min_elems", [
    ("resnet18", 0), ("resnet18", 10000),
    ("mobilenet-v2", 0), ("mobilenet-v2", 1000),
])
def test_quantize_weights_bit_identical(model_paths, name, min_elems):
    from pyopenvino_tpu.passes.quantize import quantize_weights as jax_quantize

    xml, binp = model_paths[name]
    want = jax_quantize(jax_read(xml, binp), min_elems)
    got = quantize_weights(read_ir_model(xml, binp), min_elems)
    _assert_same_quantization(got, want)
    # conv OIHW → (Co,1,1,1); depthwise GOIHW → (G,Co,1,1,1); MatMul → (1,N)
    shapes = {s.shape for _, s in got.values()}
    if min_elems == 0:
        assert len(got) == {"resnet18": 21, "mobilenet-v2": 53}[name]
        assert {(1, 1000), (512 if name == "resnet18" else 1280, 1, 1, 1)} <= shapes
        if name == "mobilenet-v2":
            assert (960, 1, 1, 1, 1) in shapes
    else:
        assert 0 < len(got) < {"resnet18": 21, "mobilenet-v2": 53}[name]


def test_quantize_transpose_b_shared_const_and_min_elems(tmp_path):
    """A transpose_b MatMul quantizes per row; a Const read by two MatMuls
    with opposite transpose_b has no single channel axis and stays float;
    a weight below ``min_elems`` stays float."""
    from pyopenvino_tpu.ir.builder import GraphBuilder
    from pyopenvino_tpu.ir.writer import write_ir_model
    from pyopenvino_tpu.passes.quantize import quantize_weights as jax_quantize

    rng = np.random.default_rng(4)
    b = GraphBuilder("q")
    x = b.parameter("x", (2, 8))
    wt = b.const(rng.standard_normal((6, 8)).astype(np.float32))
    shared = b.const(rng.standard_normal((8, 8)).astype(np.float32))
    small = b.const(rng.standard_normal((8, 3)).astype(np.float32))
    b.result(b.matmul(x, wt, transpose_b=True), name="y_tb")
    b.result(b.matmul(x, shared), name="y_shared")
    b.result(b.matmul(x, shared, transpose_b=True), name="y_shared_tb")
    b.result(b.matmul(x, small), name="y_small")
    xml = str(tmp_path / "q.xml")
    write_ir_model(b.build(), xml)
    binp = xml[:-4] + ".bin"

    port, ref = read_ir_model(xml, binp), jax_read(xml, binp)
    for min_elems in (0, 30):
        got = quantize_weights(port, min_elems)
        _assert_same_quantization(got, jax_quantize(ref, min_elems))
        by_shape = {port.nodes[nid].const.shape: s.shape for nid, (_, s) in got.items()}
        assert by_shape.get((6, 8)) == (6, 1)  # per output row under transpose_b
        assert (8, 8) not in by_shape          # shared under conflicting axes
        assert ((8, 3) in by_shape) == (min_elems == 0)


INT8_GEMM_CASES = [
    # tests/test_pallas.py's int8 cases, then path shapes and ragged ones
    (200, 300, 100, True, ("relu", 0.0, 0.0)),
    (64, 512, 96, False, ("clamp", 0.0, 6.0)),
    (49, 576, 160, True, None),     # MobileNet-v2's 576 → 160 project, B = 1
    (1, 1280, 1000, True, None),    # MobileNet-v2's classifier, B = 1
    (3, 33, 7, False, None),
]


@pytest.mark.parametrize("m,k,n,use_bias,act", INT8_GEMM_CASES)
def test_int8_fused_gemm_plain_vs_pallas(m, k, n, use_bias, act):
    import jax.numpy as jnp

    from pyopenvino_tpu.kernels.gemm import fused_gemm as jax_fused_gemm

    rng = np.random.default_rng(42 + m + k + n)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.integers(-127, 128, (k, n)).astype(np.int8)
    scale = rng.uniform(0.01, 0.02, n).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32) if use_bias else None
    want = np.asarray(jax_fused_gemm(
        jnp.asarray(a), jnp.asarray(b), scale=jnp.asarray(scale),
        bias=None if bias is None else jnp.asarray(bias), act=act,
        interpret=True))
    t = lambda v: None if v is None else torch.from_numpy(v)  # noqa: E731
    got = fused_gemm(t(a), t(b), t(scale), t(bias), act)  # CPU: the plain version
    torch.testing.assert_close(
        got, fused_gemm_plain(t(a), t(b), t(scale), t(bias), act), rtol=0, atol=0)
    assert got.shape == (m, n) and got.dtype == torch.float32
    assert _rel_err(got.numpy(), want) <= GEMM_RTOL


def test_int8_fused_gemm_needs_a_scale():
    a = torch.zeros((2, 3))
    b = torch.zeros((3, 4), dtype=torch.int8)
    with pytest.raises(ValueError, match="dequant scale"):
        fused_gemm(a, b)


@pytest.mark.parametrize("n,h,w,ci,co,stride,act", [
    (1, 14, 14, 64, 384, 1, ("clamp", 0.0, 6.0)),  # MobileNet-v2 expand
    (2, 28, 28, 128, 256, 2, None),               # ResNet-18 shortcut, B = 2
    (1, 7, 5, 65, 130, 1, ("relu", 0.0, 0.0)),
])
def test_int8_conv2d_fused_vs_pallas(n, h, w, ci, co, stride, act):
    import jax.numpy as jnp

    from pyopenvino_tpu.kernels.conv import conv2d_fused as jax_conv2d_fused

    rng = np.random.default_rng(ci + co + h)
    x = rng.standard_normal((n, h, w, ci)).astype(np.float32)
    wq = rng.integers(-127, 128, (co, ci, 1, 1)).astype(np.int8)
    scale = rng.uniform(0.001, 0.01, co).astype(np.float32)
    bias = rng.standard_normal(co).astype(np.float32)
    want = np.asarray(jax_conv2d_fused(
        jnp.asarray(x), jnp.asarray(wq), scale=jnp.asarray(scale),
        bias=jnp.asarray(bias), act=act, strides=(stride, stride),
        interpret=True))
    got = conv2d_fused(torch.from_numpy(x), torch.from_numpy(wq),
                       scale=torch.from_numpy(scale),
                       bias=torch.from_numpy(bias), act=act,
                       strides=(stride, stride))
    assert got.shape == want.shape
    assert _rel_err(got.numpy(), want) <= GEMM_RTOL


def test_load_weights_from_jax_int8w_checkpoint(model_paths, tmp_path):
    """The JAX package's save_weights of an INT8 weight-only network (int8
    codes + float32 scales, seeded perturbation of both) → the port's
    load_weights → the JAX package's outputs, on both backends; the cached
    int8 GEMM matrices are rebuilt, not reused."""
    xml, binp = model_paths["mobilenet-v2"]
    x = np.random.default_rng(7).uniform(0, 255, (1, 3, 224, 224)).astype(np.float32)
    ref = jax_compile(jax_read(xml, binp), JaxConfig(
        backend=JaxBackend.XLA, quant=JaxQuantMode.INT8_WEIGHT))
    rng = np.random.default_rng(123)
    perturbed = {}
    for k, v in ref.weights.items():
        v = np.asarray(v)
        if v.dtype == np.int8:
            v = np.clip(v.astype(np.int32) + rng.integers(-9, 10, v.shape),
                        -127, 127).astype(np.int8)
        elif v.dtype == np.float32:
            v = v * np.float32(rng.uniform(0.8, 1.2))
        perturbed[k] = v
    assert any(v.dtype == np.int8 for v in perturbed.values())
    ref.weights = perturbed
    ckpt = str(tmp_path / "mobilenet_v2_int8w.npz")
    ref.save_weights(ckpt)
    want = ref.infer({"data": x})["prob"]

    ie = IECore()
    net = ie.read_network(xml, binp)
    for kernel_type in ("kernels", "torch"):
        exe = ie.load_network(net, "CPU", config=Config(quant=QuantMode.INT8_WEIGHT))
        exe.kernel_type = kernel_type
        before = exe.infer({"data": x})["prob"]  # fills the GEMM caches
        assert np.abs(before - want).max() > 1e-4
        compiled = exe.compiled()
        assert {str(v.dtype) for v in compiled.weights.values()} == {
            "torch.int8", "torch.float32"}
        compiled.load_weights(ckpt)
        got = exe.infer({"data": x})["prob"]
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        assert list(np.argsort(got[0])[::-1][:5]) == list(np.argsort(want[0])[::-1][:5])
    with pytest.raises(ValueError, match="checkpoint"):
        scale_key = next(k for k in perturbed if k.endswith(".scale"))
        compiled.load_weights({**perturbed, scale_key: perturbed[scale_key].astype(np.float64)})


def test_tf32_off_after_compiling_int8w(model_paths, monkeypatch):
    """INT8 weight-only computes in float32 (its weights are dequantized to
    float32 for cuDNN), so compiling it turns TF32 off like FP32 does."""
    from pyopenvino_tpu_torch.runtime.compiler import compile_model

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    model = read_ir_model(*model_paths["resnet18"])
    compile_model(model, Config(quant=QuantMode.INT8_WEIGHT), device="cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


@pytest.mark.parametrize("config", [
    Config(bias_correction=True),
    Config(quant=QuantMode.INT8_WEIGHT, bias_correction=True),
    Config(compute_dtype="bfloat16"),
])
def test_unported_options_raise_naming_the_roadmap(model_paths, config, tmp_path):
    """On a model with its weights, as in the JAX package: bias correction
    with float weights does nothing; with INT8 weight-only and no
    calibration samples it raises.  bfloat16 compute runs: the float
    weights are bfloat16 on the device, the output keeps its declared
    float32, and the probabilities follow the JAX package's bfloat16 run
    (XLA) within 4e-3 with the same top-1; an unknown compute dtype
    raises."""
    from pyopenvino_tpu_torch.runtime.compiler import compile_model

    model = read_ir_model(*model_paths["resnet18"])
    if config.compute_dtype != "float32":
        x = {"data": np.random.default_rng(8).uniform(0, 1, (1, 3, 224, 224)).astype(np.float32)}
        net = compile_model(model, config, device="cpu")
        assert {v.dtype for v in net.weights.values() if v.is_floating_point()} == {
            torch.bfloat16}
        got = net.infer(x)["prob"]
        want = jax_compile(jax_read(*model_paths["resnet18"]),
                           JaxConfig(compute_dtype="bfloat16")).infer(x)["prob"]
        assert got.dtype == np.float32 and want.dtype == np.float32
        assert np.abs(got - want).max() <= 4e-3
        assert got.argmax() == want.argmax()
        with pytest.raises(ValueError, match="compute_dtype"):
            compile_model(model, config.replace(compute_dtype="float16"), device="cpu")
        return
    if config.quant == QuantMode.INT8_WEIGHT:
        with pytest.raises(ValueError, match="calibration_samples"):
            compile_model(model, config, device="cpu")
        with pytest.raises(ValueError, match="calibration_samples"):
            jax_compile(jax_read(*model_paths["resnet18"]),
                        JaxConfig(quant=JaxQuantMode.INT8_WEIGHT, bias_correction=True))
        return
    x = {"data": np.random.default_rng(8).uniform(0, 1, (1, 3, 224, 224)).astype(np.float32)}
    net = compile_model(model, config, device="cpu")
    assert net._bias_corr == {}
    np.testing.assert_array_equal(
        net.infer(x)["prob"], compile_model(model, Config(), device="cpu").infer(x)["prob"])


def test_config_fields_match_the_jax_package():
    import dataclasses

    from pyopenvino_tpu.config import Config as JaxConf

    jax_fields = {f.name: f.default for f in dataclasses.fields(JaxConf)}
    for f in dataclasses.fields(Config):
        if f.name in ("backend", "quant"):
            continue
        assert jax_fields[f.name] == f.default, f.name
    with pytest.raises(ValueError, match="depthwise_mode"):
        from pyopenvino_tpu_torch.config import check_supported

        check_supported(Config(depthwise_mode="winograd"))


# -- the ops' int8 and depthwise routes against the JAX package's reference --

def _ctx(use_kernels, depthwise_mode="native", weight=None):
    """A stand-in for the compiler's EmitCtx: weight_for dequantizes as it
    does, derived_weight makes the operand from ``weight``."""
    from pyopenvino_tpu_torch.runtime.compiler import EmitCtx

    return types.SimpleNamespace(
        use_kernels=use_kernels, depthwise_mode=depthwise_mode,
        compute_dtype=torch.float32, weight_for=EmitCtx.weight_for,
        derived_weight=lambda node, port, tag, make: make(weight))


def _nodes(op_type, attrs, out_port):
    from pyopenvino_tpu.ir.model import Node as JaxNode

    from pyopenvino_tpu_torch.ir.model import Node

    kw = dict(id=0, name="n", op_type=op_type, attrs=attrs, inputs={},
              outputs={out_port: None})
    return Node(**kw), JaxNode(**kw)


def _quantized(w, axes):
    from pyopenvino_tpu_torch.passes.quantize import _quantize_array

    q, s = _quantize_array(w, axes)
    return q, s, q.astype(np.float32) * s


@pytest.mark.parametrize("use_kernels,w_shape,attrs", [
    (True, (384, 64, 1, 1), {"strides": "1,1", "pads_begin": "0,0",
                             "pads_end": "0,0", "dilations": "1,1"}),
    (False, (384, 64, 1, 1), {"strides": "1,1", "pads_begin": "0,0",
                              "pads_end": "0,0", "dilations": "1,1"}),
    (True, (32, 3, 3, 3), {"strides": "2,2", "pads_begin": "1,1",
                           "pads_end": "1,1", "dilations": "1,1"}),
])
def test_int8_convolution_routes_match_jax_reference(use_kernels, w_shape, attrs):
    """Both routes against the JAX reference conv on the dequantized
    weight, with a fused bias and ReLU6."""
    from pyopenvino_tpu.ops import get_op as jax_get_op

    from pyopenvino_tpu_torch.ops import TValue, get_op

    node, jnode = _nodes("Convolution", attrs, 2)
    rng = np.random.default_rng(sum(w_shape))
    x = rng.standard_normal((2, w_shape[1], 9, 10)).astype(np.float32)
    q, s, deq = _quantized(rng.standard_normal(w_shape).astype(np.float32), (0,))
    bias = rng.standard_normal(w_shape[0]).astype(np.float32)
    want = np.clip(jax_get_op("Convolution").ref_compute(jnode, {0: x, 1: deq})[2]
                   + bias.reshape(1, -1, 1, 1), 0.0, 6.0)
    xt = torch.from_numpy(x).contiguous(memory_format=torch.channels_last)
    tv_w = TValue(torch.from_numpy(q), qscale=torch.from_numpy(s))
    got = get_op("Convolution").emit_fused(
        _ctx(use_kernels, weight=torch.from_numpy(q)), node, {0: TValue(xt), 1: tv_w},
        bias=torch.from_numpy(bias), act=("clamp", 0.0, 6.0))[2].arr
    assert tuple(got.shape) == want.shape
    assert _rel_err(got.numpy(), want) <= GEMM_RTOL


@pytest.mark.parametrize("use_kernels,a_shape,w_shape,tb", [
    (True, (1, 1280), (1280, 1000), False),   # MobileNet-v2's classifier
    (True, (3, 40), (24, 40), True),
    (False, (3, 40), (24, 40), True),
    (False, (2, 512), (512, 1000), False),
])
def test_int8_matmul_routes_match_jax_reference(use_kernels, a_shape, w_shape, tb):
    from pyopenvino_tpu.ops import get_op as jax_get_op

    from pyopenvino_tpu_torch.ops import TValue, get_op

    attrs = {"transpose_a": "false", "transpose_b": str(tb).lower()}
    node, jnode = _nodes("MatMul", attrs, 2)
    rng = np.random.default_rng(sum(a_shape) + sum(w_shape))
    a = rng.standard_normal(a_shape).astype(np.float32)
    q, s, deq = _quantized(rng.standard_normal(w_shape).astype(np.float32),
                           (0,) if tb else (1,))
    want = jax_get_op("MatMul").ref_compute(jnode, {0: a, 1: deq})[2]
    tv_w = TValue(torch.from_numpy(q), qscale=torch.from_numpy(s))
    got = get_op("MatMul").emit(
        _ctx(use_kernels, weight=torch.from_numpy(q)), node,
        {0: TValue(torch.from_numpy(a)), 1: tv_w})[2].arr
    assert tuple(got.shape) == want.shape
    assert _rel_err(got.numpy(), want) <= GEMM_RTOL


@pytest.mark.parametrize("mode", ["native", "shifted_mac"])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("g,co,ci,attrs", [
    (16, 1, 1, {"strides": "2,2", "pads_begin": "1,1", "pads_end": "1,1",
                "dilations": "1,1"}),
    (8, 1, 1, {"strides": "1,1", "pads_begin": "0,1", "pads_end": "1,0",
               "dilations": "2,2"}),
    (4, 3, 2, {"strides": "1,1", "pads_begin": "1,1", "pads_end": "1,1",
               "dilations": "1,1"}),   # grouped, not depthwise: always native
])
def test_group_convolution_matches_jax_reference(g, co, ci, attrs, int8, mode):
    from pyopenvino_tpu.ops import get_op as jax_get_op

    from pyopenvino_tpu_torch.ops import TValue, get_op

    node, jnode = _nodes("GroupConvolution", attrs, 2)
    rng = np.random.default_rng(g * 10 + co + ci)
    x = rng.standard_normal((2, g * ci, 9, 8)).astype(np.float32)
    w = rng.standard_normal((g, co, ci, 3, 3)).astype(np.float32)
    bias = rng.standard_normal(g * co).astype(np.float32)
    if int8:
        q, s, w = _quantized(w, (0, 1))
        tv_w = TValue(torch.from_numpy(q), qscale=torch.from_numpy(s))
    else:
        tv_w = TValue(torch.from_numpy(w))
    want = np.clip(jax_get_op("GroupConvolution").ref_compute(jnode, {0: x, 1: w})[2]
                   + bias.reshape(1, -1, 1, 1), 0.0, 6.0)
    xt = torch.from_numpy(x).contiguous(memory_format=torch.channels_last)
    got = get_op("GroupConvolution").emit_fused(
        _ctx(False, mode), node, {0: TValue(xt), 1: tv_w},
        bias=torch.from_numpy(bias), act=("clamp", 0.0, 6.0))[2].arr
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_clamp_standalone_matches_jax_reference():
    from pyopenvino_tpu.ops import get_op as jax_get_op

    from pyopenvino_tpu_torch.ops import TValue, get_op

    node, jnode = _nodes("Clamp", {"min": "-0.5", "max": "6.0"}, 1)
    x = (np.random.default_rng(2).standard_normal((2, 3, 5, 4)) * 4).astype(np.float32)
    want = jax_get_op("Clamp").ref_compute(jnode, {0: x})[1]
    got = get_op("Clamp").emit(None, node, {0: TValue(torch.from_numpy(x))})[1].arr
    np.testing.assert_array_equal(got.numpy(), want)
