"""BN-scale folding in the port's prepare_model against the JAX package's.

The trained IRs with a batch norm exported as Conv → Multiply(s) → Add
(``assets/trained/mnist_bn``, ``keras_digits``, ``torch_digits``) prepare
to the JAX package's graph: the Multiply nodes folded into the conv
weights, the same nodes left, equal weights, then equal INT8 weight-only
codes and scales, and outputs of the port's TORCH backend on the CPU that
agree with the JAX package's XLA backend.  SSD's one Multiply scales the
input Parameter, and the port's pass leaves it.

Inputs are made with numpy from a seed and handed to both packages."""

import numpy as np
import pytest

from pyopenvino_tpu.config import Backend as JaxBackend
from pyopenvino_tpu.config import Config as JaxConfig
from pyopenvino_tpu.config import QuantMode as JaxQuantMode
from pyopenvino_tpu.ir import read_ir_model as jax_read
from pyopenvino_tpu.passes.fold_scale import fold_scale_into_conv as jax_fold
from pyopenvino_tpu.runtime.compiler import compile_model as jax_compile
from pyopenvino_tpu.runtime.compiler import prepare_model as jax_prepare

from pyopenvino_tpu_torch.config import Backend, Config, QuantMode
from pyopenvino_tpu_torch.ir import read_ir_model
from pyopenvino_tpu_torch.passes.fold_scale import fold_scale_into_conv
from pyopenvino_tpu_torch.runtime.compiler import compile_model, prepare_model
import test_torch_port_threads  # noqa: F401  (this worker's torch threads)

# BN Multiply nodes in each IR, all folded
MODELS = {"mnist_bn": 3, "keras_digits": 2, "torch_digits": 2}
# the folded weights: the same float32 product in both packages, so the
# limit only allows for numpy's order of operations
WEIGHT_RTOL = 1e-6
# the INT8 weight-only scales: max |w| / 127 of the same folded weights
SCALE_RTOL = 1e-7
# outputs, TORCH (CPU) against XLA (CPU): float32 sums in another order; the
# classifiers end in SoftMax (mnist_bn, keras_digits) or in logits
OUT_RTOL, OUT_ATOL = 1e-4, 1e-5
MODES = {"fp32": (QuantMode.NONE, JaxQuantMode.NONE),
         "int8w": (QuantMode.INT8_WEIGHT, JaxQuantMode.INT8_WEIGHT)}


def _paths(name):
    return f"assets/trained/{name}.xml", f"assets/trained/{name}.bin"


def _edges(model):
    return sorted((e.src, e.src_port, e.dst, e.dst_port) for e in model.edges)


@pytest.fixture(scope="module", params=sorted(MODELS))
def models(request):
    name = request.param
    return name, read_ir_model(*_paths(name)), jax_read(*_paths(name))


def test_prepare_folds_as_jax_does(models):
    """No Multiply left, the JAX package's nodes and edges, equal weights and
    biases; the input model is left as it was."""
    name, port_model, jax_model = models
    before = {nid: n.const.copy() for nid, n in port_model.nodes.items() if n.const is not None}
    assert len(port_model.find_by_type("Multiply")) == MODELS[name]

    got, *_ = prepare_model(port_model, Config())
    want = jax_fold(jax_model)
    want_prepared, *_ = jax_prepare(jax_model, JaxConfig())
    assert got.find_by_type("Multiply") == []
    assert sorted(got.nodes) == sorted(want.nodes) == sorted(want_prepared.nodes)
    assert _edges(got) == _edges(want) == _edges(want_prepared)
    assert len(got.nodes) == len(port_model.nodes) - 2 * MODELS[name]
    folded = 0
    for nid, node in want.nodes.items():
        assert got.nodes[nid].op_type == node.op_type
        if node.const is None:
            continue
        assert got.nodes[nid].const.dtype == node.const.dtype
        np.testing.assert_allclose(got.nodes[nid].const, node.const, rtol=WEIGHT_RTOL, atol=0)
        folded += not np.array_equal(node.const, before[nid])
    assert folded == MODELS[name]  # one conv weight per Multiply
    for nid, const in before.items():  # the input model is untouched
        np.testing.assert_array_equal(port_model.nodes[nid].const, const)


def test_int8_weight_codes_and_scales_match_jax(models):
    """The quantizer sees the folded weights in both packages: equal codes,
    per-channel scales within SCALE_RTOL."""
    name, port_model, jax_model = models
    _, quantized, _, _ = prepare_model(port_model, Config(quant=QuantMode.INT8_WEIGHT))
    _, jax_quantized, _, _ = jax_prepare(jax_model, JaxConfig(quant=JaxQuantMode.INT8_WEIGHT))
    assert sorted(quantized) == sorted(jax_quantized)
    convs = {port_model.in_edges[n.id][1][0] for n in port_model.find_by_type("Convolution")}
    assert convs <= set(quantized)
    for cid, (codes, scales) in quantized.items():
        want_codes, want_scales = (np.asarray(v) for v in jax_quantized[cid])
        np.testing.assert_array_equal(np.asarray(codes), want_codes)
        np.testing.assert_allclose(np.asarray(scales), want_scales, rtol=SCALE_RTOL, atol=0)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_outputs_match_xla(models, mode):
    """FP32 and INT8 weight-only through the port's TORCH backend on the CPU
    against the JAX package's XLA backend, on 8 seeded 28×28 images."""
    name, port_model, jax_model = models
    quant, jax_quant = MODES[mode]
    (param,) = port_model.parameters
    x = np.random.default_rng(7).uniform(0, 1, (8, 1, 28, 28)).astype(np.float32)
    net = compile_model(port_model, Config(backend=Backend.TORCH, quant=quant), device="cpu")
    jax_net = jax_compile(jax_model, JaxConfig(backend=JaxBackend.XLA, quant=jax_quant))
    assert net.model.find_by_type("Multiply") == []
    for i in range(len(x)):
        got = net({param.name: x[i:i + 1]})
        want = jax_net({param.name: x[i:i + 1]})
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_allclose(got[key], np.asarray(want[key]),
                                       rtol=OUT_RTOL, atol=OUT_ATOL)


def _built(tmp_path, name, scale):
    """Parameter → Conv → Add(bias) → ReLU → MaxPool → Multiply(scale) →
    Result, written by the JAX package's IR writer and read by each
    package's parser."""
    from pyopenvino_tpu.ir.builder import GraphBuilder
    from pyopenvino_tpu.ir.writer import write_ir_model

    rng = np.random.default_rng(6)
    b = GraphBuilder(name)
    x = b.parameter("in", (1, 2, 8, 8))
    w = b.const(rng.standard_normal((2, 2, 3, 3)).astype(np.float32))
    bias = b.const(rng.standard_normal((1, 2, 1, 1)).astype(np.float32))
    y = b.max_pool(b.relu(b.add(b.conv2d(x, w), bias)))
    b.result(b.multiply(y, b.const(np.array(scale, np.float32).reshape(1, 2, 1, 1))))
    xml = str(tmp_path / f"{name}.xml")
    write_ir_model(b.build(), xml)
    return read_ir_model(xml, xml[:-4] + ".bin"), jax_read(xml, xml[:-4] + ".bin")


def test_positive_scale_folds_through_pool_relu_and_bias(tmp_path):
    """Through MaxPool, ReLU and a bias Add: the conv weight and the bias
    both take the scale, as in the JAX package; the outputs agree."""
    model, jax_model = _built(tmp_path, "pos", [0.5, 2.0])
    got, want = fold_scale_into_conv(model), jax_fold(jax_model)
    assert got.find_by_type("Multiply") == want.find_by_type("Multiply") == []
    assert sorted(got.nodes) == sorted(want.nodes)
    assert _edges(got) == _edges(want)
    changed = 0
    for nid, node in want.nodes.items():
        if node.const is not None:
            np.testing.assert_allclose(got.nodes[nid].const, node.const,
                                       rtol=WEIGHT_RTOL, atol=0)
            changed += not np.array_equal(node.const, jax_model.nodes[nid].const)
    assert changed == 2  # the weight and the bias
    blob = {"in": np.random.default_rng(8).standard_normal((1, 2, 8, 8)).astype(np.float32)}
    out = compile_model(model, Config(backend=Backend.TORCH), device="cpu")(blob)
    ref = jax_compile(jax_model, JaxConfig(backend=JaxBackend.XLA))(blob)
    for key in ref:
        np.testing.assert_allclose(out[key], np.asarray(ref[key]), rtol=OUT_RTOL, atol=OUT_ATOL)


def test_negative_scale_through_pool_is_not_folded(tmp_path):
    """A scale with a negative element does not commute with MaxPool or
    ReLU: the Multiply stays, and the model comes back as it was."""
    model, jax_model = _built(tmp_path, "neg", [-1.0, 2.0])
    assert fold_scale_into_conv(model) is model
    assert len(jax_fold(jax_model).find_by_type("Multiply")) == 1


def test_fold_scale_leaves_ssd_unchanged():
    """SSD's one Multiply scales the input Parameter, not a conv output: the
    port's own pass returns the model itself."""
    paths = ("assets/trained/ssd_shapes_ms.xml", "assets/trained/ssd_shapes_ms.bin")
    model = read_ir_model(*paths)
    assert len(model.find_by_type("Multiply")) == 1
    folded = fold_scale_into_conv(model)
    assert folded is model
    assert sorted(folded.nodes) == sorted(jax_fold(jax_read(*paths)).nodes)
