"""The port's PrePostProcessor (pyopenvino_tpu_torch/preprocess.py) against
the JAX package's: tests/test_preprocess.py's eight cases, each on the same
IR read by both packages, with the graph that ``build()`` returns held equal
to the JAX package's node for node (op types, names, attributes, port
shapes and dtypes, constants, edges) and the outputs held to the JAX
package's (the numpy interpreters bit for bit, the compiled TORCH and
KERNELS backends to its XLA backend at rtol 1e-5), then u8 ingress on
full-width ResNet-18 under INT8-FULL with bfloat16 compute: a torch.uint8
input on the device, and logits held as tests/test_torch_port_bf16.py holds
the float ones."""

import numpy as np
import pytest
import torch

from pyopenvino_tpu.config import Backend as JaxBackend
from pyopenvino_tpu.config import Config as JaxConfig
from pyopenvino_tpu.config import QuantMode as JaxQuantMode
from pyopenvino_tpu.ir import read_ir_model as jax_read
from pyopenvino_tpu.ir.builder import GraphBuilder
from pyopenvino_tpu.ir.writer import write_ir_model as jax_write
from pyopenvino_tpu.preprocess import PrePostProcessor as JaxPPP
from pyopenvino_tpu.runtime.compiler import compile_model as jax_compile
from pyopenvino_tpu.runtime.interpreter import Interpreter as JaxInterpreter

from pyopenvino_tpu_torch import IECore, PrePostProcessor
from pyopenvino_tpu_torch.config import Backend, Config, QuantMode
from pyopenvino_tpu_torch.ir import read_ir_model
from pyopenvino_tpu_torch.models.synth import resnet18_paths
from pyopenvino_tpu_torch.runtime.compiler import compile_model
from pyopenvino_tpu_torch.runtime.interpreter import Interpreter

from test_torch_port_bf16 import Bf16Case, check_bf16_case
import test_torch_port_threads  # noqa: F401  (this worker's torch threads)

RTOL = ATOL = 1e-5


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """tests/test_preprocess.py's tiny CNN (one 3×3 conv + ReLU on a
    (1, 3, 8, 8) input), written once as an IR both packages read."""
    rng = np.random.default_rng(0)
    b = GraphBuilder("tiny")
    x = b.parameter("data", (1, 3, 8, 8))
    w = rng.normal(0, 0.2, (4, 3, 3, 3)).astype(np.float32)
    b.result(b.relu(b.conv2d(x, b.const(w), pads=((1, 1), (1, 1)))), name="out")
    xml = str(tmp_path_factory.mktemp("tiny") / "tiny.xml")
    jax_write(b.build(), xml)
    return xml, xml[:-4] + ".bin"


def _both(paths, declare):
    """(port model, JAX model) after the same ``declare(ppp)`` steps."""
    built = []
    for read, ppp_cls in ((read_ir_model, PrePostProcessor), (jax_read, JaxPPP)):
        ppp = ppp_cls(read(*paths))
        declare(ppp)
        built.append(ppp.build())
    return built


def assert_same_graph(port, jax):
    """Node for node: ids, names, op types, attributes, port shapes and
    dtypes, constants; and the same edges."""
    assert sorted(port.nodes) == sorted(jax.nodes)
    for nid, pn in port.nodes.items():
        jn = jax.nodes[nid]
        assert (pn.name, pn.op_type, pn.attrs) == (jn.name, jn.op_type, jn.attrs), nid
        for mine, theirs in ((pn.inputs, jn.inputs), (pn.outputs, jn.outputs)):
            assert sorted(mine) == sorted(theirs), (nid, mine, theirs)
            for port_id in mine:
                assert tuple(mine[port_id].shape) == tuple(theirs[port_id].shape)
                assert np.dtype(mine[port_id].dtype) == np.dtype(theirs[port_id].dtype)
        if jn.const is not None:
            np.testing.assert_array_equal(pn.const, jn.const)
            assert pn.const.dtype == jn.const.dtype
    key = lambda e: (e.src, e.src_port, e.dst, e.dst_port)  # noqa: E731
    assert sorted(map(key, port.edges)) == sorted(map(key, jax.edges))


def _run_all(port, jax, feed):
    """The port's interpreter against the JAX package's (bit for bit), its
    TORCH and KERNELS backends against XLA; returns the JAX XLA output."""
    want = JaxInterpreter(jax).run(feed)
    got = Interpreter(port).run(feed)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    xla = jax_compile(jax, JaxConfig(backend=JaxBackend.XLA)).infer(feed)
    for backend in (Backend.TORCH, Backend.KERNELS):
        out = compile_model(port, Config(backend=backend), device="cpu").infer(feed)
        for k in xla:
            assert out[k].dtype == np.asarray(xla[k]).dtype
            np.testing.assert_allclose(out[k], np.asarray(xla[k]), rtol=RTOL, atol=ATOL)
    return xla


def test_full_pipeline_matches_hand_rolled_numpy(tiny):
    """u8 NHWC BGR 12×12 → f32, RGB, bilinear resize to 8×8, NCHW,
    mean/scale: the JAX package's graph, and its outputs."""
    def declare(ppp):
        ppp.input().tensor().set_element_type("u8").set_layout("NHWC") \
            .set_spatial_static_shape(12, 12).set_color_format("BGR")
        ppp.input().preprocess().convert_element_type("f32") \
            .convert_color("RGB").resize("linear").convert_layout() \
            .mean([110.0, 115.0, 120.0]).scale([58.0, 57.0, 56.0])

    port, jax = _both(tiny, declare)
    assert_same_graph(port, jax)
    p = port.parameters[0]
    assert p.outputs[p.out_port].shape == (1, 12, 12, 3)
    assert p.outputs[p.out_port].dtype == np.uint8
    assert [n.op_type for n in port if n.op_type not in ("Const", "Parameter")][:6] == [
        "Convert", "Gather", "Interpolate", "Transpose", "Subtract", "Divide"]
    raw = np.random.default_rng(1).integers(0, 256, (1, 12, 12, 3), dtype=np.uint8)
    _run_all(port, jax, {"data": raw})


def test_mean_scale_in_tensor_layout_before_conversion(tiny):
    """mean before convert_layout applies along the NHWC channel axis."""
    def declare(ppp):
        ppp.input().tensor().set_layout("NHWC")
        ppp.input().preprocess().mean([1.0, 2.0, 3.0]).convert_layout()

    port, jax = _both(tiny, declare)
    assert_same_graph(port, jax)
    raw = np.random.default_rng(2).standard_normal((1, 8, 8, 3)).astype(np.float32)
    _run_all(port, jax, {"data": raw})


def test_implicit_completion_layout_and_dtype(tiny):
    """No explicit steps: a u8 NHWC tensor reaches the f32 NCHW model
    through the implicit Transpose and Convert."""
    def declare(ppp):
        ppp.input().tensor().set_element_type("u8").set_layout("NHWC")

    port, jax = _both(tiny, declare)
    assert_same_graph(port, jax)
    assert [n.op_type for n in port if n.op_type not in ("Const", "Parameter")][:2] == [
        "Transpose", "Convert"]
    raw = np.random.default_rng(2).integers(0, 4, (1, 8, 8, 3), dtype=np.uint8)
    _run_all(port, jax, {"data": raw})


def test_spatial_mismatch_without_resize_raises(tiny):
    for read, ppp_cls in ((read_ir_model, PrePostProcessor), (jax_read, JaxPPP)):
        ppp = ppp_cls(read(*tiny))
        ppp.input().tensor().set_spatial_static_shape(16, 16)
        with pytest.raises(ValueError, match="resize"):
            ppp.build()


def test_convert_color_requires_tensor_format(tiny):
    for read, ppp_cls in ((read_ir_model, PrePostProcessor), (jax_read, JaxPPP)):
        ppp = ppp_cls(read(*tiny))
        ppp.input().preprocess().convert_color("RGB")
        with pytest.raises(ValueError, match="set_color_format"):
            ppp.build()


def test_output_postprocess_convert(tiny):
    """A trailing Convert to f16 on the output: the Result reads float16 in
    every backend of both packages."""
    def declare(ppp):
        ppp.output().postprocess().convert_element_type("f16")

    port, jax = _both(tiny, declare)
    assert_same_graph(port, jax)
    xla = _run_all(port, jax, {"data": np.ones((1, 3, 8, 8), np.float32)})
    assert np.asarray(xla["out"]).dtype == np.float16


def test_writer_roundtrip_and_ienet_facade(tiny, tmp_path):
    """The built graph writes and reads back like any IR: the port's
    writer's file reads back as the JAX package's writes (the port writes
    no underscore attributes such as ``_opset``, ir/writer.py);
    PrePostProcessor(IENetwork) rebinds the network in place and still
    loads through the public API."""
    from pyopenvino_tpu_torch.ir.writer import write_ir_model

    def declare(ppp):
        ppp.input().tensor().set_element_type("u8").set_layout("NHWC")
        ppp.input().preprocess().mean([12.0]).scale([3.0])

    port, jax = _both(tiny, declare)
    assert_same_graph(port, jax)
    xml = str(tmp_path / "ppp.xml")
    write_ir_model(port, xml)
    jax_xml = str(tmp_path / "ppp_jax.xml")
    jax_write(jax, jax_xml)
    back = read_ir_model(xml)
    assert_same_graph(back, jax_read(jax_xml))
    raw = np.random.default_rng(3).integers(0, 256, (1, 8, 8, 3), dtype=np.uint8)
    np.testing.assert_array_equal(Interpreter(back).run({"data": raw})["out"],
                                  Interpreter(port).run({"data": raw})["out"])

    ie = IECore()
    net = ie.read_network(xml)
    ppp = PrePostProcessor(net)
    ppp.input().preprocess().scale([2.0])
    net2 = ppp.build()
    assert net2 is net  # rebound in place
    exe = ie.load_network(net2, "CPU")
    out = exe.infer({"data": raw})
    assert out["out"].shape == (1, 4, 8, 8)
    jax_ppp = JaxPPP(jax_read(jax_xml))
    jax_ppp.input().preprocess().scale([2.0])
    want = JaxInterpreter(jax_ppp.build()).run({"data": raw})["out"]
    np.testing.assert_allclose(out["out"], want, rtol=RTOL, atol=ATOL)


def test_ppp_composes_with_int8_quantization(tiny):
    """INT8 weight-only over a PPP graph: the inserted chain leaves fusion
    and quantization alone, as in the JAX package."""
    def declare(ppp):
        ppp.input().tensor().set_element_type("u8")
        ppp.input().preprocess().scale([255.0])

    port, jax = _both(tiny, declare)
    assert_same_graph(port, jax)
    raw = np.random.default_rng(4).integers(0, 256, (1, 3, 8, 8), dtype=np.uint8)
    want = jax_compile(jax, JaxConfig(backend=JaxBackend.XLA,
                                      quant=JaxQuantMode.INT8_WEIGHT)).infer({"data": raw})
    for backend in (Backend.TORCH, Backend.KERNELS):
        got = compile_model(port, Config(backend=backend, quant=QuantMode.INT8_WEIGHT),
                            device="cpu").infer({"data": raw})
        np.testing.assert_allclose(got["out"], np.asarray(want["out"]), rtol=RTOL, atol=ATOL)


# -- u8 ingress on full-width ResNet-18, INT8-FULL, bfloat16 -------------------

class U8Case(Bf16Case):
    """ResNet-18's logits behind bench.py's ingress step, ``set_element_type
    ("u8")`` (a u8 Parameter, then Convert to f32), on one seeded u8 image;
    calibrated on 2 seeded images in [0, 255)."""

    def __init__(self, paths, seed):
        super().__init__(paths, seed)
        for attr, read in (("model", read_ir_model), ("jax_model", jax_read)):
            ppp = (PrePostProcessor if attr == "model" else JaxPPP)(getattr(self, attr))
            ppp.input().tensor().set_element_type("u8")
            setattr(self, attr, ppp.build())
        rng = np.random.default_rng(seed)
        self.samples = [{"data": rng.uniform(0, 255, (1, 3, 224, 224)).astype(np.float32)}
                        for _ in range(2)]
        self.x = {"data": rng.integers(0, 256, (1, 3, 224, 224), dtype=np.uint8)}


@pytest.fixture(scope="module")
def u8_case():
    paths = resnet18_paths(seed=0)
    case = U8Case(paths, seed=5)
    assert_same_graph(case.model, case.jax_model)
    return case


@pytest.mark.parametrize("backend,jax_backend", [
    (Backend.TORCH, JaxBackend.XLA), (Backend.KERNELS, JaxBackend.PALLAS)],
    ids=["torch", "kernels"])
def test_u8_int8full_bf16_resnet18_matches_jax(u8_case, backend, jax_backend):
    """bench.py's configuration (u8 ingress, INT8-FULL, bfloat16) on the
    port: the input crosses as torch.uint8 and the logits follow the JAX
    package's as the float32-input ones do."""
    net, _, _ = check_bf16_case(u8_case, backend, jax_backend, QuantMode.INT8_FULL)
    param = net.model.parameters[0]
    t = net._input_tensor(u8_case.x["data"], param.outputs[param.out_port].shape,
                          param.outputs[param.out_port].dtype)
    assert t.dtype == torch.uint8 and t.element_size() == 1
