"""The port's front end and package boundary: IR parse, weight synthesis,
shape passes, configuration, device selection and imports."""

import ast
import dataclasses
import os

import numpy as np
import pytest
import torch

from pyopenvino_tpu_torch import IECore
from pyopenvino_tpu_torch.config import (
    KERNEL_TYPE_TO_BACKEND,
    Backend,
    Config,
    QuantMode,
)
from pyopenvino_tpu_torch.ir import read_ir_model
from pyopenvino_tpu_torch.models.synth import RESNET18_XML, generate_weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "pyopenvino_tpu_torch")


@pytest.fixture(scope="module")
def resnet_paths(tmp_path_factory):
    """The IR that ``__graft_entry__._model_paths("resnet18")`` writes
    (same builder, same writer), written to a private directory: parallel
    test workers never race on the shared assets/ files."""
    from pyopenvino_tpu.ir.writer import write_ir_model
    from tools.gen_resnet import build_resnet18

    xml = str(tmp_path_factory.mktemp("resnet18") / "resnet18.xml")
    write_ir_model(build_resnet18(), xml)
    return xml, xml[:-4] + ".bin"


def test_shipped_xml_is_what_the_generator_writes(resnet_paths):
    xml, _ = resnet_paths
    with open(xml, "rb") as f, open(RESNET18_XML, "rb") as g:
        assert f.read() == g.read()


def test_parse_matches_jax_parser_node_for_node(resnet_paths):
    from pyopenvino_tpu.ir import read_ir_model as jax_read

    _, binp = resnet_paths
    port = read_ir_model(RESNET18_XML, binp)
    ref = jax_read(RESNET18_XML, binp)
    assert port.name == ref.name
    assert port.topo_order() == ref.topo_order()
    assert sorted(dataclasses.astuple(e) for e in port.edges) == sorted(
        dataclasses.astuple(e) for e in ref.edges)
    assert set(port.nodes) == set(ref.nodes)
    for nid, n in port.nodes.items():
        r = ref.nodes[nid]
        assert (n.name, n.op_type, n.attrs) == (r.name, r.op_type, r.attrs)
        for mine, theirs in ((n.inputs, r.inputs), (n.outputs, r.outputs)):
            assert {p: (i.shape, i.dtype, i.names) for p, i in mine.items()} == {
                p: (i.shape, i.dtype, i.names) for p, i in theirs.items()}
        if r.const is None:
            assert n.const is None
        else:
            assert n.const.dtype == r.const.dtype
            assert n.const.shape == r.const.shape
            assert n.const.tobytes() == r.const.tobytes()
    consts = port.find_by_type("Const")
    assert len(consts) == 43 and all(c.const is not None for c in consts)


def test_weightless_structural_parse():
    model = read_ir_model(RESNET18_XML, os.path.join(PORT, "no-such.bin"))
    assert all(n.const is None for n in model.find_by_type("Const"))
    assert len(model.nodes) == 116


def test_fp16_consts_decode_exactly(tmp_path):
    vals = np.array([0.0, -1.5, 65504.0, 6e-8, np.inf], np.float16)
    xml = tmp_path / "h.xml"
    xml.write_text(
        '<net name="h" version="10"><layers>'
        '<layer id="0" name="c" type="Const" version="opset1">'
        '<data element_type="f16" shape="5" offset="0" size="10"/>'
        '<output><port id="0" precision="FP16"><dim>5</dim></port></output>'
        '</layer></layers><edges/></net>')
    (tmp_path / "h.bin").write_bytes(vals.tobytes())
    c = read_ir_model(str(xml)).find_by_name("c").const
    assert c.dtype == np.float32
    np.testing.assert_array_equal(c, vals.astype(np.float32))


def test_synthesized_weights_equal_gen_weights():
    from pyopenvino_tpu.ir import read_ir_model as jax_read
    from tools.gen_weights import generate_weights as jax_generate

    missing = os.path.join(PORT, "no-such.bin")
    port = generate_weights(read_ir_model(RESNET18_XML, missing), seed=0)
    ref = jax_generate(jax_read(RESNET18_XML, missing), seed=0)
    assert len(port) == 46738912
    assert port == ref


def test_bake_batch_matches_jax(resnet_paths):
    from pyopenvino_tpu.ir import read_ir_model as jax_read
    from pyopenvino_tpu.passes.shape_infer import bake_batch as jax_bake

    from pyopenvino_tpu_torch.passes.shape_infer import bake_batch

    xml, binp = resnet_paths
    port = bake_batch(read_ir_model(xml, binp), 5)
    ref = jax_bake(jax_read(xml, binp), 5)
    for nid, n in port.nodes.items():
        r = ref.nodes[nid]
        assert {p: i.shape for p, i in n.outputs.items()} == {
            p: i.shape for p, i in r.outputs.items()}
        if r.op_type == "Const" and r.const.dtype == np.int64:
            np.testing.assert_array_equal(n.const, r.const)
    reshape = port.find_by_name("reshape_0")
    assert reshape.outputs[reshape.out_port].shape == (5, 512)


def test_kernel_type_strings():
    assert KERNEL_TYPE_TO_BACKEND["pallas"] is Backend.KERNELS
    assert KERNEL_TYPE_TO_BACKEND["kernels"] is Backend.KERNELS
    assert KERNEL_TYPE_TO_BACKEND["xla"] is Backend.TORCH
    assert KERNEL_TYPE_TO_BACKEND["torch"] is Backend.TORCH
    assert KERNEL_TYPE_TO_BACKEND["special"] is Backend.TORCH
    assert KERNEL_TYPE_TO_BACKEND["numpy"] is Backend.INTERPRETER
    from pyopenvino_tpu.config import QuantMode as JaxQuantMode

    assert {q.name: q.value for q in QuantMode} == {
        q.name: q.value for q in JaxQuantMode}


@pytest.mark.parametrize("config", [
    Config(backend=Backend.INTERPRETER),
    Config(quant=QuantMode.INT8_WEIGHT, bias_correction=True),
    Config(quant=QuantMode.INT8_FULL),
    Config(quant=QuantMode.BF16),
])
def test_unported_modes_raise_naming_the_roadmap(config):
    from pyopenvino_tpu_torch.runtime.compiler import compile_model

    model = read_ir_model(RESNET18_XML, os.path.join(PORT, "no-such.bin"))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        compile_model(model, config)


def test_gpu_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ie = IECore()
    net = ie.read_network(RESNET18_XML, os.path.join(PORT, "no-such.bin"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ie.load_network(net, "GPU")
    with pytest.raises(ValueError, match="unknown device"):
        ie.load_network(net, "TPU")


def test_check_nodes_rejects_unported_ops(tmp_path):
    xml = tmp_path / "lrn.xml"
    xml.write_text(
        '<net name="l" version="10"><layers>'
        '<layer id="0" name="x" type="Parameter" version="opset1">'
        '<output><port id="0"><dim>1</dim><dim>4</dim></port></output></layer>'
        '<layer id="1" name="s" type="Sigmoid" version="opset1">'
        '<input><port id="0"><dim>1</dim><dim>4</dim></port></input>'
        '<output><port id="1"><dim>1</dim><dim>4</dim></port></output></layer>'
        '</layers><edges><edge from-layer="0" from-port="0" to-layer="1" '
        'to-port="0"/></edges></net>')
    ie = IECore()
    with pytest.raises(ValueError, match="Sigmoid"):
        ie.load_network(ie.read_network(str(xml)), "CPU")


def _port_sources():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(PORT):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def test_port_imports_nothing_of_jax_or_the_jax_package():
    """An AST scan: the test process has JAX loaded already
    (tests/conftest.py imports it), so sys.modules proves nothing."""
    banned = {"jax", "jaxlib", "pyopenvino_tpu", "tools"}
    paths = _port_sources()
    assert len(paths) > 15
    found = []
    for path in paths:
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            elif (isinstance(node, ast.Call)
                  and getattr(node.func, "attr", getattr(node.func, "id", ""))
                  in ("import_module", "__import__")
                  and node.args and isinstance(node.args[0], ast.Constant)):
                names = [str(node.args[0].value)]
            else:
                continue
            found += [(path, n) for n in names if n.split(".")[0] in banned]
    assert not found, found
