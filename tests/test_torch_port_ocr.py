"""ocr-ti (the port's ``models/ocr_ti.xml`` with the weights
``models/ocr_ti.py`` replays, byte for byte those of ``tools/gen_ocr.py``)
on the port against the JAX package: a (1, 24, 32) feature strip through a
forward and a reverse TensorIterator, each iterating one LSTMCell of 48
over the frames with (h, c) on its back edges, a Concat, a per-frame
27-class MatMul head, a Transpose and a SoftMax over the classes:
  * the shipped XML is what the generator writes (the builder and version
    ``__graft_entry__._model_paths`` takes, built into a private directory),
    the replay gives its ``.bin``, and the port's writer gives both back
    from the parsed IR, body Consts where each TensorIterator is written;
  * FP32 and INT8 weight-only through the public API on the CPU, TORCH and
    KERNELS, against the JAX package's XLA backend one input at a time and
    (FP32) its interpreter, at rtol 1e-3 / atol 1e-5 (FP32 lies within
    about 1e-7: the cells' tanh and logistic bits, ROADMAP.md §3 fault 7);
    every frame's posteriors sum to 1;
  * the numpy interpreter bit for bit; INT8 weight-only quantizes the head
    alone (the quantize pass enters no body, in either package), the body
    weights stay float under their ``sub.*`` keys;
  * INT8-FULL: the same activation scale (the head's) and the logits bit
    for bit with XLA's fused multiply-add epilogue;
  * infer_batch runs one example at a time (the bodies are batch-1 and the
    head's Reshape names (24, 96)), equal to single requests and within
    tolerance of the JAX package's vmapped infer_batch;
  * a JAX ``save_weights`` checkpoint loads as is;
  * bfloat16 in the three modes with tests/test_torch_port_bf16.py's gate;
  * KERNELS launches one fused_gemm a forward (the head: M = 24, K = 96,
    N = 27), where the JAX package's Pallas forward calls its kernel; the
    rank-3 SoftMax takes no softmax_rows, the bodies no kernel."""

import numpy as np
import pytest

from pyopenvino_tpu.config import Config as JaxConfig
from pyopenvino_tpu.config import QuantMode as JaxQuantMode
from pyopenvino_tpu.runtime.compiler import compile_model as jax_compile

from pyopenvino_tpu_torch.config import Backend, QuantMode
from pyopenvino_tpu_torch.ir import parse_ir, read_ir_model
from pyopenvino_tpu_torch.ir.writer import serialize_ir
from pyopenvino_tpu_torch.models import ocr_ti
from pyopenvino_tpu_torch.models.synth import writer_order_consts
from pyopenvino_tpu_torch.ops import supported_ops
from torch_port_families import (
    QUANTS, Family, FamilyBf16Case, Int8FullCase, check_bf16, check_kernel_launches, images,
)
from test_torch_port_int8full import BACKEND_PAIRS
import test_torch_port_threads  # noqa: F401  (this worker's torch threads)

SHAPE = (1, 24, 32)
OUT_SHAPE = (27, 24)


def generator_files(tmp_path, name):
    """(xml bytes, bin bytes) of ``name`` from the builder and version that
    __graft_entry__._model_paths uses, written by the JAX package's writer
    into ``tmp_path``."""
    import __graft_entry__
    from pyopenvino_tpu.ir.writer import write_ir_model

    version, build = __graft_entry__._programmatic_generators()[name]
    xml = str(tmp_path / f"{name}.xml")
    write_ir_model(build(), xml)
    with open(xml, "rb") as f, open(xml[:-4] + ".bin", "rb") as g:
        return version, f.read(), g.read()


@pytest.fixture(scope="module")
def family():
    return Family(ocr_ti.ocr_ti_paths(), images(SHAPE, 2, 7))


def test_ir_and_weights_are_the_generator(tmp_path):
    version, want_xml, want = generator_files(tmp_path, "ocr-ti")
    assert version == 1
    xml_path, bin_path = ocr_ti.ocr_ti_paths()
    with open(xml_path, "rb") as f, open(bin_path, "rb") as g:
        assert f.read() == want_xml
        assert g.read() == want and len(want) == 136088
    with open(xml_path, encoding="utf-8") as f:
        other = ocr_ti.generate_weights(f.read(), seed=1)
    assert len(other) == len(want) and other != want
    model = parse_ir(want_xml.decode("utf-8"), want, name="ocr_ti")
    assert serialize_ir(model) == (want_xml, want)
    # the writer's order: each TensorIterator's body Consts where it is written
    consts = writer_order_consts(model)
    offsets = [int(n.attrs["offset"]) for n in consts]
    assert len(consts) == 19 and offsets == sorted(offsets)


def test_topology():
    model = read_ir_model(*ocr_ti.ocr_ti_paths())
    tis = model.find_by_type("TensorIterator")
    assert len(tis) == 2
    for ti, stride in zip(tis, (1, -1)):
        sg = ti.subgraphs["body"]
        assert [n.op_type for n in sg.model.find_by_type("LSTMCell")] == ["LSTMCell"]
        assert len(sg.back_edges) == 2
        sliced = [e for e in sg.inputs if e.axis is not None]
        assert [(e.axis, e.stride) for e in sliced] == [(1, stride)]
        assert {n.op_type for n in sg.model} <= set(supported_ops())
    assert {n.op_type for n in model} <= set(supported_ops())


@pytest.mark.parametrize("quant", [QuantMode.NONE, QuantMode.INT8_WEIGHT], ids=lambda q: q.value)
@pytest.mark.parametrize("kernel_type", ["torch", "kernels"])
def test_matches_jax(family, quant, kernel_type):
    _, batch = family.check_matches_jax(quant, kernel_type)
    assert batch.shape == (2, *OUT_SHAPE)
    assert (batch.argmax(1) == family.want[quant].argmax(1)).all()
    if quant == QuantMode.NONE:
        np.testing.assert_allclose(batch, family.want[quant], rtol=0, atol=1e-6)


def test_interpreter_and_codes_match_jax(family):
    """INT8 weight-only quantizes the head alone: the LSTMCells' weights,
    inside the bodies, stay float32 under their sub.* keys, as the JAX
    package's quantize pass never enters a body."""
    family.check_interpreter()
    assert family.check_int8_weight_codes() == 1
    compiled = family.exe(QuantMode.INT8_WEIGHT, "torch").compiled()
    subs = {k: v for k, v in compiled.weights.items() if k.startswith("sub.")}
    assert len(subs) == 6 and all(v.is_floating_point() for v in subs.values())
    assert [k for k in compiled.weights if k.endswith(".scale")] == [
        f"{next(iter(compiled._quantized))}.scale"]


@pytest.mark.parametrize("backend,jax_backend", BACKEND_PAIRS, ids=["torch", "kernels"])
def test_int8full_matches_jax(backend, jax_backend, monkeypatch):
    net = Int8FullCase(ocr_ti.ocr_ti_paths(), seed=3).check(backend, jax_backend, monkeypatch)
    assert len(net.act_scales) == 1  # the head; the TensorIterators take no scale
    if backend == Backend.TORCH:
        print("int8-stored edges", {net.model.nodes[s].op_type for s, _ in net._int8_edges})


def test_int8_modes_preserve_ranking(family):
    agree = family.int8_agreement()
    print({q.value: a for q, a in agree.items()})
    assert all(a >= 0.95 for a in agree.values()), agree


@pytest.mark.parametrize("quant", QUANTS, ids=lambda q: q.value)
def test_infer_batch_runs_per_example(family, quant):
    """The bodies' Parameters are batch-1 and the head's Reshape names
    (24, 96), so the graph cannot carry a batch in N: the TensorIterator
    refuses the batched input, and infer_batch runs the examples one at a
    time (equal to single requests), within tolerance of the JAX
    package's vmapped infer_batch."""
    cal = [{family.input: family.blobs[:1]}] if quant == QuantMode.INT8_FULL else None
    exe = family.exe(quant, "kernels", cal)
    batch = images(SHAPE, 3, 5)
    out = exe.infer_batch({family.input: batch})[family.out]
    assert exe.compiled()._batched_plan(3) is None
    assert out.shape == (3, *OUT_SHAPE)
    single = np.concatenate([exe.infer({family.input: batch[i:i + 1]})[family.out]
                             for i in range(3)])
    np.testing.assert_array_equal(out, single)
    want = jax_compile(family.jax_model, JaxConfig(quant=JaxQuantMode(quant.value)),
                       calibration_samples=cal).infer_batch({family.input: batch})[family.out]
    np.testing.assert_allclose(out, np.asarray(want).reshape(out.shape), rtol=1e-3, atol=1e-5)


def test_load_weights_takes_a_jax_checkpoint(family, tmp_path):
    """A JAX ``save_weights`` checkpoint of ocr-ti, body weights under
    ``sub.<node>.body.<const>`` included, loads as is; the answer with it
    is the answer with the port's own weights."""
    ckpt = str(tmp_path / "ocr.npz")
    family.jax_net(QuantMode.NONE).save_weights(ckpt)
    exe = family.exe(QuantMode.NONE, "torch")
    blob = {family.input: family.blobs[:1]}
    before = exe.infer(blob)[family.out]
    compiled = exe.compiled()
    assert sum(k.startswith("sub.") for k in compiled.weights) == 6
    compiled.load_weights(ckpt)
    np.testing.assert_array_equal(exe.infer(blob)[family.out], before)


@pytest.fixture(scope="module")
def bf16_case():
    return FamilyBf16Case(ocr_ti.ocr_ti_paths(), seed=3)


@pytest.mark.parametrize("quant", QUANTS, ids=lambda q: q.value)
@pytest.mark.parametrize("backend,jax_backend", BACKEND_PAIRS, ids=["torch", "kernels"])
def test_bf16_matches_jax(bf16_case, backend, jax_backend, quant):
    """The cells' logistic rounds its three steps to bfloat16 in both
    packages (ops/elementwise.py::sigmoid), the carries are cast to
    bfloat16 at the first step as the JAX package's ``cast_init`` does."""
    check_bf16(bf16_case, backend, jax_backend, quant)


@pytest.mark.parametrize("quant", QUANTS, ids=lambda q: q.value)
def test_kernel_launches(family, quant, monkeypatch):
    import chip_smoke

    table = check_kernel_launches(family, quant, monkeypatch)
    name = {QuantMode.NONE: "fused_gemm", QuantMode.INT8_WEIGHT: "fused_gemm_i8w",
            QuantMode.INT8_FULL: "fused_gemm_i8i8"}[quant]
    assert table == {name: [(24, 96, 27, 1)]}
    assert chip_smoke.softmax_rows_of(family.exe(QuantMode.NONE, "kernels").compiled()) == []
