"""lstm-tiny (the port's ``models/lstm_tiny.xml`` with the weights
``models/lstm_tiny.py`` replays, byte for byte those of
``tools/gen_lstm.py``) on the port against the JAX package, mirroring
tests/test_recurrent.py's family check: a bidirectional LSTMSequence, a
Transpose and Reshape of its (1, 2, 32, 64) output to (1, 32, 128), a
forward LSTMSequence whose final hidden state feeds a 30-class head:
  * the shipped XML is what the generator writes and the replay gives its
    ``.bin`` (built into a private directory);
  * FP32 and INT8 weight-only through the public API on the CPU, TORCH and
    KERNELS, against the JAX package's XLA backend one input at a time and
    (FP32) its interpreter, at rtol 1e-3 / atol 1e-5; infer_batch at 2;
  * the numpy interpreter bit for bit; the INT8 weight codes and scales,
    the (D, 4H, I) stacks with one scale per direction and output row
    (tests/test_recurrent.py::test_recurrent_weights_quantize_int8w);
  * INT8-FULL: the same activation scale (the head's) and the logits bit
    for bit with XLA's fused multiply-add epilogue: the recurrences run in
    float32 on dequantized weights in both packages, and XLA's and
    PyTorch's tanh and logistic differ in the last bits (ROADMAP.md §3,
    fault 7) without flipping a code of the head's input here;
  * infer_batch: the graph bakes at B (its (1,) lengths and (1, D, H)
    initial states broadcast over the batch), and its rows match single
    requests and the JAX package's vmapped infer_batch;
  * bfloat16 in the three modes with tests/test_torch_port_bf16.py's gate,
    against the JAX package as it runs by default and with XLA's excess
    precision off (a subprocess: XLA keeps float32 inside its fusions of
    the recurrence's gate math otherwise, ROADMAP.md §3 fault 5);
  * KERNELS launches one fused_gemm (the head: M = 1, K = 64, N = 30) and
    one softmax_rows (N = 30) a forward, where the JAX package's Pallas
    forward calls its kernel; the recurrences launch none."""

import importlib
import os
import subprocess
import sys

import numpy as np
import pytest

from pyopenvino_tpu.config import Config as JaxConfig
from pyopenvino_tpu.config import QuantMode as JaxQuantMode
from pyopenvino_tpu.runtime.compiler import compile_model as jax_compile

from pyopenvino_tpu_torch.config import Backend, QuantMode
from pyopenvino_tpu_torch.ir import read_ir_model
from pyopenvino_tpu_torch.models import lstm_tiny
from pyopenvino_tpu_torch.ops import supported_ops
from torch_port_families import (
    QUANTS, Family, FamilyBf16Case, Int8FullCase, check_bf16, check_kernel_launches, images,
)
from test_torch_port_int8full import BACKEND_PAIRS
import test_torch_port_threads  # noqa: F401  (this worker's torch threads)

SHAPE = (1, 32, 40)


@pytest.fixture(scope="module")
def family():
    return Family(lstm_tiny.lstm_tiny_paths(), images(SHAPE, 2, 7))


def test_ir_and_weights_are_the_generator(tmp_path):
    """The shipped XML is the one tools/gen_lstm.py writes, and the
    replayed .bin is its .bin byte for byte (another seed: other weights,
    the same layout)."""
    from pyopenvino_tpu.ir.writer import write_ir_model

    xml = str(tmp_path / "lstm_tiny.xml")
    write_ir_model(importlib.import_module("tools.gen_lstm").build_lstm(), xml)
    xml_path, bin_path = lstm_tiny.lstm_tiny_paths()
    with open(xml, "rb") as f, open(xml_path, "rb") as g:
        assert f.read() == g.read()
    with open(xml[:-4] + ".bin", "rb") as f, open(bin_path, "rb") as g:
        want = f.read()
        assert g.read() == want and len(want) == 422264
    with open(xml_path, encoding="utf-8") as f:
        other = lstm_tiny.generate_weights(f.read(), seed=1)
    assert len(other) == len(want) and other != want


def test_topology():
    model = read_ir_model(*lstm_tiny.lstm_tiny_paths())
    counts = {t: len(model.find_by_type(t)) for t in
              ("LSTMSequence", "MatMul", "SoftMax", "Transpose", "Reshape")}
    assert counts == {"LSTMSequence": 2, "MatMul": 1, "SoftMax": 1, "Transpose": 1,
                      "Reshape": 2}
    assert [n.attrs["direction"] for n in model.find_by_type("LSTMSequence")] == [
        "bidirectional", "forward"]
    assert {n.op_type for n in model} <= set(supported_ops())


@pytest.mark.parametrize("quant", [QuantMode.NONE, QuantMode.INT8_WEIGHT], ids=lambda q: q.value)
@pytest.mark.parametrize("kernel_type", ["torch", "kernels"])
def test_matches_jax(family, quant, kernel_type):
    _, batch = family.check_matches_jax(quant, kernel_type)
    assert batch.shape == (2, 30)
    assert (batch.argmax(1) == family.want[quant].argmax(1)).all()


def test_interpreter_and_codes_match_jax(family):
    """INT8 weight-only quantizes both layers' W and R stacks and the head:
    a (D, 4H, ·) stack per direction and output row, the contraction axis
    reduced; the ranking and the probabilities stay FP32's within 0.01
    (tests/test_recurrent.py::test_recurrent_weights_quantize_int8w)."""
    family.check_interpreter()
    assert family.check_int8_weight_codes() == 5
    exe = family.exe(QuantMode.INT8_WEIGHT, "torch")
    compiled = exe.compiled()
    stacks = {tuple(v.shape) for k, v in compiled.weights.items()
              if k.endswith(".scale") and v.dim() == 3}
    assert stacks == {(2, 256, 1), (1, 256, 1)}
    for nid, (codes, scale) in compiled._quantized.items():
        if codes.ndim == 3:
            assert scale.shape[:2] == codes.shape[:2] and scale.shape[2] == 1
    blob = images(SHAPE, 1, 0)
    ref = family.exe(QuantMode.NONE, "torch").infer({family.input: blob})[family.out]
    got = exe.infer({family.input: blob})[family.out]
    assert np.argmax(got) == np.argmax(ref)
    assert float(np.abs(got - ref).max()) < 0.01


@pytest.mark.parametrize("backend,jax_backend", BACKEND_PAIRS, ids=["torch", "kernels"])
def test_int8full_matches_jax(backend, jax_backend, monkeypatch):
    net = Int8FullCase(lstm_tiny.lstm_tiny_paths(), seed=3).check(backend, jax_backend,
                                                                  monkeypatch)
    assert len(net.act_scales) == 1  # the head; the LSTMSequences take no scale
    if backend == Backend.TORCH:
        assert len(net._int8_edges) == 1  # the head's input


def test_int8_modes_preserve_ranking(family):
    agree = family.int8_agreement()
    assert all(a == 1.0 for a in agree.values()), agree


@pytest.mark.parametrize("quant", QUANTS, ids=lambda q: q.value)
def test_infer_batch_bakes(family, quant):
    """The graph bakes at B: the Reshapes' leading 1 becomes B, and the (1,)
    sequence lengths and (1, D, H) zero initial states broadcast over the
    rows.  The rows match single requests (float32 sums of other M, within
    1e-6 of the largest probability; INT8-FULL exactly) and the JAX
    package's vmapped infer_batch at rtol 1e-3 / atol 1e-5."""
    cal = [{family.input: family.blobs[:1]}] if quant == QuantMode.INT8_FULL else None
    exe = family.exe(quant, "kernels", cal)
    batch = images(SHAPE, 3, 5)
    out = exe.infer_batch({family.input: batch})[family.out]
    assert exe.compiled()._batched_plan(3) is not None
    assert out.shape == (3, 30)
    single = np.concatenate([exe.infer({family.input: batch[i:i + 1]})[family.out]
                             for i in range(3)])
    if quant == QuantMode.INT8_FULL:
        np.testing.assert_array_equal(out, single)
    else:
        np.testing.assert_allclose(out, single, rtol=0, atol=1e-6)
    want = jax_compile(family.jax_model, JaxConfig(quant=JaxQuantMode(quant.value)),
                       calibration_samples=cal).infer_batch({family.input: batch})[family.out]
    np.testing.assert_allclose(out, want, rtol=1e-3, atol=1e-5)


@pytest.fixture(scope="module")
def bf16_case():
    return FamilyBf16Case(lstm_tiny.lstm_tiny_paths(), seed=3)


@pytest.fixture(scope="module")
def jax_bf16_exact(tmp_path_factory):
    """The JAX package's bfloat16 logits of the six (backend, quant) pairs
    with XLA's excess precision off, computed in a subprocess (XLA reads
    the flag when its CPU backend starts)."""
    out = tmp_path_factory.mktemp("lstm_bf16") / "logits.npz"
    script = (
        "import sys\n"
        "import numpy as np\n"
        "from pyopenvino_tpu.config import Backend as JaxBackend\n"
        "from pyopenvino_tpu_torch.models import lstm_tiny\n"
        "from torch_port_families import QUANTS, FamilyBf16Case\n"
        "case = FamilyBf16Case(lstm_tiny.lstm_tiny_paths(), seed=3)\n"
        "np.savez(sys.argv[1], **{f'{be.value}-{q.value}': case.jax(be, q, 'bfloat16')\n"
        "         for be in (JaxBackend.XLA, JaxBackend.PALLAS) for q in QUANTS})\n")
    tests = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": os.environ.get("XLA_FLAGS", "") + " --xla_allow_excess_precision=false",
           "PYTHONPATH": os.pathsep.join([tests, os.path.dirname(tests),
                                          os.environ.get("PYTHONPATH", "")])}
    subprocess.run([sys.executable, "-c", script, str(out)], env=env, check=True, timeout=900)
    with np.load(out) as data:
        return {k: data[k] for k in data.files}


@pytest.mark.parametrize("quant", QUANTS, ids=lambda q: q.value)
@pytest.mark.parametrize("backend,jax_backend", BACKEND_PAIRS, ids=["torch", "kernels"])
def test_bf16_matches_jax(bf16_case, jax_bf16_exact, backend, jax_backend, quant):
    """The port rounds every step of the recurrence to bfloat16, the
    logistic's three steps included (ops/elementwise.py::sigmoid, XLA's
    bfloat16 expansion); the gate holds against the JAX package both as it
    runs by default and with XLA's excess precision off (equal on this
    input, printed)."""
    check_bf16(bf16_case, backend, jax_backend, quant)
    check_bf16(bf16_case, backend, jax_backend, quant,
               want=jax_bf16_exact[f"{jax_backend.value}-{quant.value}"])


@pytest.mark.parametrize("quant", QUANTS, ids=lambda q: q.value)
def test_kernel_launches(family, quant, monkeypatch):
    import chip_smoke

    table = check_kernel_launches(family, quant, monkeypatch)
    name = {QuantMode.NONE: "fused_gemm", QuantMode.INT8_WEIGHT: "fused_gemm_i8w",
            QuantMode.INT8_FULL: "fused_gemm_i8i8"}[quant]
    assert table == {name: [(1, 64, 30, 1)]}
    assert chip_smoke.softmax_rows_of(family.exe(QuantMode.NONE, "kernels").compiled()) == [30]
