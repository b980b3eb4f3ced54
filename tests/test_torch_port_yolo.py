"""yolo-tiny (the port's ``models/yolo_tiny.xml`` with the weights
``models/yolo_tiny.py`` replays, byte for byte those of
``tools/gen_yolo.py::build_yolo_tiny``) on the port against the JAX package,
mirroring tests/test_yolo.py's family checks: seven 3×3 conv / PReLU(0.1)
blocks with 2×2 MaxPools (the sixth stride 1 with pads (0, 1)) down to a
5×5 grid, a 1×1 head of 45 channels and RegionYolo (5 anchors, 4 classes),
whose (1, 1125) region blob is the output:
  * the shipped XML is what the generator writes, the replay gives its
    ``.bin`` (built into a private directory), and the port's writer gives
    both back from the parsed IR (the slopes are rank-0 Consts);
  * FP32 and INT8 weight-only through the public API on the CPU, TORCH and
    KERNELS, against the JAX package's XLA backend one image at a time and
    (FP32) its interpreter, at rtol 1e-3 / atol 1e-5; infer_batch at 2 and
    4 (tests/test_yolo.py::test_yolo_tiny_batched); the region blob's
    logistic channels in (0, 1) and each anchor cell's class
    probabilities summing to 1;
  * the numpy interpreter bit for bit; the INT8 weight codes and scales;
  * INT8-FULL: the same activation scales and the head's output bit for
    bit with XLA's fused multiply-add epilogue, TORCH (int8 storage through
    PReLU → MaxPool, the stride-1 pool's end pad included) against XLA and
    KERNELS against PALLAS;
  * the decoded detections (metrics.decode_region_yolo): the JAX package's
    in each mode, and INT8 weight-only's and INT8-FULL's consistent with
    FP32's (tests/test_yolo.py::test_yolo_tiny_int8_decode_agreement);
  * bfloat16 in the three modes with tests/test_torch_port_bf16.py's gate
    on the head's output, and the region blob against the JAX package's;
  * KERNELS launches nothing in FP32 and INT8W (no 1×1 conv with
    co >= 128), and under INT8-FULL seven conv2d_direct (the 3×3 convs,
    Ci = 3 … 256 at 160² … 5²) and one int8 × int8 fused_gemm (the 1×1
    head, M = 25, K = 256, N = 45)."""

import importlib

import numpy as np
import pytest

from pyopenvino_tpu.config import Config as JaxConfig
from pyopenvino_tpu.config import QuantMode as JaxQuantMode
from pyopenvino_tpu.metrics import decode_region_yolo as jax_decode
from pyopenvino_tpu.runtime.compiler import compile_model as jax_compile

from pyopenvino_tpu_torch.config import Backend, QuantMode
from pyopenvino_tpu_torch.ir import parse_ir, read_ir_model
from pyopenvino_tpu_torch.ir.writer import serialize_ir
from pyopenvino_tpu_torch.metrics import decode_region_yolo
from pyopenvino_tpu_torch.models import yolo_tiny
from pyopenvino_tpu_torch.models.yolo_tiny import ANCHORS, CLASSES, GRID
from pyopenvino_tpu_torch.ops import supported_ops
from torch_port_families import (
    QUANTS, Family, FamilyBf16Case, Int8FullCase, check_bf16, check_kernel_launches, images,
)
from test_torch_port_int8full import BACKEND_PAIRS, xla_fma_epilogue
import test_torch_port_threads  # noqa: F401  (this worker's torch threads)

SHAPE = (1, 3, 160, 160)
BLOCK = 4 + 1 + CLASSES


def region_checks(blob):
    """A region blob's own invariants: x, y and the objectness in (0, 1),
    each anchor cell's class probabilities summing to 1."""
    t = blob.reshape(-1, len(ANCHORS), BLOCK, GRID, GRID)
    logistic = t[:, :, [0, 1, 4]]
    assert ((logistic > 0) & (logistic < 1)).all()
    np.testing.assert_allclose(t[:, :, 5:].sum(axis=2), 1.0, atol=1e-5)


def decode(blob):
    return decode_region_yolo(blob, (GRID, GRID), ANCHORS, CLASSES, conf_threshold=0.25)


def same_detections(got, want, score_atol, box_atol):
    assert [c for c, _, _ in got] == [c for c, _, _ in want]
    for (_, s, b), (_, ws, wb) in zip(got, want):
        assert abs(s - ws) <= score_atol
        np.testing.assert_allclose(b, wb, rtol=0, atol=box_atol)


@pytest.fixture(scope="module")
def family():
    return Family(yolo_tiny.yolo_tiny_paths(), images(SHAPE, 2, 7), distribution=False)


def test_ir_and_weights_are_the_generator(tmp_path):
    """The shipped XML is the one tools/gen_yolo.py writes, the replayed
    .bin is its .bin byte for byte (another seed: other weights, the same
    layout), and the port's writer writes both back from the parsed IR:
    each slope Const, rank 0 in the generator, is declared with shape "1"
    and a port without dims, which the port's parser and writer keep."""
    from pyopenvino_tpu.ir.writer import write_ir_model

    xml = str(tmp_path / "yolo_tiny.xml")
    write_ir_model(importlib.import_module("tools.gen_yolo").build_yolo_tiny(), xml)
    xml_path, bin_path = yolo_tiny.yolo_tiny_paths()
    with open(xml, "rb") as f, open(xml_path, "rb") as g:
        want_xml = f.read()
        assert g.read() == want_xml
    with open(xml[:-4] + ".bin", "rb") as f, open(bin_path, "rb") as g:
        want = f.read()
        assert g.read() == want and len(want) == 6337780
    with open(xml_path, encoding="utf-8") as f:
        other = yolo_tiny.generate_weights(f.read(), seed=1)
    assert len(other) == len(want) and other != want
    model = parse_ir(want_xml.decode("utf-8"), want, name="yolo-tiny")
    slopes = [model.nodes[model.in_edges[n.id][1][0]] for n in model.find_by_type("PReLU")]
    assert len(slopes) == 7
    for s in slopes:
        assert s.attrs["shape"] == "1" and s.outputs[s.out_port].shape == ()
        np.testing.assert_array_equal(s.const, np.full((1,), 0.1, np.float32))
    assert serialize_ir(model) == (want_xml, want)


def test_topology():
    model = read_ir_model(*yolo_tiny.yolo_tiny_paths())
    counts = {t: len(model.find_by_type(t)) for t in
              ("Convolution", "Add", "PReLU", "MaxPool", "RegionYolo")}
    assert counts == {"Convolution": 8, "Add": 8, "PReLU": 7, "MaxPool": 6, "RegionYolo": 1}
    pool1 = model.find_by_name("c6_pool1")
    assert (pool1.attrs["strides"], pool1.attrs["pads_begin"], pool1.attrs["pads_end"]) == (
        "1,1", "0,0", "1,1")
    assert {n.op_type for n in model} <= set(supported_ops())


@pytest.mark.parametrize("quant", [QuantMode.NONE, QuantMode.INT8_WEIGHT], ids=lambda q: q.value)
@pytest.mark.parametrize("kernel_type", ["torch", "kernels"])
def test_matches_jax(family, quant, kernel_type):
    """The region blob against the JAX package's, its own invariants, and
    the same detections decoded from it (scores within 1e-5, boxes within
    1e-5 of the unit image)."""
    _, batch = family.check_matches_jax(quant, kernel_type)
    assert batch.shape == (2, 1125)
    region_checks(batch)
    for got, want in zip(batch, family.want[quant]):
        same_detections(decode(got[None]), jax_decode(want[None], (GRID, GRID), ANCHORS,
                                                      CLASSES, conf_threshold=0.25),
                        1e-5, 1e-5)


def test_interpreter_and_codes_match_jax(family):
    family.check_interpreter()
    assert family.check_int8_weight_codes() == 8  # seven 3×3 convs and the head


@pytest.mark.parametrize("backend,jax_backend", BACKEND_PAIRS, ids=["torch", "kernels"])
def test_int8full_matches_jax(backend, jax_backend, monkeypatch):
    net = Int8FullCase(yolo_tiny.yolo_tiny_paths(), seed=3).check(backend, jax_backend,
                                                                  monkeypatch)
    assert len(net.act_scales) == 8
    if backend == Backend.TORCH:
        # each PReLU's output (read by a MaxPool that carries the codes, or
        # by c7's and the head's convs), the six pools' outputs and the input
        stored = net._int8_edges
        assert len(stored) == 13
        kinds = sorted(net.model.nodes[src].op_type for src, _ in stored)
        assert kinds == ["MaxPool"] * 6 + ["PReLU"] * 7


def test_int8_decode_agreement(family, monkeypatch):
    """INT8 weight-only and INT8-FULL (calibrated on the image) keep the
    decoded detections consistent with FP32's: a sparse, score-ordered set,
    about as many, the top detection's class, its score within 0.1 and its
    box within 0.08 (tests/test_yolo.py's gate); each mode's detections
    are the JAX package's, scores and boxes within 1e-5 (INT8-FULL with
    XLA's fused multiply-add epilogue, whose single rounding flips a code
    of this image otherwise: its top score then moves by 3.8e-3)."""
    blob = images(SHAPE, 1, 4)
    outs = {}
    for quant in QUANTS:
        cal = [{family.input: blob}] if quant == QuantMode.INT8_FULL else None
        exe = family.exe(quant, "torch", cal)
        outs[quant] = decode(exe.infer({family.input: blob})[family.out])
        want = jax_compile(family.jax_model, JaxConfig(quant=JaxQuantMode(quant.value)),
                           calibration_samples=cal).infer({family.input: blob})[family.out]
        if quant == QuantMode.INT8_FULL:
            xla_fma_epilogue(monkeypatch)
        same_detections(decode(exe.infer({family.input: blob})[family.out]),
                        jax_decode(want, (GRID, GRID), ANCHORS, CLASSES, conf_threshold=0.25),
                        1e-5, 1e-5)
    fp32 = outs[QuantMode.NONE]
    print({q.value: len(d) for q, d in outs.items()})
    assert 1 <= len(fp32) <= 30
    confs = [c for _, c, _ in fp32]
    assert confs == sorted(confs, reverse=True)
    for quant in (QuantMode.INT8_WEIGHT, QuantMode.INT8_FULL):
        got = outs[quant]
        assert abs(len(got) - len(fp32)) <= 2, (len(got), len(fp32))
        (c0, s0, b0), (c1, s1, b1) = fp32[0], got[0]
        assert c0 == c1 and abs(s0 - s1) < 0.1
        assert max(abs(a - b) for a, b in zip(b0, b1)) < 0.08


def test_infer_batch(family):
    """The batch runs in N (the graph bakes at B): rows equal single
    requests at rtol 1e-4 / atol 1e-5 (tests/test_yolo.py::
    test_yolo_tiny_batched)."""
    exe = family.exe(QuantMode.NONE, "kernels")
    rows = images(SHAPE, 4, 5)
    got = exe.infer_batch({family.input: rows})[family.out]
    assert exe.compiled()._batched_plan(4) is not None
    for i in range(4):
        single = exe.infer({family.input: rows[i:i + 1]})[family.out]
        np.testing.assert_allclose(got[i], single[0], rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def bf16_case():
    return FamilyBf16Case(yolo_tiny.yolo_tiny_paths(), seed=3)


@pytest.mark.parametrize("quant", QUANTS, ids=lambda q: q.value)
@pytest.mark.parametrize("backend,jax_backend", BACKEND_PAIRS, ids=["torch", "kernels"])
def test_bf16_matches_jax(bf16_case, backend, jax_backend, quant):
    check_bf16(bf16_case, backend, jax_backend, quant)


@pytest.mark.parametrize("quant", QUANTS, ids=lambda q: q.value)
def test_bf16_region_blob_matches_jax(family, quant):
    """The whole network in bfloat16 (RegionYolo's logistic and class
    softmax in bfloat16 steps) on TORCH against the JAX package's XLA
    backend: the region blob within its bfloat16 distance to JAX's own
    float32 blob (the gate of tests/test_torch_port_bf16.py), its
    invariants at bfloat16's resolution, and its equality to JAX's
    printed."""
    blob = images(SHAPE, 1, 3)
    cal = [{family.input: blob}] if quant == QuantMode.INT8_FULL else None
    got = family.exe(quant, "torch", cal, compute_dtype="bfloat16").infer(
        {family.input: blob})[family.out]
    jax = {dtype: np.asarray(jax_compile(
        family.jax_model, JaxConfig(quant=JaxQuantMode(quant.value), compute_dtype=dtype),
        calibration_samples=cal).infer({family.input: blob})[family.out], np.float32)
        for dtype in ("bfloat16", "float32")}
    d_port = np.abs(got - jax["bfloat16"]).mean()
    d_jax = np.abs(jax["bfloat16"] - jax["float32"]).mean()
    print(f"{quant.value}: mean |port - JAX| {d_port:.3e}, JAX bf16 vs f32 {d_jax:.3e}, "
          f"equal {np.array_equal(got, jax['bfloat16'])}")
    assert got.dtype == np.float32 and got.shape == (1, 1125)
    assert d_port < (1.0 if quant == QuantMode.INT8_FULL else 0.8) * d_jax
    t = got.reshape(len(ANCHORS), BLOCK, GRID, GRID)
    assert ((t[:, [0, 1, 4]] >= 0) & (t[:, [0, 1, 4]] <= 1)).all()
    np.testing.assert_allclose(t[:, 5:].sum(axis=1), 1.0, atol=2e-2)


@pytest.mark.parametrize("quant", QUANTS, ids=lambda q: q.value)
def test_kernel_launches(family, quant, monkeypatch):
    table = check_kernel_launches(family, quant, monkeypatch)
    if quant != QuantMode.INT8_FULL:
        assert table == {}
        return
    assert table["fused_gemm_i8i8"] == [(GRID * GRID, 256, 45, 1)]
    direct = table["conv2d_direct"]
    assert sum(c for *_, c in direct) == 7
    assert {k // 9 for _, k, _, _ in direct} == {3, 16, 32, 64, 128, 256}
