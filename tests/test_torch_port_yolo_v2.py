"""yolo-v2 (the port's ``models/yolo_v2.xml`` with the weights
``models/yolo_v2.py`` replays, byte for byte those of
``tools/gen_yolo.py::build_yolo_v2``) on the port against the JAX package:
yolo-tiny's 160×160 trunk to a 5×5 grid, the ReorgYolo passthrough, a 1×1
fuse conv, a 1×1 head, RegionYolo, and the box decode and
NonMaxSuppression on the device, whose answer is a (48, 7) record table
[image, class, confidence, x0, y0, x1, y1] with pad rows
[-1, -1, -1, 0, 0, 0, 0]:
  * the shipped XML is what the generator writes (the builder and version
    ``__graft_entry__._model_paths`` takes, built into a private directory),
    the replay gives its ``.bin``, and the port's writer gives both back;
  * FP32 and INT8 weight-only through the public API on the CPU, TORCH and
    KERNELS: the same records and classes in the same order as the JAX
    package's XLA backend (one input at a time) and its interpreter,
    confidences and corners within 1e-5; infer_batch runs one example at a
    time (the decode's Reshape names the anchors, not the batch);
  * the numpy interpreter bit for bit; the INT8 weight codes and scales;
  * INT8-FULL: the same activation scales, the head's output bit for bit
    with XLA's fused multiply-add epilogue (TORCH against XLA, KERNELS
    against PALLAS), and the records as in FP32;
  * INT8 weight-only's and INT8-FULL's records consistent with FP32's;
  * bfloat16 in the three modes: the head's output with
    tests/test_torch_port_bf16.py's gate, and the records with the same
    classes on each input and no farther from the JAX package's bfloat16
    records in the mean than those lie from its float32 ones;
  * KERNELS launches one fused_gemm (the fuse conv, M = 25, K = 768,
    N = 256) in FP32 and INT8W, and under INT8-FULL six conv2d_direct (the
    3×3 convs) and two int8 × int8 fused_gemm (fuse and head)."""

import numpy as np
import pytest

import pyopenvino_tpu.ir.model as jax_ir
from pyopenvino_tpu.config import Backend as JaxBackend
from pyopenvino_tpu.config import Config as JaxConfig
from pyopenvino_tpu.config import QuantMode as JaxQuantMode
from pyopenvino_tpu.ir import read_ir_model as jax_read
from pyopenvino_tpu.runtime.compiler import compile_model as jax_compile

import pyopenvino_tpu_torch.ir.model as port_ir
from pyopenvino_tpu_torch.config import Backend, Config, QuantMode
from pyopenvino_tpu_torch.ir import parse_ir, read_ir_model
from pyopenvino_tpu_torch.ir.writer import serialize_ir
from pyopenvino_tpu_torch.metrics import parse_detection_records
from pyopenvino_tpu_torch.models import yolo_v2
from pyopenvino_tpu_torch.ops import supported_ops
from pyopenvino_tpu_torch.runtime.compiler import compile_model
from chip_smoke import record_dists
from torch_port_families import (
    QUANTS, Family, check_bf16, images, jax_pallas_fused_gemms, kernel_calls,
)
from test_torch_port_bf16 import Bf16Case
from test_torch_port_int8full import BACKEND_PAIRS, FLIP_RTOL, _rel_err, xla_fma_epilogue
from test_torch_port_ocr import generator_files
import test_torch_port_threads  # noqa: F401  (this worker's torch threads)

SHAPE = (1, 3, 160, 160)
TABLE = (yolo_v2.RECORDS, 7)


def head_model(model, ir):
    """yolo-v2 cut at its head: a Result reads RegionYolo's input (the
    head conv's output with its bias), the network's logits."""
    region = model.find_by_type("RegionYolo")[0]
    src, sport = model.in_edges[region.id][0]
    keep = ir.ancestors(model, [src])
    nodes = {k: model.nodes[k] for k in keep}
    rid = max(model.nodes) + 1
    nodes[rid] = ir.Node(id=rid, name="logits", op_type="Result", attrs={},
                         inputs={0: model.nodes[src].outputs[sport]}, outputs={})
    edges = [e for e in model.edges if e.src in keep and e.dst in keep]
    return ir.Model(model.name, nodes, edges + [ir.Edge(src, sport, rid, 0)])


def same_records(got, want, atol):
    """Tables of records: the same rows, classes in the same order, every
    value within ``atol``; the pad rows [-1, -1, -1, 0, 0, 0, 0]."""
    got, want = got.reshape(-1, *TABLE), np.asarray(want).reshape(-1, *TABLE)
    assert got.shape == want.shape and got.dtype == np.float32
    for g, w in zip(got, want):
        dg, dw = parse_detection_records(g), parse_detection_records(w)
        assert [d[0] for d in dg] == [d[0] for d in dw]
        live = g[:, 0] >= 0
        assert (g[~live, :3] == -1).all() and (g[~live, 3:] == 0).all()
        assert not live[np.argmin(live):].any() or live.all()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.fixture(scope="module")
def family():
    return Family(yolo_v2.yolo_v2_paths(), images(SHAPE, 2, 7), distribution=False)


def test_ir_and_weights_are_the_generator(tmp_path):
    version, want_xml, want = generator_files(tmp_path, "yolo-v2")
    assert version == 201
    xml_path, bin_path = yolo_v2.yolo_v2_paths()
    with open(xml_path, "rb") as f, open(bin_path, "rb") as g:
        assert f.read() == want_xml
        assert g.read() == want and len(want) == 4765636
    with open(xml_path, encoding="utf-8") as f:
        other = yolo_v2.generate_weights(f.read(), seed=1)
    assert len(other) == len(want) and other != want
    assert serialize_ir(parse_ir(want_xml.decode("utf-8"), want, name="yolo-v2")) == (
        want_xml, want)


def test_topology():
    model = read_ir_model(*yolo_v2.yolo_v2_paths())
    counts = {t: len(model.find_by_type(t)) for t in
              ("Convolution", "PReLU", "MaxPool", "ReorgYolo", "RegionYolo", "Exp",
               "NonMaxSuppression", "Maximum", "GreaterEqual", "Gather")}
    assert counts == {"Convolution": 8, "PReLU": 7, "MaxPool": 5, "ReorgYolo": 1,
                      "RegionYolo": 1, "Exp": 2, "NonMaxSuppression": 1, "Maximum": 1,
                      "GreaterEqual": 1, "Gather": 3}
    nms = model.find_by_type("NonMaxSuppression")[0]
    assert (nms.attrs["output_type"], nms.attrs["sort_result_descending"]) == ("i32", "1")
    assert {n.op_type for n in model} <= set(supported_ops())


@pytest.mark.parametrize("quant", [QuantMode.NONE, QuantMode.INT8_WEIGHT], ids=lambda q: q.value)
@pytest.mark.parametrize("kernel_type", ["torch", "kernels"])
def test_matches_jax(family, quant, kernel_type):
    """Each input's records against the JAX package's (and FP32's against
    its interpreter), at batch 1 and through infer_batch, which runs the
    inputs one at a time; records on both seeded inputs."""
    exe = family.exe(quant, kernel_type)
    want = family.want[quant].reshape(-1, *TABLE)
    one = exe.infer({family.input: family.blobs[:1]})[family.out]
    batch = exe.infer_batch({family.input: family.blobs})[family.out]
    assert one.shape == TABLE and batch.shape == (2, *TABLE)
    assert exe.compiled()._batched_plan(2) is None
    same_records(one, want[0], 1e-5)
    same_records(batch, want, 1e-5)
    np.testing.assert_array_equal(batch[0], one)
    if quant == QuantMode.NONE:
        same_records(one, family.interpreted, 1e-5)
    assert all((t[:, 0] >= 0).sum() > 0 for t in batch)


def test_interpreter_and_codes_match_jax(family):
    family.check_interpreter()
    assert family.check_int8_weight_codes() == 8  # six 3×3 convs, fuse and head


class Int8FullHead:
    """INT8-FULL on one image, calibrated on the same 2 samples in both
    packages: the head's output (``head_model``) and the records."""

    def __init__(self, seed=3):
        paths = yolo_v2.yolo_v2_paths()
        rng = np.random.default_rng(seed)
        self.samples = [{"data": rng.uniform(0, 255, SHAPE).astype(np.float32)}
                        for _ in range(2)]
        self.x = {"data": rng.uniform(0, 255, SHAPE).astype(np.float32)}
        self.models = {"head": head_model(read_ir_model(*paths), port_ir),
                       "records": read_ir_model(*paths)}
        jax_models = {"head": head_model(jax_read(*paths), jax_ir), "records": jax_read(*paths)}
        self.want, self.scales = {}, {}
        for be in (JaxBackend.XLA, JaxBackend.PALLAS):
            for part, model in jax_models.items():
                net = jax_compile(model, JaxConfig(backend=be, quant=JaxQuantMode.INT8_FULL),
                                  calibration_samples=self.samples)
                self.scales[be, part] = net.act_scales
                self.want[be, part] = net.infer(self.x)[model.results[0].name]


@pytest.fixture(scope="module")
def int8full_case():
    return Int8FullHead()


@pytest.mark.parametrize("backend,jax_backend", BACKEND_PAIRS, ids=["torch", "kernels"])
def test_int8full_matches_jax(int8full_case, backend, jax_backend, monkeypatch):
    case = int8full_case
    nets = {part: compile_model(model, Config(backend=backend, quant=QuantMode.INT8_FULL),
                                device="cpu", calibration_samples=case.samples)
            for part, model in case.models.items()}
    for part, net in nets.items():
        assert net.act_scales == case.scales[jax_backend, part]
        assert len(net.act_scales) == 8
    head = nets["head"].infer(case.x)["logits"]
    err = _rel_err(head, case.want[jax_backend, "head"])
    assert err <= FLIP_RTOL
    xla_fma_epilogue(monkeypatch)
    np.testing.assert_array_equal(nets["head"].infer(case.x)["logits"],
                                  case.want[jax_backend, "head"])
    records = nets["records"].infer(case.x)["detections"]
    print(f"{backend.value}: head max rel err {err:.3e} (limit {FLIP_RTOL}), with XLA's FMA "
          f"epilogue 0; records max abs diff "
          f"{np.abs(records - case.want[jax_backend, 'records']).max():.3e}")
    same_records(records, case.want[jax_backend, "records"], 1e-5)
    if backend == Backend.TORCH:
        # the PReLU outputs read by a pool or a 3×3 conv, the pools', the
        # passthrough's ReorgYolo and the Concat the fuse conv reads
        stored = nets["records"]._int8_edges
        assert sorted(nets["records"].model.nodes[s].op_type for s, _ in stored) == [
            "Concat"] + ["MaxPool"] * 4 + ["PReLU"] * 6 + ["ReorgYolo"]


def test_int8_records_agree_with_fp32(family):
    """INT8 weight-only and INT8-FULL (calibrated on the image and one
    more) keep the records consistent with FP32's: about as many, the top
    record's class, its confidence within 0.1 and its box within 0.08
    (tests/test_yolo.py's decode gate)."""
    blob = family.blobs[:1]
    ref = parse_detection_records(family.exe(QuantMode.NONE, "torch").infer(
        {family.input: blob})[family.out])
    cal = [{family.input: blob}, {family.input: images(SHAPE, 1, 1)}]
    for quant in (QuantMode.INT8_WEIGHT, QuantMode.INT8_FULL):
        got = parse_detection_records(family.exe(
            quant, "torch", cal if quant == QuantMode.INT8_FULL else None).infer(
            {family.input: blob})[family.out])
        print(quant.value, len(got), len(ref))
        assert abs(len(got) - len(ref)) <= 2
        (c0, s0, b0), (c1, s1, b1) = ref[0], got[0]
        assert c0 == c1 and abs(s0 - s1) < 0.1
        assert max(abs(a - b) for a, b in zip(b0, b1)) < 0.08


@pytest.fixture(scope="module")
def bf16_case():
    return Bf16Case(yolo_v2.yolo_v2_paths(), seed=3, high=255.0, cut=head_model)


@pytest.mark.parametrize("quant", QUANTS, ids=lambda q: q.value)
@pytest.mark.parametrize("backend,jax_backend", BACKEND_PAIRS, ids=["torch", "kernels"])
def test_bf16_head_matches_jax(bf16_case, backend, jax_backend, quant):
    check_bf16(bf16_case, backend, jax_backend, quant)


@pytest.mark.parametrize("quant", QUANTS, ids=lambda q: q.value)
def test_bf16_records_match_jax(family, quant):
    """The whole network in bfloat16 on TORCH against the JAX package's XLA
    backend: the records hold the same classes on the input, and lie no
    farther from JAX's bfloat16 records in the mean than those lie from
    JAX's float32 ones (``chip_smoke.record_dists``), pad rows exact."""
    blob = images(SHAPE, 1, 3)
    cal = [{family.input: blob}] if quant == QuantMode.INT8_FULL else None
    got = family.exe(quant, "torch", cal, compute_dtype="bfloat16").infer(
        {family.input: blob})[family.out]
    jax = {dtype: np.asarray(jax_compile(
        family.jax_model, JaxConfig(quant=JaxQuantMode(quant.value), compute_dtype=dtype),
        calibration_samples=cal).infer({family.input: blob})[family.out], np.float32)
        for dtype in ("bfloat16", "float32")}
    agree, dists = record_dists(got[None], jax["bfloat16"][None])
    own_agree, own = record_dists(jax["bfloat16"][None], jax["float32"][None])
    print(f"{quant.value}: records vs JAX bf16 mean {np.mean(dists):.3e} max {max(dists):.3e}; "
          f"JAX bf16 vs f32 mean {np.mean(own):.3e} max {max(own):.3e}; equal "
          f"{np.array_equal(got, jax['bfloat16'])}")
    assert got.shape == TABLE and got.dtype == np.float32
    assert agree == 1 and own_agree == 1
    assert np.mean(dists) <= np.mean(own)
    live = got[:, 0] >= 0
    assert live.sum() > 0 and (got[~live, :3] == -1).all() and (got[~live, 3:] == 0).all()


@pytest.mark.parametrize("quant", QUANTS, ids=lambda q: q.value)
def test_kernel_launches(family, quant, monkeypatch):
    """The KERNELS forward's fused_gemm and conv2d_direct calls at the
    shapes of chip_smoke.launch_table and direct_convs.  The JAX package's
    Pallas forward calls its fused_gemm for the fuse conv in FP32 and INT8
    weight-only, as the port does; under INT8-FULL it runs every conv as an
    XLA int8 conv, where the port takes its kernels.
    Its conv path calls fused_gemm through the name kernels/conv.py bound
    at import, so that name is counted too."""
    import pyopenvino_tpu.kernels.conv as jax_conv

    import chip_smoke

    conv_calls, plain = [], jax_conv.fused_gemm

    def counted(a, b, *args, **kw):
        conv_calls.append((a.shape[0], tuple(b.shape)))
        return plain(a, b, *args, **kw)

    monkeypatch.setattr(jax_conv, "fused_gemm", counted)
    samples = ([{family.input: family.blobs[:1]}, {family.input: family.blobs[1:2]}]
               if quant == QuantMode.INT8_FULL else None)
    matmul_calls = jax_pallas_fused_gemms(family, quant, samples, monkeypatch)
    seen = kernel_calls(monkeypatch)
    exe = family.exe(quant, "kernels", samples)
    exe.infer({family.input: family.blobs[:1]})
    compiled = exe.compiled()
    table = chip_smoke.launch_table(compiled, quant.value)
    assert sorted((m, kn) for _, m, kn in seen["gemm"]) == sorted(
        (m, (k, n)) for name, shapes in table.items() if name != "conv2d_direct"
        for m, k, n, c in shapes for _ in range(c))
    assert sorted(seen["direct"]) == sorted(
        ((1, h, w, ci), (co, ci, kh, kw))
        for h, w, ci, co, kh, kw, _pads, c in chip_smoke.direct_convs(compiled, quant.value)
        for _ in range(c))
    assert matmul_calls == []
    assert conv_calls == ([] if quant == QuantMode.INT8_FULL else [(25, (768, 256))])
    if quant != QuantMode.INT8_FULL:
        name = "fused_gemm" if quant == QuantMode.NONE else "fused_gemm_i8w"
        assert table == {name: [(25, 768, 256, 1)]}
        return
    assert table["fused_gemm_i8i8"] == [(25, 256, 45, 1), (25, 768, 256, 1)]
    direct = table["conv2d_direct"]
    assert sum(c for *_, c in direct) == 6
    assert {k // 9 for _, k, _, _ in direct} == {3, 16, 32, 64, 128, 256}
