"""SSD-MobileNet-v1 (assets/trained/ssd_shapes_ms, trained weights) in the port
against the JAX package: DetectionOutput and PriorBoxClustered, the folded
anchor chains, the interpreter, quantization and calibration, and the
record tables of FP32, INT8 weight-only and INT8-FULL on both backend pairs
(TORCH against XLA, KERNELS against PALLAS in interpret mode), with the
settings that tools/accuracy.py gives this model.

Inputs are tools/datasets.py's labelled shapes images, made with numpy from
a seed and handed to both packages."""

import numpy as np
import pytest
import torch

from pyopenvino_tpu.config import Backend as JaxBackend
from pyopenvino_tpu.config import Config as JaxConfig
from pyopenvino_tpu.config import QuantMode as JaxQuantMode
from pyopenvino_tpu.ir import read_ir_model as jax_read
from pyopenvino_tpu.ops import ssd as jax_ssd
from pyopenvino_tpu.runtime.compiler import compile_model as jax_compile

from pyopenvino_tpu_torch.config import Backend, Config, QuantMode
from pyopenvino_tpu_torch.ir import read_ir_model
from pyopenvino_tpu_torch.ops import ssd
from pyopenvino_tpu_torch.runtime.compiler import compile_model
import test_torch_port_threads  # noqa: F401  (this worker's torch threads)

PATHS = ("assets/trained/ssd_shapes_ms.xml", "assets/trained/ssd_shapes_ms.bin")
IN, OUT = "image_tensor", "detection_boxes:0"
# KERNELS/TORCH against PALLAS/XLA: the same records (count, classes, order),
# confidences and box corners within this (float32 sums in another order,
# and XLA's fused multiply-adds in the box decode)
RECORD_ATOL = 1e-4
# DetectionOutput's batched PyTorch and JAX versions against the numpy
# twin (float32 against float64): tests/test_detection.py's limits
DO_RTOL, DO_ATOL = 1e-4, 1e-5

MODES = {"fp32": (QuantMode.NONE, JaxQuantMode.NONE),
         "int8w": (QuantMode.INT8_WEIGHT, JaxQuantMode.INT8_WEIGHT),
         "int8full": (QuantMode.INT8_FULL, JaxQuantMode.INT8_FULL)}
PAIRS = [(Backend.TORCH, JaxBackend.XLA), (Backend.KERNELS, JaxBackend.PALLAS)]


def accuracy_settings(jax_quant):
    """The Config fields tools/accuracy.py sets for ssd_shapes_ms."""
    from tools.accuracy import CAL_METHOD, CAL_PERCENTILE, QUANT_MIN_ELEMS_MODEL, _bias_corr

    name = "ssd_shapes_ms"
    return dict(quant_min_elems=QUANT_MIN_ELEMS_MODEL[name],
                calibration_percentile=CAL_PERCENTILE.get(name, 100.0),
                calibration_method=CAL_METHOD,
                bias_correction=_bias_corr(name, jax_quant) and jax_quant != JaxQuantMode.NONE)


class SsdCase:
    """8 labelled evaluation images and 4 calibration images (tools/accuracy's
    seeds); each package's network per (backend, mode) and its outputs,
    computed once."""

    def __init__(self):
        from tools import datasets
        from tools.accuracy import CAL_SEED, EVAL_SEED

        self.x, gt = datasets.shapes_det300(8, EVAL_SEED)
        self.gt = {i: [(c + 1, box) for c, box in g] for i, g in enumerate(gt)}
        cal, _ = datasets.shapes_det300(4, CAL_SEED)
        self.calibration = [{IN: cal[i:i + 1]} for i in range(len(cal))]
        self.port_model = read_ir_model(*PATHS)
        self.jax_model = jax_read(*PATHS)
        self._nets = {}

    def nets(self, backend, jax_backend, mode):
        key = (backend, mode)
        if key not in self._nets:
            quant, jax_quant = MODES[mode]
            settings = accuracy_settings(jax_quant)
            samples = self.calibration if quant != QuantMode.NONE else None
            jax_net = jax_compile(self.jax_model, JaxConfig(
                backend=jax_backend, quant=jax_quant, **settings), calibration_samples=samples)
            net = compile_model(self.port_model, Config(backend=backend, quant=quant, **settings),
                                device="cpu", calibration_samples=samples)
            self._nets[key] = (net, jax_net, net.infer_batch({IN: self.x})[OUT],
                               jax_net.infer_batch({IN: self.x})[OUT])
        return self._nets[key]


@pytest.fixture(scope="module")
def case():
    return SsdCase()


def check_records(got, want, atol=RECORD_ATOL):
    """The same records, classes in the same order, values within atol;
    returns the largest difference."""
    from pyopenvino_tpu.metrics import parse_detection_records

    assert got.shape == want.shape and np.isfinite(got).all()
    for g, w in zip(got.reshape(-1, got.shape[-2], 7), want.reshape(-1, want.shape[-2], 7)):
        dg, dw = parse_detection_records(g), parse_detection_records(w)
        assert [d[0] for d in dg] == [d[0] for d in dw]
    err = float(np.abs(got - want).max())
    assert err <= atol
    return err


# -- DetectionOutput and PriorBoxClustered ------------------------------------

def _do_cases():
    """tests/test_detection.py's seeded cases of DetectionOutput: (name,
    logits, scores, proposals, params), one example each."""
    from test_detection import _make_case

    cases = [(f"seed{s}", *_make_case(s)) for s in range(4)]
    lg, sc, pr, p = _make_case(0)
    cases.append(("terminator", lg, sc, pr, dict(p, confidence_threshold=2.0)))
    lg, sc, pr, p = _make_case(5)
    cases.append(("corner", lg, sc, pr, dict(p, code_type="caffe.PriorBoxParameter.CORNER")))
    for s in (0, 1, 2, 3, 11):
        lg, sc, pr, p = _make_case(s, P=96)
        cases.append((f"top_k8_seed{s}", lg, sc, pr, dict(p, top_k=8)))
        cases.append((f"no_top_k_seed{s}", lg, sc, pr, dict(p, top_k=-1)))
    lg, sc, pr, p = _make_case(100, P=12)
    cases.append(("fewer_priors", lg, sc, pr, dict(p, keep_top_k=(20,), top_k=20)))
    lg, sc, pr, p = _make_case(7, P=32, nc=3)
    cases.append(("keep_top_k0", lg, sc, pr, dict(p, keep_top_k=(0,), top_k=8)))
    for s in range(8):  # large variances half-invert boxes: the union > 0 guard
        lg, sc, pr, p = _make_case(s, P=40)
        pr = pr.copy()
        pr[0, 1] = np.tile(np.float32(0.5), pr.shape[2])
        cases.append((f"inverting_seed{s}", lg, sc, pr,
                      dict(p, top_k=-1, nms_threshold=0.4, clip_after_nms=False,
                           code_type="caffe.PriorBoxParameter.CORNER")))
    cases.append(("num_keep_eq_top_k", *_num_keep_eq_top_k_case()))
    return cases


def _num_keep_eq_top_k_case():
    """12 disjoint boxes above the threshold, 18 below: top_k = 10 keeps
    exactly 10, so the -1 row lands after the top-k block of 10 records."""
    from test_detection import _make_case

    P, nc = 30, 3
    rng = np.random.default_rng(4)
    cx = np.tile(np.arange(6) * 0.16 + 0.1, 5)
    cy = np.repeat(np.arange(5) * 0.2 + 0.1, 6)
    boxes = np.stack([cx - 0.05, cy - 0.05, cx + 0.05, cy + 0.05], axis=1)
    var = np.tile([0.1, 0.1, 0.2, 0.2], (P, 1))
    proposals = np.stack([boxes.reshape(-1), var.reshape(-1)])[None].astype(np.float32)
    scores = np.full((P, nc), 0.1, np.float32)
    scores[:12, 1] = np.linspace(0.9, 0.5, 12)
    logits = rng.normal(0, 0.1, (1, P * 4)).astype(np.float32)
    p = dict(_make_case(0)[3], num_classes=nc, top_k=10, keep_top_k=(20,))
    return logits, scores.reshape(1, -1), proposals, p


DO_CASES = _do_cases()


@pytest.mark.parametrize("name,logits,scores,proposals,p", DO_CASES,
                         ids=[c[0] for c in DO_CASES])
def test_detection_output_matches_jax_twins(name, logits, scores, proposals, p):
    """The numpy twin is the JAX package's to the bit; the batched PyTorch
    version agrees with it and with the JAX batched version."""
    want = jax_ssd.detection_output_ref(logits, scores, proposals, p)
    ref = ssd.detection_output_ref(logits, scores, proposals, p)
    np.testing.assert_array_equal(ref, want)
    got = ssd.detection_output_torch(torch.from_numpy(logits), torch.from_numpy(scores),
                                     torch.from_numpy(proposals), p).numpy()
    assert got.shape == (1,) + ref.shape
    np.testing.assert_allclose(got[0], ref, rtol=DO_RTOL, atol=DO_ATOL)
    jax_batched = np.asarray(jax_ssd.detection_output_jax_batched(logits, scores, proposals, p))
    np.testing.assert_allclose(got, jax_batched, rtol=DO_RTOL, atol=DO_ATOL)
    if name == "num_keep_eq_top_k":
        assert (got[0, 0, 0, :10, 0] == np.arange(10)).all() and got[0, 0, 0, 10, 0] == -1


def test_detection_output_batched_rows_and_tiles():
    """Five examples in one call, suppression in row tiles of 16: each row
    equals the numpy twin of its example."""
    from test_detection import _make_case

    cases = [_make_case(20 + i, P=96) for i in range(5)]
    p = dict(cases[0][3], top_k=-1)
    logits = np.concatenate([c[0] for c in cases])
    scores = np.concatenate([c[1] for c in cases])
    got = ssd.detection_output_torch(torch.from_numpy(logits), torch.from_numpy(scores),
                                     torch.from_numpy(cases[0][2]), p, row_tile=16).numpy()
    for i in range(5):
        want = ssd.detection_output_ref(logits[i:i + 1], scores[i:i + 1], cases[0][2], p)
        np.testing.assert_allclose(got[i], want, rtol=DO_RTOL, atol=DO_ATOL)


def test_anchor_chains_fold_as_in_jax(case):
    """ShapeOf → StridedSlice → PriorBoxClustered → Unsqueeze → Concat fold
    at compile time: the same folded nodes as the JAX compiler's, the same
    anchor table to the bit, and no anchor op runs per call."""
    net, jax_net, _, _ = case.nets(Backend.TORCH, JaxBackend.XLA, "fp32")
    assert net._folded_nodes == jax_net._folded_nodes
    folded_types = {net.model.nodes[n].op_type for n in net._folded_nodes}
    assert {"ShapeOf", "StridedSlice", "PriorBoxClustered", "Unsqueeze", "Concat"} <= folded_types
    do = net.model.find_by_type("DetectionOutput")[0]
    src, sport = net.model.in_edges[do.id][2]
    anchors = net.analysis.value(src, sport)
    assert anchors.shape == (1, 2, 1917 * 4)
    np.testing.assert_array_equal(anchors, jax_net.analysis.value(src, sport))
    assert len(net._static) >= 1  # the anchors, put on the device once
    assert [t for t in net._static.values() if tuple(t.shape) == anchors.shape]


def test_fold_scale_leaves_ssd_unchanged(case):
    """SSD's one Multiply scales the input Parameter, not a conv output: the
    JAX package's BN-scale folding changes nothing on this graph (the port's
    own pass is held to the same in tests/test_torch_port_fold_scale.py)."""
    from pyopenvino_tpu.passes.fold_scale import fold_scale_into_conv

    model = case.jax_model
    folded = fold_scale_into_conv(model)
    assert sorted(folded.nodes) == sorted(model.nodes)
    assert sorted((e.src, e.src_port, e.dst, e.dst_port) for e in folded.edges) == sorted(
        (e.src, e.src_port, e.dst, e.dst_port) for e in model.edges)
    for nid, node in model.nodes.items():
        if node.const is not None:
            np.testing.assert_array_equal(folded.nodes[nid].const, node.const)


def test_interpreter_bit_identical(case):
    from pyopenvino_tpu.runtime.interpreter import Interpreter as JaxInterpreter

    from pyopenvino_tpu_torch.runtime.interpreter import Interpreter

    x = {IN: case.x[:1]}
    got = Interpreter(case.port_model).run(x)
    want = JaxInterpreter(case.jax_model).run(x)
    assert sorted(got) == sorted(want) == [OUT]
    np.testing.assert_array_equal(got[OUT], want[OUT])
    assert (got[OUT][0, 0, :, 0] >= 0).sum() > 1  # records, not just the -1 row


def test_quantization_matches_jax(case):
    """With tools/accuracy.py's settings: equal activation scales, int8 codes
    and weight scales (quant_min_elems 4096), bias corrections (INT8-FULL),
    and int8 storage edges (TORCH against XLA; none on KERNELS)."""
    from pyopenvino_tpu.runtime.compiler import CompiledNetwork as JaxCompiledNetwork
    from pyopenvino_tpu.runtime.compiler import prepare_model as jax_prepare

    from pyopenvino_tpu_torch.runtime.compiler import CompiledNetwork, prepare_model

    settings = accuracy_settings(JaxQuantMode.INT8_FULL)
    assert settings["quant_min_elems"] == 4096 and settings["bias_correction"]
    assert settings["calibration_percentile"] == 100.0
    jax_config = JaxConfig(backend=JaxBackend.XLA, quant=JaxQuantMode.INT8_FULL, **settings)
    jm, jq, js, jb = jax_prepare(case.jax_model, jax_config, case.calibration)
    config = Config(backend=Backend.TORCH, quant=QuantMode.INT8_FULL, **settings)
    pm, pq, ps, pb = prepare_model(case.port_model, config, case.calibration)
    assert ps == js and len(ps) == 47
    assert sorted(pq) == sorted(jq) and 0 < len(pq) < 47
    for nid, (codes, scales) in jq.items():
        np.testing.assert_array_equal(pq[nid][0], codes)
        np.testing.assert_array_equal(pq[nid][1], scales)
    assert sorted(pb) == sorted(jb) and len(pb) > 10
    for nid, delta in jb.items():
        np.testing.assert_array_equal(pb[nid], delta)
    want = JaxCompiledNetwork(jm, jax_config, quantized=jq, act_scales=js,
                              bias_corr=jb)._int8_edges
    got = CompiledNetwork(pm, config, device="cpu", quantized=pq, act_scales=ps,
                          bias_corr=pb)._int8_edges
    assert got == want and len(want) > 5
    kernels = CompiledNetwork(pm, config.replace(backend=Backend.KERNELS), device="cpu",
                              quantized=pq, act_scales=ps, bias_corr=pb)
    assert kernels._int8_edges == {}


# -- the record tables end to end --------------------------------------------

@pytest.mark.parametrize("mode", ["fp32", "int8w"])
@pytest.mark.parametrize("backend,jax_backend", PAIRS)
def test_float_records_match_jax(case, backend, jax_backend, mode):
    """infer_batch on 8 images: the JAX package's (B, 1, 100, 7) layout and
    its records; a request alone gives the same table as its batch row."""
    net, _, got, want = case.nets(backend, jax_backend, mode)
    assert got.shape == want.shape == (8, 1, 100, 7)
    err = check_records(got, want)
    print(f"{mode} {backend.value} vs {jax_backend.value}: records max abs diff {err:.3e} "
          f"(limit {RECORD_ATOL})")
    single = net.infer({IN: case.x[:1]})[OUT]
    assert single.shape == (1, 1, 100, 7)
    check_records(single, got[:1])


@pytest.mark.parametrize("backend,jax_backend", PAIRS)
def test_int8full_records_match_jax(case, backend, jax_backend, monkeypatch):
    """INT8-FULL: the port rounds the epilogue twice where XLA's fused
    multiply-add rounds once, which may flip an int8 code at a tie.  The
    batch's records agree within RECORD_ATOL (the difference is printed);
    with XLA's rounding patched into the port's epilogue, a request's
    record table equals the JAX package's to the bit."""
    from test_torch_port_int8full import xla_fma_epilogue

    net, jax_net, got, want = case.nets(backend, jax_backend, "int8full")
    assert net.act_scales == jax_net.act_scales
    err = check_records(got, want)
    print(f"int8full {backend.value} vs {jax_backend.value}: records max abs diff {err:.3e} "
          f"(limit {RECORD_ATOL})")
    xla_fma_epilogue(monkeypatch)
    for i in range(2):
        x = {IN: case.x[i:i + 1]}
        np.testing.assert_array_equal(net.infer(x)[OUT], jax_net.infer(x)[OUT])


@pytest.mark.parametrize("mode", ["fp32", "int8w", "int8full"])
def test_map_matches_jax(case, mode):
    """mAP at IoU 0.5 against the real boxes: the port's (both backends) is
    the JAX package's, and the port's metric equals the JAX package's."""
    from pyopenvino_tpu.metrics import coco_map
    from pyopenvino_tpu.metrics import parse_detection_records as jax_parse

    from pyopenvino_tpu_torch.metrics import mean_average_precision, parse_detection_records

    maps = []
    for backend, jax_backend in PAIRS:
        _, _, got, want = case.nets(backend, jax_backend, mode)
        dets = {i: parse_detection_records(r) for i, r in enumerate(got)}
        jax_dets = {i: jax_parse(r) for i, r in enumerate(want)}
        assert dets == {i: jax_parse(r) for i, r in enumerate(got)}
        ours = mean_average_precision(case.gt, dets)
        assert ours == coco_map(case.gt, dets, iou_thresholds=(0.5,))
        maps.append((ours, coco_map(case.gt, jax_dets, iou_thresholds=(0.5,))))
    print(f"{mode}: mAP@0.5 (port, JAX) per backend pair {maps}")
    for ours, theirs in maps:
        assert ours == theirs and ours > 60.0


# -- the new ops' emit on tensors that are not folded -------------------------

SHAPE_OP_CASES = [
    ("Transpose", {}, {1: np.array([0, 2, 3, 1])}),
    ("Unsqueeze", {}, {1: np.array([0, -1])}),
    ("StridedSlice", {"begin_mask": "0,1", "end_mask": "1,0", "shrink_axis_mask": "0,0,1"},
     {1: np.array([1, 0, 2]), 2: np.array([0, 2, 3]), 3: np.array([1, 1, 1])}),
    ("StridedSlice", {"new_axis_mask": "0,1", "ellipsis_mask": "1"},
     {1: np.array([0, 0]), 2: np.array([0, 0])}),
    ("ShapeOf", {}, {}),
    ("Sigmoid", {}, {}),
    ("Multiply", {}, {1: np.float32([0.5, -2.0, 3.0, 1.0, 0.25])}),
]


@pytest.mark.parametrize("op_type,attrs,statics", SHAPE_OP_CASES,
                         ids=[f"{c[0]}{i}" for i, c in enumerate(SHAPE_OP_CASES)])
def test_new_ops_emit_like_the_jax_reference(op_type, attrs, statics):
    """Each new op's emit on a tensor (compile-time ports from the static
    values) against the JAX package's ref_compute."""
    import types

    import pyopenvino_tpu.ir.model as jax_ir
    from pyopenvino_tpu.ops import get_op as jax_get_op

    import pyopenvino_tpu_torch.ir.model as port_ir
    from pyopenvino_tpu_torch.ops import TValue, get_op

    x = np.random.default_rng(0).standard_normal((2, 3, 4, 5)).astype(np.float32)
    kw = dict(id=0, name="n", op_type=op_type, attrs=attrs, inputs={},
              outputs={1: types.SimpleNamespace(dtype=np.int64)})
    node, jnode = port_ir.Node(**kw), jax_ir.Node(**kw)
    want = jax_get_op(op_type).ref_compute(jnode, {0: x, **statics})[1]
    ctx = types.SimpleNamespace(
        static_value=lambda n, port: statics[port],
        model=types.SimpleNamespace(in_edges={0: {p: None for p in (0, *statics)}}))
    ins = {0: TValue(torch.from_numpy(x).contiguous(memory_format=torch.channels_last))}
    if op_type == "Multiply":
        ins[1] = TValue(torch.from_numpy(statics[1]))
    got = get_op(op_type).emit(ctx, node, ins)[1].arr.numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6 if op_type == "Sigmoid" else 0, atol=0)


def test_concat_carries_int8_at_one_scale():
    """Concat of inputs stored at one scale stays int8 at that scale; mixed
    inputs are dequantized and concatenated in float."""
    import types

    import pyopenvino_tpu_torch.ir.model as port_ir
    from pyopenvino_tpu_torch.ops import TValue, get_op

    node = port_ir.Node(id=0, name="c", op_type="Concat", attrs={"axis": "1"}, inputs={},
                        outputs={2: None})
    a = torch.tensor([[1, -2]], dtype=torch.int8)
    b = torch.tensor([[3]], dtype=torch.int8)
    out = get_op("Concat").emit(types.SimpleNamespace(), node, {
        0: TValue(a, act_scale=0.5), 1: TValue(b, act_scale=0.5)})[2]
    assert out.act_scale == 0.5 and out.arr.dtype == torch.int8
    assert out.arr.tolist() == [[1, -2, 3]]
    mixed = get_op("Concat").emit(types.SimpleNamespace(compute_dtype=torch.float32), node, {
        0: TValue(a, act_scale=0.5), 1: TValue(b.float())})[2]
    assert mixed.act_scale is None and mixed.arr.tolist() == [[0.5, -1.0, 3.0]]


def test_bake_batch_matches_jax_on_ssd(case):
    """bake_batch on SSD: every shape and patched Reshape target as in the
    JAX package, and DetectionOutput stamped with the batch, whose output
    is then one (1, 100, 7) table per example."""
    from pyopenvino_tpu.passes.shape_infer import bake_batch as jax_bake

    from pyopenvino_tpu_torch.passes.shape_infer import bake_batch

    port = bake_batch(case.port_model, 3)
    ref = jax_bake(case.jax_model, 3)
    for nid, n in port.nodes.items():
        r = ref.nodes[nid]
        assert n.attrs == r.attrs
        assert {p: i.shape for p, i in n.outputs.items()} == {
            p: i.shape for p, i in r.outputs.items()}
        if r.op_type == "Const" and r.const.dtype == np.int64:
            np.testing.assert_array_equal(n.const, r.const)
    do = port.find_by_type("DetectionOutput")[0]
    assert do.attrs["_baked_batch"] == "3"
    assert do.outputs[do.out_port].shape == (3, 1, 100, 7)
    assert case.port_model.find_by_type("DetectionOutput")[0].attrs.get("_baked_batch") is None
