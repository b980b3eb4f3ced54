"""Slice 18's ops in the port against the JAX package: ReduceSum, Gelu (erf
and tanh), MVN (with and without ``across_channels`` and
``normalize_variance``), Tile and ConvolutionBackpropData (stride 2 with
2×2 and 3×3 kernels, asymmetric pads, ``output_padding``, dilation 2, an
int8 weight with its per-channel scale): the port's ``emit`` against the
JAX package's ``emit`` on the CPU and against its own numpy
``ref_compute``, float32 at rtol 1e-5, and the port's ``ref_compute`` equal
to the JAX package's bit for bit; shape inference and refusals; the rest of
``metrics`` (top-k, top-1 accuracy and agreement, ``coco_map``,
``detections_as_gt``) against the JAX package's; and the port's U-Net,
ViT-tiny and MoE-MLP IRs and replayed weights against the generators in
``tools/``, built into a private directory.

Inputs are made with numpy from a seed and handed to both packages."""

import numpy as np
import pytest
import torch

from pyopenvino_tpu.ops import get_op as jax_get_op
from pyopenvino_tpu.ops.spec import TValue as JaxTValue

from pyopenvino_tpu_torch import metrics
from pyopenvino_tpu_torch.ir import read_ir_model
from pyopenvino_tpu_torch.models import moe_mlp, unet, vit_tiny
from pyopenvino_tpu_torch.ops import get_op, supported_ops
from pyopenvino_tpu_torch.ops.spec import TValue
from test_torch_port_extended_ops import RTOL, _ctxs, _nodes, _rel_err
import test_torch_port_threads  # noqa: F401  (this worker's torch threads)

NEW_OPS = ("ReduceSum", "Gelu", "MVN", "Tile", "ConvolutionBackpropData")


def _port_tv(x, qscale=None):
    t = torch.from_numpy(x)
    if t.dim() == 4 and t.dtype != torch.int8:
        t = t.contiguous(memory_format=torch.channels_last)
    return TValue(t, qscale=None if qscale is None else torch.from_numpy(qscale))


def _jax_tv(x, qscale=None, weight=False):
    """A 4-D activation as the JAX package stores it (NHWC, "CL"); a weight
    or any other rank in its logical layout."""
    import jax.numpy as jnp

    q = None if qscale is None else jnp.asarray(qscale)
    if x.ndim == 4 and not weight:
        return JaxTValue(jnp.asarray(x.transpose(0, 2, 3, 1)), "CL", qscale=q)
    return JaxTValue(jnp.asarray(x), "L", qscale=q)


def _both(op_type, attrs, x, static=None, weight=None, qscale=None):
    """(port emit, JAX emit, port ref_compute, JAX ref_compute) as logical
    (NCHW) numpy arrays.  ``static``: input port 1's compile-time value;
    ``weight``: input port 1 as a weight (int8 codes with ``qscale``)."""
    node, jnode = _nodes(op_type, attrs)
    pctx, jctx = _ctxs(static)
    ins, jins = {0: _port_tv(x)}, {0: _jax_tv(x)}
    if weight is not None:
        ins[1] = _port_tv(weight, qscale)
        jins[1] = _jax_tv(weight, qscale, weight=True)
    got = get_op(op_type).emit(pctx, node, ins)[0]
    want = jax_get_op(op_type).emit(jctx, jnode, jins)[0]
    assert got.act_scale is None and got.arr.dtype == torch.float32
    ref_in = {0: x}
    if static is not None:
        ref_in[1] = static
    if weight is not None:  # the interpreter reads a dequantized weight
        ref_in[1] = weight if qscale is None else weight.astype(np.float32) * qscale
    ref = get_op(op_type).ref_compute(node, ref_in)[0]
    jref = jax_get_op(op_type).ref_compute(jnode, ref_in)[0]
    return got.arr.numpy(), np.asarray(want.nchw()), ref, jref, got.arr


def _check(got, want, ref, jref, shape=None):
    if shape is not None:
        assert got.shape == want.shape == ref.shape == shape
    np.testing.assert_array_equal(ref, jref)
    assert _rel_err(got, want) <= RTOL
    assert _rel_err(got, ref) <= RTOL


def test_slice_ops_are_registered():
    assert set(NEW_OPS) <= set(supported_ops())


# -- ReduceSum ------------------------------------------------------------

@pytest.mark.parametrize("keep", [True, False])
@pytest.mark.parametrize("shape,axes", [((8, 1, 64), (0,)), ((2, 8, 7, 5), (2, 3)),
                                        ((2, 8, 7, 5), (-1,)), ((3, 5, 6), (0, 2))])
def test_reduce_sum_matches_jax(shape, axes, keep):
    """MoE-MLP's gated combine is ReduceSum over axis 0 of (8, 1, 64)."""
    x = np.random.default_rng(len(shape) + len(axes)).standard_normal(shape).astype(np.float32)
    static = np.asarray(axes, np.int64)
    attrs = {"keep_dims": "true" if keep else "false"}
    got, want, ref, jref, _ = _both("ReduceSum", attrs, x, static=static)
    _check(got, want, ref, jref)
    node, jnode = _nodes("ReduceSum", attrs)
    res = get_op("ReduceSum").infer_shapes(node, {0: x.shape, 1: static.shape},
                                           {0: x, 1: static})
    jres = jax_get_op("ReduceSum").infer_shapes(jnode, {0: x.shape, 1: static.shape},
                                                {0: x, 1: static})
    assert res.shapes == jres.shapes == {0: got.shape}
    np.testing.assert_array_equal(res.values[0], jres.values[0])


def test_reduce_mean_and_sum_share_the_reduction():
    """One base: ReduceMean still gives torch.mean's bits, ReduceSum
    torch.sum's, and both refuse a non-constant or out-of-range axis."""
    x = np.random.default_rng(5).standard_normal((2, 8, 7, 5)).astype(np.float32)
    static = np.asarray((2, 3), np.int64)
    for op, fn in (("ReduceMean", torch.mean), ("ReduceSum", torch.sum)):
        got = _both(op, {"keep_dims": "true"}, x, static=static)[4]
        want = fn(torch.from_numpy(x).contiguous(memory_format=torch.channels_last),
                  dim=(2, 3), keepdim=True)
        assert torch.equal(got, want)
        node, _ = _nodes(op, {"keep_dims": "true"})
        with pytest.raises(ValueError, match="out of range"):
            get_op(op).infer_shapes(node, {0: (1, 4, 3, 3), 1: (1,)}, {1: np.asarray([4])})
        with pytest.raises(ValueError, match="not constant"):
            get_op(op).infer_shapes(node, {0: (1, 4, 3, 3), 1: (1,)}, {1: None})


# -- Gelu -----------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 64, 512), (2, 6, 5, 4), (8, 1, 128)])
@pytest.mark.parametrize("mode", [None, "erf", "tanh", "TANH"])
def test_gelu_matches_jax(mode, shape):
    """The erf form (the default, ViT-tiny's and MoE-MLP's) and the tanh
    form; inputs over the range where the two forms and the tails differ."""
    x = (np.random.default_rng(len(shape)).standard_normal(shape) * 4).astype(np.float32)
    attrs = {} if mode is None else {"approximation_mode": mode}
    got, want, ref, jref, _ = _both("Gelu", attrs, x)
    _check(got, want, ref, jref, shape)
    from scipy.special import erf

    x64 = x.astype(np.float64)
    exact = 0.5 * x64 * (1 + erf(x64 / np.sqrt(2)))
    if mode is None or mode == "erf":
        np.testing.assert_allclose(got, exact, rtol=1e-5, atol=1e-6)
    else:  # the tanh form is another function, within 1e-3 of the erf one here
        assert 1e-5 < np.abs(got - exact).max() < 1e-3


# -- MVN ------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 64, 128), (2, 6, 5, 4)])
@pytest.mark.parametrize("across,normalize,eps", [
    (False, True, 1e-6),   # ViT-tiny's LayerNorm (rank 3: the embedding axis)
    (True, True, 1e-9),
    (False, False, 1e-9),
    (True, False, 1e-9),
    (False, True, None),   # the attribute's default, 1e-9
])
def test_mvn_matches_jax(shape, across, normalize, eps):
    rng = np.random.default_rng(len(shape) + int(across) + 2 * int(normalize))
    x = (rng.standard_normal(shape) * 3 + 1.5).astype(np.float32)
    attrs = {"across_channels": "1" if across else "0",
             "normalize_variance": "true" if normalize else "false"}
    if eps is not None:
        attrs["eps"] = str(eps)
    got, want, ref, jref, _ = _both("MVN", attrs, x)
    _check(got, want, ref, jref, shape)
    axes = tuple(range(1 if across else 2, len(shape)))
    assert np.abs(got.mean(axis=axes)).max() < 1e-5
    if normalize:
        np.testing.assert_allclose(got.var(axis=axes), 1.0, rtol=1e-3)


# -- Tile -----------------------------------------------------------------

@pytest.mark.parametrize("shape,reps", [
    ((1, 1, 64), (8, 1, 1)),        # MoE-MLP's token to each expert
    ((2, 3, 4), (2, 3)),            # fewer repeats than the rank: left-padded
    ((3, 4), (2, 1, 2)),            # more repeats than the rank: the data left-padded
    ((1, 2, 3, 2), (1, 2, 1, 3)),
])
def test_tile_matches_jax(shape, reps):
    x = np.random.default_rng(len(reps)).standard_normal(shape).astype(np.float32)
    static = np.asarray(reps, np.int64)
    got, want, ref, jref, _ = _both("Tile", {}, x, static=static)
    assert got.shape == np.tile(x, reps).shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jref)
    np.testing.assert_array_equal(ref, jref)
    node, jnode = _nodes("Tile", {})
    res = get_op("Tile").infer_shapes(node, {0: shape, 1: static.shape}, {0: x, 1: static})
    jres = jax_get_op("Tile").infer_shapes(jnode, {0: shape, 1: static.shape},
                                           {0: x, 1: static})
    assert res.shapes == jres.shapes == {0: got.shape}
    np.testing.assert_array_equal(res.values[0], jres.values[0])


def test_tile_refusals():
    node, _ = _nodes("Tile", {})
    with pytest.raises(ValueError, match=">= 1"):
        get_op("Tile").infer_shapes(node, {0: (2, 3), 1: (2,)}, {1: np.asarray([0, 2])})
    with pytest.raises(ValueError, match="not constant"):
        get_op("Tile").infer_shapes(node, {0: (2, 3), 1: (2,)}, {1: None})


# -- ConvolutionBackpropData -----------------------------------------------

def _deconv_attrs(strides=(2, 2), dilations=(1, 1), pb=(0, 0), pe=(0, 0), opad=(0, 0)):
    return {"strides": f"{strides[0]},{strides[1]}",
            "dilations": f"{dilations[0]},{dilations[1]}",
            "pads_begin": f"{pb[0]},{pb[1]}", "pads_end": f"{pe[0]},{pe[1]}",
            "output_padding": f"{opad[0]},{opad[1]}", "auto_pad": "explicit"}


DECONV_CASES = {
    "unet_2x2_s2": ((1, 32, 8, 8), (32, 16, 2, 2), _deconv_attrs()),
    "3x3_s2": ((2, 6, 5, 7), (6, 4, 3, 3), _deconv_attrs()),
    "3x3_s2_pads": ((2, 6, 5, 7), (6, 4, 3, 3), _deconv_attrs(pb=(1, 0), pe=(0, 2))),
    "3x3_s2_output_padding": ((1, 5, 4, 6), (5, 3, 3, 3),
                              _deconv_attrs(pb=(1, 1), pe=(1, 1), opad=(1, 1))),
    "output_padding_past_the_canvas": ((1, 5, 4, 6), (5, 3, 3, 3),
                                       _deconv_attrs(pb=(1, 0), pe=(0, 0), opad=(1, 1))),
    "dilation_2": ((1, 4, 6, 5), (4, 6, 3, 3),
                   _deconv_attrs(strides=(1, 2), dilations=(2, 2), pb=(2, 1), pe=(1, 2))),
    "4x4_s2_s3": ((2, 3, 5, 4), (3, 2, 4, 4), _deconv_attrs(strides=(2, 3), pb=(1, 2))),
}


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("name", list(DECONV_CASES))
def test_conv_backprop_data_matches_jax(name, int8):
    """The output's shape from the attributes, the JAX emit (a dilated
    forward conv, NHWC) and both numpy scatters; with an int8 weight
    (passes/quantize.py's per-Co codes and (1, Co, 1, 1) scale) the emit
    dequantizes it and the interpreter reads the dequantized weight."""
    x_shape, w_shape, attrs = DECONV_CASES[name]
    rng = np.random.default_rng(len(name))
    x = rng.standard_normal(x_shape).astype(np.float32)
    w = rng.standard_normal(w_shape).astype(np.float32)
    qscale = None
    if int8:
        from pyopenvino_tpu.passes.quantize import _quantize_array as jax_quantize
        from pyopenvino_tpu_torch.passes.quantize import _quantize_array

        codes, scales = jax_quantize(w, (1,))
        w, qscale = _quantize_array(w, (1,))
        np.testing.assert_array_equal(w, codes)
        np.testing.assert_array_equal(qscale, scales)
        assert qscale.shape == (1, w_shape[1], 1, 1) and w.dtype == np.int8
    got, want, ref, jref, arr = _both("ConvolutionBackpropData", attrs, x, weight=w,
                                      qscale=qscale)
    node, jnode = _nodes("ConvolutionBackpropData", attrs)
    shapes = {0: x_shape, 1: w_shape}
    res = get_op("ConvolutionBackpropData").infer_shapes(node, shapes, {})
    assert res.shapes == jax_get_op("ConvolutionBackpropData").infer_shapes(
        jnode, shapes, {}).shapes == {0: got.shape}
    _check(got, want, ref, jref)
    assert arr.is_contiguous(memory_format=torch.channels_last)


def test_conv_backprop_data_is_torch_conv_transpose():
    """Symmetric pads and output_padding are F.conv_transpose2d's own."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6, 5, 7)).astype(np.float32)
    w = rng.standard_normal((6, 4, 3, 3)).astype(np.float32)
    attrs = _deconv_attrs(pb=(1, 1), pe=(1, 1), opad=(1, 1))
    got = _both("ConvolutionBackpropData", attrs, x, weight=w)[0]
    want = torch.nn.functional.conv_transpose2d(
        torch.from_numpy(x), torch.from_numpy(w), stride=2, padding=1, output_padding=1)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-5)


def test_conv_backprop_data_output_shape_input_and_refusals():
    """The constant output_shape (input 2) must equal the attribute-derived
    size; a weight whose Ci is not the input's, or pads past the kernel
    span, are refused."""
    node, _ = _nodes("ConvolutionBackpropData", _deconv_attrs())
    op = get_op("ConvolutionBackpropData")
    shapes = {0: (1, 4, 8, 8), 1: (4, 2, 2, 2), 2: (2,)}
    assert op.infer_shapes(node, shapes, {2: np.asarray([16, 16])}).shapes == {
        0: (1, 2, 16, 16)}
    with pytest.raises(ValueError, match="inconsistent"):
        op.infer_shapes(node, shapes, {2: np.asarray([17, 16])})
    with pytest.raises(ValueError, match="must be constant"):
        op.infer_shapes(node, shapes, {})
    with pytest.raises(ValueError, match="weight Ci"):
        op.infer_shapes(node, {0: (1, 3, 8, 8), 1: (4, 2, 2, 2)}, {})
    big, _ = _nodes("ConvolutionBackpropData", _deconv_attrs(pb=(9, 0), pe=(9, 0)))
    with pytest.raises(ValueError, match="non-positive"):
        op.infer_shapes(big, {0: (1, 4, 2, 2), 1: (4, 2, 2, 2)}, {})


# -- metrics ----------------------------------------------------------------

def test_classification_metrics_match_jax():
    from pyopenvino_tpu import metrics as jax_metrics

    rng = np.random.default_rng(0)
    ref, test = rng.standard_normal((50, 10)), rng.standard_normal((50, 10))
    test[:30] = ref[:30]
    labels = rng.integers(0, 10, 50)
    for k in (1, 3):
        np.testing.assert_array_equal(metrics.topk_labels(ref, k),
                                      jax_metrics.topk_labels(ref, k))
    assert metrics.top1_accuracy(ref, labels) == jax_metrics.top1_accuracy(ref, labels)
    assert metrics.top1_agreement(ref, test) == jax_metrics.top1_agreement(ref, test)
    assert 0.6 <= metrics.top1_agreement(ref, test) < 1.0
    logits = np.array([[0.1, 0.9, 0.0], [0.5, 0.2, 0.3]])
    assert metrics.topk_labels(logits, 2).tolist() == [[1, 0], [0, 2]]
    assert metrics.top1_accuracy(logits, [1, 2]) == 0.5


def test_detection_metrics_match_jax():
    """coco_map over COCO's grid and detections_as_gt on seeded boxes,
    jittered detections with false positives, a class without ground truth
    and an image without detections."""
    from pyopenvino_tpu import metrics as jax_metrics

    rng = np.random.default_rng(1)
    gt, det = {}, {}
    for img in range(12):
        boxes = []
        for _ in range(rng.integers(1, 4)):
            x0, y0 = rng.uniform(0, 0.6, 2)
            boxes.append((int(rng.integers(1, 4)), (x0, y0, x0 + rng.uniform(0.1, 0.4),
                                                    y0 + rng.uniform(0.1, 0.4))))
        gt[img] = boxes
        det[img] = [(c, float(rng.uniform(0.3, 1.0)),
                     tuple(float(v + rng.normal(0, 0.02)) for v in b)) for c, b in boxes]
        det[img].append((int(rng.integers(1, 5)), float(rng.uniform(0, 1)), (0.1, 0.1, 0.3, 0.3)))
    det[11] = []
    assert metrics.COCO_IOU_THRESHOLDS == jax_metrics.COCO_IOU_THRESHOLDS
    got = metrics.coco_map(gt, det)
    assert got == jax_metrics.coco_map(gt, det)
    assert 20 < got < 100
    assert metrics.coco_map(gt, det, (0.5,)) == jax_metrics.coco_map(gt, det, (0.5,))
    assert metrics.detections_as_gt(det) == jax_metrics.detections_as_gt(det)
    assert metrics.coco_map(metrics.detections_as_gt(det), det) == pytest.approx(100.0)
    assert np.isnan(metrics.coco_map({}, det)) and np.isnan(jax_metrics.coco_map({}, det))


# -- the slice's IRs ----------------------------------------------------------

GENERATORS = {
    # port module, its paths(), generator module, builder, .bin bytes
    "unet": (unet, unet.unet_paths, "gen_unet", "build_unet", 1928608),
    "vit_tiny": (vit_tiny, vit_tiny.vit_tiny_paths, "gen_vit", "build_vit", 3359056),
    "moe_mlp": (moe_mlp, moe_mlp.moe_mlp_paths, "gen_moe", "build_moe", 1156944),
}


@pytest.mark.parametrize("name", list(GENERATORS))
def test_ir_and_weights_are_the_generators(name, tmp_path):
    """The shipped XML is the one tools/gen_*.py writes, and the replayed
    .bin is its .bin byte for byte (another seed: other weights, the same
    layout)."""
    import importlib

    from pyopenvino_tpu.ir.writer import write_ir_model

    module, paths, gen, builder, size = GENERATORS[name]
    xml = str(tmp_path / f"{name}.xml")
    write_ir_model(getattr(importlib.import_module(f"tools.{gen}"), builder)(), xml)
    xml_path, bin_path = paths()
    with open(xml, "rb") as f, open(xml_path, "rb") as g:
        assert f.read() == g.read()
    with open(xml[:-4] + ".bin", "rb") as f, open(bin_path, "rb") as g:
        want = f.read()
        assert g.read() == want and len(want) == size
    with open(xml_path, encoding="utf-8") as f:
        other = module.generate_weights(f.read(), seed=1)
    assert len(other) == size and other != want


TOPOLOGY = {
    "unet": {"Convolution": 15, "ConvolutionBackpropData": 3, "Concat": 3, "MaxPool": 3,
             "SoftMax": 1},
    "vit_tiny": {"MatMul": 33, "MVN": 9, "Gelu": 4, "Convolution": 1, "SoftMax": 5,
                 "ReduceMean": 1},
    "moe_mlp": {"MatMul": 7, "Tile": 2, "ReduceSum": 2, "Gelu": 2, "SoftMax": 3,
                "Convolution": 2},
}


@pytest.mark.parametrize("name", list(GENERATORS))
def test_topology(name):
    model = read_ir_model(*GENERATORS[name][1]())
    assert {t: len(model.find_by_type(t)) for t in TOPOLOGY[name]} == TOPOLOGY[name]
    assert {n.op_type for n in model} <= set(supported_ops())
