"""Slice 19's YOLO ops in the port against the JAX package: PReLU (a rank-0
slope, as yolo-tiny's, and a per-channel one), RegionYolo (YOLO v2: class
softmax and the [axis, end_axis] flatten; v3: logistic classes and
``mask``) and ReorgYolo (darknet's backward-run reorg), and
``metrics.decode_region_yolo``:

  * the port's ``emit`` against the JAX package's ``emit`` on the CPU and
    against its own numpy ``ref_compute``, float32 at rtol 1e-5 (ReorgYolo,
    a permutation, exactly), and the port's ``ref_compute`` equal to the
    JAX package's bit for bit; bfloat16 ``emit`` equal to the JAX
    package's;
  * the stride-1 2×2 MaxPool with pads (0, 1) on float32, bfloat16 and
    int8 codes against the JAX package's emit, exactly;
  * tests/test_yolo.py's op checks: the v2 and v3 semantics against the
    formulas, the channel-count refusal, the reorg's parity at yolo-v2's
    (64, 26, 26) and two other shapes, that it is not a SpaceToDepth, the
    refusal of a shape the stride does not divide, and the decode's
    geometry on one hot cell;
  * ``decode_region_yolo`` equal to the JAX package's on region blobs with
    many candidates and overlapping boxes.

Inputs are made with numpy from a seed and handed to both packages."""

import numpy as np
import pytest
import torch

from pyopenvino_tpu.metrics import decode_region_yolo as jax_decode
from pyopenvino_tpu.ops import get_op as jax_get_op
from pyopenvino_tpu.ops.spec import TValue as JaxTValue

import pyopenvino_tpu.ir.model as jax_ir
import pyopenvino_tpu_torch.ir.model as port_ir
from pyopenvino_tpu_torch import metrics
from pyopenvino_tpu_torch.ops import get_op, supported_ops
from pyopenvino_tpu_torch.ops.spec import TValue
from pyopenvino_tpu_torch.ops.yolo import region_yolo_ref
from test_torch_port_extended_ops import RTOL, _ctxs, _rel_err
import test_torch_port_threads  # noqa: F401  (this worker's torch threads)

NEW_OPS = ("PReLU", "RegionYolo", "ReorgYolo")


def _sig(v):
    return 1.0 / (1.0 + np.exp(-v))


def _nodes(op_type, attrs):
    kw = dict(id=0, name="n", op_type=op_type, attrs=attrs, inputs={}, outputs={1: None})
    return port_ir.Node(**kw), jax_ir.Node(**kw)


def _port_tv(x, dtype=torch.float32):
    t = torch.from_numpy(x).to(dtype)
    if t.dim() == 4:
        t = t.contiguous(memory_format=torch.channels_last)
    return TValue(t)


def _jax_tv(x, dtype=None):
    """A 4-D activation as the JAX package stores it (NHWC, "CL")."""
    import jax.numpy as jnp

    arr = jnp.asarray(x, dtype or jnp.float32)
    if x.ndim == 4:
        return JaxTValue(arr.transpose(0, 2, 3, 1), "CL")
    return JaxTValue(arr, "L")


def _both(op_type, attrs, ins, bf16=False):
    """(port emit, JAX emit, port ref_compute, JAX ref_compute) as logical
    numpy arrays (float32) for {port: ndarray} inputs."""
    import jax.numpy as jnp

    node, jnode = _nodes(op_type, attrs)
    pctx, jctx = _ctxs()
    dtype, jdtype = (torch.bfloat16, jnp.bfloat16) if bf16 else (torch.float32, jnp.float32)
    got = get_op(op_type).emit(pctx, node, {p: _port_tv(v, dtype) for p, v in ins.items()})[1]
    want = jax_get_op(op_type).emit(jctx, jnode, {p: _jax_tv(v, jdtype)
                                                  for p, v in ins.items()})[1]
    assert got.act_scale is None and got.arr.dtype == dtype
    ref = get_op(op_type).ref_compute(node, ins)[1]
    jref = jax_get_op(op_type).ref_compute(jnode, ins)[1]
    return (got.arr.float().numpy(), np.asarray(want.nchw().astype(jnp.float32)), ref, jref)


def _check(got, want, ref, jref, exact=False):
    assert got.shape == want.shape == ref.shape
    np.testing.assert_array_equal(ref, jref)
    if exact:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, ref)
    else:
        assert _rel_err(got, want) <= RTOL
        assert _rel_err(got, ref) <= RTOL


def test_slice_ops_are_registered():
    assert set(NEW_OPS) <= set(supported_ops())


# -- PReLU ----------------------------------------------------------------

@pytest.mark.parametrize("slope", ["scalar", "channel"])
def test_prelu_matches_jax(slope):
    """yolo-tiny's slope is a rank-0 Const of 0.1 (the parsers give it
    shape (1,)); a per-channel slope broadcasts as (C, 1, 1)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 6, 5, 4)).astype(np.float32)
    s = (np.asarray([0.1], np.float32) if slope == "scalar"
         else rng.uniform(0, 0.5, (6, 1, 1)).astype(np.float32))
    got, want, ref, jref = _both("PReLU", {}, {0: x, 1: s})
    _check(got, want, ref, jref)
    np.testing.assert_array_equal(ref, np.where(x > 0, x, s * x))
    node, jnode = _nodes("PReLU", {})
    res = get_op("PReLU").infer_shapes(node, {0: x.shape, 1: ()}, {})
    assert res.shapes == jax_get_op("PReLU").infer_shapes(jnode, {0: x.shape, 1: ()}, {}).shapes
    assert res.shapes == {1: x.shape}
    bf = _both("PReLU", {}, {0: x, 1: s}, bf16=True)
    np.testing.assert_array_equal(bf[0], bf[1])


# -- yolo-v2-tiny's stride-1 "same" MaxPool ----------------------------------

@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
def test_stride1_maxpool_end_pad_matches_jax(storage):
    """The 2×2 stride-1 MaxPool with pads (0, 1) of yolo-tiny's sixth block:
    the end row and column are padded with −inf, so the last output row and
    column pool the input's edge alone.  Float32, bfloat16 and int8 codes
    (under INT8-FULL the pool carries its input's codes at their scale)
    against the JAX package's emit, exactly."""
    import jax.numpy as jnp

    attrs = {"kernel": "2,2", "strides": "1,1", "pads_begin": "0,0", "pads_end": "1,1",
             "rounding_type": "floor", "auto_pad": "explicit"}
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 8, 5, 5)).astype(np.float32) - 1.0  # mostly negative
    node, jnode = _nodes("MaxPool", attrs)
    pctx, jctx = _ctxs()
    if storage == "int8":
        codes = rng.integers(-127, 128, x.shape).astype(np.int8)
        pin = TValue(torch.from_numpy(codes).contiguous(memory_format=torch.channels_last),
                     act_scale=0.05)
        jin = JaxTValue(jnp.asarray(codes.transpose(0, 2, 3, 1)), "CL", act_scale=0.05)
        x = codes.astype(np.float32)
    else:
        dtype = getattr(torch, storage)
        pin, jin = _port_tv(x, dtype), _jax_tv(x, getattr(jnp, storage))
        x = pin.arr.float().numpy()
    got = get_op("MaxPool").emit(pctx, node, {0: pin})[1]
    want = jax_get_op("MaxPool").emit(jctx, jnode, {0: jin})[1]
    assert got.act_scale == want.act_scale == (0.05 if storage == "int8" else None)
    assert got.arr.dtype == pin.arr.dtype and got.shape == (2, 8, 5, 5)
    got = got.arr.float().numpy()
    np.testing.assert_array_equal(got, np.asarray(want.nchw().astype(jnp.float32)))
    np.testing.assert_array_equal(got[:, :, -1, -1], x[:, :, -1, -1])
    np.testing.assert_array_equal(got[:, :, -1, :-1], np.maximum(x[:, :, -1, :-1],
                                                                 x[:, :, -1, 1:]))
    np.testing.assert_array_equal(got, get_op("MaxPool").ref_compute(node, {0: x})[1])


# -- RegionYolo -------------------------------------------------------------

def _region_attrs(classes, num, coords=4, do_softmax=True, mask=None):
    attrs = {"coords": str(coords), "classes": str(classes), "num": str(num),
             "do_softmax": "1" if do_softmax else "0", "axis": "1", "end_axis": "3",
             "anchors": ",".join(["1.0"] * (2 * num))}
    if mask is not None:
        attrs["mask"] = ",".join(str(m) for m in mask)
    return attrs


def test_region_yolo_v2_semantics():
    """do_softmax (YOLO v2): logistic on x, y and the objectness, a class
    softmax per anchor, w and h raw, the output flattened over [axis,
    end_axis]."""
    na, classes, coords, h, w = 2, 3, 4, 2, 2
    block = coords + 1 + classes
    x = np.random.default_rng(0).standard_normal((1, na * block, h, w)).astype(np.float32)
    got, want, ref, jref = _both("RegionYolo", _region_attrs(classes, na), {0: x})
    _check(got, want, ref, jref)
    assert got.shape == (1, na * block * h * w)
    t, xb = got.reshape(na, block, h, w), x.reshape(na, block, h, w)
    for ch in (0, 1, coords):
        np.testing.assert_allclose(t[:, ch], _sig(xb[:, ch]), rtol=1e-5)
    np.testing.assert_allclose(t[:, 2:coords], xb[:, 2:coords], rtol=1e-6)
    np.testing.assert_allclose(t[:, coords + 1:].sum(axis=1), np.ones((na, h, w)), rtol=1e-5)


def test_region_yolo_v3_semantics():
    """do_softmax = 0 (YOLO v3): ``mask`` gives the anchor count, the
    classes take the logistic, the NCHW shape is kept."""
    mask, classes, coords, h, w = (3, 4, 5), 2, 4, 3, 3
    na, block = len(mask), coords + 1 + classes
    x = np.random.default_rng(1).standard_normal((2, na * block, h, w)).astype(np.float32)
    got, want, ref, jref = _both("RegionYolo", _region_attrs(classes, 9, coords, False, mask),
                                 {0: x})
    _check(got, want, ref, jref)
    assert got.shape == x.shape
    np.testing.assert_allclose(got.reshape(2, na, block, h, w)[:, :, coords + 1:],
                               _sig(x.reshape(2, na, block, h, w)[:, :, coords + 1:]), rtol=1e-5)


@pytest.mark.parametrize("do_softmax", [True, False])
def test_region_yolo_bf16_matches_jax(do_softmax):
    """bfloat16: the logistic's and the softmax's steps each rounded to
    bfloat16, as XLA's bfloat16 lowering on the CPU rounds them: equal."""
    x = (np.random.default_rng(2).standard_normal((1, 45, 5, 5)) * 3).astype(np.float32)
    got, want, _, _ = _both("RegionYolo", _region_attrs(4, 5, do_softmax=do_softmax), {0: x},
                            bf16=True)
    np.testing.assert_array_equal(got, want)


def test_region_yolo_channel_mismatch_fails_fast():
    node, jnode = _nodes("RegionYolo", _region_attrs(3, 2))
    for op, n in ((get_op("RegionYolo"), node), (jax_get_op("RegionYolo"), jnode)):
        with pytest.raises(ValueError, match="C=10"):
            op.infer_shapes(n, {0: (1, 10, 2, 2)}, {})


# -- ReorgYolo --------------------------------------------------------------

@pytest.mark.parametrize("c,h,w,s", [(4, 4, 6, 2), (64, 26, 26, 2), (18, 9, 9, 3)])
def test_reorg_yolo_parity(c, h, w, s):
    """The per-channel index loop (``ref_compute``) and the vectorized
    ``emit`` agree exactly, in both packages, including yolo-v2's canonical
    (64, 26, 26) stride-2 case."""
    x = np.random.default_rng(c).standard_normal((2, c, h, w)).astype(np.float32)
    got, want, ref, jref = _both("ReorgYolo", {"stride": str(s)}, {0: x})
    assert got.shape == (2, c * s * s, h // s, w // s)
    _check(got, want, ref, jref, exact=True)


def test_reorg_yolo_is_not_space_to_depth():
    """The classic wrong implementation: darknet's reorg differs from a
    SpaceToDepth (blocks first) in the channel order."""
    x = np.arange(64, dtype=np.float32).reshape(1, 4, 4, 4)
    node, _ = _nodes("ReorgYolo", {"stride": "2"})
    reorg = get_op("ReorgYolo").ref_compute(node, {0: x})[1]
    s2d = x.reshape(1, 4, 2, 2, 2, 2).transpose(0, 3, 5, 1, 2, 4).reshape(1, 16, 2, 2)
    assert reorg.shape == s2d.shape and not np.array_equal(reorg, s2d)


def test_reorg_yolo_bad_shape_refused():
    node, jnode = _nodes("ReorgYolo", {"stride": "2"})
    for op, n in ((get_op("ReorgYolo"), node), (jax_get_op("ReorgYolo"), jnode)):
        with pytest.raises(ValueError, match="divisible"):
            op.infer_shapes(n, {0: (1, 6, 4, 4)}, {})
    node.attrs["stride"] = "0"
    with pytest.raises(ValueError, match="bad stride"):
        get_op("ReorgYolo").infer_shapes(node, {0: (1, 4, 4, 4)}, {})


# -- decode_region_yolo -------------------------------------------------------

def test_decode_region_yolo_geometry():
    """One hot cell with known offsets gives the box worked out by hand."""
    na, classes, coords, h, w = 1, 2, 4, 4, 4
    t = np.zeros((na, coords + 1 + classes, h, w), np.float32)
    t[0, 0, 1, 2] = 0.5          # bx = (0.5 + 2) / 4
    t[0, 1, 1, 2] = 0.25         # by = (0.25 + 1) / 4
    t[0, 2, 1, 2] = np.log(2.0)  # bw = 2·aw / w
    t[0, 3, 1, 2] = 0.0          # bh = ah / h
    t[0, 4, 1, 2] = 0.9          # objectness
    t[0, 5, 1, 2] = 0.8          # class 0
    t[0, 6, 1, 2] = 0.2
    dets = metrics.decode_region_yolo(t.reshape(1, -1), (h, w), [(1.0, 1.5)], classes,
                                      conf_threshold=0.3)
    assert dets == jax_decode(t.reshape(1, -1), (h, w), [(1.0, 1.5)], classes,
                              conf_threshold=0.3)
    assert len(dets) == 1
    cls, conf, box = dets[0]
    assert cls == 0 and abs(conf - 0.9 * 0.8) < 1e-6
    cx, cy, bw, bh = (0.5 + 2) / 4, (0.25 + 1) / 4, 2.0 / 4, 1.5 / 4
    np.testing.assert_allclose(box, (cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2),
                               rtol=1e-6)


@pytest.mark.parametrize("seed", range(4))
def test_decode_region_yolo_matches_jax(seed):
    """Random region blobs of yolo-tiny's layout (5 anchors, 4 classes, a
    5×5 grid) with dense candidates, so the per-class NMS suppresses:
    the same detections, in the same order, as the JAX package's."""
    rng = np.random.default_rng(seed)
    raw = rng.normal(0, 1.5, (1, 45, 5, 5)).astype(np.float32)
    p = dict(coords=4, classes=4, num=5, do_softmax=True, mask=(), axis=1, end_axis=3)
    blob = region_yolo_ref(raw, p)
    anchors = [(0.6, 0.8), (1.2, 1.2), (2.0, 1.5), (1.5, 2.4), (3.2, 3.0)]
    for thr in (0.05, 0.3):
        got = metrics.decode_region_yolo(blob, (5, 5), anchors, 4, conf_threshold=thr)
        assert got == jax_decode(blob, (5, 5), anchors, 4, conf_threshold=thr)
    dense = metrics.decode_region_yolo(blob, (5, 5), anchors, 4, conf_threshold=0.05)
    total = int((blob.reshape(5, 9, 5, 5)[:, 4:5] * blob.reshape(5, 9, 5, 5)[:, 5:] > 0.05).sum())
    assert 0 < len(dense) < total  # the NMS removed some
