"""NonMaxSuppression (ops/nms.py), Exp, Maximum and GreaterEqual
(ops/extended.py) and the Sigmoid op in bfloat16 on the port against the
JAX package:

  * NonMaxSuppression's ``emit`` on CPU tensors against the JAX op's
    ``emit`` (XLA on the CPU) and both ``ref_compute``s (equal to each other
    bit for bit): the same rows in the same order and the same
    valid_outputs, scores equal (Soft-NMS: within rtol 1e-6, the two
    libraries' exp), on seeded boxes with score ties inside and across
    classes, IoUs exactly at the threshold (on either side of it), Soft-NMS,
    both ``sort_result_descending`` modes, ``max_output_boxes_per_class``
    (0 = every box) and ``score_threshold``, the -1 pad rows, center
    encoding and flipped corners, and both ``output_type``s;
  * Exp, Maximum and GreaterEqual against the JAX ops' ``emit`` and
    ``ref_compute`` with broadcasting and their dtypes (integer and float
    Maximum, a boolean GreaterEqual);
  * the Sigmoid op's bfloat16 ``emit`` equal to ``jax.nn.sigmoid`` bit for
    bit over every bfloat16 input whose result is a normal number (below
    -87.25 XLA's CPU flushes the subnormal result to zero, ROADMAP.md §3
    fault 8)."""

import types

import numpy as np
import pytest
import torch

import pyopenvino_tpu.ir.model as jax_ir
from pyopenvino_tpu.ops import get_op as jax_get_op
from pyopenvino_tpu.ops.spec import TValue as JaxTValue

import pyopenvino_tpu_torch.ir.model as port_ir
from pyopenvino_tpu_torch.ops import get_op
from pyopenvino_tpu_torch.ops.nms import greedy_nms_sweep
from pyopenvino_tpu_torch.ops.spec import TValue
import test_torch_port_threads  # noqa: F401  (this worker's torch threads)


def _nms_nodes(attrs, statics):
    n_in = 2 + len(statics)
    info = port_ir.TensorInfo((), np.dtype(np.float32))
    kw = dict(id=0, name="nms", op_type="NonMaxSuppression", attrs=attrs,
              inputs={p: info for p in range(n_in)},
              outputs={n_in + i: info for i in range(3)})
    return port_ir.Node(**kw), jax_ir.Node(**kw)


def nms_both(boxes, scores, max_boxes=0, iou=0.5, score=0.0, sigma=None, sort=True,
             encoding="corner", output_type="i64"):
    """(port emit, JAX emit, port ref_compute, JAX ref_compute), each the
    three outputs as numpy arrays."""
    import jax.numpy as jnp

    statics = {2: np.asarray(max_boxes, np.int64), 3: np.asarray(iou, np.float32),
               4: np.asarray(score, np.float32)}
    if sigma is not None:
        statics[5] = np.asarray(sigma, np.float32)
    attrs = {"box_encoding": encoding, "sort_result_descending": "1" if sort else "0",
             "output_type": output_type}
    node, jnode = _nms_nodes(attrs, statics)
    static_value = lambda node, port: statics[port]  # noqa: E731
    pctx = types.SimpleNamespace(static_value=static_value, compute_dtype=torch.float32)
    jctx = types.SimpleNamespace(static_value=static_value, compute_dtype=jnp.float32)
    ports = sorted(node.outputs)
    got = get_op("NonMaxSuppression").emit(
        pctx, node, {0: TValue(torch.from_numpy(boxes)), 1: TValue(torch.from_numpy(scores))})
    want = jax_get_op("NonMaxSuppression").emit(
        jctx, jnode, {0: JaxTValue(jnp.asarray(boxes), "L"),
                      1: JaxTValue(jnp.asarray(scores), "L")})
    ref_in = {0: boxes, 1: scores, **statics}
    ref = get_op("NonMaxSuppression").ref_compute(node, ref_in)
    jref = jax_get_op("NonMaxSuppression").ref_compute(jnode, ref_in)
    return ([got[p].arr.numpy() for p in ports], [np.asarray(want[p].nchw()) for p in ports],
            [ref[p] for p in ports], [jref[p] for p in ports])


def check_nms(boxes, scores, score_rtol=0.0, **kw):
    got, want, ref, jref = nms_both(boxes, scores, **kw)
    idx_dt = np.int32 if kw.get("output_type") == "i32" else np.int64
    for r, j in zip(ref, jref):
        np.testing.assert_array_equal(r, j)
    assert got[0].dtype == idx_dt and got[2].dtype == idx_dt and got[1].dtype == np.float32
    n, classes, num = scores.shape
    per_class = num if kw.get("max_boxes", 0) <= 0 else min(kw["max_boxes"], num)
    assert got[0].shape == got[1].shape == (n * classes * per_class, 3)
    for other in (want, ref):
        np.testing.assert_array_equal(got[0], other[0])
        np.testing.assert_array_equal(got[2], other[2])
        np.testing.assert_array_equal(got[1][:, :2], other[1][:, :2])
        np.testing.assert_allclose(got[1][:, 2], other[1][:, 2], rtol=score_rtol, atol=0)
    valid = int(got[2][0])
    assert (got[0][valid:] == -1).all() and (got[1][valid:] == -1).all()
    assert (got[0][:valid] >= 0).all()
    return got


def random_boxes(rng, n, num, grid=None):
    """(n, num, 4) corner boxes (y1, x1, y2, x2); on an integer grid of
    ``grid`` cells where given, so that IoUs are exact small fractions."""
    if grid is None:
        y, x = rng.uniform(0, 1, (2, n, num))
        h, w = rng.uniform(0.05, 0.4, (2, n, num))
    else:
        y, x = rng.integers(0, grid, (2, n, num))
        h, w = rng.integers(1, 4, (2, n, num))
    return np.stack([y, x, y + h, x + w], -1).astype(np.float32)


@pytest.mark.parametrize("sort", [True, False], ids=["sorted", "grouped"])
@pytest.mark.parametrize("max_boxes,score", [(0, 0.0), (5, 0.2), (1, 0.0), (100, 0.5)],
                         ids=["all", "five", "one", "more_than_boxes"])
def test_nms_matches_jax(sort, max_boxes, score):
    rng = np.random.default_rng(max_boxes)
    boxes = random_boxes(rng, 2, 40)
    scores = rng.uniform(0, 1, (2, 3, 40)).astype(np.float32)
    got = check_nms(boxes, scores, max_boxes=max_boxes, score=score, iou=0.4, sort=sort)
    valid = int(got[2][0])
    assert 0 < valid <= len(got[0])
    kept = got[1][:valid, 2]
    assert (kept > score).all()
    if sort:
        assert (np.diff(kept) <= 0).all()


@pytest.mark.parametrize("sort", [True, False], ids=["sorted", "grouped"])
def test_nms_score_ties_keep_batch_class_box_order(sort):
    """Scores from four levels tie inside every class and across classes
    and images: a tie keeps (batch, class, box) order, as the JAX
    package's stable sorts do."""
    rng = np.random.default_rng(11)
    boxes = random_boxes(rng, 2, 30)
    scores = (rng.integers(1, 5, (2, 3, 30)) / 4).astype(np.float32)
    got = check_nms(boxes, scores, max_boxes=6, iou=0.3, sort=sort)
    valid = int(got[2][0])
    rows = [tuple(r) for r in got[0][:valid]]
    if sort:
        keyed = [(-s, *r) for s, r in zip(got[1][:valid, 2], rows)]
        assert keyed == sorted(keyed)
    else:
        assert [r[:2] for r in rows] == sorted(r[:2] for r in rows)


@pytest.mark.parametrize("iou", [0.5, 0.4999999, 1 / 3], ids=["half", "below_half", "third"])
def test_nms_iou_at_the_threshold(iou):
    """Boxes on an integer grid give IoUs of exactly 1/2 and 1/3: a box at
    the threshold is kept (the spec suppresses above it), one a float32
    step below it is suppressed, in the port and the JAX package alike."""
    pair = np.asarray([[0, 0, 2, 3], [0, 1, 2, 4], [0, 2, 2, 5], [5, 5, 7, 7]], np.float32)
    assert get_iou(pair[0], pair[1]) == 0.5 == get_iou(pair[1], pair[2])
    scores = np.asarray([[[0.9, 0.8, 0.7, 0.6]]], np.float32)
    got = check_nms(pair[None], scores, iou=iou)
    kept = sorted(got[0][:int(got[2][0]), 2].tolist())
    assert kept == ([0, 2, 3] if iou < 0.5 else [0, 1, 2, 3])
    rng = np.random.default_rng(3)
    grid = random_boxes(rng, 2, 60, grid=6)
    check_nms(grid, rng.uniform(0, 1, (2, 2, 60)).astype(np.float32), iou=iou)


def get_iou(a, b):
    inter = max(0, min(a[2], b[2]) - max(a[0], b[0])) * max(0, min(a[3], b[3]) - max(a[1], b[1]))
    area = lambda r: (r[2] - r[0]) * (r[3] - r[1])  # noqa: E731
    return inter / (area(a) + area(b) - inter)


@pytest.mark.parametrize("sort", [True, False], ids=["sorted", "grouped"])
@pytest.mark.parametrize("max_boxes", [0, 4], ids=["all", "four"])
def test_soft_nms_matches_jax(sort, max_boxes):
    """Soft-NMS (sigma 0.5): the same picks in the same order; the decayed
    scores within rtol 1e-6 (XLA's float32 exp against PyTorch's)."""
    rng = np.random.default_rng(5)
    boxes = random_boxes(rng, 2, 24)
    scores = rng.uniform(0, 1, (2, 2, 24)).astype(np.float32)
    got = check_nms(boxes, scores, score_rtol=1e-6, max_boxes=max_boxes, iou=0.6, score=0.3,
                    sigma=0.5, sort=sort)
    assert 0 < int(got[2][0]) <= len(got[0])


def test_nms_center_encoding_flipped_corners_and_output_type():
    rng = np.random.default_rng(9)
    center = np.concatenate([rng.uniform(0, 1, (1, 20, 2)), rng.uniform(0.1, 0.3, (1, 20, 2))],
                            -1).astype(np.float32)
    scores = rng.uniform(0, 1, (1, 2, 20)).astype(np.float32)
    check_nms(center, scores, iou=0.3, encoding="center", output_type="i32")
    corner = random_boxes(rng, 1, 20)
    flipped = corner[..., [2, 3, 0, 1]]
    a = check_nms(corner, scores, iou=0.3, max_boxes=3)
    b = check_nms(flipped, scores, iou=0.3, max_boxes=3)
    np.testing.assert_array_equal(a[0], b[0])


def test_nms_sweep_budget():
    """The keep budget, applied after the sweep, keeps the budgeted greedy
    sweep's set: a kept candidate past the budget suppressed nothing that
    the budget would have kept."""
    rng = np.random.default_rng(2)
    for _ in range(20):
        n = 16
        iou = torch.from_numpy(rng.uniform(0, 1, (3, n, n)).astype(np.float32))
        iou = (iou + iou.transpose(-1, -2)) / 2
        valid = torch.from_numpy(rng.uniform(0, 1, (3, n)) < 0.8)
        for budget in (1, 3, n):
            keep, cnt = greedy_nms_sweep(iou, valid, 0.6, budget)
            for s in range(3):
                kept = []
                for i in range(n):
                    if (valid[s, i] and len(kept) < budget
                            and not any(iou[s, i, j] > 0.6 for j in kept)):
                        kept.append(i)
                assert torch.nonzero(keep[s]).reshape(-1).tolist() == kept
                assert int(cnt[s]) == len(kept)


# -- Exp, Maximum, GreaterEqual ------------------------------------------------


def _binary_both(op_type, a, b):
    import jax.numpy as jnp

    kw = dict(id=0, name="n", op_type=op_type, attrs={}, inputs={}, outputs={2: None})
    node, jnode = port_ir.Node(**kw), jax_ir.Node(**kw)
    got = get_op(op_type).emit(None, node, {0: TValue(torch.from_numpy(a)),
                                            1: TValue(torch.from_numpy(b))})[2].arr.numpy()
    want = np.asarray(jax_get_op(op_type).emit(None, jnode, {
        0: JaxTValue(jnp.asarray(a), "L"), 1: JaxTValue(jnp.asarray(b), "L")})[2].nchw())
    ref = get_op(op_type).ref_compute(node, {0: a, 1: b})[2]
    jref = jax_get_op(op_type).ref_compute(jnode, {0: a, 1: b})[2]
    return got, want, ref, jref


@pytest.mark.parametrize("op_type", ["Maximum", "GreaterEqual"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32], ids=["f32", "i32"])
def test_binary_ops_match_jax(op_type, dtype):
    rng = np.random.default_rng(1)
    for sa, sb in (((2, 3, 4), (1, 3, 1)), ((5, 1), (1, 1)), ((4,), ())):
        a = rng.integers(-3, 4, sa).astype(dtype)
        b = rng.integers(-3, 4, sb).astype(dtype)
        got, want, ref, jref = _binary_both(op_type, a, b)
        np.testing.assert_array_equal(ref, jref)
        for other in (want, ref):
            assert got.shape == other.shape and got.dtype == other.dtype
            np.testing.assert_array_equal(got, other)
    assert got.dtype == (np.bool_ if op_type == "GreaterEqual" else dtype)


def test_maximum_clamps_nms_indices():
    """yolo-v2's use: NonMaxSuppression's i32 box column, -1 on pad rows,
    clamped at a (1, 1) int32 zero."""
    idx = np.asarray([[3], [0], [-1], [-1]], np.int32)
    got, want, _, _ = _binary_both("Maximum", idx, np.zeros((1, 1), np.int32))
    np.testing.assert_array_equal(got, [[3], [0], [0], [0]])
    np.testing.assert_array_equal(got, want)


def test_exp_matches_jax():
    import jax.numpy as jnp

    x = np.random.default_rng(4).uniform(-6, 4, (3, 5, 7)).astype(np.float32)
    kw = dict(id=0, name="n", op_type="Exp", attrs={}, inputs={}, outputs={1: None})
    node, jnode = port_ir.Node(**kw), jax_ir.Node(**kw)
    got = get_op("Exp").emit(None, node, {0: TValue(torch.from_numpy(x))})[1].arr
    want = np.asarray(jax_get_op("Exp").emit(None, jnode, {0: JaxTValue(jnp.asarray(x), "L")})[
        1].nchw())
    ref = get_op("Exp").ref_compute(node, {0: x})[1]
    np.testing.assert_array_equal(ref, jax_get_op("Exp").ref_compute(jnode, {0: x})[1])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=0)
    bf16 = get_op("Exp").emit(None, node, {0: TValue(torch.from_numpy(x).bfloat16())})[1].arr
    jbf16 = np.asarray(jnp.exp(jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    assert bf16.dtype == torch.bfloat16
    np.testing.assert_array_equal(bf16.float().numpy(), jbf16)


def test_sigmoid_bf16_equals_jax_bit_for_bit():
    """The Sigmoid op in bfloat16 rounds XLA's three steps, 1 / (1 +
    exp(-x)), each to bfloat16: equal to jax.nn.sigmoid over every finite
    bfloat16 input above -87.25.  At and below it the result is subnormal,
    which XLA's CPU flushes to zero and PyTorch keeps (the only three
    inputs that differ); float32 stays torch.sigmoid."""
    import jax
    import jax.numpy as jnp

    bits = (np.arange(1 << 16, dtype=np.uint32) << 16).view(np.float32)
    x = bits[np.isfinite(bits)]
    kw = dict(id=0, name="n", op_type="Sigmoid", attrs={}, inputs={}, outputs={1: None})
    node = port_ir.Node(**kw)
    got = get_op("Sigmoid").emit(None, node, {0: TValue(torch.from_numpy(x).bfloat16())})[1].arr
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    want = np.asarray(jax.jit(jax.nn.sigmoid)(jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    normal = x > -87.25
    np.testing.assert_array_equal(got[normal], want[normal])
    differ = np.nonzero(got != want)[0]
    assert len(differ) == 3 and (want[differ] == 0).all()
    assert (np.abs(got[differ]) < np.finfo(np.float32).tiny).all()
    f32 = np.random.default_rng(0).uniform(-8, 8, 1000).astype(np.float32)
    out = get_op("Sigmoid").emit(None, node, {0: TValue(torch.from_numpy(f32))})[1].arr
    torch.testing.assert_close(out, torch.sigmoid(torch.from_numpy(f32)), rtol=0, atol=0)
