"""ROIAlign (``ops/roi.py``), Proposal (``ops/proposal.py``) and PriorBox
(``ops/ssd.py``) of the port against the JAX package.

Each graph is built node for node with both packages' GraphBuilders and run
through the port's numpy interpreter (equal to the JAX package's bit for
bit), the port's TORCH and KERNELS backends on CPU tensors and the JAX
package's XLA backend: float outputs within RTOL of each output's largest
value, Proposal's kept rois the same rows with the same scores.  The
oracles are ``tests/test_detection.py``'s PriorBox, ROIAlign and Proposal
cases and ``tests/test_round5_fixes.py``'s PriorBox ``fixed_size`` refusal,
each also run through the port.  The registries of the two packages hold
the same op types."""

import numpy as np
import pytest
import torch

from pyopenvino_tpu.config import Backend as JaxBackend
from pyopenvino_tpu.config import Config as JaxConfig
from pyopenvino_tpu.ir.builder import GraphBuilder as JaxGraphBuilder
from pyopenvino_tpu.ops import proposal as jax_proposal
from pyopenvino_tpu.ops import ssd as jax_ssd
from pyopenvino_tpu.runtime.compiler import compile_model as jax_compile
from pyopenvino_tpu.runtime.interpreter import Interpreter as JaxInterpreter

from pyopenvino_tpu_torch.config import Backend, Config
from pyopenvino_tpu_torch.ir.builder import GraphBuilder
from pyopenvino_tpu_torch.ops import proposal, roi, ssd
from pyopenvino_tpu_torch.runtime.compiler import compile_model
from pyopenvino_tpu_torch.runtime.interpreter import Interpreter
import test_torch_port_threads  # noqa: F401  (this worker's torch threads)

RTOL = 1e-5


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def run_all(make, feeds, backends=(Backend.TORCH, Backend.KERNELS)):
    """{"interp", "jax_interp", "xla", backend value: outputs} of the graph
    ``make(builder_cls)`` builds; the two interpreters are held equal here."""
    port, jax_model = make(GraphBuilder), make(JaxGraphBuilder)
    out = {"interp": Interpreter(port).run(feeds),
           "jax_interp": JaxInterpreter(jax_model).run(feeds),
           "xla": jax_compile(jax_model, JaxConfig(backend=JaxBackend.XLA))(feeds)}
    for k, v in out["interp"].items():
        assert v.dtype == out["jax_interp"][k].dtype
        np.testing.assert_array_equal(v, out["jax_interp"][k], err_msg=k)
    for backend in backends:
        out[backend.value] = compile_model(port, Config(backend=backend), device="cpu")(feeds)
    return out


def test_registries_match():
    import pyopenvino_tpu.ops as jax_ops
    import pyopenvino_tpu_torch.ops as port_ops

    assert sorted(port_ops.REGISTRY) == sorted(jax_ops.REGISTRY)
    assert len(port_ops.REGISTRY) == 133


# -- PriorBox (tests/test_detection.py::TestPriorBox, TestPriorBoxSpecCorners) --

PB = dict(min_size=(4.0,), max_size=(9.0,), aspect_ratio=(2.0,), flip=True, clip=False,
          step=4.0, offset=0.5, variance=(0.1, 0.1, 0.2, 0.2), scale_all_sizes=True)


@pytest.mark.parametrize("p", [
    PB,
    dict(PB, min_size=(16.0,), max_size=(), aspect_ratio=(), flip=False, clip=True, step=0.0,
         variance=(0.1,)),
    dict(PB, min_size=(4.0, 8.0), aspect_ratio=(2.0,), variance=(0.1,), scale_all_sizes=False),
    dict(PB, step=0.0, offset=0.9),
    dict(PB, min_size=(30.0, 60.0), max_size=(60.0, 111.0), aspect_ratio=(2.0, 3.0), step=16.0),
], ids=["order", "clip_single_variance", "mxnet_layout", "step_zero", "ssd300"])
def test_prior_boxes_equal_jax(p):
    for grid, image in (((2, 2), (8, 8)), ((3, 5), (48, 80))):
        np.testing.assert_array_equal(ssd.prior_boxes(grid, image, p),
                                      jax_ssd.prior_boxes(grid, image, p))
    assert ssd._pb_wh_list(p) == jax_ssd._pb_wh_list(p)


def test_prior_box_order_and_values():
    out = ssd.prior_boxes((2, 2), (8, 8), PB)
    boxes = out[0].reshape(2, 2, 4, 4)
    cx = cy = 0.5 * 4.0
    m, s, r = 4.0, np.sqrt(36.0), np.sqrt(2.0)
    for k, (w, h) in enumerate([(m, m), (s, s), (m * r, m / r), (m / r, m * r)]):
        np.testing.assert_allclose(
            boxes[0, 0, k], [(cx - w / 2) / 8, (cy - h / 2) / 8, (cx + w / 2) / 8,
                             (cy + h / 2) / 8], rtol=1e-6)
    np.testing.assert_allclose(out[1][:8], [0.1, 0.1, 0.2, 0.2] * 2, rtol=1e-6)


def test_prior_box_spec_corners():
    r = np.sqrt(2.0)
    wh = ssd._pb_wh_list(dict(PB, min_size=(4.0, 8.0), variance=(0.1,),
                              scale_all_sizes=False))
    np.testing.assert_allclose(wh, [(4, 4), (8, 8), (4 * r, 4 / r), (4 / r, 4 * r)], rtol=1e-6)
    base = dict(PB, max_size=(), aspect_ratio=(), flip=False, variance=(0.1,))
    a = ssd.prior_boxes((2, 2), (8, 8), dict(base, step=0.0, offset=0.9))
    np.testing.assert_allclose(a, ssd.prior_boxes((2, 2), (8, 8), dict(base, step=0.0)))
    c = ssd.prior_boxes((2, 2), (8, 8), dict(base, offset=0.9))
    assert np.abs(a[0] - c[0]).max() > 1e-3
    with pytest.raises(ValueError, match="1 or 4"):
        ssd.prior_boxes((2, 2), (8, 8), dict(base, variance=(0.1, 0.1, 0.2)))


def test_prior_box_folds_like_jax():
    """A PriorBox on static inputs folds at compile time: TORCH's output
    equals the interpreters' and XLA's, and the node never runs."""
    def make(cls):
        b = cls("pb")
        x = b.parameter("x", (1, 1, 2, 2))
        pri = b.prior_box((2, 2), (8, 8), min_size=(4.0,), max_size=(9.0,),
                          aspect_ratio=(2.0, 3.0), flip=True)
        b.result(b.add(pri, b.const(np.zeros((1, 1), np.float32))), "out")
        b.result(b.reshape(x, (1, 4)), "unused")
        return b.build()

    out = run_all(make, {"x": np.zeros((1, 1, 2, 2), np.float32)})
    assert out["interp"]["out"].shape == (2, 4 * 2 * 2 * 6)
    for k in ("xla", "torch", "kernels"):
        np.testing.assert_array_equal(out[k]["out"], out["interp"]["out"])
    net = compile_model(make(GraphBuilder), Config(), device="cpu")
    assert net.model.find_by_type("PriorBox")[0].id in net._folded_nodes


def test_prior_box_fixed_size_refused():
    b = GraphBuilder("pb")
    g = b.const(np.asarray([4, 4], np.int64), "grid")
    im = b.const(np.asarray([64, 64], np.int64), "img")
    with pytest.raises(NotImplementedError, match="fixed_size"):
        b._add_node("PriorBox", [g, im], {"min_size": "16.0", "offset": "0.5",
                                          "fixed_size": "32.0", "density": "2.0"},
                    out_dtype=np.float32)


# -- ROIAlign (tests/test_detection.py::TestROIAlign, :447) ----------------------------------

def roi_model(n, c, h, w, r, **kw):
    def make(cls):
        b = cls("roi")
        data = b.parameter("data", (n, c, h, w))
        rois = b.parameter("rois", (r, 4))
        idx = b.parameter("idx", (r,), dtype=np.int32)
        b.result(b.roi_align(data, rois, idx, **kw), "out")
        return b.build()
    return make


def test_roi_align_constant_region_and_ramp():
    make = roi_model(1, 2, 8, 8, 2, pooled_h=3, pooled_w=3, sampling_ratio=2)
    rois = np.asarray([[0, 0, 7, 7], [1.5, 2.0, 6.0, 5.5]], np.float32)
    out = run_all(make, {"data": np.full((1, 2, 8, 8), 5.0, np.float32), "rois": rois,
                         "idx": np.zeros(2, np.int32)})
    for k in ("interp", "torch", "kernels"):
        assert out[k]["out"].shape == (2, 2, 3, 3)
        np.testing.assert_allclose(out[k]["out"], 5.0, rtol=1e-6)
    make = roi_model(1, 1, 8, 8, 1, pooled_h=2, pooled_w=2, sampling_ratio=2)
    ramp = np.broadcast_to(np.arange(8, dtype=np.float32), (1, 1, 8, 8)).copy()
    out = run_all(make, {"data": ramp, "rois": np.asarray([[1.0, 1.0, 5.0, 5.0]], np.float32),
                         "idx": np.zeros(1, np.int32)})
    for k in ("interp", "torch"):
        np.testing.assert_allclose(out[k]["out"][0, 0, 0], [2.0, 4.0], rtol=1e-6)


@pytest.mark.parametrize("mode", ["avg", "max"])
def test_roi_align_equals_jax(mode):
    rng = np.random.default_rng(0)
    feeds = {"data": rng.standard_normal((2, 3, 10, 12)).astype(np.float32),
             "rois": np.asarray([[0, 0, 11, 9], [2.3, 1.1, 8.7, 7.5], [5, 5, 9, 9],
                                 [-3, -2, 14, 13]], np.float32),
             "idx": np.asarray([0, 1, 0, 1], np.int32)}
    make = roi_model(2, 3, 10, 12, 4, pooled_h=4, pooled_w=5, sampling_ratio=3,
                     spatial_scale=0.5, mode=mode)
    out = run_all(make, feeds)
    for k in ("torch", "kernels", "xla"):
        assert out[k]["out"].dtype == np.float32
        assert _rel(out[k]["out"], out["interp"]["out"]) <= RTOL, k
    assert _rel(out["torch"]["out"], out["xla"]["out"]) <= RTOL


def test_roi_align_chunks_and_bf16(monkeypatch):
    """The emit's chunks over rois give the unchunked answer bit for bit;
    in bfloat16 the math stays float32 and the result is cast back."""
    rng = np.random.default_rng(1)
    data = torch.from_numpy(rng.standard_normal((2, 4, 9, 7)).astype(np.float32))
    rois = torch.from_numpy(rng.uniform(-2, 10, (37, 4)).astype(np.float32))
    bidx = torch.from_numpy(rng.integers(0, 2, 37))
    p = dict(pooled_h=3, pooled_w=2, sampling_ratio=2, spatial_scale=0.75, mode="avg")
    whole = roi.roi_align_torch(data, rois, bidx, p)
    monkeypatch.setattr(roi, "_CHUNK_ELEMS", 4 * 3 * 2 * 2 * 2 * 5)  # 5 rois a chunk
    np.testing.assert_array_equal(roi.roi_align_torch(data, rois, bidx, p).numpy(), whole.numpy())
    want = roi.roi_align_ref(data.numpy(), rois.numpy(), bidx.numpy(), p)
    assert _rel(whole.numpy(), want) <= RTOL
    make = roi_model(2, 4, 9, 7, 37, **{k: v for k, v in p.items()})
    feeds = {"data": data.numpy(), "rois": rois.numpy(), "idx": bidx.numpy().astype(np.int32)}
    got = compile_model(make(GraphBuilder), Config(compute_dtype="bfloat16"), device="cpu")(feeds)
    jax_bf16 = jax_compile(make(JaxGraphBuilder), JaxConfig(backend=JaxBackend.XLA,
                                                           compute_dtype="bfloat16"))(feeds)
    assert got["out"].dtype == np.float32
    # the inputs round to bfloat16 in both packages alike: one bf16 step
    assert _rel(got["out"], jax_bf16["out"]) <= 2 ** -8


def test_roi_align_out_of_range_samples_zero():
    make = roi_model(1, 1, 4, 4, 2, pooled_h=1, pooled_w=1, sampling_ratio=2)
    feeds = {"data": np.ones((1, 1, 4, 4), np.float32),
             "rois": np.asarray([[0, 0, 3, 3], [2, 2, 12, 12]], np.float32),
             "idx": np.zeros(2, np.int32)}
    out = run_all(make, feeds)
    ref = out["interp"]["out"]
    for k in ("torch", "kernels", "xla"):
        np.testing.assert_allclose(out[k]["out"], ref, rtol=1e-6, atol=1e-7)
    assert abs(float(ref[0, 0, 0, 0]) - 1.0) < 1e-6
    assert float(ref[1, 0, 0, 0]) < 0.99


def test_roi_align_adaptive_sampling_refused():
    with pytest.raises(NotImplementedError, match="sampling_ratio"):
        roi_model(1, 1, 4, 4, 1, pooled_h=2, pooled_w=2, sampling_ratio=0)(GraphBuilder)


# -- Proposal (tests/test_detection.py::TestProposal, :592, :634) ----------------------------

def proposal_model(n, a, h, w, im=(32.0, 32.0, 1.0), **kw):
    def make(cls):
        b = cls("rpn")
        probs = b.parameter("probs", (n, 2 * a, h, w))
        deltas = b.parameter("deltas", (n, 4 * a, h, w))
        info = b.const(np.asarray(im, np.float32), "im")
        rois, sc = b.proposal(probs, deltas, info, **kw)
        b.result(rois, "rois")
        b.result(sc, "scores")
        return b.build()
    return make


def proposals_agree(got, want):
    """The same kept rows (nonzero scores) with the same scores, equal
    padding, the coordinates within RTOL of the largest."""
    np.testing.assert_array_equal(got["scores"] > 0, want["scores"] > 0)
    np.testing.assert_array_equal(got["scores"], want["scores"])
    np.testing.assert_array_equal(got["rois"][:, 0], want["rois"][:, 0])
    assert _rel(got["rois"], want["rois"]) <= RTOL


def _rpn_feeds(rng, n, a, h, w):
    return {"probs": rng.uniform(0, 1, (n, 2 * a, h, w)).astype(np.float32),
            "deltas": rng.normal(0, 0.2, (n, 4 * a, h, w)).astype(np.float32)}


@pytest.mark.parametrize("framework", ["", "tensorflow"])
def test_proposal_equals_jax(framework):
    rng = np.random.default_rng(0 if not framework else 3)
    n, a, h, w = 2, 2, 4, 4
    make = proposal_model(n, a, h, w, base_size=8, feat_stride=8, ratio=(0.5, 1.0),
                          scale=(1.0,), pre_nms_topn=20, post_nms_topn=6, nms_thresh=0.5,
                          min_size=2, framework=framework)
    out = run_all(make, _rpn_feeds(rng, n, a, h, w))
    ref = out["interp"]
    assert ref["rois"].shape == (n * 6, 5)
    for k in ("torch", "kernels", "xla"):
        proposals_agree(out[k], ref)
    live = ref["scores"] > 0
    assert live.any()
    assert set(np.unique(ref["rois"][live, 0])) <= {0.0, 1.0}
    if not framework:
        assert ref["rois"][live, 1:].min() >= 0 and ref["rois"][live, 1:].max() <= 31
        for b in range(n):
            s = ref["scores"][b * 6:(b + 1) * 6]
            assert (np.diff(s[s > 0]) <= 1e-6).all()


def test_proposal_anchors_and_params_equal_jax():
    def node(framework):
        b = GraphBuilder("a")
        probs, deltas = b.parameter("p", (1, 12, 2, 2)), b.parameter("d", (1, 24, 2, 2))
        b.proposal(probs, deltas, b.const(np.asarray([8.0, 8.0, 1.0], np.float32)),
                   base_size=16, feat_stride=16, ratio=(0.5, 1.0, 2.0), scale=(8.0, 16.0),
                   framework=framework)
        return b.build().find_by_type("Proposal")[0]

    for framework in ("", "caffe", "tensorflow"):
        nd = node(framework)
        assert proposal._params(nd) == jax_proposal._params(nd)
        np.testing.assert_array_equal(proposal._anchors(proposal._params(nd)),
                                      jax_proposal._anchors(jax_proposal._params(nd)))
    p = proposal._params(node("tensorflow"))
    ws = np.sqrt(256.0 / 0.5)
    np.testing.assert_allclose(proposal._anchors(p)[0],
                               np.asarray([-ws, -ws * 0.5, ws, ws * 0.5]) * 8 / 2, rtol=1e-6)


def test_proposal_nms_suppresses_duplicates():
    make = proposal_model(1, 1, 1, 2, base_size=16, feat_stride=1, ratio=(1.0,), scale=(1.0,),
                          pre_nms_topn=10, post_nms_topn=4, nms_thresh=0.5, min_size=2)
    probs = np.zeros((1, 2, 1, 2), np.float32)
    probs[0, 1] = [[0.9, 0.8]]
    out = run_all(make, {"probs": probs, "deltas": np.zeros((1, 4, 1, 2), np.float32)})
    for k in ("interp", "torch", "kernels"):
        live = out[k]["scores"] > 0
        assert live.sum() == 1 and abs(out[k]["scores"][0] - 0.9) < 1e-6


def test_proposal_unknown_framework_refused():
    b = GraphBuilder("x")
    probs, deltas = b.parameter("p", (1, 2, 2, 2)), b.parameter("d", (1, 4, 2, 2))
    info = b.const(np.asarray([8.0, 8.0, 1.0], np.float32))
    with pytest.raises(NotImplementedError, match="framework"):
        b._add_node("Proposal", [probs, deltas, info], {
            "base_size": "8", "feat_stride": "8", "ratio": "1.0", "scale": "1.0",
            "pre_nms_topn": "10", "post_nms_topn": "4", "nms_thresh": "0.5",
            "min_size": "2", "framework": "mxnet"}, "p2", n_outputs=2)


def test_proposal_small_pool_and_padding():
    """The builder's defaults (pre 6000, post 300) on a pool of 18: zero
    padding past the kept rows, the batch column too."""
    n, a, h, w = 2, 2, 3, 3
    make = proposal_model(n, a, h, w, im=(24.0, 24.0, 1.0), base_size=8, feat_stride=8,
                          ratio=(0.5, 1.0), scale=(1.0,))
    out = run_all(make, _rpn_feeds(np.random.default_rng(2), n, a, h, w))
    ref = out["interp"]
    assert ref["rois"].shape == (n * 300, 5)
    for k in ("torch", "kernels", "xla"):
        proposals_agree(out[k], ref)
        pad = out[k]["rois"][300:][out[k]["scores"][300:] == 0]
        assert pad.size and np.all(pad == 0)


def test_proposal_clip_after_nms_normalize_and_bf16():
    """clip_after_nms and normalize against the JAX emit; bf16 scores
    widen to float32 before the sort, as the JAX emit casts them."""
    rng = np.random.default_rng(5)
    n, a, h, w = 1, 3, 5, 5
    feeds = _rpn_feeds(rng, n, a, h, w)
    feeds["deltas"] *= 5
    for kw in ({"clip_after_nms": True, "clip_before_nms": False}, {"normalize": True}):
        def make(cls, kw=kw):
            b = cls("rpn")
            probs = b.parameter("probs", (n, 2 * a, h, w))
            deltas = b.parameter("deltas", (n, 4 * a, h, w))
            info = b.const(np.asarray([40.0, 40.0, 1.0], np.float32))
            rois, sc = b._add_node("Proposal", [probs, deltas, info], {
                "base_size": "8", "feat_stride": "8", "ratio": "0.5,1.0,2.0", "scale": "1.0",
                "pre_nms_topn": "50", "post_nms_topn": "10", "nms_thresh": "0.6",
                "min_size": "2", **{k: "true" if v else "false" for k, v in kw.items()}},
                "prop", n_outputs=2)
            b.result(rois, "rois")
            b.result(sc, "scores")
            return b.build()
        out = run_all(make, feeds)
        for k in ("torch", "xla"):
            proposals_agree(out[k], out["interp"])
    got = compile_model(make(GraphBuilder), Config(compute_dtype="bfloat16"), device="cpu")(feeds)
    want = jax_compile(make(JaxGraphBuilder), JaxConfig(backend=JaxBackend.XLA,
                                                       compute_dtype="bfloat16"))(feeds)
    assert got["rois"].dtype == want["rois"].dtype == np.float32
    proposals_agree(got, want)


def two_stage(cls, post=4):
    """tests/test_detection.py:592's Faster R-CNN wiring: the batch column
    of the rois gathered off into ROIAlign's batch indices."""
    n, a, h, w = 1, 2, 4, 4
    b = cls("faster")
    feat = b.parameter("feat", (n, 8, 4, 4))
    probs = b.parameter("probs", (n, 2 * a, h, w))
    deltas = b.parameter("deltas", (n, 4 * a, h, w))
    info = b.const(np.asarray([32.0, 32.0, 1.0], np.float32), "im")
    rois, _sc = b.proposal(probs, deltas, info, base_size=8, feat_stride=8, ratio=(0.5, 1.0),
                           scale=(1.0,), pre_nms_topn=20, post_nms_topn=post, nms_thresh=0.5,
                           min_size=2)
    boxes = b.gather(rois, [1, 2, 3, 4], axis=1)
    bidx = b.convert(b.reshape(b.gather(rois, [0], axis=1), (post,)), "i32")
    b.result(b.roi_align(feat, boxes, bidx, pooled_h=2, pooled_w=2, sampling_ratio=2,
                         spatial_scale=4.0 / 32.0), "pooled")
    return b.build()


def test_two_stage_proposal_roialign_composition():
    rng = np.random.default_rng(1)
    feeds = {"feat": rng.standard_normal((1, 8, 4, 4)).astype(np.float32),
             **_rpn_feeds(rng, 1, 2, 4, 4)}
    out = run_all(two_stage, feeds)
    ref = out["interp"]["pooled"]
    assert ref.shape == (4, 8, 2, 2) and np.abs(ref).max() > 0
    for k in ("torch", "kernels", "xla"):
        assert _rel(out[k]["pooled"], ref) <= RTOL, k
