"""Nine graph recipes that drive the op types no in-repo family uses through
the normal entry points: ``GraphBuilder`` → ``ir/writer.py`` →
``IECore.read_network`` → ``load_network`` → ``infer`` / ``infer_batch``.

Each recipe is a plain function ``recipe(b, rng, batch, width)`` on any
object with ``GraphBuilder``'s methods (the port's or the JAX package's,
which build the same graph node for node): it adds Parameters, weights
drawn from ``rng``, the ops and named Results to ``b``, and returns a
``Recipe`` that draws inputs.  At ``width`` = 128 (``FULL_WIDTH``) the
shapes are those of served families; a small width keeps the CPU tests
small.

  * ``activations``: unary math and activations on a 1×1 Convolution
    W → W at H×W (28×28 at full width: ResNet-18's stage-2 width), each op's
    domain made valid (Abs before Sqrt and Log, Tanh before Asin, Acos and
    Atanh); Floor, Ceiling, Round and Sign on a Parameter;
  * ``binary_logical``: Minimum, Power, SquaredDifference, FloorMod and Mod
    on the same root, the comparisons, logic and Select on Parameters;
  * ``reduce_norm``: the reductions over spatial and channel axes,
    NormalizeL2 across channels (SSD-VGG's conv4_3), BatchNormInference and
    GroupNormalization with 32 groups on the root; the logical reductions
    on a boolean Parameter;
  * ``layout``: Squeeze, Pad in its four modes, DepthToSpace and
    SpaceToDepth in both orders, SpaceToBatch and BatchToSpace,
    ShuffleChannels with 2 groups (ShuffleNet-v2's), Broadcast in its three
    modes, Range (folded), ReverseSequence, CumSum and OneHot;
  * ``gather_scatter``: a MatMul W → W on the rows GatherND gathers, then
    GatherElements, GatherND (batch_dims 0 and 2), ScatterNDUpdate,
    ScatterElementsUpdate on distinct indices, and EmbeddingBagOffsetsSum on
    a (1000, W) table with per-sample weights and an empty bag;
  * ``heads``: ResNet-18's FC (MatMul 512 → 1000) with TopK k = 5 and
    LogSoftmax over its logits; ViT-tiny's attention as two Einsums (4
    heads of 32 over 64 tokens); CTCGreedyDecoder on ocr-ti's (24 frames, 27
    classes) posteriors; TopK's four modes on a Parameter;
  * ``lstm_stream``: lstm-tiny after OpenVINO's LowLatency2 transform
    (ReadValue, Assign): a chunk of 8 frames of 40 features a call (four
    calls make lstm-tiny's 32), two forward LSTMSequences of 64 whose
    initial h and c each come from a ReadValue of a zero Const and whose
    final h and c each go to an Assign (four variables), the second's last
    hidden state into a 64 → 30 MatMul with bias and a SoftMax: keyword
    spotting served as a stream of chunks, each call seeing the previous
    call's state;
  * ``two_stage``: a Faster R-CNN head on ResNet-18's stride-16 map, (1,
    256, 14, 14) at 224 × 224 (Proposal, ROIAlign): the RPN (a 3×3 conv 256
    → 256 with ReLU, 1×1 convs to 2·9 scores, softmaxed over each pair, and
    to 4·9 deltas), Proposal with the published Faster R-CNN test settings
    (1,764 anchors, 300 rois), ROIAlign 7 × 7 of the map, and a C4-style
    box head (a 3×3 stride-2 conv 256 → 512 with ReLU, a mean over H and
    W, FCs 512 → 81 with a SoftMax and 512 → 324): Detectron's R-50-C4 at
    ResNet-18's widths;
  * ``single_shot``: Caffe SSD300's heads on ResNet-18's stride-16 and -32
    maps (PriorBox): its conv6_1/conv6_2 extra layers (a 1×1 conv 256 →
    256 and a 3×3 stride-2 conv 256 → 512, each with ReLU) make the 7 × 7
    map, each map has 3×3 loc and conf convs (21 VOC classes) and a
    PriorBox with SSD300's first two settings at steps 16 and 32 (1,078
    priors), and DetectionOutput with SSD300-VOC's settings.

The detector recipes draw their weights as a trained detector answers: the
conf head's background logit leads by ``BACKGROUND_LEAD`` and the RPN's
deltas are small, so an image holds tens of records, not every prior.

Discontinuous ops read inputs that pass through no kernel (a Parameter, a
Const or an integer tensor) with values on a small grid, so that ties and
.5 cases occur and every backend agrees on them exactly.  ``Recipe.loose``
names the Results whose values a discontinuous op took from a kernel's
output (TopK's indices behind the FC): those are compared as agreement.
"""

from __future__ import annotations

from typing import Callable, Dict, FrozenSet, NamedTuple

import numpy as np

FULL_WIDTH = 128
FC_IN, FC_OUT = 512, 1000     # ResNet-18's classifier
HEADS, TOKENS = 4, 64         # ViT-tiny's attention: 4 heads of 32
CTC_FRAMES, CTC_CLASSES = 24, 27   # ocr-ti's posteriors
LSTM_FEATURES, LSTM_CLASSES = 40, 30   # lstm-tiny (models/lstm_tiny.py)
LSTM_FRAMES, CHUNK = 32, 8     # lstm-tiny's frames; a stream's chunk a call
LSTM_VARIABLES = ("lstm1_h", "lstm1_c", "lstm2_h", "lstm2_c")
IMAGE, STRIDE = 224, 16        # ResNet-18's input and its layer-3 stride
# Faster R-CNN's published test settings (py-faster-rcnn, RPN test config)
RPN = dict(base_size=16, feat_stride=STRIDE, ratio=(0.5, 1.0, 2.0), scale=(8.0, 16.0, 32.0),
           pre_nms_topn=6000, post_nms_topn=300, nms_thresh=0.7, min_size=16)
ROI_CLASSES = 81               # COCO's 80 and background
# SSD300's first two PriorBox layers (min/max sizes, aspect ratios), at
# ResNet-18's strides 16 and 32 in place of VGG's 8 and 16
SSD_PRIORS = (dict(min_size=(30.0,), max_size=(60.0,), aspect_ratio=(2.0,)),
              dict(min_size=(60.0,), max_size=(111.0,), aspect_ratio=(2.0, 3.0)))
SSD_VARIANCE = (0.1, 0.1, 0.2, 0.2)
VOC_CLASSES = 21
BACKGROUND_LEAD = 5.0


class Recipe(NamedTuple):
    inputs: Callable[[np.random.Generator, int], Dict[str, np.ndarray]]
    loose: FrozenSet[str] = frozenset()


def spatial(width: int) -> int:
    """H = W of the conv-rooted recipes: 28 at full width, 4 below 64."""
    return 28 if width >= 64 else 4


def _f32(a):
    return np.asarray(a, np.float32)


def _grid(rng, shape, lo, hi):
    """Integers and half-integers in [lo, hi], float32."""
    return (rng.integers(2 * lo, 2 * hi + 1, shape) / 2).astype(np.float32)


def _root(b, rng, x, width):
    """A 1×1 Convolution width → width with its bias (fused on KERNELS:
    ``fused_gemm`` and its variants)."""
    w = rng.standard_normal((width, width, 1, 1)) / np.sqrt(width)
    y = b.conv2d(x, b.const(_f32(w)))
    return b.add(y, b.const(_f32(rng.standard_normal((1, width, 1, 1)) * 0.1)))


def _c(b, value):
    return b.const(_f32(value))


def _sum(b, *ports):
    out = ports[0]
    for p in ports[1:]:
        out = b.add(out, p)
    return out


def activations(b, rng, batch, width) -> Recipe:
    hw = spatial(width)
    x = b.parameter("x", (batch, width, hw, hw))
    g = b.parameter("g", (batch, 8, hw, hw))
    r = _root(b, rng, x, width)
    a = b.unary("Abs", r)
    t = b.tanh(r)
    t9 = b.multiply(t, _c(b, 0.9))
    half = _c(b, 0.5)
    b.result(_sum(b, b.sqrt(b.add(a, half)), b.unary("Log", b.add(a, half))), "roots")
    b.result(_sum(b, b.unary("Sin", r), b.unary("Cos", r), b.unary("Tan", t)), "trig")
    b.result(_sum(b, b.unary("Asin", t9), b.unary("Acos", t9), b.unary("Atan", r)), "arc")
    t2 = b.multiply(t, _c(b, 2.0))
    b.result(_sum(b, b.unary("Sinh", t2), b.unary("Cosh", t2), b.unary("Asinh", r),
                  b.unary("Acosh", b.add(a, _c(b, 1.5))), b.unary("Atanh", t9)), "hyperbolic")
    b.result(b.add(b.unary("Erf", r), b.unary("Negative", t)), "erf")
    b.result(_sum(b, b.elu(r, alpha=0.5), b.softplus(r), b.hswish(r)), "act1")
    hsig = b._add_node("HardSigmoid", [r, _c(b, 0.2), _c(b, 0.5)], {})
    b.result(_sum(b, b.hsigmoid(r), b.mish(r), hsig), "act2")
    selu = b._add_node("Selu", [r, _c(b, 1.6733), _c(b, 1.0507)], {})
    b.result(b.add(selu, b.unary("SoftSign", r)), "act3")
    b.result(b._add_node("LogSoftmax", [r], {"axis": "1"}), "log_softmax")
    b.result(b.unary("Floor", g), "floor")
    b.result(b.unary("Ceiling", g), "ceiling")
    b.result(b._add_node("Round", [g], {"mode": "half_to_even"}), "round_even")
    b.result(b._add_node("Round", [g], {"mode": "half_away_from_zero"}), "round_away")
    b.result(b.unary("Sign", g), "sign")

    def inputs(rng, n):
        return {"x": _f32(rng.standard_normal((n, width, hw, hw))),
                "g": _grid(rng, (n, 8, hw, hw), -4, 4)}
    return Recipe(inputs)


def binary_logical(b, rng, batch, width) -> Recipe:
    hw = spatial(width)
    x = b.parameter("x", (batch, width, hw, hw))
    p = b.parameter("p", (batch, 1, hw, hw))
    q = b.parameter("q", (batch, 1, hw, hw))
    i = b.parameter("i", (batch, 1, hw, hw), dtype=np.int32)
    j = b.parameter("j", (batch, 1, hw, hw), dtype=np.int32)
    r = _root(b, rng, x, width)
    per_channel = (1, width, 1, 1)
    b.result(b.minimum(r, _c(b, rng.standard_normal(per_channel) * 0.5)), "minimum")
    base = b.add(b.unary("Abs", r), _c(b, 0.5))
    b.result(b.power(base, _c(b, rng.uniform(0.5, 2.5, per_channel))), "power")
    b.result(b._add_node("SquaredDifference", [r, _c(b, rng.standard_normal(per_channel))],
                         {"auto_broadcast": "numpy"}), "squared_difference")
    # the remainders on the root stay inside one period (no jump to land on)
    pos = b.add(b.unary("Abs", r), _c(b, 0.25))
    b.result(_sum(b, b._add_node("FloorMod", [pos, _c(b, 64.0)], {}),
                  b._add_node("FloorMod", [pos, _c(b, -64.0)], {}),
                  b._add_node("Mod", [r, _c(b, 64.0)], {})), "remainders")
    b.result(b._add_node("FloorMod", [i, j], {}), "floor_mod_int")
    b.result(b._add_node("Mod", [i, j], {}), "mod_int")
    b.result(b.minimum(p, q), "minimum_pq")
    for op in ("Equal", "NotEqual", "Greater", "GreaterEqual", "Less", "LessEqual"):
        b.result(b.compare(op, p, q), op.lower())
    b.result(b.compare("Less", i, j), "less_int")
    gt, lt_int = b.compare("Greater", p, q), b.compare("Less", i, j)
    b.result(b.compare("LogicalAnd", gt, lt_int), "logical_and")
    b.result(b.compare("LogicalOr", gt, lt_int), "logical_or")
    b.result(b.compare("LogicalXor", gt, lt_int), "logical_xor")
    b.result(b.logical_not(gt), "logical_not")
    b.result(b.select(gt, p, q), "select")
    b.result(b.select(lt_int, i, j), "select_int")
    b.result(b.select(gt, r, b.unary("Negative", r)), "select_root")

    def inputs(rng, n):
        shape = (n, 1, hw, hw)
        divisor = rng.integers(1, 5, shape) * rng.choice([-1, 1], shape)
        return {"x": _f32(rng.standard_normal((n, width, hw, hw))),
                "p": _grid(rng, shape, -2, 2), "q": _grid(rng, shape, -2, 2),
                "i": rng.integers(-9, 10, shape).astype(np.int32),
                "j": divisor.astype(np.int32)}
    return Recipe(inputs)


def _groups(width):
    return 32 if width % 32 == 0 and width >= 64 else max(1, width // 2)


def reduce_norm(b, rng, batch, width) -> Recipe:
    hw = spatial(width)
    x = b.parameter("x", (batch, width, hw, hw))
    m = b.parameter("m", (batch, 8, hw, hw), dtype=np.bool_)
    r = _root(b, rng, x, width)
    b.result(b.reduce("Max", r, (2, 3), keep_dims=True), "reduce_max")
    b.result(b.reduce("Min", r, (1,), keep_dims=False), "reduce_min")
    near_one = b.add(b.multiply(b.tanh(r), _c(b, 0.1)), _c(b, 1.0))
    b.result(b.reduce("Prod", near_one, (3,), keep_dims=True), "reduce_prod")
    b.result(b.reduce("L1", r, (1,), keep_dims=True), "reduce_l1")
    b.result(b.reduce("L2", r, (2, 3), keep_dims=False), "reduce_l2")
    axes = b.const(np.asarray([1], np.int64))
    b.result(b._add_node("ReduceLogicalAnd", [m, axes], {"keep_dims": "false"},
                         out_dtype=np.bool_), "reduce_and")
    axes = b.const(np.asarray([2, 3], np.int64))
    b.result(b._add_node("ReduceLogicalOr", [m, axes], {"keep_dims": "true"},
                         out_dtype=np.bool_), "reduce_or")
    b.result(b.add(b.normalize_l2(r, axes=(1,), eps=1e-10, eps_mode="add"),
                   b.normalize_l2(r, axes=(2, 3), eps=1e-4, eps_mode="max")), "normalize_l2")
    c = (width,)
    b.result(b._add_node("BatchNormInference", [
        r, _c(b, rng.uniform(0.5, 1.5, c)), _c(b, rng.standard_normal(c) * 0.1),
        _c(b, rng.standard_normal(c) * 0.1), _c(b, rng.uniform(0.5, 2.0, c))],
        {"epsilon": "1e-5"}), "batch_norm")
    b.result(b._add_node("GroupNormalization", [
        r, _c(b, rng.uniform(0.5, 1.5, c)), _c(b, rng.standard_normal(c) * 0.1)],
        {"num_groups": str(_groups(width)), "epsilon": "1e-5"}), "group_norm")

    def inputs(rng, n):
        return {"x": _f32(rng.standard_normal((n, width, hw, hw))),
                "m": rng.integers(0, 5, (n, 8, hw, hw)) > 0}
    return Recipe(inputs)


def layout(b, rng, batch, width) -> Recipe:
    hw = spatial(width)
    x = b.parameter("x", (batch, width, hw, hw))
    lens = b.parameter("lens", (batch,), dtype=np.int32)
    k = b.parameter("k", (batch, 4, hw, hw), dtype=np.int32)
    r = _root(b, rng, x, width)
    pooled = b.reduce("Mean", r, (2, 3), keep_dims=True)          # (B, W, 1, 1)
    b.result(b.squeeze(pooled, axes=(2, 3)), "squeeze")
    b.result(b.squeeze(pooled), "squeeze_all")
    b.result(b.pad(r, (0, 0, 1, 2), (0, 0, 2, 1), mode="constant", value=-1.5), "pad_constant")
    b.result(b.pad(r, (0, 1, 1, 0), (0, 2, 0, 1), mode="edge"), "pad_edge")
    b.result(b.pad(r, (0, 0, 2, 3), (0, 0, 3, 2), mode="reflect"), "pad_reflect")
    b.result(b.pad(r, (0, 3, 1, 1), (0, 2, 1, 1), mode="symmetric"), "pad_symmetric")
    b.result(b.add(b.depth_to_space(r, 2, mode="blocks_first"),
                   b.depth_to_space(r, 2, mode="depth_first")), "depth_to_space")
    b.result(b.add(b.space_to_depth(r, 2, mode="blocks_first"),
                   b.space_to_depth(r, 2, mode="depth_first")), "space_to_depth")
    block, pb, pe = (1, 1, 2, 2), (0, 0, 1, 0), (0, 0, 1, 2)
    s2b = b.space_to_batch(r, block, pb, pe)
    b.result(s2b, "space_to_batch")
    b.result(b.batch_to_space(s2b, block, pb, pe), "batch_to_space")
    b.result(b._add_node("ShuffleChannels", [r], {"axis": "1", "group": "2"}), "shuffle")
    row = b.unary("Abs", _c(b, rng.standard_normal((width, 1, 1))))  # runs: no batch
    numpy_mode = b._add_node("Broadcast", [row, b.const(np.asarray([width, hw, hw], np.int64))],
                             {"mode": "numpy"})
    vec = b.unary("Abs", _c(b, rng.standard_normal((width,))))
    explicit = b._add_node("Broadcast", [
        vec, b.const(np.asarray([width, hw, hw], np.int64)), b.const(np.asarray([0], np.int64))],
        {"mode": "explicit"})
    mean_c = b.reduce("Mean", r, (1,), keep_dims=True)            # (B, 1, H, W)
    bidir = b._add_node("Broadcast", [mean_c, b.const(np.asarray([1, width, 1, 1], np.int64))],
                        {"mode": "bidirectional"})
    b.result(_sum(b, bidir, numpy_mode, explicit), "broadcast")
    ramp = b.reshape(b.range_(0, width, 1, output_type="f32"), (1, width, 1, 1))
    b.result(b.add(r, b.multiply(ramp, _c(b, 0.01))), "range")
    steps = b.range_(hw, 0, -1, output_type="i32")                # hw, hw − 1, ..., 1
    b.result(b._add_node("ReverseSequence", [r, steps], {"batch_axis": "2", "seq_axis": "3"}),
             "reverse_rows")
    b.result(b._add_node("ReverseSequence", [r, lens], {"batch_axis": "0", "seq_axis": "2"}),
             "reverse_batch")
    ax1, ax3 = b.const(np.asarray(1, np.int64)), b.const(np.asarray(3, np.int64))
    b.result(b.add(b._add_node("CumSum", [r, ax1], {}),
                   b._add_node("CumSum", [r, ax3], {"exclusive": "1", "reverse": "1"})),
             "cumsum")
    b.result(b._add_node("CumSum", [k, ax1], {"exclusive": "1"}), "cumsum_int")
    b.result(b._add_node("CumSum", [k, ax3], {"reverse": "1"}), "cumsum_int_reverse")
    b.result(b._add_node("OneHot", [
        k, b.const(np.asarray(8, np.int64)), b.const(np.asarray(5, np.int32)),
        b.const(np.asarray(-1, np.int32))], {"axis": "-1"}, out_dtype=np.int32), "one_hot")

    def inputs(rng, n):
        return {"x": _f32(rng.standard_normal((n, width, hw, hw))),
                "lens": rng.integers(0, hw + 1, (n,)).astype(np.int32),
                "k": rng.integers(-1, 9, (n, 4, hw, hw)).astype(np.int32)}
    return Recipe(inputs)


def _tokens(width):
    return TOKENS if width >= 64 else 8


def gather_scatter(b, rng, batch, width) -> Recipe:
    """A batch-1 graph: EmbeddingBagOffsetsSum's indices are one example's
    (a (1, I) Parameter reshaped to (I,)), so a batch runs one example at a
    time (``CompiledNetwork.infer_batch``)."""
    s = _tokens(width)
    rows, keep = s // 2, s // 8
    vocab = 1000 if width >= 64 else 50
    bag, bags = 24 if width >= 64 else 6, 8 if width >= 64 else 3
    x = b.parameter("x", (batch, s, width))
    gi = b.parameter("gather_rows", (batch, rows, 1), dtype=np.int32)
    ge = b.parameter("gather_elements", (batch, keep, width), dtype=np.int32)
    gi2 = b.parameter("gather_nd2", (batch, 4, 3, 1), dtype=np.int32)
    su = b.parameter("scatter_updates", (batch, keep, width))
    si = b.parameter("scatter_elements", (batch, keep, width), dtype=np.int32)
    bi = b.parameter("bag_indices", (batch, bag), dtype=np.int32)
    bw = b.parameter("bag_weights", (batch, bag))
    picked = b.gather_nd(x, gi, batch_dims=1)                     # (B, rows, W)
    w = rng.standard_normal((width, width)) / np.sqrt(width)
    h = b.matmul(picked, b.const(_f32(w)))                        # the root
    b.result(h, "rows")
    b.result(b.gather_elements(h, ge, axis=1), "gather_elements")
    ht = b.transpose(h, (1, 0, 2))                                # (rows, B, W)
    pick = rng.permutation(rows)[:keep].reshape(keep, 1).astype(np.int64)
    b.result(b.gather_nd(ht, b.const(pick)), "gather_nd")
    blocks = b.reshape(h, (batch, 4, rows // 4, width))
    b.result(b.gather_nd(blocks, gi2, batch_dims=2), "gather_nd_batch2")
    put = rng.permutation(rows)[:keep].reshape(keep, 1).astype(np.int64)
    upd = b.transpose(su, (1, 0, 2))                              # (keep, B, W)
    b.result(b.transpose(b.scatter_nd_update(ht, b.const(put), upd), (1, 0, 2)), "scatter_nd")
    b.result(b._add_node("ScatterElementsUpdate", [
        h, si, su, b.const(np.asarray(1, np.int64))], {}), "scatter_elements")
    table = b.const(_f32(rng.standard_normal((vocab, width))))
    offsets = np.sort(rng.integers(0, bag + 1, bags))
    offsets[0], offsets[bags // 2] = 0, offsets[bags // 2 - 1]    # an empty bag
    b.result(b._add_node("EmbeddingBagOffsetsSum", [
        table, b.reshape(bi, (bag,)), b.const(offsets.astype(np.int32)),
        b.const(np.asarray(3, np.int32)), b.reshape(bw, (bag,))], {}), "embedding_bag")

    def inputs(rng, n):
        distinct = np.argsort(rng.random((n, rows, width)), axis=1)[:, :keep]
        return {"x": _f32(rng.standard_normal((n, s, width))),
                "gather_rows": rng.integers(0, s, (n, rows, 1)).astype(np.int32),
                "gather_elements": rng.integers(-rows, rows, (n, keep, width)).astype(np.int32),
                "gather_nd2": rng.integers(0, rows // 4, (n, 4, 3, 1)).astype(np.int32),
                "scatter_updates": _f32(rng.standard_normal((n, keep, width))),
                "scatter_elements": distinct.astype(np.int32),
                "bag_indices": rng.integers(0, vocab, (n, bag)).astype(np.int32),
                "bag_weights": _f32(rng.uniform(0.5, 1.5, (n, bag)))}
    return Recipe(inputs)


def heads(b, rng, batch, width) -> Recipe:
    fc_in, fc_out = (FC_IN, FC_OUT) if width >= 64 else (4 * width, 50)
    t, head_dim = _tokens(width), width // HEADS
    f = b.parameter("features", (batch, fc_in))
    s = b.parameter("scores", (batch, fc_out))
    tok = b.parameter("tokens", (batch, t, width))
    post = b.parameter("posteriors", (batch, CTC_FRAMES, CTC_CLASSES))
    seq = b.parameter("frames", (batch, CTC_FRAMES))
    w = rng.standard_normal((fc_in, fc_out)) / np.sqrt(fc_in)
    logits = b.add(b.matmul(f, b.const(_f32(w))),
                   b.const(_f32(rng.standard_normal((fc_out,)) * 0.1)))
    vals, idx = b.top_k(logits, 5, axis=-1)
    b.result(vals, "top5_values")
    b.result(idx, "top5_indices")
    b.result(b._add_node("LogSoftmax", [logits], {"axis": "1"}), "log_softmax")
    for mode in ("max", "min"):
        for sort in ("value", "index"):
            v, i = b.top_k(s, 5, axis=1, mode=mode, sort=sort)
            b.result(v, f"topk_{mode}_{sort}_values")
            b.result(i, f"topk_{mode}_{sort}_indices")

    def heads_of():
        wq = rng.standard_normal((width, width)) / np.sqrt(width)
        y = b.reshape(b.matmul(tok, b.const(_f32(wq))), (batch, t, HEADS, head_dim))
        return b.transpose(y, (0, 2, 1, 3))                       # (B, heads, T, d)

    q, k, v = heads_of(), heads_of(), heads_of()
    att = b._add_node("Einsum", [q, k], {"equation": "bhqd,bhkd->bhqk"})
    att = b.softmax(b.multiply(att, _c(b, 1.0 / np.sqrt(head_dim))), axis=3)
    b.result(b._add_node("Einsum", [att, v], {"equation": "bhqk,bhkd->bhqd"}), "attention")
    post_t = b.transpose(post, (1, 0, 2))                         # (T, B, C)
    seq_t = b.transpose(seq, (1, 0))
    b.result(b._add_node("CTCGreedyDecoder", [post_t, seq_t], {}), "ctc")
    b.result(b._add_node("CTCGreedyDecoder", [post_t, seq_t], {"ctc_merge_repeated": "0"}),
             "ctc_unmerged")

    def inputs(rng, n):
        lengths = rng.integers(CTC_FRAMES // 2, CTC_FRAMES + 1, (n, 1))
        return {"features": _f32(np.abs(rng.standard_normal((n, fc_in)))),
                "scores": rng.integers(-3, 4, (n, fc_out)).astype(np.float32),
                "tokens": _f32(rng.standard_normal((n, t, width))),
                "posteriors": rng.integers(0, 3, (n, CTC_FRAMES, CTC_CLASSES)).astype(np.float32),
                "frames": (np.arange(CTC_FRAMES)[None, :] < lengths).astype(np.float32)}
    return Recipe(inputs, loose=frozenset({"top5_indices"}))


def _he(rng, shape):
    """Conv or FC weights with He's scale over the fan-in (the last dims
    of an (O, I, kh, kw) conv, the first of an (I, O) FC)."""
    fan_in = int(np.prod(shape[1:])) if len(shape) == 4 else shape[0]
    return _f32(rng.standard_normal(shape) * np.sqrt(2.0 / fan_in))


def _conv(b, x, w, bias, stride=1, pad=0, relu=True):
    y = b.add(b.conv2d(x, b.const(w), strides=(stride, stride), pads=((pad, pad), (pad, pad))),
              b.const(bias.reshape(1, -1, 1, 1)))
    return b.relu(y) if relu else y


def lstm_hidden(width):
    return 64 if width >= 64 else 16


def lstm_stream(b, rng, batch, width, frames=CHUNK, stateful=True) -> Recipe:
    """``stateful=False`` with ``frames=LSTM_FRAMES`` builds the same
    weights into one stateless run over lstm-tiny's 32 frames, the run that
    four chunks of a stream must equal."""
    h = lstm_hidden(width)
    layers = []
    for n_in in (LSTM_FEATURES, h):
        k = 1 / np.sqrt(h)
        layers.append((_f32(rng.uniform(-k, k, (1, 4 * h, n_in))),
                       _f32(rng.uniform(-k, k, (1, 4 * h, h))),
                       _f32(rng.uniform(-k, k, (1, 4 * h)))))
    head_w = _f32(rng.standard_normal((h, LSTM_CLASSES)) / np.sqrt(h))
    head_b = _f32(rng.standard_normal((LSTM_CLASSES,)) * 0.1)

    x = b.parameter("x", (batch, frames, LSTM_FEATURES))
    lens = b.const(np.asarray([frames], np.int32))
    seq = x
    for i, (w, r, bias) in enumerate(layers, start=1):
        zeros = [b.const(np.zeros((1, 1, h), np.float32)) for _ in range(2)]
        if stateful:
            init = [b.read_value(z, f"lstm{i}_{s}") for z, s in zip(zeros, "hc")]
        else:
            init = zeros
        y, ho, co = b.lstm_sequence(seq, init[0], init[1], lens, b.const(w), b.const(r),
                                    b.const(bias), h)
        if stateful:
            b.assign(ho, f"lstm{i}_h")
            b.assign(co, f"lstm{i}_c")
        seq = b.squeeze(y, axes=(1,))                             # (B, T, h)
    logits = b.add(b.matmul(b.squeeze(ho, axes=(1,)), b.const(head_w)), b.const(head_b))
    b.result(logits, "logits")
    b.result(b.softmax(logits, axis=1), "probs")

    def inputs(rng, n):
        return {"x": _f32(rng.standard_normal((n, frames, LSTM_FEATURES)))}
    return Recipe(inputs)


def detector_sizes(width):
    """(channels of the map, its H = W, post_nms_topn, the box head's
    channels, its classes, VOC's classes): published at full width, an
    8 × 8 map of 16 channels below 64."""
    if width >= 64:
        return 256, IMAGE // STRIDE, RPN["post_nms_topn"], 512, ROI_CLASSES, VOC_CLASSES
    return 16, 8, 16, 32, 5, 5


def _features(rng, n, c, hw):
    """ResNet-18's layer-3 output stands in as a ReLU of normals."""
    return {"features": _f32(np.maximum(rng.standard_normal((n, c, hw, hw)), 0))}


def two_stage(b, rng, batch, width) -> Recipe:
    c, hw, post, head_c, classes, _ = detector_sizes(width)
    anchors = len(RPN["ratio"]) * len(RPN["scale"])
    w_rpn, b_rpn = _he(rng, (c, c, 3, 3)), _f32(rng.standard_normal(c) * 0.1)
    w_cls, b_cls = _he(rng, (2 * anchors, c, 1, 1)), _f32(rng.standard_normal(2 * anchors))
    w_box = _f32(rng.standard_normal((4 * anchors, c, 1, 1)) * 0.1 / np.sqrt(c))
    b_box = _f32(rng.standard_normal(4 * anchors) * 0.05)
    w_head, b_head = _he(rng, (head_c, c, 3, 3)), _f32(rng.standard_normal(head_c) * 0.1)
    w_fc, b_fc = _he(rng, (head_c, classes)), _f32(rng.standard_normal(classes) * 0.1)
    w_bb = _f32(rng.standard_normal((head_c, 4 * classes)) * 0.1 / np.sqrt(head_c))
    b_bb = _f32(rng.standard_normal(4 * classes) * 0.01)

    x = b.parameter("features", (batch, c, hw, hw))
    rpn = _conv(b, x, w_rpn, b_rpn, pad=1)
    score = _conv(b, rpn, w_cls, b_cls, relu=False)               # (B, 2A, H, W)
    # Caffe's rpn_cls_score_reshape: background and foreground of each
    # anchor paired on axis 1, softmaxed, and back
    pairs = b.softmax(b.reshape(score, (batch, 2, anchors * hw, hw)), axis=1)
    probs = b.reshape(pairs, (batch, 2 * anchors, hw, hw))
    deltas = _conv(b, rpn, w_box, b_box, relu=False)
    im_info = b.const(np.asarray([hw * STRIDE, hw * STRIDE, 1.0], np.float32), "im_info")
    rois, roi_scores = b.proposal(probs, deltas, im_info,
                                  **dict(RPN, post_nms_topn=post))
    b.result(rois, "rois")
    b.result(roi_scores, "roi_scores")
    boxes = b.gather(rois, [1, 2, 3, 4], axis=1)
    bidx = b.convert(b.reshape(b.gather(rois, [0], axis=1), (post,)), "i32")
    pooled = b.roi_align(x, boxes, bidx, 7, 7, sampling_ratio=2, spatial_scale=1.0 / STRIDE)
    head = _conv(b, pooled, w_head, b_head, stride=2, pad=1)      # (R, head_c, 4, 4)
    feat = b.reduce("mean", head, (2, 3), keep_dims=False)
    cls = b.add(b.matmul(feat, b.const(w_fc)), b.const(b_fc))
    b.result(cls, "cls_score")
    b.result(b.softmax(cls, axis=1), "cls_prob")
    b.result(b.add(b.matmul(feat, b.const(w_bb)), b.const(b_bb)), "bbox_pred")

    def inputs(rng, n):
        return _features(rng, n, c, hw)
    return Recipe(inputs)


def single_shot(b, rng, batch, width) -> Recipe:
    c, hw, _, head_c, _, classes = detector_sizes(width)
    image = hw * STRIDE
    w6_1, b6_1 = _he(rng, (c, c, 1, 1)), _f32(rng.standard_normal(c) * 0.1)
    w6_2, b6_2 = _he(rng, (head_c, c, 3, 3)), _f32(rng.standard_normal(head_c) * 0.1)
    x = b.parameter("features", (batch, c, hw, hw))
    conv6 = _conv(b, _conv(b, x, w6_1, b6_1), w6_2, b6_2, stride=2, pad=1)
    locs, confs, priors, n_priors = [], [], [], 0
    for fmap, ch, grid, step, pb in ((x, c, hw, STRIDE, SSD_PRIORS[0]),
                                     (conv6, head_c, (hw + 1) // 2, 2 * STRIDE, SSD_PRIORS[1])):
        n_pri = 2 + 2 * len(pb["aspect_ratio"])   # min, sqrt(min·max), each ratio flipped
        n_priors += n_pri * grid * grid
        w_loc = _f32(rng.standard_normal((4 * n_pri, ch, 3, 3)) * 0.1 / np.sqrt(9 * ch))
        w_conf = _f32(rng.standard_normal((classes * n_pri, ch, 3, 3)) * 1.5
                      / np.sqrt(9 * ch * 0.5))
        b_conf = np.zeros((n_pri, classes), np.float32)
        b_conf[:, 0] = BACKGROUND_LEAD
        for head, w, bias, out in ((locs, w_loc, np.zeros(4 * n_pri, np.float32), 4),
                                   (confs, w_conf, b_conf.reshape(-1), classes)):
            y = _conv(b, fmap, w, bias, pad=1, relu=False)
            head.append(b.reshape(b.transpose(y, (0, 2, 3, 1)), (batch, -1)))
        priors.append(b.unsqueeze(b.prior_box(
            (grid, grid), (image, image), flip=True, clip=False, step=float(step),
            offset=0.5, variance=SSD_VARIANCE, **pb), (0,)))
    loc = b.concat(locs, axis=1)
    conf = b.concat(confs, axis=1)
    conf = b.reshape(b.softmax(b.reshape(conf, (batch, n_priors, classes)), axis=2),
                     (batch, n_priors * classes))
    b.result(loc, "mbox_loc")
    b.result(conf, "mbox_conf")
    b.result(b.detection_output(loc, conf, b.concat(priors, axis=2), classes, keep_top_k=200,
                                nms_threshold=0.45, confidence_threshold=0.01),
             "detections")

    def inputs(rng, n):
        return _features(rng, n, c, hw)
    return Recipe(inputs)


RECIPES = {f.__name__: f for f in (activations, binary_logical, reduce_norm, layout,
                                    gather_scatter, heads, lstm_stream, two_stage,
                                    single_shot)}

# the op types each recipe covers: each of the 75 of ops/extended.py and the
# five of the state and detector ops exactly once
COVERS = {
    "activations": ("Sqrt", "Tanh", "Erf", "Log", "Abs", "Negative", "Floor", "Ceiling",
                    "Sin", "Cos", "Tan", "Asin", "Acos", "Atan", "Sinh", "Cosh", "Asinh",
                    "Acosh", "Atanh", "Sign", "Round", "Elu", "SoftPlus", "HSwish",
                    "HSigmoid", "Mish", "HardSigmoid", "LogSoftmax", "Selu", "SoftSign"),
    "binary_logical": ("Minimum", "Power", "FloorMod", "Mod", "SquaredDifference", "Equal",
                       "NotEqual", "Greater", "Less", "LessEqual", "LogicalAnd", "LogicalOr",
                       "LogicalXor", "LogicalNot", "Select"),
    "reduce_norm": ("ReduceMax", "ReduceMin", "ReduceProd", "ReduceL1", "ReduceL2",
                    "ReduceLogicalAnd", "ReduceLogicalOr", "NormalizeL2",
                    "BatchNormInference", "GroupNormalization"),
    "layout": ("Squeeze", "Pad", "DepthToSpace", "SpaceToDepth", "SpaceToBatch",
               "BatchToSpace", "ShuffleChannels", "Broadcast", "Range", "ReverseSequence",
               "CumSum", "OneHot"),
    "gather_scatter": ("GatherND", "GatherElements", "ScatterNDUpdate",
                       "ScatterElementsUpdate", "EmbeddingBagOffsetsSum"),
    "heads": ("TopK", "Einsum", "CTCGreedyDecoder"),
    "lstm_stream": ("ReadValue", "Assign"),
    "two_stage": ("Proposal", "ROIAlign"),
    "single_shot": ("PriorBox",),
}
# the recipes of the variable state and the detector ops
STATE_AND_DETECTION = ("lstm_stream", "two_stage", "single_shot")


def build(builder_cls, name, width=FULL_WIDTH, batch=1, seed=0):
    """(model, Recipe) of recipe ``name`` built with ``builder_cls`` (a
    GraphBuilder class) from ``seed``."""
    b = builder_cls(name)
    recipe = RECIPES[name](b, np.random.default_rng(seed), batch, width)
    return b.build(), recipe
