"""Six graph recipes that drive the op types no in-repo family uses through
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
    classes) posteriors; TopK's four modes on a Parameter.

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


RECIPES = {f.__name__: f for f in (activations, binary_logical, reduce_norm, layout,
                                    gather_scatter, heads)}

# the op types each recipe covers (every one of the 75 exactly once)
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
}


def build(builder_cls, name, width=FULL_WIDTH, batch=1, seed=0):
    """(model, Recipe) of recipe ``name`` built with ``builder_cls`` (a
    GraphBuilder class) from ``seed``."""
    b = builder_cls(name)
    recipe = RECIPES[name](b, np.random.default_rng(seed), batch, width)
    return b.build(), recipe
