"""The rest of ``ops/extended.py`` in the port against the JAX package: its
75 op types that no in-repo family uses, one case per type and attribute
mode.  In each case the same seeded numpy inputs go through

  * the port's ``emit`` on CPU tensors (4-D activations in channels_last
    memory) against the JAX op's ``emit`` (XLA on the CPU, 4-D activations
    stored NHWC): float32 within rtol 1e-5 of the largest value, integer,
    bool and data-movement outputs equal;
  * the port's ``ref_compute`` against the JAX package's, equal bit for bit
    and in dtype, and the port's ``emit`` against its own ``ref_compute``
    as the emits are held;
  * both ops' shape inference (shapes and folded values).

The bfloat16 cases run each activation formula (the ``_UnaryAttr`` ops,
HardSigmoid, Selu) in bfloat16 on both sides, XLA with
``--xla_allow_excess_precision=false`` in a subprocess (the flag is read
when XLA starts; ROADMAP.md §3 fault 5): equal bit for bit; LogSoftmax,
whose bfloat16 sum XLA takes in another order, within one bfloat16 step."""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import pyopenvino_tpu.ir.model as jax_ir
from pyopenvino_tpu.ops import get_op as jax_get_op
from pyopenvino_tpu.ops.spec import TValue as JaxTValue

import pyopenvino_tpu_torch.ir.model as port_ir
from pyopenvino_tpu_torch.ops import get_op, supported_ops
from pyopenvino_tpu_torch.ops.spec import TValue
import test_torch_port_threads  # noqa: F401  (this worker's torch threads)

RTOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

UNARY_MATH = ("Sqrt", "Tanh", "Erf", "Log", "Abs", "Negative", "Floor", "Ceiling", "Sin",
              "Cos", "Tan", "Asin", "Acos", "Atan", "Sinh", "Cosh", "Asinh", "Acosh",
              "Atanh", "Sign", "Round")
ACTIVATIONS = ("Elu", "SoftPlus", "HSwish", "HSigmoid", "Mish", "HardSigmoid", "LogSoftmax",
               "Selu", "SoftSign")
BINARY = ("Minimum", "Power", "FloorMod", "Mod", "SquaredDifference")
LOGIC = ("Equal", "NotEqual", "Greater", "Less", "LessEqual", "LogicalAnd", "LogicalOr",
         "LogicalXor", "LogicalNot", "Select")
REDUCTIONS = ("ReduceMax", "ReduceMin", "ReduceProd", "ReduceL1", "ReduceL2",
              "ReduceLogicalAnd", "ReduceLogicalOr")
NORMS = ("NormalizeL2", "BatchNormInference", "GroupNormalization")
LAYOUT = ("Squeeze", "Pad", "DepthToSpace", "SpaceToDepth", "SpaceToBatch", "BatchToSpace",
          "ShuffleChannels", "Broadcast", "Range", "ReverseSequence", "CumSum", "OneHot")
GATHER = ("GatherND", "GatherElements", "ScatterNDUpdate", "ScatterElementsUpdate",
          "EmbeddingBagOffsetsSum")
SELECTION = ("TopK", "Einsum", "CTCGreedyDecoder")
SLICE_OPS = (UNARY_MATH + ACTIVATIONS + BINARY + LOGIC + REDUCTIONS + NORMS + LAYOUT + GATHER
             + SELECTION)


def test_slice_ops_are_registered():
    assert len(SLICE_OPS) == len(set(SLICE_OPS)) == 75
    assert set(SLICE_OPS) <= set(supported_ops())
    from pyopenvino_tpu.ops import REGISTRY as JAX_REGISTRY

    # the state and detector ops (tests/test_torch_port_{state,roi}.py)
    # complete the registry
    assert len(supported_ops()) == 133
    assert set(JAX_REGISTRY) == set(supported_ops())


# -- the harness -----------------------------------------------------------------------

def _nodes(op_type, attrs, n_in, n_out):
    kw = dict(id=0, name="n", op_type=op_type, attrs=dict(attrs),
              inputs={p: port_ir.TensorInfo((), np.dtype(np.float32)) for p in range(n_in)},
              outputs={n_in + i: port_ir.TensorInfo((), np.dtype(np.float32))
                       for i in range(n_out)})
    jkw = dict(kw, inputs={p: jax_ir.TensorInfo((), np.dtype(np.float32)) for p in range(n_in)},
               outputs={n_in + i: jax_ir.TensorInfo((), np.dtype(np.float32))
                        for i in range(n_out)})
    return port_ir.Node(**kw), jax_ir.Node(**jkw)


def _port_tv(x):
    t = torch.from_numpy(np.array(x))
    if t.dim() == 4:
        t = t.contiguous(memory_format=torch.channels_last)
    return TValue(t)


def _jax_tv(x):
    import jax.numpy as jnp

    x = np.asarray(x)
    if x.ndim == 4:
        return JaxTValue(jnp.asarray(x.transpose(0, 2, 3, 1)), "CL")
    return JaxTValue(jnp.asarray(x), "L")


def run_both(op_type, attrs, ins, n_out=1):
    """{port: (port emit, JAX emit, port ref_compute, JAX ref_compute)} of
    ``op_type`` on the inputs ``ins`` ({port: ndarray}), each a numpy array
    in logical layout; every input is also its port's compile-time value."""
    import jax.numpy as jnp

    node, jnode = _nodes(op_type, attrs, max(ins) + 1, n_out)
    static = lambda n, port: ins[port]  # noqa: E731
    pctx = types.SimpleNamespace(static_value=static, compute_dtype=torch.float32)
    jctx = types.SimpleNamespace(static_value=static, compute_dtype=jnp.float32,
                                 use_pallas=False, pallas_interpret=True,
                                 out_int8_scale=lambda n: None)
    got = get_op(op_type).emit(pctx, node, {p: _port_tv(a) for p, a in ins.items()})
    want = jax_get_op(op_type).emit(jctx, jnode, {p: _jax_tv(a) for p, a in ins.items()})
    ref = get_op(op_type).ref_compute(node, dict(ins))
    jref = jax_get_op(op_type).ref_compute(jnode, dict(ins))
    assert sorted(got) == sorted(want) == sorted(ref) == sorted(jref)
    return {p: (got[p].arr.numpy(), np.asarray(want[p].nchw()), ref[p], jref[p])
            for p in sorted(got)}


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.size == 0:
        return 0.0
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def check(op_type, attrs, ins, exact=False, n_out=1):
    """The emits within RTOL (``exact``: equal), the port's emit against its
    ref_compute likewise, the two ref_computes equal in value and dtype, and
    both shape inferences equal on the inputs' shapes and values."""
    outs = run_both(op_type, attrs, ins, n_out)
    for p, (got, want, ref, jref) in outs.items():
        assert got.shape == want.shape == ref.shape, (op_type, p)
        assert ref.dtype == jref.dtype, (op_type, p)
        np.testing.assert_array_equal(ref, jref)
        if exact or not np.issubdtype(ref.dtype, np.floating):
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got, ref)
        else:
            assert _rel_err(got, want) <= RTOL, (op_type, p, _rel_err(got, want))
            assert _rel_err(got, ref) <= RTOL, (op_type, p, _rel_err(got, ref))
    node, jnode = _nodes(op_type, attrs, max(ins) + 1, n_out)
    shapes = {p: tuple(np.shape(a)) for p, a in ins.items()}
    res = get_op(op_type).infer_shapes(node, shapes, dict(ins))
    jres = jax_get_op(op_type).infer_shapes(jnode, shapes, dict(ins))
    assert res.shapes == jres.shapes == {p: v[0].shape for p, v in outs.items()}
    assert sorted(res.values) == sorted(jres.values)
    for p in res.values:
        np.testing.assert_array_equal(res.values[p], jres.values[p])
    return outs


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(seed, shape, scale=1.0):
    return (_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _grid(seed, shape, lo=-4, hi=4):
    """Half-integers and integers: every .5 tie and the zeros."""
    return (_rng(seed).integers(2 * lo, 2 * hi + 1, shape) / 2).astype(np.float32)


# -- 1. unary math -------------------------------------------------------------------

SHAPE4 = (2, 6, 5, 4)
UNARY_INPUTS = {
    "Sqrt": lambda: np.abs(_normal(1, SHAPE4)) + 0.01,
    "Log": lambda: np.abs(_normal(2, SHAPE4)) + 0.01,
    "Tan": lambda: _rng(3).uniform(-1.4, 1.4, SHAPE4).astype(np.float32),
    "Asin": lambda: _rng(4).uniform(-0.99, 0.99, SHAPE4).astype(np.float32),
    "Acos": lambda: _rng(5).uniform(-0.99, 0.99, SHAPE4).astype(np.float32),
    "Atanh": lambda: _rng(6).uniform(-0.95, 0.95, SHAPE4).astype(np.float32),
    "Acosh": lambda: _rng(7).uniform(1.01, 5.0, SHAPE4).astype(np.float32),
    "Sinh": lambda: _normal(8, SHAPE4, 3.0),
    "Cosh": lambda: _normal(9, SHAPE4, 3.0),
}
DISCONTINUOUS = ("Floor", "Ceiling", "Sign", "Round")


@pytest.mark.parametrize("op", [o for o in UNARY_MATH if o != "Round"])
def test_unary_math_matches_jax(op):
    x = UNARY_INPUTS.get(op, lambda: _normal(10, SHAPE4, 2.0))()
    if op in DISCONTINUOUS:
        x = _grid(11, SHAPE4)
    check(op, {}, {0: x}, exact=op in DISCONTINUOUS + ("Abs", "Negative"))


@pytest.mark.parametrize("mode", [None, "half_to_even", "half_away_from_zero"])
def test_round_matches_jax(mode):
    """Every .5 tie on both sides of zero, as the JAX test's golden does."""
    x = np.concatenate([_grid(12, (2, 40)), np.asarray(
        [[-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 1.2, -1.2] * 5] * 2, np.float32)], axis=1)
    outs = check("Round", {} if mode is None else {"mode": mode}, {0: x}, exact=True)
    got = outs[1][0][0, 40:48]
    if mode == "half_away_from_zero":
        np.testing.assert_array_equal(got, [-3, -2, -1, 1, 2, 3, 1, -1])
    else:
        np.testing.assert_array_equal(got, [-2, -2, -0.0, 0.0, 2, 2, 1, -1])


@pytest.mark.parametrize("op", ["Floor", "Ceiling"])
def test_floor_ceiling_keep_integers(op):
    """An integer tensor passes unchanged, as ``jnp.floor`` returns it."""
    x = _rng(13).integers(-9, 9, (3, 7)).astype(np.int32)
    node, jnode = _nodes(op, {}, 1, 1)
    got = get_op(op).emit(None, node, {0: _port_tv(x)})[1].arr
    want = jax_get_op(op).emit(None, jnode, {0: _jax_tv(x)})[1].arr
    assert got.dtype == torch.int32 and np.asarray(want).dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- 2. activations ----------------------------------------------------------------

ACT_CASES = [
    ("Elu", {}), ("Elu", {"alpha": "0.5"}), ("SoftPlus", {}), ("HSwish", {}),
    ("HSigmoid", {}), ("Mish", {}), ("SoftSign", {}),
]


@pytest.mark.parametrize("op,attrs", ACT_CASES)
def test_activation_matches_jax(op, attrs):
    x = np.concatenate([_normal(20, (2, 6, 5, 4), 4.0), _grid(21, (2, 6, 5, 4), -6, 6)], axis=1)
    check(op, attrs, {0: x})


@pytest.mark.parametrize("alpha,beta", [(0.2, 0.5), (0.4, 0.3)])
def test_hard_sigmoid_matches_jax(alpha, beta):
    x = _normal(22, (3, 13), 4.0)
    outs = check("HardSigmoid", {}, {0: x, 1: np.float32(alpha), 2: np.float32(beta)})
    np.testing.assert_allclose(outs[3][0], np.clip(alpha * x + beta, 0, 1), rtol=1e-6)


def test_selu_matches_jax():
    x = _normal(23, (2, 9, 4, 3), 3.0)
    outs = check("Selu", {}, {0: x, 1: np.float32(1.6733), 2: np.float32(1.0507)})
    want = 1.0507 * np.where(x > 0, x, 1.6733 * (np.exp(x) - 1))
    np.testing.assert_allclose(outs[3][0], want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("axis", [None, "1", "-1", "0"])
def test_log_softmax_matches_jax(axis):
    x = _normal(24, (3, 7, 5), 20.0)
    outs = check("LogSoftmax", {} if axis is None else {"axis": axis}, {0: x})
    ax = 1 if axis is None else int(axis)
    np.testing.assert_allclose(np.exp(outs[1][0]).sum(axis=ax), 1.0, rtol=1e-5)


def test_log_softmax_over_a_4d_channels_last_tensor():
    x = _normal(25, (2, 16, 3, 3), 5.0)
    check("LogSoftmax", {"axis": "1"}, {0: x})


# -- 3. binary --------------------------------------------------------------------

@pytest.mark.parametrize("op", ["Minimum", "SquaredDifference", "FloorMod", "Mod"])
@pytest.mark.parametrize("kind", ["float", "int"])
def test_binary_matches_jax(op, kind):
    """numpy broadcast of a per-channel operand; the remainders with both
    signs of dividend and divisor and exact multiples."""
    if kind == "float":
        a = _normal(30, (2, 4, 3, 5), 5.0)
        b = np.where(np.abs(_normal(31, (1, 4, 1, 1))) < 0.3, 1.5, _normal(31, (1, 4, 1, 1), 3.0))
        b = b.astype(np.float32)
        a[0, :, 0, 0] = 3 * b.reshape(-1)  # exact multiples
    else:
        a = _rng(32).integers(-20, 21, (2, 4, 3, 5)).astype(np.int32)
        b = np.asarray([3, -4, 7, -1], np.int32).reshape(1, 4, 1, 1)
    check(op, {"auto_broadcast": "numpy"}, {0: a, 1: b}, exact=kind == "int")


@pytest.mark.parametrize("exp", [0.5, 2.0, 3.0, -1.5])
def test_power_matches_jax(exp):
    a = np.abs(_normal(33, (2, 4, 3, 5))) + 0.5
    check("Power", {}, {0: a, 1: np.full((1, 4, 1, 1), exp, np.float32)})


def test_binary_folds_on_constants():
    for op in BINARY:
        a, b = np.asarray([[1.5, -2.0, 4.0]], np.float32), np.asarray([2.0], np.float32)
        node, jnode = _nodes(op, {}, 2, 1)
        res = get_op(op).infer_shapes(node, {0: (1, 3), 1: (1,)}, {0: a, 1: b})
        jres = jax_get_op(op).infer_shapes(jnode, {0: (1, 3), 1: (1,)}, {0: a, 1: b})
        np.testing.assert_array_equal(res.values[2], jres.values[2])


# -- 4. comparison and logic ------------------------------------------------------------

@pytest.mark.parametrize("op", [o for o in LOGIC if o.startswith(("Equal", "Not", "Greater",
                                                                    "Less"))])
@pytest.mark.parametrize("kind", ["float", "int"])
def test_comparison_matches_jax(op, kind):
    """Many ties: small-range integers, or floats on a half-integer grid."""
    if kind == "int":
        a = _rng(40).integers(-3, 4, (2, 4, 3, 5)).astype(np.int32)
        b = _rng(41).integers(-3, 4, (1, 4, 1, 5)).astype(np.int32)
    else:
        a, b = _grid(42, (2, 4, 3, 5), -2, 2), _grid(43, (1, 4, 1, 5), -2, 2)
    outs = check(op, {"auto_broadcast": "numpy"}, {0: a, 1: b})
    assert outs[2][0].dtype == np.bool_


@pytest.mark.parametrize("op", ["LogicalAnd", "LogicalOr", "LogicalXor"])
def test_logical_matches_jax(op):
    a = _rng(44).integers(0, 2, (3, 4, 5)).astype(bool)
    b = _rng(45).integers(0, 2, (1, 4, 5)).astype(bool)
    outs = check(op, {}, {0: a, 1: b})
    assert outs[2][0].dtype == np.bool_


def test_logical_not_matches_jax():
    check("LogicalNot", {}, {0: _rng(46).integers(0, 2, (2, 3, 4, 5)).astype(bool)})


@pytest.mark.parametrize("kind", ["float", "int"])
def test_select_matches_jax(kind):
    cond = _rng(47).integers(0, 2, (2, 1, 3, 5)).astype(bool)
    if kind == "float":
        a, b = _normal(48, (2, 4, 3, 5)), _normal(49, (1, 4, 1, 1))
    else:
        a = _rng(48).integers(-9, 9, (2, 4, 3, 5)).astype(np.int32)
        b = np.full((1, 4, 1, 1), -1, np.int32)
    check("Select", {}, {0: cond, 1: a, 2: b}, exact=True)


# -- 5. reductions ----------------------------------------------------------------------

@pytest.mark.parametrize("op", ["ReduceMax", "ReduceMin", "ReduceProd", "ReduceL1", "ReduceL2"])
@pytest.mark.parametrize("axes", [(2, 3), (1,), (-1,), (0, 2)])
@pytest.mark.parametrize("keep", [True, False])
def test_reduction_matches_jax(op, axes, keep):
    x = _normal(50, (2, 6, 5, 4))
    if op == "ReduceProd":
        x = (1.0 + 0.2 * np.tanh(x)).astype(np.float32)
    check(op, {"keep_dims": "true" if keep else "false"},
          {0: x, 1: np.asarray(axes, np.int64)}, exact=op in ("ReduceMax", "ReduceMin"))


@pytest.mark.parametrize("op", ["ReduceLogicalAnd", "ReduceLogicalOr"])
@pytest.mark.parametrize("axes,keep", [((1,), False), ((1, 2), True), ((0,), True)])
def test_reduce_logical_matches_jax(op, axes, keep):
    x = _rng(51).integers(0, 4, (3, 4, 5)) > 0
    outs = check(op, {"keep_dims": "true" if keep else "false"},
                 {0: x, 1: np.asarray(axes, np.int64)})
    assert outs[2][0].dtype == np.bool_


def test_reduction_over_no_axis_is_identity():
    x = _normal(52, (2, 3, 4))
    for op in ("ReduceMax", "ReduceL1"):
        outs = check(op, {"keep_dims": "false"}, {0: x, 1: np.zeros((0,), np.int64)})
        np.testing.assert_array_equal(outs[2][2], outs[2][0])


# -- 6. normalization ---------------------------------------------------------------------

@pytest.mark.parametrize("eps_mode", ["add", "max"])
@pytest.mark.parametrize("axes", [(1,), (1, 2, 3), (-1,)])
def test_normalize_l2_matches_jax(eps_mode, axes):
    x = _normal(60, (2, 8, 5, 4))
    check("NormalizeL2", {"eps": "1e-6", "eps_mode": eps_mode},
          {0: x, 1: np.asarray(axes, np.int64)})


@pytest.mark.parametrize("shape", [(2, 4, 5, 5), (3, 6)])
def test_batch_norm_inference_matches_jax(shape):
    c = shape[1]
    rng = _rng(61)
    ins = {0: _normal(62, shape), 1: rng.uniform(0.5, 1.5, c).astype(np.float32),
           2: rng.standard_normal(c).astype(np.float32),
           3: rng.standard_normal(c).astype(np.float32),
           4: rng.uniform(0.5, 2.0, c).astype(np.float32)}
    check("BatchNormInference", {"epsilon": "1e-5"}, ins)


@pytest.mark.parametrize("groups,shape", [(3, (2, 6, 4, 4)), (32, (1, 64, 3, 3)), (2, (2, 4, 7))])
def test_group_normalization_matches_jax(groups, shape):
    c = shape[1]
    ins = {0: _normal(63, shape, 2.0), 1: _rng(64).uniform(0.5, 1.5, c).astype(np.float32),
           2: _normal(65, (c,))}
    check("GroupNormalization", {"num_groups": str(groups), "epsilon": "1e-5"}, ins)


# -- 7. layout and data -------------------------------------------------------------------

@pytest.mark.parametrize("axes", [None, (2,), (0, 2), (-2,)])
def test_squeeze_matches_jax(axes):
    x = _normal(70, (1, 4, 1, 6))
    ins = {0: x} if axes is None else {0: x, 1: np.asarray(axes, np.int64)}
    check("Squeeze", {}, ins, exact=True)


@pytest.mark.parametrize("mode", ["constant", "edge", "reflect", "symmetric"])
@pytest.mark.parametrize("pads", [((0, 0, 1, 2), (0, 0, 2, 1)), ((0, 2, 3, 1), (1, 1, 0, 3))])
def test_pad_matches_jax(mode, pads):
    """Pads on the channel and batch axes of a channels_last tensor too, and
    reflect and symmetric pads as wide as the axis."""
    x = _normal(71, (2, 3, 4, 5))
    ins = {0: x, 1: np.asarray(pads[0], np.int64), 2: np.asarray(pads[1], np.int64)}
    if mode == "constant":
        ins[3] = np.float32(-1.5)
    check("Pad", {"pad_mode": mode}, ins, exact=True)


def test_pad_constant_defaults_to_zero():
    x = _normal(72, (1, 2, 3, 3))
    outs = check("Pad", {}, {0: x, 1: np.asarray((0, 0, 1, 1), np.int64),
                             2: np.asarray((0, 0, 1, 1), np.int64)}, exact=True)
    assert outs[3][0][0, 0, 0, 0] == 0.0


@pytest.mark.parametrize("op", ["DepthToSpace", "SpaceToDepth"])
@pytest.mark.parametrize("mode", ["blocks_first", "depth_first"])
@pytest.mark.parametrize("block", [2, 3])
def test_block_spatial_matches_jax(op, mode, block):
    shape = (2, 9 * block * block, 3, 6) if op == "DepthToSpace" else (2, 5, 3 * block, 6 * block)
    check(op, {"block_size": str(block), "mode": mode}, {0: _normal(73, shape)}, exact=True)


@pytest.mark.parametrize("block,pb,pe", [((1, 1, 2, 4), (0, 0, 2, 0), (0, 0, 0, 4)),
                                         ((1, 2, 1, 3), (0, 1, 0, 1), (0, 1, 0, 0))])
def test_space_batch_matches_jax(block, pb, pe):
    x = _normal(74, (2, 2, 6, 8))
    outs = check("SpaceToBatch", {}, {0: x, 1: np.asarray(block, np.int64),
                                      2: np.asarray(pb, np.int64), 3: np.asarray(pe, np.int64)},
                 exact=True)
    s2b = outs[4][0]
    assert s2b.shape[0] == 2 * int(np.prod(block))
    outs = check("BatchToSpace", {}, {0: s2b, 1: np.asarray(block, np.int64),
                                      2: np.asarray(pb, np.int64), 3: np.asarray(pe, np.int64)},
                 exact=True)
    np.testing.assert_array_equal(outs[4][0], x)


@pytest.mark.parametrize("axis,group", [("1", "2"), ("1", "3"), ("-1", "2")])
def test_shuffle_channels_matches_jax(axis, group):
    x = _normal(75, (2, 12, 3, 4))
    outs = check("ShuffleChannels", {"axis": axis, "group": group}, {0: x}, exact=True)
    if axis == "1" and group == "2":
        want = x.reshape(2, 2, 6, 3, 4).transpose(0, 2, 1, 3, 4).reshape(x.shape)
        np.testing.assert_array_equal(outs[1][0], want)


@pytest.mark.parametrize("mode,shape,target,mapping", [
    ("numpy", (1, 3), (4, 3), None),
    ("numpy", (3, 1, 1), (2, 3, 4, 5), None),
    ("bidirectional", (2, 1, 3), (5, 1), None),
    ("explicit", (16,), (2, 16, 3), (1,)),
    ("explicit", (3, 4), (4, 3), (1, 0)),
    ("explicit", (4, 1), (2, 4, 3, 5), (1, 3)),
])
def test_broadcast_matches_jax(mode, shape, target, mapping):
    ins = {0: _normal(76, shape), 1: np.asarray(target, np.int64)}
    if mapping is not None:
        ins[2] = np.asarray(mapping, np.int64)
    check("Broadcast", {"mode": mode}, ins, exact=True)


@pytest.mark.parametrize("start,stop,step,otype", [(0, 4, 1, "f32"), (0, 10, 3, "i32"),
                                                   (-1.5, 2.5, 0.5, "f32"), (5, 0, -2, "i64")])
def test_range_matches_jax(start, stop, step, otype):
    ins = {i: np.asarray(v, np.float32) for i, v in enumerate((start, stop, step))}
    outs = check("Range", {"output_type": otype}, ins, exact=True)
    assert outs[3][2].dtype == {"f32": np.float32, "i32": np.int32, "i64": np.int64}[otype]


@pytest.mark.parametrize("ba,sa,shape", [(0, 1, (2, 5, 3)), (1, 0, (5, 3, 2)),
                                         (0, 2, (3, 2, 6, 2))])
def test_reverse_sequence_matches_jax(ba, sa, shape):
    x = _normal(77, shape)
    lens = _rng(78).integers(0, shape[sa] + 1, shape[ba]).astype(np.int32)
    check("ReverseSequence", {"batch_axis": str(ba), "seq_axis": str(sa)}, {0: x, 1: lens},
          exact=True)


@pytest.mark.parametrize("exclusive", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("kind", ["float", "int"])
def test_cumsum_matches_jax(exclusive, reverse, kind):
    x = (_normal(79, (2, 5, 4, 3)) if kind == "float"
         else _rng(79).integers(-50, 50, (2, 5, 4, 3)).astype(np.int32))
    attrs = {"exclusive": "1" if exclusive else "0", "reverse": "1" if reverse else "0"}
    check("CumSum", attrs, {0: x, 1: np.asarray(1, np.int64)}, exact=kind == "int")


def test_cumsum_axis_defaults_to_zero():
    x = _normal(80, (4, 3))
    outs = check("CumSum", {}, {0: x})
    np.testing.assert_allclose(outs[1][0], np.cumsum(x, axis=0), rtol=1e-6)


@pytest.mark.parametrize("axis", ["-1", "0", "1"])
@pytest.mark.parametrize("kind", ["float", "int"])
def test_one_hot_matches_jax(axis, kind):
    """Out-of-range and negative indices give off everywhere."""
    idx = _rng(81).integers(-1, 6, (2, 3, 4)).astype(np.int32)
    dt = np.float32 if kind == "float" else np.int32
    check("OneHot", {"axis": axis}, {0: idx, 1: np.asarray(5, np.int64),
                                     2: np.asarray(2, dt), 3: np.asarray(-1, dt)})


# -- 8. gather and scatter ---------------------------------------------------------------

@pytest.mark.parametrize("bd,dshape,ishape,opset", [
    (0, (4, 5, 6), (3, 2), None), (0, (4, 5, 6), (2, 3, 3), None),
    (1, (2, 5, 6), (2, 4, 1), None), (2, (2, 3, 5, 6), (2, 3, 4, 1), None),
    (2, (2, 3, 5, 6), (2, 3, 4, 1), "opset5"), (1, (3, 4, 5, 2), (3, 2, 2), "opset5"),
])
def test_gather_nd_matches_jax(bd, dshape, ishape, opset):
    """batch_dims 0, 1 and 2, negative indices, and an opset5 layer's
    flattened batch (tests/test_ops_extended.py:1246)."""
    rng = _rng(90)
    k = ishape[-1]
    hi = np.asarray(dshape[bd:bd + k])
    idx = (rng.integers(0, 1 << 20, ishape) % hi).astype(np.int32)
    idx[..., 0] -= (rng.integers(0, 2, ishape[:-1]) * hi[0]).astype(np.int32)
    attrs = {"batch_dims": str(bd)}
    if opset:
        attrs["_opset"] = opset
    outs = check("GatherND", attrs, {0: _normal(91, dshape), 1: idx}, exact=True)
    if opset and bd:
        assert outs[2][0].shape[0] == int(np.prod(ishape[:bd]))


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_gather_elements_matches_jax(axis):
    data = _normal(92, (3, 5, 4))
    shape = list(data.shape)
    shape[axis] = 2
    idx = _rng(93).integers(-data.shape[axis], data.shape[axis], shape).astype(np.int32)
    check("GatherElements", {"axis": str(axis)}, {0: data, 1: idx}, exact=True)


@pytest.mark.parametrize("ishape,kind", [((2, 1), "float"), ((3, 2), "float"), ((2, 2), "int")])
def test_scatter_nd_update_matches_jax(ishape, kind):
    """Distinct indices (the duplicate case is unspecified: ROADMAP.md §3)."""
    data = (_normal(94, (4, 3, 5)) if kind == "float"
            else _rng(94).integers(-9, 9, (4, 3, 5)).astype(np.int32))
    k = ishape[-1]
    flat = _rng(95).permutation(int(np.prod(data.shape[:k])))[:ishape[0]]
    idx = np.stack(np.unravel_index(flat, data.shape[:k]), axis=-1).astype(np.int32)
    upd = _normal(96, ishape[:-1] + data.shape[k:]).astype(data.dtype)
    check("ScatterNDUpdate", {}, {0: data, 1: idx, 2: upd}, exact=True)


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_scatter_elements_update_matches_jax(axis):
    data = _normal(97, (3, 5, 4))
    shape = list(data.shape)
    shape[axis] = 2
    # distinct along the axis at every other position
    perm = np.argsort(_rng(98).random(tuple(shape[:axis % 3]) + (data.shape[axis],)
                                      + tuple(shape[axis % 3 + 1:])), axis=axis)
    idx = np.take(perm, np.arange(2), axis=axis).astype(np.int32)
    check("ScatterElementsUpdate", {},
          {0: data, 1: idx, 2: _normal(99, shape), 3: np.asarray(axis, np.int64)}, exact=True)


@pytest.mark.parametrize("default,weights", [(False, False), (True, False), (True, True)])
def test_embedding_bag_offsets_sum_matches_jax(default, weights):
    """An empty bag (the default_index row or zeros) and per-sample
    weights, as tests/test_ops_extended.py:1683 builds them."""
    table = _normal(100, (10, 4))
    ins = {0: table, 1: np.asarray([0, 2, 2, 5, 9], np.int32),
           2: np.asarray([0, 2, 2, 4], np.int32)}
    if default:
        ins[3] = np.asarray(7, np.int32)
    if weights:
        ins[4] = _rng(101).uniform(0.5, 1.5, 5).astype(np.float32)
    outs = check("EmbeddingBagOffsetsSum", {}, ins)
    got = next(iter(outs.values()))[0]
    np.testing.assert_array_equal(got[1], table[7] if default else 0.0)


# -- 9. selection and decoding -------------------------------------------------------------

@pytest.mark.parametrize("mode", ["max", "min"])
@pytest.mark.parametrize("sort", ["value", "index"])
@pytest.mark.parametrize("kind,axis", [("int", "-1"), ("float", "1"), ("grid", "-1")])
def test_top_k_matches_jax(mode, sort, kind, axis):
    """Ties resolve to the lower index (small-range integers and a
    half-integer grid give many)."""
    shape = (3, 12, 5) if axis == "1" else (4, 20)
    x = {"int": lambda: _rng(110).integers(-3, 4, shape).astype(np.int32),
         "float": lambda: _normal(111, shape),
         "grid": lambda: _grid(112, shape, -2, 2)}[kind]()
    attrs = {"axis": axis, "mode": mode, "sort": sort, "index_element_type": "i32"}
    outs = check("TopK", attrs, {0: x, 1: np.asarray(4, np.int64)}, exact=True, n_out=2)
    idx = outs[3][0]
    assert idx.dtype == np.int32
    if sort == "value" and kind != "float":
        x2 = np.moveaxis(x, int(axis), -1)
        key = -x2 if mode == "max" else x2
        want = np.argsort(key, axis=-1, kind="stable")[..., :4]
        np.testing.assert_array_equal(np.moveaxis(idx, int(axis), -1), want)


def test_top_k_i64_indices():
    x = _grid(113, (2, 9))
    node, _ = _nodes("TopK", {"axis": "1", "index_element_type": "i64"}, 2, 2)
    ctx = types.SimpleNamespace(static_value=lambda n, p: np.asarray(3, np.int64))
    out = get_op("TopK").emit(ctx, node, {0: _port_tv(x), 1: _port_tv(np.asarray(3))})
    assert out[3].arr.dtype == torch.int64
    ref = get_op("TopK").ref_compute(node, {0: x, 1: np.asarray(3)})
    assert ref[3].dtype == np.int64
    np.testing.assert_array_equal(out[3].arr.numpy(), ref[3])


@pytest.mark.parametrize("eq,shapes", [
    ("bhqd,bhkd->bhqk", [(1, 4, 8, 6), (1, 4, 8, 6)]),
    ("bhqk,bhkd->bhqd", [(2, 4, 8, 8), (2, 4, 8, 6)]),
    ("ij,jk", [(3, 5), (5, 4)]),
    ("...ij,...jk->...ik", [(2, 1, 3, 5), (4, 5, 2)]),
    ("ii", [(5, 5)]),
    ("bqd, bkd -> bqk", [(2, 4, 8), (2, 5, 8)]),
])
def test_einsum_matches_jax(eq, shapes):
    ins = {i: _normal(120 + i, s) for i, s in enumerate(shapes)}
    check("Einsum", {"equation": eq}, ins)


@pytest.mark.parametrize("merge", [None, "1", "0"])
def test_ctc_greedy_decoder_matches_jax(merge):
    """The JAX test's hand-built sequences (merged repeats, blanks, a masked
    tail), then seeded posteriors on a small integer grid (ties: the first
    maximum)."""
    T, N, C = 6, 2, 4
    probs = np.zeros((T, N, C), np.float32)
    for t, c in enumerate([0, 0, 3, 0, 1, 1]):
        probs[t, 0, c] = 1.0
    for t, c in enumerate([1, 3, 3, 2, 0, 0]):
        probs[t, 1, c] = 1.0
    mask = np.ones((T, N), np.float32)
    mask[4:, 1] = 0.0
    attrs = {} if merge is None else {"ctc_merge_repeated": merge}
    outs = check("CTCGreedyDecoder", attrs, {0: probs, 1: mask}, exact=True)
    got = outs[2][0][..., 0, 0]
    if merge == "0":
        np.testing.assert_array_equal(got[0], [0, 0, 0, 1, 1, -1])
    else:
        np.testing.assert_array_equal(got[0], [0, 0, 1, -1, -1, -1])
        np.testing.assert_array_equal(got[1], [1, 2, -1, -1, -1, -1])
    probs = _rng(130).integers(0, 3, (24, 5, 27)).astype(np.float32)
    mask = (np.arange(24)[:, None] < _rng(131).integers(10, 25, 5)[None, :]).astype(np.float32)
    check("CTCGreedyDecoder", attrs, {0: probs, 1: mask}, exact=True)


# -- bfloat16 --------------------------------------------------------------------------------

BF16_CASES = [(op, attrs) for op, attrs in ACT_CASES] + [
    ("Round", {"mode": "half_away_from_zero"}), ("Sign", {}), ("Sin", {}), ("Atan", {}),
    ("HardSigmoid", {}), ("Selu", {}), ("LogSoftmax", {"axis": "1"})]

_BF16_SCRIPT = r"""
import json, sys, types
import numpy as np
import jax, jax.numpy as jnp
import ml_dtypes
import pyopenvino_tpu.ir.model as jax_ir
from pyopenvino_tpu.ops import get_op
from pyopenvino_tpu.ops.spec import TValue
cases = json.loads(sys.argv[1])
x = np.load(sys.argv[2])
out = {}
for i, (op, attrs) in enumerate(cases):
    ins = {0: TValue(jnp.asarray(x).astype(jnp.bfloat16), "L")}
    statics = {}
    if op == "HardSigmoid":
        statics = {1: np.float32(0.2), 2: np.float32(0.5)}
    if op == "Selu":
        statics = {1: np.float32(1.6733), 2: np.float32(1.0507)}
    info = jax_ir.TensorInfo((), np.dtype(np.float32))
    n_in = 1 + len(statics)
    node = jax_ir.Node(id=0, name="n", op_type=op, attrs=attrs,
                       inputs={p: info for p in range(n_in)}, outputs={n_in: info})
    ctx = types.SimpleNamespace(static_value=lambda n, p: statics[p], compute_dtype=jnp.bfloat16)
    res = get_op(op).emit(ctx, node, ins)[n_in].arr
    out[str(i)] = np.asarray(res.astype(jnp.float32))
np.savez(sys.argv[3], **out)
"""


@pytest.fixture(scope="module")
def jax_bf16(tmp_path_factory):
    """The JAX emits of BF16_CASES on bfloat16 inputs, XLA started with
    --xla_allow_excess_precision=false (a subprocess: the flag is read once)."""
    d = tmp_path_factory.mktemp("bf16")
    x = np.concatenate([_normal(140, (4, 64), 4.0), _grid(141, (4, 64), -8, 8),
                        _normal(142, (4, 64), 0.3)], axis=1)
    np.save(d / "x.npy", x)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS=os.environ.get("XLA_FLAGS", "") + " --xla_allow_excess_precision=false")
    script = d / "jax_bf16.py"
    script.write_text(_BF16_SCRIPT)
    subprocess.run([sys.executable, str(script), json.dumps(BF16_CASES), str(d / "x.npy"),
                    str(d / "out.npz")], check=True, env=env, cwd=REPO, timeout=600)
    with np.load(d / "out.npz") as f:
        return x, {int(k): f[k] for k in f.files}


@pytest.mark.parametrize("case", range(len(BF16_CASES)))
def test_activation_formulas_bf16_equal_jax(jax_bf16, case):
    """Each step rounded to bfloat16 on both sides: equal bit for bit; the
    LogSoftmax steps (XLA sums the bf16 exps in its own order) within one
    bfloat16 step of the JAX emit."""
    x, want = jax_bf16
    op, attrs = BF16_CASES[case]
    statics = {"HardSigmoid": {1: np.float32(0.2), 2: np.float32(0.5)},
               "Selu": {1: np.float32(1.6733), 2: np.float32(1.0507)}}.get(op, {})
    n_in = 1 + len(statics)
    node, _ = _nodes(op, attrs, n_in, 1)
    ctx = types.SimpleNamespace(static_value=lambda n, p: statics[p],
                                compute_dtype=torch.bfloat16)
    got = get_op(op).emit(ctx, node, {0: TValue(torch.from_numpy(x).to(torch.bfloat16))})
    got = got[n_in].arr
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    if op == "LogSoftmax":
        step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want[case]), 1e-30))) - 7)
        assert (np.abs(got - want[case]) <= step).all()
    else:
        np.testing.assert_array_equal(got, want[case])


# -- the float32 bits against XLA's (ROADMAP.md §3, fault 9) -----------------------------

BIT_DOMAINS = {"Tan": (-1.4, 1.4), "Asin": (-0.99, 0.99), "Acos": (-0.99, 0.99),
               "Atanh": (-0.95, 0.95), "Acosh": (1.01, 5.0), "Sqrt": (0.01, 5.0),
               "Log": (0.01, 5.0)}
BIT_OPS = ("Sqrt", "Tanh", "Erf", "Log", "Sin", "Cos", "Tan", "Asin", "Acos", "Atan", "Sinh",
           "Cosh", "Asinh", "Acosh", "Atanh", "Elu", "SoftPlus", "Mish", "SoftSign", "HSwish",
           "HSigmoid", "LogSoftmax")


def bit_differences(op, n):
    """(share of n uniform float32 inputs on which the port's emit and the
    JAX emit differ in any bit, the largest difference in ulps, the largest
    relative to the output's largest value)."""
    lo, hi = BIT_DOMAINS.get(op, (-6.0, 6.0))
    x = _rng(150).uniform(lo, hi, (64, n // 64)).astype(np.float32)
    got, want, _, _ = run_both(op, {}, {0: x})[1]
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    return float((got != want).mean()), int(ulps.max()), _rel_err(got, want)


@pytest.mark.parametrize("op", BIT_OPS)
def test_float32_bits_within_rtol_of_xla(op):
    """The libraries' float32 transcendentals differ in the last bits on a
    share of inputs (``python tests/test_torch_port_ops_extended3.py``
    prints it); the piecewise formulas of exact steps not at all."""
    share, _, rel = bit_differences(op, 1 << 14)
    assert rel <= RTOL
    if op in ("SoftSign", "HSwish", "HSigmoid"):
        assert share == 0.0


if __name__ == "__main__":
    for name in BIT_OPS:
        share, ulps, rel = bit_differences(name, 1 << 20)
        print(f"{name:10s} bits differ on {100 * share:6.2f} % of 2^20 inputs, "
              f"at most {ulps} ulps, {rel:.2e} of the largest output")
