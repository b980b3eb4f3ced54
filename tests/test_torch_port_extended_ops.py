"""Slice 3's ops in the port against the JAX package: LRN, ReduceMean and
Swish (``emit`` against the JAX package's ``emit`` on the CPU and its numpy
``ref_compute``, float32 at rtol 1e-5; the port's ``ref_compute`` equal to
the JAX package's bit for bit), LRN's int8-stored input, the ceil-mode pools
of ``googlenet_shapes``, and the port's EfficientNet-B0 IR and weights
against ``tools/gen_efficientnet.py``.

Inputs are made with numpy from a seed and handed to both packages."""

import os
import types

import numpy as np
import pytest
import torch

import pyopenvino_tpu.ir.model as jax_ir
from pyopenvino_tpu.ops import get_op as jax_get_op
from pyopenvino_tpu.ops.spec import TValue as JaxTValue

import pyopenvino_tpu_torch.ir.model as port_ir
from pyopenvino_tpu_torch import IECore
from pyopenvino_tpu_torch.ir import read_ir_model
from pyopenvino_tpu_torch.models import efficientnet_b0
from pyopenvino_tpu_torch.ops import get_op
from pyopenvino_tpu_torch.ops.spec import TValue
from pyopenvino_tpu_torch.passes.shape_infer import infer_shapes
import test_torch_port_threads  # noqa: F401  (this worker's torch threads)

RTOL = 1e-5
TRAINED = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "assets", "trained")
GOOGLENET = tuple(os.path.join(TRAINED, f"googlenet_shapes.{e}") for e in ("xml", "bin"))
SHAPES_RESNET = tuple(os.path.join(TRAINED, f"shapes_resnet.{e}") for e in ("xml", "bin"))


def _nodes(op_type, attrs):
    kw = dict(id=0, name="n", op_type=op_type, attrs=attrs, inputs={}, outputs={0: None})
    return port_ir.Node(**kw), jax_ir.Node(**kw)


def _ctxs(static=None):
    """(port ctx, JAX ctx): the JAX one lowers as on the CPU (interpret)."""
    import jax.numpy as jnp

    static_value = lambda node, port: static  # noqa: E731
    port = types.SimpleNamespace(static_value=static_value, compute_dtype=torch.float32)
    jax_ctx = types.SimpleNamespace(
        compute_dtype=jnp.float32, use_pallas=False, pallas_interpret=True,
        static_value=static_value, out_int8_scale=lambda node: None)
    return port, jax_ctx


def _port_tv(x, act_scale=None):
    t = torch.from_numpy(x)
    if t.dim() == 4:
        t = t.contiguous(memory_format=torch.channels_last)
    return TValue(t, act_scale=act_scale)


def _jax_tv(x, act_scale=None):
    import jax.numpy as jnp

    if x.ndim == 4:
        return JaxTValue(jnp.asarray(x.transpose(0, 2, 3, 1)), "CL", act_scale=act_scale)
    return JaxTValue(jnp.asarray(x), "L", act_scale=act_scale)


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _both(op_type, attrs, x, static=None, act_scale=None):
    """(port emit, JAX emit, port ref_compute, JAX ref_compute) as NCHW
    numpy arrays; ``static`` is input port 1's compile-time value."""
    node, jnode = _nodes(op_type, attrs)
    pctx, jctx = _ctxs(static)
    ins = {0: _port_tv(x, act_scale)}
    jins = {0: _jax_tv(x, act_scale)}
    got = get_op(op_type).emit(pctx, node, ins)[0]
    want = jax_get_op(op_type).emit(jctx, jnode, jins)[0]
    assert got.act_scale is None and got.arr.dtype == torch.float32
    deq = x.astype(np.float32) * act_scale if act_scale is not None else x
    ref_in = {0: deq} if static is None else {0: deq, 1: static}
    ref = get_op(op_type).ref_compute(node, ref_in)[0]
    jref = jax_get_op(op_type).ref_compute(jnode, ref_in)[0]
    return got.arr.numpy(), np.asarray(want.nchw()), ref, jref


# -- LRN ------------------------------------------------------------------

def _lrn_attrs(alpha, beta, bias, size):
    return {"alpha": str(alpha), "beta": str(beta), "bias": str(bias), "size": str(size),
            "region": "across"}


LRN_CASES = [
    ((2, 16, 7, 9), 1e-4, 0.75, 1.0, 5),   # googlenet_shapes' LRNs
    ((1, 5, 4, 4), 0.01, 0.6, 2.0, 3),     # another beta
    ((2, 3, 5, 6), 0.001, 0.75, 1.0, 5),   # the window wider than C
    ((1, 64, 3, 3), 2e-5, 0.75, 1.0, 4),   # even size: C − 2 … C + 2
]


@pytest.mark.parametrize("shape,alpha,beta,bias,size", LRN_CASES)
def test_lrn_matches_jax(shape, alpha, beta, bias, size):
    """After a ReLU the inputs are non-negative and reach tens; at α = 1e-4
    the window term α·Σx² is then of the order of the bias."""
    x = np.random.default_rng(size + shape[1]).uniform(0, 60, shape).astype(np.float32)
    got, want, ref, jref = _both("LRN", _lrn_attrs(alpha, beta, bias, size), x)
    assert got.shape == want.shape == shape
    np.testing.assert_array_equal(ref, jref)
    assert _rel_err(got, want) <= RTOL
    assert _rel_err(got, ref) <= RTOL


def test_lrn_is_not_torch_local_response_norm():
    """torch's local_response_norm divides α by ``size`` (and averages the
    window), so it is another function at the IR's α."""
    x = np.random.default_rng(0).uniform(0, 60, (1, 16, 4, 4)).astype(np.float32)
    got, _, ref, _ = _both("LRN", _lrn_attrs(1e-4, 0.75, 1.0, 5), x)
    theirs = torch.nn.functional.local_response_norm(
        torch.from_numpy(x), 5, alpha=1e-4, beta=0.75, k=1.0).numpy()
    assert _rel_err(theirs, ref) > 1e-2
    assert _rel_err(got, ref) <= RTOL


@pytest.mark.parametrize("act_scale,out_scale", [(0.3, 0.25), (1.0, 0.02)])
def test_lrn_int8_input_matches_jax_codes(act_scale, out_scale):
    """An int8-stored input is dequantized on read; requantized at one
    storage scale, the port's output gives the JAX package's codes."""
    import jax.numpy as jnp

    codes = np.random.default_rng(7).integers(0, 128, (2, 16, 6, 5)).astype(np.int8)
    got, want, ref, _ = _both("LRN", _lrn_attrs(1e-4, 0.75, 1.0, 5), codes,
                              act_scale=act_scale)
    assert _rel_err(got, want) <= RTOL and _rel_err(got, ref) <= RTOL
    mine = TValue.quantize(torch.from_numpy(got), out_scale).numpy()
    theirs = np.asarray(JaxTValue.quantize(jnp.asarray(want), out_scale))
    np.testing.assert_array_equal(mine, theirs)
    assert np.abs(mine.astype(int)).max() > 10  # codes, not all zero


# -- ReduceMean -----------------------------------------------------------

@pytest.mark.parametrize("keep", [True, False])
@pytest.mark.parametrize("axes", [(2, 3), (-1, -2), (1,), (-3,), (0, 2)])
def test_reduce_mean_matches_jax(axes, keep):
    from pyopenvino_tpu.ops.extended import ReduceMean as JaxReduceMean

    x = np.random.default_rng(len(axes)).standard_normal((2, 8, 7, 5)).astype(np.float32)
    static = np.asarray(axes, np.int64)
    attrs = {"keep_dims": "true" if keep else "false"}
    got, want, ref, jref = _both("ReduceMean", attrs, x, static=static)
    assert got.shape == want.shape == ref.shape
    np.testing.assert_array_equal(ref, jref)
    assert _rel_err(got, want) <= RTOL
    assert _rel_err(got, ref) <= RTOL
    # shape inference, with the value folded when the input is constant
    node, jnode = _nodes("ReduceMean", attrs)
    res = get_op("ReduceMean").infer_shapes(node, {0: x.shape, 1: static.shape},
                                            {0: x, 1: static})
    jres = JaxReduceMean().infer_shapes(jnode, {0: x.shape, 1: static.shape},
                                        {0: x, 1: static})
    assert res.shapes == jres.shapes
    np.testing.assert_array_equal(res.values[0], jres.values[0])


def test_reduce_mean_refusals():
    node, _ = _nodes("ReduceMean", {"keep_dims": "true"})
    op = get_op("ReduceMean")
    with pytest.raises(ValueError, match="out of range"):
        op.infer_shapes(node, {0: (1, 4, 3, 3), 1: (1,)}, {1: np.asarray([4])})
    with pytest.raises(ValueError, match="not constant"):
        op.infer_shapes(node, {0: (1, 4, 3, 3), 1: (1,)}, {1: None})


# -- Swish ----------------------------------------------------------------

@pytest.mark.parametrize("beta", [None, 1.0, 0.5, 1.702])
def test_swish_matches_jax(beta):
    x = (np.random.default_rng(3).standard_normal((2, 6, 5, 4)) * 6).astype(np.float32)
    attrs = {} if beta is None else {"beta": str(beta)}
    got, want, ref, jref = _both("Swish", attrs, x)
    np.testing.assert_array_equal(ref, jref)
    assert _rel_err(got, want) <= RTOL
    assert _rel_err(got, ref) <= RTOL
    b = 1.0 if beta is None else beta
    np.testing.assert_allclose(got, x / (1 + np.exp(-b * x.astype(np.float64))),
                               rtol=1e-5, atol=1e-6)


# -- ceil-mode pools -------------------------------------------------------

def _pool_inputs():
    """(name, NCHW input shape) of every pool of googlenet_shapes."""
    model = read_ir_model(GOOGLENET[0], None)
    analysis = infer_shapes(model)
    return [(n.name, analysis.shape(*model.in_edges[n.id][0])) for n in model
            if n.op_type in ("MaxPool", "AvgPool")]


GOOGLENET_POOLS = _pool_inputs()


def test_googlenet_pools_are_ceil_mode():
    from pyopenvino_tpu_torch.ops.padding import pool_padding

    model = read_ir_model(GOOGLENET[0], None)
    pools = [n for n in model if n.op_type in ("MaxPool", "AvgPool")]
    assert [n.op_type for n in pools].count("MaxPool") == 13 and len(pools) == 14
    assert all(n.attrs["rounding_type"] == "ceil" for n in pools)
    # the stem's 3×3/s2 at 112² gives 56² by one padded row and column
    names = dict(GOOGLENET_POOLS)
    stem = next(n for n in pools if names[n.name][2] == 112)
    pad = pool_padding(stem.attrs, (112, 112))
    assert (pad.out_h, pad.out_w) == (56, 56) and pad.pads == ((0, 1), (0, 1))


@pytest.mark.parametrize("name,shape", GOOGLENET_POOLS, ids=[n for n, _ in GOOGLENET_POOLS])
def test_googlenet_ceil_pools_match_jax(name, shape):
    """Each pool at its input shape (batch 2): MaxPool equal to the JAX
    package's bit for bit, float32 and on int8 codes (the exact carry);
    AvgPool within 1e-6; both ``ref_compute`` equal."""
    model = read_ir_model(GOOGLENET[0], None)
    from pyopenvino_tpu.ir import read_ir_model as jax_read

    node = model.find_by_name(name)
    jnode = jax_read(GOOGLENET[0], None).find_by_name(name)
    rng = np.random.default_rng(len(name))
    shape = (2,) + tuple(shape[1:])
    x = rng.standard_normal(shape).astype(np.float32)
    pctx, jctx = _ctxs()
    got = get_op(node.op_type).emit(pctx, node, {0: _port_tv(x)})[node.out_port].arr.numpy()
    want = np.asarray(jax_get_op(node.op_type).emit(
        jctx, jnode, {0: _jax_tv(x)})[jnode.out_port].nchw())
    ref = get_op(node.op_type).ref_compute(node, {0: x})[node.out_port]
    np.testing.assert_array_equal(ref, jax_get_op(node.op_type).ref_compute(
        jnode, {0: x})[jnode.out_port])
    assert got.shape == want.shape == ref.shape
    if node.op_type == "MaxPool":
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, ref)
        codes = rng.integers(-127, 128, shape).astype(np.int8)
        out = get_op("MaxPool").emit(pctx, node, {0: _port_tv(codes, 0.1)})[node.out_port]
        jout = jax_get_op("MaxPool").emit(jctx, jnode, {0: _jax_tv(codes, 0.1)})[jnode.out_port]
        assert out.act_scale == jout.act_scale == 0.1 and out.arr.dtype == torch.int8
        np.testing.assert_array_equal(out.arr.numpy(), np.asarray(jout.nchw()))
    else:
        assert _rel_err(got, want) <= 1e-6 and _rel_err(got, ref) <= 1e-6


# -- the IRs the slice serves ---------------------------------------------

@pytest.fixture(scope="module")
def generated_efficientnet(tmp_path_factory):
    """The IR ``tools/gen_efficientnet.py`` writes, in a private directory."""
    from pyopenvino_tpu.ir.writer import write_ir_model
    from tools.gen_efficientnet import build_efficientnet_b0

    xml = str(tmp_path_factory.mktemp("efficientnet-b0") / "efficientnet-b0.xml")
    write_ir_model(build_efficientnet_b0(), xml)
    return xml, xml[:-4] + ".bin"


def test_efficientnet_b0_ir_and_weights_match_the_generator(generated_efficientnet, tmp_path):
    xml, binp = generated_efficientnet
    with open(xml, "rb") as f, open(efficientnet_b0.EFFICIENTNET_B0_XML, "rb") as g:
        assert f.read() == g.read()
    with open(xml, encoding="utf-8") as f:
        blob = efficientnet_b0.generate_weights(f.read(), seed=0)
    with open(binp, "rb") as f:
        want = f.read()
    assert len(blob) == len(want) == 21034016
    assert blob == want
    # another seed gives other weights in the same layout
    with open(xml, encoding="utf-8") as f:
        other = efficientnet_b0.generate_weights(f.read(), seed=1)
    assert len(other) == len(blob) and other != blob


def test_efficientnet_b0_topology_and_synth_refusal():
    from pyopenvino_tpu_torch.models import synth

    xml, binp = efficientnet_b0.efficientnet_b0_paths()
    model = read_ir_model(xml, binp)
    counts = {t: len(model.find_by_type(t)) for t in
              ("ReduceMean", "Swish", "GroupConvolution", "Sigmoid", "Convolution")}
    assert counts == {"ReduceMean": 17, "Swish": 49, "GroupConvolution": 16,
                      "Sigmoid": 16, "Convolution": 65}
    params = sum(n.const.size for n in model.find_by_type("Const")
                 if np.issubdtype(n.const.dtype, np.floating))
    assert params == 5258200
    # the generic synthesizer has no role for the ReduceMean axes
    with pytest.raises(NotImplementedError, match="Reshape"):
        synth.generate_weights(read_ir_model(xml, None))


@pytest.mark.parametrize("paths", [GOOGLENET, SHAPES_RESNET, "efficientnet_b0"])
def test_port_accepts_the_slice_irs(paths):
    if paths == "efficientnet_b0":
        paths = efficientnet_b0.efficientnet_b0_paths()
    ie = IECore()
    net = ie.read_network(*paths)
    ie.check_nodes(net)
    exe = ie.load_network(net, "CPU")
    p = net.model.parameters[0]
    x = np.random.default_rng(0).uniform(0, 255, p.outputs[p.out_port].shape)
    out = next(iter(exe.infer({p.name: x.astype(np.float32)}).values()))
    assert np.isfinite(out).all() and abs(float(out.sum()) - 1.0) < 1e-4
