"""INT8-FULL in the port against the JAX package: the int8 × int8 fused_gemm
and conv2d_direct (plain versions on the CPU) against exact integer sums and
the Pallas kernels in interpret mode, the ops' int8 routes, the int8 storage
analysis, bias correction, and full-width ResNet-18 end to end.

Inputs are made with numpy from a seed and handed to both packages."""

import types

import numpy as np
import pytest
import torch

import pyopenvino_tpu.ir.model as jax_ir
from pyopenvino_tpu.config import Backend as JaxBackend
from pyopenvino_tpu.config import Config as JaxConfig
from pyopenvino_tpu.config import QuantMode as JaxQuantMode
from pyopenvino_tpu.ir import read_ir_model as jax_read
from pyopenvino_tpu.runtime.compiler import compile_model as jax_compile

import pyopenvino_tpu_torch.ir.model as port_ir
from pyopenvino_tpu_torch.config import Backend, Config, QuantMode
from pyopenvino_tpu_torch.ir import read_ir_model
from pyopenvino_tpu_torch.kernels import conv_direct, gemm
from pyopenvino_tpu_torch.kernels.conv import (
    conv2d_fused, conv_weight_matrix, conv_weight_matrix_nk,
)
from pyopenvino_tpu_torch.models.synth import resnet18_paths
from pyopenvino_tpu_torch.ops import conv as conv_ops
from pyopenvino_tpu_torch.ops import matmul as matmul_ops
from pyopenvino_tpu_torch.runtime.compiler import CompiledNetwork, compile_model
import test_torch_port_threads  # noqa: F401  (this worker's torch threads)

# The float32 epilogue of the interpreted Pallas kernels is XLA's, which
# contracts acc·scale + bias into one fused multiply-add: one rounding where
# the port (kernel and plain version alike) rounds twice.  1e-6 of the
# output's largest magnitude covers that last bit.
EPILOGUE_RTOL = 1e-6


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _codes(rng, shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


def _t(v):
    return None if v is None else torch.from_numpy(v)


# -- int8 × int8 fused_gemm ------------------------------------------------

@pytest.mark.parametrize("m,k,n,lda,use_bias,act", [
    (200, 147, 64, 147, True, ("relu", 0.0, 0.0)),   # ResNet-18's 7×7 stem, K = 147
    (50, 27, 32, 27, True, ("clamp", 0.0, 6.0)),     # MobileNet-v2's stem, K = 27
    (1, 512, 1000, 512, True, None),                 # ResNet-18's classifier, M = 1
    (49, 2304, 512, 2304, False, ("relu", 0.0, 0.0)),
    (37, 70, 129, 96, False, None),                  # lda > K, N odd
])
def test_i8i8_fused_gemm_plain_exact(m, k, n, lda, use_bias, act):
    """The int32 sum equals numpy's int64 product exactly; the float32
    output equals the JAX package's kernel (interpret) to the last bit of
    its epilogue."""
    import jax.numpy as jnp

    from pyopenvino_tpu.kernels.gemm import fused_gemm as jax_fused_gemm

    rng = np.random.default_rng(m + k + n)
    a_full = _codes(rng, (m, lda))
    a = a_full[:, :k]
    b = _codes(rng, (k, n))
    scale = rng.uniform(1e-4, 1e-2, n).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32) if use_bias else None

    at = torch.from_numpy(a_full)[:, :k]
    assert at.stride() == (lda, 1)
    acc = gemm.matmul_int32(at, torch.from_numpy(b))
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), a.astype(np.int64) @ b.astype(np.int64))

    b_kmajor = torch.from_numpy(np.ascontiguousarray(b.T)).t()  # as the kernel takes it
    got = gemm.fused_gemm(at, b_kmajor, _t(scale), _t(bias), act)  # CPU: plain
    assert got.dtype == torch.float32 and got.shape == (m, n)
    torch.testing.assert_close(
        got, gemm.epilogue(acc.float(), _t(scale), _t(bias), act), rtol=0, atol=0)
    want = np.asarray(jax_fused_gemm(
        jnp.asarray(np.ascontiguousarray(a)), jnp.asarray(b), scale=jnp.asarray(scale),
        bias=None if bias is None else jnp.asarray(bias), act=act, interpret=True))
    assert _rel_err(got.numpy(), want) <= EPILOGUE_RTOL


def test_i8i8_fused_gemm_refusals():
    a = torch.zeros((2, 3), dtype=torch.int8)
    with pytest.raises(ValueError, match="dequant scale"):
        gemm.fused_gemm(a, torch.zeros((3, 4), dtype=torch.int8))
    with pytest.raises(ValueError, match="int8 a needs an int8 b"):
        gemm.fused_gemm(a, torch.zeros((3, 4)), torch.ones(4))


# -- conv2d_direct ----------------------------------------------------------

@pytest.mark.parametrize("n,h,w,ci,co,kh,kw,pads,act", [
    # tests/test_pallas.py's TestDirectConv shapes, then Ci = 3 with
    # asymmetric pads and a ResNet-18 layer1 conv
    (2, 14, 14, 8, 16, 3, 3, ((1, 1), (1, 1)), ("relu", 0.0, 0.0)),
    (1, 9, 9, 3, 5, 3, 3, ((0, 0), (0, 0)), None),
    (2, 8, 8, 16, 32, 5, 5, ((2, 2), (2, 2)), ("clamp", 0.0, 6.0)),
    (2, 9, 11, 3, 7, 3, 3, ((0, 2), (1, 0)), None),
    (1, 56, 56, 64, 64, 3, 3, ((1, 1), (1, 1)), ("relu", 0.0, 0.0)),
])
def test_conv2d_direct_plain_exact(n, h, w, ci, co, kh, kw, pads, act):
    """The int32 sum equals lax.conv_general_dilated's int32 accumulator
    exactly; the float32 output equals the JAX package's kernel
    (interpret) to the last bit of its epilogue."""
    import jax.numpy as jnp
    from jax import lax

    from pyopenvino_tpu.kernels.conv_direct import conv2d_direct as jax_conv2d_direct

    rng = np.random.default_rng(ci + co + h)
    x = _codes(rng, (n, h, w, ci))
    wt = _codes(rng, (co, ci, kh, kw))
    scale = rng.uniform(1e-4, 1e-2, co).astype(np.float32)
    bias = rng.standard_normal(co).astype(np.float32)

    acc_want = np.asarray(lax.conv_general_dilated(
        jnp.asarray(x), jnp.transpose(jnp.asarray(wt), (2, 3, 1, 0)), (1, 1), pads,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))
    # the plain version's accumulator: its output with unit scale, no bias
    acc = conv_direct.conv2d_direct_plain(
        torch.from_numpy(x), torch.from_numpy(wt), torch.ones(co), pads=pads)
    np.testing.assert_array_equal(acc.numpy(), acc_want.astype(np.float32))

    # the K-major weight matrix the compiled network caches and the kernel takes
    wmat = conv_weight_matrix_nk(torch.from_numpy(wt)).t()
    got = conv_direct.conv2d_direct(torch.from_numpy(x), torch.from_numpy(wt),
                                    _t(scale), _t(bias), act, pads, wmat=wmat)  # CPU: plain
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert torch.equal(got, conv_direct.conv2d_direct(
        torch.from_numpy(x), torch.from_numpy(wt), _t(scale), _t(bias), act, pads))
    want = np.asarray(jax_conv2d_direct(
        jnp.asarray(x), jnp.asarray(wt), scale=jnp.asarray(scale),
        bias=jnp.asarray(bias), act=act, pads=pads, interpret=True))
    assert got.shape == want.shape
    assert _rel_err(got.numpy(), want) <= EPILOGUE_RTOL


def test_conv2d_direct_refusals():
    """Mixed or unsupported dtypes and an int8 weight without its scale are
    refused; float32 activations take the float variant (kernel 3f)."""
    x = torch.zeros((1, 4, 4, 2), dtype=torch.int8)
    w = torch.zeros((3, 2, 3, 3), dtype=torch.int8)
    with pytest.raises(ValueError, match="int8 x with an int8 w"):
        conv_direct.conv2d_direct(x, w.float(), torch.ones(3))
    with pytest.raises(ValueError, match="int8 x with an int8 w"):
        conv_direct.conv2d_direct(x.double(), w.double())
    with pytest.raises(ValueError, match="int8 x with an int8 w"):
        conv_direct.conv2d_direct(x.float(), w.half())
    with pytest.raises(ValueError, match="scale"):
        conv_direct.conv2d_direct(x, w, None)
    with pytest.raises(ValueError, match="scale"):
        conv_direct.conv2d_direct(x.float(), w, None)
    out = conv_direct.conv2d_direct(x.float(), w.float())
    assert out.shape == (1, 2, 2, 3) and out.dtype == torch.float32


@pytest.mark.parametrize("co", [1, 5])
def test_conv2d_direct_int8_refuses_row_major_wmat(co):
    """int8 x takes its weight matrix K-major, as the int8 tensor-core loop
    needs; a row-major (K, Co) matrix is refused on the CPU too, before any
    plain version runs.  float32 x keeps its row-major matrix."""
    rng = np.random.default_rng(co)
    x = torch.from_numpy(_codes(rng, (1, 6, 6, 4)))
    w = torch.from_numpy(_codes(rng, (co, 4, 3, 3)))
    scale, pads = torch.full((co,), 0.01), ((1, 1), (1, 1))
    k_major = conv_weight_matrix_nk(w).t()
    row_major = k_major.contiguous()
    assert torch.equal(row_major, conv_weight_matrix(w))
    want = conv_direct.conv2d_direct_plain(x, w, scale, pads=pads)
    assert torch.equal(conv_direct.conv2d_direct(x, w, scale, pads=pads, wmat=k_major), want)
    if co > 1:  # a (K, 1) matrix is both row-major and K-major
        with pytest.raises(ValueError, match="K-major"):
            conv_direct.conv2d_direct(x, w, scale, pads=pads, wmat=row_major)
    got = conv_direct.conv2d_direct(x.float(), w.float(), pads=pads, wmat=row_major.float())
    assert got.shape == (1, 6, 6, co)


def test_resnet18_direct_convs_cache_the_k_major_operand(resnet18_case):
    """The compiled ResNet-18 INT8-FULL network on KERNELS caches, for each
    of its 13 conv2d_direct convs, the (Co, K) K-major copy and no (K, Co)
    one; every routed conv and the classifier hold one cached int8 operand
    the size of their weight, 11678912 bytes in all, as before the int8
    direct convs moved onto the tensor cores."""
    net, _ = resnet18_case.port(Backend.KERNELS)
    direct = [n for n in net.model.find_by_type("Convolution")
              if conv_ops._conv_attrs(n) == ((1, 1), (1, 1))
              and net.model.nodes[net.model.in_edges[n.id][1][0]].const.shape[2:] == (3, 3)]
    assert len(direct) == 13
    tags = {key: tag for key, tag, _ in net._derived}
    for node in direct:
        key = str(net.model.in_edges[node.id][1][0])
        assert tags[key] == "gemm_nk"
        co, ci, kh, kw = net.weights[key].shape
        assert net._derived[(key, "gemm_nk", torch.int8)].shape == (co, kh * kw * ci)
    assert "gemm_kn" not in tags.values()
    for (key, _, dtype), t in net._derived.items():
        assert dtype == torch.int8 and t.is_contiguous()
        assert t.numel() == net.weights[key].numel()
    assert sum(t.numel() * t.element_size() for t in net._derived.values()) == 11678912


def test_conv2d_fused_int8_patches():
    """conv2d_fused on int8 codes: int8 patches into the int8 × int8 GEMM,
    equal to the exact convolution at a 3×3/s2 shape."""
    rng = np.random.default_rng(3)
    x, wt = _codes(rng, (2, 15, 14, 16)), _codes(rng, (24, 16, 3, 3))
    scale = torch.from_numpy(rng.uniform(1e-4, 1e-2, 24).astype(np.float32))
    got = conv2d_fused(torch.from_numpy(x), torch.from_numpy(wt), scale=scale,
                       strides=(2, 2), pads=((1, 1), (1, 1)))
    acc = gemm.conv2d_int32(torch.from_numpy(x).permute(0, 3, 1, 2),
                            torch.from_numpy(wt), (2, 2), (1, 1), ((1, 1), (1, 1)))
    want = gemm.epilogue(acc.permute(0, 2, 3, 1).float(), scale)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# -- the ops' int8 routes: int32 accumulators against the JAX ops ---------

def _nodes(op_type, attrs, out_port):
    kw = dict(id=0, name="n", op_type=op_type, attrs=attrs, inputs={},
              outputs={out_port: None})
    return port_ir.Node(**kw), jax_ir.Node(**kw)


def _port_ctx(use_kernels, weight):
    return types.SimpleNamespace(
        use_kernels=use_kernels, full_int8=True, act_scale=lambda node: None,
        compute_dtype=torch.float32,
        derived_weight=lambda node, port, tag, make: make(weight))


def _jax_ctx():
    import jax.numpy as jnp

    return types.SimpleNamespace(
        compute_dtype=jnp.float32, use_pallas=False, pallas_interpret=True,
        full_int8=True, act_scale=lambda node: None, config=None)


def _conv_attrs(s, p):
    return {"strides": f"{s},{s}", "pads_begin": f"{p},{p}", "pads_end": f"{p},{p}",
            "dilations": "1,1"}


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("op_type,x_shape,w_shape,attrs", [
    ("Convolution", (2, 64, 14, 14), (128, 64, 1, 1), _conv_attrs(2, 0)),   # 1×1/s2
    ("Convolution", (2, 64, 14, 14), (128, 64, 3, 3), _conv_attrs(2, 1)),   # 3×3/s2
    ("Convolution", (1, 3, 32, 32), (64, 3, 7, 7), _conv_attrs(2, 3)),      # 7×7/s2 stem
    ("Convolution", (2, 32, 9, 9), (32, 32, 3, 3), _conv_attrs(1, 1)),      # conv_direct
    ("GroupConvolution", (2, 16, 9, 9), (16, 1, 1, 3, 3), _conv_attrs(2, 1)),
])
def test_int8_conv_routes_exact_int32(op_type, x_shape, w_shape, attrs, use_kernels):
    """The same stored int8 codes (act_scale 1) and unit weight scales: the
    op's output is its int32 accumulator as float32 (|sum| < 2^24), which
    must equal the JAX op's exactly, on both backends."""
    import jax.numpy as jnp

    from pyopenvino_tpu.ops import get_op as jax_get_op
    from pyopenvino_tpu.ops.spec import TValue as JaxTValue

    from pyopenvino_tpu_torch.ops import TValue, get_op

    node, jnode = _nodes(op_type, attrs, 2)
    rng = np.random.default_rng(sum(w_shape))
    x, wq = _codes(rng, x_shape), _codes(rng, w_shape)
    qscale = np.ones((w_shape[0],) + (1,) * (len(w_shape) - 1), np.float32)
    if op_type == "GroupConvolution":
        qscale = np.ones(w_shape[:2] + (1, 1, 1), np.float32)
    want = jax_get_op(op_type).emit_fused(_jax_ctx(), jnode, {
        0: JaxTValue(jnp.asarray(x.transpose(0, 2, 3, 1)), "CL", act_scale=1.0),
        1: JaxTValue(jnp.asarray(wq), "L", qscale=jnp.asarray(qscale))})[2].nchw()
    xt = torch.from_numpy(x).contiguous(memory_format=torch.channels_last)
    got = get_op(op_type).emit_fused(
        _port_ctx(use_kernels, torch.from_numpy(wq)), node,
        {0: TValue(xt, act_scale=1.0), 1: TValue(torch.from_numpy(wq), qscale=_t(qscale))})[2]
    assert got.act_scale is None and got.arr.dtype == torch.float32
    np.testing.assert_array_equal(got.arr.numpy(), np.asarray(want))


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("a_shape,w_shape,tb", [
    ((2, 512), (512, 1000), False), ((3, 40), (24, 40), True)])
def test_int8_matmul_routes_exact_int32(a_shape, w_shape, tb, use_kernels):
    import jax.numpy as jnp

    from pyopenvino_tpu.ops import get_op as jax_get_op
    from pyopenvino_tpu.ops.spec import TValue as JaxTValue

    from pyopenvino_tpu_torch.ops import TValue, get_op

    attrs = {"transpose_a": "false", "transpose_b": str(tb).lower()}
    node, jnode = _nodes("MatMul", attrs, 2)
    rng = np.random.default_rng(sum(a_shape))
    a, wq = _codes(rng, a_shape), _codes(rng, w_shape)
    qscale = np.ones((w_shape[0], 1) if tb else (1, w_shape[1]), np.float32)
    want = jax_get_op("MatMul").emit_fused(_jax_ctx(), jnode, {
        0: JaxTValue(jnp.asarray(a), "L", act_scale=1.0),
        1: JaxTValue(jnp.asarray(wq), "L", qscale=jnp.asarray(qscale))})[2].arr
    bmat = torch.from_numpy(wq)
    got = get_op("MatMul").emit_fused(
        _port_ctx(use_kernels, bmat), node,
        {0: TValue(torch.from_numpy(a), act_scale=1.0),
         1: TValue(bmat, qscale=_t(qscale))})[2].arr
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- full-width ResNet-18 ----------------------------------------------------

def logits_model(model, ir):
    """``model`` with its SoftMax cut out: the Result reads the logits.
    The JAX package captures a node only in an unfused program without int8
    storage, so its logits are read this way instead."""
    sm = model.find_by_type("SoftMax")[0]
    src, sport = model.in_edges[sm.id][0]
    edges = [ir.Edge(src, sport, e.dst, e.dst_port) if e.src == sm.id else e
             for e in model.edges if e.dst != sm.id]
    return ir.Model(model.name, {k: v for k, v in model.nodes.items() if k != sm.id},
                    edges)


def xla_fma_epilogue(monkeypatch):
    """Make the port's INT8 epilogue round acc·scale + bias once, as XLA's
    fused multiply-add does (float64 holds the product of an int32 sum and
    a float32 scale exactly).  With it the port reproduces the JAX
    package's INT8-FULL logits bit for bit, which shows that the epilogue's
    rounding is the only difference between the two."""
    plain = gemm.epilogue

    def fma(acc, scale=None, bias=None, act=None):
        if scale is None or bias is None:
            return plain(acc, scale, bias, act)
        return gemm.apply_act((acc.double() * scale.double() + bias.double()).float(), act)

    for module in (gemm, conv_direct, conv_ops, matmul_ops):
        monkeypatch.setattr(module, "epilogue", fma)


# One flipped int8 code moves every later activation it reaches by a scale
# step, and with the port's two roundings against XLA's one, ties are met:
# over four seeds on these models the logits differed from the JAX
# package's by up to 2.3e-2 of max |logit| where a code flipped and by
# under 1e-7 where none did (both pairs of backends), with the same top-1.
# At the cases below: ResNet-18 (image seed 3) 1.042e-2 TORCH vs XLA and
# 9.122e-3 KERNELS vs PALLAS; MobileNet-v2 (image seed 0) 1.429e-3 and
# 1.508e-3.  A 1e-3 limit would not hold for the shipped epilogue, so the
# gate that holds the port to the JAX package is the bit equality under
# XLA's rounding (xla_fma_epilogue); this limit only bounds the flips.
FLIP_RTOL = 5e-2


class Int8FullCase:
    """One model's INT8-FULL comparison on one image: both packages compile
    the logits model from the same 2 calibration samples; the JAX outputs
    are taken once per backend.  Inputs are uniform in [0, ``high``) at the
    model's one Parameter; ``config`` holds further Config fields that both
    packages share (``bias_correction``)."""

    def __init__(self, paths, seed, high=1.0, **config):
        self.model = logits_model(read_ir_model(*paths), port_ir)
        param = self.model.parameters[0]
        self.out = self.model.results[0].name
        shape = param.outputs[param.out_port].shape
        rng = np.random.default_rng(seed)
        self.samples = [{param.name: rng.uniform(0, high, shape).astype(np.float32)}
                        for _ in range(2)]
        self.x = {param.name: rng.uniform(0, high, shape).astype(np.float32)}
        self.config = config
        jax_model = logits_model(jax_read(*paths), jax_ir)
        self.jax_scales, self.want = {}, {}
        for be in (JaxBackend.XLA, JaxBackend.PALLAS):
            net = jax_compile(
                jax_model, JaxConfig(backend=be, quant=JaxQuantMode.INT8_FULL, **config),
                calibration_samples=self.samples)
            self.jax_scales[be] = net.act_scales
            self.want[be] = net.infer(self.x)[self.out]

    def port(self, backend):
        net = compile_model(
            self.model, Config(backend=backend, quant=QuantMode.INT8_FULL, **self.config),
            device="cpu", calibration_samples=self.samples)
        return net, net.infer(self.x)[self.out]


BACKEND_PAIRS = [(Backend.TORCH, JaxBackend.XLA), (Backend.KERNELS, JaxBackend.PALLAS)]


@pytest.fixture(scope="module")
def resnet18_case():
    return Int8FullCase(resnet18_paths(seed=0), seed=3)


def check_int8full_case(case, backend, jax_backend, monkeypatch):
    net, got = case.port(backend)
    assert net.act_scales == case.jax_scales[jax_backend]
    want = case.want[jax_backend]
    err = _rel_err(got, want)
    print(f"{backend.value} vs {jax_backend.value}: logits max rel err {err:.3e} "
          f"(limit {FLIP_RTOL})")
    assert err <= FLIP_RTOL
    assert (got.argmax(1) == want.argmax(1)).all()
    xla_fma_epilogue(monkeypatch)
    np.testing.assert_array_equal(net.infer(case.x)[case.out], want)


@pytest.mark.parametrize("backend,jax_backend", BACKEND_PAIRS)
def test_resnet18_int8full_matches_jax(resnet18_case, backend, jax_backend, monkeypatch):
    check_int8full_case(resnet18_case, backend, jax_backend, monkeypatch)


def test_resnet18_kernels_route_counts(resnet18_case, monkeypatch):
    """8 int8 × int8 fused_gemm calls (the 7×7 stem, three 3×3/s2 convs,
    three 1×1/s2 shortcuts, the classifier) and 13 conv2d_direct calls per
    forward, at the shapes chip_smoke.py checks and times."""
    import chip_smoke

    seen = {"gemm": [], "direct": []}
    plain_gemm, plain_direct = gemm.fused_gemm_plain, conv_direct.conv2d_direct_plain

    def gemm_spy(a, b, *args, **kw):
        seen["gemm"].append((str(a.dtype), str(b.dtype), a.shape[0], tuple(b.shape)))
        return plain_gemm(a, b, *args, **kw)

    def direct_spy(x, w, *args, **kw):
        seen["direct"].append((tuple(x.shape), tuple(w.shape)))
        return plain_direct(x, w, *args, **kw)

    monkeypatch.setattr(gemm, "fused_gemm_plain", gemm_spy)
    monkeypatch.setattr(conv_direct, "conv2d_direct_plain", direct_spy)
    net, _ = resnet18_case.port(Backend.KERNELS)
    assert sorted(seen["gemm"]) == sorted(
        ("torch.int8", "torch.int8", m, (k, n))
        for m, k, n, count in chip_smoke.i8i8_gemms("resnet18", 1) for _ in range(count))
    assert sorted(seen["direct"]) == sorted(
        ((1, hw, hw, c), (c, c, 3, 3))
        for hw, c, count in chip_smoke.RESNET18_DIRECT for _ in range(count))
    assert net._int8_edges == {}


def _int8_edge_models():
    """{name: ((xml, bin), input high)}: the two synthesized classifiers
    (inputs in [0, 1)), then slice 3's IRs (inputs in [0, 255))."""
    import os

    from pyopenvino_tpu_torch.models import efficientnet_b0, synth

    trained = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "assets", "trained")
    return {
        "resnet18": (lambda: synth.resnet18_paths(seed=0), 1.0),
        "mobilenet_v2": (lambda: synth.mobilenet_v2_paths(seed=0), 1.0),
        "efficientnet_b0": (lambda: efficientnet_b0.efficientnet_b0_paths(seed=0), 255.0),
        **{name: (lambda name=name: tuple(os.path.join(trained, f"{name}.{e}")
                                          for e in ("xml", "bin")), 255.0)
           for name in ("googlenet_shapes", "shapes_resnet")},
    }


@pytest.mark.parametrize("name", ["resnet18", "mobilenet_v2", "efficientnet_b0",
                                  "googlenet_shapes", "shapes_resnet"])
def test_int8_edges_match_jax(name):
    """The TORCH backend's int8 storage edges equal the JAX package's on
    XLA, fed the same weights and activation scales; KERNELS, like PALLAS,
    stores none.  On googlenet_shapes both LRNs take an int8-stored input
    (an accepter); on EfficientNet-B0 a tensor read by a Swish, a
    ReduceMean or the SE gate's Multiply stays float, and the Swish
    outputs that only convs read travel as int8."""
    from pyopenvino_tpu.runtime.compiler import CompiledNetwork as JaxCompiledNetwork
    from pyopenvino_tpu.runtime.compiler import prepare_model as jax_prepare

    make_paths, high = _int8_edge_models()[name]
    paths = make_paths()
    port_model = read_ir_model(*paths)
    param = port_model.parameters[0]
    x = np.random.default_rng(5).uniform(
        0, high, param.outputs[param.out_port].shape).astype(np.float32)
    config = JaxConfig(backend=JaxBackend.XLA, quant=JaxQuantMode.INT8_FULL)
    model, quantized, scales, _ = jax_prepare(jax_read(*paths), config, [{param.name: x}])
    want = JaxCompiledNetwork(model, config, quantized=quantized, act_scales=scales)._int8_edges
    for backend, expected in ((Backend.TORCH, want), (Backend.KERNELS, {})):
        net = CompiledNetwork(port_model, Config(backend=backend, quant=QuantMode.INT8_FULL),
                              device="cpu", quantized=quantized, act_scales=scales)
        assert net._int8_edges == expected
    print(f"{name}: {len(want)} int8-stored edges")
    assert len(want) == {"resnet18": 17, "mobilenet_v2": 43, "efficientnet_b0": 72,
                         "googlenet_shapes": 83, "shapes_resnet": 8}[name]
    if name == "googlenet_shapes":
        lrn_inputs = {port_model.in_edges[n.id][0] for n in port_model.find_by_type("LRN")}
        assert len(lrn_inputs) == 2 and lrn_inputs <= set(want)


# -- a narrow net: bias correction ------------------------------------------

def small_net(path, seed=0):
    """(xml, bin) of a narrow net with the routes and carries of the two
    full-width models: a 3×3/s2 stem, MaxPool, a residual block of stride-1
    3×3 convs, a depthwise conv with ReLU6, a 1×1 conv, the global AvgPool,
    Reshape, MatMul with bias, SoftMax."""
    from pyopenvino_tpu.ir.builder import GraphBuilder
    from pyopenvino_tpu.ir.writer import write_ir_model

    rng = np.random.default_rng(seed)
    b = GraphBuilder("small")

    def w(*shape):
        fan_in = int(np.prod(shape[-3:])) if len(shape) > 2 else shape[0]
        return b.const(rng.normal(0, np.sqrt(2.0 / fan_in), shape).astype(np.float32))

    def bias(shape):
        return b.const(rng.normal(0, 0.1, shape).astype(np.float32))

    pad1 = ((1, 1), (1, 1))
    x = b.parameter("data", (1, 3, 16, 16))
    y = b.relu(b.add(b.conv2d(x, w(8, 3, 3, 3), strides=(2, 2), pads=pad1), bias((1, 8, 1, 1))))
    y = b.max_pool(y, kernel=(3, 3), strides=(1, 1), pads=pad1)
    z = b.relu(b.add(b.conv2d(y, w(8, 8, 3, 3), pads=pad1), bias((1, 8, 1, 1))))
    z = b.add(b.conv2d(z, w(8, 8, 3, 3), pads=pad1), bias((1, 8, 1, 1)))
    y = b.relu(b.add(y, z))
    y = b.clamp(b.add(b.group_conv2d(y, w(8, 1, 1, 3, 3), pads=pad1), bias((1, 8, 1, 1))),
                0.0, 6.0)
    y = b.relu(b.add(b.conv2d(y, w(16, 8, 1, 1)), bias((1, 16, 1, 1))))
    y = b.reshape(b.avg_pool(y, kernel=(8, 8), strides=(1, 1)), [1, 16])
    b.result(b.softmax(b.add(b.matmul(y, w(16, 10)), bias((10,)))), name="prob")
    xml = str(path / "small.xml")
    write_ir_model(b.build(), xml)
    return xml, xml[:-4] + ".bin"


def small_samples(n, seed):
    rng = np.random.default_rng(seed)
    return [{"data": rng.uniform(0, 1, (1, 3, 16, 16)).astype(np.float32)}
            for _ in range(n)]


@pytest.mark.parametrize("quant", [QuantMode.INT8_WEIGHT, QuantMode.INT8_FULL])
def test_bias_corrections_match_jax(tmp_path, quant):
    from pyopenvino_tpu.passes.bias_correct import bias_corrections as jax_bias_corrections
    from pyopenvino_tpu.passes.quantize import quantize_weights as jax_quantize
    from pyopenvino_tpu.passes.shape_infer import infer_shapes as jax_infer_shapes

    from pyopenvino_tpu_torch.passes.bias_correct import bias_corrections

    paths = small_net(tmp_path)
    samples = small_samples(3, seed=1)
    jmodel = jax_read(*paths)
    want = jax_bias_corrections(jmodel, jax_infer_shapes(jmodel), jax_quantize(jmodel),
                                samples)
    net = compile_model(read_ir_model(*paths),
                        Config(quant=quant, bias_correction=True), device="cpu",
                        calibration_samples=samples)
    got = net._bias_corr
    assert sorted(got) == sorted(want) and len(got) == 6
    for nid, delta in want.items():
        assert got[nid].dtype == np.float32
        assert np.abs(got[nid] - delta).max() <= 1e-6
        const = net.model.nodes[nid].const
        np.testing.assert_array_equal(net.weights[str(nid)].numpy(),
                                      (const + delta.reshape(const.shape)).astype(np.float32))


def test_load_weights_from_jax_int8full_checkpoint(tmp_path, monkeypatch):
    """The JAX package's save_weights of an INT8-FULL network (int8 codes,
    float32 scales and biases, seeded perturbation) loads into the port's
    network compiled with the same activation scales, and both backends
    then give the JAX package's logits (XLA's rounding patched in)."""
    from pyopenvino_tpu.runtime.compiler import CompiledNetwork as JaxCompiledNetwork
    from pyopenvino_tpu.runtime.compiler import prepare_model as jax_prepare

    paths = small_net(tmp_path)
    samples, x = small_samples(2, seed=1), small_samples(1, seed=2)[0]
    jax_config = JaxConfig(backend=JaxBackend.PALLAS, quant=JaxQuantMode.INT8_FULL)
    model, quantized, scales, _ = jax_prepare(
        logits_model(jax_read(*paths), jax_ir), jax_config, samples)
    ref = JaxCompiledNetwork(model, jax_config, quantized=quantized, act_scales=scales)
    rng = np.random.default_rng(12)
    perturbed = {}
    for k, v in ref.weights.items():
        v = np.asarray(v)
        if v.dtype == np.int8:
            v = np.clip(v.astype(np.int32) + rng.integers(-9, 10, v.shape),
                        -127, 127).astype(np.int8)
        elif v.dtype == np.float32:
            v = v * np.float32(rng.uniform(0.8, 1.2))
        perturbed[k] = v
    ref.weights = perturbed
    ckpt = str(tmp_path / "small_int8full.npz")
    ref.save_weights(ckpt)
    want = ref.infer(x)["prob"]

    xla_fma_epilogue(monkeypatch)
    port_model = logits_model(read_ir_model(*paths), port_ir)
    for backend in (Backend.KERNELS, Backend.TORCH):
        net = CompiledNetwork(port_model, Config(backend=backend, quant=QuantMode.INT8_FULL,
                                                 int8_dataflow=False),
                              device="cpu", quantized=quantized, act_scales=scales)
        assert np.abs(net.infer(x)["prob"] - want).max() > 1e-4
        net.load_weights(ckpt)
        np.testing.assert_array_equal(net.infer(x)["prob"], want)
