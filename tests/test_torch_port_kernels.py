"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper takes its plain PyTorch version, so these tests
hold the plain versions (and the Python around the kernels: patches,
weight layout, padding) against the Pallas kernels run in interpret mode.
The CUDA and Triton kernels themselves are held against the plain versions
on the card (tests/test_torch_port_gpu.py, chip_smoke.py).  Inputs are made
with numpy from a seed and handed to both packages.
"""

import types

import numpy as np
import pytest
import torch

from pyopenvino_tpu_torch.kernels.conv import conv2d_fused, extract_patches
from pyopenvino_tpu_torch.kernels.gemm import fused_gemm, fused_gemm_plain
from pyopenvino_tpu_torch.kernels.softmax import softmax_rows, softmax_rows_plain
import test_torch_port_threads  # noqa: F401  (this worker's torch threads)

# fused_gemm: f32 products summed in another order than the interpreted
# Pallas kernel's; 1e-5 of the output's largest magnitude covers it.
GEMM_RTOL = 1e-5
# softmax: one exp per element and one division, in f32.
SOFTMAX_ATOL = 1e-6


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


GEMM_CASES = [
    # (m, k, n, scale, bias, act) — ragged against every tile size
    (49, 147, 65, False, True, None),
    (1, 512, 1000, False, True, None),
    (130, 70, 129, True, True, ("relu", 0.0, 0.0)),
    (77, 33, 200, True, False, ("clamp", -0.5, 0.75)),
    (256, 64, 128, False, True, None),
    (3, 1, 5, False, False, ("relu", 0.0, 0.0)),
]


@pytest.mark.parametrize("m,k,n,use_scale,use_bias,act", GEMM_CASES)
def test_fused_gemm_plain_vs_pallas(m, k, n, use_scale, use_bias, act):
    import jax.numpy as jnp

    from pyopenvino_tpu.kernels.gemm import fused_gemm as jax_fused_gemm

    rng = np.random.default_rng(m * 1000 + k + n)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, n).astype(np.float32) if use_scale else None
    bias = rng.standard_normal(n).astype(np.float32) if use_bias else None

    want = jax_fused_gemm(
        jnp.asarray(a), jnp.asarray(b),
        scale=None if scale is None else jnp.asarray(scale),
        bias=None if bias is None else jnp.asarray(bias),
        act=act, interpret=True,
    )
    t = lambda v: None if v is None else torch.from_numpy(v)  # noqa: E731
    got = fused_gemm_plain(t(a), t(b), t(scale), t(bias), act)
    assert got.shape == (m, n)
    assert _rel_err(got.numpy(), want) <= GEMM_RTOL


def test_fused_gemm_wrapper_takes_plain_on_cpu_and_counts_nothing():
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((9, 17)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((17, 6)).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(6).astype(np.float32))
    before = fused_gemm.launches
    got = fused_gemm(a, b, bias=bias, act=("relu", 0, 0))
    torch.testing.assert_close(
        got, fused_gemm_plain(a, b, None, bias, ("relu", 0, 0)), rtol=0, atol=0)
    assert fused_gemm.launches == before


def test_wrappers_refuse_other_devices():
    """No silent fallback: a tensor that is neither on the CPU nor on a CUDA
    card is refused, never computed by the plain version."""
    a = torch.empty((4, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_gemm(a, a)
    with pytest.raises(ValueError, match="unsupported device"):
        softmax_rows(a)


@pytest.mark.parametrize("m,n", [(1, 1000), (5, 1000), (3, 129), (7, 1)])
def test_softmax_rows_plain_vs_pallas(m, n):
    import jax.numpy as jnp

    from pyopenvino_tpu.kernels.softmax import softmax_rows as jax_softmax_rows

    rng = np.random.default_rng(m + n)
    x = (rng.standard_normal((m, n)) * 30).astype(np.float32)
    want = np.asarray(jax_softmax_rows(jnp.asarray(x), interpret=True))
    got = softmax_rows(torch.from_numpy(x))  # CPU: the plain version
    torch.testing.assert_close(got, softmax_rows_plain(torch.from_numpy(x)),
                               rtol=0, atol=0)
    assert np.abs(got.numpy() - want).max() <= SOFTMAX_ATOL


@pytest.mark.parametrize(
    "n,h,w,ci,co,stride,act",
    [
        (1, 56, 56, 64, 128, 2, None),      # ResNet-18 layer2 shortcut
        (2, 14, 14, 256, 512, 2, None),     # layer4 shortcut, batch 2
        (2, 9, 7, 65, 130, 2, ("relu", 0, 0)),  # odd sizes
        (1, 6, 6, 64, 128, 1, ("clamp", 0.0, 6.0)),
    ],
)
def test_conv2d_fused_vs_pallas(n, h, w, ci, co, stride, act):
    import jax.numpy as jnp

    from pyopenvino_tpu.kernels.conv import conv2d_fused as jax_conv2d_fused

    rng = np.random.default_rng(ci + co + h)
    x = rng.standard_normal((n, h, w, ci)).astype(np.float32)
    wgt = (rng.standard_normal((co, ci, 1, 1)) * 0.1).astype(np.float32)
    bias = rng.standard_normal(co).astype(np.float32)
    want = np.asarray(jax_conv2d_fused(
        jnp.asarray(x), jnp.asarray(wgt), bias=jnp.asarray(bias), act=act,
        strides=(stride, stride), interpret=True))
    got = conv2d_fused(torch.from_numpy(x), torch.from_numpy(wgt),
                       bias=torch.from_numpy(bias), act=act,
                       strides=(stride, stride))
    assert got.shape == want.shape
    assert got.is_contiguous()
    assert _rel_err(got.numpy(), want) <= GEMM_RTOL


@pytest.mark.parametrize("kh,kw,stride,dil,pads", [
    (3, 3, 1, 1, ((1, 1), (1, 1))),
    (3, 3, 2, 1, ((0, 1), (0, 1))),
    (2, 2, 1, 2, ((1, 0), (0, 1))),
])
def test_extract_patches_matches_jax(kh, kw, stride, dil, pads):
    import jax.numpy as jnp

    from pyopenvino_tpu.kernels.conv import extract_patches as jax_extract

    x = np.random.default_rng(kh + stride).standard_normal(
        (2, 9, 8, 3)).astype(np.float32)
    want, woh, wow = jax_extract(jnp.asarray(x), kh, kw, stride, stride,
                                 dil, dil, pads)
    got, oh, ow = extract_patches(torch.from_numpy(x), kh, kw, stride, stride,
                                  dil, dil, pads)
    assert (oh, ow) == (woh, wow)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the ops around the kernels: padding routes of pools and convs --------

def _ctx(use_kernels, w):
    """A stand-in for the compiler's EmitCtx over one float32 weight."""
    return types.SimpleNamespace(
        use_kernels=use_kernels, compute_dtype=torch.float32,
        weight_for=lambda node, tv: tv.arr,
        derived_weight=lambda node, port, tag, make: make(torch.from_numpy(w)))


def _nodes(op_type, attrs, out_port):
    from pyopenvino_tpu.ir.model import Node as JaxNode

    from pyopenvino_tpu_torch.ir.model import Node

    kw = dict(id=0, name="n", op_type=op_type, attrs=attrs, inputs={},
              outputs={out_port: None})
    return Node(**kw), JaxNode(**kw)


@pytest.mark.parametrize("op_type,attrs", [
    ("MaxPool", {"kernel": "3,3", "strides": "2,2", "pads_begin": "1,1",
                 "pads_end": "1,1", "rounding_type": "floor"}),
    ("MaxPool", {"kernel": "3,3", "strides": "2,2", "pads_begin": "0,0",
                 "pads_end": "0,0", "rounding_type": "ceil"}),
    ("AvgPool", {"kernel": "7,7", "strides": "1,1", "pads_begin": "0,0",
                 "pads_end": "0,0", "exclude-pad": "true"}),
    ("AvgPool", {"kernel": "3,3", "strides": "2,2", "pads_begin": "0,1",
                 "pads_end": "1,0", "exclude-pad": "true"}),
    ("AvgPool", {"kernel": "3,3", "strides": "2,2", "pads_begin": "1,1",
                 "pads_end": "0,0", "rounding_type": "ceil",
                 "exclude-pad": "false"}),
])
def test_pools_match_jax_reference(op_type, attrs):
    from pyopenvino_tpu.ops import get_op as jax_get_op

    from pyopenvino_tpu_torch.ops import TValue, get_op

    node, jnode = _nodes(op_type, attrs, 1)
    x = np.random.default_rng(5).standard_normal((2, 3, 11, 10)).astype(np.float32)
    want = jax_get_op(op_type).ref_compute(jnode, {0: x})[1]
    xt = torch.from_numpy(x).contiguous(memory_format=torch.channels_last)
    got = get_op(op_type).emit(None, node, {0: TValue(xt)})[1].arr
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("use_kernels,w_shape,attrs", [
    (False, (6, 3, 3, 3), {"strides": "2,2", "pads_begin": "0,1",
                           "pads_end": "1,0", "dilations": "1,1"}),
    (False, (8, 3, 3, 3), {"strides": "1,1", "pads_begin": "1,1",
                           "pads_end": "1,1", "dilations": "2,2"}),
    (True, (128, 64, 1, 1), {"strides": "2,2", "pads_begin": "0,0",
                             "pads_end": "0,0", "dilations": "1,1"}),
])
def test_convolution_routes_match_jax_reference(use_kernels, w_shape, attrs):
    from pyopenvino_tpu.ops import get_op as jax_get_op

    from pyopenvino_tpu_torch.ops import TValue, get_op

    node, jnode = _nodes("Convolution", attrs, 2)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, w_shape[1], 9, 10)).astype(np.float32)
    w = (rng.standard_normal(w_shape) * 0.2).astype(np.float32)
    want = jax_get_op("Convolution").ref_compute(jnode, {0: x, 1: w})[2]
    ctx = _ctx(use_kernels, w)
    xt = torch.from_numpy(x).contiguous(memory_format=torch.channels_last)
    got = get_op("Convolution").emit(
        ctx, node, {0: TValue(xt), 1: TValue(torch.from_numpy(w))})[2].arr
    assert tuple(got.shape) == want.shape
    assert _rel_err(got.numpy(), want) <= GEMM_RTOL


@pytest.mark.parametrize("use_kernels,a_shape,w_shape,ta,tb", [
    (True, (1, 512), (512, 1000), False, False),   # ResNet-18's FC
    (True, (3, 40), (24, 40), False, True),
    (True, (40, 1), (40, 24), True, False),       # transpose_a with M = 1
    (True, (2, 40, 3), (40, 24), True, False),    # leading dims fold into M
    (False, (40, 1), (24, 40), True, True),
])
def test_matmul_routes_match_jax_reference(use_kernels, a_shape, w_shape, ta, tb):
    from pyopenvino_tpu.ops import get_op as jax_get_op

    from pyopenvino_tpu_torch.ops import TValue, get_op

    attrs = {"transpose_a": str(ta).lower(), "transpose_b": str(tb).lower()}
    node, jnode = _nodes("MatMul", attrs, 2)
    rng = np.random.default_rng(sum(a_shape) + sum(w_shape))
    a = rng.standard_normal(a_shape).astype(np.float32)
    w = rng.standard_normal(w_shape).astype(np.float32)
    want = jax_get_op("MatMul").ref_compute(jnode, {0: a, 1: w})[2]
    ctx = _ctx(use_kernels, w)
    got = get_op("MatMul").emit(
        ctx, node, {0: TValue(torch.from_numpy(a)), 1: TValue(torch.from_numpy(w))})[2].arr
    assert tuple(got.shape) == want.shape
    assert _rel_err(got.numpy(), want) <= GEMM_RTOL


# -- conv2d_direct, float32 (kernel 3f) ------------------------------------

# The plain version sums in float64 on the CPU, the interpreted Pallas kernel
# in float32 at HIGHEST precision: tests/test_pallas.py's limits.
DIRECT_RTOL = DIRECT_ATOL = 1e-4


@pytest.mark.parametrize("w_int8", [False, True])
@pytest.mark.parametrize("n,h,w,ci,co,kh,kw,pads", [
    (2, 14, 14, 8, 16, 3, 3, ((1, 1), (1, 1))),   # tests/test_pallas.py's shapes
    (1, 9, 9, 3, 5, 3, 3, ((0, 0), (0, 0))),
    (2, 8, 8, 16, 32, 5, 5, ((2, 2), (2, 2))),
])
def test_conv2d_direct_f32_plain_vs_pallas(n, h, w, ci, co, kh, kw, pads, w_int8):
    """The float variant's plain version against the JAX package's kernel in
    interpret mode, with a float32 weight, and with an int8 weight whose
    scale multiplies the sum (the weight cast to float32, as in the kernel)."""
    import jax.numpy as jnp

    from pyopenvino_tpu.kernels.conv_direct import conv2d_direct as jax_conv2d_direct

    from pyopenvino_tpu_torch.kernels.conv_direct import conv2d_direct

    rng = np.random.default_rng(ci + co)
    x = rng.standard_normal((n, h, w, ci)).astype(np.float32)
    if w_int8:
        wt = rng.integers(-127, 128, (co, ci, kh, kw)).astype(np.int8)
        scale = rng.uniform(1e-3, 1e-2, co).astype(np.float32)
    else:
        wt, scale = rng.standard_normal((co, ci, kh, kw)).astype(np.float32), None
    bias = rng.standard_normal(co).astype(np.float32)
    want = np.asarray(jax_conv2d_direct(
        jnp.asarray(x), jnp.asarray(wt), scale=None if scale is None else jnp.asarray(scale),
        bias=jnp.asarray(bias), act=("relu", 0, 0), pads=pads, interpret=True))
    before = conv2d_direct.launches_f32
    got = conv2d_direct(torch.from_numpy(x), torch.from_numpy(wt),
                        None if scale is None else torch.from_numpy(scale),
                        torch.from_numpy(bias), ("relu", 0, 0), pads)  # CPU: plain
    assert conv2d_direct.launches_f32 == before
    assert got.dtype == torch.float32 and got.is_contiguous() and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=DIRECT_RTOL, atol=DIRECT_ATOL)


# -- dw_pw_fused (kernel 4) -------------------------------------------------

def _dw_pw_inputs(n, h, w, c, co):
    """tests/test_dw_pw_experiment.py's draws, seed 42."""
    rng = np.random.default_rng(42)
    return (rng.integers(-127, 128, (n, h, w, c), dtype=np.int8),
            rng.integers(-127, 128, (9, c), dtype=np.int8),
            rng.uniform(1e-4, 1e-3, c).astype(np.float32),
            rng.uniform(-1, 1, c).astype(np.float32),
            rng.integers(-127, 128, (c, co), dtype=np.int8),
            rng.uniform(1e-4, 1e-3, co).astype(np.float32),
            rng.uniform(-1, 1, co).astype(np.float32))


DW_PW_SHAPES = [(2, 10, 10, 32, 64), (8, 19, 21, 64, 32), (1, 7, 9, 16, 16)]


def _jax_dw_pw(args, **kw):
    import os
    import sys

    import jax.numpy as jnp

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
    from dw_pw_kernel import dw_pw_fused as jax_dw_pw_fused

    return np.asarray(jax_dw_pw_fused(*map(jnp.asarray, args), interpret=True, **kw))


@pytest.mark.parametrize("n,h,w,c,co", DW_PW_SHAPES)
def test_dw_pw_fused_plain_exact(n, h, w, c, co):
    """int8 out: the plain version's codes equal the JAX package's kernel
    (interpret) and tests/test_dw_pw_experiment.py's numpy reference exactly."""
    from test_dw_pw_experiment import _ref

    from pyopenvino_tpu_torch.kernels.dw_pw import dw_pw_fused

    args = _dw_pw_inputs(n, h, w, c, co)
    kw = dict(dw_act=("clamp", 0.0, 6.0), pw_act=("clamp", 0.0, 6.0), s_mid=0.05, s_out=0.04)
    before = dw_pw_fused.launches
    got = dw_pw_fused(*map(torch.from_numpy, args), **kw).numpy()  # CPU: plain
    assert dw_pw_fused.launches == before
    assert got.dtype == np.int8 and got.shape == (n, h, w, co)
    np.testing.assert_array_equal(got, _jax_dw_pw(args, **kw))
    np.testing.assert_array_equal(got, _ref(*args, 0.05, 0.04))


# The JAX kernel's pointwise epilogue in interpret mode is XLA's, which
# contracts pacc·scale + bias into one fused multiply-add (one rounding;
# the port rounds twice, as its CUDA kernel must to equal its plain version).
# The largest difference seen at these shapes is 1.5e-5 of outputs up to
# 5.2e2, about 3e-8 of the largest; 1e-6 of the largest covers that last bit.
DW_PW_EPILOGUE_RTOL = 1e-6


@pytest.mark.parametrize("n,h,w,c,co", DW_PW_SHAPES)
def test_dw_pw_fused_plain_float_out(n, h, w, c, co, monkeypatch):
    """float32 out with no pointwise activation (MobileNet-v2's projection
    form): within the last bit of the JAX kernel's epilogue, and equal to it
    once the pointwise epilogue rounds like XLA's fused multiply-add."""
    from pyopenvino_tpu_torch.kernels import dw_pw, gemm

    args = _dw_pw_inputs(n, h, w, c, co)
    kw = dict(dw_act=("clamp", 0.0, 6.0), pw_act=None, s_mid=0.05)
    want = _jax_dw_pw(args, **kw)
    got = dw_pw.dw_pw_fused(*map(torch.from_numpy, args), **kw).numpy()
    assert got.dtype == np.float32 and got.shape == (n, h, w, co)
    err = _rel_err(got, want)
    print(f"dw_pw_fused float out vs the JAX kernel: max rel err {err:.3e} "
          f"(limit {DW_PW_EPILOGUE_RTOL})")
    assert err <= DW_PW_EPILOGUE_RTOL

    def fma(acc, scale=None, bias=None, act=None):
        return gemm.apply_act((acc.double() * scale.double() + bias.double()).float(), act)

    monkeypatch.setattr(dw_pw, "epilogue", fma)
    np.testing.assert_array_equal(dw_pw.dw_pw_fused(*map(torch.from_numpy, args), **kw).numpy(),
                                  want)


def test_dw_pw_fused_refusals():
    from pyopenvino_tpu_torch.kernels.dw_pw import dw_pw_fused

    args = [torch.from_numpy(a) for a in _dw_pw_inputs(1, 5, 5, 8, 16)]
    with pytest.raises(ValueError, match="takes int8"):
        dw_pw_fused(args[0].float(), *args[1:], s_mid=0.05)
    with pytest.raises(ValueError, match="do not match"):
        dw_pw_fused(args[0], args[1][:, :4], *args[2:], s_mid=0.05)
    with pytest.raises(ValueError, match="unsupported device"):
        dw_pw_fused(args[0].to("meta"), *args[1:], s_mid=0.05)


def test_dw_pw_fused_takes_a_cached_k_major_pointwise_weight():
    """The kernel's pointwise stage reads w_pw K-major: a cached (C, Co)
    .t() view of the (Co, C) contiguous matrix gives what w_pw gives, and a
    row-major one is refused on every device."""
    from pyopenvino_tpu_torch.kernels.dw_pw import dw_pw_fused

    args = [torch.from_numpy(a) for a in _dw_pw_inputs(2, 7, 6, 24, 40)]
    kw = dict(pw_act=("relu", 0.0, 0.0), s_mid=0.05, s_out=0.04)
    before = dw_pw_fused.launches
    want = dw_pw_fused(*args, **kw)  # CPU: the plain version
    got = dw_pw_fused(*args, wmat=args[4].t().contiguous().t(), **kw)
    assert torch.equal(got, want) and dw_pw_fused.launches == before
    with pytest.raises(ValueError, match="K-major"):
        dw_pw_fused(*args, wmat=args[4], **kw)
    with pytest.raises(ValueError, match="K-major"):
        dw_pw_fused(*args, wmat=args[4].t().contiguous(), **kw)


@pytest.mark.parametrize("b,h,c,co,rows,split", [
    (64, 150, 8, 16, 128, 1),      # SSD's widest pair: 2813 blocks of 128
    (64, 19, 512, 512, 128, 1),    # 181 blocks of 128, two fit an SM
    (256, 10, 1024, 1024, 64, 1),  # one 128-row block an SM at C = 1024
    (64, 10, 256, 256, 64, 1),     # 50 blocks of 128 would idle 82 SMs
    (1, 10, 1024, 1024, 64, 8),    # 2 blocks: the 8 Co tiles split them
    (1, 19, 512, 512, 64, 4),
    (1, 150, 8, 16, 128, 1),
])
def test_dw_pw_grid_choice(b, h, c, co, rows, split, monkeypatch):
    """The wrapper's tile height and Co split for an H100's 132 SMs."""
    from pyopenvino_tpu_torch.kernels import dw_pw

    monkeypatch.setattr(dw_pw, "_sm_count", lambda index: 132)
    assert dw_pw.pick_tile_rows(b * h * h, c, 0) == rows
    assert dw_pw.co_split(b * h * h, co, rows, 0) == split


# -- kernel 3f's implicit-im2col loader (csrc/conv_direct.cu, ConvAF32) ------

def _fast_div(n, d):
    """csrc/conv_direct.cu's FastDiv: n // d for 0 <= n < 2^31 by a
    multiply-high with the host's magic number and a shift."""
    if d == 1:
        return n
    lg = 0
    while (1 << lg) < d:
        lg += 1
    mul = ((1 << (31 + lg)) + d - 1) // d
    hi = (n.astype(np.uint64) * np.uint64(mul)) >> np.uint64(32)
    return (hi >> np.uint64(lg - 1)).astype(np.int64)


def _conv_f32_loader_matrix(x, kh, kw, pads):
    """The (M + 5, K rounded up to 32) matrix that ConvAF32 hands
    f32_mma.cuh's ring, emulated: each row's (n, oy - pt, ox - pl), each
    column's (tap, channel) by FastDiv, rows past M and columns past K at a
    coordinate far outside the input, one unsigned test per value; 4-value
    chunks read from one address where Ci % 4 == 0, else one value each."""
    n, h, w, ci = x.shape
    (pt, pb), (pl, pr) = pads
    oh, ow = h + pt + pb - kh + 1, w + pl + pr - kw + 1
    big, k_all = 1 << 29, kh * kw * ci
    m = np.arange(n * oh * ow + 5)
    ox, t = m % ow, m // ow
    oy, nn = t % oh, t // oh
    valid = m < n * oh * ow
    iy0, ix0 = np.where(valid, oy - pt, -2 * big), np.where(valid, ox - pl, 0)
    o = np.where(valid, ((nn * h + iy0) * w + ix0) * ci, 0)
    k = np.arange(-(-k_all // 32) * 32)
    tap = _fast_div(k, ci)
    c = k - tap * ci
    i = _fast_div(tap, kw)
    j = tap - i * kw
    ci_, off = np.where(k < k_all, i, big), (i * w + j) * ci + c

    def inside(rows, cols):
        ys = (iy0[rows, None] + ci_[None, cols]).astype(np.int32).view(np.uint32)
        xs = (ix0[rows, None] + j[None, cols]).astype(np.int32).view(np.uint32)
        return (ys < h) & (xs < w)

    flat = x.reshape(-1)
    out = np.zeros((len(m), len(k)), x.dtype)
    rows = np.arange(len(m))
    step = 4 if ci % 4 == 0 else 1
    for k0 in range(0, len(k), step):
        ok = inside(rows, [k0])[:, 0]
        src = o[ok] + off[k0]
        for q in range(step):
            out[ok, k0 + q] = flat[src + q]
    return out


@pytest.mark.parametrize("n,h,w,ci,kh,kw,pads", [
    (2, 9, 11, 3, 3, 3, ((0, 2), (1, 0))),   # Ci = 3: one value at a time
    (2, 7, 6, 4, 3, 3, ((1, 0), (0, 2))),    # Ci = 4: 16-byte chunks
    (1, 8, 9, 7, 5, 5, ((2, 1), (0, 2))),    # Ci = 7, 5×5
    (1, 6, 5, 64, 3, 3, ((1, 1), (1, 1))),   # Ci = 64, ResNet-18's pads
    (2, 5, 7, 64, 1, 3, ((0, 0), (2, 0))),   # 1×3, one-sided pads
])
def test_conv_f32_loader_map_equals_extract_patches(n, h, w, ci, kh, kw, pads):
    """The loader's (tap, channel) map with FastDiv's magic numbers, its far
    coordinates for rows past M and k past K, and its 16-byte chunks give
    the JAX package's patch matrix, and zeros beyond it."""
    import jax.numpy as jnp

    from pyopenvino_tpu.kernels.conv import extract_patches

    x = np.random.default_rng(ci + kh).standard_normal((n, h, w, ci)).astype(np.float32)
    patches, oh, ow = extract_patches(jnp.asarray(x), kh, kw, 1, 1, 1, 1, pads)
    want = np.asarray(patches).reshape(n * oh * ow, kh * kw * ci)
    got = _conv_f32_loader_matrix(x, kh, kw, pads)
    np.testing.assert_array_equal(got[:want.shape[0], :want.shape[1]], want)
    assert not got[want.shape[0]:].any() and not got[:, want.shape[1]:].any()


def test_fast_div_equals_floor_division():
    n = np.concatenate([np.arange(5000), np.array([2 ** 31 - 1, 2 ** 30 + 7, 123456789])])
    for d in list(range(1, 600)) + [1152, 2304, 4608, 4999, 65535, 2 ** 20 + 3]:
        np.testing.assert_array_equal(_fast_div(n, d), n // d)


# -- the profiler's categories for 3f and #4 ---------------------------------

@pytest.mark.parametrize("name,category", [
    ("void f32mma::f32_mma_kernel<(anonymous namespace)::ConvAF32, f32mma::BFloat>"
     "((anonymous namespace)::ConvAF32, f32mma::BFloat, float const*)", "conv2d_direct_f32"),
    ("void f32mma::f32_mma_kernel<(anonymous namespace)::ConvAF32, f32mma::BInt8>"
     "((anonymous namespace)::ConvAF32, f32mma::BInt8, float const*)", "conv2d_direct_f32"),
    ("void f32mma::f32_mma_kernel<f32mma::RowMajorF32, f32mma::BFloat>"
     "(f32mma::RowMajorF32, f32mma::BFloat, float const*)", "fused_gemm"),
    ("void f32mma::f32_mma_kernel<f32mma::RowMajorF32, f32mma::BInt8>"
     "(f32mma::RowMajorF32, f32mma::BInt8, float const*)", "fused_gemm_i8w"),
    ("void i8mma::i8i8_mma_kernel<(anonymous namespace)::ConvA>((anonymous namespace)::ConvA, "
     "i8mma::RowMajor, float const*)", "conv2d_direct"),
    ("void i8mma::i8i8_mma_kernel<i8mma::RowMajor>(i8mma::RowMajor, i8mma::RowMajor, "
     "float const*)", "fused_gemm_i8i8"),
    ("void (anonymous namespace)::dw_pw_kernel<64>((anonymous namespace)::Params)",
     "dw_pw_fused"),
    ("void (anonymous namespace)::dw_pw_kernel<128>((anonymous namespace)::Params)",
     "dw_pw_fused"),
    ("void i8mma::splitk_reduce<float, false>(float const*, int, long long, int)",
     "splitk_reduce"),
    # the output type as a template argument (float32 or bfloat16) and the
    # bf16 loop
    ("void i8mma::i8i8_mma_kernel<(anonymous namespace)::ConvA, float>((anonymous "
     "namespace)::ConvA, i8mma::RowMajor, float const*)", "conv2d_direct"),
    ("void i8mma::i8i8_mma_kernel<(anonymous namespace)::ConvA, __nv_bfloat16>((anonymous "
     "namespace)::ConvA, i8mma::RowMajor, float const*)", "conv2d_direct_bf16"),
    ("void i8mma::i8i8_mma_kernel<i8mma::RowMajor, float>(i8mma::RowMajor, i8mma::RowMajor, "
     "float const*)", "fused_gemm_i8i8"),
    ("void i8mma::i8i8_mma_kernel<i8mma::RowMajor, __nv_bfloat16>(i8mma::RowMajor, "
     "i8mma::RowMajor, float const*)", "fused_gemm_i8i8_bf16"),
    ("void bf16mma::bf16_mma_kernel<bf16mma::BBf16>(bf16mma::RowMajorBf16, bf16mma::BBf16, "
     "float const*)", "fused_gemm_bf16"),
    ("void bf16mma::bf16_mma_kernel<bf16mma::BInt8>(bf16mma::RowMajorBf16, bf16mma::BInt8, "
     "float const*)", "fused_gemm_bf16_i8w"),
    ("void i8mma::splitk_reduce<float, true, __nv_bfloat16>(float const*, int, long long, "
     "int)", "splitk_reduce"),
    # the bf16 loop with its A loader as a template argument (3f-bf16's
    # ConvABf16 or the row-major one) and dw_pw.cu's output type
    ("void bf16mma::bf16_mma_kernel<(anonymous namespace)::ConvABf16, bf16mma::BBf16>("
     "(anonymous namespace)::ConvABf16, bf16mma::BBf16, float const*, float const*, "
     "__nv_bfloat16*)", "conv2d_direct_float_bf16"),
    ("void bf16mma::bf16_mma_kernel<(anonymous namespace)::ConvABf16, bf16mma::BInt8>("
     "(anonymous namespace)::ConvABf16, bf16mma::BInt8, float const*, float const*, "
     "__nv_bfloat16*)", "conv2d_direct_float_bf16"),
    ("void bf16mma::bf16_mma_kernel<bf16mma::RowMajorBf16, bf16mma::BBf16>("
     "bf16mma::RowMajorBf16, bf16mma::BBf16, float const*)", "fused_gemm_bf16"),
    ("void bf16mma::bf16_mma_kernel<bf16mma::RowMajorBf16, bf16mma::BInt8>("
     "bf16mma::RowMajorBf16, bf16mma::BInt8, float const*)", "fused_gemm_bf16_i8w"),
    ("void (anonymous namespace)::dw_pw_kernel<64, signed char>((anonymous "
     "namespace)::Params)", "dw_pw_fused"),
    ("void (anonymous namespace)::dw_pw_kernel<128, float>((anonymous namespace)::Params)",
     "dw_pw_fused"),
    ("void (anonymous namespace)::dw_pw_kernel<64, __nv_bfloat16>((anonymous "
     "namespace)::Params)", "dw_pw_fused_bf16"),
    # 3f-bf16 on i8_wgmma.cuh's loop: its loaders name the kernel (both
    # weight types, both tile widths), whose template also holds #3's
    # kernel name and a bfloat16 output
    ("void i8wgmma::i8_wgmma_kernel<i8wgmma::ConvABf16Im2col, 128, __nv_bfloat16>("
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, i8wgmma::ConvABf16Im2col, float const*, "
     "float const*, __nv_bfloat16*, float*, int, int, int, int, int, int, float, float)",
     "conv2d_direct_float_bf16"),
    ("void i8wgmma::i8_wgmma_kernel<i8wgmma::ConvABf16Im2col, 64, __nv_bfloat16>("
     "CUtensorMap_st const, CUtensorMap_st const, CUtensorMap_st const, "
     "i8wgmma::ConvABf16Im2col, float const*, float const*, __nv_bfloat16*, float*, int, int, "
     "int, int, int, int, float, float)", "conv2d_direct_float_bf16"),
    ("void i8wgmma::i8_wgmma_kernel<i8wgmma::ConvABf16Im2colI8w, 128, __nv_bfloat16>("
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, i8wgmma::ConvABf16Im2colI8w, float "
     "const*, float const*, __nv_bfloat16*, float*, int, int, int, int, int, int, float, "
     "float)", "conv2d_direct_float_bf16"),
    ("void i8wgmma::i8_wgmma_kernel<i8wgmma::ConvABf16Im2colI8w, 64, __nv_bfloat16>("
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, i8wgmma::ConvABf16Im2colI8w, float "
     "const*, float const*, __nv_bfloat16*, float*, int, int, int, int, int, int, float, "
     "float)", "conv2d_direct_float_bf16"),
    ("void i8mma::splitk_reduce<float, false, __nv_bfloat16>(float const*, int, long long, "
     "int, float const*, float const*, __nv_bfloat16*, int, float, float)", "splitk_reduce"),
])
def test_profiler_files_each_kernel_under_its_own_category(name, category):
    from pyopenvino_tpu_torch.runtime.profiling import categorize

    assert categorize(name) == category
