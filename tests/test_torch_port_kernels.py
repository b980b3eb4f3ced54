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
        use_kernels=use_kernels,
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
