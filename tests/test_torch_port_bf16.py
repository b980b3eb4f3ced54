"""bfloat16 compute in the port against the JAX package on the CPU.

  * each bf16 kernel's plain version (the wrapper's CPU route) against the
    Pallas kernel in interpret mode, on the same seeded inputs: fused_gemm
    with a bfloat16 or int8 B, the int8 × int8 fused_gemm and
    conv2d_direct with a bfloat16 output, softmax_rows;
  * every ported op's ``emit`` on bfloat16 inputs against the JAX
    package's ``emit`` (its CPU lowering) with ``compute_dtype=bfloat16``;
  * full-width ResNet-18 (here) and MobileNet-v2
    (test_torch_port_bf16_mobilenet.py) in FP32, INT8 weight-only and
    INT8-FULL with ``compute_dtype="bfloat16"``, TORCH against XLA and
    KERNELS against PALLAS;
  * a JAX bf16 checkpoint (INT8 weight-only, mnist) loaded by the port.

Tolerances, in bfloat16 steps (ulp: 2^(e-7) for a value in [2^e, 2^(e+1))):
a float kernel or op sums in float32 in another order than XLA does, so its
bfloat16 result may lie one step off, and where the float32 sum cancels to
a value far below the output's largest, the order's float32 noise is more
steps of that small value: the gate is one step of the element or 2^-16 of
the output's largest magnitude, whichever is larger (FLOAT_ULPS, FLOOR).
The int8 kernels sum exactly and are held bit for bit, with XLA's fused
multiply-add epilogue patched in (tests/test_torch_port_int8full.py)."""

import types

import numpy as np
import pytest
import torch

import pyopenvino_tpu.ir.model as jax_ir
from pyopenvino_tpu.config import Backend as JaxBackend
from pyopenvino_tpu.config import Config as JaxConfig
from pyopenvino_tpu.config import QuantMode as JaxQuantMode
from pyopenvino_tpu.ir import read_ir_model as jax_read
from pyopenvino_tpu.ops import get_op as jax_get_op
from pyopenvino_tpu.ops.spec import TValue as JaxTValue
from pyopenvino_tpu.runtime.compiler import compile_model as jax_compile

import pyopenvino_tpu_torch.ir.model as port_ir
from pyopenvino_tpu_torch.config import Backend, Config, QuantMode
from pyopenvino_tpu_torch.ir import read_ir_model
from pyopenvino_tpu_torch.kernels import conv_direct, gemm, softmax
from pyopenvino_tpu_torch.kernels.conv import conv_weight_matrix_nk
from pyopenvino_tpu_torch.models.synth import resnet18_paths
from pyopenvino_tpu_torch.ops import get_op
from pyopenvino_tpu_torch.ops.spec import TValue
from pyopenvino_tpu_torch.runtime.compiler import compile_model

from test_torch_port_int8full import logits_model, xla_fma_epilogue
import test_torch_port_threads  # noqa: F401  (this worker's torch threads)

FLOAT_ULPS = 1.0
FLOOR = 2.0 ** -16


def bf16_ulp(x):
    """One bfloat16 step at each element's magnitude: 2^(e-8) for a value
    m·2^e with m in [0.5, 1)."""
    x = np.abs(np.asarray(x, np.float64))
    return np.ldexp(1.0, np.frexp(np.where(x == 0, 2.0 ** -126, x))[1] - 8)


def assert_bf16_close(got, want, what=""):
    """Every element within FLOAT_ULPS steps of its own magnitude, or
    within FLOOR of the largest; returns the share that is bit-equal."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    diff = np.abs(got.astype(np.float64) - want)
    limit = np.maximum(FLOAT_ULPS * bf16_ulp(want), FLOOR * np.abs(want).max())
    bad = diff > limit
    assert not bad.any(), (
        f"{what}: {int(bad.sum())} of {bad.size} elements beyond one bfloat16 step; worst "
        f"{(diff / bf16_ulp(want)).max():.1f} steps")
    return float((got == want).mean())


def _jbf16(t):
    """A torch bfloat16 (or float32) tensor as a JAX bfloat16 array."""
    import jax.numpy as jnp

    return None if t is None else jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _f32(a):
    """A JAX array (any float dtype) as float32 numpy."""
    return np.asarray(a, np.float32)


# -- kernels: plain versions against the Pallas kernels (interpret) ---------

@pytest.mark.parametrize("m,k,n,lda,int8_b,act", [
    (1, 512, 1000, 512, False, None),                 # ResNet-18's classifier at B = 1
    (64, 512, 1000, 512, True, None),                 # its classifier at B = 64, INT8W
    (196, 64, 128, 64, False, ("relu", 0.0, 0.0)),    # a projection shortcut
    (98, 256, 512, 256, True, ("relu", 0.0, 0.0)),
    (49, 960, 160, 960, False, ("clamp", 0.0, 6.0)),  # MobileNet-v2's project
    (37, 77, 129, 96, False, None),                   # ragged, lda > K
    (30, 232, 232, 464, True, None),                  # ShuffleNet-v2's Split half
])
def test_bf16_fused_gemm_plain_matches_pallas(m, k, n, lda, int8_b, act):
    """fused_gemm_bf16 / fused_gemm_bf16_i8w: a float32 sum of the
    widened operands, the epilogue in float32, one rounding to bfloat16,
    as the Pallas kernel's bf16 dot at DEFAULT precision with a float32
    accumulator does."""
    from pyopenvino_tpu.kernels.gemm import fused_gemm as jax_fused_gemm

    rng = np.random.default_rng(m + k + n)
    a = torch.from_numpy(rng.standard_normal((m, lda)).astype(np.float32)).bfloat16()[:, :k]
    if int8_b:
        b = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8))
        scale = torch.from_numpy(rng.uniform(1e-3, 2e-2, n).astype(np.float32)).bfloat16()
    else:
        b = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)).bfloat16()
        scale = None
    bias = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).bfloat16()
    got = gemm.fused_gemm(a, b, scale, bias, act)  # CPU: the plain version
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    want = jax_fused_gemm(_jbf16(a), np.asarray(b) if int8_b else _jbf16(b),
                          scale=_jbf16(scale), bias=_jbf16(bias), act=act, interpret=True)
    assert str(want.dtype) == "bfloat16"
    equal = assert_bf16_close(got.float().numpy(), _f32(want), "fused_gemm bf16")
    print(f"fused_gemm bf16 {m}x{k}x{n} int8_b={int8_b}: {equal:.5f} of the elements "
          f"bit-equal to the Pallas kernel's")


@pytest.mark.parametrize("m,k,n,lda", [
    (200, 147, 64, 147),   # ResNet-18's 7×7 stem, K = 147
    (1, 512, 1000, 512),   # its classifier, M = 1
    (49, 2304, 512, 2304),
    (37, 70, 129, 96),     # lda > K, N odd
])
def test_i8i8_bf16_out_plain_matches_pallas(m, k, n, lda, monkeypatch):
    """fused_gemm_i8i8 with a bfloat16 output: the exact int32 sum, the
    float32 epilogue, one rounding to bfloat16 (the Pallas kernel's
    out_dtype); bit-equal with XLA's fused multiply-add epilogue patched
    in."""
    import jax.numpy as jnp

    from pyopenvino_tpu.kernels.gemm import fused_gemm as jax_fused_gemm

    rng = np.random.default_rng(m + k)
    a_full = rng.integers(-127, 128, (m, lda)).astype(np.int8)
    b = rng.integers(-127, 128, (k, n)).astype(np.int8)
    scale = rng.uniform(1e-4, 1e-2, n).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    at = torch.from_numpy(a_full)[:, :k]
    bt = torch.from_numpy(np.ascontiguousarray(b.T)).t()
    want = np.asarray(jax_fused_gemm(
        jnp.asarray(a_full[:, :k]), jnp.asarray(b), scale=jnp.asarray(scale),
        bias=jnp.asarray(bias), act=("relu", 0.0, 0.0), out_dtype=jnp.bfloat16,
        interpret=True).astype(jnp.float32))
    plain = gemm.fused_gemm(at, bt, torch.from_numpy(scale), torch.from_numpy(bias),
                            ("relu", 0.0, 0.0), out_dtype=torch.bfloat16)
    assert plain.dtype == torch.bfloat16
    assert_bf16_close(plain.float().numpy(), want, "i8i8 bf16 out")
    xla_fma_epilogue(monkeypatch)
    got = gemm.fused_gemm(at, bt, torch.from_numpy(scale), torch.from_numpy(bias),
                          ("relu", 0.0, 0.0), out_dtype=torch.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("n,h,w,ci,co,pads", [
    (1, 56, 56, 64, 64, ((1, 1), (1, 1))),   # ResNet-18's layer1 conv
    (2, 9, 11, 3, 7, ((0, 2), (1, 0))),      # Ci = 3, asymmetric pads
    (2, 7, 7, 48, 100, ((1, 1), (1, 1))),
])
def test_conv2d_direct_bf16_out_plain_matches_pallas(n, h, w, ci, co, pads, monkeypatch):
    """conv2d_direct on int8 codes with a bfloat16 output (the Pallas
    kernel's out_dtype, the compute dtype): bit-equal with XLA's fused
    multiply-add epilogue patched in."""
    import jax.numpy as jnp

    from pyopenvino_tpu.kernels.conv_direct import conv2d_direct as jax_conv2d_direct

    rng = np.random.default_rng(ci + co)
    x = rng.integers(-127, 128, (n, h, w, ci)).astype(np.int8)
    wt = rng.integers(-127, 128, (co, ci, 3, 3)).astype(np.int8)
    scale = rng.uniform(1e-4, 1e-2, co).astype(np.float32)
    bias = rng.standard_normal(co).astype(np.float32)
    want = np.asarray(jax_conv2d_direct(
        jnp.asarray(x), jnp.asarray(wt), scale=jnp.asarray(scale), bias=jnp.asarray(bias),
        act=("relu", 0.0, 0.0), pads=pads, out_dtype=jnp.bfloat16,
        interpret=True).astype(jnp.float32))
    args = (torch.from_numpy(x), torch.from_numpy(wt), torch.from_numpy(scale),
            torch.from_numpy(bias), ("relu", 0.0, 0.0), pads)
    wmat = conv_weight_matrix_nk(args[1]).t()
    plain = conv_direct.conv2d_direct(*args, wmat=wmat, out_dtype=torch.bfloat16)
    assert plain.dtype == torch.bfloat16
    assert_bf16_close(plain.float().numpy(), want, "conv2d_direct bf16 out")
    xla_fma_epilogue(monkeypatch)
    got = conv_direct.conv2d_direct(*args, wmat=wmat, out_dtype=torch.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("n,h,w,ci,co,kh,pads,int8_w,act", [
    (1, 14, 14, 32, 48, 3, ((1, 1), (1, 1)), False, ("relu", 0.0, 0.0)),
    (2, 9, 11, 3, 7, 3, ((0, 2), (1, 0)), True, None),     # Ci = 3, asymmetric pads
    (2, 8, 8, 16, 32, 5, ((2, 2), (2, 2)), False, None),   # 5×5
    (1, 7, 7, 64, 100, 3, ((1, 1), (1, 1)), True, ("clamp", 0.0, 6.0)),
])
def test_conv2d_direct_bf16_plain_matches_pallas(n, h, w, ci, co, kh, pads, int8_w, act):
    """Kernel 3f-bf16: conv2d_direct on bfloat16 activations with a
    bfloat16 or int8 weight (cast to bfloat16, exactly), one float32 sum,
    the epilogue in float32, one rounding to bfloat16, against the Pallas
    kernel's DEFAULT-precision bf16 dots (interpret) on the same inputs:
    within one bfloat16 step or 2^-16 of max |want|."""
    import jax.numpy as jnp

    from pyopenvino_tpu.kernels.conv_direct import conv2d_direct as jax_conv2d_direct

    rng = np.random.default_rng(ci + co + kh)
    x = torch.from_numpy(rng.standard_normal((n, h, w, ci)).astype(np.float32)).bfloat16()
    if int8_w:
        wt = torch.from_numpy(rng.integers(-127, 128, (co, ci, kh, kh)).astype(np.int8))
        scale = torch.from_numpy(rng.uniform(1e-3, 1e-2, co).astype(np.float32)).bfloat16()
        jw = jnp.asarray(wt.numpy())
    else:
        wt = torch.from_numpy(rng.standard_normal((co, ci, kh, kh)).astype(np.float32)
                              * 0.2).bfloat16()
        scale, jw = None, _jbf16(wt)
    bias = torch.from_numpy(rng.standard_normal(co).astype(np.float32)).bfloat16()
    before = conv_direct.conv2d_direct.launches_float_bf16
    got = conv_direct.conv2d_direct(x, wt, scale, bias, act, pads)  # CPU: the plain version
    assert conv_direct.conv2d_direct.launches_float_bf16 == before
    assert got.dtype == torch.bfloat16
    want = jax_conv2d_direct(_jbf16(x), jw, scale=_jbf16(scale), bias=_jbf16(bias), act=act,
                             pads=pads, interpret=True)
    assert str(want.dtype) == "bfloat16" and got.shape == want.shape
    equal = assert_bf16_close(got.float().numpy(), _f32(want), "conv2d_direct bf16 x")
    print(f"conv2d_direct bf16 x ({n},{h},{w},{ci}) w ({co},{ci},{kh},{kh}) int8_w={int8_w}: "
          f"{equal:.5f} of the elements bit-equal to the Pallas kernel's")


@pytest.mark.parametrize("n,h,w,c,co", [(2, 10, 10, 32, 64), (8, 19, 21, 64, 32),
                                        (1, 7, 9, 16, 16)])
def test_dw_pw_fused_plain_bf16_out(n, h, w, c, co, monkeypatch):
    """Kernel 4-bf16: dw_pw_fused with s_out None and a bfloat16
    out_dtype: the float32 pointwise epilogue rounded once to bfloat16, as
    the Pallas kernel's ``o.astype(out_dtype)``; bit-equal to it (interpret)
    once the epilogues round like XLA's fused multiply-add
    (test_torch_port_kernels.py::test_dw_pw_fused_plain_float_out's patch)."""
    import jax.numpy as jnp

    from test_torch_port_kernels import _dw_pw_inputs, _jax_dw_pw

    from pyopenvino_tpu_torch.kernels import dw_pw

    args = _dw_pw_inputs(n, h, w, c, co)
    kw = dict(dw_act=("clamp", 0.0, 6.0), pw_act=None, s_mid=0.05)
    want = _jax_dw_pw(args, out_dtype=jnp.bfloat16, **kw).astype(np.float32)
    before = (dw_pw.dw_pw_fused.launches, dw_pw.dw_pw_fused.launches_bf16)
    got = dw_pw.dw_pw_fused(*map(torch.from_numpy, args), out_dtype=torch.bfloat16, **kw)
    assert (dw_pw.dw_pw_fused.launches, dw_pw.dw_pw_fused.launches_bf16) == before
    assert got.dtype == torch.bfloat16 and got.shape == (n, h, w, co)
    assert_bf16_close(got.float().numpy(), want, "dw_pw_fused bf16 out")

    def fma(acc, scale=None, bias=None, act=None):
        return gemm.apply_act((acc.double() * scale.double() + bias.double()).float(), act)

    monkeypatch.setattr(dw_pw, "epilogue", fma)
    got = dw_pw.dw_pw_fused(*map(torch.from_numpy, args), out_dtype=torch.bfloat16, **kw)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_bf16_kernel_refusals():
    a = torch.zeros((2, 3), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="writes"):
        gemm.fused_gemm(a, torch.zeros((3, 4), dtype=torch.bfloat16),
                        out_dtype=torch.float32)
    with pytest.raises(ValueError, match="cannot write"):
        conv_direct.conv2d_direct(torch.zeros((1, 3, 3, 4)), torch.zeros((4, 4, 3, 3)),
                                  out_dtype=torch.bfloat16)


@pytest.mark.parametrize("x_dtype,w_dtype,out_dtype,match", [
    (torch.bfloat16, torch.float32, None, "takes"),       # bf16 x needs a bf16 or int8 w
    (torch.float32, torch.bfloat16, None, "takes"),
    (torch.bfloat16, torch.bfloat16, torch.float32, "cannot write"),
    (torch.bfloat16, torch.int8, torch.bfloat16, "scale"),  # an int8 w without its scale
])
def test_conv2d_direct_bf16_x_refusals(x_dtype, w_dtype, out_dtype, match):
    """3f-bf16 takes bfloat16 x with a bfloat16 or int8 weight and writes
    bfloat16; other combinations raise on every device, before the CPU
    route."""
    x = torch.zeros((1, 5, 5, 8), dtype=x_dtype)
    w = torch.zeros((4, 8, 3, 3), dtype=w_dtype)
    with pytest.raises(ValueError, match=match):
        conv_direct.conv2d_direct(x, w, out_dtype=out_dtype)


def test_dw_pw_fused_bf16_out_refusals():
    """A bfloat16 out_dtype with s_out (int8 codes out), and an out_dtype
    other than float32 or bfloat16, raise in the wrapper and the plain
    version alike."""
    from test_torch_port_kernels import _dw_pw_inputs

    from pyopenvino_tpu_torch.kernels import dw_pw

    args = [torch.from_numpy(a) for a in _dw_pw_inputs(1, 5, 5, 8, 16)]
    for fn in (dw_pw.dw_pw_fused, dw_pw.dw_pw_fused_plain):
        with pytest.raises(ValueError, match="s_out"):
            fn(*args, s_mid=0.05, s_out=0.04, out_dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="out_dtype"):
            fn(*args, s_mid=0.05, out_dtype=torch.float16)


@pytest.mark.parametrize("m,n", [(1, 1000), (64, 1000), (3, 10), (7, 129)])
def test_softmax_rows_bf16_plain_matches_pallas(m, n):
    """softmax_rows in bfloat16: loads widened to float32, one rounding of
    the result (the Pallas kernel's 16-row bf16 tiles compute the same)."""
    from pyopenvino_tpu.kernels.softmax import softmax_rows as jax_softmax_rows

    x = torch.from_numpy(
        (np.random.default_rng(m * n).standard_normal((m, n)) * 8).astype(np.float32)).bfloat16()
    got = softmax.softmax_rows(x)
    assert got.dtype == torch.bfloat16
    want = jax_softmax_rows(_jbf16(x), interpret=True)
    assert_bf16_close(got.float().numpy(), _f32(want), "softmax_rows bf16")


# -- ops: emit on bfloat16 inputs against the JAX package's emit ------------

def _ctxs(static, n_inputs=1):
    """(port ctx, JAX ctx) with compute_dtype bfloat16 for node 0 with
    ``n_inputs`` data inputs and the constant ports of ``static``; the JAX
    one lowers as on the CPU (interpret)."""
    import jax.numpy as jnp

    def static_value(node, port):
        return static[port]

    ports = {p: None for p in (*range(n_inputs), *static)}
    port = types.SimpleNamespace(
        compute_dtype=torch.bfloat16, use_kernels=False, full_int8=False,
        act_scale=lambda node: None, depthwise_mode="native", static_value=static_value,
        weight_for=lambda node, tv: tv.arr,
        model=types.SimpleNamespace(in_edges={0: ports}))
    jax_ctx = types.SimpleNamespace(
        compute_dtype=jnp.bfloat16, use_pallas=False, pallas_interpret=True,
        full_int8=False, act_scale=lambda node: None, static_value=static_value,
        out_int8_scale=lambda node: None, weight_for=lambda node, tv: tv.arr,
        config=types.SimpleNamespace(depthwise_mode="native"))
    return port, jax_ctx


def _port_in(x, activation=True):
    """A bfloat16 activation (4-D ones channels_last) or weight; integer
    arrays as they are."""
    if not np.issubdtype(x.dtype, np.floating):
        return TValue(torch.from_numpy(x))
    t = torch.from_numpy(x).bfloat16()
    if activation and t.dim() == 4:
        t = t.contiguous(memory_format=torch.channels_last)
    return TValue(t)


def _jax_in(x, activation=True):
    import jax.numpy as jnp

    arr = jnp.asarray(x, jnp.bfloat16) if np.issubdtype(x.dtype, np.floating) else jnp.asarray(x)
    if activation and x.ndim == 4 and np.issubdtype(x.dtype, np.floating):
        return JaxTValue(arr.transpose(0, 2, 3, 1), "CL")
    return JaxTValue(arr, "L")


def _pool(kind, kernel, strides, pads, rounding="floor", exclude="true"):
    return (kind, {"kernel": kernel, "strides": strides, "pads_begin": pads,
                   "pads_end": pads, "rounding_type": rounding, "exclude-pad": exclude},
            [(2, 8, 9, 9)], {})


_CONV = {"strides": "1,1", "pads_begin": "1,1", "pads_end": "1,1", "dilations": "1,1"}
_FQ_RANGES = [np.array(v, np.float32) for v in (-1.5, 1.5, -1.5, 1.5)]

# (op type, attrs, data input shapes (float, seeded normal) or arrays,
#  {port: compile-time constant})
OP_CASES = {
    "Convolution": ("Convolution", _CONV, [(1, 16, 9, 9), (24, 16, 3, 3)], {}),
    "GroupConvolution": ("GroupConvolution", _CONV, [(1, 16, 9, 9), (16, 1, 1, 3, 3)], {}),
    "MatMul": ("MatMul", {"transpose_a": "false", "transpose_b": "true"},
               [(3, 64), (40, 64)], {}),
    "Add": ("Add", {}, [(2, 8, 5, 5), (1, 8, 1, 1)], {}),
    "Multiply": ("Multiply", {}, [(2, 8, 5, 5), (1, 8, 1, 1)], {}),
    "Subtract": ("Subtract", {}, [(2, 3, 5, 5), (1, 3, 1, 1)], {}),
    "Divide": ("Divide", {}, [(2, 3, 5, 5), np.array([[[[2.0]], [[3.0]], [[5.0]]]],
                                                    np.float32)], {}),
    "ReLU": ("ReLU", {}, [(2, 8, 5, 5)], {}),
    "Clamp": ("Clamp", {"min": "0", "max": "0.6"}, [(2, 8, 5, 5)], {}),
    "Sigmoid": ("Sigmoid", {}, [(4, 33)], {}),
    "SoftMax": ("SoftMax", {"axis": "1"}, [(4, 1000)], {}),
    "Swish": ("Swish", {"beta": "1.0"}, [(2, 8, 5, 5)], {}),
    "LRN": ("LRN", {"alpha": "0.0001", "beta": "0.75", "bias": "1", "size": "5",
                    "region": "across"}, [(2, 16, 7, 9)], {1: np.array([1], np.int64)}),
    "MaxPool": _pool("MaxPool", "3,3", "2,2", "1,1"),
    "AvgPool": _pool("AvgPool", "3,3", "1,1", "1,1"),
    "AvgPool_global": ("AvgPool", {"kernel": "7,7", "strides": "1,1", "pads_begin": "0,0",
                                   "pads_end": "0,0", "rounding_type": "floor",
                                   "exclude-pad": "true"}, [(2, 32, 7, 7)], {}),
    "ReduceMean": ("ReduceMean", {"keep_dims": "true"}, [(2, 32, 7, 7)],
                   {1: np.array([2, 3], np.int64)}),
    "FakeQuantize": ("FakeQuantize", {"levels": "256"}, [(2, 8, 5, 5)] + _FQ_RANGES, {}),
    "Split": ("Split", {"num_splits": "2"}, [(2, 8, 5, 5)], {1: np.array(1, np.int64)}),
    "VariadicSplit": ("VariadicSplit", {}, [(2, 8, 5, 5)],
                      {1: np.array(1, np.int64), 2: np.array([3, -1], np.int64)}),
    "Concat": ("Concat", {"axis": "1"}, [(2, 3, 5, 5), (2, 5, 5, 5)], {}),
    "Reshape": ("Reshape", {"special_zero": "true"}, [(2, 8, 5, 5)],
                {1: np.array([0, -1], np.int64)}),
    "Transpose": ("Transpose", {}, [(2, 8, 5, 6)], {1: np.array([0, 2, 3, 1], np.int64)}),
    "Unsqueeze": ("Unsqueeze", {}, [(2, 40)], {1: np.array([0], np.int64)}),
    "StridedSlice": ("StridedSlice", {"begin_mask": "0", "end_mask": "0"}, [(2, 8, 5, 5)],
                     {1: np.array([0, 2], np.int64), 2: np.array([2, 6], np.int64),
                      3: np.array([1, 1], np.int64)}),
    "Convert": ("Convert", {"destination_type": "f32"},
                [np.arange(24, dtype=np.uint8).reshape(1, 2, 3, 4)], {}),
    "Gather": ("Gather", {}, [(1, 3, 4, 5), np.array([2, 1, 0], np.int64)],
               {2: np.array(1, np.int64)}),
    "Interpolate_linear": ("Interpolate", {"axes": "2,3", "mode": "linear",
                                           "align_corners": "1"},
                           [(1, 3, 12, 10)], {1: np.array([8, 7], np.int64)}),
    "Interpolate_nearest": ("Interpolate", {"axes": "2,3", "mode": "nearest",
                                            "align_corners": "0"},
                            [(1, 3, 5, 6)], {1: np.array([10, 9], np.int64)}),
}


def _op_inputs(shapes, seed):
    rng = np.random.default_rng(seed)
    return [s if isinstance(s, np.ndarray) else
            np.asarray(rng.standard_normal(s), np.float32) for s in shapes]


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_op_bf16_matches_jax(case):
    """Each ported op on bfloat16 inputs (compute_dtype bfloat16): the
    output dtype and values of the JAX package's emit on the same inputs,
    within one bfloat16 step (XLA may keep an elementwise chain in float32
    before its one rounding, where PyTorch rounds each step)."""
    op_type, attrs, shapes, static = OP_CASES[case]
    arrays = _op_inputs(shapes, len(case))
    n_out = 3 if op_type in ("Split", "VariadicSplit") else 1
    out_ports = {p: None for p in range(len(arrays) + len(static), len(arrays) + len(static)
                                        + n_out)}
    kw = dict(id=0, name="n", op_type=op_type, attrs=attrs, inputs={}, outputs=out_ports)
    node, jnode = port_ir.Node(**kw), jax_ir.Node(**kw)
    if op_type in ("Split", "VariadicSplit"):
        node = port_ir.Node(**{**kw, "outputs": {2: None, 3: None}})
        jnode = jax_ir.Node(**{**kw, "outputs": {2: None, 3: None}})
    pctx, jctx = _ctxs(static, len(arrays))
    weight = op_type in ("Convolution", "GroupConvolution", "MatMul")
    ins = {i: _port_in(a, not (weight and i == 1)) for i, a in enumerate(arrays)}
    jins = {i: _jax_in(a, not (weight and i == 1)) for i, a in enumerate(arrays)}
    got = get_op(op_type).emit(pctx, node, ins)
    want = jax_get_op(op_type).emit(jctx, jnode, jins)
    assert sorted(got) == sorted(want)
    for port in got:
        g, w = got[port].arr, want[port]
        w_arr = w.nchw() if w.layout == "CL" else w.arr
        assert str(g.dtype).split(".")[-1] == str(w_arr.dtype), (port, g.dtype, w_arr.dtype)
        equal = assert_bf16_close(g.float().numpy(), _f32(w_arr), f"{case} port {port}")
        print(f"{case}: output {port} {str(w_arr.dtype)}, {equal:.4f} bit-equal to JAX's")


def test_detection_output_bf16_matches_jax():
    """DetectionOutput (SSD's last op) on bfloat16 box logits and
    confidences (tests/test_detection.py's seeded case): both packages
    widen them to float32 first, so the batched records agree as the
    float32 ones do (tests/test_torch_port_ssd.py's tolerances)."""
    import jax.numpy as jnp

    from pyopenvino_tpu.ops import ssd as jax_ssd
    from test_detection import _make_case
    from test_torch_port_ssd import DO_ATOL, DO_RTOL

    from pyopenvino_tpu_torch.ops import ssd

    logits, scores, proposals, p = _make_case(3, P=96)
    lb, sb = (torch.from_numpy(a).bfloat16() for a in (logits, scores))
    got = ssd.detection_output_torch(lb, sb, torch.from_numpy(proposals), p).numpy()
    want = np.asarray(jax_ssd.detection_output_jax_batched(
        _jbf16(lb), _jbf16(sb), jnp.asarray(proposals), p))
    assert got.dtype == np.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=DO_RTOL, atol=DO_ATOL)


# -- full-width ResNet-18 ------------------------------------------------------

class Bf16Case:
    """One model's logits (its SoftMax cut out) on one seeded image in the
    three quant modes with compute_dtype="bfloat16", from both packages;
    INT8-FULL calibrated on 2 seeded samples in both (none where
    ``calibrate`` is False: a POT IR's scales come from its FakeQuantizes),
    with ``int8full_config``'s further Config fields (bias correction).
    Inputs are uniform in [0, ``high``) at the model's one Parameter.  The
    JAX package's float32 logits (its XLA backend's for both pairs:
    PALLAS's float32 logits lie within 1e-6 of them in FP32 and INT8W, and
    INT8-FULL's differ by the same fused multiply-add ties on both) give the
    bfloat16-vs-float32 distance that the port's distance to JAX's bfloat16
    is held inside.  Each network is compiled once.  ``cut`` makes the
    logits model of a parsed IR in either package (``logits_model``: the
    first SoftMax cut out)."""

    def __init__(self, paths, seed, high=1.0, calibrate=True, cut=None, **int8full_config):
        cut = cut or logits_model
        self.model = cut(read_ir_model(*paths), port_ir)
        self.jax_model = cut(jax_read(*paths), jax_ir)
        self.out = self.model.results[0].name
        param = self.model.parameters[0]
        self.input = param.name
        shape = param.outputs[param.out_port].shape
        rng = np.random.default_rng(seed)
        self.samples = [{param.name: rng.uniform(0, high, shape).astype(np.float32)}
                        for _ in range(2)]
        self.x = {param.name: rng.uniform(0, high, shape).astype(np.float32)}
        self.calibrate, self.int8full_config = calibrate, int8full_config
        self._jax, self._jax_nets, self._port = {}, {}, {}

    def _settings(self, quant):
        """(calibration samples, further Config fields) of a quant mode."""
        if quant != QuantMode.INT8_FULL:
            return None, {}
        return self.samples if self.calibrate else None, self.int8full_config

    def jax_net(self, backend, quant, dtype):
        if dtype == "float32":
            backend = JaxBackend.XLA
        key = (backend, quant, dtype)
        if key not in self._jax_nets:
            samples, extra = self._settings(quant)
            self._jax_nets[key] = jax_compile(
                self.jax_model, JaxConfig(backend=backend, quant=JaxQuantMode(quant.value),
                                          compute_dtype=dtype, **extra),
                calibration_samples=samples)
        return self._jax_nets[key]

    def jax(self, backend, quant, dtype):
        key = (JaxBackend.XLA if dtype == "float32" else backend, quant, dtype)
        if key not in self._jax:
            self._jax[key] = _f32(self.jax_net(backend, quant, dtype).infer(self.x)[self.out])
        return self._jax[key]

    def port_net(self, backend, quant):
        if (backend, quant) not in self._port:
            samples, extra = self._settings(quant)
            self._port[backend, quant] = compile_model(
                self.model, Config(backend=backend, quant=quant, compute_dtype="bfloat16",
                                   **extra),
                device="cpu", calibration_samples=samples)
        return self._port[backend, quant]

    def port(self, backend, quant):
        net = self.port_net(backend, quant)
        return net, net.infer(self.x)[self.out]


def _dist(a, b):
    """(max |a - b| / max |b|, mean |a - b| / mean |b|)."""
    d = np.abs(a.astype(np.float64) - b)
    return float(d.max() / np.abs(b).max()), float(d.mean() / np.abs(b).mean())


BACKEND_PAIRS = [(Backend.TORCH, JaxBackend.XLA), (Backend.KERNELS, JaxBackend.PALLAS)]
QUANTS = [QuantMode.NONE, QuantMode.INT8_WEIGHT, QuantMode.INT8_FULL]


def check_bf16_case(case, backend, jax_backend, quant, got=None):
    """The port's bfloat16 logits against the JAX package's bfloat16 ones.

    bfloat16 rounds every activation to 8 significant bits; a float32 sum
    taken in another order than XLA's (oneDNN's or cuBLAS's, the kernels')
    flips a rounding now and then, and each flip spreads: over the layers
    of a deep network two bfloat16 runs that agree layer for layer on
    99.99 % of the first layers' values still drift apart by about half
    as much as bfloat16 lies from float32 (ResNet-18: 5e-3 of the mean
    |logit| against 9e-3).  So the gate is relative to the reference's
    own bfloat16 error: the port's mean distance to JAX's bfloat16 logits
    below 0.8 of JAX's bfloat16-vs-float32 mean distance (a port that
    rounded elsewhere, such as a float32 average pool, moves toward
    float32 and fails it), the same top-1 unless JAX's own top two lie
    within its bfloat16 error of each other, and finite values.

    INT8-FULL on TORCH stores int8 between ops where XLA does, and there
    XLA may keep a float32 value (its excess precision) where the port
    rounds to bfloat16 before the requantize, on top of the fused
    multiply-add ties of the float32 run (ROADMAP §3, fault 1: 1e-2 of
    max |logit| already in float32): there the gate is JAX's own
    bfloat16-vs-float32 distance itself.  ``got``: the port's logits when
    the caller ran them itself (JAX's FakeQuantize outputs forced in)."""
    int8_stored = quant == QuantMode.INT8_FULL and backend == Backend.TORCH
    if got is None:
        net, got = case.port(backend, quant)
    else:  # logits the caller ran (FakeQuantize outputs forced in)
        net = case.port_net(backend, quant)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    want = case.jax(jax_backend, quant, "bfloat16")
    f32 = case.jax(jax_backend, quant, "float32")
    port_jax, jax_f32 = _dist(got, want), _dist(want, f32)
    print(f"{quant.value} {backend.value} vs {jax_backend.value}: port bf16 vs JAX bf16 "
          f"max {port_jax[0]:.3e} mean {port_jax[1]:.3e}; JAX bf16 vs JAX f32 max "
          f"{jax_f32[0]:.3e} mean {jax_f32[1]:.3e}; top-1 {got.argmax()} {want.argmax()} "
          f"(f32 {f32.argmax()})")
    assert port_jax[1] < (1.0 if int8_stored else 0.8) * jax_f32[1]
    for g, w in zip(got, want):
        if g.argmax() != w.argmax():
            margin = (w.max() - w[g.argmax()]) / np.abs(w).max()
            assert margin <= jax_f32[0], (margin, jax_f32[0])
    return net, got, want


def jax_without_excess_precision(case_args, backend, quant, tmp_path):
    """The JAX package's bfloat16 logits of ``Bf16Case(*case_args[0],
    **case_args[1])`` with XLA's excess precision off, so that XLA rounds
    every bfloat16 op's result to bfloat16 as the program's dtypes say,
    where by default its CPU fusions keep float32 between them: computed in
    a subprocess, since XLA reads the flag when its CPU backend starts."""
    import json
    import os
    import subprocess
    import sys

    out = tmp_path / "jax_logits.npy"
    script = (
        "import json, sys\n"
        "import numpy as np\n"
        "from pyopenvino_tpu.config import Backend as JaxBackend\n"
        "from pyopenvino_tpu_torch.config import QuantMode\n"
        "from test_torch_port_bf16 import Bf16Case\n"
        "args, kw, backend, quant, out = json.loads(sys.argv[1])\n"
        "case = Bf16Case(*args, **kw)\n"
        "np.save(out, case.jax(JaxBackend(backend), QuantMode(quant), 'bfloat16'))\n")
    tests = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": os.environ.get("XLA_FLAGS", "") + " --xla_allow_excess_precision=false",
           "PYTHONPATH": os.pathsep.join([tests, os.path.dirname(tests),
                                          os.environ.get("PYTHONPATH", "")])}
    subprocess.run([sys.executable, "-c", script,
                    json.dumps([list(case_args[0]), case_args[1], backend.value, quant.value,
                                str(out)])], env=env, check=True, timeout=900)
    return np.load(out)


@pytest.fixture(scope="module")
def resnet18_case():
    return Bf16Case(resnet18_paths(seed=0), seed=3)


@pytest.mark.parametrize("quant", QUANTS, ids=lambda q: q.value)
@pytest.mark.parametrize("backend,jax_backend", BACKEND_PAIRS, ids=["torch", "kernels"])
def test_resnet18_bf16_matches_jax(resnet18_case, backend, jax_backend, quant):
    check_bf16_case(resnet18_case, backend, jax_backend, quant)


def test_resnet18_bf16_int8full_kernels_equal_pallas(resnet18_case, monkeypatch):
    """KERNELS INT8-FULL in bfloat16: exact int32 sums, the float32
    epilogue rounded once to bfloat16, so the logits equal the JAX
    package's PALLAS run bit for bit (with XLA's fused multiply-add
    epilogue patched in, which here changes no code)."""
    xla_fma_epilogue(monkeypatch)
    _, got = resnet18_case.port(Backend.KERNELS, QuantMode.INT8_FULL)
    np.testing.assert_array_equal(
        got, resnet18_case.jax(JaxBackend.PALLAS, QuantMode.INT8_FULL, "bfloat16"))


def test_resnet18_bf16_kernel_routes(resnet18_case, monkeypatch):
    """Each bf16 path reaches its variants, at ResNet-18's launch counts:
    FP32 4 fused_gemm_bf16, INT8W 4 fused_gemm_bf16_i8w, INT8-FULL 8
    int8 × int8 GEMMs and 13 conv2d_direct with bfloat16 outputs."""
    check_bf16_routes(resnet18_case, monkeypatch, {
        QuantMode.NONE: {"fused_gemm_bf16": 4},
        QuantMode.INT8_WEIGHT: {"fused_gemm_bf16_i8w": 4},
        QuantMode.INT8_FULL: {"fused_gemm_i8i8_bf16": 8, "conv2d_direct_bf16": 13},
    })


# kernel calls seen by the plain versions' spies → the bf16 variant's name
# in chip_smoke.py's launch counters
SPY_VARIANTS = {
    ("gemm", "torch.bfloat16", "torch.bfloat16", "torch.bfloat16"): "fused_gemm_bf16",
    ("gemm", "torch.bfloat16", "torch.int8", "torch.bfloat16"): "fused_gemm_bf16_i8w",
    ("gemm", "torch.int8", "torch.int8", "torch.bfloat16"): "fused_gemm_i8i8_bf16",
    ("direct", "torch.int8", "torch.bfloat16"): "conv2d_direct_bf16",
}


def check_bf16_routes(case, monkeypatch, expected):
    """One KERNELS forward of the case's logits model in each quant mode of
    ``expected`` ({quant: {bf16 variant: calls}}) reaches those variants,
    and nothing else, as many times (each wrapper hands its CPU call to its
    plain version, spied on here); chip_smoke.py's expectation on the card
    (``compiled_per_forward`` in its bf16 variants) says the same."""
    import chip_smoke

    seen = []
    plain_gemm, plain_direct = gemm.fused_gemm_plain, conv_direct.conv2d_direct_plain

    def gemm_spy(a, b, scale=None, bias=None, act=None, out_dtype=None):
        out = plain_gemm(a, b, scale, bias, act, out_dtype)
        seen.append(("gemm", str(a.dtype), str(b.dtype), str(out.dtype)))
        return out

    def direct_spy(*args, **kw):
        out = plain_direct(*args, **kw)
        seen.append(("direct", str(args[0].dtype), str(out.dtype)))
        return out

    monkeypatch.setattr(gemm, "fused_gemm_plain", gemm_spy)
    monkeypatch.setattr(conv_direct, "conv2d_direct_plain", direct_spy)
    for quant, want in expected.items():
        seen.clear()
        net, _ = case.port(Backend.KERNELS, quant)
        assert {SPY_VARIANTS[k]: seen.count(k) for k in set(seen)} == want, quant
        per_forward = chip_smoke.compiled_per_forward(net, quant.value, 0)
        assert {chip_smoke.BF16_VARIANT[k]: c for k, c in per_forward.items() if c} == want


# -- weights across ----------------------------------------------------------

def test_load_weights_from_jax_bf16_checkpoint(tmp_path):
    """The JAX package's save_weights under INT8 weight-only with bfloat16
    compute (bfloat16 arrays as ``::bf16``-tagged uint16 views, int8 codes,
    bfloat16 scales) loads into the port's network: the same bits in every
    weight, and outputs that move with them to the JAX package's.  On
    ``mnist_bn`` (assets/trained: the MNIST graph with its BN scales, which
    both packages fold into the convs first), as tests/test_review_fixes.py
    does on mnist, whose IR lives outside the repository."""
    import os

    trained = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "assets", "trained")
    xml, binp = (os.path.join(trained, f"mnist_bn.{e}") for e in ("xml", "bin"))
    cfg = dict(quant=QuantMode.INT8_WEIGHT, compute_dtype="bfloat16")
    ref = jax_compile(jax_read(xml, binp), JaxConfig(quant=JaxQuantMode.INT8_WEIGHT,
                                                     compute_dtype="bfloat16"))
    rng = np.random.default_rng(9)
    ref.weights = {k: v if str(v.dtype) != "bfloat16" else
                   (v.astype(np.float32) * np.float32(rng.uniform(0.8, 1.2))).astype(v.dtype)
                   for k, v in ref.weights.items()}
    ckpt = str(tmp_path / "mnist_int8w_bf16.npz")
    ref.save_weights(ckpt)
    with np.load(ckpt) as data:
        assert any(k.endswith("::bf16") for k in data.files)

    net = compile_model(read_ir_model(xml, binp), Config(**cfg), device="cpu")
    x = {"conv2d_input": rng.uniform(0, 255, (1, 1, 28, 28)).astype(np.float32)}
    before = net.infer(x)
    net.load_weights(ckpt)
    for k, v in ref.weights.items():
        assert str(net.weights[k].dtype).split(".")[-1] == str(v.dtype), k
        np.testing.assert_array_equal(net.weights[k].float().numpy(),
                                      np.asarray(v, np.float32))
    after = net.infer(x)
    want = ref.infer(x)
    for k in want:
        assert np.abs(after[k] - before[k]).max() > 0
        np.testing.assert_allclose(after[k], np.asarray(want[k], np.float32),
                                   rtol=0, atol=2.0 ** -8 * np.abs(want[k]).max())
