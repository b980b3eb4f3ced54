"""fused_gemm's tensor-core variants, what the CPU can check of them.

* The float32-A kernels (csrc/f32_mma.cuh) multiply on the TF32 tensor
  cores.  Against an int8 B (#1w) A is split in two TF32 terms, its hi term
  cvt.rna.tf32(a) and its lo term cvt.rna.tf32(a - hi); against a float32 B
  (#1) B is split too, each term cut toward zero (hi = a's top 11
  significant bits, lo = the top 11 of a - hi), and three products
  (a_lo·b_hi, a_hi·b_lo, a_hi·b_hi) go into one float32 accumulator.  An
  emulation here (mantissas rounded to 10 bits as the kernel rounds them;
  float32 sums of eight products, one m16n8k8 at a time, in the kernel's
  order of terms) shows at the main paths' shapes, and at kernel 3f's conv
  shapes up to K = 4608, that those terms stay within the card's gates of
  the float64 product and that one TF32 pass does not: the gates' reason.
* The split-K planner (kernels/gemm.py::split_k) is plain Python.
* The int8 × int8 variant and conv2d_direct on int8 codes take B K-major;
  the wrappers refuse a row-major int8 B with int8 activations on every
  device, and the compiled network caches the K-major copy in place of the
  (K, N) one.

Inputs are made with numpy from a seed; nothing here needs a card.
"""

import types

import numpy as np
import pytest
import torch

import pyopenvino_tpu_torch.ir.model as port_ir
from pyopenvino_tpu_torch.kernels import gemm
from pyopenvino_tpu_torch.kernels.conv import (
    conv2d_fused, conv_weight_matrix, conv_weight_matrix_nk,
)
from pyopenvino_tpu_torch.ops import TValue, get_op
import test_torch_port_threads  # noqa: F401  (this worker's torch threads)

I8W_RTOL = 2e-5  # tests/test_torch_port_gpu.py and chip_smoke.py hold the card to it
# the three-term float32-B product: its emulation stays within the int8-B
# gate; the card is held to 1e-4 of max |plain| (GEMM_RTOL there)
F32_RTOL = 2e-5

# (M, K, N) of the float32-A launches at batch 1, int8 B (#1w) and float32 B
# (#1) alike: ResNet-18's shortcuts and FC, MobileNet-v2's 1×1 convs and FC
# (chip_smoke.py's tables), SSD's 1×1 convs
PATH_SHAPES = [(784, 64, 128), (196, 128, 256), (49, 256, 512), (1, 512, 1000),
              (196, 64, 384), (196, 96, 576), (49, 576, 160), (49, 160, 960),
              (49, 960, 160), (49, 960, 320), (49, 320, 1280), (1, 1280, 1000),
              (100, 128, 256), (100, 256, 256), (361, 64, 128), (361, 128, 128)]


def tf32_rna(x):
    """float32 → TF32 (10 mantissa bits), to nearest, ties away from zero:
    PTX cvt.rna.tf32.f32."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_trunc(x):
    """float32 → TF32 cut toward zero: the low 13 mantissa bits masked off."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _to_f32(v, trunc):
    """float64 → float32, to nearest, or (trunc) toward zero."""
    f = v.astype(np.float32)
    if trunc:
        over = np.abs(f.astype(np.float64)) > np.abs(v)
        f[over] = np.nextafter(f[over], np.float32(0))
    return f


def tc_product(a, b, terms, kchunk, trunc=False):
    """The kernel's product emulated: ``terms`` TF32 products (1: one pass,
    both operands rounded to nearest; 2: the int8-B kernel's a_lo·b, a_hi·b,
    A's terms rounded to nearest; 3: the float32-B kernel's a_lo·b_hi,
    a_hi·b_lo, a_hi·b_hi, every term cut toward zero), each m16n8k8 step
    adding eight exact products to a float32 accumulator, rounded to nearest
    or (trunc) toward zero, K cut into splits of ``kchunk`` added in order
    (to nearest, as the split-K reduction adds them)."""
    if terms == 3:
        a_hi, b_hi = tf32_trunc(a), tf32_trunc(b)
        a_lo, b_lo = tf32_trunc(a - a_hi), tf32_trunc(b - b_hi)
        pairs = [(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)]
    else:
        a_hi = tf32_rna(a)
        pairs = ([(a_hi, tf32_rna(b))] if terms == 1
                 else [(tf32_rna(a - a_hi), b), (a_hi, b)])
    k = a.shape[1]
    out = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0, k1 in gemm.split_ranges(k, kchunk):
        acc = np.zeros_like(out)
        for s in range(k0, k1, 8):
            for pa, pb in pairs:
                step = pa[:, s:min(s + 8, k1)].astype(np.float64) @ pb[s:min(s + 8, k1)]
                acc = _to_f32(acc.astype(np.float64) + step, trunc)
        out = (out.astype(np.float64) + acc).astype(np.float32)
    return out


@pytest.mark.parametrize("m,k,n", PATH_SHAPES)
def test_two_tf32_terms_meet_the_i8w_gate_and_one_does_not(m, k, n):
    rng = np.random.default_rng(m * 7 + k + n)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.integers(-127, 128, (k, n)).astype(np.float64)
    exact = a.astype(np.float64) @ b
    kchunk = gemm.split_k(m, k, n, gemm.PLANS["fused_gemm_f32_i8w"])

    def rel(got):
        return np.abs(got - exact).max() / np.abs(exact).max()

    two, one = rel(tc_product(a, b, 2, kchunk)), rel(tc_product(a, b, 1, kchunk))
    assert two <= I8W_RTOL / 4, two
    assert one > I8W_RTOL, one


@pytest.mark.parametrize("m,k,n", PATH_SHAPES)
def test_three_tf32_terms_meet_the_f32_gate_and_one_does_not(m, k, n):
    rng = np.random.default_rng(m * 5 + k + n)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    kchunk = gemm.split_k(m, k, n, gemm.PLANS["fused_gemm_f32"])

    def rel(got):
        return np.abs(got - exact).max() / np.abs(exact).max()

    three, one = rel(tc_product(a, b, 3, kchunk)), rel(tc_product(a, b, 1, kchunk))
    assert three <= F32_RTOL / 4, three
    assert one > F32_RTOL, one


# Kernel 3f (conv2d_direct on float32, csrc/f32_mma.cuh's loop with an
# implicit-im2col A) at ResNet-18's stride-1 3×3 convs, (batch, H = W,
# Ci = Co): K = 9·Ci = 576 ... 4608, 3.6× the longest K of #1.  At B = 1 the
# plan splits K; at B = 64 every chain runs the whole K.  The card holds 3f
# to 1e-4 of max |plain| with either weight type.  Its errors on an H100
# follow the accumulator cut toward zero after every mma (3.8e-5 at K =
# 4608 against this model's 4.2e-5; to nearest it would be 1.7e-6), so the
# tests hold both models: nearest within the GEMMs' own bounds, toward zero
# within half the card's gate.
CONV_SHAPES = [(b, hw, c) for b in (1, 64) for hw, c in ((56, 64), (28, 128), (14, 256),
                                                         (7, 512))]
CONV_RTOL = 1e-4


def _conv_errors(b, hw, c, terms, seed):
    """Relative errors against float64 of ``terms`` TF32 terms (accumulator
    to nearest, then toward zero) and of one term, at one conv shape's
    implicit GEMM (M = b·hw², K = 9c, N = c), on its first 64 rows and 128
    columns (rows and columns are independent sums), with kernel 3f's split
    plan.  terms = 3: a float32 weight; 2: an int8 one."""
    m, k, n = b * hw * hw, 9 * c, c
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((min(m, 64), k)).astype(np.float32)
    if terms == 3:
        w = (rng.standard_normal((k, min(n, 128))) / np.sqrt(k)).astype(np.float32)
    else:
        w = rng.integers(-127, 128, (k, min(n, 128))).astype(np.float64)
    exact = a.astype(np.float64) @ w.astype(np.float64)
    kchunk = gemm.split_k(m, k, n, gemm.PLANS["conv2d_direct_f32"])

    def rel(got):
        return np.abs(got - exact).max() / np.abs(exact).max()

    return (rel(tc_product(a, w, terms, kchunk)), rel(tc_product(a, w, terms, kchunk, True)),
            rel(tc_product(a, w, 1, kchunk)))


@pytest.mark.parametrize("b,hw,c", CONV_SHAPES)
def test_three_tf32_terms_meet_the_f32_gate_at_conv_k(b, hw, c):
    three, cut, one = _conv_errors(b, hw, c, 3, seed=b + hw + c)
    assert three <= F32_RTOL / 4, three
    assert cut <= CONV_RTOL / 2, cut
    assert one > CONV_RTOL, one


@pytest.mark.parametrize("b,hw,c", CONV_SHAPES)
def test_two_tf32_terms_meet_the_gate_at_conv_k_with_an_int8_weight(b, hw, c):
    two, cut, one = _conv_errors(b, hw, c, 2, seed=3 * b + hw + c)
    assert two <= I8W_RTOL / 4, two
    assert cut <= CONV_RTOL / 2, cut
    assert one > CONV_RTOL, one


def test_tf32_rna_rounds_to_ten_bits_ties_away():
    one_ulp = 2.0 ** -10
    x = np.array([1 + one_ulp / 2, -(1 + one_ulp / 2), 1 + one_ulp / 4, 3.0], np.float32)
    np.testing.assert_array_equal(tf32_rna(x), [1 + one_ulp, -(1 + one_ulp), 1.0, 3.0])
    np.testing.assert_array_equal(tf32_trunc(x), [1.0, -1.0, 1.0, 3.0])
    codes = np.arange(-127, 128, dtype=np.float32)  # int8 codes are exact in TF32
    np.testing.assert_array_equal(tf32_rna(codes), codes)


# -- the split-K planner -------------------------------------------------------

@pytest.mark.parametrize("entry", sorted(gemm.PLANS))
@pytest.mark.parametrize("m,k,n", [
    (1, 1280, 1000), (64, 1280, 1000), (49, 2304, 512), (1, 2304, 512), (64, 512, 1000),
    (1, 27, 32), (3, 1, 5), (784, 576, 128), (196, 1152, 256), (64 * 3136, 2304, 512),
    (64 * 12544, 147, 64), (37, 70, 129), (49, 960, 160),
])
def test_split_k_covers_k_in_steps(entry, m, k, n):
    plan = gemm.PLANS[entry]
    bm, bn, bk = plan.bm, plan.bn, plan.bk
    kchunk = gemm.split_k(m, k, n, plan)
    ranges = gemm.split_ranges(k, kchunk)
    assert kchunk % bk == 0 and len(ranges) >= 1
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    for (s0, e0), (s1, _) in zip(ranges, ranges[1:]):
        assert e0 == s1
    assert all(s % bk == 0 and e > s for s, e in ranges)
    assert len(ranges) <= gemm.MAX_SPLITS
    tiles = -(-m // bm) * -(-n // bn)
    if tiles >= plan.wave:
        assert len(ranges) == 1  # the grid already fills the card
    assert tiles * len(ranges) <= max(tiles, 2 * plan.wave)


def test_split_k_splits_small_grids_with_long_k():
    i8i8, i8w = gemm.PLANS["fused_gemm_i8i8"], gemm.PLANS["fused_gemm_f32_i8w"]
    assert len(gemm.split_ranges(2304, gemm.split_k(49, 2304, 512, i8i8))) > 4
    assert len(gemm.split_ranges(1280, gemm.split_k(64, 1280, 1000, i8w))) > 4
    assert len(gemm.split_ranges(960, gemm.split_k(3136, 960, 160, i8w))) > 1
    assert gemm.split_k(64 * 3136, 2304, 512, i8i8) >= 2304  # 200 tiles
    assert gemm.split_k(3136, 960, 160, i8i8) >= 960          # 75 tiles
    assert gemm.split_k(784, 144, 32, i8i8) >= 144            # 3 K steps
    assert gemm.split_k(1, 1280, 1000, i8w, sms=2) >= 1280    # 16 tiles fill 2 SMs
    direct, f32 = gemm.PLANS["conv2d_direct"], gemm.PLANS["fused_gemm_f32"]
    assert len(gemm.split_ranges(4608, gemm.split_k(49, 4608, 512, direct))) > 4  # 8 tiles
    assert len(gemm.split_ranges(2304, gemm.split_k(196, 2304, 256, direct))) > 4
    assert gemm.split_k(64 * 3136, 576, 64, direct) >= 576   # 1568 tiles
    assert len(gemm.split_ranges(512, gemm.split_k(1, 512, 1000, f32))) > 4
    assert gemm.split_k(64 * 784, 64, 128, f32) >= 64          # 1568 tiles


# -- K-major B for int8 × int8 -------------------------------------------------

def _codes(rng, shape):
    return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))


@pytest.mark.parametrize("m,k,n", [(5, 7, 3), (49, 2304, 512), (1, 147, 64), (65, 33, 1)])
def test_i8i8_wrapper_takes_k_major_b_and_refuses_row_major(m, k, n):
    rng = np.random.default_rng(m + k + n)
    a, b_nk = _codes(rng, (m, k)), _codes(rng, (n, k))
    scale = torch.from_numpy(rng.uniform(1e-4, 1e-2, n).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    act = ("clamp", 0.0, 6.0)
    k_major, row_major = b_nk.t(), b_nk.t().contiguous()
    got = gemm.fused_gemm(a, k_major, scale, bias, act)  # CPU: the plain version
    want = gemm.fused_gemm_plain(a, row_major, scale, bias, act)
    assert torch.equal(got, want)
    assert torch.equal(gemm.fused_gemm_plain(a, k_major, scale, bias, act), want)
    if n > 1:  # a (K, 1) matrix is both row-major and K-major
        with pytest.raises(ValueError, match="K-major"):
            gemm.fused_gemm(a, row_major, scale, bias, act)


def test_float_a_keeps_row_major_b():
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((4, 16)).astype(np.float32))
    b = _codes(rng, (16, 8))
    scale = torch.ones(8)
    torch.testing.assert_close(gemm.fused_gemm(a, b, scale), a @ b.float())


def test_conv_weight_matrix_nk_is_the_k_major_copy():
    rng = np.random.default_rng(5)
    w = _codes(rng, (64, 3, 7, 7))
    nk = conv_weight_matrix_nk(w)
    assert nk.is_contiguous() and nk.shape == (64, 147)
    assert torch.equal(nk.t(), conv_weight_matrix(w))
    x = _codes(rng, (1, 20, 20, 3))
    scale = torch.ones(64)
    # conv2d_fused builds the K-major operand itself for int8 codes
    got = conv2d_fused(x, w, scale=scale, strides=(2, 2), pads=((3, 3), (3, 3)))
    via = conv2d_fused(x, w, scale=scale, strides=(2, 2), pads=((3, 3), (3, 3)), wmat=nk.t())
    assert torch.equal(got, via)
    want = gemm.conv2d_int32(x.permute(0, 3, 1, 2), w, (2, 2), (1, 1), ((3, 3), (3, 3)))
    assert torch.equal(got, want.permute(0, 2, 3, 1).float())


def _recording_ctx(weight, cache):
    def derived_weight(node, port, tag, make):
        cache[tag] = make(weight)
        return cache[tag]

    return types.SimpleNamespace(use_kernels=True, full_int8=True, compute_dtype=torch.float32,
                                 act_scale=lambda node: None, derived_weight=derived_weight)


def _node(op_type, attrs):
    return port_ir.Node(id=0, name="n", op_type=op_type, attrs=attrs, inputs={},
                        outputs={2: None})


def _conv_attrs(s, p):
    return {"strides": f"{s},{s}", "pads_begin": f"{p},{p}", "pads_end": f"{p},{p}",
            "dilations": "1,1"}


@pytest.mark.parametrize("w_shape,stride,pad,int8_acts,tag", [
    ((128, 64, 3, 3), 2, 1, True, "gemm_nk"),     # fused_gemm_i8i8 through patches
    ((128, 64, 1, 1), 2, 0, True, "gemm_nk"),     # fused_gemm_i8i8, 1×1/s2
    ((32, 32, 3, 3), 1, 1, True, "gemm_nk"),      # conv2d_direct, on the same loop
    ((128, 64, 1, 1), 1, 0, False, "gemm_kn"),    # INT8 weight-only: fused_gemm_i8w
])
def test_conv_routes_cache_one_operand_of_the_same_size(w_shape, stride, pad, int8_acts, tag):
    rng = np.random.default_rng(sum(w_shape))
    co, ci = w_shape[:2]
    x, wq = _codes(rng, (2, ci, 9, 9)), _codes(rng, w_shape)
    qscale = torch.ones((co, 1, 1, 1))
    xt = (x if int8_acts else x.float()).contiguous(memory_format=torch.channels_last)
    cache = {}
    out = get_op("Convolution").emit_fused(
        _recording_ctx(wq, cache), _node("Convolution", _conv_attrs(stride, pad)),
        {0: TValue(xt, act_scale=1.0 if int8_acts else None), 1: TValue(wq, qscale=qscale)})[2]
    assert list(cache) == [tag]
    assert cache[tag].numel() == wq.numel() and cache[tag].dtype == torch.int8
    want = torch.nn.functional.conv2d(x.double(), wq.double(), stride=stride, padding=pad)
    np.testing.assert_array_equal(out.arr.double().numpy(), want.numpy())


@pytest.mark.parametrize("tb", [False, True])
def test_int8full_matmul_caches_the_k_major_operand(tb):
    rng = np.random.default_rng(7)
    a, wq = _codes(rng, (3, 40)), _codes(rng, (24, 40) if tb else (40, 24))
    qscale = torch.ones((24, 1) if tb else (1, 24))
    cache = {}
    node = _node("MatMul", {"transpose_a": "false", "transpose_b": str(tb).lower()})
    out = get_op("MatMul").emit_fused(
        _recording_ctx(wq, cache), node,
        {0: TValue(a, act_scale=1.0), 1: TValue(wq, qscale=qscale)})[2].arr
    tag = f"gemm_nk.{int(tb)}"
    assert list(cache) == [tag] and cache[tag].shape == (24, 40)
    assert cache[tag].is_contiguous()
    b = wq.t() if tb else wq
    np.testing.assert_array_equal(out.numpy(), (a.double() @ b.double()).numpy())
