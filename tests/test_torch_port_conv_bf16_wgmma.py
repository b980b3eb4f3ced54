"""conv2d_direct on bfloat16 x (kernel 3f-bf16) on the wgmma loop
(csrc/i8_wgmma.cuh on bf16 operands), what the CPU can check of it.

The loop itself runs only on a card (tests/test_torch_port_gpu.py, ``-k
conv_bf16_wgmma``, holds it to the plain version there).  What routes a
launch to it, its tile, slice, ring and splits are plain Python in
kernels/conv_direct.py (``direct_bf16_route``, ``direct_takes`` with 2-byte
x, ``direct_bf16_plan``); the producer's walk over K at 2-byte elements is
mirrored here (``_k_steps``), and so is the order in which the loop sums
(``_wgmma_sum``: exact bf16 products, a float32 accumulator added to once a
k16 step, the splits' float32 partials added in order), held to the plain
version and to the JAX package's Pallas kernel (interpret mode) within one
bfloat16 step; the profiler's names for the loop are in
runtime/profiling.py.  Nothing here needs a card.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pyopenvino_tpu_torch.kernels import conv_direct as cd
from pyopenvino_tpu_torch.kernels import gemm
from pyopenvino_tpu_torch.kernels.conv import conv_weight_matrix_nk
from pyopenvino_tpu_torch.kernels.conv_direct import (
    DIRECT_BF16_WGMMA_MIN_M, DIRECT_BF16_WGMMA_MIN_MACS, conv2d_direct, conv2d_direct_plain,
    direct_bf16_plan,
    direct_bf16_route, direct_slice, direct_takes,
)
import test_torch_port_threads  # noqa: F401  (this worker's torch threads)
from test_torch_port_conv_wgmma import _im2col, _m

import chip_smoke

HEADER = Path(cd.__file__).resolve().parents[1] / "csrc" / "i8_wgmma.cuh"
ENTRY = Path(cd.__file__).resolve().parents[1] / "csrc" / "conv_direct.cu"
P1 = ((1, 1), (1, 1))
BF16 = torch.bfloat16
# one bfloat16 step of the element, or this share of the output's largest
# magnitude where a float32 sum cancels (tests/test_torch_port_bf16.py's
# FLOAT_ULPS and FLOOR): two float32 sums in other orders, each rounded once
FLOOR = 2.0 ** -16


def _route(n, hw, ci, co, kh=3, kw=3, pads=P1, x_ptr=0x1000, w_ptr=0x2000):
    return direct_bf16_route(n, hw, hw, ci, co, kh, kw, pads, x_ptr, w_ptr)


def _takes(ci, co, kh=3, kw=3, pads=P1, x_ptr=0, w_ptr=0):
    return direct_takes(ci, co, kh, kw, pads, x_ptr, w_ptr, BF16, 2)


# -- the route -------------------------------------------------------------

@pytest.mark.parametrize("batch", [chip_smoke.BATCH, chip_smoke.HEADLINE_BATCH])
def test_resnet18_stride1_convs_take_the_wgmma_loop(batch):
    """R's four stride-1 3×3 widths at B = 64 and 512 on bfloat16 x: every
    one on the new loop, with the plan of its shape (the route reads no
    weight type: both weights share the plan)."""
    for hw, c, _ in chip_smoke.RESNET18_DIRECT:
        plan = _route(batch, hw, c, c)
        assert plan is not None, (hw, c)
        assert plan == direct_bf16_plan(batch * hw * hw, 9 * c, c, c)


@pytest.mark.parametrize("hw,c", [(hw, c) for hw, c, _ in chip_smoke.RESNET18_DIRECT])
def test_batch1_crossover_holds(hw, c):
    """At B = 1 each of R's convs does 115 M multiply-adds, above
    DIRECT_BF16_WGMMA_MIN_MACS: the wgmma loop, but for the 7x7 conv, whose
    49 output pixels are below one 128-row tile (DIRECT_BF16_WGMMA_MIN_M)
    until B = 3."""
    assert hw * hw * 9 * c * c >= DIRECT_BF16_WGMMA_MIN_MACS
    assert (_route(1, hw, c, c) is None) == (hw * hw < DIRECT_BF16_WGMMA_MIN_M)
    first = -(-DIRECT_BF16_WGMMA_MIN_M // (hw * hw))
    assert _route(first, hw, c, c) is not None
    assert first == 1 or _route(first - 1, hw, c, c) is None
    assert (first == 1) == (hw > 7)


@pytest.mark.parametrize("n,hw,ci,co,routed", [
    (1, 16, 64, 64, False),    # 2^24.2 multiply-adds, 256 pixels
    (1, 28, 64, 136, False),   # 2^25.9, a conv the loop takes
    (1, 32, 64, 128, True),    # 2^26.2
    (2, 8, 512, 512, True),    # 128 pixels, one tile
    (1, 11, 512, 512, False),  # 121 pixels, below a tile
])
def test_crossover_in_work_and_pixels(n, hw, ci, co, routed):
    macs = n * hw * hw * 9 * ci * co
    assert routed == (macs >= DIRECT_BF16_WGMMA_MIN_MACS
                      and n * hw * hw >= DIRECT_BF16_WGMMA_MIN_M)
    assert _takes(ci, co)
    assert (_route(n, hw, ci, co) is not None) == routed


@pytest.mark.parametrize("n,h,w,ci,co,kh,kw,pads", chip_smoke.DIRECT_F32_RAGGED)
def test_3f_ragged_shapes_stay_on_the_mma_loop(n, h, w, ci, co, kh, kw, pads):
    """chip_smoke.py's ragged 3f-bf16 shapes (Ci = 8, 3, 16 with Co = 32,
    7): no 16-channel slice, or Co below the 64-wide tile, so neither the
    route nor a forced launch takes the wgmma loop."""
    assert not _takes(ci, co, kh, kw, pads)
    assert direct_bf16_route(n, h, w, ci, co, kh, kw, pads, 0, 0) is None


@pytest.mark.parametrize("ci,co,takes,why", [
    (64, 64, True, "R's 56x56 width: 64-channel slices"),
    (96, 192, True, "32-channel slices, a ragged band"),
    (48, 128, True, "16-channel slices (Ci = 48)"),
    (16, 64, True, "one 16-channel slice a tap: a whole k16 step"),
    (8, 64, False, "Ci = 8: 16-byte pixels, half a k16 step a tap"),
    (24, 64, False, "Ci = 24: no 16-channel slice divides it"),
    (7, 64, False, "Ci = 7: rows of 14 bytes, no TMA row stride"),
    (3, 64, False, "Ci = 3"),
    (64, 32, False, "Co = 32: below the 64-wide tile"),
    (64, 72, False, "Co = 72: below the 128-wide tile its width takes"),
    (64, 132, False, "Co = 132: bf16 rows not a multiple of 8 values"),
    (64, 136, True, "Co = 136: a second band of 8 columns"),
])
def test_direct_takes_bf16(ci, co, takes, why):
    assert _takes(ci, co) == takes, why


@pytest.mark.parametrize("x_ptr,w_ptr,why", [
    (0x1008, 0x2000, "x 8 bytes off a 16-byte boundary"),
    (0x1000, 0x2004, "the weight matrix 4 bytes off"),
    (0x1002, 0x2000, "x at one bfloat16 off"),
])
def test_unaligned_bases_stay_on_the_mma_loop(x_ptr, w_ptr, why):
    assert _route(64, 28, 128, 128, x_ptr=x_ptr, w_ptr=w_ptr) is None, why
    assert _route(64, 28, 128, 128) is not None


def test_pads_and_kernels_past_the_im2col_corners_stay():
    assert _takes(64, 64, 5, 5, ((2, 2), (2, 2)))
    assert not _takes(64, 64, 3, 3, ((65, 1), (1, 1)))
    assert not _takes(64, 64, 3, 3, ((1, 1), (1, 65)))
    assert not _takes(64, 64, 65, 1, ((0, 0), (0, 0)))


@pytest.mark.parametrize("n,h,w,ci,co,kh,kw,pads", chip_smoke.WGMMA_BF16_DIRECT_EDGES)
def test_the_wgmma_edges_are_convs_the_loop_takes(n, h, w, ci, co, kh, kw, pads):
    """chip_smoke.py and the card tests force the wgmma loop at these
    shapes: each one it takes, with fewer tiles than SMs, so that the plan
    splits K wherever K holds 4 or more stages of 64 bf16 values."""
    assert _takes(ci, co, kh, kw, pads)
    k = kh * kw * ci
    plan = direct_bf16_plan(_m(n, h, w, kh, kw, pads), k, ci, co)
    assert plan.units // plan.splits < gemm.SMS
    assert (plan.splits > 1) == (2 * k >= 4 * gemm.I8W_STAGE_K)


# -- the plan ----------------------------------------------------------------

@pytest.mark.parametrize("ci,sl", [(64, 128), (128, 128), (512, 128), (32, 64), (96, 64),
                                   (16, 32), (48, 32), (80, 32), (8, None), (40, None)])
def test_slice_bytes(ci, sl):
    """A k step is one tap's slice of 64, 32 or 16 channels, the largest
    that divides Ci: 128, 64 or 32 bytes, a whole number of 32-byte k16
    steps."""
    assert direct_slice(ci, 2) == sl


@pytest.mark.parametrize("batch", [1, chip_smoke.BATCH, chip_smoke.HEADLINE_BATCH])
@pytest.mark.parametrize("hw,c", [(hw, c) for hw, c, _ in chip_smoke.RESNET18_DIRECT])
def test_plan_is_the_int8_plan_over_twice_the_bytes(batch, hw, c):
    """A stage is 128 bytes of k for either operand type, so a bf16 conv's
    plan is the int8 conv's over its 2·K bytes, with a bfloat16 C tile:
    64-wide tiles to Co = 64, 128-wide above; 128-byte steps at Ci >= 64;
    the ring as deep as the room beside the C tile allows; K split below
    one tile an SM."""
    m, k = batch * hw * hw, 9 * c
    plan = direct_bf16_plan(m, k, c, c)
    assert plan == gemm.i8w_plan(m, 2 * k, c, 128, 2)
    assert plan.bn == (64 if c <= 64 else 128) and plan.sl == 128
    assert plan.smem == gemm.i8w_smem(plan.bn, plan.stages, 2)
    assert gemm.I8W_PER_SM * (plan.smem + gemm.SMEM_RESERVED) <= gemm.SMEM_PER_SM
    assert 3 <= plan.stages <= gemm.I8W_MAX_STAGES
    groups = -(-2 * k // gemm.I8W_STAGE_K)
    assert 1 <= plan.splits <= max(1, groups // 2)
    assert (plan.splits > 1) == (plan.units // plan.splits < gemm.SMS and groups >= 4)


# -- the k-step order and the loop's sums -------------------------------------

def _k_steps(kh, kw, ci):
    """The wgmma loop's k steps in order on bf16 x, as its producer walks
    them (i8_wgmma.cuh, Im2col<2>::load: tap s / slices, slice s % slices
    of sl / 2 channels): (i, j, c0, k0) for the tap (i, j), the slice's
    first channel c0 (the im2col map's channel coordinate) and its first
    column k0 of the K-major weight matrix (the B map's coordinate, in
    values)."""
    sl = direct_slice(ci, 2)
    cpp = sl // 2
    slices = ci // cpp
    steps = []
    for s in range(kh * kw * slices):
        tap, q = divmod(s, slices)
        i, j = divmod(tap, kw)
        steps.append((i, j, q * cpp, tap * ci + q * cpp))
    return steps


def _bf16_inputs(n, h, w, ci, co, kh, kw, int8_w, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((n, h, w, ci)).astype(np.float32)).to(BF16)
    if int8_w:
        wt = torch.from_numpy(rng.integers(-127, 128, (co, ci, kh, kw)).astype(np.int8))
        scale = torch.from_numpy(rng.uniform(1e-3, 1e-2, co).astype(np.float32)).to(BF16)
    else:
        wt = torch.from_numpy((rng.standard_normal((co, ci, kh, kw)) * 0.2)
                              .astype(np.float32)).to(BF16)
        scale = None
    bias = torch.from_numpy(rng.standard_normal(co).astype(np.float32)).to(BF16)
    return x, wt, scale, bias


@pytest.mark.parametrize("n,h,w,ci,co,kh,kw,pads", [
    (2, 5, 6, 64, 64, 3, 3, P1), (1, 4, 4, 128, 128, 3, 3, P1),
    (3, 5, 4, 96, 64, 1, 3, ((0, 0), (1, 1))), (1, 7, 6, 16, 64, 5, 5, ((2, 2), (2, 2))),
    (2, 6, 5, 48, 64, 3, 3, ((0, 2), (1, 0))),
])
def test_k_steps_walk_the_weight_matrix_in_feature_order(n, h, w, ci, co, kh, kw, pads):
    """The producer's k steps (tap, channel slice) cover K = kh·kw·Ci once,
    in conv_weight_matrix_nk's (i, j, c) feature order, each of sl / 2
    values; a stage's 128 bytes are 64 consecutive values of K (128 / sl
    steps side by side); each step's A columns are its tap's shifted pixels
    and its B columns the same features of the K-major weight; summed over
    the steps the exact products give the conv in float64."""
    x, wt, _, _ = _bf16_inputs(n, h, w, ci, co, kh, kw, False, ci + kh)
    wmat = conv_weight_matrix_nk(wt)
    a = _im2col(x, kh, kw, pads)
    cpp = direct_slice(ci, 2) // 2
    steps = _k_steps(kh, kw, ci)
    assert [k0 for *_, k0 in steps] == list(range(0, kh * kw * ci, cpp))
    taps = gemm.I8W_STAGE_K // (2 * cpp)
    groups = [steps[g:g + taps] for g in range(0, len(steps), taps)]
    assert [grp[0][3] for grp in groups] == list(range(0, kh * kw * ci, gemm.I8W_STAGE_K // 2))
    acc = torch.zeros((a.shape[0], co), dtype=torch.float64)
    for i, j, c0, k0 in steps:
        assert torch.equal(wmat[:, k0:k0 + cpp], wt[:, c0:c0 + cpp, i, j])
        acc += a[:, k0:k0 + cpp].double() @ wmat[:, k0:k0 + cpp].double().t()
    xp = torch.nn.functional.pad(x.double().permute(0, 3, 1, 2),
                                 (pads[1][0], pads[1][1], pads[0][0], pads[0][1]))
    want = torch.nn.functional.conv2d(xp, wt.double()).permute(0, 2, 3, 1).reshape(-1, co)
    torch.testing.assert_close(acc, want, rtol=1e-12, atol=1e-12)


def _wgmma_sum(x, wt, pads, splits):
    """The wgmma loop's float32 sums of a bfloat16 conv: the im2col A and
    the K-major B (an int8 weight's codes as bf16, exactly) in K's (i, j, c)
    order; each k16 step's 16 products are exact (a bf16 product has 16
    significant bits) and summed in float64, then added to a float32
    accumulator, rounded once; split z takes stages (64 values of k each)
    [z·per, (z + 1)·per) into its own accumulator, and the splits' float32
    partials are added in the order z = 0, 1, ... (i8_mma.cuh's
    reduction)."""
    co, _, kh, kw = wt.shape
    a = _im2col(x, kh, kw, pads).double()
    b = conv_weight_matrix_nk(wt).double()
    k = a.shape[1]
    groups = -(-k // 64)
    per = -(-groups // splits)
    total = None
    for z in range(splits):
        acc = torch.zeros((a.shape[0], co), dtype=torch.float32)
        for k0 in range(z * per * 64, min(k, (z + 1) * per * 64), 16):
            acc = (acc.double() + a[:, k0:k0 + 16] @ b[:, k0:k0 + 16].t()).float()
        total = acc if total is None else total + acc
    return total


def _assert_bf16_close(got, want, what):
    """Every element within one bfloat16 step of its own magnitude, or
    within FLOOR of the largest (tests/test_torch_port_bf16.py's gate)."""
    got, want = got.double(), want.double()
    e = torch.frexp(want.abs().clamp_min(2.0 ** -126))[1]
    limit = torch.maximum(torch.exp2(e.double() - 8), FLOOR * want.abs().max())
    worst = ((got - want).abs() / limit).max().item()
    assert worst <= 1.0, f"{what}: {worst:.2f} of the limit"


@pytest.mark.parametrize("n,h,w,ci,co,kh,pads,act", [
    (2, 6, 6, 64, 64, 3, P1, ("relu", 0.0, 0.0)),          # one 128-byte step a stage
    (1, 7, 7, 128, 128, 3, P1, None),                      # 18 stages: the plan splits
    (2, 5, 7, 48, 64, 3, ((0, 2), (1, 0)), ("clamp", 0.0, 6.0)),  # 16-channel slices
    (1, 6, 6, 96, 136, 5, ((2, 2), (2, 2)), None),         # 32-channel slices, Co = 136
])
@pytest.mark.parametrize("int8_w", [False, True], ids=["bf16_w", "int8_w"])
def test_wgmma_order_of_summation_within_the_bf16_gate(n, h, w, ci, co, kh, pads, act, int8_w):
    """The loop's order of summation (``_wgmma_sum`` with the plan's
    splits), then the epilogue in epilogue.cuh's order and one rounding to
    bfloat16, within one bfloat16 step (or 2^-16 of the largest output)
    of the plain version (one float64 sum) and of the JAX package's Pallas
    kernel on bfloat16 x (interpret mode: DEFAULT-precision bf16 dots), with
    a bfloat16 and an int8 weight."""
    import jax.numpy as jnp

    from pyopenvino_tpu.kernels.conv_direct import conv2d_direct as jax_conv2d_direct

    x, wt, scale, bias = _bf16_inputs(n, h, w, ci, co, kh, kh, int8_w, n + ci + co + kh)
    assert _takes(ci, co, kh, kh, pads)
    oh, ow = h + sum(pads[0]) - kh + 1, w + sum(pads[1]) - kh + 1
    plan = direct_bf16_plan(n * oh * ow, kh * kh * ci, ci, co)
    acc = _wgmma_sum(x, wt, pads, plan.splits).reshape(n, oh, ow, co)
    got = gemm.epilogue(acc, None if scale is None else scale.float(), bias.float(), act).to(BF16)
    plain = conv2d_direct_plain(x, wt, scale, bias, act, pads)
    assert got.shape == plain.shape and plain.dtype == BF16
    _assert_bf16_close(got.float(), plain.float(), "emulated loop vs plain")

    def jbf16(t):
        return None if t is None else jnp.asarray(t.float().numpy(), jnp.bfloat16)

    jw = jnp.asarray(wt.numpy()) if int8_w else jbf16(wt)
    want = jax_conv2d_direct(jbf16(x), jw, scale=jbf16(scale), bias=jbf16(bias), act=act,
                             pads=pads, interpret=True)
    assert str(want.dtype) == "bfloat16"
    _assert_bf16_close(got.float(), torch.from_numpy(np.asarray(want, np.float32)),
                       "emulated loop vs the Pallas kernel")


# -- conv_loop and the wrapper on the CPU --------------------------------------

@pytest.mark.parametrize("loop", [None, "wgmma", "mma"])
@pytest.mark.parametrize("int8_w", [False, True], ids=["bf16_w", "int8_w"])
def test_cpu_tensors_take_the_plain_version_and_leave_the_counter(loop, int8_w):
    """conv_loop is taken for bfloat16 x too; on the CPU either loop is the
    plain version, no launch counted; a cached wmat in either layout gives
    the same result."""
    x, wt, scale, bias = _bf16_inputs(2, 6, 6, 64, 64, 3, 3, int8_w, 5)
    before = conv2d_direct.launches_float_bf16
    got = conv2d_direct(x, wt, scale, bias, ("relu", 0.0, 0.0), P1, conv_loop=loop)
    for wmat in (cd.conv_weight_matrix(wt), conv_weight_matrix_nk(wt).t()):
        assert torch.equal(got, conv2d_direct(x, wt, scale, bias, ("relu", 0.0, 0.0), P1,
                                              wmat=wmat, conv_loop=loop))
    assert conv2d_direct.launches_float_bf16 == before
    assert torch.equal(got, conv2d_direct_plain(x, wt, scale, bias, ("relu", 0.0, 0.0), P1))


def test_float32_x_refuses_conv_loop():
    x = torch.zeros((1, 4, 4, 16))
    with pytest.raises(ValueError, match="conv_loop needs int8 x or bfloat16 x"):
        conv2d_direct(x, torch.zeros((64, 16, 3, 3)), None, None, None, P1, conv_loop="wgmma")


# -- the C side ----------------------------------------------------------------

def test_header_holds_the_bf16_loop():
    """The bf16 products, their loaders (named so that the profiler files
    them under 3f-bf16) and the entry the wrapper calls."""
    text = HEADER.read_text()
    for bn in (64, 128):
        assert f"m64n{bn}k16.f32.bf16.bf16" in text and f"m64n{bn}k32.s32.s8.s8" in text
    assert "p, 1, 1, 0, 0;" in text  # both operands K-major: no transpose
    for name in ("ConvABf16Im2col : Im2col<2>", "ConvABf16Im2colI8w : Im2col<2>",
                 "ConvAIm2col : Im2col<1>"):
        assert f"struct {name}" in text
    assert "CU_TENSOR_MAP_DATA_TYPE_BFLOAT16" in text and "codes_to_bf16" in text
    entry = ENTRY.read_text()
    assert 'extern "C" int conv2d_direct_bf16_wgmma(' in entry
    for loader in ("ConvABf16Im2col", "ConvABf16Im2colI8w"):
        assert re.search(rf"i8wgmma::conv_launch<i8wgmma::{loader}>\(", entry)
    assert len(cd._ENTRIES["conv2d_direct_bf16_wgmma"]) == 27
