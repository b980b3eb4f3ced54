"""conv2d_direct's int8 wgmma loop (csrc/i8_wgmma.cuh), what the CPU can
check of it.

The loop itself runs only on a card (tests/test_torch_port_gpu.py, ``-k
conv_wgmma``, holds it to the plain version there).  What routes a launch
to it, its tile, slice, ring and splits, its shared memory and the order in
which its producer walks K are plain Python in kernels/conv_direct.py
(``direct_route``, ``direct_takes``, ``direct_plan``; the shared
``gemm.i8w_smem``);
the producer's walk over K is mirrored here (``_k_steps``); the profiler's
names for it are in runtime/profiling.py.  Nothing here needs a card.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pyopenvino_tpu_torch.kernels import conv_direct as cd
from pyopenvino_tpu_torch.kernels import gemm
from pyopenvino_tpu_torch.kernels.conv import conv_weight_matrix_nk
from pyopenvino_tpu_torch.kernels.conv_direct import (
    DIRECT_WGMMA_MIN_MACS, conv2d_direct, conv2d_direct_plain, direct_plan, direct_route,
    direct_takes,
)
from pyopenvino_tpu_torch.kernels.gemm import i8w_smem
import test_torch_port_threads  # noqa: F401  (this worker's torch threads)

import chip_smoke
from test_torch_port_gpu import GOOGLENET_DIRECT

HEADER = Path(cd.__file__).resolve().parents[1] / "csrc" / "i8_wgmma.cuh"
P1 = ((1, 1), (1, 1))
F32, BF16 = torch.float32, torch.bfloat16


def _route(n, hw, ci, co, kh=3, kw=3, pads=P1, out=F32, x_ptr=0x1000, w_ptr=0x2000):
    return direct_route(n, hw, hw, ci, co, kh, kw, pads, x_ptr, w_ptr, out)


def _m(n, h, w, kh, kw, pads):
    (pt, pb), (pl, pr) = pads
    return n * (h + pt + pb - kh + 1) * (w + pl + pr - kw + 1)


# -- the route -------------------------------------------------------------

@pytest.mark.parametrize("out", [F32, BF16], ids=["f32_out", "bf16_out"])
@pytest.mark.parametrize("batch", [chip_smoke.BATCH, chip_smoke.HEADLINE_BATCH])
def test_resnet18_stride1_convs_take_the_wgmma_loop(batch, out):
    """R's and P's 13 stride-1 3×3 convs at B = 64 and the headline's at
    512: every width on the new loop, with the plan of its shape."""
    for hw, c, _ in chip_smoke.RESNET18_DIRECT:
        plan = _route(batch, hw, c, c, out=out)
        assert plan is not None, (hw, c)
        assert plan == direct_plan(batch * hw * hw, 9 * c, c, c, 2 if out == BF16 else 4)


@pytest.mark.parametrize("hw,c", [(hw, c) for hw, c, _ in chip_smoke.RESNET18_DIRECT])
def test_batch1_crossover_holds(hw, c):
    """At B = 1 each of R's convs does 115 M multiply-adds, below
    DIRECT_WGMMA_MIN_MACS: the mma.sync loop.  The smallest batch whose
    work reaches the crossover takes the wgmma loop, the one below it not."""
    macs = hw * hw * 9 * c * c
    assert macs < DIRECT_WGMMA_MIN_MACS and _route(1, hw, c, c) is None
    at = -(-DIRECT_WGMMA_MIN_MACS // macs)
    assert _route(at, hw, c, c) is not None
    assert _route(at - 1, hw, c, c) is None
    # M alone does not decide: the 7x7 conv at 64 has the 56x56 one's M at 1
    assert _route(64, 7, 512, 512) is not None and 64 * 49 == 56 * 56


@pytest.mark.parametrize("h,w,ci,co,kh,kw,pads", GOOGLENET_DIRECT)
@pytest.mark.parametrize("out", [F32, BF16], ids=["f32_out", "bf16_out"])
def test_googlenet_shapes_route(h, w, ci, co, kh, kw, pads, out):
    """googlenet_shapes' 5×5 convs (Ci = 4 ... 12) and 3×3 convs with Ci =
    16 ... 48 at B = 64: only Ci a multiple of 32 (a k step is whole 32-byte
    wgmma steps; Ci = 16 and 48 would split one across two taps) with Co
    at least the 64-wide tile and enough work takes the wgmma loop."""
    plan = direct_route(chip_smoke.BATCH, h, w, ci, co, kh, kw, pads, 0x100, 0x200, out)
    macs = _m(chip_smoke.BATCH, h, w, kh, kw, pads) * kh * kw * ci * co
    assert (plan is not None) == (ci % 32 == 0 and co >= 64
                                  and macs >= DIRECT_WGMMA_MIN_MACS), (h, w, ci, co)


@pytest.mark.parametrize("x_ptr,w_ptr,why", [
    (0x1008, 0x2000, "x 8 bytes off a 16-byte boundary"),
    (0x1000, 0x2004, "the weight matrix 4 bytes off"),
    (0x1001, 0x2000, "x at an odd address"),
])
def test_unaligned_bases_stay_on_the_mma_loop(x_ptr, w_ptr, why):
    assert _route(64, 28, 128, 128, x_ptr=x_ptr, w_ptr=w_ptr) is None, why
    assert _route(64, 28, 128, 128) is not None


@pytest.mark.parametrize("ci,co,out,takes,why", [
    (64, 64, F32, True, "R's 56x56 width"),
    (96, 192, BF16, True, "a 32-channel slice, a ragged band"),
    (16, 64, F32, False, "Ci = 16: half a k32 step a tap"),
    (48, 96, F32, False, "Ci = 48"),
    (132, 128, F32, False, "Ci = 132: no slice divides it"),
    (64, 130, F32, False, "Co = 130: float32 rows of 520 bytes, pairs off 16"),
    (64, 132, BF16, False, "Co = 132 in bf16: not a multiple of 8"),
    (64, 132, F32, True, "Co = 132 in float32: a multiple of 4"),
    (64, 32, F32, False, "Co = 32: below the 64-wide tile"),
])
def test_direct_takes(ci, co, out, takes, why):
    assert direct_takes(ci, co, 3, 3, P1, 0, 0, out) == takes, why


@pytest.mark.parametrize("n,h,w,ci,co,kh,kw,pads", chip_smoke.WGMMA_DIRECT_EDGES)
@pytest.mark.parametrize("out", [F32, BF16], ids=["f32_out", "bf16_out"])
def test_the_wgmma_edges_are_convs_the_loop_takes(n, h, w, ci, co, kh, kw, pads, out):
    """chip_smoke.py and the card tests force the wgmma loop at these
    shapes: each must be one it takes, with fewer tiles than SMs, so that
    the plan splits K wherever K holds 4 or more stages of 128 bytes."""
    assert direct_takes(ci, co, kh, kw, pads, 0, 0, out)
    plan = direct_plan(_m(n, h, w, kh, kw, pads), kh * kw * ci, ci, co, out.itemsize)
    assert plan.units // plan.splits < gemm.SMS
    assert (plan.splits > 1) == (kh * kw * ci >= 4 * gemm.I8W_STAGE_K)


def test_pads_and_kernels_past_the_im2col_corners_stay():
    assert direct_takes(64, 64, 5, 5, ((2, 2), (2, 2)), 0, 0, F32)
    assert not direct_takes(64, 64, 3, 3, ((65, 1), (1, 1)), 0, 0, F32)
    assert not direct_takes(64, 64, 65, 1, ((0, 0), (0, 0)), 0, 0, F32)


# -- the plan and its shared memory ------------------------------------------

def _routed_shapes():
    """(M, K, Ci, Co) of every conv2d_direct launch of R, P and G at B = 64
    and the headline's at 512 that the route sends to the wgmma loop."""
    convs = [(b, hw, hw, c, c, 3, 3, P1) for b in (chip_smoke.BATCH, chip_smoke.HEADLINE_BATCH)
             for hw, c, _ in chip_smoke.RESNET18_DIRECT]
    convs += [(chip_smoke.BATCH, *conv) for conv in GOOGLENET_DIRECT]
    shapes = []
    for n, h, w, ci, co, kh, kw, pads in convs:
        for out in (F32, BF16):
            if direct_route(n, h, w, ci, co, kh, kw, pads, 0, 0, out) is not None:
                shapes.append((_m(n, h, w, kh, kw, pads), kh * kw * ci, ci, co))
    return sorted(set(shapes))


def test_routed_shapes_are_r_p_g_and_the_headline():
    """R's (and so P's) four widths at 64 and 512, and at most one of G's:
    (14, 14, 32, 64), the only one with Ci a multiple of 32 and Co >= 64."""
    shapes = _routed_shapes()
    g = (64 * 196, 288, 32, 64)
    assert len(shapes) == 8 + (g in shapes)
    assert (g in shapes) == (64 * 196 * 288 * 64 >= DIRECT_WGMMA_MIN_MACS)


@pytest.mark.parametrize("m,k,ci,co", _routed_shapes())
@pytest.mark.parametrize("out_bytes", [4, 2], ids=["f32_c_tile", "bf16_c_tile"])
def test_plan_fits_the_shared_memory(m, k, ci, co, out_bytes):
    """Every routed shape's block, with a float32 or bf16 C tile where its
    tile is 64 wide, fits the card's 227 KB a block, and two fit an SM; the
    ring takes what is left, at least 3 stages of 128 bytes of k."""
    plan = direct_plan(m, k, ci, co, out_bytes)
    c_tile = 128 * plan.bn * out_bytes if plan.bn == 64 else 0
    assert plan.smem == i8w_smem(plan.bn, plan.stages, out_bytes)
    assert plan.smem >= plan.stages * (gemm.I8W_BM + plan.bn) * gemm.I8W_STAGE_K + c_tile
    assert plan.smem <= 232448
    assert gemm.I8W_PER_SM * (plan.smem + gemm.SMEM_RESERVED) <= gemm.SMEM_PER_SM
    assert 3 <= plan.stages <= gemm.I8W_MAX_STAGES
    room = gemm.SMEM_PER_SM // gemm.I8W_PER_SM - gemm.SMEM_RESERVED
    assert (plan.stages == gemm.I8W_MAX_STAGES
            or i8w_smem(plan.bn, plan.stages + 1, out_bytes) > room)
    assert ci % plan.sl == 0 and plan.sl == max(s for s in (32, 64, 128) if ci % s == 0)
    assert plan.bn == (64 if co <= 64 else 128)
    assert plan.units == -(-m // gemm.I8W_BM) * -(-co // plan.bn) * plan.splits
    assert plan.grid == min(plan.units, gemm.I8W_PER_SM * gemm.SMS)


@pytest.mark.parametrize("m,k,ci,co,splits", [
    (64 * 3136, 576, 64, 64, 1),    # R 56x56 at 64: 1568 tiles
    (64 * 196, 2304, 256, 256, 1),  # R 14x14 at 64: 196 tiles, more than the SMs
    (64 * 49, 4608, 512, 512, 2),   # R 7x7 at 64: 100 tiles, 200 units in one wave
    (48 * 49, 4608, 512, 512, 3),   # 76 tiles: 228 units
    (49, 4608, 512, 512, 18),       # R 7x7 at 1: 4 tiles, 36 stages of k
    (3136, 576, 64, 64, 2),         # R 56x56 at 1: 25 tiles, 5 stages of k
    (196, 2304, 256, 256, 9),       # R 14x14 at 1: 4 tiles, 18 stages of k
])
def test_plan_splits_k_below_one_tile_an_sm(m, k, ci, co, splits):
    plan = direct_plan(m, k, ci, co)
    assert plan.splits == splits
    assert plan.splits <= max(1, -(-k // gemm.I8W_STAGE_K) // 2)
    assert plan.splits == 1 or plan.units <= gemm.I8W_PER_SM * gemm.SMS


def test_smem_counts_ring_c_tile_scale_bias_and_barriers():
    extra = 1024 + 2 * 128 * 4 + 2 * 8 * 8  # alignment slack, scale and bias, barriers
    # 128-wide tiles store from the accumulators: no C tile
    assert i8w_smem(128, 3) == 3 * (128 + 128) * 128 + extra
    assert i8w_smem(128, 3, 2) == i8w_smem(128, 3)
    assert i8w_smem(64, 3) == 3 * (128 + 64) * 128 + 128 * 64 * 4 + extra
    assert i8w_smem(64, 4, 2) == 4 * (128 + 64) * 128 + 128 * 64 * 2 + extra


def test_python_constants_match_the_header():
    text = HEADER.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    assert const("BM") == gemm.I8W_BM
    assert const("PER_SM") == gemm.I8W_PER_SM
    assert const("STAGE_K") == gemm.I8W_STAGE_K
    assert const("MAX_STAGES") == gemm.I8W_MAX_STAGES
    assert const("MAX_BN") == gemm.I8W_MAX_BN
    assert re.search(r"SMEM_EXTRA = 1024 \+ 2 \* MAX_BN \* 4 \+ 2 \* MAX_STAGES \* 8;", text)
    assert gemm.I8W_SMEM_EXTRA == 1024 + 2 * gemm.I8W_MAX_BN * 4 + 2 * gemm.I8W_MAX_STAGES * 8
    assert re.search(r"return \(BM \+ bn\) \* STAGE_K;", text)  # stage_bytes
    for bn in (64, 128):
        assert f"struct Wgmma<{bn}>" in text and f"I8_WGMMA_CASE({bn})" in text
    assert "__launch_bounds__(THREADS, PER_SM)" in text
    assert re.search(r"return bn == 64 \? BM \* bn \* out_bytes : 0;", text)  # ctile_bytes
    assert f"KH > {cd.DIRECT_MAX_EXTENT}" in text and f"pt > {cd.DIRECT_MAX_EXTENT}" in text


# -- the k-step order ---------------------------------------------------------

def _k_steps(kh, kw, ci):
    """The wgmma loop's k steps in order, as its producer walks them
    (i8_wgmma.cuh, ConvAIm2col::load: tap s / slices, slice s % slices):
    (i, j, c0, k0) for the tap (i, j), the slice's first channel c0 and its
    first column k0 of the K-major weight matrix."""
    sl = cd.direct_slice(ci)
    slices = ci // sl
    steps = []
    for s in range(kh * kw * slices):
        tap, q = divmod(s, slices)
        i, j = divmod(tap, kw)
        steps.append((i, j, q * sl, tap * ci + q * sl))
    return steps


def _im2col(x, kh, kw, pads):
    """The plain (M, kh·kw·Ci) patch matrix of an NHWC input, features in
    (i, j, c) order, padding as zeros."""
    (pt, pb), (pl, pr) = pads
    xp = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb)).permute(0, 2, 3, 1)
    n, hp, wp, ci = xp.shape
    oh, ow = hp - kh + 1, wp - kw + 1
    cols = [xp[:, i:i + oh, j:j + ow, :] for i in range(kh) for j in range(kw)]
    return torch.cat(cols, dim=3).reshape(n * oh * ow, kh * kw * ci)


@pytest.mark.parametrize("n,h,w,ci,co,kh,kw,pads", [
    (2, 5, 6, 64, 64, 3, 3, P1), (1, 4, 4, 256, 128, 3, 3, P1),
    (3, 5, 4, 96, 64, 1, 3, ((0, 0), (1, 1))), (1, 7, 6, 32, 64, 5, 5, ((2, 2), (2, 2))),
    (2, 6, 5, 192, 64, 3, 3, ((0, 2), (1, 0))),
])
def test_k_steps_walk_the_weight_matrix_in_feature_order(n, h, w, ci, co, kh, kw, pads):
    """The producer's k steps (tap, channel slice) cover K = kh·kw·Ci once,
    in conv_weight_matrix_nk's (i, j, c) feature order; each step's A
    columns are its tap's shifted pixels, its B columns the same features
    of the K-major weight; summed over the steps the products give the
    exact conv of the codes."""
    rng = np.random.default_rng(ci + kh)
    x = torch.from_numpy(rng.integers(-127, 128, (n, h, w, ci)).astype(np.int8))
    wt = torch.from_numpy(rng.integers(-127, 128, (co, ci, kh, kw)).astype(np.int8))
    wmat = conv_weight_matrix_nk(wt)  # (Co, K), row co = its features in (i, j, c) order
    a = _im2col(x, kh, kw, pads)
    sl = cd.direct_slice(ci)
    steps = _k_steps(kh, kw, ci)
    assert [k0 for *_, k0 in steps] == list(range(0, kh * kw * ci, sl))
    # a stage's 128 bytes of k are 128 / sl consecutive k steps: whole taps'
    # slices, so K's stages are its 128-byte column groups
    taps = gemm.I8W_STAGE_K // sl
    groups = [steps[g:g + taps] for g in range(0, len(steps), taps)]
    assert [grp[0][3] for grp in groups] == list(range(0, kh * kw * ci, gemm.I8W_STAGE_K))
    acc = torch.zeros((a.shape[0], co), dtype=torch.float64)
    for i, j, c0, k0 in steps:
        assert torch.equal(wmat[:, k0:k0 + sl], wt[:, c0:c0 + sl, i, j])
        acc += a[:, k0:k0 + sl].double() @ wmat[:, k0:k0 + sl].double().t()
    want = gemm.conv2d_int32(x.permute(0, 3, 1, 2), wt, pads=pads).permute(0, 2, 3, 1)
    assert torch.equal(acc.round().to(torch.int32), want.reshape(-1, co))


# -- conv_loop on the CPU ---------------------------------------------------

def _codes(shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(-127, 128, shape).astype(np.int8))


@pytest.mark.parametrize("loop", [None, "wgmma", "mma"])
@pytest.mark.parametrize("out", [F32, BF16], ids=["f32_out", "bf16_out"])
def test_cpu_tensors_take_the_plain_version_and_leave_the_counters(loop, out):
    x, wt = _codes((2, 6, 6, 64)), _codes((64, 64, 3, 3), 1)
    scale = torch.from_numpy(np.random.default_rng(2).uniform(1e-4, 1e-2, 64).astype(np.float32))
    before = (conv2d_direct.launches, conv2d_direct.launches_bf16)
    got = conv2d_direct(x, wt, scale, None, ("relu", 0.0, 0.0), P1, out_dtype=out,
                        conv_loop=loop)
    assert (conv2d_direct.launches, conv2d_direct.launches_bf16) == before
    assert torch.equal(got, conv2d_direct_plain(x, wt, scale, None, ("relu", 0.0, 0.0), P1, out))


@pytest.mark.parametrize("x_dtype,loop,match", [
    (torch.int8, "tma", "conv_loop 'tma'"),
    (torch.int8, "WGMMA", "conv_loop 'WGMMA'"),
    (torch.float32, "wgmma", "needs int8 x"),
    (torch.float32, "mma", "needs int8 x"),
])
def test_conv_loop_is_validated_on_the_cpu(x_dtype, loop, match):
    x = _codes((1, 4, 4, 32)).to(x_dtype)
    wt = _codes((64, 32, 3, 3), 1)
    if x_dtype != torch.int8:
        wt = wt.to(x_dtype)
    with pytest.raises(ValueError, match=match):
        conv2d_direct(x, wt, torch.ones(64), None, None, P1, conv_loop=loop)


# -- the profiler's names ---------------------------------------------------

@pytest.mark.parametrize("name,category", [
    ("void i8wgmma::i8_wgmma_kernel<i8wgmma::ConvAIm2col, 128, float>(CUtensorMap_st, "
     "CUtensorMap_st, i8wgmma::ConvAIm2col, float const*, float const*, float*, int*, int, int, "
     "int, int, int, int, float, float)", "conv2d_direct"),
    ("void i8wgmma::i8_wgmma_kernel<i8wgmma::ConvAIm2col, 64, __nv_bfloat16>(CUtensorMap_st "
     "const, CUtensorMap_st const, i8wgmma::ConvAIm2col, float const*, float const*, "
     "__nv_bfloat16*, int*, int, int, int, int, int, int, float, float)", "conv2d_direct_bf16"),
    ("void i8mma::splitk_reduce<int, true, __nv_bfloat16>(int const*, int, long long, int, "
     "float const*, float const*, __nv_bfloat16*, int, float, float)", "splitk_reduce"),
])
def test_profiler_files_the_wgmma_conv_kernel_under_its_variants(name, category):
    from pyopenvino_tpu_torch.runtime.profiling import categorize

    assert categorize(name) == category
