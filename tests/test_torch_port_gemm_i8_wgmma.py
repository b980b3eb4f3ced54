"""fused_gemm's int8 × int8 wgmma loop (csrc/i8_wgmma.cuh with its TiledA
loader), what the CPU can check of it.

The loop itself runs only on a card (tests/test_torch_port_gpu.py, ``-k
i8_wgmma``, holds it to the mma.sync loop and the plain version there).
What routes a launch to it, its tile, step, ring, splits and grid, its
shared memory and the order in which its producer walks K are plain Python
in kernels/gemm.py (``i8_route``, ``i8_takes``, ``i8_plan``, ``i8_slice``,
``i8w_plan``, ``i8w_smem``); the producer's walk over K is mirrored here
(``_k_steps``); the profiler's names for it are in runtime/profiling.py.
Nothing here needs a card.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pyopenvino_tpu_torch.kernels import gemm
from pyopenvino_tpu_torch.kernels.gemm import (
    I8_WGMMA_MIN_K, I8_WGMMA_MIN_MACS, fused_gemm, fused_gemm_plain, i8_plan, i8_route,
    i8_slice, i8_takes, i8w_plan, i8w_smem,
)
import test_torch_port_threads  # noqa: F401  (this worker's torch threads)

import chip_smoke
from test_torch_port_gpu import I8I8_NETS, SPLIT_HALVES

CSRC = Path(gemm.__file__).resolve().parents[1] / "csrc"
F32, BF16 = torch.float32, torch.bfloat16


def _why_not(m, k, n, lda=None, a_off=0, out_bf16=False):
    """Why i8_route keeps a launch on the mma.sync loop, or None."""
    lda = k if lda is None else lda
    if k % 16 or lda % 16:
        return "rows not 16-byte strides"
    if a_off % 16:
        return "A's base not 16-byte aligned"
    if n < 64:
        return "N below the 64-wide tile"
    if n % (8 if out_bf16 else 4):
        return "C's rows not 16-byte strides"
    if k < I8_WGMMA_MIN_K:
        return "K = 16: one 32-byte step, half of it zeros"
    if m * k * n < I8_WGMMA_MIN_MACS:
        return "below the crossover"
    return None


def _launches():
    """(model, batch, M, K, N) of every #1ii launch of the seven families at
    B = 1 and 64 and of the headline at 512."""
    out = {(model, b, m * b, k, n) for model, table in I8I8_NETS.items() for b in (1, 64)
           for m, k, n, _ in table}
    out |= {("headline", 512, m, k, n) for m, k, n, _ in chip_smoke.i8i8_gemms("resnet18", 512)}
    return sorted(out)


# -- the route ---------------------------------------------------------------

@pytest.mark.parametrize("out", [F32, BF16], ids=["f32_out", "bf16_out"])
@pytest.mark.parametrize("model,batch,m,k,n", _launches())
def test_route_of_every_family_launch(model, batch, m, k, n, out):
    """Each launch takes the wgmma loop exactly when nothing keeps it on
    the old one (``_why_not``), with the plan of its shape."""
    plan = i8_route(m, k, n, k, 0x1000, 0x2000, 0x3000, out == BF16)
    why = _why_not(m, k, n, out_bf16=out == BF16)
    assert (plan is None) == (why is not None), why
    if plan is not None:
        assert plan == i8_plan(m, k, n, out.itemsize)


def _routed(model, batch, out=BF16):
    return sorted((m, k, n) for mo, b, m, k, n in _launches() if (mo, b) == (model, batch)
                  and i8_route(m, k, n, k, 0, 0, 0, out == BF16) is not None)


def test_resnet18_and_the_headline_route_their_six_aligned_launches():
    """R (and so P) at B = 64: all but the K = 147 stem and the FC (M = 64,
    2^25 multiply-adds); the headline at 512 the FC too (2^27.97); at B = 1
    none."""
    for model, batch in (("resnet18", 64), ("resnet18_pot", 64), ("headline", 512)):
        gemms = chip_smoke.i8i8_gemms("resnet18", batch)
        want = sorted((m, k, n) for m, k, n, _ in gemms[1:7 if batch == 64 else 8])
        assert _routed(model, batch) == want == _routed(model, batch, F32)
    assert _routed("resnet18", 1) == []


@pytest.mark.parametrize("model", sorted(I8I8_NETS))
def test_what_stays_on_the_mma_loop(model):
    """At B = 64: the K = 147 and K = 27 stems (rows not 16-byte strides),
    K not a multiple of 16 (24, 40, 58, 116, 232, ...), K = 16, N below 64,
    and the launches below the crossover: E's SE gates and every FC at M =
    64; at B = 1 every launch."""
    for m, k, n, _ in I8I8_NETS[model]:
        routed = i8_route(m * 64, k, n, k, 0, 0, 0, True) is not None
        if k in (147, 27, 16) or k % 16 or n < 64 or m == 1:
            assert not routed, (m, k, n)
        assert i8_route(m, k, n, k, 0, 0, 0, True) is None


def test_routed_counts_per_family():
    """What the route takes at B = 64, float32 and bf16 out alike: R and P
    6, M 12, S 5, E 11, G none (every aligned launch below the crossover),
    Sh 1 (its stage-4 expand, K = 464)."""
    for out in (F32, BF16):
        counts = {model: len(_routed(model, 64, out)) for model in I8I8_NETS}
        assert counts == {"resnet18": 6, "resnet18_pot": 6, "mobilenet_v2": 12,
                          "ssd_shapes_ms": 5, "efficientnet_b0": 11, "googlenet_shapes": 0,
                          "shufflenet_v2": 1}


@pytest.mark.parametrize("pixels,k,lda", SPLIT_HALVES)
def test_shufflenet_split_halves_stay(pixels, k, lda):
    """A Split half starts K = C/2 bytes into its row: at byte offsets 58,
    116 and 232 (none a multiple of 16), its K and lda not multiples of 16."""
    for half in (0, 1):
        assert i8_route(pixels * 64, k, k, lda, 0x10000 + half * k, 0, 0, False) is None
    assert not i8_takes(k, k, lda, 0x10000 + k, 0, 0, False)


@pytest.mark.parametrize("a_ptr,b_ptr,c_ptr,why", [
    (0x1008, 0x2000, 0x3000, "A 8 bytes off a 16-byte boundary"),
    (0x1000, 0x2004, 0x3000, "B 4 bytes off"),
    (0x1000, 0x2000, 0x3002, "C 2 bytes off"),
])
def test_unaligned_bases_stay_on_the_mma_loop(a_ptr, b_ptr, c_ptr, why):
    assert i8_route(50176, 576, 128, 576, a_ptr, b_ptr, c_ptr, False) is None, why
    assert i8_route(50176, 576, 128, 576, 0x1000, 0x2000, 0x3000, False) is not None


@pytest.mark.parametrize("k,n,lda,out,takes,why", [
    (64, 128, 64, F32, True, "R's 56x56 shortcut"),
    (16, 96, 16, BF16, True, "K = 16: one 32-byte step, half of it past K (not routed)"),
    (144, 136, 144, F32, True, "K = 144: a last step of 16 bytes"),
    (96, 128, 112, F32, True, "lda > K"),
    (147, 64, 147, F32, False, "the K = 147 stem"),
    (24, 144, 24, F32, False, "K = 24"),
    (64, 32, 64, F32, False, "N = 32: below the 64-wide tile"),
    (64, 100, 64, BF16, False, "N = 100 in bf16: not a multiple of 8"),
    (64, 100, 64, F32, True, "N = 100 in float32: a multiple of 4"),
    (64, 128, 72, F32, False, "lda = 72"),
    (0, 128, 0, F32, False, "K = 0"),
])
def test_i8_takes(k, n, lda, out, takes, why):
    assert i8_takes(k, n, lda, 0, 0, 0, out == BF16) == takes, why


def test_crossover_is_work_not_rows():
    """The threshold is M·K·N: R's 3x3/s2 patches at B = 1 and its 1x1
    shortcut at B = 4 have the same M, the first takes the mma.sync loop,
    launches with the threshold's work the wgmma one."""
    assert i8_route(784, 576, 128, 576, 0, 0, 0, False) is None
    m = -(-I8_WGMMA_MIN_MACS // (576 * 128))
    assert i8_route(m, 576, 128, 576, 0, 0, 0, False) is not None
    assert i8_route(m - 1, 576, 128, 576, 0, 0, 0, False) is None


# -- the plan and its shared memory ------------------------------------------

def _routed_shapes():
    return sorted({(m, k, n, out) for _, _, m, k, n in _launches() for out in (4, 2)
                   if i8_route(m, k, n, k, 0, 0, 0, out == 2) is not None})


@pytest.mark.parametrize("m,k,n,out_bytes", _routed_shapes())
def test_plan_fits_two_blocks_an_sm(m, k, n, out_bytes):
    """Every routed shape's block fits the card's 227 KB a block and two fit
    an SM; the ring takes what is left beside the C tile, at least 3 stages;
    K splits only below one tile an SM; a grid of at most two blocks an SM
    unless each block takes one work unit."""
    plan = i8_plan(m, k, n, out_bytes)
    c_tile = 128 * plan.bn * out_bytes if plan.bn == 64 else 0
    assert plan.smem == i8w_smem(plan.bn, plan.stages, out_bytes)
    assert plan.smem >= plan.stages * (128 + plan.bn) * 128 + c_tile
    assert gemm.I8W_PER_SM * (plan.smem + gemm.SMEM_RESERVED) <= gemm.SMEM_PER_SM
    assert 3 <= plan.stages <= gemm.I8W_MAX_STAGES
    room = gemm.SMEM_PER_SM // gemm.I8W_PER_SM - gemm.SMEM_RESERVED
    assert plan.stages == gemm.I8W_MAX_STAGES or i8w_smem(plan.bn, plan.stages + 1,
                                                          out_bytes) > room
    assert plan.sl == i8_slice(k) and plan.bn <= n
    tiles = -(-m // 128) * -(-n // plan.bn)
    assert plan.units == tiles * plan.splits
    assert plan.splits == 1 or (tiles < gemm.SMS and plan.splits * tiles <= gemm.SMS)
    assert plan.grid == plan.units or plan.grid == min(plan.units, 2 * gemm.SMS)


@pytest.mark.parametrize("k,sl", [(16, 32), (32, 32), (48, 64), (64, 64), (80, 128),
                                  (96, 128), (144, 128), (2304, 128)])
def test_slice_is_the_narrowest_that_holds_k(k, sl):
    assert i8_slice(k) == sl


@pytest.mark.parametrize("m,k,n,out_bytes,bn,splits,unit_blocks", [
    (50176, 576, 128, 4, 128, 1, False),    # R at 64, float32: 128-wide tiles
    (50176, 576, 128, 2, 64, 1, False),     # bf16 below K = 1024: staged C tiles
    (50176, 64, 128, 4, 64, 1, False),      # K below 128: staged C tiles
    (12544, 1152, 256, 2, 128, 1, False),   # bf16, K >= 1024 and tiles enough
    (3136, 2304, 512, 2, 128, 1, False),    # 100 tiles: no split
    (3136, 960, 320, 4, 64, 1, False),      # 75 128-wide tiles: 64-wide ones
    (401408, 576, 128, 2, 128, 1, True),    # the headline's: one unit a block
    (100352, 1152, 256, 4, 128, 1, True),   # 1568 tiles, 8 waves
    (100352, 128, 256, 4, 128, 1, False),   # ... but not below K = 512
    (401408, 64, 128, 2, 64, 1, False),     # nor at K = 64
    (784, 2304, 512, 4, 64, 2, False),      # 56 tiles, 18 stages of k: split
    (784, 576, 128, 4, 64, 1, False),       # 14 tiles, 5 stages of k: none
])
def test_plan_choices(m, k, n, out_bytes, bn, splits, unit_blocks):
    plan = i8_plan(m, k, n, out_bytes)
    assert (plan.bn, plan.splits, plan.grid == plan.units > 2 * gemm.SMS) == \
        (bn, splits, unit_blocks)


def test_the_conv_plan_is_unchanged():
    """conv_direct.direct_plan shares i8w_plan with its own defaults: R's
    four widths at B = 64 and the 7x7 conv's two splits."""
    from pyopenvino_tpu_torch.kernels.conv_direct import direct_plan

    for hw, c, _ in chip_smoke.RESNET18_DIRECT:
        plan = direct_plan(64 * hw * hw, 9 * c, c, c)
        assert plan == i8w_plan(64 * hw * hw, 9 * c, c, min(c, 128))
        assert plan.bn == (64 if c == 64 else 128) and plan.grid == min(plan.units, 264)
    assert direct_plan(64 * 49, 4608, 512, 512).splits == 2


def test_python_constants_match_the_header_and_the_entry():
    header = (CSRC / "i8_wgmma.cuh").read_text()
    for name, value in (("BM", gemm.I8W_BM), ("PER_SM", gemm.I8W_PER_SM),
                        ("STAGE_K", gemm.I8W_STAGE_K), ("MAX_STAGES", gemm.I8W_MAX_STAGES),
                        ("MAX_BN", gemm.I8W_MAX_BN)):
        assert int(re.search(rf"constexpr int {name} = (\d+);", header).group(1)) == value
    assert gemm.I8W_SMEM_EXTRA == 1024 + 2 * gemm.I8W_MAX_BN * 4 + 2 * gemm.I8W_MAX_STAGES * 8
    assert "struct TiledA {" in header and "tma_load(a_dst, ta, s * sl, m0, bar);" in header
    assert "K < 16 || K % 16 || lda < K || lda % 16" in header
    source = (CSRC / "fused_gemm.cu").read_text()
    entry = re.search(r'extern "C" int fused_gemm_i8i8_wgmma\((.*?)\)', source, re.S).group(1)
    # A, B, scale, bias, C, M, N, K, lda, out_bf16, act, lo, hi, bn, sl,
    # stages, splits, grid, ws, stream: as _kernel_fn binds them
    assert len(entry.split(",")) == 20
    assert [t for t in entry.split(",")][-2:] == [" void* ws", "\n                                     void* stream"]


# -- the producer's k walk ------------------------------------------------------

def _k_steps(k, sl):
    """The wgmma loop's k steps as TiledA::load walks them: step s reads
    bytes [s·sl, (s + 1)·sl) of every row of A and of the K-major B, zeros
    past K; a stage holds STAGE_K / sl consecutive steps."""
    return [(s * sl, (s + 1) * sl) for s in range(-(-k // sl))]


def _k32_steps(k):
    """The consumers' wgmma k32 steps, stage by stage: stage g multiplies
    bytes [g·128 + 32q, g·128 + 32q + 32) for q below
    ceil((min(K, (g + 1)·128) − g·128) / 32)."""
    out = []
    for g in range(-(-k // 128)):
        k32 = (min(k, (g + 1) * 128) - g * 128 + 31) // 32
        out += [(g * 128 + 32 * q, g * 128 + 32 * q + 32) for q in range(k32)]
    return out


@pytest.mark.parametrize("k", [16, 32, 48, 64, 80, 96, 112, 144, 160, 464, 576, 1152, 2304])
@pytest.mark.parametrize("sl", [32, 64, 128])
def test_k_walk_covers_k_once_with_zeros_past_k(k, sl):
    """The producer's steps cover [0, K) once; a stage's steps are whole
    STAGE_K groups of K; the consumers' k32 steps stay inside what the
    stage's steps brought and cover [0, K); summed over the k32 steps, with
    TMA's zeros past K in A and B, the products give the exact product."""
    steps = _k_steps(k, sl)
    assert steps[0][0] == 0 and all(a[1] == b[0] for a, b in zip(steps, steps[1:]))
    assert steps[-1][1] >= k > steps[-1][0]
    taps = 128 // sl
    groups = [steps[g:g + taps] for g in range(0, len(steps), taps)]
    assert len(groups) == -(-k // 128) and [grp[0][0] for grp in groups] == \
        list(range(0, k, 128))
    k32 = _k32_steps(k)
    assert k32[0][0] == 0 and k32[-1][1] >= k > k32[-1][0]
    assert all(a[1] == b[0] for a, b in zip(k32, k32[1:]))
    assert k32[-1][1] <= steps[-1][1]  # nothing read that no step brought
    rng = np.random.default_rng(k + sl)
    a = rng.integers(-127, 128, (37, k)).astype(np.int64)
    b = rng.integers(-127, 128, (11, k)).astype(np.int64)
    pad = steps[-1][1] - k
    a_box, b_box = np.pad(a, ((0, 0), (0, pad))), np.pad(b, ((0, 0), (0, pad)))
    acc = sum(a_box[:, lo:hi] @ b_box[:, lo:hi].T for lo, hi in k32)
    np.testing.assert_array_equal(acc, a @ b.T)


# -- i8_loop on the CPU -----------------------------------------------------------

def _codes(shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(-127, 128, shape).astype(np.int8))


@pytest.mark.parametrize("loop", [None, "wgmma", "mma"])
@pytest.mark.parametrize("out", [F32, BF16], ids=["f32_out", "bf16_out"])
def test_cpu_tensors_take_the_plain_version_and_leave_the_counters(loop, out):
    a, b = _codes((300, 64)), _codes((128, 64), 1).t()
    scale = torch.from_numpy(np.random.default_rng(2).uniform(1e-4, 1e-2, 128).astype(np.float32))
    before = [getattr(fused_gemm, c) for c in gemm.COUNTERS]
    got = fused_gemm(a, b, scale, None, ("relu", 0.0, 0.0), out_dtype=out, i8_loop=loop)
    assert [getattr(fused_gemm, c) for c in gemm.COUNTERS] == before
    assert torch.equal(got, fused_gemm_plain(a, b, scale, None, ("relu", 0.0, 0.0), out))


@pytest.mark.parametrize("a_dtype,loop,match", [
    (torch.int8, "tma", "i8_loop 'tma'"),
    (torch.int8, "WGMMA", "i8_loop 'WGMMA'"),
    (torch.float32, "wgmma", "needs an int8 a"),
    (torch.bfloat16, "mma", "needs an int8 a"),
])
def test_i8_loop_is_validated_on_the_cpu(a_dtype, loop, match):
    a = _codes((4, 32)).to(a_dtype)
    b = _codes((64, 32), 1)
    b = b.t() if a_dtype == torch.int8 else b.t().contiguous().to(a_dtype)
    with pytest.raises(ValueError, match=match):
        fused_gemm(a, b, torch.ones(64), i8_loop=loop)


# -- the profiler's names -----------------------------------------------------------

@pytest.mark.parametrize("name,category", [
    ("void i8wgmma::i8_wgmma_kernel<i8wgmma::TiledA, 128, float>(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, i8wgmma::TiledA, float const*, float const*, float*, "
     "int*, int, int, int, int, int, int, float, float)", "fused_gemm_i8i8"),
    ("void i8wgmma::i8_wgmma_kernel<i8wgmma::TiledA, 64, __nv_bfloat16>(CUtensorMap_st "
     "const, CUtensorMap_st const, CUtensorMap_st const, i8wgmma::TiledA, float const*, "
     "float const*, __nv_bfloat16*, int*, int, int, int, int, int, int, float, float)",
     "fused_gemm_i8i8_bf16"),
    ("void i8mma::i8i8_mma_kernel<i8mma::RowMajor, float>(i8mma::RowMajor, i8mma::RowMajor, "
     "float const*, float const*, float*, int*, long long, int, int, int, int, float, float)",
     "fused_gemm_i8i8"),
    ("void i8wgmma::i8_wgmma_kernel<i8wgmma::ConvAIm2col, 128, float>(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, i8wgmma::ConvAIm2col, float const*, float const*, "
     "float*, int*, int, int, int, int, int, int, float, float)", "conv2d_direct"),
])
def test_profiler_files_the_tiled_kernel_under_fused_gemm_i8i8(name, category):
    from pyopenvino_tpu_torch.runtime.profiling import categorize

    assert categorize(name) == category
