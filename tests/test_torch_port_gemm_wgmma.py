"""fused_gemm's bfloat16 wgmma loop (csrc/bf16_wgmma.cuh), what the CPU can
check of it.

The loop itself runs only on a card (tests/test_torch_port_gpu.py holds it
to the plain version there).  What routes a launch to it, the band width it
takes and whether its band of B fits in shared memory are plain Python in
kernels/gemm.py (``bf16_route``, ``wgmma_plan``, ``band_widths``,
``wgmma_smem``); the profiler's names for it are in runtime/profiling.py.
Nothing here needs a card.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pyopenvino_tpu_torch.kernels import gemm
from pyopenvino_tpu_torch.kernels.gemm import (
    WGMMA_MIN_M, WGMMA_MIN_M_I8, band_widths, bf16_route, fused_gemm, fused_gemm_plain,
    wgmma_aligned, wgmma_plan, wgmma_smem,
)
import test_torch_port_threads  # noqa: F401  (this worker's torch threads)

import chip_smoke

HEADER = Path(gemm.__file__).resolve().parents[1] / "csrc" / "bf16_wgmma.cuh"


def _aligned(m, k, n, lda=None, b_int8=False):
    return bf16_route(m, k, n, k if lda is None else lda, 0x1000, 0x2000, b_int8)


# -- the route -------------------------------------------------------------

@pytest.mark.parametrize("m,k,n,lda,a_ptr,b_ptr,why", [
    (1000, 96, 130, 97, 0, 0, "lda and N not multiples of 8"),
    (37, 77, 129, 77, 0, 0, "lda, K and N not multiples of 8"),
    (3136, 96, 128, 97, 0, 0, "lda not a multiple of 8"),
    (3136, 96, 130, 96, 0, 0, "N not a multiple of 8"),
    (3136, 100, 128, 104, 0, 0, "K not a multiple of 8"),
    (3136, 96, 128, 96, 8, 0, "A not 16-byte aligned"),
    (3136, 96, 128, 96, 0, 2, "B not 16-byte aligned"),
    (1, 1280, 1000, 1280, 0, 0, "an FC at batch 1"),
    (49, 256, 512, 256, 0, 0, "ResNet-18's 7x7 shortcut at batch 1"),
    (63, 512, 1024, 512, 0, 0, "below both crossovers"),
])
def test_route_keeps_unaligned_and_small_launches_on_the_mma_loop(m, k, n, lda, a_ptr, b_ptr,
                                                                 why):
    assert bf16_route(m, k, n, lda, a_ptr, b_ptr) is None, why
    assert bf16_route(m, k, n, lda, a_ptr, b_ptr, b_int8=True) is None, why


def test_wgmma_aligned_needs_16_byte_rows_and_bases():
    assert wgmma_aligned(96, 128, 104, 0x10, 0x20)
    assert not wgmma_aligned(96, 128, 97, 0x10, 0x20)
    assert not wgmma_aligned(96, 128, 96, 0x18, 0x20)
    assert not wgmma_aligned(96, 136, 96, 0x10, 0x20, b_int8=True)


def test_route_needs_n_a_multiple_of_16_with_an_int8_b():
    # ShuffleNet-v2's 232 columns: 464 bytes a bf16 row, 232 an int8 one
    assert bf16_route(3136, 232, 232, 464, 0, 0) is not None
    assert bf16_route(3136, 232, 232, 464, 0, 0, b_int8=True) is None
    assert bf16_route(3136, 232, 240, 464, 0, 0, b_int8=True) is not None


@pytest.mark.parametrize("m,k,n,lda", [
    (3136, 232, 232, 464),   # ShuffleNet-v2's Split half: a strided A
    (3136, 96, 128, 104),    # lda > K, both multiples of 8
    (WGMMA_MIN_M, 64, 128, 64),
])
def test_route_takes_aligned_launches_to_the_wgmma_loop(m, k, n, lda):
    plan = bf16_route(m, k, n, lda, 0x10, 0x7f0)
    assert plan is not None and plan == wgmma_plan(m, k, n)


@pytest.mark.parametrize("b_int8,crossover", [(False, WGMMA_MIN_M), (True, WGMMA_MIN_M_I8)])
def test_route_crossover_by_b_type(b_int8, crossover):
    assert _aligned(crossover - 1, 64, 128, b_int8=b_int8) is None
    assert _aligned(crossover, 64, 128, b_int8=b_int8) is not None


def test_every_batch64_main_path_shape_of_resnet18_and_mobilenet_v2_takes_wgmma():
    """Every #1b launch (the FCs at M = 64 too); every #1bw launch but the
    FCs, whose 1000 int8 columns are no TMA row stride."""
    for gemms in chip_smoke.GEMMS.values():
        for m, k, n, _ in gemms(chip_smoke.BATCH):
            assert _aligned(m, k, n) is not None, (m, k, n)
            assert (_aligned(m, k, n, b_int8=True) is None) == (n == 1000), (m, k, n)


# -- the band width and the shared-memory budget ---------------------------

@pytest.mark.parametrize("n,widths", [
    (8, [64]), (64, [64]), (128, [128, 64]), (160, [192, 128, 64]),
    (232, [256, 128, 64]), (384, [192, 128, 64]), (576, [192, 128, 64]),
    (1000, [256, 192, 128, 64]), (1280, [256, 192, 128, 64]),
])
def test_band_widths_widest_first_one_per_band_count(n, widths):
    got = band_widths(n)
    assert got == widths
    bands = [-(-n // w) for w in got]
    assert bands == sorted(set(bands))  # each width lowers the band count


# (M, K, N) -> (bn, stages, stream): the main paths' batch-64 shapes
@pytest.mark.parametrize("m,k,n,bn,stages,stream", [
    (50176, 64, 128, 128, 8, False),   # R: the 3x3/s2 shortcut, 784 tiles
    (12544, 128, 256, 128, 7, False),  # 256 wide leaves no room for 4 stages
    (3136, 256, 512, 64, 8, False),    # 196 tiles at 128 wide: 64 gives 392
    (12544, 112, 672, 192, 4, False),  # E's largest
    (3136, 960, 160, 64, 6, True),     # M: a 120 KB band fits no block's share
    (3136, 320, 1280, 64, 7, False),   # M's head
    (3136, 1152, 320, 64, 6, True),    # E
])
def test_plan_of_path_shapes(m, k, n, bn, stages, stream):
    plan = wgmma_plan(m, k, n)
    assert (plan.bn, plan.stages, plan.stream) == (bn, stages, stream)
    assert plan.tiles == -(-m // 64) * -(-n // bn)
    assert plan.grid == min(plan.tiles, gemm.WGMMA_PER_SM * gemm.SMS)


def _fits(k, bn, stream, int8, stages=gemm.WGMMA_MIN_STAGES):
    room = gemm.SMEM_PER_SM // gemm.WGMMA_PER_SM - gemm.SMEM_RESERVED
    return wgmma_smem(k, bn, stages, stream, int8) <= room


@pytest.mark.parametrize("m,k,n", [
    (50176, 64, 128), (3136, 960, 160), (3136, 320, 1280), (3136, 1152, 192),
    (784, 64, 128), (1000, 200, 1008), (130, 8, 16), (3136, 1408, 64), (12544, 112, 672),
])
@pytest.mark.parametrize("int8", [False, True])
def test_plan_fits_the_shared_memory(m, k, n, int8):
    plan = wgmma_plan(m, k, n, int8)
    assert plan.smem == wgmma_smem(k, plan.bn, plan.stages, plan.stream, int8)
    assert _fits(k, plan.bn, plan.stream, int8, plan.stages)
    assert not _fits(k, plan.bn, plan.stream, int8, plan.stages + 1) or (
        plan.stages == gemm.WGMMA_MAX_STAGES)
    assert gemm.WGMMA_MIN_STAGES <= plan.stages <= gemm.WGMMA_MAX_STAGES
    # B streams only where its band does not fit
    assert plan.stream == (not _fits(k, plan.bn, False, int8))
    # the widest band giving every block a tile, else the one with most tiles
    for w in [w for w in band_widths(n) if w > plan.bn]:
        fits = _fits(k, w, False, int8) or _fits(k, w, True, int8)
        assert not fits or -(-m // 64) * -(-n // w) < gemm.WGMMA_PER_SM * gemm.SMS


def test_a_band_that_does_not_fit_streams():
    # 1408 rows of k at 64 columns (176 KB) fit no block's share of an SM
    assert not wgmma_plan(3136, 64, 64).stream
    assert wgmma_plan(3136, 1408, 64).stream
    assert wgmma_plan(3136, 1408, 64, b_int8=True).stream
    assert _aligned(3136, 4096, 256).stream
    # an int8 B streams its codes beside the converted k step: a larger stage
    assert wgmma_plan(3136, 1408, 64, True).stages < wgmma_plan(3136, 1408, 64).stages


def test_wgmma_smem_counts_ring_band_c_tile_and_barriers():
    extra = 1024 + 2048 + 18 * 8  # alignment slack, scale and bias, barriers
    # K = 100 rounds up to 128 rows of k
    assert wgmma_smem(100, 192, 5) == 5 * 8192 + 128 * 192 * 2 + 64 * 192 * 2 + extra
    # B streaming: no band, each stage A, B's k step in bf16 (and the codes)
    assert wgmma_smem(100, 64, 5, True) == 5 * (8192 + 8192) + 64 * 64 * 2 + extra
    assert wgmma_smem(100, 64, 5, True, True) == 5 * (8192 + 8192 + 4096) + 64 * 64 * 2 + extra


def test_python_constants_match_the_header():
    text = HEADER.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+)", text).group(1))

    assert (const("BM"), const("BK")) == (gemm.WGMMA_BM, gemm.WGMMA_BK)
    assert const("MAX_STAGES") == gemm.WGMMA_MAX_STAGES
    assert const("BM") * const("BK") * 2 == gemm.WGMMA_STAGE_BYTES
    assert re.search(r"SMEM_EXTRA = 1024 \+ 2 \* MAX_BN \* 4 \+ \(2 \* MAX_STAGES \+ 2\) \* 8;",
                     text)
    assert const("MAX_BN") == max(gemm.WGMMA_WIDTHS)
    assert gemm.WGMMA_SMEM_EXTRA == 1024 + 2 * 256 * 4 + (2 * gemm.WGMMA_MAX_STAGES + 2) * 8
    for w in gemm.WGMMA_WIDTHS:
        assert f"struct Wgmma<{w}>" in text and f"BF16_WGMMA_CASE({w})" in text


# -- the CPU takes the plain version ---------------------------------------

@pytest.mark.parametrize("int8,loop", [(False, None), (True, None), (False, "wgmma"),
                                       (True, "mma")])
def test_cpu_tensors_take_the_plain_version_and_leave_the_counters(int8, loop):
    rng = np.random.default_rng(12)
    a = torch.from_numpy(rng.standard_normal((192, 64)).astype(np.float32)).bfloat16()
    if int8:
        b = torch.from_numpy(rng.integers(-127, 128, (64, 128)).astype(np.int8))
        scale = torch.from_numpy(rng.uniform(1e-3, 1e-2, 128).astype(np.float32))
    else:
        b = torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32)).bfloat16()
        scale = None
    bias = torch.from_numpy(rng.standard_normal(128).astype(np.float32))
    before = {c: getattr(fused_gemm, c) for c in gemm.COUNTERS}
    got = fused_gemm(a, b, scale, bias, ("relu", 0.0, 0.0), bf16_loop=loop)
    assert {c: getattr(fused_gemm, c) for c in gemm.COUNTERS} == before
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, fused_gemm_plain(a, b, scale, bias, ("relu", 0.0, 0.0)))


# -- the profiler's names --------------------------------------------------

@pytest.mark.parametrize("name,category", [
    ("void bf16wgmma::bf16_wgmma_kernel<128, bf16wgmma::BandBf16>(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, float const*, float const*, int, int, int, int, int, "
     "int, float, float)", "fused_gemm_bf16"),
    ("void bf16wgmma::bf16_wgmma_kernel<64, bf16wgmma::BandInt8>(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, float const*, float const*, int, int, int, int, int, "
     "int, float, float)", "fused_gemm_bf16_i8w"),
    ("void bf16wgmma::bf16_wgmma_kernel<256, bf16wgmma::BandInt8>(CUtensorMap_st const, "
     "CUtensorMap_st const, CUtensorMap_st const, float const*, float const*, int, int, int, "
     "int, int, int, float, float)", "fused_gemm_bf16_i8w"),
])
def test_profiler_files_the_wgmma_kernels_under_their_variants(name, category):
    from pyopenvino_tpu_torch.runtime.profiling import categorize

    assert categorize(name) == category
