"""fused_gemm's float32-A wgmma loop (csrc/f32_wgmma.cuh: #1 with a
float32 B, #1w with an int8 B), what the CPU can check of it.

The loop itself runs only on a card (tests/test_torch_port_gpu.py, ``-k
f32_wgmma``, holds it to the plain version and to itself there).  What
routes a launch to it, its ring, splits, band and grid, and its shared
memory are plain Python in kernels/gemm.py (``f32_route``, ``f32_takes``,
``f32_plan``, ``f32w_smem``); the plan's split ranges are checked here
under tests/test_torch_port_gemm_tc.py's model of the TF32 passes
(``tc_product``), which stands for the loop's arithmetic but is not run
by it; the profiler's names for it are in runtime/profiling.py.  Nothing
here needs a card.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pyopenvino_tpu_torch.kernels import gemm
from pyopenvino_tpu_torch.kernels.gemm import (
    F32_WGMMA_MIN_MACS, f32_plan, f32_route, f32_takes, f32w_smem, fused_gemm, fused_gemm_plain,
)
import test_torch_port_threads  # noqa: F401  (this worker's torch threads)

import chip_smoke
from test_torch_port_gemm_tc import tc_product
from test_torch_port_gpu import EFFICIENTNET_I8I8, SHUFFLENET_GEMMS

CSRC = Path(gemm.__file__).resolve().parents[1] / "csrc"
GEMM_RTOL, I8W_RTOL = chip_smoke.GEMM_RTOL, chip_smoke.I8W_RTOL  # the card's gates
KERNELS_RTOL = 1e-5  # tests/test_torch_port_kernels.py's, against the Pallas kernel

# #1's and #1w's launches of the seven families, (M per image, K, N,
# launches per forward, lda): R and M from chip_smoke.py's tables; S its
# 1×1 convs with co >= 128 and ci >= 64 (ops/conv.py::kernel_route); E the
# same rule over its convs (the SE convs have ci < 64 or co < 128) and its
# FC; G its FC; Sh chip_smoke.launch_table's (three of the eight 49×232×232
# take a Split half, lda 464); P ResNet-18's
EFFICIENTNET_GEMMS = sorted(
    [(m, k, n, c) for m, k, n, c in EFFICIENTNET_I8I8 if m > 1 and k >= 64 and n >= 128]
    + [(1, 1280, 1000, 1)])
F32_NETS = {
    "resnet18": chip_smoke.resnet18_gemms(1),
    "mobilenet_v2": chip_smoke.mobilenet_v2_gemms(1),
    "ssd_shapes_ms": [(361, 64, 128, 1), (361, 128, 128, 5), (100, 128, 256, 1),
                      (100, 256, 256, 1)],
    "efficientnet_b0": EFFICIENTNET_GEMMS,
    "googlenet_shapes": [(1, 256, 10, 1)],
    "shufflenet_v2": SHUFFLENET_GEMMS,
    "resnet18_pot": chip_smoke.resnet18_gemms(1),
}
F32_LAUNCHES = {"resnet18": 4, "mobilenet_v2": 16, "ssd_shapes_ms": 8, "efficientnet_b0": 17,
                "googlenet_shapes": 1, "shufflenet_v2": 11, "resnet18_pot": 4}


def test_family_tables_count_each_forward():
    """The tables give each family's #1 / #1w launches a forward (PERF.md
    §6: R 4, M 16, S 8, E 17, G 1, Sh 11, P 4)."""
    assert {model: sum(c for *_, c in table) for model, table in F32_NETS.items()} == F32_LAUNCHES


def _launches():
    """(model, batch, M, K, N, lda) of every #1 / #1w launch of the seven
    families at B = 1 and 64; ShuffleNet-v2's Split halves with lda 464."""
    out = set()
    for model, table in F32_NETS.items():
        for b in (1, 64):
            for m, k, n, _ in table:
                out.add((model, b, m * b, k, n, k))
                if model == "shufflenet_v2" and (m, k, n) == (49, 232, 232):
                    out.add((model, b, m * b, k, n, 464))
    return sorted(out)


def _why_not(m, k, n, lda, b_int8, a_off=0):
    """Why f32_route keeps a launch on the mma.sync loop, or None."""
    if lda % 4:
        return "A's rows not 16-byte strides"
    if a_off % 16:
        return "A's base not 16-byte aligned"
    if n < 64:
        return "N below the 64-wide tile"
    if n % (16 if b_int8 else 4):
        return "B's rows not 16-byte strides"
    if m * k * n < F32_WGMMA_MIN_MACS:
        return "below the crossover"
    return None


# -- the route ---------------------------------------------------------------

@pytest.mark.parametrize("b_int8", [False, True], ids=["f32_b", "i8_b"])
@pytest.mark.parametrize("model,batch,m,k,n,lda", _launches())
def test_route_of_every_family_launch(model, batch, m, k, n, lda, b_int8):
    """Each launch takes the wgmma loop exactly when nothing keeps it on the
    old one (``_why_not``), with the plan of its shape; at B = 1 none."""
    plan = f32_route(m, k, n, lda, 0x1000, 0x2000, 0x3000, b_int8)
    why = _why_not(m, k, n, lda, b_int8)
    assert (plan is None) == (why is not None), why
    if plan is not None:
        assert plan == f32_plan(m, k, n, b_int8)
    if batch == 1:
        assert plan is None


def _routed(model, batch, b_int8):
    return sorted((m, k, n, lda) for mo, b, m, k, n, lda in _launches()
                  if (mo, b) == (model, batch)
                  and f32_route(m, k, n, lda, 0, 0, 0, b_int8) is not None)


def test_routed_shapes_of_resnet18_and_mobilenet_v2():
    """At B = 64 R's three shortcuts and M's seven 1×1 convs, not their
    FCs (2^25 and 2^26.3 multiply-adds), with either B type."""
    r = [(m, k, n, k) for m, k, n, _ in chip_smoke.resnet18_gemms(64)[:3]]
    mv2 = [(m, k, n, k) for m, k, n, _ in chip_smoke.mobilenet_v2_gemms(64)[:7]]
    for b_int8 in (False, True):
        assert _routed("resnet18", 64, b_int8) == sorted(r)
        assert _routed("resnet18_pot", 64, b_int8) == sorted(r)
        assert _routed("mobilenet_v2", 64, b_int8) == sorted(mv2)


def test_routed_launches_per_family():
    """What the route takes at B = 64, in launches a forward: every 1×1
    conv of R, M, S, E, Sh and P with a float32 B (Sh's Split halves too),
    no FC and nothing of G; with an int8 B the same but Sh's N = 232 convs
    (one launch, its 464 → 1024 head, left)."""
    def launches(b_int8):
        return {model: sum(c for m, k, n, c in table
                           if any((m * 64, k, n) == r[:3] for r in _routed(model, 64, b_int8)))
                for model, table in F32_NETS.items()}

    want = {"resnet18": 3, "mobilenet_v2": 15, "ssd_shapes_ms": 8, "efficientnet_b0": 16,
            "googlenet_shapes": 0, "shufflenet_v2": 10, "resnet18_pot": 3}
    assert launches(False) == want
    assert launches(True) == {**want, "shufflenet_v2": 1}


@pytest.mark.parametrize("a_off,b_off,c_off,why", [
    (8, 0, 0, "A 8 bytes off a 16-byte boundary"),
    (0, 4, 0, "B 4 bytes off"),
    (0, 0, 8, "C 8 bytes off"),
])
def test_unaligned_bases_stay_on_the_mma_loop(a_off, b_off, c_off, why):
    args = (12544, 96, 576, 96)
    assert f32_route(*args, 0x1000 + a_off, 0x2000 + b_off, 0x3000 + c_off, False) is None, why
    assert f32_route(*args, 0x1000, 0x2000, 0x3000, False) is not None


@pytest.mark.parametrize("k,n,lda,b_int8,takes,why", [
    (64, 128, 64, False, True, "R's 56x56 shortcut"),
    (77, 200, 80, False, True, "K = 77: TMA's zeros past K; N = 200 a ragged band"),
    (96, 128, 97, False, False, "lda = 97"),
    (232, 232, 464, False, True, "ShuffleNet-v2's Split half, lda 464"),
    (232, 232, 464, True, False, "... with an int8 B: N = 232 not a multiple of 16"),
    (512, 1000, 512, False, True, "an FC's N = 1000 with a float32 B"),
    (512, 1000, 512, True, False, "... with an int8 B"),
    (960, 160, 960, True, True, "N = 160 with an int8 B"),
    (256, 10, 256, False, False, "N = 10: below the 64-wide tile"),
    (64, 62, 64, False, False, "N = 62"),
    (0, 128, 0, False, False, "K = 0"),
])
def test_f32_takes(k, n, lda, b_int8, takes, why):
    assert f32_takes(k, n, lda, 0, 0, 0, b_int8) == takes, why


def test_crossover_is_work_not_rows():
    """The threshold is M·K·N: R's shortcut at batch 1 stays; the launch
    with the threshold's work takes the wgmma loop, one row fewer does not."""
    assert f32_route(784, 64, 128, 64, 0, 0, 0, False) is None
    m = -(-F32_WGMMA_MIN_MACS // (64 * 128))
    assert f32_route(m, 64, 128, 64, 0, 0, 0, False) is not None
    assert f32_route(m - 1, 64, 128, 64, 0, 0, 0, False) is None


@pytest.mark.parametrize("b_int8", [False, True])
def test_shufflenet_split_halves(b_int8):
    """A float32 Split half starts 232 values (928 bytes, a multiple of 16)
    into its row: it takes the route as a dense A would with a float32 B;
    with an int8 B N = 232 keeps it on the old loop."""
    dense = f32_route(64 * 49, 232, 232, 232, 0x10000, 0, 0, b_int8)
    half = f32_route(64 * 49, 232, 232, 464, 0x10000 + 928, 0, 0, b_int8)
    assert half == dense and (half is None) == b_int8


# -- the plan and its shared memory ------------------------------------------

def _routed_shapes():
    return sorted({(m, k, n, b_int8) for _, _, m, k, n, lda in _launches()
                   for b_int8 in (False, True)
                   if f32_route(m, k, n, lda, 0, 0, 0, b_int8) is not None})


@pytest.mark.parametrize("m,k,n,b_int8", _routed_shapes())
def test_plan_fits_its_share_of_the_sm(m, k, n, b_int8):
    """Every routed shape's block fits its share of the SM (113 KB at two
    blocks an SM); the ring takes what is left beside the slots (a band's,
    or the stream's), at least two stages; K splits only below one tile an
    SM, each split at least F32W_SPLIT_STEPS k steps, and no split is empty;
    a grid of at most two blocks an SM."""
    plan = f32_plan(m, k, n, b_int8)
    steps = -(-k // 32)
    slots = steps if plan.band else gemm.F32W_STREAM_SLOTS
    assert plan.smem == f32w_smem(plan.stages, b_int8, slots)
    stage = 128 * 32 * 4 + 32 * 64 * (1 if b_int8 else 4)
    terms = (1 if b_int8 else 2) * 64 * 128
    assert plan.smem >= plan.stages * stage + slots * terms
    assert 2 * (plan.smem + gemm.SMEM_RESERVED) <= gemm.SMEM_PER_SM
    room = gemm.SMEM_PER_SM // 2 - gemm.SMEM_RESERVED
    assert plan.stages == gemm.F32W_MAX_STAGES or f32w_smem(
        plan.stages + 1, b_int8, slots) > room
    assert plan.stages >= 2
    assert not (plan.band and plan.splits > 1)
    tiles = -(-m // 128) * -(-n // 64)
    blocks = 2 * gemm.SMS
    assert plan.units == tiles * plan.splits
    assert plan.splits == 1 or (tiles < gemm.SMS and plan.splits * tiles <= blocks)
    assert plan.splits == 1 or -(-steps // plan.splits) >= gemm.F32W_SPLIT_STEPS
    per = -(-steps // plan.splits)
    assert (plan.splits - 1) * per < steps  # the last split has a k step
    assert plan.grid == min(plan.units, blocks)


@pytest.mark.parametrize("m,k,n,b_int8,splits,band", [
    (50176, 64, 128, False, 1, True),     # R's shortcut: a band of 2 k steps
    (12544, 96, 576, False, 1, True),     # M's expand: 3
    (3136, 256, 512, False, 1, False),    # 8 steps of float32 terms: streams
    (3136, 256, 512, True, 1, True),      # ... of int8 codes as floats: a band
    (3136, 960, 320, False, 2, False),    # 125 tiles for 132 SMs: split
    (3136, 960, 160, False, 3, False),    # 75 tiles: three splits
    (3136, 1152, 192, True, 3, False),
    (3136, 232, 232, False, 1, False),    # 100 tiles of 8 steps: no split
    (64, 1280, 1000, False, 6, False),    # an FC: 40 steps, at least 6 a split
])
def test_plan_choices(m, k, n, b_int8, splits, band):
    plan = f32_plan(m, k, n, b_int8)
    assert (plan.splits, plan.band) == (splits, band)


def test_forced_plans():
    """f32_plan's forced choices (chip_smoke.py's f32_plans lines): a band
    cannot split, a band that does not fit gives no plan, splits are cut to
    leave none empty; N below the 64-wide tile gives no plan."""
    assert f32_plan(50176, 64, 128, False, band=False).band is False
    assert f32_plan(3136, 960, 160, False, band=True) is None
    assert f32_plan(3136, 960, 160, False, splits=1).splits == 1
    assert f32_plan(64, 512, 1000, False, splits=7).splits == 6  # 16 steps: 3 a split
    assert f32_plan(100, 64, 32, False) is None
    assert f32_plan(100, 64, 64, False) is not None


def test_python_constants_match_the_header_and_the_entries():
    header = (CSRC / "f32_wgmma.cuh").read_text()
    for name, value in (("BM", gemm.F32W_BM), ("BN", gemm.F32W_BN), ("BK", gemm.F32W_BK),
                        ("PER_SM", gemm.F32W_PER_SM), ("MAX_STAGES", gemm.F32W_MAX_STAGES),
                        ("STREAM_SLOTS", gemm.F32W_STREAM_SLOTS)):
        assert int(re.search(rf"constexpr int {name} = (\d+);", header).group(1)) == value
    assert "constexpr int A_BYTES = BM * BK * 4;" in header
    assert gemm.F32W_A_BYTES == gemm.F32W_BM * gemm.F32W_BK * 4
    assert gemm.F32W_SMEM_EXTRA == (1024 + 2 * gemm.F32W_BN * 4
                                    + 2 * gemm.F32W_MAX_STAGES * 8)
    assert "constexpr int SMEM_EXTRA = 1024 + 2 * BN * 4 + 2 * MAX_STAGES * 8;" in header
    # one kernel a B type: no other tile or blocks an SM is built
    assert "template <class BT>\n__global__ void __launch_bounds__(THREADS, PER_SM)" in header
    assert f"constexpr int SMEM_MAX = {gemm.SMEM_PER_SM - gemm.SMEM_RESERVED};" in header
    # the split of each B type is f32_mma.cuh's
    assert "f32mma::split_trunc(a, hi, lo);" in header and "f32mma::split_rna(a, hi, lo);" in header
    source = (CSRC / "fused_gemm.cu").read_text()
    for entry in ("fused_gemm_f32_wgmma", "fused_gemm_f32_i8w_wgmma"):
        args = re.search(rf'extern "C" int {entry}\((.*?)\)', source, re.S).group(1)
        # A, B, scale, bias, C, M, N, K, lda, act, lo, hi, stages, splits,
        # band, grid, ws, stream: as _kernel_fn binds them
        names = [a.split()[-1].lstrip("*") for a in args.split(",")]
        assert names == ["A", "B", "scale", "bias", "C", "M", "N", "K", "lda", "act", "lo",
                         "hi", "stages", "splits", "band", "grid", "ws", "stream"]


# -- f32_loop on the CPU -----------------------------------------------------------

def _f32(shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def _codes(shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(-127, 128, shape).astype(np.int8))


@pytest.mark.parametrize("loop", [None, "wgmma", "mma"])
@pytest.mark.parametrize("b_int8", [False, True], ids=["f32_b", "i8_b"])
def test_cpu_tensors_take_the_plain_version_and_leave_the_counters(loop, b_int8):
    a = _f32((300, 64))
    b = _codes((64, 128), 1) if b_int8 else _f32((64, 128), 1)
    scale = torch.from_numpy(np.random.default_rng(2).uniform(1e-3, 1e-2, 128).astype(np.float32))
    scale = scale if b_int8 else None
    before = [getattr(fused_gemm, c) for c in gemm.COUNTERS]
    got = fused_gemm(a, b, scale, None, ("relu", 0.0, 0.0), f32_loop=loop)
    assert [getattr(fused_gemm, c) for c in gemm.COUNTERS] == before
    assert torch.equal(got, fused_gemm_plain(a, b, scale, None, ("relu", 0.0, 0.0)))


@pytest.mark.parametrize("a_dtype,loop,match", [
    (torch.float32, "tma", "f32_loop 'tma'"),
    (torch.float32, "MMA", "f32_loop 'MMA'"),
    (torch.int8, "wgmma", "needs a float32 a"),
    (torch.bfloat16, "mma", "needs a float32 a"),
])
def test_f32_loop_is_validated_on_the_cpu(a_dtype, loop, match):
    a = _codes((4, 32)).to(a_dtype)
    b = _codes((64, 32), 1)
    b = b.t() if a_dtype == torch.int8 else b.t().contiguous().to(
        torch.float32 if a_dtype == torch.float32 else a_dtype)
    with pytest.raises(ValueError, match=match):
        fused_gemm(a, b, torch.ones(64), f32_loop=loop)


# -- the profiler's names -----------------------------------------------------------

# f32_wgmma.cuh's kernel as the profiler names it: its one template
# argument, the B side (tests/test_torch_port_gpu.py's
# test_f32_wgmma_profiled_under_its_category reads the names on the card)
F32W_ARGS = ("(CUtensorMap_st, CUtensorMap_st, float const*, float const*, float*, float*, "
             "int, int, int, int, int, int, int, int, float, float)")


@pytest.mark.parametrize("name,category", [
    ("void f32wgmma::f32_wgmma_kernel<f32wgmma::BFloat>" + F32W_ARGS, "fused_gemm"),
    ("void f32wgmma::f32_wgmma_kernel<f32wgmma::BInt8>" + F32W_ARGS, "fused_gemm_i8w"),
    # a B side followed by another template argument files the same
    ("void f32wgmma::f32_wgmma_kernel<64, f32wgmma::BFloat, 2>" + F32W_ARGS, "fused_gemm"),
    ("void f32wgmma::f32_wgmma_kernel<64, f32wgmma::BInt8, 2>" + F32W_ARGS, "fused_gemm_i8w"),
    ("void f32mma::f32_mma_kernel<f32mma::RowMajorF32, f32mma::BFloat>"
     "(f32mma::RowMajorF32, f32mma::BFloat, float const*)", "fused_gemm"),
    ("void f32mma::f32_mma_kernel<f32mma::RowMajorF32, f32mma::BInt8>"
     "(f32mma::RowMajorF32, f32mma::BInt8, float const*)", "fused_gemm_i8w"),
    ("void bf16wgmma::bf16_wgmma_kernel<128, bf16wgmma::BandInt8>(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, float const*, float const*, int, int, int, int, int, "
     "int, int, float, float)", "fused_gemm_bf16_i8w"),
    ("void i8mma::splitk_reduce<float, true, float>(float const*, int, long long, int, "
     "float const*, float const*, float*, int, float, float)", "splitk_reduce"),
])
def test_profiler_files_the_wgmma_kernels_under_fused_gemm(name, category):
    from pyopenvino_tpu_torch.runtime.profiling import categorize

    assert categorize(name) == category


# -- the loop's arithmetic, emulated -------------------------------------------------

def _emulated_error(m, k, n, b_int8, seed, rows=64, cols=128):
    """The relative error against float64 of ``tc_product``'s model of the
    TF32 passes (three cut TF32 terms for a float32 B, two rounded ones of
    A for an int8 B; a float32 accumulator, eight products a k8 step) at
    the split ranges of f32_plan at (m, k, n), on the first ``rows`` rows
    and ``cols`` columns (rows and columns are independent sums).  A check
    of the plan's splits under that model; the loop itself is held to the
    gates on the card."""
    plan = f32_plan(m, k, n, b_int8)
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((min(m, rows), k)).astype(np.float32)
    if b_int8:
        b = rng.integers(-127, 128, (k, min(n, cols))).astype(np.float64)
    else:
        b = (rng.standard_normal((k, min(n, cols))) / np.sqrt(k)).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    steps = -(-k // 32)
    kchunk = -(-steps // plan.splits) * 32  # the plan's k steps a split
    got = tc_product(a, b, 2 if b_int8 else 3, kchunk)
    return np.abs(got - exact).max() / np.abs(exact).max()


@pytest.mark.parametrize("m,k,n,b_int8", _routed_shapes())
def test_emulated_loop_within_a_quarter_of_the_gate(m, k, n, b_int8):
    err = _emulated_error(m, k, n, b_int8, seed=m + 3 * k + 7 * n + b_int8)
    assert err <= (I8W_RTOL if b_int8 else GEMM_RTOL) / 4, err


def test_split_ranges_of_the_plan_are_whole_steps():
    """The k ranges the plan's splits take are whole 32-value steps, each
    split at least one, and they cover K once (what the emulation uses)."""
    for m, k, n, b_int8 in _routed_shapes():
        plan = f32_plan(m, k, n, b_int8)
        steps = -(-k // 32)
        per = -(-steps // plan.splits)
        ranges = gemm.split_ranges(k, per * 32)
        assert len(ranges) == plan.splits
        assert ranges[0][0] == 0 and ranges[-1][1] == k
        assert all(lo < hi and lo % 32 == 0 for lo, hi in ranges)


@pytest.mark.parametrize("m,k,n,b_int8,splits,act", [
    (130, 70, 129, False, 1, ("relu", 0.0, 0.0)),
    (64, 512, 200, False, 4, None),
    (77, 96, 128, True, 1, ("clamp", -0.5, 0.75)),
    (49, 256, 64, True, 2, None),
])
def test_emulated_loop_against_the_pallas_kernel(m, k, n, b_int8, splits, act):
    """``tc_product``'s model of the TF32 passes at ``splits`` split ranges
    of whole 32-value steps, as f32_plan cuts K, then the epilogue in its
    order, against the JAX package's fused_gemm in interpret mode, within
    tests/test_torch_port_kernels.py's tolerance: a check of the split
    ranges under the model, not of the loop (the card tests hold that)."""
    import jax.numpy as jnp

    from pyopenvino_tpu.kernels.gemm import fused_gemm as jax_fused_gemm

    rng = np.random.default_rng(m + k + n + splits)
    a = rng.standard_normal((m, k)).astype(np.float32)
    if b_int8:
        b = rng.integers(-127, 128, (k, n)).astype(np.int8)
        scale = rng.uniform(1e-3, 1e-2, n).astype(np.float32)
    else:
        b = rng.standard_normal((k, n)).astype(np.float32)
        scale = None
    bias = rng.standard_normal(n).astype(np.float32)
    want = np.asarray(jax_fused_gemm(
        jnp.asarray(a), jnp.asarray(b), scale=None if scale is None else jnp.asarray(scale),
        bias=jnp.asarray(bias), act=act, interpret=True))
    steps = -(-k // 32)
    acc = tc_product(a, b.astype(np.float64) if b_int8 else b, 2 if b_int8 else 3,
                     -(-steps // splits) * 32)
    t = lambda v: None if v is None else torch.from_numpy(v)  # noqa: E731
    got = gemm.epilogue(t(acc), t(scale), t(bias), act).numpy()
    err = np.abs(got.astype(np.float64) - want).max() / np.abs(want).max()
    assert err <= KERNELS_RTOL, err
