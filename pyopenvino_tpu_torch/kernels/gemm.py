"""fused_gemm: ``act((A @ B) * scale + bias)`` as one hand-written CUDA kernel.

Counterpart of ``pyopenvino_tpu/kernels/gemm.py::fused_gemm`` (the Pallas
TPU kernel) in its variants: float32 A and B; float32 A and int8 B (INT8
weight-only, per-column dequant scale applied to the accumulator); int8 A
and B (INT8-FULL: an exact int32 sum, then the per-column scale, written
in float32 or bfloat16); bfloat16 A and B, and bfloat16 A with int8 B
(``compute_dtype="bfloat16"``: one bf16 pass, a float32 accumulator and
epilogue, a bfloat16 result).  The kernel is ``csrc/fused_gemm.cu``, one C
entry point per (A, B) type pair, built by ``nvcc`` into a plain-C library
on first use (kernels/build.py) and called through ``ctypes`` on PyTorch's
current stream.  All run on the tensor cores: float32 A by TF32 passes of
its hi and lo terms (three against a float32 B, whose terms are split too;
two against an int8 B, exact in TF32), by TF32 ``wgmma`` on TMA loads with
B's terms made in shared memory, ``csrc/f32_wgmma.cuh``, where
``f32_route`` finds the launch aligned and large enough, else by TF32
``mma.sync``, ``csrc/f32_mma.cuh``; int8 × int8
by int8 ``mma.sync``, ``csrc/i8_mma.cuh``; bfloat16 A by bf16 ``wgmma``
on TMA loads and a band of B kept in shared memory (or streamed where it
does not fit), ``csrc/bf16_wgmma.cuh``, where ``bf16_route`` finds the
launch aligned and large enough, else by bf16 ``mma.sync``,
``csrc/bf16_mma.cuh``; int8 × int8 likewise by int8 ``wgmma`` on tiled
TMA loads, ``csrc/i8_wgmma.cuh``, where ``i8_route`` finds the launch
aligned and large enough, else by int8 ``mma.sync``.  The ``mma.sync``
loops split K across blocks when their tile grid would not fill the card
(``split_k``), the int8 and float32 ``wgmma`` loops when they have fewer
tiles than SMs (``i8_plan``, ``f32_plan``).  Scale and bias
are float32 to the kernels; bfloat16 ones (a bfloat16 network stores them
so) are widened first, exactly.

The int8 × int8 variant takes B K-major: the (K, N) ``.t()`` view of an
(N, K) contiguous matrix, because the tensor cores' int8 B fragment holds
consecutive k of one column.  The other variants take a contiguous (K, N) B.

``fused_gemm_plain`` is the same function in plain PyTorch.  The wrapper
takes it only for tensors that lie on the CPU (the CPU tests and the CPU
device); for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

_ACT_CODES = {None: 0, "relu": 1, "clamp": 2}
_INT_MAX = 2 ** 31 - 1
SMS = 132  # streaming multiprocessors of an H100 SXM
MAX_SPLITS = 32


class SplitPlan(NamedTuple):
    """A tensor-core loop's tile (BM, BN, BK) and when splitting K pays, per
    132 SMs: below ``most_tiles`` output tiles and from ``least_steps`` K
    steps on, K is cut so that about ``wave`` blocks run."""
    bm: int
    bn: int
    bk: int
    wave: int
    most_tiles: int
    least_steps: int


# csrc/i8_mma.cuh (fused_gemm_i8i8; conv_direct.cu's conv2d_direct_i8 on
# the same loop) and csrc/f32_mma.cuh (fused_gemm_f32_i8w and
# fused_gemm_f32, four 128-thread blocks an SM each; conv_direct.cu's
# conv2d_direct_f32 on the same loop, one plan for both its weight types).
# The thresholds come from sweeps of every main-path shape over split
# counts on an H100 (tools/sweep_split_k.py): splitting the int8 GEMM lost
# from about 50 tiles on, the int8-B loop gained up to 147 tiles and lost
# at 245, and the float32-B loop gained at 147 tiles and lost at 245, from
# two K steps.  csrc/bf16_mma.cuh (fused_gemm_bf16, fused_gemm_bf16_i8w)
# has the float32 loop's tile and takes its two loops' thresholds (a card
# sweep kept them: the planned splits within 3 % of the best per forward);
# conv_direct.cu's conv2d_direct_bf16 on the same loop takes
# conv2d_direct_f32's, not swept.
PLANS = {
    "fused_gemm_i8i8": SplitPlan(128, 64, 64, wave=132, most_tiles=32, least_steps=4),
    "fused_gemm_f32_i8w": SplitPlan(64, 64, 32, wave=528, most_tiles=176, least_steps=3),
    "fused_gemm_f32": SplitPlan(64, 64, 32, wave=528, most_tiles=176, least_steps=2),
    "conv2d_direct": SplitPlan(128, 64, 64, wave=132, most_tiles=32, least_steps=4),
    "conv2d_direct_f32": SplitPlan(64, 64, 32, wave=528, most_tiles=176, least_steps=2),
    "fused_gemm_bf16": SplitPlan(64, 64, 32, wave=528, most_tiles=176, least_steps=2),
    "fused_gemm_bf16_i8w": SplitPlan(64, 64, 32, wave=528, most_tiles=176, least_steps=3),
    "conv2d_direct_bf16": SplitPlan(64, 64, 32, wave=528, most_tiles=176, least_steps=2),
}


def apply_act(out, act):
    """Activation epilogue: None | ("relu", _, _) | ("clamp", lo, hi)."""
    if act is None:
        return out
    kind, lo, hi = act
    if kind == "relu":
        return torch.relu(out)
    if kind == "clamp":
        return torch.clamp(out, lo, hi)
    raise ValueError(f"unknown activation {kind!r}")


def epilogue(acc, scale=None, bias=None, act: Optional[tuple] = None):
    """act(acc * scale + bias) on a float32 ``acc`` whose last dim is the
    output channel, each step rounded on its own (the kernels' order)."""
    if scale is not None:
        acc = acc * scale
    if bias is not None:
        acc = acc + bias
    return apply_act(acc, act)


def matmul_int32(a, b):
    """The exact int32 product of int8 codes: float64 holds every partial
    sum (an integer below 2^53) exactly, in any summation order."""
    return torch.round(torch.matmul(a.double(), b.double())).to(torch.int32)


def conv2d_int32(x, w, strides=(1, 1), dilations=(1, 1), pads=((0, 0), (0, 0)),
                 groups=1):
    """The exact int32 sum of a convolution of int8 codes (NCHW x, OIHW w,
    pads ((top, bottom), (left, right)) read as zeros), computed in float64
    as ``matmul_int32`` is."""
    (pt, pb), (pl, pr) = pads
    xd = F.pad(x.double(), (pl, pr, pt, pb))
    acc = F.conv2d(xd, w.double(), stride=strides, dilation=dilations, groups=groups)
    return torch.round(acc).to(torch.int32)


def fused_gemm_plain(a, b, scale=None, bias=None, act: Optional[tuple] = None,
                     out_dtype=None):
    """The kernel's function in plain PyTorch: act((a @ b) * scale + bias),
    epilogue in the kernel's order, in float32, then one cast to
    ``out_dtype`` (default: float32 for an int8 ``a``, else ``a``'s
    dtype).  An int8 ``b`` is converted to float32 and its scale
    multiplies the product, as in the kernel; with an int8 ``a`` too, the
    product is the exact int32 sum, converted to float32.  bfloat16
    operands are widened to float32 (exactly) and summed there.  A
    bfloat16 scale or bias is widened first."""
    out_dtype = out_dtype or (torch.float32 if a.dtype == torch.int8 else a.dtype)
    scale = None if scale is None else scale.float()
    bias = None if bias is None else bias.float()
    if a.dtype == torch.int8:
        acc = matmul_int32(a, b).float()
    else:
        acc = torch.matmul(a.float(), b.float())
    return epilogue(acc, scale, bias, act).to(out_dtype)


def split_k(m: int, k: int, n: int, plan: SplitPlan, sms: int = SMS) -> int:
    """k per split (a multiple of the plan's K step) for an (m, k) @ (k, n)
    launch on a card of ``sms`` SMs.

    One split (the return value covers K) when the M × N tile grid is large
    enough to keep the card busy or K is short; otherwise as many splits as
    bring the grid to about ``plan.wave`` blocks, at most MAX_SPLITS and at
    most one per K step."""
    tiles = -(-m // plan.bm) * -(-n // plan.bn)
    steps = max(1, -(-k // plan.bk))
    if tiles == 0 or tiles * SMS > plan.most_tiles * sms or steps < plan.least_steps:
        return steps * plan.bk
    splits = min(steps, -(-plan.wave * sms // (SMS * tiles)), MAX_SPLITS)
    return -(-steps // splits) * plan.bk


class WgmmaPlan(NamedTuple):
    """A launch of csrc/bf16_wgmma.cuh: band width ``bn`` (the wgmma N),
    ring ``stages``, ``stream`` (B comes with each k step instead of a band
    resident in shared memory), at most ``grid`` persistent blocks,
    ``tiles`` output tiles of 64 × bn, ``smem`` dynamic shared-memory bytes
    a block (WGMMA_PER_SM blocks fit on an SM)."""
    bn: int
    stages: int
    stream: bool
    grid: int
    tiles: int
    smem: int


# csrc/bf16_wgmma.cuh's constants (BM, BK, STAGE_BYTES, MAX_STAGES,
# SMEM_EXTRA; its __launch_bounds__ keeps registers for WGMMA_PER_SM blocks
# an SM) and an H100's shared memory: 228 KB an SM, 1 KB of each block's
# share reserved by the system
WGMMA_BM, WGMMA_BK, WGMMA_PER_SM = 64, 64, 2
WGMMA_STAGE_BYTES, WGMMA_MAX_STAGES, WGMMA_MIN_STAGES = 8192, 8, 4
WGMMA_SMEM_EXTRA = 1024 + 2 * 256 * 4 + (2 * WGMMA_MAX_STAGES + 2) * 8
SMEM_PER_SM, SMEM_RESERVED = 233472, 1024
WGMMA_WIDTHS = (256, 192, 128, 64)


def wgmma_stage_bytes(bn: int, stream: bool = False, int8: bool = False) -> int:
    """One ring stage: A's 64 × 64 bf16 box; with ``stream`` also B's k
    step, bn columns of bf16 and, for an int8 B, its codes."""
    return WGMMA_STAGE_BYTES + ((bn * WGMMA_BK * 2 + (bn * WGMMA_BK if int8 else 0))
                                if stream else 0)


def wgmma_smem(k: int, bn: int, stages: int, stream: bool = False, int8: bool = False) -> int:
    """Dynamic shared memory of a bf16_wgmma.cuh block: the ring, the band
    of B (K rounded up to 64 rows of bn bf16; none when B streams), the
    64 × bn C tile, the band's scale and bias, the barriers and the
    alignment slack."""
    kpad = -(-k // WGMMA_BK) * WGMMA_BK
    return (stages * wgmma_stage_bytes(bn, stream, int8) + (0 if stream else kpad * bn * 2)
            + WGMMA_BM * bn * 2 + WGMMA_SMEM_EXTRA)


def band_widths(n: int):
    """The wgmma band widths worth trying for N columns, widest first: each
    the widest of the four that gives its number of bands."""
    bands = lambda w: -(-n // w)  # noqa: E731
    return [w for w in WGMMA_WIDTHS
            if w <= -(-n // 64) * 64 and (w == 64 or bands(w) < bands(w - 64))]


def wgmma_plan(m: int, k: int, n: int, b_int8: bool = False,
               sms: int = SMS) -> Optional[WgmmaPlan]:
    """The bf16_wgmma.cuh launch for an (m, k) @ (k, n) product, or None
    when nothing fits in shared memory.

    WGMMA_PER_SM blocks an SM, so that one block's loads and products run
    while the other writes its tile (a block has one consumer warpgroup,
    which runs its epilogue between products; one block an SM with a band
    twice as wide ran slower on an H100).  The widest band
    (fewest bands: A read the fewest times) that gives every block a tile,
    else the narrowest (the most tiles).  A band is resident in shared
    memory when it, the C tile and a ring of WGMMA_MIN_STAGES stages fit
    in a block's share, else B streams with A through the ring, one k step
    a stage; the ring takes what is left, up to WGMMA_MAX_STAGES."""
    room = SMEM_PER_SM // WGMMA_PER_SM - SMEM_RESERVED
    m_tiles = -(-m // WGMMA_BM)
    plan = None
    for bn in band_widths(n):
        for stream in (False, True):
            stages = min(WGMMA_MAX_STAGES,
                         (room - wgmma_smem(k, bn, 0, stream, b_int8))
                         // wgmma_stage_bytes(bn, stream, b_int8))
            if stages >= WGMMA_MIN_STAGES:
                break
        else:
            continue
        tiles = m_tiles * -(-n // bn)
        plan = WgmmaPlan(bn, stages, stream, min(tiles, WGMMA_PER_SM * sms), tiles,
                         wgmma_smem(k, bn, stages, stream, b_int8))
        if tiles >= WGMMA_PER_SM * sms:
            break
    return plan


# The crossovers below which bf16_route keeps a launch on the mma.sync loop
# (csrc/bf16_mma.cuh, whose split K fills the card at small M), from both
# loops timed at every main-path shape by chip_smoke.py's phase 5a on an
# H100 (wgmma / mma.sync time): with a bf16 B 0.74-1.07x at 64 rows (the
# classifiers' FCs at batch 64), 0.78-0.81x at 100, 0.47-0.99x from 196 on,
# but 0.76-1.25x at 49 (slower where B streams) and 1.02-1.38x at one row;
# with an int8 B, whose band is converted once per block and so per tile
# when M is small, 0.84-1.92x below 128 rows and 0.51-0.96x from 196 on.
WGMMA_MIN_M, WGMMA_MIN_M_I8 = 64, 128


def wgmma_aligned(k: int, n: int, lda: int, a_ptr: int, b_ptr: int,
                  b_int8: bool = False) -> bool:
    """Whether csrc/bf16_wgmma.cuh takes these operands.  TMA needs 16-byte
    aligned bases and row strides: A and B at addresses that are multiples
    of 16, lda and N multiples of 8 values (and of 16 for an int8 B, whose
    values are bytes); the loop takes K in multiples of 8."""
    return not (lda % 8 or n % (16 if b_int8 else 8) or k % 8 or a_ptr % 16 or b_ptr % 16)


def bf16_route(m: int, k: int, n: int, lda: int, a_ptr: int, b_ptr: int,
               b_int8: bool = False, sms: int = SMS) -> Optional[WgmmaPlan]:
    """The loop of a bfloat16 fused_gemm launch: the plan of the wgmma loop
    (csrc/bf16_wgmma.cuh), or None for the mma.sync loop
    (csrc/bf16_mma.cuh): the wgmma loop where it takes the operands
    (``wgmma_aligned``) and M is at least WGMMA_MIN_M (WGMMA_MIN_M_I8 with
    an int8 B).  A pure function of the shape and the operands' addresses,
    never of whether a launch succeeded."""
    if (m < (WGMMA_MIN_M_I8 if b_int8 else WGMMA_MIN_M)
            or not wgmma_aligned(k, n, lda, a_ptr, b_ptr, b_int8)):
        return None
    return wgmma_plan(m, k, n, b_int8, sms)


class I8WgmmaPlan(NamedTuple):
    """A launch of csrc/i8_wgmma.cuh: tile N ``bn`` (the wgmma N; tiles are
    I8W_BM rows), ``sl`` bytes of k a step (a conv: one tap's channel
    slice), ring ``stages``, K ``splits``, at most ``grid`` persistent
    blocks, ``units`` work units (tiles × splits), ``smem`` dynamic
    shared-memory bytes a block (I8W_PER_SM blocks fit on an SM)."""
    bn: int
    sl: int
    stages: int
    splits: int
    grid: int
    units: int
    smem: int


# csrc/i8_wgmma.cuh's constants (BM, PER_SM, STAGE_K, MAX_STAGES, MAX_BN,
# SMEM_EXTRA; its __launch_bounds__ keeps registers for I8W_PER_SM blocks
# an SM) and the bytes of k a step may take (one 128-, 64- or 32-byte
# swizzled row a tile row; wgmma's int8 k step is 32 bytes)
I8W_BM, I8W_PER_SM, I8W_STAGE_K, I8W_MAX_STAGES, I8W_MAX_BN = 128, 2, 128, 8, 128
I8W_SMEM_EXTRA = 1024 + 2 * I8W_MAX_BN * 4 + 2 * I8W_MAX_STAGES * 8
I8W_SLICES = (128, 64, 32)


def i8w_smem(bn: int, stages: int, out_bytes: int = 4) -> int:
    """Dynamic shared memory of an i8_wgmma.cuh block: the ring (A's I8W_BM
    rows and B's bn rows, I8W_STAGE_K bytes of k each, a stage), the
    I8W_BM × bn C tile of ``out_bytes`` values where the tile is 64 wide
    (128-wide tiles store from the accumulators), the band's scale and
    bias, the barriers and the alignment slack."""
    return (I8W_SMEM_EXTRA + stages * (I8W_BM + bn) * I8W_STAGE_K
            + (I8W_BM * bn * out_bytes if bn == 64 else 0))


@functools.lru_cache(maxsize=1024)
def i8w_plan(m: int, k: int, n: int, sl: int, out_bytes: int = 4, sms: int = SMS,
             bn: Optional[int] = None, wave: int = I8W_PER_SM,
             split_groups: int = 2) -> Optional[I8WgmmaPlan]:
    """The i8_wgmma.cuh launch of an (m, k) @ (k, n) product in steps of
    ``sl`` bytes of k with ``out_bytes`` bytes an output value, or None
    when N is below the tile's width.

    Tiles of 128 × ``bn`` (by default 128 where N is 128 or more, else 64;
    B's bytes a stage at most A's, A read from L2 once per band); as many
    stages of I8W_STAGE_K bytes of k as fit in a block's share of the SM
    beside its C tile with I8W_PER_SM blocks, at most I8W_MAX_STAGES (a
    deeper ring at one block an SM was slower on an H100); at most
    I8W_PER_SM persistent blocks an SM.  K is split where there are fewer
    tiles than SMs, into as many splits as keep the work units within
    ``wave`` blocks an SM, at most MAX_SPLITS and at most one per
    ``split_groups`` stages' worth of k.  The defaults are the conv's: on
    an H100, R's 7x7 conv at batch 64 (100 tiles) took 0.87x the time with
    2 splits and 1.15x with 3 (a second wave), the 14x14 one (196 tiles)
    1.5x with 2."""
    bn = bn or (128 if n >= 128 else 64)
    if n < bn:
        return None
    room = SMEM_PER_SM // I8W_PER_SM - SMEM_RESERVED
    stages = min(I8W_MAX_STAGES, (room - i8w_smem(bn, 0, out_bytes))
                 // ((I8W_BM + bn) * I8W_STAGE_K))
    tiles = -(-m // I8W_BM) * -(-n // bn)
    groups = -(-k // I8W_STAGE_K)  # stages' worth of k
    splits = 1
    if 0 < tiles < sms:
        splits = max(1, min(wave * sms // tiles, MAX_SPLITS, groups // split_groups))
    units = tiles * splits
    return I8WgmmaPlan(bn, sl, stages, splits, max(1, min(units, I8W_PER_SM * sms)), units,
                       i8w_smem(bn, stages, out_bytes))


# The least work, M·K·N multiply-adds, and the least K that i8_route sends
# to the wgmma loop; below them the mma.sync loop, whose split K fills the
# card at small M and which has the smaller fixed cost.  From
# chip_smoke.py's crossover lines (R's and M's launches at batch 1 ... 16
# on both loops) on an H100: wgmma / mma.sync time summed 1.09 from 2^25
# to 2^26 multiply-adds, 1.00 from 2^26 to 2^27, 0.89 from 2^27 to 2^28,
# 0.77 above; K = 16 (a 32-byte step, half of it zeros) 1.06-1.20 at
# every batch up to 16.
I8_WGMMA_MIN_MACS = 2 ** 27
I8_WGMMA_MIN_K = 32


def i8_slice(k: int) -> int:
    """The bytes of k of one step of the wgmma loop for a GEMM of depth K:
    the narrowest of 32, 64 and 128 that holds K, else 128 (a stage's
    width, the fewest loads; TMA writes zeros past K, the products stop
    at K's last 32 bytes)."""
    return next((sl for sl in sorted(I8W_SLICES) if sl >= k), I8W_SLICES[0])


# The GEMM's plan on an H100, from chip_smoke.py's i8_plans lines (each
# routed shape at 64- and 128-wide tiles, persistent or one work unit a
# block, one split where the plan splits): 64-wide tiles, whose C tile is
# staged in shared memory and stored by TMA, where K is below 128 (there
# the epilogue is most of the time: 0.42-0.98x the 128-wide tiles' time,
# which store 4-byte bf16 or 8-byte float32 pairs from the accumulators)
# and for a bf16 C (0.41-1.01x); 128-wide tiles (A read once per 128
# columns) for a float32 C from K = 128 where they give at least two
# thirds of the SMs a tile (0.66-0.98x; below that the 64-wide tiles fill
# the card, 0.85-0.94x), and for a bf16 C from K = 1024 likewise
# (0.81-0.95x) or from K = 512 where the tiles fill I8_UNIT_BLOCKS_WAVES
# waves of blocks; there one work unit a block (0.72-0.89x the persistent
# walk's time; 0.85-1.11x with fewer tiles).  K split only below one tile
# an SM and 4 stages' worth of k a split.
I8_UNIT_BLOCKS_WAVES = 8
I8_SPLITS = {"wave": 1, "split_groups": 4}  # i8w_plan's split rule for the GEMM


def i8_plan(m: int, k: int, n: int, out_bytes: int = 4,
            sms: int = SMS) -> Optional[I8WgmmaPlan]:
    """The i8_wgmma.cuh launch of an int8 × int8 (m, k) @ (k, n) product
    (``i8w_plan`` in ``i8_slice``'s steps, the tile width and the grid as
    measured above), or None for N below 64."""
    tiles = -(-m // I8W_BM) * -(-n // 128)
    many = k >= 512 and tiles >= I8_UNIT_BLOCKS_WAVES * sms
    wide = n >= 128 and k >= 128 and (
        3 * tiles >= 2 * sms and (out_bytes == 4 or k >= 1024) or many)
    plan = i8w_plan(m, k, n, i8_slice(k), out_bytes, sms, 128 if wide else 64, **I8_SPLITS)
    if plan is not None and plan.bn == 128 and many:
        plan = plan._replace(grid=plan.units)
    return plan


def i8_takes(k: int, n: int, lda: int, a_ptr: int, b_ptr: int, c_ptr: int,
             out_bf16: bool) -> bool:
    """Whether csrc/i8_wgmma.cuh takes an int8 × int8 launch: TMA needs
    16-byte aligned bases and row strides, so A, B and C at addresses that
    are multiples of 16, lda and K (B's row stride) multiples of 16, and C's
    rows whole 16-byte units (N a multiple of 4 float32 or 8 bf16 values);
    N at least the 64-wide tile."""
    return not (k < 16 or k % 16 or lda % 16 or a_ptr % 16 or b_ptr % 16 or c_ptr % 16
                or n < 64 or n % (8 if out_bf16 else 4))


def i8_route(m: int, k: int, n: int, lda: int, a_ptr: int, b_ptr: int, c_ptr: int,
             out_bf16: bool, sms: int = SMS) -> Optional[I8WgmmaPlan]:
    """The loop of an int8 × int8 fused_gemm launch: the plan of the wgmma
    loop (csrc/i8_wgmma.cuh), or None for the mma.sync loop
    (csrc/i8_mma.cuh): the wgmma loop where it takes the operands
    (``i8_takes``), K is at least I8_WGMMA_MIN_K and the launch's M·K·N
    multiply-adds are at least I8_WGMMA_MIN_MACS.  A pure function of the
    shape and the operands' addresses, never of whether a launch
    succeeded."""
    if (m * k * n < I8_WGMMA_MIN_MACS or k < I8_WGMMA_MIN_K
            or not i8_takes(k, n, lda, a_ptr, b_ptr, c_ptr, out_bf16)):
        return None
    return i8_plan(m, k, n, 2 if out_bf16 else 4, sms)


class F32WgmmaPlan(NamedTuple):
    """A launch of csrc/f32_wgmma.cuh (tiles of F32W_BM × F32W_BN, two
    blocks an SM): ring ``stages``, K ``splits``, ``band`` (B's TF32 terms
    made once a band and kept in shared memory; else once a k step, B
    streaming with A), at most ``grid`` persistent blocks, ``units`` work
    units (tiles × splits), ``smem`` dynamic shared-memory bytes a block."""
    stages: int
    splits: int
    band: bool
    grid: int
    units: int
    smem: int


# csrc/f32_wgmma.cuh's constants (BM, BN, BK, PER_SM, MAX_STAGES,
# STREAM_SLOTS: B's term tiles in rotation when B streams, A_BYTES,
# SMEM_EXTRA)
F32W_BM, F32W_BN, F32W_BK, F32W_PER_SM, F32W_MAX_STAGES = 128, 64, 32, 2, 8
F32W_STREAM_SLOTS, F32W_A_BYTES = 2, 128 * 32 * 4
F32W_SMEM_EXTRA = 1024 + 2 * F32W_BN * 4 + 2 * F32W_MAX_STAGES * 8
# the fewest k steps a split
F32W_SPLIT_STEPS = 6


def f32w_smem(stages: int, b_int8: bool, slots: int) -> int:
    """Dynamic shared memory of an f32_wgmma.cuh block: the ring (A's
    F32W_BM × 32 float32 box and B's raw 32 × F32W_BN tile a stage),
    ``slots`` tiles of B's terms (F32W_BN rows of 128 bytes, two terms for
    a float32 B), the band's scale and bias, the barriers and the alignment
    slack."""
    return (F32W_SMEM_EXTRA + stages * (F32W_A_BYTES + F32W_BK * F32W_BN * (1 if b_int8 else 4))
            + slots * (1 if b_int8 else 2) * F32W_BN * F32W_BK * 4)


@functools.lru_cache(maxsize=1024)
def f32_plan(m: int, k: int, n: int, b_int8: bool = False, sms: int = SMS,
             band: Optional[bool] = None,
             splits: Optional[int] = None) -> Optional[F32WgmmaPlan]:
    """The f32_wgmma.cuh launch of an (m, k) @ (k, n) float32 product with a
    float32 or int8 (``b_int8``) B, or None when N is below the tile's
    width or nothing fits.  ``band`` and ``splits`` force those choices
    (measurements: chip_smoke.py's ``f32_plans`` lines).

    K is split where there are fewer tiles than SMs, into as many splits
    as keep the work units within one wave of blocks, at most MAX_SPLITS
    and at least F32W_SPLIT_STEPS k steps a split (M's 3136 × 576 × 160 at
    batch 64, 75 tiles: three splits 0.82-0.83x one on an H100;
    ShuffleNet-v2's 3136 × 232 × 232, 100 tiles of 8 steps: two splits
    1.19x one).  With one split, B's terms are kept a band at a time where
    the band and two ring stages fit a block's share of the SM, else they
    are made once a k step in F32W_STREAM_SLOTS rotating slots; the ring
    takes the rest, at most F32W_MAX_STAGES stages."""
    if n < F32W_BN:
        return None
    tiles = -(-m // F32W_BM) * -(-n // F32W_BN)
    steps = max(1, -(-k // F32W_BK))
    blocks = F32W_PER_SM * sms
    if splits is None:
        splits = 1
        if 0 < tiles < sms:
            splits = max(1, min(blocks // tiles, MAX_SPLITS, steps // F32W_SPLIT_STEPS))
    splits = -(-steps // -(-steps // splits))  # no empty split
    room = SMEM_PER_SM // F32W_PER_SM - SMEM_RESERVED
    stage = F32W_A_BYTES + F32W_BK * F32W_BN * (1 if b_int8 else 4)
    fits = lambda slots: (room - f32w_smem(0, b_int8, slots)) // stage  # noqa: E731
    if band is None:
        band = splits == 1 and fits(steps) >= 2
    if band and splits > 1:
        return None
    slots = steps if band else F32W_STREAM_SLOTS
    stages = min(F32W_MAX_STAGES, fits(slots))
    if stages < 2:
        return None
    units = tiles * splits
    return F32WgmmaPlan(stages, splits, band, max(1, min(units, blocks)), units,
                        f32w_smem(stages, b_int8, slots))


# The least work, M·K·N multiply-adds, that f32_route sends to the wgmma
# loop; below it the mma.sync loop (csrc/f32_mma.cuh), whose split K fills
# the card at small M and which has the smaller fixed cost.  From
# chip_smoke.py's crossover lines (R's and M's #1 and #1w launches at batch
# 1 ... 16 on both loops) and its batch-64 rows, in two runs on an H100:
# wgmma / mma.sync time summed 1.04-1.82 below 2^25 multiply-adds,
# 0.93-1.02 from 2^25 to 2^26, 1.01-1.06 from 2^26 to 2^27 (the FCs at
# M = 64 among them), 0.84-0.87 from 2^27 to 2^28 and 0.75-0.82 above.
F32_WGMMA_MIN_MACS = 2 ** 27


def f32_takes(k: int, n: int, lda: int, a_ptr: int, b_ptr: int, c_ptr: int,
              b_int8: bool) -> bool:
    """Whether csrc/f32_wgmma.cuh takes a float32-A launch: TMA needs
    16-byte aligned bases and row strides, so A, B and C at addresses that
    are multiples of 16, lda a multiple of 4 values and B's rows whole
    16-byte units (N a multiple of 4 float32 or 16 int8 values); N at least
    the 64-wide tile."""
    return not (k < 1 or lda % 4 or a_ptr % 16 or b_ptr % 16 or c_ptr % 16 or n < 64
                or n % (16 if b_int8 else 4))


def f32_route(m: int, k: int, n: int, lda: int, a_ptr: int, b_ptr: int, c_ptr: int,
              b_int8: bool, sms: int = SMS) -> Optional[F32WgmmaPlan]:
    """The loop of a float32-A fused_gemm launch (#1, #1w): the plan of the
    wgmma loop (csrc/f32_wgmma.cuh), or None for the mma.sync loop
    (csrc/f32_mma.cuh): the wgmma loop where it takes the operands
    (``f32_takes``) and the launch's M·K·N multiply-adds are at least
    F32_WGMMA_MIN_MACS.  A pure function of the shape and the operands'
    addresses, never of whether a launch succeeded."""
    if m * k * n < F32_WGMMA_MIN_MACS or not f32_takes(k, n, lda, a_ptr, b_ptr, c_ptr, b_int8):
        return None
    return f32_plan(m, k, n, b_int8, sms)


def split_ranges(k: int, kchunk: int):
    """The [start, stop) k ranges of the splits ``split_k`` chose."""
    return [(s, min(k, s + kchunk)) for s in range(0, max(k, 1), kchunk)]


# (A dtype, B dtype, C dtype) → C entry point of csrc/fused_gemm.cu,
# launch counter
_ENTRIES = {
    (torch.float32, torch.float32, torch.float32): ("fused_gemm_f32", "launches"),
    (torch.float32, torch.int8, torch.float32): ("fused_gemm_f32_i8w", "launches_i8w"),
    (torch.int8, torch.int8, torch.float32): ("fused_gemm_i8i8", "launches_i8i8"),
    (torch.int8, torch.int8, torch.bfloat16): ("fused_gemm_i8i8", "launches_i8i8_bf16"),
    (torch.bfloat16, torch.bfloat16, torch.bfloat16): ("fused_gemm_bf16", "launches_bf16"),
    (torch.bfloat16, torch.int8, torch.bfloat16): ("fused_gemm_bf16_i8w", "launches_bf16_i8w"),
}
COUNTERS = ("launches", "launches_i8w", "launches_i8i8", "launches_i8i8_bf16",
            "launches_bf16", "launches_bf16_i8w")


@functools.cache
def _kernel_fn(entry: str):
    """The C entry point, built and loaded on first call.  The int8 × int8
    entries take ``out_bf16`` after lda; ``*_splitk`` entries take
    (kchunk, workspace) before the stream, the bf16 ``*_wgmma`` entries
    (bn, stages, stream, grid), the int8 one (bn, sl, stages, splits, grid,
    workspace), the float32-A ones (stages, splits, band, grid, workspace)."""
    from pyopenvino_tpu_torch.kernels.build import load_library

    fn = getattr(load_library("fused_gemm.cu"), entry)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    i8 = entry.startswith("fused_gemm_i8i8")
    bf16 = entry.startswith("fused_gemm_bf16")
    split = ([i, p] if entry.endswith("_splitk") else
             ([i] * 4 if bf16 else [i] * 5 + [p] if i8 else [i] * 4 + [p])
             if entry.endswith("_wgmma") else [])
    out = [i] if i8 else []
    fn.argtypes = [p, p, p, p, p, i, i, i, i, *out, i, f, f, *split, p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_vector(v, n, what, device):
    if v is None:
        return
    if (v.device != device or v.dtype != torch.float32 or v.dim() != 1
            or v.shape[0] != n or not v.is_contiguous()):
        raise ValueError(
            f"fused_gemm: {what} must be a contiguous float32 or bfloat16 ({n},) "
            f"tensor on {device}, got {v.dtype}{tuple(v.shape)} on {v.device}")


def fused_gemm(a, b, scale=None, bias=None, act: Optional[tuple] = None, out_dtype=None,
               bf16_loop: Optional[str] = None, i8_loop: Optional[str] = None,
               f32_loop: Optional[str] = None):
    """act((a @ b) * scale + bias).

    a:     (M, K) float32, bfloat16 or int8, unit column stride; rows may be
           strided (lda >= K)
    b:     (K, N): with a float ``a`` contiguous, in ``a``'s dtype or int8
           (weight-only INT8); with an int8 ``a`` (INT8-FULL) K-major int8,
           the ``.t()`` view of an (N, K) contiguous int8 matrix.  An int8 b
           needs ``scale``, which dequantizes the product per column
    scale: optional (N,) per-output-column scale, float32 or bfloat16
    bias:  optional (N,) bias, float32 or bfloat16
    act:   None | ("relu", 0, 0) | ("clamp", lo, hi)
    out_dtype: the result's dtype: ``a``'s for a float ``a`` (the default);
           float32 (the default) or bfloat16 for an int8 ``a``
    bf16_loop: for a bfloat16 ``a`` on a card, ``"wgmma"`` or ``"mma"``
           forces that loop (measurements and tests; a launch the wgmma
           loop does not take raises); None takes ``bf16_route``'s
    i8_loop: the same for an int8 ``a``: ``"wgmma"`` (a launch that
           ``i8_takes`` refuses raises) or ``"mma"``; None takes
           ``i8_route``'s.  Checked on every device; a CPU tensor takes the
           plain version whatever it says
    f32_loop: the same for a float32 ``a`` (a float32 or int8 ``b``):
           ``"wgmma"`` (a launch that ``f32_takes`` refuses raises) or
           ``"mma"``; None takes ``f32_route``'s.  Checked on every device

    Returns a new contiguous (M, N) tensor: the float32 epilogue rounded
    once to ``out_dtype``.  On a CUDA tensor each call launches
    csrc/fused_gemm.cu (a split-K call adds its reduction launch) and adds
    one to the counter of its variant: ``fused_gemm.launches`` (float32 A
    and B), ``launches_i8w`` (float32 A, int8 B), ``launches_i8i8`` (int8 A
    and B, float32 out), ``launches_i8i8_bf16`` (the same, bfloat16 out),
    ``launches_bf16`` (bfloat16 A and B) or ``launches_bf16_i8w``
    (bfloat16 A, int8 B); int8 × int8 on either loop, the same bits; a
    float32 A on either loop within the same gates, each loop giving the
    same bits on every call.
    """
    out_dtype = out_dtype or (torch.float32 if a.dtype == torch.int8 else a.dtype)
    if i8_loop not in (None, "wgmma", "mma"):
        raise ValueError(f"fused_gemm: i8_loop {i8_loop!r}")
    if i8_loop is not None and a.dtype != torch.int8:
        raise ValueError("fused_gemm: i8_loop needs an int8 a")
    if f32_loop not in (None, "wgmma", "mma"):
        raise ValueError(f"fused_gemm: f32_loop {f32_loop!r}")
    if f32_loop is not None and a.dtype != torch.float32:
        raise ValueError("fused_gemm: f32_loop needs a float32 a")
    if b.dtype == torch.int8 and scale is None:
        raise ValueError("fused_gemm: an int8 b needs its (N,) dequant scale")
    if a.dtype == torch.int8 and b.dtype != torch.int8:
        raise ValueError(f"fused_gemm: an int8 a needs an int8 b, got {b.dtype}")
    if a.dtype == torch.int8 and b.dim() == 2 and not b.t().is_contiguous():
        raise ValueError(
            "fused_gemm: an int8 a needs a K-major int8 b, the (K, N) .t() view of "
            f"an (N, K) contiguous matrix, got strides {b.stride()}")
    if a.dtype != torch.int8 and out_dtype != a.dtype:
        raise ValueError(f"fused_gemm: a {a.dtype} a writes {a.dtype}, not {out_dtype}")
    if a.device.type == "cpu":
        return fused_gemm_plain(a, b, scale, bias, act, out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"fused_gemm: unsupported device {a.device}")
    if act is not None and act[0] not in _ACT_CODES:
        raise ValueError(f"unknown activation {act[0]!r}")
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"fused_gemm: shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if (a.dtype, b.dtype, out_dtype) not in _ENTRIES:
        raise ValueError(
            f"fused_gemm: the CUDA kernel takes float32 or bfloat16 @ itself or "
            f"int8, or int8 @ int8 (float32 or bfloat16 out), got {a.dtype} @ "
            f"{b.dtype} -> {out_dtype}")
    if b.device != a.device:
        raise ValueError(f"fused_gemm: b on {b.device}, a on {a.device}")
    # The stride of a size-1 dim is never stepped, and PyTorch leaves it
    # arbitrary (a transposed (K, 1) view is (1, K) with strides (1, 1)).
    lda = a.stride(0) if m > 1 else k
    if (k > 1 and a.stride(1) != 1) or lda < k:
        raise ValueError(
            f"fused_gemm: a needs unit column stride and row stride >= K, got "
            f"strides {a.stride()}")
    if a.dtype != torch.int8 and not b.is_contiguous():
        raise ValueError("fused_gemm: b must be contiguous (K, N)")
    if m > _INT_MAX or n > _INT_MAX or k > _INT_MAX or lda > _INT_MAX:
        raise ValueError(f"fused_gemm: shape ({m}, {k}, {n}) out of range")
    # a bfloat16 scale or bias holds bfloat16-rounded values, exact in float32
    scale, bias = (v.float() if v is not None and v.dtype == torch.bfloat16 else v
                   for v in (scale, bias))
    _check_vector(scale, n, "scale", a.device)
    _check_vector(bias, n, "bias", a.device)

    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    kind, lo, hi = act if act is not None else (None, 0.0, 0.0)
    entry, counter = _ENTRIES[(a.dtype, b.dtype, out_dtype)]
    out_arg = [int(out_dtype == torch.bfloat16)] if a.dtype == torch.int8 else []
    split = []
    plan = None
    if a.dtype == torch.bfloat16:
        if bf16_loop not in (None, "wgmma", "mma"):
            raise ValueError(f"fused_gemm: bf16_loop {bf16_loop!r}")
        sms = _sm_count(a.device.index)
        plan = (bf16_route(m, k, n, lda, a.data_ptr(), b.data_ptr(), b.dtype == torch.int8, sms)
                if bf16_loop is None else None if bf16_loop == "mma" else
                wgmma_plan(m, k, n, b.dtype == torch.int8, sms))
        if bf16_loop == "wgmma" and plan is None:
            raise ValueError(f"fused_gemm: no band of B fits for ({m}, {k}, {n})")
    elif bf16_loop is not None:
        raise ValueError("fused_gemm: bf16_loop needs a bfloat16 a")
    iplan = None
    if a.dtype == torch.int8 and i8_loop != "mma":
        sms = _sm_count(a.device.index)
        ptrs = (a.data_ptr(), b.data_ptr(), out.data_ptr(), out_dtype == torch.bfloat16)
        if i8_loop == "wgmma":
            if not i8_takes(k, n, lda, *ptrs):
                raise ValueError(
                    f"fused_gemm: the wgmma loop does not take ({m}, {k}, {n}) lda={lda} "
                    f"with A, B, C at {ptrs[0] % 16}, {ptrs[1] % 16}, {ptrs[2] % 16} bytes "
                    f"past 16 and {out_dtype} out")
            iplan = i8_plan(m, k, n, out.element_size(), sms)
        else:
            iplan = i8_route(m, k, n, lda, *ptrs, sms)
    fplan = None
    if a.dtype == torch.float32 and f32_loop != "mma":
        sms = _sm_count(a.device.index)
        b_int8 = b.dtype == torch.int8
        ptrs = (a.data_ptr(), b.data_ptr(), out.data_ptr(), b_int8)
        if f32_loop == "wgmma":
            if not f32_takes(k, n, lda, *ptrs):
                raise ValueError(
                    f"fused_gemm: the wgmma loop does not take ({m}, {k}, {n}) lda={lda} "
                    f"with A, B, C at {ptrs[0] % 16}, {ptrs[1] % 16}, {ptrs[2] % 16} bytes "
                    f"past 16 and a {b.dtype} b")
            fplan = f32_plan(m, k, n, b_int8, sms)
            if fplan is None:
                raise ValueError(f"fused_gemm: no wgmma plan fits ({m}, {k}, {n})")
        else:
            fplan = f32_route(m, k, n, lda, *ptrs, sms)
    if plan is not None:
        entry, split = entry + "_wgmma", [plan.bn, plan.stages, int(plan.stream), plan.grid]
    elif iplan is not None:
        # freed on return while the kernels may still run (as below)
        ws = (torch.empty((iplan.splits, m, n), device=a.device, dtype=torch.int32)
              if iplan.splits > 1 else None)
        entry, split = entry + "_wgmma", [iplan.bn, iplan.sl, iplan.stages, iplan.splits,
                                          iplan.grid, ws.data_ptr() if ws is not None else None]
    elif fplan is not None:
        ws = (torch.empty((fplan.splits, m, n), device=a.device, dtype=torch.float32)
              if fplan.splits > 1 else None)
        entry, split = entry + "_wgmma", [fplan.stages, fplan.splits, int(fplan.band), fplan.grid,
                                          ws.data_ptr() if ws is not None else None]
    elif entry in PLANS:
        kchunk = split_k(m, k, n, PLANS[entry], _sm_count(a.device.index))
        if kchunk < k:
            # freed on return while the kernels may still run: the caching
            # allocator hands it out again only to work queued after them
            # on this stream
            ws = torch.empty((-(-k // kchunk), m, n), device=a.device,
                             dtype=torch.int32 if a.dtype == torch.int8 else torch.float32)
            entry, split = entry + "_splitk", [kchunk, ws.data_ptr()]
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _kernel_fn(entry)(
            a.data_ptr(), b.data_ptr(),
            scale.data_ptr() if scale is not None else None,
            bias.data_ptr() if bias is not None else None,
            out.data_ptr(), m, n, k, lda, *out_arg,
            _ACT_CODES[kind], float(lo), float(hi), *split, stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_gemm: CUDA launch failed, cudaError {err}")
    setattr(fused_gemm, counter, getattr(fused_gemm, counter) + 1)
    return out


for _counter in COUNTERS:
    setattr(fused_gemm, _counter, 0)
del _counter
