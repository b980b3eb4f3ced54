"""conv2d_direct: a stride-1 convolution with no patch matrix, as one
hand-written CUDA kernel in three variants.

Counterpart of ``pyopenvino_tpu/kernels/conv_direct.py::conv2d_direct`` (the
Pallas TPU kernel), its variants, chosen by the activations' dtype:

  * int8 codes (INT8-FULL): NHWC int8 activations, an int8 OIHW weight, an
    exact int32 sum over the kh·kw taps, then ``act(sum * scale + bias)``
    in float32, written in float32 or, under ``compute_dtype="bfloat16"``,
    rounded once to bfloat16 (the TPU kernel's ``out_dtype``; entry
    ``conv2d_direct_i8``, on the int8 tensor cores: the loop of
    ``csrc/i8_mma.cuh`` with an implicit-im2col loader, split K for small
    grids by ``kernels/gemm.py::split_k``; or, where ``direct_route`` sends
    a launch, entry ``conv2d_direct_i8_wgmma``: int8 ``wgmma`` on
    ``csrc/i8_wgmma.cuh``, the implicit im2col A brought by TMA in im2col
    mode, planned by ``direct_plan``);
  * float32 (kernel 3f): NHWC float32 activations, a float32 weight, or an
    int8 weight whose (Co,) scale multiplies the float32 sum, with float32
    accuracy on the TF32 tensor cores (entry ``conv2d_direct_f32``: the loop
    of ``csrc/f32_mma.cuh``, three TF32 passes of split terms against a
    float32 weight and two against an int8 one, with an implicit-im2col
    loader and split K for small grids);
  * bfloat16 (kernel 3f-bf16, ``compute_dtype="bfloat16"``): NHWC bfloat16
    activations, a bfloat16 weight or an int8 one (its codes exact in
    bfloat16) whose (Co,) scale multiplies the sum, one bf16 pass into a
    float32 sum (the TPU kernel's DEFAULT-precision dot), the epilogue in
    float32, rounded once to bfloat16 (entry ``conv2d_direct_bf16``: the
    loop of ``csrc/bf16_mma.cuh`` with an implicit-im2col loader, split K
    for small grids; or, where ``direct_bf16_route`` sends a launch, entry
    ``conv2d_direct_bf16_wgmma``: bf16 ``wgmma`` on ``csrc/i8_wgmma.cuh``'s
    loop, A by TMA in im2col mode, an int8 weight converted to bfloat16 in
    shared memory, planned by ``direct_bf16_plan``).
The JAX package routes no float conv through its kernel, so neither does
the port: the float32 and bfloat16 variants are library functions, held
against their plain versions on the card.

The kernels are ``csrc/conv_direct.cu``, implicit GEMMs that read the
padding as zeros, built by ``nvcc`` on first use (kernels/build.py) and
called through ``ctypes`` on PyTorch's current stream.  The int8 variant
takes its weight matrix K-major, as fused_gemm's int8 × int8 variant does:
the ``.t()`` view of ``conv_weight_matrix_nk(w)``, the (Co, kh·kw·Ci)
contiguous int8 matrix; the float variants' mma.sync loops the row-major
``conv_weight_matrix(w)`` in the weight's dtype, the bfloat16 variant's
wgmma loop the K-major one (either is accepted, and the other made where
the chosen loop needs it).

``conv2d_direct_plain`` is the same function in plain PyTorch.  The wrapper
takes it only for tensors that lie on the CPU; for a CUDA tensor it launches
the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from pyopenvino_tpu_torch.kernels.conv import conv_weight_matrix, conv_weight_matrix_nk
from pyopenvino_tpu_torch.kernels.gemm import (
    _ACT_CODES, _INT_MAX, I8W_BM, I8W_SLICES, PLANS, SMS, I8WgmmaPlan, _sm_count, conv2d_int32,
    epilogue, i8w_plan, split_k,
)

def out_dtype_of(x, out_dtype=None):
    """The output dtype the TPU kernel writes by default
    (conv_direct.py:95): float32 for int8 codes, else x's dtype."""
    return out_dtype or (torch.float32 if x.dtype == torch.int8 else x.dtype)


def conv2d_direct_plain(x, w, scale=None, bias=None, act: Optional[tuple] = None,
                        pads=((0, 0), (0, 0)), out_dtype=None):
    """The kernel's function in plain PyTorch, then the epilogue in the
    kernel's order, then one cast to ``out_dtype`` (default
    ``out_dtype_of(x)``).  int8 codes: the exact int32 sum
    (``conv2d_int32``).  float32 or bfloat16: ``F.conv2d`` on the widened
    activations and weight (exact: an int8 code or a bfloat16 value is
    exact in either), in float64 on the CPU and in float32 with TF32 off on
    the card."""
    out_dtype = out_dtype_of(x, out_dtype)
    scale = None if scale is None else scale.float()
    bias = None if bias is None else bias.float()
    if x.dtype == torch.int8:
        acc = conv2d_int32(x.permute(0, 3, 1, 2), w, pads=pads).float()
    else:
        (pt, pb), (pl, pr) = pads
        dt = torch.float64 if x.device.type == "cpu" else torch.float32
        xp = F.pad(x.permute(0, 3, 1, 2).to(dt), (pl, pr, pt, pb))
        cudnn = torch.backends.cudnn
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            acc = F.conv2d(xp, w.to(dt)).float()
    return epilogue(acc.permute(0, 2, 3, 1), scale, bias, act).contiguous().to(out_dtype)


# The largest pad and kernel extent csrc/i8_wgmma.cuh's im2col map's
# corners take (its plan and constants are kernels/gemm.py's i8w_plan and
# I8W_*, shared with fused_gemm's int8 × int8 launches)
DIRECT_MAX_EXTENT = 64
# The least work, M·K·Co multiply-adds, that direct_route sends to the
# wgmma loop; below it the mma.sync loop, whose split K fills the card at
# small M.  Not M alone: R's 56x56 conv at batch 1 and its 7x7 one at batch
# 64 both have M = 3136, and on an H100 (chip_smoke.py's crossover lines)
# the wgmma loop took 1.04-1.18x the mma.sync loop's time at the first
# (115 M multiply-adds) and 0.58x at the second (7.4 G); R's convs took
# 0.88-1.08x at batch 2 (231 M) and 0.73-0.98x at batch 4 (462 M)
DIRECT_WGMMA_MIN_MACS = 2 ** 28


def direct_slice(ci: int, x_bytes: int = 1) -> Optional[int]:
    """The bytes of one k step, one tap's channel slice: the largest of
    I8W_SLICES that holds a whole number of channels of ``x_bytes`` bytes
    dividing Ci (one 128-, 64- or 32-byte swizzled row a pixel; wgmma's k
    step is 32 bytes: 32 int8 or 16 bf16 values), or None (Ci not a
    multiple of 32 int8 or 16 bf16 values)."""
    return next((s for s in I8W_SLICES if ci * x_bytes % s == 0), None)


def direct_plan(m: int, k: int, ci: int, co: int, out_bytes: int = 4,
                sms: int = SMS) -> Optional[I8WgmmaPlan]:
    """The i8_wgmma.cuh launch of an int8 conv with ``m`` output pixels,
    K = ``k`` (kh·kw·Ci), ``co`` output channels and ``out_bytes`` bytes an
    output value (``gemm.i8w_plan`` in steps of ``direct_slice(ci)``), or
    None when Ci is not a multiple of 32 or Co is below the narrowest tile."""
    sl = direct_slice(ci)
    return None if sl is None else i8w_plan(m, k, co, sl, out_bytes, sms)


def direct_bf16_plan(m: int, k: int, ci: int, co: int,
                     sms: int = SMS) -> Optional[I8WgmmaPlan]:
    """The i8_wgmma.cuh launch of a bfloat16 conv (3f-bf16; a bfloat16
    output): ``gemm.i8w_plan`` over its 2·k bytes of k in steps of
    ``direct_slice(ci, 2)`` bytes.  A stage is 128 bytes of k whatever the
    operands' type (64 bf16 values, four k16 steps), and an int8 weight's
    codes are converted inside the bf16 weight's room, so both weight types
    share the int8 conv's tiles, ring and split rule."""
    sl = direct_slice(ci, 2)
    return None if sl is None else i8w_plan(m, 2 * k, co, sl, 2, sms)


def direct_takes(ci: int, co: int, kh: int, kw: int, pads, x_ptr: int, w_ptr: int,
                 out_dtype, x_bytes: int = 1) -> bool:
    """Whether csrc/i8_wgmma.cuh takes this conv on ``x_bytes``-byte
    activations (1: int8, 2: bfloat16): a channel slice of whole 32-byte
    wgmma k steps and 16-byte TMA rows (Ci a multiple of 32 int8 or 16 bf16
    values), x and the K-major weight matrix 16-byte aligned (TMA's bases),
    an output row of 16-byte pairs (Co a multiple of 4 for float32 out, 8
    for bfloat16), Co at least the tile's N, pads and kernel extents within
    the im2col map's corners."""
    (pt, pb), (pl, pr) = pads
    bn = 64 if co <= 64 else 128
    return not (direct_slice(ci, x_bytes) is None or x_ptr % 16 or w_ptr % 16
                or co % (8 if out_dtype == torch.bfloat16 else 4) or co < bn
                or max(pt, pb, pl, pr, kh, kw) > DIRECT_MAX_EXTENT)


def direct_route(n: int, h: int, w: int, ci: int, co: int, kh: int, kw: int, pads,
                 x_ptr: int, w_ptr: int, out_dtype, sms: int = SMS) -> Optional[I8WgmmaPlan]:
    """The loop of an int8 conv2d_direct launch: the plan of the wgmma loop
    (csrc/i8_wgmma.cuh), or None for the mma.sync loop (csrc/i8_mma.cuh):
    the wgmma loop where it takes the conv (``direct_takes``) and its
    M·K·Co multiply-adds are at least DIRECT_WGMMA_MIN_MACS.  A pure
    function of the shape and the operands' addresses, never of whether a
    launch succeeded."""
    (pt, pb), (pl, pr) = pads
    m = n * (h + pt + pb - kh + 1) * (w + pl + pr - kw + 1)
    if (m * kh * kw * ci * co < DIRECT_WGMMA_MIN_MACS
            or not direct_takes(ci, co, kh, kw, pads, x_ptr, w_ptr, out_dtype)):
        return None
    return direct_plan(m, kh * kw * ci, ci, co, torch.finfo(out_dtype).bits // 8, sms)


# The least work, M·K·Co multiply-adds, and the fewest output pixels (one
# 128-row tile) that direct_bf16_route sends to the wgmma loop (bfloat16
# x); below them bf16_mma.cuh's mma.sync loop, whose 64-row tiles and split
# K fill the card at small M.  From chip_smoke.py's crossover lines (R's
# four convs at B = 1 ... 16 on both loops, both weights) on an H100:
# wgmma / mma.sync time 0.83-0.97 at B = 1 (2^26.8 multiply-adds) but
# 1.10-1.11 for the 7x7 conv there (M = 49, a third of a tile), 0.71-1.03 at
# B = 2, 0.75-1.04 at B = 4, 0.47-0.77 from B = 8 on; summed over the four
# convs 0.93 (bf16 weight) and 0.99 (int8) at B = 1, 0.86 and 0.93 at B = 2
DIRECT_BF16_WGMMA_MIN_MACS = 2 ** 26
DIRECT_BF16_WGMMA_MIN_M = I8W_BM


def direct_bf16_route(n: int, h: int, w: int, ci: int, co: int, kh: int, kw: int, pads,
                      x_ptr: int, w_ptr: int, sms: int = SMS) -> Optional[I8WgmmaPlan]:
    """The loop of a bfloat16-x conv2d_direct launch (3f-bf16, either
    weight type): the plan of the wgmma loop (csrc/i8_wgmma.cuh on bf16
    operands), or None for the mma.sync loop (csrc/bf16_mma.cuh): the wgmma
    loop where it takes the conv (``direct_takes`` with 2-byte x, the
    K-major weight matrix at ``w_ptr``), its M·K·Co multiply-adds are at
    least DIRECT_BF16_WGMMA_MIN_MACS and its M at least
    DIRECT_BF16_WGMMA_MIN_M.  A pure function of the shape and the
    operands' addresses, never of whether a launch succeeded."""
    (pt, pb), (pl, pr) = pads
    m = n * (h + pt + pb - kh + 1) * (w + pl + pr - kw + 1)
    if (m * kh * kw * ci * co < DIRECT_BF16_WGMMA_MIN_MACS or m < DIRECT_BF16_WGMMA_MIN_M
            or not direct_takes(ci, co, kh, kw, pads, x_ptr, w_ptr, torch.bfloat16, 2)):
        return None
    return direct_bf16_plan(m, kh * kw * ci, ci, co, sms)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# entry point of csrc/conv_direct.cu → its argument types: the pointers (and
# the float32 entry's weight type), the shape and activation, k per split and
# the workspace, the stream
_ENTRIES = {
    "conv2d_direct_i8": [_P] * 5 + [_I] * 13 + [_F, _F, _I, _P, _P],
    "conv2d_direct_i8_wgmma": [_P] * 5 + [_I] * 13 + [_F, _F] + [_I] * 5 + [_P, _P],
    "conv2d_direct_f32": [_P, _P, _I] + [_P] * 3 + [_I] * 12 + [_F, _F, _I, _P, _P],
    "conv2d_direct_bf16": [_P, _P, _I] + [_P] * 3 + [_I] * 12 + [_F, _F, _I, _P, _P],
    "conv2d_direct_bf16_wgmma": [_P, _P, _I] + [_P] * 3 + [_I] * 12 + [_F, _F] + [_I] * 5
    + [_P, _P],
}


@functools.cache
def _kernel_fn(entry: str):
    """The C entry point, built and loaded on first call."""
    from pyopenvino_tpu_torch.kernels.build import load_library

    fn = getattr(load_library("conv_direct.cu"), entry)
    fn.argtypes = _ENTRIES[entry]
    fn.restype = ctypes.c_int
    return fn


def _check(t, dtype, shape, what, device):
    if (t.device != device or t.dtype != dtype or tuple(t.shape) != shape
            or not t.is_contiguous()):
        raise ValueError(
            f"conv2d_direct: {what} must be a contiguous {dtype}{shape} tensor "
            f"on {device}, got {t.dtype}{tuple(t.shape)} on {t.device}")


def conv2d_direct(x, w, scale=None, bias=None, act: Optional[tuple] = None,
                  pads=((0, 0), (0, 0)), wmat=None, out_dtype=None,
                  conv_loop: Optional[str] = None):
    """Stride-1, dilation-1 convolution:
    act((Σ_{i,j,c} xpad[n, y+i, x+j, c] · w[co, c, i, j]) · scale + bias).

    x:     (N, H, W, Ci) contiguous (NHWC): int8 codes, float32 or bfloat16
    w:     (Co, Ci, kh, kw) (OIHW): int8 with int8 x; float32 or int8 with
           float32 x; bfloat16 or int8 with bfloat16 x (an int8 w is cast
           to x's type, exactly, as in the TPU kernel)
    scale: (Co,) float32 or bfloat16 (widened); required with an int8 w (it
           dequantizes the sum), optional with a float w
    bias:  optional (Co,) float32 or bfloat16 (widened)
    act:   None | ("relu", 0, 0) | ("clamp", lo, hi)
    pads:  ((top, bottom), (left, right)), read as zeros
    wmat:  the (kh·kw·Ci, Co) GEMM operand in w's dtype, when the caller
           caches it: with int8 x K-major, ``conv_weight_matrix_nk(w).t()``
           (a row-major int8 wmat with int8 x raises on every device); with
           float32 x ``conv_weight_matrix(w)``, contiguous; with bfloat16 x
           either (the wgmma loop reads the K-major matrix, the mma.sync
           loop the row-major one; the wrapper copies a wmat into the other
           layout where the chosen loop needs it)

    out_dtype: None (``out_dtype_of(x)``: float32 for int8 or float32 x,
           bfloat16 for bfloat16 x); float32 or bfloat16 for int8 x (the
           epilogue rounded once); float32 for float32 x; bfloat16 for
           bfloat16 x
    conv_loop: for int8 or bfloat16 x on a card, ``"wgmma"`` or ``"mma"``
           forces that loop (measurements and tests; a conv the wgmma loop
           does not take, ``direct_takes``, raises); None takes
           ``direct_route``'s (int8 x) or ``direct_bf16_route``'s
           (bfloat16 x)

    Returns a new contiguous (N, OH, OW, Co) tensor in ``out_dtype``.  On a
    CUDA tensor each call launches csrc/conv_direct.cu (a split-K call adds
    its reduction launch; int8 x on either loop, the same bits; bfloat16 x
    on the wgmma loop another summation order, so other bits within the
    same bound; a weight matrix made for the call adds its copy) and adds
    one to ``conv2d_direct.launches`` (int8
    x, float32 out), ``launches_bf16`` (int8 x, bfloat16 out),
    ``launches_f32`` (float32 x) or ``launches_float_bf16`` (bfloat16 x).
    The float32 result is within 1e-4 of max |plain| (TF32 terms), the
    bfloat16 one within one bfloat16 step of it (or of the float32 sums'
    error where a sum cancels), each the same bits every call.
    """
    if not ((x.dtype == torch.int8 and w.dtype == torch.int8)
            or (x.dtype == torch.float32 and w.dtype in (torch.float32, torch.int8))
            or (x.dtype == torch.bfloat16 and w.dtype in (torch.bfloat16, torch.int8))):
        raise ValueError(
            f"conv2d_direct: takes int8 x with an int8 w, float32 x with a float32 or "
            f"int8 w, or bfloat16 x with a bfloat16 or int8 w, got {x.dtype} and {w.dtype}")
    if scale is None and w.dtype == torch.int8:
        raise ValueError("conv2d_direct: an int8 w needs its (Co,) dequant scale")
    int8 = x.dtype == torch.int8
    out_dtype = out_dtype_of(x, out_dtype)
    if out_dtype not in ((torch.float32, torch.bfloat16) if int8 else (x.dtype,)):
        raise ValueError(f"conv2d_direct: {x.dtype} x cannot write {out_dtype}")
    if int8 and wmat is not None and wmat.dim() == 2 and not wmat.t().is_contiguous():
        raise ValueError(
            "conv2d_direct: int8 x needs a K-major wmat, the (K, Co) .t() view of "
            f"a (Co, K) contiguous int8 matrix, got strides {wmat.stride()}")
    if conv_loop not in (None, "wgmma", "mma"):
        raise ValueError(f"conv2d_direct: conv_loop {conv_loop!r}")
    if conv_loop is not None and x.dtype == torch.float32:
        raise ValueError("conv2d_direct: conv_loop needs int8 x or bfloat16 x")
    if x.device.type == "cpu":
        return conv2d_direct_plain(x, w, scale, bias, act, pads, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"conv2d_direct: unsupported device {x.device}")
    if act is not None and act[0] not in _ACT_CODES:
        raise ValueError(f"unknown activation {act[0]!r}")
    if x.dim() != 4 or w.dim() != 4 or x.shape[3] != w.shape[1]:
        raise ValueError(
            f"conv2d_direct: x {tuple(x.shape)} (NHWC) and w {tuple(w.shape)} "
            f"(OIHW) do not match")
    n, h, wd, ci = x.shape
    co, _, kh, kw = w.shape
    (pt, pb), (pl, pr) = pads
    oh, ow = h + pt + pb - kh + 1, wd + pl + pr - kw + 1
    if min(pt, pb, pl, pr) < 0 or oh < 1 or ow < 1:
        raise ValueError(f"conv2d_direct: pads {pads} give an empty output")
    if n * oh * ow > _INT_MAX or x.numel() > _INT_MAX:
        raise ValueError(f"conv2d_direct: shape {tuple(x.shape)} out of range")
    _check(x, x.dtype, (n, h, wd, ci), "x", x.device)
    k = kh * kw * ci
    bf16 = x.dtype == torch.bfloat16
    if int8:
        if wmat is None:
            wmat = conv_weight_matrix_nk(w).t()
        _check(wmat.t(), w.dtype, (co, k), "wmat.t()", x.device)
    elif bf16 and wmat is not None:
        if (wmat.device != x.device or wmat.dtype != w.dtype or tuple(wmat.shape) != (k, co)
                or not (wmat.is_contiguous() or wmat.t().is_contiguous())):
            raise ValueError(
                f"conv2d_direct: wmat must be a {w.dtype}({k}, {co}) tensor on {x.device}, "
                f"row-major or the .t() view of a (Co, K) contiguous one, got "
                f"{wmat.dtype}{tuple(wmat.shape)} strides {wmat.stride()} on {wmat.device}")
    else:
        if wmat is None:
            wmat = conv_weight_matrix(w)
        _check(wmat, w.dtype, (k, co), "wmat", x.device)
    # a bfloat16 scale or bias holds bfloat16-rounded values, exact in float32
    scale, bias = (v.float() if v is not None and v.dtype == torch.bfloat16 else v
                   for v in (scale, bias))
    if scale is not None:
        _check(scale, torch.float32, (co,), "scale", x.device)
    if bias is not None:
        _check(bias, torch.float32, (co,), "bias", x.device)

    m = n * oh * ow
    sms = _sm_count(x.device.index)
    # the wgmma loops read the K-major weight matrix: for bfloat16 x the
    # given one, or a fresh (so 16-byte aligned) copy made below (w_ptr 0)
    k_major = wmat is not None and not wmat.is_contiguous()
    w_ptr = wmat.data_ptr() if int8 or k_major else 0
    x_bytes = x.element_size()
    wplan = None
    if conv_loop == "wgmma":
        if not direct_takes(ci, co, kh, kw, pads, x.data_ptr(), w_ptr, out_dtype, x_bytes):
            raise ValueError(
                f"conv2d_direct: the wgmma loop does not take x {tuple(x.shape)}, w "
                f"{tuple(w.shape)}, pads {pads}, {out_dtype} out")
        wplan = (direct_bf16_plan(m, k, ci, co, sms) if bf16
                 else direct_plan(m, k, ci, co, torch.finfo(out_dtype).bits // 8, sms))
    elif conv_loop is None and int8:
        wplan = direct_route(n, h, wd, ci, co, kh, kw, pads, x.data_ptr(), w_ptr, out_dtype, sms)
    elif conv_loop is None and bf16:
        wplan = direct_bf16_route(n, h, wd, ci, co, kh, kw, pads, x.data_ptr(), w_ptr, sms)
    if bf16:  # the layout the chosen loop reads
        if wplan is not None:
            wmat = (wmat if k_major else
                    (w.permute(0, 2, 3, 1) if wmat is None else wmat.t()).clone(
                        memory_format=torch.contiguous_format).view(co, k).t())
        else:
            wmat = (conv_weight_matrix(w) if wmat is None else
                    wmat.contiguous() if k_major else wmat)

    out = torch.empty((n, oh, ow, co), dtype=out_dtype, device=x.device)
    kind, lo, hi = act if act is not None else (None, 0.0, 0.0)
    ptrs = [x.data_ptr(), wmat.data_ptr()]
    if int8:
        entry, plan = "conv2d_direct_i8", "conv2d_direct"
        counter = "launches_bf16" if out_dtype == torch.bfloat16 else "launches"
    else:
        entry, counter, plan = (
            ("conv2d_direct_bf16", "launches_float_bf16", "conv2d_direct_bf16") if bf16 else
            ("conv2d_direct_f32", "launches_f32", "conv2d_direct_f32"))
        ptrs.append(int(w.dtype == torch.int8))
    # freed on return while the kernels may still run: the caching
    # allocator hands it out again only to work queued after them on this
    # stream
    if wplan is not None:
        entry = "conv2d_direct_bf16_wgmma" if bf16 else "conv2d_direct_i8_wgmma"
        ws = (torch.empty((wplan.splits, m, co), device=x.device,
                          dtype=torch.float32 if bf16 else torch.int32)
              if wplan.splits > 1 else None)
        split = [wplan.bn, wplan.sl, wplan.stages, wplan.splits, wplan.grid,
                 ws.data_ptr() if ws is not None else None]
    else:
        kchunk = split_k(m, k, co, PLANS[plan], sms)
        ws = (torch.empty((-(-k // kchunk), m, co), device=x.device,
                          dtype=torch.int32 if int8 else torch.float32)
              if kchunk < k else None)
        split = [kchunk, ws.data_ptr() if ws is not None else None]
    ptrs += [scale.data_ptr() if scale is not None else None,
             bias.data_ptr() if bias is not None else None, out.data_ptr()]
    if int8:
        ptrs.append(int(out_dtype == torch.bfloat16))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _kernel_fn(entry)(*ptrs, n, h, wd, ci, co, kh, kw, oh, ow, pt, pl,
                                _ACT_CODES[kind], float(lo), float(hi), *split, stream)
    if err != 0:
        raise RuntimeError(f"conv2d_direct: CUDA launch failed, cudaError {err}")
    setattr(conv2d_direct, counter, getattr(conv2d_direct, counter) + 1)
    return out


conv2d_direct.launches = 0
conv2d_direct.launches_bf16 = 0
conv2d_direct.launches_f32 = 0
conv2d_direct.launches_float_bf16 = 0
