"""dw_pw_fused: a 3×3 stride-1 depthwise conv and the 1×1 pointwise conv after
it, on int8 codes, as one hand-written CUDA kernel.

Counterpart of ``tools/dw_pw_kernel.py::dw_pw_fused`` (a Pallas TPU kernel
that the JAX package keeps off its serving paths and times with
``tools/microbench_dw_pw.py``).  The port does the same: nothing routes a
network through it, and ``python -m pyopenvino_tpu_torch.tools.
microbench_dw_pw`` times it against the port's unfused pair at
SSD-MobileNet's stride-1 separable pairs.

The kernel is ``csrc/dw_pw.cu`` (entry ``dw_pw_fused_i8``), built by
``nvcc`` on first use (kernels/build.py) and called through ``ctypes`` on
PyTorch's current stream: the depthwise stage on the CUDA cores into an int8
tile in shared memory, then the pointwise product of that tile on the int8
tensor cores (``mma.sync``, ``csrc/i8_mma.cuh``'s warp step), whose
epilogue writes int8 codes, float32 or bfloat16 (the TPU kernel's
``out_dtype``, the float32 result rounded once).  Those take
the pointwise weight K-major: the (Co, C) contiguous matrix, which the
wrapper makes from ``w_pw`` on each call unless the caller passes it cached
(``wmat``).  ``dw_pw_fused_plain`` is the same function in
plain PyTorch: the exact int32 sums of ``conv2d_int32`` (grouped) and
``matmul_int32``, each followed by the unfused epilogue and the port's
requantize.  The wrapper takes it only for tensors that lie on the CPU; for
a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from pyopenvino_tpu_torch.kernels.gemm import (
    _ACT_CODES, _INT_MAX, _sm_count, conv2d_int32, epilogue, matmul_int32,
)
from pyopenvino_tpu_torch.ops.spec import TValue


def _out_type(s_out, out_dtype):
    """The kernel's output code for csrc/dw_pw.cu: 0 float32, 1 int8 codes
    (``s_out`` given), 2 bfloat16.  A bfloat16 ``out_dtype`` with ``s_out``
    raises: int8 codes are the output then."""
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dw_pw_fused: out_dtype must be float32 or bfloat16, got {out_dtype}")
    if s_out is not None:
        if out_dtype != torch.float32:
            raise ValueError("dw_pw_fused: s_out gives int8 codes; it takes no "
                             f"out_dtype {out_dtype}")
        return 1
    return 2 if out_dtype == torch.bfloat16 else 0


def dw_pw_fused_plain(x, w_dw, dw_scale, dw_bias, w_pw, pw_scale, pw_bias, *,
                      dw_act: Optional[tuple] = ("clamp", 0.0, 6.0),
                      pw_act: Optional[tuple] = None, s_mid: float,
                      s_out: Optional[float] = None, out_dtype=torch.float32):
    """The kernel's function in plain PyTorch (arguments as ``dw_pw_fused``)."""
    _out_type(s_out, out_dtype)
    n, h, w, c = x.shape
    acc = conv2d_int32(x.permute(0, 3, 1, 2), w_dw.t().reshape(c, 1, 3, 3),
                       pads=((1, 1), (1, 1)), groups=c)
    y1 = epilogue(acc.permute(0, 2, 3, 1).float(), dw_scale, dw_bias, dw_act)
    q = TValue.quantize(y1, s_mid)
    o = epilogue(matmul_int32(q.reshape(-1, c), w_pw).float(), pw_scale, pw_bias, pw_act)
    o = TValue.quantize(o, s_out) if s_out is not None else o.to(out_dtype)
    return o.reshape(n, h, w, w_pw.shape[1])


# output pixels a block: csrc/dw_pw.cu's kernel takes 64 or 128, with Co
# tiles of 128 and 64 columns
TILE_ROWS = (64, 128)
_TILE_COLS = {64: 128, 128: 64}
# an H100's shared memory per SM, and what the 128-row kernel takes besides
# its mid tile: the static ring (3 x 64 rows x 80 bytes) and the 1 KB the
# card reserves a block
_SMEM_PER_SM = 228 * 1024
_SMEM_128_BESIDES_MID = 3 * 64 * 80 + 1024


@functools.cache
def _kernel_fn():
    """The C entry point, built and loaded on first call."""
    from pyopenvino_tpu_torch.kernels.build import load_library

    fn = load_library("dw_pw.cu").dw_pw_fused_i8
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p] * 8 + [i] * 6 + [f, f, i, f, f, f, i, f, i, i, p, p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _max_channels(device_index: int, tile_rows: int = 64) -> int:
    """The largest C the kernel takes on the card: its mid tile of
    ``tile_rows`` C-wide rows lies in shared memory (csrc/dw_pw.cu reports
    the limit; 64 rows take the most)."""
    from pyopenvino_tpu_torch.kernels.build import load_library

    fn = load_library("dw_pw.cu").dw_pw_max_channels
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(device_index, tile_rows)


def pick_tile_rows(m: int, c: int, device_index: int) -> int:
    """Output pixels a block for m pixels of c channels: 128 where that
    still gives every SM a block and two such blocks fit in an SM's shared
    memory (c <= 768), else 64.  Fewer, larger blocks share the per-block
    set-up (the ring's first stages, two barriers, the pointwise weight's
    reads) over more pixels; below one block an SM, or one block resident
    an SM, they leave the card idler."""
    mid = 128 * (-(-c // 64) * 64 + 16)
    if (-(-m // 128) >= _sm_count(device_index)
            and 2 * (mid + _SMEM_128_BESIDES_MID) <= _SMEM_PER_SM):
        return 128
    return 64


def co_split(m: int, co: int, tile_rows: int, device_index: int) -> int:
    """Blocks that share one tile of pixels, each taking its share of the
    Co tiles: as many as bring the grid to one block an SM, at most one per
    Co tile (at batch 1 a 10×10 image's 100 pixels make 2 blocks)."""
    blocks = -(-m // tile_rows)
    tiles = -(-co // _TILE_COLS[tile_rows])
    return max(1, min(tiles, _sm_count(device_index) // blocks))


def _act_args(act, what):
    if act is None:
        return 0, 0.0, 0.0
    kind, lo, hi = act
    if kind not in _ACT_CODES:
        raise ValueError(f"dw_pw_fused: unknown {what} activation {kind!r}")
    return _ACT_CODES[kind], float(lo), float(hi)


def _check(t, dtype, shape, what, device):
    if (t.device != device or t.dtype != dtype or tuple(t.shape) != shape
            or not t.is_contiguous()):
        raise ValueError(
            f"dw_pw_fused: {what} must be a contiguous {dtype}{shape} tensor on "
            f"{device}, got {t.dtype}{tuple(t.shape)} on {t.device}")


def dw_pw_fused(x, w_dw, dw_scale, dw_bias, w_pw, pw_scale, pw_bias, *,
                dw_act: Optional[tuple] = ("clamp", 0.0, 6.0),
                pw_act: Optional[tuple] = None, s_mid: float,
                s_out: Optional[float] = None, out_dtype=torch.float32, wmat=None,
                tile_rows: Optional[int] = None, clocks=None):
    """Fused stride-1 3×3 depthwise + 1×1 pointwise conv of int8 codes.

    x:        (N, H, W, C) int8 activation codes, contiguous (NHWC)
    w_dw:     (9, C) int8 depthwise taps, row t = (dy = t // 3, dx = t % 3)
    dw_scale: (C,) float32 = s_x · s_wdw[c] (dequantizes the depthwise sum)
    dw_bias:  (C,) float32
    w_pw:     (C, Co) int8 pointwise weights
    pw_scale: (Co,) float32 = s_mid · s_wpw[o]
    pw_bias:  (Co,) float32
    dw_act, pw_act: None | ("relu", 0, 0) | ("clamp", lo, hi)
    s_mid:    scale of the intermediate's int8 codes
    s_out:    output scale → (N, H, W, Co) int8 codes; None → ``out_dtype``
    out_dtype: float32 or bfloat16 (the float32 epilogue rounded once, as
              the TPU kernel's ``o.astype(out_dtype)``); with ``s_out`` only
              float32, the default (another raises)
    wmat:     ``w_pw`` K-major, when the caller caches it: the (C, Co)
              ``.t()`` view of the (Co, C) contiguous int8 matrix (another
              layout raises on every device)
    tile_rows: output pixels a block of the kernel, 64 or 128; None picks
              by the grid (``pick_tile_rows``)
    clocks:   None, or a (2,) int64 tensor on the card to which every block
              adds its depthwise and pointwise stages' clock64() counts

    Both requantizations are ``clip(round(v · (1.0 / s)), ±127)`` with the
    Python float 1.0 / s, as the port's INT8-FULL dataflow and the TPU
    kernel do.  On a CUDA tensor each call is one launch of csrc/dw_pw.cu and
    adds one to ``dw_pw_fused.launches`` (int8 or float32 out) or
    ``dw_pw_fused.launches_bf16`` (bfloat16 out).
    """
    if x.dtype != torch.int8 or w_dw.dtype != torch.int8 or w_pw.dtype != torch.int8:
        raise ValueError(
            f"dw_pw_fused: takes int8 x, w_dw and w_pw, got {x.dtype}, {w_dw.dtype} "
            f"and {w_pw.dtype}")
    if x.dim() != 4 or w_dw.shape != (9, x.shape[3]) or w_pw.dim() != 2 \
            or w_pw.shape[0] != x.shape[3]:
        raise ValueError(
            f"dw_pw_fused: x {tuple(x.shape)} (NHWC), w_dw {tuple(w_dw.shape)} and "
            f"w_pw {tuple(w_pw.shape)} do not match")
    if wmat is not None and (wmat.shape != w_pw.shape or not wmat.t().is_contiguous()):
        raise ValueError(
            f"dw_pw_fused: wmat must be the K-major (C, Co) .t() view of a (Co, C) "
            f"contiguous matrix, got {tuple(wmat.shape)} with strides {wmat.stride()}")
    out_type = _out_type(s_out, out_dtype)
    if x.device.type == "cpu":
        return dw_pw_fused_plain(x, w_dw, dw_scale, dw_bias, w_pw, pw_scale, pw_bias,
                                 dw_act=dw_act, pw_act=pw_act, s_mid=s_mid, s_out=s_out,
                                 out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"dw_pw_fused: unsupported device {x.device}")
    n, h, w, c = x.shape
    co = w_pw.shape[1]
    if tile_rows is None:
        tile_rows = pick_tile_rows(n * h * w, c, x.device.index)
    if tile_rows not in TILE_ROWS:
        raise ValueError(f"dw_pw_fused: tile_rows must be one of {TILE_ROWS}, got {tile_rows}")
    if (c > _max_channels(x.device.index, tile_rows) or x.numel() > _INT_MAX
            or n * h * w * co > _INT_MAX):
        raise ValueError(f"dw_pw_fused: shape {tuple(x.shape)} -> {co} out of range")
    dev = x.device
    _check(x, torch.int8, (n, h, w, c), "x", dev)
    _check(w_dw, torch.int8, (9, c), "w_dw", dev)
    if wmat is None:
        wmat = w_pw.t().contiguous().t()
    _check(wmat.t(), torch.int8, (co, c), "wmat.t()", dev)
    if clocks is not None:
        _check(clocks, torch.int64, (2,), "clocks", dev)
    for t, size, what in ((dw_scale, c, "dw_scale"), (dw_bias, c, "dw_bias"),
                          (pw_scale, co, "pw_scale"), (pw_bias, co, "pw_bias")):
        _check(t, torch.float32, (size,), what, dev)
    dw = _act_args(dw_act, "depthwise")
    pw = _act_args(pw_act, "pointwise")

    out = torch.empty((n, h, w, co), dtype=torch.int8 if out_type == 1 else out_dtype,
                      device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel_fn()(
            x.data_ptr(), w_dw.data_ptr(), dw_scale.data_ptr(), dw_bias.data_ptr(),
            wmat.data_ptr(), pw_scale.data_ptr(), pw_bias.data_ptr(), out.data_ptr(),
            n, h, w, c, co, *dw, *pw, 1.0 / s_mid, out_type,
            1.0 / s_out if s_out is not None else 0.0, tile_rows,
            co_split(n * h * w, co, tile_rows, dev.index),
            clocks.data_ptr() if clocks is not None else None, stream)
    if err != 0:
        raise RuntimeError(f"dw_pw_fused: CUDA launch failed, cudaError {err}")
    if out_type == 2:
        dw_pw_fused.launches_bf16 += 1
    else:
        dw_pw_fused.launches += 1
    return out


dw_pw_fused.launches = 0
dw_pw_fused.launches_bf16 = 0
