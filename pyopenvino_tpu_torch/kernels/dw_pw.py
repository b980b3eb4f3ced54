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
PyTorch's current stream.  ``dw_pw_fused_plain`` is the same function in
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
    _ACT_CODES, _INT_MAX, conv2d_int32, epilogue, matmul_int32,
)
from pyopenvino_tpu_torch.ops.spec import TValue


def dw_pw_fused_plain(x, w_dw, dw_scale, dw_bias, w_pw, pw_scale, pw_bias, *,
                      dw_act: Optional[tuple] = ("clamp", 0.0, 6.0),
                      pw_act: Optional[tuple] = None, s_mid: float,
                      s_out: Optional[float] = None):
    """The kernel's function in plain PyTorch (arguments as ``dw_pw_fused``)."""
    n, h, w, c = x.shape
    acc = conv2d_int32(x.permute(0, 3, 1, 2), w_dw.t().reshape(c, 1, 3, 3),
                       pads=((1, 1), (1, 1)), groups=c)
    y1 = epilogue(acc.permute(0, 2, 3, 1).float(), dw_scale, dw_bias, dw_act)
    q = TValue.quantize(y1, s_mid)
    o = epilogue(matmul_int32(q.reshape(-1, c), w_pw).float(), pw_scale, pw_bias, pw_act)
    if s_out is not None:
        o = TValue.quantize(o, s_out)
    return o.reshape(n, h, w, w_pw.shape[1])


@functools.cache
def _kernel_fn():
    """The C entry point, built and loaded on first call."""
    from pyopenvino_tpu_torch.kernels.build import load_library

    fn = load_library("dw_pw.cu").dw_pw_fused_i8
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p] * 8 + [i] * 6 + [f, f, i, f, f, f, i, f, p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _max_channels(device_index: int) -> int:
    """The largest C the kernel takes on the card: its mid tile of C-wide
    rows lies in shared memory (csrc/dw_pw.cu reports the limit)."""
    from pyopenvino_tpu_torch.kernels.build import load_library

    return load_library("dw_pw.cu").dw_pw_max_channels(device_index)


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
                s_out: Optional[float] = None):
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
    s_out:    output scale → (N, H, W, Co) int8 codes; None → float32

    Both requantizations are ``clip(round(v · (1.0 / s)), ±127)`` with the
    Python float 1.0 / s, as the port's INT8-FULL dataflow and the TPU
    kernel do.  On a CUDA tensor each call is one launch of csrc/dw_pw.cu and
    adds one to ``dw_pw_fused.launches``.
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
    if x.device.type == "cpu":
        return dw_pw_fused_plain(x, w_dw, dw_scale, dw_bias, w_pw, pw_scale, pw_bias,
                                 dw_act=dw_act, pw_act=pw_act, s_mid=s_mid, s_out=s_out)
    if x.device.type != "cuda":
        raise ValueError(f"dw_pw_fused: unsupported device {x.device}")
    n, h, w, c = x.shape
    co = w_pw.shape[1]
    if c > _max_channels(x.device.index) or x.numel() > _INT_MAX or n * h * w * co > _INT_MAX:
        raise ValueError(f"dw_pw_fused: shape {tuple(x.shape)} -> {co} out of range")
    dev = x.device
    _check(x, torch.int8, (n, h, w, c), "x", dev)
    _check(w_dw, torch.int8, (9, c), "w_dw", dev)
    _check(w_pw, torch.int8, (c, co), "w_pw", dev)
    for t, size, what in ((dw_scale, c, "dw_scale"), (dw_bias, c, "dw_bias"),
                          (pw_scale, co, "pw_scale"), (pw_bias, co, "pw_bias")):
        _check(t, torch.float32, (size,), what, dev)
    dw = _act_args(dw_act, "depthwise")
    pw = _act_args(pw_act, "pointwise")

    int8_out = s_out is not None
    out = torch.empty((n, h, w, co), dtype=torch.int8 if int8_out else torch.float32,
                      device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel_fn()(
            x.data_ptr(), w_dw.data_ptr(), dw_scale.data_ptr(), dw_bias.data_ptr(),
            w_pw.data_ptr(), pw_scale.data_ptr(), pw_bias.data_ptr(), out.data_ptr(),
            n, h, w, c, co, *dw, *pw, 1.0 / s_mid, int(int8_out),
            1.0 / s_out if int8_out else 0.0, stream)
    if err != 0:
        raise RuntimeError(f"dw_pw_fused: CUDA launch failed, cudaError {err}")
    dw_pw_fused.launches += 1
    return out


dw_pw_fused.launches = 0
