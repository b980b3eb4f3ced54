"""fused_gemm: ``act((A @ B) * scale + bias)`` as one hand-written CUDA kernel.

Counterpart of ``pyopenvino_tpu/kernels/gemm.py::fused_gemm`` (the Pallas
TPU kernel) with a float32 A and either a float32 B or an int8 B (INT8
weight-only, per-column float32 dequant scale applied to the accumulator).
The kernel is ``csrc/fused_gemm.cu``, one C entry point per B type, built by
``nvcc`` into a plain-C library on first use (kernels/build.py) and called
through ``ctypes`` on PyTorch's current stream.

``fused_gemm_plain`` is the same function in plain PyTorch.  The wrapper
takes it only for tensors that lie on the CPU (the CPU tests and the CPU
device); for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

_ACT_CODES = {None: 0, "relu": 1, "clamp": 2}
_MAX_N = 65535 * 64  # grid.y = ceil(N / 64)
_INT_MAX = 2 ** 31 - 1


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


def fused_gemm_plain(a, b, scale=None, bias=None, act: Optional[tuple] = None):
    """The kernel's function in plain PyTorch: act((a @ b) * scale + bias),
    epilogue in the kernel's order.  An int8 ``b`` is converted to float32
    and its scale multiplies the product, as in the kernel."""
    if b.dtype == torch.int8:
        b = b.float()
    out = torch.matmul(a, b)
    if scale is not None:
        out = out * scale
    if bias is not None:
        out = out + bias
    return apply_act(out, act)


# B dtype → C entry point of csrc/fused_gemm.cu
_ENTRIES = {torch.float32: "fused_gemm_f32", torch.int8: "fused_gemm_f32_i8w"}


@functools.cache
def _kernel_fn(entry: str):
    """The C entry point, built and loaded on first call."""
    from pyopenvino_tpu_torch.kernels.build import load_library

    fn = getattr(load_library("fused_gemm.cu"), entry)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, p, p, p, p, i, i, i, i, i, f, f, p]
    fn.restype = ctypes.c_int
    return fn


def _check_vector(v, n, what, device):
    if v is None:
        return
    if (v.device != device or v.dtype != torch.float32 or v.dim() != 1
            or v.shape[0] != n or not v.is_contiguous()):
        raise ValueError(
            f"fused_gemm: {what} must be a contiguous float32 ({n},) tensor "
            f"on {device}, got {v.dtype}{tuple(v.shape)} on {v.device}")


def fused_gemm(a, b, scale=None, bias=None, act: Optional[tuple] = None):
    """act((a @ b) * scale + bias).

    a:     (M, K) float32, unit column stride; rows may be strided (lda >= K)
    b:     (K, N) contiguous, float32, or int8 (weight-only INT8: then
           ``scale`` is required and dequantizes the product per column)
    scale: optional (N,) per-output-column scale
    bias:  optional (N,) bias
    act:   None | ("relu", 0, 0) | ("clamp", lo, hi)

    Returns a new contiguous (M, N) float32 tensor.  On a CUDA tensor each
    call is one launch of csrc/fused_gemm.cu and adds one to
    ``fused_gemm.launches`` (float32 B) or ``fused_gemm.launches_i8w``
    (int8 B).
    """
    if b.dtype == torch.int8 and scale is None:
        raise ValueError("fused_gemm: an int8 b needs its (N,) dequant scale")
    if a.device.type == "cpu":
        return fused_gemm_plain(a, b, scale, bias, act)
    if a.device.type != "cuda":
        raise ValueError(f"fused_gemm: unsupported device {a.device}")
    if act is not None and act[0] not in _ACT_CODES:
        raise ValueError(f"unknown activation {act[0]!r}")
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"fused_gemm: shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != torch.float32 or b.dtype not in _ENTRIES:
        raise ValueError(
            f"fused_gemm: the CUDA kernel takes a float32 a and a float32 or "
            f"int8 b, got {a.dtype} @ {b.dtype}")
    if b.device != a.device:
        raise ValueError(f"fused_gemm: b on {b.device}, a on {a.device}")
    # The stride of a size-1 dim is never stepped, and PyTorch leaves it
    # arbitrary (a transposed (K, 1) view is (1, K) with strides (1, 1)).
    lda = a.stride(0) if m > 1 else k
    if (k > 1 and a.stride(1) != 1) or lda < k:
        raise ValueError(
            f"fused_gemm: a needs unit column stride and row stride >= K, got "
            f"strides {a.stride()}")
    if not b.is_contiguous():
        raise ValueError("fused_gemm: b must be contiguous (K, N)")
    if m > _INT_MAX or n > _MAX_N or k > _INT_MAX or lda > _INT_MAX:
        raise ValueError(f"fused_gemm: shape ({m}, {k}, {n}) out of range")
    _check_vector(scale, n, "scale", a.device)
    _check_vector(bias, n, "bias", a.device)

    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    kind, lo, hi = act if act is not None else (None, 0.0, 0.0)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _kernel_fn(_ENTRIES[b.dtype])(
            a.data_ptr(), b.data_ptr(),
            scale.data_ptr() if scale is not None else None,
            bias.data_ptr() if bias is not None else None,
            out.data_ptr(), m, n, k, lda,
            _ACT_CODES[kind], float(lo), float(hi), stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_gemm: CUDA launch failed, cudaError {err}")
    if b.dtype == torch.int8:
        fused_gemm.launches_i8w += 1
    else:
        fused_gemm.launches += 1
    return out


fused_gemm.launches = 0
fused_gemm.launches_i8w = 0
