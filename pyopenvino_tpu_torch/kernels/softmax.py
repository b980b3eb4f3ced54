"""softmax_rows: last-axis softmax of a 2-D tensor as one Triton kernel.

Counterpart of ``pyopenvino_tpu/kernels/softmax.py::softmax_rows`` (the
Pallas TPU kernel, body ``_kernel`` at softmax.py:22-31).

What bounds it on an H100: one read and one write per element at 3.35 TB/s
and a handful of float32 operations per element, so bytes.  Design: one
program per row with ``BLOCK = next_power_of_2(N)`` lanes holds the whole
row in registers — max, ``exp(x - max)``, sum and divide in one pass, the
same traffic as a hand-written warp-shuffle CUDA kernel.  Lanes past N load
``-inf`` and contribute 0 to the sum, as the padded lanes do on the TPU.

``triton`` is imported inside the launching function: it exists only where
there is a card.  ``softmax_rows_plain`` is the same function in plain
PyTorch; the wrapper takes it only for CPU tensors.
"""

import functools
import importlib

import torch

tl = None  # triton.language, bound by _triton_kernel on the first launch


def softmax_rows_plain(x):
    """The kernel's function in plain PyTorch, in float32."""
    xf = x.float()
    e = torch.exp(xf - xf.max(dim=1, keepdim=True).values)
    return (e / e.sum(dim=1, keepdim=True)).to(x.dtype)


@functools.cache
def _triton_kernel():
    import triton

    # Triton resolves the names of a jitted body through the module's
    # globals: bind ``tl`` there now, never at import.  (This module keeps
    # annotations eager, so ``tl.constexpr`` below is evaluated here.)
    globals()["tl"] = importlib.import_module("triton.language")

    @triton.jit
    def _softmax_rows_kernel(x_ptr, out_ptr, n_cols, x_stride, out_stride,
                             BLOCK: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK)
        mask = cols < n_cols
        x = tl.load(x_ptr + row * x_stride + cols, mask=mask,
                    other=-float("inf")).to(tl.float32)
        m = tl.max(x, axis=0)
        e = tl.where(mask, tl.exp(x - m), 0.0)
        s = tl.sum(e, axis=0)
        y = e / s
        tl.store(out_ptr + row * out_stride + cols,
                 y.to(out_ptr.dtype.element_ty), mask=mask)

    return triton, _softmax_rows_kernel


def softmax_rows(x):
    """Softmax over the last axis of a 2-D tensor (float32 or bfloat16).

    On a CUDA tensor each call is one launch of the Triton kernel (one
    compile per dtype: the loads widen to float32, the store rounds to the
    input's dtype) and adds one to ``softmax_rows.launches`` (float32) or
    ``softmax_rows.launches_bf16`` (bfloat16)."""
    if x.dim() != 2:
        raise ValueError(f"softmax_rows takes a 2-D tensor, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return softmax_rows_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"softmax_rows: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"softmax_rows: unsupported dtype {x.dtype}")
    m, n = x.shape
    if x.stride(1) != 1:
        x = x.contiguous()
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    triton, kernel = _triton_kernel()
    block = triton.next_power_of_2(n)
    num_warps = 4 if block <= 2048 else 8 if block <= 8192 else 16
    with torch.cuda.device(x.device):
        kernel[(m,)](x, out, n, x.stride(0), out.stride(0), BLOCK=block,
                     num_warps=num_warps)
    if x.dtype == torch.bfloat16:
        softmax_rows.launches_bf16 += 1
    else:
        softmax_rows.launches += 1
    return out


softmax_rows.launches = 0
softmax_rows.launches_bf16 = 0
