"""Microbenchmark of the fused depthwise + pointwise kernel on the card.

    python -m pyopenvino_tpu_torch.tools.microbench_dw_pw [B]

Counterpart of ``tools/microbench_dw_pw.py``.  At SSD-MobileNet-v1's
stride-1 separable pairs (3×3 depthwise, ReLU6, 1×1 pointwise, ReLU6, int8
in and out, batch B, 256 by default), it times two versions of one function
on the same seeded inputs:

  * fused: ``kernels/dw_pw.py::dw_pw_fused`` (csrc/dw_pw.cu), the
    intermediate kept in shared memory, the pointwise weight K-major and
    cached, at each of the kernel's tile heights (64 and 128 pixels a
    block);
  * unfused: the pair as the port's INT8-FULL route runs it, the depthwise
    conv's exact int32 sum (``conv2d_int32``, grouped, float64), its epilogue
    and requantize, then the int8 × int8 ``fused_gemm`` with the pointwise
    epilogue, and requantize.

For each shape it prints one line of JSON: the largest difference of the
output codes between the two (0, or the script fails), both device times in
ms (CUDA events around ``ITERS`` calls after a warm-up; ``fused_ms`` at the
tile height the wrapper picks), the roofline bound, and for each tile
height the depthwise stage's share of the kernel's block clocks (clock64()
counts that every block adds up, the card having no profiler of stalls).
Needs a CUDA card: without one it exits non-zero and times nothing.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from pyopenvino_tpu_torch.kernels.dw_pw import TILE_ROWS, dw_pw_fused, pick_tile_rows
from pyopenvino_tpu_torch.kernels.gemm import conv2d_int32, epilogue, fused_gemm
from pyopenvino_tpu_torch.ops.spec import TValue

# (H, W, C, Co) of SSD-MobileNet-v1's stride-1 separable pairs at the
# published widths: dw7-11 (x5), dw5, dw3, dw13
PUBLISHED = [(19, 19, 512, 512), (38, 38, 256, 256), (75, 75, 128, 128),
             (10, 10, 1024, 1024)]
RELU6 = ("clamp", 0.0, 6.0)
S_MID, S_OUT = 0.05, 0.04
ITERS = 10
PEAK_INT8_OPS = 1979e12  # H100 SXM, dense (NVIDIA data sheet)
PEAK_BYTES = 3.35e12


def make_inputs(b, h, w, c, co, seed=0, device="cuda"):
    """The JAX script's distributions: int8 codes, dequant scales in
    [1e-4, 1e-3), biases in [-1, 1)."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(a).to(device)

    return (t(rng.integers(-127, 128, (b, h, w, c), dtype=np.int8)),
            t(rng.integers(-127, 128, (9, c), dtype=np.int8)),
            t(rng.uniform(1e-4, 1e-3, c).astype(np.float32)),
            t(rng.uniform(-1, 1, c).astype(np.float32)),
            t(rng.integers(-127, 128, (c, co), dtype=np.int8)),
            t(rng.uniform(1e-4, 1e-3, co).astype(np.float32)),
            t(rng.uniform(-1, 1, co).astype(np.float32)))


def unfused(x, w_dw, dw_scale, dw_bias, w_pw, pw_scale, pw_bias, *, dw_act, pw_act,
            s_mid, s_out=None):
    """The same function through the port's separate INT8-FULL routes;
    ``w_pw`` is K-major here, as fused_gemm's int8 × int8 variant takes it."""
    n, h, w, c = x.shape
    acc = conv2d_int32(x.permute(0, 3, 1, 2), w_dw.t().reshape(c, 1, 3, 3),
                       pads=((1, 1), (1, 1)), groups=c)
    q = TValue.quantize(epilogue(acc.permute(0, 2, 3, 1).float(), dw_scale, dw_bias, dw_act),
                        s_mid)
    o = fused_gemm(q.reshape(-1, c), w_pw, pw_scale, pw_bias, pw_act)
    if s_out is not None:
        o = TValue.quantize(o, s_out)
    return o.reshape(n, h, w, w_pw.shape[1])


def dw_pw_bound(b, h, w, c, co, out_bytes):
    """(ms, "bytes" | "operations"): the least time of one call on the card,
    each input read and the output written once (tools/dw_pw_kernel.py's
    cost estimate, with the scales and biases)."""
    ops = b * (18 * h * w * c + 2 * h * w * c * co)
    nbytes = b * h * w * (c + co * out_bytes) + 9 * c + c * co + 8 * (c + co)
    t_ops, t_bytes = ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def event_ms(fn, iters=ITERS):
    """Device ms per call: CUDA events around ``iters`` calls after two."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def run(h, w, c, co, b):
    args = make_inputs(b, h, w, c, co)
    kw = dict(dw_act=RELU6, pw_act=RELU6, s_mid=S_MID, s_out=S_OUT)
    # the pointwise weight as both routes would cache it: K-major
    wmat = args[4].t().contiguous().t()
    pair = (*args[:4], wmat, *args[5:])
    ref = unfused(*pair, **kw)
    row = {"shape": f"{h}x{w}x{c}->{co}", "batch": b, "max_code_diff": 0}
    for rows in TILE_ROWS:
        fused = dw_pw_fused(*args, wmat=wmat, tile_rows=rows, **kw)
        torch.cuda.synchronize()
        diff = int((fused.int() - ref.int()).abs().max().item())
        if diff != 0:
            raise AssertionError(f"dw_pw_fused ({rows} rows) differs from the unfused pair "
                                 f"at {h}x{w}x{c}->{co} B={b}: {diff}")
        row[f"fused_ms_{rows}"] = event_ms(
            lambda: dw_pw_fused(*args, wmat=wmat, tile_rows=rows, **kw))
        clocks = torch.zeros(2, dtype=torch.int64, device=args[0].device)
        dw_pw_fused(*args, wmat=wmat, tile_rows=rows, clocks=clocks, **kw)
        dw, pw = clocks.tolist()
        row[f"depthwise_clock_share_{rows}"] = dw / (dw + pw)
    t_unfused = event_ms(lambda: unfused(*pair, **kw))
    rows = pick_tile_rows(b * h * w, c, args[0].device.index)
    t_fused = row[f"fused_ms_{rows}"]
    bound_ms, bound_by = dw_pw_bound(b, h, w, c, co, 1)
    return {**row, "tile_rows": rows, "fused_ms": t_fused, "unfused_ms": t_unfused,
            "speedup": t_unfused / t_fused, "bound_ms": bound_ms, "bound_by": bound_by}


def main(argv):
    if not torch.cuda.is_available():
        print("microbench_dw_pw: PyTorch sees no CUDA device", file=sys.stderr)
        return 2
    b = int(argv[1]) if len(argv) > 1 else 256
    print(f"device {torch.cuda.get_device_name(0)}", flush=True)
    for shape in PUBLISHED:
        print(json.dumps(run(*shape, b)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
