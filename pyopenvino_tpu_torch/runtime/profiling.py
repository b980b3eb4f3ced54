"""Where a forward's time goes on the card: device time by kind of kernel,
and the device's busy share of the host-clock time.

The port's counterpart of ``pyopenvino_tpu/runtime/profiling.py``, built on
``torch.profiler``: every device activity (kernels and copies) inside the
window is summed by category, and the busy share is that sum over the
window's host-clock time (one stream, so activities do not overlap).

    python -m pyopenvino_tpu_torch.runtime.profiling

profiles ResNet-18 and MobileNet-v2 (synthesized weights, seed 0) and
SSD-MobileNet-v1 (assets/trained/ssd_shapes_ms, its trained weights, seeded
images of shapes from models/shapes.py, tools/accuracy.py's settings), each
in FP32, INT8 weight-only and INT8-FULL (calibrated on 4 seeded images), at
batch 1 (``infer``) and batch 64 (``infer_batch``) on both backends, STEPS
calls each after one warm-up, and prints one JSON line per case.  Needs a
CUDA card.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Callable, Dict

import numpy as np
import torch

STEPS = 10

# (category, substrings of the device activity's name), first match wins
CATEGORIES = (
    # csrc/i8_mma.cuh's kernel with conv_direct.cu's ConvA loader (#3), then
    # with the row-major loader (#1ii); csrc/f32_mma.cuh's kernel with an
    # int8 B (#1w) and a float32 B (#1); both loops' split-K reductions,
    # which their names do not tell apart; csrc/f32_tile.cuh's kernel with
    # conv_direct.cu's ConvF32A (3f); csrc/dw_pw.cu's kernel (#4)
    ("conv2d_direct", ("ConvA>",)),
    ("fused_gemm_i8i8", ("i8i8_mma_kernel",)),
    ("fused_gemm_i8w", ("BInt8>",)),
    ("fused_gemm", ("BFloat>",)),
    ("splitk_reduce", ("splitk_reduce",)),
    ("conv2d_direct_f32", ("ConvF32A",)),
    ("dw_pw_fused", ("dw_pw_kernel",)),
    ("softmax_rows", ("softmax_rows",)),
    ("copy", ("Memcpy", "Memset")),
    ("pool", ("pool",)),
    # cuDNN convolutions and cuBLAS products (the TORCH backend's FC)
    ("conv_and_library_gemm", ("conv", "cudnn", "xmma", "sm90", "sm80",
                               "gemm", "gemv", "implicit")),
    ("softmax_library", ("softmax",)),
    ("elementwise", ("elementwise", "vectorized", "copy_kernel", "reduce")),
)


def categorize(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k.lower() in low for k in keys):
            return cat
    return "other"


def device_profile(fn: Callable[[], object]) -> Dict[str, object]:
    """Profile STEPS calls of ``fn`` (after one warm-up call).  Returns
    host milliseconds per step, device-busy milliseconds per step, the busy
    share, device milliseconds per step by category, and the five longest
    activities."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_cat: Dict[str, float] = {}
    by_name: Dict[str, float] = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        by_cat[categorize(e.name)] = by_cat.get(categorize(e.name), 0.0) + us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    busy_ms = sum(by_cat.values()) / 1e3
    if busy_ms == 0.0:
        raise RuntimeError("the profiler recorded no device activity")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {
        "host_ms_per_step": wall_ms / STEPS,
        "device_busy_ms_per_step": busy_ms / STEPS,
        "device_busy_share": busy_ms / wall_ms,
        "device_ms_per_step_by_category": {
            k: v / 1e3 / STEPS for k, v in sorted(by_cat.items(), key=lambda kv: -kv[1])},
        "top_activities_ms_per_step": [(n[:80], us / 1e3 / STEPS) for n, us in top],
    }


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profiling needs a CUDA card")

    from pyopenvino_tpu_torch import IECore
    from pyopenvino_tpu_torch.config import Config, QuantMode
    from pyopenvino_tpu_torch.models.shapes import shapes_det300
    from pyopenvino_tpu_torch.models.synth import mobilenet_v2_paths, resnet18_paths

    ie = IECore()
    rng = np.random.default_rng(0)
    classifier = ("data", rng.uniform(0, 1, (65, 3, 224, 224)).astype(np.float32),
                  rng.uniform(0, 1, (4, 3, 224, 224)).astype(np.float32), {})
    trained = Path(__file__).resolve().parents[2] / "assets" / "trained"
    ssd = ("image_tensor", shapes_det300(65, seed=0)[0], shapes_det300(4, seed=1)[0],
           {"quant_min_elems": 4096})
    for model, paths, (name, images, cal, extra) in (
            ("resnet18", resnet18_paths(seed=0), classifier),
            ("mobilenet_v2", mobilenet_v2_paths(seed=0), classifier),
            ("ssd_shapes_ms", (str(trained / "ssd_shapes_ms.xml"),
                               str(trained / "ssd_shapes_ms.bin")), ssd)):
        net = ie.read_network(*paths)
        one, batch = images[:1], images[1:]
        calibration = [{name: cal[i:i + 1]} for i in range(len(cal))]
        for quant in (QuantMode.NONE, QuantMode.INT8_WEIGHT, QuantMode.INT8_FULL):
            int8full = quant == QuantMode.INT8_FULL
            for kernel_type in ("kernels", "torch"):
                exe = ie.load_network(net, "GPU", config=Config(
                    quant=quant, bias_correction=int8full and model == "ssd_shapes_ms",
                    **extra))
                exe.kernel_type = kernel_type
                if int8full:
                    exe.set_calibration(calibration)
                for b, call in ((1, lambda: exe.infer({name: one})),
                                (64, lambda: exe.infer_batch({name: batch}))):
                    row = {"model": model, "quant": quant.value,
                           "backend": kernel_type, "batch": b,
                           "card": torch.cuda.get_device_name(0),
                           **device_profile(call)}
                    print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
