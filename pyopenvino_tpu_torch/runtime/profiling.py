"""Where a forward's time goes on the card: device time by kind of kernel,
and the device's busy share of the host-clock time.

The port's counterpart of ``pyopenvino_tpu/runtime/profiling.py``, built on
``torch.profiler``: every device activity (kernels and copies) inside the
window is summed by category, and the busy share is that sum over the
window's host-clock time (one stream, so activities do not overlap).

    python -m pyopenvino_tpu_torch.runtime.profiling

profiles ResNet-18 and MobileNet-v2 (synthesized weights, seed 0), each in
FP32 and INT8 weight-only, at batch 1 (``infer``) and batch 64
(``infer_batch``) on both backends, STEPS calls each after one warm-up, and
prints one JSON line per case.  Needs a CUDA card.
"""

from __future__ import annotations

import json
import time
from typing import Callable, Dict

import numpy as np
import torch

STEPS = 10

# (category, substrings of the device activity's name), first match wins
CATEGORIES = (
    # the int8-B instantiation of csrc/fused_gemm.cu's kernel template,
    # demangled or mangled (signed char is "a")
    ("fused_gemm_i8w", ("fused_gemm_kernel<signed char>", "fused_gemm_kernelIa")),
    ("fused_gemm", ("fused_gemm",)),
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
    from pyopenvino_tpu_torch.models.synth import mobilenet_v2_paths, resnet18_paths

    ie = IECore()
    rng = np.random.default_rng(0)
    one = rng.uniform(0, 1, (1, 3, 224, 224)).astype(np.float32)
    batch = rng.uniform(0, 1, (64, 3, 224, 224)).astype(np.float32)
    for model, paths in (("resnet18", resnet18_paths),
                         ("mobilenet_v2", mobilenet_v2_paths)):
        net = ie.read_network(*paths(seed=0))
        for quant in (QuantMode.NONE, QuantMode.INT8_WEIGHT):
            for kernel_type in ("kernels", "torch"):
                exe = ie.load_network(net, "GPU", config=Config(quant=quant))
                exe.kernel_type = kernel_type
                for b, call in ((1, lambda: exe.infer({"data": one})),
                                (64, lambda: exe.infer_batch({"data": batch}))):
                    row = {"model": model, "quant": quant.value,
                           "backend": kernel_type, "batch": b,
                           "card": torch.cuda.get_device_name(0),
                           **device_profile(call)}
                    print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
