"""End-to-end times of several source trees of the port on one card, in turns.

    python -m pyopenvino_tpu_torch.tools.ab_e2e TREE [TREE ...]

Each TREE is a checkout of the repository (the parent of a change unpacked
under ``build/``, and ``.``); pass them in the order to run, for instance
``build/parent . . build/parent``.  Each runs in a process of its own (its
``pyopenvino_tpu_torch`` first on ``sys.path``, its kernels built into its
own ``build/``) and prints one ``e2e {...}`` line per measurement, as
``chip_smoke.py`` phase 5c measures them: ResNet-18 INT8-FULL on KERNELS in
float32 and bfloat16 compute (median batch-1 latency over 30 requests,
images a second of ``infer_batch`` at 64, the median of 5), and bench.py's
headline (u8 ingress, INT8-FULL, bfloat16, ``infer_batch`` at 512), each
three times.  Needs the card; exits non-zero without one.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

REPEATS = 3


def _e2e(target, requests, rows):
    import torch

    torch.cuda.synchronize()
    target.infer({"data": requests[0]})
    lat = []
    for i in range(30):
        t = time.perf_counter()
        target.infer({"data": requests[i % len(requests)]})
        lat.append((time.perf_counter() - t) * 1e3)
    target.infer_batch({"data": rows})
    thr = []
    for _ in range(5):
        t = time.perf_counter()
        target.infer_batch({"data": rows})
        thr.append(time.perf_counter() - t)
    return {"latency_b1_ms_median": statistics.median(lat),
            f"img_per_s_b{len(rows)}": len(rows) / statistics.median(thr)}


def run_tree(tree: str) -> None:
    """The measurements of the port imported from ``tree`` (this process)."""
    import numpy as np
    import torch

    from pyopenvino_tpu_torch import IECore, PrePostProcessor
    from pyopenvino_tpu_torch.config import Config, QuantMode
    from pyopenvino_tpu_torch.models.synth import resnet18_paths

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ie = IECore()
    rng = np.random.default_rng(0)
    requests = [rng.uniform(0, 1, (1, 3, 224, 224)).astype(np.float32) for _ in range(5)]
    batch = rng.uniform(0, 1, (64, 3, 224, 224)).astype(np.float32)
    calibration = [{"data": rng.uniform(0, 1, (1, 3, 224, 224)).astype(np.float32)}
                   for _ in range(4)]
    net = ie.read_network(*resnet18_paths(seed=0))
    for dtype in ("float32", "bfloat16"):
        exe = ie.load_network(net, "GPU", config=Config(quant=QuantMode.INT8_FULL,
                                                          compute_dtype=dtype))
        exe.kernel_type = "pallas"
        exe.set_calibration(calibration)
        for _ in range(REPEATS):
            print("e2e " + json.dumps({"tree": tree, "case": f"resnet18 int8 {dtype}",
                                       **_e2e(exe, requests, batch)}), flush=True)
    ppp = PrePostProcessor(ie.read_network(*resnet18_paths(seed=0)))
    ppp.input().tensor().set_element_type("u8")
    u8 = np.random.default_rng(31)
    u8_requests = [u8.integers(0, 256, (1, 3, 224, 224), dtype=np.uint8) for _ in range(5)]
    u8_batch = u8.integers(0, 256, (512, 3, 224, 224), dtype=np.uint8)
    exe = ie.load_network(ppp.build(), "GPU", config=Config(quant=QuantMode.INT8_FULL,
                                                              compute_dtype="bfloat16"))
    exe.kernel_type = "pallas"
    exe.set_calibration([{"data": u8.integers(0, 256, (1, 3, 224, 224), dtype=np.uint8)}
                         for _ in range(4)])
    for _ in range(REPEATS):
        print("e2e " + json.dumps({"tree": tree, "case": "headline",
                                   **_e2e(exe, u8_requests, u8_batch)}), flush=True)


def main(argv) -> int:
    if len(argv) == 3 and argv[1] == "--in-tree":
        tree = os.path.abspath(argv[2])
        sys.path.insert(0, tree)
        import torch

        import pyopenvino_tpu_torch

        if not pyopenvino_tpu_torch.__file__.startswith(tree):
            raise RuntimeError(f"imported {pyopenvino_tpu_torch.__file__}, not from {tree}")
        if not torch.cuda.is_available():
            print("ab_e2e: PyTorch sees no CUDA device", file=sys.stderr)
            return 2
        run_tree(argv[2])
        return 0
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    here = os.path.abspath(__file__)
    for tree in argv[1:]:
        rc = subprocess.run([sys.executable, here, "--in-tree", tree]).returncode
        if rc != 0:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
