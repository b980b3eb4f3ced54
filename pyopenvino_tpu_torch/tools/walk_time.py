"""Host time of the compiled walk of several source trees of the port, in turns.

    python -m pyopenvino_tpu_torch.tools.walk_time [--device cpu|cuda] TREE [TREE ...]

Each TREE is a checkout of the repository (the parent of a change unpacked
under ``build/``, and ``.``); pass them in the order to run, for instance
``build/parent . . build/parent``.  Each runs in a process of its own, its
``pyopenvino_tpu_torch`` first on ``sys.path``, and prints one ``walk {...}``
line per network: the median and the least host milliseconds of
``CompiledNetwork._run`` at batch 1 over ``RUNS`` calls after two warm-up
calls, with the device synchronized after each call, for ResNet-18 and
EfficientNet-B0 (seed-0 weights) in INT8-FULL on KERNELS, calibrated on one
seeded image.  On the CPU (the default, four threads) the kernels' plain
versions run, so the time is the walk plus the CPU's arithmetic, the same
in every tree; a difference between trees is the walk's.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

RUNS = 20


def run_tree(tree: str, device: str) -> None:
    """The measurements of the port imported from ``tree`` (this process)."""
    import numpy as np
    import torch

    from pyopenvino_tpu_torch import IECore
    from pyopenvino_tpu_torch.config import Config, QuantMode
    from pyopenvino_tpu_torch.models.efficientnet_b0 import efficientnet_b0_paths
    from pyopenvino_tpu_torch.models.synth import resnet18_paths

    if device == "cpu":
        torch.set_num_threads(4)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    ie = IECore()
    rng = np.random.default_rng(0)
    for model, paths in (("resnet18", resnet18_paths), ("efficientnet_b0", efficientnet_b0_paths)):
        net = ie.read_network(*paths(seed=0))
        name = net.model.parameters[0].name
        x = rng.uniform(0, 1, (1, 3, 224, 224)).astype(np.float32)
        exe = ie.load_network(net, "GPU" if device == "cuda" else "CPU",
                              config=Config(quant=QuantMode.INT8_FULL))
        exe.kernel_type = "pallas"
        exe.set_calibration([{name: rng.uniform(0, 1, x.shape).astype(np.float32)}])
        compiled = exe.compiled()
        times = []
        for i in range(RUNS + 2):
            t = time.perf_counter()
            compiled._run(compiled.model, compiled.analysis, {name: x})
            sync()
            if i >= 2:
                times.append((time.perf_counter() - t) * 1e3)
        print("walk " + json.dumps({"tree": tree, "model": model, "device": device,
                                    "runs": RUNS, "ms_median": statistics.median(times),
                                    "ms_min": min(times)}), flush=True)


def main(argv) -> int:
    device = "cpu"
    if len(argv) > 2 and argv[1] == "--device":
        device, argv = argv[2], [argv[0], *argv[3:]]
    if len(argv) == 3 and argv[1] == "--in-tree":
        tree = os.path.abspath(argv[2])
        sys.path.insert(0, tree)
        import pyopenvino_tpu_torch

        if not pyopenvino_tpu_torch.__file__.startswith(tree):
            raise RuntimeError(f"imported {pyopenvino_tpu_torch.__file__}, not from {tree}")
        run_tree(argv[2], device)
        return 0
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    here = os.path.abspath(__file__)
    for tree in argv[1:]:
        rc = subprocess.run([sys.executable, here, "--device", device, "--in-tree",
                             tree]).returncode
        if rc != 0:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
