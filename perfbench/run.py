#!/usr/bin/env python3
"""The benchmark of pyopenvino_tpu_torch on NVIDIA cards: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout.  The cell, its configuration, its traffic
and its metrics are found by name from BENCHMARK.json (perfbench/README.md).
The last line of standard output is the run's one JSON object; the numbers
the check compared, each beside its limit, are the last lines of standard
error.  No card, or fewer than the cell asks for: exit 2 and no result.
jax, jaxlib, flax or the JAX package loaded by the time the window has
closed: exit 3 and no result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# every cache of the program inside the checkout, at fixed paths: nvcc's
# libraries go to the package's own build/kernels/, Triton's here
os.environ["TRITON_CACHE_DIR"] = str(HERE / ".cache" / "triton")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "pyopenvino_tpu")


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def log(line: str) -> None:
    print(line, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    from perfbench.core import harness, spec

    t_proc = harness.process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"perfbench: {args.workload} needs {cell.chips} CUDA card(s); PyTorch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_proc, log)
    found = loaded_forbidden()
    if found:
        log(f"perfbench: {', '.join(found)} loaded in the process that measured")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
