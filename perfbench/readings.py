#!/usr/bin/env python3
"""The readings that each limit of ``correct`` is set from, for one cell, many
seeds in one process (the benchmark's own runs do not run this):

    python3 perfbench/readings.py --workload r18.bulk512 --seeds 12 --seconds 2 \
        [--first 1000] [--out chiprun_out/readings.jsonl]

For each seed: the program set up as a run sets it up, a short window at the
cell's own load, and then, against the plain reference's answers to the same
frames, the numbers of ``core/check.py`` for

  * the program (the lower readings: the largest over sound seeds);
  * the control: the reference itself computed in float8 (e4m3) where the
    configuration states bfloat16, put in the program's place (the upper
    reading: the smallest);
  * the faults a scoring cell can have, planted in the program's answers as
    they come out: each answer moved to its neighbour's place
    (``misplaced``), each answer's classes moved by one (``altered``), the
    second half of each batch given the first half's answers (``half``),
    and one answer of the window alone given its neighbour's answer
    (``one_misplaced``) or its classes moved by one (``one_altered``).

One JSON line a seed on standard output and in ``--out``.  Needs a card, as a
run does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
os.environ["TRITON_CACHE_DIR"] = str(HERE / ".cache" / "triton")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(HERE.parent))


def faults(answers):
    """{fault: the answers as the fault would hand them out}."""
    import numpy as np

    def halved(o):
        o = o.copy()
        h = len(o) // 2
        o[h:2 * h] = o[:h]
        return o

    def first_row(change):
        (idx, o), rest = answers[0], answers[1:]
        o = o.copy()
        o[0] = change(o)
        return [(idx, o)] + rest
    return {"misplaced": [(idx, np.roll(o, 1, axis=0)) for idx, o in answers],
            "altered": [(idx, np.roll(o, 1, axis=-1)) for idx, o in answers],
            "half": [(idx, halved(o)) for idx, o in answers],
            "one_misplaced": first_row(lambda o: o[1]),
            "one_altered": first_row(lambda o: np.roll(o[0], 1, axis=-1))}


def reading(cell, seed: int, seconds: float, device: str) -> dict:
    import numpy as np
    import torch

    from perfbench.core import check, harness, trace

    t0 = time.perf_counter()
    graph, consts, calibration, exe = harness.setup(cell, seed, device)
    frames, (window,) = harness.driver(cell)(
        exe, graph, cell.traffic, seed, device, seconds, [trace.Tracer(False, device == "cuda")])
    del exe
    harness.free_device(device == "cuda")
    t1 = time.perf_counter()
    probs, logits = harness.reference(cell, graph, consts, calibration)(frames)
    t2 = time.perf_counter()
    control, _ = harness.reference(cell, graph, consts, calibration,
                                   dtype=torch.float8_e4m3fn)(frames)
    out = {"workload": cell.name, "seed": seed, "window": window.metrics,
           "answers": len(window.answers), "frames": int(len(frames)),
           "setup_and_window_s": t1 - t0, "reference_s": t2 - t1,
           "program": check.compare(window.answers, probs, logits),
           "control": check.compare([(np.arange(len(frames)), control)], probs, logits),
           "faults": {k: check.compare(v, probs, logits)
                      for k, v in faults(window.answers).items()}}
    if device == "cuda":
        out["card"] = torch.cuda.get_device_name(0)
    return out


def main(argv=None) -> int:
    from perfbench.core import spec

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first", type=int, default=1000)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("readings.py needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    sink = open(args.out, "a") if args.out else None
    for seed in range(args.first, args.first + args.seeds):
        line = json.dumps(reading(cell, seed, args.seconds, "cuda"))
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
