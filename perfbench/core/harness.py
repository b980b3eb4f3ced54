"""One run of one cell: set-up, the measured window, the check, the metrics.

``run`` is what ``perfbench/run.py`` calls once it has found the cards; the
CPU tests call it on the CPU with small mixes.  Order, as the benchmark
states it: weights and inputs from the seed, the program set up and warmed
on the cell's own shapes, the window, the device's peak memory read, the
program's state freed, and only then the reference, in blocks, over every
distinct frame the windows answered.

A traced run measures two windows back to back: one as an untraced run
measures it, which the metrics timed on the host clock read, and then one
under the profiler, which the metrics of the trace read: the profiler's
cost on each launch slows the traced window's host.
"""

from __future__ import annotations

import dataclasses
import gc
import os
import tempfile
import time
from typing import Dict, Optional

import numpy as np
import torch

from perfbench.core import check, ir, peaks, spec, system, trace, weights
from perfbench.core.window import Window


@dataclasses.dataclass
class Reading:
    """What a per-layer metric's reader reads (``metrics/<name>.py``)."""
    config: dict
    traffic: dict
    graph: ir.Graph
    window: Window                # the traced window (in an untraced run, the window)
    trace: Optional[trace.Summary]
    peaks: Optional[dict]
    untraced: Window              # the window as an untraced run measures it


def process_start() -> float:
    """The process's start on the ``perf_counter`` clock (10 ms steps)."""
    try:
        with open("/proc/self/stat", "r") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - age
    except (OSError, ValueError, IndexError, AttributeError):
        return time.perf_counter()


def _finite(x):
    return x if isinstance(x, (int, float)) and np.isfinite(x) else None


def setup(cell: spec.Cell, seed: int, device: str, log=None):
    """(graph, weights, calibration frames, the program loaded and
    calibrated) of ``cell`` at ``seed``."""
    cfg = cell.config
    t0 = time.perf_counter()
    graph = ir.parse(cfg["xml"])
    consts = weights.make(graph, seed, device, reference_class(cell).OPS)
    calibration = weights.frames(graph, int(cfg["mode"]["calibration_frames"]), seed,
                                 weights.CALIBRATION, device)
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="perfbench-") as d:
        bin_path = os.path.join(d, "weights.bin")
        with open(bin_path, "wb") as f:
            f.write(weights.blob(graph, consts, cfg.get("int_consts", {})))
        exe = system.load(cfg, cfg["xml"], bin_path, list(calibration.cpu().numpy()), device)
    if log is not None:
        log(f"setup: weights and calibration frames {t1 - t0:.3f} s, the program read, "
            f"calibrated and compiled {time.perf_counter() - t1:.3f} s")
    return graph, consts, calibration, exe


def reference_class(cell: spec.Cell):
    """The configuration's plain reference (``reference/<name>.py``'s
    ``Reference``); its ``OPS`` give the plain semantics of the operations
    its topology has beyond ``core/plain.py``'s."""
    return spec.module("reference", cell.config["name"], cell.base).Reference


def reference(cell: spec.Cell, graph, consts, calibration, **kw):
    return reference_class(cell)(graph, consts, calibration, **kw)


def driver(cell: spec.Cell):
    """The run function of the cell's kind of traffic (``drivers/<kind>.py``)."""
    return spec.module("drivers", cell.traffic["kind"], cell.base).run


def free_device(cuda: bool) -> None:
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool, device: str,
        t_proc: float, log=print) -> dict:
    cfg, mix = cell.config, cell.traffic
    cuda = device == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t_import = time.perf_counter()
    graph, consts, calibration, exe = setup(cell, seed, device, log)
    t_warm = time.perf_counter()
    tracers = [trace.Tracer(False, cuda)] + ([trace.Tracer(True, cuda)] if traced else [])
    frames, windows = driver(cell)(exe, graph, mix, seed, device, seconds, tracers)
    untraced, window = windows[0], windows[-1]
    setup_s = untraced.start - t_proc
    log(f"setup: {setup_s:.3f} s in all: process start to the harness {t_import - t_proc:.3f} s, "
        f"traffic and warm-up {untraced.start - t_warm:.3f} s")
    if cuda:
        torch.cuda.synchronize()
        peak = int(torch.cuda.max_memory_allocated())
        kind = torch.cuda.get_device_name(0)
    else:
        peak, kind = 0, "cpu"
    summary = tracers[-1].summary()
    for k, w in enumerate(windows):
        log(f"window {k}{' (traced)' if tracers[k].on else ''}: {w.metrics}")
        for note in w.notes:
            log(f"window {k}: {note}")
    del exe
    free_device(cuda)

    t_ref = time.perf_counter()
    probs, logits = reference(cell, graph, consts, calibration)(frames)
    numbers = check.compare([a for w in windows for a in w.answers], probs, logits)
    correct, table = check.verdict(numbers, cfg["checks"]["limits"])
    log(f"check: {numbers['answers']} answers against the reference over {len(frames)} "
        f"distinct frames in {time.perf_counter() - t_ref:.3f} s")

    reading = Reading(cfg, mix, graph, window, summary, peaks.of(kind), untraced)
    metrics: Dict[str, dict] = {}
    if traced:
        for m in cell.per_layer:
            value = spec.module("metrics", m["name"], cell.base).read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        found = dict(untraced.metrics, setup_s=setup_s)
        for m in cell.end_to_end:
            if m["name"] in found:
                metrics[m["name"]] = {"value": found[m["name"]], "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": sum(int(w.attempted) for w in windows),
              "failed": sum(int(w.failed) for w in windows), "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu", "kind": kind,
                         "count": cell.chips, "memory_peak_bytes": peak}}
    if summary is not None:
        result["device"].update(busy_s=summary.busy_s, window_s=summary.window_s)
        result["breakdown"] = summary.breakdown()
        for name, sec in sorted(summary.unmatched.items(), key=lambda kv: -kv[1]):
            log(f"trace: activity in no category (counted as conv/GEMM time): {sec} s {name}")
        log(f"trace: device seconds by category {summary.by_category}")
    result["checks"] = {k: {"value": _finite(v["value"]), "limit": v["limit"]}
                        for k, v in table.items()}
    for k, v in table.items():
        log(f"check {k} {v['value']} limit {v['limit']}")
    return result
