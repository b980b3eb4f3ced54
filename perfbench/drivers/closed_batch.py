"""``closed_batch``: one client calling ``infer_batch`` back to back, each
call ``batch`` frames taken in turn from a pool of ``pool`` host batches
(``core/traffic.py``), after ``warmup_calls`` calls that build, bake the
batch and cache the operands.  ``throughput`` is every frame answered in a
window over the window's seconds."""

import time

import numpy as np

from perfbench.core import system, traffic
from perfbench.core.window import GcPauses, Window, settled_heap


def run(exe, graph, mix, seed, device, seconds, tracers):
    frames, pool = traffic.closed_batch(graph, mix, seed, device)
    name, result = system.input_name(exe), system.result_name(exe)
    b = int(mix["batch"])
    for i in range(int(mix.get("warmup_calls", 2))):
        exe.infer_batch({name: pool[i % len(pool)]})
    windows = []
    calls = 0   # over every window, so each takes up the pool where the last left it
    for tracer in tracers:
        answers, failed, first = [], 0, calls
        with settled_heap(), tracer.profiling(), tracer.window(), GcPauses() as pauses:
            t0 = time.perf_counter()
            while True:
                k = calls % len(pool)
                try:
                    out = exe.infer_batch({name: pool[k]})[result]
                    answers.append((np.arange(k * b, (k + 1) * b), out))
                except Exception as e:  # noqa: BLE001 — a failed call fails its frames
                    failed += b
                    note = f"call {calls} failed: {e!r}"
                calls += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            t1 = time.perf_counter()
        n = calls - first
        w = Window(start=t0, seconds=t1 - t0, attempted=n * b, failed=failed,
                   metrics={"throughput": (n * b - failed) / (t1 - t0)}, answers=answers,
                   counts={"calls": n, "images": n * b - failed})
        if failed:
            w.notes.append(note)
        w.notes.append(pauses.note())
        windows.append(w)
    return frames, windows
