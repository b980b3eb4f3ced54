"""What a driver (``drivers/<kind>.py``) hands back for each measured
window, and what it keeps steady while one runs.

A driver makes its traffic from the seed, warms only the shapes its traffic
uses, then measures one window for each tracer it is given, back to back,
each ``seconds`` long, and returns every distinct frame (on the device) and
a ``Window`` each: its start on the host clock (the first timed request),
the end-to-end numbers, the counts, and every answer with the index of its
frame, for the check after the windows.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import time
from typing import Dict, List


@dataclasses.dataclass
class Window:
    start: float                          # perf_counter of the first timed request
    seconds: float                        # the measured window's length
    attempted: int
    failed: int
    metrics: Dict[str, float]             # end-to-end numbers by metric name
    answers: List[tuple]                  # (frame indices, answers (n, ...)) in order
    counts: Dict[str, float] = dataclasses.field(default_factory=dict)
    notes: List[str] = dataclasses.field(default_factory=list)


@contextlib.contextmanager
def settled_heap():
    """The heap as set-up left it collected and frozen while the block runs
    (``gc.freeze``), and unfrozen after it.

    A full collection walks every object the process holds, torch's and the
    program's set-up among them: 125-330 ms on an H100 machine's 8-core host, once in
    about ten seconds of a window, every thread stopped.  Frozen, a
    collection walks only what the window allocates, the program's garbage
    and the harness's bookkeeping."""
    gc.collect()
    gc.freeze()
    try:
        yield
    finally:
        gc.unfreeze()


class GcPauses:
    """The garbage collector's pauses while the block runs, in any thread,
    for a note: a pause stops every thread of the process."""

    def __init__(self):
        self.pauses: List[tuple] = []   # (generation, seconds)
        self._t = None

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.pauses.append((info["generation"], time.perf_counter() - self._t))
            self._t = None

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)

    def note(self) -> str:
        sec = [s for _, s in self.pauses]
        return (f"garbage collections {len(sec)} (generation 2: "
                f"{sum(g == 2 for g, _ in self.pauses)}), paused ms total {sum(sec) * 1e3} "
                f"max {max(sec, default=0.0) * 1e3}")
