"""The traced window: ``torch.profiler`` around the measured window, and its
reduction to what the per-layer metrics read.

The window is a profiler range of its own (``MARK``), so the host clock's
window and the device's timeline share one time base.  Device activities
(kernels, copies, sets) are clipped to the window; ``busy_s`` is the length
of their union; each idle gap of the device inside the window is put down to
the host operator that overlaps its middle (the innermost, latest started),
or to "python" where no operator was running.
"""

from __future__ import annotations

import contextlib
import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from perfbench.core import categories

MARK = "perfbench.window"
NAME_CHARS = 160  # a kernel's name in the breakdown, cut to this length
SMALL_GAP_S = 10e-6


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    activities: int
    by_category: Dict[str, float]       # device seconds
    by_name: Dict[str, float]           # device seconds
    idle_by_host: Dict[str, float]      # idle device seconds by host operator
    unmatched: Dict[str, float]         # names in no category, seconds

    def seconds(self, cats) -> float:
        return sum(v for k, v in self.by_category.items() if k in cats)

    def breakdown(self) -> dict:
        top = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:NAME_CHARS], s] for n, s in top],
                "idle_gaps": [[n[:NAME_CHARS], s] for n, s in gaps]}


class Tracer:
    """``with tracer.profiling():`` profiles (when on), after the warm-up;
    ``tracer.window()`` marks the measured window inside it."""

    def __init__(self, on: bool, cuda: bool):
        self.on, self.cuda = on, cuda
        self._prof = None

    def profiling(self):
        if not self.on:
            return contextlib.nullcontext()
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        self._prof = profile(activities=acts)
        return self._prof

    def window(self):
        if not self.on:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(MARK)

    def summary(self) -> Optional[Summary]:
        if self._prof is None:
            return None
        return reduce(_events(self._prof))


def _events(prof) -> List[tuple]:
    """(device?, name, start_ns, end_ns, annotation?) of the profiler's raw
    events."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = start + e.duration_ns()
        ann = bool(getattr(e, "is_user_annotation", lambda: False)()) or \
            "annotation" in str(getattr(e, "activity_type", lambda: "")()).lower()
        out.append((e.device_type() != DeviceType.CPU, e.name(), start, end, ann))
    return out


def union(intervals: np.ndarray) -> np.ndarray:
    """The merged (start, end) rows of ``intervals``, sorted."""
    if len(intervals) == 0:
        return intervals.reshape(0, 2)
    iv = intervals[np.argsort(intervals[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    last = np.flatnonzero(new)
    stops = ends[np.r_[last[1:] - 1, len(iv) - 1]]
    return np.stack([starts, stops], axis=1)


def reduce(events: List[tuple]) -> Summary:
    marks = [e for e in events if not e[0] and e[1] == MARK]
    if not marks:
        raise RuntimeError("the traced window's mark is missing from the trace")
    w0, w1 = marks[0][2], marks[0][3]
    dev = [(n, max(s, w0), min(t, w1)) for d, n, s, t, a in events
           if d and not a and n != MARK and t > w0 and s < w1]
    by_name: Dict[str, float] = defaultdict(float)
    by_cat: Dict[str, float] = defaultdict(float)
    unmatched: Dict[str, float] = defaultdict(float)
    for n, s, t in dev:
        sec = (t - s) * 1e-9
        by_name[n] += sec
        cat = categories.categorize(n)
        by_cat[cat] += sec
        if cat == categories.OTHER:
            unmatched[n] += sec
    busy = union(np.array([(s, t) for _, s, t in dev], dtype=np.int64).reshape(-1, 2))
    busy_s = float((busy[:, 1] - busy[:, 0]).sum()) * 1e-9
    # idle gaps inside the window, each put down to a host operator
    edges = np.concatenate([[w0], busy.reshape(-1), [w1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    host = sorted((s, t, n) for d, n, s, t, a in events
                  if not d and not a and n != MARK and t > w0 and s < w1)
    starts = np.array([h[0] for h in host], dtype=np.int64)
    idle: Dict[str, float] = defaultdict(float)
    for g0, g1 in gaps:
        sec = (g1 - g0) * 1e-9
        if sec < SMALL_GAP_S:
            idle["(gaps under 10 us)"] += sec
            continue
        mid = (g0 + g1) // 2
        k = int(np.searchsorted(starts, mid, side="right"))
        label = "python (no operator running)"
        for j in range(k - 1, max(k - 400, 0) - 1, -1):
            if host[j][1] >= mid:
                label = host[j][2]
                break
        idle[label] += sec
    return Summary(window_s=(w1 - w0) * 1e-9, busy_s=busy_s, activities=len(dev),
                   by_category=dict(by_cat), by_name=dict(by_name),
                   idle_by_host=dict(idle), unmatched=dict(unmatched))
