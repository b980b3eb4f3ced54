"""The whole forward's share of the card's peak, %: 2 · MACs of the IR's
Convolution, GroupConvolution and MatMul nodes a frame (``core/work.py``)
times the frames answered, over the window's seconds (host clock), over the
configuration's peak operations a second.  Read from the untraced window of
a traced run, measured as an untraced run measures its throughput: the
profiler's cost on each launch would lower it."""

from perfbench.core import work


def read(r):
    images = r.untraced.counts.get("images")
    if r.peaks is None or not images:
        return None
    ops = 2.0 * work.macs_per_image(r.graph) * images
    return 100.0 * ops / r.untraced.seconds / r.peaks[r.config["peak"]]
