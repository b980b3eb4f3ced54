"""Share of the conv/GEMM kernels' roofline in the traced window, %.

Numerator: each Convolution, GroupConvolution and MatMul of the IR at the
cell's batch, bound by max(2 · MACs / the configuration's peak, bytes / peak
bandwidth) (``core/work.py``), summed, times the calls in the window.
Denominator: device time of the conv/GEMM categories (``core/categories.py``:
the port's kernels, their split-K reductions, the library's convolutions and
products) and of every activity in no category.  Same work whatever
implements it; a new kernel name can lower the share, never raise it."""

from perfbench.core import categories, work


def read(r):
    calls = r.window.counts.get("calls")
    if r.trace is None or r.peaks is None or not calls:
        return None
    spent = r.trace.seconds(categories.CONV_GEMM | {categories.OTHER})
    if spent <= 0:
        return None
    bound = work.bound_seconds(r.graph, int(r.traffic["batch"]), r.config["work_bytes"],
                               r.peaks[r.config["peak"]], r.peaks["bytes_per_s"])
    return 100.0 * bound * calls / spent
