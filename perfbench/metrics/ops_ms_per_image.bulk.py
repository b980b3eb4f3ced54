"""Device ms a frame outside the conv/GEMM categories: elementwise work (the
(de)quantization among it), copies, pools, torch.cat's patches and the
softmax (``core/categories.py`` OPS), over the frames answered."""

from perfbench.core import categories


def read(r):
    images = r.window.counts.get("images")
    if r.trace is None or not images:
        return None
    return 1e3 * r.trace.seconds(categories.OPS) / images
