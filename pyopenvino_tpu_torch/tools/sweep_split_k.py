"""Time fused_gemm's tensor-core variants at every split count of K.

    python -m pyopenvino_tpu_torch.tools.sweep_split_k SMOKE_LOG OUT.jsonl

Reads the main-path shapes of ``fused_gemm_i8i8`` and ``fused_gemm_i8w``
from the phase-5a rows of a ``chip_smoke.py`` log, and for each shape
launches the C entry points directly with k per split set to every value
that gives 1, 2, 3, 4, 6, 8, 12, 16, 24 or 32 splits (and the one
``kernels/gemm.py::split_k`` picks).  Each launch is checked against the
plain version (int8 × int8 exactly, int8 B within 2e-5) and timed by
CUDA-graph replay, as in ``chip_smoke.py``.  One JSON line per (shape,
split) goes to OUT.jsonl; the best split of each shape is printed.  This is
how ``kernels/gemm.py::PLANS`` was chosen.  Needs the card; exits non-zero
without one.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from pyopenvino_tpu_torch.kernels import gemm

ENTRIES = {"fused_gemm_i8i8": "fused_gemm_i8i8", "fused_gemm_i8w": "fused_gemm_f32_i8w"}
SPLITS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32)
ITERS = 20


def smoke_shapes(path):
    """{(kernel, model, batch, M, K, N): launches per forward} of a log."""
    shapes = {}
    with open(path) as f:
        for line in f:
            if line.startswith("time "):
                _, name, payload = line.split(" ", 2)
                if name in ENTRIES:
                    r = json.loads(payload)
                    shapes[(name, r["model"], r["batch"], r["M"], r["K"], r["N"])] = (
                        r["launches_per_forward"])
    return shapes


def graph_ms(fn):
    """Device ms per call: ITERS calls in one CUDA graph, replayed between
    CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(ITERS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def sweep(name, m, k, n, rng, sms):
    """[(splits, kchunk, ms, planned)] of one shape."""
    entry = ENTRIES[name]
    plan = gemm.PLANS[entry]
    dev = torch.device("cuda")
    if name == "fused_gemm_i8i8":
        a = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8)).to(dev)
        b = torch.from_numpy(rng.integers(-127, 128, (n, k)).astype(np.int8)).to(dev).t()
    else:
        a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(dev)
        b = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8)).to(dev)
    scale = torch.from_numpy(rng.uniform(1e-4, 1e-2, n).astype(np.float32)).to(dev)
    bias = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
    want = gemm.fused_gemm_plain(a, b, scale, bias)
    steps = -(-k // plan.bk)
    planned = gemm.split_k(m, k, n, plan, sms)
    chunks = sorted({-(-steps // s) * plan.bk for s in SPLITS if s <= steps} | {planned},
                    reverse=True)
    rows = []
    for kchunk in chunks:
        splits = -(-k // kchunk)
        out = torch.empty((m, n), device=dev)
        ws = torch.empty((splits, m, n), device=dev,
                         dtype=torch.int32 if name == "fused_gemm_i8i8" else torch.float32)
        fn = gemm._kernel_fn(entry + ("_splitk" if splits > 1 else ""))
        extra = [kchunk, ws.data_ptr()] if splits > 1 else []

        def call():
            err = fn(a.data_ptr(), b.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                     out.data_ptr(), m, n, k, k, 0, 0.0, 0.0, *extra,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{entry}: cudaError {err}")

        call()
        torch.cuda.synchronize()
        err = (out - want).abs().max().item() / max(want.abs().max().item(), 1e-30)
        if err > (0.0 if name == "fused_gemm_i8i8" else 2e-5):
            raise AssertionError(f"{name} ({m}, {k}, {n}) with {splits} splits: {err}")
        rows.append((splits, kchunk, graph_ms(call), kchunk == planned))
    return rows


def main(argv):
    if not torch.cuda.is_available():
        print("sweep_split_k: PyTorch sees no CUDA device", file=sys.stderr)
        return 2
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(0)
    with open(argv[2], "w") as out:
        for (name, model, batch, m, k, n), count in sorted(smoke_shapes(argv[1]).items()):
            rows = sweep(name, m, k, n, rng, sms)
            plan = gemm.PLANS[ENTRIES[name]]
            tiles = -(-m // plan.bm) * -(-n // plan.bn)
            for splits, kchunk, ms, planned in rows:
                out.write(json.dumps({
                    "kernel": name, "model": model, "batch": batch, "M": m, "K": k, "N": n,
                    "launches_per_forward": count, "tiles": tiles, "splits": splits,
                    "kchunk": kchunk, "planned": planned, "ms": ms}) + "\n")
            best = min(rows, key=lambda r: r[2])
            chosen = next(r for r in rows if r[3])
            print(f"{name} {model} B={batch} ({m}, {k}, {n}) tiles {tiles}: "
                  f"best {best[0]} splits {best[2]:.4f} ms, planned {chosen[0]} "
                  f"{chosen[2]:.4f} ms, one {rows[0][2]:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
