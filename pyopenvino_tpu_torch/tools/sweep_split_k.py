"""Time the tensor-core kernels at every split count of K.

    python -m pyopenvino_tpu_torch.tools.sweep_split_k SMOKE_LOG OUT.jsonl [KERNEL ...]

Reads the main-path shapes of ``fused_gemm`` (float32 B), ``fused_gemm_i8w``
(int8 B), ``fused_gemm_i8i8``, ``conv2d_direct`` (int8 codes, ResNet-18's
stride-1 3×3 convs), ``conv2d_direct_f32`` (float32, the same convs had
they been routed, float32 weight), ``fused_gemm_bf16`` and
``fused_gemm_bf16_i8w`` (bfloat16 A), or of the KERNELs named, from the
phase-5a rows of a ``chip_smoke.py`` log, and for each shape launches the C entry points
directly with k per split set to every value that gives 1, 2, 3, 4, 6, 8,
12, 16, 24 or 32 splits (and the one ``kernels/gemm.py::split_k`` picks).
Each launch is checked against the plain version (int8 × int8 and the int8
conv exactly, int8 B within 2e-5, float32 B and the float32 conv within
1e-4, the bfloat16 ones within 2^-7, each of its max |plain|: a bfloat16
step at the largest value) and timed by CUDA-graph replay, as in
``chip_smoke.py``.  One
JSON line per (shape, split) goes to OUT.jsonl; the best split of each
shape is printed.  This is how ``kernels/gemm.py::PLANS`` was chosen.
Needs the card; exits non-zero without one.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from pyopenvino_tpu_torch.kernels import conv_direct, gemm
from pyopenvino_tpu_torch.kernels.conv import conv_weight_matrix, conv_weight_matrix_nk

# chip_smoke.py's kernel name → (C entry point, its PLANS key, gate)
ENTRIES = {"fused_gemm": ("fused_gemm_f32", "fused_gemm_f32", 1e-4),
           "fused_gemm_i8w": ("fused_gemm_f32_i8w", "fused_gemm_f32_i8w", 2e-5),
           "fused_gemm_i8i8": ("fused_gemm_i8i8", "fused_gemm_i8i8", 0.0),
           "conv2d_direct": ("conv2d_direct_i8", "conv2d_direct", 0.0),
           "conv2d_direct_f32": ("conv2d_direct_f32", "conv2d_direct_f32", 1e-4),
           "fused_gemm_bf16": ("fused_gemm_bf16", "fused_gemm_bf16", 2.0 ** -7),
           "fused_gemm_bf16_i8w": ("fused_gemm_bf16_i8w", "fused_gemm_bf16_i8w", 2.0 ** -7)}
SPLITS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32)
ITERS = 20


def smoke_shapes(path, kernels):
    """{(kernel, model, batch, M, K, N, conv): launches per forward} of a
    log's rows of ``kernels``; conv is (H, W, Ci) for conv2d_direct's and
    conv2d_direct_f32's 3×3 rows, else None."""
    shapes = {}
    with open(path) as f:
        for line in f:
            if line.startswith("time "):
                _, name, payload = line.split(" ", 2)
                if name in kernels:
                    r = json.loads(payload)
                    if name.startswith("conv2d_direct"):
                        h, w, ci = r["H"], r["W"], r["Ci"]
                        key = (r["batch"] * h * w, 9 * ci, r["Co"], (h, w, ci))
                    else:
                        key = (r["M"], r["K"], r["N"], None)
                    shapes[(name, r["model"], r["batch"], *key)] = (
                        r["launches_per_forward"] or r.get("if_routed", 0))
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


def operands(name, m, k, n, conv, rng, dev):
    """(launch(kchunk, ws) → cudaError, the output, the plain version's
    output, the workspace dtype) of one shape.  A launch goes to the
    current stream, which a CUDA graph's capture sets."""
    def codes(shape):
        return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8)).to(dev)

    def normal(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)

    scale = torch.from_numpy(rng.uniform(1e-4, 1e-2, n).astype(np.float32)).to(dev)
    bias = normal((n,))
    out = torch.empty((m, n), device=dev)
    if name.startswith("conv2d_direct"):
        h, w, ci = conv
        b = m // (h * w)
        pads = ((1, 1), (1, 1))
        # the int8 entry's output type after the output, the float32 entry's
        # weight type after the weight (float32 out, a float32 weight)
        if name == "conv2d_direct":
            x, wt = codes((b, h, w, ci)), codes((n, ci, 3, 3))
            wmat, w_int8, out_bf16 = conv_weight_matrix_nk(wt), [], [0]
        else:
            x, wt, scale = normal((b, h, w, ci)), normal((n, ci, 3, 3)), None
            wmat, w_int8, out_bf16 = conv_weight_matrix(wt), [0], []
        want = conv_direct.conv2d_direct_plain(x, wt, scale, bias, None, pads).view(m, n)
        fn = conv_direct._kernel_fn(ENTRIES[name][0])

        def launch(kchunk, ws):
            return fn(x.data_ptr(), wmat.data_ptr(), *w_int8,
                      scale.data_ptr() if scale is not None else None, bias.data_ptr(),
                      out.data_ptr(), *out_bf16, b, h, w, ci, n, 3, 3, h, w, 1, 1, 0, 0.0, 0.0,
                      kchunk, ws,
                      torch.cuda.current_stream().cuda_stream)

        return launch, out, want, torch.int32 if name == "conv2d_direct" else torch.float32
    if name == "fused_gemm_i8i8":
        a, bmat = codes((m, k)), codes((n, k)).t()
    elif name == "fused_gemm_i8w":
        a, bmat = normal((m, k)), codes((k, n))
    elif name == "fused_gemm_bf16_i8w":
        a, bmat, out = normal((m, k)).bfloat16(), codes((k, n)), out.bfloat16()
    elif name == "fused_gemm_bf16":
        a, bmat, scale = normal((m, k)).bfloat16(), normal((k, n)).bfloat16(), None
        out = out.bfloat16()
    else:
        a, bmat, scale = normal((m, k)), normal((k, n)), None
    want = gemm.fused_gemm_plain(a, bmat, scale, bias).float()
    entry = ENTRIES[name][0]
    out_bf16 = [0] if name == "fused_gemm_i8i8" else []  # float32 out

    def launch(kchunk, ws):
        # the closure holds every tensor whose address it passes: a freed
        # scale's memory is handed to the next allocation
        split = [kchunk, ws] if kchunk < k else []
        fn = gemm._kernel_fn(entry + ("_splitk" if split else ""))
        scale_ptr = scale.data_ptr() if scale is not None else None
        return fn(a.data_ptr(), bmat.data_ptr(), scale_ptr, bias.data_ptr(), out.data_ptr(),
                  m, n, k, k, *out_bf16, 0, 0.0, 0.0, *split,
                  torch.cuda.current_stream().cuda_stream)

    return launch, out, want, torch.int32 if name == "fused_gemm_i8i8" else torch.float32


def sweep(name, m, k, n, conv, rng, sms):
    """[(splits, kchunk, ms, planned)] of one shape."""
    _, plan_key, gate = ENTRIES[name]
    plan = gemm.PLANS[plan_key]
    dev = torch.device("cuda")
    launch, out, want, ws_dtype = operands(name, m, k, n, conv, rng, dev)
    steps = -(-k // plan.bk)
    planned = gemm.split_k(m, k, n, plan, sms)
    chunks = sorted({-(-steps // s) * plan.bk for s in SPLITS if s <= steps} | {planned},
                    reverse=True)
    rows = []
    for kchunk in chunks:
        splits = -(-k // kchunk)
        ws = torch.empty((splits, m, n), device=dev, dtype=ws_dtype)

        def call():
            err = launch(kchunk, ws.data_ptr() if splits > 1 else None)
            if err:
                raise RuntimeError(f"{name}: cudaError {err}")

        call()
        torch.cuda.synchronize()
        err = (out.float() - want).abs().max().item() / max(want.abs().max().item(), 1e-30)
        if err > gate:
            raise AssertionError(f"{name} ({m}, {k}, {n}) with {splits} splits: {err}")
        rows.append((splits, kchunk, graph_ms(call), kchunk == planned))
    return rows


def main(argv):
    if not torch.cuda.is_available():
        print("sweep_split_k: PyTorch sees no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(0)
    with open(argv[2], "w") as out:
        for (name, model, batch, m, k, n, conv), count in sorted(
                smoke_shapes(argv[1], argv[3:] or ENTRIES).items(),
                key=lambda kv: str(kv[0])):
            rows = sweep(name, m, k, n, conv, rng, sms)
            plan = gemm.PLANS[ENTRIES[name][1]]
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
