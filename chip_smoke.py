"""Smoke run of the PyTorch/CUDA port (pyopenvino_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0, no result line):

  1. environment: the card's name and power limit as nvidia-smi reports
     them, CUDA, Triton and device count;
  2. build: every CUDA source of the port compiled from the checkout and
     the Triton kernel's first compile;
  3. kernel checks: each kernel against its plain PyTorch version on the
     card, at every shape the main paths give it at batch 1 and 64 plus
     ragged shapes: fused_gemm with a float32 B and with an int8 B (max
     relative error <= 1e-4, from the summation order), conv2d_fused
     against F.conv2d, softmax_rows (max absolute error <= 1e-6);
  4. the main paths, full width (224×224, 1000 classes, weights synthesized
     from seed 0): ResNet-18 FP32, ResNet-18 INT8 weight-only, MobileNet-v2
     FP32 and MobileNet-v2 INT8 weight-only, each through
     IECore.read_network → load_network("GPU") → kernel_type "pallas",
     five batch-1 requests and one infer_batch at 64, with every launch
     counter set to 0 just before the path and read just after it, and the
     outputs held against the TORCH backend (TF32 off) on the same card;
  5. times: per kernel variant and shape the kernel, plain-version and
     library-call times (CUDA events), the roofline bound, and for every
     (model, quant, backend) latency, throughput, peak device memory and
     resident weight bytes;
  6. one JSON line {"kernels": [...]}, then the last line
     {"ok": true, "device": {...}}.

Needs one CUDA card and the CUDA toolkit (nvcc) and Triton; it exits
non-zero without a result on a machine without a card.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores, and
# device memory bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

GEMM_RTOL = 1e-4     # max |kernel - plain| / max |plain|
SOFTMAX_ATOL = 1e-6  # max |kernel - plain|
E2E_RTOL, E2E_ATOL = 1e-3, 1e-5      # probabilities, KERNELS vs TORCH
LOGIT_RTOL = 1e-4                    # max |Δlogit| / max |logit|
REQUESTS, BATCH = 5, 64


def log(*args):
    print(*args, flush=True)


def eager_ms(torch, fn, iters):
    """Milliseconds per call of ``fn`` issued eagerly from Python, from CUDA
    events around ``iters`` calls after warm-up.  For a short kernel this is
    the host's issue rate (wrapper checks, ctypes, launch), not the
    kernel's duration."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters):
    """Device milliseconds per call of ``fn``: ``iters`` calls captured in
    one CUDA graph and replayed between two CUDA events, so the host's
    issue cost is out of the measurement."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def gemm_bytes(m, k, n, int8):
    """Bytes a fused_gemm launch of the main path must move: A, B (int8 or
    f32), the bias (and the int8 variant's scale) read once, C written once."""
    if int8:
        return 4.0 * m * k + k * n + 4.0 * m * n + 8.0 * n
    return 4.0 * (m * k + k * n + n + m * n)


def resnet18_gemms(b):
    """(M, K, N, launches per forward) of ResNet-18's fused_gemm launches at
    batch b: the three 1×1/s2 projection shortcuts, then the 512 → 1000 FC."""
    return [(784 * b, 64, 128, 1), (196 * b, 128, 256, 1), (49 * b, 256, 512, 1),
            (b, 512, 1000, 1)]


def mobilenet_v2_gemms(b):
    """(M, K, N, launches per forward) of MobileNet-v2's fused_gemm launches
    at batch b: its 15 1×1 convs with co >= 128 and ci >= 64 (expand at
    14×14 and 7×7, project at 7×7, the 320 → 1280 head), then the
    1280 → 1000 FC."""
    return [(196 * b, 64, 384, 4), (196 * b, 96, 576, 3), (49 * b, 576, 160, 1),
            (49 * b, 160, 960, 3), (49 * b, 960, 160, 2), (49 * b, 960, 320, 1),
            (49 * b, 320, 1280, 1), (b, 1280, 1000, 1)]


GEMMS = {"resnet18": resnet18_gemms, "mobilenet_v2": mobilenet_v2_gemms}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: PyTorch sees no CUDA device", file=sys.stderr)
        return 2

    from pyopenvino_tpu_torch import IECore
    from pyopenvino_tpu_torch.config import Config, QuantMode
    from pyopenvino_tpu_torch.kernels import build
    from pyopenvino_tpu_torch.kernels.conv import conv2d_fused
    from pyopenvino_tpu_torch.kernels.gemm import fused_gemm, fused_gemm_plain
    from pyopenvino_tpu_torch.kernels.softmax import softmax_rows, softmax_rows_plain
    from pyopenvino_tpu_torch.models.synth import mobilenet_v2_paths, resnet18_paths

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # -- 1. environment ----------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    import triton

    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} triton "
        f"{triton.__version__} devices {torch.cuda.device_count()} "
        f"name {torch.cuda.get_device_name(0)}")

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    logs = build.build_all()
    log(f"build: nvcc {time.perf_counter() - t0:.2f} s for {sorted(logs)}")
    for src, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  {src}: {line.strip()}")
    t0 = time.perf_counter()
    softmax_rows(torch.zeros((1, 1000), device=dev))
    torch.cuda.synchronize()
    log(f"build: triton softmax_rows first launch {time.perf_counter() - t0:.2f} s")

    # -- 3. kernel checks ----------------------------------------------------
    rng = np.random.default_rng(0)

    def rand(shape, lo=None, hi=None):
        arr = (rng.standard_normal(shape) if lo is None
               else rng.uniform(lo, hi, shape)).astype(np.float32)
        return torch.from_numpy(arr).to(dev)

    def rand_int8(shape):
        return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8)).to(dev)

    errs = {"fused_gemm": 0.0, "fused_gemm_i8w": 0.0, "softmax_rows": 0.0}

    def check_gemm(name, a, b, scale, bias, act, what):
        got = fused_gemm(a, b, scale, bias, act)
        torch.cuda.synchronize()
        want = fused_gemm_plain(a, b, scale, bias, act)
        abs_err = (got - want).abs().max().item()
        rel = abs_err / max(want.abs().max().item(), 1e-30)
        log(f"check {name} {what}: max_abs_err {abs_err:.3e} max_rel_err {rel:.3e}")
        if rel > GEMM_RTOL:
            raise AssertionError(f"{name} disagrees at {what}: {rel}")
        errs[name] = max(errs[name], abs_err)

    path_shapes = sorted({(m, k, n) for b in (1, BATCH) for gemms in GEMMS.values()
                          for m, k, n, _ in gemms(b)})
    ragged = [(1000, 77, 130, True, True, ("relu", 0.0, 0.0)),
              (65, 33, 200, False, False, ("clamp", -0.5, 0.5)),
              (130, 70, 129, True, False, None), (3, 1, 5, False, True, None),
              (1, 77, 1000, True, True, None)]
    for m, k, n, use_scale, use_bias, act in (
            [(m, k, n, False, True, None) for m, k, n in path_shapes] + ragged):
        a, b = rand((m, k)), rand((k, n))
        scale = rand((n,), 0.5, 1.5) if use_scale else None
        bias = rand((n,)) if use_bias else None
        check_gemm("fused_gemm", a, b, scale, bias, act,
                   f"M={m} K={k} N={n} scale={use_scale} bias={use_bias} act={act}")
    # int8 B: every path shape with its scale and bias, then ragged K/N
    # (N % 4 != 0 takes the byte path) and a B that is not 4-byte aligned
    for m, k, n, use_bias, act in (
            [(m, k, n, True, None) for m, k, n in path_shapes]
            + [(1, 77, 1000, True, None), (64, 77, 1000, True, ("relu", 0.0, 0.0)),
               (130, 70, 129, False, None), (65, 33, 200, True, ("clamp", 0.0, 6.0)),
               (3, 1, 5, False, None)]):
        a, b = rand((m, k)), rand_int8((k, n))
        scale, bias = rand((n,), 0.001, 0.02), rand((n,)) if use_bias else None
        check_gemm("fused_gemm_i8w", a, b, scale, bias, act,
                   f"M={m} K={k} N={n} int8 bias={use_bias} act={act}")
    flat = rand_int8((96 * 1000 + 1,))
    b = flat[1:].view(96, 1000)
    check_gemm("fused_gemm_i8w", rand((37, 96)), b, rand((1000,), 0.001, 0.02),
               None, None, f"M=37 K=96 N=1000 int8 B at address % 4 == {b.data_ptr() % 4}")
    # strided rows (lda > K)
    big = rand((300, 96))
    check_gemm("fused_gemm", big[:, 7:77], rand((70, 129)), None, None,
               ("relu", 0, 0), "lda=96 K=70")
    check_gemm("fused_gemm_i8w", big[:, 7:77], rand_int8((70, 128)),
               rand((128,), 0.001, 0.02), None, None, "lda=96 K=70 int8")
    # the conv wrapper at a shortcut's shape, against cuDNN, f32 and int8
    x = rand((BATCH, 56, 56, 64))
    w, cb = rand((128, 64, 1, 1)), rand((128,))
    wq, ws = rand_int8((128, 64, 1, 1)), rand((128,), 0.001, 0.02)
    for what, got, wref in (
            ("f32", conv2d_fused(x, w, bias=cb, strides=(2, 2)), w),
            ("int8", conv2d_fused(x, wq, scale=ws, bias=cb, strides=(2, 2)),
             wq.float() * ws.reshape(-1, 1, 1, 1))):
        want = torch.nn.functional.conv2d(
            x.permute(0, 3, 1, 2), wref, cb, stride=2).permute(0, 2, 3, 1)
        rel = (got - want).abs().max().item() / want.abs().max().item()
        log(f"check conv2d_fused {what} 1x1/s2 x=(64,56,56,64) vs F.conv2d: "
            f"max_rel_err {rel:.3e}")
        if rel > GEMM_RTOL:
            raise AssertionError(f"conv2d_fused {what} disagrees with F.conv2d: {rel}")

    for m, n in [(1, 1000), (BATCH, 1000), (7, 129), (3, 1), (5, 4097)]:
        x = rand((m, n)) * 30
        got = softmax_rows(x)
        torch.cuda.synchronize()
        abs_err = (got - softmax_rows_plain(x)).abs().max().item()
        log(f"check softmax_rows M={m} N={n}: max_abs_err {abs_err:.3e}")
        if abs_err > SOFTMAX_ATOL:
            raise AssertionError(f"softmax_rows disagrees at {(m, n)}: {abs_err}")
        errs["softmax_rows"] = max(errs["softmax_rows"], abs_err)

    # -- 4. the main paths ---------------------------------------------------
    # images normalized to [0, 1)
    requests = [rng.uniform(0, 1, (1, 3, 224, 224)).astype(np.float32)
                for _ in range(REQUESTS)]
    batch = rng.uniform(0, 1, (BATCH, 3, 224, 224)).astype(np.float32)
    ie = IECore()
    networks = {}
    for model, paths in (("resnet18", resnet18_paths),
                         ("mobilenet_v2", mobilenet_v2_paths)):
        t0 = time.perf_counter()
        networks[model] = ie.read_network(*paths(seed=0))
        log(f"{model}: weights synthesized and read in {time.perf_counter() - t0:.2f} s")

    def counters():
        return {"fused_gemm": fused_gemm.launches,
                "fused_gemm_i8w": fused_gemm.launches_i8w,
                "softmax_rows": softmax_rows.launches}

    def reset_counters():
        fused_gemm.launches = fused_gemm.launches_i8w = softmax_rows.launches = 0

    launches = {name: 0 for name in errs}
    paths_run = {}
    for model, quant in (("resnet18", QuantMode.NONE), ("resnet18", QuantMode.INT8_WEIGHT),
                         ("mobilenet_v2", QuantMode.NONE),
                         ("mobilenet_v2", QuantMode.INT8_WEIGHT)):
        label = f"{model} {quant.value}"
        net = networks[model]
        exe = ie.load_network(net, "GPU", config=Config(quant=quant))
        exe.kernel_type = "pallas"
        compiled = exe.compiled()  # weights onto the card; launches nothing
        ref = ie.load_network(net, "GPU", config=Config(quant=quant))
        ref.kernel_type = "torch"
        matmul = next(n for n in net.model if n.op_type == "MatMul")
        logits_name = net.model.nodes[compiled._fusions[matmul.id].out_key[0]].name

        reset_counters()
        answers = [exe.infer({"data": r})["prob"] for r in requests]
        batch_answer = exe.infer_batch({"data": batch})["prob"]
        got_launches = counters()
        log(f"{label} main path: {REQUESTS} requests + infer_batch({BATCH}); "
            f"launches {got_launches}")
        per_forward = sum(c for _, _, _, c in GEMMS[model](1))
        gemm_name = "fused_gemm_i8w" if quant == QuantMode.INT8_WEIGHT else "fused_gemm"
        expected = {name: 0 for name in launches}
        expected[gemm_name] = per_forward * (REQUESTS + 1)
        expected["softmax_rows"] = REQUESTS + 1
        if got_launches != expected:
            raise AssertionError(
                f"{label}: kernel launches {got_launches}, expected {expected} "
                f"({per_forward} {gemm_name} + 1 softmax_rows per forward)")
        for name in launches:
            launches[name] += got_launches[name]

        for i, r in enumerate(requests):
            want = ref.infer({"data": r})["prob"]
            got = answers[i]
            if got.shape != (1, 1000) or not np.isfinite(got).all():
                raise AssertionError(f"{label} request {i}: bad output {got.shape}")
            np.testing.assert_allclose(got, want, rtol=E2E_RTOL, atol=E2E_ATOL)
            if got.argmax() != want.argmax():
                raise AssertionError(
                    f"{label} request {i}: top-1 {got.argmax()} != {want.argmax()}")
        want_batch = ref.infer_batch({"data": batch})["prob"]
        if batch_answer.shape != (BATCH, 1000) or not np.isfinite(batch_answer).all():
            raise AssertionError(f"{label} infer_batch: bad output {batch_answer.shape}")
        np.testing.assert_allclose(batch_answer, want_batch, rtol=E2E_RTOL, atol=E2E_ATOL)
        if (batch_answer.argmax(1) != want_batch.argmax(1)).any():
            raise AssertionError(f"{label} infer_batch: top-1 differs from the TORCH backend")
        sums = batch_answer.sum(axis=1)
        if np.abs(sums - 1).max() > 1e-4:
            raise AssertionError(
                f"{label}: probabilities do not sum to 1: {sums.min()}..{sums.max()}")
        # the rows of one batch agree with the same images sent one at a time
        single = exe.infer({"data": batch[:1]})["prob"]
        np.testing.assert_allclose(single[0], batch_answer[0], rtol=E2E_RTOL, atol=E2E_ATOL)
        _, got_logits = compiled.infer_with_capture({"data": requests[0]}, [logits_name])
        _, want_logits = ref.compiled().infer_with_capture({"data": requests[0]}, [logits_name])
        gl, wl = got_logits[logits_name], want_logits[logits_name]
        logit_err = np.abs(gl - wl).max() / np.abs(wl).max()
        prob_err = float(np.abs(batch_answer - want_batch).max())
        log(f"{label} KERNELS vs TORCH: logits ({logits_name}) max_rel_err "
            f"{logit_err:.3e} (|logit| max {np.abs(wl).max():.3f}); probabilities "
            f"max_abs_err {prob_err:.3e}; top-1 identical on {REQUESTS + BATCH} "
            f"images (top-1 of request 0: {int(answers[0].argmax())})")
        if logit_err > LOGIT_RTOL:
            raise AssertionError(f"{label}: logits disagree: {logit_err}")
        paths_run[label] = (exe, ref)

    # -- 5. times ------------------------------------------------------------
    per_shape = {name: [] for name in launches}

    def timings(kernel, plain, library, iters):
        return {"ms": device_ms(torch, kernel, iters),
                "plain_ms": device_ms(torch, plain, iters),
                "library_ms": device_ms(torch, library, iters),
                "eager_ms": eager_ms(torch, kernel, 10 * iters)}

    for b in (1, BATCH):
        for model, gemms in GEMMS.items():
            for m, k, n, count in gemms(b):
                a, bias = rand((m, k)), rand((n,))
                w = rand((k, n))
                wq, scale = rand_int8((k, n)), rand((n,), 0.001, 0.02)
                # no single PyTorch call takes f32 x int8: the yardstick is
                # addmm on the weight dequantized here, outside the timing
                w_deq = wq.float() * scale
                for name, kernel, plain, library in (
                        ("fused_gemm", lambda: fused_gemm(a, w, bias=bias),
                         lambda: fused_gemm_plain(a, w, bias=bias),
                         lambda: torch.addmm(bias, a, w)),
                        ("fused_gemm_i8w", lambda: fused_gemm(a, wq, scale, bias),
                         lambda: fused_gemm_plain(a, wq, scale, bias),
                         lambda: torch.addmm(bias, a, w_deq))):
                    bms, by = bound(2.0 * m * n * k,
                                    gemm_bytes(m, k, n, name == "fused_gemm_i8w"))
                    row = {"model": model, "batch": b, "M": m, "K": k, "N": n,
                           **timings(kernel, plain, library, 20),
                           "bound_ms": bms, "bound_by": by,
                           "launches_per_forward": count}
                    row["share_of_bound"] = bms / row["ms"]
                    per_shape[name].append(row)
                    log(f"time {name} " + json.dumps(row))
        x = rand((b, 1000)) * 30
        bms, by = bound(5.0 * b * 1000, 8.0 * b * 1000)
        for model in GEMMS:
            row = {"model": model, "batch": b, "M": b, "N": 1000, **timings(
                lambda: softmax_rows(x), lambda: softmax_rows_plain(x),
                lambda: torch.softmax(x, dim=1), 50),
                "bound_ms": bms, "bound_by": by, "launches_per_forward": 1}
            per_shape["softmax_rows"].append(row)
            log("time softmax_rows " + json.dumps(row))

    def e2e(target):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        target.infer({"data": requests[0]})
        lat = []
        for i in range(30):
            t = time.perf_counter()
            target.infer({"data": requests[i % REQUESTS]})
            lat.append((time.perf_counter() - t) * 1e3)
        target.infer_batch({"data": batch})
        thr = []
        for _ in range(5):
            t = time.perf_counter()
            target.infer_batch({"data": batch})
            thr.append(time.perf_counter() - t)
        compiled = target.compiled()
        return {"latency_b1_ms_median": statistics.median(lat),
                "latency_b1_ms_p90": sorted(lat)[int(0.9 * len(lat)) - 1],
                "img_per_s_b64": BATCH / statistics.median(thr),
                "peak_mem_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
                "weight_bytes": sum(t.numel() * t.element_size()
                                    for t in compiled.weights.values()),
                "derived_weight_bytes": sum(t.numel() * t.element_size()
                                            for t in compiled._derived.values())}

    for label, (exe, ref) in paths_run.items():
        results = {}
        for name, target in (("kernels", exe), ("torch", ref), ("torch", ref),
                             ("kernels", exe)):
            results.setdefault(name, []).append(e2e(target))
        for name, runs in results.items():
            for r in runs:
                log(f"e2e {label} {name} " + json.dumps(r))

    # -- 6. kernels line -----------------------------------------------------
    def entry(name, route, source, replaces):
        rows = [r for r in per_shape[name] if r["batch"] == BATCH]
        total = lambda key: sum(r[key] * r["launches_per_forward"] for r in rows)  # noqa: E731
        return {
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": max(("bytes", "operations"), key=lambda by: sum(
                r["bound_ms"] * r["launches_per_forward"]
                for r in rows if r["bound_by"] == by)),
            "library_ms": total("library_ms"),
            "times_are": (f"sum over the launches of one batch-{BATCH} forward "
                          f"of each model ({', '.join(GEMMS)})"),
            "shapes": per_shape[name],
        }

    gemm_src = "pyopenvino_tpu_torch/csrc/fused_gemm.cu"
    log(json.dumps({"kernels": [
        entry("fused_gemm", "cuda", gemm_src, "pyopenvino_tpu/kernels/gemm.py:141"),
        {**entry("fused_gemm_i8w", "cuda", gemm_src, "pyopenvino_tpu/kernels/gemm.py:141"),
         "library_is": "torch.addmm on the weight dequantized beforehand, outside "
                       "the timing: no single PyTorch call takes f32 x int8"},
        entry("softmax_rows", "triton", "pyopenvino_tpu_torch/kernels/softmax.py",
              "pyopenvino_tpu/kernels/softmax.py:44"),
    ]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main())
