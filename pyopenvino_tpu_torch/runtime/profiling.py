"""Where a forward's time goes on the card: device time by kind of kernel,
and the device's busy share of the host-clock time.

The port's counterpart of ``pyopenvino_tpu/runtime/profiling.py``, built on
``torch.profiler``: every device activity (kernels and copies) inside the
window is summed by category, and the busy share is that sum over the
window's host-clock time (one stream, so activities do not overlap).

    python -m pyopenvino_tpu_torch.runtime.profiling [MODEL ...]

profiles ResNet-18 and MobileNet-v2 (synthesized weights, seed 0), SSD-
MobileNet-v1 (assets/trained/ssd_shapes_ms, its trained weights, seeded
images of shapes from models/shapes.py, tools/accuracy.py's settings),
EfficientNet-B0 (models/efficientnet_b0.py's weights, seed 0),
googlenet_shapes (assets/trained, trained weights, bias correction under
INT8-FULL as tools/accuracy.py runs it), ShuffleNet-v2
(models/shufflenet_v2.py's weights, seed 0) and resnet18_pot (models/pot.py,
the POT-quantized ResNet-18: FakeQuantize emulated in FP32 and INT8
weight-only, INT8-FULL with the IR's activation scales and no samples), the
last four on seeded images in [0, 255), and U-Net, ViT-tiny, MoE-MLP,
lstm-tiny, yolo-tiny, ocr-ti and yolo-v2 (their generators' weights,
models/*.py, on seeded
inputs of their Parameter's shape in [0, 255)), each in FP32, INT8
weight-only and INT8-FULL (calibrated on 4 seeded inputs, except
resnet18_pot), at batch 1 (``infer``) and batch 64 (``infer_batch``) on
both backends, STEPS calls each after one warm-up (PER_EXAMPLE_STEPS for
the batch of a network that answers it one example at a time), and prints
one JSON line per case; every model also with ``compute_dtype="bfloat16"``; then
``resnet18_headline``, bench.py's configuration (u8 ingress through
PrePostProcessor, INT8-FULL, bfloat16) on KERNELS at batch 1 and 512;
before them kernels 3f, 4 and their bfloat16 variants, which no path
launches, alone (``off_path_kernels``).  Named MODELs (resnet18,
mobilenet_v2, ssd_shapes_ms, efficientnet_b0, googlenet_shapes,
shufflenet_v2, resnet18_pot, unet, vit_tiny, moe_mlp, lstm_tiny, yolo_tiny,
ocr_ti, yolo_v2, resnet18_headline) profile only those, and only their weights are made, so
that one call can profile a few of them.  Needs a CUDA card.

A kernel that writes bfloat16 is filed under its variant's name
(``fused_gemm_bf16``, ``fused_gemm_bf16_i8w``, ``fused_gemm_i8i8_bf16``,
``conv2d_direct_bf16``, ``conv2d_direct_float_bf16``,
``dw_pw_fused_bf16``), from the template arguments in its name;
Triton's softmax has one name for both dtypes, so ``softmax_rows`` holds
both, and ``splitk_reduce`` every loop's reduction.

Per node: ``CompiledNetwork.profile`` runs one forward with each node's
emit inside a profiler range named ``"<OpType>_<node id>"`` (the JAX
package's named scope, ``pyopenvino_tpu/runtime/profiling.py``), and
``node_rows`` turns the profiler's events into rows {node, category,
self_us, occurrences, kernel}: on a CUDA network each device activity
(kernel or copy) is credited, through the profiler's correlation of the
activity with the host event that launched it, to the innermost node range
around that event, not by timestamps (on one stream a kernel runs after
its range has closed); on a CPU network each top-level aten operator's
host time is.  A split-K reduction and the (de)quantization that a node's
emit issues fall in its range; the input and output copies fall in none
and are ``node`` None, ``"(unattributed)"`` in ``aggregate``.
``aggregate(rows, by="category"|"node")`` and ``format_table`` are the
JAX module's.
"""

from __future__ import annotations

import json
import re
import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

STEPS = 10
# steps of a batch that a network answers one example at a time (MoE-MLP,
# ocr-ti, yolo-v2: 64 forwards, tens of thousands of device activities)
PER_EXAMPLE_STEPS = 2

# (category, substrings of the device activity's name), first match wins
CATEGORIES = (
    # csrc/dw_pw.cu's kernel (#4), before anything whose names its own could
    # hold; csrc/f32_mma.cuh's kernel with conv_direct.cu's ConvAF32 loader
    # (3f, either weight type), before the same kernel's B sides below; the
    # bf16 loop with conv_direct.cu's ConvABf16 loader and i8_wgmma.cuh's
    # kernel with its ConvABf16Im2col and ConvABf16Im2colI8w loaders
    # (3f-bf16, both loops), before those loops' B sides (#1bw, #1b) and
    # #3's ConvAIm2col, each with the wgmma loop's kernel for
    # the same B type (csrc/bf16_wgmma.cuh: "gemm" in its name, so before
    # the library's category);
    # csrc/i8_mma.cuh's kernel with conv_direct.cu's ConvA loader and
    # csrc/i8_wgmma.cuh's with its ConvAIm2col one (#3), then i8_mma.cuh's
    # with the row-major loader and i8_wgmma.cuh's with its TiledA one
    # (#1ii; "gemm" is in neither name); csrc/f32_mma.cuh's kernel and
    # csrc/f32_wgmma.cuh's with an int8 B (#1w) and a float32 B (#1), each
    # B side by its namespace and name alone, whatever template argument
    # follows it; the tensor-core loops' split-K reductions, which their
    # names do not tell apart
    ("dw_pw_fused", ("dw_pw_kernel",)),
    ("conv2d_direct_f32", ("ConvAF32",)),
    ("conv2d_direct_float_bf16", ("ConvABf16",)),
    ("fused_gemm_bf16_i8w", ("bf16mma::BInt8", "bf16wgmma::BandInt8")),
    ("fused_gemm_bf16", ("bf16_mma_kernel", "bf16_wgmma_kernel")),
    ("conv2d_direct", ("ConvA,", "ConvA>", "ConvAIm2col")),
    ("fused_gemm_i8i8", ("i8i8_mma_kernel", "i8wgmma::TiledA")),
    ("fused_gemm_i8w", ("f32mma::BInt8", "f32wgmma::BInt8")),
    ("fused_gemm", ("f32mma::BFloat", "f32wgmma::BFloat")),
    ("splitk_reduce", ("splitk_reduce",)),
    ("softmax_rows", ("softmax_rows",)),
    ("copy", ("Memcpy", "Memset")),
    ("pool", ("pool",)),
    # cuDNN convolutions and cuBLAS products (the TORCH backend's FC)
    ("conv_and_library_gemm", ("conv", "cudnn", "xmma", "sm90", "sm80",
                               "gemm", "gemv", "implicit")),
    ("softmax_library", ("softmax",)),
    ("elementwise", ("elementwise", "vectorized", "copy_kernel", "reduce")),
)


# the int8 loops' categories whose kernel writes bfloat16 under a name of
# its own (i8_mma.cuh's, i8_wgmma.cuh's and dw_pw.cu's OutT template
# argument)
BF16_OUT = ("conv2d_direct", "fused_gemm_i8i8", "dw_pw_fused")


def categorize(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k.lower() in low for k in keys):
            return cat + "_bf16" if cat in BF16_OUT and "bfloat16" in low else cat
    return "other"


# the range of a node's emit (CompiledNetwork.profile) and, searched in a
# framework op name, the JAX package's named scope
_RANGE_RE = re.compile(r"^[A-Za-z][A-Za-z0-9]*_\d+$")
_SCOPE_RE = re.compile(r"([A-Za-z]+)_(\d+)")


def _node_of(event) -> Optional[str]:
    """The innermost node range around a host event (itself included)."""
    while event is not None:
        if _RANGE_RE.match(event.name):
            return event.name
        event = event.cpu_parent
    return None


def node_rows(events, cuda: bool) -> List[Dict]:
    """Rows {node, category, self_us, occurrences, kernel} of a profiler's
    events (``prof.events()``), one per (node range, activity name).
    ``cuda``: the device activities, each credited through the profiler's
    correlation to the host event that launched it (its ``kernels``), once
    where two host events share a correlation id; else the host time of
    each aten operator that no other operator encloses."""
    from torch.autograd import DeviceType

    groups: Dict[tuple, List[float]] = defaultdict(lambda: [0.0, 0])
    host = [e for e in events if e.device_type == DeviceType.CPU]
    ranges = {e.name for e in host if _RANGE_RE.match(e.name)}
    credits = []  # (node, [(activity name, µs)])
    if cuda:
        # the profiler appends a device activity to every host event whose
        # id is the activity's correlation id: the operator or node range
        # that launched it, and any other host event that carries the same
        # number in another numbering (a CUDA API call, the profiler's own
        # "Activity Buffer Request" on an H100): only operators ("aten::")
        # and ranges launch, and an id that two of them still share counts
        # once, for the node they agree on
        by_id = defaultdict(list)
        for e in host:
            if e.kernels and (_RANGE_RE.match(e.name) or "::" in e.name):
                by_id[e.id].append(e)
        for evs in by_id.values():
            nodes = {_node_of(e) for e in evs}
            # a range's own span on the device timeline (kineto's
            # gpu_user_annotation) is no activity of its own
            credits.append((nodes.pop() if len(nodes) == 1 else None,
                            [(k.name, k.duration) for k in evs[0].kernels
                             if not _RANGE_RE.match(k.name)]))
    else:
        credits = [(_node_of(e), [(e.name, e.cpu_time_total)]) for e in host
                   if not _RANGE_RE.match(e.name)
                   and (e.cpu_parent is None or _RANGE_RE.match(e.cpu_parent.name))]
    for node, acts in credits:
        for name, us in acts:
            g = groups[node, name]
            g[0] += float(us)
            g[1] += 1
    rows = [{"node": node, "category": categorize(name), "self_us": us,
             "occurrences": n, "kernel": name}
            for (node, name), (us, n) in groups.items()]
    # a node whose range ran but launched nothing (a view, a shape)
    credited = {node for node, _ in groups}
    rows += [{"node": node, "category": "host_only", "self_us": 0.0, "occurrences": 0,
              "kernel": ""} for node in sorted(ranges - credited)]
    return rows


# the port's own kernels (csrc/, kernels/softmax.py), each with its bf16
# variant, but the split-K reduction: what ``exec_types`` names first
_OURS = [cat for cat, _ in CATEGORIES]
PORT_KERNELS = (set(_OURS[:_OURS.index("splitk_reduce")]) | {"softmax_rows"}
                | {cat + "_bf16" for cat in BF16_OUT})


def exec_types(rows: List[Dict]) -> Dict[str, tuple]:
    """{node: (exec_type, its time in µs)} of ``node_rows``' rows:
    exec_type is the port's kernel that took the node's most time
    (quantization and split-K reductions beside it aside), else the
    longest library kernel's or operator's name, ``host_only`` where the
    node launched nothing."""
    out: Dict[str, tuple] = {}
    for node in {r["node"] for r in rows if r["node"] is not None}:
        mine = [r for r in rows if r["node"] == node]
        ours = [r for r in mine if r["category"] in PORT_KERNELS]
        top = max(ours or mine, key=lambda r: r["self_us"])
        name = top["category"] if top["category"] in PORT_KERNELS | {"host_only"} else top["kernel"]
        out[node] = (name, round(sum(r["self_us"] for r in mine), 2))
    return out


def device_us(events) -> float:
    """The device activities' total time in a profiler's events (kernels
    and copies; the device-side spans of the node ranges left out)."""
    from torch.autograd import DeviceType

    return sum(e.time_range.elapsed_us() for e in events
               if e.device_type == DeviceType.CUDA and not _RANGE_RE.match(e.name))


def node_scope(row: Dict) -> Optional[str]:
    """The row's node, ``"<OpType>_<id>"``: the port's ``node`` field, or
    the named scope in a JAX row's framework op name."""
    if "node" in row:
        return row["node"]
    m = _SCOPE_RE.search(row.get("framework_op") or "")
    return m.group(0) if m else None


def aggregate(rows: List[Dict], by: str = "category") -> List[Dict]:
    """Rows summed by ``"category"`` or ``"node"`` (time outside every node
    range under ``"(unattributed)"``), in descending self time, each with
    its percent of the total, its occurrences and its dominant
    ``bound_by`` (a JAX row's; the port's rows have none) and ``kernel``
    (a port row's longest activity)."""
    groups: Dict[str, Dict] = defaultdict(
        lambda: {"self_us": 0.0, "occurrences": 0, "rows": 0})
    for row in rows:
        key = row.get("category") if by == "category" else node_scope(row)
        if key is None:
            key = "(unattributed)"
        g = groups[key]
        us = float(row.get("self_us") or 0.0)
        g["self_us"] += us
        g["occurrences"] += int(row.get("occurrences") or 0)
        g["rows"] += 1
        for field in ("bound_by", "kernel"):
            if row.get(field):
                g.setdefault(field, defaultdict(float))[row[field]] += us
    total = sum(g["self_us"] for g in groups.values()) or 1.0
    out = []
    for key, g in sorted(groups.items(), key=lambda kv: -kv[1]["self_us"]):
        out.append({
            by: key,
            "self_us": round(g["self_us"], 2),
            "pct": round(100.0 * g["self_us"] / total, 2),
            "occurrences": g["occurrences"],
            **{field: (max(g[field].items(), key=lambda kv: kv[1])[0] if field in g else "")
               for field in ("bound_by", "kernel")},
        })
    return out


def format_table(agg_rows: List[Dict], by: str = "category") -> str:
    lines = [f"{by:<36} {'self µs':>12} {'%':>7} {'occurs':>8}  bound by"]
    for r in agg_rows:
        lines.append(
            f"{str(r[by]):<36} {r['self_us']:>12.1f} {r['pct']:>7.2f} "
            f"{r['occurrences']:>8}  {r.get('bound_by', '')}")
    return "\n".join(lines)


def device_profile(fn: Callable[[], object], steps: int = STEPS) -> Dict[str, object]:
    """Profile ``steps`` calls of ``fn`` (after one warm-up call).  Returns
    host milliseconds per step, device-busy milliseconds per step, the busy
    share, the device activities (kernel launches and copies) per step,
    device milliseconds per step by category, and the five longest
    activities."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_cat: Dict[str, float] = {}
    by_name: Dict[str, float] = {}
    activities = 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        activities += 1
        us = e.time_range.elapsed_us()
        by_cat[categorize(e.name)] = by_cat.get(categorize(e.name), 0.0) + us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    busy_ms = sum(by_cat.values()) / 1e3
    if busy_ms == 0.0:
        raise RuntimeError("the profiler recorded no device activity")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {
        "steps": steps,
        "host_ms_per_step": wall_ms / steps,
        "device_busy_ms_per_step": busy_ms / steps,
        "device_busy_share": busy_ms / wall_ms,
        "device_activities_per_step": activities / steps,
        "device_ms_per_step_by_category": {
            k: v / 1e3 / steps for k, v in sorted(by_cat.items(), key=lambda kv: -kv[1])},
        "top_activities_ms_per_step": [(n[:80], us / 1e3 / steps) for n, us in top],
    }


def off_path_kernels():
    """Kernels 3f and 3f-bf16 (each with a float and an int8 weight), 4 and
    4-bf16 (a bfloat16 output), which no path launches, each profiled alone
    at batch 64 at a ResNet-18 and an SSD-MobileNet-v1 shape: one JSON line
    each, and an error unless the category named after the kernel takes the
    most device time."""
    from pyopenvino_tpu_torch.kernels.conv_direct import conv2d_direct
    from pyopenvino_tpu_torch.kernels.dw_pw import dw_pw_fused
    from pyopenvino_tpu_torch.tools.microbench_dw_pw import make_inputs

    rng = np.random.default_rng(0)

    def rand(shape, lo=-1.0, hi=1.0):
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32)).cuda()

    x, bias, pads = rand((64, 28, 28, 128)), rand((128,)), ((1, 1), (1, 1))
    w = rand((128, 128, 3, 3))
    wq = torch.from_numpy(rng.integers(-127, 128, (128, 128, 3, 3), dtype=np.int8)).cuda()
    scale = rand((128,), 1e-3, 1e-2)
    xb, wb = x.bfloat16(), w.bfloat16()
    args = make_inputs(64, 19, 19, 128, 128)
    for name, weight, call in (
            ("conv2d_direct_f32", "float32", lambda: conv2d_direct(x, w, None, bias, None, pads)),
            ("conv2d_direct_f32", "int8", lambda: conv2d_direct(x, wq, scale, bias, None, pads)),
            ("conv2d_direct_float_bf16", "bfloat16",
             lambda: conv2d_direct(xb, wb, None, bias, None, pads)),
            ("conv2d_direct_float_bf16", "int8",
             lambda: conv2d_direct(xb, wq, scale, bias, None, pads)),
            ("dw_pw_fused", "int8", lambda: dw_pw_fused(*args, s_mid=0.05, s_out=0.04)),
            ("dw_pw_fused_bf16", "int8", lambda: dw_pw_fused(
                *args, s_mid=0.05, out_dtype=torch.bfloat16))):
        row = {"kernel": name, "weight": weight, "batch": 64,
               "card": torch.cuda.get_device_name(0), **device_profile(call)}
        print(json.dumps(row), flush=True)
        by_cat = row["device_ms_per_step_by_category"]
        if max(by_cat, key=by_cat.get) != name:
            raise AssertionError(f"{name}'s device time was filed elsewhere: {by_cat}")


def main(argv=None):
    if not torch.cuda.is_available():
        raise SystemExit("profiling needs a CUDA card")
    only = set(sys.argv[1:] if argv is None else argv)

    off_path_kernels()

    from pyopenvino_tpu_torch import IECore
    from pyopenvino_tpu_torch.config import Config, QuantMode
    from pyopenvino_tpu_torch.models.efficientnet_b0 import efficientnet_b0_paths
    from pyopenvino_tpu_torch.models.lstm_tiny import lstm_tiny_paths
    from pyopenvino_tpu_torch.models.moe_mlp import moe_mlp_paths
    from pyopenvino_tpu_torch.models.ocr_ti import ocr_ti_paths
    from pyopenvino_tpu_torch.models.pot import resnet18_pot_paths
    from pyopenvino_tpu_torch.models.shapes import shapes_det300
    from pyopenvino_tpu_torch.models.shufflenet_v2 import shufflenet_v2_paths
    from pyopenvino_tpu_torch.models.synth import mobilenet_v2_paths, resnet18_paths
    from pyopenvino_tpu_torch.models.unet import unet_paths
    from pyopenvino_tpu_torch.models.vit_tiny import vit_tiny_paths
    from pyopenvino_tpu_torch.models.yolo_tiny import yolo_tiny_paths
    from pyopenvino_tpu_torch.models.yolo_v2 import yolo_v2_paths

    families = {"unet": unet_paths, "vit_tiny": vit_tiny_paths, "moe_mlp": moe_mlp_paths,
                "lstm_tiny": lstm_tiny_paths, "yolo_tiny": yolo_tiny_paths,
                "ocr_ti": ocr_ti_paths, "yolo_v2": yolo_v2_paths}
    ie = IECore()
    rng = np.random.default_rng(0)
    classifier = ("data", rng.uniform(0, 1, (65, 3, 224, 224)).astype(np.float32),
                  rng.uniform(0, 1, (4, 3, 224, 224)).astype(np.float32), {})
    images255 = ("data", rng.uniform(0, 255, (65, 3, 224, 224)).astype(np.float32),
                 rng.uniform(0, 255, (4, 3, 224, 224)).astype(np.float32), {})
    trained = Path(__file__).resolve().parents[2] / "assets" / "trained"
    ssd = ("image_tensor", shapes_det300(65, seed=0)[0], shapes_det300(4, seed=1)[0],
           {"quant_min_elems": 4096})
    def trained_ir(name):
        return lambda seed: (str(trained / f"{name}.xml"), str(trained / f"{name}.bin"))

    def profile_row(label, exe, name, one, batch, **extra):
        per_example = exe.compiled()._batched_plan(len(batch)) is None
        for b, call, steps in (
                (1, lambda: exe.infer({name: one}), STEPS),
                (len(batch), lambda: exe.infer_batch({name: batch}),
                 PER_EXAMPLE_STEPS if per_example else STEPS)):
            row = {**label, "batch": b, "card": torch.cuda.get_device_name(0),
                   **extra, **device_profile(call, steps)}
            print(json.dumps(row), flush=True)

    def profile_model(model, net, name, images, cal, extra):
        one, batch = images[:1], images[1:]
        calibration = [{name: cal[i:i + 1]} for i in range(len(cal))]
        dtypes = ("float32", "bfloat16")
        for quant, dtype in ((q, d) for q in (QuantMode.NONE, QuantMode.INT8_WEIGHT,
                                              QuantMode.INT8_FULL) for d in dtypes):
            int8full = quant == QuantMode.INT8_FULL
            for kernel_type in ("kernels", "torch"):
                exe = ie.load_network(net, "GPU", config=Config(
                    quant=quant, bias_correction=int8full and model in (
                        "ssd_shapes_ms", "googlenet_shapes"),
                    compute_dtype=dtype, **extra))
                exe.kernel_type = kernel_type
                if int8full and model != "resnet18_pot":  # its scales are in the IR
                    exe.set_calibration(calibration)
                profile_row({"model": model, "quant": quant.value, "backend": kernel_type},
                            exe, name, one, batch,
                            **({"compute_dtype": dtype} if dtype != "float32" else {}))

    for model, paths, spec in (
            ("resnet18", resnet18_paths, classifier),
            ("mobilenet_v2", mobilenet_v2_paths, classifier),
            ("ssd_shapes_ms", trained_ir("ssd_shapes_ms"), ssd),
            ("efficientnet_b0", efficientnet_b0_paths, images255),
            ("googlenet_shapes", trained_ir("googlenet_shapes"), images255),
            ("shufflenet_v2", shufflenet_v2_paths, images255),
            ("resnet18_pot", resnet18_pot_paths, images255)):
        if not only or model in only:
            # weights synthesized (or the POT IR built) on first use
            profile_model(model, ie.read_network(*paths(seed=0)), *spec)
    for model, paths in families.items():
        if not only or model in only:
            net = ie.read_network(*paths())  # the generator's seed
            param = net.model.parameters[0]
            shape = param.outputs[param.out_port].shape[1:]
            profile_model(model, net, param.name,
                          rng.uniform(0, 255, (65, *shape)).astype(np.float32),
                          rng.uniform(0, 255, (4, *shape)).astype(np.float32), {})

    if not only or "resnet18_headline" in only:
        from pyopenvino_tpu_torch import PrePostProcessor

        ppp = PrePostProcessor(ie.read_network(*resnet18_paths(seed=0)))
        ppp.input().tensor().set_element_type("u8")
        exe = ie.load_network(ppp.build(), "GPU", config=Config(
            quant=QuantMode.INT8_FULL, compute_dtype="bfloat16"))
        exe.kernel_type = "kernels"
        u8 = rng.integers(0, 256, (517, 3, 224, 224), dtype=np.uint8)
        exe.set_calibration([{"data": u8[i:i + 1]} for i in range(513, 517)])
        profile_row({"model": "resnet18_headline", "quant": "int8", "backend": "kernels"},
                    exe, "data", u8[:1], u8[1:513], compute_dtype="bfloat16", ingress="u8")


if __name__ == "__main__":
    main()
