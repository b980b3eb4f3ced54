"""Multi-process worker: one rank of a group that runs a network data
parallel (DP, DP × TP, EP), with a data row's tensor, expert or spatial
group across the processes, or pipelined across them.

    python -m pyopenvino_tpu_torch.tools.mp_worker PID NPROC ADDRESS MODEL BATCH_PER_PROC \\
        REF_NPZ [--tp] [--model M] [--spatial S] [--b1] [--pipeline] [--bench N] \\
        [--save NPZ] [--next MODEL BATCH_PER_PROC REF_NPZ ...] --device cpu|cuda [--threads N]

The port's copy of ``tools/mp_worker.py``.  Started NPROC times, once a rank
(``launch`` starts them and waits), each process joins the gloo group at
ADDRESS (``host:port``, or a ``file://`` store) with ``LOCAL_DEVICES``
local devices, ``--device`` repeated (two logical shards of the one card,
or of the CPU), and runs each job in turn: MODEL (an in-repo ``.xml``, the
weights beside it or a shipped family's synthesized ones; or a sharded
``.ovpt`` artifact, imported onto the job's mesh), BATCH_PER_PROC rows a
process, REF_NPZ the job's reference file (``write_reference``):

  * default: a (data = NPROC·2/(M·S), model = M, spatial = S) mesh over the
    group's devices, process-major, with ``tensor_parallel`` where M > 1
    (EP on an expert stack) and ``spatial_parallel`` where S > 1; M and S
    are 1 unless ``--model`` / ``--spatial`` say otherwise, and ``--tp`` is
    ``--model 2``.  Each rank feeds the rows of the data rows it owns
    (``infer_batch_multiprocess``): where M·S is more than a rank's devices
    a row spans the ranks, and every owner feeds that row's rows and gets
    its full outputs.  It checks its rows of the reference outputs;
  * ``--b1``: the same mesh, but ``infer`` on the first of the rank's rows
    (batch 1, the sharded nodes across the row's processes), checked
    against the reference's batch-1 outputs where it holds them, else the
    first row of its outputs;
  * ``--pipeline``: a (data = 1, stage = NPROC·2) pipeline, the stage axis
    across the processes; every rank feeds the same full batch and checks
    the full output.

Each job checks its activation scales against the reference's (where it
holds them), then counts the kernels' launches over its checked call and
``--bench`` N timed calls (their median, host clock, numpy in and out,
after a barrier) and, apart for the checked call and the timed ones, the
exchanges on its rows' groups (``distributed.exchanges``: all-gathers and
halo hand-offs, their bytes and host seconds), writes its checked
outputs to ``--save`` (``{pid}`` in the name becomes the rank), and prints
``MP_JOB {...}``; the worker then prints ``MP_OK <pid>``.  Any failure
exits non-zero.
"""

from __future__ import annotations

import importlib
import json
import os
import statistics
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

# local devices a process: ``--device`` repeated (the JAX worker's two
# forced host devices)
LOCAL_DEVICES = 2
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# the shipped families whose weights are synthesized into build/models
_SYNTH = {"resnet18": "synth", "mobilenet_v2": "synth"}


def write_reference(path: str, inputs: Dict[str, np.ndarray], outputs: Dict[str, np.ndarray],
                    config=None, calibration: Optional[Sequence[dict]] = None, u8: bool = False,
                    act_scales: Optional[Dict[int, float]] = None, gate: str = "close",
                    rtol: float = 1e-4, atol: float = 1e-5,
                    b1_outputs: Optional[Dict[str, np.ndarray]] = None) -> None:
    """A job's reference file: the global batch (``inputs``), its outputs,
    the ``Config`` (default ``Config()``), calibration samples, whether the
    input goes through a u8 ``PrePostProcessor``, the activation scales the
    job must arrive at, the gate: ``"exact"`` (the same bits), ``"close"``
    (rtol, atol) or ``"probability"`` (rtol, atol and the same top-1), and
    the outputs of ``infer`` on the batch's first row (``b1_outputs``)."""
    from pyopenvino_tpu_torch.runtime.export import _config_meta

    arrays = {f"in.{k}": v for k, v in inputs.items()}
    arrays.update({f"out.{k}": v for k, v in outputs.items()})
    arrays.update({f"out1.{k}": v for k, v in (b1_outputs or {}).items()})
    for i, sample in enumerate(calibration or ()):
        arrays.update({f"calibration.{i}.{k}": v for k, v in sample.items()})
    if act_scales is not None:
        ids = sorted(act_scales)
        arrays["act_scales"] = np.array([ids, [act_scales[i] for i in ids]], np.float64)
    arrays["meta"] = np.array(json.dumps({
        "config": None if config is None else _config_meta(config), "u8": u8,
        "gate": gate, "rtol": rtol, "atol": atol}))
    np.savez(path, **arrays)


def model_files(xml: str):
    """(xml, bin) of MODEL: the ``.bin`` beside it, or a shipped family's
    (``pyopenvino_tpu_torch/models/<name>.xml``) synthesized weights."""
    weights = os.path.splitext(xml)[0] + ".bin"
    if os.path.exists(weights):
        return xml, weights
    name = os.path.splitext(os.path.basename(xml))[0]
    module = importlib.import_module(f"pyopenvino_tpu_torch.models.{_SYNTH.get(name, name)}")
    paths = getattr(module, f"{name}_paths")()
    if not os.path.samefile(paths[0], xml):
        raise FileNotFoundError(f"{xml}: no weights beside it and not a shipped family")
    return paths


def _reference(path: str) -> dict:
    from pyopenvino_tpu_torch.config import Config
    from pyopenvino_tpu_torch.runtime.export import _config_from_meta

    with np.load(path) as f:
        arrays = {k: f[k] for k in f.files}
    meta = json.loads(str(arrays.pop("meta")))
    samples: Dict[int, dict] = {}
    for key in [k for k in arrays if k.startswith("calibration.")]:
        _, i, name = key.split(".", 2)
        samples.setdefault(int(i), {})[name] = arrays.pop(key)
    scales = arrays.pop("act_scales", None)
    return {
        "config": Config() if meta["config"] is None else _config_from_meta(meta["config"]),
        "u8": meta["u8"], "gate": meta["gate"], "rtol": meta["rtol"], "atol": meta["atol"],
        "calibration": [samples[i] for i in sorted(samples)] or None,
        "act_scales": None if scales is None else {
            int(i): float(s) for i, s in zip(scales[0], scales[1])},
        "inputs": {k[3:]: v for k, v in arrays.items() if k.startswith("in.")},
        "outputs": {k[4:]: v for k, v in arrays.items() if k.startswith("out.")},
        "b1_outputs": {k[5:]: v for k, v in arrays.items() if k.startswith("out1.")},
    }


def _check(label, got, want, ref) -> dict:
    """The job's gate on its outputs; the largest difference."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"{label}: outputs {sorted(got)}, expected {sorted(want)}")
    err, equal = 0.0, True
    for k, w in want.items():
        g = got[k]
        if g.shape != w.shape or not np.isfinite(g).all():
            raise AssertionError(f"{label}: {k} {g.shape} (finite {np.isfinite(g).all()}), "
                                 f"expected {w.shape}")
        err = max(err, float(np.abs(g.astype(np.float64) - w.astype(np.float64)).max()))
        equal = equal and g.dtype == w.dtype and np.array_equal(g, w)
        if ref["gate"] == "exact":
            if not equal:
                raise AssertionError(f"{label}: {k} is not the reference's bits (max "
                                     f"difference {err:.3e})")
            continue
        np.testing.assert_allclose(g, w, rtol=ref["rtol"], atol=ref["atol"],
                                   err_msg=f"{label}: {k}")
        if ref["gate"] == "probability" and (g.argmax(-1) != w.argmax(-1)).any():
            raise AssertionError(f"{label}: {k}'s top-1 moved")
    return {"max_abs_err": err, "bit_equal": bool(equal)}


def _exchanges(handoffs) -> dict:
    """A pipelined call's exchanges with other processes by kind
    (``PipelinedNetwork.handoffs``): how many, their bytes, their host
    seconds."""
    out = {}
    for kind in ("send", "recv", "broadcast"):
        these = [h for h in handoffs if h["dir"] == kind]
        out[kind] = {"count": len(these), "bytes_each": sorted({h["bytes"] for h in these}),
                     "s": sum(h["s"] for h in these)}
    return out


def _flag(flags, name, default):
    return int(flags[flags.index(name) + 1]) if name in flags else default


def run_job(pid: int, nproc: int, job: List[str], local, prepared: dict) -> dict:
    """One job (module docstring); its ``MP_JOB`` record."""
    import torch.distributed as dist

    from pyopenvino_tpu_torch import IECore, PrePostProcessor
    from pyopenvino_tpu_torch.kernels import launch_counts, reset_launch_counts
    from pyopenvino_tpu_torch.parallel import (
        MeshConfig, build_mesh, build_pipeline_mesh, compile_pipelined, shard_compiled,
    )
    from pyopenvino_tpu_torch.parallel.distributed import (
        exchanges, infer_batch_multiprocess, reset_exchanges,
    )
    from pyopenvino_tpu_torch.parallel.mesh import local_rows
    from pyopenvino_tpu_torch.runtime.compiler import CompiledNetwork, prepare_model
    from pyopenvino_tpu_torch.runtime.export import import_compiled

    xml, batch_per, ref_path, *flags = job
    batch_per, pipeline, b1 = int(batch_per), "--pipeline" in flags, "--b1" in flags
    bench = _flag(flags, "--bench", 0)
    m = _flag(flags, "--model", 2 if "--tp" in flags else 1)
    sp = _flag(flags, "--spatial", 1)
    artifact = xml.endswith(".ovpt")
    t_job = time.perf_counter()
    ref = _reference(ref_path)
    if pipeline:
        label = "pp"
    else:
        data = nproc * LOCAL_DEVICES // (m * sp)
        label = "_".join(f"{axis}{n}" for axis, n in (("dp", data), ("tp", m), ("sp", sp))
                         if n > 1) + ("_b1" if b1 else "")
        label = f"import {label}" if artifact else label
    label = f"{os.path.basename(xml)} {label}"
    inputs, want = ref["inputs"], ref["outputs"]
    if pipeline:
        net = IECore().read_network(*model_files(xml))
        if ref["u8"]:
            ppp = PrePostProcessor(net)
            ppp.input().tensor().set_element_type("u8")
            net = ppp.build()
        runner = compile_pipelined(net.model, build_pipeline_mesh(nproc * LOCAL_DEVICES, data=1),
                                   ref["config"], calibration_samples=ref["calibration"])
        scales = next(s.act_scales for s in runner.stages if isinstance(s, CompiledNetwork))
        b_global = batch_per * nproc
        feed = {k: v[:b_global] for k, v in inputs.items()}
        want = {k: v[:b_global] for k, v in want.items()}
        call = lambda: runner.infer_batch(feed)  # noqa: E731
    else:
        cfg = MeshConfig(data=data, model=m, spatial=sp)
        if artifact:
            runner = import_compiled(xml, device=local[0], mesh=cfg).network
        else:
            key = (xml, ref_path)
            if key not in prepared:
                net = IECore().read_network(*model_files(xml))
                if ref["u8"]:
                    ppp = PrePostProcessor(net)
                    ppp.input().tensor().set_element_type("u8")
                    net = ppp.build()
                prepared[key] = prepare_model(net.model, ref["config"], ref["calibration"])
            model, quantized, act_scales, bias_corr = prepared[key]
            runner = CompiledNetwork(model, ref["config"], device=local[0], quantized=quantized,
                                     act_scales=act_scales, bias_corr=bias_corr)
            shard_compiled(runner, build_mesh(cfg), tensor_parallel=m > 1,
                           spatial_parallel=sp > 1)
        scales = runner.act_scales
        rows_here = local_rows(runner.mesh)
        per_row = batch_per // len(rows_here)
        idx = np.concatenate([np.arange(d * per_row, (d + 1) * per_row) for d in rows_here])
        feed = {k: v[idx] for k, v in inputs.items()}
        want = {k: v[idx] for k, v in want.items()}
        if b1:
            feed = {k: v[:1] for k, v in feed.items()}
            want = ref["b1_outputs"] or {k: v[:1] for k, v in want.items()}
            call = lambda: runner.infer(feed)  # noqa: E731
        else:
            call = lambda: infer_batch_multiprocess(runner, feed)  # noqa: E731
    if ref["act_scales"] is not None and {int(k): float(v) for k, v in scales.items()} != \
            ref["act_scales"]:
        raise AssertionError(f"{label}: the activation scales are not the reference's")
    reset_launch_counts()
    reset_exchanges()
    got = call()
    record = {"pid": pid, "job": label, "mesh": dict(runner.mesh.shape),
              "rows": len(next(iter(feed.values()))), "gate": ref["gate"],
              **_check(label, got, want, ref)}
    if "--save" in flags:
        np.savez(flags[flags.index("--save") + 1].format(pid=pid), **got)
    if pipeline:
        record["handoffs"] = _exchanges(runner.handoffs)
    else:
        specs = runner._w_specs
        record["sharded_weights"] = sum("model" in s for s in specs.values())
        record["expert_stacks_sharded"] = sum(
            runner.weights[k].dim() == 3 and s[:1] == ("model",) for k, s in specs.items())
        record["owners"] = {d: list(runner.mesh.owners(d)) for d in rows_here}
        record["lead"] = str(runner.device)
        record["exchanges_checked_call"] = exchanges()
    times, handoffs = [], []
    if bench:
        dist.barrier()
        reset_exchanges()
        for _ in range(bench):
            t0 = time.perf_counter()
            call()
            times.append((time.perf_counter() - t0) * 1e3)
            if pipeline:
                handoffs.append(_exchanges(runner.handoffs))
        if not pipeline:
            record["exchanges_timed"] = exchanges()
    if handoffs:
        # the median timed call's (of an even count the upper one)
        record["handoffs_timed"] = handoffs[int(np.argsort(times)[len(times) // 2])]
    record.update({"calls": 1 + bench, "launches": launch_counts(), "ms_batches": times,
                   "ms_batch_median": statistics.median(times) if times else None,
                   "s": time.perf_counter() - t_job})
    return record


def main(argv: Sequence[str]) -> int:
    argv = list(argv)
    options = {}
    for opt in ("--device", "--threads"):
        if opt in argv:
            i = argv.index(opt)
            options[opt] = argv[i + 1]
            del argv[i:i + 2]
    if "--device" not in options:
        raise SystemExit("mp_worker: --device cpu|cuda is required")
    jobs, current = [], []
    for arg in argv:
        if arg == "--next":
            jobs.append(current)
            current = []
        else:
            current.append(arg)
    jobs.append(current)
    pid, nproc, address = int(jobs[0][0]), int(jobs[0][1]), jobs[0][2]
    jobs[0] = jobs[0][3:]

    import torch
    import torch.distributed as dist

    from pyopenvino_tpu_torch.parallel.distributed import initialize_multihost, shutdown_multihost

    if "--threads" in options:
        torch.set_num_threads(int(options["--threads"]))
    device = torch.device(options["--device"])
    if device.type == "cuda":
        from pyopenvino_tpu_torch.kernels import build

        prebuilt = all(build.library_path(src.name).exists()
                       for src in build.CSRC_DIR.glob("*.cu"))
        device = torch.device("cuda", torch.cuda.current_device())
    local = [device] * LOCAL_DEVICES
    info = initialize_multihost(address, nproc, pid, devices=local)
    if info["process_count"] != nproc or info["global_devices"] != nproc * LOCAL_DEVICES:
        raise AssertionError(f"group {info}")
    print("MP_GROUP " + json.dumps({"pid": pid, **info, "device": str(device),
                                    "threads": torch.get_num_threads(),
                                    **({"prebuilt": prebuilt} if device.type == "cuda"
                                       else {})}), flush=True)
    prepared: dict = {}
    for job in jobs:
        print("MP_JOB " + json.dumps(run_job(pid, nproc, job, local, prepared)), flush=True)
    dist.barrier()
    shutdown_multihost()
    print(f"MP_OK {pid}", flush=True)
    return 0


def launch(nproc: int, address: str, jobs: Sequence[Sequence[str]], device: str,
           threads: int, timeout: float) -> List[dict]:
    """Start NPROC workers on ``jobs`` (each MODEL BATCH_PER_PROC REF_NPZ and
    its flags) from the repository's root and wait for them all.  A worker
    that exits non-zero, or the ``timeout`` passing, kills every other one.
    Returns each rank's ``{"rc", "output", "timed_out", "jobs", "group"}``
    (``jobs``: its parsed ``MP_JOB`` records)."""
    tail = [a for i, job in enumerate(jobs) for a in (["--next"] if i else []) + list(job)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "pyopenvino_tpu_torch.tools.mp_worker", str(pid), str(nproc),
         address, *tail, "--device", device, "--threads", str(threads)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(nproc)]
    outputs = [""] * nproc

    def read(i):
        outputs[i] = procs[i].stdout.read()

    readers = [threading.Thread(target=read, args=(i,), daemon=True) for i in range(nproc)]
    for r in readers:
        r.start()
    deadline, timed_out = time.monotonic() + timeout, False
    while any(p.poll() is None for p in procs):
        failed = any(p.poll() not in (None, 0) for p in procs)
        timed_out = time.monotonic() > deadline
        if failed or timed_out:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            break
        time.sleep(0.05)
    for p, r in zip(procs, readers):
        p.wait()
        r.join()
    results = []
    for p, out in zip(procs, outputs):
        lines = out.splitlines()
        results.append({
            "rc": p.returncode, "output": out, "timed_out": timed_out,
            "jobs": [json.loads(x[len("MP_JOB "):]) for x in lines if x.startswith("MP_JOB ")],
            "group": next((json.loads(x[len("MP_GROUP "):]) for x in lines
                           if x.startswith("MP_GROUP ")), None)})
    return results


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
