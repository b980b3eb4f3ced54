"""The int8 ``conv2d_direct`` (kernel #3) built from several source trees and
timed in one process.

    python -m pyopenvino_tpu_torch.tools.ab_conv_direct [--wgmma | --bf16] CSRC_DIR [CSRC_DIR ...]

Each CSRC_DIR holds a ``conv_direct.cu`` with its headers (this package's
``csrc/``, or that of another commit unpacked beside it) whose
``conv2d_direct_i8`` takes the ``out_bf16`` argument (float32 out here),
as every tree since the bfloat16 slice does.  Each is compiled
with ``kernels/build.py``'s flags into ``build/ab/<i>.so``; the SASS of its
int8 kernel (``i8i8_mma_kernel`` with the ``ConvA`` loader) is counted by
``cuobjdump`` (all instructions, IMMA, LDSM, LDG, BRA); then at ResNet-18's
four stride-1 3×3 shapes at batch 1 (split K by ``PLANS``) and 64, every
build's ``conv2d_direct_i8`` is held exactly to the plain version and timed
by CUDA-graph replay in turns (builds in order, then reversed, three
times), and the median of each build's six times is printed, one JSON line
a shape.  With ``--wgmma`` the same for ``conv2d_direct_i8_wgmma``
(csrc/i8_wgmma.cuh's loop, ``ConvAIm2col``; the trees since it came) at
ResNet-18's four shapes at batch 64 and 512 with ``direct_plan``'s plan,
float32 and bfloat16 out, its kernel's SASS counted likewise.  With
``--bf16`` the same for ``conv2d_direct_bf16_wgmma`` (kernel 3f-bf16 on
that loop, ``ConvABf16Im2col`` and ``ConvABf16Im2colI8w``; the trees since
it came) at ResNet-18's four shapes at batch 64 with ``direct_bf16_plan``'s
plan, a bfloat16 and an int8 weight, each build within one bfloat16 step
of the plain version (or the float32 sums' bound, 4·K·2^-24·Σ|x·w|, where
a sum cancels), the int8 weight's kernel's SASS counted.  Two builds
of one function in one process are how a change to a
shared header is told apart from the card's run-to-run spread; each is
built with ``-fno-gnu-unique``, so that the function-local statics of
one header's templates (the shared-memory size a kernel was granted) stay
each library's own.  Needs the card and ``nvcc``; exits non-zero without
them.
"""

from __future__ import annotations

import collections
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from pyopenvino_tpu_torch.kernels.build import NVCC_FLAGS, PACKAGE_DIR, _nvcc
from pyopenvino_tpu_torch.kernels.conv import conv_weight_matrix_nk
from pyopenvino_tpu_torch.kernels.conv_direct import (
    _ENTRIES, conv2d_direct_plain, direct_bf16_plan, direct_plan,
)
from pyopenvino_tpu_torch.kernels.gemm import PLANS, split_k
from pyopenvino_tpu_torch.tools.sweep_split_k import graph_ms

WIDTHS = ((56, 64), (28, 128), (14, 256), (7, 512))
SHAPES = [(b, hw, c) for b in (1, 64) for hw, c in WIDTHS]
WGMMA_SHAPES = [(b, hw, c) for b in (64, 512) for hw, c in WIDTHS]
OUT_DIR = PACKAGE_DIR.parent / "build" / "ab"
PADS = ((1, 1), (1, 1))


def build(dirs, entry="conv2d_direct_i8"):
    """One library a source tree, nvcc started for all at once; returns
    each one's ``entry``."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-Xcompiler", "-fno-gnu-unique", "-o",
                               str(OUT_DIR / f"{i}.so"), str(Path(d) / "conv_direct.cu")],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i, d in enumerate(dirs)]
    fns = []
    for i, proc in enumerate(procs):
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {dirs[i]}:\n{log}")
        fn = getattr(ctypes.CDLL(str(OUT_DIR / f"{i}.so")), entry)
        fn.argtypes = _ENTRIES[entry]
        fn.restype = ctypes.c_int
        fns.append(fn)
    return fns


def sass_counts(library, kernel="i8i8_mma_kernel", loader="ConvA"):
    """Instruction counts of the conv kernel's SASS in ``library``
    (``kernel`` with the conv's ``loader``: the int8 conv's float32 output,
    or for a bfloat16 loader its bfloat16 one)."""
    sass = subprocess.run(["cuobjdump", "-sass", str(library)], capture_output=True,
                          text=True, check=True).stdout
    for block in sass.split("Function : ")[1:]:
        name = block.splitlines()[0]
        if (kernel in name and loader in name
                and ("bfloat16" not in name or "Bf16" in loader)):
            ops = collections.Counter()
            for line in block.splitlines():
                parts = line.split("*/")
                if line.strip().startswith("/*") and len(parts) > 2 and parts[1].split():
                    words = parts[1].split()
                    op = words[1] if words[0].startswith("@") else words[0]
                    ops[op.split(".")[0]] += 1
            return {"instructions": sum(ops.values()),
                    **{k: ops[k] for k in ("IMMA", "IGMMA", "WARPGROUP", "LDSM", "LDG", "BRA")}}
    raise RuntimeError(f"no int8 conv kernel in {library}")


def wgmma_ab(fns, rng):
    """Each build's conv2d_direct_i8_wgmma at WGMMA_SHAPES, float32 and
    bfloat16 out: exact against the plain version, then timed in turns."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    order = list(range(len(fns))) + list(reversed(range(len(fns))))
    for b, hw, c in WGMMA_SHAPES:
        x = torch.from_numpy(rng.integers(-127, 128, (b, hw, hw, c)).astype(np.int8)).cuda()
        wt = torch.from_numpy(rng.integers(-127, 128, (c, c, 3, 3)).astype(np.int8)).cuda()
        wmat = conv_weight_matrix_nk(wt)
        scale = torch.from_numpy(rng.uniform(1e-4, 1e-2, c).astype(np.float32)).cuda()
        bias = torch.from_numpy(rng.standard_normal(c).astype(np.float32)).cuda()
        for out_dtype in (torch.float32, torch.bfloat16):
            bf = int(out_dtype == torch.bfloat16)
            plan = direct_plan(b * hw * hw, 9 * c, c, c, 2 if bf else 4, sms)
            ws = (torch.empty((plan.splits, b * hw * hw, c), dtype=torch.int32, device="cuda")
                  if plan.splits > 1 else None)
            want = conv2d_direct_plain(x, wt, scale, bias, None, PADS, out_dtype)
            outs = [torch.empty_like(want) for _ in fns]

            def launcher(i):
                def launch():
                    err = fns[i](x.data_ptr(), wmat.data_ptr(), scale.data_ptr(),
                                 bias.data_ptr(), outs[i].data_ptr(), bf, b, hw, hw, c, c, 3,
                                 3, hw, hw, 1, 1, 0, 0.0, 0.0, plan.bn, plan.sl, plan.stages,
                                 plan.splits, plan.grid,
                                 ws.data_ptr() if ws is not None else None,
                                 torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"build {i}: cudaError {err}")
                return launch

            for i in range(len(fns)):
                launcher(i)()
                torch.cuda.synchronize()
                if not torch.equal(outs[i], want):
                    raise AssertionError(f"build {i} differs from the plain version at "
                                         f"{b, hw, c, out_dtype}")
            times = collections.defaultdict(list)
            for _ in range(3):
                for i in order:
                    times[i].append(graph_ms(launcher(i)))
            print(json.dumps({"loop": "wgmma", "batch": b, "H": hw, "C": c,
                              "out": str(out_dtype)[6:], "plan": plan._asdict(),
                              "median_ms": [sorted(times[i])[len(times[i]) // 2]
                                            for i in range(len(fns))]}), flush=True)


def bf16_ab(fns, rng):
    """Each build's conv2d_direct_bf16_wgmma at R's four shapes at batch
    64, a bfloat16 and an int8 weight: within one bfloat16 step of the
    plain version (or the float32 sums' bound where a sum cancels), then
    timed in turns."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    order = list(range(len(fns))) + list(reversed(range(len(fns))))
    for hw, c in WIDTHS:
        b = 64
        x = torch.from_numpy(rng.standard_normal((b, hw, hw, c)).astype(np.float32)).cuda()
        x = x.to(torch.bfloat16)
        bias = torch.from_numpy(rng.standard_normal(c).astype(np.float32)).cuda()
        plan = direct_bf16_plan(b * hw * hw, 9 * c, c, c, sms)
        ws = (torch.empty((plan.splits, b * hw * hw, c), device="cuda")
              if plan.splits > 1 else None)
        for w_int8 in (0, 1):
            if w_int8:
                wt = torch.from_numpy(rng.integers(-127, 128, (c, c, 3, 3)).astype(np.int8))
                scale = torch.from_numpy(rng.uniform(1e-3, 1e-2, c).astype(np.float32)).cuda()
            else:
                wt = torch.from_numpy(rng.standard_normal((c, c, 3, 3)).astype(np.float32))
                wt, scale = wt.to(torch.bfloat16), None
            wt = wt.cuda()
            wmat = conv_weight_matrix_nk(wt)
            want = conv2d_direct_plain(x, wt, scale, bias, None, PADS).double()
            # one bf16 step of each element, or 4·K·2^-24·Σ|x·w|·|scale|
            xa = torch.nn.functional.pad(x.double().abs().permute(0, 3, 1, 2), (1, 1, 1, 1))
            floor = torch.nn.functional.conv2d(xa, wt.double().abs()).permute(0, 2, 3, 1)
            floor = floor * (4 * 9 * c * 2.0 ** -24)
            if scale is not None:
                floor = floor * scale.double()
            step = torch.exp2(torch.frexp(want.abs().clamp_min(2.0 ** -126))[1].double() - 8)
            limit = torch.maximum(step, floor)
            outs = [torch.empty((b, hw, hw, c), dtype=torch.bfloat16, device="cuda")
                    for _ in fns]

            def launcher(i):
                def launch():
                    err = fns[i](x.data_ptr(), wmat.data_ptr(), w_int8,
                                 scale.data_ptr() if scale is not None else None,
                                 bias.data_ptr(), outs[i].data_ptr(), b, hw, hw, c, c, 3, 3, hw,
                                 hw, 1, 1, 0, 0.0, 0.0, plan.bn, plan.sl, plan.stages,
                                 plan.splits, plan.grid,
                                 ws.data_ptr() if ws is not None else None,
                                 torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"build {i}: cudaError {err}")
                return launch

            worst = []
            for i in range(len(fns)):
                launcher(i)()
                torch.cuda.synchronize()
                worst.append(((outs[i].double() - want).abs() / limit).max().item())
                if worst[-1] > 1.0:
                    raise AssertionError(f"build {i} beyond the bf16 gate at {b, hw, c}, "
                                         f"int8 weight {w_int8}: {worst[-1]}")
            times = collections.defaultdict(list)
            for _ in range(3):
                for i in order:
                    times[i].append(graph_ms(launcher(i)))
            print(json.dumps({"loop": "bf16_wgmma", "batch": b, "H": hw, "C": c,
                              "weight": "int8" if w_int8 else "bfloat16",
                              "plan": plan._asdict(), "worst_over_limit": worst,
                              "bits_equal": [torch.equal(o, outs[0]) for o in outs],
                              "median_ms": [sorted(times[i])[len(times[i]) // 2]
                                            for i in range(len(fns))]}), flush=True)


def main(argv):
    wgmma, bf16 = "--wgmma" in argv[1:], "--bf16" in argv[1:]
    dirs = [d for d in argv[1:] if d not in ("--wgmma", "--bf16")]
    if not torch.cuda.is_available() or not dirs:
        print("ab_conv_direct: needs a CUDA card and at least one CSRC_DIR", file=sys.stderr)
        return 2
    fns = build(dirs, "conv2d_direct_bf16_wgmma" if bf16 else
                "conv2d_direct_i8_wgmma" if wgmma else "conv2d_direct_i8")
    kernel = "i8_wgmma_kernel" if wgmma or bf16 else "i8i8_mma_kernel"
    for i, d in enumerate(dirs):
        print(json.dumps({"build": i, "csrc": d, **sass_counts(
            OUT_DIR / f"{i}.so", kernel, "ConvABf16Im2colI8w" if bf16 else "ConvA")}), flush=True)
    if bf16:
        bf16_ab(fns, np.random.default_rng(0))
        return 0
    if wgmma:
        wgmma_ab(fns, np.random.default_rng(0))
        return 0
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(0)
    order = list(range(len(fns))) + list(reversed(range(len(fns))))
    for b, hw, c in SHAPES:
        x = torch.from_numpy(rng.integers(-127, 128, (b, hw, hw, c)).astype(np.int8)).cuda()
        wt = torch.from_numpy(rng.integers(-127, 128, (c, c, 3, 3)).astype(np.int8)).cuda()
        wmat = conv_weight_matrix_nk(wt)
        scale = torch.from_numpy(rng.uniform(1e-4, 1e-2, c).astype(np.float32)).cuda()
        bias = torch.from_numpy(rng.standard_normal(c).astype(np.float32)).cuda()
        m, k = b * hw * hw, 9 * c
        kchunk = split_k(m, k, c, PLANS["conv2d_direct"], sms)
        ws = (torch.empty((-(-k // kchunk), m, c), dtype=torch.int32, device="cuda")
              if kchunk < k else None)
        want = conv2d_direct_plain(x, wt, scale, bias, None, PADS)
        outs = [torch.empty_like(want) for _ in fns]

        def launcher(i):
            def launch():
                err = fns[i](x.data_ptr(), wmat.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                             outs[i].data_ptr(), 0, b, hw, hw, c, c, 3, 3, hw, hw, 1, 1, 0, 0.0,
                             0.0, kchunk, ws.data_ptr() if ws is not None else None,
                             torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"build {i}: cudaError {err}")
            return launch

        for i in range(len(fns)):
            launcher(i)()
            torch.cuda.synchronize()
            if not torch.equal(outs[i], want):
                raise AssertionError(f"build {i} differs from the plain version at {b, hw, c}")
        times = collections.defaultdict(list)
        for _ in range(3):
            for i in order:
                times[i].append(graph_ms(launcher(i)))
        print(json.dumps({"batch": b, "H": hw, "C": c, "splits": -(-k // kchunk),
                          "median_ms": [sorted(times[i])[len(times[i]) // 2]
                                        for i in range(len(fns))]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
