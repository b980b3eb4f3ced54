"""The int8 ``conv2d_direct`` (kernel #3) built from several source trees and
timed in one process.

    python -m pyopenvino_tpu_torch.tools.ab_conv_direct CSRC_DIR [CSRC_DIR ...]

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
a shape.  Two builds of one function in one process are how a change to a
shared header is told apart from the card's run-to-run spread.  Needs the
card and ``nvcc``; exits non-zero without them.
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
from pyopenvino_tpu_torch.kernels.conv_direct import _ENTRIES, conv2d_direct_plain
from pyopenvino_tpu_torch.kernels.gemm import PLANS, split_k
from pyopenvino_tpu_torch.tools.sweep_split_k import graph_ms

SHAPES = [(b, hw, c) for b in (1, 64) for hw, c in ((56, 64), (28, 128), (14, 256), (7, 512))]
OUT_DIR = PACKAGE_DIR.parent / "build" / "ab"
PADS = ((1, 1), (1, 1))


def build(dirs):
    """One library a source tree, nvcc started for all at once."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(OUT_DIR / f"{i}.so"),
                               str(Path(d) / "conv_direct.cu")],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i, d in enumerate(dirs)]
    fns = []
    for i, proc in enumerate(procs):
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {dirs[i]}:\n{log}")
        fn = ctypes.CDLL(str(OUT_DIR / f"{i}.so")).conv2d_direct_i8
        fn.argtypes = _ENTRIES["conv2d_direct_i8"]
        fn.restype = ctypes.c_int
        fns.append(fn)
    return fns


def sass_counts(library):
    """Instruction counts of the int8 conv kernel's SASS in ``library``."""
    sass = subprocess.run(["cuobjdump", "-sass", str(library)], capture_output=True,
                          text=True, check=True).stdout
    for block in sass.split("Function : ")[1:]:
        name = block.splitlines()[0]
        if "i8i8_mma_kernel" in name and "ConvA" in name:
            ops = collections.Counter()
            for line in block.splitlines():
                parts = line.split("*/")
                if line.strip().startswith("/*") and len(parts) > 2 and parts[1].split():
                    words = parts[1].split()
                    op = words[1] if words[0].startswith("@") else words[0]
                    ops[op.split(".")[0]] += 1
            return {"instructions": sum(ops.values()),
                    **{k: ops[k] for k in ("IMMA", "LDSM", "LDG", "BRA")}}
    raise RuntimeError(f"no int8 conv kernel in {library}")


def main(argv):
    if not torch.cuda.is_available() or len(argv) < 2:
        print("ab_conv_direct: needs a CUDA card and at least one CSRC_DIR", file=sys.stderr)
        return 2
    dirs = argv[1:]
    fns = build(dirs)
    for i, d in enumerate(dirs):
        print(json.dumps({"build": i, "csrc": d, **sass_counts(OUT_DIR / f"{i}.so")}), flush=True)
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
