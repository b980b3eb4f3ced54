"""Build the port's CUDA sources into plain-C shared libraries, on first use.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into
``build/kernels/<name>-<hash>.so`` beside the package (the hash covers the
source and the flags, so an edited source never loads a stale library) and
loaded with ``ctypes``.  No PyTorch headers are involved, so a build takes
seconds.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libraries: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "of pyopenvino_tpu_torch are built from source on first use"
        )
    return nvcc


def library_path(source: str) -> Path:
    digest = hashlib.sha256(
        (CSRC_DIR / source).read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


def compile_source(source: str) -> Tuple[Path, str]:
    """Compile ``csrc/<source>`` unless its library exists.  Returns the
    library path and nvcc's log (ptxas register and spill report), empty
    when the library was already built."""
    out = library_path(source)
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {source} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent builder never loads half a file
    return out, proc.stdout + proc.stderr


def build_all() -> Dict[str, str]:
    """Compile every ``csrc/*.cu``.  Returns {source: nvcc log}."""
    return {p.name: compile_source(p.name)[1]
            for p in sorted(CSRC_DIR.glob("*.cu"))}


def load_library(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built first if needed."""
    with _lock:
        if source not in _libraries:
            path, _ = compile_source(source)
            _libraries[source] = ctypes.CDLL(str(path))
        return _libraries[source]
