"""Model cache: OpenVINO's ``CACHE_DIR``.

The port's counterpart of ``pyopenvino_tpu/runtime/cache.py``, with its
functions' signatures.  The JAX package points XLA's persistent compilation
cache at the directory.  PyTorch has no such cache to point, and the port's
kernels are built once into ``build/kernels/`` anyway: its costly load
steps are parsing the IR, ``prepare_model`` and, under INT8-FULL, the
calibration on the host.  So the cache holds ``runtime/export.py``'s
artifacts, one per key:

    <CACHE_DIR>/<sha256 of the key>.ovpt

The key is a digest of the model as read (every node's id, name, type,
attributes, ports and Const bytes, bodies included, and the edges),
``dataclasses.astuple(config)``, the calibration samples' names, dtypes,
shapes and bytes, the artifact format version and the port's own code
(``code_digest``: every ``.py`` file of the package, which holds the passes,
the quantization and calibration that made the artifact's weights): a
changed config field, sample or source file misses, two reads of the same
files hit.  The device is not in the key; an import rebuilds on whichever
device is asked for.  ``ExecutableNetwork.compiled()`` (api.py) imports on
a hit; an entry that fails to import counts as a miss.  A miss compiles and
writes the artifact under a temporary name, then ``os.replace``s it, so
that two processes never read half a file.

The directory is process-wide, as ``jax.config``'s is; it is set through
``IECore.set_config({"CACHE_DIR": path})`` or
``Core.set_property({"CACHE_DIR": path})``.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import os
from typing import List, Optional

import numpy as np

from pyopenvino_tpu_torch.runtime.export import FORMAT_VERSION

SUFFIX = ".ovpt"
# the package whose source ``code_digest`` reads
PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_cache_dir: Optional[str] = None


def enable_model_cache(path: str) -> str:
    """Cache compiled networks under ``path`` (created if missing).  Returns
    the absolute path."""
    global _cache_dir
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    _cache_dir = path
    return path


def disable_model_cache() -> None:
    global _cache_dir
    _cache_dir = None


def current_cache_dir() -> Optional[str]:
    """The active CACHE_DIR, or None (``get_config``'s answer)."""
    return _cache_dir


def cache_entries(path: str) -> List[str]:
    """The files under ``path``, sorted."""
    if not os.path.isdir(path):
        return []
    out = []
    for root, _, files in os.walk(path):
        out.extend(os.path.join(root, f) for f in files)
    return sorted(out)


def _hash_model(h, model):
    for nid in sorted(model.nodes):
        node = model.nodes[nid]
        h.update(repr((node.id, node.name, node.op_type, sorted(node.attrs.items()))).encode())
        for side in (node.inputs, node.outputs):
            h.update(repr(sorted((p, tuple(i.shape), np.dtype(i.dtype).str)
                                 for p, i in side.items())).encode())
        if node.const is not None:
            const = np.ascontiguousarray(node.const)
            h.update(repr((const.dtype.str, const.shape)).encode())
            h.update(const.tobytes())
        for bname, sg in sorted((node.subgraphs or {}).items()):
            h.update(repr((bname, sg.inputs, sg.outputs, sg.back_edges)).encode())
            _hash_model(h, sg.model)
    h.update(repr(sorted((e.src, e.src_port, e.dst, e.dst_port)
                         for e in model.edges)).encode())


def source_digest(root: str) -> str:
    """sha256 of every ``.py`` file under ``root``: path and bytes, in
    sorted order."""
    h = hashlib.sha256()
    for dirpath, dirnames, files in os.walk(root):
        dirnames.sort()
        for name in sorted(f for f in files if f.endswith(".py")):
            path = os.path.join(dirpath, name)
            h.update(os.path.relpath(path, root).encode() + b"\0")
            with open(path, "rb") as f:
                h.update(f.read())
    return h.hexdigest()


@functools.lru_cache(maxsize=None)
def code_digest() -> str:
    """``source_digest`` of this package, read once a process."""
    return source_digest(PACKAGE_DIR)


def cache_key(model, config, samples=None) -> str:
    """The hex digest that names a network's artifact."""
    h = hashlib.sha256()
    h.update(f"format {FORMAT_VERSION} code {code_digest()}".encode())
    h.update(repr(dataclasses.astuple(config)).encode())
    _hash_model(h, model)
    if samples is None:
        h.update(b"no samples")
    for sample in samples or ():
        for name in sorted(sample):
            arr = np.ascontiguousarray(sample[name])
            h.update(repr((name, arr.dtype.str, arr.shape)).encode())
            h.update(arr.tobytes())
    return h.hexdigest()


def cache_path(model, config, samples=None) -> Optional[str]:
    """Where the network's artifact lives in the active CACHE_DIR, or None
    when the cache is off."""
    if _cache_dir is None:
        return None
    return os.path.join(_cache_dir, cache_key(model, config, samples) + SUFFIX)
