"""The port's native host library: fp16 decode, batch preprocessing, the
stacking copy and a background loader, over ctypes.

Counterpart of ``pyopenvino_tpu/native``.  ``preprocess.cpp`` beside this
file is the port's own copy of the JAX package's source, with the same C ABI
(``ov_fp16_to_fp32``, ``ov_preprocess_batch``, ``ov_preprocess_batch_u8``,
``ov_stack_f32``, the ``ov_loader_*`` calls, ``ov_native_abi_version``) and
the same arithmetic.  g++ builds it on first use with the JAX package's
flags into ``build/native/preprocess-<hash>.so`` beside the package: the
hash covers the source, the flags, g++'s version and the CPU that
``-march=native`` names, so an edited source or another host never loads a
stale library.  The build runs under a file lock and lands by an atomic
rename, since several processes (pytest workers) may build at once.

There is no fallback: a failed build, a library that does not load or one
with another ABI version raises RuntimeError with g++'s log, and no public
function gives way to numpy.  ``_preprocess_numpy``, ``_preprocess_numpy_u8``
and ``_ThreadLoader`` are the plain versions that only tests call.

Entry points:
  * ``fp16_to_fp32(src)``: bit-exact fp16 → float32, threaded (the IR
    parser's decode of fp16 Consts);
  * ``preprocess_batch(imgs, out_hw, scale, bias, u8_out)``: (B, H, W, C)
    uint8 → (B, C, oh, ow) bilinear with align-corners sampling, float32
    ``px * scale + bias`` per channel, or uint8 rounded half up (the u8
    ingress: scale and bias then run on the device through
    ``PrePostProcessor``);
  * ``stack_f32(blobs)``: per-example float32 blobs into one batch;
  * ``AsyncLoader``: a C++ worker pool that preprocesses submitted batches
    in the background and hands them back in submission order.
"""

from __future__ import annotations

import collections
import concurrent.futures
import ctypes
import functools
import hashlib
import os
import queue
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "preprocess.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
# the JAX package's native/Makefile: CXXFLAGS, then LDFLAGS
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-Wextra")
LD_FLAGS = ("-shared", "-pthread")
ABI_VERSION = 3

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_U8_SCALE_ERROR = ("u8_out keeps raw pixels — put scale/bias on-device "
                   "(PrePostProcessor), not in the loader")


def _cxx() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the port's native host library "
                           "(pyopenvino_tpu_torch/native/preprocess.cpp) is built on first use")
    return cxx


@functools.cache
def _toolchain_id(cxx: str) -> str:
    """g++'s version and the CPU that ``-march=native`` resolves to."""
    version = subprocess.run([cxx, "--version"], capture_output=True, text=True,
                             check=True, timeout=60).stdout.splitlines()[0]
    target = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                            capture_output=True, text=True, check=True, timeout=60).stdout
    march = next((line.split()[-1] for line in target.splitlines()
                  if line.strip().startswith("-march=")), "")
    return f"{version} {march}"


def library_path() -> Path:
    """``build/native/<source stem>-<hash>.so`` of the current source."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS + LD_FLAGS).encode())
    digest.update(_toolchain_id(_cxx()).encode())
    return BUILD_DIR / f"{SOURCE.stem}-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``SOURCE`` unless its library exists; returns its path.
    Raises RuntimeError with g++'s log when the build fails."""
    out = library_path()
    if out.exists():
        return out
    import fcntl

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():  # another process built it while this one waited
            return out
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp")
        proc = subprocess.run([_cxx(), *CXX_FLAGS, str(SOURCE), "-o", str(tmp), *LD_FLAGS],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              timeout=300)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed on {SOURCE} (exit {proc.returncode}):\n"
                               f"{proc.stdout}")
        os.replace(tmp, out)  # atomic: no process loads half a file
    return out


def _load() -> ctypes.CDLL:
    """The loaded library, built first if needed, its ABI checked."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = build()
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise RuntimeError(f"the native host library {path} does not load: {e}") from e
        lib.ov_native_abi_version.restype = ctypes.c_int
        version = lib.ov_native_abi_version()
        if version != ABI_VERSION:
            raise RuntimeError(f"{path}: ABI version {version}, the bindings want "
                               f"{ABI_VERSION}")
        i, i64, p = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
        lib.ov_fp16_to_fp32.argtypes = [p, p, i64, i]
        lib.ov_preprocess_batch.argtypes = [p, i, i, i, i, p, i, i, p, p, i]
        lib.ov_preprocess_batch_u8.argtypes = [p, i, i, i, i, p, i, i, i]
        lib.ov_stack_f32.argtypes = [p, i, i64, p, i]
        lib.ov_loader_create.restype = p
        lib.ov_loader_create.argtypes = [i, i, i, i, i, p, p, i, i, i]
        lib.ov_loader_submit.restype = i64
        lib.ov_loader_submit.argtypes = [p, p, i]
        lib.ov_loader_next.restype = i64
        lib.ov_loader_next.argtypes = [p, p, i64]
        lib.ov_loader_close.argtypes = [p]
        lib.ov_loader_destroy.argtypes = [p]
        _lib = lib
        return lib


def available() -> bool:
    """Whether the library builds and loads here (the public functions
    raise the reason where it does not)."""
    try:
        _load()
    except RuntimeError:
        return False
    return True


def _nthreads() -> int:
    return max(1, min(16, os.cpu_count() or 1))


def _default_workers() -> int:
    return max(1, min(8, (os.cpu_count() or 2) - 1))


def fp16_to_fp32(src: np.ndarray) -> np.ndarray:
    """Decode an fp16 array to float32, bit-exact, threaded."""
    src = np.ascontiguousarray(src, dtype=np.float16)
    lib = _load()
    out = np.empty(src.shape, np.float32)
    lib.ov_fp16_to_fp32(src.ctypes.data, out.ctypes.data, src.size, _nthreads())
    return out


def _images(imgs) -> np.ndarray:
    imgs = np.ascontiguousarray(imgs, dtype=np.uint8)
    if imgs.ndim != 4:
        raise ValueError(f"images must be (B, H, W, C) uint8, got shape {imgs.shape}")
    return imgs


def _per_channel(v, c: int, what: str) -> Optional[np.ndarray]:
    if v is None:
        return None
    v = np.ascontiguousarray(v, np.float32).reshape(-1)
    if v.size != c:
        raise ValueError(f"{what} has {v.size} values for {c} channels")
    return v


def preprocess_batch(imgs: np.ndarray, out_hw, scale: Optional[np.ndarray] = None,
                     bias: Optional[np.ndarray] = None, u8_out: bool = False) -> np.ndarray:
    """(B, H, W, C) uint8 → (B, C, oh, ow) bilinear-resized blobs: float32
    ``px * scale + bias`` per channel, or with ``u8_out`` uint8 rounded half
    up (scale and bias must then be None: the u8 ingress applies them on
    the device, and the host-to-device copy is 1 byte a pixel)."""
    imgs = _images(imgs)
    b, ih, iw, c = imgs.shape
    oh, ow = out_hw
    if u8_out and (scale is not None or bias is not None):
        raise ValueError(_U8_SCALE_ERROR)
    lib = _load()
    if u8_out:
        out = np.empty((b, c, oh, ow), np.uint8)
        lib.ov_preprocess_batch_u8(imgs.ctypes.data, b, ih, iw, c, out.ctypes.data, oh, ow,
                                   _nthreads())
        return out
    sc = _per_channel(scale, c, "scale")
    bi = _per_channel(bias, c, "bias")
    out = np.empty((b, c, oh, ow), np.float32)
    lib.ov_preprocess_batch(imgs.ctypes.data, b, ih, iw, c, out.ctypes.data, oh, ow,
                            sc.ctypes.data if sc is not None else None,
                            bi.ctypes.data if bi is not None else None, _nthreads())
    return out


def _preprocess_numpy(imgs, out_hw, scale, bias):
    """The plain version of the float32 path: vectorized bilinear with
    align-corners sampling and float32 coordinates (the same neighbour
    picks), summed without fused multiply-adds."""
    b, ih, iw, c = imgs.shape
    oh, ow = out_hw
    fy = (np.arange(oh, dtype=np.float32) * np.float32((ih - 1) / (oh - 1))
          if oh > 1 else np.zeros(oh, np.float32))
    fx = (np.arange(ow, dtype=np.float32) * np.float32((iw - 1) / (ow - 1))
          if ow > 1 else np.zeros(ow, np.float32))
    y0 = fy.astype(np.int64)
    x0 = fx.astype(np.int64)
    y1 = np.minimum(y0 + 1, ih - 1)
    x1 = np.minimum(x0 + 1, iw - 1)
    wy = (fy - y0).astype(np.float32)[:, None, None]
    wx = (fx - x0).astype(np.float32)[None, :, None]
    f = imgs.astype(np.float32)
    top = (1 - wx) * f[:, y0][:, :, x0] + wx * f[:, y0][:, :, x1]
    bot = (1 - wx) * f[:, y1][:, :, x0] + wx * f[:, y1][:, :, x1]
    out = (1 - wy) * top + wy * bot  # (B, oh, ow, C)
    if scale is not None:
        out = out * np.asarray(scale, np.float32)
    if bias is not None:
        out = out + np.asarray(bias, np.float32)
    return np.ascontiguousarray(out.transpose(0, 3, 1, 2))


def _preprocess_numpy_u8(imgs, out_hw):
    """The plain version of the u8 path: the float32 resize rounded half up."""
    f = _preprocess_numpy(imgs, out_hw, None, None)
    return np.clip(np.floor(f + 0.5), 0, 255).astype(np.uint8)


def stack_f32(blobs) -> np.ndarray:
    """Stack per-example float32 blobs of one shape into one contiguous
    batch (the server's coalescing copy), a threaded memcpy."""
    blobs = [np.ascontiguousarray(x, np.float32) for x in blobs]
    if not blobs:
        raise ValueError("stack_f32 needs at least one blob")
    if any(x.shape != blobs[0].shape for x in blobs):
        raise ValueError(f"stack_f32: shapes differ: {sorted({x.shape for x in blobs})}")
    lib = _load()
    out = np.empty((len(blobs),) + blobs[0].shape, np.float32)
    ptrs = (ctypes.c_void_p * len(blobs))(*[x.ctypes.data for x in blobs])
    lib.ov_stack_f32(ptrs, len(blobs), blobs[0].size, out.ctypes.data, _nthreads())
    return out


class AsyncLoader:
    """Asynchronous prefetching loader: uint8 image batches in, NCHW blobs
    out (float32, or uint8 with ``u8_out``), preprocessed by a background
    C++ worker pool so that input preparation overlaps the device's work.

    Results come back strictly in submission order; ``depth`` bounds the
    batches in flight (submitted and not yet taken: ``submit`` blocks while
    it is full).  ``close()`` ends the submits (a blocked submitter is
    released with RuntimeError("loader is closed")); what was submitted
    stays retrievable, then ``next()`` returns None, and keeps returning it.
    Leaving the ``with`` block destroys the pool, after waiting out any
    thread still inside a call.

        with AsyncLoader((ih, iw, c), (oh, ow)) as ld:
            for imgs in stream: ld.submit(imgs)   # producer thread
            ...
            blob = ld.next()                      # consumer, in order
    """

    def __init__(self, in_shape, out_hw, scale=None, bias=None,
                 workers: int = 0, depth: int = 4, u8_out: bool = False):
        self.ih, self.iw, self.c = in_shape
        self.oh, self.ow = out_hw
        self.u8_out = bool(u8_out)
        if self.u8_out and (scale is not None or bias is not None):
            raise ValueError(_U8_SCALE_ERROR)
        self._scale = _per_channel(scale, self.c, "scale")
        self._bias = _per_channel(bias, self.c, "bias")
        self._handle = None
        self._lib = _load()
        self._batches: "queue.SimpleQueue[Optional[int]]" = queue.SimpleQueue()
        self._handle = ctypes.c_void_p(self._lib.ov_loader_create(
            self.ih, self.iw, self.c, self.oh, self.ow,
            self._scale.ctypes.data if self._scale is not None else None,
            self._bias.ctypes.data if self._bias is not None else None,
            workers or _default_workers(), depth, int(self.u8_out)))
        self._closed = False
        # serializes (native submit → size-queue put), so that several
        # producer threads cannot desynchronize sequence ids and sizes
        self._submit_lock = threading.Lock()

    @property
    def native(self) -> bool:
        return self._handle is not None

    def _check(self, imgs) -> np.ndarray:
        if self._closed:
            raise RuntimeError("loader is closed")
        imgs = _images(imgs)
        if imgs.shape[1:] != (self.ih, self.iw, self.c):
            raise ValueError(f"image shape {imgs.shape[1:]} != loader "
                             f"{(self.ih, self.iw, self.c)}")
        return imgs

    def submit(self, imgs: np.ndarray) -> None:
        """imgs: (B, ih, iw, c) uint8.  Blocks while ``depth`` batches are
        in flight."""
        imgs = self._check(imgs)
        with self._submit_lock:
            if self._lib.ov_loader_submit(self._handle, imgs.ctypes.data, imgs.shape[0]) < 0:
                raise RuntimeError("loader is closed")
            self._batches.put(imgs.shape[0])

    def next(self):
        """The next blob in submission order, (B, c, oh, ow), or None once
        the loader is closed and drained.  Blocks, outside the GIL, while
        the next batch is still being preprocessed."""
        b = self._batches.get()  # None: the close() sentinel
        if b is None:
            self._batches.put(None)  # the drained state is sticky
            return None
        out = np.empty((b, self.c, self.oh, self.ow), np.uint8 if self.u8_out else np.float32)
        n = self._lib.ov_loader_next(self._handle, out.ctypes.data, out.size)
        if n <= 0:
            return None
        if n != b:
            raise RuntimeError(f"loader handed back a batch of {n} where {b} was submitted")
        return out

    def __iter__(self):
        while True:
            blob = self.next()
            if blob is None:
                return
            yield blob

    def close(self):
        """No further submits; the batches in flight stay retrievable."""
        self._closed = True
        if self._handle is not None:
            self._lib.ov_loader_close(self._handle)
        self._batches.put(None)  # wake a consumer blocked in next()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        h, self._handle = self._handle, None
        if h is not None:
            self._lib.ov_loader_destroy(h)

    def __del__(self):  # a loader used without ``with``
        h, self._handle = getattr(self, "_handle", None), None
        if h is not None:
            self._lib.ov_loader_destroy(h)


class _ThreadLoader:
    """The plain version of ``AsyncLoader`` for tests: the same interface
    and semantics (order, the in-flight window, close releasing a blocked
    submitter, the sticky None) on a Python thread pool running
    ``_preprocess_numpy`` or ``_preprocess_numpy_u8``."""

    native = False

    def __init__(self, in_shape, out_hw, scale=None, bias=None,
                 workers: int = 0, depth: int = 4, u8_out: bool = False):
        self.ih, self.iw, self.c = in_shape
        self.oh, self.ow = out_hw
        self.u8_out = bool(u8_out)
        if self.u8_out and (scale is not None or bias is not None):
            raise ValueError(_U8_SCALE_ERROR)
        self._scale = _per_channel(scale, self.c, "scale")
        self._bias = _per_channel(bias, self.c, "bias")
        self._pool = concurrent.futures.ThreadPoolExecutor(workers or _default_workers())
        self._depth = max(1, depth)
        self._cv = threading.Condition()
        self._order = collections.deque()  # futures not yet taken, in order
        self._inflight = 0                 # submitted and not yet taken
        self._closed = False

    _check = AsyncLoader._check

    def _work(self, imgs):
        if self.u8_out:
            return _preprocess_numpy_u8(imgs, (self.oh, self.ow))
        return _preprocess_numpy(imgs, (self.oh, self.ow), self._scale, self._bias)

    def submit(self, imgs: np.ndarray) -> None:
        imgs = self._check(imgs).copy()
        with self._cv:
            self._cv.wait_for(lambda: self._closed or self._inflight < self._depth)
            if self._closed:
                raise RuntimeError("loader is closed")
            self._inflight += 1
            self._order.append(self._pool.submit(self._work, imgs))
            self._cv.notify_all()

    def next(self):
        with self._cv:
            self._cv.wait_for(lambda: self._order or self._closed)
            if not self._order:
                return None
            fut = self._order.popleft()
        try:
            return fut.result()
        finally:
            with self._cv:
                self._inflight -= 1
                self._cv.notify_all()

    __iter__ = AsyncLoader.__iter__

    def close(self):
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        self._pool.shutdown(wait=True)
