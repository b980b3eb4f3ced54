"""Continuous-batching inference server.

Counterpart of ``pyopenvino_tpu/serving/server.py``:

  * requests land in a thread-safe queue as (inputs, Future, enqueue time,
    resolution key);
  * one scheduler thread takes the first request, waits up to
    ``max_delay_ms`` for more (the admission window), coalesces up to the
    largest bucket, pads the batch to the smallest bucket that holds it with
    copies of the last example (masked out of the answers) and answers it
    with one ``CompiledNetwork.infer_batch``.  The compiled network bakes one
    model per bucket (``_batched_plan``), so steady-state serving bakes
    nothing new; ``start(warmup=True)`` runs every (resolution, bucket) once
    in the caller's thread before the scheduler starts, so no kernel build
    or bake lands inside a request's latency;
  * a malformed request is refused in the caller's thread (``submit``), so
    it never fails the batch of the requests it would have landed in.

Latency is measured from enqueue to answer; ``ServerStats`` keeps p50/p99,
batches and padded slots.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class ServerStats:
    requests: int = 0
    batches: int = 0
    padded_slots: int = 0
    # a rolling window, so a long-running server does not grow without bound
    latencies_ms: "deque" = dataclasses.field(
        default_factory=lambda: deque(maxlen=100_000))

    def _snapshot(self) -> list:
        # the scheduler thread appends concurrently, and list() of a deque
        # that changes under it can raise: retry a few times
        for _ in range(8):
            try:
                return list(self.latencies_ms)
            except RuntimeError:
                continue
        return []

    def percentile(self, p: float) -> float:
        snap = self._snapshot()
        if not snap:
            return 0.0
        return float(np.percentile(np.asarray(snap), p))

    @property
    def p50_ms(self) -> float:
        return self.percentile(50)

    @property
    def p99_ms(self) -> float:
        return self.percentile(99)

    def summary(self) -> Dict[str, float]:
        # one snapshot for both percentiles, so they describe the same window
        snap = self._snapshot()
        p50, p99 = ((float(x) for x in np.percentile(np.asarray(snap), [50, 99]))
                    if snap else (0.0, 0.0))
        return {
            "requests": self.requests,
            "batches": self.batches,
            "padded_slots": self.padded_slots,
            "p50_ms": round(p50, 3),
            "p99_ms": round(p99, 3),
        }


def _declared_shapes(model) -> Dict[str, tuple]:
    return {n.name: tuple(n.outputs[n.out_port].shape) for n in model.parameters}


class InferenceServer:
    """Continuous batching over a ``CompiledNetwork``
    (``runtime/compiler.py``).

    compiled     : the network that answers the declared resolution.
    buckets      : batch sizes; a batch is padded up to the smallest bucket
                   that holds it.
    max_delay_ms : the admission window: how long the scheduler waits for
                   more requests before it launches a partial batch.
    resolutions  : extra (H, W) of a network with one rank-4 image input;
                   each gets its own ``CompiledNetwork`` of the reshaped
                   model with the same quantization state, so shape-derived
                   constants (SSD's ShapeOf → PriorBox chains) fold again at
                   each resolution.  A request routes by its input shape, and
                   only requests of one resolution share a batch.
    """

    def __init__(self, compiled, buckets: Sequence[int] = (1, 2, 4, 8, 16, 32),
                 max_delay_ms: float = 2.0,
                 resolutions: Optional[Sequence[Tuple[int, int]]] = None):
        self.compiled = compiled
        buckets = sorted(buckets)
        # a network on a mesh (parallel/mesh.py shard_compiled) splits
        # infer_batch's batch into equal blocks over its P('data') axis, so
        # every bucket is rounded up to a multiple of that axis: a batch of 1
        # on a data=4 mesh pads to 4, and the padded slots are masked out of
        # the answers like any other padding
        mesh = getattr(compiled, "mesh", None)
        pspec = getattr(compiled, "_batch_pspec", None)
        if mesh is not None and pspec is not None:
            data_ax = int(np.prod([
                mesh.shape[ax] for ax in (pspec[0] if isinstance(
                    pspec[0], tuple) else (pspec[0],)) if ax is not None
            ])) if len(pspec) else 1
            buckets = sorted({max(data_ax, -(-b // data_ax) * data_ax) for b in buckets})
        self.buckets = tuple(buckets)
        self.max_delay_s = max_delay_ms / 1e3
        self.stats = ServerStats()
        self._queue: "queue.Queue[Optional[Tuple[dict, Future, float, object]]]" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self._lock = threading.Lock()
        self._param_names = [n.name for n in compiled.model.parameters]
        self._nets: Dict[Optional[Tuple[int, int]], object] = {None: compiled}
        self._shapes_by_key = {None: _declared_shapes(compiled.model)}
        if resolutions:
            if mesh is not None:
                raise NotImplementedError(
                    "resolutions with a sharded network: each resolution's network would "
                    "need the mesh attached again, which is not wired up; serve one "
                    "resolution per sharded server")
            self._add_resolutions(resolutions)

    def _add_resolutions(self, resolutions):
        from pyopenvino_tpu_torch.passes.shape_infer import reshape_model
        from pyopenvino_tpu_torch.runtime.compiler import CompiledNetwork

        compiled = self.compiled
        params = compiled.model.parameters
        if len(params) != 1 or len(params[0].outputs[params[0].out_port].shape) != 4:
            raise NotImplementedError("resolutions need exactly one rank-4 image input")
        p = params[0]
        b0, c0, h0, w0 = p.outputs[p.out_port].shape
        for h, w in resolutions:
            key = (int(h), int(w))
            if key == (h0, w0) or key in self._nets:
                continue
            model = reshape_model(compiled.model, {p.name: (b0, c0, h, w)})
            self._nets[key] = CompiledNetwork(
                model, compiled.config, device=compiled.device,
                quantized=compiled._quantized, act_scales=compiled.act_scales,
                bias_corr=compiled._bias_corr)
            self._shapes_by_key[key] = _declared_shapes(model)

    # -- lifecycle -------------------------------------------------------------

    def start(self, warmup: bool = False) -> "InferenceServer":
        """With ``warmup``, run every (resolution, bucket) once first, in the
        caller's thread: the kernels' builds and each bucket's baked model
        then never land inside a request's latency."""
        if warmup:
            self.warmup_buckets()
        with self._lock:
            if self._running:
                return self
            if self._thread is not None and self._thread.is_alive():
                # the previous scheduler is still finishing a batch: a second
                # thread would race it on the queue
                raise RuntimeError("previous scheduler thread still stopping; retry stop()")
            self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def warmup_buckets(self):
        """One batch of zeros through every (resolution, bucket), in each
        Parameter's declared dtype (a u8 input warms the u8 path)."""
        for net in self._nets.values():
            dummy = {n.name: np.zeros((1,) + tuple(n.outputs[n.out_port].shape),
                                      n.outputs[n.out_port].dtype)
                     for n in net.model.parameters}
            for b in self.buckets:
                net.infer_batch({k: np.repeat(v, b, axis=0) for k, v in dummy.items()})

    def stop(self):
        with self._lock:
            if not self._running:
                return
            self._running = False
        self._queue.put(None)  # wake the scheduler
        if self._thread is not None:
            self._thread.join(timeout=30)
            if self._thread.is_alive():
                # still in a batch: keep the handle so that start() refuses
                # to race it
                return
            self._thread = None
        self._fail_orphans()

    def _fail_orphans(self):
        """Fail every request left in the queue (a submit that raced the
        shutdown), whose caller would otherwise wait on its Future for
        ever."""
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                return
            if item is None:
                continue
            fut = item[1]
            if not fut.done():
                fut.set_exception(RuntimeError("server stopped"))

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- client API ------------------------------------------------------------

    def submit(self, inputs: Dict[str, np.ndarray]) -> Future:
        """Enqueue one request at the declared shapes (batch 1).  Returns a
        Future of {result name: ndarray}, each shaped as a direct
        ``infer`` answer.  Validation runs here, in the caller's thread."""
        if not self._running:
            raise RuntimeError("server not started")
        key = self._route(inputs)
        fut: Future = Future()
        self._queue.put((inputs, fut, time.perf_counter(), key))
        return fut

    def _route(self, inputs: Dict[str, np.ndarray]):
        """The resolution whose declared shapes the request matches."""
        last_err = None
        for key, shapes in self._shapes_by_key.items():
            for name, shape in shapes.items():
                if name not in inputs:
                    raise KeyError(f"missing input {name!r}")
                got = tuple(np.shape(inputs[name]))
                if got != shape:
                    last_err = f"input {name!r}: shape {got} != declared {shape}"
                    break
            else:
                return key
        served = sorted(str(s) for shapes in self._shapes_by_key.values()
                        for s in shapes.values())
        raise ValueError(f"{last_err} (served shapes: {', '.join(served)})")

    def infer(self, inputs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        return self.submit(inputs).result()

    # -- scheduler -------------------------------------------------------------

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _collect(self) -> List[Tuple[dict, Future, float, object]]:
        """Wait for the first request, then coalesce within the admission
        window up to the largest bucket."""
        first = self._queue.get()
        if first is None:
            return []
        batch = [first]
        deadline = time.perf_counter() + self.max_delay_s
        while len(batch) < self.buckets[-1]:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                item = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if item is None:
                self._queue.put(None)  # keep the shutdown signal
                break
            batch.append(item)
        return batch

    def _loop(self):
        while True:
            items = self._collect()
            if not items:
                if not self._running:
                    return
                continue
            # only requests of one resolution share a launch
            groups: Dict[object, list] = {}
            for item in items:
                groups.setdefault(item[3], []).append(item)
            for key, group in groups.items():
                try:
                    self._run_batch(group, key)
                except Exception as e:  # noqa: BLE001 — each caller gets it
                    for _, fut, _, _ in group:
                        if not fut.done():
                            fut.set_exception(e)
            if not self._running and self._queue.empty():
                return

    def _run_batch(self, items, key=None):
        n = len(items)
        bucket = self._bucket_for(n)
        stacked: Dict[str, np.ndarray] = {}
        for name in self._param_names:
            block = np.stack([np.asarray(inputs[name]) for inputs, _, _, _ in items])
            if bucket > n:  # copies of the last example, masked out below
                block = np.concatenate([block, np.repeat(block[-1:], bucket - n, axis=0)])
            stacked[name] = block
        out = self._nets[key].infer_batch(stacked)
        # the stats first: a caller woken by its answer reads them whole
        now = time.perf_counter()
        self.stats.latencies_ms.extend((now - t_enq) * 1e3 for _, _, t_enq, _ in items)
        self.stats.requests += n
        self.stats.batches += 1
        self.stats.padded_slots += bucket - n
        for i, (_, fut, _, _) in enumerate(items):
            # the declared unit batch dim back on each example, so a served
            # answer has a direct infer()'s shape
            if not fut.done():
                fut.set_result({k: np.asarray(v[i])[None] for k, v in out.items()})
