"""OpenVINO-compatible facade of the port.

Counterpart of ``pyopenvino_tpu/api.py`` (IECore, IENetwork,
ExecutableNetwork):

    ie = IECore()
    net = ie.read_network(xml, bin)         # → IENetwork
    exe = ie.load_network(net, "GPU")       # → ExecutableNetwork
    exe.kernel_type = "pallas"              # or "kernels"; "xla"/"torch";
                                            # "numpy" (the host interpreter)
    exe.set_calibration(samples)            # INT8-FULL: [{input_name: blob}];
                                            # a POT IR's FakeQuantizes carry them
    res = exe.infer({input_name: blob})     # {result_node_name: ndarray}
    res = exe.infer_batch({input_name: (B, ...) blob})

The OpenVINO 2.0 spelling and the async request API ride on the same
engine; concurrent requests coalesce into shared batches in the serving
layer (``serving/server.py``):

    core = Core()
    compiled = core.compile_model(core.read_model(xml, bin), "GPU", Config())
    queue = AsyncInferQueue(compiled, jobs=32)
    queue.set_callback(lambda request, userdata: ...)  # request.output_blobs
    queue.start_async({input_name: blob}, userdata=i)  # blocks when full
    queue.wait_all()

Deployment and debugging (``runtime/cache.py``, ``runtime/export.py``,
``runtime/profiling.py``):

    core.set_property({"CACHE_DIR": path})  # later compiles import from it
    compiled.export_model("net.ovpt")        # exe.export(...) in 1.0
    imported = core.import_model("net.ovpt") # no .xml/.bin, no passes
    exe.get_perf_counts({input_name: blob})  # {layer: status, exec_type, µs}
    exe.compiled().verify_against_interpreter({input_name: blob})
    exe.expected_result = {layer: golden}    # exe.last_compare_failures

Inputs bind by Parameter node name and outputs key by Result node name.  A
stateful network (ReadValue/Assign) keeps its variables between calls:
``exe.query_state()`` lists a ``VariableState`` per variable (``name``, the
``state`` getter and setter, ``reset()``), ``exe.reset_state()`` resets
them all, and ``net.reshape({input_name: (N, ...)})`` before
``load_network`` runs N streams in lockstep.  Each ``InferRequest`` on a
stateful network owns its own variables and runs inline, never through the
server.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import os
import queue as _queue
import threading
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from pyopenvino_tpu_torch.config import (
    KERNEL_TYPE_TO_BACKEND,
    Backend,
    Config,
    check_supported,
)
from pyopenvino_tpu_torch.ir import Model, read_ir_model
from pyopenvino_tpu_torch.ops import supported_ops
from pyopenvino_tpu_torch.runtime.interpreter import Interpreter
from pyopenvino_tpu_torch.utils.platform import select_device


class IENetwork:
    """The typed Model with the reference's net.inputs / net.outputs."""

    def __init__(self, model: Model):
        self._set_model(model)

    def _set_model(self, model: Model):
        self.model = model
        self.name = model.name
        self.inputs = [
            {"id": n.id, "name": n.name, "shape": n.outputs[n.out_port].shape}
            for n in model.parameters
        ]
        self.outputs = [
            {"id": n.id, "name": n.name, "shape": n.inputs[0].shape}
            for n in model.results
        ]

    def reshape(self, new_shapes: Dict[str, tuple]) -> "IENetwork":
        """Change input shapes before ``load_network`` (OpenVINO's
        ``IENetwork.reshape``): shape inference derives every port again,
        and an op that captured the old shape raises its own error."""
        from pyopenvino_tpu_torch.passes.shape_infer import reshape_model

        self._set_model(reshape_model(self.model, new_shapes))
        return self


class ExecutableNetwork:
    """A loaded network on one device with a selectable backend.
    Compilation is lazy and cached per configuration: setting
    ``kernel_type`` switches the backend that ``infer`` uses.  The
    INTERPRETER backend runs the numpy interpreter on the host."""

    def __init__(self, network: IENetwork, config: Config, device: torch.device):
        self.ienet = network
        self.config = config
        self.device = device
        self._compiled = {}
        self._compile_lock = threading.Lock()
        self._interpreter: Optional[Interpreter] = None
        self._calibration = None
        # the async request pool: its size, and the server behind it, made
        # and replaced under a lock (request threads ask for it at once)
        self.num_requests = 1
        self._server = None
        self._requests = None
        self._server_lock = threading.RLock()
        # the JAX package's debugging hooks: {layer name: golden activation}
        # checked on every infer, the layers that differed, and the
        # interpreter's node ids whose (node, inputs) it captures
        self.expected_result = None
        self.last_compare_failures = []
        self.capture_node_args = []

    @property
    def kernel_type(self) -> str:
        return self.config.backend.value

    @kernel_type.setter
    def kernel_type(self, value: str):
        if value not in KERNEL_TYPE_TO_BACKEND:
            raise ValueError(
                f"unknown kernel_type {value!r}; "
                f"accepted: {sorted(KERNEL_TYPE_TO_BACKEND)}"
            )
        self.config = self.config.replace(backend=KERNEL_TYPE_TO_BACKEND[value])

    def set_calibration(self, samples):
        """Representative {input_name: blob} dicts for INT8-FULL activation
        calibration (passes/calibrate.py) and bias correction; the compiled
        networks are dropped, since the scales change them.  A POT/NNCF IR
        whose activation FakeQuantizes give every conv and MatMul its scale
        compiles under INT8-FULL without them (passes/fold_fq.py)."""
        self._calibration = list(samples)
        self._compiled.clear()
        self.close()  # a running server serves the old scales

    def compiled(self):
        """The CompiledNetwork of the current configuration, compiled once
        even when request threads ask for it at the same time.  With a
        CACHE_DIR set (``IECore.set_config``), a cached artifact of the same
        model, config and samples is imported instead, with no pass and no
        calibration; a miss, or an entry that does not import, compiles and
        writes one (runtime/cache.py)."""
        check_supported(self.config)
        key = dataclasses.astuple(self.config)
        with self._compile_lock:
            if key not in self._compiled:
                self._compiled[key] = self._compile()
            return self._compiled[key]

    def _compile(self):
        from pyopenvino_tpu_torch.parallel.mesh import shard_declared
        from pyopenvino_tpu_torch.runtime.cache import cache_path
        from pyopenvino_tpu_torch.runtime.compiler import compile_model
        from pyopenvino_tpu_torch.runtime.export import (
            ARTIFACT_ERRORS, import_compiled, write_atomically,
        )

        # the cache holds the unsharded network, keyed without the mesh: a
        # mesh the Config declares is attached after it
        config = self.config.replace(mesh_data=1, mesh_model=1, mesh_spatial=1)
        path = cache_path(self.ienet.model, config, self._calibration)
        net = None
        if path is not None and os.path.exists(path):
            try:
                net = import_compiled(path, device=self.device).network
            except ARTIFACT_ERRORS as exc:  # a damaged entry: compile and rewrite it
                warnings.warn(f"CACHE_DIR entry {path} does not import ({exc!r}); "
                              f"compiling the network again")
        if net is None:
            net = compile_model(self.ienet.model, config, device=self.device,
                                calibration_samples=self._calibration)
            if path is not None:
                write_atomically(net, path)
        net.config = self.config
        return shard_declared(net, self.config)

    def _get_interpreter(self) -> Interpreter:
        if self._interpreter is None:
            self._interpreter = Interpreter(self.ienet.model)
        it = self._interpreter
        it.expected_result = self.expected_result
        it.capture_node_args = self.capture_node_args
        return it

    def infer(self, inputs: Dict[str, np.ndarray], verbose: bool = False
              ) -> Dict[str, np.ndarray]:
        """{Result name: array}.  With ``expected_result`` set, each named
        layer's activation of this run is held against its golden array
        (``utils/compare.compare_golden``, rtol 1) and the layers that
        differ are in ``last_compare_failures``: on the compiled path one
        run gives both the results and the activations, and a layer the
        compiled path folded or fused away is skipped.  ``verbose`` prints
        the interpreter's per-node times and the comparisons."""
        if self.config.backend == Backend.INTERPRETER:
            it = self._get_interpreter()
            out = it.run(inputs, verbose=verbose)
            self.last_compare_failures = list(it.last_compare_failures)
            return out
        compiled = self.compiled()
        if not self.expected_result:
            return compiled.infer(inputs)
        from pyopenvino_tpu_torch.utils.compare import compare_golden

        emitted = compiled.emitted_names()
        names = [n for n in self.expected_result if n in emitted]
        out, acts = compiled.infer_with_capture(inputs, names)
        self.last_compare_failures = [
            n for n in names
            if not compare_golden(n, acts[n], self.expected_result[n], rtol=1.0,
                                  verbose=verbose)]
        return out

    def infer_batch(self, inputs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        if self.config.backend == Backend.INTERPRETER:
            # the interpreter runs the declared (batch-1) graph once per
            # example; rows reshape to the declared input shape and the
            # outputs drop the declared unit batch dim, as on the compiled
            # path
            it = self._get_interpreter()
            declared = {p.name: p.outputs[p.out_port].shape
                        for p in self.ienet.model.parameters}
            n = np.asarray(next(iter(inputs.values()))).shape[0]
            per = [it.run({k: np.asarray(v[i]).reshape(declared[k])
                           for k, v in inputs.items()})
                   for i in range(n)]
            return {k: np.stack([p[k][0] for p in per], axis=0) for k in per[0]}
        return self.compiled().infer_batch(inputs)

    def get_perf_counts(self, inputs=None) -> Dict[str, dict]:
        """OpenVINO's per-layer counters, {layer name: {status, layer_type,
        exec_type, real_time_us}}.  ``kernel_type = "numpy"``: the measured
        time of each node of the last ``infer`` (exec_type ``numpy_ref``).
        Compiled backends: one ``CompiledNetwork.profile`` of ``inputs``
        (required), each layer's device time (host time on a CPU network)
        credited through its node's profiler range; ``exec_type`` names the
        port's kernel that ran (``fused_gemm_i8i8``, ``conv2d_direct``,
        ``softmax_rows`` ...), else the library kernel's or operator's name,
        ``host_only`` for a layer that launched nothing.  A layer folded at
        compile time or fused into an epilogue is ``NOT_RUN``.  An empty
        profile raises.  The profiler session ends with the call: on an
        H100, batch-1 latency after two of them read 1.03–1.21× the latency
        before, within the host's run-to-run spread (``chip_smoke.py``
        phase 4h, ``profile_after_cost``)."""
        if self.config.backend == Backend.INTERPRETER:
            it = self._get_interpreter()
            if not it.last_timings:
                raise RuntimeError("no interpreter run recorded — call infer() first")
            return {name: {"status": "EXECUTED", "layer_type": op_type,
                           "exec_type": "numpy_ref", "real_time_us": round(dt * 1e6, 2)}
                    for _, op_type, name, dt in it.last_timings}
        if inputs is None:
            raise ValueError("compiled-path perf counts profile a real execution — pass inputs")
        from pyopenvino_tpu_torch.runtime.profiling import exec_types

        rows = self.compiled().profile(inputs)
        if not rows:
            raise RuntimeError("the profile came back empty; use kernel_type='numpy' and "
                               "infer() for host-side counts")
        by_node = exec_types(rows)
        out = {}
        for node in self.ienet.model:
            if node.op_type in ("Const", "Parameter", "Result"):
                continue
            ran = by_node.get(f"{node.op_type}_{node.id}")
            out[node.name] = {
                "status": "EXECUTED" if ran else "NOT_RUN",
                "layer_type": node.op_type,
                "exec_type": ran[0] if ran else "",
                "real_time_us": ran[1] if ran else 0.0}
        return out

    def shard(self, mesh=None, tensor_parallel: bool = False,
              spatial_parallel: bool = False, data: int = 0,
              model: int = 1, spatial: int = 1):
        """Place this network on a device mesh (parallel/mesh.py
        ``shard_compiled``): a prebuilt ``Mesh``, or axis sizes on the
        default devices of the network's device type, ``data`` defaulting to
        all that the other axes leave.  Returns self; later ``infer_batch``
        calls run sharded, and a running async-request server is stopped so
        that the next one rounds its buckets to the data axis.

            exe.shard(model=2, tensor_parallel=True)    # DP×TP
            exe.shard(spatial=4, spatial_parallel=True)  # DP×SP
            exe.shard(build_mesh(MeshConfig(data=4), [torch.device("cuda:0")] * 4))
        """
        from pyopenvino_tpu_torch.parallel.mesh import (
            MeshConfig, build_mesh, default_devices, shard_compiled,
        )

        if mesh is None:
            n = len(default_devices(self.device.type))
            d = data or max(1, n // (model * spatial))
            mesh = build_mesh(MeshConfig(data=d, model=model, spatial=spatial),
                              devices=self.device.type)
        self.close()
        shard_compiled(self.compiled(), mesh, tensor_parallel=tensor_parallel,
                       spatial_parallel=spatial_parallel)
        return self

    def export(self, path: str, buckets=(8, 32)) -> None:
        """Write the compiled network into one artifact that
        ``IECore.import_network`` loads without the IR files, the passes or
        a calibration (runtime/export.py)."""
        if self.config.backend == Backend.INTERPRETER:
            raise ValueError("the interpreter backend has no compiled network to export; "
                             "use kernel_type 'torch' or 'kernels'")
        self.compiled().export(path, buckets=buckets)

    # -- variable state (ReadValue/Assign, ops/state_ops.py) -----------------

    def _state_holder(self):
        """The executor that carries the variables of this configuration:
        the numpy interpreter, or the compiled network (its state on the
        device)."""
        if self.config.backend == Backend.INTERPRETER:
            return self._get_interpreter()
        return self.compiled()

    @property
    def stateful(self) -> bool:
        return bool(self.ienet.model.find_by_type("ReadValue"))

    def query_state(self) -> list:
        """One VariableState per variable, sorted by variable id."""
        holder = self._state_holder()
        return [VariableState(holder, vid) for vid in sorted(holder.query_state())]

    def reset_state(self):
        """Every variable back to its init."""
        self._state_holder().reset_state()

    # -- async requests (serving/server.py) -----------------------------------

    @property
    def requests(self) -> list:
        """``num_requests`` InferRequests; on a stateless network they share
        one continuous-batching server, which starts here."""
        with self._server_lock:
            if self._requests is None:
                if not self.stateful:  # stateful requests run inline
                    self._ensure_server()
                self._requests = [InferRequest(self) for _ in range(max(1, self.num_requests))]
            return self._requests

    def _ensure_server(self):
        """The server of the current compiled network, started with every
        batch bucket warm; rebuilt when the configuration now yields another
        compiled network."""
        compiled = self.compiled()
        with self._server_lock:
            if self._server is not None and self._server.compiled is not compiled:
                self.close()
            if self._server is None:
                from pyopenvino_tpu_torch.serving import InferenceServer

                self._server = InferenceServer(
                    compiled, buckets=self.config.batch_buckets).start(warmup=True)
            return self._server

    def close(self):
        """Stop the async-request server, if one was started."""
        with self._server_lock:
            if self._server is not None:
                self._server.stop()
                self._server = None
                self._requests = None


class VariableState:
    """One ReadValue/Assign variable, OpenVINO's ``VariableState``: ``name``,
    ``state`` (get and set) and ``reset()``, on the executor that holds it."""

    def __init__(self, holder, name: str):
        self._holder = holder
        self.name = name

    @property
    def state(self) -> np.ndarray:
        return self._holder.query_state()[self.name]

    @state.setter
    def state(self, value):
        self._holder.set_state({self.name: value})

    def reset(self):
        """This variable back to its init, the others untouched; a dynamic
        (input-dependent) init is computed again at the next inference."""
        self._holder.reset_variable(self.name)

    def __repr__(self):
        return f"VariableState({self.name!r})"


class _StatefulStream:
    """One request's own variable state on a stateful network: the compiled
    network's ``step`` threads a state dict of its own through each call (a
    new dict each time, the caller's tensors never written), or, for
    ``kernel_type = "numpy"``, a private Interpreter holds it.  The state is
    made again when the configuration yields another compiled network."""

    def __init__(self, exe: ExecutableNetwork):
        self._exe = exe
        self._interp: Optional[Interpreter] = None
        self._state = None     # the compiled path's state dict
        self._compiled = None  # the network that state belongs to

    def _backend(self):
        """(interpreter, compiled network): exactly one is not None."""
        if self._exe.config.backend == Backend.INTERPRETER:
            if self._interp is None:
                self._interp = Interpreter(self._exe.ienet.model)
            return self._interp, None
        compiled = self._exe.compiled()
        if self._compiled is not compiled or self._state is None:
            self._compiled = compiled
            self._state = compiled.fresh_state()
        return None, compiled

    def infer(self, inputs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        interp, compiled = self._backend()
        if interp is not None:
            return interp.run(inputs)
        out, self._state = compiled.step(inputs, self._state)
        return out

    def query_state(self) -> Dict[str, np.ndarray]:
        interp, compiled = self._backend()
        if interp is not None:
            return interp.query_state()
        return compiled.state_to_host(self._state)

    def set_state(self, values: Dict[str, np.ndarray]):
        interp, compiled = self._backend()
        if interp is not None:
            interp.set_state(values)
        else:
            self._state = compiled.state_with(self._state, values)

    def reset_state(self):
        interp, compiled = self._backend()
        if interp is not None:
            interp.reset_state()
        else:
            self._state = compiled.fresh_state()

    def reset_variable(self, vid: str):
        interp, compiled = self._backend()
        if interp is not None:
            interp.reset_variable(vid)
        else:
            self._state = compiled.state_with_reset(self._state, vid)


class InferRequest:
    """One async request (OpenVINO's ``InferRequest``: ``start_async`` →
    ``wait`` → ``output_blobs``).  Requests of a stateless network submit to
    the network's continuous-batching server, where concurrent ones share a
    batch.  On a stateful network each request owns its variables
    (``_StatefulStream``), and ``start_async`` runs the step inline: a
    request's steps are sequential by definition.  ``ExecutableNetwork
    .infer`` keeps the network's own state, apart from every request's."""

    def __init__(self, exe: ExecutableNetwork):
        self._exe = exe
        self._future = None
        self.output_blobs: Dict[str, np.ndarray] = {}
        self._stream = _StatefulStream(exe) if exe.stateful else None

    def infer(self, inputs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        self.start_async(inputs)
        self.wait()
        return self.output_blobs

    def start_async(self, inputs: Dict[str, np.ndarray]) -> "InferRequest":
        if self._future is not None and not self._future.done():
            raise RuntimeError("request is already running; wait() first")
        if self._stream is not None:
            f = concurrent.futures.Future()
            try:
                f.set_result(self._stream.infer(inputs))
            except Exception as e:  # raised by wait(), as a served job's is
                f.set_exception(e)
            self._future = f
            return self
        self._future = self._exe._ensure_server().submit(inputs)
        return self

    def query_state(self) -> list:
        """One VariableState per variable: this request's own on a stateful
        network."""
        if self._stream is not None:
            return [VariableState(self._stream, vid)
                    for vid in sorted(self._stream.query_state())]
        return self._exe.query_state()

    def reset_state(self):
        if self._stream is not None:
            self._stream.reset_state()
        else:
            self._exe.reset_state()

    def wait(self, timeout: Optional[float] = None) -> int:
        """Block until the request's answer is in ``output_blobs``; 0 (OK)."""
        if self._future is None:
            return 0
        self.output_blobs = self._future.result(timeout=timeout)
        return 0

    def get_perf_counts(self, inputs=None) -> Dict[str, dict]:
        """The network's ``ExecutableNetwork.get_perf_counts``."""
        return self._exe.get_perf_counts(inputs)


class AsyncInferQueue:
    """OpenVINO 2.0's ``AsyncInferQueue``: ``jobs`` request slots and a
    completion callback.

        queue = AsyncInferQueue(compiled, jobs=4)
        queue.set_callback(lambda request, userdata: ...)
        for i, blob in enumerate(dataset):
            queue.start_async({"data": blob}, userdata=i)   # blocks when full
        queue.wait_all()

    The slots' requests coalesce in the network's server into shared
    batches; on a stateful network each slot runs inline on its own
    variables."""

    def __init__(self, compiled_model, jobs: int = 4):
        exe = getattr(compiled_model, "_exe", compiled_model)
        if not isinstance(exe, ExecutableNetwork):
            raise TypeError("AsyncInferQueue takes a CompiledModel or ExecutableNetwork")
        self._exe = exe
        self._requests = [InferRequest(exe) for _ in range(max(1, jobs))]
        self._idle = _queue.SimpleQueue()
        for i in range(len(self._requests)):
            self._idle.put(i)
        self._callback = None
        self._inflight = 0
        self._lock = threading.Lock()
        self._all_done = threading.Condition(self._lock)
        self._errors: list = []

    def __len__(self) -> int:
        return len(self._requests)

    def __getitem__(self, i: int) -> InferRequest:
        return self._requests[i]

    def __iter__(self):
        return iter(self._requests)

    def set_callback(self, callback):
        """``callback(request, userdata)``, run when a job completes, with
        ``request.output_blobs`` filled."""
        self._callback = callback

    def is_ready(self) -> bool:
        """True when a slot is idle (``start_async`` would not block)."""
        return not self._idle.empty()

    def _finish(self, idx: int):
        self._idle.put(idx)
        with self._all_done:
            self._inflight -= 1
            if self._inflight == 0:
                self._all_done.notify_all()

    def _complete(self, req: InferRequest, idx: int, userdata, answer):
        """Fill the slot's answer, run the callback, free the slot; an error
        of either is kept for ``wait_all``."""
        try:
            req.output_blobs = answer()
            if self._callback is not None:
                self._callback(req, userdata)
        except Exception as e:  # noqa: BLE001 — raised by wait_all
            with self._lock:
                self._errors.append(e)
        finally:
            self._finish(idx)

    def start_async(self, inputs: Dict[str, np.ndarray], userdata=None):
        """Submit one inference; blocks until a slot is free.  A request the
        server refuses raises here, and its slot is free again."""
        idx = self._idle.get()  # blocks while every job is in flight
        req = self._requests[idx]
        with self._lock:
            self._inflight += 1
        if req._stream is not None:
            # stateful: inline on the slot's own variables
            self._complete(req, idx, userdata, lambda: req._stream.infer(inputs))
            return
        try:
            fut = self._exe._ensure_server().submit(inputs)
        except Exception:
            self._finish(idx)
            raise
        req._future = fut
        fut.add_done_callback(
            lambda f: self._complete(req, idx, userdata, f.result))

    def wait_all(self, timeout: Optional[float] = None):
        """Block until every submitted job has completed; raise the first
        inference or callback error."""
        with self._all_done:
            if not self._all_done.wait_for(lambda: self._inflight == 0, timeout=timeout):
                raise TimeoutError(f"{self._inflight} job(s) still in flight")
            if self._errors:
                raise self._errors[0]


class IECore:
    def __init__(self):
        self.supported = set(supported_ops())

    def set_config(self, config: Dict[str, object], device_name: str = "GPU"):
        """OpenVINO 1.0's ``ie.set_config``: ``CACHE_DIR`` (a path, or ""
        to turn the cache off; process-wide, runtime/cache.py).  Any other
        key raises."""
        from pyopenvino_tpu_torch.runtime.cache import disable_model_cache, enable_model_cache

        for key, value in config.items():
            if key != "CACHE_DIR":
                raise ValueError(f"unsupported config key {key!r}")
            if value:
                enable_model_cache(str(value))
            else:
                disable_model_cache()

    def get_config(self, device_name: str = "GPU", name: str = "CACHE_DIR"):
        """``CACHE_DIR``: its absolute path, or "" when the cache is off."""
        if name != "CACHE_DIR":
            raise ValueError(f"unsupported config key {name!r}")
        from pyopenvino_tpu_torch.runtime.cache import current_cache_dir

        return current_cache_dir() or ""

    def import_network(self, path: str, device_name: str = "GPU"):
        """Load an artifact that ``ExecutableNetwork.export`` wrote onto the
        device named (the card unless ``"CPU"``): an ``ImportedNetwork``,
        built without the IR files, the passes or a calibration."""
        from pyopenvino_tpu_torch.runtime.export import import_compiled

        return import_compiled(path, device=_device(device_name))

    def get_metric(self, device_name: str = "GPU", name: str = ""):
        """OpenVINO 1.0's ``ie.get_metric`` for the device keys deployment
        scripts read, from ``torch.cuda`` (``"CPU"``: one device)."""
        cpu = _device(device_name).type == "cpu"
        if name == "AVAILABLE_DEVICES":
            return ["0"] if cpu else [str(i) for i in range(torch.cuda.device_count())]
        if name == "FULL_DEVICE_NAME":
            return "CPU" if cpu else f"GPU:{torch.cuda.get_device_name(0)}"
        if name == "SUPPORTED_METRICS":
            return ["AVAILABLE_DEVICES", "FULL_DEVICE_NAME", "SUPPORTED_METRICS"]
        raise ValueError(f"unsupported metric {name!r}")

    def read_network(self, model: str, weights: Optional[str] = None) -> IENetwork:
        return IENetwork(read_ir_model(model, weights))

    def check_nodes(self, network: IENetwork):
        """Fail-fast unsupported-op check, nested bodies included."""
        def op_types(model):
            for n in model.nodes.values():
                yield n.op_type
                for sg in (n.subgraphs or {}).values():
                    yield from op_types(sg.model)

        unsupported = set(op_types(network.model)) - self.supported
        if unsupported:
            raise ValueError(f"unsupported node types: {sorted(unsupported)}")

    def query_network(self, network: IENetwork, device_name: str = "GPU") -> Dict[str, str]:
        """OpenVINO's ``IECore.query_network``: {layer name: device} for
        every top-level layer the device supports; unsupported layers are
        left out."""
        return {n.name: device_name for n in network.model.nodes.values()
                if n.op_type in self.supported}

    def load_network(
        self,
        network: IENetwork,
        device_name: str = "GPU",
        num_requests: int = 1,
        config: Optional[Config] = None,
    ) -> ExecutableNetwork:
        """``"GPU"`` runs on ``torch.device("cuda")`` and raises when PyTorch
        sees no CUDA device.  ``"CPU"`` runs the same compiled path on CPU
        tensors, where each kernel wrapper takes its plain PyTorch version.
        (In the JAX package ``"CPU"`` selects the numpy interpreter; here
        ``kernel_type = "numpy"`` does, on either device.)  ``num_requests``
        sizes ``ExecutableNetwork.requests``."""
        self.check_nodes(network)
        exe = ExecutableNetwork(network, config or Config(), _device(device_name))
        exe.num_requests = num_requests
        return exe


def _device(device_name: str) -> torch.device:
    """``"GPU"``: the card, refused where PyTorch sees none; ``"CPU"``."""
    if device_name.upper() not in ("GPU", "CPU"):
        raise ValueError(f"unknown device {device_name!r}: 'GPU' or 'CPU'")
    return select_device(device_name)


class CompiledModel:
    """The OpenVINO 2.0 handle over an ExecutableNetwork: callable, with
    infer requests for the async workflow."""

    def __init__(self, exe: ExecutableNetwork):
        self._exe = exe

    def __call__(self, inputs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        return self._exe.infer(inputs)

    def infer_new_request(self, inputs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        return self._exe.infer(inputs)

    def create_infer_request(self) -> InferRequest:
        return InferRequest(self._exe)

    def export_model(self, path: str, buckets=(8, 32)) -> None:
        """OpenVINO 2.0's ``export_model``: ``ExecutableNetwork.export``."""
        self._exe.export(path, buckets=buckets)

    @property
    def inputs(self):
        return self._exe.ienet.inputs

    @property
    def outputs(self):
        return self._exe.ienet.outputs


class Core:
    """OpenVINO 2.0's entry point (``openvino.Core``) on the engine that
    IECore drives:

        core = Core()
        model = core.read_model("net.xml")          # has .reshape()
        compiled = core.compile_model(model)        # "GPU" unless named
        out = compiled({"data": blob})              # or infer requests
    """

    def __init__(self):
        self._ie = IECore()

    def read_model(self, model: str, weights: Optional[str] = None) -> IENetwork:
        return self._ie.read_network(model, weights)

    def set_property(self, properties: Dict[str, object]):
        """OpenVINO 2.0's ``core.set_property``: ``IECore.set_config``'s keys
        (``CACHE_DIR``)."""
        self._ie.set_config(properties)

    def get_property(self, device_name: str = "GPU", name: str = "CACHE_DIR"):
        """A config key (``CACHE_DIR``), else a device metric of
        ``IECore.get_metric``."""
        try:
            return self._ie.get_config(device_name, name)
        except ValueError:
            return self._ie.get_metric(device_name, name)

    def compile_model(self, model: IENetwork, device_name: str = "GPU",
                      config=None) -> CompiledModel:
        """``config``: a Config, or OpenVINO's properties dict, which goes to
        ``set_property`` ({"CACHE_DIR": path})."""
        if isinstance(config, dict):
            self.set_property(config)
            config = None
        return CompiledModel(self._ie.load_network(model, device_name, config=config))

    def import_model(self, path: str, device_name: str = "GPU"):
        """OpenVINO 2.0's ``import_model``: ``IECore.import_network``."""
        return self._ie.import_network(path, device_name)
