"""Graph compiler: typed IR → weights on the device + an emission plan that
runs the graph eagerly in PyTorch.

Counterpart of ``pyopenvino_tpu/runtime/compiler.py``.  Where the JAX package
traces the graph into one jitted XLA program, the port walks the same
topological order on every call and runs each op's ``emit`` on device
tensors:

  * constant folding — statically known values (reshape targets, SSD's
    ShapeOf → StridedSlice → PriorBoxClustered → Unsqueeze → Concat anchor
    chains) are consumed at compile time and their nodes never run; a
    folded value that a running op reads (SSD's anchor table) is put on the
    device once and reused by every call;
  * weights are decoded once onto the device, keyed exactly like the JAX
    package's weight pytree (``str(node_id)``, ``folded.{src}.{sport}``;
    under INT8 weight-only a quantized weight is ``str(node_id)`` as int8
    codes plus ``{node_id}.scale`` as float32 per-channel scales) and kept
    in the IR layout, so checkpoints move between the two packages;
  * epilogue fusion (passes/fuse.py): a Conv/GroupConv/MatMul root emits
    its bias and activation, and the absorbed Add/ReLU/Clamp nodes are
    skipped;
  * batch is native in N: ``infer_batch`` runs the graph compiled at batch B
    (passes/shape_infer.py bake_batch), with no vmap;
  * INT8-FULL: each conv-family and MatMul data input carries a calibrated
    per-tensor scale (passes/calibrate.py); on the TORCH backend, as on the
    JAX package's XLA backend, qualifying edges are stored as int8 codes
    between ops (``_find_int8_edges``), and an int8 value reaching an op
    port that does not take one is dequantized first;
  * the bodies of TensorIterator, Loop and If (ops/subgraph.py) run through
    a ``BodyWalk`` each, built once here: their Consts are weights under
    ``sub.<node id>.<body name>.<const id>`` in the compute dtype, never
    quantized (the quantize pass does not enter bodies, in either
    package), and a body runs with no fusion, no activation scales and no
    int8 storage, as the JAX package's ``_emit_graph`` traces it;
  * variable state (ReadValue/Assign, ops/state_ops.py): a stateful network
    keeps ``state``, a dict of device tensors, from one call to the next.
    Each ReadValue reads it; each Assign's write is staged and committed
    after the walk, after a dynamic init's commit (the assignment is the
    next state), so a write is seen by the NEXT call even where an Assign
    comes before its ReadValue.  A dynamic-init variable (an init that
    depends on the inputs) carries a ``fresh`` flag, a Python bool beside
    its tensor: the first call after a reset reads the init's value.
    ``step`` and ``fresh_state`` run a caller's own state dict (the unit of
    a request's state); ``infer_batch`` refuses a stateful network, whose
    batch is baked into the IR instead (``IENetwork.reshape``);
  * a device mesh (``parallel/mesh.py``, ``shard_compiled``): the walk
    hands every op node to its data row's ``Walk``, which runs the
    tensor-parallel shards and the spatial row blocks, each on its own
    device of the mesh with that device's copy of the weights, and
    ``infer_batch`` splits its batch into the data axis' blocks;
  * debugging and deployment, the JAX package's methods:
    ``save_weights`` / ``load_weights`` (its checkpoint form),
    ``capture_activations`` and ``verify_against_interpreter`` (a fused
    chain's value is its last node's, so a root or an Add inside one is
    skipped), ``profile`` (one forward under ``torch.profiler`` with each
    node's emit in a range of its own, entered only while it runs) and
    ``export`` (``runtime/export.py``).

Floats are in ``Config.compute_dtype``, float32 or bfloat16, in the JAX
package's order: float weights, INT8 scales (``{nid}.scale``) and corrected
biases are cast to it when the weights are built; a float Parameter is cast
to it on the device after the copy (an integer one, a u8 image from
``preprocess.py``, crosses as its own type, 1 byte a pixel); every product
sums in float32 and rounds once to the compute dtype after its epilogue;
each Result goes back to its declared dtype.  Float32 on the card means
full float32: compiling a float32 network sets
``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` to False.  These flags are process-wide
and stay set for every later PyTorch call in the process.
"""

from __future__ import annotations

import copy
import threading
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from pyopenvino_tpu_torch.config import Backend, Config, QuantMode, check_supported
from pyopenvino_tpu_torch.ir.model import Model
from pyopenvino_tpu_torch.ops import get_op
from pyopenvino_tpu_torch.ops.spec import TValue, torch_dtype
from pyopenvino_tpu_torch.ops.state_ops import initial_state, model_variables, variable_id
from pyopenvino_tpu_torch.parallel.mesh import (
    Rows,
    emit_node,
    run_batch,
    shard_compiled,
    shard_declared,
    walk_for,
    weight_part,
    weights_for,
)
from pyopenvino_tpu_torch.passes.calibrate import QUANTIZABLE
from pyopenvino_tpu_torch.passes.fold_fq import extract_act_scales, fold_fake_quantize
from pyopenvino_tpu_torch.passes.fold_scale import fold_scale_into_conv
from pyopenvino_tpu_torch.passes.shape_infer import (
    ShapeAnalysis,
    bake_batch,
    infer_shapes,
)
from pyopenvino_tpu_torch.passes.util import folded_nodes, prune_dead_nodes

# (op_type, input_port) pairs consumed at compile time — never emitted.
STATIC_PORTS = {
    ("Reshape", 1),
    ("Transpose", 1),
    ("Unsqueeze", 1),
    ("StridedSlice", 1),
    ("StridedSlice", 2),
    ("StridedSlice", 3),
    ("PriorBoxClustered", 0),
    ("PriorBoxClustered", 1),
    ("LRN", 1),  # axes input: LRN normalizes across channels
    # a variable's init: its static value is the initial state, and a
    # dynamic one is read by the ReadValue itself on a fresh state
    ("ReadValue", 0),
}

# Folded values larger than this that a running op reads become entries of
# the weight dict; smaller ones are materialized where they are read.
_INLINE_LIMIT = 1 << 16

# npz cannot hold bfloat16: the JAX package stores bf16 arrays as uint16 bit
# patterns under this key suffix (compiler.py save_weights).
_BF16_TAG = "::bf16"

# state-dict key suffix of a dynamic-init variable's fresh flag
_FRESH = "::fresh"

# A node's profiler range (``CompiledNetwork.profile``): a RecordFunction of
# the scope PyTorch gives its own operators, so that the profiler correlates
# every kernel launched inside it, a ctypes or Triton launch included, with
# the range.  ``torch.profiler.record_function`` opens a user scope, under
# which the port's own kernels are credited to no host event.
_RecordFunctionFast = torch._C._profiler._RecordFunctionFast


class EmitCtx:
    """Services handed to every op's ``emit``."""

    # weight-dict key prefix of this graph's Consts: "" for the network,
    # ``sub.<node id>.<body name>.`` for a body (BodyWalk)
    weight_prefix = ""

    # the model index whose weight slices a tensor-parallel shard reads
    # (parallel/mesh.py), None for the whole weights
    shard = None

    def __init__(self, net: "CompiledNetwork", model: Model, analysis: ShapeAnalysis,
                 device=None):
        self.net = net
        self.model = model
        self.analysis = analysis
        # the device this walk runs on
        self.device = net.device if device is None else device

    @property
    def weights(self):
        """The weights as this walk's device reads them (parallel/mesh.py)."""
        return weights_for(self.net, self.device)

    def on(self, device, shard=None) -> "EmitCtx":
        """This context on another device of the mesh, or for one model
        index's weight slices (``shard``)."""
        ctx = copy.copy(self)
        ctx.device, ctx.shard = device, shard
        return ctx

    @property
    def use_kernels(self) -> bool:
        return self.net.config.backend == Backend.KERNELS

    @property
    def depthwise_mode(self) -> str:
        return self.net.config.depthwise_mode

    @property
    def full_int8(self) -> bool:
        return self.net.config.quant == QuantMode.INT8_FULL

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.net.compute_dtype

    def act_scale(self, node) -> Optional[float]:
        """Calibrated per-tensor scale of ``node``'s data input, if any."""
        return self.net.act_scales.get(node.id)

    def out_int8_scale(self, node) -> Optional[float]:
        """Storage scale if ``node``'s output edge is stored as int8."""
        return self.net._int8_edges.get((node.id, node.out_port))

    def static_value(self, node, port: int) -> np.ndarray:
        src, sport = self.model.in_edges[node.id][port]
        val = self.analysis.value(src, sport)
        if val is None:
            raise ValueError(
                f"{node.op_type} {node.name!r}: input port {port} must be "
                f"compile-time constant"
            )
        return val

    def derived_weight(self, node, port: int, tag: str,
                       make: Callable[[torch.Tensor], torch.Tensor]):
        """``make(weight)`` for the weight feeding ``node``'s ``port``,
        cached per weight key when that input is a weight (a GEMM-ready
        (K, N) matrix, say).  The cache is dropped when weights are
        loaded."""
        src, _sport = self.model.in_edges[node.id][port]
        key = self.weight_prefix + str(src)
        if key not in self.net.weights:
            raise ValueError(
                f"{node.op_type} {node.name!r}: port {port} is not a weight")
        weight = (self.weights[key] if self.shard is None
                  else weight_part(self.net, self.device, key, self.shard))
        # int8 and f32 never share an entry; on a mesh, every other device
        # and every model index's slice has its own (parallel/mesh.py)
        ckey = (key, tag, weight.dtype)
        if self.shard is not None or self.device != self.net.device:
            ckey += (self.device, self.shard)
        cache = self.net._derived
        if ckey not in cache:
            cache[ckey] = make(weight)
        return cache[ckey]

    def run_body(self, node, bname: str, feeds: Dict[int, torch.Tensor]) -> Dict[int, torch.Tensor]:
        """One run of ``node``'s body ``bname``: {body Parameter layer id:
        tensor} → {body Result layer id: tensor}."""
        walk = self.net._bodies[self.weight_prefix, node.id, bname]
        return walk.run(feeds) if self.device == self.net.device else walk.run(feeds, self)

    @staticmethod
    def weight_for(node, tv: TValue) -> torch.Tensor:
        """A weight operand in the compute dtype: int8 codes are dequantized
        on every call (``codes * scale`` in the scale's dtype, which is the
        compute dtype: the JAX package's ``weight_for``), so no float copy
        of a quantized weight outlives the call."""
        if tv.qscale is None:
            return tv.arr
        return tv.arr.to(tv.qscale.dtype) * tv.qscale


class _BodyCtx(EmitCtx):
    """A body's EmitCtx: its Consts under its weight prefix, and no
    activation scales or int8 storage (body node ids are scoped to the
    body, and the JAX package's body EmitCtx carries neither)."""

    def __init__(self, net, model, analysis, prefix):
        super().__init__(net, model, analysis)
        self.weight_prefix = prefix

    def act_scale(self, node):
        return None

    def out_int8_scale(self, node):
        return None


def _traced_consts(model: Model, folded) -> List[int]:
    """Const nodes with at least one consumer that runs."""
    return sorted(
        n.id for n in model.find_by_type("Const")
        if any(dst not in folded and (model.nodes[dst].op_type, dport) not in STATIC_PORTS
               for _, dst, dport in model.out_edges[n.id]))


def body_const_weights(node, prefix: str = "") -> Dict[str, np.ndarray]:
    """{weight key: value} of every Const that a running node of one of
    ``node``'s bodies reads, recursing into nested bodies: the JAX
    package's ``body_const_weights`` keys, ``<prefix>sub.<node id>.<body
    name>.<const id>``."""
    from pyopenvino_tpu_torch.ops.subgraph import body_analysis

    out = {}
    for bname, sg in (node.subgraphs or {}).items():
        p = f"{prefix}sub.{node.id}.{bname}."
        body = sg.model
        for cid in _traced_consts(body, folded_nodes(body, body_analysis(sg))):
            if body.nodes[cid].const is None:
                raise RuntimeError(f"body Const {body.nodes[cid].name!r} has no weights")
            out[p + str(cid)] = body.nodes[cid].const
        for bn in body.nodes.values():
            if bn.subgraphs:
                out.update(body_const_weights(bn, p))
    return out


class BodyWalk:
    """A body's emission plan, built once when the network is compiled: the
    body's topological order less its Consts, folded nodes and Results,
    each running node's op and input sources (``STATIC_PORTS`` skipped),
    its Const weights' keys and its small folded values on the device.
    ``run`` emits the body on device tensors; the JAX package's
    ``_emit_graph`` with no trace to reuse."""

    def __init__(self, net: "CompiledNetwork", node, bname: str, sg, prefix: str = ""):
        from pyopenvino_tpu_torch.ops.subgraph import body_analysis

        self.net = net
        model = sg.model
        analysis = body_analysis(sg)
        self.prefix = f"{prefix}sub.{node.id}.{bname}."
        self.ctx = _BodyCtx(net, model, analysis, self.prefix)
        folded = folded_nodes(model, analysis)
        consts = set(_traced_consts(model, folded))
        self.params = []   # (layer id, port, shape, dtype on the device)
        self.steps = []    # (node, op, [(port, source key)])
        self.results = []  # (layer id, source key, dtype)
        self.static = {}   # (src, sport) → folded value on the device
        cdt = net.compute_dtype

        def source(src, sport):
            if src in consts:
                return self.prefix + str(src)
            if model.nodes[src].op_type != "Const" and src not in folded:
                return (src, sport)
            val = analysis.value(src, sport)
            if val is None:
                raise RuntimeError(
                    f"body: no traced or static value for layer {src} port {sport}")
            self.static[(src, sport)] = torch.as_tensor(np.array(val), device=net.device)
            return (src, sport)

        for bn in model:
            if bn.op_type == "Parameter":
                info = bn.outputs[bn.out_port]
                self.params.append((bn.id, bn.out_port, tuple(info.shape),
                                    cdt if np.issubdtype(info.dtype, np.floating)
                                    else torch_dtype(info.dtype)))
            elif bn.op_type == "Result":
                decl = bn.inputs[0].dtype
                self.results.append((bn.id, source(*model.in_edges[bn.id][0]),
                                     cdt if np.issubdtype(decl, np.floating)
                                     else torch_dtype(decl)))
            elif bn.op_type != "Const" and bn.id not in folded:
                op = get_op(bn.op_type)
                ins = [(port, source(src, sport))
                       for port, (src, sport) in sorted(model.in_edges[bn.id].items())
                       if (bn.op_type, port) not in STATIC_PORTS]
                self.steps.append((bn, op, ins))
                if bn.subgraphs:
                    for sub_name, sub in bn.subgraphs.items():
                        net._bodies[self.prefix, bn.id, sub_name] = BodyWalk(
                            net, bn, sub_name, sub, self.prefix)

    def run(self, feeds: Dict[int, torch.Tensor], caller: Optional[EmitCtx] = None
            ) -> Dict[int, torch.Tensor]:
        """The body on the device of ``caller`` (its node's context), the
        network's own by default."""
        ctx = self.ctx
        if caller is not None and caller.device != ctx.device:
            ctx = ctx.on(caller.device)
        weights = ctx.weights
        values: Dict[Tuple[int, int], TValue] = {}
        for pid, port, shape, dtype in self.params:
            x = feeds[pid].reshape(shape).to(dtype)
            if x.dim() == 4:
                x = x.contiguous(memory_format=torch.channels_last)
            values[(pid, port)] = TValue(x)

        def tv(key):
            if isinstance(key, str):
                return TValue(weights[key])
            if key in values:
                return values[key]
            return TValue(self.static[key].to(ctx.device))

        for bn, op, ins in self.steps:
            for port, out in op.emit(ctx, bn, {port: tv(key) for port, key in ins}).items():
                values[(bn.id, port)] = out
        return {rid: tv(key).arr.to(dtype) for rid, key, dtype in self.results}


class CompiledNetwork:
    def __init__(self, model: Model, config: Optional[Config] = None,
                 device="cuda",
                 quantized: Optional[Dict[int, Tuple[np.ndarray, np.ndarray]]] = None,
                 act_scales: Optional[Dict[int, float]] = None,
                 bias_corr: Optional[Dict[int, np.ndarray]] = None,
                 weights: Optional[Dict[str, torch.Tensor]] = None,
                 mesh=None):
        """``quantized``, ``act_scales`` and ``bias_corr`` are what
        ``prepare_model`` returns: {const id: (int8 codes, float32
        scales)}, {consumer node id: activation scale} (INT8-FULL) and
        {bias const id: per-channel delta}, in the JAX package's forms.
        ``weights``, where given, are the compiled weights themselves
        (``save_weights``' keys, an imported network's): they are moved to
        the device as they are, and no weight is built from the Consts.
        ``mesh`` (parallel/mesh.py): the network runs infer_batch data
        parallel over it (``shard_compiled`` places it otherwise)."""
        self.config = config or Config()
        check_supported(self.config)
        self.device = torch.device(device)
        self.compute_dtype = getattr(torch, self.config.compute_dtype)  # config.COMPUTE_DTYPES
        if self.compute_dtype == torch.float32:
            # full float32 everywhere, dequantized int8 weights included:
            # cuDNN convs default to TF32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

        self.model = model
        self.analysis = infer_shapes(model)
        self._folded_nodes = folded_nodes(model, self.analysis)
        self._runtime_consts = self._find_runtime_consts()

        from pyopenvino_tpu_torch.passes.fuse import find_fusions

        self._fusions = find_fusions(model, self.analysis)
        self._fused_skip = {
            nid for f in self._fusions.values() for nid in f.skip
        }
        self._quantized = quantized or {}
        self.act_scales = act_scales or {}
        self._bias_corr = bias_corr or {}
        self._int8_edges = self._find_int8_edges()
        # {variable_id: its description} (ops/state_ops.py) and the state
        # of the network's own calls, {variable_id: device tensor} made at
        # the first call or reset
        self.variables = model_variables(model, self.analysis)
        self.state: Optional[Dict[str, object]] = None
        self.weights: Dict[str, torch.Tensor] = (
            self._build_weights() if weights is None
            else {k: v.to(self.device) for k, v in weights.items()})
        # {(weight prefix, node id, body name): BodyWalk} of every body,
        # nested ones included
        self._bodies: Dict[Tuple[str, int, str], BodyWalk] = {}
        for node in model:
            for bname, sg in (node.subgraphs or {}).items():
                self._bodies["", node.id, bname] = BodyWalk(self, node, bname, sg)
        self._derived: Dict[Tuple[str, str, torch.dtype], torch.Tensor] = {}
        # small folded values that running ops read, on the device:
        # {(id of the plan's analysis, src, sport): tensor}
        self._static: Dict[Tuple[int, int, int], torch.Tensor] = {}
        # batch → (model, analysis) compiled at that batch (infer_batch),
        # filled under a lock: a serving thread and the caller's may ask for
        # one batch at once, and a second analysis of it would leave
        # ``_static`` entries keyed by the id of one that is gone
        self._batched: Dict[int, Tuple[Model, ShapeAnalysis]] = {}
        self._bake_lock = threading.Lock()
        self.input_names = [n.name for n in model.parameters]
        self.output_names = [n.name for n in model.results]
        # each node's emit inside a profiler range (``_node_ranges``): only
        # while ``profile`` runs, so a normal call walks the bare node list
        self._ranges = False
        # the profiler's own total of the last ``profile``, in microseconds
        self.last_profile_us: Optional[float] = None
        # the device mesh and what shard_compiled (parallel/mesh.py) sets:
        # {weight key: its spec}, infer_batch's batch spec, the SP axis, and
        # the weights other devices of the mesh read: {device: {key: copy}}
        # and {(device, key, model index): slice}
        self.mesh = None
        # Results returned in the dtype the walk holds them in, not their
        # declared one: a pipeline stage's cut tensor (parallel/pipeline.py)
        self._keep_dtype = frozenset()
        self._w_specs: Dict[str, tuple] = {}
        self._batch_pspec = None
        self._spatial_axis: Optional[str] = None
        self._tensor_parallel = False
        self._placed: Dict[torch.device, Dict[str, torch.Tensor]] = {}
        self._parts: Dict[tuple, torch.Tensor] = {}
        if mesh is not None:
            shard_compiled(self, mesh)

    # -- graph partitioning -------------------------------------------------

    def _find_runtime_consts(self):
        """Const nodes with at least one consumer that runs."""
        runtime = set()
        for node in self.model.find_by_type("Const"):
            for _sport, dst, dport in self.model.out_edges[node.id]:
                if (self.model.nodes[dst].op_type, dport) in STATIC_PORTS:
                    continue
                if dst in self._folded_nodes:
                    continue
                runtime.add(node.id)
                break
        return runtime

    def _find_int8_edges(self) -> Dict[Tuple[int, int], float]:
        """INT8-FULL storage decision, {(src, sport): scale} for every
        emitted tensor that travels as int8 codes: the JAX package's
        ``_find_int8_edges`` (runtime/compiler.py:235-356) with XLA → TORCH.

        Backward demand over the fused graph (a fused group produces at its
        chain end).  Each consumer of a tensor yields a storage scale:

          * a conv-family or MatMul data input with a calibrated scale and
            an int8 weight (a sink) yields that scale;
          * MaxPool / ReLU (exact carries) yield their own output edge's
            demand;
          * Concat (a carry: int8 once every input is stored at one scale)
            yields its output edge's demand to all its inputs;
          * LRN and AvgPool (accepters: float inside, dequantized on read)
            yield the calibrated scale of their input;
          * anything else blocks storage of the edge (a TensorIterator,
            Loop or If among them; their bodies never store int8, as the
            JAX package leaves bodies alone).

        A tensor is stored at max(yielded scales) when every emitted
        consumer yields one."""
        if (
            self.config.quant != QuantMode.INT8_FULL
            or not self.act_scales
            or self.config.backend != Backend.TORCH
            or not self.config.int8_dataflow
        ):
            return {}
        model = self.model
        roots = ("Convolution", "GroupConvolution", "MatMul")
        memo: Dict[Tuple[int, int], Optional[float]] = {}

        def demand(key: Tuple[int, int]) -> Optional[float]:
            if key in memo:
                return memo[key]
            memo[key] = None  # DAG, but guard anyway
            src, sport = key
            scales: List[float] = []
            for p, dst, dport in model.out_edges[src]:
                if p != sport or dst in self._folded_nodes:
                    continue  # a folded consumer never reads the tensor
                dn = model.nodes[dst]
                if dn.op_type in roots and dport == 0:
                    s = self.act_scales.get(dst)
                    w_src = model.in_edges[dst].get(1)
                    if s is None or w_src is None or w_src[0] not in self._quantized:
                        return None
                elif dn.op_type in ("MaxPool", "ReLU") and dport == 0:
                    s = demand((dst, dn.out_port))
                elif dn.op_type == "Concat" and dst not in self._fused_skip:
                    s = demand((dst, dn.out_port))
                elif dn.op_type in ("LRN", "AvgPool") and dport == 0:
                    s = self.act_scales.get(dst)
                else:
                    return None
                if s is None:
                    return None
                scales.append(s)
            if not scales:
                return None  # no emitted consumer (or Result only)
            memo[key] = max(scales)
            return memo[key]

        produced = [f.out_key for f in self._fusions.values()]
        for node in model:
            if node.op_type in ("Const", "Parameter", "Result"):
                continue
            if (node.id not in self._fusions and node.id not in self._folded_nodes
                    and node.id not in self._fused_skip):
                produced += [(node.id, port) for port in node.outputs]
        out = {}
        for key in produced:
            s = demand(key)
            if s is not None:
                out[key] = s
        return out

    def _build_weights(self) -> Dict[str, torch.Tensor]:
        """Weight dict on the device, in IR layout.  Float weights are in
        the compute dtype; a quantized weight ({const id: (codes, scales)},
        passes/quantize.py) is its int8 codes under ``str(nid)`` and its
        keepdims scales, in the compute dtype, under ``f"{nid}.scale"``; a
        bias with a correction (passes/bias_correct.py) has it added, then
        is cast.  The casts round float32 to bfloat16 to nearest even, as
        ``jnp.asarray(x, dtype=bfloat16)`` does."""
        weights = {}

        def put(key, arr, dtype=None):
            t = torch.from_numpy(np.array(arr, order="C", copy=True))
            if dtype is not None:
                t = t.to(dtype)
            weights[key] = t.to(self.device)

        for nid in sorted(self._runtime_consts):
            node = self.model.nodes[nid]
            if node.const is None:
                raise RuntimeError(
                    f"Const {node.name!r} has no weights; synthesize a .bin "
                    f"(pyopenvino_tpu_torch/models/synth.py) or load one"
                )
            if nid in self._quantized:
                codes, scales = self._quantized[nid]
                put(str(nid), codes)
                put(f"{nid}.scale", scales.astype(np.float32, copy=False), self.compute_dtype)
            elif nid in self._bias_corr:
                corr = self._bias_corr[nid].reshape(node.const.shape)
                put(str(nid), (node.const + corr).astype(np.float32, copy=False),
                    self.compute_dtype)
            elif np.issubdtype(node.const.dtype, np.floating):
                put(str(nid), node.const.astype(np.float32, copy=False), self.compute_dtype)
            else:
                put(str(nid), node.const)

        # body Consts, in the compute dtype where float, never quantized
        for node in self.model:
            for key, val in body_const_weights(node).items():
                floating = np.issubdtype(val.dtype, np.floating)
                put(key, val.astype(np.float32, copy=False) if floating else val,
                    self.compute_dtype if floating else None)

        # large folded values read by running ops live beside the weights
        for (src, sport), val in self.analysis.values.items():
            if val.size <= _INLINE_LIMIT:
                continue
            if self.model.nodes[src].op_type == "Const":
                continue
            read = any(
                dst not in self._folded_nodes
                and (self.model.nodes[dst].op_type, dport) not in STATIC_PORTS
                for p, dst, dport in self.model.out_edges[src]
                if p == sport
            )
            if read:
                weights[f"folded.{src}.{sport}"] = torch.from_numpy(
                    np.array(val)).to(self.device)
        return weights

    # -- emission ------------------------------------------------------------

    def _stage(self, inputs, device) -> Dict[str, torch.Tensor]:
        """The Parameters' values copied to ``device`` (``_stage_one``)."""
        return {n.name: self._stage_one(inputs[n.name], n.outputs[n.out_port].dtype, device)
                for n in self.model.parameters}

    def _input_tensor(self, value, shape, dtype, device=None) -> torch.Tensor:
        """A Parameter's value on ``device`` (the network's by default),
        ``_stage``d there or a host array, cast to the compute dtype there
        where it is float."""
        device = self.device if device is None else device
        if not isinstance(value, torch.Tensor):
            value = self._stage_one(value, dtype, device)
        t = value.to(device).reshape(shape)
        if t.dim() == 4:
            t = t.contiguous(memory_format=torch.channels_last)
        return t.to(self.compute_dtype) if np.issubdtype(dtype, np.floating) else t

    @staticmethod
    def _stage_one(value, dtype, device) -> torch.Tensor:
        """A host value copied to ``device``: a float one as float32, any
        other in its declared type (a u8 image crosses at 1 byte a pixel)."""
        arr = np.asarray(value)
        arr = arr.astype(np.float32 if np.issubdtype(dtype, np.floating) else dtype, copy=False)
        arr = np.ascontiguousarray(arr)
        if not arr.flags.writeable:
            arr = arr.copy()
        return torch.from_numpy(arr).to(device)

    def _node_ranges(self, model: Model):
        """``model``'s nodes for ``_run`` under ``profile``: each node that
        runs is yielded inside a profiler range of its own, which stays open
        while ``_run``'s loop body emits it.  Parameters, Consts, Results
        and the folded or fused nodes are yielded bare, so the input and
        output copies fall outside every range."""
        skip = self._folded_nodes | self._fused_skip
        for node in model:
            if node.op_type in ("Parameter", "Const", "Result") or (
                    node.id in skip and node.op_type not in ("ReadValue", "Assign")):
                yield node
            else:
                with _RecordFunctionFast(f"{node.op_type}_{node.id}"):
                    yield node

    def _run(self, model: Model, analysis: ShapeAnalysis, inputs, capture=(),
             state=None, walk=None) -> Tuple[Dict[str, torch.Tensor],
                                              Dict[str, torch.Tensor],
                                              Optional[Dict[str, object]]]:
        """Emit ``model`` in topological order on device tensors.  Returns
        ({result name: tensor}, {captured node name: tensor}, the new state),
        the first two dequantized where they were stored as int8.  ``state``
        is the variable state the ReadValues read (None for a network with
        no variables); it is left as it is, and the new state is a new
        dict.  On a mesh, ``walk`` (parallel/mesh.py) is the data row that
        runs it, row 0 unbatched by default: every op node then goes
        through it, and a value it holds in row blocks (``Rows``) is
        gathered where a Result, a capture or the state reads it."""
        if walk is None:
            walk = walk_for(self)
        device = walk.lead if walk is not None else self.device
        if walk is not None and not walk.active:
            walk = None
        ctx = EmitCtx(self, model, analysis, device)
        weights = ctx.weights
        int8_edges = self._int8_edges
        values: Dict[Tuple[int, int], TValue] = {}
        new_state = dict(state) if state is not None else None
        assigned: Dict[str, torch.Tensor] = {}
        init_commit: Dict[str, torch.Tensor] = {}

        def store(key, tv):
            """Register a produced tensor; an int8-storage edge is
            requantized here unless its producer already carries codes
            (MaxPool, ReLU)."""
            s = int8_edges.get(key)
            if s is not None and tv.act_scale is None:
                tv = (tv.quantized(s) if isinstance(tv, Rows)
                      else TValue(TValue.quantize(tv.arr, s), act_scale=s))
            values[key] = tv

        def whole(src: int, sport: int) -> TValue:
            tv = tv_for(src, sport)
            return tv.gather(device) if isinstance(tv, Rows) else tv

        def tv_for(src: int, sport: int) -> TValue:
            key = (src, sport)
            if key in values:
                return values[key]
            wkey = f"folded.{src}.{sport}"
            if wkey in weights:
                values[key] = TValue(weights[wkey])
                return values[key]
            skey = (id(analysis), src, sport, device)
            if skey not in self._static:
                val = analysis.value(src, sport)
                if val is None:
                    raise RuntimeError(
                        f"no emitted or static value for node {src} port {sport}")
                self._static[skey] = torch.as_tensor(np.array(val), device=device)
            values[key] = TValue(self._static[skey])
            return values[key]

        outputs: Dict[str, torch.Tensor] = {}
        for node in (self._node_ranges(model) if self._ranges else model):
            if node.op_type == "Parameter":
                info = node.outputs[node.out_port]
                tv = TValue(self._input_tensor(inputs[node.name], info.shape, info.dtype,
                                               device))
                values[(node.id, node.out_port)] = walk.place(tv) if walk is not None else tv
            elif node.op_type == "Const":
                if node.id in self._runtime_consts:
                    values[(node.id, node.out_port)] = TValue(
                        weights[str(node.id)],
                        qscale=weights.get(f"{node.id}.scale"))
            elif node.op_type == "Result":
                src, sport = model.in_edges[node.id][0]
                tv = whole(src, sport)
                outputs[node.name] = (tv.dequant(self.compute_dtype).arr
                                      if node.name in self._keep_dtype else
                                      tv.dequant().arr.to(torch_dtype(node.inputs[0].dtype)))
            elif node.op_type == "ReadValue":
                vid = variable_id(node)
                var = self.variables[vid]
                x = state[vid]
                if var["dynamic_init"]:
                    if state[vid + _FRESH]:
                        init = whole(*model.in_edges[node.id][0]).dequant().arr.to(
                            torch_dtype(var["dtype"]))
                        # a batch-baked variable broadcasts the init
                        x = (init.reshape(var["shape"])
                             if init.numel() == int(np.prod(var["shape"]))
                             else init.broadcast_to(var["shape"]))
                        init_commit[vid] = x
                    new_state[vid + _FRESH] = False
                if x.is_floating_point():
                    x = x.to(self.compute_dtype)
                values[(node.id, node.out_port)] = TValue(x)
            elif node.op_type == "Assign":
                vid = variable_id(node)
                assigned[vid] = whole(*model.in_edges[node.id][0]).dequant().arr.to(
                    torch_dtype(self.variables[vid]["dtype"]))
            elif node.id in self._folded_nodes or node.id in self._fused_skip:
                continue  # folded: read lazily; fused: in its root's epilogue
            else:
                op = get_op(node.op_type)
                ins = {}
                for port, (src, sport) in sorted(model.in_edges[node.id].items()):
                    if (node.op_type, port) in STATIC_PORTS:
                        continue
                    tv = tv_for(src, sport)
                    # an int8-stored value reaching a port that does not
                    # take one is dequantized here, so correctness never
                    # depends on the storage analysis
                    if not (op.int8_ports == "all" or port in op.int8_ports):
                        tv = tv.dequant(self.compute_dtype)
                    ins[port] = tv
                f = self._fusions.get(node.id)
                bias = (tv_for(*f.bias_src).arr.reshape(-1)
                        if f is not None and f.bias_src is not None else None)
                outs = (walk.emit(ctx, node, op, ins, f, bias) if walk is not None
                        else emit_node(ctx, node, op, ins, f, bias))
                for key, tv in outs.items():
                    store(key, tv)
        captured = {}
        for name in capture:
            node = model.find_by_name(name)
            if node is None or (node.id, node.out_port) not in values:
                raise KeyError(
                    f"{name!r} has no emitted value of its own (unknown, "
                    f"folded, or inside a fused epilogue)")
            captured[name] = whole(node.id, node.out_port).dequant().arr
        if new_state is not None:
            new_state.update(init_commit)
            new_state.update(assigned)  # the assignment wins
        return outputs, captured, new_state

    @staticmethod
    def _to_host(tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
        """numpy copies; a bfloat16 capture (numpy has no such type) widens
        to float32, which holds it exactly."""
        return {k: (v.float() if v.dtype == torch.bfloat16 else v).detach()
                .contiguous().cpu().numpy() for k, v in tensors.items()}

    # -- execution -----------------------------------------------------------

    def _check_inputs(self, inputs):
        for name in self.input_names:
            if name not in inputs:
                raise KeyError(f"missing input for Parameter {name!r}")

    def _run_own(self, inputs, capture=()):
        """One run at the declared shapes on the network's own state, which
        a stateful network then replaces."""
        self._check_inputs(inputs)
        out, captured, state = self._run(self.model, self.analysis, inputs, capture,
                                         self._own_state() if self.variables else None)
        if self.variables:
            self.state = state
        return out, captured

    def __call__(self, inputs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Run one inference at the declared shapes; returns numpy."""
        return self._to_host(self._run_own(inputs)[0])

    def infer(self, inputs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        return self(inputs)

    def infer_with_capture(self, inputs, names):
        """One run at the declared shapes returning (results, {node name:
        activation}) for the named nodes.  A fused group's activation is
        captured under the name of its chain's last node."""
        out, captured = self._run_own(inputs, tuple(names))
        return self._to_host(out), self._to_host(captured)

    def capture_activations(self, inputs, names) -> Dict[str, np.ndarray]:
        """{node name: activation} of the named nodes (``infer_with_capture``,
        which also returns the results)."""
        return self.infer_with_capture(inputs, names)[1]

    def emitted_names(self) -> set:
        """Names of the nodes whose value a run keeps under their own id,
        which ``infer_with_capture`` can return: not the folded nodes, not a
        fused chain's root or its absorbed Add (the chain's value is its
        last node's), no Result or Assign, a Const only where a running op
        reads it."""
        ends = {f.out_key[0] for f in self._fusions.values()}
        roots = set(self._fusions)
        names = set()
        for node in self.model:
            if node.op_type in ("Result", "Assign") or node.id in roots:
                continue
            if node.op_type == "Const":
                if node.id in self._runtime_consts:
                    names.add(node.name)
            elif (node.id in ends or node.op_type == "ReadValue"
                  or node.id not in self._folded_nodes | self._fused_skip):
                names.add(node.name)
        return names

    def verify_against_interpreter(self, inputs, names=None, rtol=1e-3, atol=1e-4
                                   ) -> Dict[str, float]:
        """Each named activation (default: every node but Const, Parameter
        and Result) of one compiled run against the port's numpy twin (the
        ops' ``ref_compute``) on the same prepared model: the JAX package's
        ``verify_against_interpreter``.  A stateful network is checked from
        its initial state on both sides (the network's own state is reset
        first, and the run advances it).  Names the compiled path folded or
        fused away are skipped.  Returns {name: max |compiled - numpy|};
        raises AssertionError listing the layers outside ``rtol``/``atol``."""
        model = self.model
        if names is None:
            names = [n.name for n in model if n.op_type not in ("Const", "Parameter", "Result")]
        wanted = set(names) & self.emitted_names()
        if self.variables:
            istate = initial_state(self.variables)
            self.reset_state()
        values, golden = {}, {}
        for node in model:
            ins = {p: values[(s, sp)] for p, (s, sp) in sorted(model.in_edges[node.id].items())}
            if node.op_type == "Parameter":
                info = node.outputs[node.out_port]
                outs = {node.out_port: np.asarray(inputs[node.name])
                        .reshape(info.shape).astype(info.dtype)}
            elif node.op_type == "Const":
                outs = {node.out_port: node.const}
            elif node.op_type in ("Result", "Assign"):
                outs = {}
            elif node.op_type == "ReadValue":
                var = self.variables[variable_id(node)]
                if var["dynamic_init"]:
                    # the first call's value is the init input; a batch-baked
                    # variable broadcasts it, as the compiled run does
                    iv = np.asarray(ins[0], dtype=var["dtype"])
                    iv = (iv.reshape(var["shape"]) if iv.size == int(np.prod(var["shape"]))
                          else np.broadcast_to(iv, var["shape"]))
                    outs = {node.out_port: iv}
                else:
                    outs = {node.out_port: istate[variable_id(node)]}
            else:
                outs = get_op(node.op_type).ref_compute(node, ins)
            for p, arr in outs.items():
                values[(node.id, p)] = arr
            if node.name in wanted and (node.id, node.out_port) in values:
                golden[node.name] = values[(node.id, node.out_port)]
        got = self.capture_activations(inputs, sorted(golden))
        diffs, failures = {}, []
        for name in sorted(golden):
            d = float(np.abs(got[name].astype(np.float64)
                             - golden[name].astype(np.float64)).max())
            diffs[name] = d
            if not np.allclose(got[name], golden[name], rtol=rtol, atol=atol):
                failures.append((name, d))
        if failures:
            raise AssertionError(
                f"{len(failures)} layer mismatches vs interpreter: {failures[:5]}")
        return diffs

    def profile(self, inputs, batch_size: Optional[int] = None) -> List[Dict]:
        """The measured time of each node in one forward: ``infer`` (or
        ``infer_batch`` where ``batch_size`` names the inputs' batch) once
        to warm up, then once under ``torch.profiler`` with each node's emit
        inside a range named ``"<OpType>_<node id>"`` (``_node_ranges``), CUDA
        activity on a CUDA network, CPU activity on a CPU one.  Returns the
        rows of ``runtime/profiling.node_rows`` ({node, category, self_us,
        occurrences, kernel}; ``aggregate(rows, by="node"|"category")``
        sums them) and keeps the profiler's own total in
        ``last_profile_us``: the device activities' time on a CUDA network,
        the top-level operators' host time on a CPU one.  Raises where a
        CUDA network's profile holds no device activity."""
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile

        from pyopenvino_tpu_torch.runtime.profiling import device_us, node_rows

        def run():
            return self.infer_batch(inputs) if batch_size is not None else self(inputs)

        run()  # kernel builds and the batch's plan outside the profile
        cuda = self.device.type == "cuda"
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        self._ranges = True
        try:
            with torch_profile(activities=activities) as prof:
                run()  # returns host copies: the device work is done
        finally:
            self._ranges = False
        events = prof.events()
        rows = node_rows(events, cuda)
        if cuda:
            self.last_profile_us = device_us(events)
            if not rows or not self.last_profile_us:
                raise RuntimeError("the profiler recorded no device activity for a "
                                   f"network on {self.device}")
        else:
            self.last_profile_us = sum(r["self_us"] for r in rows)
        return rows

    # -- variable state (ReadValue/Assign, ops/state_ops.py) -----------------

    def fresh_state(self) -> Dict[str, object]:
        """A new state dict: each variable's initial value on the device
        (zeros for a dynamic-init one, whose init the first call computes)
        and a fresh flag for each dynamic-init variable.  The unit of a
        request's own state (``step``)."""
        state = {vid: torch.from_numpy(np.array(v, order="C")).to(self.device)
                 for vid, v in initial_state(self.variables).items()}
        for vid, var in self.variables.items():
            if var["dynamic_init"]:
                state[vid + _FRESH] = True
        return state

    def step(self, inputs, state) -> Tuple[Dict[str, np.ndarray], Dict[str, object]]:
        """One inference on the caller's own state: (outputs, new state).
        ``state`` is left as it is."""
        self._check_inputs(inputs)
        out, _, new_state = self._run(self.model, self.analysis, inputs, state=state)
        return self._to_host(out), new_state

    def state_to_host(self, state) -> Dict[str, np.ndarray]:
        """{variable_id: numpy copy} of a state dict, fresh flags left out."""
        return self._to_host({vid: state[vid] for vid in self.variables})

    def state_with(self, state, values: Dict[str, np.ndarray]) -> Dict[str, object]:
        """A copy of ``state`` with the given variables set (to their
        declared shape and dtype); setting a dynamic-init variable clears
        its fresh flag: an explicit value wins over the init."""
        state = dict(state)
        for vid, val in values.items():
            if vid not in self.variables:
                raise KeyError(f"unknown variable {vid!r}")
            var = self.variables[vid]
            arr = np.array(np.asarray(val, dtype=var["dtype"]).reshape(var["shape"]), order="C")
            state[vid] = torch.from_numpy(arr).to(self.device)
            if var["dynamic_init"]:
                state[vid + _FRESH] = False
        return state

    def state_with_reset(self, state, vid: str) -> Dict[str, object]:
        """A copy of ``state`` with one variable reset to its init, the
        others untouched; a dynamic-init variable is armed again, so the
        next call computes its init."""
        if vid not in self.variables:
            raise KeyError(f"unknown variable {vid!r}")
        state = dict(state)
        state[vid] = torch.from_numpy(
            np.array(initial_state({vid: self.variables[vid]})[vid], order="C")).to(self.device)
        if self.variables[vid]["dynamic_init"]:
            state[vid + _FRESH] = True
        return state

    def reset_state(self):
        """Every variable back to its init (zeros where it has none)."""
        self.state = self.fresh_state()

    def _own_state(self) -> Dict[str, object]:
        """The network's own state, made at its first use."""
        if self.state is None:
            self.reset_state()
        return self.state

    def query_state(self) -> Dict[str, np.ndarray]:
        return self.state_to_host(self._own_state())

    def set_state(self, values: Dict[str, np.ndarray]):
        self.state = self.state_with(self._own_state(), values)

    def reset_variable(self, vid: str):
        self.state = self.state_with_reset(self._own_state(), vid)

    def _batched_plan(self, batch: int) -> Optional[Tuple[Model, ShapeAnalysis]]:
        """The model and analysis compiled at ``batch``, or None where the
        graph cannot carry a batch in N: a Reshape target that names the
        batch-1 extent of a tensor the batch has reached elsewhere
        (MoE-MLP's gate, (1, E) → Transpose → (E, 1, 1)) fails its shape
        inference."""
        with self._bake_lock:
            if batch not in self._batched:
                try:
                    model = bake_batch(self.model, batch)
                    self._batched[batch] = (model, infer_shapes(model))
                except ValueError:
                    self._batched[batch] = None
            return self._batched[batch]

    def infer_batch(self, inputs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """inputs: {name: (B, ...)}, each example shaped like the declared
        input (with or without its unit batch dim).  Outputs are (B, ...)
        with the declared unit batch dim dropped, in the JAX package's
        layout: (B, 1000) class scores, and DetectionOutput's (1, 1, K, 7)
        record table becomes (B, 1, K, 7), one table per example.  A graph
        that cannot be baked at B (``_batched_plan``) runs once per example
        at its declared shapes, which is what the JAX package's vmap over
        the examples computes.  A stateful network raises: its batch is N
        streams in lockstep, baked into the IR (``IENetwork.reshape``)."""
        if self.variables:
            raise NotImplementedError(
                "stateful networks (ReadValue/Assign) run at their declared shapes: a "
                "batch of examples has no defined state per step; bake the batch into "
                "the IR instead (IENetwork.reshape)")
        self._check_inputs(inputs)
        b = int(np.asarray(next(iter(inputs.values()))).shape[0])
        if self.mesh is not None:
            return run_batch(self, inputs, b)
        return self._to_host(self._batch_on(inputs, b))

    def _batch_on(self, inputs, b: int, walk=None) -> Dict[str, torch.Tensor]:
        """``infer_batch``'s outputs on the device, unread: the plan baked at
        ``b``, or one run an example at the declared shapes.  ``walk``: the
        mesh's data row that runs it (parallel/mesh.py)."""
        plan = self._batched_plan(b)
        if plan is not None:
            out = self._run(*plan, inputs, walk=walk)[0]
            # a Result known at compile time (ShapeOf → Result) holds the
            # baked batch's value; each example's is the declared graph's
            for node in self.model.results:
                val = self.analysis.value(*self.model.in_edges[node.id][0])
                if val is not None:
                    shape = tuple(np.shape(val))
                    per = shape[1:] if shape[:1] == (1,) else shape
                    t = out[node.name]
                    out[node.name] = torch.as_tensor(np.reshape(val, per), device=t.device).to(
                        t.dtype).expand((b,) + per)
            return out
        runs = [self._run(self.model, self.analysis, {k: v[i] for k, v in inputs.items()},
                          walk=walk)[0]
                for i in range(b)]
        return {name: torch.cat([r[name] for r in runs]) if runs[0][name].shape[:1] == (1,)
                else torch.stack([r[name] for r in runs]) for name in runs[0]}

    # -- weight checkpoints --------------------------------------------------

    def load_weights(self, source):
        """Replace the weights with those of a checkpoint: the ``.npz`` that
        the JAX package's ``CompiledNetwork.save_weights`` writes (same keys;
        bfloat16 arrays under the ``::bf16`` tag; an INT8 weight-only
        network's int8 codes and ``.scale`` arrays; a body's Consts under
        ``sub.<node id>.<body name>.<const id>``) or a {key: ndarray} dict.
        Keys, shapes and dtypes must match the compiled network's.  Caches
        derived from the weights are rebuilt."""
        if isinstance(source, dict):
            loaded = {k: torch.from_numpy(np.array(v)) for k, v in source.items()}
        else:
            loaded = decode_weights(source)
        missing = set(self.weights) - set(loaded)
        if missing:
            raise KeyError(f"checkpoint missing weights: {sorted(missing)[:5]}")
        extras = set(loaded) - set(self.weights)
        if extras:
            raise KeyError(
                f"checkpoint has {len(extras)} unknown weight key(s), e.g. "
                f"{sorted(extras)[:5]} — wrong model or config?")
        for k, v in self.weights.items():
            if loaded[k].shape != v.shape or loaded[k].dtype != v.dtype:
                raise ValueError(
                    f"weight {k!r}: checkpoint {loaded[k].dtype}"
                    f"{tuple(loaded[k].shape)} != expected {v.dtype}{tuple(v.shape)}")
        self.weights = {k: v.to(self.device) for k, v in loaded.items()}
        self._derived, self._placed, self._parts = {}, {}, {}

    def save_weights(self, path):
        """Write the weights as the JAX package's ``save_weights`` does:
        ``np.savez_compressed`` of {key: array}, a bfloat16 array as its
        uint16 bit pattern under ``key + "::bf16"``.  ``load_weights`` of
        either package reads it."""
        np.savez_compressed(path, **encode_weights(self.weights))

    # -- analyses (runtime/analysis.py) -------------------------------------

    def cost_analysis(self) -> Dict[str, float]:
        """{"flops", "transcendentals", "bytes accessed"} of one forward at
        the declared shapes (B = 1), counted from the compiled graph as the
        walk issues it: the JAX package's ``cost_analysis`` keys, from the
        port's own rules (``runtime/analysis.py``) where the JAX package
        reads XLA's."""
        from pyopenvino_tpu_torch.runtime.analysis import cost_analysis

        return cost_analysis(self)

    def memory_analysis(self) -> Dict[str, int]:
        """The JAX package's ``memory_analysis`` keys for one forward at the
        declared shapes: argument (resident weights and cached GEMM operands,
        plus the inputs), output, temp (the values the walk holds), alias (0)
        and generated code (the kernel libraries the routes load) bytes
        (``runtime/analysis.py``)."""
        from pyopenvino_tpu_torch.runtime.analysis import memory_analysis

        return memory_analysis(self)

    # -- export (runtime/export.py) ------------------------------------------

    def export(self, path, buckets=(8, 32)) -> None:
        """Write this network into one artifact that
        ``runtime/export.import_compiled`` loads without the IR, the passes
        or a calibration (``ExecutableNetwork.export``)."""
        from pyopenvino_tpu_torch.runtime.export import export_compiled

        export_compiled(self, path, buckets=buckets)


def decode_weights(source) -> Dict[str, torch.Tensor]:
    """{key: CPU tensor} of an ``.npz`` that ``save_weights`` (either
    package's) wrote: a ``::bf16``-tagged uint16 array back to bfloat16."""
    loaded = {}
    with np.load(source) as data:
        for k in data.files:
            arr = np.array(data[k])
            if k.endswith(_BF16_TAG):
                loaded[k[: -len(_BF16_TAG)]] = torch.from_numpy(
                    arr.view(np.int16)).view(torch.bfloat16)
            else:
                loaded[k] = torch.from_numpy(arr)
    return loaded


def encode_weights(weights: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """{key: numpy array} of a weight dict for ``np.savez``: a bfloat16
    tensor as its uint16 bits under ``key + _BF16_TAG``."""
    out = {}
    for k, v in weights.items():
        v = v.detach().contiguous().cpu()
        if v.dtype == torch.bfloat16:
            out[k + _BF16_TAG] = v.view(torch.int16).numpy().view(np.uint16)
        else:
            out[k] = v.numpy()
    return out


def prepare_model(model: Model, config: Optional[Config] = None,
                  calibration_samples=None):
    """Compile-time preprocessing before CompiledNetwork, in the JAX
    package's order: dead-branch elimination, the weightless-Const check,
    BN-scale folding, FakeQuantize folding, INT8-FULL activation scales
    from the IR, INT8 weight quantization, calibration of the quantizable
    ops the IR leaves without a scale, and bias correction.  Returns
    (model, quantized, act_scales, bias_corr) as the JAX package's
    ``prepare_model`` does: {const id: (int8 codes, float32 scales)} or
    None, {consumer node id: scale} or None, {bias const id: delta} or None.

    BN-scale folding (``passes/fold_scale.py``) folds a Multiply by a
    positive per-channel constant after a conv into the conv's weights and
    the biases between them, before quantization, so the INT8 scales see
    the effective weights (``mnist_bn``, ``keras_digits`` and
    ``torch_digits`` in ``assets/trained/``); SSD's one Multiply scales the
    input Parameter and stays.  FakeQuantize folding
    (``passes/fold_fq.py``) evaluates every weight FakeQuantize of a
    POT/NNCF IR into its Const in every mode; the activation FakeQuantizes
    run as elementwise emulation in FP32 and INT8 weight-only, and under
    INT8-FULL the symmetric ones become the activation scales of their
    consumers (``extract_act_scales``), so such an IR needs no calibration
    samples.  Samples calibrate only the quantizable ops the IR leaves
    without a scale (a weight-only POT IR: all of them), and the IR's
    scales win where both exist."""
    config = config or Config()
    check_supported(config)
    model, _ = prune_dead_nodes(model)
    if calibration_samples is not None:
        # calibration and bias correction both iterate the samples
        calibration_samples = list(calibration_samples)
    missing = [n.name for n in model
               if n.op_type == "Const" and n.const is None]
    if missing:
        raise ValueError(
            f"model has {len(missing)} Const node(s) without data — "
            f"weightless structural parse (was the .bin found?); first: "
            f"{missing[0]!r}"
        )
    model = fold_scale_into_conv(model)
    model = fold_fake_quantize(model)
    quantized = act_scales = bias_corr = None
    fq_scales = {}
    if config.quant == QuantMode.INT8_FULL:
        model, fq_scales = extract_act_scales(model, QUANTIZABLE)
    if config.quant in (QuantMode.INT8_WEIGHT, QuantMode.INT8_FULL):
        from pyopenvino_tpu_torch.passes.quantize import quantize_weights

        quantized = quantize_weights(model, config.quant_min_elems)
    if config.quant == QuantMode.INT8_FULL:
        needs_cal = [n.id for n in model
                     if n.op_type in QUANTIZABLE and n.id not in fq_scales]
        if needs_cal and not calibration_samples:
            raise ValueError(
                "QuantMode.INT8_FULL needs calibration_samples "
                "(representative {input_name: blob} dicts): the model carries "
                f"FakeQuantize scales for {len(fq_scales)} consumers but "
                f"{len(needs_cal)} quantizable ops have none"
            )
        act_scales = fq_scales
        if needs_cal:
            from pyopenvino_tpu_torch.passes.calibrate import calibrate_activations

            act_scales = calibrate_activations(
                model, calibration_samples,
                percentile=config.calibration_percentile,
                method=config.calibration_method,
            )
            act_scales.update(fq_scales)  # the IR's scales win where present
    if config.bias_correction and quantized:
        if not calibration_samples:
            raise ValueError(
                "Config.bias_correction needs calibration_samples (the "
                "correction is E[(W - deq(Wq))*x] over representative "
                "inputs — passes/bias_correct.py)"
            )
        from pyopenvino_tpu_torch.passes.bias_correct import bias_corrections

        bias_corr = bias_corrections(
            model, infer_shapes(model), quantized, calibration_samples)
    return model, quantized, act_scales, bias_corr


def compile_model(model: Model, config: Optional[Config] = None,
                  device="cuda", calibration_samples=None, mesh=None) -> CompiledNetwork:
    """Prepare and compile ``model`` onto ``device`` (the card unless the
    caller asks for the CPU).  ``calibration_samples``: {param_name: blob}
    input dicts, required for QuantMode.INT8_FULL (activation scales)
    unless the IR's FakeQuantizes give every quantizable op its scale, and
    for ``Config.bias_correction``.  ``mesh`` (parallel/mesh.py) runs
    infer_batch data parallel over it; without one, a mesh that the Config
    declares (``mesh_data``, ``mesh_model``, ``mesh_spatial``) is built on
    the default devices of ``device``'s type and attached, TP where
    ``mesh_model > 1`` and SP where ``mesh_spatial > 1``
    (``shard_declared``)."""
    config = config or Config()
    model, quantized, act_scales, bias_corr = prepare_model(
        model, config, calibration_samples)
    net = CompiledNetwork(model, config, device=device, quantized=quantized,
                          act_scales=act_scales, bias_corr=bias_corr, mesh=mesh)
    return net if mesh is not None else shard_declared(net, config)
