"""Graph compiler: typed IR → weights on the device + an emission plan that
runs the graph eagerly in PyTorch.

Counterpart of ``pyopenvino_tpu/runtime/compiler.py``.  Where the JAX package
traces the graph into one jitted XLA program, the port walks the same
topological order on every call and runs each op's ``emit`` on device
tensors:

  * constant folding — statically known values (reshape targets) are
    consumed at compile time and their nodes never run;
  * weights are decoded once onto the device, keyed exactly like the JAX
    package's weight pytree (``str(node_id)``, ``folded.{src}.{sport}``;
    under INT8 weight-only a quantized weight is ``str(node_id)`` as int8
    codes plus ``{node_id}.scale`` as float32 per-channel scales) and kept
    in the IR layout, so checkpoints move between the two packages;
  * epilogue fusion (passes/fuse.py): a Conv/GroupConv/MatMul root emits
    its bias and activation, and the absorbed Add/ReLU/Clamp nodes are
    skipped;
  * batch is native in N: ``infer_batch`` runs the graph compiled at batch B
    (passes/shape_infer.py bake_batch), with no vmap.

Every mode the port runs computes in float32 (INT8 weight-only included:
its weights are dequantized to float32), and float32 on the card means full
float32: compiling a network sets ``torch.backends.cuda.matmul.allow_tf32``
and ``torch.backends.cudnn.allow_tf32`` to False.  These flags are
process-wide and stay set for every later PyTorch call in the process.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from pyopenvino_tpu_torch.config import Backend, Config, QuantMode, check_supported
from pyopenvino_tpu_torch.ir.model import Model
from pyopenvino_tpu_torch.ops import get_op
from pyopenvino_tpu_torch.ops.spec import TValue
from pyopenvino_tpu_torch.passes.shape_infer import (
    ShapeAnalysis,
    bake_batch,
    infer_shapes,
)
from pyopenvino_tpu_torch.passes.util import folded_nodes, prune_dead_nodes

# (op_type, input_port) pairs consumed at compile time — never emitted.
STATIC_PORTS = {
    ("Reshape", 1),
}

# Folded values larger than this that a running op reads become entries of
# the weight dict; smaller ones are materialized where they are read.
_INLINE_LIMIT = 1 << 16

# npz cannot hold bfloat16: the JAX package stores bf16 arrays as uint16 bit
# patterns under this key suffix (compiler.py save_weights).
_BF16_TAG = "::bf16"


class EmitCtx:
    """Services handed to every op's ``emit``."""

    def __init__(self, net: "CompiledNetwork", model: Model, analysis: ShapeAnalysis):
        self.net = net
        self.model = model
        self.analysis = analysis

    @property
    def use_kernels(self) -> bool:
        return self.net.config.backend == Backend.KERNELS

    @property
    def depthwise_mode(self) -> str:
        return self.net.config.depthwise_mode

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
        key = str(src)
        if key not in self.net.weights:
            raise ValueError(
                f"{node.op_type} {node.name!r}: port {port} is not a weight")
        weight = self.net.weights[key]
        ckey = (key, tag, weight.dtype)  # int8 and f32 never share an entry
        cache = self.net._derived
        if ckey not in cache:
            cache[ckey] = make(weight)
        return cache[ckey]

    @staticmethod
    def weight_for(node, tv: TValue) -> torch.Tensor:
        """A weight operand in float32: int8 codes are dequantized on every
        call (``codes * scale``, the JAX package's ``weight_for``), so no
        float copy of a quantized weight outlives the call."""
        if tv.qscale is None:
            return tv.arr
        return tv.arr.float() * tv.qscale


class CompiledNetwork:
    def __init__(self, model: Model, config: Optional[Config] = None,
                 device="cuda",
                 quantized: Optional[Dict[int, Tuple[np.ndarray, np.ndarray]]] = None):
        self.config = config or Config()
        check_supported(self.config)
        self.device = torch.device(device)
        if self.config.compute_dtype == "float32":
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
        self.weights: Dict[str, torch.Tensor] = self._build_weights(quantized or {})
        self._derived: Dict[Tuple[str, str, torch.dtype], torch.Tensor] = {}
        # batch → (model, analysis) compiled at that batch (infer_batch)
        self._batched: Dict[int, Tuple[Model, ShapeAnalysis]] = {}
        self.input_names = [n.name for n in model.parameters]

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

    def _build_weights(self, quantized) -> Dict[str, torch.Tensor]:
        """Weight dict on the device, in IR layout.  Float weights are
        float32 (the only compute dtype the port runs); a weight in
        ``quantized`` ({const id: (codes, scales)}, passes/quantize.py) is
        its int8 codes under ``str(nid)`` and its keepdims float32 scales
        under ``f"{nid}.scale"``."""
        weights = {}

        def put(key, arr):
            weights[key] = torch.from_numpy(
                np.array(arr, order="C", copy=True)).to(self.device)

        for nid in sorted(self._runtime_consts):
            node = self.model.nodes[nid]
            if node.const is None:
                raise RuntimeError(
                    f"Const {node.name!r} has no weights; synthesize a .bin "
                    f"(pyopenvino_tpu_torch/models/synth.py) or load one"
                )
            if nid in quantized:
                codes, scales = quantized[nid]
                put(str(nid), codes)
                put(f"{nid}.scale", scales.astype(np.float32, copy=False))
            elif np.issubdtype(node.const.dtype, np.floating):
                put(str(nid), node.const.astype(np.float32, copy=False))
            else:
                put(str(nid), node.const)

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

    def _input_tensor(self, value, shape, dtype) -> torch.Tensor:
        arr = np.asarray(value)
        if np.issubdtype(dtype, np.floating):
            arr = arr.astype(np.float32, copy=False)
        else:
            arr = arr.astype(dtype, copy=False)
        arr = np.ascontiguousarray(arr.reshape(shape))
        if not arr.flags.writeable:
            arr = arr.copy()
        t = torch.from_numpy(arr).to(self.device)
        if t.dim() == 4:
            t = t.contiguous(memory_format=torch.channels_last)
        return t

    def _run(self, model: Model, analysis: ShapeAnalysis, inputs,
             capture=()) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """Emit ``model`` in topological order on device tensors.  Returns
        ({result name: tensor}, {captured node name: tensor})."""
        ctx = EmitCtx(self, model, analysis)
        weights = self.weights
        values: Dict[Tuple[int, int], TValue] = {}

        def tv_for(src: int, sport: int) -> TValue:
            key = (src, sport)
            if key in values:
                return values[key]
            wkey = f"folded.{src}.{sport}"
            if wkey in weights:
                values[key] = TValue(weights[wkey])
                return values[key]
            val = analysis.value(src, sport)
            if val is None:
                raise RuntimeError(
                    f"no emitted or static value for node {src} port {sport}")
            values[key] = TValue(torch.as_tensor(np.array(val), device=self.device))
            return values[key]

        outputs: Dict[str, torch.Tensor] = {}
        for node in model:
            if node.op_type == "Parameter":
                info = node.outputs[node.out_port]
                values[(node.id, node.out_port)] = TValue(
                    self._input_tensor(inputs[node.name], info.shape, info.dtype))
            elif node.op_type == "Const":
                if node.id in self._runtime_consts:
                    values[(node.id, node.out_port)] = TValue(
                        weights[str(node.id)],
                        qscale=weights.get(f"{node.id}.scale"))
            elif node.op_type == "Result":
                src, sport = model.in_edges[node.id][0]
                outputs[node.name] = tv_for(src, sport).arr
            elif node.id in self._folded_nodes or node.id in self._fused_skip:
                continue  # folded: read lazily; fused: in its root's epilogue
            else:
                op = get_op(node.op_type)
                ins = {
                    port: tv_for(src, sport)
                    for port, (src, sport) in sorted(model.in_edges[node.id].items())
                    if (node.op_type, port) not in STATIC_PORTS
                }
                if node.id in self._fusions:
                    f = self._fusions[node.id]
                    bias = (tv_for(*f.bias_src).arr.reshape(-1)
                            if f.bias_src is not None else None)
                    outs = op.emit_fused(ctx, node, ins, bias=bias, act=f.act)
                    values[f.out_key] = outs[node.out_port]
                else:
                    for port, tv in op.emit(ctx, node, ins).items():
                        values[(node.id, port)] = tv
        captured = {}
        for name in capture:
            node = model.find_by_name(name)
            if node is None or (node.id, node.out_port) not in values:
                raise KeyError(
                    f"{name!r} has no emitted value of its own (unknown, "
                    f"folded, or inside a fused epilogue)")
            captured[name] = values[(node.id, node.out_port)].arr
        return outputs, captured

    @staticmethod
    def _to_host(tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
        return {k: v.detach().contiguous().cpu().numpy() for k, v in tensors.items()}

    # -- execution -----------------------------------------------------------

    def _check_inputs(self, inputs):
        for name in self.input_names:
            if name not in inputs:
                raise KeyError(f"missing input for Parameter {name!r}")

    def __call__(self, inputs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Run one inference at the declared shapes; returns numpy."""
        self._check_inputs(inputs)
        out, _ = self._run(self.model, self.analysis, inputs)
        return self._to_host(out)

    def infer(self, inputs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        return self(inputs)

    def infer_with_capture(self, inputs, names):
        """One run at the declared shapes returning (results, {node name:
        activation}) for the named nodes.  A fused group's activation is
        captured under the name of its chain's last node."""
        self._check_inputs(inputs)
        out, captured = self._run(self.model, self.analysis, inputs, tuple(names))
        return self._to_host(out), self._to_host(captured)

    def _batched_plan(self, batch: int) -> Tuple[Model, ShapeAnalysis]:
        if batch not in self._batched:
            model = bake_batch(self.model, batch)
            self._batched[batch] = (model, infer_shapes(model))
        return self._batched[batch]

    def infer_batch(self, inputs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """inputs: {name: (B, ...)}, each example shaped like the declared
        input (with or without its unit batch dim).  Outputs are (B, ...)
        with the declared unit batch dim dropped."""
        self._check_inputs(inputs)
        b = int(np.asarray(next(iter(inputs.values()))).shape[0])
        model, analysis = self._batched_plan(b)
        out, _ = self._run(model, analysis, inputs)
        return self._to_host(out)

    # -- weight checkpoints --------------------------------------------------

    def load_weights(self, source):
        """Replace the weights with those of a checkpoint: the ``.npz`` that
        the JAX package's ``CompiledNetwork.save_weights`` writes (same keys;
        bfloat16 arrays under the ``::bf16`` tag; an INT8 weight-only
        network's int8 codes and ``.scale`` arrays) or a {key: ndarray} dict.
        Keys, shapes and dtypes must match the compiled network's.  Caches
        derived from the weights are rebuilt."""
        if isinstance(source, dict):
            loaded = {k: torch.from_numpy(np.array(v)) for k, v in source.items()}
        else:
            loaded = {}
            with np.load(source) as data:
                for k in data.files:
                    arr = np.array(data[k])
                    if k.endswith(_BF16_TAG):
                        loaded[k[: -len(_BF16_TAG)]] = torch.from_numpy(
                            arr.view(np.int16)).view(torch.bfloat16)
                    else:
                        loaded[k] = torch.from_numpy(arr)
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
        self._derived = {}


def prepare_model(model: Model, config: Optional[Config] = None):
    """Compile-time preprocessing before CompiledNetwork: dead-branch
    elimination, the weightless-Const check and, under INT8 weight-only,
    weight quantization.  Returns (model, quantized), ``quantized`` being
    {const id: (int8 codes, float32 scales)} or None, as the first two of
    the JAX package's ``prepare_model`` results.  The JAX package's graph
    rewrites before quantization (BN-scale and FakeQuantize folding) fold
    Multiply and FakeQuantize nodes, which the port does not run yet
    (``IECore.check_nodes`` refuses them)."""
    config = config or Config()
    check_supported(config)
    model, _ = prune_dead_nodes(model)
    missing = [n.name for n in model
               if n.op_type == "Const" and n.const is None]
    if missing:
        raise ValueError(
            f"model has {len(missing)} Const node(s) without data — "
            f"weightless structural parse (was the .bin found?); first: "
            f"{missing[0]!r}"
        )
    quantized = None
    if config.quant == QuantMode.INT8_WEIGHT:
        from pyopenvino_tpu_torch.passes.quantize import quantize_weights

        quantized = quantize_weights(model, config.quant_min_elems)
    return model, quantized


def compile_model(model: Model, config: Optional[Config] = None,
                  device="cuda") -> CompiledNetwork:
    """Prepare and compile ``model`` onto ``device`` (the card unless the
    caller asks for the CPU)."""
    config = config or Config()
    model, quantized = prepare_model(model, config)
    return CompiledNetwork(model, config, device=device, quantized=quantized)
