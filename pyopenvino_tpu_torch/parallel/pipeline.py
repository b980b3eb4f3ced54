"""Pipeline-parallel inference over a 'stage' mesh axis, in one process.

Counterpart of ``pyopenvino_tpu/parallel/pipeline.py``, with its cost model,
cut points and stage sub-models unchanged:

  * **Partitioning** — the graph is cut at single tensors that alone cross
    the frontier, chosen by an exact DP that minimizes the largest stage's
    FLOP estimate, never strictly inside a fusion group (a conv with its
    bias and activation stays in one stage, so the INT8 epilogue and the
    int8 storage analysis keep working per stage).
  * **Per-stage compilation** — each stage is a sub-``Model`` of shared
    ``Node``s (so per-stage quantization subsets index by node id) with a
    ``__pp_in__`` Parameter and a ``__pp_out__`` Result at its cuts,
    compiled by the ordinary ``CompiledNetwork``.  ``prepare_model`` runs on
    the WHOLE graph first and every stage shares its quantized weights,
    activation scales and bias corrections, so where the cuts fall cannot
    change the numerics.
  * **Schedule** — GPipe, issued from one host thread where the JAX package
    runs one ``shard_map`` program with a ``ppermute`` ring: at tick t stage
    s runs microbatch t − s.  A microbatch's rows are split over 'data' in
    order; replica d of stage s runs on ``mesh.devices[d, s]`` through the
    stage network's batched path at the block's size (``_batch_on``: the
    plan baked at that size, or one example at a time where the stage
    cannot be baked).  Stage s's weights live on the devices of mesh column
    s, one copy a distinct device (``parallel/mesh.py`` ``weights_for``), so
    logical shards of one card share one copy.  The cut tensor passes to
    the next stage's ``__pp_in__`` as a device tensor in the dtype the walk
    holds it in (bfloat16 under bf16 compute: no rounding on the way, no
    float32 ring) and moves to that stage's device; nothing is read back to
    the host before the last microbatch's last stage is issued.

Batch semantics match ``CompiledNetwork.infer_batch``: inputs are
``{name: (B, ...)}``; B is split into ``n_micro`` microbatches of B /
n_micro examples, each split over the 'data' axis (DP × PP compose).

Across processes (``parallel/distributed.py``), as the JAX package's
``jax.process_count() > 1`` branch: the mesh's positions lie process-major,
every process passes the SAME full batch, and each runs, in the same GPipe
order, the microbatch blocks of the stages it owns; a stage whose every
position another process owns is a ``RemoteStage`` (its sub-model, never
compiled here).  A cut tensor that crosses processes goes as its raw bytes
(``distributed.send_tensor``, tagged by microbatch, data row and stage;
bfloat16 bit for bit), a hand-off within a process stays a device tensor,
and the last stage's process broadcasts each block's outputs, so every
process returns the full output.  A receive that never comes raises after
the group's timeout.

What one process on one card can show: the cuts, the stage sub-models, the
schedule's bookkeeping and each kernel at its per-microbatch shapes.  It
cannot show transfers between cards, or stages that overlap: that the
stages issued here would overlap on real cards is not verified.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from pyopenvino_tpu_torch.config import Config
from pyopenvino_tpu_torch.ir.model import Edge, Model, Node
from pyopenvino_tpu_torch.parallel.distributed import (
    broadcast_tensor, is_local, owner, recv_tensor, send_tensor,
)
from pyopenvino_tpu_torch.parallel.mesh import Mesh, P, Walk, device_grid, shard_compiled
from pyopenvino_tpu_torch.passes.fuse import find_fusions
from pyopenvino_tpu_torch.passes.shape_infer import infer_shapes
# Runtime nodes with statically known outputs behave like Consts for
# partitioning: they produce no runtime tensor, so their edges never cross
# a stage frontier (SSD's ShapeOf → PriorBox anchor chains, live across the
# whole trunk, would otherwise block every cut).  One shared definition with
# the compiler.
from pyopenvino_tpu_torch.passes.util import folded_nodes

# -- cost model and cut points -------------------------------------------------


def _node_cost(model: Model, analysis, node: Node) -> float:
    """FLOP estimate for stage balancing (a proxy, not a roofline model: it
    only has to rank segment weights consistently)."""
    if not node.outputs:
        return 0.0
    out = analysis.shape(node.id, node.out_port)
    size = float(np.prod(out)) if out else 1.0
    if node.op_type in ("Convolution", "GroupConvolution"):
        w_src = model.in_edges[node.id].get(1)
        if w_src is not None:
            w = analysis.shape(*w_src)
            # OIHW: reduction = I·kh·kw; G-Co-Ci-kh-kw: prod(w[2:]) = Ci·kh·kw
            red = float(np.prod(w[2:])) * (w[1] if len(w) == 4 else 1)
            return 2.0 * size * red
    if node.op_type == "MatMul":
        in0 = analysis.shape(*model.in_edges[node.id][0])
        return 2.0 * size * float(in0[-1])
    return size  # elementwise / data movement proxy


@dataclasses.dataclass(frozen=True)
class CutPoint:
    pos: int          # index into the runtime-node topo list (cut AFTER it)
    node_id: int      # the articulation node
    port: int         # its crossing output port
    size: int         # flat element count of the crossing tensor (batch 1)


def find_cut_candidates(model: Model, analysis) -> Tuple[List[int], List[CutPoint]]:
    """Runtime topo order and every valid single-tensor cut position.

    A cut after position p is valid when every runtime edge crossing the
    frontier comes from the SAME (node, port), the tensor is floating
    point, no fusion group is split, and every Result's producer stays in
    the last segment."""
    folded = folded_nodes(model, analysis)
    rt = [n.id for n in model
          if n.op_type not in ("Const", "Result") and n.id not in folded]
    pos = {nid: i for i, nid in enumerate(rt)}

    # block cuts strictly INSIDE a fusion group (root .. last absorbed
    # node); a cut AT the group's chain end is fine, the whole group lies
    # before it (MobileNet's trunk is wall-to-wall conv+bias+ReLU6 groups)
    blocked = set()
    for f in find_fusions(model, analysis).values():
        ps = [pos[n] for n in (f.root,) + f.skip if n in pos]
        blocked.update(range(min(ps), max(ps)))

    # runtime → runtime edges only (Const feeds are stage-local, folded
    # nodes produce compile-time values, a Result stays with its producer)
    redges = [e for e in model.edges if e.src in pos and e.dst in pos]
    result_floor = min(
        (pos[model.in_edges[r.id][0][0]] for r in model.results
         if model.in_edges[r.id][0][0] in pos),
        default=len(rt))

    candidates: List[CutPoint] = []
    for p in range(len(rt) - 1):
        if p >= result_floor:
            break
        nid = rt[p]
        node = model.nodes[nid]
        if node.op_type == "Parameter" or p in blocked:
            continue
        crossing = {(e.src, e.src_port) for e in redges if pos[e.src] <= p < pos[e.dst]}
        if crossing != {(nid, node.out_port)}:
            continue
        info = node.outputs[node.out_port]
        if not np.issubdtype(info.dtype, np.floating):
            continue
        candidates.append(CutPoint(p, nid, node.out_port, int(np.prod(info.shape))))
    return rt, candidates


def choose_cuts(model: Model, analysis, n_stages: int) -> Tuple[List[int], List[CutPoint]]:
    """Pick n_stages − 1 cut points minimizing the largest per-stage FLOP
    cost (exact DP over the candidates)."""
    rt, cands = find_cut_candidates(model, analysis)
    k = n_stages - 1
    if k == 0:
        return rt, []
    if len(cands) < k:
        raise ValueError(
            f"model {model.name!r} has only {len(cands)} valid pipeline cut "
            f"points; cannot split into {n_stages} stages")
    costs = [_node_cost(model, analysis, model.nodes[nid]) for nid in rt]
    prefix = np.concatenate([[0.0], np.cumsum(costs)])

    def seg(i: int, j: int) -> float:  # cost of rt[i..j] inclusive
        return float(prefix[j + 1] - prefix[i])

    n = len(cands)
    # dp[kk][j]: the least largest cost of rt[0..cands[j].pos] in kk + 1
    # pieces with the last cut at cands[j]
    dp = [[math.inf] * n for _ in range(k)]
    arg = [[-1] * n for _ in range(k)]
    for j in range(n):
        dp[0][j] = seg(0, cands[j].pos)
    for kk in range(1, k):
        for j in range(n):
            for i in range(j):
                v = max(dp[kk - 1][i], seg(cands[i].pos + 1, cands[j].pos))
                if v < dp[kk][j]:
                    dp[kk][j], arg[kk][j] = v, i
    best, bj = math.inf, -1
    for j in range(n):
        v = max(dp[k - 1][j], seg(cands[j].pos + 1, len(rt) - 1))
        if v < best:
            best, bj = v, j
    picks = [bj]
    for kk in range(k - 1, 0, -1):
        picks.append(arg[kk][picks[-1]])
    picks.reverse()
    return rt, [cands[j] for j in picks]


# -- stage sub-models ----------------------------------------------------------

PP_IN = "__pp_in__"
PP_OUT = "__pp_out__"


@dataclasses.dataclass
class StageSpec:
    model: Model
    cut_in: Optional[CutPoint]    # tensor this stage consumes (None = first)
    cut_out: Optional[CutPoint]   # tensor this stage produces (None = last)


def partition(model: Model, rt: List[int], cuts: List[CutPoint],
              analysis=None) -> List[StageSpec]:
    """Cut the model into len(cuts) + 1 stage sub-models.  Node objects are
    shared with the full model (same ids); each boundary gets a synthetic
    ``__pp_in__`` Parameter / ``__pp_out__`` Result with the cut tensor's
    TensorInfo.

    Compile-time-folded subtrees (ShapeOf → … → PriorBox chains) are copied
    into every stage that reads them, like Consts.  Where such a subtree
    reads a runtime tensor of another stage it reads it through ShapeOf
    (value propagation sees no runtime VALUE any other way), so a zero
    Const with the declared TensorInfo is an exact stand-in: the stage's
    own shape inference makes the folded values again from it."""
    if model.find_by_type("ReadValue"):
        raise NotImplementedError(
            "pipeline partitioning of stateful networks (ReadValue/Assign) is not "
            "supported: the variable state lives with one network's walk "
            "(runtime/compiler.py), which a stage cut would split")
    if analysis is None:
        analysis = infer_shapes(model)
    folded = folded_nodes(model, analysis)
    bounds = [-1] + [c.pos for c in cuts] + [len(rt) - 1]
    # a Result rides with its producer (in the last stage, by
    # find_cut_candidates' result_floor); one fed by a FOLDED producer (a
    # statically known output, ShapeOf → Result) lands in the last stage,
    # whose closure pulls its folded chain in
    results_by_prod: Dict[int, List[Node]] = {}
    folded_results = []
    for r in model.results:
        src, _ = model.in_edges[r.id][0]
        if src in folded:
            folded_results.append(r)
        else:
            results_by_prod.setdefault(src, []).append(r)
    if folded_results and rt:
        results_by_prod.setdefault(rt[-1], []).extend(folded_results)

    fresh = max(model.nodes) + 1
    stages: List[StageSpec] = []
    for s in range(len(bounds) - 1):
        seg_ids = rt[bounds[s] + 1: bounds[s + 1] + 1]
        nodes: Dict[int, Node] = {nid: model.nodes[nid] for nid in seg_ids}
        for nid in seg_ids:
            for r in results_by_prod.get(nid, ()):
                nodes[r.id] = r
        cut_in = cuts[s - 1] if s > 0 else None
        cut_out = cuts[s] if s < len(cuts) else None
        edges: List[Edge] = []
        pp_in_id = fresh
        stub_id = [fresh + 2]  # pp_in / pp_out take fresh, fresh + 1

        def close_over(e: Edge, s=s, cut_in=cut_in, nodes=nodes, edges=edges,
                       stub_id=stub_id):
            """Resolve one edge whose dst is in the stage."""
            if e.src in nodes:
                edges.append(e)
                return
            src_node = model.nodes[e.src]
            if src_node.op_type == "Const":
                nodes[e.src] = src_node
                edges.append(e)
            elif e.src in folded:
                nodes[e.src] = src_node
                edges.append(e)
                for port, (up, uport) in sorted(model.in_edges[e.src].items()):
                    close_over(Edge(up, uport, e.src, port))
            elif cut_in and (e.src, e.src_port) == (cut_in.node_id, cut_in.port):
                edges.append(Edge(pp_in_id, 0, e.dst, e.dst_port))
            elif e.dst in folded:
                # a folded consumer reading an out-of-stage runtime tensor:
                # a shape-only use (see the docstring), so a zero Const
                # with the declared TensorInfo stands in
                info = src_node.outputs[e.src_port]
                sid = stub_id[0]
                stub_id[0] += 1
                nodes[sid] = Node(id=sid, name=f"__pp_shape_{e.src}_{e.src_port}__",
                                  op_type="Const", attrs={}, inputs={}, outputs={0: info},
                                  const=np.zeros(info.shape, info.dtype))
                edges.append(Edge(sid, 0, e.dst, e.dst_port))
            else:
                raise AssertionError(f"stage {s}: edge {e} crosses the cut from a "
                                     f"non-articulation node (a partition bug)")

        initial = set(nodes)  # the closure grows `nodes`; folded additions
        for e in model.edges:  # close over their own in-edges recursively
            if e.dst in initial:
                close_over(e)
        if cut_in is not None:
            info = model.nodes[cut_in.node_id].outputs[cut_in.port]
            nodes[pp_in_id] = Node(id=pp_in_id, name=PP_IN, op_type="Parameter", attrs={},
                                   inputs={}, outputs={0: info})
        if cut_out is not None:
            info = model.nodes[cut_out.node_id].outputs[cut_out.port]
            out_id = fresh + 1
            nodes[out_id] = Node(id=out_id, name=PP_OUT, op_type="Result", attrs={},
                                 inputs={0: info}, outputs={})
            edges.append(Edge(cut_out.node_id, cut_out.port, out_id, 0))
        stages.append(StageSpec(Model(f"{model.name}_pp{s}", nodes, edges), cut_in, cut_out))
    return stages


# -- the pipelined network ------------------------------------------------------


class RemoteStage:
    """A stage whose every position another process owns: its sub-model,
    for the names, never compiled or walked here."""

    def __init__(self, model: Model):
        self.model = model
        self.input_names = [n.name for n in model.parameters]
        self.output_names = [n.name for n in model.results]


class PipelinedNetwork:
    """GPipe microbatches over ``mesh``'s 'stage' axis, data parallel over
    its 'data' axis.  Built by ``compile_pipelined``.  After a call across
    processes, ``handoffs`` lists this process's exchanges, one
    ``{"dir": "send" | "recv" | "broadcast", "microbatch", "data", "stage"
    (the sending stage), "peer", "bytes", "s"}`` each: ``s`` the host
    seconds the call spent in it (a send: the copy to the host, which waits
    for the stage's work, and the start of the send; a receive: the wait
    and the copy to the device; a broadcast: one block's outputs)."""

    def __init__(self, stage_nets, cuts: List[CutPoint], mesh: Mesh, model=None):
        if "stage" not in mesh.shape:
            raise ValueError("pipeline mesh needs a 'stage' axis")
        self.mesh = mesh
        # the whole prepared model (the server reads .model.parameters, the
        # apps .model.results)
        self.model = model if model is not None else stage_nets[0].model
        # serving/server.py rounds its buckets up to multiples of 'data'
        self._batch_pspec = P("data")
        self.n_stages = mesh.shape["stage"]
        self.data_ax = mesh.shape.get("data", 1)
        if len(stage_nets) != self.n_stages:
            raise ValueError(f"{len(stage_nets)} stages vs mesh stage axis {self.n_stages}")
        self.stages = stage_nets
        self.cuts = cuts
        self.input_names = list(stage_nets[0].input_names)
        self.output_names = list(stage_nets[-1].output_names)
        self.handoffs: List[dict] = []
        for s, net in enumerate(stage_nets):
            if isinstance(net, RemoteStage):
                continue
            # stage s's weights on mesh column s: one copy a distinct device
            column = mesh.devices[:, s].reshape(self.data_ax, 1, 1)
            shard_compiled(net, Mesh(column))
            if s < self.n_stages - 1:
                net._keep_dtype = frozenset({PP_OUT})

    def _pick_n_micro(self, batch: int) -> int:
        """Largest microbatch count ≤ 2·n_stages (a full pipeline plus one
        refill: bubble fraction (K − 1) / (n_micro + K − 1)) that divides the
        batch into 'data'-divisible microbatches."""
        for n in range(min(2 * self.n_stages, batch), 0, -1):
            if batch % n == 0 and (batch // n) % self.data_ax == 0:
                return n
        raise ValueError(f"batch {batch} cannot be split into microbatches shardable "
                         f"over data={self.data_ax}")

    def infer_batch(self, inputs: Dict[str, np.ndarray],
                    n_micro: Optional[int] = None) -> Dict[str, np.ndarray]:
        """inputs: {name: (B, ...)}; returns {result name: (B, ...)} as
        ``CompiledNetwork.infer_batch`` does.  Across processes every process
        passes the same full batch and gets the full output (module
        docstring)."""
        from pyopenvino_tpu_torch.runtime.compiler import CompiledNetwork

        for name in self.input_names:
            if name not in inputs:
                raise KeyError(f"missing input for Parameter {name!r}")
        batch = int(np.asarray(next(iter(inputs.values()))).shape[0])
        if n_micro is None:
            n_micro = self._pick_n_micro(batch)
        if batch % n_micro or (batch // n_micro) % self.data_ax:
            raise ValueError(f"batch {batch} not divisible into {n_micro} microbatches "
                             f"over data={self.data_ax}")
        per = batch // n_micro // self.data_ax
        blocks = [(m, d) for m in range(n_micro) for d in range(self.data_ax)]
        pos = self.mesh.devices
        walks = {(s, d): Walk(net, d, batched=True) for s, net in enumerate(self.stages)
                 for d in range(self.data_ax) if is_local(pos[d, s])}
        # every block's rows on its first-stage device before any stage runs
        held, sent = {}, []
        for i, (m, d) in enumerate(blocks):
            if is_local(pos[d, 0]):
                rows = {k: np.asarray(v)[i * per:(i + 1) * per] for k, v in inputs.items()}
                held[m, d] = self.stages[0]._stage(rows, walks[0, d].lead)
        last = self.n_stages - 1
        self.handoffs = []
        for t in range(n_micro + last):
            for s in range(min(t, last), max(0, t - n_micro + 1) - 1, -1):
                m = t - s
                for d in range(self.data_ax):
                    if not is_local(pos[d, s]):
                        continue
                    tag = (m * self.data_ax + d) * self.n_stages + s
                    if s > 0 and not is_local(pos[d, s - 1]):
                        t0, src = time.perf_counter(), owner(pos[d, s - 1])
                        held[m, d] = recv_tensor(src, tag - 1, walks[s, d].lead)
                        self._handoff("recv", m, d, s - 1, src, held[m, d], t0=t0)
                    feed = held[m, d] if s == 0 else {PP_IN: held[m, d]}
                    out = self.stages[s]._batch_on(feed, per, walks[s, d])
                    held[m, d] = out if s == last else out[PP_OUT]
                    if s < last and not is_local(pos[d, s + 1]):
                        t0, dst, cut = time.perf_counter(), owner(pos[d, s + 1]), held.pop((m, d))
                        sent.append(send_tensor(cut, dst, tag))
                        self._handoff("send", m, d, s, dst, cut, t0=t0)
        for handle in sent:
            handle.wait()
        if self.mesh.spans_processes:
            # the last stage's process sends each block's outputs to all
            for m, d in blocks:
                t0, src = time.perf_counter(), owner(pos[d, last])
                mine = held.get((m, d), {})
                held[m, d] = {k: broadcast_tensor(mine.get(k), src) for k in self.output_names}
                self._handoff("broadcast", m, d, last, src, *held[m, d].values(), t0=t0)
        host = [CompiledNetwork._to_host(held[b]) for b in blocks]
        return {k: np.concatenate([h[k] for h in host]) for k in self.output_names}

    def _handoff(self, kind, m, d, stage, peer, *tensors, t0):
        self.handoffs.append({"dir": kind, "microbatch": m, "data": d, "stage": stage,
                              "peer": peer, "bytes": sum(t.numel() * t.element_size()
                                                         for t in tensors),
                              "s": time.perf_counter() - t0})


def compile_pipelined(model: Model, mesh: Mesh, config: Optional[Config] = None,
                      calibration_samples=None) -> PipelinedNetwork:
    """Partition ``model`` into mesh.shape['stage'] balanced stages, each
    compiled on the devices of its mesh column (see the module
    docstring)."""
    from pyopenvino_tpu_torch.runtime.compiler import CompiledNetwork, prepare_model

    config = config or Config()
    model, quantized, act_scales, bias_corr = prepare_model(model, config, calibration_samples)
    analysis = infer_shapes(model)
    rt, cuts = choose_cuts(model, analysis, mesh.shape["stage"])
    specs = partition(model, rt, cuts, analysis=analysis)
    nets = []
    for s, spec in enumerate(specs):
        here = [d for d in mesh.devices[:, s] if is_local(d)]
        nets.append(CompiledNetwork(spec.model, config, device=here[0], quantized=quantized,
                                    act_scales=act_scales, bias_corr=bias_corr)
                    if here else RemoteStage(spec.model))
    return PipelinedNetwork(nets, cuts, mesh, model=model)


def build_pipeline_mesh(n_stages: int, data: int = 1, devices=None) -> Mesh:
    """Mesh(('data', 'stage')) of shape (data, n_stages) over the first
    data·n_stages ``devices``, 'stage' minor so that consecutive stages sit
    on adjacent devices (the cut tensor is the traffic between them; a
    stage's 'data' replicas never talk).  ``devices`` as ``build_mesh``
    takes them (``device_grid``): a list, a device type (``"cpu"``:
    ``CPU_DEVICES`` entries of the CPU) or None (every visible card, or in
    a multi-process group the group's, process-major); too few raise.
    Logical shards of one card are named explicitly,
    ``[torch.device("cuda:0")] * n``."""
    return Mesh(device_grid(devices, (data, n_stages), "pipeline mesh"), ("data", "stage"))
