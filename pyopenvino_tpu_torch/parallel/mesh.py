"""Device-mesh parallelism: data-parallel batch blocks, tensor-parallel (and
expert-parallel) channel shards, and spatial row blocks of a
``CompiledNetwork``, in one process or over the processes of a group.

Counterpart of ``pyopenvino_tpu/parallel/mesh.py``.  The JAX package places
its weights with ``NamedSharding``s and lets GSPMD partition one jitted
program; the port's walk (``runtime/compiler.py`` ``_run``) carries out each
placement itself, with the same ``MeshConfig``, the same ``(data, model,
spatial)`` axes and the same weight specs (``_weight_pspec``):

  * DP — ``infer_batch`` splits its batch into ``data`` equal blocks, in
    order; block d runs the model baked at B / data (``_batched_plan``) on
    the devices of mesh row d, on that device's copy of the weights, and
    the outputs are concatenated back in order.  A batch that ``data`` does
    not divide raises, as a ``P('data')`` placement does: the server rounds
    its buckets up to multiples of the axis (``serving/server.py``).  Every
    block's inputs are on its device before any block runs, and no block
    reads a result back before the last one is issued, so no host sync
    stands between two blocks.
  * TP — a Convolution, GroupConvolution or MatMul whose weight
    ``_weight_pspec`` shards over ``model`` runs once per model index, on
    that index's slice, with its fused bias and per-channel scale sliced
    with it; a GroupConvolution also slices its input to its groups.  The
    outputs are gathered along the sharded axis onto the lead device of the
    row (GSPMD's all-gather), so every other op sees a replicated
    activation.  A rank-3 MatMul weight is a stack of per-expert matrices:
    EP shards its expert axis, and the data input's expert axis with it
    where it has one, and keeps the scale replicated.  ``infer`` (batch 1)
    runs the sharded nodes the same way, as the JAX package's single-sample
    jit keeps its weights sharded.
  * SP — in ``infer_batch`` a rank-4 activation is held as ``spatial`` row
    blocks (``Rows``, its H axis split as ``torch.tensor_split`` splits it)
    from the inputs on.  A row-local op runs once per block: the
    elementwise ops, a Concat or Split off the row axis, an LRN across
    channels.  A windowed op (Convolution, GroupConvolution, MaxPool,
    AvgPool) splits its output rows the same way, and each block first
    takes from its neighbours the halo rows that its windows reach
    (``halo_rows``); the op's own padding applies only at the image's top
    and bottom (the block's node gets explicit pads).  Any other op, and a
    windowed op with fewer output rows than blocks, gathers the blocks and
    runs replicated; its rank-4 outputs with at least ``spatial`` rows are
    split again.  int8-stored edges (``_int8_edges``) split like float ones.

``tensor_parallel`` and ``spatial_parallel`` together are refused with the
JAX package's ``ValueError``.

Devices.  ``build_mesh`` takes the first ``data·model·spatial`` devices of
its list: by default every visible card, ``cuda:0 … cuda:n-1``, and it
raises where there are too few.  The CPU counts as one device repeated
(``CPU_DEVICES`` entries, the JAX tests' forced host devices), and a caller
who wants logical shards on one card names them: ``[torch.device("cuda:0")]
* 4``.  Every distinct device holds one copy of the weights it reads, made
on first use; logical shards on one device share the network's own weights,
and a TP slice is then a view of it.  In a multi-process group
(``parallel/distributed.py``) the default device list is the group's,
process-major; a position another process owns is a ``Remote``, which this
process never walks and gives no weights.  A data row may span processes:
every process that owns one of its positions runs the row's walk on its
own positions (its first one the lead, where each owner runs the
replicated ops, as GSPMD replicates them), and what the walk gathers on
one device in a single process crosses the row's gloo group instead
(``distributed.row_groups``): a TP output's parts by ``all_gather_parts``
in model-index order, a ``Rows`` value's blocks the same way, and each
block's halo rows from the neighbour blocks another process owns by
``exchange_rows``.  A ``Rows`` then holds only this process's blocks, and
every block's start and height.  Two layouts are refused with a
``ValueError``: a process owning positions of two data rows of which one
spans processes (``model·spatial`` and the local device count not dividing
one into the other), and an owner of a spanning row that holds none of the
positions its sharded axis uses (ROADMAP.md §1 item 6d).

What one process on one card can show: the sharding's arithmetic, each
kernel at its per-shard shapes, and what the bookkeeping costs.  It cannot
show transfers between cards or how several cards overlap: that the blocks
issued here would overlap on real cards is not verified.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from pyopenvino_tpu_torch.ir import attrs as A
from pyopenvino_tpu_torch.ops.padding import conv_padding, pool_padding
from pyopenvino_tpu_torch.ops.spec import TValue
from pyopenvino_tpu_torch.parallel.distributed import (
    Remote, agree_on_row, all_gather_parts, exchange_rows, global_devices, group, is_local,
    owner, row_groups,
)
from pyopenvino_tpu_torch.passes.util import ELEMENTWISE

AXES = ("data", "model", "spatial")

# the CPU's default device list: the JAX tests' 8 forced host devices
# (tests/conftest.py), so that ``ExecutableNetwork.shard``'s defaults give
# the same mesh in both packages' tests
CPU_DEVICES = 8

_WINDOWED = ("Convolution", "GroupConvolution", "MaxPool", "AvgPool")

@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data: int = 1
    model: int = 1
    spatial: int = 1


class P(tuple):
    """A partition spec: one mesh-axis name (or None) per dimension, ``P()``
    replicated; the JAX package's ``PartitionSpec``."""

    def __new__(cls, *spec):
        return super().__new__(cls, spec)

    def __repr__(self):
        return "P(" + ", ".join(map(repr, self)) + ")"


class Mesh:
    """An object array of ``torch.device``s shaped (data, model, spatial)."""

    def __init__(self, devices: np.ndarray, axis_names=AXES):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))
        # {data row: its RowGroup} of the rows across processes that this
        # process owns positions of, made once by ``attach``
        self.groups: Optional[Dict[int, object]] = None

    def __repr__(self):
        return f"Mesh({self.shape}, {sorted({str(d) for d in self.devices.flat})})"

    @property
    def spans_processes(self) -> bool:
        """Whether another process of the group owns a position."""
        return any(not is_local(d) for d in self.devices.flat)

    def owners(self, d: int) -> tuple:
        """The ranks that own positions of data row ``d``, in order."""
        return tuple(sorted({owner(x) for x in self.devices[d].flat}))

    def row_group(self, d: int):
        """Row ``d``'s ``RowGroup`` where it spans processes, else None."""
        return (self.groups or {}).get(d)


def canonical(device) -> torch.device:
    """``device`` with its index: a bare ``"cuda"`` names the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def default_devices(device_type="cuda") -> List[torch.device]:
    """Every visible card, or ``CPU_DEVICES`` entries of the CPU."""
    if torch.device(device_type).type == "cpu":
        return [torch.device("cpu")] * CPU_DEVICES
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def device_list(devices) -> list:
    """``devices`` as a list: a list as given, a device type (``"cpu"``,
    ``"cuda"``: ``default_devices``) or None (every visible card); in a
    multi-process group a type or None is the group's global list
    (``distributed.global_devices``)."""
    if devices is None or isinstance(devices, (str, torch.device)):
        if group() is not None:
            return global_devices()
        devices = default_devices(devices or "cuda")
    return [d if isinstance(d, Remote) else canonical(d) for d in devices]


def device_grid(devices, shape, what: str) -> np.ndarray:
    """The first prod(``shape``) of ``device_list(devices)`` as an object
    array of that shape.  Too few raise: no mesh shrinks to the devices
    there are."""
    n = int(np.prod(shape))
    devices = device_list(devices)
    if len(devices) < n:
        raise ValueError(f"{what} needs {n} devices, have {len(devices)}")
    arr = np.empty(n, dtype=object)
    for i, d in enumerate(devices[:n]):
        arr[i] = d
    return arr.reshape(shape)


def build_mesh(cfg: MeshConfig, devices=None) -> Mesh:
    """The mesh of the first data·model·spatial ``devices`` (``device_grid``).
    A data row may span processes; a process that would own positions of
    two rows, one of them across processes, raises."""
    mesh = Mesh(device_grid(devices, (cfg.data, cfg.model, cfg.spatial), f"mesh {cfg}"))
    rows_of: Dict[int, List[int]] = {}
    spanning = set()
    for d in range(cfg.data):
        ranks = mesh.owners(d)
        if len(ranks) > 1:
            spanning.add(d)
        for r in ranks:
            rows_of.setdefault(r, []).append(d)
    for r, rows in sorted(rows_of.items()):
        if len(rows) > 1 and spanning.intersection(rows):
            raise ValueError(
                f"mesh {cfg}: a data row's model·spatial = {cfg.model * cfg.spatial} "
                f"positions and a process's {len(group().local)} local devices do not "
                f"divide one into the other, so process {r} would own positions of rows "
                f"{rows}, one of them across processes (ROADMAP.md §1 item 6d)")
    return mesh


def local_rows(mesh: Mesh) -> List[int]:
    """The data rows that this process owns a position of."""
    return [d for d in range(mesh.devices.shape[0])
            if any(is_local(x) for x in mesh.devices[d].flat)]


def _weight_pspec(model, key: str, arr, model_axis_size: int) -> P:
    """The spec of one weight-dict entry: the output-channel dim of conv and
    MatMul weights (and of their per-channel scales) over 'model', a rank-3
    MatMul weight's expert axis (EP), everything else replicated."""

    def shard_axis(axis: int):
        if arr.shape[axis] % model_axis_size == 0 and arr.shape[axis] > 1:
            spec = [None] * arr.ndim
            spec[axis] = "model"
            return P(*spec)
        return P()

    head = key.split(".")[0]
    if not head.isdigit():
        # 'folded.<src>.<port>' entries are statically computed activations
        # (runtime/compiler.py _build_weights), not op weights: replicated
        return P()
    nid = int(head)
    for _, dst, dport in model.out_edges[nid]:
        consumer = model.nodes[dst]
        if dport != 1:
            continue
        if consumer.op_type in ("Convolution", "GroupConvolution"):
            # OIHW / (G, Co, ...) weights: output channels on axis 0; the
            # (O,1,1,1)-shaped scale vectors share that layout
            return shard_axis(0)
        if consumer.op_type == "MatMul":
            tb = A.get_bool(consumer.attrs, "transpose_b", False)
            if key.endswith(".scale"):
                # the scale mirrors the weight's keepdims reduction: (N,1)
                # when transposed, (..,N) otherwise; a rank-3 expert stack's
                # scale has no expert dim (passes/quantize.py): replicated
                if arr.ndim >= 3:
                    return P()
                return shard_axis(0 if tb else arr.ndim - 1)
            if arr.ndim >= 3:
                # EP: a stack of per-expert matrices, sharded on its experts
                return shard_axis(0)
            return shard_axis(arr.ndim - 2 if tb else arr.ndim - 1)
    return P()


def _sharded_axis(spec) -> Optional[int]:
    return spec.index("model") if "model" in spec else None


def check_tp_sp(tensor_parallel: bool, spatial_parallel: bool, model: int, spatial: int):
    """TP and SP together raise the JAX package's ``ValueError``."""
    if tensor_parallel and spatial_parallel and model > 1 and spatial > 1:
        # refused for parity with the JAX package, whose SPMD partitioner
        # miscompiles a conv with both shardings; the port's walk has no
        # such fault, but a network must not run a mesh there that fails here
        raise ValueError(
            "tensor_parallel and spatial_parallel cannot be combined (the JAX "
            "package refuses the pair, its XLA SPMD partitioner miscompiles conv "
            "with both shardings, and the port keeps its API); use one of them "
            "with data parallelism instead")


def shard_compiled(compiled, mesh: Mesh, tensor_parallel: bool = False,
                   spatial_parallel: bool = False):
    """Place a CompiledNetwork on ``mesh``: DP over 'data' in infer_batch,
    TP over 'model' with ``tensor_parallel`` (``_weight_pspec``), SP over
    'spatial' in infer_batch with ``spatial_parallel``.  Returns the same
    network, changed in place (``attach``)."""
    model_axis = mesh.shape["model"]
    spatial = mesh.shape.get("spatial", 1)
    check_tp_sp(tensor_parallel, spatial_parallel, model_axis, spatial)
    w_specs = {k: _weight_pspec(compiled.model, k, v, model_axis) if tensor_parallel else P()
               for k, v in compiled.weights.items()}
    return attach(compiled, mesh, w_specs,
                  "spatial" if spatial_parallel and spatial > 1 else None)


def attach(compiled, mesh: Mesh, w_specs: Dict[str, P], spatial_axis: Optional[str]):
    """Put ``compiled`` on ``mesh`` with these weight specs (the sharded
    import's are the exporter's, ``runtime/export.py``).  Its weights move
    to this process's first position of its first data row (that row's
    walk's lead, ``Walk``), which the network then names as its own.  On a
    mesh with rows across processes, the rows' groups are made here, once a
    mesh (every process of the group attaches, in the same order)."""
    rows = local_rows(mesh)
    if not rows:
        raise ValueError(f"{mesh}: no position of the mesh is on this process")
    lead = next(x for x in mesh.devices[rows[0]].flat if is_local(x))
    tensor_parallel = any(_sharded_axis(s) is not None for s in w_specs.values())
    _check_spanning_rows(mesh, tensor_parallel, spatial_axis is not None)
    if mesh.groups is None and mesh.spans_processes:
        mesh.groups = row_groups([mesh.owners(d) for d in range(mesh.devices.shape[0])])
    compiled._w_specs = dict(w_specs)
    compiled.weights = {k: v.to(lead) for k, v in compiled.weights.items()}
    if compiled.state is not None:
        compiled.state = {k: v.to(lead) if torch.is_tensor(v) else v
                          for k, v in compiled.state.items()}
    compiled.device = lead
    compiled.mesh = mesh
    compiled._batch_pspec = P("data")
    compiled._spatial_axis = spatial_axis
    compiled._tensor_parallel = tensor_parallel
    compiled._placed, compiled._parts, compiled._derived = {}, {}, {}
    compiled._static = {}
    return compiled


def _check_spanning_rows(mesh: Mesh, tensor_parallel: bool, spatial: bool) -> None:
    """A row across processes needs each owner to hold a position of the
    axis its walk shards (the model axis' ``row[:, 0]`` under TP, the
    spatial axis' ``row[0, :]`` under SP), else that owner would have no
    part of what the row gathers."""
    for d in range(mesh.devices.shape[0]):
        ranks = mesh.owners(d)
        if len(ranks) < 2:
            continue
        row = mesh.devices[d]
        for used, positions, axis in ((tensor_parallel, row[:, 0], "model"),
                                      (spatial, row[0, :], "spatial")):
            if not used:
                continue
            missing = sorted(set(ranks) - {owner(x) for x in positions})
            if missing:
                raise ValueError(
                    f"{mesh}: data row {d} spans processes {list(ranks)}, but processes "
                    f"{missing} own none of its {axis} positions; lay the row out so "
                    f"that each of its processes holds some (ROADMAP.md §1 item 6d)")


def shard_declared(compiled, config):
    """The mesh a Config declares (``mesh_data``, ``mesh_model``,
    ``mesh_spatial``), built on the default devices of the network's device
    type and attached: TP where ``mesh_model > 1``, SP where
    ``mesh_spatial > 1``.  Nothing where the mesh is one device."""
    d, m, s = config.mesh_data, config.mesh_model, config.mesh_spatial
    if d * m * s > 1:
        shard_compiled(compiled, build_mesh(MeshConfig(d, m, s), devices=compiled.device.type),
                       tensor_parallel=m > 1, spatial_parallel=s > 1)
    return compiled


# -- the weights on each device ------------------------------------------------


def weight_on(net, device, key: str) -> torch.Tensor:
    """``key`` of the network's weights on ``device``: the network's own on
    its device, elsewhere a copy made on first use (one a device)."""
    if device == net.device:
        return net.weights[key]
    placed = net._placed.setdefault(device, {})
    if key not in placed:
        placed[key] = net.weights[key].to(device)
    return placed[key]


class DeviceWeights:
    """The weight dict as one device reads it (``weight_on``)."""

    def __init__(self, net, device):
        self.net, self.device = net, device

    def __getitem__(self, key):
        return weight_on(self.net, self.device, key)

    def __contains__(self, key):
        return key in self.net.weights

    def get(self, key, default=None):
        return self[key] if key in self else default


def weights_for(net, device):
    return net.weights if device == net.device else DeviceWeights(net, device)


def weight_part(net, device, key: str, j: int) -> torch.Tensor:
    """Model index ``j``'s part of ``key`` on ``device``: its slice of a
    sharded weight (a view where the device holds the whole), the whole of
    a replicated one."""
    axis = _sharded_axis(net._w_specs.get(key, P()))
    if axis is None:
        return weight_on(net, device, key)
    ck = (device, key, j)
    if ck not in net._parts:
        whole = (weight_on(net, device, key)
                 if device == net.device or key in net._placed.get(device, {})
                 else net.weights[key])
        size = whole.shape[axis] // net.mesh.shape["model"]
        part = whole.narrow(axis, j * size, size)
        net._parts[ck] = part if part.device == device else part.to(device)
    return net._parts[ck]


def weight_shards(compiled, key: str) -> Dict[int, torch.Tensor]:
    """{model index: its part of ``key``} of this process's shards in its
    first data row, in order: every index in a single process; on a row
    across processes only the indices whose positions this process owns,
    as no weights go to another process's positions."""
    d = local_rows(compiled.mesh)[0]
    return {j: weight_part(compiled, dev, key, j)
            for j, dev in enumerate(compiled.mesh.devices[d, :, 0]) if is_local(dev)}


# -- spatial row blocks --------------------------------------------------------


class Rows:
    """A rank-4 activation (N, C, H, W) held as row blocks: block s holds
    rows [starts[s], starts[s] + heights[s]) on its own device, in
    channels_last memory; ``act_scale`` as ``TValue``'s (int8 codes).  On a
    row across processes a block another process owns is None here,
    ``owners`` names each block's rank and ``group`` is the row's
    ``RowGroup`` (both None in one process); ``received`` holds, while a
    windowed op runs, the halo rows that came from other processes'
    blocks, {(block, first row, end row): tensor}."""

    __slots__ = ("blocks", "act_scale", "heights", "starts", "owners", "group", "received")

    def __init__(self, blocks, act_scale=None, heights=None, owners=None, group=None):
        self.blocks = list(blocks)
        self.act_scale = act_scale
        self.heights = [b.shape[2] for b in self.blocks] if heights is None else list(heights)
        self.starts = np.cumsum([0] + self.heights[:-1]).tolist()
        self.owners, self.group, self.received = owners, group, None

    def _like(self, blocks, act_scale=None) -> "Rows":
        return Rows(blocks, act_scale, self.heights, self.owners, self.group)

    @property
    def shape(self):
        n, c, _, w = next(b for b in self.blocks if b is not None).shape
        return (n, c, sum(self.heights), w)

    def block(self, s) -> TValue:
        return TValue(self.blocks[s], act_scale=self.act_scale)

    def dequant(self, compute_dtype=None) -> "Rows":
        if self.act_scale is None:
            return self
        return self._like([None if b is None else self.block(s).dequant(compute_dtype).arr
                           for s, b in enumerate(self.blocks)])

    def quantized(self, scale) -> "Rows":
        return self._like([None if b is None else TValue.quantize(b, scale)
                           for b in self.blocks], act_scale=scale)

    def gather(self, device) -> TValue:
        """The whole value on ``device``: across processes, every block
        through the row's all-gather."""
        if self.group is None:
            parts = [b.to(device) for b in self.blocks]
        else:
            mine = [_nhwc(b) for b in self.blocks if b is not None]
            n, _, w, c = mine[0].shape
            shapes = [[(n, h, w, c) for h, o in zip(self.heights, self.owners) if o == r]
                      for r in self.group.ranks]
            parts = [_nchw(p) for p in all_gather_parts(mine, shapes, self.group, device)]
        arr = torch.cat(parts, dim=2)
        return TValue(arr.contiguous(memory_format=torch.channels_last), act_scale=self.act_scale)


def _channels_last(t):
    return t.contiguous(memory_format=torch.channels_last)


# A rank-4 value crosses processes in its channels_last memory order, as an
# (N, H, W, C) tensor, and arrives as the same view, with the strides the
# block has on its own process: its bytes, and the route a kernel takes on
# them (a one-channel tensor's channel stride, say), are the single
# process's.
def _nhwc(t):
    return t.permute(0, 2, 3, 1)


def _nchw(t):
    return t.permute(0, 3, 1, 2)


def split_rows(tv: TValue, devices, group=None) -> Rows:
    """``tv`` (rank 4, at least ``len(devices)`` rows) as row blocks, the
    blocks of another process's positions left out (``group``: the row's
    ``RowGroup`` where it spans processes)."""
    parts = torch.tensor_split(tv.arr, len(devices), dim=2)
    return Rows([_channels_last(p.to(d)) if is_local(d) else None
                 for p, d in zip(parts, devices)], act_scale=tv.act_scale,
                heights=[p.shape[2] for p in parts],
                owners=None if group is None else [owner(d) for d in devices], group=group)


def halo_rows(x: Rows, a: int, b: int, device) -> torch.Tensor:
    """Rows [a, b) of ``x`` on ``device``, taken from every block they
    cross: a windowed op's halo exchange with its neighbour blocks (those
    of another process from ``x.received``)."""
    parts = []
    for t, (blk, start, h) in enumerate(zip(x.blocks, x.starts, x.heights)):
        lo, hi = max(a, start), min(b, start + h)
        if lo < hi:
            parts.append(x.received[t, lo, hi] if blk is None
                         else blk.narrow(2, lo - start, hi - lo).to(device))
    return _channels_last(torch.cat(parts, dim=2))


def _rows_of(x: Rows, s: int, a: int, b: int, device) -> torch.Tensor:
    """Rows [a, b) for block ``s``: its own where they lie in it, else
    through ``halo_rows``."""
    start, h = x.starts[s], x.heights[s]
    if start <= a and b <= start + h:
        return _channels_last(x.blocks[s].narrow(2, a - start, b - a))
    return halo_rows(x, a, b, device)


def _exchange_halos(x: Rows, spans, devices) -> None:
    """The halo hand-off of a windowed op across processes: block s reads
    rows ``spans[s]``; every rows' piece of a block of this process that a
    block of another process reads is sent there, and every piece that a
    block of this process reads from another's arrives in ``x.received``."""
    me = group().rank
    n = len(x.blocks)
    sends, recvs = [], []
    for s, (a, b) in enumerate(spans):
        for t in range(n):
            lo, hi = max(a, x.starts[t]), min(b, x.starts[t] + x.heights[t])
            if t == s or lo >= hi or x.owners[s] == x.owners[t]:
                continue
            if x.owners[t] == me:
                sends.append((_nhwc(x.blocks[t].narrow(2, lo - x.starts[t], hi - lo)),
                              x.owners[s], t * n + s))
            elif x.owners[s] == me:
                n_, c, _, w = x.shape
                recvs.append(((t, lo, hi), (x.owners[t], t * n + s, (n_, hi - lo, w, c),
                                            x.blocks[s].dtype, devices[s])))
    if not sends and not recvs:
        return
    got = exchange_rows(sends, [r for _, r in recvs], x.group)
    x.received = {key: _nchw(t) for (key, _), t in zip(recvs, got)}


def _even_starts(n: int, parts: int):
    sizes = [len(c) for c in np.array_split(np.arange(n), parts)]
    return np.cumsum([0] + sizes).tolist()


# -- one data row's walk -------------------------------------------------------


class Walk:
    """The devices that one data block of a sharded network's walk runs
    on (mesh row ``d``): its model axis for TP, its spatial axis for SP
    (the two never both), and the lead device, where the replicated ops
    run: this process's first position of the row.  On a row across
    processes only this process's positions are walked, and ``group`` is
    the row's ``RowGroup``.  ``_run`` hands it every op node to emit
    (``emit``) and every rank-4 input (``place``)."""

    def __init__(self, net, d: int, batched: bool):
        row = net.mesh.devices[d]
        self.net = net
        self.lead = next(x for x in row.flat if is_local(x))
        self.group = net.mesh.row_group(d)
        self.tp = list(row[:, 0]) if net._tensor_parallel else [self.lead]
        self.sp = (list(row[0, :]) if batched and net._spatial_axis is not None
                   else [self.lead])

    @property
    def active(self) -> bool:
        return len(self.tp) > 1 or len(self.sp) > 1

    def place(self, tv: TValue):
        """A rank-4 value with at least a row a block (a Parameter's, a
        replicated op's output) in row blocks under SP."""
        s = len(self.sp)
        if s > 1 and isinstance(tv, TValue) and tv.arr.dim() == 4 and tv.arr.shape[2] >= s:
            return split_rows(tv, self.sp, self.group)
        return tv

    def emit(self, ctx, node, op, ins, fusion, bias) -> Dict[tuple, object]:
        """{store key: value} of one op node."""
        if len(self.tp) > 1 and self._weight_axis(ctx, node) is not None:
            return self._tensor_parallel(ctx, node, op, ins, fusion, bias)
        if len(self.sp) > 1 and any(isinstance(v, Rows) for v in ins.values()):
            kind = self._row_kind(ctx, node, ins)
            if kind == "window":
                out = self._windowed(ctx, node, op, ins, fusion, bias)
                if out is not None:
                    return out
            elif kind == "local":
                return self._row_local(ctx, node, op, ins)
        return self._replicated(ctx, node, op, ins, fusion, bias)

    def _replicated(self, ctx, node, op, ins, fusion, bias):
        """The node on the lead device, its row-block inputs gathered."""
        ins = {p: v.gather(self.lead) if isinstance(v, Rows) else v for p, v in ins.items()}
        return {k: self.place(v) for k, v in emit_node(ctx, node, op, ins, fusion, bias).items()}

    # -- TP / EP ---------------------------------------------------------------

    def _weight_axis(self, ctx, node) -> Optional[int]:
        if node.op_type not in ("Convolution", "GroupConvolution", "MatMul"):
            return None
        src = ctx.model.in_edges[node.id].get(1)
        if src is None:
            return None
        return _sharded_axis(self.net._w_specs.get(ctx.weight_prefix + str(src[0]), P()))

    def _tensor_parallel(self, ctx, node, op, ins, fusion, bias):
        key = ctx.weight_prefix + str(ctx.model.in_edges[node.id][1][0])
        n = len(self.tp)
        w = ins[1]
        expert = node.op_type == "MatMul" and w.arr.dim() >= 3
        out_axis = 1 if node.op_type != "MatMul" else (-3 if expert else -1)
        parts = []
        for j, dev in enumerate(self.tp):
            if not is_local(dev):
                continue
            x = ins[0]
            arr = x.arr
            if node.op_type == "GroupConvolution":  # the input channels of its groups
                c = arr.shape[1] // n
                arr = _channels_last(arr.narrow(1, j * c, c))
            elif expert and arr.dim() >= 3 and arr.shape[-3] == w.arr.shape[0]:
                e = arr.shape[-3] // n
                arr = arr.narrow(-3, j * e, e)
            shard_ins = {p: _on(v, dev) for p, v in ins.items() if p not in (0, 1)}
            shard_ins[0] = TValue(arr.to(dev), act_scale=x.act_scale)
            shard_ins[1] = TValue(weight_part(self.net, dev, key, j), qscale=(
                None if w.qscale is None else weight_part(self.net, dev, key + ".scale", j)))
            b = bias
            if b is not None and not expert:
                size = b.shape[0] // n
                b = b.narrow(0, j * size, size)
            b = None if b is None else b.to(dev)
            outs = emit_node(ctx.on(dev, shard=j), node, op, shard_ins, fusion, b)
            parts.append(next(iter(outs.values())))
        mine = [p.arr for p in parts]
        if self.group is not None:  # every index's part, in model-index order
            conv = mine[0].dim() == 4
            mine = [_nhwc(p) for p in mine] if conv else mine
            shapes = [[mine[0].shape] * sum(owner(dev) == r for dev in self.tp)
                      for r in self.group.ranks]
            mine = all_gather_parts(mine, shapes, self.group, self.lead)
            mine = [_nchw(p) for p in mine] if conv else mine
        arr = torch.cat([p.to(self.lead) for p in mine], dim=out_axis)
        if arr.dim() == 4:
            arr = _channels_last(arr)
        out_key = fusion.out_key if fusion is not None else (node.id, node.out_port)
        return {out_key: TValue(arr, act_scale=parts[0].act_scale)}

    # -- SP --------------------------------------------------------------------

    def _row_kind(self, ctx, node, ins) -> Optional[str]:
        t = node.op_type
        if t in _WINDOWED:
            return "window"
        if any(not isinstance(v, Rows) and v.arr.dim() > 4 for v in ins.values()):
            return None
        if t in ELEMENTWISE:
            return "local"
        if t == "Concat":
            axis = A.get_int(node.attrs, "axis") % 4
        elif t in ("Split", "VariadicSplit"):
            axis = int(np.asarray(ctx.static_value(node, 1)).reshape(-1)[0]) % 4
        elif t == "LRN":
            axes = {int(a) % 4 for a in np.asarray(ctx.static_value(node, 1)).reshape(-1)}
            axis = 1 if axes == {1} else 2
        else:
            return None
        return "local" if axis != 2 else None

    def _block_ctx(self, ctx, s):
        return ctx if self.sp[s] == ctx.device else ctx.on(self.sp[s])

    def _port_value(self, ctx, node, port, v, dev):
        """An operand that is not a row block, on ``dev``: a weight from the
        device's own copy."""
        src, _ = ctx.model.in_edges[node.id][port]
        key = ctx.weight_prefix + str(src)
        if ctx.model.nodes[src].op_type == "Const" and key in self.net.weights:
            return TValue(weight_on(self.net, dev, key), qscale=(
                None if v.qscale is None else weight_on(self.net, dev, key + ".scale")))
        return _on(v, dev)

    def _windowed(self, ctx, node, op, ins, fusion, bias):
        x = ins[0]
        if not isinstance(x, Rows):
            return None
        n_blocks = len(self.sp)
        _, _, h, w = x.shape
        if node.op_type in ("MaxPool", "AvgPool"):
            kh = A.get_int_tuple(node.attrs, "kernel")[0]
            sh, dh = A.get_int_tuple(node.attrs, "strides", (1, 1))[0], 1
            pad = pool_padding(node.attrs, (h, w))
        else:
            kh, kw = ins[1].shape[-2:]
            sh = A.get_int_tuple(node.attrs, "strides", (1, 1))[0]
            dh = A.get_int_tuple(node.attrs, "dilations", (1, 1))[0]
            pad = conv_padding(node.attrs, (h, w), (kh, kw))
        if pad.out_h < n_blocks:
            return None
        starts = _even_starts(pad.out_h, n_blocks)
        reach = (kh - 1) * dh + 1
        # the input rows [a, b) that each block's windows reach, padding
        # rows included
        reaches = [(starts[s] * sh - pad.pad_top, (starts[s + 1] - 1) * sh - pad.pad_top + reach)
                   for s in range(n_blocks)]
        if x.group is not None:
            _exchange_halos(x, [(max(a, 0), min(b, h)) for a, b in reaches], self.sp)
        blocks = []
        for s, (a, b) in enumerate(reaches):
            dev = self.sp[s]
            if not is_local(dev):
                blocks.append(None)
                continue
            o0, o1 = starts[s], starts[s + 1]
            top, bottom = max(0, -a), max(0, b - h)
            snode = dataclasses.replace(node, attrs={
                **node.attrs, "pads_begin": f"{top},{pad.pad_left}",
                "pads_end": f"{bottom},{pad.pad_right}", "auto_pad": "explicit",
                "rounding_type": "floor"})
            shard_ins = {p: self._port_value(ctx, node, p, v, dev)
                         for p, v in ins.items() if p != 0}
            shard_ins[0] = TValue(_rows_of(x, s, max(a, 0), min(b, h), dev),
                                  act_scale=x.act_scale)
            outs = emit_node(self._block_ctx(ctx, s), snode, op, shard_ins, fusion,
                         None if bias is None else bias.to(dev))
            (out_key, out), = outs.items()
            if out.arr.shape[2] != o1 - o0:
                raise RuntimeError(f"{node.op_type} {node.name!r} block {s}: "
                                   f"{out.arr.shape[2]} rows, expected {o1 - o0}")
            blocks.append(out)
        x.received = None
        local = [b for b in blocks if b is not None]
        return {out_key: Rows([None if b is None else _channels_last(b.arr) for b in blocks],
                              act_scale=local[0].act_scale,
                              heights=[starts[s + 1] - starts[s] for s in range(n_blocks)],
                              owners=x.owners, group=x.group)}

    def _row_local(self, ctx, node, op, ins):
        rows = [v for v in ins.values() if isinstance(v, Rows)]
        heights = rows[0].heights
        if any(r.heights != heights for r in rows):
            return self._replicated(ctx, node, op, ins, None, None)
        h = sum(heights)
        per_port: Dict[tuple, dict] = {}
        for s, dev in enumerate(self.sp):
            if not is_local(dev):
                continue
            start, size = rows[0].starts[s], heights[s]
            shard_ins = {}
            for p, v in ins.items():
                if isinstance(v, Rows):
                    shard_ins[p] = v.block(s)
                    continue
                v = self._port_value(ctx, node, p, v, dev)
                if v.arr.dim() >= 2 and v.arr.shape[-2] == h and h > 1:
                    v = TValue(v.arr.narrow(-2, start, size), qscale=v.qscale,
                               act_scale=v.act_scale)
                shard_ins[p] = v
            for key, out in emit_node(self._block_ctx(ctx, s), node, op, shard_ins,
                                  None, None).items():
                if out.arr.dim() != 4 or out.arr.shape[2] != size:
                    raise RuntimeError(f"{node.op_type} {node.name!r} block {s}: output "
                                       f"{tuple(out.arr.shape)} is not {size} rows")
                per_port.setdefault(key, {})[s] = out
        return {key: rows[0]._like([_channels_last(outs[s].arr) if s in outs else None
                                    for s in range(len(self.sp))],
                                   act_scale=next(iter(outs.values())).act_scale)
                for key, outs in per_port.items()}


def _on(v: TValue, device) -> TValue:
    if v.arr.device == device:
        return v
    return TValue(v.arr.to(device), qscale=None if v.qscale is None else v.qscale.to(device),
                  act_scale=v.act_scale)


def emit_node(ctx, node, op, ins, fusion, bias) -> Dict[tuple, TValue]:
    """{store key: value} of one op node on ``ctx``'s device, unsharded."""
    if fusion is not None:
        return {fusion.out_key: op.emit_fused(ctx, node, ins, bias=bias,
                                              act=fusion.act)[node.out_port]}
    return {(node.id, port): tv for port, tv in op.emit(ctx, node, ins).items()}


def walk_for(net, batched: bool = False) -> Optional[Walk]:
    """The walk of a sharded network's first data row on this process, None
    for an unsharded network.  On a row across processes every owner runs
    it, in the same order on the same inputs."""
    return Walk(net, local_rows(net.mesh)[0], batched) if net.mesh is not None else None


def run_batch(net, inputs, batch: int) -> Dict[str, np.ndarray]:
    """``infer_batch`` on a mesh: ``data`` equal blocks in order, each on
    its mesh row (``run_rows``).  A mesh across processes answers through
    ``distributed.infer_batch_multiprocess``, each process its own rows."""
    if net.mesh.spans_processes:
        raise ValueError(
            "the mesh spans processes: each process feeds its own rows through "
            "parallel.distributed.infer_batch_multiprocess")
    return run_rows(net, inputs, list(range(net.mesh.shape["data"])))


def run_rows(net, inputs, rows: List[int]) -> Dict[str, np.ndarray]:
    """``inputs``' batch split into ``len(rows)`` equal blocks in order,
    block i on mesh row ``rows[i]``: every block's inputs staged on its
    device first and no result read back before the last block is issued.
    A row across processes first checks that its owners feed it the same
    rows (``distributed.agree_on_row``)."""
    batch = int(np.asarray(next(iter(inputs.values()))).shape[0])
    if batch % len(rows):
        raise ValueError(
            f"batch {batch} does not divide into the mesh's {len(rows)} data blocks (a "
            f"P('data') placement); pad it to a multiple of {len(rows)}, as the server's "
            f"buckets are")
    per = batch // len(rows)
    walks = [Walk(net, d, batched=True) for d in rows]
    blocks = [{k: np.asarray(v)[i * per:(i + 1) * per] for k, v in inputs.items()}
              for i in range(len(rows))]
    for d, walk, block in zip(rows, walks, blocks):
        if walk.group is not None:
            agree_on_row(walk.group, d, block)
    staged = [net._stage(block, walk.lead) for block, walk in zip(blocks, walks)]
    outs = [net._batch_on(x, per, walk) for x, walk in zip(staged, walks)]
    host = [net._to_host(o) for o in outs]
    return {k: np.concatenate([h[k] for h in host]) for k in host[0]}
