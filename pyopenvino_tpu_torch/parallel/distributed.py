"""Multi-process groups: the processes of a launch joined into one group.

Counterpart of ``pyopenvino_tpu/parallel/distributed.py``.  The JAX package
joins its processes with ``jax.distributed``, so that ``jax.devices()``
spans every process and one jitted program runs collectively.  The port
joins them with ``torch.distributed`` and keeps the group's layout here;
each process then walks only what it owns:

  * **Devices.**  Each process names its local devices (``devices``:
    ``[torch.device("cuda:0")] * 2`` for two logical shards of one card, the
    CPU repeated in the tests; by default every visible card, and nothing
    falls back to the CPU).  After ``initialize_multihost``, ``build_mesh``
    and ``build_pipeline_mesh`` lay the GLOBAL device list out
    process-major, as ``jax.devices()`` orders it: process p's L local
    devices take positions [p·L, (p+1)·L).  A position that another process
    owns holds a ``Remote``: this process never walks it, and
    ``shard_compiled`` places no weights there.
  * **Data parallelism** (``infer_batch_multiprocess``): each process feeds
    the batch rows of the data rows it owns and gets those rows of every
    output back.  No process ever holds the global batch.
  * **A data row across processes** (``parallel/mesh.py``): where a row's
    ``model`` or ``spatial`` group spans processes, every process that owns
    one of its positions runs the row's program (SPMD), feeds the row's
    rows and gets the row's full outputs, as ``jax.make_array_from_
    process_local_data`` and the dedup of replicated shards give them in
    the JAX package.  ``shard_compiled`` makes one gloo group a row
    (``row_groups``); the walk's gathers of tensor-parallel outputs and of
    row blocks are ``all_gather_parts`` on it, and its halo rows move
    between neighbouring blocks' processes by ``exchange_rows``.  Owners
    that feed a row different rows raise (``agree_on_row``).
  * **The pipeline** (``parallel/pipeline.py``): every process passes the
    same full batch, runs the microbatches of the stages it owns, hands a
    cut tensor to the next stage's process as its raw bytes
    (``send_tensor`` / ``recv_tensor``), and every process gets the full
    output (``broadcast_tensor`` from the last stage's process).

Backend: gloo only.  NCCL refuses two ranks on one card, and the port's
card machine holds one H100; NCCL across cards is ROADMAP.md §1 item 6d,
and any other backend raises naming it.  Gloo moves host tensors, so every
hand-off between processes goes through host memory.  Every group has an
explicit timeout (``GROUP_TIMEOUT_S``): a peer that dies or a schedule that
waits for a message nobody sends raises in the others instead of hanging.

Launching two ranks on one card (each a process of its own, the same
command but its rank)::

    python -m pyopenvino_tpu_torch.tools.mp_worker 0 2 localhost:29500 ... --device cuda &
    python -m pyopenvino_tpu_torch.tools.mp_worker 1 2 localhost:29500 ... --device cuda

or under ``torchrun``, whose ``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE`` and ``RANK`` stand in for the arguments.  Two processes on one
card are two CUDA contexts that the card time-slices: they show the group,
the layout and the hand-offs, not transfers between cards.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import time
import zlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

# seconds a collective or a receive waits for its peers before it raises
GROUP_TIMEOUT_S = 60.0

# the raw-bytes hand-off's dtype codes (``send_tensor``'s header)
_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64, torch.int8,
           torch.uint8, torch.int32, torch.int64, torch.bool)
_HEADER = 8  # dtype code, number of dimensions, up to six dimensions
# the halo hand-offs' tags (on a row's own group besides, so that no
# pipeline hand-off, ``send_tensor``'s 2·tag and 2·tag + 1, can take one)
HALO_TAG = 1 << 20


@dataclasses.dataclass(frozen=True)
class Remote:
    """A mesh position that another process of the group owns: that
    process's rank and the position's index among its local devices."""

    rank: int
    index: int

    def __str__(self):
        return f"rank{self.rank}:{self.index}"


@dataclasses.dataclass(frozen=True)
class Group:
    """The group this process joined: its rank, the number of processes, and
    this process's local devices."""

    rank: int
    size: int
    local: tuple


_group: Optional[Group] = None


def group() -> Optional[Group]:
    """The group ``initialize_multihost`` joined, None in a single process."""
    return _group


def is_local(device) -> bool:
    """Whether a mesh position is this process's (a ``torch.device``)."""
    return not isinstance(device, Remote)


def owner(device) -> int:
    """The rank of the process that owns a mesh position."""
    if isinstance(device, Remote):
        return device.rank
    return _group.rank if _group is not None else 0


def global_devices() -> list:
    """The group's device list, process-major: this process's positions its
    own devices, every other process's ``Remote``s."""
    g = _group
    return [d if p == g.rank else Remote(p, i)
            for p in range(g.size) for i, d in enumerate(g.local)]


def _local_devices(devices) -> List[torch.device]:
    from pyopenvino_tpu_torch.parallel.mesh import canonical

    if devices is None:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [canonical(d) for d in devices]


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         devices=None, backend: str = "gloo") -> dict:
    """Join this process to the launch's group; a no-op in a single
    process.  Returns the JAX package's summary: ``initialized``,
    ``process_index``, ``process_count``, ``local_devices`` and
    ``global_devices`` (counts).

    ``coordinator_address`` is ``host:port`` (rank 0 listens there) or a
    ``torch.distributed`` init URL (``file://`` a store file every process
    can reach); a missing argument is read from torchrun's environment
    (``MASTER_ADDR``:``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).  With
    neither, nothing is joined.  ``devices``: this process's local devices
    (module docstring).  Only ``backend="gloo"`` is taken (module
    docstring).  Any collective or receive of the group waits
    ``GROUP_TIMEOUT_S`` seconds before it raises."""
    global _group
    if backend != "gloo":
        raise ValueError(
            f"backend {backend!r}: the port's process groups run on gloo only; NCCL "
            f"refuses two ranks on one card, and NCCL across cards is ROADMAP.md §1 "
            f"item 6d")
    env = os.environ
    if coordinator_address is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    local = _local_devices(devices)
    multi = bool(coordinator_address) or (num_processes or 0) > 1
    if multi and _group is None:
        if not coordinator_address or num_processes is None or process_id is None:
            raise ValueError(
                f"a process group needs its address, size and rank (have "
                f"{coordinator_address!r}, {num_processes!r}, {process_id!r})")
        if not local:
            raise RuntimeError(
                "this process has no local devices: no card is visible and none was "
                "named (devices=...); nothing falls back to the CPU")
        import torch.distributed as dist

        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        dist.init_process_group("gloo", init_method=url, world_size=num_processes,
                                rank=process_id,
                                timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        counts = [torch.zeros(1, dtype=torch.int64) for _ in range(num_processes)]
        dist.all_gather(counts, torch.tensor([len(local)]))
        if len({int(c) for c in counts}) != 1:
            dist.destroy_process_group()
            raise ValueError(f"the processes name unequal numbers of local devices "
                             f"{[int(c) for c in counts]}: the process-major layout "
                             f"needs the same number in each")
        _group = Group(process_id, num_processes, tuple(local))
    count = _group.size if _group is not None else 1
    return {
        "initialized": _group is not None,
        "process_index": _group.rank if _group is not None else 0,
        "process_count": count,
        "local_devices": len(local),
        "global_devices": len(local) * count,
    }


def shutdown_multihost() -> None:
    """Leave the group (``jax.distributed.shutdown``); nothing in a single
    process."""
    global _group
    if _group is not None:
        import torch.distributed as dist

        dist.destroy_process_group()
        _group = None


# -- hand-offs between processes -------------------------------------------------


def _header(t: torch.Tensor) -> torch.Tensor:
    if t.dim() > _HEADER - 2:
        raise ValueError(f"a hand-off of rank {t.dim()}: at most {_HEADER - 2} dimensions")
    head = torch.zeros(_HEADER, dtype=torch.int64)
    head[0], head[1] = _DTYPES.index(t.dtype), t.dim()
    head[2:2 + t.dim()] = torch.tensor(t.shape, dtype=torch.int64)
    return head


def _bytes_of(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bytes on the host, as a flat uint8 view (bfloat16 arrives bit
    for bit, whatever the backend does with the type)."""
    return t.detach().contiguous().reshape(-1).view(torch.uint8).cpu()


def _from_bytes(head: torch.Tensor, buf: torch.Tensor, device) -> torch.Tensor:
    dtype, ndim = _DTYPES[int(head[0])], int(head[1])
    shape = [int(d) for d in head[2:2 + ndim]]
    return buf.view(dtype).reshape(shape).to(device)


def _empty_for(head: torch.Tensor) -> torch.Tensor:
    dtype, ndim = _DTYPES[int(head[0])], int(head[1])
    n = int(np.prod([int(d) for d in head[2:2 + ndim]]))
    return torch.empty(n * torch.tensor([], dtype=dtype).element_size(), dtype=torch.uint8)


class Sent:
    """An unfinished ``send_tensor``: it holds the buffers until ``wait``."""

    def __init__(self, works, buffers):
        self.works, self.buffers = works, buffers

    def wait(self):
        for w in self.works:
            w.wait()


def send_tensor(t: torch.Tensor, dst: int, tag: int) -> Sent:
    """Start sending ``t`` to rank ``dst`` as a header and its raw bytes
    (tags 2·tag and 2·tag + 1); ``wait`` on the result before the process
    leaves the group."""
    import torch.distributed as dist

    head, buf = _header(t), _bytes_of(t)
    works = [dist.isend(head, dst, tag=2 * tag), dist.isend(buf, dst, tag=2 * tag + 1)]
    return Sent(works, (head, buf))


def recv_tensor(src: int, tag: int, device) -> torch.Tensor:
    """The tensor ``send_tensor`` sent from rank ``src`` under ``tag``, on
    ``device``; raises after the group's timeout if it never comes."""
    import torch.distributed as dist

    head = torch.zeros(_HEADER, dtype=torch.int64)
    dist.recv(head, src, tag=2 * tag)
    buf = _empty_for(head)
    dist.recv(buf, src, tag=2 * tag + 1)
    return _from_bytes(head, buf, device)


def broadcast_tensor(t: Optional[torch.Tensor], src: int) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank (the others pass None and get a
    host tensor); every rank calls it in the same order."""
    import torch.distributed as dist

    if _group.rank == src:
        head, buf = _header(t), _bytes_of(t)
        dist.broadcast(head, src)
        dist.broadcast(buf, src)
        return t
    head = torch.zeros(_HEADER, dtype=torch.int64)
    dist.broadcast(head, src)
    buf = _empty_for(head)
    dist.broadcast(buf, src)
    return _from_bytes(head, buf, "cpu")


# -- a data row across processes --------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RowGroup:
    """The processes that own positions of one data row of a mesh, in rank
    order, and their gloo group: the row's program runs on them."""

    ranks: tuple
    pg: object = dataclasses.field(compare=False, repr=False)


def _new_group(ranks):
    import torch.distributed as dist

    return dist.new_group(list(ranks), backend="gloo",
                          timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))


def row_groups(owners: Sequence[tuple]) -> Dict[int, RowGroup]:
    """{row: its group} of the rows that this process owns positions of and
    that more than one process owns (``owners[d]``: row d's ranks).  Every
    process calls ``dist.new_group`` for every such row, member or not, in
    row order, as the group's creation requires."""
    out = {}
    for d, ranks in enumerate(owners):
        if len(ranks) > 1:
            pg = _new_group(ranks)
            if _group.rank in ranks:
                out[d] = RowGroup(tuple(ranks), pg)
    return out


# this process's exchanges on its rows' groups since ``reset_exchanges``:
# {"all_gather" | "halo": {"count", "bytes_out", "bytes_in", "s", and "s" split
# into its steps, _STEPS}}
_exchanges: Dict[str, Dict[str, float]] = {}
# waiting for the card's work on what is sent, the copies to the host, the
# gloo exchange itself (a receive: its wait for the peer), the copies back
_STEPS = ("s_wait", "s_to_host", "s_wire", "s_to_device")


def reset_exchanges() -> None:
    _exchanges.clear()


def exchanges() -> Dict[str, Dict[str, float]]:
    """How many exchanges of each kind this process made on its rows'
    groups, the payload bytes it sent and received, and the host seconds
    they took, in all and by step (``_STEPS``)."""
    return {k: dict(v) for k, v in _exchanges.items()}


class _Steps:
    """The host clock at each step's end (``mark``)."""

    def __init__(self):
        self.times = [time.perf_counter()]

    def mark(self):
        self.times.append(time.perf_counter())


def _count(kind: str, bytes_out: int, bytes_in: int, steps: _Steps) -> None:
    e = _exchanges.setdefault(kind, dict.fromkeys(("count", "bytes_out", "bytes_in", "s")
                                                  + _STEPS, 0))
    e["count"] += 1
    e["bytes_out"] += bytes_out
    e["bytes_in"] += bytes_in
    e["s"] += steps.times[-1] - steps.times[0]
    for key, t0, t1 in zip(_STEPS, steps.times, steps.times[1:]):
        e[key] += t1 - t0


def _wait_for(tensors) -> None:
    """The card's work on ``tensors`` done (the copy to the host would wait
    for it anyway; apart, its time is the step's own)."""
    for t in tensors:
        if t.is_cuda:
            torch.cuda.current_stream(t.device).synchronize()


def _nbytes(shape, dtype) -> int:
    return int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()


def all_gather_parts(mine: List[torch.Tensor], shapes: Sequence[Sequence[tuple]],
                     rg: RowGroup, device) -> List[torch.Tensor]:
    """Every part of a row on ``device``, in the order of the group's ranks
    and, within a rank, in its own order: ``mine`` are this process's parts,
    ``shapes[i]`` the shapes of rank ``rg.ranks[i]``'s, all in ``mine[0]``'s
    dtype.  Each rank's parts travel as their raw bytes (``_bytes_of``) in
    one buffer padded to the largest, through one all_gather on the row's
    group, so bfloat16 and int8 codes arrive bit for bit."""
    import torch.distributed as dist

    steps = _Steps()
    _wait_for(mine)
    steps.mark()
    dtype = mine[0].dtype
    sizes = [sum(_nbytes(s, dtype) for s in shp) for shp in shapes]
    me = rg.ranks.index(_group.rank)
    own = torch.cat([_bytes_of(p) for p in mine])
    buf = own
    if own.numel() < max(sizes):
        buf = torch.zeros(max(sizes), dtype=torch.uint8)
        buf[:own.numel()] = own
    steps.mark()
    gathered = [torch.empty_like(buf) for _ in rg.ranks]
    dist.all_gather(gathered, buf, group=rg.pg)
    steps.mark()
    out = []
    for i, shp in enumerate(shapes):
        if i == me:
            out += [p.to(device) for p in mine]
            continue
        at = 0
        for s in shp:
            n = _nbytes(s, dtype)
            out.append(gathered[i][at:at + n].view(dtype).reshape(s).to(device))
            at += n
    steps.mark()
    _count("all_gather", own.numel(), sum(sizes) - sizes[me], steps)
    return out


def exchange_rows(sends, recvs, rg: RowGroup) -> List[torch.Tensor]:
    """One halo hand-off on a row's group: ``sends`` [(tensor, destination
    rank, tag)], ``recvs`` [(source rank, tag, shape, dtype, device)].
    Every send starts before the first receive, each as its raw bytes;
    returns the received tensors in ``recvs``' order, each where its entry
    names."""
    import torch.distributed as dist

    steps = _Steps()
    _wait_for([t for t, _, _ in sends])
    steps.mark()
    held = [_bytes_of(t) for t, _, _ in sends]
    steps.mark()
    works = [dist.isend(buf, dst, group=rg.pg, tag=HALO_TAG + tag)
             for buf, (_, dst, tag) in zip(held, sends)]
    got = []
    for src, tag, shape, dtype, _ in recvs:
        buf = torch.empty(_nbytes(shape, dtype), dtype=torch.uint8)
        dist.recv(buf, src, group=rg.pg, tag=HALO_TAG + tag)
        got.append(buf)
    for w in works:
        w.wait()
    steps.mark()
    out = [buf.view(dtype).reshape(shape).to(device)
           for buf, (_, _, shape, dtype, device) in zip(got, recvs)]
    steps.mark()
    _count("halo", sum(b.numel() for b in held), sum(b.numel() for b in got), steps)
    return out


def agree_on_row(rg: RowGroup, d: int, arrays: Dict[str, np.ndarray]) -> None:
    """One CRC-32 of the bytes this process feeds data row ``d``,
    all-gathered on the row's group: where the owners feed different rows,
    every owner raises, naming its rank."""
    import torch.distributed as dist

    crc = 0
    for k in sorted(arrays):
        a = np.ascontiguousarray(arrays[k])
        crc = zlib.crc32(repr((k, a.shape, a.dtype.str)).encode(), crc)
        crc = zlib.crc32(a.reshape(-1).view(np.uint8), crc)
    mine = torch.tensor([crc], dtype=torch.int64)
    every = [torch.zeros_like(mine) for _ in rg.ranks]
    dist.all_gather(every, mine, group=rg.pg)
    crcs = {r: int(e) for r, e in zip(rg.ranks, every)}
    if len(set(crcs.values())) > 1:
        raise ValueError(
            f"rank {_group.rank}: the owners of data row {d} feed it different rows "
            f"(rank: CRC-32 {crcs}); every process that owns a position of a row feeds "
            f"that row's rows")


# -- data parallelism ------------------------------------------------------------


def _agree_on_batch(arrays: Dict[str, np.ndarray]) -> None:
    """One all_gather of every process's local batch and input shapes: a
    mismatch raises on every rank instead of hanging a later exchange."""
    if _group is None:
        return
    import torch.distributed as dist

    batch = int(next(iter(arrays.values())).shape[0])
    shapes = repr(sorted((k, v.shape, v.dtype.str) for k, v in arrays.items()))
    mine = torch.tensor([batch, zlib.crc32(shapes.encode())], dtype=torch.int64)
    every = [torch.zeros_like(mine) for _ in range(_group.size)]
    dist.all_gather(every, mine)
    if any(not torch.equal(e, every[0]) for e in every):
        raise ValueError(
            f"the processes' local batches differ (rank: rows, inputs' shapes digest "
            f"{ {r: tuple(int(x) for x in e) for r, e in enumerate(every)} }): every "
            f"process feeds the same number of rows of the same shapes")


def infer_batch_multiprocess(compiled, local_inputs) -> Dict[str, np.ndarray]:
    """Data-parallel inference across the group: each process feeds its
    LOCAL batch rows ({name: (B_local, ...)} numpy) and gets its local rows
    of every output back as numpy.  The rows run through the mesh rows this
    process owns (``parallel/mesh.py::run_rows``, ``infer_batch``'s walk),
    in order, split equally; no host ever holds the global batch.  A data
    row that spans processes is one program on all its owners: each of
    them calls this in the same order, feeds the row's rows (the same bytes
    on every owner, ``agree_on_row``) and gets the row's full outputs.
    Requires ``shard_compiled`` to have attached a mesh to ``compiled``."""
    from pyopenvino_tpu_torch.parallel.mesh import local_rows, run_rows

    if compiled.mesh is None:
        raise ValueError("compiled network has no mesh; call shard_compiled")
    if compiled.variables:
        raise NotImplementedError(
            "stateful networks (ReadValue/Assign) run at their declared shapes, not as "
            "a batch of rows")
    compiled._check_inputs(local_inputs)
    arrays = {k: np.asarray(v) for k, v in local_inputs.items()}
    _agree_on_batch(arrays)
    return run_rows(compiled, arrays, local_rows(compiled.mesh))
