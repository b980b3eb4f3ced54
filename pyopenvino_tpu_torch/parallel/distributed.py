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
    ``shard_compiled`` places no weights there.  A ``model`` or ``spatial``
    group that would cross a process boundary raises ``NotImplementedError``
    (``parallel/mesh.py``); ``data`` rows and pipeline stages may cross it.
  * **Data parallelism** (``infer_batch_multiprocess``): each process feeds
    its local batch rows through the mesh rows it owns and gets its local
    rows of every output back.  No process ever holds the global batch.
  * **The pipeline** (``parallel/pipeline.py``): every process passes the
    same full batch, runs the microbatches of the stages it owns, hands a
    cut tensor to the next stage's process as its raw bytes
    (``send_tensor`` / ``recv_tensor``), and every process gets the full
    output (``broadcast_tensor`` from the last stage's process).

Backend: gloo only.  NCCL refuses two ranks on one card, and the port's
card machine holds one H100; NCCL across cards is ROADMAP.md §1 item 6d,
and any other backend raises naming it.  Gloo moves host tensors, so every
hand-off between processes goes through host memory.  The group has an
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
import zlib
from typing import Dict, List, Optional

import numpy as np
import torch

# seconds a collective or a receive waits for its peers before it raises
GROUP_TIMEOUT_S = 60.0

# the raw-bytes hand-off's dtype codes (``send_tensor``'s header)
_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64, torch.int8,
           torch.uint8, torch.int32, torch.int64, torch.bool)
_HEADER = 8  # dtype code, number of dimensions, up to six dimensions


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
    in order, split equally; no host ever holds the global batch.  Requires
    ``shard_compiled`` to have attached a mesh to ``compiled``."""
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
