"""The port's multi-process groups (``pyopenvino_tpu_torch/parallel/
distributed.py``), its sharded export and import, and its worker
(``pyopenvino_tpu_torch/tools/mp_worker.py``) against the JAX package on
the CPU.

  * Counterparts of ``tests/test_multiprocess.py``'s four process tests (DP,
    DP + TP, the pipeline, expert parallelism): two real processes over
    gloo, each owning two CPU devices, on ``assets/trained/mnist_bn`` where
    the JAX tests read the reference's mnist, and on the port's
    ``models/moe_mlp.xml``.  Each rank's rows (the pipeline: the full
    output on both ranks) within the JAX test's rtol 1e-4 / atol 1e-5 of
    the JAX package's single-process ``compile_model(...).infer_batch`` on
    the same seeded blob, computed here on the same IR; INT8-FULL DP bit for
    bit against the port's own unsharded network.
  * A data row across the two ranks (``CROSS``): TP, EP and SP over four
    positions, batch-1 ``infer``, INT8-FULL and the sharded import, in the
    same spawn; float within the JAX bound, INT8-FULL and the import the
    exporter's bits, and every case bit for bit the port's single-process
    mesh of the same shape.
  * The failures: unequal local batches, and a row's owners feeding it
    different rows, make both ranks exit non-zero within the group's
    timeout; a receive nobody answers raises after it; another backend
    than gloo, a multi-process group without local devices, a process
    owning positions of two rows of which one spans processes, an owner of
    a spanning row without a position of its sharded axis, TP with SP and
    ``infer_batch_multiprocess`` on an unsharded network raise;
    ``initialize_multihost()`` alone joins nothing.
  * The process-major layout (ranks 0 and 1 of two, two devices each),
    checked on this process's view of the group, with the owners,
    ``attach``'s lead and ``weight_shards`` of a row across the ranks.
  * ``__graft_entry__.py``'s ``dryrun_multichip`` checks (DP × TP, the
    pipeline, SP, EP, the sharded export) on 8 and 16 logical CPU devices
    against the JAX package's unsharded outputs within the dryrun's rtol
    1e-4 / atol 1e-4 (EP 1e-5).
  * The sharded round trip (``tests/test_export.py::
    test_sharded_export_roundtrip``): export, import, the exporter's bits on
    distinct rows; the artifact's mesh, weight specs and batch spec equal
    to the JAX package's sharded artifact's.

The workers get ``worker_threads() // 2`` intra-op threads each and a
``file://`` store in ``tmp_path`` for the rendezvous (no port to race for);
``launch`` kills both on a failure or at ``SPAWN_TIMEOUT_S``."""

import json
import os
import socket
import subprocess
import sys
import time
import zipfile

import numpy as np
import pytest
import torch

from pyopenvino_tpu import parallel as jax_parallel
from pyopenvino_tpu.config import Backend as JaxBackend
from pyopenvino_tpu.config import Config as JaxConfig
from pyopenvino_tpu.ir import read_ir_model as jax_read
from pyopenvino_tpu.parallel import mesh as jax_mesh
from pyopenvino_tpu.runtime.compiler import compile_model as jax_compile

from pyopenvino_tpu_torch import parallel
from pyopenvino_tpu_torch.config import Config, QuantMode
from pyopenvino_tpu_torch.ir import read_ir_model
from pyopenvino_tpu_torch.models.moe_mlp import moe_mlp_paths
from pyopenvino_tpu_torch.parallel import distributed
from pyopenvino_tpu_torch.parallel.distributed import (
    GROUP_TIMEOUT_S, Group, Remote, infer_batch_multiprocess, initialize_multihost,
    shutdown_multihost,
)
from pyopenvino_tpu_torch.parallel.mesh import MeshConfig, build_mesh, local_rows, shard_compiled
from pyopenvino_tpu_torch.parallel.pipeline import (
    RemoteStage, build_pipeline_mesh, compile_pipelined,
)
from pyopenvino_tpu_torch.runtime.compiler import CompiledNetwork, compile_model
from pyopenvino_tpu_torch.runtime.export import import_compiled
from pyopenvino_tpu_torch.tools.mp_worker import launch, write_reference
from test_torch_port_threads import worker_threads
from test_torch_port_state import ema_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MNIST = tuple(os.path.join(REPO, "assets", "trained", f"mnist_bn.{e}") for e in ("xml", "bin"))
IN = "conv2d_input"
NPROC, BATCH_PER = 2, 4
# the JAX multiprocess test's bound; mnist_bn's TORCH-vs-XLA limit
RTOL, ATOL = 1e-4, 1e-5
# __graft_entry__.dryrun_multichip's bound (its EP check keeps ATOL)
DRYRUN_ATOL = 1e-4
SPAWN_TIMEOUT_S = 240
JAX_KEYS = {"initialized", "process_index", "process_count", "local_devices",
            "global_devices"}


def _blob(n, shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 255, (n, *shape)).astype(np.float32)


def _jax_outputs(paths, rows):
    """The JAX package's single-process infer_batch on ``rows``."""
    model = jax_read(*paths)
    param = model.parameters[0]
    return jax_compile(model, JaxConfig(backend=JaxBackend.XLA)).infer_batch({param.name: rows})


def _spawn(tmp_path, jobs):
    results = launch(NPROC, f"file://{tmp_path}/store", jobs, "cpu",
                     max(1, worker_threads() // NPROC), SPAWN_TIMEOUT_S)
    for pid, r in enumerate(results):
        assert not r["timed_out"], f"rank {pid} timed out:\n{r['output']}"
        assert r["rc"] == 0 and f"MP_OK {pid}" in r["output"], f"rank {pid}:\n{r['output']}"
    return results


# -- tests/test_multiprocess.py -----------------------------------------------------


CASES = ("dp", "dp+tp", "pipeline", "expert", "dp_int8full")
# a data row across the two ranks: (data = 1, model = 4) or (1, 1, 4), every
# rank feeding the row's rows; {case: (mesh, worker flags)}
CROSS = {
    "tp_cross": (MeshConfig(model=4), ["--model", "4"]),
    "ep_cross": (MeshConfig(model=4), ["--model", "4"]),
    "sp_cross": (MeshConfig(spatial=4), ["--spatial", "4"]),
    "tp_cross_b1": (MeshConfig(model=4), ["--model", "4", "--b1"]),
    "tp_cross_int8full": (MeshConfig(model=4), ["--model", "4"]),
    "import_cross": (MeshConfig(model=4), ["--model", "4"]),
    "import_cross_b1": (MeshConfig(model=4), ["--model", "4", "--b1"]),
}
INT8FULL = ("dp_int8full", "tp_cross_int8full", "import_cross", "import_cross_b1")


def _int8full(paths, name, shape):
    samples = [{name: x[None]} for x in _blob(4, shape, seed=3)]
    config = Config(quant=QuantMode.INT8_FULL)
    return compile_model(read_ir_model(*paths), config, device="cpu",
                         calibration_samples=samples), config, samples


def _single_process(case, paths, name, rows, art):
    """The port's single-process mesh of the case's shape on ["cpu"] * 4:
    its outputs on ``rows`` (batch 1: the first row), at the workers'
    intra-op threads."""
    cfg, flags = CROSS[case]
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, worker_threads() // NPROC))
    try:
        if case.startswith("import"):
            net = import_compiled(art, device="cpu", devices=["cpu"] * 4, mesh=cfg).network
        else:
            net = (_int8full(paths, name, rows.shape[1:])[0] if case in INT8FULL
                   else compile_model(read_ir_model(*paths), device="cpu"))
            shard_compiled(net, build_mesh(cfg, ["cpu"] * 4), tensor_parallel=cfg.model > 1,
                           spatial_parallel=cfg.spatial > 1)
        return net.infer({name: rows[:1]}) if "--b1" in flags else net.infer_batch({name: rows})
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """ONE pair of worker processes runs every case's job in turn (the
    startup paid once); {case: (rank 0's record, rank 1's record)}, a
    record of a case across the ranks with its ``saved`` outputs and the
    ``single`` process mesh's."""
    tmp_path = tmp_path_factory.mktemp("two_ranks")
    jobs, single = [], {}
    art = str(tmp_path / "dp2_tp2.ovpt")
    for case in CASES + tuple(CROSS):
        expert = case in ("expert", "ep_cross")
        paths = moe_mlp_paths() if expert else MNIST
        shape = (3, 32, 32) if expert else (1, 28, 28)
        name = "input" if expert else IN
        rows = _blob(NPROC * BATCH_PER, shape)
        ref = str(tmp_path / f"{case}.npz")
        model = paths[0]
        if case == "import_cross":
            # the sharded export of a DP2×TP2 network, imported onto the row
            net, config, samples = _int8full(paths, name, shape)
            shard_compiled(net, build_mesh(MeshConfig(data=2, model=2), "cpu"),
                           tensor_parallel=True)
            net.export(art, buckets=(len(rows),))
        if case in INT8FULL:
            if not case.startswith("import"):
                net, config, samples = _int8full(paths, name, shape)
            write_reference(ref, {name: rows}, net.infer_batch({name: rows}), config=config,
                            calibration=samples, act_scales=net.act_scales, gate="exact",
                            b1_outputs=net.infer({name: rows[:1]}))
        else:
            write_reference(ref, {name: rows}, _jax_outputs(paths, rows), rtol=RTOL, atol=ATOL)
        flags = {"dp+tp": ["--tp"], "expert": ["--tp"], "pipeline": ["--pipeline"]}.get(case, [])
        batch_per = BATCH_PER
        if case in CROSS:
            model = art if case.startswith("import") else model
            flags = CROSS[case][1] + ["--save", str(tmp_path / f"{case}.{{pid}}.npz")]
            batch_per = len(rows)
            single[case] = _single_process(case, paths, name, rows, art)
        jobs.append([model, str(batch_per), ref, *flags])
    results = _spawn(tmp_path, jobs)
    for r in results:
        assert r["group"]["process_count"] == NPROC and r["group"]["global_devices"] == 4
        assert len(r["jobs"]) == len(jobs)
    out = {}
    for i, case in enumerate(CASES + tuple(CROSS)):
        out[case] = tuple(r["jobs"][i] for r in results)
        for pid, job in enumerate(out[case]):
            if case in CROSS:
                with np.load(tmp_path / f"{case}.{pid}.npz") as f:
                    job["saved"] = {k: f[k] for k in f.files}
                job["single"] = single[case]
    return out


@pytest.mark.parametrize("case", CASES)
def test_two_process_distributed_inference(two_ranks, case):
    """Two ranks × two CPU devices: DP (data = 4), DP + TP (data = 2 across
    the ranks, model = 2 inside each), the pipeline (stage = 4, two stages a
    rank, the cut tensors handed across), expert parallelism (MoE-MLP's
    expert stacks over model = 2); each rank's rows within rtol 1e-4 /
    atol 1e-5 of the JAX package (the worker's gate), and INT8-FULL DP the
    port's own unsharded network's bits."""
    tp = case in ("dp+tp", "expert")
    for pid, job in enumerate(two_ranks[case]):
        if case == "pipeline":
            assert job["mesh"] == {"data": 1, "stage": 4} and job["rows"] == NPROC * BATCH_PER
            # stages 0-1 on rank 0 hand every microbatch to rank 1, whose last
            # stage broadcasts every block's outputs back
            sends, recvs = (job["handoffs"][k]["count"] for k in ("send", "recv"))
            assert (sends, recvs) == ((NPROC * BATCH_PER, 0) if pid == 0 else
                                      (0, NPROC * BATCH_PER))
            assert job["handoffs"]["broadcast"]["count"] == NPROC * BATCH_PER
        else:
            assert job["rows"] == BATCH_PER
            assert job["mesh"]["model"] == (2 if tp else 1)
            assert (job["sharded_weights"] > 0) == tp
        assert job["gate"] == ("exact" if case == "dp_int8full" else "close")
        if case == "expert":
            assert job["expert_stacks_sharded"] == 4
        if case == "dp_int8full":
            assert job["bit_equal"]


@pytest.mark.parametrize("case", CROSS)
def test_row_across_processes(two_ranks, case):
    """A data row across the two ranks (two CPU devices each): TP and EP on
    (data = 1, model = 4), SP on (1, 1, 4), batch-1 ``infer`` on TP4,
    INT8-FULL TP4, and the DP2×TP2 artifact imported onto TP4 (B = 8 and
    batch 1).  Both ranks feed the row's rows and get its full outputs:
    float within rtol 1e-4 / atol 1e-5 of the JAX package (the worker's
    gate), INT8-FULL and the import the exporter's bits; every case bit
    for bit the port's single-process mesh of the same shape on
    ["cpu"] * 4.  The TP outputs cross by all-gather, the SP halos by
    hand-offs."""
    cfg, flags = CROSS[case]
    for pid, job in enumerate(two_ranks[case]):
        assert job["mesh"] == {"data": 1, "model": cfg.model, "spatial": cfg.spatial}
        assert job["rows"] == (1 if "--b1" in flags else NPROC * BATCH_PER)
        assert job["owners"] == {"0": [0, 1]} and job["lead"] == "cpu"
        assert job["gate"] == ("exact" if case in INT8FULL else "close")
        if case in INT8FULL:
            assert job["bit_equal"]
        ex = job["exchanges_checked_call"]
        if cfg.model > 1:
            assert job["sharded_weights"] > 0 and ex["all_gather"]["count"] > 0
            assert ex["all_gather"]["bytes_in"] == ex["all_gather"]["bytes_out"] > 0
        else:
            assert job["sharded_weights"] == 0 and ex["halo"]["count"] > 0
            assert ex["halo"]["bytes_in"] > 0 and ex["all_gather"]["count"] > 0
        if case == "ep_cross":
            assert job["expert_stacks_sharded"] == 4
        assert sorted(job["saved"]) == sorted(job["single"])
        for k, want in job["single"].items():
            assert np.array_equal(job["saved"][k], want), f"rank {pid} {k}"


def _worker_cmd(tmp_path, pid, batch_per, ref, *flags):
    return [sys.executable, "-m", "pyopenvino_tpu_torch.tools.mp_worker", str(pid),
            str(NPROC), f"file://{tmp_path}/store", MNIST[0], str(batch_per), ref, *flags,
            "--device", "cpu", "--threads", str(max(1, worker_threads() // NPROC))]


def _communicate(procs, timeout):
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("a worker hung past the group's timeout")
    return outs


def test_local_batch_mismatch_fails_every_rank(tmp_path):
    """Rank 0 feeds 4 rows, rank 1 feeds 2: the all_gather of the local
    batches raises on both ranks, well inside the group's timeout."""
    rows = _blob(NPROC * BATCH_PER, (1, 28, 28))
    ref = str(tmp_path / "ref.npz")
    write_reference(ref, {IN: rows}, _jax_outputs(MNIST, rows))
    t0 = time.monotonic()
    procs = [subprocess.Popen(_worker_cmd(tmp_path, pid, BATCH_PER >> pid, ref), cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for pid in range(NPROC)]
    outs = _communicate(procs, GROUP_TIMEOUT_S)
    assert time.monotonic() - t0 < GROUP_TIMEOUT_S
    for p, out in zip(procs, outs):
        assert p.returncode != 0 and "local batches differ" in out, out


def test_row_owners_feeding_different_rows_fail_every_rank(tmp_path):
    """On (data = 1, model = 4) both ranks own the one row, but rank 1 feeds
    other rows than rank 0: the CRC-32s all-gathered on the row's group
    differ, and both ranks exit non-zero naming themselves, well inside the
    group's timeout."""
    refs = []
    for pid in range(NPROC):
        rows = _blob(BATCH_PER, (1, 28, 28), seed=pid)
        refs.append(str(tmp_path / f"ref{pid}.npz"))
        write_reference(refs[-1], {IN: rows}, _jax_outputs(MNIST, rows))
    t0 = time.monotonic()
    procs = [subprocess.Popen(_worker_cmd(tmp_path, pid, BATCH_PER, refs[pid], "--model", "4"),
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for pid in range(NPROC)]
    outs = _communicate(procs, GROUP_TIMEOUT_S)
    assert time.monotonic() - t0 < GROUP_TIMEOUT_S
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode != 0, out
        assert f"rank {pid}: the owners of data row 0 feed it different rows" in out, out


_SILENT_PEER = """
import sys, time
from pyopenvino_tpu_torch.parallel import distributed
distributed.GROUP_TIMEOUT_S = 1
rank = int(sys.argv[1])
distributed.initialize_multihost(sys.argv[2], 2, rank, devices=["cpu"])
if rank == 0:
    t0 = time.monotonic()
    try:
        distributed.recv_tensor(1, 0, "cpu")  # rank 1 never sends
    finally:
        print("waited", time.monotonic() - t0, flush=True)
else:
    time.sleep(60)
"""


def test_receive_nobody_sends_raises_after_the_timeout(tmp_path):
    """A schedule that waits for a hand-off its peer never sends raises
    through the group's timeout (1 s here) instead of hanging, while the
    peer is still alive."""
    procs = [subprocess.Popen([sys.executable, "-c", _SILENT_PEER, str(rank),
                               f"file://{tmp_path}/store"], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    try:
        out, _ = procs[0].communicate(timeout=50)
    finally:
        procs[1].kill()
        procs[1].communicate()
    assert procs[0].returncode != 0 and "Timed out" in out, out
    waited = float(out.split("waited ")[1].split()[0])
    assert 1 <= waited < 10, out


# -- the API -------------------------------------------------------------------


def test_parallel_all_equals_jax():
    assert parallel.__all__ == jax_parallel.__all__
    assert parallel.initialize_multihost is initialize_multihost


def test_initialize_without_arguments_or_environment(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    info = initialize_multihost(devices=["cpu"] * 2)
    assert set(info) == JAX_KEYS
    assert info == {"initialized": False, "process_index": 0, "process_count": 1,
                    "local_devices": 2, "global_devices": 2}
    assert distributed.group() is None


def test_other_backends_raise():
    with pytest.raises(ValueError, match="gloo only.*item 6d"):
        initialize_multihost("127.0.0.1:1", 2, 0, devices=["cpu"], backend="nccl")


def test_group_without_local_devices_raises(monkeypatch):
    """No card visible and none named: nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no local devices"):
        initialize_multihost("127.0.0.1:1", 2, 0)


def test_infer_batch_multiprocess_needs_a_mesh():
    net = compile_model(read_ir_model(*MNIST), device="cpu")
    with pytest.raises(ValueError, match="no mesh; call shard_compiled"):
        infer_batch_multiprocess(net, {IN: _blob(2, (1, 28, 28))})


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("given", ["arguments", "environment"])
def test_single_process_group_over_tcp(monkeypatch, given):
    """``host:port`` from the arguments or from torchrun's environment: a
    group of one process joins, lays the mesh out of its own devices, and
    leaves.  A port taken between the probe and the bind is tried again."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    for attempt in range(5):
        port = _free_port()
        args = (f"127.0.0.1:{port}", 1, 0)
        if given == "environment":
            for var, value in zip(("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"),
                                  ("127.0.0.1", str(port), "1", "0")):
                monkeypatch.setenv(var, value)
            args = ()
        try:
            info = initialize_multihost(*args, devices=["cpu"] * 2)
            break
        except RuntimeError as exc:  # the port went to another process
            if "address already in use" not in str(exc).lower() or attempt == 4:
                raise
    try:
        assert info == {"initialized": True, "process_index": 0, "process_count": 1,
                        "local_devices": 2, "global_devices": 2}
        mesh = build_mesh(MeshConfig(data=2))
        assert list(mesh.devices.flat) == [torch.device("cpu")] * 2
        net = shard_compiled(compile_model(read_ir_model(*MNIST), device="cpu"), mesh)
        rows = _blob(4, (1, 28, 28))
        got = infer_batch_multiprocess(net, {IN: rows})
        want = compile_model(read_ir_model(*MNIST), device="cpu").infer_batch({IN: rows})
        assert all(np.array_equal(got[k], want[k]) for k in want)
    finally:
        shutdown_multihost()
    assert distributed.group() is None


# -- the process-major layout ----------------------------------------------------


@pytest.fixture(params=[0, 1], ids=["rank0", "rank1"])
def rank_of_two(request, monkeypatch):
    """This process as rank ``param`` of two, two CPU devices each (the
    layout's view; nothing is exchanged)."""
    monkeypatch.setattr(distributed, "_group", Group(request.param, 2, (torch.device("cpu"),) * 2))
    return request.param


def _owners(mesh):
    return [d.rank if isinstance(d, Remote) else "here" for d in mesh.devices.flat]


def test_process_major_layout(rank_of_two):
    r, other = rank_of_two, 1 - rank_of_two
    mine = lambda owned: ["here" if o == r else o for o in owned]  # noqa: E731
    dp4 = build_mesh(MeshConfig(data=4))
    assert _owners(dp4) == mine([0, 0, 1, 1])
    assert local_rows(dp4) == [2 * r, 2 * r + 1]
    dp2_tp2 = build_mesh(MeshConfig(data=2, model=2))
    assert _owners(dp2_tp2) == mine([0, 0, 1, 1]) and local_rows(dp2_tp2) == [r]
    pp4 = build_pipeline_mesh(4)
    assert _owners(pp4) == mine([0, 0, 1, 1])
    assert Remote(other, 1) in list(pp4.devices.flat)
    # a data row across the ranks: both own it, each its own positions
    for cfg in (MeshConfig(model=4), MeshConfig(spatial=4), MeshConfig(data=1, model=2,
                                                                        spatial=2)):
        row = build_mesh(cfg)
        assert _owners(row) == mine([0, 0, 1, 1])
        assert local_rows(row) == [0] and row.owners(0) == (0, 1)
    with pytest.raises(ValueError, match="cannot be combined"):
        shard_compiled(compile_model(read_ir_model(*MNIST), device="cpu"),
                       build_mesh(MeshConfig(data=1, model=2, spatial=2)),
                       tensor_parallel=True, spatial_parallel=True)


@pytest.mark.parametrize("rank", [0, 1])
def test_process_owning_two_rows_one_across_raises(monkeypatch, rank):
    """Three devices a rank and rows of two positions: rank 0 would own row
    0 and half of row 1, which spans the ranks; refused naming both
    counts."""
    monkeypatch.setattr(distributed, "_group", Group(rank, 2, (torch.device("cpu"),) * 3))
    assert local_rows(build_mesh(MeshConfig(data=2, model=3))) == [rank]
    with pytest.raises(ValueError, match=r"model·spatial = 2 positions and a process's 3 "
                                         r"local devices .* process 0 would own positions "
                                         r"of rows \[0, 1\]"):
        build_mesh(MeshConfig(data=3, model=2))


@pytest.fixture
def groups_made(monkeypatch):
    """The row groups ``attach`` asks for, each rank tuple a made group
    (nothing joined here)."""
    made = []
    monkeypatch.setattr(distributed, "_new_group", lambda ranks: made.append(tuple(ranks)))
    return made


def test_row_across_attach_and_weight_shards(rank_of_two, groups_made):
    """On (data = 1, model = 4) ``attach`` puts the weights on this rank's
    first position of the row, which is the walk's lead, and makes the
    row's group once; ``weight_shards`` gives this rank's two model
    indices, each the slice of the whole weight; ``infer_batch`` (the
    server's call) points at ``infer_batch_multiprocess``."""
    from pyopenvino_tpu_torch.parallel.mesh import Walk, weight_shards

    mesh = build_mesh(MeshConfig(model=4))
    net = shard_compiled(compile_model(read_ir_model(*MNIST), device="cpu"), mesh,
                         tensor_parallel=True)
    assert groups_made == [(0, 1)] and mesh.row_group(0).ranks == (0, 1)
    walk = Walk(net, 0, batched=True)
    assert net.device == walk.lead == torch.device("cpu") and walk.group is mesh.row_group(0)
    assert [d for d in walk.tp if isinstance(d, Remote)] == [Remote(1 - rank_of_two, i)
                                                              for i in range(2)]
    shard_compiled(net, mesh, tensor_parallel=True)
    assert groups_made == [(0, 1)]  # the mesh keeps its groups
    with pytest.raises(ValueError, match="infer_batch_multiprocess"):
        net.infer_batch({IN: _blob(4, (1, 28, 28))})
    sharded = [k for k, spec in net._w_specs.items() if "model" in spec]
    assert sharded
    for key in sharded:
        parts = weight_shards(net, key)
        assert sorted(parts) == [2 * rank_of_two, 2 * rank_of_two + 1]
        axis = net._w_specs[key].index("model")
        size = net.weights[key].shape[axis] // 4
        for j, part in parts.items():
            assert torch.equal(part, net.weights[key].narrow(axis, j * size, size)), (key, j)


def test_row_across_owner_without_its_axis_raises(rank_of_two, groups_made):
    """SP on (data = 1, model = 2, spatial = 2): the row's spatial positions
    are all rank 0's, so rank 1 would hold no block of what the row
    gathers; refused on both ranks, before any group is made."""
    with pytest.raises(ValueError, match=r"processes \[1\] own none of its spatial positions"):
        shard_compiled(compile_model(read_ir_model(*MNIST), device="cpu"),
                       build_mesh(MeshConfig(data=1, model=2, spatial=2)),
                       spatial_parallel=True)
    assert groups_made == []


def test_remote_positions_get_no_weights(rank_of_two):
    """shard_compiled puts the weights on this process's first position;
    infer_batch on a mesh across processes points at
    infer_batch_multiprocess; compile_pipelined builds only this rank's
    stages."""
    net = shard_compiled(compile_model(read_ir_model(*MNIST), device="cpu"),
                         build_mesh(MeshConfig(data=2, model=2)), tensor_parallel=True)
    assert net.device == torch.device("cpu") and net._placed == {}
    assert all(v.device == torch.device("cpu") for v in net.weights.values())
    with pytest.raises(ValueError, match="infer_batch_multiprocess"):
        net.infer_batch({IN: _blob(4, (1, 28, 28))})
    pp = compile_pipelined(read_ir_model(*MNIST), build_pipeline_mesh(4))
    kinds = [isinstance(s, RemoteStage) for s in pp.stages]
    assert kinds == ([False, False, True, True] if rank_of_two == 0 else
                     [True, True, False, False])
    assert all(isinstance(s, CompiledNetwork) for s, remote in zip(pp.stages, kinds)
               if not remote)
    assert pp.input_names == [IN] and pp.output_names == ["prob"]


# -- __graft_entry__.py dryrun_multichip ------------------------------------------


@pytest.fixture(scope="module")
def mnist_rows():
    return _blob(32, (1, 28, 28))


@pytest.fixture(scope="module")
def jax_mnist(mnist_rows):
    return _jax_outputs(MNIST, mnist_rows)


def _close(got, want, rows, atol=DRYRUN_ATOL):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape[0] == rows and np.isfinite(got[k]).all(), k
        np.testing.assert_allclose(got[k], want[k][:rows], rtol=RTOL, atol=atol, err_msg=k)


@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("check", ["dp_tp", "pipeline", "spatial", "expert", "export"])
def test_dryrun_multichip(tmp_path, n, check, mnist_rows, jax_mnist):
    """The dryrun's five checks on ``n`` logical CPU devices, each against
    the JAX package's unsharded outputs."""
    cpus = ["cpu"] * n
    data, batch = n // 2, n  # TP over model = 2, 2 examples a data shard
    rows = mnist_rows[:batch]
    if check in ("dp_tp", "export"):
        net = shard_compiled(compile_model(read_ir_model(*MNIST), device="cpu"),
                             build_mesh(MeshConfig(data=data, model=2), cpus),
                             tensor_parallel=True)
        if check == "export":
            path = str(tmp_path / "mnist_sharded.ovpt")
            net.export(path, buckets=(batch,))
            net = import_compiled(path, device="cpu", devices=cpus)
            assert dict(net.mesh.shape) == {"data": data, "model": 2, "spatial": 1}
        _close(net.infer_batch({IN: rows}), jax_mnist, batch)
    elif check == "pipeline":
        pp = compile_pipelined(read_ir_model(*MNIST),
                               build_pipeline_mesh(4, data=n // 4, devices=cpus))
        _close(pp.infer_batch({IN: rows}), jax_mnist, batch)
    elif check == "spatial":
        axes = {8: (2, 1, 4)}.get(n, (n // 2, 1, 2))
        net = shard_compiled(compile_model(read_ir_model(*MNIST), device="cpu"),
                             build_mesh(MeshConfig(*axes), cpus), spatial_parallel=True)
        _close(net.infer_batch({IN: rows[:2 * axes[0]]}), jax_mnist, 2 * axes[0])
    else:
        paths = moe_mlp_paths()
        moe_rows = _blob(batch, (3, 32, 32), seed=1)
        net = shard_compiled(compile_model(read_ir_model(*paths), device="cpu"),
                             build_mesh(MeshConfig(data=data, model=2), cpus),
                             tensor_parallel=True)
        experts = [k for k, s in net._w_specs.items()
                   if net.weights[k].dim() == 3 and s[:1] == ("model",)]
        assert experts, "EP placed no expert-sharded weights"
        _close(net.infer_batch({"input": moe_rows}), _jax_outputs(paths, moe_rows), batch,
               atol=ATOL)


# -- the sharded export --------------------------------------------------------------


def _distinct_rows():
    rows = _blob(8, (1, 28, 28), seed=5)
    rows[1] = rows[1][:, :, ::-1]  # distinct from row 0
    return rows


@pytest.mark.parametrize("cfg, kw", [
    (MeshConfig(data=4, model=2), {"tensor_parallel": True}),
    (MeshConfig(data=2, spatial=4), {"spatial_parallel": True}),
    (MeshConfig(data=4, model=2), {"tensor_parallel": True, "quant": QuantMode.INT8_FULL}),
], ids=["dp4_tp2", "dp2_sp4", "dp4_tp2_int8full"])
def test_sharded_export_roundtrip(tmp_path, cfg, kw):
    """Export a network on a mesh, import it onto as many CPU devices: the
    same mesh and weight specs, and the exporter's bits at B = 1 and on
    eight distinct rows (repeated rows would hide a shard's indexing)."""
    kw = dict(kw)
    quant = kw.pop("quant", QuantMode.NONE)
    samples = ([{IN: x[None]} for x in _blob(4, (1, 28, 28), seed=3)]
               if quant == QuantMode.INT8_FULL else None)
    net = compile_model(read_ir_model(*MNIST), Config(quant=quant), device="cpu",
                        calibration_samples=samples)
    shard_compiled(net, build_mesh(cfg, "cpu"), **kw)
    rows = _distinct_rows()
    want_b1, want = net.infer({IN: rows[:1]}), net.infer_batch({IN: rows})
    path = str(tmp_path / "sharded.ovpt")
    net.export(path, buckets=(8,))
    imp = import_compiled(path, device="cpu", devices=["cpu"] * 8)
    assert dict(imp.mesh.shape) == dict(net.mesh.shape)
    assert imp.network._w_specs == net._w_specs
    assert imp.network._spatial_axis == net._spatial_axis
    for got, ref in ((imp.infer({IN: rows[:1]}), want_b1), (imp.infer_batch({IN: rows}), want)):
        assert sorted(got) == sorted(ref)
        for k in ref:
            assert got[k].dtype == ref[k].dtype and np.array_equal(got[k], ref[k]), k


def test_sharded_artifact_meta_matches_jax(tmp_path):
    """The port's meta.json holds the JAX sharded artifact's mesh, weight
    specs and batch spec, key for key."""
    cfg = MeshConfig(data=4, model=2)
    port = shard_compiled(compile_model(read_ir_model(*MNIST), device="cpu"),
                          build_mesh(cfg, "cpu"), tensor_parallel=True)
    jax = jax_mesh.shard_compiled(
        jax_compile(jax_read(*MNIST), JaxConfig(backend=JaxBackend.XLA)),
        jax_mesh.build_mesh(jax_mesh.MeshConfig(data=4, model=2)), tensor_parallel=True)
    metas = []
    for net, name in ((port, "p.ovpt"), (jax, "j.ovtpu")):
        net.export(str(tmp_path / name), buckets=(8,))
        with zipfile.ZipFile(tmp_path / name) as zf:
            metas.append(json.loads(zf.read("meta.json")))
    for key in ("mesh", "w_pspecs", "batch_pspec"):
        assert metas[0][key] == metas[1][key], key
    assert any("model" in spec for spec in metas[0]["w_pspecs"].values())


def test_stateful_sharded_export_refused(tmp_path):
    from pyopenvino_tpu_torch.ir.builder import GraphBuilder

    net = compile_model(ema_model(GraphBuilder), device="cpu")
    shard_compiled(net, build_mesh(MeshConfig(data=2), "cpu"))
    with pytest.raises(NotImplementedError, match="stateful \\+ sharded"):
        net.export(str(tmp_path / "x.ovpt"))


def test_import_onto_too_few_devices_raises(tmp_path):
    net = shard_compiled(compile_model(read_ir_model(*MNIST), device="cpu"),
                         build_mesh(MeshConfig(data=4, model=2), "cpu"), tensor_parallel=True)
    path = str(tmp_path / "x.ovpt")
    net.export(path)
    with pytest.raises(ValueError, match=r"sharded artifact needs 8 devices \(mesh "
                                         r"\['data', 'model', 'spatial'\]=\[4, 2, 1\]\), have 4"):
        import_compiled(path, device="cpu", devices=["cpu"] * 4)
