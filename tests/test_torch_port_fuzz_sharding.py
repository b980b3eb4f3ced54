"""Sharding fuzzer on the port: random graph × mesh, against the JAX
package's sharded network and the port's unsharded one; and the server over
a sharded network.

Counterpart of ``tests/test_fuzz_sharding.py``: its six ``MESH_CASES`` (DP,
DP×TP, TP, DP×SP, SP, DP×TP) over its 12 fixed seeds.  Each seed's graph is
``tests/test_fuzz_differential.py::_random_graph``, written to IR by the JAX
package's writer and read by both packages, and runs batched on 8 DISTINCT
rows (a repeated-row batch cannot see rows mixed across shards).  The port's
sharded network is held against its unsharded one and against the JAX
package's sharded network under the same ``MeshConfig``, at the JAX test's
rtol 1e-4 / atol 1e-5.  Three seeds past the 12 (16, 46, 116) once baked a
batch that crossed examples (``passes/shape_infer.py::_check_batch_axes``
refuses such a bake now); they are held against the JAX package's answers.
So is ROADMAP §3's fault-12 graph, where a Transpose moved the batch off axis
0 and a SoftMax then read across it, graphs for the refusal rules of
``_check_batch_axes`` (a softmax, a Concat, a CumSum and a MatMul across the
batch, a batch merged into another axis) and a Transpose that keeps the
batch on axis 0 (still baked), each built by both packages' ``GraphBuilder``
and held within 1e-6.

Then the counterpart of ``tests/test_serving.py::test_served_sharded_network``
on ``assets/trained/mnist_bn``: a DP network behind the port's server rounds
its buckets up to multiples of the mesh's data axis, as the JAX package's
does, answers as direct ``infer`` does (a single request padded to the
rounded bucket of 4), and refuses ``resolutions``."""

import dataclasses

import numpy as np
import pytest

from pyopenvino_tpu.config import Backend as JaxBackend
from pyopenvino_tpu.config import Config as JaxConfig
from pyopenvino_tpu.ir.builder import GraphBuilder as JaxBuilder
from pyopenvino_tpu.ir import read_ir_model as jax_read
from pyopenvino_tpu.ir.writer import write_ir_model
from pyopenvino_tpu.parallel import mesh as jax_mesh
from pyopenvino_tpu.runtime.compiler import compile_model as jax_compile
from pyopenvino_tpu.serving import InferenceServer as JaxServer

from pyopenvino_tpu_torch.config import Config
from pyopenvino_tpu_torch.ir import read_ir_model
from pyopenvino_tpu_torch.ir.builder import GraphBuilder
from pyopenvino_tpu_torch.models import op_graphs
from pyopenvino_tpu_torch.parallel import MeshConfig, build_mesh, shard_compiled
from pyopenvino_tpu_torch.passes.shape_infer import bake_batch
from pyopenvino_tpu_torch.runtime.compiler import compile_model
from pyopenvino_tpu_torch.serving import InferenceServer
from test_fuzz_differential import _random_graph
from test_fuzz_sharding import MESH_CASES
import test_torch_port_threads  # noqa: F401  (this worker's torch threads)

RTOL, ATOL = 1e-4, 1e-5
MNIST = ("assets/trained/mnist_bn.xml", "assets/trained/mnist_bn.bin")
IN = "conv2d_input"


def _port_mesh(cfg) -> MeshConfig:
    return MeshConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("seed", range(12))
def test_random_graph_random_mesh_parity(seed, tmp_path):
    model, in_name, in_shape = _random_graph(seed)
    xml = str(tmp_path / f"fuzz_{seed}.xml")
    write_ir_model(model, xml)
    paths = (xml, xml[:-4] + ".bin")
    rng = np.random.default_rng(seed + 5000)
    blob = rng.normal(0, 1, (8,) + in_shape).astype(np.float32)  # distinct rows

    name, axes, kw = MESH_CASES[seed % len(MESH_CASES)]
    ref = compile_model(read_ir_model(*paths), Config(), device="cpu").infer_batch(
        {in_name: blob})
    net = compile_model(read_ir_model(*paths), Config(), device="cpu")
    shard_compiled(net, build_mesh(_port_mesh(axes), "cpu"), **kw)
    got = net.infer_batch({in_name: blob})
    jax = jax_compile(jax_read(*paths), JaxConfig(backend=JaxBackend.XLA))
    jax_mesh.shard_compiled(jax, jax_mesh.build_mesh(axes), **kw)
    want = jax.infer_batch({in_name: blob})

    assert set(ref) == set(got) == set(want)
    for k in ref:
        assert got[k].shape == ref[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], ref[k], rtol=RTOL, atol=ATOL,
                                   err_msg=f"seed={seed} mesh={name} output {k!r}: unsharded")
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=f"seed={seed} mesh={name} output {k!r}: JAX")


@pytest.mark.parametrize("seed", [16, 46, 116])
def test_baked_batch_keeps_examples_apart(seed, tmp_path):
    """Seeds whose TopK gate reshapes (B, 1) values to (B,) and Gathers
    index 0: baked at B, every example would read example 0's k-th value.
    The bake is refused (one run an example, what the JAX package's vmap
    computes), unsharded and on a DP2 mesh alike."""
    model, in_name, in_shape = _random_graph(seed)
    xml = str(tmp_path / f"fuzz_{seed}.xml")
    write_ir_model(model, xml)
    paths = (xml, xml[:-4] + ".bin")
    blob = np.random.default_rng(seed + 5000).normal(0, 1, (8,) + in_shape).astype(np.float32)
    want = jax_compile(jax_read(*paths), JaxConfig(backend=JaxBackend.XLA)).infer_batch(
        {in_name: blob})
    net = compile_model(read_ir_model(*paths), Config(), device="cpu")
    assert net._batched_plan(8) is None and net._batched_plan(1) is not None
    for got in (net.infer_batch({in_name: blob}),
                shard_compiled(net, build_mesh(MeshConfig(data=2), "cpu")).infer_batch(
                    {in_name: blob})):
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL, err_msg=k)


def _fault12(b):
    """ROADMAP §3's fault 12: the batch moved to axis 1, merged into axis 1
    by the Reshape, then read across by the SoftMax."""
    x = b.parameter("x", (1, 4, 3))
    y = b.softmax(b.reshape(b.transpose(x, (1, 0, 2)), (4, -1)), axis=1)
    b.result(b.reshape(b.transpose(y, (1, 0)), (-1, 12)), "out")


def _softmax_on_batch(b):
    x = b.parameter("x", (1, 6))
    b.result(b.softmax(b.relu(x), axis=0), "out")


def _concat_on_batch(b):
    x = b.parameter("x", (1, 6))
    b.result(b.concat([x, b.relu(x)], axis=0), "out")


def _cumsum_on_batch(b):
    x = b.parameter("x", (1, 6))
    b.result(b._add_node("CumSum", [x, b.const(np.asarray(0, np.int64))], {}), "out")


def _matmul_contracts_batch(b):
    x = b.parameter("x", (1, 6))
    b.result(b.matmul(x, b.relu(x), transpose_a=True), "out")  # (6, 1) @ (1, 6)


def _batch_merged(b):
    x = b.parameter("x", (1, 4, 3))
    y = b.softmax(b.reshape(x, (4, -1)), axis=1)  # (B, 4, 3) → (4, 3B)
    b.result(b.reshape(y, (1, 12)), "out")


def _transpose_keeps_batch(b):
    x = b.parameter("x", (1, 4, 3))
    b.result(b.softmax(b.transpose(x, (0, 2, 1)), axis=2), "out")


BATCH_CASES = {
    "fault12": (_fault12, "merges the batch"),
    "softmax_on_batch": (_softmax_on_batch, "reads across the batch"),
    "concat_on_batch": (_concat_on_batch, "reads across the batch"),
    "cumsum_on_batch": (_cumsum_on_batch, "reads across the batch"),
    "matmul_contracts_batch": (_matmul_contracts_batch, "reads across the batch"),
    "batch_merged": (_batch_merged, "merges the batch"),
    "transpose_keeps_batch": (_transpose_keeps_batch, None),
}


@pytest.mark.parametrize("case", sorted(BATCH_CASES))
def test_bake_refuses_mixing_examples(case):
    """Each graph at B = 4 of seeded normals: the port's infer_batch equals
    its own infer one example at a time and the JAX package's infer_batch
    (its vmap) within 1e-6; the bake is refused with the rule's reason, or,
    where the batch stays on axis 0 and no op reads across it, kept."""
    build, reason = BATCH_CASES[case]
    port_b, jax_b = GraphBuilder(case), JaxBuilder(case)
    build(port_b)
    build(jax_b)
    model = port_b.build()
    blob = np.random.default_rng(0).normal(0, 1, (4,) + model.parameters[0].outputs[0].shape[1:]
                                           ).astype(np.float32)
    net = compile_model(model, Config(), device="cpu")
    if reason is None:
        bake_batch(model, 4)
        assert net._batched_plan(4) is not None
    else:
        with pytest.raises(ValueError, match=reason):
            bake_batch(model, 4)
        assert net._batched_plan(4) is None and net._batched_plan(1) is not None
    got = net.infer_batch({"x": blob})["out"]
    each = [net.infer({"x": blob[i:i + 1]})["out"] for i in range(4)]
    # the declared unit batch dropped, as infer_batch lays out its outputs
    each = np.concatenate(each) if each[0].shape[:1] == (1,) else np.stack(each)
    want = jax_compile(jax_b.build(), JaxConfig(backend=JaxBackend.XLA)).infer_batch(
        {"x": blob})["out"]
    assert got.shape == want.shape == each.shape
    np.testing.assert_allclose(got, each, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_layout_recipe_batch_keeps_examples_apart():
    """models/op_graphs.py's layout recipe: its SpaceToBatch merges the batch
    with the block on axis 0, so the bake is refused; one example at a time,
    every output (space_to_batch (B, 4, C, h, w) among them, which the bake
    interleaved as (4B, C, h, w)) equals the JAX package's infer_batch at
    B = 3, within rtol 1e-4 / atol 1e-5."""
    model, rec = op_graphs.build(GraphBuilder, "layout", width=16)
    rows = rec.inputs(np.random.default_rng(1), 3)
    net = compile_model(model, Config(), device="cpu")
    with pytest.raises(ValueError, match="SpaceToBatch .* merges the batch"):
        bake_batch(model, 3)
    got = net.infer_batch(rows)
    want = jax_compile(op_graphs.build(JaxBuilder, "layout", width=16)[0],
                       JaxConfig(backend=JaxBackend.XLA)).infer_batch(rows)
    assert sorted(got) == sorted(want)
    assert got["space_to_batch"].shape == (3, 4, 16, 3, 3)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL, err_msg=k)


def test_served_sharded_network():
    compiled = compile_model(read_ir_model(*MNIST), Config(), device="cpu")
    shard_compiled(compiled, build_mesh(MeshConfig(data=4, model=1), "cpu"))
    server = InferenceServer(compiled, buckets=(1, 2, 4, 8), max_delay_ms=5.0)
    assert server.buckets == (4, 8)  # rounded to data-axis multiples
    jax = jax_compile(jax_read(*MNIST), JaxConfig(backend=JaxBackend.XLA))
    jax_mesh.shard_compiled(jax, jax_mesh.build_mesh(jax_mesh.MeshConfig(data=4, model=1)))
    assert JaxServer(jax, buckets=(1, 2, 4, 8)).buckets == server.buckets

    rng = np.random.default_rng(0)
    blobs = [rng.uniform(0, 255, (1, 1, 28, 28)).astype(np.float32) for _ in range(6)]
    ref = [compiled({IN: b}) for b in blobs]
    with server:
        futs = [server.submit({IN: b}) for b in blobs]
        outs = [f.result(timeout=60) for f in futs]
    for got, want in zip(outs, ref):
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL)
    assert server.stats.requests == 6
    # a single request (bucket 1 → padded to 4) also works
    with server.start():
        one = server.infer({IN: blobs[0]})
    for k in ref[0]:
        np.testing.assert_allclose(one[k], ref[0][k], rtol=RTOL, atol=ATOL)
    assert server.stats.padded_slots >= 3


def test_sharded_network_refuses_resolutions():
    compiled = compile_model(read_ir_model(*MNIST), Config(), device="cpu")
    shard_compiled(compiled, build_mesh(MeshConfig(data=2), "cpu"))
    with pytest.raises(NotImplementedError, match="sharded network"):
        InferenceServer(compiled, resolutions=[(32, 32)])
    jax = jax_compile(jax_read(*MNIST), JaxConfig(backend=JaxBackend.XLA))
    jax_mesh.shard_compiled(jax, jax_mesh.build_mesh(jax_mesh.MeshConfig(data=2)))
    with pytest.raises(NotImplementedError, match="sharded network"):
        JaxServer(jax, resolutions=[(32, 32)])
