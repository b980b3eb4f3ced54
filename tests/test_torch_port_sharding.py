"""The port's device mesh (``pyopenvino_tpu_torch/parallel/mesh.py``)
against the JAX package's (``pyopenvino_tpu/parallel/mesh.py``) on the CPU.

Counterparts of every case of ``tests/test_sharding.py``,
``tests/test_review_fixes.py::{test_tp_shards_matmul_weights,
test_config_mesh_knobs_build_mesh}`` and
``tests/test_round2_fixes.py::test_weight_pspec_skips_folded_keys``, on
in-repo IRs: ``assets/trained/mnist_bn`` where the JAX tests read the
reference's mnist, ``assets/trained/googlenet_shapes`` (GoogLeNet-v1's graph
narrowed 4×) where they read googlenet-v1.  Each case runs the JAX
package's sharded network, under the same ``MeshConfig`` on its 8 forced
host devices, and the port's, on the CPU as 8 logical devices, on the same
seeded rows, and holds:
  * the port's sharded network against its unsharded one: float at the JAX
    tests' rtol 1e-4 / atol 1e-5, INT8-FULL bit for bit;
  * the port's sharded network against the JAX package's: mnist_bn at its
    TORCH-vs-XLA limit, rtol 1e-4 / atol 1e-5
    (``test_torch_port_fold_scale.py``), googlenet_shapes at the families'
    1e-3 / 1e-5 (``test_torch_port_googlenet.py``), INT8-FULL with XLA's
    fused multiply-add epilogue patched in (``xla_fma_epilogue``) at rtol
    1e-4 / atol 1e-5.
The weight specs equal the JAX package's key for key, and each model
index's slice equals, element for element, the JAX package's
``addressable_shards`` of that key on that index's device.  The halo test
counts the exchanges by wrapping ``mesh.halo_rows``; the JAX test asserts
that "collective-permute" appears in its HLO."""

import dataclasses

import numpy as np
import pytest
import torch

from pyopenvino_tpu.config import Backend as JaxBackend
from pyopenvino_tpu.config import Config as JaxConfig
from pyopenvino_tpu.config import QuantMode as JaxQuantMode
from pyopenvino_tpu.ir import read_ir_model as jax_read
from pyopenvino_tpu.parallel import mesh as jax_mesh
from pyopenvino_tpu.runtime.compiler import compile_model as jax_compile

from pyopenvino_tpu_torch import IECore
from pyopenvino_tpu_torch.config import Config, QuantMode
from pyopenvino_tpu_torch.ir import read_ir_model
from pyopenvino_tpu_torch.parallel import MeshConfig, build_mesh, shard_compiled
from pyopenvino_tpu_torch.parallel import mesh as port_mesh
from pyopenvino_tpu_torch.runtime.compiler import compile_model
from test_torch_port_int8full import xla_fma_epilogue
import test_torch_port_threads  # noqa: F401  (this worker's torch threads)

# the port's sharded network against its unsharded one, and mnist_bn's
# TORCH-vs-XLA limit (float32 sums in another order)
RTOL, ATOL = 1e-4, 1e-5
# googlenet_shapes' TORCH-vs-XLA limit (test_torch_port_googlenet.py)
FAMILY_RTOL, FAMILY_ATOL = 1e-3, 1e-5
MNIST = ("assets/trained/mnist_bn.xml", "assets/trained/mnist_bn.bin")
GOOGLENET = ("assets/trained/googlenet_shapes.xml", "assets/trained/googlenet_shapes.bin")
IN = "conv2d_input"


def _rows(n, shape, seed):
    return np.random.default_rng(seed).uniform(0, 255, (n, *shape)).astype(np.float32)


def _port(paths, quant=QuantMode.NONE, samples=None, **config):
    return compile_model(read_ir_model(*paths), Config(quant=quant, **config), device="cpu",
                         calibration_samples=samples)


def _jax(paths, quant=QuantMode.NONE, samples=None):
    return jax_compile(jax_read(*paths), JaxConfig(backend=JaxBackend.XLA,
                                                   quant=JaxQuantMode(quant.value)),
                       calibration_samples=samples)


def _jax_mesh(cfg: MeshConfig):
    return jax_mesh.build_mesh(jax_mesh.MeshConfig(**dataclasses.asdict(cfg)))


def _sharded_pair(paths, cfg, quant=QuantMode.NONE, samples=None, **kw):
    """(port network, JAX network), each on ``cfg``'s mesh."""
    port = shard_compiled(_port(paths, quant, samples), build_mesh(cfg, "cpu"), **kw)
    jax = jax_mesh.shard_compiled(_jax(paths, quant, samples), _jax_mesh(cfg), **kw)
    return port, jax


def _close(got, want, rtol=RTOL, atol=ATOL):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol)


def _equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def _sharded_keys(net):
    return {k for k, spec in net._w_specs.items() if "model" in spec}


# -- tests/test_sharding.py ---------------------------------------------------------


def test_mesh_build():
    for cfg in (MeshConfig(data=4, model=2), MeshConfig(data=2, spatial=4)):
        mesh = build_mesh(cfg, "cpu")
        assert mesh.shape == dict(_jax_mesh(cfg).shape)
        assert mesh.axis_names == ("data", "model", "spatial")
        assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    assert build_mesh(MeshConfig(data=4, model=2), "cpu").shape == {
        "data": 4, "model": 2, "spatial": 1}
    with pytest.raises(ValueError, match="needs 16 devices, have 8"):
        build_mesh(MeshConfig(data=4, model=4), "cpu")


def test_default_devices_one_card(monkeypatch):
    """On a machine with one card, the default devices are that card, and
    any mesh of more than one device raises: no mesh shrinks to the
    devices there are.  Logical shards on the card are named explicitly."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert build_mesh(MeshConfig()).devices.flat[0] == torch.device("cuda", 0)
    for cfg in (MeshConfig(data=2), MeshConfig(model=2), MeshConfig(spatial=2),
                MeshConfig(data=2, model=2)):
        with pytest.raises(ValueError, match="have 1"):
            build_mesh(cfg)
    mesh = build_mesh(MeshConfig(data=2, spatial=2), [torch.device("cuda:0")] * 4)
    assert mesh.shape == {"data": 2, "model": 1, "spatial": 2}
    assert {str(d) for d in mesh.devices.flat} == {"cuda:0"}


def test_data_parallel_batch():
    image = _rows(1, (1, 1, 28, 28), 0)[0]
    plain = _port(MNIST)
    ref = plain.infer({IN: image})
    port, jax = _sharded_pair(MNIST, MeshConfig(data=8))
    batch = np.repeat(image, 8, axis=0)
    out = port.infer_batch({IN: batch})
    name = next(iter(ref))
    assert out[name].shape[0] == 8
    for b in range(8):
        np.testing.assert_allclose(out[name][b], ref[name][0], rtol=RTOL, atol=1e-6)
    _close(out, jax.infer_batch({IN: batch}))
    # logical shards on one device share the network's own weights
    assert port._placed == {} and port._parts == {}


def test_tensor_parallel_weights():
    image = _rows(1, (1, 1, 28, 28), 1)[0]
    ref = _port(MNIST).infer({IN: image})
    port, jax = _sharded_pair(MNIST, MeshConfig(data=1, model=2), tensor_parallel=True)
    assert _sharded_keys(port), "tensor_parallel placed no sharded weights"
    out = port.infer({IN: image})
    _close(out, ref, atol=1e-6)
    _close(out, jax.infer({IN: image}))


def test_dp_x_tp_combined():
    image = _rows(1, (1, 1, 28, 28), 2)[0]
    ref = _port(MNIST).infer({IN: image})
    port, jax = _sharded_pair(MNIST, MeshConfig(data=4, model=2), tensor_parallel=True)
    batch = np.repeat(image, 4, axis=0)
    out = port.infer_batch({IN: batch})
    name = next(iter(ref))
    for b in range(4):
        np.testing.assert_allclose(out[name][b], ref[name][0], rtol=RTOL, atol=1e-6)
    _close(out, jax.infer_batch({IN: batch}))


def test_flagship_dp_x_tp_int8w():
    """googlenet_shapes on (data=4, model=2), INT8 weight-only: the
    per-output-channel weights and scales shard together (concat joins,
    1×1/3×3/5×5 branches), on four distinct rows."""
    rows = _rows(4, (3, 224, 224), 0)
    ref = _port(GOOGLENET, QuantMode.INT8_WEIGHT).infer_batch({"data": rows})
    port, jax = _sharded_pair(GOOGLENET, MeshConfig(data=4, model=2), QuantMode.INT8_WEIGHT,
                              tensor_parallel=True)
    assert any(k.endswith(".scale") for k in _sharded_keys(port))
    out = port.infer_batch({"data": rows})
    _close(out, ref, atol=1e-6)
    _close(out, jax.infer_batch({"data": rows}), FAMILY_RTOL, FAMILY_ATOL)


def test_spatial_parallel_halo_exchange(monkeypatch):
    """SP on (data=2, spatial=4): googlenet_shapes per example, and the
    blocks really exchanged halo rows (the JAX test's collective-permute in
    the HLO)."""
    rows = _rows(4, (3, 224, 224), 1)
    ref = _port(GOOGLENET).infer_batch({"data": rows})
    port, jax = _sharded_pair(GOOGLENET, MeshConfig(data=2, spatial=4), spatial_parallel=True)
    exchanges = []
    real = port_mesh.halo_rows

    def counted(x, a, b, device):
        exchanges.append((a, b))
        return real(x, a, b, device)

    monkeypatch.setattr(port_mesh, "halo_rows", counted)
    out = port.infer_batch({"data": rows})
    assert len(exchanges) >= 1, "no halo exchange"
    _close(out, ref, atol=1e-6)
    _close(out, jax.infer_batch({"data": rows}), FAMILY_RTOL, FAMILY_ATOL)


def test_spatial_x_data_combined_distinct_rows():
    rows = _rows(4, (1, 1, 28, 28), 5)
    ref = _port(MNIST).infer_batch({IN: rows})
    port, jax = _sharded_pair(MNIST, MeshConfig(data=2, model=1, spatial=2),
                              spatial_parallel=True)
    out = port.infer_batch({IN: rows})
    _close(out, ref)
    _close(out, jax.infer_batch({IN: rows}))


def test_spatial_x_tensor_rejected():
    cfg = MeshConfig(data=2, model=2, spatial=2)
    with pytest.raises(ValueError, match="cannot be combined"):
        shard_compiled(_port(MNIST), build_mesh(cfg, "cpu"), tensor_parallel=True,
                       spatial_parallel=True)
    with pytest.raises(ValueError, match="cannot be combined"):
        jax_mesh.shard_compiled(_jax(MNIST), _jax_mesh(cfg), tensor_parallel=True,
                                spatial_parallel=True)


def test_spatial_with_int8_full(monkeypatch):
    """SP × INT8-FULL: the int8-stored edges split their rows too; bit-equal
    to the port's unsharded network, and with XLA's epilogue rounding
    patched in, to the JAX package's sharded network."""
    rows = _rows(4, (1, 1, 28, 28), 9)
    rng = np.random.default_rng(9)
    cal = [{IN: rng.uniform(0, 255, (1, 1, 28, 28)).astype(np.float32)} for _ in range(3)]
    ref = _port(MNIST, QuantMode.INT8_FULL, cal).infer_batch({IN: rows})
    port, jax = _sharded_pair(MNIST, MeshConfig(data=2, spatial=2), QuantMode.INT8_FULL, cal,
                              spatial_parallel=True)
    assert port._int8_edges
    _equal(port.infer_batch({IN: rows}), ref)
    xla_fma_epilogue(monkeypatch)
    _close(port.infer_batch({IN: rows}), jax.infer_batch({IN: rows}))


def test_config_declared_spatial_mesh():
    rows = _rows(4, (1, 1, 28, 28), 10)
    ref = _port(MNIST).infer_batch({IN: rows})
    net = _port(MNIST, mesh_data=2, mesh_spatial=2)
    assert net._spatial_axis == "spatial"
    assert net.mesh.shape == {"data": 2, "model": 1, "spatial": 2}
    jax = jax_compile(jax_read(*MNIST), JaxConfig(backend=JaxBackend.XLA, mesh_data=2,
                                                  mesh_spatial=2))
    assert jax._spatial_axis == "spatial"
    out = net.infer_batch({IN: rows})
    _close(out, ref)
    _close(out, jax.infer_batch({IN: rows}))


def test_api_level_shard_facade():
    """ExecutableNetwork.shard: DP×TP from axis sizes, data taking the rest
    of the CPU's 8 devices, as in the JAX package."""
    from pyopenvino_tpu.api import IECore as JaxIECore

    rows = _rows(8, (1, 28, 28), 0)
    ie = IECore()
    plain = ie.load_network(ie.read_network(*MNIST), "CPU")
    want = plain.infer_batch({IN: rows})
    exe = ie.load_network(ie.read_network(*MNIST), "CPU")
    assert exe.shard(model=2, tensor_parallel=True) is exe
    assert exe.compiled().mesh.shape == {"data": 4, "model": 2, "spatial": 1}
    got = exe.infer_batch({IN: rows})
    _close(got, want)
    jie = JaxIECore()
    jexe = jie.load_network(jie.read_network(*MNIST), "TPU")
    jexe.shard(model=2, tensor_parallel=True)
    assert dict(jexe._get_compiled().mesh.shape) == exe.compiled().mesh.shape
    _close(got, jexe.infer_batch({IN: rows}))


def test_batch_not_divisible_by_data_axis():
    port = shard_compiled(_port(MNIST), build_mesh(MeshConfig(data=4), "cpu"))
    with pytest.raises(ValueError, match="4 data blocks"):
        port.infer_batch({IN: _rows(6, (1, 28, 28), 0)})


# -- tests/test_review_fixes.py, tests/test_round2_fixes.py ----------------------------


def test_tp_shards_matmul_weights():
    """tensor_parallel shards the FC (MatMul) weights, not just the convs."""
    image = _rows(1, (1, 1, 28, 28), 3)[0]
    ref = _port(MNIST).infer({IN: image})
    port, jax = _sharded_pair(MNIST, MeshConfig(data=1, model=2), tensor_parallel=True)
    matmul_keys = {str(port.model.in_edges[n.id][1][0]) for n in port.model.find_by_type("MatMul")}
    assert matmul_keys & _sharded_keys(port), "no MatMul weight got sharded"
    out = port({IN: image})
    k = next(iter(out))
    assert list(np.argsort(out[k][0])[::-1][:3]) == list(np.argsort(ref[k][0])[::-1][:3])
    _close(out, ref, atol=1e-6)
    _close(out, jax({IN: image}))


def test_config_mesh_knobs_build_mesh():
    """Config(mesh_data=2) shards (no silent no-op)."""
    image = _rows(1, (1, 1, 28, 28), 4)[0]
    ref = _port(MNIST).infer({IN: image})
    c = _port(MNIST, mesh_data=2)
    assert c.mesh is not None and c.mesh.shape["data"] == 2
    out = c.infer_batch({IN: np.repeat(image, 4, axis=0)})
    k = next(iter(out))
    for i in range(4):
        assert list(np.argsort(out[k][i])[::-1][:3]) == list(np.argsort(ref[k][0])[::-1][:3])
        np.testing.assert_allclose(out[k][i], ref[k][0], rtol=RTOL, atol=1e-6)


def test_weight_pspec_skips_folded_keys():
    from pyopenvino_tpu.parallel.mesh import _weight_pspec as jax_weight_pspec

    spec = port_mesh._weight_pspec(read_ir_model(*MNIST), "folded.42.0", np.zeros((8, 128)), 2)
    assert spec == port_mesh.P() == ()
    assert tuple(jax_weight_pspec(jax_read(*MNIST), "folded.42.0", np.zeros((8, 128)), 2)) == ()


def test_tensor_parallel_with_synthetic_folded_key():
    port = _port(MNIST)
    port.weights["folded.9999.0"] = torch.zeros((4, 4))
    shard_compiled(port, build_mesh(MeshConfig(data=4, model=2), "cpu"), tensor_parallel=True)
    assert port._w_specs["folded.9999.0"] == ()


# -- the weights carried across -------------------------------------------------------


@pytest.mark.parametrize("paths,quant,cfg", [
    (MNIST, QuantMode.NONE, MeshConfig(data=4, model=2)),
    (MNIST, QuantMode.INT8_WEIGHT, MeshConfig(data=2, model=4)),
    (GOOGLENET, QuantMode.INT8_WEIGHT, MeshConfig(data=4, model=2)),
], ids=["mnist_bn-fp32-dp4tp2", "mnist_bn-int8w-dp2tp4", "googlenet_shapes-int8w-dp4tp2"])
def test_weight_shards_equal_jax(paths, quant, cfg):
    """Every weight key has the JAX package's spec, and each model index's
    part of it is, element for element, the data of the JAX package's
    ``addressable_shards`` on that index's devices (every data row)."""
    port, jax = _sharded_pair(paths, cfg, quant, tensor_parallel=True)
    assert sorted(port.weights) == sorted(jax.weights)
    index = {dev: tuple(int(i) for i in np.argwhere(jax.mesh.devices == dev)[0])
             for dev in jax.mesh.devices.flat}
    for key, arr in jax.weights.items():
        assert tuple(arr.sharding.spec) == tuple(port._w_specs[key]) or (
            not any(arr.sharding.spec) and not any(port._w_specs[key])), key
        parts = port_mesh.weight_shards(port, key)
        for shard in arr.addressable_shards:
            _, j, _ = index[shard.device]
            np.testing.assert_array_equal(np.asarray(shard.data), parts[j].numpy(),
                                          err_msg=f"{key} model index {j}")
    assert _sharded_keys(port)


# -- the port's own entry points -------------------------------------------------------


def test_compile_model_mesh_argument():
    """compile_model(mesh=): infer_batch runs data parallel over it, and a
    mesh the Config declares is not built on top of it."""
    rows = _rows(4, (1, 28, 28), 11)
    ref = _port(MNIST).infer_batch({IN: rows})
    mesh = build_mesh(MeshConfig(data=4), "cpu")
    net = compile_model(read_ir_model(*MNIST), Config(mesh_data=2), device="cpu", mesh=mesh)
    assert net.mesh is mesh and net._spatial_axis is None and not _sharded_keys(net)
    _close(net.infer_batch({IN: rows}), ref)


def test_cache_dir_with_declared_mesh(tmp_path):
    """A Config that declares a mesh compiles through CACHE_DIR: the
    artifact holds the unsharded network (the cache key leaves the mesh
    out), and the network is sharded after the compile and after the
    import."""
    from pyopenvino_tpu_torch.runtime import cache

    rows = _rows(4, (1, 28, 28), 12)
    ref = _port(MNIST).infer_batch({IN: rows})
    cache.enable_model_cache(str(tmp_path))
    try:
        nets = []
        for _ in range(2):
            ie = IECore()
            exe = ie.load_network(ie.read_network(*MNIST), "CPU",
                                  config=Config(mesh_data=2, mesh_model=2))
            nets.append(exe.compiled())
        assert len(cache.cache_entries(str(tmp_path))) == 1
    finally:
        cache.disable_model_cache()
    for net in nets:
        assert net.mesh.shape == {"data": 2, "model": 2, "spatial": 1} and _sharded_keys(net)
        assert net.config.mesh_model == 2
        _close(net.infer_batch({IN: rows}), ref)
