"""The families' sharded cases on the port's device mesh
(``pyopenvino_tpu_torch/parallel/mesh.py``) against the JAX package's, on
the CPU.

Counterparts of the models' ``test_sharded_dp*`` cases (ResNet-18,
MobileNet-v2, EfficientNet-B0, ShuffleNet-v2, SqueezeNet-1.1, U-Net,
ViT-tiny on (data=4, model=2) with TP, EfficientNet-B0 on data=4) and of
``tests/test_moe.py``'s EP cases (MoE-MLP on (data=2, model=4), and INT8
weight-only on (data=1, model=2)), on the port's shipped IRs (SqueezeNet:
``tools/gen_squeezenet.py`` written by the JAX package's writer, as
``test_torch_port_squeezenet.py`` does), on distinct seeded rows where the
JAX tests repeat one image.  Each case holds the port's sharded network
against its unsharded one at the JAX tests' rtol 1e-4 / atol 1e-5, and
against the JAX package's sharded network under the same ``MeshConfig`` at
the families' TORCH-vs-XLA limit, rtol 1e-3 / atol 1e-5
(``tests/torch_port_families.py``).  Then ResNet-18 INT8-FULL on KERNELS
(the kernels' plain versions on the CPU), its 7-row last stage split over 2
and 4 row blocks (SP4 and DP2×SP2) and its channels over TP2, bit for bit
against the unsharded network."""

import dataclasses

import numpy as np
import pytest

from pyopenvino_tpu.config import Backend as JaxBackend
from pyopenvino_tpu.config import Config as JaxConfig
from pyopenvino_tpu.config import QuantMode as JaxQuantMode
from pyopenvino_tpu.ir import read_ir_model as jax_read
from pyopenvino_tpu.parallel import mesh as jax_mesh
from pyopenvino_tpu.runtime.compiler import compile_model as jax_compile

from pyopenvino_tpu_torch.config import Backend, Config, QuantMode
from pyopenvino_tpu_torch.ir import read_ir_model
from pyopenvino_tpu_torch.models import (
    efficientnet_b0, moe_mlp, shufflenet_v2, synth, unet, vit_tiny,
)
from pyopenvino_tpu_torch.parallel import MeshConfig, build_mesh, shard_compiled
from pyopenvino_tpu_torch.runtime.compiler import CompiledNetwork, compile_model
import test_torch_port_threads  # noqa: F401  (this worker's torch threads)

RTOL, ATOL = 1e-4, 1e-5  # the port's sharded network against its unsharded one
FAMILY_RTOL, FAMILY_ATOL = 1e-3, 1e-5  # against the JAX package (families' limit)
DP4_TP2 = (MeshConfig(data=4, model=2), {"tensor_parallel": True})


@pytest.fixture(scope="module")
def squeezenet_paths(tmp_path_factory):
    from pyopenvino_tpu.ir.writer import write_ir_model
    from tools.gen_squeezenet import build_squeezenet_11

    xml = str(tmp_path_factory.mktemp("squeezenet-1.1") / "squeezenet-1.1.xml")
    write_ir_model(build_squeezenet_11(), xml)
    return xml, xml[:-4] + ".bin"


FAMILIES = {
    "resnet18": (lambda _: synth.resnet18_paths(), (3, 224, 224), DP4_TP2),
    "mobilenet_v2": (lambda _: synth.mobilenet_v2_paths(), (3, 224, 224), DP4_TP2),
    "efficientnet_b0": (lambda _: efficientnet_b0.efficientnet_b0_paths(), (3, 224, 224),
                        (MeshConfig(data=4), {})),
    "shufflenet_v2": (lambda _: shufflenet_v2.shufflenet_v2_paths(), (3, 224, 224), DP4_TP2),
    "squeezenet_11": (lambda sq: sq, (3, 224, 224), DP4_TP2),
    "unet": (lambda _: unet.unet_paths(), (3, 128, 128), DP4_TP2),
    "vit_tiny": (lambda _: vit_tiny.vit_tiny_paths(), (3, 64, 64), DP4_TP2),
}


def _rows(n, shape, seed):
    return np.random.default_rng(seed).uniform(0, 255, (n, *shape)).astype(np.float32)


def _check(paths, rows, cfg, kw, quant=QuantMode.NONE):
    """(port sharded, port unsharded, JAX sharded) outputs of ``rows``."""
    model = read_ir_model(*paths)
    name = model.parameters[0].name
    config = Config(quant=quant)
    plain = compile_model(model, config, device="cpu")
    port = CompiledNetwork(plain.model, config, device="cpu", quantized=plain._quantized)
    shard_compiled(port, build_mesh(cfg, "cpu"), **kw)
    jax = jax_compile(jax_read(*paths), JaxConfig(backend=JaxBackend.XLA,
                                                  quant=JaxQuantMode(quant.value)))
    jax_mesh.shard_compiled(jax, jax_mesh.build_mesh(jax_mesh.MeshConfig(
        **dataclasses.asdict(cfg))), **kw)
    got = port.infer_batch({name: rows})
    want = plain.infer_batch({name: rows})
    ref = jax.infer_batch({name: rows})
    for k in want:
        assert got[k].shape == want[k].shape == ref[k].shape and np.isfinite(got[k]).all()
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got[k], ref[k], rtol=FAMILY_RTOL, atol=FAMILY_ATOL)
    return port


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_sharded_dp(family, squeezenet_paths):
    paths, shape, (cfg, kw) = FAMILIES[family]
    port = _check(paths(squeezenet_paths), _rows(4, shape, 7), cfg, kw)
    assert any("model" in spec for spec in port._w_specs.values()) == bool(kw)


def test_expert_parallel_sharding():
    """EP on (data=2, model=4): the four (E, K, N) expert stacks shard
    their expert axis, on eight distinct rows."""
    port = _check(moe_mlp.moe_mlp_paths(), _rows(8, (3, 32, 32), 3),
                  MeshConfig(data=2, model=4), {"tensor_parallel": True})
    experts = [k for k, spec in port._w_specs.items()
               if port.weights[k].dim() == 3 and spec[:1] == ("model",)]
    assert len(experts) == 4, experts


def test_moe_int8w_expert_parallel():
    """INT8 weight-only × EP: the rank-3 codes shard, their scales (no
    expert axis) stay replicated."""
    port = _check(moe_mlp.moe_mlp_paths(), _rows(4, (3, 32, 32), 4),
                  MeshConfig(data=1, model=2), {"tensor_parallel": True}, QuantMode.INT8_WEIGHT)
    for k, spec in port._w_specs.items():
        if k.endswith(".scale") and port.weights[k].dim() == 3:
            assert spec == ()


@pytest.fixture(scope="module")
def resnet18_int8_full():
    rng = np.random.default_rng(11)
    cal = [{"data": rng.uniform(0, 255, (1, 3, 224, 224)).astype(np.float32)} for _ in range(2)]
    net = compile_model(read_ir_model(*synth.resnet18_paths()),
                        Config(backend=Backend.KERNELS, quant=QuantMode.INT8_FULL),
                        device="cpu", calibration_samples=cal)
    rows = _rows(2, (3, 224, 224), 12)
    return net, rows, net.infer_batch({"data": rows})


@pytest.mark.parametrize("cfg,kw", [
    (MeshConfig(spatial=4), {"spatial_parallel": True}),
    (MeshConfig(data=2, spatial=2), {"spatial_parallel": True}),
    (MeshConfig(model=2), {"tensor_parallel": True}),
], ids=["sp4", "dp2_sp2", "tp2"])
def test_resnet18_int8_full_bit_equal(resnet18_int8_full, cfg, kw):
    net, rows, want = resnet18_int8_full
    port = CompiledNetwork(net.model, net.config, device="cpu", quantized=net._quantized,
                           act_scales=net.act_scales)
    shard_compiled(port, build_mesh(cfg, "cpu"), **kw)
    got = port.infer_batch({"data": rows})
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
