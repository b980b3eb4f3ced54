"""Full-width SqueezeNet-1.1 (224×224, 1000 classes, the IR and weights of
``_model_paths("squeezenet-1.1")``: Fire modules with their Concats, three
ceil-mode MaxPools, a convolutional class head and a global AvgPool) in
FP32 and INT8 weight-only through the port's public API on the CPU, against
the JAX package on the same IR, weights and inputs: TORCH against XLA and
KERNELS against Pallas in interpret mode, probabilities at rtol 1e-3 /
atol 1e-5 with the same top-5.  Every op type of the IR was registered in
the port before slice 3; these tests hold the port's claim to serve it."""

import numpy as np
import pytest

from pyopenvino_tpu.config import Backend as JaxBackend
from pyopenvino_tpu.config import Config as JaxConfig
from pyopenvino_tpu.config import QuantMode as JaxQuantMode
from pyopenvino_tpu.ir import read_ir_model as jax_read
from pyopenvino_tpu.runtime.compiler import compile_model as jax_compile

from pyopenvino_tpu_torch import IECore
from pyopenvino_tpu_torch.config import Config, QuantMode
from test_torch_port_efficientnet import PAIRS, QUANTS, _assert_matches
import test_torch_port_threads  # noqa: F401  (this worker's torch threads)


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    """The IR that ``__graft_entry__._model_paths("squeezenet-1.1")`` writes
    (same builder, same writer), in a private directory."""
    from pyopenvino_tpu.ir.writer import write_ir_model
    from tools.gen_squeezenet import build_squeezenet_11

    xml = str(tmp_path_factory.mktemp("squeezenet-1.1") / "squeezenet-1.1.xml")
    write_ir_model(build_squeezenet_11(), xml)
    return xml, xml[:-4] + ".bin"


@pytest.fixture(scope="module")
def blobs():
    return np.random.default_rng(17).uniform(0, 255, (2, 3, 224, 224)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_refs(paths, blobs):
    """{(quant, JAX backend): (B, 1000) outputs of the JAX package's batch-1
    ``infer``, one image at a time (one compile per network)."""
    model = jax_read(*paths)
    refs = {}
    for quant, jax_quant in QUANTS.items():
        for _, be in PAIRS:
            net = jax_compile(model, JaxConfig(backend=be, quant=jax_quant))
            refs[quant, be] = np.concatenate(
                [net.infer({"data": blobs[i:i + 1]})["prob"] for i in range(len(blobs))])
    return refs


@pytest.mark.parametrize("kernel_type,jax_backend", PAIRS)
@pytest.mark.parametrize("quant", list(QUANTS))
def test_port_matches_jax(paths, blobs, jax_refs, quant, kernel_type, jax_backend):
    ie = IECore()
    net = ie.read_network(*paths)
    assert {n.op_type for n in net.model.nodes.values()} == {
        "Parameter", "Const", "Convolution", "Add", "ReLU", "MaxPool", "Concat",
        "AvgPool", "Reshape", "SoftMax", "Result"}
    exe = ie.load_network(net, "CPU", config=Config(quant=quant))
    exe.kernel_type = kernel_type
    want = jax_refs[quant, jax_backend]
    got = exe.infer({"data": blobs[:1]})
    assert set(got) == {"prob"}
    _assert_matches(got["prob"], want[:1])
    _assert_matches(exe.infer_batch({"data": blobs})["prob"], want)
