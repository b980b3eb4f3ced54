"""Activation calibration in the port against the JAX package's: the
percentile method at full width on ResNet-18 and MobileNet-v2, and the KL
method on a narrow 3-conv net (its threshold search is a Python loop of
about 245k steps per observed node, so this file runs on a worker of its
own under ``--dist loadfile``).

Inputs are made with numpy from a seed and handed to both packages."""

import numpy as np
import pytest

from pyopenvino_tpu.ir import read_ir_model as jax_read

from pyopenvino_tpu_torch.ir import read_ir_model
from pyopenvino_tpu_torch.models import synth
from pyopenvino_tpu_torch.passes.calibrate import calibrate_activations
import test_torch_port_threads  # noqa: F401  (this worker's torch threads)

MODELS = ["resnet18", "mobilenet_v2"]


def _images(n, seed):
    rng = np.random.default_rng(seed)
    return [{"data": rng.uniform(0, 1, (1, 3, 224, 224)).astype(np.float32)}
            for _ in range(n)]


@pytest.mark.parametrize("percentile", [100.0, 99.9])
@pytest.mark.parametrize("name", MODELS)
def test_calibration_matches_jax(name, percentile):
    from pyopenvino_tpu.passes.calibrate import calibrate_activations as jax_calibrate

    paths = getattr(synth, f"{name}_paths")(seed=0)
    samples = _images(2, seed=4)
    want = jax_calibrate(jax_read(*paths), samples, percentile=percentile)
    got = calibrate_activations(read_ir_model(*paths), samples, percentile=percentile)
    assert got == want
    assert all(type(v) is float for v in got.values())
    assert len(got) == {"resnet18": 22, "mobilenet_v2": 54}[name]


def test_kl_calibration_matches_jax(tmp_path):
    """Entropy calibration on a 3-conv net."""
    from pyopenvino_tpu.ir.builder import GraphBuilder
    from pyopenvino_tpu.ir.writer import write_ir_model
    from pyopenvino_tpu.passes.calibrate import calibrate_activations as jax_calibrate

    rng = np.random.default_rng(6)
    b = GraphBuilder("kl")
    y = b.parameter("data", (1, 4, 12, 12))
    for ci, co in ((4, 8), (8, 8), (8, 4)):
        w = rng.normal(0, 0.4, (co, ci, 3, 3)).astype(np.float32)
        y = b.relu(b.conv2d(y, b.const(w), pads=((1, 1), (1, 1))))
    b.result(y, name="out")
    xml = str(tmp_path / "kl.xml")
    write_ir_model(b.build(), xml)
    # heavy-tailed inputs, so the clip point falls inside the range
    samples = [{"data": rng.standard_t(2, (1, 4, 12, 12)).astype(np.float32)}
               for _ in range(2)]
    want = jax_calibrate(jax_read(xml), samples, method="kl")
    got = calibrate_activations(read_ir_model(xml), samples, method="kl")
    assert got == want and len(got) == 3
    absmax = calibrate_activations(read_ir_model(xml), samples)
    assert any(got[k] < absmax[k] for k in got)
    with pytest.raises(ValueError, match="calibration method"):
        calibrate_activations(read_ir_model(xml), samples, method="minmax")
