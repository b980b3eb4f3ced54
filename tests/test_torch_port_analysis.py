"""``CompiledNetwork.cost_analysis`` and ``memory_analysis`` of the port
(``runtime/analysis.py``) against the JAX package's, which reads XLA's
reports (``Config(backend=XLA)``, computed live here on the CPU), on the
trained ``mnist_bn``, ``shapes_resnet`` and ``googlenet_shapes``:

  * the JAX package's keys;
  * FP32 TORCH: flops within 10 % of XLA's; transcendentals equal where the
    softmax's exp is the only one (``mnist_bn``, ``shapes_resnet``),
    within 10 % on ``googlenet_shapes`` (its LRNs);
  * output bytes equal to XLA's and to what ``infer`` returns; argument
    bytes equal to this test's own sum of ``net.weights`` and the input
    (printed beside XLA's, which leaves out what its program does not
    read); temp bytes the sum of the values the walk holds, which the
    test captures, positive and at most the sum of every node's output;
    alias and generated code 0 on the CPU;
  * INT8-FULL TORCH: flops within 10 % of FP32's (the quantize steps are
    not counted), argument bytes equal to the sum of its weights (int8
    codes and float32 scales; TORCH keeps no float64 copy of a code) and
    the input.

Inputs are uniform in [0, 255), the trained models' range."""

import os

import numpy as np
import pytest

from pyopenvino_tpu.config import Backend as JaxBackend
from pyopenvino_tpu.config import Config as JaxConfig
from pyopenvino_tpu.ir import read_ir_model as jax_read
from pyopenvino_tpu.runtime.compiler import compile_model as jax_compile

from pyopenvino_tpu_torch.config import Config, QuantMode
from pyopenvino_tpu_torch.ir import read_ir_model
from pyopenvino_tpu_torch.runtime.compiler import compile_model
import test_torch_port_threads  # noqa: F401  (this worker's torch threads)

TRAINED = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "assets", "trained")
NAMES = ["mnist_bn", "shapes_resnet", "googlenet_shapes"]
COST_KEYS = {"flops", "transcendentals", "bytes accessed"}
MEMORY_KEYS = {"argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes",
               "alias_size_in_bytes", "generated_code_size_in_bytes"}


def _paths(name):
    return tuple(os.path.join(TRAINED, f"{name}.{e}") for e in ("xml", "bin"))


def _inputs(net, seed=0):
    p = net.model.parameters[0]
    shape = p.outputs[p.out_port].shape
    return {p.name: np.random.default_rng(seed).uniform(0, 255, shape).astype(np.float32)}


@pytest.fixture(scope="module")
def xla_reports():
    """{name: (XLA's cost_analysis, XLA's memory_analysis)} of the JAX
    package's network, B = 1."""
    reports = {}
    for name in NAMES:
        net = jax_compile(jax_read(*_paths(name)), JaxConfig(backend=JaxBackend.XLA))
        reports[name] = (net.cost_analysis(), net.memory_analysis())
    return reports


@pytest.fixture(scope="module")
def fp32():
    return {name: compile_model(read_ir_model(*_paths(name)), Config(), device="cpu")
            for name in NAMES}


def _close(got, want, rel):
    assert abs(got - want) <= rel * want, (got, want, got / want - 1)


@pytest.mark.parametrize("name", NAMES)
def test_cost_analysis_against_xla(fp32, xla_reports, name):
    cost, xla = fp32[name].cost_analysis(), xla_reports[name][0]
    assert set(cost) == COST_KEYS and COST_KEYS <= set(xla)
    print(f"{name}: port {cost}, XLA flops {xla['flops']} transcendentals "
          f"{xla['transcendentals']} bytes accessed {xla['bytes accessed']}")
    _close(cost["flops"], xla["flops"], 0.10)
    if name == "googlenet_shapes":
        _close(cost["transcendentals"], xla["transcendentals"], 0.10)
    else:
        assert cost["transcendentals"] == xla["transcendentals"] == 10.0
    assert cost["bytes accessed"] > 0


@pytest.mark.parametrize("name", NAMES)
def test_memory_analysis_against_xla(fp32, xla_reports, name):
    net = fp32[name]
    mem, xla = net.memory_analysis(), xla_reports[name][1]
    assert set(mem) == MEMORY_KEYS == set(xla)
    inputs = _inputs(net)
    in_bytes = sum(x.nbytes for x in inputs.values())
    weights = sum(w.nbytes for w in net.weights.values())
    print(f"{name}: port {mem}, XLA {xla}, net.weights {weights} + input {in_bytes}")
    assert mem["argument_size_in_bytes"] == weights + in_bytes
    out = net.infer(inputs)
    assert mem["output_size_in_bytes"] == xla["output_size_in_bytes"] == sum(
        o.nbytes for o in out.values())
    held = {n for n in net.emitted_names()  # the weights and the input are arguments
            if net.model.find_by_name(n).op_type not in ("Const", "Parameter")}
    _, captured = net.infer_with_capture(inputs, sorted(held))
    every = sum(4 * int(np.prod(net.analysis.shape(n.id, p))) for n in net.model
                if n.op_type not in ("Const", "Parameter", "Result") for p in n.outputs)
    assert 0 < mem["temp_size_in_bytes"] == sum(a.nbytes for a in captured.values()) <= every
    assert mem["alias_size_in_bytes"] == mem["generated_code_size_in_bytes"] == 0


@pytest.mark.parametrize("name", NAMES)
def test_int8full_analyses(fp32, name):
    model = read_ir_model(*_paths(name))
    samples = [_inputs(fp32[name], seed) for seed in (1, 2)]
    net = compile_model(model, Config(quant=QuantMode.INT8_FULL), device="cpu",
                        calibration_samples=samples)
    assert net._int8_edges  # int8 storage between ops (TORCH)
    cost, mem = net.cost_analysis(), net.memory_analysis()
    _close(cost["flops"], fp32[name].cost_analysis()["flops"], 0.10)
    codes = sum(w.nbytes for w in net.weights.values() if w.dtype.itemsize == 1)
    assert codes > 0
    in_bytes = sum(x.nbytes for x in samples[0].values())
    assert mem["argument_size_in_bytes"] == sum(
        w.nbytes for w in net.weights.values()) + in_bytes
    assert mem["argument_size_in_bytes"] < fp32[name].memory_analysis()["argument_size_in_bytes"]
    assert mem["output_size_in_bytes"] == sum(o.nbytes for o in net.infer(samples[0]).values())
    # int8-stored edges hold a byte an element
    assert 0 < mem["temp_size_in_bytes"] < fp32[name].memory_analysis()["temp_size_in_bytes"]
