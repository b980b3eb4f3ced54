"""Slice 3's trained IRs end to end: ``googlenet_shapes`` (GoogLeNet-v1's
graph narrowed ×4 with its two LRNs and 14 ceil-mode pools, trained on
labelled shapes at 224²) and ``shapes_resnet`` (a ResNet with a ReduceMean
global pool, 32²) through the port's public API on the CPU, against the JAX
package on the same IR, weights and inputs:

  * FP32 and INT8 weight-only: TORCH against XLA and KERNELS against Pallas
    in interpret mode, probabilities at rtol 1e-3 / atol 1e-5 with the same
    top-5 above 1e-5;
  * INT8-FULL (``googlenet_shapes`` with bias correction, as
    tools/accuracy.py runs it): the same activation scales, and logits equal
    to the JAX package's bit for bit once the epilogue rounds as XLA's fused
    multiply-add does (tests/test_torch_port_int8full.py);
  * the numpy interpreter bit for bit, the fusion plan, and the kernels'
    launches at the shapes chip_smoke.py checks and times.

Inputs are uniform in [0, 255), the trained models' range."""

import os

import numpy as np
import pytest

from pyopenvino_tpu.config import Backend as JaxBackend
from pyopenvino_tpu.config import Config as JaxConfig
from pyopenvino_tpu.config import QuantMode as JaxQuantMode
from pyopenvino_tpu.ir import read_ir_model as jax_read
from pyopenvino_tpu.runtime.compiler import compile_model as jax_compile

from pyopenvino_tpu_torch import IECore
from pyopenvino_tpu_torch.config import Config, QuantMode
from pyopenvino_tpu_torch.kernels import conv_direct, gemm
from test_torch_port_int8full import BACKEND_PAIRS, Int8FullCase, check_int8full_case
import test_torch_port_threads  # noqa: F401  (this worker's torch threads)

RTOL, ATOL = 1e-3, 1e-5
TRAINED = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "assets", "trained")
PATHS = {name: tuple(os.path.join(TRAINED, f"{name}.{e}") for e in ("xml", "bin"))
         for name in ("googlenet_shapes", "shapes_resnet")}
QUANTS = {QuantMode.NONE: JaxQuantMode.NONE,
          QuantMode.INT8_WEIGHT: JaxQuantMode.INT8_WEIGHT}
PAIRS = [("torch", JaxBackend.XLA), ("kernels", JaxBackend.PALLAS)]
# tools/accuracy.py's INT8-FULL settings: bias correction on googlenet_shapes
INT8FULL_CONFIG = {"googlenet_shapes": {"bias_correction": True}, "shapes_resnet": {}}


def _input(net, n, seed):
    p = net.model.parameters[0]
    shape = (n,) + tuple(p.outputs[p.out_port].shape[1:])
    return p.name, np.random.default_rng(seed).uniform(0, 255, shape).astype(np.float32)


@pytest.fixture(scope="module")
def nets():
    return {name: IECore().read_network(*paths) for name, paths in PATHS.items()}


@pytest.fixture(scope="module")
def jax_refs(nets):
    """{(model, quant, JAX backend): (2, 10) outputs of the JAX package's
    batch-1 ``infer``, one image at a time (one compile per network)."""
    refs = {}
    for name, paths in PATHS.items():
        model = jax_read(*paths)
        in_name, x = _input(nets[name], 2, seed=5)
        out = nets[name].model.results[0].name
        for quant, jax_quant in QUANTS.items():
            for _, be in PAIRS:
                net = jax_compile(model, JaxConfig(backend=be, quant=jax_quant))
                refs[name, quant, be] = np.concatenate(
                    [net.infer({in_name: x[i:i + 1]})[out] for i in range(len(x))])
    return refs


def _exe(net, quant, kernel_type, **config):
    exe = IECore().load_network(net, "CPU", config=Config(quant=quant, **config))
    exe.kernel_type = kernel_type
    return exe


def _assert_matches(got, want):
    """allclose, and the same top-5 among the classes above ``ATOL``: the
    trained models put the rest below 1e-20, where the order is noise."""
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    for g, w in zip(got, want):
        top = [c for c in np.argsort(w)[::-1][:5] if w[c] > ATOL]
        assert list(np.argsort(g)[::-1][:len(top)]) == top


@pytest.mark.parametrize("kernel_type,jax_backend", PAIRS)
@pytest.mark.parametrize("quant", list(QUANTS))
@pytest.mark.parametrize("name", list(PATHS))
def test_port_matches_jax(nets, jax_refs, name, quant, kernel_type, jax_backend):
    net = nets[name]
    in_name, x = _input(net, 2, seed=5)
    out = net.model.results[0].name
    exe = _exe(net, quant, kernel_type)
    want = jax_refs[name, quant, jax_backend]
    got = exe.infer({in_name: x[:1]})
    assert set(got) == {out} and got[out].shape == (1, 10)
    _assert_matches(got[out], want[:1])
    _assert_matches(exe.infer_batch({in_name: x})[out], want)


@pytest.fixture(scope="module")
def int8full_cases():
    return {name: Int8FullCase(paths, seed=3, high=255.0, **INT8FULL_CONFIG[name])
            for name, paths in PATHS.items()}


@pytest.mark.parametrize("backend,jax_backend", BACKEND_PAIRS)
@pytest.mark.parametrize("name", list(PATHS))
def test_int8full_matches_jax(int8full_cases, name, backend, jax_backend, monkeypatch):
    check_int8full_case(int8full_cases[name], backend, jax_backend, monkeypatch)


@pytest.mark.parametrize("name", list(PATHS))
def test_interpreter_matches_jax_bit_for_bit(nets, name):
    from pyopenvino_tpu.runtime.interpreter import Interpreter as JaxInterpreter

    net = nets[name]
    in_name, x = _input(net, 1, seed=9)
    got = _exe(net, QuantMode.NONE, "numpy").infer({in_name: x})
    want = JaxInterpreter(jax_read(*PATHS[name])).run({in_name: x})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("name", list(PATHS))
def test_fusions_match_jax(name):
    from pyopenvino_tpu.passes.fuse import find_fusions as jax_find_fusions
    from pyopenvino_tpu.passes.shape_infer import infer_shapes as jax_infer_shapes

    from pyopenvino_tpu_torch.ir import read_ir_model
    from pyopenvino_tpu_torch.passes.fuse import find_fusions
    from pyopenvino_tpu_torch.passes.shape_infer import infer_shapes

    model, jmodel = read_ir_model(*PATHS[name]), jax_read(*PATHS[name])
    got = find_fusions(model, infer_shapes(model))
    want = jax_find_fusions(jmodel, jax_infer_shapes(jmodel))
    assert {k: (f.bias_src, f.act, f.out_key, f.skip) for k, f in got.items()} == {
        k: (f.bias_src, f.act, f.out_key, f.skip) for k, f in want.items()}
    assert len(got) == {"googlenet_shapes": 58, "shapes_resnet": 10}[name]


@pytest.mark.parametrize("quant", [QuantMode.NONE, QuantMode.INT8_WEIGHT, QuantMode.INT8_FULL])
def test_googlenet_kernel_launches(nets, int8full_cases, monkeypatch, quant):
    """The launches of one googlenet_shapes forward on KERNELS, at the
    shapes of chip_smoke.launch_table: under INT8-FULL the 19 stride-1
    spatial convs (3×3 and 5×5, Ci down to 4) through conv2d_direct and the
    38 others and the classifier through the int8 × int8 fused_gemm;
    otherwise only the classifier (no 1×1 conv is wide enough) through
    fused_gemm, with an int8 B under INT8 weight-only."""
    import chip_smoke

    seen = {"gemm": [], "direct": []}
    plain_gemm, plain_direct = gemm.fused_gemm_plain, conv_direct.conv2d_direct_plain

    def gemm_spy(a, b, *args, **kw):
        seen["gemm"].append((str(a.dtype), str(b.dtype), a.shape[0], tuple(b.shape)))
        return plain_gemm(a, b, *args, **kw)

    def direct_spy(x, w, *args, **kw):
        seen["direct"].append((tuple(x.shape), tuple(w.shape)))
        return plain_direct(x, w, *args, **kw)

    monkeypatch.setattr(gemm, "fused_gemm_plain", gemm_spy)
    monkeypatch.setattr(conv_direct, "conv2d_direct_plain", direct_spy)
    case = int8full_cases["googlenet_shapes"]
    exe = _exe(nets["googlenet_shapes"], quant, "kernels",
               **INT8FULL_CONFIG["googlenet_shapes"] if quant == QuantMode.INT8_FULL else {})
    if quant == QuantMode.INT8_FULL:
        exe.set_calibration(case.samples)
    exe.infer(case.x)
    table = chip_smoke.launch_table(exe.compiled(), quant.value)
    gemm_name = {QuantMode.NONE: "fused_gemm", QuantMode.INT8_WEIGHT: "fused_gemm_i8w",
                 QuantMode.INT8_FULL: "fused_gemm_i8i8"}[quant]
    dtypes = {QuantMode.NONE: ("torch.float32", "torch.float32"),
              QuantMode.INT8_WEIGHT: ("torch.float32", "torch.int8"),
              QuantMode.INT8_FULL: ("torch.int8", "torch.int8")}[quant]
    assert sorted(seen["gemm"]) == sorted(
        (*dtypes, m, (k, n)) for m, k, n, count in table[gemm_name] for _ in range(count))
    assert set(table) == ({gemm_name, "conv2d_direct"} if quant == QuantMode.INT8_FULL
                          else {gemm_name})
    if quant != QuantMode.INT8_FULL:
        assert len(seen["gemm"]) == 1 and not seen["direct"]
        return
    assert len(seen["gemm"]) == 39 and len(seen["direct"]) == 19
    # the card tests and the int8 wgmma route's tests take #1ii at these shapes
    from test_torch_port_gpu import GOOGLENET_I8I8

    assert table["fused_gemm_i8i8"] == GOOGLENET_I8I8
    assert sorted((h * w, ci * kh * kw, co) for (_, h, w, ci), (co, _, kh, kw) in seen["direct"]
                  ) == sorted((m, k, n) for m, k, n, count in table["conv2d_direct"]
                              for _ in range(count))
    assert {w[1] for _, w in seen["direct"] if w[2] == 5} == {4, 6, 8, 12}
    # the card tests hold conv2d_direct at these geometries
    from test_torch_port_gpu import GOOGLENET_DIRECT

    assert [c[:7] for c in chip_smoke.direct_convs(exe.compiled(), quant.value)] == \
        GOOGLENET_DIRECT
