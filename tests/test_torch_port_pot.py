"""POT-quantized IRs on the port against the JAX package: the FakeQuantize
op (grid midpoints included), the offline quantizer
(``tools/pot_quantize.py`` against the port's copy), weight-side folding
and IR-carried activation scales (``passes/fold_fq.py``), the IR writer,
and ``resnet18-pot`` (``models/pot.py``: the port's full-width ResNet-18
quantized with 4 samples, written by the port's writer and read back) in
FP32 (FakeQuantize emulation), INT8 weight-only (weight FakeQuantizes
folded) and sample-free INT8-FULL.

One rounding differs between the packages, and the tests patch it in
(``xla_fake_quantize``): XLA on the CPU computes FakeQuantize's
``clip·a − il·a`` and ``q·s + ol`` as fused multiply-adds, and divides by
``levels − 1`` as a multiply by its reciprocal, so its codes differ from
the port's (and numpy's) on a fraction of a percent of inputs and its
outputs in the last bit on most.  The port keeps the JAX package's
formula, which its numpy ``ref_compute`` computes exactly.

Inputs are made with numpy from a seed and handed to both packages."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import pyopenvino_tpu.ir.model as jax_ir
from pyopenvino_tpu.config import Backend as JaxBackend
from pyopenvino_tpu.config import Config as JaxConfig
from pyopenvino_tpu.config import QuantMode as JaxQuantMode
from pyopenvino_tpu.ir import read_ir_model as jax_read
from pyopenvino_tpu.runtime.compiler import compile_model as jax_compile

import pyopenvino_tpu_torch.ir.model as port_ir
from pyopenvino_tpu_torch import IECore
from pyopenvino_tpu_torch.config import Backend, Config, QuantMode
from pyopenvino_tpu_torch.ir import parse_ir, read_ir_model
from pyopenvino_tpu_torch.ir.writer import serialize_ir, write_ir_model
from pyopenvino_tpu_torch.kernels import conv_direct, gemm
from pyopenvino_tpu_torch.models.pot import resnet18_pot_paths
from pyopenvino_tpu_torch.models.synth import resnet18_paths
from pyopenvino_tpu_torch.ops import extended, get_op
from pyopenvino_tpu_torch.ops.spec import TValue
from pyopenvino_tpu_torch.passes import fold_fq
from pyopenvino_tpu_torch.runtime.compiler import compile_model, prepare_model
from pyopenvino_tpu_torch.tools import pot_quantize
from test_torch_port_int8full import (
    BACKEND_PAIRS,
    FLIP_RTOL,
    _rel_err,
    logits_model,
    xla_fma_epilogue,
)
import test_torch_port_threads  # noqa: F401  (this worker's torch threads)

TRAINED = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "assets", "trained")


def _trained(name):
    return tuple(os.path.join(TRAINED, f"{name}.{e}") for e in ("xml", "bin"))


def xla_fake_quantize(monkeypatch):
    """Make the port's FakeQuantize round as XLA's CPU lowering of the JAX
    package's formula does: ``round(fma(clip(x), a, −(il·a)))`` with
    a = steps/(ih − il), then ``fma(q, (oh − ol)·(1/steps), ol)`` (float64
    holds each float32 product exactly, so one rounding to float32 is the
    fused multiply-add's).  The numpy ``ref_compute``, which folds the
    weight FakeQuantizes in both packages, keeps its formula."""
    own = extended.FakeQuantize._apply

    def apply(self, node, x, il, ih, ol, oh, m):
        if m is not torch:
            return own(self, node, x, il, ih, ol, oh, m)
        steps = self._levels(node) - 1
        a = steps / (ih - il)
        c = torch.clip(x, il, ih).double()
        q = torch.round((c * a.double() - (il * a).double()).float())
        s = (oh - ol) * np.float32(1.0 / steps)
        return (q.double() * s.double() + ol.double()).float()

    monkeypatch.setattr(extended.FakeQuantize, "_apply", apply)


# -- the op ---------------------------------------------------------------

def _grid_inputs(shape, lo, hi, levels, seed):
    """Inputs on every grid midpoint of the (first-channel) range, one
    float32 step either side of it, past both ends, and uniform ones."""
    rng = np.random.default_rng(seed)
    lo0, hi0 = float(np.min(lo)), float(np.max(hi))
    a = np.float32(levels - 1) / (np.float32(hi0) - np.float32(lo0))
    mids = ((np.arange(levels - 1) + 0.5) / a + lo0).astype(np.float32)
    special = np.concatenate([np.nextafter(mids, np.float32(-np.inf)), mids,
                              np.nextafter(mids, np.float32(np.inf)),
                              np.float32([lo0 - 1, hi0 + 1, 0.0])])
    x = rng.uniform(lo0 - 0.2 * abs(lo0), hi0 + 0.2 * abs(hi0), int(np.prod(shape)))
    x = x.astype(np.float32)
    x[:special.size] = special[:x.size]
    return x.reshape(shape)


def _fq_graph(shape, ranges, levels):
    from pyopenvino_tpu.ir.builder import GraphBuilder

    b = GraphBuilder("fq")
    x = b.parameter("x", shape)
    b.result(b.fake_quantize(x, *ranges, levels=levels), name="out")
    return b.build()


FQ_CASES = {
    # POT's symmetric activation grid at three ranges
    "sym_2": ((1, 16, 8, 8), 2.0, 256),
    "sym_0.37": ((1, 16, 8, 8), 0.37, 256),
    "sym_255": ((2, 8, 8, 8), 255.0, 256),
    # a per-channel weight grid, other output range, fewer levels
    "per_channel": ((8, 4, 3, 3), None, 256),
    "asym_16_levels": ((1, 16, 8, 8), "asym", 16),
}


def _ranges(case):
    shape, hi, levels = FQ_CASES[case]
    rng = np.random.default_rng(len(case))
    if hi is None:
        his = rng.uniform(0.1, 3.0, (shape[0], 1, 1, 1)).astype(np.float32)
        lo, hi = pot_quantize._sym_ranges(his, levels)
        return shape, (lo, hi, lo, hi), levels
    if hi == "asym":
        return shape, tuple(np.float32([v]) for v in (-0.7, 1.9, -1.3, 2.4)), levels
    lo, hi = pot_quantize._sym_ranges(np.array([hi], np.float32), levels)
    return shape, (lo, hi, lo, hi), levels


@pytest.mark.parametrize("case", list(FQ_CASES))
def test_fake_quantize_matches_jax_op(case, monkeypatch):
    """The port's ref_compute equals the JAX package's bit for bit and the
    port's emit equals both; the JAX package's compiled op (XLA on the CPU)
    differs from them, and equals the port with XLA's rounding patched in."""
    from pyopenvino_tpu.ops import get_op as jax_get_op

    shape, ranges, levels = _ranges(case)
    x = _grid_inputs(shape, ranges[0], ranges[1], levels, seed=len(case))
    node = port_ir.Node(0, "fq", "FakeQuantize", {"levels": str(levels)}, {}, {5: None})
    jnode = jax_ir.Node(0, "fq", "FakeQuantize", {"levels": str(levels)}, {}, {5: None})
    ins = {0: x, **{i + 1: np.asarray(r) for i, r in enumerate(ranges)}}
    ref = get_op("FakeQuantize").ref_compute(node, ins)[5]
    np.testing.assert_array_equal(ref, jax_get_op("FakeQuantize").ref_compute(jnode, ins)[5])
    tvs = {p: TValue(torch.from_numpy(np.ascontiguousarray(v))) for p, v in ins.items()}
    got = get_op("FakeQuantize").emit(None, node, tvs)[5].arr
    np.testing.assert_array_equal(got.numpy(), ref)
    # every output on the output grid
    lo, hi, ol, oh = (np.asarray(r, np.float64) for r in ranges)
    k = (ref - ol) / ((oh - ol) / (levels - 1))
    assert np.abs(k - np.round(k)).max() < 1e-3 and k.min() > -0.5 and k.max() < levels - 0.5

    want = jax_compile(_fq_graph(shape, ranges, levels),
                       JaxConfig(backend=JaxBackend.XLA)).infer({"x": x})["out"]
    assert (want != ref).any()
    xla_fake_quantize(monkeypatch)
    np.testing.assert_array_equal(get_op("FakeQuantize").emit(None, node, tvs)[5].arr.numpy(),
                                  want)


def test_fake_quantize_zero_and_ends_exact():
    """The symmetric grid keeps exact zeros and the range's top."""
    lo, hi = pot_quantize._sym_ranges(np.array([2.0], np.float32), 256)
    node = port_ir.Node(0, "fq", "FakeQuantize", {"levels": "256"}, {}, {5: None})
    x = np.array([0.0, 2.0, -2.0, 1.0, 9.0], np.float32)
    out = get_op("FakeQuantize").ref_compute(node, {0: x, 1: lo, 2: hi, 3: lo, 4: hi})[5]
    assert out[0] == 0.0 and out[4] == hi[0]
    np.testing.assert_allclose(out[1], 2.0)
    with pytest.raises(ValueError, match="levels"):
        get_op("FakeQuantize").infer_shapes(
            port_ir.Node(0, "fq", "FakeQuantize", {"levels": "1"}, {}, {5: None}),
            {0: (1,), 1: (1,), 2: (1,), 3: (1,), 4: (1,)}, {})


# -- the quantizer, folding and scales -------------------------------------

def _assert_same_graph(got, want):
    """The same nodes (ids, names, types, attributes, ports), the same
    Const bytes and the same edges."""
    assert sorted(got.nodes) == sorted(want.nodes)
    for nid, g in got.nodes.items():
        w = want.nodes[nid]
        assert (g.name, g.op_type, g.attrs) == (w.name, w.op_type, w.attrs)
        assert ({p: (i.shape, i.dtype) for p, i in g.outputs.items()}
                == {p: (i.shape, i.dtype) for p, i in w.outputs.items()})
        if g.const is not None or w.const is not None:
            assert g.const.dtype == w.const.dtype and g.const.shape == w.const.shape
            assert g.const.tobytes() == w.const.tobytes()
    assert sorted(got.edges, key=dataclasses.astuple) == sorted(
        (port_ir.Edge(*dataclasses.astuple(e)) for e in want.edges), key=dataclasses.astuple)


@pytest.mark.parametrize("name,n_fq", [("mnist_bn", 10), ("shapes_resnet", None)])
def test_quantize_ir_matches_jax(name, n_fq):
    """tools/pot_quantize.py and the port's copy insert the same
    FakeQuantize nodes, with the same ranges, from the same samples."""
    from tools.pot_quantize import gen_samples as jax_gen_samples
    from tools.pot_quantize import quantize_ir as jax_quantize_ir

    paths = _trained(name)
    model, jmodel = read_ir_model(*paths), jax_read(*paths)
    got = pot_quantize.quantize_ir(model, samples=pot_quantize.gen_samples(model, 2))
    want = jax_quantize_ir(jmodel, samples=jax_gen_samples(jmodel, 2))
    _assert_same_graph(got, want)
    fqs = got.find_by_type("FakeQuantize")
    quantizable = [n for n in model if n.op_type in ("Convolution", "GroupConvolution", "MatMul")]
    assert len([f for f in fqs if got.nodes[got.in_edges[f.id][0][0]].op_type == "Const"]) == len(
        quantizable)
    if n_fq is not None:
        assert len(fqs) == n_fq
    weight_only = pot_quantize.quantize_ir(model, activations=False)
    _assert_same_graph(weight_only, jax_quantize_ir(jmodel, activations=False))
    assert len(weight_only.find_by_type("FakeQuantize")) == len(quantizable)


@pytest.fixture(scope="module")
def pot_paths():
    return resnet18_pot_paths(seed=0)


def test_resnet18_pot_is_jax_quantize_ir_of_the_same_model(pot_paths):
    """The POT IR on disk is the JAX package's quantize_ir of the same
    ResNet-18 and samples, read back: 21 weight and 18 activation
    FakeQuantizes (each projection shortcut shares its block's node)."""
    from tools.pot_quantize import gen_samples as jax_gen_samples
    from tools.pot_quantize import quantize_ir as jax_quantize_ir

    from pyopenvino_tpu.ir.writer import serialize_ir as jax_serialize

    jmodel = jax_read(*resnet18_paths(seed=0))
    want = jax_quantize_ir(jmodel, samples=jax_gen_samples(jmodel, 4))
    got = read_ir_model(*pot_paths)
    want = _jax_without_underscores(want)
    assert serialize_ir(got) == jax_serialize(jax_ir.Model(got.name, want.nodes, want.edges))
    fqs = got.find_by_type("FakeQuantize")
    on_weights = [f for f in fqs if got.nodes[got.in_edges[f.id][0][0]].op_type == "Const"]
    assert (len(on_weights), len(fqs) - len(on_weights)) == (21, 18)


def test_fold_fake_quantize_matches_jax(pot_paths):
    """Folding evaluates the port's own ref_compute in numpy: the folded
    weight Consts equal the JAX package's byte for byte, every weight
    FakeQuantize and its range Consts are gone, the activation ones stay."""
    from pyopenvino_tpu.passes.fold_fq import fold_fake_quantize as jax_fold

    model, jmodel = read_ir_model(*pot_paths), jax_read(*pot_paths)
    got, want = fold_fq.fold_fake_quantize(model), jax_fold(jmodel)
    _assert_same_graph(got, want)
    assert len(got.find_by_type("FakeQuantize")) == 18
    assert len(model.nodes) - len(got.nodes) == 21 * 3
    folded = [n for n in got.find_by_type("Const")
              if n.const.tobytes() != model.nodes[n.id].const.tobytes()]
    assert len(folded) == 21
    assert fold_fq.fold_fake_quantize(got) is got


def test_extract_act_scales_matches_jax(pot_paths):
    """The same 21 consumers (18 FakeQuantizes, three of them shared by a
    block's first conv and its shortcut), the same scales."""
    from pyopenvino_tpu.passes.calibrate import QUANTIZABLE as JAX_QUANTIZABLE
    from pyopenvino_tpu.passes.fold_fq import extract_act_scales as jax_extract
    from pyopenvino_tpu.passes.fold_fq import fold_fake_quantize as jax_fold

    from pyopenvino_tpu_torch.passes.calibrate import QUANTIZABLE

    model = fold_fq.fold_fake_quantize(read_ir_model(*pot_paths))
    got, scales = fold_fq.extract_act_scales(model, QUANTIZABLE)
    want, jscales = jax_extract(jax_fold(jax_read(*pot_paths)), JAX_QUANTIZABLE)
    assert scales == jscales and len(scales) == 21
    _assert_same_graph(got, want)
    assert not got.find_by_type("FakeQuantize")
    # a per-channel or zero-inexact activation grid is not the engine's lattice
    fq = model.find_by_type("FakeQuantize")[0]
    srcs = {p: model.nodes[s] for p, (s, _) in model.in_edges[fq.id].items()}
    assert fold_fq._symmetric_scale(srcs, 256) == scales[model.out_edges[fq.id][0][1]]
    shifted = {**srcs, 1: dataclasses.replace(srcs[1], const=srcs[1].const * 0.9)}
    assert fold_fq._symmetric_scale(shifted, 256) is None


# -- resnet18-pot end to end -------------------------------------------------

@pytest.fixture(scope="module")
def blobs():
    return np.random.default_rng(11).uniform(0, 255, (2, 3, 224, 224)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_refs(pot_paths, blobs):
    """{quant: [(logits, {FakeQuantize name: output}) for each image]} of
    the JAX package's XLA backend on the logits model, batch 1."""
    model = logits_model(jax_read(*pot_paths), jax_ir)
    refs = {}
    for quant, jquant in ((QuantMode.NONE, JaxQuantMode.NONE),
                          (QuantMode.INT8_WEIGHT, JaxQuantMode.INT8_WEIGHT)):
        net = jax_compile(model, JaxConfig(backend=JaxBackend.XLA, quant=jquant))
        names = [n.name for n in net.model.find_by_type("FakeQuantize")]
        refs[quant] = []
        for i in range(len(blobs)):
            res, fqs = net.infer_with_capture({"data": blobs[i:i + 1]}, names)
            refs[quant].append((res[model.results[0].name], fqs))
    return refs


@pytest.mark.parametrize("kernel_type", ["torch", "kernels"])
@pytest.mark.parametrize("quant", [QuantMode.NONE, QuantMode.INT8_WEIGHT])
def test_pot_fp32_and_int8w_match_jax(pot_paths, blobs, jax_refs, quant, kernel_type,
                                      monkeypatch):
    """FP32 emulates the 18 activation FakeQuantizes (the 21 weight ones
    folded); INT8 weight-only also quantizes the folded weights.  The
    probabilities saturate (|logit| about 1.8e4 on inputs in [0, 255)), so
    the logits are held against the JAX package's XLA backend, between the
    FakeQuantizes: each FakeQuantize emits XLA's output, after its own
    output (XLA's rounding patched in) is held to it, a differing code one
    step off with its input at a rounding midpoint and at most FLIP_RATE of
    the codes differing (``chip_smoke.forced_fake_quantize``); the logits
    then agree within 1e-4, the top-1 too.  Unforced, those few midpoint
    codes move the logits as far as no emulation at all does; a run without
    the emulation fails both checks."""
    import chip_smoke

    backend = {"torch": Backend.TORCH, "kernels": Backend.KERNELS}[kernel_type]
    model = logits_model(read_ir_model(*pot_paths), port_ir)
    net = compile_model(model, Config(backend=backend, quant=quant), device="cpu")
    assert len(net.model.find_by_type("FakeQuantize")) == 18
    out = model.results[0].name
    xla_fake_quantize(monkeypatch)
    for i, (want, fqs) in enumerate(jax_refs[quant]):
        x = {"data": blobs[i:i + 1]}
        forced = {name: torch.tensor(v) for name, v in fqs.items()}
        stats = {}
        with chip_smoke.forced_fake_quantize(forced, stats):
            got = net.infer(x)[out]
        err = _rel_err(got, want)
        unforced = _rel_err(net.infer(x)[out], want)
        with chip_smoke.no_fake_quantize():
            bare = _rel_err(net.infer(x)[out], want)
        print(f"resnet18-pot {quant.value} {kernel_type} image {i}: logits max_rel_err forced "
              f"{err:.3e}, unforced {unforced:.3e}, without FakeQuantize {bare:.3e}; "
              f"{stats['flips']} of {stats['elements']} codes differ, their inputs at most "
              f"{stats['worst_midpoint_dist']:.3e} of max |x| from the midpoint")
        assert err <= chip_smoke.LOGIT_RTOL[quant.value] < bare
        assert got.argmax() == want.argmax()
        with pytest.raises(AssertionError, match="one step|midpoint"):
            with chip_smoke.no_fake_quantize(), chip_smoke.forced_fake_quantize(forced, {}):
                net.infer(x)

    # the same IR through the API answers probabilities with the same top-1
    exe = IECore().load_network(IECore().read_network(*pot_paths), "CPU",
                                config=Config(quant=quant))
    exe.kernel_type = kernel_type
    probs = exe.infer_batch({"data": blobs})["prob"]
    assert probs.shape == (len(blobs), 1000) and np.isfinite(probs).all()
    assert len(exe.compiled().model.find_by_type("FakeQuantize")) == 18
    assert (probs.argmax(1) == [w.argmax() for w, _ in jax_refs[quant]]).all()


def test_pot_int8w_codes_are_the_folded_grid(pot_paths):
    """quantize_weights gives the JAX package's codes and scales for the 21
    folded weights; a conv weight's per-channel grid is the int8 grid
    itself, so codes times scale give it back within a float32 rounding,
    while the classifier's per-tensor grid is requantized per column,
    within half a column step."""
    from pyopenvino_tpu.runtime.compiler import prepare_model as jax_prepare

    model, quantized, _, _ = prepare_model(read_ir_model(*pot_paths),
                                           Config(quant=QuantMode.INT8_WEIGHT))
    _, want, _, _ = jax_prepare(jax_read(*pot_paths), JaxConfig(quant=JaxQuantMode.INT8_WEIGHT))
    assert sorted(quantized) == sorted(want) and len(want) == 21
    for nid, (codes, scales) in want.items():
        np.testing.assert_array_equal(quantized[nid][0], codes)
        np.testing.assert_array_equal(quantized[nid][1], scales)
        w = model.nodes[nid].const
        if w.ndim == 4:
            np.testing.assert_allclose(codes * scales, w, rtol=1e-6, atol=1e-6 * np.abs(w).max())
        else:
            assert (np.abs(codes * scales - w) <= scales * (0.5 + 1e-5)).all()


def test_interpreter_runs_pot_ir_bit_for_bit(pot_paths, blobs):
    from pyopenvino_tpu.runtime.interpreter import Interpreter as JaxInterpreter

    exe = IECore().load_network(IECore().read_network(*pot_paths), "CPU")
    exe.kernel_type = "numpy"
    got = exe.infer({"data": blobs[:1]})["prob"]
    np.testing.assert_array_equal(
        got, JaxInterpreter(jax_read(*pot_paths)).run({"data": blobs[:1]})["prob"])


@pytest.fixture(scope="module")
def int8full(pot_paths, blobs):
    """The logits model of resnet18-pot compiled INT8-FULL with no samples
    by the JAX package, on both its backends."""
    jmodel = logits_model(jax_read(*pot_paths), jax_ir)
    out = {}
    for be in (JaxBackend.XLA, JaxBackend.PALLAS):
        net = jax_compile(jmodel, JaxConfig(backend=be, quant=JaxQuantMode.INT8_FULL))
        out[be] = (net.act_scales, net.infer({"data": blobs[:1]})[jmodel.results[0].name])
    return out


@pytest.mark.parametrize("backend,jax_backend", BACKEND_PAIRS)
def test_sample_free_int8full_matches_jax(pot_paths, blobs, int8full, backend, jax_backend,
                                          monkeypatch):
    """Every activation scale comes from the IR (21, the JAX package's),
    no FakeQuantize is left, and the logits equal the JAX package's bit for
    bit with XLA's fused multiply-add in the epilogue."""
    model = logits_model(read_ir_model(*pot_paths), port_ir)
    net = compile_model(model, Config(backend=backend, quant=QuantMode.INT8_FULL), device="cpu")
    scales, want = int8full[jax_backend]
    assert net.act_scales == scales and len(scales) == 21
    assert not net.model.find_by_type("FakeQuantize")
    got = net.infer({"data": blobs[:1]})[model.results[0].name]
    assert _rel_err(got, want) <= FLIP_RTOL
    xla_fma_epilogue(monkeypatch)
    np.testing.assert_array_equal(net.infer({"data": blobs[:1]})[model.results[0].name], want)


def test_sample_free_int8full_through_the_api_launches_as_resnet18(pot_paths, blobs,
                                                                  monkeypatch):
    """load_network under INT8-FULL without set_calibration answers; on
    KERNELS it launches what ResNet-18 INT8-FULL launches (13 conv2d_direct,
    8 int8 × int8 fused_gemm) at the same shapes."""
    import chip_smoke

    seen = {"gemm": 0, "direct": 0}
    plain_gemm, plain_direct = gemm.fused_gemm_plain, conv_direct.conv2d_direct_plain

    def gemm_spy(*args, **kw):
        seen["gemm"] += 1
        return plain_gemm(*args, **kw)

    def direct_spy(*args, **kw):
        seen["direct"] += 1
        return plain_direct(*args, **kw)

    monkeypatch.setattr(gemm, "fused_gemm_plain", gemm_spy)
    monkeypatch.setattr(conv_direct, "conv2d_direct_plain", direct_spy)
    ie = IECore()
    exe = ie.load_network(ie.read_network(*pot_paths), "CPU",
                          config=Config(quant=QuantMode.INT8_FULL))
    exe.kernel_type = "kernels"
    out = exe.infer({"data": blobs[:1]})["prob"]
    assert out.shape == (1, 1000) and np.isfinite(out).all()
    assert seen == {"gemm": 8, "direct": 13}
    r18 = compile_model(read_ir_model(*resnet18_paths(seed=0)),
                        Config(backend=Backend.KERNELS, quant=QuantMode.INT8_FULL),
                        device="cpu", calibration_samples=[{"data": blobs[:1]}])
    assert (chip_smoke.launch_table(exe.compiled(), "int8")
            == chip_smoke.launch_table(r18, "int8"))
    assert chip_smoke.direct_convs(exe.compiled(), "int8") == chip_smoke.direct_convs(r18, "int8")


def test_weight_only_pot_ir_needs_samples(tmp_path):
    """An IR with weight FakeQuantizes only carries no activation scale:
    INT8-FULL raises without samples, naming them, and calibrates with
    them (the JAX package's scales)."""
    paths = _trained("mnist_bn")
    q = pot_quantize.quantize_ir(read_ir_model(*paths), activations=False)
    xml = str(tmp_path / "mnist_bn_w.xml")
    write_ir_model(q, xml)
    model = read_ir_model(xml)
    with pytest.raises(ValueError, match="calibration_samples"):
        compile_model(model, Config(quant=QuantMode.INT8_FULL), device="cpu")
    with pytest.raises(ValueError, match="calibration_samples"):
        compile_model(read_ir_model(*paths), Config(quant=QuantMode.INT8_FULL), device="cpu")
    samples = pot_quantize.gen_samples(model, 2)
    net = compile_model(model, Config(quant=QuantMode.INT8_FULL), device="cpu",
                        calibration_samples=samples)
    want = jax_compile(jax_read(xml), JaxConfig(quant=JaxQuantMode.INT8_FULL),
                       calibration_samples=samples)
    assert net.act_scales == want.act_scales and len(net.act_scales) == 5


# -- the writer --------------------------------------------------------------

def _jax_without_underscores(model):
    nodes = {nid: dataclasses.replace(n, attrs={k: v for k, v in n.attrs.items()
                                                if not k.startswith("_")})
             for nid, n in model.nodes.items()}
    return jax_ir.Model(model.name, nodes, model.edges)


@pytest.mark.parametrize("name", ["resnet18-pot", "ssd_shapes_ms", "shapes_resnet"])
def test_writer_matches_jax_writer(name, pot_paths):
    """The port's XML and .bin equal the JAX writer's on the same model,
    once the engine's underscore attributes (``_opset``) are left out of
    the JAX side; the written IR reads back and writes again the same."""
    from pyopenvino_tpu.ir.writer import serialize_ir as jax_serialize

    paths = pot_paths if name == "resnet18-pot" else _trained(name)
    model, jmodel = read_ir_model(*paths), jax_read(*paths)
    xml, blob = serialize_ir(model)
    jxml, jblob = jax_serialize(jmodel)
    assert b"_opset" in jxml and b"_opset" not in xml
    assert xml == jax_serialize(_jax_without_underscores(jmodel))[0]
    assert blob == jblob
    again = parse_ir(xml.decode("utf-8"), blob, name=model.name)
    assert serialize_ir(again) == (xml, blob)


def test_writer_strips_baked_batch(tmp_path):
    """A graph compiled at batch 4 (DetectionOutput carries
    ``_baked_batch``) writes no underscore attribute: the written IR is a
    plain IR with a batch-4 input, not a permanently baked one."""
    from pyopenvino_tpu_torch.passes.shape_infer import bake_batch

    paths = _trained("ssd_shapes_ms")
    baked = bake_batch(read_ir_model(*paths), 4)
    det = baked.find_by_type("DetectionOutput")[0]
    assert det.attrs["_baked_batch"] == "4"
    xml = str(tmp_path / "ssd_b4.xml")
    write_ir_model(baked, xml)
    with open(xml, encoding="utf-8") as f:
        text = f.read()
    assert "_baked_batch" not in text and "_opset" not in text
    back = read_ir_model(xml)
    assert back.parameters[0].outputs[0].shape == (4, 3, 300, 300)
    assert "_baked_batch" not in back.find_by_type("DetectionOutput")[0].attrs
