"""ShuffleNet-v2 1.0× on the port against the JAX package: Split and
VariadicSplit, the rank-5 Reshape/Transpose of the channel shuffle on
channels_last tensors, a narrow ShuffleNet unit built with the JAX
package's GraphBuilder, and the full-width network (the port's
``models/shufflenet_v2.xml`` with the weights ``models/shufflenet_v2.py``
replays, byte for byte those of ``tools/gen_shufflenet.py``):

  * FP32 through the port's public API on the CPU, TORCH and KERNELS (each
    kernel wrapper taking its plain version) against the JAX package's XLA
    backend: probabilities at rtol 1e-3 / atol 1e-5 with the same top-5;
  * INT8 weight-only: the same int8 codes and float32 scales;
  * INT8-FULL: the same activation scales, and logits equal to the JAX
    package's bit for bit once the epilogue rounds as XLA's fused
    multiply-add does (tests/test_torch_port_int8full.py);
  * the numpy interpreter bit for bit; ``bake_batch`` at 4.

Inputs are made with numpy from a seed, uniform in [0, 255) (the stem folds
the 1/255 input scale), and handed to both packages."""

import types

import numpy as np
import pytest
import torch

from pyopenvino_tpu.config import Backend as JaxBackend
from pyopenvino_tpu.config import Config as JaxConfig
from pyopenvino_tpu.config import QuantMode as JaxQuantMode
from pyopenvino_tpu.ir import read_ir_model as jax_read
from pyopenvino_tpu.runtime.compiler import compile_model as jax_compile
from pyopenvino_tpu.runtime.interpreter import Interpreter as JaxInterpreter

from pyopenvino_tpu_torch import IECore
from pyopenvino_tpu_torch.config import Backend, Config, QuantMode
from pyopenvino_tpu_torch.ir import read_ir_model
from pyopenvino_tpu_torch.kernels import conv, conv_direct, gemm
from pyopenvino_tpu_torch.models import shufflenet_v2
from pyopenvino_tpu_torch.ops import get_op
from pyopenvino_tpu_torch.ops.spec import TValue
from pyopenvino_tpu_torch.passes.shape_infer import bake_batch, infer_shapes
from pyopenvino_tpu_torch.runtime.compiler import compile_model
from pyopenvino_tpu_torch.runtime.interpreter import Interpreter
from test_torch_port_int8full import BACKEND_PAIRS, Int8FullCase, check_int8full_case
import test_torch_port_threads  # noqa: F401  (this worker's torch threads)

RTOL, ATOL = 1e-3, 1e-5


def _assert_matches(got, want):
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    for g, w in zip(got, want):
        assert list(np.argsort(g)[::-1][:5]) == list(np.argsort(w)[::-1][:5])


def _write(model, tmp_path, name):
    from pyopenvino_tpu.ir.writer import write_ir_model

    xml = str(tmp_path / f"{name}.xml")
    write_ir_model(model, xml)
    return xml, xml[:-4] + ".bin"


# -- the ops, unit by unit ------------------------------------------------

def _graph(tmp_path, name, build):
    """(xml, bin) of a one-input graph that ``build(b, x)`` ends with
    Results, written by the JAX package's writer."""
    from pyopenvino_tpu.ir.builder import GraphBuilder

    b = GraphBuilder(name)
    build(b, b.parameter("data", (2, 12, 5, 6)))
    return _write(b.build(), tmp_path, name)


def _port_and_jax(paths, x):
    """{result: array} of the port's TORCH and numpy interpreter, and of the
    JAX package's XLA backend and interpreter, on one input."""
    model, jmodel = read_ir_model(*paths), jax_read(*paths)
    net = compile_model(model, Config(), device="cpu")
    want = jax_compile(jmodel, JaxConfig(backend=JaxBackend.XLA)).infer({"data": x})
    return (net.infer({"data": x}), Interpreter(model).run({"data": x}),
            want, JaxInterpreter(jmodel).run({"data": x}))


SPLITS = {
    "split_channels": lambda b, x: [b.result(p, name=f"out{i}") for i, p in
                                    enumerate(b.split(x, axis=1, num_splits=3))],
    "split_width": lambda b, x: [b.result(b.relu(p), name=f"out{i}") for i, p in
                                 enumerate(b.split(x, axis=-1, num_splits=2))],
    "variadic": lambda b, x: [b.result(p, name=f"out{i}") for i, p in
                              enumerate(b.variadic_split(x, 1, [5, -1, 3]))],
    "variadic_height": lambda b, x: [b.result(b.relu(p), name=f"out{i}") for i, p in
                                     enumerate(b.variadic_split(x, 2, [1, 4]))],
}


@pytest.mark.parametrize("name", list(SPLITS))
def test_split_ops_match_jax(tmp_path, name):
    """Every part on its own output port, the ports the IR declares; the
    compiled parts (views of the channels_last input) equal the JAX
    package's XLA backend and both interpreters, exactly."""
    paths = _graph(tmp_path, name, SPLITS[name])
    x = np.random.default_rng(len(name)).standard_normal((2, 12, 5, 6)).astype(np.float32)
    got, ref, want, jref = _port_and_jax(paths, x)
    assert set(got) == set(ref) == set(want) == set(jref)
    split = next(n for n in read_ir_model(*paths) if "Split" in n.op_type)
    assert len(split.outputs) == len(got) and min(split.outputs) == len(split.inputs)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(ref[k], jref[k])
        np.testing.assert_array_equal(got[k], ref[k])


def test_split_refusals():
    from pyopenvino_tpu_torch.ir.model import Node, TensorInfo

    info = TensorInfo((1, 6), np.dtype(np.float32))
    node = Node(0, "s", "Split", {"num_splits": "4"}, {}, {1: info, 2: info})
    with pytest.raises(ValueError, match="divisible"):
        get_op("Split").infer_shapes(node, {0: (1, 6), 1: ()}, {1: np.array(1)})
    with pytest.raises(ValueError, match="not constant"):
        get_op("Split").infer_shapes(node, {0: (1, 6), 1: ()}, {})
    vnode = Node(0, "v", "VariadicSplit", {}, {}, {1: info, 2: info})
    for lengths, what in (([-1, -1], "at most one"), ([2, 3], "sum to 5"),
                          ([7, -1], "exceed")):
        with pytest.raises(ValueError, match=what):
            get_op("VariadicSplit").infer_shapes(
                vnode, {0: (1, 6), 1: (), 2: (2,)}, {1: np.array(1), 2: np.array(lengths)})


@pytest.mark.parametrize("n,c,hw", [(1, 116, 28), (3, 24, 5), (2, 464, 7)])
def test_channel_shuffle_on_channels_last(n, c, hw):
    """The shuffle's Reshape → Transpose → Reshape on a channels_last
    tensor gives NCHW semantics (numpy on the logical array): the first
    Reshape is a view, the last one writes a channels_last tensor."""
    from pyopenvino_tpu_torch.ir.model import Node

    rng = np.random.default_rng(c)
    x = rng.standard_normal((n, c, hw, hw)).astype(np.float32)
    t = torch.from_numpy(x).contiguous(memory_format=torch.channels_last)

    def emit(op, static, tv):
        node = Node(0, op, op, {"special_zero": "true"}, {}, {0: None})
        ctx = types.SimpleNamespace(static_value=lambda node, port: static)
        return get_op(op).emit(ctx, node, {0: tv})[0]

    five = emit("Reshape", np.array([n, 2, c // 2, hw, hw]), TValue(t))
    assert five.arr.data_ptr() == t.data_ptr()
    swapped = emit("Transpose", np.array([0, 2, 1, 3, 4]), five)
    out = emit("Reshape", np.array([n, c, hw, hw]), swapped).arr
    want = x.reshape(n, 2, c // 2, hw, hw).transpose(0, 2, 1, 3, 4).reshape(n, c, hw, hw)
    np.testing.assert_array_equal(out.numpy(), want)
    assert out.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("half", [False, True])
def test_split_half_is_a_strided_gemm_operand(half):
    """A channel half of a channels_last activation reaches fused_gemm as a
    view with row stride C (no copy), and the 1×1 conv equals F.conv2d."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 464, 7, 7)).astype(np.float32)).contiguous(
        memory_format=torch.channels_last)
    part = torch.split(x, 232, dim=1)[int(half)]
    w = torch.from_numpy(rng.standard_normal((232, 232, 1, 1)).astype(np.float32))
    nhwc = part.permute(0, 2, 3, 1)
    a = conv.gemm_rows(nhwc)
    assert a.shape == (98, 232) and a.stride() == (464, 1)
    assert a.data_ptr() == nhwc.data_ptr()
    got = conv.conv2d_fused(nhwc, w).permute(0, 3, 1, 2)
    want = torch.nn.functional.conv2d(part, w)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    # the strided 1×1 conv's subsampled pixels are still copied
    assert conv.gemm_rows(nhwc[:, ::2, ::2, :]).is_contiguous()


def _unit(b, x):
    """A narrow ShuffleNet: tools/gen_shufflenet.py's downsampling unit and
    two basic units at 16 channels, GAP, a classifier and SoftMax."""
    from tools import gen_shufflenet as g

    rng = np.random.default_rng(0)
    x = g._conv(b, rng, x, 8, 3, 1)
    x = g._down_unit(b, rng, x, 16)
    for _ in range(2):
        x = g._basic_unit(b, rng, x)
    x = b.reduce("mean", x, (2, 3), keep_dims=False)
    wf = rng.normal(0, 0.3, (16, 10)).astype(np.float32)
    b.result(b.softmax(b.add(b.matmul(x, b.const(wf)),
                             b.const(np.zeros((1, 10), np.float32))), axis=1), name="prob")


@pytest.fixture(scope="module")
def unit_paths(tmp_path_factory):
    from pyopenvino_tpu.ir.builder import GraphBuilder

    b = GraphBuilder("shufflenet_unit")
    _unit(b, b.parameter("data", (1, 12, 10, 10)))
    return _write(b.build(), tmp_path_factory.mktemp("unit"), "shufflenet_unit")


def test_narrow_unit_matches_jax(unit_paths):
    """FP32 on both backends within 1e-5 of the JAX package's XLA backend,
    the interpreters bit for bit, and INT8-FULL (two calibration images)
    bit for bit with XLA's fused multiply-add in the epilogue."""
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (1, 12, 10, 10)).astype(np.float32)
    model, jmodel = read_ir_model(*unit_paths), jax_read(*unit_paths)
    assert {t: len(model.find_by_type(t)) for t in ("Split", "Transpose", "Reshape")} == {
        "Split": 2, "Transpose": 3, "Reshape": 6}
    want = jax_compile(jmodel, JaxConfig(backend=JaxBackend.XLA)).infer({"data": x})["prob"]
    for backend in ("torch", "kernels"):
        exe = IECore().load_network(IECore().read_network(*unit_paths), "CPU")
        exe.kernel_type = backend
        np.testing.assert_allclose(exe.infer({"data": x})["prob"], want,
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(Interpreter(model).run({"data": x})["prob"],
                                  JaxInterpreter(jmodel).run({"data": x})["prob"])


@pytest.mark.parametrize("backend,jax_backend", BACKEND_PAIRS)
def test_narrow_unit_int8full_matches_jax(unit_paths, backend, jax_backend, monkeypatch):
    case = Int8FullCase(unit_paths, seed=4)
    check_int8full_case(case, backend, jax_backend, monkeypatch)


# -- full width -----------------------------------------------------------

@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    """tools/gen_shufflenet.py's IR, written by the JAX package's writer."""
    from tools.gen_shufflenet import build_shufflenet_v2

    return _write(build_shufflenet_v2(), tmp_path_factory.mktemp("shufflenet"),
                  "shufflenet-v2")


@pytest.fixture(scope="module")
def paths():
    return shufflenet_v2.shufflenet_v2_paths(seed=0)


@pytest.fixture(scope="module")
def blobs():
    return np.random.default_rng(7).uniform(0, 255, (2, 3, 224, 224)).astype(np.float32)


@pytest.fixture(scope="module")
def net(paths):
    return IECore().read_network(*paths)


def _exe(net, quant, kernel_type):
    exe = IECore().load_network(net, "CPU", config=Config(quant=quant))
    exe.kernel_type = kernel_type
    return exe


def test_ir_and_weights_are_the_generators(generated, paths):
    """The shipped XML is the generator's; the replayed .bin is its .bin
    byte for byte (another seed: other weights, the same layout)."""
    xml, binp = generated
    with open(xml, "rb") as f, open(paths[0], "rb") as g:
        assert f.read() == g.read()
    with open(binp, "rb") as f, open(paths[1], "rb") as g:
        want = f.read()
        assert g.read() == want and len(want) == 9089184
    with open(paths[0], encoding="utf-8") as f:
        other = shufflenet_v2.generate_weights(f.read(), seed=1)
    assert len(other) == len(want) and other != want


def test_topology_and_synth_refusal(paths):
    """13 Splits (ports 2 and 3), 32 Reshapes and 16 Transposes in 16
    shuffles, 37 convs and 19 depthwise convs, 2.3 M parameters; every
    Reshape has a target Const of its own at a .bin region of its own;
    models/synth.py refuses the Split and Transpose integer roles."""
    from pyopenvino_tpu_torch.models import synth

    model = read_ir_model(*paths)
    counts = {t: len(model.find_by_type(t)) for t in (
        "Split", "Reshape", "Transpose", "Convolution", "GroupConvolution", "Concat")}
    assert counts == {"Split": 13, "Reshape": 32, "Transpose": 16, "Convolution": 37,
                      "GroupConvolution": 19, "Concat": 16}
    assert all(sorted(n.outputs) == [2, 3] for n in model.find_by_type("Split"))
    targets = [model.in_edges[n.id][1][0] for n in model.find_by_type("Reshape")]
    assert len(set(targets)) == 32
    assert all(len(model.out_edges[t]) == 1 for t in targets)
    assert len({model.nodes[t].attrs["offset"] for t in targets}) == 32
    params = sum(n.const.size for n in model.find_by_type("Const")
                 if np.issubdtype(n.const.dtype, np.floating))
    assert params == 2270514
    with pytest.raises(NotImplementedError, match="Reshape"):
        synth.generate_weights(read_ir_model(paths[0], None))


@pytest.fixture(scope="module")
def jax_refs(paths, blobs):
    """(2, 1000) of the JAX package's XLA backend, batch-1 ``infer`` one
    image at a time, and of its interpreter on image 0."""
    model = jax_read(*paths)
    net = jax_compile(model, JaxConfig(backend=JaxBackend.XLA))
    return (np.concatenate([net.infer({"data": blobs[i:i + 1]})["prob"] for i in range(2)]),
            JaxInterpreter(model).run({"data": blobs[:1]})["prob"])


@pytest.mark.parametrize("kernel_type", ["torch", "kernels"])
def test_full_width_fp32_matches_jax(net, blobs, jax_refs, kernel_type):
    exe = _exe(net, QuantMode.NONE, kernel_type)
    _assert_matches(exe.infer({"data": blobs[:1]})["prob"], jax_refs[0][:1])
    _assert_matches(exe.infer_batch({"data": blobs})["prob"], jax_refs[0])


def test_interpreter_matches_jax_bit_for_bit(net, blobs, jax_refs):
    got = _exe(net, QuantMode.NONE, "numpy").infer({"data": blobs[:1]})["prob"]
    np.testing.assert_array_equal(got, jax_refs[1])


def test_int8_weight_codes_match_jax(net, paths, blobs):
    """quantize_weights gives the JAX package's codes and scales for all 56
    conv weights and the classifier; INT8 weight-only keeps FP32's top-1."""
    from pyopenvino_tpu.runtime.compiler import prepare_model as jax_prepare

    exe = _exe(net, QuantMode.INT8_WEIGHT, "torch")
    got = exe.compiled()._quantized
    _, want, _, _ = jax_prepare(jax_read(*paths), JaxConfig(quant=JaxQuantMode.INT8_WEIGHT))
    assert sorted(got) == sorted(want) and len(want) == 57
    for nid, (codes, scales) in want.items():
        np.testing.assert_array_equal(got[nid][0], codes)
        np.testing.assert_array_equal(got[nid][1], scales)
    fp32 = _exe(net, QuantMode.NONE, "torch").infer_batch({"data": blobs})["prob"]
    assert (exe.infer_batch({"data": blobs})["prob"].argmax(1) == fp32.argmax(1)).all()


def test_bake_batch_at_4(net, paths):
    """bake_batch patches the 32 shuffle Reshape targets (leading 1 → 4)
    and nothing else; infer_batch at 4 equals four batch-1 requests."""
    model = read_ir_model(*paths)
    baked = bake_batch(model, 4)
    analysis = infer_shapes(baked)
    patched = [n for n in baked.find_by_type("Reshape")
               if int(baked.nodes[baked.in_edges[n.id][1][0]].const[0]) == 4]
    assert len(patched) == 32
    assert [analysis.shape(*baked.in_edges[r.id][0]) for r in baked.results] == [(4, 1000)]
    x = np.random.default_rng(9).uniform(0, 255, (4, 3, 224, 224)).astype(np.float32)
    exe = _exe(net, QuantMode.NONE, "torch")
    got = exe.infer_batch({"data": x})["prob"]
    assert got.shape == (4, 1000)
    for i in range(4):
        np.testing.assert_allclose(got[i], exe.infer({"data": x[i:i + 1]})["prob"][0],
                                   rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("quant", [QuantMode.NONE, QuantMode.INT8_WEIGHT])
def test_kernels_route_reaches_the_wrappers(net, blobs, monkeypatch, quant):
    """The 1×1 convs with co >= 128 and ci >= 64 (stage 3's, the head) and
    the classifier through fused_gemm, at the shapes chip_smoke.py reads
    from the compiled network; three of them take a Split half, a view
    with row stride 464."""
    import chip_smoke

    shapes, strided = [], []
    plain = gemm.fused_gemm_plain

    def spy(a, b, *args, **kw):
        shapes.append((a.shape[0], *b.shape))
        if a.stride(0) > a.shape[1]:
            strided.append((tuple(a.shape), a.stride()))
        return plain(a, b, *args, **kw)

    monkeypatch.setattr(gemm, "fused_gemm_plain", spy)
    exe = _exe(net, quant, "kernels")
    exe.infer({"data": blobs[:1]})
    table = chip_smoke.launch_table(exe.compiled(), quant.value)
    name = "fused_gemm_i8w" if quant == QuantMode.INT8_WEIGHT else "fused_gemm"
    assert set(table) == {name}
    assert sorted(shapes) == sorted(
        (m, k, n) for m, k, n, count in table[name] for _ in range(count))
    assert len(shapes) == 11
    assert strided == [((49, 232), (464, 1))] * 3
    from test_torch_port_gpu import SHUFFLENET_GEMMS  # the card tests' shapes

    assert table[name] == SHUFFLENET_GEMMS


def test_int8full_kernel_launches(int8full_case, monkeypatch):
    """Under INT8-FULL every Convolution (the stem through conv2d_fused's
    patches, the 1×1 convs) and the classifier run int8 × int8 fused_gemm,
    38 launches at the shapes of chip_smoke.launch_table; no conv2d_direct
    (no stride-1 spatial Convolution: the 3×3 convs are depthwise)."""
    import chip_smoke
    from test_torch_port_gpu import SHUFFLENET_I8I8

    seen = []
    plain = gemm.fused_gemm_plain

    def spy(a, b, *args, **kw):
        seen.append((str(a.dtype), a.shape[0], tuple(b.shape)))
        return plain(a, b, *args, **kw)

    monkeypatch.setattr(gemm, "fused_gemm_plain", spy)
    monkeypatch.setattr(conv_direct, "conv2d_direct_plain", None)  # never reached
    net, _ = int8full_case.port(Backend.KERNELS)
    assert chip_smoke.launch_table(net, "int8") == {"fused_gemm_i8i8": SHUFFLENET_I8I8}
    assert chip_smoke.direct_convs(net, "int8") == []
    assert sorted(seen) == sorted(("torch.int8", m, (k, n))
                                  for m, k, n, count in SHUFFLENET_I8I8 for _ in range(count))
    assert len(seen) == 38


@pytest.fixture(scope="module")
def int8full_case(paths):
    return Int8FullCase(paths, seed=3, high=255.0)


@pytest.mark.parametrize("backend,jax_backend", BACKEND_PAIRS)
def test_full_width_int8full_matches_jax(int8full_case, backend, jax_backend, monkeypatch):
    check_int8full_case(int8full_case, backend, jax_backend, monkeypatch)
    net, _ = int8full_case.port(backend)
    assert len(net.act_scales) == 57
