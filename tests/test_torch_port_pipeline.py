"""The port's pipeline (``pyopenvino_tpu_torch/parallel/pipeline.py``)
against the JAX package's (``pyopenvino_tpu/parallel/pipeline.py``) on the
CPU.

Counterparts of the 17 tests of ``tests/test_pipeline.py`` and of
``tests/test_serving.py::test_served_pipelined_network``.  The JAX tests'
``mnist`` and ``googlenet-v1`` read the reference's models, which are not in
the repository: their cases run on ``assets/trained/mnist_bn`` and
``assets/trained/googlenet_shapes`` (GoogLeNet-v1's graph narrowed 4×), the
SSD case on ``assets/trained/ssd_shapes_ms``; ViT-tiny, U-Net and ocr-ti at
their generators' widths, built as ``__graft_entry__._model_paths`` builds
them, into a private directory.  Each case runs the JAX package's pipelined
network on its 8 forced host devices and the port's on the CPU repeated 8
times (``devices="cpu"``), and holds:
  * the port's pipelined network against its own unsharded one: INT8-FULL
    bit for bit, float at the JAX tests' rtol 1e-4 / atol 1e-5 (ViT-tiny
    atol 1e-3, SSD's tables atol 1e-4, as the JAX tests hold theirs);
  * the port's pipelined network against the JAX package's: mnist_bn at
    its TORCH-vs-XLA limit, rtol 1e-4 / atol 1e-5, INT8-FULL with XLA's
    fused multiply-add epilogue patched in (``xla_fma_epilogue``);
    googlenet_shapes and the families at the families' rtol 1e-3 / atol
    1e-5; SSD's tables by ``check_records``.
Then what the port must share with the JAX package stage by stage: the same
cuts on every IR above at 2, 3 and 4 stages, the same runtime node ids and
``__pp_in__`` / ``__pp_out__`` TensorInfos in each stage, and each stage's
weights equal key for key, element for element.  And what the port's own
schedule must do: no stage output read back to the host before the last
stage is issued (``torch.Tensor.cpu``, ``.numpy`` and ``.item`` wrapped
inside the test), the cut tensor handed on in bfloat16 under bf16 compute,
a cut on an edge that the whole network stores as int8 giving the same
codes, and the default devices refusing a mesh larger than the cards."""

import numpy as np
import pytest
import torch

from pyopenvino_tpu.config import Backend as JaxBackend
from pyopenvino_tpu.config import Config as JaxConfig
from pyopenvino_tpu.config import QuantMode as JaxQuantMode
from pyopenvino_tpu.ir import read_ir_model as jax_read
from pyopenvino_tpu.ir.builder import GraphBuilder as JaxBuilder
from pyopenvino_tpu.parallel import pipeline as jax_pp
from pyopenvino_tpu.passes.shape_infer import infer_shapes as jax_infer_shapes
from pyopenvino_tpu.runtime.compiler import compile_model as jax_compile
from pyopenvino_tpu.runtime.compiler import prepare_model as jax_prepare
from pyopenvino_tpu.serving import InferenceServer as JaxServer

from pyopenvino_tpu_torch import parallel
from pyopenvino_tpu_torch.config import Config, QuantMode
from pyopenvino_tpu_torch.ir import read_ir_model
from pyopenvino_tpu_torch.ir.builder import GraphBuilder
from pyopenvino_tpu_torch.models import op_graphs
from pyopenvino_tpu_torch.ops.spec import TValue
from pyopenvino_tpu_torch.parallel.pipeline import (
    PP_IN,
    PP_OUT,
    build_pipeline_mesh,
    choose_cuts,
    compile_pipelined,
    find_cut_candidates,
    partition,
)
from pyopenvino_tpu_torch.passes.fuse import find_fusions
from pyopenvino_tpu_torch.passes.shape_infer import infer_shapes
from pyopenvino_tpu_torch.runtime.compiler import CompiledNetwork, compile_model, prepare_model
from pyopenvino_tpu_torch.serving import InferenceServer
from test_torch_port_int8full import xla_fma_epilogue
from test_torch_port_ssd import check_records
import test_torch_port_threads  # noqa: F401  (this worker's torch threads)

RTOL, ATOL = 1e-4, 1e-5  # the JAX tests' bound; mnist_bn's TORCH-vs-XLA limit
FAMILY_RTOL, FAMILY_ATOL = 1e-3, 1e-5  # the families' TORCH-vs-XLA limit
MNIST = ("assets/trained/mnist_bn.xml", "assets/trained/mnist_bn.bin")
GOOGLENET = ("assets/trained/googlenet_shapes.xml", "assets/trained/googlenet_shapes.bin")
SSD = ("assets/trained/ssd_shapes_ms.xml", "assets/trained/ssd_shapes_ms.bin")
TRAINED = ("mnist_bn", "keras_digits", "torch_digits", "shapes_resnet", "googlenet_shapes",
           "shapes_ssd", "ssd_shapes_ms")
FAMILIES = ("vit-tiny", "unet", "ocr-ti")
IN = "conv2d_input"


@pytest.fixture(scope="module")
def family_paths(tmp_path_factory):
    """{name: (xml, bin)} of ViT-tiny, U-Net and ocr-ti from the builders
    and versions that __graft_entry__._model_paths uses, written by the JAX
    package's writer into a private directory."""
    import __graft_entry__
    from pyopenvino_tpu.ir.writer import write_ir_model

    out = {}
    for name in FAMILIES:
        xml = str(tmp_path_factory.mktemp(name) / f"{name}.xml")
        write_ir_model(__graft_entry__._programmatic_generators()[name][1](), xml)
        out[name] = (xml, xml[:-4] + ".bin")
    return out


def _paths(name, family_paths):
    if name in FAMILIES:
        return family_paths[name]
    return f"assets/trained/{name}.xml", f"assets/trained/{name}.bin"


def _blob(batch, shape=(1, 28, 28), seed=0):
    return np.random.default_rng(seed).uniform(0, 255, (batch,) + tuple(shape)).astype(np.float32)


def _calibration(name, shape, n=4):
    rng = np.random.default_rng(7)
    return [{name: rng.uniform(0, 255, (1,) + tuple(shape)).astype(np.float32)}
            for _ in range(n)]


def _port_pp(paths, stages, data=1, quant=QuantMode.NONE, samples=None, **config):
    return compile_pipelined(read_ir_model(*paths), build_pipeline_mesh(stages, data, "cpu"),
                             Config(quant=quant, **config), calibration_samples=samples)


def _jax_pp(paths, stages, data=1, quant=QuantMode.NONE, samples=None):
    return jax_pp.compile_pipelined(
        jax_read(*paths), jax_pp.build_pipeline_mesh(stages, data=data),
        JaxConfig(backend=JaxBackend.XLA, quant=JaxQuantMode(quant.value)),
        calibration_samples=samples)


def _plain(paths, quant=QuantMode.NONE, samples=None, **config):
    return compile_model(read_ir_model(*paths), Config(quant=quant, **config), device="cpu",
                         calibration_samples=samples)


def _prepared(paths, quant=QuantMode.NONE):
    """(the port's prepared model, the JAX package's), with analyses."""
    port = prepare_model(read_ir_model(*paths), Config(quant=quant))[0]
    jax = jax_prepare(jax_read(*paths), JaxConfig(backend=JaxBackend.XLA,
                                                  quant=JaxQuantMode(quant.value)))[0]
    return (port, infer_shapes(port)), (jax, jax_infer_shapes(jax))


def _close(got, want, rtol=RTOL, atol=ATOL):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=k)


def _equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def _parity(paths, stages, data=1, quant=QuantMode.NONE, batch=8, atol=ATOL, cal=False,
            jax_rtol=RTOL, jax_atol=ATOL, fma=None):
    """The port's pipelined network against its unsharded one (bit for bit
    under INT8-FULL) and against the JAX package's pipelined network."""
    model = read_ir_model(*paths)
    name = model.parameters[0].name
    shape = tuple(model.parameters[0].outputs[0].shape[1:])
    blob = _blob(batch, shape)
    samples = _calibration(name, shape) if cal else None
    ref = _plain(paths, quant, samples).infer_batch({name: blob})
    pp = _port_pp(paths, stages, data, quant, samples)
    out = pp.infer_batch({name: blob})
    if quant == QuantMode.INT8_FULL:
        _equal(out, ref)
    else:
        _close(out, ref, atol=atol)
    if fma is not None:
        xla_fma_epilogue(fma)
        out = pp.infer_batch({name: blob})
    _close(out, _jax_pp(paths, stages, data, quant, samples).infer_batch({name: blob}),
           jax_rtol, jax_atol)
    return pp


# -- partitioning ---------------------------------------------------------------


def test_cut_candidates_single_tensor_and_unfused():
    """Every candidate is a floating single-tensor articulation point never
    strictly inside a fusion group, and the candidates are the JAX
    package's."""
    (model, analysis), (jmodel, janalysis) = _prepared(MNIST)
    rt, cands = find_cut_candidates(model, analysis)
    assert cands, "mnist_bn must have at least one cut point"
    pos = {nid: i for i, nid in enumerate(rt)}
    interior = set()
    for f in find_fusions(model, analysis).values():
        ps = [pos[n] for n in (f.root,) + f.skip if n in pos]
        interior.update(range(min(ps), max(ps)))
    for c in cands:
        assert c.pos not in interior
        assert np.issubdtype(model.nodes[c.node_id].outputs[c.port].dtype, np.floating)
        for e in model.edges:
            if e.src in pos and e.dst in pos and pos[e.src] <= c.pos < pos[e.dst]:
                assert (e.src, e.src_port) == (c.node_id, c.port)
    jrt, jcands = jax_pp.find_cut_candidates(jmodel, janalysis)
    assert rt == jrt
    assert [tuple(vars(c).values()) for c in cands] == [tuple(vars(c).values()) for c in jcands]


def test_partition_is_a_cover():
    """Stage runtime nodes tile the runtime node set once; the boundary
    stages carry the synthetic Parameter / Result pairs; each stage holds
    the JAX package's node ids."""
    (model, analysis), (jmodel, janalysis) = _prepared(MNIST)
    rt, cuts = choose_cuts(model, analysis, 3)
    specs = partition(model, rt, cuts)
    jspecs = jax_pp.partition(jmodel, *jax_pp.choose_cuts(jmodel, janalysis, 3))
    assert len(specs) == len(jspecs) == 3
    seen = []
    for s, (spec, jspec) in enumerate(zip(specs, jspecs)):
        seen.extend(n.id for n in spec.model
                    if n.op_type not in ("Const", "Result") and n.name != PP_IN)
        names = {n.name for n in spec.model.nodes.values()}
        assert (PP_IN in names) == (s > 0)
        assert (PP_OUT in names) == (s < 2)
        assert sorted(spec.model.nodes) == sorted(jspec.model.nodes)
    assert sorted(seen) == sorted(rt)
    assert {r.name for r in specs[-1].model.results} >= {r.name for r in model.results}


def test_googlenet_cuts_land_on_block_boundaries():
    """The balanced DP cuts between inception blocks (Concat outputs) or at
    stem ops, never mid-block, on the JAX package's cut nodes."""
    (model, analysis), (jmodel, janalysis) = _prepared(GOOGLENET)
    _, cuts = choose_cuts(model, analysis, 4)
    assert len(cuts) == 3
    assert {model.nodes[c.node_id].op_type for c in cuts} <= {
        "Concat", "LRN", "MaxPool", "ReLU", "AvgPool"}
    _, jcuts = jax_pp.choose_cuts(jmodel, janalysis, 4)
    assert [(c.node_id, c.port) for c in cuts] == [(c.node_id, c.port) for c in jcuts]


def test_too_many_stages_is_a_clear_error():
    (model, analysis), (jmodel, janalysis) = _prepared(MNIST)
    with pytest.raises(ValueError, match="cut points"):
        choose_cuts(model, analysis, 64)
    with pytest.raises(ValueError, match="cut points"):
        jax_pp.choose_cuts(jmodel, janalysis, 64)


@pytest.mark.parametrize("name", TRAINED + FAMILIES)
def test_cuts_match_jax(name, family_paths):
    """The same cut nodes and ports as the JAX package at 2, 3 and 4
    stages, or the same refusal where that many cuts do not exist."""
    (model, analysis), (jmodel, janalysis) = _prepared(_paths(name, family_paths))
    for stages in (2, 3, 4):
        try:
            want = [(c.node_id, c.port) for c in jax_pp.choose_cuts(jmodel, janalysis, stages)[1]]
        except ValueError:
            with pytest.raises(ValueError, match="cut points"):
                choose_cuts(model, analysis, stages)
            continue
        assert [(c.node_id, c.port) for c in choose_cuts(model, analysis, stages)[1]] == want


@pytest.mark.parametrize("paths, stages, data, quant", [
    (MNIST, 3, 1, QuantMode.INT8_FULL),
    (GOOGLENET, 4, 2, QuantMode.INT8_WEIGHT),
])
def test_stage_submodels_match_jax(paths, stages, data, quant):
    """Under the same build_pipeline_mesh shape each stage holds the JAX
    package's runtime node ids and PP_IN / PP_OUT TensorInfos, and each of
    its weight keys is equal element for element (int8 codes and scales
    under INT8)."""
    model = read_ir_model(*paths)
    name = model.parameters[0].name
    samples = _calibration(name, model.parameters[0].outputs[0].shape[1:])
    port = _port_pp(paths, stages, data, quant, samples)
    jax = _jax_pp(paths, stages, data, quant, samples)
    assert port.n_stages == jax.n_stages == stages and port.data_ax == jax.data_ax == data
    assert [(c.node_id, c.port) for c in port.cuts] == [(c.node_id, c.port) for c in jax.cuts]
    for s, (net, jnet) in enumerate(zip(port.stages, jax.stages)):
        assert sorted(net.model.nodes) == sorted(jnet.model.nodes)
        for pp in (PP_IN, PP_OUT):
            node, jnode = net.model.find_by_name(pp), jnet.model.find_by_name(pp)
            assert (node is None) == (jnode is None)
            if node is not None:
                info = (node.outputs or node.inputs)[0]
                jinfo = (jnode.outputs or jnode.inputs)[0]
                assert (tuple(info.shape), info.dtype) == (tuple(jinfo.shape), jinfo.dtype)
        assert sorted(net.weights) == sorted(jnet.weights)
        for k, v in net.weights.items():
            assert np.array_equal(v.numpy(), np.asarray(jnet.weights[k])), (s, k)


# -- end-to-end parity ----------------------------------------------------------


def test_mnist_pp2():
    _parity(MNIST, 2)


def test_mnist_pp4_dp2():
    pp = _parity(MNIST, 4, data=2, batch=16)
    assert pp.n_stages == 4 and pp.data_ax == 2
    assert pp.mesh.shape == {"data": 2, "stage": 4}


def test_mnist_pp2_dp2_int8_weight():
    _parity(MNIST, 2, data=2, quant=QuantMode.INT8_WEIGHT)


def test_mnist_pp2_int8_full(monkeypatch):
    """INT8-FULL: quantization runs on the WHOLE graph before the cuts, so
    the pipelined output is bit-identical to the unsharded network; with
    XLA's epilogue rounding patched in, within 1e-4 / 1e-5 of the JAX
    package's pipelined network."""
    _parity(MNIST, 2, quant=QuantMode.INT8_FULL, cal=True, fma=monkeypatch)


def test_googlenet_pp4_dp2():
    """googlenet_shapes across (data=2, stage=4): heterogeneous inception
    stages, the cut tensor of each handed to the next."""
    _parity(GOOGLENET, 4, data=2, jax_rtol=FAMILY_RTOL, jax_atol=FAMILY_ATOL)


def test_explicit_n_micro_and_errors():
    pp = _port_pp(MNIST, 2, data=2)
    jax = _jax_pp(MNIST, 2, data=2)
    blob = _blob(8)
    ref = pp.infer_batch({IN: blob})
    out_name = pp.output_names[0]
    for n_micro in (1, 2, 4):  # the schedule does not move the answer
        np.testing.assert_allclose(pp.infer_batch({IN: blob}, n_micro=n_micro)[out_name],
                                   ref[out_name], rtol=1e-5, atol=1e-5)
    for net in (pp, jax):
        with pytest.raises(ValueError, match="microbatch"):
            net.infer_batch({IN: _blob(8)}, n_micro=3)  # 8 % 3 != 0
        with pytest.raises(ValueError):
            net.infer_batch({IN: _blob(7)})  # 7 rows over data = 2
    assert [pp._pick_n_micro(b) for b in (2, 8, 16, 64)] == [
        jax._pick_n_micro(b) for b in (2, 8, 16, 64)] == [1, 4, 4, 4]


def test_microbatch_order_preserved():
    """Row i of the batch is row i of every output."""
    pp = _port_pp(MNIST, 2)
    blob = _blob(8, seed=3)
    out = pp.infer_batch({IN: blob})[pp.output_names[0]]
    single = _plain(MNIST)
    for i in (0, 3, 7):
        one = single.infer_batch({IN: blob[i:i + 1]})[pp.output_names[0]]
        np.testing.assert_allclose(out[i], one[0], rtol=RTOL, atol=ATOL)


def test_vit_pp4(family_paths):
    """The transformer: ViT-tiny cut between attention blocks onto 4
    stages."""
    _parity(family_paths["vit-tiny"], 4, atol=1e-3, jax_rtol=FAMILY_RTOL,
            jax_atol=FAMILY_ATOL)


def test_unet_pp2_segmentation(family_paths):
    """U-Net's skip connections leave one articulation tensor: the 2-stage
    cut carries the full-resolution map."""
    pp = _parity(family_paths["unet"], 2, batch=4, jax_rtol=FAMILY_RTOL,
                 jax_atol=FAMILY_ATOL)
    assert len(pp.cuts) == 1


def test_ssd_pp2_detection():
    """SSD's ShapeOf → PriorBoxClustered anchor chains are copied into the
    stages that read them, fed by zero-Const shape stand-ins; the record
    table equals the unsharded network's within 1e-4 and the JAX package's
    pipelined network's by check_records."""
    model = read_ir_model(*SSD)
    name = model.parameters[0].name
    blob = _blob(4, model.parameters[0].outputs[0].shape[1:])
    ref = _plain(SSD).infer_batch({name: blob})
    pp = _port_pp(SSD, 2)
    out = pp.infer_batch({name: blob})
    _close(out, ref, atol=1e-4)
    want = _jax_pp(SSD, 2).infer_batch({name: blob})
    assert sorted(out) == sorted(want)
    for k in want:
        check_records(out[k], want[k])
    assert any(n.name.startswith("__pp_shape_") for net in pp.stages[1:]
               for n in net.model.nodes.values())


def _shape_out(b):
    rng = np.random.default_rng(0)
    x = b.parameter("in", (1, 4, 16, 16))
    w1 = rng.normal(0, 0.3, (8, 4, 3, 3)).astype(np.float32)
    y = b.relu(b.conv2d(x, b.const(w1), pads=((1, 1), (1, 1))))
    w2 = rng.normal(0, 0.3, (8, 8, 3, 3)).astype(np.float32)
    z = b.conv2d(y, b.const(w2), pads=((1, 1), (1, 1)))
    b.result(z, name="act_out")
    b.result(b.unary("ShapeOf", z), name="shape_out")
    return b.build()


def test_folded_producer_result_survives_partition():
    """A Result fed by a compile-time-folded producer (ShapeOf → Result)
    still comes out of the pipelined network, its declared value per
    example, as from the unsharded network and the JAX package's pipelined
    network."""
    blob = np.random.default_rng(0).normal(0, 1, (4, 4, 16, 16)).astype(np.float32)
    ref = compile_model(_shape_out(GraphBuilder("shape_out")), device="cpu").infer_batch(
        {"in": blob})
    pp = compile_pipelined(_shape_out(GraphBuilder("shape_out")),
                           build_pipeline_mesh(2, devices="cpu"))
    out = pp.infer_batch({"in": blob})
    want = jax_pp.compile_pipelined(_shape_out(JaxBuilder("shape_out")),
                                    jax_pp.build_pipeline_mesh(2)).infer_batch({"in": blob})
    assert set(out) == set(ref) == set(want) == {"act_out", "shape_out"}
    assert out["shape_out"].shape == (4, 4)
    np.testing.assert_array_equal(out["shape_out"], np.tile([1, 8, 16, 16], (4, 1)))
    _close(out, ref)
    _close(out, want)


def test_generator_calibration_samples_not_exhausted():
    """calibration_samples may be a one-shot generator though calibration
    and bias correction both read it, in compile_model and in
    compile_pipelined."""
    def gen():
        rng = np.random.default_rng(1)
        for _ in range(3):
            yield {IN: rng.uniform(0, 255, (1, 1, 28, 28)).astype(np.float32)}

    config = Config(quant=QuantMode.INT8_FULL, bias_correction=True)
    net = compile_model(read_ir_model(*MNIST), config, device="cpu", calibration_samples=gen())
    zeros = np.zeros((1, 1, 28, 28), np.float32)
    assert next(iter(net({IN: zeros}).values())).shape == (1, 10)
    pp = compile_pipelined(read_ir_model(*MNIST), build_pipeline_mesh(2, devices="cpu"), config,
                           calibration_samples=gen())
    _equal(pp.infer_batch({IN: _blob(4)}), net.infer_batch({IN: _blob(4)}))
    jax = jax_compile(jax_read(*MNIST), JaxConfig(backend=JaxBackend.XLA,
                                                  quant=JaxQuantMode.INT8_FULL,
                                                  bias_correction=True),
                      calibration_samples=gen())
    assert next(iter(jax({IN: zeros}).values())).shape == (1, 10)


def test_ocr_ti_pp2(family_paths):
    """The TensorIterator family: the TI nodes land whole inside a stage,
    which runs one example at a time (a batch-1 body cannot be baked)."""
    pp = _parity(family_paths["ocr-ti"], 2, jax_rtol=FAMILY_RTOL, jax_atol=FAMILY_ATOL)
    assert any(net._batched_plan(4) is None for net in pp.stages)


# -- serving ------------------------------------------------------------------


def test_served_pipelined_network():
    """A pipelined network behind the server: buckets rounded up to the
    'data' axis as the JAX package's server rounds them, answers as the
    unsharded network's direct infer, a lone request padded to 2."""
    ref_net = _plain(MNIST)
    pp = _port_pp(MNIST, 2, data=2)
    server = InferenceServer(pp, buckets=(1, 2, 4, 8), max_delay_ms=5.0)
    assert server.buckets == (2, 4, 8)
    assert JaxServer(_jax_pp(MNIST, 2, data=2), buckets=(1, 2, 4, 8)).buckets == server.buckets
    rng = np.random.default_rng(1)
    blobs = [rng.uniform(0, 255, (1, 1, 28, 28)).astype(np.float32) for _ in range(6)]
    ref = [ref_net({IN: b}) for b in blobs]
    with server:
        futs = [server.submit({IN: b}) for b in blobs]
        outs = [f.result(timeout=60) for f in futs]
    for got, want in zip(outs, ref):
        _close(got, want)
    with server.start():
        one = server.infer({IN: blobs[0]})
    _close(one, ref[0])
    assert server.stats.padded_slots >= 1


# -- the port's own schedule --------------------------------------------------


def test_schedule_reads_nothing_back_between_stages(monkeypatch):
    """No stage's output is read to the host before the last stage's last
    block is issued: torch.Tensor.cpu, .numpy and .item are wrapped for the
    call and every read falls after the last issue."""
    pp = _port_pp(MNIST, 3, data=2)
    rows = {IN: _blob(8)}
    want = pp.infer_batch(rows)
    events = []
    for net in pp.stages:
        real_on = net._batch_on

        def issued(inputs, b, walk=None, real_on=real_on):
            out = real_on(inputs, b, walk)
            events.append("issue")
            return out

        monkeypatch.setattr(net, "_batch_on", issued)
    for attr in ("cpu", "numpy", "item"):
        real = getattr(torch.Tensor, attr)

        def read(self, *a, real=real, **kw):
            events.append("read")
            return real(self, *a, **kw)

        monkeypatch.setattr(torch.Tensor, attr, read)
    got = pp.infer_batch(rows)
    monkeypatch.undo()
    _equal(got, want)
    last_issue = max(i for i, e in enumerate(events) if e == "issue")
    assert events.count("issue") == 3 * 4 * 2  # stages × microbatches × data
    assert "read" in events and "read" not in events[:last_issue]


@pytest.mark.parametrize("quant", [QuantMode.NONE, QuantMode.INT8_FULL])
def test_bf16_cut_tensor_handed_on_in_bf16(quant, monkeypatch):
    """Under bf16 compute the cut tensor reaches the next stage as the
    bfloat16 tensor the walk holds (declared float32, not widened and
    rounded again), and the answers equal the unsharded network's."""
    samples = _calibration(IN, (1, 28, 28)) if quant == QuantMode.INT8_FULL else None
    pp = _port_pp(MNIST, 3, quant=quant, samples=samples, compute_dtype="bfloat16")
    fed = []
    for net in pp.stages[1:]:
        real_on = net._batch_on

        def seen(inputs, b, walk=None, real_on=real_on):
            fed.append(inputs[PP_IN].dtype)
            return real_on(inputs, b, walk)

        monkeypatch.setattr(net, "_batch_on", seen)
    rows = {IN: _blob(8)}
    got = pp.infer_batch(rows)
    assert fed and set(fed) == {torch.bfloat16}
    assert all(net.model.find_by_name(PP_IN).outputs[0].dtype == np.float32
               for net in pp.stages[1:])
    _equal(got, _plain(MNIST, quant, samples, compute_dtype="bfloat16").infer_batch(rows))


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_cut_on_an_int8_edge_keeps_the_codes(compute_dtype):
    """A cut on an edge that the whole INT8-FULL network stores as int8
    (mnist_bn's MaxPool output, read only by the next conv): the stage
    hands it on as float, and the next stage's conv quantizes it on read to
    the codes the whole network stores (max commutes with the monotone
    quantizer)."""
    samples = _calibration(IN, (1, 28, 28))
    whole = _plain(MNIST, QuantMode.INT8_FULL, samples, compute_dtype=compute_dtype)
    pp = _port_pp(MNIST, 3, quant=QuantMode.INT8_FULL, samples=samples,
                  compute_dtype=compute_dtype)
    on_int8 = [c for c in pp.cuts if (c.node_id, c.port) in whole._int8_edges]
    assert on_int8, "no cut on an int8-stored edge"
    cut = on_int8[0]
    scale = whole._int8_edges[cut.node_id, cut.port]
    stage = next(s for s, c in enumerate(pp.cuts) if c == cut)
    assert (cut.node_id, cut.port) not in pp.stages[stage]._int8_edges
    image = _blob(1)
    name = whole.model.nodes[cut.node_id].name
    stored = whole.capture_activations({IN: image}, [name])[name]
    feed = {IN: image}
    for net in pp.stages[:stage + 1]:
        out = net._run(net.model, net.analysis, feed)[0]
        feed = {PP_IN: out[PP_OUT]}
    codes = TValue.quantize(out[PP_OUT], scale)
    np.testing.assert_array_equal((codes.float() * scale).numpy(), stored)
    _equal(pp.infer_batch({IN: _blob(8)}), whole.infer_batch({IN: _blob(8)}))


def test_stateful_network_refused():
    for builder, part in ((GraphBuilder, partition), (JaxBuilder, jax_pp.partition)):
        model, _ = op_graphs.build(builder, "lstm_stream", width=16)
        with pytest.raises(NotImplementedError, match="stateful"):
            part(model, [], [])


def test_default_devices_one_card(monkeypatch):
    """The default devices are the visible cards: on a machine with one,
    any pipeline mesh of more than one device raises (no mesh shrinks to
    the devices there are); logical shards of the card are named
    explicitly."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert build_pipeline_mesh(1).devices.flat[0] == torch.device("cuda", 0)
    for stages, data in ((2, 1), (1, 2), (2, 2), (4, 1)):
        with pytest.raises(ValueError, match="have 1"):
            build_pipeline_mesh(stages, data)
    mesh = build_pipeline_mesh(2, data=2, devices=[torch.device("cuda:0")] * 4)
    assert mesh.shape == {"data": 2, "stage": 2} and mesh.axis_names == ("data", "stage")
    assert {str(d) for d in mesh.devices.flat} == {"cuda:0"}
    cpu = build_pipeline_mesh(4, data=2, devices="cpu")
    assert cpu.shape == dict(jax_pp.build_pipeline_mesh(4, data=2).shape)
    with pytest.raises(ValueError, match="needs 16 devices, have 8"):
        build_pipeline_mesh(4, data=4, devices="cpu")


def test_stage_weights_one_copy_a_device():
    """Logical shards of one device share each stage's own weights: no
    stage makes a copy for its other replicas."""
    pp = _port_pp(MNIST, 2, data=2)
    pp.infer_batch({IN: _blob(8)})
    for s, net in enumerate(pp.stages):
        assert list(net.mesh.devices.flat) == list(pp.mesh.devices[:, s])
        assert net._placed == {}


def test_parallel_all():
    from pyopenvino_tpu import parallel as jax_parallel

    assert parallel.__all__ == jax_parallel.__all__
    assert parallel.PipelinedNetwork is parallel.pipeline.PipelinedNetwork
    assert isinstance(_port_pp(MNIST, 2).stages[0], CompiledNetwork)
