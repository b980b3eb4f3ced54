"""The port's export/import (``pyopenvino_tpu_torch/runtime/export.py``) and
``CACHE_DIR`` (``runtime/cache.py``) against the JAX package's.

Every case of ``tests/test_cache.py`` and of ``tests/test_export.py`` but
the two sharded ones runs here on in-repo IRs with seeded inputs
(``assets/trained/mnist_bn``, ``shapes_resnet``, and the stateful graphs
of ``test_torch_port_state.py``): the round trip at B = 1 and at batches
never named at export, the artifact imported in a subprocess after the
user's ``.xml``/``.bin`` are gone, INT8-FULL, the 1.0 and 2.0 spellings,
the refusals, the stateful artifacts.  Beyond them:

  * an imported network answers the exporter's bits in FP32, INT8
    weight-only and INT8-FULL, float32 and bfloat16, TORCH and KERNELS, at
    B = 1 and through ``infer_batch``, with the same weight keys, fusions
    and int8 edges, and the u8 bf16 INT8-FULL ResNet-18 (bench.py's
    headline) at full width;
  * for the same IR, config and samples, the port's ``weights.npz`` has the
    JAX artifact's keys, int8 codes and scales equal, floats within 1e-6,
    and ``meta.json``'s io fields equal; each package's ``save_weights``
    file loads into the other's ``load_weights``;
  * neither an import nor a CACHE_DIR hit runs ``prepare_model``,
    quantization, calibration or bias correction (each patched to raise);
  * a changed sample or config field misses the cache, a second read of the
    same files hits."""

import json
import os
import shutil
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch

from pyopenvino_tpu.config import Backend as JaxBackend
from pyopenvino_tpu.config import Config as JaxConfig
from pyopenvino_tpu.config import QuantMode as JaxQuantMode
from pyopenvino_tpu.ir import read_ir_model as jax_read
from pyopenvino_tpu.runtime.compiler import compile_model as jax_compile_model

from pyopenvino_tpu_torch import Core, IECore, PrePostProcessor
from pyopenvino_tpu_torch.config import Backend, Config, QuantMode
from pyopenvino_tpu_torch.ir import read_ir_model
from pyopenvino_tpu_torch.ir.builder import GraphBuilder
from pyopenvino_tpu_torch.models.synth import resnet18_paths
from pyopenvino_tpu_torch.runtime import cache as cache_mod
from pyopenvino_tpu_torch.runtime.cache import cache_entries, cache_key, disable_model_cache
from pyopenvino_tpu_torch.runtime.compiler import compile_model
from pyopenvino_tpu_torch.runtime.export import FORMAT_VERSION, import_compiled
from test_torch_port_state import dynamic_init_model, ema_model
import test_torch_port_threads  # noqa: F401  (this worker's torch threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MNIST = tuple(os.path.join(REPO, "assets", "trained", f"mnist_bn.{e}") for e in ("xml", "bin"))
RESNET = tuple(os.path.join(REPO, "assets", "trained", f"shapes_resnet.{e}")
               for e in ("xml", "bin"))
IN = "conv2d_input"
# mnist_bn, TORCH (CPU) against XLA (CPU): float32 sums in another order
OUT_RTOL, OUT_ATOL = 1e-4, 1e-5
MODES = {"none": (QuantMode.NONE, JaxQuantMode.NONE),
         "int8w": (QuantMode.INT8_WEIGHT, JaxQuantMode.INT8_WEIGHT),
         "int8": (QuantMode.INT8_FULL, JaxQuantMode.INT8_FULL)}
# the steps of prepare_model and the calibration: an import must reach none
PASSES = ("pyopenvino_tpu_torch.runtime.compiler.prepare_model",
          "pyopenvino_tpu_torch.passes.calibrate.calibrate_activations",
          "pyopenvino_tpu_torch.passes.quantize.quantize_weights",
          "pyopenvino_tpu_torch.passes.bias_correct.bias_corrections",
          "pyopenvino_tpu_torch.passes.fold_scale.fold_scale_into_conv",
          "pyopenvino_tpu_torch.passes.fold_fq.fold_fake_quantize",
          "pyopenvino_tpu_torch.passes.util.prune_dead_nodes")


def _images(n, seed, shape=(1, 1, 28, 28)):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 255, shape).astype(np.float32) for _ in range(n)]


def _samples(n, seed, name=IN, shape=(1, 1, 28, 28)):
    return [{name: x} for x in _images(n, seed, shape)]


def _forbid_passes(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("a pass or a calibration ran")
    for target in PASSES:
        monkeypatch.setattr(target, refuse)


def _equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture
def cache_off():
    """Every test leaves the process-wide CACHE_DIR off."""
    yield
    disable_model_cache()


@pytest.fixture(scope="module")
def mnist_export(tmp_path_factory):
    net = compile_model(read_ir_model(*MNIST), Config(), device="cpu")
    path = str(tmp_path_factory.mktemp("export") / "mnist.ovpt")
    net.export(path)
    return net, path


# -- tests/test_export.py ----------------------------------------------------------

def test_roundtrip_b1_and_any_batch(mnist_export):
    net, path = mnist_export
    imp = import_compiled(path, device="cpu")
    assert imp.meta["format_version"] == FORMAT_VERSION
    assert imp.input_names == net.input_names == [IN]
    assert imp.output_names == net.output_names
    assert imp.network.device.type == "cpu"
    jax = jax_compile_model(jax_read(*MNIST), JaxConfig(backend=JaxBackend.XLA))
    x = _images(1, 0)[0]
    got = imp.infer({IN: x})
    _equal(got, net.infer({IN: x}))
    _equal(imp({IN: x}), got)
    want = jax.infer({IN: x})
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=OUT_RTOL, atol=OUT_ATOL)
    # batches never named at export
    for b in (3, 7):
        batch = np.concatenate(_images(b, b))
        gb = imp.infer_batch({IN: batch})
        _equal(gb, net.infer_batch({IN: batch}))
        wb = jax.infer_batch({IN: batch})
        for k in wb:
            assert gb[k].shape == wb[k].shape and gb[k].shape[0] == b
            np.testing.assert_allclose(gb[k], wb[k], rtol=OUT_RTOL, atol=OUT_ATOL)


def test_artifact_is_self_contained(tmp_path):
    """The user's .xml/.bin removed, a subprocess imports the artifact
    with every pass patched to raise, and answers the exporter's bits."""
    xml, binp = (str(tmp_path / "m.xml"), str(tmp_path / "m.bin"))
    shutil.copy(MNIST[0], xml)
    shutil.copy(MNIST[1], binp)
    cal = _samples(3, 1)
    net = compile_model(read_ir_model(xml, binp), Config(quant=QuantMode.INT8_FULL),
                        device="cpu", calibration_samples=cal)
    path = str(tmp_path / "m.ovpt")
    net.export(path)
    os.remove(xml)
    os.remove(binp)
    x = _images(1, 2)[0]
    np.save(tmp_path / "x.npy", x)
    np.savez(tmp_path / "want.npz", **net.infer({IN: x}))
    script = (
        "import sys, numpy as np\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import importlib\n"
        f"for target in {PASSES!r}:\n"
        "    mod, fn = target.rsplit('.', 1)\n"
        "    def refuse(*a, **k):\n"
        "        raise AssertionError('a pass ran')\n"
        "    setattr(importlib.import_module(mod), fn, refuse)\n"
        "from pyopenvino_tpu_torch import IECore\n"
        "imp = IECore().import_network('m.ovpt', 'CPU')\n"
        "out = imp.infer({'conv2d_input': np.load('x.npy')})\n"
        "want = np.load('want.npz')\n"
        "assert sorted(out) == sorted(want.files)\n"
        "assert all(np.array_equal(out[k], want[k]) for k in want.files)\n"
        "assert 'jax' not in sys.modules\n"
        "print('OK')\n")
    r = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                       cwd=str(tmp_path), timeout=240)
    assert r.returncode == 0, r.stderr
    assert "OK" in r.stdout
    assert sorted(os.listdir(tmp_path)) == ["m.ovpt", "want.npz", "x.npy"]


def test_int8_full_roundtrip(tmp_path, monkeypatch):
    cal = _samples(4, 0)
    net = compile_model(read_ir_model(*MNIST), Config(quant=QuantMode.INT8_FULL),
                        device="cpu", calibration_samples=cal)
    path = str(tmp_path / "mnist8.ovpt")
    net.export(path)
    _forbid_passes(monkeypatch)
    imp = import_compiled(path, device="cpu")
    # int8 codes and their scale vectors survive the round trip
    assert any(v.dtype == torch.int8 for v in imp.weights.values())
    assert imp.network.act_scales == net.act_scales
    x = _images(1, 3)[0]
    _equal(imp.infer({IN: x}), net.infer({IN: x}))


def test_import_loads_the_exported_weights(tmp_path):
    """The artifact's weights.npz, not a rebuild from the model, is what the
    imported network runs: a weight changed after compile travels."""
    net = compile_model(read_ir_model(*MNIST), Config(), device="cpu")
    key = next(k for k, v in net.weights.items() if v.dim() == 4)
    net.weights[key] = net.weights[key] * 1.5
    path = str(tmp_path / "changed.ovpt")
    net.export(path)
    imp = import_compiled(path, device="cpu")
    assert torch.equal(imp.weights[key], net.weights[key])
    x = _images(1, 14)[0]
    _equal(imp.infer({IN: x}), net.infer({IN: x}))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_artifact_holds_each_weight_once(tmp_path, mode):
    """A float32 network's artifact holds the weights once, in weights.npz:
    model.bin's copies of the Consts that only running ops read are zeros,
    deflated, and the import puts them back, exactly (FP32) or as the codes
    times the scales (INT8), so verify_against_interpreter sees the values
    the network computes with."""
    quant = MODES[mode][0]
    model = read_ir_model(*RESNET)
    p = model.parameters[0]
    name, shape = p.name, p.outputs[p.out_port].shape
    cal = _samples(2, 30, name, shape) if quant == QuantMode.INT8_FULL else None
    net = compile_model(model, Config(quant=quant), device="cpu", calibration_samples=cal)
    path = str(tmp_path / "r.ovpt")
    net.export(path)
    with zipfile.ZipFile(path) as zf:
        meta = json.loads(zf.read("meta.json"))
        sizes = {i.filename: i.compress_size for i in zf.infolist()}
    assert meta["weight_only_consts"]
    assert sizes["model.bin"] < 0.02 * os.path.getsize(RESNET[1])
    assert os.path.getsize(path) < sum(sizes.values()) + 4096
    imp = import_compiled(path, device="cpu").network
    for nid in meta["weight_only_consts"]:
        got = imp.model.nodes[nid].const
        if nid in net._quantized:
            codes, scales = net._quantized[nid]
            np.testing.assert_array_equal(got, codes.astype(np.float32) * scales)
        else:
            np.testing.assert_array_equal(got, net.model.nodes[nid].const)
    for node in net.model.find_by_type("Const"):
        if node.id not in meta["weight_only_consts"]:
            np.testing.assert_array_equal(imp.model.nodes[node.id].const, node.const)
    x = _images(1, 31, shape)[0]
    if quant == QuantMode.NONE:
        assert imp.verify_against_interpreter({name: x}) == net.verify_against_interpreter(
            {name: x})


def test_api_facades(tmp_path, cache_off):
    x = _images(1, 4)[0]
    # 1.0 spelling
    ie = IECore()
    exe = ie.load_network(ie.read_network(*MNIST), "CPU")
    p1 = str(tmp_path / "a.ovpt")
    exe.export(p1)
    imp = ie.import_network(p1, "CPU")
    out = imp.infer({IN: x})
    _equal(out, exe.infer({IN: x}))
    # 2.0 spelling
    core = Core()
    compiled = core.compile_model(core.read_model(*MNIST), "CPU")
    p2 = str(tmp_path / "b.ovpt")
    compiled.export_model(p2)
    _equal(core.import_model(p2, "CPU").infer({IN: x}), out)
    # the card unless the caller names the CPU
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ie.import_network(p1)
        with pytest.raises(RuntimeError, match="CUDA"):
            core.import_model(p2)


def test_interpreter_backend_refuses_export(tmp_path):
    ie = IECore()
    exe = ie.load_network(ie.read_network(*MNIST), "CPU")
    exe.kernel_type = "numpy"
    with pytest.raises(ValueError, match="interpreter"):
        exe.export(str(tmp_path / "x.ovpt"))


def test_import_errors(mnist_export, tmp_path):
    _, path = mnist_export
    # a missing member fails loudly
    for member in ("weights.npz", "model.xml", "prepared.npz"):
        broken = str(tmp_path / f"no_{member}.ovpt")
        with zipfile.ZipFile(path) as src, zipfile.ZipFile(broken, "w") as dst:
            for name in src.namelist():
                if name != member:
                    dst.writestr(name, src.read(name))
        with pytest.raises(KeyError):
            import_compiled(broken, device="cpu")
    # a newer format version
    newer = str(tmp_path / "newer.ovpt")
    with zipfile.ZipFile(path) as src, zipfile.ZipFile(newer, "w") as dst:
        for name in src.namelist():
            data = src.read(name)
            if name == "meta.json":
                meta = json.loads(data)
                meta["format_version"] = FORMAT_VERSION + 1
                data = json.dumps(meta)
            dst.writestr(name, data)
    with pytest.raises(ValueError, match="newer"):
        import_compiled(newer, device="cpu")
    # a wrong input name fails with the Parameter's name
    imp = import_compiled(path, device="cpu")
    with pytest.raises(KeyError, match=IN):
        imp.infer({"wrong_name": np.zeros((1, 1, 28, 28), np.float32)})


def test_jax_artifact_refused(tmp_path):
    """The JAX package's .ovtpu (StableHLO) is not the port's format."""
    jpath = str(tmp_path / "mnist.ovtpu")
    jax_compile_model(jax_read(*MNIST), JaxConfig(backend=JaxBackend.XLA)).export(jpath)
    with pytest.raises(ValueError, match="not a pyopenvino_tpu_torch artifact"):
        import_compiled(jpath, device="cpu")


def test_stateful_export_roundtrip(tmp_path):
    """A stateful network's artifact threads its state, resets and answers
    query_state; its initial state is the prepared graph's ReadValue init;
    infer_batch refuses, as the live network does."""
    from test_torch_port_state import jax_compile

    rng = np.random.default_rng(11)
    seq = [rng.standard_normal((1, 3)).astype(np.float32) for _ in range(4)]
    net = compile_model(ema_model(GraphBuilder), device="cpu")
    path = str(tmp_path / "ema.ovpt")
    net.export(path)
    imp = import_compiled(path, device="cpu")
    assert imp.stateful and imp.meta["stateful"]
    assert imp.meta["variables"] == {"ema": {"shape": [1, 3], "dtype": "float32",
                                             "dynamic_init": False}}
    from pyopenvino_tpu.ir.builder import GraphBuilder as JaxGraphBuilder

    ref, jref = compile_model(ema_model(GraphBuilder), device="cpu"), jax_compile(
        ema_model(JaxGraphBuilder))
    for x in seq:
        got = imp.infer({"x": x})["out"]
        np.testing.assert_array_equal(got, ref.infer({"x": x})["out"])
        np.testing.assert_allclose(got, jref.infer({"x": x})["out"], rtol=1e-5, atol=1e-6)
    st = imp.query_state()
    assert st["ema"].shape == (1, 3) and np.abs(st["ema"]).max() > 0
    imp.reset_state()
    np.testing.assert_allclose(imp.infer({"x": seq[0]})["out"], 0.25 * seq[0],
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(NotImplementedError, match="declared shapes"):
        imp.infer_batch({"x": np.zeros((4, 3), np.float32)})

    # a dynamic init: the first imported call reads it, as the live network
    dyn = compile_model(dynamic_init_model(GraphBuilder), device="cpu")
    dpath = str(tmp_path / "dyn.ovpt")
    dyn.export(dpath)
    dimp = import_compiled(dpath, device="cpu")
    x4 = np.concatenate([seq[0], seq[0][:, :1]], axis=1)
    np.testing.assert_allclose(dimp.infer({"x": x4})["out"], 3 * x4, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dimp.infer({"x": x4})["out"], 4 * x4, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("stateful", [False, True])
def test_sharded_export_refused(tmp_path, stateful):
    """What a network on a mesh (parallel/mesh.py) refuses: a stateful one
    refuses to export, with the JAX package's NotImplementedError
    (tests/test_export.py::test_stateful_sharded_export_refused); a
    stateless one exports, and its import onto fewer devices than the mesh
    holds raises with the JAX package's message.  The round trip itself is
    in test_torch_port_distributed.py."""
    from pyopenvino_tpu_torch.parallel import MeshConfig, build_mesh, shard_compiled

    model = (ema_model(GraphBuilder) if stateful else read_ir_model(*MNIST))
    net = compile_model(model, device="cpu")
    shard_compiled(net, build_mesh(MeshConfig(data=2), "cpu"))
    path = str(tmp_path / "x.ovpt")
    if stateful:
        with pytest.raises(NotImplementedError, match="stateful \\+ sharded"):
            net.export(path)
        return
    net.export(path)
    with pytest.raises(ValueError, match="sharded artifact needs 2 devices .*have 1"):
        import_compiled(path, device="cpu", devices=["cpu"])


# -- tests/test_cache.py -----------------------------------------------------------

def test_cache_dir_populates_and_serves(tmp_path, monkeypatch, cache_off):
    cache = str(tmp_path / "blob_cache")
    core = Core()
    core.set_property({"CACHE_DIR": cache})
    net = core.read_model(*MNIST)
    compiled = core.compile_model(net, "CPU")
    x = _images(1, 5)[0]
    out1 = compiled({IN: x})
    entries = cache_entries(cache)
    assert len(entries) == 1 and entries[0].endswith(cache_mod.SUFFIX)
    # a fresh compile of a fresh read is served from disk, with no pass
    _forbid_passes(monkeypatch)
    compiled2 = Core().compile_model(Core().read_model(*MNIST), "CPU")
    _equal(compiled2({IN: x}), out1)
    assert cache_entries(cache) == entries
    want = jax_compile_model(jax_read(*MNIST), JaxConfig(backend=JaxBackend.XLA)).infer({IN: x})
    for k in want:
        np.testing.assert_allclose(out1[k], want[k], rtol=OUT_RTOL, atol=OUT_ATOL)


def test_cache_key_covers_the_code(tmp_path, monkeypatch, cache_off):
    """The key holds a digest of the package's source: a changed pass gives
    another digest, and under another digest the same model, config and
    samples miss and calibrate again."""
    copy = tmp_path / "pkg"
    shutil.copytree(cache_mod.PACKAGE_DIR, copy,
                    ignore=shutil.ignore_patterns("__pycache__", "*.pyc"))
    assert cache_mod.source_digest(str(copy)) == cache_mod.code_digest()
    with open(copy / "passes" / "calibrate.py", "a") as f:
        f.write("\n# a changed pass\n")
    changed = cache_mod.source_digest(str(copy))
    assert changed != cache_mod.code_digest()

    import pyopenvino_tpu_torch.passes.calibrate as calibrate

    calls = []
    real = calibrate.calibrate_activations
    monkeypatch.setattr(calibrate, "calibrate_activations",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    ie = IECore()
    ie.set_config({"CACHE_DIR": str(tmp_path / "cache")})
    cfg, cal, x = Config(quant=QuantMode.INT8_FULL), _samples(2, 32), _images(1, 33)[0]

    def answer():
        exe = ie.load_network(ie.read_network(*MNIST), "CPU", config=cfg)
        exe.set_calibration(cal)
        return exe.infer({IN: x})

    first = answer()
    _equal(answer(), first)
    assert len(calls) == 1
    monkeypatch.setattr(cache_mod, "code_digest", lambda: changed)
    _equal(answer(), first)
    assert len(calls) == 2 and len(cache_entries(str(tmp_path / "cache"))) == 2


def test_damaged_cache_entry_is_a_miss(tmp_path, monkeypatch, cache_off):
    """An entry that does not import (a truncated file) is compiled again,
    with a warning, and rewritten whole: the next compile imports it."""
    cache = str(tmp_path / "cache")
    IECore().set_config({"CACHE_DIR": cache})
    x = _images(1, 34)[0]
    want = Core().compile_model(Core().read_model(*MNIST), "CPU")({IN: x})
    (entry,) = cache_entries(cache)
    with open(entry, "r+b") as f:
        f.truncate(os.path.getsize(entry) // 2)
    with pytest.warns(UserWarning, match="does not import"):
        got = Core().compile_model(Core().read_model(*MNIST), "CPU")({IN: x})
    _equal(got, want)
    assert cache_entries(cache) == [entry]
    _forbid_passes(monkeypatch)
    _equal(Core().compile_model(Core().read_model(*MNIST), "CPU")({IN: x}), want)


def test_unknown_config_key_fails_fast():
    with pytest.raises(ValueError, match="unsupported config key"):
        IECore().set_config({"NOT_A_KEY": 1})
    with pytest.raises(ValueError, match="unsupported config key"):
        Core().compile_model(Core().read_model(*MNIST), "CPU", {"NOT_A_KEY": 1})


def test_get_config_get_property_roundtrip(tmp_path, cache_off):
    """ie.get_config / core.get_property read CACHE_DIR back, and the 2.0
    get_property also answers the device metrics."""
    ie = IECore()
    path = str(tmp_path / "cache")
    assert ie.get_config("CPU", "CACHE_DIR") == ""
    ie.set_config({"CACHE_DIR": path})
    assert ie.get_config("CPU", "CACHE_DIR") == os.path.abspath(path)
    assert os.path.isdir(path)
    core = Core()
    assert core.get_property("CPU", "CACHE_DIR") == os.path.abspath(path)
    assert core.get_property("CPU", "AVAILABLE_DEVICES") == ["0"]
    assert "CPU" in core.get_property("CPU", "FULL_DEVICE_NAME").upper()
    ie.set_config({"CACHE_DIR": ""})
    assert ie.get_config("CPU", "CACHE_DIR") == ""
    with pytest.raises(ValueError, match="unsupported"):
        ie.get_metric("CPU", "NOT_A_METRIC")
    with pytest.raises(ValueError, match="unsupported"):
        ie.get_config("CPU", "NOT_A_KEY")
    # a properties dict in compile_model goes to set_property
    core.compile_model(core.read_model(*MNIST), "CPU", {"CACHE_DIR": path})
    assert core.get_property("CPU", "CACHE_DIR") == os.path.abspath(path)


def test_cache_key_misses_on_a_changed_sample_or_field(tmp_path, monkeypatch, cache_off):
    """The key changes with any config field or calibration sample, and not
    between two reads of the same files; a miss compiles and calibrates, a
    hit does neither."""
    model = read_ir_model(*MNIST)
    cfg = Config(quant=QuantMode.INT8_FULL)
    cal = _samples(3, 6)
    key = cache_key(model, cfg, cal)
    assert cache_key(read_ir_model(*MNIST), cfg, _samples(3, 6)) == key
    moved = [dict(s) for s in cal]
    moved[1] = {IN: cal[1][IN].copy()}
    moved[1][IN][0, 0, 3, 3] += 1.0
    assert cache_key(model, cfg, moved) != key
    assert cache_key(model, cfg, cal[:2]) != key
    for field, value in (("calibration_percentile", 99.9), ("compute_dtype", "bfloat16"),
                         ("backend", Backend.KERNELS), ("int8_dataflow", False),
                         ("bias_correction", True), ("quant_min_elems", 16),
                         ("depthwise_mode", "shifted_mac"), ("batch_buckets", (1, 4)),
                         ("calibration_method", "kl"), ("quant", QuantMode.INT8_WEIGHT)):
        assert cache_key(model, cfg.replace(**{field: value}), cal) != key, field

    import pyopenvino_tpu_torch.passes.calibrate as calibrate

    calls = []
    real = calibrate.calibrate_activations
    monkeypatch.setattr(calibrate, "calibrate_activations",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    ie = IECore()
    ie.set_config({"CACHE_DIR": str(tmp_path)})

    def answer(samples, config=cfg):
        exe = ie.load_network(ie.read_network(*MNIST), "CPU", config=config)
        exe.set_calibration(samples)
        return exe.infer({IN: _images(1, 7)[0]})

    first = answer(cal)
    assert len(calls) == 1 and len(cache_entries(str(tmp_path))) == 1
    _equal(answer(_samples(3, 6)), first)          # the same files: a hit
    assert len(calls) == 1
    answer(moved)                                  # a changed sample: a miss
    assert len(calls) == 2 and len(cache_entries(str(tmp_path))) == 2
    answer(cal, cfg.replace(calibration_percentile=99.9))
    assert len(calls) == 3 and len(cache_entries(str(tmp_path))) == 3


# -- import against export, every mode ---------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_import_equals_export(tmp_path, monkeypatch, mode, dtype):
    """mnist_bn on TORCH and KERNELS and shapes_resnet on KERNELS: the
    imported network has the exporter's weight keys, fusions and int8
    edges, and answers its bits at B = 1 and through infer_batch."""
    quant = MODES[mode][0]
    nets = []
    for paths, backends in ((MNIST, ("torch", "kernels")), (RESNET, ("kernels",))):
        model = read_ir_model(*paths)
        p = model.parameters[0]
        name, shape = p.name, p.outputs[p.out_port].shape
        cal = _samples(3, 8, name, shape) if quant == QuantMode.INT8_FULL else None
        for backend in backends:
            net = compile_model(model, Config(quant=quant, compute_dtype=dtype,
                                              backend=Backend(backend)),
                                device="cpu", calibration_samples=cal)
            path = str(tmp_path / f"{len(nets)}.ovpt")
            net.export(path)
            nets.append((net, path, name, shape))
    _forbid_passes(monkeypatch)
    for i, (net, path, name, shape) in enumerate(nets):
        imp = import_compiled(path, device="cpu").network
        assert sorted(imp.weights) == sorted(net.weights)
        for k, w in net.weights.items():
            assert imp.weights[k].dtype == w.dtype and torch.equal(imp.weights[k], w), k
        assert imp._fusions == net._fusions and imp._int8_edges == net._int8_edges
        assert imp.act_scales == net.act_scales and imp.config == net.config
        x = _images(1, 9 + i, shape)[0]
        _equal(imp.infer({name: x}), net.infer({name: x}))
        batch = np.concatenate(_images(5, 20 + i, shape))
        _equal(imp.infer_batch({name: batch}), net.infer_batch({name: batch}))


def test_import_equals_export_resnet18_headline(tmp_path, monkeypatch, cache_off):
    """bench.py's headline at full width on the CPU: u8 ingress
    (PrePostProcessor), INT8-FULL, bfloat16, KERNELS, through CACHE_DIR and
    export_model / import_model; the PrePostProcessor nodes survive the
    writer and the bits are the exporter's."""
    core = Core()
    core.set_property({"CACHE_DIR": str(tmp_path / "cache")})

    def headline():
        ppp = PrePostProcessor(core.read_model(*resnet18_paths(seed=0)))
        ppp.input().tensor().set_element_type("u8")
        return ppp.build()

    rng = np.random.default_rng(10)
    u8 = rng.integers(0, 256, (4, 3, 224, 224), dtype=np.uint8)
    cfg = Config(backend=Backend.KERNELS, quant=QuantMode.INT8_FULL,
                 compute_dtype="bfloat16")
    compiled = core.compile_model(headline(), "CPU", cfg)
    compiled._exe.set_calibration([{"data": u8[i:i + 1]} for i in range(2)])
    want = compiled({"data": u8[2:3]})
    path = str(tmp_path / "headline.ovpt")
    compiled.export_model(path)
    assert {n.op_type for n in import_compiled(path, "cpu").network.model} >= {"Convert"}
    _forbid_passes(monkeypatch)
    for imported in (core.import_model(path, "CPU"),
                     core.compile_model(headline(), "CPU", cfg)._exe):
        if hasattr(imported, "set_calibration"):
            imported.set_calibration([{"data": u8[i:i + 1]} for i in range(2)])
        _equal(imported.infer({"data": u8[2:3]}), want)
        got = imported.infer_batch({"data": u8[2:4]})
        np.testing.assert_array_equal(got[next(iter(got))][:1], want[next(iter(want))])


# -- the port's artifact against the JAX package's ---------------------------------

def _artifact(path):
    with zipfile.ZipFile(path) as zf:
        meta = json.loads(zf.read("meta.json"))
        with np.load(zf.open("weights.npz")) as data:
            weights = {k: np.array(data[k]) for k in data.files}
    return meta, weights


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_weights_and_io_match_the_jax_artifact(tmp_path, mode, dtype):
    quant, jquant = MODES[mode]
    cal = _samples(3, 12) if quant == QuantMode.INT8_FULL else None
    compile_model(read_ir_model(*MNIST), Config(quant=quant, compute_dtype=dtype),
                  device="cpu", calibration_samples=cal).export(str(tmp_path / "p.ovpt"))
    jax_compile_model(jax_read(*MNIST), JaxConfig(backend=JaxBackend.XLA, quant=jquant,
                                                  compute_dtype=dtype),
                      calibration_samples=cal).export(str(tmp_path / "j.ovtpu"))
    meta, weights = _artifact(str(tmp_path / "p.ovpt"))
    jmeta, jweights = _artifact(str(tmp_path / "j.ovtpu"))
    assert sorted(weights) == sorted(jweights)
    assert (meta["inputs"], meta["outputs"]) == (jmeta["inputs"], jmeta["outputs"])
    for k, want in jweights.items():
        got = weights[k]
        assert got.dtype == want.dtype and got.shape == want.shape, k
        if want.dtype == np.int8 or k.endswith(".scale") or k.endswith(".scale::bf16"):
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            if k.endswith("::bf16"):
                got, want = (a.astype(np.uint32) << 16 for a in (got, want))
                got, want = got.view(np.float32), want.view(np.float32)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=k)
    if quant != QuantMode.NONE:
        assert any(w.dtype == np.int8 for w in weights.values())
    assert {k: v for k, v in meta["config"].items() if k in jmeta["config"]
            and k not in ("backend",)} == {k: v for k, v in jmeta["config"].items()
                                          if k in meta["config"] and k != "backend"}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_save_weights_moves_between_packages(tmp_path, dtype):
    """An INT8 weight-only checkpoint of either package loads into the
    other's load_weights and gives the answers of the network that wrote it."""
    cfg = Config(quant=QuantMode.INT8_WEIGHT, compute_dtype=dtype)
    jcfg = JaxConfig(backend=JaxBackend.XLA, quant=JaxQuantMode.INT8_WEIGHT,
                     compute_dtype=dtype)
    port = compile_model(read_ir_model(*MNIST), cfg, device="cpu")
    jax = jax_compile_model(jax_read(*MNIST), jcfg)
    x = _images(1, 13)[0]
    port.save_weights(str(tmp_path / "port.npz"))
    jax.save_weights(str(tmp_path / "jax.npz"))
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
    # a perturbed checkpoint, so that a load that changes nothing shows
    perturbed = {}
    with np.load(tmp_path / "port.npz") as data:
        for k in data.files:
            arr = np.array(data[k])
            perturbed[k] = arr if arr.dtype != np.float32 else arr * np.float32(1.5)
    np.savez(tmp_path / "perturbed.npz", **perturbed)
    want = compile_model(read_ir_model(*MNIST), cfg, device="cpu")
    want.load_weights(str(tmp_path / "perturbed.npz"))
    jax.load_weights(str(tmp_path / "perturbed.npz"))
    got, jgot = want.infer({IN: x}), jax.infer({IN: x})
    for k in got:
        tol = 1e-2 if dtype == "bfloat16" else OUT_RTOL
        np.testing.assert_allclose(got[k], jgot[k], rtol=tol, atol=OUT_ATOL)
    # the JAX package's file into the port: the port's own answers
    fresh = compile_model(read_ir_model(*MNIST), cfg, device="cpu")
    fresh.load_weights(str(tmp_path / "jax.npz"))
    _equal(fresh.infer({IN: x}), port.infer({IN: x}))
