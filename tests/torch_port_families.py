"""Shared checks of the U-Net, ViT-tiny, MoE-MLP, lstm-tiny and yolo-tiny
tests (tests/test_torch_port_{unet,vit,moe,lstm,yolo}.py): each network
through the port on the CPU against the JAX package's XLA backend, its
Pallas backend (interpret) and its numpy interpreter, on seeded inputs
uniform in [0, 255) (every stem folds the 1/255 input scale):

  * FP32 and INT8 weight-only through the public API, TORCH and KERNELS
    (each kernel wrapper taking its plain version), at rtol 1e-3 /
    atol 1e-5, the tolerance of the JAX package's own family tests;
  * INT8-FULL: the logits (the last SoftMax, or yolo-tiny's RegionYolo,
    cut out) from the same activation scales, within FLIP_RTOL, and equal
    to the JAX package's bit for bit once the port rounds as XLA on the CPU
    does: the INT8 epilogue as one fused multiply-add (``xla_fma_epilogue``)
    and Gelu's erfc taken from XLA (``xla_erfc``: XLA's and PyTorch's
    float32 erfc differ in the last bits on about 41 % of inputs,
    ROADMAP.md §3 fault 6);
  * bfloat16: the relative gate of tests/test_torch_port_bf16.py;
  * the kernels' launches on KERNELS at the shapes chip_smoke.py reads from
    the compiled graphs, and the JAX package's Pallas calls for the same
    graph.

This module holds no tests of its own."""

import numpy as np
import torch

import pyopenvino_tpu.ir.model as jax_ir
from pyopenvino_tpu.config import Backend as JaxBackend
from pyopenvino_tpu.config import Config as JaxConfig
from pyopenvino_tpu.config import QuantMode as JaxQuantMode
from pyopenvino_tpu.ir import read_ir_model as jax_read
from pyopenvino_tpu.runtime.compiler import compile_model as jax_compile
from pyopenvino_tpu.runtime.interpreter import Interpreter as JaxInterpreter

import pyopenvino_tpu_torch.ir.model as port_ir
from pyopenvino_tpu_torch import IECore
from pyopenvino_tpu_torch.config import Backend, Config, QuantMode
from pyopenvino_tpu_torch.ir import read_ir_model
from pyopenvino_tpu_torch.kernels import conv_direct, gemm
from pyopenvino_tpu_torch.ops import extended
from pyopenvino_tpu_torch.runtime.compiler import compile_model
from pyopenvino_tpu_torch.runtime.interpreter import Interpreter
from test_torch_port_bf16 import Bf16Case, _dist
from test_torch_port_int8full import FLIP_RTOL, _rel_err, xla_fma_epilogue

RTOL, ATOL = 1e-3, 1e-5
QUANTS = [QuantMode.NONE, QuantMode.INT8_WEIGHT, QuantMode.INT8_FULL]


def head_logits_model(model, ir):
    """``model`` with the SoftMax (or yolo-tiny's RegionYolo) that feeds its
    Result cut out: the Result reads the logits (ViT-tiny's and MoE-MLP's
    first SoftMax nodes are their attention and router softmaxes)."""
    sm = model.in_edges[model.results[0].id][0][0]
    assert model.nodes[sm].op_type in ("SoftMax", "RegionYolo")
    src, sport = model.in_edges[sm][0]
    edges = [ir.Edge(src, sport, e.dst, e.dst_port) if e.src == sm else e
             for e in model.edges if e.dst != sm]
    return ir.Model(model.name, {k: v for k, v in model.nodes.items() if k != sm}, edges)


def xla_erfc(monkeypatch):
    """Make the port's Gelu take its erfc from XLA's CPU lowering: the
    ``torch`` that ops/extended.py sees is PyTorch with ``erfc`` replaced."""
    import jax
    import jax.numpy as jnp

    erfc = jax.jit(jax.lax.erfc)

    class XlaErfcTorch:
        def __getattr__(self, name):
            return getattr(torch, name)

        @staticmethod
        def erfc(t):
            return torch.from_numpy(np.array(erfc(jnp.asarray(t.detach().numpy()))))

    monkeypatch.setattr(extended, "torch", XlaErfcTorch())


def images(shape, n, seed, high=255.0):
    return np.random.default_rng(seed).uniform(0, high, (n, *shape[1:])).astype(np.float32)


class Family:
    """One network's paths, input and output, with the JAX package's
    per-image XLA answers and interpreter answer on ``blobs``.
    ``distribution``: the output sums to 1 over axis 1 (a class or per-pixel
    SoftMax; yolo-tiny's region blob does not, and its tests check it
    their own way)."""

    def __init__(self, paths, blobs, distribution=True):
        self.paths, self.blobs, self.distribution = paths, blobs, distribution
        self.model, self.jax_model = read_ir_model(*paths), jax_read(*paths)
        self.input = self.model.parameters[0].name
        self.out = self.model.results[0].name
        self.jax_nets = {}
        self.want = {q: self.jax_per_image(q) for q in (QuantMode.NONE, QuantMode.INT8_WEIGHT)}
        self.interpreted = JaxInterpreter(self.jax_model).run({self.input: blobs[:1]})[self.out]

    def jax_net(self, quant, backend=JaxBackend.XLA, samples=None):
        key = (quant, backend)
        if key not in self.jax_nets:
            self.jax_nets[key] = jax_compile(
                self.jax_model, JaxConfig(backend=backend, quant=JaxQuantMode(quant.value)),
                calibration_samples=samples)
        return self.jax_nets[key]

    def jax_per_image(self, quant):
        net = self.jax_net(quant)
        return np.concatenate([net.infer({self.input: self.blobs[i:i + 1]})[self.out]
                               for i in range(len(self.blobs))])

    def exe(self, quant, kernel_type, calibration=None, **config):
        ie = IECore()
        exe = ie.load_network(ie.read_network(*self.paths), "CPU",
                              config=Config(quant=quant, **config))
        exe.kernel_type = kernel_type
        if calibration is not None:
            exe.set_calibration(calibration)
        return exe

    def check_matches_jax(self, quant, kernel_type):
        """infer at batch 1 and infer_batch over ``blobs`` against the JAX
        package's XLA answers one image at a time; FP32 also against its
        numpy interpreter."""
        exe = self.exe(quant, kernel_type)
        want = self.want[quant]
        one = exe.infer({self.input: self.blobs[:1]})[self.out]
        batch = exe.infer_batch({self.input: self.blobs})[self.out]
        assert one.shape == want[:1].shape and batch.shape == want.shape
        assert np.isfinite(batch).all()
        np.testing.assert_allclose(one, want[:1], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(batch, want, rtol=RTOL, atol=ATOL)
        if self.distribution:
            np.testing.assert_allclose(batch.sum(axis=1), 1.0, atol=1e-4)
        if quant == QuantMode.NONE:
            np.testing.assert_allclose(one, self.interpreted, rtol=RTOL, atol=ATOL)
        return exe, batch

    def check_interpreter(self):
        got = Interpreter(self.model).run({self.input: self.blobs[:1]})[self.out]
        np.testing.assert_array_equal(got, self.interpreted)

    def check_int8_weight_codes(self):
        from pyopenvino_tpu.runtime.compiler import prepare_model as jax_prepare

        got = self.exe(QuantMode.INT8_WEIGHT, "torch").compiled()._quantized
        _, want, _, _ = jax_prepare(self.jax_model, JaxConfig(quant=JaxQuantMode.INT8_WEIGHT))
        assert sorted(got) == sorted(want)
        for nid, (codes, scales) in want.items():
            np.testing.assert_array_equal(got[nid][0], codes)
            np.testing.assert_array_equal(got[nid][1], scales)
        return len(want)

    def int8_agreement(self):
        """The JAX family tests' INT8 check, through the port: INT8W and
        INT8-FULL (calibrated on the image and one more, as they are) against
        FP32 on image 0, as (argmax over axis 1, agreement share) per mode."""
        blob = self.blobs[:1]
        ref = self.exe(QuantMode.NONE, "torch").infer({self.input: blob})[self.out]
        cal = [{self.input: blob}, {self.input: images(blob.shape, 1, 1)}]
        out = {}
        for quant in (QuantMode.INT8_WEIGHT, QuantMode.INT8_FULL):
            got = self.exe(quant, "torch", cal if quant == QuantMode.INT8_FULL else None).infer(
                {self.input: blob})[self.out]
            out[quant] = float(np.mean(got.argmax(axis=1) == ref.argmax(axis=1)))
        return out


class Int8FullCase:
    """INT8-FULL on one image, the logits model of both packages compiled
    from the same 2 calibration samples; the JAX logits taken once per
    backend (tests/test_torch_port_int8full.py's case with the head's
    SoftMax cut)."""

    def __init__(self, paths, seed):
        self.model = head_logits_model(read_ir_model(*paths), port_ir)
        param = self.model.parameters[0]
        self.out = self.model.results[0].name
        shape = param.outputs[param.out_port].shape
        rng = np.random.default_rng(seed)
        self.samples = [{param.name: rng.uniform(0, 255, shape).astype(np.float32)}
                        for _ in range(2)]
        self.x = {param.name: rng.uniform(0, 255, shape).astype(np.float32)}
        jax_model = head_logits_model(jax_read(*paths), jax_ir)
        self.jax_scales, self.want = {}, {}
        for be in (JaxBackend.XLA, JaxBackend.PALLAS):
            net = jax_compile(jax_model, JaxConfig(backend=be, quant=JaxQuantMode.INT8_FULL),
                              calibration_samples=self.samples)
            self.jax_scales[be] = net.act_scales
            self.want[be] = net.infer(self.x)[self.out]

    def check(self, backend, jax_backend, monkeypatch):
        net = compile_model(self.model, Config(backend=backend, quant=QuantMode.INT8_FULL),
                            device="cpu", calibration_samples=self.samples)
        assert net.act_scales == self.jax_scales[jax_backend]
        got, want = net.infer(self.x)[self.out], self.want[jax_backend]
        err = _rel_err(got, want)
        xla_fma_epilogue(monkeypatch)
        fma = _rel_err(net.infer(self.x)[self.out], want)
        print(f"{backend.value} vs {jax_backend.value}: logits max rel err {err:.3e} "
              f"(limit {FLIP_RTOL}); with XLA's FMA epilogue {fma:.3e}")
        assert err <= FLIP_RTOL
        assert (got.argmax(1) == want.argmax(1)).all()
        xla_erfc(monkeypatch)
        np.testing.assert_array_equal(net.infer(self.x)[self.out], want)
        return net


class FamilyBf16Case(Bf16Case):
    """tests/test_torch_port_bf16.py's case with the head's SoftMax cut out
    (``head_logits_model``) and inputs in [0, 255)."""

    def __init__(self, paths, seed):
        super().__init__(paths, seed, high=255.0, cut=head_logits_model)


def check_bf16(case, backend, jax_backend, quant, want=None):
    """The port's bfloat16 logits against the JAX package's
    (``want``: JAX's logits where the caller computed them): the mean
    distance below 0.8 of JAX's own bfloat16-vs-float32 distance (1.0 for
    INT8-FULL on TORCH, int8 storage between ops: tests/test_torch_port_
    bf16.py's check_bf16_case), finite values, and the argmax over axis 1
    the same wherever JAX's own two best classes lie further apart than its
    bfloat16 error."""
    int8_stored = quant == QuantMode.INT8_FULL and backend == Backend.TORCH
    _, got = case.port(backend, quant)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    if want is None:
        want = case.jax(jax_backend, quant, "bfloat16")
    f32 = case.jax(jax_backend, quant, "float32")
    port_jax, jax_f32 = _dist(got, want), _dist(want, f32)
    print(f"{quant.value} {backend.value} vs {jax_backend.value}: port bf16 vs JAX bf16 max "
          f"{port_jax[0]:.3e} mean {port_jax[1]:.3e}; JAX bf16 vs JAX f32 max {jax_f32[0]:.3e} "
          f"mean {jax_f32[1]:.3e}; equal: {np.array_equal(got, want)}")
    assert port_jax[1] < (1.0 if int8_stored else 0.8) * jax_f32[1]
    top = np.sort(want, axis=1)
    margin = (top[:, -1] - top[:, -2]) / np.abs(want).max()
    differ = got.argmax(axis=1) != want.argmax(axis=1)
    assert (margin[differ] <= jax_f32[0]).all()
    return got, want


def kernel_calls(monkeypatch):
    """{"gemm": [(A dtype, M, (K, N))], "direct": [(x shape, w shape)]}: the
    plain versions the port's wrappers run on the CPU, recorded."""
    seen = {"gemm": [], "direct": []}
    plain_gemm, plain_direct = gemm.fused_gemm_plain, conv_direct.conv2d_direct_plain

    def gemm_spy(a, b, *args, **kw):
        seen["gemm"].append((str(a.dtype), a.shape[0], tuple(b.shape)))
        return plain_gemm(a, b, *args, **kw)

    def direct_spy(x, w, *args, **kw):
        seen["direct"].append((tuple(x.shape), tuple(w.shape)))
        return plain_direct(x, w, *args, **kw)

    monkeypatch.setattr(gemm, "fused_gemm_plain", gemm_spy)
    monkeypatch.setattr(conv_direct, "conv2d_direct_plain", direct_spy)
    return seen


def jax_pallas_fused_gemms(family, quant, samples, monkeypatch):
    """How many times the JAX package's PALLAS backend calls fused_gemm in
    one forward of the network (counted while it traces).  It runs every
    INT8-FULL conv as an XLA int8 conv, so its calls are the MatMuls'."""
    import pyopenvino_tpu.kernels.gemm as jax_gemm

    calls = []
    fn = jax_gemm.fused_gemm

    def counted(a, b, *args, **kw):
        calls.append((a.shape[0], tuple(b.shape)))
        return fn(a, b, *args, **kw)

    monkeypatch.setattr(jax_gemm, "fused_gemm", counted)
    net = jax_compile(family.jax_model, JaxConfig(backend=JaxBackend.PALLAS,
                                                  quant=JaxQuantMode(quant.value)),
                      calibration_samples=samples)
    net.infer({family.input: family.blobs[:1]})
    monkeypatch.setattr(jax_gemm, "fused_gemm", fn)
    return calls


def check_kernel_launches(family, quant, monkeypatch):
    """The port's KERNELS forward calls fused_gemm and conv2d_direct at the
    shapes of chip_smoke.launch_table; its MatMuls take fused_gemm where,
    and at the shapes where, the JAX package's Pallas forward calls it (the
    port's INT8-FULL convs take its kernels too, where the JAX package runs
    XLA int8 convs).  Returns the table."""
    import chip_smoke

    samples = ([{family.input: family.blobs[:1]}, {family.input: family.blobs[1:2]}]
               if quant == QuantMode.INT8_FULL else None)
    jax_calls = jax_pallas_fused_gemms(family, quant, samples, monkeypatch)
    seen = kernel_calls(monkeypatch)
    exe = family.exe(quant, "kernels", samples)
    exe.infer({family.input: family.blobs[:1]})
    compiled = exe.compiled()
    table = chip_smoke.launch_table(compiled, quant.value)
    gemms = {k: v for k, v in table.items() if k != "conv2d_direct"}
    assert sorted((m, kn) for _, m, kn in seen["gemm"]) == sorted(
        (m, (k, n)) for shapes in gemms.values() for m, k, n, c in shapes for _ in range(c))
    assert sorted(seen["direct"]) == sorted(
        ((1, h, w, ci), (co, ci, kh, kw))
        for h, w, ci, co, kh, kw, _pads, c in chip_smoke.direct_convs(compiled, quant.value)
        for _ in range(c))
    assert sorted(jax_calls) == sorted(
        (m, (k, n)) for _, m, k, n in chip_smoke.matmul_launches(compiled, quant.value))
    return table
