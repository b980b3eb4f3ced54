"""Full-width EfficientNet-B0 INT8-FULL in the port against the JAX package
(its heavy case lives in a file of its own so that ``--dist loadfile``
runs it beside the FP32 and INT8 weight-only cases): the same weight codes
and scales, the same activation scales from the same 2 calibration images,
and logits equal to the JAX package's bit for bit once the port rounds as
XLA on the CPU does, on both backends; the int8 × int8 launches at the
shapes chip_smoke.py checks and times.

Two roundings differ between the packages, and the tests patch both in:
  * the INT8 epilogue acc·scale + bias, which XLA contracts into one fused
    multiply-add (``xla_fma_epilogue``, as for ResNet-18);
  * Swish's float32 exp: XLA's CPU exp and PyTorch's differ in the last
    bit on about 9 % of inputs, and with 49 Swish layers between
    quantization points such a bit moves an int8 code now and then.
    With XLA's exp in the port's formula (``xla_exp``) the Swish outputs
    are XLA's bit for bit."""

import numpy as np
import pytest
import torch

from pyopenvino_tpu.config import Config as JaxConfig
from pyopenvino_tpu.config import QuantMode as JaxQuantMode
from pyopenvino_tpu.ir import read_ir_model as jax_read

from pyopenvino_tpu_torch.config import Backend, QuantMode
from pyopenvino_tpu_torch.kernels import conv_direct, gemm
from pyopenvino_tpu_torch.models.efficientnet_b0 import efficientnet_b0_paths
from pyopenvino_tpu_torch.ops import extended
from test_torch_port_int8full import (
    BACKEND_PAIRS,
    FLIP_RTOL,
    Int8FullCase,
    _rel_err,
    xla_fma_epilogue,
)
import test_torch_port_threads  # noqa: F401  (this worker's torch threads)


def xla_exp(monkeypatch):
    """Make the port's Swish take its exp from XLA's CPU lowering: the
    ``torch`` that ops/extended.py sees is PyTorch with ``exp`` replaced."""
    import jax
    import jax.numpy as jnp

    exp = jax.jit(jnp.exp)

    class XlaExpTorch:
        def __getattr__(self, name):
            return getattr(torch, name)

        @staticmethod
        def exp(t):
            out = torch.from_numpy(np.array(exp(t.detach().numpy())))
            return out.contiguous(memory_format=torch.channels_last) if out.dim() == 4 else out

    monkeypatch.setattr(extended, "torch", XlaExpTorch())


@pytest.fixture(scope="module")
def case():
    return Int8FullCase(efficientnet_b0_paths(seed=0), seed=3, high=255.0)


@pytest.mark.parametrize("backend,jax_backend", BACKEND_PAIRS)
def test_efficientnet_int8full_matches_jax(case, backend, jax_backend, monkeypatch):
    net, got = case.port(backend)
    assert net.act_scales == case.jax_scales[jax_backend]
    assert len(net.act_scales) == 82  # 65 convs, 16 depthwise convs, the classifier
    want = case.want[jax_backend]
    err = _rel_err(got, want)
    print(f"{backend.value} vs {jax_backend.value}: logits max rel err {err:.3e}")
    assert err <= FLIP_RTOL
    assert (got.argmax(1) == want.argmax(1)).all()
    xla_fma_epilogue(monkeypatch)
    assert _rel_err(net.infer(case.x)[case.out], want) > 0  # exp alone still differs
    xla_exp(monkeypatch)
    np.testing.assert_array_equal(net.infer(case.x)[case.out], want)


def test_efficientnet_int8full_codes_match_jax(case):
    """quantize_weights gives the JAX package's int8 codes and float32
    scales for every weight (65 convs, 16 depthwise convs, the classifier)."""
    from pyopenvino_tpu.runtime.compiler import prepare_model as jax_prepare

    net, _ = case.port(Backend.TORCH)
    _, quantized, _, _ = jax_prepare(
        jax_read(*efficientnet_b0_paths(seed=0)),
        JaxConfig(quant=JaxQuantMode.INT8_FULL), case.samples)
    assert sorted(net._quantized) == sorted(quantized) and len(quantized) == 82
    for nid, (codes, scales) in quantized.items():
        np.testing.assert_array_equal(net._quantized[nid][0], codes)
        np.testing.assert_array_equal(net._quantized[nid][1], scales)


def test_efficientnet_int8full_kernel_launches(case, monkeypatch):
    """Every conv but the depthwise ones, and the classifier, as int8 ×
    int8 fused_gemm (the SE convs at M = batch); no conv2d_direct (the only
    spatial conv of the plain kind is the stride-2 stem).  The shapes are
    those of chip_smoke.launch_table."""
    import chip_smoke

    seen = []
    plain = gemm.fused_gemm_plain

    def spy(a, b, *args, **kw):
        seen.append((str(a.dtype), str(b.dtype), a.shape[0], tuple(b.shape)))
        return plain(a, b, *args, **kw)

    monkeypatch.setattr(gemm, "fused_gemm_plain", spy)
    monkeypatch.setattr(conv_direct, "conv2d_direct_plain", None)  # never reached
    net, _ = case.port(Backend.KERNELS)
    table = chip_smoke.launch_table(net, QuantMode.INT8_FULL.value)
    assert set(table) == {"fused_gemm_i8i8"}
    assert sorted(seen) == sorted(
        ("torch.int8", "torch.int8", m, (k, n))
        for m, k, n, count in table["fused_gemm_i8i8"] for _ in range(count))
    assert len(seen) == 66
    # the 32 SE convs: one pixel per image, the SE width max(1, ci // 4)
    # as N (the squeeze) or K (the excite)
    se = [(k, n, c) for m, k, n, c in table["fused_gemm_i8i8"] if m == 1 and min(k, n) <= 48]
    assert sum(c for *_, c in se) == 32
    assert {min(k, n) for k, n, _ in se} == {4, 6, 8, 10, 20, 28, 48}
    from test_torch_port_gpu import EFFICIENTNET_I8I8, EFFICIENTNET_SE  # the card tests' shapes

    assert sorted((k, n) for k, n, _ in se) == EFFICIENTNET_SE
    assert table["fused_gemm_i8i8"] == EFFICIENTNET_I8I8
    assert net._int8_edges == {}
