"""U-Net (the port's ``models/unet.xml`` with the weights ``models/unet.py``
replays, byte for byte those of ``tools/gen_unet.py``) on the port against
the JAX package, mirroring tests/test_unet.py: ConvolutionBackpropData
2×2/s2 up-convolutions, skip Concats across scales and a SoftMax over
axis 1 of the rank-4 logits (1, 8, 128, 128):
  * FP32 and INT8 weight-only through the public API on the CPU, TORCH and
    KERNELS, against the JAX package's XLA backend one image at a time and
    (FP32) its interpreter, at rtol 1e-3 / atol 1e-5; infer_batch at 2;
  * the numpy interpreter bit for bit; the INT8 weight codes and scales;
  * INT8-FULL: the same activation scales and the logits bit for bit with
    XLA's fused multiply-add epilogue (tests/torch_port_families.py), TORCH
    against XLA and KERNELS against PALLAS;
  * INT8 weight-only and INT8-FULL keep FP32's per-pixel class on more
    than 95 % of the pixels (tests/test_unet.py:58);
  * bfloat16 in the three modes with tests/test_torch_port_bf16.py's gate;
  * KERNELS launches nothing in FP32 and INT8W (no 1×1 conv with
    co >= 128, the head's SoftMax is rank 4), and under INT8-FULL 14
    conv2d_direct (the stride-1 3×3 convs, Ci = 3 … 128 at 128² … 16²) and
    one int8 × int8 fused_gemm (the 1×1 head, N = 8)."""

import pytest

from pyopenvino_tpu_torch.config import Backend, QuantMode
from pyopenvino_tpu_torch.models import unet
from torch_port_families import (
    QUANTS, Family, FamilyBf16Case, Int8FullCase, check_bf16, check_kernel_launches, images,
)
from test_torch_port_int8full import BACKEND_PAIRS
import test_torch_port_threads  # noqa: F401  (this worker's torch threads)


@pytest.fixture(scope="module")
def family():
    return Family(unet.unet_paths(), images((1, 3, 128, 128), 2, 7))


@pytest.mark.parametrize("quant", [QuantMode.NONE, QuantMode.INT8_WEIGHT], ids=lambda q: q.value)
@pytest.mark.parametrize("kernel_type", ["torch", "kernels"])
def test_matches_jax(family, quant, kernel_type):
    _, batch = family.check_matches_jax(quant, kernel_type)
    assert batch.shape == (2, 8, 128, 128)


def test_interpreter_and_codes_match_jax(family):
    family.check_interpreter()
    assert family.check_int8_weight_codes() == 18  # 15 convs, 3 up-convolutions


@pytest.mark.parametrize("backend,jax_backend", BACKEND_PAIRS, ids=["torch", "kernels"])
def test_int8full_matches_jax(backend, jax_backend, monkeypatch):
    net = Int8FullCase(unet.unet_paths(), seed=3).check(backend, jax_backend, monkeypatch)
    assert len(net.act_scales) == 15  # the convs; the up-convolutions take no scale
    if backend == Backend.TORCH:
        assert len(net._int8_edges) == 23


def test_int8_modes_preserve_mask(family):
    agree = family.int8_agreement()
    print({q.value: a for q, a in agree.items()})
    assert all(a > 0.95 for a in agree.values()), agree


@pytest.fixture(scope="module")
def bf16_case():
    return FamilyBf16Case(unet.unet_paths(), seed=3)


@pytest.mark.parametrize("quant", QUANTS, ids=lambda q: q.value)
@pytest.mark.parametrize("backend,jax_backend", BACKEND_PAIRS, ids=["torch", "kernels"])
def test_bf16_matches_jax(bf16_case, backend, jax_backend, quant):
    check_bf16(bf16_case, backend, jax_backend, quant)


@pytest.mark.parametrize("quant", QUANTS, ids=lambda q: q.value)
def test_kernel_launches(family, quant, monkeypatch):
    table = check_kernel_launches(family, quant, monkeypatch)
    if quant != QuantMode.INT8_FULL:
        assert table == {}
        return
    assert table["fused_gemm_i8i8"] == [(128 * 128, 16, 8, 1)]
    direct = table["conv2d_direct"]
    assert sum(c for *_, c in direct) == 14
    assert {k // 9 for _, k, _, _ in direct} == {3, 16, 32, 64, 128}
