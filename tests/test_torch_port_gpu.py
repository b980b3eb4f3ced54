"""The port's kernels, ResNet-18 and MobileNet-v2 on a CUDA card.

Each test decides inside itself whether a card is present and skips with a
reason when it is not, so every worker collects the same tests.  Run on a
machine with an H100 (``--noconftest``: tests/conftest.py imports JAX,
which the port's machine need not have):

    python -m pytest --noconftest -m gpu tests/test_torch_port_gpu.py -q
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

# Summation order differs between the kernel and cuBLAS (both full f32).
GEMM_RTOL = 1e-4
SOFTMAX_ATOL = 1e-6


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, shape, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)


@pytest.mark.parametrize("m,k,n,use_scale,use_bias,act", [
    (784, 64, 128, False, True, None),
    (196 * 64, 128, 256, False, True, None),
    (1, 512, 1000, False, True, None),
    (1000, 77, 130, True, True, ("relu", 0.0, 0.0)),
    (65, 33, 200, False, False, ("clamp", -0.5, 0.5)),
    (3, 1, 5, False, False, None),
])
def test_fused_gemm_kernel_vs_plain(m, k, n, use_scale, use_bias, act):
    from pyopenvino_tpu_torch.kernels.gemm import fused_gemm, fused_gemm_plain

    dev = _card()
    rng = np.random.default_rng(m + k + n)
    a, b = _rand(rng, (m, k), dev), _rand(rng, (k, n), dev)
    scale = _rand(rng, (n,), dev) if use_scale else None
    bias = _rand(rng, (n,), dev) if use_bias else None
    before = fused_gemm.launches
    got = fused_gemm(a, b, scale, bias, act)
    torch.cuda.synchronize()
    assert fused_gemm.launches == before + 1
    want = fused_gemm_plain(a, b, scale, bias, act)
    err = (got - want).abs().max().item() / max(want.abs().max().item(), 1e-30)
    assert err <= GEMM_RTOL


def test_fused_gemm_kernel_strided_rows():
    from pyopenvino_tpu_torch.kernels.gemm import fused_gemm, fused_gemm_plain

    dev = _card()
    rng = np.random.default_rng(5)
    big = _rand(rng, (300, 96), dev)
    a = big[:, 7:7 + 70]  # lda = 96 > K = 70
    b = _rand(rng, (70, 129), dev)
    got = fused_gemm(a, b, act=("relu", 0, 0))
    want = fused_gemm_plain(a, b, act=("relu", 0, 0))
    assert (got - want).abs().max().item() <= GEMM_RTOL * want.abs().max().item()


def test_fused_gemm_kernel_single_row_any_stride():
    """A transposed (K, 1) view is a (1, K) row with strides (1, 1): its row
    stride is never stepped, so the wrapper takes it as it is."""
    from pyopenvino_tpu_torch.kernels.gemm import fused_gemm, fused_gemm_plain

    dev = _card()
    rng = np.random.default_rng(6)
    a = _rand(rng, (512, 1), dev).t()
    assert a.stride() == (1, 1)
    b, bias = _rand(rng, (512, 1000), dev), _rand(rng, (1000,), dev)
    got = fused_gemm(a, b, bias=bias)
    want = fused_gemm_plain(a, b, bias=bias)
    assert (got - want).abs().max().item() <= GEMM_RTOL * want.abs().max().item()


@pytest.mark.parametrize("m,k,n,use_bias,act", [
    (196, 64, 384, True, ("clamp", 0.0, 6.0)),   # MobileNet-v2 expand, B = 1
    (49 * 64, 960, 160, True, None),             # MobileNet-v2 project, B = 64
    (1, 1280, 1000, True, None),                 # MobileNet-v2 FC, B = 1
    (64, 512, 1000, True, None),                 # ResNet-18 FC, B = 64
    (1, 77, 1000, True, ("relu", 0.0, 0.0)),     # K % 16 != 0
    (130, 70, 129, False, None),                 # N % 4 != 0: the byte path
    (3, 1, 5, False, None),
])
def test_int8_fused_gemm_kernel_vs_plain(m, k, n, use_bias, act):
    from pyopenvino_tpu_torch.kernels.gemm import fused_gemm, fused_gemm_plain

    dev = _card()
    rng = np.random.default_rng(m + k + n)
    a = _rand(rng, (m, k), dev)
    b = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8)).to(dev)
    scale = torch.from_numpy(rng.uniform(0.001, 0.02, n).astype(np.float32)).to(dev)
    bias = _rand(rng, (n,), dev) if use_bias else None
    f32, i8w = fused_gemm.launches, fused_gemm.launches_i8w
    got = fused_gemm(a, b, scale, bias, act)
    torch.cuda.synchronize()
    assert (fused_gemm.launches, fused_gemm.launches_i8w) == (f32, i8w + 1)
    want = fused_gemm_plain(a, b, scale, bias, act)
    err = (got - want).abs().max().item() / max(want.abs().max().item(), 1e-30)
    assert err <= GEMM_RTOL


def test_int8_fused_gemm_kernel_unaligned_b_and_refusals():
    """A B that is not 4-byte aligned takes the byte path; an int8 B without
    a scale, or with a scale of the wrong shape, is refused on the card."""
    from pyopenvino_tpu_torch.kernels.gemm import fused_gemm, fused_gemm_plain

    dev = _card()
    rng = np.random.default_rng(9)
    flat = torch.from_numpy(rng.integers(-127, 128, 96 * 1000 + 1).astype(np.int8)).to(dev)
    b = flat[1:].view(96, 1000)
    assert b.data_ptr() % 4 != 0
    a = _rand(rng, (37, 96), dev)
    scale = torch.from_numpy(rng.uniform(0.001, 0.02, 1000).astype(np.float32)).to(dev)
    got = fused_gemm(a, b, scale)
    want = fused_gemm_plain(a, b, scale)
    assert (got - want).abs().max().item() <= GEMM_RTOL * want.abs().max().item()
    with pytest.raises(ValueError, match="dequant scale"):
        fused_gemm(a, b)
    with pytest.raises(ValueError, match="scale"):
        fused_gemm(a, b, scale.reshape(1, 1000))


@pytest.mark.parametrize("m,n", [(1, 1000), (64, 1000), (7, 129), (3, 1)])
def test_softmax_rows_kernel_vs_plain(m, n):
    from pyopenvino_tpu_torch.kernels.softmax import softmax_rows, softmax_rows_plain

    dev = _card()
    x = _rand(np.random.default_rng(m * n), (m, n), dev) * 30
    before = softmax_rows.launches
    got = softmax_rows(x)
    torch.cuda.synchronize()
    assert softmax_rows.launches == before + 1
    assert (got - softmax_rows_plain(x)).abs().max().item() <= SOFTMAX_ATOL


def test_resnet18_kernels_vs_torch_on_card():
    from pyopenvino_tpu_torch import IECore
    from pyopenvino_tpu_torch.kernels.gemm import fused_gemm
    from pyopenvino_tpu_torch.kernels.softmax import softmax_rows
    from pyopenvino_tpu_torch.models.synth import resnet18_paths

    _card()
    ie = IECore()
    net = ie.read_network(*resnet18_paths(seed=0))
    x = np.random.default_rng(1).uniform(0, 1, (4, 3, 224, 224)).astype(np.float32)
    kernels = ie.load_network(net, "GPU")
    kernels.kernel_type = "kernels"
    reference = ie.load_network(net, "GPU")
    reference.kernel_type = "torch"
    g0, s0 = fused_gemm.launches, softmax_rows.launches
    got = kernels.infer_batch({"data": x})["prob"]
    assert (fused_gemm.launches - g0, softmax_rows.launches - s0) == (4, 1)
    want = reference.infer_batch({"data": x})["prob"]
    assert got.shape == (4, 1000) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)
    assert (got.argmax(1) == want.argmax(1)).all()


@pytest.mark.parametrize("model,quant,per_forward", [
    ("resnet18", "int8w", 4),
    ("mobilenet_v2", "none", 16),
    ("mobilenet_v2", "int8w", 16),
])
def test_slice2_paths_kernels_vs_torch_on_card(model, quant, per_forward):
    from pyopenvino_tpu_torch import IECore
    from pyopenvino_tpu_torch.config import Config, QuantMode
    from pyopenvino_tpu_torch.kernels.gemm import fused_gemm
    from pyopenvino_tpu_torch.kernels.softmax import softmax_rows
    from pyopenvino_tpu_torch.models import synth

    _card()
    ie = IECore()
    net = ie.read_network(*getattr(synth, f"{model}_paths")(seed=0))
    config = Config(quant=QuantMode(quant))
    x = np.random.default_rng(1).uniform(0, 1, (4, 3, 224, 224)).astype(np.float32)
    kernels = ie.load_network(net, "GPU", config=config)
    kernels.kernel_type = "kernels"
    reference = ie.load_network(net, "GPU", config=config)
    reference.kernel_type = "torch"
    before = (fused_gemm.launches, fused_gemm.launches_i8w, softmax_rows.launches)
    got = kernels.infer_batch({"data": x})["prob"]
    after = (fused_gemm.launches, fused_gemm.launches_i8w, softmax_rows.launches)
    int8 = quant == "int8w"
    assert tuple(b - a for a, b in zip(before, after)) == (
        0 if int8 else per_forward, per_forward if int8 else 0, 1)
    want = reference.infer_batch({"data": x})["prob"]
    assert got.shape == (4, 1000) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)
    assert (got.argmax(1) == want.argmax(1)).all()
