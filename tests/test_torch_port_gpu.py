"""The port's kernels, ResNet-18, MobileNet-v2 and SSD-MobileNet-v1 on a CUDA
card.

Each test decides inside itself whether a card is present and skips with a
reason when it is not, so every worker collects the same tests.  Run on a
machine with an H100 (``--noconftest``: tests/conftest.py imports JAX,
which the port's machine need not have):

    python -m pytest --noconftest -m gpu tests/test_torch_port_gpu.py -q
"""

import numpy as np
import pytest
import torch

import chip_smoke

pytestmark = pytest.mark.gpu

# The float32 kernel's three TF32 terms against full float32 (cuBLAS with
# TF32 off, summed in another order); tests/test_torch_port_gemm_tc.py
# shows one TF32 term fails this gate.
GEMM_RTOL = 1e-4
# The int8-B kernel's two TF32 terms of A carry 22 of its 24 bits, and the
# tensor cores add at float32 width; tests/test_torch_port_gemm_tc.py shows
# why 2e-5 holds for two terms and fails for one.
I8W_RTOL = 2e-5
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


# SSD's float32-B (and int8-B) launches, (M per image, K, N): its 1×1 convs
# with co >= 128 and ci >= 64
SSD_GEMMS = [(361, 64, 128), (361, 128, 128), (100, 128, 256), (100, 256, 256)]
# ShuffleNet-v2's (M per image, K, N, launches per forward), as
# chip_smoke.launch_table reads them from its compiled network
# (tests/test_torch_port_shufflenet.py holds them to it): #1 and #1w, its
# 1×1 convs with co >= 128 and ci >= 64 (stage 3, the head) and the FC ...
SHUFFLENET_GEMMS = [(1, 1024, 1000, 1), (49, 232, 232, 8), (49, 464, 1024, 1),
                    (196, 232, 232, 1)]
# ... and #1ii, every Convolution under INT8-FULL (the 3×3/s2 stem's patches,
# the 1×1 convs) and the FC
SHUFFLENET_I8I8 = [(1, 1024, 1000, 1), (49, 232, 232, 8), (49, 464, 1024, 1),
                   (196, 116, 116, 16), (196, 232, 232, 1), (784, 24, 58, 1),
                   (784, 58, 58, 7), (784, 116, 116, 1), (3136, 24, 58, 1),
                   (12544, 27, 24, 1)]
# #1ii's launches under INT8-FULL of SSD, EfficientNet-B0 and
# googlenet_shapes, (M per image, K, N, launches per forward), as
# chip_smoke.launch_table reads them from the compiled networks
# (tests/test_torch_port_efficientnet_int8full.py and
# tests/test_torch_port_googlenet.py hold the last two to it)
SSD_I8I8 = [(1, 144, 32, 1), (4, 288, 64, 1), (9, 288, 64, 1), (25, 128, 32, 1),
            (25, 576, 128, 1), (100, 128, 256, 1), (100, 256, 24, 1), (100, 256, 30, 1),
            (100, 256, 64, 1), (100, 256, 256, 1), (361, 64, 128, 1), (361, 128, 128, 5),
            (1444, 64, 64, 1)]
EFFICIENTNET_I8I8 = [(1, 4, 96, 1), (1, 6, 144, 2), (1, 8, 32, 1), (1, 10, 240, 2),
                     (1, 20, 480, 3), (1, 28, 672, 3), (1, 32, 8, 1), (1, 48, 1152, 4),
                     (1, 96, 4, 1), (1, 144, 6, 2), (1, 240, 10, 2), (1, 480, 20, 3),
                     (1, 672, 28, 3), (1, 1152, 48, 4), (1, 1280, 1000, 1), (49, 192, 1152, 4),
                     (49, 320, 1280, 1), (49, 672, 192, 1), (49, 1152, 192, 3),
                     (49, 1152, 320, 1), (196, 80, 480, 3), (196, 112, 672, 3),
                     (196, 240, 80, 1), (196, 480, 80, 2), (196, 480, 112, 1),
                     (196, 672, 112, 2), (784, 40, 240, 2), (784, 144, 40, 1),
                     (784, 240, 40, 1), (3136, 24, 144, 2), (3136, 96, 24, 1),
                     (3136, 144, 24, 1), (12544, 16, 96, 1), (12544, 27, 32, 1),
                     (12544, 32, 16, 1)]
GOOGLENET_I8I8 = [(1, 256, 10, 1), (49, 208, 8, 1), (49, 208, 12, 1), (49, 208, 32, 2),
                  (49, 208, 40, 1), (49, 208, 48, 1), (49, 208, 64, 1), (49, 208, 96, 1),
                  (196, 120, 4, 1), (196, 120, 16, 1), (196, 120, 24, 1), (196, 120, 48, 1),
                  (196, 128, 6, 2), (196, 128, 8, 1), (196, 128, 16, 3), (196, 128, 28, 2),
                  (196, 128, 32, 2), (196, 128, 36, 1), (196, 128, 40, 1), (196, 132, 8, 1),
                  (196, 132, 32, 1), (196, 132, 40, 1), (196, 132, 64, 1), (784, 48, 4, 1),
                  (784, 48, 8, 1), (784, 48, 16, 1), (784, 48, 24, 1), (784, 64, 8, 1),
                  (784, 64, 16, 1), (784, 64, 32, 2), (3136, 16, 16, 1), (12544, 147, 16, 1)]
# the Split halves a basic unit's first 1×1 conv takes, (pixels per image,
# K = C/2, lda = C): a channel half of a channels_last tensor; FP32 and
# INT8W pass stage 3's to #1 / #1w as it is
SPLIT_HALVES = [(784, 58, 116), (196, 116, 232), (49, 232, 464)]
# #1ii's launches of the seven families, (M per image, K, N, launches per
# forward); resnet18_pot launches ResNet-18's
I8I8_NETS = {**{model: chip_smoke.I8I8_GEMMS[model] for model in chip_smoke.I8I8_GEMMS},
             "ssd_shapes_ms": SSD_I8I8, "efficientnet_b0": EFFICIENTNET_I8I8,
             "googlenet_shapes": GOOGLENET_I8I8, "shufflenet_v2": SHUFFLENET_I8I8,
             "resnet18_pot": chip_smoke.I8I8_GEMMS["resnet18"]}
# #1's main-path shapes at B = 1 and 64 (ResNet-18, MobileNet-v2, SSD; the
# classifiers give split K at M = 1 and 64 with K = 512 and 1280), then the
# tensor-core loop's edges: split K at M = 49, K not a multiple of 32, an
# odd lda, N = 1000 and a ragged N; each (M, K, N, lda)
F32_SHAPES = sorted(
    {(m, k, n, k) for b in (1, 64) for model in chip_smoke.GEMMS
     for m, k, n, _ in chip_smoke.GEMMS[model](b)}
    | {(m * b, k, n, k) for b in (1, 64) for m, k, n in SSD_GEMMS}
    | {(m * b, k, n, k) for b in (1, 64) for m, k, n, _ in SHUFFLENET_GEMMS}
    | {(49 * b, 232, 232, 464) for b in (1, 64)}) + [
    (49, 1280, 1000, 1280), (49, 512, 512, 512), (100, 77, 130, 77), (65, 96, 129, 97),
    (300, 70, 30, 70), (37, 1280, 1000, 1281)]


@pytest.mark.parametrize("m,k,n,lda", F32_SHAPES)
def test_fused_gemm_f32_tensor_cores_within_gate_and_deterministic(m, k, n, lda):
    """Three TF32 terms with a fixed-order split-K sum: within GEMM_RTOL of
    the plain version, and a second call gives the same bits."""
    from pyopenvino_tpu_torch.kernels.gemm import fused_gemm, fused_gemm_plain

    dev = _card()
    rng = np.random.default_rng(m + 3 * k + n)
    a = _rand(rng, (m, lda), dev)[:, :k]
    b, bias = _rand(rng, (k, n), dev), _rand(rng, (n,), dev)
    act = (("relu", 0.0, 0.0), None)[(m + n) % 2]
    before = fused_gemm.launches
    got = fused_gemm(a, b, None, bias, act)
    again = fused_gemm(a, b, None, bias, act)
    torch.cuda.synchronize()
    assert fused_gemm.launches == before + 2  # one per call, split or not
    want = fused_gemm_plain(a, b, None, bias, act)
    err = (got - want).abs().max().item() / max(want.abs().max().item(), 1e-30)
    assert err <= GEMM_RTOL
    assert torch.equal(got, again)


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
    assert err <= I8W_RTOL


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
    assert (got - want).abs().max().item() <= I8W_RTOL * want.abs().max().item()
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


# -- INT8-FULL: the int8 × int8 fused_gemm and conv2d_direct ---------------

def _codes(rng, shape, dev):
    return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8)).to(dev)


@pytest.mark.parametrize("m,k,n,lda,act", [
    (12544, 147, 64, 147, ("relu", 0.0, 0.0)),   # ResNet-18's 7×7 stem, B = 1
    (37, 27, 129, 32, None),                     # K = 27, N odd, lda > K
])
def test_i8i8_fused_gemm_kernel_equals_plain(m, k, n, lda, act):
    """Exact int32 sums and the same unfused epilogue: no difference."""
    from pyopenvino_tpu_torch.kernels.gemm import fused_gemm, fused_gemm_plain

    dev = _card()
    rng = np.random.default_rng(m + k)
    a = _codes(rng, (m, lda), dev)[:, :k]
    b = _codes(rng, (n, k), dev).t()  # K-major, as the kernel takes it
    scale = torch.from_numpy(rng.uniform(1e-4, 1e-2, n).astype(np.float32)).to(dev)
    bias = _rand(rng, (n,), dev)
    before = (fused_gemm.launches, fused_gemm.launches_i8w, fused_gemm.launches_i8i8)
    got = fused_gemm(a, b, scale, bias, act)
    torch.cuda.synchronize()
    assert (fused_gemm.launches, fused_gemm.launches_i8w,
            fused_gemm.launches_i8i8) == (before[0], before[1], before[2] + 1)
    assert (got - fused_gemm_plain(a, b, scale, bias, act)).abs().max().item() == 0


# The tensor-core loops' edges: split-K (M = 1, 49, 64 at K = 1280, 2304),
# A rows that are not 16-byte aligned (K = 27, 147, an odd lda), ragged N
# (24, 30) and N = 16, each (M, K, N, lda, act)
TC_SHAPES = [
    (1, 1280, 1000, 1280, None), (49, 2304, 512, 2304, ("relu", 0.0, 0.0)),
    (64, 1280, 1000, 1280, ("clamp", 0.0, 6.0)), (64, 2304, 512, 2304, None),
    (1, 2304, 512, 2304, None), (2 * 12544, 27, 32, 27, ("clamp", 0.0, 6.0)),
    (12544, 147, 64, 147, ("relu", 0.0, 0.0)), (65, 96, 130, 97, None),
    (300, 64, 24, 64, None), (300, 70, 30, 70, ("relu", 0.0, 0.0)),
    (2 * 12544, 32, 16, 32, None),
] + [  # ShuffleNet-v2's INT8-FULL shapes and its Split halves at B = 1 and 64
    (m * b, k, n, k, (("relu", 0.0, 0.0), None)[i % 2])
    for b in (1, 64) for i, (m, k, n, _) in enumerate(SHUFFLENET_I8I8)] + [
    (m * b, k, k, lda, ("relu", 0.0, 0.0)) for b in (1, 64) for m, k, lda in SPLIT_HALVES]


@pytest.mark.parametrize("m,k,n,lda,act", TC_SHAPES)
def test_i8i8_tensor_core_edges_equal_plain(m, k, n, lda, act):
    """int8 mma.sync, split-K and the byte path: still no difference."""
    from pyopenvino_tpu_torch.kernels.gemm import fused_gemm, fused_gemm_plain

    dev = _card()
    rng = np.random.default_rng(m + k + n)
    a = _codes(rng, (m, lda), dev)[:, :k]
    b = _codes(rng, (n, k), dev).t()
    scale = torch.from_numpy(rng.uniform(1e-4, 1e-2, n).astype(np.float32)).to(dev)
    bias = _rand(rng, (n,), dev)
    before = fused_gemm.launches_i8i8
    got = fused_gemm(a, b, scale, bias, act)
    torch.cuda.synchronize()
    assert fused_gemm.launches_i8i8 == before + 1  # one per call, split or not
    assert (got - fused_gemm_plain(a, b, scale, bias, act)).abs().max().item() == 0


@pytest.mark.parametrize("m,k,n,lda,act", TC_SHAPES)
def test_i8w_tensor_core_edges_within_gate_and_deterministic(m, k, n, lda, act):
    """Two TF32 terms, split-K with a fixed-order sum: within I8W_RTOL of the
    plain version, and two calls give the same bits."""
    from pyopenvino_tpu_torch.kernels.gemm import fused_gemm, fused_gemm_plain

    dev = _card()
    rng = np.random.default_rng(m + k + n)
    a = _rand(rng, (m, lda), dev)[:, :k]
    b = _codes(rng, (k, n), dev)
    scale = torch.from_numpy(rng.uniform(1e-3, 2e-2, n).astype(np.float32)).to(dev)
    bias = _rand(rng, (n,), dev)
    before = fused_gemm.launches_i8w
    got = fused_gemm(a, b, scale, bias, act)
    again = fused_gemm(a, b, scale, bias, act)
    torch.cuda.synchronize()
    assert fused_gemm.launches_i8w == before + 2
    want = fused_gemm_plain(a, b, scale, bias, act)
    err = (got - want).abs().max().item() / max(want.abs().max().item(), 1e-30)
    assert err <= I8W_RTOL
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype", ["float32", "int8 weight", "int8"])
@pytest.mark.parametrize("b", [1, 64])
@pytest.mark.parametrize("m,k,lda", SPLIT_HALVES)
def test_split_half_as_strided_a(m, k, lda, b, dtype):
    """ShuffleNet-v2's branch half, the second channel half of a
    channels_last activation: gemm_rows hands it to the kernel as a view
    (row stride C, offset C/2) and the kernel equals its plain version on
    it; conv2d_fused on the half equals cuDNN's 1×1 conv."""
    from pyopenvino_tpu_torch.kernels.conv import conv2d_fused, gemm_rows
    from pyopenvino_tpu_torch.kernels.gemm import fused_gemm, fused_gemm_plain

    dev = _card()
    rng = np.random.default_rng(m + k + b)
    hw = int(round(m ** 0.5))
    make = _codes if dtype == "int8" else _rand
    x = make(rng, (b, hw, hw, lda), dev).permute(0, 3, 1, 2)  # channels_last NCHW
    half = torch.split(x, k, dim=1)[1].permute(0, 2, 3, 1)
    a = gemm_rows(half)
    assert a.stride() == (lda, 1) and a.data_ptr() == half.data_ptr()
    w = (_codes(rng, (k, k), dev) if dtype != "float32" else _rand(rng, (k, k), dev))
    scale = (torch.from_numpy(rng.uniform(1e-4, 1e-2, k).astype(np.float32)).to(dev)
             if dtype != "float32" else None)
    bmat = w.t() if dtype == "int8" else w.t().contiguous()  # (K, N): K-major for int8 A
    bias, act = _rand(rng, (k,), dev), ("relu", 0.0, 0.0)
    got = fused_gemm(a, bmat, scale, bias, act)
    want = fused_gemm_plain(a, bmat, scale, bias, act)
    if dtype == "int8":
        assert (got - want).abs().max().item() == 0
    else:
        limit = GEMM_RTOL if dtype == "float32" else I8W_RTOL
        assert (got - want).abs().max().item() <= limit * want.abs().max().item()
    if dtype == "float32":
        out = conv2d_fused(half, w.reshape(k, k, 1, 1), bias=bias)
        ref = torch.nn.functional.conv2d(half.permute(0, 3, 1, 2), w.reshape(k, k, 1, 1), bias)
        assert (out.permute(0, 3, 1, 2) - ref).abs().max().item() <= (
            GEMM_RTOL * ref.abs().max().item())


def test_i8i8_refuses_row_major_b_on_card():
    from pyopenvino_tpu_torch.kernels.gemm import fused_gemm

    dev = _card()
    rng = np.random.default_rng(4)
    a, b = _codes(rng, (8, 32), dev), _codes(rng, (32, 16), dev)
    with pytest.raises(ValueError, match="K-major"):
        fused_gemm(a, b, torch.ones(16, device=dev))


P1 = ((1, 1), (1, 1))
# #3: ResNet-18's stride-1 3×3 shapes (its 13 launches) at B = 1 and 64,
# then Ci = 3, 4, 12 (4-byte and byte paths), 16, 48 (16-byte chunks),
# asymmetric pads, 5×5 and 1×3 kernels, M not a multiple of 128
DIRECT_SHAPES = [(b, hw, hw, c, c, 3, 3, P1)
                 for b in (1, 64) for hw, c, _ in chip_smoke.RESNET18_DIRECT] + [
    (2, 56, 56, 64, 64, 3, 3, P1),              # ResNet-18 layer1
    (3, 9, 11, 3, 70, 3, 3, ((0, 2), (1, 0))),  # Ci = 3, asymmetric pads
    (2, 15, 13, 4, 33, 3, 3, ((1, 0), (0, 2))), (2, 10, 10, 12, 64, 3, 3, P1),
    (1, 12, 12, 16, 40, 5, 5, ((2, 2), (2, 2))), (5, 7, 7, 48, 100, 3, 3, P1),
    (2, 10, 10, 16, 24, 1, 3, ((0, 0), (1, 1))), (3, 11, 9, 64, 130, 3, 3, ((0, 1), (2, 0))),
]


@pytest.mark.parametrize("n,h,w,ci,co,kh,kw,pads", DIRECT_SHAPES)
def test_conv2d_direct_kernel_equals_plain(n, h, w, ci, co, kh, kw, pads):
    """The int8 tensor-core loop with the implicit-im2col loader, split K
    where the grid is small: exact int32 sums, the same epilogue, so no
    difference at all; the cached K-major weight matrix gives the same."""
    from pyopenvino_tpu_torch.kernels.conv import conv_weight_matrix_nk
    from pyopenvino_tpu_torch.kernels.conv_direct import conv2d_direct, conv2d_direct_plain

    dev = _card()
    rng = np.random.default_rng(ci + co + n)
    x, wt = _codes(rng, (n, h, w, ci), dev), _codes(rng, (co, ci, kh, kw), dev)
    scale = torch.from_numpy(rng.uniform(1e-4, 1e-2, co).astype(np.float32)).to(dev)
    bias = _rand(rng, (co,), dev)
    act = (("relu", 0.0, 0.0), ("clamp", 0.0, 6.0), None)[(ci + co) % 3]
    before = conv2d_direct.launches
    got = conv2d_direct(x, wt, scale, bias, act, pads)
    via = conv2d_direct(x, wt, scale, bias, act, pads, wmat=conv_weight_matrix_nk(wt).t())
    torch.cuda.synchronize()
    assert conv2d_direct.launches == before + 2  # one per call, split or not
    want = conv2d_direct_plain(x, wt, scale, bias, act, pads)
    assert got.shape == want.shape
    assert (got - want).abs().max().item() == 0
    assert torch.equal(got, via)


@pytest.mark.parametrize("hw,c", [(7, 512), (14, 256)])
def test_conv2d_direct_splits_k_at_batch_1(hw, c):
    """ResNet-18's 7×7×512 and 14×14×256 convs at B = 1 give 8 tiles of
    128 × 64 for 132 SMs: the plan splits K, and the result stays exact."""
    from pyopenvino_tpu_torch.kernels import gemm
    from pyopenvino_tpu_torch.kernels.conv_direct import conv2d_direct, conv2d_direct_plain

    dev = _card()
    k = 9 * c
    assert gemm.split_k(hw * hw, k, c, gemm.PLANS["conv2d_direct"], 132) < k
    rng = np.random.default_rng(hw)
    x, wt = _codes(rng, (1, hw, hw, c), dev), _codes(rng, (c, c, 3, 3), dev)
    scale = torch.from_numpy(rng.uniform(1e-4, 1e-2, c).astype(np.float32)).to(dev)
    got = conv2d_direct(x, wt, scale, None, None, P1)
    torch.cuda.synchronize()
    assert (got - conv2d_direct_plain(x, wt, scale, None, None, P1)).abs().max().item() == 0


def test_int8_kernels_refuse_wrong_dtype_and_missing_scale():
    from pyopenvino_tpu_torch.kernels.conv_direct import conv2d_direct
    from pyopenvino_tpu_torch.kernels.gemm import fused_gemm

    dev = _card()
    rng = np.random.default_rng(2)
    a, b = _codes(rng, (8, 16), dev), _codes(rng, (16, 8), dev)
    scale = torch.ones(8, device=dev)
    with pytest.raises(ValueError, match="dequant scale"):
        fused_gemm(a, b)
    with pytest.raises(ValueError, match="int8 a needs an int8 b"):
        fused_gemm(a, b.float(), scale)
    x, wt = _codes(rng, (1, 5, 5, 4), dev), _codes(rng, (8, 4, 3, 3), dev)
    with pytest.raises(ValueError, match="scale"):
        conv2d_direct(x, wt, None)
    with pytest.raises(ValueError, match="K-major"):
        conv2d_direct(x, wt, scale, wmat=wt.permute(2, 3, 1, 0).reshape(36, 8).contiguous())
    with pytest.raises(ValueError, match="int8 x with an int8 w"):
        conv2d_direct(x, wt.float(), scale)
    with pytest.raises(ValueError, match="scale"):
        conv2d_direct(x, wt, scale.double())
    with pytest.raises(ValueError, match="x"):
        conv2d_direct(x.permute(0, 2, 1, 3), wt, scale)


@pytest.mark.parametrize("model,gemms,direct", [
    ("resnet18", 8, 13), ("mobilenet_v2", 36, 0)])
def test_int8full_kernels_vs_torch_on_card(model, gemms, direct):
    """INT8-FULL: KERNELS against TORCH with int8_dataflow=False, which
    quantizes at the same points: the int32 sums are exact and the
    epilogues the same, so the logits agree to the last bit."""
    from pyopenvino_tpu_torch import IECore
    from pyopenvino_tpu_torch.config import Config, QuantMode
    from pyopenvino_tpu_torch.kernels.conv_direct import conv2d_direct
    from pyopenvino_tpu_torch.kernels.gemm import fused_gemm
    from pyopenvino_tpu_torch.kernels.softmax import softmax_rows
    from pyopenvino_tpu_torch.models import synth

    _card()
    ie = IECore()
    net = ie.read_network(*getattr(synth, f"{model}_paths")(seed=0))
    rng = np.random.default_rng(1)
    samples = [{"data": rng.uniform(0, 1, (1, 3, 224, 224)).astype(np.float32)}
               for _ in range(2)]
    x = rng.uniform(0, 1, (4, 3, 224, 224)).astype(np.float32)
    kernels = ie.load_network(net, "GPU", config=Config(quant=QuantMode.INT8_FULL))
    kernels.kernel_type = "kernels"
    kernels.set_calibration(samples)
    reference = ie.load_network(
        net, "GPU", config=Config(quant=QuantMode.INT8_FULL, int8_dataflow=False))
    reference.kernel_type = "torch"
    reference.set_calibration(samples)
    before = (fused_gemm.launches_i8i8, conv2d_direct.launches, softmax_rows.launches,
              fused_gemm.launches + fused_gemm.launches_i8w)
    got = kernels.infer_batch({"data": x})["prob"]
    after = (fused_gemm.launches_i8i8, conv2d_direct.launches, softmax_rows.launches,
             fused_gemm.launches + fused_gemm.launches_i8w)
    assert tuple(b - a for a, b in zip(before, after)) == (gemms, direct, 1, 0)
    want = reference.infer_batch({"data": x})["prob"]
    assert got.shape == (4, 1000) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    assert (got.argmax(1) == want.argmax(1)).all()


@pytest.mark.parametrize("n,h,w,ci,co,kh,kw,pads,w_int8", [
    (2, 56, 56, 64, 64, 3, 3, ((1, 1), (1, 1)), False),   # ResNet-18 layer1
    (1, 7, 7, 512, 512, 3, 3, ((1, 1), (1, 1)), True),    # layer4, int8 weight
    (2, 13, 12, 3, 33, 5, 5, ((2, 2), (2, 2)), False),    # Ci = 3, 5×5
    (3, 9, 11, 7, 70, 3, 3, ((0, 2), (1, 0)), True),      # ragged K, asymmetric pads
])
def test_conv2d_direct_f32_kernel_vs_plain(n, h, w, ci, co, kh, kw, pads, w_int8):
    """Kernel 3f: float32 activations, a float32 weight or an int8 weight
    with its scale, against F.conv2d in float32 with TF32 off."""
    from pyopenvino_tpu_torch.kernels.conv_direct import conv2d_direct, conv2d_direct_plain

    dev = _card()
    rng = np.random.default_rng(ci + co + kh)
    x = _rand(rng, (n, h, w, ci), dev)
    if w_int8:
        wt = _codes(rng, (co, ci, kh, kw), dev)
        scale = torch.from_numpy(rng.uniform(1e-3, 1e-2, co).astype(np.float32)).to(dev)
    else:
        wt, scale = _rand(rng, (co, ci, kh, kw), dev), None
    bias = _rand(rng, (co,), dev)
    before = (conv2d_direct.launches, conv2d_direct.launches_f32)
    got = conv2d_direct(x, wt, scale, bias, ("relu", 0.0, 0.0), pads)
    torch.cuda.synchronize()
    assert (conv2d_direct.launches, conv2d_direct.launches_f32) == (before[0], before[1] + 1)
    want = conv2d_direct_plain(x, wt, scale, bias, ("relu", 0.0, 0.0), pads)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert (got - want).abs().max().item() <= GEMM_RTOL * want.abs().max().item()


@pytest.mark.parametrize("n,h,w,c,co,s_out,pw_act", [
    (2, 19, 19, 128, 128, 0.04, ("clamp", 0.0, 6.0)),
    (1, 10, 10, 1024, 1024, 0.04, ("clamp", 0.0, 6.0)),   # 64 KB of shared memory
    (3, 9, 11, 20, 40, None, None),                       # float32 out
    (1, 7, 9, 6, 16, 0.04, ("relu", 0.0, 0.0)),           # C % 4 != 0
])
def test_dw_pw_fused_kernel_equals_plain(n, h, w, c, co, s_out, pw_act):
    """Kernel 4: exact int32 sums and the same epilogues, so no difference."""
    from pyopenvino_tpu_torch.kernels.dw_pw import dw_pw_fused, dw_pw_fused_plain
    from pyopenvino_tpu_torch.tools.microbench_dw_pw import make_inputs

    _card()
    args = make_inputs(n, h, w, c, co, seed=c + co)
    kw = dict(dw_act=("clamp", 0.0, 6.0), pw_act=pw_act, s_mid=0.05, s_out=s_out)
    before = dw_pw_fused.launches
    got = dw_pw_fused(*args, **kw)
    torch.cuda.synchronize()
    assert dw_pw_fused.launches == before + 1
    want = dw_pw_fused_plain(*args, **kw)
    assert got.dtype == (torch.int8 if s_out else torch.float32) and got.shape == want.shape
    assert (got.double() - want.double()).abs().max().item() == 0


def test_dw_pw_fused_refusals():
    from pyopenvino_tpu_torch.kernels.dw_pw import dw_pw_fused
    from pyopenvino_tpu_torch.tools.microbench_dw_pw import make_inputs

    _card()
    x, wdw, dws, dwb, wpw, pws, pwb = make_inputs(1, 5, 5, 8, 16)
    kw = dict(s_mid=0.05)
    with pytest.raises(ValueError, match="takes int8"):
        dw_pw_fused(x.float(), wdw, dws, dwb, wpw, pws, pwb, **kw)
    with pytest.raises(ValueError, match="do not match"):
        dw_pw_fused(x, wdw[:, :4], dws, dwb, wpw, pws, pwb, **kw)
    with pytest.raises(ValueError, match="pw_scale"):
        dw_pw_fused(x, wdw, dws, dwb, wpw, pws.double(), pwb, **kw)
    with pytest.raises(ValueError, match="x must be"):
        dw_pw_fused(x.permute(0, 2, 1, 3), wdw, dws, dwb, wpw, pws, pwb, **kw)
    # the mid tile of C-wide rows must fit the shared memory the kernel reports
    from pyopenvino_tpu_torch.kernels.dw_pw import _max_channels

    c = _max_channels(x.device.index)
    assert 1024 <= c < 4096
    wide = make_inputs(1, 2, 2, c + 32, 16)
    with pytest.raises(ValueError, match="out of range"):
        dw_pw_fused(*wide, **kw)


def test_ssd_int8full_kernels_request_on_card():
    """One SSD INT8-FULL request on KERNELS: every quantized Convolution is
    one int8 × int8 fused_gemm launch and no other kernel runs; the record
    table equals TORCH's with int8_dataflow=False, and finds the shapes."""
    from pyopenvino_tpu_torch import IECore
    from pyopenvino_tpu_torch.config import Config, QuantMode
    from pyopenvino_tpu_torch.kernels.conv_direct import conv2d_direct
    from pyopenvino_tpu_torch.kernels.dw_pw import dw_pw_fused
    from pyopenvino_tpu_torch.kernels.gemm import fused_gemm
    from pyopenvino_tpu_torch.kernels.softmax import softmax_rows
    from pyopenvino_tpu_torch.models.shapes import shapes_det300

    _card()
    ie = IECore()
    net = ie.read_network("assets/trained/ssd_shapes_ms.xml", "assets/trained/ssd_shapes_ms.bin")
    cal, _ = shapes_det300(2, 1)
    x, _ = shapes_det300(1, 2)
    samples = [{"image_tensor": cal[i:i + 1]} for i in range(2)]

    def loaded(kernel_type, **extra):
        exe = ie.load_network(net, "GPU", config=Config(
            quant=QuantMode.INT8_FULL, quant_min_elems=4096, bias_correction=True, **extra))
        exe.kernel_type = kernel_type
        exe.set_calibration(samples)
        return exe

    kernels = loaded("kernels")
    compiled = kernels.compiled()
    quantized_convs = sum(
        1 for n in compiled.model.find_by_type("Convolution")
        if compiled.model.in_edges[n.id][1][0] in compiled._quantized)

    def counts():
        return (fused_gemm.launches_i8i8, fused_gemm.launches + fused_gemm.launches_i8w,
                conv2d_direct.launches + conv2d_direct.launches_f32, dw_pw_fused.launches,
                softmax_rows.launches)

    before = counts()
    got = kernels.infer({"image_tensor": x})["detection_boxes:0"]
    assert tuple(b - a for a, b in zip(before, counts())) == (quantized_convs, 0, 0, 0, 0)
    assert quantized_convs == 17  # the 34 Convolutions' weights of >= 4096 values
    want = loaded("torch", int8_dataflow=False).infer({"image_tensor": x})["detection_boxes:0"]
    assert got.shape == (1, 1, 100, 7)
    np.testing.assert_array_equal(got, want)
    assert got[0, 0, 0, 0] == 0 and got[0, 0, 0, 2] > 0.3  # at least one detection


# -- kernel 3f on the TF32 tensor cores, kernel 4's pointwise on int8 mma ----

# ResNet-18's stride-1 3×3 shapes at B = 1 (split K) and 64 (K up to 4608,
# one split), then chip_smoke.py's ragged ones (Ci = 3, 7, 8, 16: the
# loader's 4-byte and 16-byte paths, asymmetric pads, 5×5)
DIRECT_F32_SHAPES = [(b, hw, hw, c, c, 3, 3, P1)
                     for b in (1, 64) for hw, c, _ in chip_smoke.RESNET18_DIRECT] + \
    chip_smoke.DIRECT_F32_RAGGED


@pytest.mark.parametrize("w_int8", [False, True])
@pytest.mark.parametrize("n,h,w,ci,co,kh,kw,pads", DIRECT_F32_SHAPES)
def test_conv2d_direct_f32_tensor_cores_within_gate_and_deterministic(
        n, h, w, ci, co, kh, kw, pads, w_int8):
    """Kernel 3f on f32_mma.cuh with the implicit-im2col loader: three TF32
    terms against a float32 weight, two against an int8 one, within
    GEMM_RTOL of F.conv2d in float32 (TF32 off) at every K up to 4608, and
    the same bits on a second call (split K adds its partial sums in a fixed
    order)."""
    from pyopenvino_tpu_torch.kernels.conv import conv_weight_matrix
    from pyopenvino_tpu_torch.kernels.conv_direct import conv2d_direct, conv2d_direct_plain

    dev = _card()
    rng = np.random.default_rng(n + ci + co + kh)
    x = _rand(rng, (n, h, w, ci), dev)
    if w_int8:
        wt = _codes(rng, (co, ci, kh, kw), dev)
        scale = torch.from_numpy(rng.uniform(1e-3, 1e-2, co).astype(np.float32)).to(dev)
    else:
        wt, scale = _rand(rng, (co, ci, kh, kw), dev), None
    bias = _rand(rng, (co,), dev)
    act = (("relu", 0.0, 0.0), None)[(ci + n) % 2]
    before = conv2d_direct.launches_f32
    got = conv2d_direct(x, wt, scale, bias, act, pads)
    again = conv2d_direct(x, wt, scale, bias, act, pads, wmat=conv_weight_matrix(wt))
    torch.cuda.synchronize()
    assert conv2d_direct.launches_f32 == before + 2  # one per call, split or not
    want = conv2d_direct_plain(x, wt, scale, bias, act, pads)
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= GEMM_RTOL * want.abs().max().item()
    assert torch.equal(got, again)


@pytest.mark.parametrize("tile_rows", [64, 128])
@pytest.mark.parametrize("n,h,w,c,co", [
    (3, 5, 7, 20, 40),     # C % 16 != 0 (4-byte loads), M = 105 not a multiple of the tile
    (2, 9, 9, 48, 100),    # C % 32 != 0, Co % 64 != 0
    (1, 7, 9, 6, 16),      # C % 4 != 0: byte loads, the ring's byte path
    (2, 19, 19, 128, 72),  # Co a multiple of 8, not of 64
    (1, 19, 19, 512, 512),  # ring and mid tile above 48 KB together (64 rows)
    (1, 10, 10, 1024, 1024),  # the published 10x10x1024 pair
    (2, 3, 3, 0, 72),      # C at dw_pw_max_channels (0 stands for it)
])
def test_dw_pw_fused_kernel_edges_equal_plain(n, h, w, c, co, tile_rows):
    """Kernel 4's pointwise stage on int8 mma.sync over the mid tile in
    shared memory: exact at ragged C, Co and M, with either tile height,
    int8 and float32 out, and with the K-major weight cached or not."""
    from pyopenvino_tpu_torch.kernels.dw_pw import _max_channels, dw_pw_fused, dw_pw_fused_plain
    from pyopenvino_tpu_torch.tools.microbench_dw_pw import make_inputs

    dev = _card()
    c = c or _max_channels(dev.index or 0, tile_rows)
    args = make_inputs(n, h, w, c, co, seed=c + co + tile_rows)
    wmat = args[4].t().contiguous().t()
    for s_out, pw_act in ((0.04, ("clamp", 0.0, 6.0)), (None, ("relu", 0.0, 0.0))):
        kw = dict(dw_act=("clamp", 0.0, 6.0), pw_act=pw_act, s_mid=0.05, s_out=s_out)
        got = dw_pw_fused(*args, tile_rows=tile_rows, **kw)
        cached = dw_pw_fused(*args, tile_rows=tile_rows, wmat=wmat, **kw)
        torch.cuda.synchronize()
        want = dw_pw_fused_plain(*args, **kw)
        assert got.shape == want.shape and got.dtype == want.dtype
        assert (got.double() - want.double()).abs().max().item() == 0
        assert torch.equal(got, cached)


def test_dw_pw_fused_refuses_row_major_wmat_and_counts_stage_clocks():
    from pyopenvino_tpu_torch.kernels.dw_pw import dw_pw_fused
    from pyopenvino_tpu_torch.tools.microbench_dw_pw import make_inputs

    dev = _card()
    args = make_inputs(2, 19, 19, 128, 128)
    with pytest.raises(ValueError, match="K-major"):
        dw_pw_fused(*args, s_mid=0.05, wmat=args[4])  # row-major (C, Co)
    with pytest.raises(ValueError, match="tile_rows"):
        dw_pw_fused(*args, s_mid=0.05, tile_rows=96)
    clocks = torch.zeros(2, dtype=torch.int64, device=dev)
    dw_pw_fused(*args, s_mid=0.05, clocks=clocks)
    torch.cuda.synchronize()
    assert (clocks > 0).all()


# #1, #1w, #1ii and #3 after the shared loops were refactored for 3f and #4
# (f32_mma.cuh's A loader, i8_mma.cuh's warp step), and #1b, #1bw and #4
# after bf16_mma.cuh's loop took an A loader and dw_pw.cu's store an output
# type (3f-bf16, 4-bf16): each case's output digest, recorded from the
# kernels before each change on an H100 (golden_digests() run in that tree).
# #1b and #1bw at 784x64x128 and 3136x960x160 run on bf16_wgmma.cuh since
# it came (kernels/gemm.py::bf16_route): their digests are that loop's (its
# sums in another order; #1bw at 784x64x128 came out the same bits), the
# others' still the mma.sync loop's, and 3f-bf16's were recorded on the
# tree before bf16_wgmma.cuh and are pinned to the mma.sync loop
# (conv_loop="mma") since i8_wgmma.cuh took bf16 operands; the same
# launches forced onto that loop ("wgmma" keys) were recorded from it on an
# H100, its float32 sums in another order.  #3's batch-64 digests of each ResNet-18
# width, float32 and bf16 out, were recorded from i8_mma.cuh's loop before
# i8_wgmma.cuh came; the route now sends them to the new loop, whose int32
# sums are exact, so they must not change.  #1ii's and #1ii-bf16's at R's
# six batch-64 shapes that i8_route sends to i8_wgmma.cuh's tiled loader
# were recorded from i8_mma.cuh's loop (golden_digests() run in the tree
# before that loader), likewise.  #1 and #1w at 3136x960x160 run on
# f32_wgmma.cuh since it came (kernels/gemm.py::f32_route): its plan cuts K
# in three splits where the old loop's split_k cut it in its own, so the
# float32 sums add in another order, and their digests are the new loop's,
# recorded from it on an H100; at 3136x256x512 both loops sum K in one
# split, in the same k8 steps and passes, and the new loop gives the old
# digests; the other #1 and #1w cases stay off the route (below
# F32_WGMMA_MIN_MACS, lda 97 or 77) and keep the old loop's
GOLDEN = {
    "fused_gemm 784x64x128 lda=64": "206b241709cce3ef",
    "fused_gemm_i8w 784x64x128 lda=64": "db9f2fa3f857618c",
    "fused_gemm 3136x256x512 lda=256": "a57d130d937b2829",
    "fused_gemm_i8w 3136x256x512 lda=256": "e919a35e78b5b639",
    "fused_gemm 1x512x1000 lda=512": "15c2400252d52b8a",
    "fused_gemm_i8w 1x512x1000 lda=512": "bd4340579f4436ed",
    "fused_gemm 65x96x130 lda=97": "c401870147213dc6",
    "fused_gemm_i8w 65x96x130 lda=97": "d019d30637092e51",
    "fused_gemm 3136x960x160 lda=960": "5134bee906b4feb6",
    "fused_gemm_i8w 3136x960x160 lda=960": "eff2a10508d4b134",
    "fused_gemm 64x1280x1000 lda=1280": "fc9a65827d621bc7",
    "fused_gemm_i8w 64x1280x1000 lda=1280": "914997e5db0fc8c9",
    "fused_gemm 37x77x129 lda=77": "e7e5adebf8ad1b78",
    "fused_gemm_i8w 37x77x129 lda=77": "48ce85e1298b0fba",
    "fused_gemm_i8i8 784x576x128": "be9f63c9175a3258",
    "fused_gemm_i8i8 49x2304x512": "6993c24667ef2009",
    "fused_gemm_i8i8 12544x147x64": "92721e97ce20e877",
    "fused_gemm_i8i8 65x33x131": "d7b96224c21e48a0",
    "conv2d_direct 1x14x14x256->256": "28e4a20e17c2b701",
    "conv2d_direct 2x56x56x64->64": "539cb0b0f806f5b6",
    "conv2d_direct 3x9x9x3->70": "ce687471082ec677",
    "conv2d_direct 64x56x56x64->64 float32": "7567db32d05473cb",
    "conv2d_direct 64x56x56x64->64 bfloat16": "45e08523e6906435",
    "conv2d_direct 64x28x28x128->128 float32": "b50750d965418e48",
    "conv2d_direct 64x28x28x128->128 bfloat16": "5ab1db5a63b21aab",
    "conv2d_direct 64x14x14x256->256 float32": "d1b52ff90ffa3236",
    "conv2d_direct 64x14x14x256->256 bfloat16": "c1da019d2a9ef056",
    "conv2d_direct 64x7x7x512->512 float32": "821982772cb26600",
    "conv2d_direct 64x7x7x512->512 bfloat16": "11bc9f623ba88603",
    "dw_pw_fused 1x10x10x48->100 float32 tile_rows=128": "17f2b0607585acde",
    "dw_pw_fused 1x10x10x48->100 float32 tile_rows=64": "17f2b0607585acde",
    "dw_pw_fused 1x10x10x48->100 int8 tile_rows=128": "494988709cf335a0",
    "dw_pw_fused 1x10x10x48->100 int8 tile_rows=64": "494988709cf335a0",
    "dw_pw_fused 2x19x19x128->128 float32 tile_rows=128": "c81d819d561c5d75",
    "dw_pw_fused 2x19x19x128->128 float32 tile_rows=64": "c81d819d561c5d75",
    "dw_pw_fused 2x19x19x128->128 int8 tile_rows=128": "320f0031280d79e5",
    "dw_pw_fused 2x19x19x128->128 int8 tile_rows=64": "320f0031280d79e5",
    "fused_gemm_bf16 1x512x1000 lda=512": "060b52b3b22d7019",
    "fused_gemm_bf16 3136x960x160 lda=960": "e211591d936d506e",
    "fused_gemm_bf16 37x77x129 lda=77": "bcea3aa098b78fff",
    "fused_gemm_bf16 49x2304x512 lda=2304": "558a1310ddde199a",
    "fused_gemm_bf16 65x96x130 lda=97": "74497ca45e07dac3",
    "fused_gemm_bf16 784x64x128 lda=64": "93518bdbd85e87eb",
    "fused_gemm_bf16_i8w 1x512x1000 lda=512": "071e00743d2c3ba8",
    "fused_gemm_bf16_i8w 3136x960x160 lda=960": "19d839b2f324cd71",
    "fused_gemm_bf16_i8w 37x77x129 lda=77": "c31c078dcea1198a",
    "fused_gemm_bf16_i8w 49x2304x512 lda=2304": "bab90f9ada4ce942",
    "fused_gemm_bf16_i8w 65x96x130 lda=97": "c6f397390c20bfd1",
    "fused_gemm_bf16_i8w 784x64x128 lda=64": "4ae3c46c8e85d794",
    "conv2d_direct_float_bf16 8x28x28x64->128": "81b729f285bc86c7",
    "conv2d_direct_float_bf16_i8w 8x28x28x64->128": "7a355364742383c6",
    "conv2d_direct_float_bf16 1x14x14x256->256": "a256c38b20324003",
    "conv2d_direct_float_bf16_i8w 1x14x14x256->256": "38c9fb386e170bd5",
    "conv2d_direct_float_bf16 8x28x28x64->128 wgmma": "7b0e0ab26be60fa4",
    "conv2d_direct_float_bf16_i8w 8x28x28x64->128 wgmma": "855c26ad8ed61127",
    "conv2d_direct_float_bf16 1x14x14x256->256 wgmma": "cfe8ba5fcf6f2b84",
    "conv2d_direct_float_bf16_i8w 1x14x14x256->256 wgmma": "a17a856587f9a1a8",
    "fused_gemm_i8i8 50176x576x128 float32": "04df596de32e2119",
    "fused_gemm_i8i8 50176x576x128 bfloat16": "5089bf3495ab40b0",
    "fused_gemm_i8i8 12544x1152x256 float32": "b9601c325208e680",
    "fused_gemm_i8i8 12544x1152x256 bfloat16": "d93ad87f0dee897f",
    "fused_gemm_i8i8 3136x2304x512 float32": "f6e72beefe030ab3",
    "fused_gemm_i8i8 3136x2304x512 bfloat16": "23cfe7f85d594b5e",
    "fused_gemm_i8i8 50176x64x128 float32": "4d21e6064c43fc30",
    "fused_gemm_i8i8 50176x64x128 bfloat16": "802e7d661febcdc4",
    "fused_gemm_i8i8 12544x128x256 float32": "02c0722d68dd22b7",
    "fused_gemm_i8i8 12544x128x256 bfloat16": "f95c7936f5fc1cdd",
    "fused_gemm_i8i8 3136x256x512 float32": "ef6101bbb18a047a",
    "fused_gemm_i8i8 3136x256x512 bfloat16": "41b595942e6a8281",
}


# R's int8 × int8 launches at batch 64 but the K = 147 stem and the FC,
# (M, K, N): the three 3×3/s2 convs' patches and the three 1×1/s2 shortcuts
R_ROUTED_I8I8 = [(m, k, n) for m, k, n, _ in chip_smoke.i8i8_gemms("resnet18", 64)[1:7]]


def golden_digests():
    """{case: sha256 of the output bytes, 16 hex digits} of fixed seeded
    launches of #1, #1w, #1ii (on both its loops), #1ii-bf16, #3 (on both
    its loops), #3-bf16, #1b, #1bw and #4 (int8 and float32 out):
    split K, 4-byte rows and the byte path among them.  Runs against
    whichever pyopenvino_tpu_torch is imported."""
    import hashlib

    from pyopenvino_tpu_torch.kernels.conv import conv_weight_matrix_nk
    from pyopenvino_tpu_torch.kernels.conv_direct import conv2d_direct
    from pyopenvino_tpu_torch.kernels.dw_pw import dw_pw_fused
    from pyopenvino_tpu_torch.kernels.gemm import fused_gemm
    from pyopenvino_tpu_torch.tools.microbench_dw_pw import make_inputs

    dev = torch.device("cuda")
    out = {}

    def digest(name, t):
        torch.cuda.synchronize()
        if t.dtype == torch.bfloat16:  # numpy has no bfloat16: the same bytes as int16
            t = t.view(torch.int16)
        out[name] = hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]

    for m, k, n, lda in [(784, 64, 128, 64), (3136, 256, 512, 256), (1, 512, 1000, 512),
                         (65, 96, 130, 97), (3136, 960, 160, 960), (64, 1280, 1000, 1280),
                         (37, 77, 129, 77)]:
        rng = np.random.default_rng(m + k + n)
        a, bias = _rand(rng, (m, lda), dev)[:, :k], _rand(rng, (n,), dev)
        scale = torch.from_numpy(rng.uniform(1e-3, 1e-2, n).astype(np.float32)).to(dev)
        digest(f"fused_gemm {m}x{k}x{n} lda={lda}",
               fused_gemm(a, _rand(rng, (k, n), dev), None, bias, ("relu", 0.0, 0.0)))
        digest(f"fused_gemm_i8w {m}x{k}x{n} lda={lda}",
               fused_gemm(a, _codes(rng, (k, n), dev), scale, bias))
    for m, k, n in [(784, 576, 128), (49, 2304, 512), (12544, 147, 64), (65, 33, 131)]:
        rng = np.random.default_rng(m * k + n)
        scale = torch.from_numpy(rng.uniform(1e-4, 1e-2, n).astype(np.float32)).to(dev)
        digest(f"fused_gemm_i8i8 {m}x{k}x{n}",
               fused_gemm(_codes(rng, (m, k), dev), _codes(rng, (n, k), dev).t(), scale,
                          _rand(rng, (n,), dev), ("clamp", 0.0, 6.0)))
    # #1ii and #1ii-bf16 at R's six batch-64 shapes that
    # kernels/gemm.py::i8_route sends to i8_wgmma.cuh (all but the K = 147
    # stem and the FC): recorded from i8_mma.cuh's loop before the new loop
    # came, so they pin it to the old loop's bits
    for m, k, n in R_ROUTED_I8I8:
        rng = np.random.default_rng(m + k + n + 64)
        a, b = _codes(rng, (m, k), dev), _codes(rng, (n, k), dev).t()
        scale = torch.from_numpy(rng.uniform(1e-4, 1e-2, n).astype(np.float32)).to(dev)
        bias = _rand(rng, (n,), dev)
        for out_dtype in (torch.float32, torch.bfloat16):
            digest(f"fused_gemm_i8i8 {m}x{k}x{n} {str(out_dtype)[6:]}",
                   fused_gemm(a, b, scale, bias, ("relu", 0.0, 0.0), out_dtype=out_dtype))
    for n, hw, ci, co in [(1, 14, 256, 256), (2, 56, 64, 64), (3, 9, 3, 70)]:
        rng = np.random.default_rng(n + hw + ci)
        wt = _codes(rng, (co, ci, 3, 3), dev)
        scale = torch.from_numpy(rng.uniform(1e-4, 1e-2, co).astype(np.float32)).to(dev)
        digest(f"conv2d_direct {n}x{hw}x{hw}x{ci}->{co}",
               conv2d_direct(_codes(rng, (n, hw, hw, ci), dev), wt, scale,
                             _rand(rng, (co,), dev), None, P1,
                             wmat=conv_weight_matrix_nk(wt).t()))
    # #3 and #3-bf16 at one batch-64 shape of each ResNet-18 width, the
    # shapes kernels/conv_direct.py::direct_route sends to i8_wgmma.cuh:
    # recorded from i8_mma.cuh's loop before the new loop came, so they pin
    # it to the old loop's bits (int32 sums are exact in any order)
    for hw, c, _ in chip_smoke.RESNET18_DIRECT:
        rng = np.random.default_rng(64 + hw + c)
        x, wt = _codes(rng, (64, hw, hw, c), dev), _codes(rng, (c, c, 3, 3), dev)
        scale = torch.from_numpy(rng.uniform(1e-4, 1e-2, c).astype(np.float32)).to(dev)
        bias, wmat = _rand(rng, (c,), dev), conv_weight_matrix_nk(wt).t()
        for out_dtype in (torch.float32, torch.bfloat16):
            digest(f"conv2d_direct 64x{hw}x{hw}x{c}->{c} {str(out_dtype)[6:]}",
                   conv2d_direct(x, wt, scale, bias, ("relu", 0.0, 0.0), P1, wmat=wmat,
                                 out_dtype=out_dtype))
    # the bf16 loop's row-major A (its loader contract since 3f-bf16):
    # split K, an lda that is not a multiple of 8 (the value-by-value path),
    # ragged N; bfloat16 and int8 B
    for m, k, n, lda in [(784, 64, 128, 64), (1, 512, 1000, 512), (49, 2304, 512, 2304),
                         (65, 96, 130, 97), (3136, 960, 160, 960), (37, 77, 129, 77)]:
        rng = np.random.default_rng(m + k + n + 1)
        a, bias = _rand(rng, (m, lda), dev)[:, :k].bfloat16(), _rand(rng, (n,), dev)
        scale = torch.from_numpy(rng.uniform(1e-3, 1e-2, n).astype(np.float32)).to(dev)
        digest(f"fused_gemm_bf16 {m}x{k}x{n} lda={lda}",
               fused_gemm(a, _rand(rng, (k, n), dev).bfloat16(), None, bias,
                          ("relu", 0.0, 0.0)))
        digest(f"fused_gemm_bf16_i8w {m}x{k}x{n} lda={lda}",
               fused_gemm(a, _codes(rng, (k, n), dev), scale, bias))
    # 3f-bf16, the other kernel on the bf16 loop: one split and split K,
    # bfloat16 and int8 w; recorded on the mma.sync loop before the wgmma
    # loop came and pinned to it (conv_loop="mma"), then the same launches
    # forced onto the wgmma loop (its float32 sums in another order: keys
    # of their own, recorded from it on an H100)
    for n, hw, ci, co in [(8, 28, 64, 128), (1, 14, 256, 256)]:
        rng = np.random.default_rng(n + hw + ci + co)
        x, bias = _rand(rng, (n, hw, hw, ci), dev).bfloat16(), _rand(rng, (co,), dev)
        scale = torch.from_numpy(rng.uniform(1e-3, 1e-2, co).astype(np.float32)).to(dev)
        wb, wq = _rand(rng, (co, ci, 3, 3), dev).bfloat16(), _codes(rng, (co, ci, 3, 3), dev)
        for loop, tag in (("mma", ""), ("wgmma", " wgmma")):
            digest(f"conv2d_direct_float_bf16 {n}x{hw}x{hw}x{ci}->{co}{tag}",
                   conv2d_direct(x, wb, None, bias, ("relu", 0.0, 0.0), P1, conv_loop=loop))
            digest(f"conv2d_direct_float_bf16_i8w {n}x{hw}x{hw}x{ci}->{co}{tag}",
                   conv2d_direct(x, wq, scale, bias, None, P1, conv_loop=loop))
    # dw_pw.cu's store (its output type a template argument since 4-bf16):
    # int8 and float32 out, both tile heights
    for b, hw, c, co in [(2, 19, 128, 128), (1, 10, 48, 100)]:
        args = make_inputs(b, hw, hw, c, co, seed=hw + c)
        for rows in (64, 128):
            digest(f"dw_pw_fused {b}x{hw}x{hw}x{c}->{co} int8 tile_rows={rows}",
                   dw_pw_fused(*args, pw_act=("clamp", 0.0, 6.0), s_mid=0.05, s_out=0.04,
                               tile_rows=rows))
            digest(f"dw_pw_fused {b}x{hw}x{hw}x{c}->{co} float32 tile_rows={rows}",
                   dw_pw_fused(*args, s_mid=0.05, tile_rows=rows))
    return out


def test_unchanged_kernels_keep_their_bits():
    _card()
    assert golden_digests() == GOLDEN


# -- slice 3: EfficientNet-B0 and googlenet_shapes --------------------------

# EfficientNet-B0's 32 squeeze-and-excitation 1×1 convs under INT8-FULL:
# one pixel per image, (K, N) with the SE width max(1, ci // 4) as N (the
# squeeze) or K (the excite); rows of K bytes that are not 16-byte aligned
EFFICIENTNET_SE = [(4, 96), (6, 144), (8, 32), (10, 240), (20, 480), (28, 672), (32, 8),
                   (48, 1152), (96, 4), (144, 6), (240, 10), (480, 20), (672, 28), (1152, 48)]
# googlenet_shapes' 19 conv2d_direct launches under INT8-FULL, (H, W, Ci, Co,
# kh, kw, pads): 5×5 with Ci = 4, 6, 8, 12 and 3×3 with Ci = 16 … 48
P2 = ((2, 2), (2, 2))
GOOGLENET_DIRECT = [
    (7, 7, 8, 32, 5, 5, P2), (7, 7, 12, 32, 5, 5, P2), (7, 7, 40, 80, 3, 3, P1),
    (7, 7, 48, 96, 3, 3, P1), (14, 14, 4, 12, 5, 5, P2), (14, 14, 6, 16, 5, 5, P2),
    (14, 14, 8, 16, 5, 5, P2), (14, 14, 8, 32, 5, 5, P2), (14, 14, 24, 52, 3, 3, P1),
    (14, 14, 28, 56, 3, 3, P1), (14, 14, 32, 64, 3, 3, P1), (14, 14, 36, 72, 3, 3, P1),
    (14, 14, 40, 80, 3, 3, P1), (28, 28, 4, 8, 5, 5, P2), (28, 28, 8, 24, 5, 5, P2),
    (28, 28, 24, 32, 3, 3, P1), (28, 28, 32, 48, 3, 3, P1), (56, 56, 16, 48, 3, 3, P1)]


@pytest.mark.parametrize("m", [1, 64])
@pytest.mark.parametrize("k,n", EFFICIENTNET_SE)
def test_i8i8_se_shapes_equal_plain(k, n, m):
    """#1ii at the SE shapes, batch 1 and 64: tiny K and N, the byte path."""
    from pyopenvino_tpu_torch.kernels.gemm import fused_gemm, fused_gemm_plain

    dev = _card()
    rng = np.random.default_rng(m * k + n)
    a = _codes(rng, (m, k), dev)
    b = _codes(rng, (n, k), dev).t()
    scale = torch.from_numpy(rng.uniform(1e-4, 1e-2, n).astype(np.float32)).to(dev)
    got = fused_gemm(a, b, scale, None, None)
    torch.cuda.synchronize()
    assert (got - fused_gemm_plain(a, b, scale, None, None)).abs().max().item() == 0


@pytest.mark.parametrize("n", [1, 64])
@pytest.mark.parametrize("h,w,ci,co,kh,kw,pads", GOOGLENET_DIRECT)
def test_conv2d_direct_googlenet_shapes_equal_plain(h, w, ci, co, kh, kw, pads, n):
    """#3 at googlenet_shapes' convs: the loader's byte path (Ci = 6), its
    4-byte path (Ci = 4, 8, 12, 28, 36) and 16-byte chunks (Ci = 16 … 48)."""
    test_conv2d_direct_kernel_equals_plain(n, h, w, ci, co, kh, kw, pads)


@pytest.mark.parametrize("model,quant", [
    ("efficientnet_b0", "none"), ("efficientnet_b0", "int8w"), ("efficientnet_b0", "int8"),
    ("googlenet_shapes", "none"), ("googlenet_shapes", "int8w"), ("googlenet_shapes", "int8")])
def test_slice3_paths_kernels_vs_torch_on_card(model, quant):
    """KERNELS against TORCH on the card at batch 4, with the launches of
    chip_smoke.compiled_per_forward; INT8-FULL against TORCH with
    int8_dataflow=False, which quantizes where KERNELS does."""
    from pyopenvino_tpu_torch import IECore
    from pyopenvino_tpu_torch.config import Config, QuantMode
    from pyopenvino_tpu_torch.models.efficientnet_b0 import efficientnet_b0_paths

    _card()
    ie = IECore()
    paths = (efficientnet_b0_paths(seed=0) if model == "efficientnet_b0"
             else chip_smoke.GOOGLENET_PATHS)
    net = ie.read_network(*paths)
    out = net.model.results[0].name
    rng = np.random.default_rng(1)
    samples = [{"data": rng.uniform(0, 255, (1, 3, 224, 224)).astype(np.float32)}
               for _ in range(2)]
    x = rng.uniform(0, 255, (4, 3, 224, 224)).astype(np.float32)
    extra = {"bias_correction": True} if model == "googlenet_shapes" and quant == "int8" else {}

    def loaded(kernel_type, **config):
        exe = ie.load_network(net, "GPU", config=Config(quant=QuantMode(quant), **extra,
                                                        **config))
        exe.kernel_type = kernel_type
        if quant == "int8":
            exe.set_calibration(samples)
        return exe

    kernels = loaded("kernels")
    counters = chip_smoke.launch_counts
    before = counters()
    got = kernels.infer_batch({"data": x})[out]
    after = counters()
    assert {k: after[k] - before[k] for k in after} == chip_smoke.compiled_per_forward(
        kernels.compiled(), quant, 1)
    want = loaded("torch", int8_dataflow=False).infer_batch({"data": x})[out]
    assert got.shape == (4, net.outputs[0]["shape"][-1]) and np.isfinite(got).all()
    rtol, atol = (1e-5, 1e-7) if quant == "int8" else (1e-3, 1e-5)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    assert (got.argmax(1) == want.argmax(1)).all()


# -- bfloat16 compute ------------------------------------------------------------

@pytest.mark.parametrize("m,k,n,lda", [
    (1, 512, 1000, 512), (64, 512, 1000, 512), (784 * 64, 64, 128, 64), (49, 2304, 512, 2304),
    (196 * 64, 96, 576, 96), (65, 96, 130, 97), (37, 77, 129, 77), (3, 1, 5, 1),
])
@pytest.mark.parametrize("int8_b", [False, True], ids=["bf16_b", "int8_b"])
def test_bf16_fused_gemm_kernels_vs_plain(m, k, n, lda, int8_b):
    """fused_gemm_bf16 and fused_gemm_bf16_i8w within one bfloat16 step of
    the plain version, or the float32 sums' worst-case error where the sum
    cancels (chip_smoke.bf16_steps, gemm_floor), the same bits twice."""
    from pyopenvino_tpu_torch.kernels.gemm import fused_gemm, fused_gemm_plain

    dev = _card()
    rng = np.random.default_rng(m + k + n)
    a = _rand(rng, (m, lda), dev)[:, :k].bfloat16()
    if int8_b:
        b = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8)).to(dev)
        scale = _rand(rng, (n,), dev).abs().bfloat16() * 0.01
    else:
        b, scale = _rand(rng, (k, n), dev).bfloat16(), None
    bias = _rand(rng, (n,), dev).bfloat16()
    counter = "launches_bf16_i8w" if int8_b else "launches_bf16"
    before = getattr(fused_gemm, counter)
    got = fused_gemm(a, b, scale, bias, ("relu", 0.0, 0.0))
    torch.cuda.synchronize()
    assert getattr(fused_gemm, counter) == before + 1 and got.dtype == torch.bfloat16
    worst, _, _ = chip_smoke.bf16_steps(
        torch, got, fused_gemm_plain(a, b, scale, bias, ("relu", 0.0, 0.0)),
        chip_smoke.gemm_floor(torch, a, b, scale))
    assert worst <= 1.0
    assert torch.equal(got, fused_gemm(a, b, scale, bias, ("relu", 0.0, 0.0)))


def _wgmma_case(m, k, n, int8_b, act, loop):
    """fused_gemm's bf16 variant on ``loop`` ("wgmma", "mma" or None for the
    route) against the plain version: within one bfloat16 step (or
    gemm_floor), the same bits twice.  Returns the route's plan."""
    from pyopenvino_tpu_torch.kernels.gemm import bf16_route, fused_gemm, fused_gemm_plain

    dev = _card()
    rng = np.random.default_rng(7 * m + 3 * k + n)
    a = _rand(rng, (m, k), dev).bfloat16()
    if int8_b:
        b = _codes(rng, (k, n), dev)
        scale = torch.from_numpy(rng.uniform(1e-3, 2e-2, n).astype(np.float32)).to(dev)
    else:
        b, scale = _rand(rng, (k, n), dev).bfloat16(), None
    bias = _rand(rng, (n,), dev)
    got = fused_gemm(a, b, scale, bias, act, bf16_loop=loop)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    worst, _, _ = chip_smoke.bf16_steps(torch, got, fused_gemm_plain(a, b, scale, bias, act),
                                        chip_smoke.gemm_floor(torch, a, b, scale))
    assert worst <= 1.0
    assert torch.equal(got, fused_gemm(a, b, scale, bias, act, bf16_loop=loop))
    return bf16_route(m, k, n, k, a.data_ptr(), b.data_ptr(), int8_b)


def _path_shapes():
    return sorted({(m, k, n) for gemms in chip_smoke.GEMMS.values() for b in (1, chip_smoke.BATCH)
                   for m, k, n, _ in gemms(b)})


@pytest.mark.parametrize("int8_b", [False, True], ids=["bf16_b", "int8_b"])
def test_bf16_wgmma_route_at_resnet18_and_mobilenet_v2_path_shapes(int8_b):
    """Every R and M #1b / #1bw shape at B = 1 and 64 as the route sends it:
    the wgmma loop from WGMMA_MIN_M rows on (WGMMA_MIN_M_I8 with an int8 B,
    whose FCs' 1000 columns are no TMA row stride), the mma.sync loop below."""
    from pyopenvino_tpu_torch.kernels.gemm import WGMMA_MIN_M, WGMMA_MIN_M_I8

    for i, (m, k, n) in enumerate(_path_shapes()):
        act = (None, ("relu", 0.0, 0.0), ("clamp", -0.5, 0.5))[i % 3]
        plan = _wgmma_case(m, k, n, int8_b, act, None)
        wgmma = m >= (WGMMA_MIN_M_I8 if int8_b else WGMMA_MIN_M) and not (int8_b and n % 16)
        assert (plan is not None) == wgmma, (m, k, n)


@pytest.mark.parametrize("m,k,n,why", [
    (784, 64, 128, "ResNet-18's first shortcut at B = 1: 13 M tiles"),
    (200, 72, 144, "M not a multiple of 64, K not of 64, N not of the band"),
    (1000, 112, 1008, "four bands of 256, the last one 240 wide"),
    (130, 8, 8, "K and N of one wgmma step"),
    (3136, 1152, 320, "long K: B streams"),
    (3136, 320, 1280, "twenty 64-wide bands"),
    (3136, 1408, 64, "a 176 KB band: B streams"),
    (50176, 64, 128, "two blocks an SM, three tiles each"),
    (6272, 232, 232, "ShuffleNet-v2's width, a 256-wide band (int8: refused)"),
])
@pytest.mark.parametrize("int8_b", [False, True], ids=["bf16_b", "int8_b"])
@pytest.mark.parametrize("act", [None, ("relu", 0.0, 0.0), ("clamp", -0.5, 0.5)],
                         ids=["none", "relu", "clamp"])
def test_bf16_wgmma_loop_vs_plain(m, k, n, why, int8_b, act):
    if int8_b and n % 16:  # an int8 B's rows of N bytes are no TMA row stride
        with pytest.raises(RuntimeError, match="cudaError 1"):
            _wgmma_case(m, k, n, int8_b, act, "wgmma")
    else:
        _wgmma_case(m, k, n, int8_b, act, "wgmma")


@pytest.mark.parametrize("int8_b", [False, True], ids=["bf16_b", "int8_b"])
def test_bf16_wgmma_resident_and_streamed_bands(int8_b):
    """The same product with B's band resident (K = 448 at 64 columns)
    and, where the band does not fit a block's share, streamed with A one
    k step a stage (K = 1472), each as the route sends it."""
    from pyopenvino_tpu_torch.kernels.gemm import wgmma_plan

    for k, stream in ((448, False), (1472, True)):
        assert wgmma_plan(3136, k, 64, int8_b).stream == stream
        assert _wgmma_case(3136, k, 64, int8_b, ("relu", 0.0, 0.0), None).stream == stream


def test_bf16_wgmma_refused_launch_raises():
    """A launch the wgmma loop does not take (lda not a multiple of 8),
    forced onto it, comes back as an error from the C entry point."""
    from pyopenvino_tpu_torch.kernels.gemm import fused_gemm

    dev = _card()
    a = torch.zeros((256, 100), dtype=torch.bfloat16, device=dev)[:, :96]
    assert a.stride(0) == 100
    with pytest.raises(RuntimeError, match="cudaError 1"):
        fused_gemm(a, torch.zeros((96, 128), dtype=torch.bfloat16, device=dev),
                   bf16_loop="wgmma")


@pytest.mark.parametrize("m,k,n", [(1, 512, 1000), (12544, 147, 64), (784 * 64, 64, 128),
                                   (37, 70, 129), (64, 2304, 512)])
def test_i8i8_bf16_out_kernel_equals_plain(m, k, n):
    from pyopenvino_tpu_torch.kernels.gemm import fused_gemm, fused_gemm_plain

    dev = _card()
    rng = np.random.default_rng(m + k)
    a = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8)).to(dev)
    w = torch.from_numpy(rng.integers(-127, 128, (n, k)).astype(np.int8)).to(dev).t()
    scale, bias = _rand(rng, (n,), dev).abs() * 1e-3, _rand(rng, (n,), dev).bfloat16()
    before = fused_gemm.launches_i8i8_bf16
    got = fused_gemm(a, w, scale, bias, ("relu", 0.0, 0.0), out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert fused_gemm.launches_i8i8_bf16 == before + 1 and got.dtype == torch.bfloat16
    assert torch.equal(got, fused_gemm_plain(a, w, scale, bias, ("relu", 0.0, 0.0),
                                             out_dtype=torch.bfloat16))


@pytest.mark.parametrize("n,hw,c", [(1, 56, 64), (64, 14, 256), (1, 7, 512), (3, 9, 3)])
def test_conv2d_direct_bf16_out_kernel_equals_plain(n, hw, c):
    from pyopenvino_tpu_torch.kernels.conv import conv_weight_matrix_nk
    from pyopenvino_tpu_torch.kernels.conv_direct import conv2d_direct, conv2d_direct_plain

    dev = _card()
    rng = np.random.default_rng(n + hw + c)
    x = torch.from_numpy(rng.integers(-127, 128, (n, hw, hw, c)).astype(np.int8)).to(dev)
    wt = torch.from_numpy(rng.integers(-127, 128, (c, c, 3, 3)).astype(np.int8)).to(dev)
    scale, bias = _rand(rng, (c,), dev).abs() * 1e-3, _rand(rng, (c,), dev)
    pads = ((1, 1), (1, 1))
    before = conv2d_direct.launches_bf16
    got = conv2d_direct(x, wt, scale, bias, None, pads, wmat=conv_weight_matrix_nk(wt).t(),
                        out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert conv2d_direct.launches_bf16 == before + 1 and got.dtype == torch.bfloat16
    assert torch.equal(got, conv2d_direct_plain(x, wt, scale, bias, None, pads,
                                                torch.bfloat16))


@pytest.mark.parametrize("m,n", [(1, 1000), (64, 1000), (512, 1000), (7, 129)])
def test_softmax_rows_bf16_kernel_vs_plain(m, n):
    from pyopenvino_tpu_torch.kernels.softmax import softmax_rows, softmax_rows_plain

    dev = _card()
    x = (_rand(np.random.default_rng(m + n), (m, n), dev) * 30).bfloat16()
    before = softmax_rows.launches_bf16
    got = softmax_rows(x)
    torch.cuda.synchronize()
    assert softmax_rows.launches_bf16 == before + 1 and got.dtype == torch.bfloat16
    assert chip_smoke.bf16_steps(torch, got, softmax_rows_plain(x))[0] <= 1.0


@pytest.mark.parametrize("n,h,w,ci,co,kh,pads", [
    (1, 7, 7, 512, 512, 3, P1),          # split K at batch 1
    (1, 14, 14, 256, 256, 3, P1),
    (64, 56, 56, 64, 64, 3, P1),         # one split, 16-byte chunks
    (1, 9, 9, 3, 5, 3, ((0, 0), (0, 0))),  # Ci = 3: value by value
    (2, 13, 12, 12, 33, 5, P2),          # Ci % 8 != 0, Co ragged, 5×5
    (3, 9, 11, 16, 70, 3, ((0, 2), (1, 0))),  # asymmetric pads
])
@pytest.mark.parametrize("int8_w", [False, True], ids=["bf16_w", "int8_w"])
def test_conv2d_direct_float_bf16_kernel_vs_plain(n, h, w, ci, co, kh, pads, int8_w):
    """Kernel 3f-bf16 (bfloat16 x, a bfloat16 or int8 weight) within one
    bfloat16 step of the plain version, or the float32 sums' bound where a
    sum cancels (chip_smoke.conv_floor), the same bits twice."""
    from pyopenvino_tpu_torch.kernels.conv_direct import conv2d_direct, conv2d_direct_plain

    dev = _card()
    rng = np.random.default_rng(n + h + ci + co)
    x = _rand(rng, (n, h, w, ci), dev).bfloat16()
    if int8_w:
        wt = torch.from_numpy(rng.integers(-127, 128, (co, ci, kh, kh)).astype(np.int8)).to(dev)
        scale = _rand(rng, (co,), dev).abs() * 1e-2
    else:
        wt, scale = _rand(rng, (co, ci, kh, kh), dev).bfloat16(), None
    bias = _rand(rng, (co,), dev)
    before = conv2d_direct.launches_float_bf16
    got = conv2d_direct(x, wt, scale, bias, ("relu", 0.0, 0.0), pads)
    torch.cuda.synchronize()
    assert conv2d_direct.launches_float_bf16 == before + 1 and got.dtype == torch.bfloat16
    worst, _, _ = chip_smoke.bf16_steps(
        torch, got, conv2d_direct_plain(x, wt, scale, bias, ("relu", 0.0, 0.0), pads),
        chip_smoke.conv_floor(torch, x, wt, scale, pads))
    assert worst <= 1.0
    assert torch.equal(got, conv2d_direct(x, wt, scale, bias, ("relu", 0.0, 0.0), pads))


@pytest.mark.parametrize("b,hw,c,co", [(1, 19, 128, 128), (64, 19, 512, 512), (3, 5, 20, 40),
                                       (1, 3, 1024, 72), (64, 150, 8, 16)])
@pytest.mark.parametrize("rows", [64, 128])
def test_dw_pw_fused_bf16_out_kernel_equals_plain(b, hw, c, co, rows):
    """Kernel 4-bf16: the pointwise epilogue rounded once to bfloat16 in
    the kernel's store, exact against the plain version at both tile
    heights; counted apart from #4."""
    from pyopenvino_tpu_torch.kernels.dw_pw import dw_pw_fused, dw_pw_fused_plain
    from pyopenvino_tpu_torch.tools.microbench_dw_pw import make_inputs

    _card()
    args = make_inputs(b, hw, hw, c, co, seed=hw + c)
    kw = dict(pw_act=None, s_mid=0.05, out_dtype=torch.bfloat16)
    before = (dw_pw_fused.launches, dw_pw_fused.launches_bf16)
    got = dw_pw_fused(*args, tile_rows=rows, **kw)
    torch.cuda.synchronize()
    assert (dw_pw_fused.launches, dw_pw_fused.launches_bf16) == (before[0], before[1] + 1)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, dw_pw_fused_plain(*args, **kw))


def test_resnet18_headline_on_card():
    """bench.py's configuration on the port: ResNet-18 behind a u8
    PrePostProcessor, INT8-FULL, bfloat16.  The input reaches the card as
    torch.uint8, KERNELS launches R's 8 + 13 int8 kernels with bfloat16
    outputs per forward, and its logits equal TORCH's with
    int8_dataflow=False."""
    from pyopenvino_tpu_torch import IECore, PrePostProcessor
    from pyopenvino_tpu_torch.config import Config, QuantMode
    from pyopenvino_tpu_torch.kernels.conv_direct import conv2d_direct
    from pyopenvino_tpu_torch.kernels.gemm import fused_gemm
    from pyopenvino_tpu_torch.models.synth import resnet18_paths

    _card()
    ie = IECore()
    ppp = PrePostProcessor(ie.read_network(*resnet18_paths(seed=0)))
    ppp.input().tensor().set_element_type("u8")
    net = ppp.build()
    rng = np.random.default_rng(4)
    x = rng.integers(0, 256, (8, 3, 224, 224), dtype=np.uint8)
    cal = [{"data": x[i:i + 1]} for i in range(2)]
    exes = {}
    for kernel_type in ("kernels", "torch"):
        exe = ie.load_network(net, "GPU", config=Config(
            quant=QuantMode.INT8_FULL, compute_dtype="bfloat16", int8_dataflow=False))
        exe.kernel_type = kernel_type
        exe.set_calibration(cal)
        exes[kernel_type] = exe
    compiled = exes["kernels"].compiled()
    param = compiled.model.parameters[0]
    t = compiled._input_tensor(x, (8, 3, 224, 224), param.outputs[param.out_port].dtype)
    assert t.dtype == torch.uint8 and t.is_cuda
    before = (fused_gemm.launches_i8i8_bf16, conv2d_direct.launches_bf16)
    exes["kernels"].infer_batch({"data": x})
    assert (fused_gemm.launches_i8i8_bf16 - before[0], conv2d_direct.launches_bf16
            - before[1]) == (8, 13)
    matmul = next(n for n in compiled.model if n.op_type == "MatMul")
    name = compiled.model.nodes[compiled._fusions[matmul.id].out_key[0]].name
    got = compiled.infer_with_capture({"data": x[:1]}, [name])[1][name]
    want = exes["torch"].compiled().infer_with_capture({"data": x[:1]}, [name])[1][name]
    np.testing.assert_array_equal(got, want)


# -- slice 14: #3 and #3-bf16 on the int8 wgmma loop (-k conv_wgmma) --------

# R's four widths at B = 64 (the route's shapes), two at B = 1 (the forced
# wgmma loop splits K there), then the wgmma loop's edges
CONV_WGMMA_SHAPES = ([(64, hw, hw, c, c, 3, 3, P1) for hw, c, _ in chip_smoke.RESNET18_DIRECT]
                     + [(1, 56, 56, 64, 64, 3, 3, P1), (1, 7, 7, 512, 512, 3, 3, P1)]
                     + chip_smoke.WGMMA_DIRECT_EDGES)


@pytest.mark.parametrize("loop", ["wgmma", "mma"])
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h,w,ci,co,kh,kw,pads", CONV_WGMMA_SHAPES)
def test_conv_wgmma_forced_loop_equals_plain(n, h, w, ci, co, kh, kw, pads, out, loop):
    """#3 (float32 out) and #3-bf16 forced onto each loop: exact int32
    sums and the same epilogue, so the plain version's bits; the same bits
    on a second call; one launch counted per call."""
    from pyopenvino_tpu_torch.kernels.conv import conv_weight_matrix_nk
    from pyopenvino_tpu_torch.kernels.conv_direct import conv2d_direct, conv2d_direct_plain

    dev = _card()
    out_dtype = getattr(torch, out)
    rng = np.random.default_rng(n * 7 + ci + co + kh)
    x, wt = _codes(rng, (n, h, w, ci), dev), _codes(rng, (co, ci, kh, kw), dev)
    scale = torch.from_numpy(rng.uniform(1e-4, 1e-2, co).astype(np.float32)).to(dev)
    bias, wmat = _rand(rng, (co,), dev), conv_weight_matrix_nk(wt).t()
    act = (("relu", 0.0, 0.0), ("clamp", 0.0, 6.0), None)[(ci + co) % 3]
    counter = "launches_bf16" if out_dtype == torch.bfloat16 else "launches"
    before = getattr(conv2d_direct, counter)
    got = conv2d_direct(x, wt, scale, bias, act, pads, wmat=wmat, out_dtype=out_dtype,
                        conv_loop=loop)
    again = conv2d_direct(x, wt, scale, bias, act, pads, wmat=wmat, out_dtype=out_dtype,
                          conv_loop=loop)
    torch.cuda.synchronize()
    assert getattr(conv2d_direct, counter) == before + 2
    assert got.dtype == out_dtype
    assert torch.equal(got, conv2d_direct_plain(x, wt, scale, bias, act, pads, out_dtype))
    assert torch.equal(got, again)


@pytest.mark.parametrize("batch", [1, 64])
def test_conv_wgmma_route_at_resnet18_shapes(batch):
    """R's convs as the route sends them: the wgmma loop at B = 64, the
    mma.sync loop at B = 1, the plain version's bits either way."""
    from pyopenvino_tpu_torch.kernels.conv import conv_weight_matrix_nk
    from pyopenvino_tpu_torch.kernels.conv_direct import (
        conv2d_direct, conv2d_direct_plain, direct_route,
    )

    dev = _card()
    for hw, c, _ in chip_smoke.RESNET18_DIRECT:
        rng = np.random.default_rng(batch + hw)
        x, wt = _codes(rng, (batch, hw, hw, c), dev), _codes(rng, (c, c, 3, 3), dev)
        scale = torch.from_numpy(rng.uniform(1e-4, 1e-2, c).astype(np.float32)).to(dev)
        wmat = conv_weight_matrix_nk(wt).t()
        route = direct_route(batch, hw, hw, c, c, 3, 3, P1, x.data_ptr(), wmat.data_ptr(),
                             torch.bfloat16)
        assert (route is not None) == (batch == 64), (batch, hw)
        got = conv2d_direct(x, wt, scale, None, ("relu", 0.0, 0.0), P1, wmat=wmat,
                            out_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        assert torch.equal(got, conv2d_direct_plain(x, wt, scale, None, ("relu", 0.0, 0.0), P1,
                                                    torch.bfloat16))


def test_conv_wgmma_forced_on_a_conv_it_does_not_take_raises():
    """Ci = 16 (half a k32 step a tap) and Co = 130 (no 16-byte output
    rows) are no convs of the wgmma loop: forcing it raises, before any
    launch; the route keeps them on the mma.sync loop."""
    from pyopenvino_tpu_torch.kernels.conv_direct import conv2d_direct

    dev = _card()
    rng = np.random.default_rng(3)
    for ci, co in ((16, 64), (64, 130)):
        x, wt = _codes(rng, (64, 14, 14, ci), dev), _codes(rng, (co, ci, 3, 3), dev)
        scale = torch.ones(co, device=dev)
        with pytest.raises(ValueError, match="does not take"):
            conv2d_direct(x, wt, scale, None, None, P1, conv_loop="wgmma")
        assert conv2d_direct(x, wt, scale, None, None, P1).shape == (64, 14, 14, co)


def test_conv_wgmma_refused_launch_raises():
    """The C entry refuses arguments the loop does not take (a channel
    slice that does not divide Ci) with cudaErrorInvalidValue; the wrapper
    raises on any such code."""
    from pyopenvino_tpu_torch.kernels import conv_direct as cd

    dev = _card()
    x = torch.zeros((2, 8, 8, 96), dtype=torch.int8, device=dev)
    wmat = torch.zeros((64, 9 * 96), dtype=torch.int8, device=dev)
    out = torch.empty((2, 8, 8, 64), device=dev)
    scale = torch.ones(64, device=dev)
    fn = cd._kernel_fn("conv2d_direct_i8_wgmma")
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(x.data_ptr(), wmat.data_ptr(), scale.data_ptr(), None, out.data_ptr(), 0,
             2, 8, 8, 96, 64, 3, 3, 8, 8, 1, 1, 0, 0.0, 0.0, 64, 64, 3, 1, 1, None, stream)
    assert err == 1  # sl = 64 does not divide Ci = 96


# -- slice 15: #1ii and #1ii-bf16 on the int8 wgmma loop (-k i8_wgmma) -------

def _i8_routed_shapes():
    """(M, K, N, out) of every #1ii launch of the seven families at B = 64
    and of the headline at 512 that kernels/gemm.py::i8_route sends to
    i8_wgmma.cuh (16-byte aligned operands, as the caching allocator gives)."""
    from pyopenvino_tpu_torch.kernels.gemm import i8_route

    launches = {(m * 64, k, n) for table in I8I8_NETS.values() for m, k, n, _ in table}
    launches |= {(m, k, n) for m, k, n, _ in chip_smoke.i8i8_gemms("resnet18", 512)}
    return sorted((m, k, n, out) for m, k, n in launches for out in ("float32", "bfloat16")
                  if i8_route(m, k, n, k, 0, 0, 0, out == "bfloat16") is not None)


def _i8_operands(rng, m, k, n, dev, lda=None):
    a = _codes(rng, (m, lda or k), dev)[:, :k]
    b = _codes(rng, (n, k), dev).t()
    scale = torch.from_numpy(rng.uniform(1e-4, 1e-2, n).astype(np.float32)).to(dev)
    return a, b, scale, _rand(rng, (n,), dev)


@pytest.mark.parametrize("m,k,n,out", _i8_routed_shapes())
def test_i8_wgmma_routed_shapes_equal_both_loops_and_plain(m, k, n, out):
    """At every routed main-path shape, float32 and bf16 out, with each
    activation: the route's launch, the wgmma loop and the mma.sync loop
    forced, and the plain version, bit for bit; one launch counted a call."""
    from pyopenvino_tpu_torch.kernels.gemm import fused_gemm, fused_gemm_plain

    dev = _card()
    out_dtype = getattr(torch, out)
    counter = "launches_i8i8_bf16" if out == "bfloat16" else "launches_i8i8"
    rng = np.random.default_rng(m + k + n)
    a, b, scale, bias = _i8_operands(rng, m, k, n, dev)
    for act in (("relu", 0.0, 0.0), ("clamp", 0.0, 6.0), None):
        want = fused_gemm_plain(a, b, scale, bias, act, out_dtype)
        before = getattr(fused_gemm, counter)
        got = {loop: fused_gemm(a, b, scale, bias, act, out_dtype=out_dtype, i8_loop=loop)
               for loop in (None, "wgmma", "mma")}
        torch.cuda.synchronize()
        assert getattr(fused_gemm, counter) == before + 3
        for loop, t in got.items():
            assert t.dtype == out_dtype
            assert torch.equal(t, want), (loop, act)


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n,lda", chip_smoke.I8_WGMMA_EDGES)
def test_i8_wgmma_edges_equal_plain(m, k, n, lda, out):
    """The wgmma loop forced at the edges (M, N and K tails, lda > K, split
    K at small M, N = 64, a ragged N up to 1000, K = 16 ... 48) and at every
    split count from one to its plan's, against the mma.sync loop and the
    plain version, bit for bit."""
    from pyopenvino_tpu_torch.kernels import gemm

    dev = _card()
    out_dtype = getattr(torch, out)
    rng = np.random.default_rng(m * 3 + k + n)
    a, b, scale, bias = _i8_operands(rng, m, k, n, dev, lda)
    want = gemm.fused_gemm_plain(a, b, scale, bias, ("relu", 0.0, 0.0), out_dtype)
    for loop in ("wgmma", "mma"):
        got = gemm.fused_gemm(a, b, scale, bias, ("relu", 0.0, 0.0), out_dtype=out_dtype,
                              i8_loop=loop)
        torch.cuda.synchronize()
        assert torch.equal(got, want), loop
    plan = gemm.i8_plan(m, k, n, 2 if out == "bfloat16" else 4)
    tiles = plan.units // plan.splits
    fn = gemm._kernel_fn("fused_gemm_i8i8_wgmma")
    for splits in range(1, max(plan.splits, 3) + 1):
        if splits > -(-k // 128):
            break
        c = torch.empty((m, n), dtype=out_dtype, device=dev)
        ws = torch.empty((splits, m, n), dtype=torch.int32, device=dev) if splits > 1 else None
        err = fn(a.data_ptr(), b.data_ptr(), scale.data_ptr(), bias.data_ptr(), c.data_ptr(),
                 m, n, k, lda, int(out == "bfloat16"), 1, 0.0, 0.0, plan.bn, plan.sl,
                 plan.stages, splits, min(tiles * splits, plan.grid),
                 ws.data_ptr() if ws is not None else None,
                 torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        assert err == 0 and torch.equal(c, want), splits


@pytest.mark.parametrize("batch", [1, 64])
def test_i8_wgmma_route_at_resnet18_shapes(batch):
    """R's int8 × int8 launches as the route sends them: the six aligned
    ones to the wgmma loop at B = 64, none at B = 1, the K = 147 stem and
    the FC never; the plain version's bits either way."""
    from pyopenvino_tpu_torch.kernels.gemm import fused_gemm, fused_gemm_plain, i8_route

    dev = _card()
    for i, (m, k, n, _) in enumerate(chip_smoke.i8i8_gemms("resnet18", batch)):
        rng = np.random.default_rng(batch + i)
        a, b, scale, bias = _i8_operands(rng, m, k, n, dev)
        route = i8_route(m, k, n, k, a.data_ptr(), b.data_ptr(), 0, True)
        assert (route is not None) == (batch == 64 and 0 < i < 7), (batch, m, k, n)
        got = fused_gemm(a, b, scale, bias, ("relu", 0.0, 0.0), out_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        assert torch.equal(got, fused_gemm_plain(a, b, scale, bias, ("relu", 0.0, 0.0),
                                                 torch.bfloat16))


def test_i8_wgmma_forced_on_a_launch_it_does_not_take_raises():
    """K = 147 (rows not 16-byte strides), N = 32 (below the tile), an A
    8 bytes off a 16-byte boundary and a bf16 C with N = 100 are no launches
    of the wgmma loop: forcing it raises before any launch; the route keeps
    them on the mma.sync loop."""
    from pyopenvino_tpu_torch.kernels.gemm import fused_gemm, fused_gemm_plain

    dev = _card()
    rng = np.random.default_rng(5)
    for m, k, n, offset, out in ((4096, 147, 64, 0, torch.float32),
                                 (4096, 64, 32, 0, torch.float32),
                                 (4096, 64, 128, 8, torch.float32),
                                 (4096, 64, 100, 0, torch.bfloat16)):
        a = _codes(rng, (m * k + 16,), dev)[offset:offset + m * k].view(m, k)
        b, scale = _codes(rng, (n, k), dev).t(), torch.ones(n, device=dev)
        with pytest.raises(ValueError, match="does not take"):
            fused_gemm(a, b, scale, out_dtype=out, i8_loop="wgmma")
        assert torch.equal(fused_gemm(a, b, scale, out_dtype=out),
                           fused_gemm_plain(a, b, scale, out_dtype=out))


def test_i8_wgmma_refused_launch_raises():
    """The C entry refuses arguments the loop does not take (K not a
    multiple of 16, a slice of 16 bytes, more splits than stages of k) with
    cudaErrorInvalidValue."""
    from pyopenvino_tpu_torch.kernels import gemm

    dev = _card()
    a = torch.zeros((256, 96), dtype=torch.int8, device=dev)
    b = torch.zeros((128, 96), dtype=torch.int8, device=dev)
    c = torch.empty((256, 128), device=dev)
    scale = torch.ones(128, device=dev)
    fn = gemm._kernel_fn("fused_gemm_i8i8_wgmma")
    stream = torch.cuda.current_stream().cuda_stream
    for k, sl, splits in ((88, 128, 1), (96, 16, 1), (96, 128, 2)):
        err = fn(a.data_ptr(), b.data_ptr(), scale.data_ptr(), None, c.data_ptr(), 256, 128,
                 k, 96, 0, 0, 0.0, 0.0, 128, sl, 3, splits, 4, None, stream)
        assert err == 1, (k, sl, splits)


# -- slice 16: #1 and #1w on the TF32 wgmma loop (-k f32_wgmma) ----------------

def _f32_routed_shapes():
    """(M, K, N, b_int8) of ResNet-18's and MobileNet-v2's #1 / #1w launches
    at B = 64 that kernels/gemm.py::f32_route sends to f32_wgmma.cuh
    (16-byte aligned operands, as the caching allocator gives)."""
    from pyopenvino_tpu_torch.kernels.gemm import f32_route

    launches = {(m, k, n) for model in chip_smoke.GEMMS
                for m, k, n, _ in chip_smoke.GEMMS[model](64)}
    return sorted((m, k, n, b_int8) for m, k, n in launches for b_int8 in (False, True)
                  if f32_route(m, k, n, k, 0, 0, 0, b_int8) is not None)


def _f32_operands(rng, m, k, n, b_int8, dev, lda=None):
    a = _rand(rng, (m, lda or k), dev)[:, :k]
    b = _codes(rng, (k, n), dev) if b_int8 else _rand(rng, (k, n), dev)
    scale = (torch.from_numpy(rng.uniform(1e-3, 2e-2, n).astype(np.float32)).to(dev)
             if b_int8 else None)
    return a, b, scale, _rand(rng, (n,), dev)


def _within_gate(got, want, b_int8):
    err = (got - want).abs().max().item() / max(want.abs().max().item(), 1e-30)
    return err <= (I8W_RTOL if b_int8 else GEMM_RTOL), err


@pytest.mark.parametrize("m,k,n,b_int8", _f32_routed_shapes())
def test_f32_wgmma_routed_shapes_within_gate_and_deterministic(m, k, n, b_int8):
    """At R's and M's routed shapes, both B types: the route's launch (the
    wgmma loop's, its bits), the wgmma loop and the mma.sync loop forced,
    each within its gate of the plain version and the same bits twice; one
    launch counted a call."""
    from pyopenvino_tpu_torch.kernels.gemm import fused_gemm, fused_gemm_plain

    dev = _card()
    counter = "launches_i8w" if b_int8 else "launches"
    rng = np.random.default_rng(m + k + n + b_int8)
    a, b, scale, bias = _f32_operands(rng, m, k, n, b_int8, dev)
    act = ("relu", 0.0, 0.0)
    want = fused_gemm_plain(a, b, scale, bias, act)
    before = getattr(fused_gemm, counter)
    got = {loop: fused_gemm(a, b, scale, bias, act, f32_loop=loop)
           for loop in (None, "wgmma", "mma")}
    again = fused_gemm(a, b, scale, bias, act, f32_loop="wgmma")
    torch.cuda.synchronize()
    assert getattr(fused_gemm, counter) == before + 4
    for loop, t in got.items():
        ok, err = _within_gate(t, want, b_int8)
        assert ok, (loop, err)
    assert torch.equal(got["wgmma"], again) and torch.equal(got[None], got["wgmma"])


def _f32_edges():
    """chip_smoke.F32_WGMMA_EDGES with each B type the wgmma loop takes
    there (an int8 B needs N a multiple of 16)."""
    from pyopenvino_tpu_torch.kernels.gemm import f32_takes

    return [(m, k, n, lda, b_int8) for m, k, n, lda in chip_smoke.F32_WGMMA_EDGES
            for b_int8 in (False, True) if f32_takes(k, n, lda, 0, 0, 0, b_int8)]


@pytest.mark.parametrize("m,k,n,lda,b_int8", _f32_edges())
def test_f32_wgmma_edges_under_every_plan(m, k, n, lda, b_int8):
    """The wgmma loop at the edges (K past a whole step with lda > K, M and
    N tails, N = 64, K below a step, split K at small M) under each band or
    stream and split count f32_plan chooses between: within the gate of the
    plain version, the same bits twice."""
    from pyopenvino_tpu_torch.kernels import gemm

    dev = _card()
    rng = np.random.default_rng(m * 3 + k + n)
    a, b, scale, bias = _f32_operands(rng, m, k, n, b_int8, dev, lda)
    want = gemm.fused_gemm_plain(a, b, scale, bias, ("relu", 0.0, 0.0))
    fn = gemm._kernel_fn("fused_gemm_f32_i8w_wgmma" if b_int8 else "fused_gemm_f32_wgmma")
    plans = {gemm.f32_plan(m, k, n, b_int8, 132, band, splits)
             for band in (None, False) for splits in (None, 1, 3)} - {None}
    assert plans
    for plan in plans:
        outs = []
        for _ in range(2):
            c = torch.empty((m, n), device=dev)
            ws = torch.empty((plan.splits, m, n), device=dev) if plan.splits > 1 else None
            err = fn(a.data_ptr(), b.data_ptr(), scale.data_ptr() if b_int8 else None,
                     bias.data_ptr(), c.data_ptr(), m, n, k, lda, 1, 0.0, 0.0, plan.stages,
                     plan.splits, int(plan.band), plan.grid,
                     ws.data_ptr() if ws is not None else None,
                     torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            assert err == 0, plan
            outs.append(c)
        ok, rel = _within_gate(outs[0], want, b_int8)
        assert ok and torch.equal(outs[0], outs[1]), (plan, rel)


def test_f32_wgmma_forced_on_a_launch_it_does_not_take_raises():
    """lda = 97 (rows not 16-byte strides), N = 62 (below the tile and not
    a multiple of 4), an A 8 bytes off a 16-byte boundary and an int8 B with
    N = 200 (not a multiple of 16) are no launches of the wgmma loop: forcing
    it raises before any launch; the route keeps them on the mma.sync loop,
    within the gate."""
    from pyopenvino_tpu_torch.kernels.gemm import fused_gemm, fused_gemm_plain

    dev = _card()
    rng = np.random.default_rng(6)
    for m, k, n, lda, offset, b_int8 in ((4096, 96, 128, 97, 0, False),
                                         (4096, 64, 62, 64, 0, False),
                                         (4096, 64, 128, 64, 2, False),
                                         (4096, 96, 200, 96, 0, True)):
        flat = _rand(rng, (m * lda + 8,), dev)
        a = flat[offset:offset + m * lda].view(m, lda)[:, :k]
        _, b, scale, bias = _f32_operands(rng, 1, k, n, b_int8, dev)
        with pytest.raises(ValueError, match="does not take"):
            fused_gemm(a, b, scale, bias, f32_loop="wgmma")
        ok, err = _within_gate(fused_gemm(a, b, scale, bias), fused_gemm_plain(a, b, scale, bias),
                               b_int8)
        assert ok, err


def test_f32_wgmma_refused_launch_raises():
    """The C entries refuse arguments the loop does not take (one ring
    stage, more than MAX_STAGES, a band with splits, more splits than k
    steps, no block, an int8 B without a scale, N below the 64-wide tile)
    with cudaErrorInvalidValue."""
    from pyopenvino_tpu_torch.kernels import gemm

    dev = _card()
    m, k, n = 4096, 128, 256
    a, b, c = (torch.zeros((m, k), device=dev), torch.zeros((k, n), device=dev),
               torch.empty((m, n), device=dev))
    q = torch.zeros((k, n), dtype=torch.int8, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    f32 = gemm._kernel_fn("fused_gemm_f32_wgmma")
    i8w = gemm._kernel_fn("fused_gemm_f32_i8w_wgmma")
    ws = torch.empty((8, m, n), device=dev)
    for fn, bmat, cols, stages, splits, band, grid in (
            (f32, b, n, 1, 1, 0, 64), (f32, b, n, 9, 1, 0, 64), (f32, b, n, 2, 2, 1, 64),
            (f32, b, n, 2, 5, 0, 64), (f32, b, n, 2, 1, 0, 0), (i8w, q, n, 2, 1, 0, 64),
            (f32, b, 60, 2, 1, 0, 64)):
        err = fn(a.data_ptr(), bmat.data_ptr(), None, None, c.data_ptr(), m, cols, k, k, 0, 0.0,
                 0.0, stages, splits, band, grid, ws.data_ptr(), stream)
        assert err == 1, (cols, stages, splits, band, grid)


@pytest.mark.parametrize("b_int8", [False, True], ids=["f32_b", "i8_b"])
def test_f32_wgmma_profiled_under_its_category(b_int8):
    """A routed #1 (#1w) launch at M's 12544x96x576, and the same launch
    forced onto the mma.sync loop, profiled on the card: each loop's kernel,
    under the name the profiler reports, files under fused_gemm
    (fused_gemm_i8w) in runtime/profiling.py's categories."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pyopenvino_tpu_torch.kernels.gemm import f32_route, fused_gemm
    from pyopenvino_tpu_torch.runtime.profiling import categorize

    dev = _card()
    m, k, n = 12544, 96, 576
    a, b, scale, bias = _f32_operands(np.random.default_rng(9), m, k, n, b_int8, dev)
    assert f32_route(m, k, n, k, a.data_ptr(), b.data_ptr(), 0, b_int8) is not None
    want = "fused_gemm_i8w" if b_int8 else "fused_gemm"
    for loop, kernel in ((None, "f32_wgmma_kernel"), ("mma", "f32_mma_kernel")):
        fused_gemm(a, b, scale, bias, f32_loop=loop)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fused_gemm(a, b, scale, bias, f32_loop=loop)
            torch.cuda.synchronize()
        names = {e.name for e in prof.events() if e.device_type == DeviceType.CUDA}
        ours = sorted(nm for nm in names if kernel in nm)
        assert ours, (loop, sorted(names))
        assert {categorize(nm) for nm in ours} == {want}, ours


# -- 3f-bf16 on the wgmma loop (-k conv_bf16_wgmma) ---------------------------

# R's four widths at B = 1 and 64, then the wgmma loop's bf16 edges
CONV_BF16_WGMMA_SHAPES = ([(b, hw, hw, c, c, 3, 3, P1) for b in (1, 64)
                           for hw, c, _ in chip_smoke.RESNET18_DIRECT]
                          + chip_smoke.WGMMA_BF16_DIRECT_EDGES)


def _bf16_conv_operands(rng, n, h, w, ci, co, kh, kw, int8_w, dev):
    x = _rand(rng, (n, h, w, ci), dev).bfloat16()
    if int8_w:
        wt = _codes(rng, (co, ci, kh, kw), dev)
        scale = torch.from_numpy(rng.uniform(1e-3, 1e-2, co).astype(np.float32)).to(dev)
    else:
        wt, scale = _rand(rng, (co, ci, kh, kw), dev).bfloat16(), None
    return x, wt, scale, _rand(rng, (co,), dev)


@pytest.mark.parametrize("loop", ["wgmma", "mma"])
@pytest.mark.parametrize("int8_w", [False, True], ids=["bf16_w", "int8_w"])
@pytest.mark.parametrize("n,h,w,ci,co,kh,kw,pads", CONV_BF16_WGMMA_SHAPES)
def test_conv_bf16_wgmma_forced_loop_within_the_gate(n, h, w, ci, co, kh, kw, pads, int8_w,
                                                     loop):
    """3f-bf16 forced onto each loop, with a bfloat16 and an int8 weight:
    within one bfloat16 step of the plain version, or the float32 sums'
    bound where a sum cancels (chip_smoke.conv_floor); the same bits on a
    second call, with the weight matrix made by the wrapper and with it
    cached in either layout; one launch counted per call."""
    from pyopenvino_tpu_torch.kernels.conv import conv_weight_matrix, conv_weight_matrix_nk
    from pyopenvino_tpu_torch.kernels.conv_direct import conv2d_direct, conv2d_direct_plain

    dev = _card()
    rng = np.random.default_rng(n * 5 + ci + co + kh)
    x, wt, scale, bias = _bf16_conv_operands(rng, n, h, w, ci, co, kh, kw, int8_w, dev)
    act = (("relu", 0.0, 0.0), ("clamp", 0.0, 6.0), None)[(ci + co) % 3]
    before = conv2d_direct.launches_float_bf16
    got = conv2d_direct(x, wt, scale, bias, act, pads, conv_loop=loop)
    again = [conv2d_direct(x, wt, scale, bias, act, pads, wmat=wmat, conv_loop=loop)
             for wmat in (None, conv_weight_matrix(wt), conv_weight_matrix_nk(wt).t())]
    torch.cuda.synchronize()
    assert conv2d_direct.launches_float_bf16 == before + 4
    assert got.dtype == torch.bfloat16
    worst, _, _ = chip_smoke.bf16_steps(
        torch, got, conv2d_direct_plain(x, wt, scale, bias, act, pads),
        chip_smoke.conv_floor(torch, x, wt, scale, pads))
    assert worst <= 1.0
    for other in again:
        assert torch.equal(got, other)


@pytest.mark.parametrize("batch", [1, 64])
def test_conv_bf16_wgmma_route_at_resnet18_shapes(batch):
    """R's convs on bfloat16 x as the route sends them: the wgmma loop at
    B = 64 and, but for the 7x7 conv (49 pixels, below one tile), at B = 1;
    each call the bits of the loop forced."""
    from pyopenvino_tpu_torch.kernels.conv_direct import conv2d_direct, direct_bf16_route

    dev = _card()
    for hw, c, _ in chip_smoke.RESNET18_DIRECT:
        rng = np.random.default_rng(batch + hw + 1)
        x, wt, scale, bias = _bf16_conv_operands(rng, batch, hw, hw, c, c, 3, 3, False, dev)
        route = direct_bf16_route(batch, hw, hw, c, c, 3, 3, P1, x.data_ptr(), 0)
        assert (route is not None) == (batch * hw * hw >= 128), (batch, hw)
        got = conv2d_direct(x, wt, scale, bias, None, P1)
        forced = conv2d_direct(x, wt, scale, bias, None, P1,
                               conv_loop="wgmma" if route is not None else "mma")
        torch.cuda.synchronize()
        assert torch.equal(got, forced)


def test_conv_bf16_wgmma_forced_on_a_conv_it_does_not_take_raises():
    """Ci = 8 (half a k16 step a tap), Ci = 24 (no 16-channel slice), Co =
    32 (below the tile) and Co = 132 (no 16-byte bf16 output rows) are no
    convs of the wgmma loop: forcing it raises, before any launch; the
    route keeps them on the mma.sync loop."""
    from pyopenvino_tpu_torch.kernels.conv_direct import conv2d_direct

    dev = _card()
    rng = np.random.default_rng(4)
    for ci, co in ((8, 64), (24, 64), (64, 32), (64, 132)):
        x, wt, scale, bias = _bf16_conv_operands(rng, 64, 14, 14, ci, co, 3, 3, True, dev)
        before = conv2d_direct.launches_float_bf16
        with pytest.raises(ValueError, match="does not take"):
            conv2d_direct(x, wt, scale, bias, None, P1, conv_loop="wgmma")
        assert conv2d_direct.launches_float_bf16 == before
        assert conv2d_direct(x, wt, scale, bias, None, P1).shape == (64, 14, 14, co)


def test_conv_bf16_wgmma_refused_launch_raises():
    """The C entry refuses arguments the loop does not take (a slice of 64
    channels that does not divide Ci = 96; an int8 weight without its
    scale) with cudaErrorInvalidValue; a ring of 2 stages is one it
    takes."""
    from pyopenvino_tpu_torch.kernels import conv_direct as cd

    dev = _card()
    x = torch.zeros((2, 8, 8, 96), dtype=torch.bfloat16, device=dev)
    wmat = torch.zeros((64, 9 * 96), dtype=torch.bfloat16, device=dev)
    codes = torch.zeros((64, 9 * 96), dtype=torch.int8, device=dev)
    out = torch.empty((2, 8, 8, 64), dtype=torch.bfloat16, device=dev)
    scale = torch.ones(64, device=dev)
    fn = cd._kernel_fn("conv2d_direct_bf16_wgmma")
    stream = torch.cuda.current_stream().cuda_stream
    for w, w_int8, sc, sl, stages, want in ((wmat, 0, None, 128, 3, 1),
                                            (codes, 1, None, 64, 3, 1),
                                            (codes, 1, scale, 64, 2, 0),
                                            (wmat, 0, None, 64, 2, 0),
                                            (codes, 1, scale, 64, 3, 0)):
        err = fn(x.data_ptr(), w.data_ptr(), w_int8, None if sc is None else sc.data_ptr(),
                 None, out.data_ptr(), 2, 8, 8, 96, 64, 3, 3, 8, 8, 1, 1, 0, 0.0, 0.0, 64, sl,
                 stages, 1, 1, None, stream)
        torch.cuda.synchronize()
        assert err == want, (w_int8, sl, stages)


def test_conv_bf16_wgmma_profiled_under_3f_bf16():
    """A routed 3f-bf16 launch (R's 28x28 conv at B = 64), each weight
    type, and the same launch forced onto the mma.sync loop, profiled on
    the card: each loop's kernel files under conv2d_direct_float_bf16."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pyopenvino_tpu_torch.kernels.conv_direct import conv2d_direct
    from pyopenvino_tpu_torch.runtime.profiling import categorize

    dev = _card()
    for int8_w in (False, True):
        rng = np.random.default_rng(11)
        x, wt, scale, bias = _bf16_conv_operands(rng, 64, 28, 28, 128, 128, 3, 3, int8_w, dev)
        for loop, kernel in ((None, "i8_wgmma_kernel"), ("mma", "bf16_mma_kernel")):
            conv2d_direct(x, wt, scale, bias, None, P1, conv_loop=loop)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                conv2d_direct(x, wt, scale, bias, None, P1, conv_loop=loop)
                torch.cuda.synchronize()
            names = {e.name for e in prof.events() if e.device_type == DeviceType.CUDA}
            ours = sorted(nm for nm in names if kernel in nm)
            assert ours, (loop, sorted(names))
            assert {categorize(nm) for nm in ours} == {"conv2d_direct_float_bf16"}, ours


# -- the runtime extras (runtime/export.py, CompiledNetwork.profile) ----------------

def test_extras_imported_resnet18_int8full_bit_equal_and_profiled(tmp_path):
    """ResNet-18 INT8-FULL KERNELS at full width on the card: the imported
    network (no pass, no calibration) answers the exporter's bits at B = 1
    and 4, and profile returns node rows with device time, the port's
    kernels under their Convolution and MatMul nodes."""
    from pyopenvino_tpu_torch.config import Backend, Config, QuantMode
    from pyopenvino_tpu_torch.ir import read_ir_model
    from pyopenvino_tpu_torch.models.synth import resnet18_paths
    import pyopenvino_tpu_torch.runtime.compiler as compiler_mod
    from pyopenvino_tpu_torch.runtime.compiler import compile_model
    from pyopenvino_tpu_torch.runtime.export import import_compiled
    from pyopenvino_tpu_torch.runtime.profiling import aggregate

    _card()
    rng = np.random.default_rng(23)
    cal = [{"data": rng.uniform(0, 1, (1, 3, 224, 224)).astype(np.float32)} for _ in range(2)]
    net = compile_model(read_ir_model(*resnet18_paths(seed=0)),
                        Config(backend=Backend.KERNELS, quant=QuantMode.INT8_FULL),
                        device="cuda", calibration_samples=cal)
    path = str(tmp_path / "r18.ovpt")
    net.export(path)
    real = compiler_mod.prepare_model
    compiler_mod.prepare_model = None  # an import that prepared would fail here
    try:
        imp = import_compiled(path)
    finally:
        compiler_mod.prepare_model = real
    assert imp.network.device.type == "cuda"
    x = rng.uniform(0, 1, (4, 3, 224, 224)).astype(np.float32)
    for got, want in ((imp.infer({"data": x[:1]}), net.infer({"data": x[:1]})),
                      (imp.infer_batch({"data": x}), net.infer_batch({"data": x}))):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    rows = imp.network.profile({"data": x[:1]})
    by_node = {r["node"]: r for r in aggregate(rows, by="node")}
    assert imp.network.last_profile_us > 0
    assert sum(r["self_us"] for r in rows) == pytest.approx(imp.network.last_profile_us,
                                                           rel=1e-2)
    for node in imp.network.model:
        if node.op_type in ("Convolution", "MatMul"):
            row = by_node[f"{node.op_type}_{node.id}"]
            assert row["self_us"] > 0
            assert {r["category"] for r in rows if r["node"] == row["node"]} & {
                "conv2d_direct", "fused_gemm_i8i8"}, row


def test_two_rank_dp_resnet18_int8full_bit_equal(tmp_path):
    """Two processes of a gloo group, each owning two logical shards of the
    card (``[cuda:0] * 2``), run R INT8-FULL KERNELS data parallel over
    (data = 4, model = 1): each rank calibrates to the parent's scales and
    answers its rows with the unsharded network's bits, its launches
    counted."""
    from pyopenvino_tpu_torch.config import Backend, Config, QuantMode
    from pyopenvino_tpu_torch.ir import read_ir_model
    from pyopenvino_tpu_torch.kernels import build
    from pyopenvino_tpu_torch.models.synth import resnet18_paths
    from pyopenvino_tpu_torch.runtime.compiler import compile_model
    from pyopenvino_tpu_torch.tools.mp_worker import launch, write_reference

    _card()
    build.build_all()
    rng = np.random.default_rng(29)
    cal = [{"data": rng.uniform(0, 1, (1, 3, 224, 224)).astype(np.float32)} for _ in range(2)]
    config = Config(backend=Backend.KERNELS, quant=QuantMode.INT8_FULL)
    paths = resnet18_paths(seed=0)
    net = compile_model(read_ir_model(*paths), config, device="cuda", calibration_samples=cal)
    rows = rng.uniform(0, 1, (8, 3, 224, 224)).astype(np.float32)
    ref = str(tmp_path / "ref.npz")
    write_reference(ref, {"data": rows}, net.infer_batch({"data": rows}), config=config,
                    calibration=cal, act_scales=net.act_scales, gate="exact")
    results = launch(2, f"file://{tmp_path}/store", [[paths[0], "4", ref]], "cuda", 4, 600)
    for pid, r in enumerate(results):
        assert r["rc"] == 0 and f"MP_OK {pid}" in r["output"], r["output"]
        (job,) = r["jobs"]
        assert r["group"]["prebuilt"] and job["bit_equal"] and job["rows"] == 4
        # two blocks of 2 rows a rank: 8 #1ii and 13 #3 a forward each
        assert job["launches"]["fused_gemm_i8i8"] == 16
        assert job["launches"]["conv2d_direct"] == 26


def test_two_rank_row_across_resnet18_int8full_bit_equal(tmp_path):
    """Two processes of a gloo group, each owning two logical shards of the
    card, hold one data row between them: R INT8-FULL KERNELS on TP4
    (data = 1, model = 4) and SP4 (data = 1, spatial = 4), both ranks
    feeding the same 8 rows and answering all of them with the unsharded
    network's bits; the TP outputs cross by all-gather, the SP halos by
    hand-offs."""
    from pyopenvino_tpu_torch.config import Backend, Config, QuantMode
    from pyopenvino_tpu_torch.ir import read_ir_model
    from pyopenvino_tpu_torch.kernels import build
    from pyopenvino_tpu_torch.models.synth import resnet18_paths
    from pyopenvino_tpu_torch.runtime.compiler import compile_model
    from pyopenvino_tpu_torch.tools.mp_worker import launch, write_reference

    _card()
    build.build_all()
    rng = np.random.default_rng(29)
    cal = [{"data": rng.uniform(0, 1, (1, 3, 224, 224)).astype(np.float32)} for _ in range(2)]
    config = Config(backend=Backend.KERNELS, quant=QuantMode.INT8_FULL)
    paths = resnet18_paths(seed=0)
    net = compile_model(read_ir_model(*paths), config, device="cuda", calibration_samples=cal)
    rows = rng.uniform(0, 1, (8, 3, 224, 224)).astype(np.float32)
    ref = str(tmp_path / "ref.npz")
    write_reference(ref, {"data": rows}, net.infer_batch({"data": rows}), config=config,
                    calibration=cal, act_scales=net.act_scales, gate="exact",
                    b1_outputs=net.infer({"data": rows[:1]}))
    jobs = [[paths[0], "8", ref, "--model", "4"], [paths[0], "8", ref, "--spatial", "4"],
            [paths[0], "8", ref, "--model", "4", "--b1"]]
    results = launch(2, f"file://{tmp_path}/store", jobs, "cuda", 4, 600)
    for pid, r in enumerate(results):
        assert r["rc"] == 0 and f"MP_OK {pid}" in r["output"], r["output"]
        tp4, sp4, b1 = r["jobs"]
        for job, way in ((tp4, "all_gather"), (sp4, "halo"), (b1, "all_gather")):
            assert job["bit_equal"] and job["owners"] == {"0": [0, 1]}, job
            assert job["exchanges_checked_call"][way]["count"] > 0, job
        assert tp4["rows"] == sp4["rows"] == 8 and b1["rows"] == 1
        assert tp4["launches"] == results[0]["jobs"][0]["launches"]
