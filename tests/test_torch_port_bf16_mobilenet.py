"""Full-width MobileNet-v2 with ``compute_dtype="bfloat16"`` in FP32, INT8
weight-only and INT8-FULL against the JAX package on the CPU: TORCH against
XLA, KERNELS against PALLAS (interpret), with test_torch_port_bf16.py's gate
(the port's distance to JAX's bfloat16 logits inside JAX's own
bfloat16-vs-float32 distance, top-1 equal up to JAX's near ties), and the
bf16 kernel variants reached at MobileNet-v2's launch counts."""

import pytest

from pyopenvino_tpu_torch.config import Backend, QuantMode
from pyopenvino_tpu_torch.kernels import gemm
from pyopenvino_tpu_torch.models.synth import mobilenet_v2_paths

from test_torch_port_bf16 import BACKEND_PAIRS, QUANTS, Bf16Case, check_bf16_case


@pytest.fixture(scope="module")
def mobilenet_v2_case():
    return Bf16Case(mobilenet_v2_paths(seed=0), seed=3)


@pytest.mark.parametrize("quant", QUANTS, ids=lambda q: q.value)
@pytest.mark.parametrize("backend,jax_backend", BACKEND_PAIRS, ids=["torch", "kernels"])
def test_mobilenet_v2_bf16_matches_jax(mobilenet_v2_case, backend, jax_backend, quant):
    check_bf16_case(mobilenet_v2_case, backend, jax_backend, quant)


def test_mobilenet_v2_bf16_kernel_routes(mobilenet_v2_case, monkeypatch):
    """FP32 16 fused_gemm_bf16, INT8W 16 fused_gemm_bf16_i8w, INT8-FULL 36
    int8 × int8 fused_gemm with bfloat16 outputs per forward (MobileNet-v2
    runs no conv2d_direct: its 3×3 convs are depthwise)."""
    seen = []
    plain = gemm.fused_gemm_plain

    def spy(a, b, scale=None, bias=None, act=None, out_dtype=None):
        out = plain(a, b, scale, bias, act, out_dtype)
        seen.append((str(a.dtype), str(b.dtype), str(out.dtype)))
        return out

    monkeypatch.setattr(gemm, "fused_gemm_plain", spy)
    expected = {
        QuantMode.NONE: {("torch.bfloat16", "torch.bfloat16", "torch.bfloat16"): 16},
        QuantMode.INT8_WEIGHT: {("torch.bfloat16", "torch.int8", "torch.bfloat16"): 16},
        QuantMode.INT8_FULL: {("torch.int8", "torch.int8", "torch.bfloat16"): 36},
    }
    for quant, want in expected.items():
        seen.clear()
        mobilenet_v2_case.port(Backend.KERNELS, quant)
        assert {k: seen.count(k) for k in set(seen)} == want, quant
