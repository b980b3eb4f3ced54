"""Full-width EfficientNet-B0 (models/efficientnet_b0.py's weights, seed 0,
inputs in [0, 255)) with ``compute_dtype="bfloat16"`` against the JAX
package on the CPU: TORCH against XLA in FP32, INT8 weight-only and
INT8-FULL, KERNELS against PALLAS (interpret) in FP32 (#1b; INT8-FULL
reaches as many variants, #1ii-bf16), with test_torch_port_bf16.py's gate
(the port's distance to JAX's bfloat16 logits inside JAX's own
bfloat16-vs-float32 distance, top-1 equal up to JAX's near ties), and the
bf16 kernel variants reached at EfficientNet-B0's launch counts."""

import pytest

from pyopenvino_tpu.config import Backend as JaxBackend

from pyopenvino_tpu_torch.config import Backend, QuantMode
from pyopenvino_tpu_torch.models.efficientnet_b0 import efficientnet_b0_paths

from test_torch_port_bf16 import QUANTS, Bf16Case, check_bf16_case, check_bf16_routes
import test_torch_port_threads  # noqa: F401  (this worker's torch threads)


@pytest.fixture(scope="module")
def case():
    return Bf16Case(efficientnet_b0_paths(seed=0), seed=3, high=255.0)


@pytest.mark.parametrize("quant", QUANTS, ids=lambda q: q.value)
def test_efficientnet_b0_bf16_torch_matches_xla(case, quant):
    check_bf16_case(case, Backend.TORCH, JaxBackend.XLA, quant)


def test_efficientnet_b0_bf16_kernels_match_pallas(case):
    check_bf16_case(case, Backend.KERNELS, JaxBackend.PALLAS, QuantMode.NONE)


def test_efficientnet_b0_bf16_kernel_routes(case, monkeypatch):
    """FP32 17 fused_gemm_bf16, INT8W 17 fused_gemm_bf16_i8w, INT8-FULL 66
    int8 × int8 fused_gemm with bfloat16 outputs (32 of them the SE convs at
    M = batch) per forward; no conv2d_direct (the 3×3 and 5×5 convs are
    depthwise)."""
    check_bf16_routes(case, monkeypatch, {
        QuantMode.NONE: {"fused_gemm_bf16": 17},
        QuantMode.INT8_WEIGHT: {"fused_gemm_bf16_i8w": 17},
        QuantMode.INT8_FULL: {"fused_gemm_i8i8_bf16": 66},
    })
