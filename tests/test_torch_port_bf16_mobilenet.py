"""Full-width MobileNet-v2 with ``compute_dtype="bfloat16"`` in FP32, INT8
weight-only and INT8-FULL against the JAX package on the CPU: TORCH against
XLA, KERNELS against PALLAS (interpret), with test_torch_port_bf16.py's gate
(the port's distance to JAX's bfloat16 logits inside JAX's own
bfloat16-vs-float32 distance, top-1 equal up to JAX's near ties), and the
bf16 kernel variants reached at MobileNet-v2's launch counts."""

import pytest

from pyopenvino_tpu_torch.config import QuantMode
from pyopenvino_tpu_torch.models.synth import mobilenet_v2_paths

from test_torch_port_bf16 import (
    BACKEND_PAIRS,
    QUANTS,
    Bf16Case,
    check_bf16_case,
    check_bf16_routes,
)
import test_torch_port_threads  # noqa: F401  (this worker's torch threads)


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
    check_bf16_routes(mobilenet_v2_case, monkeypatch, {
        QuantMode.NONE: {"fused_gemm_bf16": 16},
        QuantMode.INT8_WEIGHT: {"fused_gemm_bf16_i8w": 16},
        QuantMode.INT8_FULL: {"fused_gemm_i8i8_bf16": 36},
    })
