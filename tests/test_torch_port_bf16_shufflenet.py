"""Full-width ShuffleNet-v2 1.0× (models/shufflenet_v2.py's weights, seed 0,
inputs in [0, 255)) with ``compute_dtype="bfloat16"`` against the JAX
package on the CPU: TORCH against XLA in FP32, INT8 weight-only and
INT8-FULL, KERNELS against PALLAS (interpret) in FP32 (#1b, three launches
on a Split half as a strided A), with test_torch_port_bf16.py's gate, and
the bf16 kernel variants reached at ShuffleNet-v2's launch counts."""

import pytest

from pyopenvino_tpu.config import Backend as JaxBackend

from pyopenvino_tpu_torch.config import Backend, QuantMode
from pyopenvino_tpu_torch.models.shufflenet_v2 import shufflenet_v2_paths

from test_torch_port_bf16 import QUANTS, Bf16Case, check_bf16_case, check_bf16_routes
import test_torch_port_threads  # noqa: F401  (this worker's torch threads)


@pytest.fixture(scope="module")
def case():
    return Bf16Case(shufflenet_v2_paths(seed=0), seed=3, high=255.0)


@pytest.mark.parametrize("quant", QUANTS, ids=lambda q: q.value)
def test_shufflenet_v2_bf16_torch_matches_xla(case, quant):
    check_bf16_case(case, Backend.TORCH, JaxBackend.XLA, quant)


def test_shufflenet_v2_bf16_kernels_match_pallas(case):
    check_bf16_case(case, Backend.KERNELS, JaxBackend.PALLAS, QuantMode.NONE)


def test_shufflenet_v2_bf16_kernel_routes(case, monkeypatch):
    """FP32 11 fused_gemm_bf16, INT8W 11 fused_gemm_bf16_i8w, INT8-FULL 38
    int8 × int8 fused_gemm with bfloat16 outputs per forward; no
    conv2d_direct (its 3×3 convs are depthwise)."""
    check_bf16_routes(case, monkeypatch, {
        QuantMode.NONE: {"fused_gemm_bf16": 11},
        QuantMode.INT8_WEIGHT: {"fused_gemm_bf16_i8w": 11},
        QuantMode.INT8_FULL: {"fused_gemm_i8i8_bf16": 38},
    })
