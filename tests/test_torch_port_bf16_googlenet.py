"""googlenet_shapes (assets/trained: GoogLeNet-v1's graph narrowed 4×,
trained weights, inputs in [0, 255), INT8-FULL with bias correction as
tools/accuracy.py runs it) with ``compute_dtype="bfloat16"`` against the
JAX package on the CPU: TORCH against XLA in FP32, INT8 weight-only and
INT8-FULL (bit for bit with XLA's excess precision off), KERNELS against
PALLAS (interpret) in INT8-FULL, the mode that
reaches the most variants (#1ii and #3 with bfloat16 outputs, #3 on 5×5
convs with Ci = 4 … 12), with test_torch_port_bf16.py's gate, and the bf16
kernel variants reached at googlenet_shapes' launch counts."""

import os

import numpy as np
import pytest

from pyopenvino_tpu.config import Backend as JaxBackend

from pyopenvino_tpu_torch.config import Backend, QuantMode

from test_torch_port_bf16 import (
    Bf16Case,
    _dist,
    check_bf16_case,
    check_bf16_routes,
    jax_without_excess_precision,
)
import test_torch_port_threads  # noqa: F401  (this worker's torch threads)

PATHS = tuple(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "assets", "trained", f"googlenet_shapes.{e}") for e in ("xml", "bin"))


CASE_ARGS = ((PATHS, 3), {"high": 255.0, "bias_correction": True})


@pytest.fixture(scope="module")
def case():
    return Bf16Case(*CASE_ARGS[0], **CASE_ARGS[1])


@pytest.mark.parametrize("quant", [QuantMode.NONE, QuantMode.INT8_WEIGHT],
                         ids=lambda q: q.value)
def test_googlenet_shapes_bf16_torch_matches_xla(case, quant):
    check_bf16_case(case, Backend.TORCH, JaxBackend.XLA, quant)


def test_googlenet_shapes_bf16_int8full_torch_equals_xla(case, tmp_path):
    """INT8-FULL on TORCH stores int8 between ops, as XLA does, and
    requantizes each op's bfloat16 result.  XLA's CPU fusions keep float32
    where the program says bfloat16 (its excess precision): already the
    mean subtraction at the input, then every requantize, so by default
    the port lies about twice JAX's own bfloat16-vs-float32 distance from
    JAX (printed).  With the excess precision off, XLA rounds where the
    program says, and the port's logits equal the JAX package's bit for
    bit."""
    _, got = case.port(Backend.TORCH, QuantMode.INT8_FULL)
    want = jax_without_excess_precision(CASE_ARGS, JaxBackend.XLA, QuantMode.INT8_FULL,
                                        tmp_path)
    default = case.jax(JaxBackend.XLA, QuantMode.INT8_FULL, "bfloat16")
    f32 = case.jax(JaxBackend.XLA, QuantMode.INT8_FULL, "float32")
    print(f"int8 torch vs xla (default, excess precision on): port bf16 vs JAX bf16 "
          f"{_dist(got, default)}; JAX bf16 vs JAX f32 {_dist(default, f32)}")
    np.testing.assert_array_equal(got, want)


def test_googlenet_shapes_bf16_kernels_match_pallas(case):
    check_bf16_case(case, Backend.KERNELS, JaxBackend.PALLAS, QuantMode.INT8_FULL)


def test_googlenet_shapes_bf16_kernel_routes(case, monkeypatch):
    """FP32 1 fused_gemm_bf16 (the classifier), INT8W 1
    fused_gemm_bf16_i8w, INT8-FULL 39 int8 × int8 fused_gemm and 19
    conv2d_direct with bfloat16 outputs per forward."""
    check_bf16_routes(case, monkeypatch, {
        QuantMode.NONE: {"fused_gemm_bf16": 1},
        QuantMode.INT8_WEIGHT: {"fused_gemm_bf16_i8w": 1},
        QuantMode.INT8_FULL: {"fused_gemm_i8i8_bf16": 39, "conv2d_direct_bf16": 19},
    })
