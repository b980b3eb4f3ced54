"""resnet18_pot (models/pot.py: the port's ResNet-18 quantized by its
tools/pot_quantize.py, inputs in [0, 255)) with ``compute_dtype="bfloat16"``
against the JAX package on the CPU.

  * FP32 and INT8 weight-only emulate 18 activation FakeQuantizes, and an
    emulated code amplifies the last bit of whatever feeds it (ROADMAP §3,
    fault 3): unforced, the port's bfloat16 logits lie about 1.3× JAX's own
    bfloat16-vs-float32 distance from JAX's.  So each FakeQuantize of the
    port emits the JAX package's bfloat16 output (XLA), and
    test_torch_port_bf16.py's gate holds the logits, TORCH against XLA.  In
    bfloat16 the two packages' FakeQuantize outputs are not one-step flips
    apart: the port rounds every step of the op to bfloat16, as the JAX
    program's dtypes say, where XLA's CPU lowering does not, and on most
    outputs of some nodes they lie up to about 3 output steps apart (printed
    per node), so chip_smoke.forced_fake_quantize's flip limits, which hold
    two runs of the same op (KERNELS and TORCH on the card), do not apply;
  * INT8-FULL takes every activation scale from the IR, no samples: TORCH
    against XLA and KERNELS against PALLAS (interpret; #1ii and #3 with
    bfloat16 outputs, the mode that reaches the most variants) with the
    plain gate;
  * the bf16 kernel variants reached at ResNet-18's launch counts."""

import contextlib

import numpy as np
import pytest
import torch

from pyopenvino_tpu.config import Backend as JaxBackend

from pyopenvino_tpu_torch.config import Backend, QuantMode
from pyopenvino_tpu_torch.models.pot import resnet18_pot_paths
from pyopenvino_tpu_torch.ops import extended
from pyopenvino_tpu_torch.ops.spec import TValue

from test_torch_port_bf16 import Bf16Case, check_bf16_case, check_bf16_routes
import test_torch_port_threads  # noqa: F401  (this worker's torch threads)


@pytest.fixture(scope="module")
def case():
    return Bf16Case(resnet18_pot_paths(seed=0), seed=3, high=255.0, calibrate=False)


@contextlib.contextmanager
def jax_fake_quantize_outputs(forced, apart):
    """Within the block every FakeQuantize of the port emits ``forced[its
    name]``, the JAX package's output of it; ``apart[its name]`` gets
    (outputs that differ from the port's own, outputs, the largest
    difference in output steps)."""
    own_emit = extended.FakeQuantize.emit

    def emit(op, ctx, node, inputs):
        own = own_emit(op, ctx, node, inputs)[node.out_port].arr
        other = forced[node.name]
        step = ((inputs[4].arr.double() - inputs[3].arr.double())
                / (op._levels(node) - 1)).abs().max().item()
        d = (own.double() - other.double()).abs()
        apart[node.name] = (int((d > 0).sum()), own.numel(), d.max().item() / step)
        return {node.out_port: TValue(other)}

    extended.FakeQuantize.emit = emit
    try:
        yield
    finally:
        extended.FakeQuantize.emit = own_emit


@pytest.mark.parametrize("quant", [QuantMode.NONE, QuantMode.INT8_WEIGHT],
                         ids=lambda q: q.value)
def test_resnet18_pot_bf16_torch_matches_xla_forced(case, quant):
    jax_net = case.jax_net(JaxBackend.XLA, quant, "bfloat16")
    names = [n.name for n in jax_net.model.find_by_type("FakeQuantize")]
    assert len(names) == 18
    _, fqs = jax_net.infer_with_capture(case.x, names)
    forced = {name: torch.from_numpy(np.asarray(v, np.float32)).bfloat16()
              for name, v in fqs.items()}
    net = case.port_net(Backend.TORCH, quant)
    apart = {}
    with jax_fake_quantize_outputs(forced, apart):
        got = net.infer(case.x)[case.out]
    assert sorted(apart) == sorted(names)
    for name, (n_diff, n, steps) in apart.items():
        print(f"resnet18-pot {quant.value} bf16 {name}: {n_diff} of {n} outputs differ from "
              f"XLA's, by at most {steps:.2f} output steps")
    check_bf16_case(case, Backend.TORCH, JaxBackend.XLA, quant, got=got)


def test_resnet18_pot_bf16_int8full_torch_matches_xla(case):
    check_bf16_case(case, Backend.TORCH, JaxBackend.XLA, QuantMode.INT8_FULL)


def test_resnet18_pot_bf16_int8full_kernels_match_pallas(case):
    check_bf16_case(case, Backend.KERNELS, JaxBackend.PALLAS, QuantMode.INT8_FULL)


def test_resnet18_pot_bf16_kernel_routes(case, monkeypatch):
    """ResNet-18's launches in bfloat16: FP32 4 fused_gemm_bf16, INT8W 4
    fused_gemm_bf16_i8w, INT8-FULL (no samples) 8 int8 × int8 fused_gemm
    and 13 conv2d_direct with bfloat16 outputs per forward."""
    check_bf16_routes(case, monkeypatch, {
        QuantMode.NONE: {"fused_gemm_bf16": 4},
        QuantMode.INT8_WEIGHT: {"fused_gemm_bf16_i8w": 4},
        QuantMode.INT8_FULL: {"fused_gemm_i8i8_bf16": 8, "conv2d_direct_bf16": 13},
    })
