"""SSD-MobileNet-v1 (assets/trained/ssd_shapes_ms, trained weights,
tools/accuracy.py's settings) with ``compute_dtype="bfloat16"`` against the
JAX package on the CPU, on tools/datasets.py's 8 labelled evaluation
images: TORCH against XLA in FP32, INT8 weight-only and INT8-FULL, KERNELS
against PALLAS (interpret) in FP32 (#1b; INT8-FULL reaches as many
variants, #1ii-bf16), and the bf16 kernel variants reached at SSD's launch
counts.

A detector's answer is its record table.  The gate: the same records, the
classes in the same order, on every image; the same mAP at IoU 0.5 against
the drawn boxes; and record values no farther from JAX's bfloat16 ones than
JAX's own bfloat16 records lie from its float32 ones, each record held to
the nearest of its class (``chip_smoke.record_match``: bfloat16 moves the
boxes and confidences by up to a few 1e-2 in both packages, far beyond
test_torch_port_ssd.py's float32 RECORD_ATOL)."""

import numpy as np
import pytest

from pyopenvino_tpu.config import Backend as JaxBackend
from pyopenvino_tpu.config import Config as JaxConfig
from pyopenvino_tpu.ir import read_ir_model as jax_read
from pyopenvino_tpu.metrics import coco_map
from pyopenvino_tpu.metrics import parse_detection_records as jax_parse
from pyopenvino_tpu.runtime.compiler import compile_model as jax_compile

from pyopenvino_tpu_torch.config import Backend, Config, QuantMode
from pyopenvino_tpu_torch.ir import read_ir_model
from pyopenvino_tpu_torch.metrics import mean_average_precision, parse_detection_records
from pyopenvino_tpu_torch.runtime.compiler import compile_model

from chip_smoke import record_match
from test_torch_port_bf16 import check_bf16_routes
from test_torch_port_ssd import IN, MODES, OUT, PATHS, accuracy_settings
import test_torch_port_threads  # noqa: F401  (this worker's torch threads)

QUANT_MODE = {quant: mode for mode, (quant, _) in MODES.items()}


class SsdBf16Case:
    """tools/accuracy.py's 8 evaluation and 4 calibration images; each
    network per (package, backend, mode, dtype) and its (8, 1, 100, 7)
    record table, computed once."""

    def __init__(self):
        from tools import datasets
        from tools.accuracy import CAL_SEED, EVAL_SEED

        self.x, gt = datasets.shapes_det300(8, EVAL_SEED)
        self.gt = {i: [(c + 1, box) for c, box in g] for i, g in enumerate(gt)}
        cal, _ = datasets.shapes_det300(4, CAL_SEED)
        self.calibration = [{IN: cal[i:i + 1]} for i in range(len(cal))]
        self.port_model, self.jax_model = read_ir_model(*PATHS), jax_read(*PATHS)
        self.x_in = {IN: self.x}
        self._jax, self._port = {}, {}

    def jax(self, backend, quant, dtype):
        if dtype == "float32":
            backend = JaxBackend.XLA
        key = (backend, quant, dtype)
        if key not in self._jax:
            _, jax_quant = MODES[QUANT_MODE[quant]]
            net = jax_compile(self.jax_model, JaxConfig(
                backend=backend, quant=jax_quant, compute_dtype=dtype,
                **accuracy_settings(jax_quant)),
                calibration_samples=self.calibration if quant != QuantMode.NONE else None)
            self._jax[key] = np.asarray(net.infer_batch(self.x_in)[OUT], np.float32)
        return self._jax[key]

    def port_net(self, backend, quant):
        if (backend, quant) not in self._port:
            _, jax_quant = MODES[QUANT_MODE[quant]]
            self._port[backend, quant] = compile_model(self.port_model, Config(
                backend=backend, quant=quant, compute_dtype="bfloat16",
                **accuracy_settings(jax_quant)), device="cpu",
                calibration_samples=self.calibration if quant != QuantMode.NONE else None)
        return self._port[backend, quant]

    def port(self, backend, quant):
        net = self.port_net(backend, quant)
        return net, net.infer_batch(self.x_in)[OUT]


@pytest.fixture(scope="module")
def case():
    return SsdBf16Case()


def check_bf16_records(case, backend, jax_backend, quant):
    _, got = case.port(backend, quant)
    want, f32 = case.jax(jax_backend, quant, "bfloat16"), case.jax(jax_backend, quant, "float32")
    assert got.dtype == np.float32 and got.shape == want.shape == (8, 1, 100, 7)
    assert np.isfinite(got).all()
    dets = {i: parse_detection_records(r) for i, r in enumerate(got)}
    jax_dets = {i: jax_parse(r) for i, r in enumerate(want)}
    for i in dets:
        assert [d[0] for d in dets[i]] == [d[0] for d in jax_dets[i]], i
    err, own = record_match(got, want)[1], record_match(want, f32)[1]
    ours, theirs = (mean_average_precision(case.gt, dets),
                    coco_map(case.gt, jax_dets, iou_thresholds=(0.5,)))
    print(f"{quant.value} {backend.value} vs {jax_backend.value} bf16: records "
          f"{err:.3e} apart (JAX bf16 vs JAX f32 {own:.3e}); {sum(map(len, dets.values()))} records; "
          f"mAP@0.5 {ours:.2f} (JAX bf16 {theirs:.2f})")
    assert err <= own
    assert ours == theirs


@pytest.mark.parametrize("quant", list(QUANT_MODE), ids=lambda q: q.value)
def test_ssd_bf16_torch_matches_xla(case, quant):
    check_bf16_records(case, Backend.TORCH, JaxBackend.XLA, quant)


def test_ssd_bf16_kernels_match_pallas(case):
    check_bf16_records(case, Backend.KERNELS, JaxBackend.PALLAS, QuantMode.NONE)


class _FirstImage:
    """SsdBf16Case's port networks run on the first image alone (the route
    test counts the launches of one forward)."""

    def __init__(self, case):
        self.case = case

    def port(self, backend, quant):
        net = self.case.port_net(backend, quant)
        return net, net.infer({IN: self.case.x[:1]})[OUT]


def test_ssd_bf16_kernel_routes(case, monkeypatch):
    """FP32 8 fused_gemm_bf16 (the large 1×1 convs; tools/accuracy.py's
    quant_min_elems keeps the small heads on the library), INT8W 8
    fused_gemm_bf16_i8w, INT8-FULL 17 int8 × int8 fused_gemm with bfloat16
    outputs per forward; no conv2d_direct, no softmax_rows (SSD ends in a
    Sigmoid)."""
    check_bf16_routes(_FirstImage(case), monkeypatch, {
        QuantMode.NONE: {"fused_gemm_bf16": 8},
        QuantMode.INT8_WEIGHT: {"fused_gemm_bf16_i8w": 8},
        QuantMode.INT8_FULL: {"fused_gemm_i8i8_bf16": 17},
    })
