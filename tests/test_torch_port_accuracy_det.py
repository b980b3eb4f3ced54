"""tests/test_accuracy.py's trained-detector mAP gate
(``test_trained_detector_real_map_gate``, :151) through the port's TORCH
backend on the CPU, on the committed ``assets/trained/shapes_ssd``: the
same labelled eval set (96 images of ``eval_images`` with their real
boxes), the same 32 calibration images drawn from ``CAL_SEED``, and
tools/accuracy.py's settings for the model (``_config``: the heads under
4096 elements stay float, bias correction under INT8-FULL).  Scored with
the port's ``metrics`` over COCO's IoU grid (``coco_map``), as
tools/accuracy.py's ``score_det`` scores with the JAX package's: FP32 mAP
at least 60, INT8 weight-only and INT8-FULL within 0.5 of FP32, and the
port's FP32 mAP equal to the JAX package's on the JAX package's records.
The flagship multi-scale SSD's gate is tests/test_torch_port_accuracy_det_ms.py."""

from pyopenvino_tpu_torch import metrics
from test_torch_port_accuracy import _run_port
import test_torch_port_threads  # noqa: F401  (this worker's torch threads)


def score_det(ref_outputs, outputs, gt_boxes):
    """(mAP, FP32 mAP − mAP) against real boxes over COCO's IoU grid, with
    the port's metrics: tools/accuracy.py's ``score_det`` with real GT."""
    def dets(outs):
        return {k: metrics.parse_detection_records(next(iter(o.values())))
                for k, o in outs.items()}

    got = metrics.coco_map(gt_boxes, dets(outputs))
    return got, metrics.coco_map(gt_boxes, dets(ref_outputs)) - got


def check_detector_gate(family, n, dataset):
    """The gate of tests/test_accuracy.py on ``family`` through the port;
    returns {mode: (mAP, delta)}."""
    from tools import datasets
    from tools.accuracy import CAL_SEED, MODELS, eval_images, run_model
    from tools.accuracy import score_det as jax_score_det

    images, gt = eval_images(family, n)
    in_name = MODELS[family][0]
    cx, _ = getattr(datasets, dataset)(32, CAL_SEED)
    calibration = [{in_name: cx[i][None]} for i in range(len(cx))]
    ref = _run_port(family, "fp32", images, calibration)
    fp32_map, _ = score_det(ref, ref, gt)
    assert fp32_map >= 60.0, fp32_map  # trained weights, real boxes
    # the port's FP32 mAP is the JAX package's, and the port's scorer the
    # JAX package's on the same records
    jax_ref = run_model(family, "fp32", images, calibration)
    jax_map = score_det(jax_ref, jax_ref, gt)[0]
    assert jax_map == jax_score_det(jax_ref, jax_ref, gt)[0]
    assert fp32_map == jax_map, (fp32_map, jax_map)
    out = {"fp32": (fp32_map, 0.0)}
    for mode in ("int8w", "int8full"):
        val, delta = score_det(ref, _run_port(family, mode, images, calibration), gt)
        print(f"{family} {mode}: mAP {val:.2f} (FP32 {fp32_map:.2f}, delta {delta:.2f})")
        assert delta <= 0.5 + 1e-9, (mode, val, delta)
        out[mode] = (val, delta)
    return out


def test_port_trained_detector_real_map_gate():
    check_detector_gate("shapes_ssd", 96, "shapes_det")
