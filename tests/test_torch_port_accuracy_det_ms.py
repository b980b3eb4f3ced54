"""tests/test_accuracy.py's flagship multi-scale SSD mAP gate
(``test_flagship_ssd_real_map_gate``, :262) through the port's TORCH
backend on the CPU, on the committed ``assets/trained/ssd_shapes_ms``
(SSD-MobileNet-v1's graph narrowed 4×, 1917 anchors): 48 labelled eval
images with their real boxes, 32 calibration images from ``CAL_SEED``,
tools/accuracy.py's settings; FP32 mAP at least 60, INT8 weight-only and
INT8-FULL within 0.5 of FP32 over COCO's IoU grid, and the port's FP32 mAP
equal to the JAX package's (tests/test_torch_port_accuracy_det.py's
``check_detector_gate``; a file of its own so that ``--dist loadfile``
gives the two gates to two workers)."""

from test_torch_port_accuracy_det import check_detector_gate
import test_torch_port_threads  # noqa: F401  (this worker's torch threads)


def test_port_flagship_ssd_real_map_gate():
    check_detector_gate("ssd_shapes_ms", 48, "shapes_det300")
