"""The accuracy gates of tools/accuracy.py through the port's TORCH backend
on the CPU, for the five trained classifiers: the same labelled eval set
(96 images of ``eval_images``), the same 32 calibration images drawn from
``CAL_SEED``, and the per-model settings of tools/accuracy.py (bias
correction on googlenet_shapes under INT8-FULL; clipping percentile and
quant_min_elems where it sets them).  As tests/test_accuracy.py holds the
JAX package: INT8 weight-only and INT8-FULL top-1 within 0.5 of FP32
against the real labels; and the port's FP32 answers equal the JAX
package's."""

import numpy as np
import pytest

from pyopenvino_tpu_torch import IECore
from pyopenvino_tpu_torch.config import Config, QuantMode
import test_torch_port_threads  # noqa: F401  (this worker's torch threads)

FAMILIES = ["mnist_bn_real", "keras_digits", "torch_digits", "shapes_resnet",
            "googlenet_shapes"]
MODES = {"fp32": QuantMode.NONE, "int8w": QuantMode.INT8_WEIGHT,
         "int8full": QuantMode.INT8_FULL}


def _config(family, quant):
    from tools.accuracy import (
        BIAS_CORRECTION_DEFAULT, CAL_PERCENTILE, QUANT_MIN_ELEMS_MODEL,
    )

    return Config(quant=quant,
                  calibration_percentile=CAL_PERCENTILE.get(family, 100.0),
                  quant_min_elems=QUANT_MIN_ELEMS_MODEL.get(family, 0),
                  bias_correction=family in BIAS_CORRECTION_DEFAULT
                  and quant == QuantMode.INT8_FULL)


def _run_port(family, mode, images, calibration):
    """{image key: {output: (classes,)}} from one infer_batch, the form
    tools/accuracy.py's score_cls reads."""
    from tools.accuracy import MODELS, model_paths

    ie = IECore()
    config = _config(family, MODES[mode])
    exe = ie.load_network(ie.read_network(*model_paths(family)), "CPU", config=config)
    exe.kernel_type = "torch"
    if config.quant == QuantMode.INT8_FULL or config.bias_correction:
        exe.set_calibration(calibration)
    keys = list(images)
    out = exe.infer_batch({MODELS[family][0]: np.stack([images[k][0] for k in keys])})
    return {k: {name: v[i] for name, v in out.items()} for i, k in enumerate(keys)}


@pytest.mark.parametrize("family", FAMILIES)
def test_port_int8_accuracy_gates(family):
    from tools import datasets
    from tools.accuracy import CAL_SEED, MODELS, TRAINED, eval_images, run_model, score_cls

    images, labels = eval_images(family, 96)
    in_name = MODELS[family][0]
    cx, _ = getattr(datasets, TRAINED[family][1])(32, CAL_SEED)
    calibration = [{in_name: cx[i][None]} for i in range(len(cx))]
    ref = _run_port(family, "fp32", images, calibration)
    fp32_acc, _ = score_cls(ref, ref, labels)
    assert fp32_acc >= 90.0, fp32_acc  # trained weights, real labels
    # the port's FP32 answers are the JAX package's
    jax_ref = run_model(family, "fp32", images, calibration)
    assert score_cls(jax_ref, jax_ref, labels)[0] == fp32_acc
    for k in images:
        assert next(iter(ref[k].values())).argmax() == next(iter(jax_ref[k].values())).argmax()
    for mode in ("int8w", "int8full"):
        out = _run_port(family, mode, images, calibration)
        val, delta = score_cls(ref, out, labels)
        print(f"{family} {mode}: top-1 {val:.2f} (FP32 {fp32_acc:.2f}, delta {delta:.2f})")
        assert delta <= 0.5 + 1e-9, (mode, val, delta)
