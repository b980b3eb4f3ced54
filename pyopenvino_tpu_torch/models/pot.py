"""``resnet18-pot``: the port's POT-quantized full-width ResNet-18.

Built as the JAX package's ``__graft_entry__`` builds its ``resnet18-pot``
family, from the port's own pieces: ``models/resnet18.xml`` with the
weights ``models/synth.py`` synthesizes from ``seed``, through
``tools/pot_quantize.py::quantize_ir`` with ``gen_samples(model, 4)``
(inputs uniform in [0, 255), calibrated on the host by the numpy
interpreter), written by ``ir/writer.py`` and read back as a user's POT IR
would be.  Every conv and the classifier get a per-channel (per-tensor for
the MatMul) 256-level weight FakeQuantize and a per-tensor activation
FakeQuantize on its data input: 21 on weights and 18 on activations (each
of the three projection shortcuts shares its block's input, and its node,
with the block's first conv).
"""

from __future__ import annotations

import os
from typing import Tuple

from pyopenvino_tpu_torch.ir import read_ir_model
from pyopenvino_tpu_torch.ir.writer import write_ir_model
from pyopenvino_tpu_torch.models.synth import BUILD_DIR, resnet18_paths

CALIBRATION_SAMPLES = 4


def pot_ir_paths(seed: int = 0) -> Tuple[str, str]:
    """(xml, bin) where ``resnet18_pot_paths`` keeps the IR of ``seed``."""
    xml = os.path.join(BUILD_DIR, f"resnet18_pot-seed{seed}.xml")
    return xml, xml[:-4] + ".bin"


def resnet18_pot_paths(seed: int = 0) -> Tuple[str, str]:
    """(xml, bin) of ``build/models/resnet18_pot-seed<seed>.{xml,bin}``,
    quantized and written unless both exist."""
    from pyopenvino_tpu_torch.tools.pot_quantize import gen_samples, quantize_ir

    xml, binp = pot_ir_paths(seed)
    if not (os.path.exists(xml) and os.path.exists(binp)):
        model = read_ir_model(*resnet18_paths(seed=seed))
        pot = quantize_ir(model, samples=gen_samples(model, CALIBRATION_SAMPLES))
        tmp = f"{xml[:-4]}.{os.getpid()}.tmp"
        write_ir_model(pot, tmp + ".xml", tmp + ".bin")
        os.replace(tmp + ".bin", binp)
        os.replace(tmp + ".xml", xml)
    return xml, binp
