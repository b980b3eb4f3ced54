"""Small helpers of the port: golden comparison (``compare``) and device
selection (``platform``)."""

from pyopenvino_tpu_torch.utils.platform import select_device

__all__ = ["select_device"]
