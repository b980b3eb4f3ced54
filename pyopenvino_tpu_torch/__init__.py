"""pyopenvino_tpu_torch — the PyTorch/CUDA port of pyopenvino_tpu.

An OpenVINO IR inference engine for one NVIDIA H100: it reads IR
(``.xml`` + ``.bin``), rewrites the graph at compile time and runs it with
PyTorch, with the hot ops in hand-written Hopper kernels (``kernels/``,
``csrc/``).  It imports neither JAX nor the JAX package, which stays the
reference.  Slices 1, 2, 4 and 5 run ResNet-18, MobileNet-v2 and
SSD-MobileNet-v1 in FP32, INT8 weight-only and INT8-FULL (see ROADMAP.md).
"""

from pyopenvino_tpu_torch.api import ExecutableNetwork, IECore, IENetwork
from pyopenvino_tpu_torch.config import Backend, Config, QuantMode

__all__ = [
    "Backend", "Config", "ExecutableNetwork", "IECore", "IENetwork",
    "QuantMode",
]
