"""pyopenvino_tpu_torch — the PyTorch/CUDA port of pyopenvino_tpu.

An OpenVINO IR inference engine for one NVIDIA H100: it reads IR
(``.xml`` + ``.bin``), rewrites the graph at compile time and runs it with
PyTorch, with the hot ops in hand-written Hopper kernels (``kernels/``,
``csrc/``).  It imports neither JAX nor the JAX package, which stays the
reference.  It runs ResNet-18, MobileNet-v2, SSD-MobileNet-v1,
EfficientNet-B0, GoogLeNet's graph, ShuffleNet-v2 and POT-quantized IRs in
FP32, INT8 weight-only and INT8-FULL, in float32 or bfloat16 compute
(``Config.compute_dtype``), and bakes input preprocessing (u8 ingress)
into the graph with ``PrePostProcessor``, and serves concurrent requests
through ``Core`` → ``compile_model`` → ``AsyncInferQueue``, which coalesce
into batches in ``serving/`` (see ROADMAP.md).
"""

from pyopenvino_tpu_torch.api import (AsyncInferQueue, CompiledModel, Core, ExecutableNetwork,
                                      IECore, IENetwork, InferRequest, VariableState)
from pyopenvino_tpu_torch.config import Backend, Config, QuantMode
from pyopenvino_tpu_torch.preprocess import PrePostProcessor

# the JAX package's names, in its order
__all__ = [
    "AsyncInferQueue", "IECore", "Core", "CompiledModel", "IENetwork", "ExecutableNetwork",
    "InferRequest", "VariableState", "Config", "Backend", "QuantMode", "PrePostProcessor",
]
