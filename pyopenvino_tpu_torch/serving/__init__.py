"""Serving layer of the port: continuous batching over a compiled network.

Counterpart of ``pyopenvino_tpu/serving``: concurrent requests land in a
queue, one scheduler thread coalesces them into padded batch buckets and
answers them from ``CompiledNetwork.infer_batch`` while the callers wait on
futures.
"""

from pyopenvino_tpu_torch.serving.server import InferenceServer, ServerStats

__all__ = ["InferenceServer", "ServerStats"]
