"""The general traffic generator: what a mix's data file asks for, made from
the seed.

A mix (``traffic/<name>.json``) names its ``kind``, the driver
``drivers/<kind>.py`` that reads it, and its parameters:

  * ``closed_batch``: one client calling back to back, each call ``batch``
    frames taken in turn from a pool of ``pool`` batches made from the
    seed in host memory.

Frames are u8 of the network's input shape, uniform in [0, 256), drawn on
the device in one call.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from perfbench.core import weights
from perfbench.core.ir import Graph


def pool_frames(graph: Graph, n: int, seed: int, device) -> torch.Tensor:
    return weights.frames(graph, n, seed, weights.TRAFFIC, device)


def closed_batch(graph: Graph, mix: dict, seed: int, device) -> Tuple[torch.Tensor, List[np.ndarray]]:
    """(every distinct frame, on the device; the pool of host batches)."""
    b, k = int(mix["batch"]), int(mix["pool"])
    frames = pool_frames(graph, b * k, seed, device)
    host = frames.cpu().numpy()
    return frames, [np.ascontiguousarray(host[i * b:(i + 1) * b]) for i in range(k)]
