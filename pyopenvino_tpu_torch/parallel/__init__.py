"""Parallelism of the port: the device mesh (``parallel/mesh.py``: data,
tensor/expert and spatial sharding), the pipeline (``parallel/pipeline.py``:
stage cuts, stage sub-models, GPipe microbatches over data × stage) and
multi-process groups (``parallel/distributed.py``: ``initialize_multihost``,
``infer_batch_multiprocess``, the pipeline across processes).  Counterpart
of ``pyopenvino_tpu/parallel``, with the same ``__all__``."""

from pyopenvino_tpu_torch.parallel.distributed import initialize_multihost
from pyopenvino_tpu_torch.parallel.mesh import MeshConfig, build_mesh, shard_compiled
from pyopenvino_tpu_torch.parallel.pipeline import (
    PipelinedNetwork,
    build_pipeline_mesh,
    compile_pipelined,
)

__all__ = [
    "MeshConfig",
    "build_mesh",
    "shard_compiled",
    "initialize_multihost",
    "PipelinedNetwork",
    "build_pipeline_mesh",
    "compile_pipelined",
]
