"""Parallelism of the port in one process: the device mesh
(``parallel/mesh.py``: data, tensor/expert and spatial sharding) and the
pipeline (``parallel/pipeline.py``: stage cuts, stage sub-models, GPipe
microbatches over data × stage).  Counterpart of ``pyopenvino_tpu/parallel``;
the multi-process groups (``initialize_multihost``) come with their own
slice, and ``__all__`` grows then."""

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
    "PipelinedNetwork",
    "build_pipeline_mesh",
    "compile_pipelined",
]
