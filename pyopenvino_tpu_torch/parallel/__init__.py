"""Parallelism of the port: the device mesh in one process
(``parallel/mesh.py``).  Counterpart of ``pyopenvino_tpu/parallel``; the
pipeline and the multi-process groups come with their own slices, and
``__all__`` grows then."""

from pyopenvino_tpu_torch.parallel.mesh import MeshConfig, build_mesh, shard_compiled

__all__ = [
    "MeshConfig",
    "build_mesh",
    "shard_compiled",
]
