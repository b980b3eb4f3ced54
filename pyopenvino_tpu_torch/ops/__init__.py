"""Op registry of the port: importing this package registers every op."""

from pyopenvino_tpu_torch.ops import (  # noqa: F401  (registration)
    conv,
    elementwise,
    io_ops,
    matmul,
    pool,
    shape_ops,
)
from pyopenvino_tpu_torch.ops.spec import (
    REGISTRY,
    Op,
    ShapeResult,
    TValue,
    get_op,
    register,
    supported_ops,
)

__all__ = [
    "REGISTRY", "Op", "ShapeResult", "TValue", "get_op", "register",
    "supported_ops",
]
