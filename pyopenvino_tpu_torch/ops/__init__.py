"""Op registry of the port: importing this package registers every op."""

from pyopenvino_tpu_torch.ops import (  # noqa: F401  (registration)
    conv,
    elementwise,
    extended,
    io_ops,
    matmul,
    nms,
    pool,
    proposal,
    recurrent,
    roi,
    shape_ops,
    ssd,
    state_ops,
    subgraph,
    yolo,
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
