from pyopenvino_tpu_torch.ir.model import Edge, Model, Node, TensorInfo
from pyopenvino_tpu_torch.ir.xml_parser import parse_ir, read_ir_model

__all__ = ["Edge", "Model", "Node", "TensorInfo", "parse_ir", "read_ir_model"]
