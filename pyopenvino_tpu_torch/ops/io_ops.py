"""Graph boundary ops: Parameter, Const, Result.

Counterpart of ``pyopenvino_tpu/ops/io_ops.py``.  The compiler binds inputs
by Parameter name, materializes Consts from its weight dict and collects
outputs by Result name, so these registrations provide shape inference only.
"""

from __future__ import annotations

from pyopenvino_tpu_torch.ops.spec import Op, ShapeResult, register


@register
class Parameter(Op):
    type_name = "Parameter"

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        return ShapeResult({node.out_port: node.outputs[node.out_port].shape})

    def emit(self, ctx, node, inputs):
        raise RuntimeError("Parameter nodes are bound by the compiler")


@register
class Const(Op):
    type_name = "Const"

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        info = node.outputs[node.out_port]
        return ShapeResult(
            {node.out_port: info.shape},
            {node.out_port: node.const} if node.const is not None else {},
        )

    def emit(self, ctx, node, inputs):
        raise RuntimeError("Const nodes are materialized by the compiler")


@register
class Result(Op):
    type_name = "Result"

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        return ShapeResult({})

    def emit(self, ctx, node, inputs):
        return {}
