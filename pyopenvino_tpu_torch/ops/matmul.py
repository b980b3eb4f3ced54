"""MatMul with transpose_a/transpose_b, FP32 and INT8 weight-only.

Counterpart of ``pyopenvino_tpu/ops/matmul.py`` (without its INT8-FULL
branch).  On the KERNELS backend a 2-D weight runs the fused_gemm kernel
with the bias and activation in its epilogue (the JAX package's Pallas
route, matmul.py:112-130); leading activation dims fold into M.  The (K, N)
operand is derived once from the weight (transposed when transpose_b) and
cached by the compiler; an int8 weight stays int8 there and its (N,) scale
(per output column either way) goes to the kernel's epilogue.  Otherwise
``torch.matmul`` on ``ctx.weight_for`` (an int8 weight dequantized on every
call) plus the epilogue.
"""

from __future__ import annotations

from pyopenvino_tpu_torch.ir import attrs as A
from pyopenvino_tpu_torch.kernels.gemm import apply_act
from pyopenvino_tpu_torch.ops.spec import Op, ShapeResult, TValue, register


def _flags(node):
    return (
        A.get_bool(node.attrs, "transpose_a", False),
        A.get_bool(node.attrs, "transpose_b", False),
    )


def _gemm_operand(tb):
    """Weight → contiguous (K, N) GEMM operand."""
    if tb:
        return lambda w: w.transpose(-1, -2).contiguous()
    return lambda w: w.contiguous()


@register
class MatMul(Op):
    type_name = "MatMul"

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        ta, tb = _flags(node)
        a, b = in_shapes[0], in_shapes[1]
        m = a[-1] if ta else a[-2]
        n = b[-2] if tb else b[-1]
        return ShapeResult({node.out_port: (*a[:-2], m, n)})

    def emit(self, ctx, node, inputs):
        return self.emit_fused(ctx, node, inputs)

    def emit_fused(self, ctx, node, inputs, bias=None, act=None):
        ta, tb = _flags(node)
        a = inputs[0].arr
        tv_b = inputs[1]
        if ta:
            a = a.transpose(-1, -2)

        if ctx.use_kernels and tv_b.arr.dim() == 2 and (bias is None or bias.dim() <= 1):
            from pyopenvino_tpu_torch.kernels.gemm import fused_gemm

            bmat = ctx.derived_weight(node, 1, f"gemm_kn.{int(tb)}",
                                      _gemm_operand(tb))
            scale = tv_b.qscale.reshape(-1) if tv_b.qscale is not None else None
            lead = a.shape[:-1]
            a2 = a.reshape(-1, a.shape[-1])
            if a2.stride(-1) != 1 or (a2.shape[0] > 1
                                      and a2.stride(0) < a2.shape[-1]):
                a2 = a2.contiguous()
            out = fused_gemm(a2, bmat, scale=scale, bias=bias, act=act)
            return {node.out_port: TValue(out.reshape(*lead, out.shape[-1]))}

        b = ctx.weight_for(node, tv_b)
        if tb:
            b = b.transpose(-1, -2)
        out = a.matmul(b)
        if bias is not None:
            out = out + bias
        return {node.out_port: TValue(apply_act(out, act))}
