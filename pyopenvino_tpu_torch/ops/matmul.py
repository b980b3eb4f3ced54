"""MatMul with transpose_a/transpose_b: FP32, INT8 weight-only and INT8-FULL.

Counterpart of ``pyopenvino_tpu/ops/matmul.py``; ``ref_compute`` is its
numpy ``np.matmul``.  On the KERNELS backend a 2-D weight runs the
fused_gemm kernel with the bias and activation in its epilogue (the JAX
package's Pallas route, matmul.py:87-99 and :112-130); leading activation
dims fold into M.  The (K, N) operand is derived once from the weight
(transposed when transpose_b) and cached by the compiler (under INT8-FULL
as the K-major ``.t()`` view of an (N, K) copy, which the int8 × int8
kernel takes); an int8 weight
stays int8 there and its (N,) scale (per output column either way) goes to
the kernel's epilogue.  Under INT8-FULL the activation is int8 codes too and
the kernel's int8 × int8 variant sums exactly in int32, the scale being
``qscale · s_x``; the TORCH route takes the same exact sum from a float64
``torch.matmul`` of the codes.  Otherwise ``torch.matmul`` on
``ctx.weight_for`` (an int8 weight dequantized on every call) plus the
epilogue.  Every route sums in float32 and writes the compute dtype
(bfloat16 operands widen exactly; an int8 × int8 product writes the
dtype of ``ops/spec.py::int8_out_dtype``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from pyopenvino_tpu_torch.ir import attrs as A
from pyopenvino_tpu_torch.kernels.gemm import epilogue, matmul_int32
from pyopenvino_tpu_torch.ops.spec import (
    Op, ShapeResult, TValue, int8_operand, int8_out_dtype, register,
)


def _flags(node):
    return (
        A.get_bool(node.attrs, "transpose_a", False),
        A.get_bool(node.attrs, "transpose_b", False),
    )


def _gemm_operand(tb):
    """Weight → contiguous matrix, transposed when ``tb``: the (K, N) GEMM
    operand for transpose_b = ``tb``, or the (N, K) copy for ``not tb``."""
    if tb:
        return lambda w: w.transpose(-1, -2).contiguous()
    return lambda w: w.contiguous()


@register
class MatMul(Op):
    type_name = "MatMul"
    int8_ports = (0,)  # takes int8 codes on the integer path

    def infer_shapes(self, node, in_shapes, in_values) -> ShapeResult:
        ta, tb = _flags(node)
        a, b = in_shapes[0], in_shapes[1]
        m = a[-1] if ta else a[-2]
        n = b[-2] if tb else b[-1]
        return ShapeResult({node.out_port: (*a[:-2], m, n)})

    def ref_compute(self, node, inputs) -> Dict[int, np.ndarray]:
        ta, tb = _flags(node)
        a, b = inputs[0], inputs[1]
        if ta:
            a = np.swapaxes(a, -1, -2)
        if tb:
            b = np.swapaxes(b, -1, -2)
        return {node.out_port: np.matmul(a, b)}

    def emit(self, ctx, node, inputs):
        return self.emit_fused(ctx, node, inputs)

    def emit_fused(self, ctx, node, inputs, bias=None, act=None):
        ta, tb = _flags(node)
        tv_b = inputs[1]
        q = int8_operand(ctx, node, inputs[0], tv_b)
        a = q[0] if q is not None else inputs[0].dequant(ctx.compute_dtype).arr
        out_dtype = int8_out_dtype(ctx, inputs[0]) if q is not None else a.dtype
        if ta:
            a = a.transpose(-1, -2)
        kernel = (ctx.use_kernels and tv_b.arr.dim() == 2
                  and (bias is None or bias.dim() <= 1))
        scale = tv_b.qscale.reshape(-1) if tv_b.qscale is not None else None
        if q is not None:
            scale = scale.float() * q[1]
            if not kernel:
                b = tv_b.arr.transpose(-1, -2) if tb else tv_b.arr
                out = epilogue(matmul_int32(a, b).float(), scale, bias, act)
                return {node.out_port: TValue(out.to(out_dtype))}

        if kernel:
            from pyopenvino_tpu_torch.kernels.gemm import fused_gemm

            if q is not None:  # int8 × int8: B K-major, the .t() of an (N, K) copy
                bmat = ctx.derived_weight(node, 1, f"gemm_nk.{int(tb)}",
                                          _gemm_operand(not tb)).t()
            else:
                bmat = ctx.derived_weight(node, 1, f"gemm_kn.{int(tb)}",
                                          _gemm_operand(tb))
            lead = a.shape[:-1]
            a2 = a.reshape(-1, a.shape[-1])
            if a2.stride(-1) != 1 or (a2.shape[0] > 1
                                      and a2.stride(0) < a2.shape[-1]):
                a2 = a2.contiguous()
            out = fused_gemm(a2, bmat, scale=scale, bias=bias, act=act, out_dtype=out_dtype)
            return {node.out_port: TValue(out.reshape(*lead, out.shape[-1]))}

        b = ctx.weight_for(node, tv_b)
        if tb:
            b = b.transpose(-1, -2)
        # float32 sums of the widened operands, the epilogue in float32, one
        # rounding to the compute dtype (XLA's preferred_element_type=f32)
        out = epilogue(a.float().matmul(b.float()), None, bias, act)
        return {node.out_port: TValue(out.to(out_dtype))}
