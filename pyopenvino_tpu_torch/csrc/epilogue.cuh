// epilogue.cuh: the activation codes and the float32 epilogue that the GEMM
// loops of this package end in (i8_mma.cuh, f32_mma.cuh and dw_pw.cu).
//
// epilogue() is act(v * scale + bias[n]) with each step rounded on its own
// (__fmul_rn then __fadd_rn, never an FMA), in the order of the TPU kernel
// (pyopenvino_tpu/kernels/gemm.py:63-76), so an int8 loop's output is
// bit-identical to the plain PyTorch version.  An exact int32 sum is
// converted to float32 first.

#pragma once

#include <cuda_runtime.h>

namespace gemm {

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_CLAMP = 2 };

__device__ __forceinline__ float activate(float v, int act, float lo, float hi) {
  if (act == ACT_RELU) return fmaxf(v, 0.f);
  if (act == ACT_CLAMP) return fminf(fmaxf(v, lo), hi);
  return v;
}

// act(v * scale + bias[n]); bias may be null.
__device__ __forceinline__ float epilogue(float v, float scale, const float* __restrict__ bias,
                                          int n, int act, float lo, float hi) {
  v = __fmul_rn(v, scale);
  if (bias != nullptr) v = __fadd_rn(v, bias[n]);
  return activate(v, act, lo, hi);
}

__device__ __forceinline__ float epilogue(int acc, float scale, const float* __restrict__ bias,
                                          int n, int act, float lo, float hi) {
  return epilogue(__int2float_rn(acc), scale, bias, n, act, lo, hi);
}

}  // namespace gemm
