// fused_gemm: C = act((A @ B) * scale + bias) in full float32, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pyopenvino_tpu/kernels/gemm.py::fused_gemm
// (body _kernel, gemm.py:35-76; grid and scratch in _fused_gemm_impl,
// gemm.py:86-167) in three variants, one C entry point each:
//   * fused_gemm_f32:     A float32, B float32;
//   * fused_gemm_f32_i8w: A float32, B int8 (weight-only INT8) with a
//     per-column float32 scale (gemm.py:44-59, scale at :64-65);
//   * fused_gemm_i8i8:    A int8, B int8 (INT8-FULL): an exact int32 sum
//     (gemm.py:44-47, int32 scratch at :150), then the per-column scale,
//     bias and activation.  Its tile loop is int8_tile.cuh's (__dp4a).
//
// What bounds it on an H100 SXM: float32 FMAs run outside the tensor cores at
// 67 TFLOP/s, and device memory moves 3.35 TB/s, so a product whose
// 2*M*N*K / (bytes moved) exceeds about 20 FLOP per byte is bound by
// arithmetic.  Large-M 1x1 convs sit near or above that line; a classifier
// at small batch is a matrix-vector product, bound by reading B, which is
// where int8 B (a quarter of the f32 bytes) pays.  The int8 x int8 variant's
// roof is the int8 tensor cores' 1,979 TOPS dense, against which every
// INT8-FULL path shape is bound by its bytes (int8 in, float32 out); its
// __dp4a loop runs on the CUDA cores, far below that roof, and mma.sync or
// wgmma on the tensor cores, with a pipelined K loop, is later work.
//
// Design of the float32-A variants (right and simple first), the tile loop
// of f32_tile.cuh, which conv_direct.cu's float entry shares:
//   * The TPU kernel walks K as a sequential "arbitrary" grid axis and keeps
//     the sum in VMEM scratch across grid steps.  Blocks on a GPU run in
//     parallel and in no order, so each block owns one 64 x 64 output tile
//     and loops over K itself, keeping the sum in registers.
//   * 256 threads per block; each thread owns a 4 x 4 micro-tile.  A and B
//     tiles of depth 16 are staged in shared memory as float32 (A
//     transposed, so both operands are read as float4 broadcasts).
//   * int8 B is read from device memory as bytes, four neighbouring columns
//     per thread in one 4-byte load when N % 4 == 0 and B is 4-byte aligned
//     (the host decides; otherwise one byte at a time), and converted to
//     float32 on the way into the shared tile.  The product is the same
//     FFMA loop as for f32 B; the TPU kernel likewise upcasts the tile on
//     the VPU (gemm.py:49-50).
//   * Full float32 FFMA, no TF32: matches Precision.HIGHEST in the reference.
//   * Ragged M/N/K edges are masked at the loads (zero in shared memory) and
//     at the stores.  Nothing is padded in device memory.
//   * The epilogue runs scale -> bias -> relu/clamp on the registers before
//     the one write of C, in the order of gemm.py:63-76: the int8 variant's
//     dequant scale multiplies the finished accumulator, not B.
//   * A may have a row stride (lda >= K) and must have unit column stride;
//     B is row-major (K, N), C row-major (M, N).
// wgmma, TMA and a deeper pipeline are later work.

#include <cuda_runtime.h>

#include <cstdint>

#include "f32_tile.cuh"
#include "int8_tile.cuh"

namespace {

// A row-major (M, K) float32 matrix with row stride lda for f32_tile.cuh.
struct GemmF32A {
  const float* A;
  long long lda;
  long long M;
  int K;

  struct Row {
    long long m;
  };
  struct Col {
    int k;
  };

  __device__ Row row(long long m) const { return {m}; }
  __device__ Col col(int k) const { return {k}; }
  __device__ float at(const Row& r, const Col& c) const {
    return (r.m < M && c.k < K) ? A[r.m * lda + c.k] : 0.f;
  }
};

template <typename TB>
int launch(const void* A, const void* B, const void* scale, const void* bias, void* C,
           int M, int N, int K, int lda, int act, float lo, float hi, void* stream) {
  const GemmF32A ld{static_cast<const float*>(A), (long long)lda, (long long)M, K};
  return f32tile::launch<GemmF32A, TB>(ld, B, scale, bias, C, M, N, K, act, lo, hi, stream);
}

// A row-major (M, K) int8 matrix with row stride lda for int8_tile.cuh.
// vec4: A and lda are multiples of 4 bytes, so a group at k % 4 == 0 that
// lies inside K is one aligned 4-byte load; otherwise byte by byte.
struct GemmA {
  const int8_t* A;
  long long lda;
  long long M;
  int K;
  bool vec4;

  struct Row {
    const int8_t* p;
    bool valid;
  };

  __device__ Row row(long long m) const { return {A + (m < M ? m : 0) * lda, m < M}; }

  __device__ int group(const Row& r, int k) const {
    if (!r.valid || k >= K) return 0;
    if (vec4 && k + 3 < K) return *reinterpret_cast<const int*>(r.p + k);
    return i8tile::pack4(r.p[k], k + 1 < K ? r.p[k + 1] : 0, k + 2 < K ? r.p[k + 2] : 0,
                         k + 3 < K ? r.p[k + 3] : 0);
  }
};

}  // namespace

// Plain C interface for ctypes.  scale and bias may be null (the wrapper
// always passes a scale to the int8 variant).  Launches on `stream` and does
// not synchronise.  Returns cudaGetLastError() after the launch: 0 when the
// launch was accepted.
extern "C" int fused_gemm_f32(const void* A, const void* B, const void* scale,
                              const void* bias, void* C, int M, int N, int K,
                              int lda, int act, float lo, float hi, void* stream) {
  return launch<float>(A, B, scale, bias, C, M, N, K, lda, act, lo, hi, stream);
}

extern "C" int fused_gemm_f32_i8w(const void* A, const void* B, const void* scale,
                                  const void* bias, void* C, int M, int N, int K,
                                  int lda, int act, float lo, float hi, void* stream) {
  return launch<int8_t>(A, B, scale, bias, C, M, N, K, lda, act, lo, hi, stream);
}

// scale is required (the int32 sum is in code units); bias may be null.
extern "C" int fused_gemm_i8i8(const void* A, const void* B, const void* scale,
                               const void* bias, void* C, int M, int N, int K, int lda,
                               int act, float lo, float hi, void* stream) {
  const bool vec4 = reinterpret_cast<std::uintptr_t>(A) % 4 == 0 && lda % 4 == 0;
  const GemmA ld{static_cast<const int8_t*>(A), (long long)lda, (long long)M, K, vec4};
  return i8tile::launch(ld, B, scale, bias, C, M, N, K, act, lo, hi, stream);
}
