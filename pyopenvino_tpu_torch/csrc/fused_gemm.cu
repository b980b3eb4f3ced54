// fused_gemm: C = act((A @ B) * scale + bias) with float32 accuracy, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pyopenvino_tpu/kernels/gemm.py::fused_gemm
// (body _kernel, gemm.py:35-76; grid and scratch in _fused_gemm_impl,
// gemm.py:86-167) in five variants, one C entry point each:
//   * fused_gemm_f32:     A float32, B float32;
//   * fused_gemm_f32_i8w: A float32, B int8 (weight-only INT8) with a
//     per-column float32 scale (gemm.py:44-59, scale at :64-65);
//   * fused_gemm_i8i8:    A int8, B int8 (INT8-FULL): an exact int32 sum
//     (gemm.py:44-47, int32 scratch at :150), then the per-column scale,
//     bias and activation, C in float32 or bfloat16 (out_bf16: the TPU
//     kernel's out_dtype, the compute dtype);
//   * fused_gemm_bf16:     A bfloat16, B bfloat16, C bfloat16 (the TPU
//     kernel under compute_dtype="bfloat16": DEFAULT precision, a float32
//     accumulator, gemm.py:50-58);
//   * fused_gemm_bf16_i8w: A bfloat16, B int8 with its per-column scale,
//     C bfloat16.
//
// What bounds it on an H100 SXM: device memory moves 3.35 TB/s; a
// float32-accurate product runs on the TF32 tensor cores (495 TFLOP/s dense)
// in three passes for a float32 B and two for an int8 B (f32_mma.cuh), at
// 165 and 248 TFLOP/s of useful work, against 67 TFLOP/s for float32 FFMA.
// So the 1x1 convs and FCs of the main paths are bound by their bytes, or
// close to the line; a classifier at small batch is a matrix-vector product,
// bound by reading B, which is where int8 B (a quarter of the f32 bytes)
// pays.  The int8 x int8 variant's roof is the int8 tensor cores' 1,979 TOPS
// dense: the INT8-FULL path shapes with short K (the stems, K = 64 ... 144)
// are bound by their bytes (int8 in, float32 out), those with K of 576 and
// more within a factor of about two of their operations.
//
// Loops, one per variant:
//   * fused_gemm_f32 and fused_gemm_f32_i8w: f32_mma.cuh, TF32 mma.sync
//     with A split in a hi and a lo term (and a float32 B too: three
//     passes; an int8 B is exact in TF32: two), a cp.async ring and split-K
//     with a fixed-order reduction (see its design note).  The TPU kernel
//     walks K as a sequential grid axis with the sum in VMEM scratch; here
//     each block owns one output tile and loops over its range of K itself.
//     Their _wgmma twins: f32_wgmma.cuh's loop (TF32 wgmma with A's terms
//     in registers and B's made once a stage or a band in shared memory, A
//     and B by tiled TMA loads, a TMA producer warp, two consumer
//     warpgroups, persistent blocks, split K with the same reduction; see
//     its design note), the same split and passes, for the launches
//     kernels/gemm.py::f32_route sends there.
//   * fused_gemm_i8i8: i8_mma.cuh, int8 mma.sync on the tensor cores, a
//     cp.async ring and split-K (see its design note).  B is K-major: the
//     caller passes an (N, K) contiguous int8 matrix.  Its _wgmma twin:
//     i8_wgmma.cuh's loop (int8 wgmma, A and B by tiled TMA loads, a TMA
//     producer warp, two consumer warpgroups, two persistent blocks an SM,
//     split K; see its design note), the same bits, for the launches
//     kernels/gemm.py::i8_route sends there.
//   * fused_gemm_bf16 and fused_gemm_bf16_i8w: bf16_mma.cuh, one bf16
//     mma.sync pass with a float32 accumulator, a cp.async ring and split-K
//     (see its design note); the epilogue in float32, one rounding to
//     bfloat16.  Their _wgmma twins: bf16_wgmma.cuh, persistent blocks,
//     TMA loads through an mbarrier ring, wgmma on a band of B resident in
//     shared memory and a TMA store (see its design note); the same
//     function, for the launches kernels/gemm.py::bf16_route sends there.
//   * Ragged M/N/K edges are zero in shared memory and masked at the
//     stores; nothing is padded in device memory.  The epilogue runs scale
//     -> bias -> relu/clamp on the finished sum before the one write of C,
//     in the order of gemm.py:63-76.
//   * A may have a row stride (lda >= K) and must have unit column stride;
//     C is row-major (M, N).

#include <cuda_runtime.h>

#include <cstdint>

#include "bf16_mma.cuh"
#include "bf16_wgmma.cuh"
#include "f32_mma.cuh"
#include "f32_wgmma.cuh"
#include "i8_mma.cuh"
#include "i8_wgmma.cuh"

namespace {

// One split: k per split rounded up to the loop's K step.
int whole_k(int K, int bk) { return K > bk ? (K + bk - 1) / bk * bk : bk; }

// fused_gemm_f32's operands: B row-major (K, N) float32.
// A (M, K) float32 with row stride lda, read by 16-byte chunks where A and
// lda are 4-float aligned.
f32mma::RowMajorF32 row_major_a(const void* A, int M, int K, int lda) {
  const auto a_addr = reinterpret_cast<std::uintptr_t>(A);
  return {static_cast<const float*>(A), (long long)lda, (long long)M, K,
          a_addr % 16 == 0 && lda % 4 == 0};
}

int f32(const void* A, const void* B, const void* scale, const void* bias, void* C, int M, int N,
        int K, int lda, int kchunk, void* ws, int act, float lo, float hi, void* stream) {
  const auto b_addr = reinterpret_cast<std::uintptr_t>(B);
  const f32mma::BFloat bl{static_cast<const float*>(B), N, K, b_addr % 16 == 0 && N % 4 == 0};
  return f32mma::launch(row_major_a(A, M, K, lda), bl, scale, bias, C, M, N, K, kchunk, ws, act,
                        lo, hi, stream);
}

// fused_gemm_f32_i8w's operands: B row-major (K, N) int8, read a row of k
// (N bytes) at a time.
int f32_i8w(const void* A, const void* B, const void* scale, const void* bias, void* C, int M,
            int N, int K, int lda, int kchunk, void* ws, int act, float lo, float hi,
            void* stream) {
  if (scale == nullptr) return (int)cudaErrorInvalidValue;
  const auto b_addr = reinterpret_cast<std::uintptr_t>(B);
  const f32mma::BInt8 bl{{static_cast<const int8_t*>(B), (long long)N, (long long)K, N,
                          b_addr % 16 == 0 && N % 16 == 0, b_addr % 4 == 0 && N % 4 == 0}};
  return f32mma::launch(row_major_a(A, M, K, lda), bl, scale, bias, C, M, N, K, kchunk, ws, act,
                        lo, hi, stream);
}

// fused_gemm_i8i8's operands: A (M, K) with row stride lda, B K-major.
int i8i8(const void* A, const void* B, const void* scale, const void* bias, void* C, int M,
         int N, int K, int lda, int out_bf16, int kchunk, void* ws, int act, float lo, float hi,
         void* stream) {
  const auto a_addr = reinterpret_cast<std::uintptr_t>(A);
  const auto b_addr = reinterpret_cast<std::uintptr_t>(B);
  const i8mma::RowMajor la{static_cast<const int8_t*>(A), (long long)lda, (long long)M, K,
                           a_addr % 16 == 0 && lda % 16 == 0, a_addr % 4 == 0 && lda % 4 == 0};
  const i8mma::RowMajor lb{static_cast<const int8_t*>(B), (long long)K, (long long)N, K,
                           b_addr % 16 == 0 && K % 16 == 0, b_addr % 4 == 0 && K % 4 == 0};
  return i8mma::launch(la, lb, scale, bias, C, out_bf16 != 0, M, N, K, kchunk, ws, act, lo, hi,
                       stream);
}

// fused_gemm_bf16's A: (M, K) bfloat16 with row stride lda.
bf16mma::RowMajorBf16 row_major_bf16(const void* A, int M, int K, int lda) {
  const auto a_addr = reinterpret_cast<std::uintptr_t>(A);
  return {static_cast<const __nv_bfloat16*>(A), (long long)lda, (long long)M, K,
          a_addr % 16 == 0 && lda % 8 == 0};
}

// B row-major (K, N): bfloat16 (b_int8 == 0) or int8 (b_int8 != 0, scale
// required).
int bf16(const void* A, const void* B, int b_int8, const void* scale, const void* bias, void* C,
         int M, int N, int K, int lda, int kchunk, void* ws, int act, float lo, float hi,
         void* stream) {
  const auto b_addr = reinterpret_cast<std::uintptr_t>(B);
  const bf16mma::RowMajorBf16 la = row_major_bf16(A, M, K, lda);
  if (b_int8) {
    if (scale == nullptr) return (int)cudaErrorInvalidValue;
    const bf16mma::BInt8 bl{{static_cast<const int8_t*>(B), (long long)N, (long long)K, N,
                             b_addr % 16 == 0 && N % 16 == 0, b_addr % 4 == 0 && N % 4 == 0}};
    return bf16mma::launch(la, bl, scale, bias, C, M, N, K, kchunk, ws, act, lo, hi, stream);
  }
  const bf16mma::BBf16 bl{{static_cast<const __nv_bfloat16*>(B), (long long)N, (long long)K, N,
                           b_addr % 16 == 0 && N % 8 == 0}};
  return bf16mma::launch(la, bl, scale, bias, C, M, N, K, kchunk, ws, act, lo, hi, stream);
}

}  // namespace

// Plain C interface for ctypes.  scale and bias may be null (the wrapper
// always passes a scale to the int8 variants).  Launches on `stream` and does
// not synchronise.  Returns cudaGetLastError() after the launch: 0 when the
// launch was accepted.  One split.
extern "C" int fused_gemm_f32(const void* A, const void* B, const void* scale,
                              const void* bias, void* C, int M, int N, int K,
                              int lda, int act, float lo, float hi, void* stream) {
  return f32(A, B, scale, bias, C, M, N, K, lda, whole_k(K, f32mma::BK), nullptr, act, lo, hi,
             stream);
}

// The same with split-K: kchunk values of k per split (a multiple of 32), ws
// a float32 workspace of ceil(K / kchunk) * M * N values.
extern "C" int fused_gemm_f32_splitk(const void* A, const void* B, const void* scale,
                                     const void* bias, void* C, int M, int N, int K, int lda,
                                     int act, float lo, float hi, int kchunk, void* ws,
                                     void* stream) {
  return f32(A, B, scale, bias, C, M, N, K, lda, kchunk, ws, act, lo, hi, stream);
}

// B row-major (K, N) int8; scale is required.  One split.
extern "C" int fused_gemm_f32_i8w(const void* A, const void* B, const void* scale,
                                  const void* bias, void* C, int M, int N, int K,
                                  int lda, int act, float lo, float hi, void* stream) {
  return f32_i8w(A, B, scale, bias, C, M, N, K, lda, whole_k(K, f32mma::BK), nullptr, act, lo,
                 hi, stream);
}

// The same with split-K: kchunk values of k per split (a multiple of 32), ws
// a float32 workspace of ceil(K / kchunk) * M * N values.
extern "C" int fused_gemm_f32_i8w_splitk(const void* A, const void* B, const void* scale,
                                         const void* bias, void* C, int M, int N, int K,
                                         int lda, int act, float lo, float hi, int kchunk,
                                         void* ws, void* stream) {
  return f32_i8w(A, B, scale, bias, C, M, N, K, lda, kchunk, ws, act, lo, hi, stream);
}

// The same functions on f32_wgmma.cuh's loop (TF32 wgmma, A and B by tiled
// TMA loads, 128 x 64 tiles), the arguments as fused_gemm_f32's up to hi,
// then the plan (kernels/gemm.py::f32_plan): the ring's stages, the K
// splits (ws a float32 workspace of splits * M * N values when above 1),
// band (B's terms made once a band; one split only), grid the most
// persistent blocks.  A, B and C 16-byte aligned, lda a multiple of 4, N at
// least 64 and a multiple of 4; anything else, or a tensor map that the
// encoder refuses, returns cudaErrorInvalidValue.  Launches on `stream` and
// does not synchronise.
extern "C" int fused_gemm_f32_wgmma(const void* A, const void* B, const void* scale,
                                    const void* bias, void* C, int M, int N, int K, int lda,
                                    int act, float lo, float hi, int stages, int splits, int band,
                                    int grid, void* ws, void* stream) {
  return f32wgmma::launch(A, B, false, scale, bias, C, M, N, K, lda, act, lo, hi, stages, splits,
                          band != 0, grid, ws, stream);
}

// B row-major (K, N) int8, N a multiple of 16; scale is required.
extern "C" int fused_gemm_f32_i8w_wgmma(const void* A, const void* B, const void* scale,
                                        const void* bias, void* C, int M, int N, int K, int lda,
                                        int act, float lo, float hi, int stages, int splits,
                                        int band, int grid, void* ws, void* stream) {
  return f32wgmma::launch(A, B, true, scale, bias, C, M, N, K, lda, act, lo, hi, stages, splits,
                          band != 0, grid, ws, stream);
}

// B K-major: an (N, K) contiguous int8 matrix.  scale is required (the int32
// sum is in code units); bias may be null.  C is float32, or bfloat16 when
// out_bf16 != 0.  One split.
extern "C" int fused_gemm_i8i8(const void* A, const void* B, const void* scale,
                               const void* bias, void* C, int M, int N, int K, int lda,
                               int out_bf16, int act, float lo, float hi, void* stream) {
  return i8i8(A, B, scale, bias, C, M, N, K, lda, out_bf16, whole_k(K, i8mma::BK), nullptr, act,
              lo, hi, stream);
}

// The same with split-K: kchunk values of k per split (a multiple of 64), ws
// an int32 workspace of ceil(K / kchunk) * M * N values.
extern "C" int fused_gemm_i8i8_splitk(const void* A, const void* B, const void* scale,
                                      const void* bias, void* C, int M, int N, int K, int lda,
                                      int out_bf16, int act, float lo, float hi, int kchunk,
                                      void* ws, void* stream) {
  return i8i8(A, B, scale, bias, C, M, N, K, lda, out_bf16, kchunk, ws, act, lo, hi, stream);
}

// The same function on i8_wgmma.cuh's loop (int8 wgmma, A and B by tiled
// TMA loads), the arguments as fused_gemm_i8i8's up to hi, then the plan
// (kernels/gemm.py::i8_plan): bn the tile's N (64 or 128), sl the bytes of
// k a step (32, 64 or 128), the ring's stages, the K splits (ws an int32
// workspace of splits * M * N values when above 1), grid the most
// persistent blocks.  K and lda multiples of 16, A, B and C 16-byte
// aligned, N at least bn and a multiple of 4 (float32 C) or 8 (bf16 C);
// anything else, or a tensor map that the encoder refuses, returns
// cudaErrorInvalidValue.  Launches on `stream` and does not synchronise.
extern "C" int fused_gemm_i8i8_wgmma(const void* A, const void* B, const void* scale,
                                     const void* bias, void* C, int M, int N, int K, int lda,
                                     int out_bf16, int act, float lo, float hi, int bn, int sl,
                                     int stages, int splits, int grid, void* ws,
                                     void* stream) {
  return i8wgmma::launch_gemm(A, B, scale, bias, C, out_bf16 != 0, M, N, K, lda, act, lo, hi,
                              bn, sl, stages, splits, grid, ws, stream);
}

// A (M, K) bfloat16 with row stride lda, B row-major (K, N) bfloat16, C
// (M, N) bfloat16; scale and bias float32, either may be null.  One split.
extern "C" int fused_gemm_bf16(const void* A, const void* B, const void* scale,
                               const void* bias, void* C, int M, int N, int K, int lda,
                               int act, float lo, float hi, void* stream) {
  return bf16(A, B, 0, scale, bias, C, M, N, K, lda, whole_k(K, bf16mma::BK), nullptr, act, lo,
              hi, stream);
}

// The same with split-K: kchunk values of k per split (a multiple of 32), ws
// a float32 workspace of ceil(K / kchunk) * M * N values.
extern "C" int fused_gemm_bf16_splitk(const void* A, const void* B, const void* scale,
                                      const void* bias, void* C, int M, int N, int K, int lda,
                                      int act, float lo, float hi, int kchunk, void* ws,
                                      void* stream) {
  return bf16(A, B, 0, scale, bias, C, M, N, K, lda, kchunk, ws, act, lo, hi, stream);
}

// B row-major (K, N) int8; scale is required.  One split.
extern "C" int fused_gemm_bf16_i8w(const void* A, const void* B, const void* scale,
                                   const void* bias, void* C, int M, int N, int K, int lda,
                                   int act, float lo, float hi, void* stream) {
  return bf16(A, B, 1, scale, bias, C, M, N, K, lda, whole_k(K, bf16mma::BK), nullptr, act, lo,
              hi, stream);
}

// The same with split-K: kchunk values of k per split (a multiple of 32), ws
// a float32 workspace of ceil(K / kchunk) * M * N values.
extern "C" int fused_gemm_bf16_i8w_splitk(const void* A, const void* B, const void* scale,
                                          const void* bias, void* C, int M, int N, int K,
                                          int lda, int act, float lo, float hi, int kchunk,
                                          void* ws, void* stream) {
  return bf16(A, B, 1, scale, bias, C, M, N, K, lda, kchunk, ws, act, lo, hi, stream);
}

// The same functions on bf16_wgmma.cuh's loop: bn (64, 128, 192 or 256),
// stages (2-8), stream (B with each k step, not a resident band) and grid
// (the most blocks) from kernels/gemm.py::wgmma_plan.
// A, B and C 16-byte aligned; lda, N and K multiples of 8; anything else,
// or a tensor map that cuTensorMapEncodeTiled refuses, returns cudaErrorInvalidValue.
extern "C" int fused_gemm_bf16_wgmma(const void* A, const void* B, const void* scale,
                                     const void* bias, void* C, int M, int N, int K, int lda,
                                     int act, float lo, float hi, int bn, int stages,
                                     int stream_b, int grid, void* stream) {
  return bf16wgmma::launch(A, B, false, scale, bias, C, M, N, K, lda, bn, stages, stream_b != 0,
                           grid, act, lo, hi, stream);
}

// B row-major (K, N) int8, N a multiple of 16; scale is required.
extern "C" int fused_gemm_bf16_i8w_wgmma(const void* A, const void* B, const void* scale,
                                         const void* bias, void* C, int M, int N, int K, int lda,
                                         int act, float lo, float hi, int bn, int stages,
                                         int stream_b, int grid, void* stream) {
  return bf16wgmma::launch(A, B, true, scale, bias, C, M, N, K, lda, bn, stages, stream_b != 0,
                           grid, act, lo, hi, stream);
}
