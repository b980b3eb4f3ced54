// f32_i8w_mma.cuh: float32 A times int8 B with float32 accuracy on Hopper's
// TF32 tensor cores (mma.sync), fed through a cp.async ring, with split-K.
// fused_gemm.cu's fused_gemm_f32_i8w (weight-only INT8) runs it.
//
// C[m][n] = act((sum_k A[m][k] * B[k][n]) * scale[n] + bias[n]), with A a
// row-major (M, K) float32 matrix with row stride lda, B a row-major (K, N)
// int8 matrix, scale the per-column dequant scale, C row-major (M, N).
//
// Design note.
//   * Products: mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32.  An int8
//     code is exact in TF32 (8 significant bits of its 11), so only A is
//     split: a_hi = cvt.rna.tf32(a), a_lo = cvt.rna.tf32(a - a_hi).  Two
//     products, lo first, then hi, go into one float32 accumulator; the two
//     terms carry 22 of A's 24 significant bits.  It is the idea of the TPU
//     kernel's Precision.HIGHEST (multi-pass bf16 on its matrix unit,
//     pyopenvino_tpu/kernels/gemm.py:51-59), and it moves the product from
//     FFMA at 67 TFLOP/s to the 495 TFLOP/s TF32 units at two passes.
//   * Accuracy: the tensor cores add the eight products of an m16n8k8 and the
//     accumulator at float32 width but need not round to nearest, so a long
//     K chain can drift; split-K shortens the chains, and the card tests hold
//     the result within 2e-5 of max |plain| at K = 1280 and beyond.
//   * Tiles: BM x BN = 64 x 64 per block, 4 warps as 2 x 2, each a 32 x 32
//     warp tile of 2 x 4 mma tiles (32 float32 accumulators a thread).  The
//     ring holds STAGES = 4 stages of BK = 32 values of k (A 64 x 32 float32,
//     rows padded to 36 so a fragment's 32 lanes hit 32 banks; B 32 x 64
//     int8, rows padded to 80 bytes), 46 KB, static.  Stages k+1 .. k+3 are
//     in flight while stage k multiplies.
//   * Loads: A by 16-byte cp.async.cg where A and lda are 4-float aligned,
//     else by 4-byte cp.async.ca.  B, a row of k at a time, through
//     i8_mma.cuh's RowMajor loader and fetch/put: 16-byte cp.async where B
//     and N are 16-byte aligned, 4-byte where 4-byte aligned, and else
//     through registers (read before the stage's mma, stored after it).
//     src-size zero-fills beyond K, M and N.  B stays int8 in shared memory
//     and is converted to TF32 (exactly) as its fragments are read.
//   * Split-K: blockIdx.z takes k in [z * kchunk, (z + 1) * kchunk), kchunk a
//     multiple of BK chosen by the host (kernels/gemm.py::split_k) when the
//     tile grid would not fill the card (the classifier FCs, every batch-1
//     shape).  Each split writes its float32 partial tile to a workspace, and
//     a second kernel adds the splits in the fixed order z = 0, 1, ... before
//     the epilogue: no float atomics, so two calls give the same bits.
//   * The warp-tile store, the split grid and the reduction are
//     i8_mma.cuh's, with float32 partials; the epilogue is epilogue.cuh's
//     (gemm.py:63-76): the scale multiplies the finished sum, then the bias,
//     then ReLU or clamp, each rounded alone.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "i8_mma.cuh"

namespace i8wmma {

using i8mma::clamp_bytes;
using i8mma::cp_async16;
using i8mma::cp_async4;

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;  // values of k per stage
constexpr int STAGES = 4;
constexpr int THREADS = 128;
constexpr int BLOCKS_PER_SM = 4;
constexpr int A_PITCH = BK + 4;   // float32 values per shared row of A
constexpr int B_PITCH = BN + 16;  // bytes per shared row of B

struct Smem {
  float a[STAGES][BM][A_PITCH];
  int8_t b[STAGES][BK][B_PITCH];
};

// A row-major (M, K) float32 with row stride lda; B row-major (K, N) int8,
// read a row of k at a time.
struct Operands {
  const float* A;
  long long lda;
  bool a16;  // A and lda 4-float aligned
  i8mma::RowMajor b;
};

__device__ __forceinline__ unsigned tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Grid: (tiles of M x N, N tiles fastest; 1; splits).  ws is null with one
// split, else a float32 (splits, M, N) workspace for the partial sums.
// Four blocks an SM (at most 128 registers a thread): shared memory allows
// four, and kernels/gemm.py's split plan for this loop counts on them.
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
f32_i8w_mma_kernel(Operands op, const float* __restrict__ scale, const float* __restrict__ bias,
                   float* __restrict__ C, float* __restrict__ ws, long long M, int N, int K,
                   int kchunk, int act, float lo, float hi) {
  __shared__ __align__(128) Smem sm;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp % 2, wn = warp / 2;  // warp tile rows wm*32, columns wn*32
  const int n_tiles = (N + BN - 1) / BN;
  const long long row0 = (long long)(blockIdx.x / n_tiles) * BM;
  const int col0 = (int)(blockIdx.x % n_tiles) * BN;
  const int kb = blockIdx.z * kchunk;
  const int ke = min(K, kb + kchunk);
  const int nk = (ke - kb + BK - 1) / BK;

  // A: 64 rows x 8 chunks of 4 values, four a thread (rows a_m + 16 r);
  // B: 32 rows of k x 4 chunks of 16 bytes, one a thread.
  const int a_m = tid / 8, a_k = (tid % 8) * 4;
  const float* a_ptr[4];
  bool a_ok[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const long long m = row0 + a_m + 16 * r;
    a_ok[r] = m < M;
    a_ptr[r] = op.A + (a_ok[r] ? m : 0) * op.lda;
  }
  const int b_k = tid / 4, b_n = (tid % 4) * 16;
  int4 b_reg;

  auto issue = [&](int stage, int k0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float* dst = &sm.a[stage][a_m + 16 * r][a_k];
      const int k = k0 + a_k;
      if (op.a16) {
        const int bytes = a_ok[r] ? 4 * clamp_bytes((long long)K - k, 4) : 0;
        cp_async16(dst, a_ptr[r] + (bytes ? k : 0), bytes);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool ok = a_ok[r] && k + q < K;
          cp_async4(dst + q, a_ptr[r] + (ok ? k + q : 0), ok ? 4 : 0);
        }
      }
    }
    i8mma::fetch(op.b, op.b.row(k0 + b_k), col0 + b_n, &sm.b[stage][b_k][b_n], b_reg);
  };
  auto store = [&](int stage) { i8mma::put(op.b, &sm.b[stage][b_k][b_n], b_reg); };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) {
      issue(s, kb + s * BK);
      store(s);
    }
    i8mma::cp_async_commit();
  }

  const int g = lane / 4, t = lane % 4;
  for (int i = 0; i < nk; ++i) {
    i8mma::cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage i landed for every thread; stage i-1 is free
    const int next = i + STAGES - 1;
    if (next < nk) issue(next % STAGES, kb + next * BK);
    i8mma::cp_async_commit();

    const int s = i % STAGES;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      unsigned ahi[2][4], alo[2][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm * 32 + mi * 16 + g;
        const float x[4] = {sm.a[s][r][kk + t], sm.a[s][r + 8][kk + t], sm.a[s][r][kk + t + 4],
                            sm.a[s][r + 8][kk + t + 4]};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ahi[mi][j] = tf32(x[j]);
          alo[mi][j] = tf32(x[j] - __uint_as_float(ahi[mi][j]));
        }
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = wn * 32 + ni * 8 + g;
        bf[ni][0] = __float_as_uint(__int2float_rn(sm.b[s][kk + t][n]));
        bf[ni][1] = __float_as_uint(__int2float_rn(sm.b[s][kk + t + 4][n]));
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          mma_tf32(acc[mi][ni], alo[mi], bf[ni][0], bf[ni][1]);
          mma_tf32(acc[mi][ni], ahi[mi], bf[ni][0], bf[ni][1]);
        }
    }
    if (next < nk) store(next % STAGES);
  }
  i8mma::cp_async_wait<0>();

  i8mma::store_warp_tile(acc, row0 + wm * 32, col0 + wn * 32, M, N,
                         ws == nullptr ? nullptr : ws + (long long)blockIdx.z * M * N, C, scale,
                         bias, act, lo, hi);
}

// kchunk: k per split, a multiple of BK (K or more for one split); ws: a
// float32 workspace of ceil(K / kchunk) * M * N values when that is above 1.
inline int launch(const void* A, const void* B, const void* scale, const void* bias, void* C,
                  long long M, int N, int K, long long lda, int kchunk, void* ws, int act,
                  float lo, float hi, void* stream) {
  if (M == 0 || N == 0) return (int)cudaGetLastError();
  if (scale == nullptr) return (int)cudaErrorInvalidValue;
  const i8mma::SplitGrid g = i8mma::split_grid<BM, BN, BK>(M, N, K, kchunk, ws);
  if (g.err != cudaSuccess) return (int)g.err;
  const auto a_addr = reinterpret_cast<std::uintptr_t>(A);
  const auto b_addr = reinterpret_cast<std::uintptr_t>(B);
  const Operands op{static_cast<const float*>(A), lda, a_addr % 16 == 0 && lda % 4 == 0,
                    {static_cast<const int8_t*>(B), (long long)N, (long long)K, N,
                     b_addr % 16 == 0 && N % 16 == 0, b_addr % 4 == 0 && N % 4 == 0}};
  const cudaStream_t s = (cudaStream_t)stream;
  float* partial = g.splits > 1 ? static_cast<float*>(ws) : nullptr;
  f32_i8w_mma_kernel<<<g.grid, THREADS, 0, s>>>(
      op, static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<float*>(C), partial, M, N, K, kchunk, act, lo, hi);
  return i8mma::finish(g, partial, M, N, scale, bias, C, act, lo, hi, s);
}

}  // namespace i8wmma
