// f32_tile.cuh: the float32 FFMA tile loop of conv_direct.cu's
// conv2d_direct_f32 (kernel 3f, on no serving path).  The float32 GEMMs run
// on the TF32 tensor cores instead (f32_mma.cuh).
//
// C[m][n] = act((sum_k A[m][k] * B[k][n]) * scale[n] + bias[n]), with
//   * A an (M, K) float32 matrix that a loader reads (the implicit im2col
//     matrix of a convolution, computed from the indices);
//   * B a row-major (K, N) matrix, float32 or int8 (an int8 B is converted to
//     float32 on its way into shared memory; its per-column scale then
//     multiplies the finished sum);
//   * C a row-major (M, N) float32 matrix; scale and bias may be null.
//
// Each block owns one BM x BN output tile and walks K itself in steps of BK.
// 256 threads, each a 4 x 4 micro-tile of float32 sums (fmaf, full float32,
// no TF32).  A and B tiles are staged in shared memory as float32, A
// transposed, so both operands are read as float4 broadcasts: three
// shared-memory wavefronts per 16 FMAs keep the FMA pipes, not shared memory,
// the limit.  Ragged M/N/K edges are zero in shared memory and masked at the
// stores; nothing is padded in device memory.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "epilogue.cuh"

namespace f32tile {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;
constexpr int A_PITCH = BM + 4;  // keeps float4 alignment, spreads store banks

// B tile [k0, k0 + BK) x [col0, col0 + BN) into Bs as float32, zero outside.
__device__ __forceinline__ void load_b_tile(float (*Bs)[BN], const float* __restrict__ B,
                                            int N, int K, int k0, int col0, int tid,
                                            bool /*vec4*/) {
#pragma unroll
  for (int r = 0; r < (BK * BN) / THREADS; ++r) {
    const int i = tid + r * THREADS;
    const int k = i / BN, n = i % BN;
    const int gk = k0 + k, gn = col0 + n;
    Bs[k][n] = (gk < K && gn < N) ? B[(long long)gk * N + gn] : 0.f;
  }
}

// int8 B: four neighbouring columns per thread, one 4-byte load when vec4
// (N % 4 == 0 and B 4-byte aligned, decided by the host), else byte by byte.
__device__ __forceinline__ void load_b_tile(float (*Bs)[BN], const int8_t* __restrict__ B,
                                            int N, int K, int k0, int col0, int tid,
                                            bool vec4) {
  static_assert(BK * BN == 4 * THREADS, "one 4-byte group of B per thread");
  const int k = tid / (BN / 4), n = (tid % (BN / 4)) * 4;
  const int gk = k0 + k, gn = col0 + n;
  float v0 = 0.f, v1 = 0.f, v2 = 0.f, v3 = 0.f;
  if (gk < K) {
    const int8_t* row = B + (long long)gk * N;
    if (vec4 && gn + 3 < N) {
      const char4 q = *reinterpret_cast<const char4*>(row + gn);
      v0 = q.x;
      v1 = q.y;
      v2 = q.z;
      v3 = q.w;
    } else {
      if (gn < N) v0 = row[gn];
      if (gn + 1 < N) v1 = row[gn + 1];
      if (gn + 2 < N) v2 = row[gn + 2];
      if (gn + 3 < N) v3 = row[gn + 3];
    }
  }
  *reinterpret_cast<float4*>(&Bs[k][n]) = make_float4(v0, v1, v2, v3);
}

// Loader contract: ``Row row(long long m) const`` prepares what a thread
// needs to read row m (valid = m < M); ``Col col(int k) const`` what it needs
// to read column k (valid = k < K), once per K step for all its rows;
// ``float at(const Row&, const Col&) const`` returns A[m][k], zero for an
// invalid row or column and for padding.

template <class Loader, typename TB>
__global__ void __launch_bounds__(THREADS)
f32_gemm_kernel(Loader ld, const TB* __restrict__ B, const float* __restrict__ scale,
                const float* __restrict__ bias, float* __restrict__ C, long long M, int N,
                int K, int act, float lo, float hi, bool vec4) {
  __shared__ __align__(16) float As[BK][A_PITCH];  // As[k][m]
  __shared__ __align__(16) float Bs[BK][BN];       // Bs[k][n]

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // column group: columns tx*4 .. tx*4+3
  const int ty = tid / 16;  // row group: rows ty*4 .. ty*4+3
  const long long row0 = (long long)blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;

  // A: BM * BK values per step, four per thread, always at the same four
  // rows and the same k offset, so the loader's row work is done once.
  constexpr int AR = (BM * BK) / THREADS;
  const int a_k = tid % BK;
  typename Loader::Row a_row[AR];
#pragma unroll
  for (int r = 0; r < AR; ++r) a_row[r] = ld.row(row0 + tid / BK + r * (THREADS / BK));

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    const typename Loader::Col a_col = ld.col(k0 + a_k);
#pragma unroll
    for (int r = 0; r < AR; ++r) As[a_k][tid / BK + r * (THREADS / BK)] = ld.at(a_row[r], a_col);
    load_b_tile(Bs, B, N, K, k0, col0, tid, vec4);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // scale -> bias -> relu/clamp on the registers, before the one write of C
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long gm = row0 + ty * 4 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = col0 + tx * 4 + j;
      if (gn >= N) continue;
      float v = acc[i][j];
      if (scale != nullptr) v *= scale[gn];
      if (bias != nullptr) v += bias[gn];
      C[gm * N + gn] = gemm::activate(v, act, lo, hi);
    }
  }
}

template <class Loader, typename TB>
int launch(const Loader& ld, const void* B, const void* scale, const void* bias, void* C,
           long long M, int N, int K, int act, float lo, float hi, void* stream) {
  if (M == 0 || N == 0) return (int)cudaGetLastError();
  const bool vec4 = std::is_same<TB, int8_t>::value && N % 4 == 0 &&
                    reinterpret_cast<std::uintptr_t>(B) % 4 == 0;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((N + BN - 1) / BN));
  f32_gemm_kernel<Loader, TB><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      ld, static_cast<const TB*>(B), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<float*>(C), M, N, K, act, lo, hi, vec4);
  return (int)cudaGetLastError();
}

}  // namespace f32tile
