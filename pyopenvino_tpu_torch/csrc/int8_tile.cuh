// int8_tile.cuh: the __dp4a int8 x int8 -> int32 tile pieces that dw_pw.cu's
// pointwise stage (dw_pw_fused_i8) runs, and pack4, which i8_mma.cuh's byte
// path shares.
//
// C[m][n] = act(float(sum_k A[m][k] * B[k][n]) * scale[n] + bias[n]), with
//   * A an (M, K) int8 matrix that already lies in shared memory (dw_pw.cu's
//     mid tile), packed as int32 words of four consecutive k;
//   * B a row-major (K, N) int8 matrix; C whatever the caller's store writes.
//
// The sum is exact: __dp4a multiplies four int8 pairs and adds them to an
// int32 accumulator, and never leaves the integers.  K is at most 4608 in the
// paths of this package, so |sum| <= 4608 * 127 * 127 < 2^27.
//
// A block owns one BM x BN output tile and walks K in steps of BK int8
// values.  B tiles are packed into shared memory as int32 words of four
// consecutive k values (Bs[g][n]), zero beyond K and N.  256 threads, each a
// 4 x 4 micro-tile of int32 sums.  The pieces (BStage, mma_step, store_tile)
// are device functions that the caller's kernel runs.
//
// The epilogue is epilogue.cuh's: int32 sum -> float32, times scale, plus
// bias, then ReLU or clamp, each rounded on its own, so the output is
// bit-identical to the plain PyTorch version.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "epilogue.cuh"

namespace i8tile {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;           // int8 values of k per step
constexpr int KG = BK / 4;       // 4-byte k groups per step
constexpr int THREADS = 256;

using gemm::epilogue;

__device__ __forceinline__ int pack4(int b0, int b1, int b2, int b3) {
  return (b0 & 0xff) | ((b1 & 0xff) << 8) | ((b2 & 0xff) << 16) |
         (int)((unsigned)(b3 & 0xff) << 24);
}

// Stages B's k groups k0 .. k0+BK-1 of columns col0 .. col0+BN-1 into
// Bs[g][n]: KG * BN = 512 groups per step, two per thread, zero beyond K and
// N.  The thread's column pointer is found once, and each group costs one
// 64-bit row offset (k * N in 64 bits, then N-strided loads through the
// read-only cache).
struct BStage {
  const int8_t* col;  // B + this thread's column, null beyond N
  int N, K;

  __device__ BStage(const int8_t* B, int N_, int K_, int col0)
      : col(col0 + (int)threadIdx.x % BN < N_ ? B + col0 + (int)threadIdx.x % BN : nullptr),
        N(N_),
        K(K_) {}

  __device__ __forceinline__ void operator()(int (&Bs)[KG][BN], int k0) const {
    static_assert(KG * BN == 2 * THREADS, "two B groups per thread");
    const int tid = threadIdx.x;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int g = tid / BN + r * (THREADS / BN);
      const int k = k0 + 4 * g;
      int v = 0;
      if (col != nullptr) {
        const int8_t* p = col + (long long)k * N;
        v = pack4(k < K ? __ldg(p) : 0, k + 1 < K ? __ldg(p + N) : 0,
                  k + 2 < K ? __ldg(p + 2 * N) : 0, k + 3 < K ? __ldg(p + 3 * N) : 0);
      }
      Bs[g][tid % BN] = v;
    }
  }
};

// One K step of a thread's 4 x 4 micro-tile (columns tx*4 ..): rows(g)
// returns the int4 of its four rows' k group g of this step.
template <class Rows>
__device__ __forceinline__ void mma_step(int (&acc)[4][4], const Rows& rows,
                                         const int (&Bs)[KG][BN], int tx) {
#pragma unroll
  for (int g = 0; g < KG; ++g) {
    const int4 a = rows(g);
    const int4 b = *reinterpret_cast<const int4*>(&Bs[g][tx * 4]);
    const int av[4] = {a.x, a.y, a.z, a.w};
    const int bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
  }
}

// The epilogue of a thread's micro-tile at rows row0 + ty*4 .., columns
// col0 + tx*4 ..; store(m, n, v) writes one value inside M x N.
template <class Store>
__device__ __forceinline__ void store_tile(const int (&acc)[4][4], long long row0, int col0,
                                           int ty, int tx, long long M, int N,
                                           const float* __restrict__ scale,
                                           const float* __restrict__ bias, int act, float lo,
                                           float hi, const Store& store) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long gm = row0 + ty * 4 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = col0 + tx * 4 + j;
      if (gn >= N) continue;
      store(gm, gn, epilogue(acc[i][j], scale[gn], bias, gn, act, lo, hi));
    }
  }
}

}  // namespace i8tile
