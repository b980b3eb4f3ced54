// int8_tile.cuh: the int8 x int8 -> int32 tile loop that fused_gemm.cu
// (fused_gemm_i8i8), conv_direct.cu (conv2d_direct_i8) and dw_pw.cu (the
// pointwise stage of dw_pw_fused_i8) share.
//
// C[m][n] = act(float(sum_k A[m][k] * B[k][n]) * scale[n] + bias[n]), with
//   * A an (M, K) int8 matrix that a loader reads (a row-major matrix, or the
//     implicit im2col matrix of a convolution, computed from the indices), or
//     that already lies in shared memory (dw_pw.cu's mid tile);
//   * B a row-major (K, N) int8 matrix; C a row-major (M, N) float32 matrix
//     (or whatever the caller's store writes).
//
// The sum is exact: __dp4a multiplies four int8 pairs and adds them to an
// int32 accumulator, and never leaves the integers.  K is at most 4608 in the
// paths of this package, so |sum| <= 4608 * 127 * 127 < 2^27.
//
// Each block owns one BM x BN output tile and walks K itself in steps of BK
// int8 values.  A and B tiles are packed into shared memory as int32 words of
// four consecutive k values (As[g][m], Bs[g][n]), zero beyond K, beyond M or
// N, and wherever the loader says the value is padding: nothing is padded in
// device memory.  256 threads, each a 4 x 4 micro-tile of int32 sums.  The
// pieces (BStage, mma_step, epilogue, store_tile) are device functions, so a
// kernel with another A source runs the same loop.
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
constexpr int A_PITCH = BM + 4;  // int4 reads stay aligned; stores hit 32 banks

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

// Loader contract: ``Row row(long long m) const`` prepares what a thread
// needs to read row m (valid = m < M); ``int group(const Row&, int k) const``
// returns the four int8 values A[m][k..k+3] packed low byte first, zero for
// k >= K, for an invalid row and for padding.

template <class Loader>
__global__ void __launch_bounds__(THREADS)
i8_gemm_kernel(Loader ld, const int8_t* __restrict__ B, const float* __restrict__ scale,
               const float* __restrict__ bias, float* __restrict__ C, long long M, int N,
               int K, int act, float lo, float hi) {
  __shared__ __align__(16) int As[KG][A_PITCH];  // As[g][m]
  __shared__ __align__(16) int Bs[KG][BN];       // Bs[g][n]

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // columns tx*4 .. tx*4+3
  const int ty = tid / 16;  // rows ty*4 .. ty*4+3
  const long long row0 = (long long)blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;

  // A: BM * KG = 512 groups per step, two per thread, always the same two
  // rows, so the loader's per-row index work is done once.
  static_assert(BM * KG == 2 * THREADS, "two A groups per thread");
  const int a_g = tid % KG;
  const typename Loader::Row a_row[2] = {ld.row(row0 + tid / KG),
                                         ld.row(row0 + tid / KG + THREADS / KG)};

  const BStage stage_b(B, N, K, col0);

  int acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      As[a_g][tid / KG + r * (THREADS / KG)] = ld.group(a_row[r], k0 + 4 * a_g);
    }
    stage_b(Bs, k0);
    __syncthreads();
    mma_step(acc, [&](int g) { return *reinterpret_cast<const int4*>(&As[g][ty * 4]); }, Bs,
             tx);
    __syncthreads();
  }
  store_tile(acc, row0, col0, ty, tx, M, N, scale, bias, act, lo, hi,
             [&](long long gm, int gn, float v) { C[gm * N + gn] = v; });
}

template <class Loader>
int launch(const Loader& ld, const void* B, const void* scale, const void* bias, void* C,
           long long M, int N, int K, int act, float lo, float hi, void* stream) {
  if (M == 0 || N == 0) return (int)cudaGetLastError();
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((N + BN - 1) / BN));
  i8_gemm_kernel<Loader><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      ld, static_cast<const int8_t*>(B), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<float*>(C), M, N, K, act, lo, hi);
  return (int)cudaGetLastError();
}

}  // namespace i8tile
