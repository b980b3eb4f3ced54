// fused_gemm: C = act((A @ B) * scale + bias) in full float32, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pyopenvino_tpu/kernels/gemm.py::fused_gemm
// (body _kernel, gemm.py:35-76; grid and scratch in _fused_gemm_impl,
// gemm.py:86-167) in two variants, one C entry point each:
//   * fused_gemm_f32:     A float32, B float32;
//   * fused_gemm_f32_i8w: A float32, B int8 (weight-only INT8) with a
//     per-column float32 scale (gemm.py:44-59, scale at :64-65).
// The int8 x int8 -> int32 variant (gemm.py:44-47) is later work.
//
// What bounds it on an H100 SXM: float32 FMAs run outside the tensor cores at
// 67 TFLOP/s, and device memory moves 3.35 TB/s, so a product whose
// 2*M*N*K / (bytes moved) exceeds about 20 FLOP per byte is bound by
// arithmetic.  Large-M 1x1 convs sit near or above that line; a classifier
// at small batch is a matrix-vector product, bound by reading B, which is
// where int8 B (a quarter of the f32 bytes) pays.
//
// Design (right and simple first):
//   * The TPU kernel walks K as a sequential "arbitrary" grid axis and keeps
//     the sum in VMEM scratch across grid steps.  Blocks on a GPU run in
//     parallel and in no order, so each block owns one 64 x 64 output tile
//     and loops over K itself, keeping the sum in registers.
//   * 256 threads per block; each thread owns a 4 x 4 micro-tile.  A and B
//     tiles of depth 16 are staged in shared memory as float32 (A
//     transposed, so both operands are read as float4 broadcasts: three
//     shared-memory wavefronts per 16 FMAs keep the FMA pipes, not shared
//     memory, the limit).
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
#include <type_traits>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;
constexpr int A_PITCH = BM + 4;  // keeps float4 alignment, spreads store banks

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_CLAMP = 2 };

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

template <typename TB>
__global__ void __launch_bounds__(THREADS)
fused_gemm_kernel(const float* __restrict__ A, const TB* __restrict__ B,
                  const float* __restrict__ scale, const float* __restrict__ bias,
                  float* __restrict__ C, int M, int N, int K, long long lda,
                  int act, float lo, float hi, bool vec4) {
  __shared__ __align__(16) float As[BK][A_PITCH];  // As[k][m]
  __shared__ __align__(16) float Bs[BK][BN];       // Bs[k][n]

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // column group: columns tx*4 .. tx*4+3
  const int ty = tid / 16;  // row group: rows ty*4 .. ty*4+3
  const long long row0 = (long long)blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int r = 0; r < (BM * BK) / THREADS; ++r) {
      const int i = tid + r * THREADS;
      const int m = i / BK, k = i % BK;
      const long long gm = row0 + m;
      const int gk = k0 + k;
      As[k][m] = (gm < M && gk < K) ? A[gm * lda + gk] : 0.f;
    }
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
      if (act == ACT_RELU) {
        v = fmaxf(v, 0.f);
      } else if (act == ACT_CLAMP) {
        v = fminf(fmaxf(v, lo), hi);
      }
      C[gm * N + gn] = v;
    }
  }
}

template <typename TB>
int launch(const void* A, const void* B, const void* scale, const void* bias, void* C,
           int M, int N, int K, int lda, int act, float lo, float hi, void* stream) {
  if (M == 0 || N == 0) return (int)cudaGetLastError();
  const bool vec4 = std::is_same<TB, int8_t>::value && N % 4 == 0 &&
                    reinterpret_cast<std::uintptr_t>(B) % 4 == 0;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((N + BN - 1) / BN));
  fused_gemm_kernel<TB><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(A), static_cast<const TB*>(B),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<float*>(C), M, N, K, (long long)lda, act, lo, hi, vec4);
  return (int)cudaGetLastError();
}

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
