// f32_mma.cuh: float32 A times a float32 or int8 B with float32 accuracy on
// Hopper's TF32 tensor cores (mma.sync), fed through a cp.async ring, with
// split-K.  fused_gemm.cu's fused_gemm_f32 (float32 B) and
// fused_gemm_f32_i8w (int8 B, weight-only INT8) run it on a row-major A,
// conv_direct.cu's conv2d_direct_f32 (both B types) on the implicit im2col
// matrix of a convolution.
//
// C[m][n] = act((sum_k A[m][k] * B[k][n]) * scale[n] + bias[n]), with A an
// (M, K) float32 matrix that a loader reads (contract below), B a row-major
// (K, N) float32 or int8 matrix, scale per column (required with an int8 B,
// where it dequantizes; optional with a float32 B), C row-major (M, N).
//
// Design note.
//   * Products: mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, at
//     495 TFLOP/s dense against 67 for float32 FFMA.  A TF32 value keeps 11
//     of float32's 24 significant bits, so an operand is split into two
//     terms, x_hi and x_lo = x - x_hi in TF32, which together carry 21 to 22
//     of its bits.  It is the idea of the TPU kernel's Precision.HIGHEST
//     (multi-pass bf16 on its matrix unit, pyopenvino_tpu/kernels/
//     gemm.py:51-59).
//       - int8 B: a code is exact in TF32, so only A is split, each term
//         rounded to nearest (cvt.rna): two passes, a_lo*b then a_hi*b.
//       - float32 B: both are split, three passes ("3xTF32"), the small
//         terms first: a_lo*b_hi, a_hi*b_lo, then a_hi*b_hi; a_lo*b_lo
//         (about 2^-20 of the product) is left out.  Each term is cut
//         toward zero by a mask (split_trunc): four split operands per
//         fragment pair make cvt.rna's cost count, and the cut terms
//         carry 21 bits, far inside the 1e-4 gate.
//     All passes go into one float32 accumulator.  Three TF32 passes are the
//     float32 B's route rather than three bf16 ones: the gate is 1e-4 of
//     the output's largest magnitude against full float32, and
//     tests/test_torch_port_gemm_tc.py shows one TF32 pass fails it.
//   * Accuracy: the tensor cores add the eight products of an m16n8k8 and the
//     accumulator at float32 width but need not round to nearest, so a long
//     K chain can drift; split-K shortens the chains, and the card tests hold
//     the GEMMs' int8-B result within 2e-5 and the float32-B one within 1e-4
//     of max |plain| at K = 1280 and beyond, and conv2d_direct_f32 within
//     1e-4 at K up to 4608 (9 x 512, one split at batch 64).
//   * Tiles: BM x BN = 64 x 64 per block, 4 warps as 2 x 2, each a 32 x 32
//     warp tile of 2 x 4 mma tiles (32 float32 accumulators a thread).  The
//     ring holds stages of BK = 32 values of k.  A: 64 x 32 float32, rows
//     padded to 36 so a fragment's 32 lanes hit 32 banks.  B: 32 rows of k
//     x 64 columns; int8 rows padded to 80 bytes (4 stages, 46 KB in all),
//     float32 rows to 72 values, so the lanes of a fragment (k = t, n = g)
//     hit 8t + g, 32 banks (3 stages, 54 KB in all, dynamic shared memory).
//     Both run four blocks an SM: on an H100 the float32-B loop was faster
//     with three stages and four blocks than with four and three.  Stages
//     k+1 .. are in flight while stage k multiplies.  Each B type has its
//     own launch bound: the float32-B loop holds a second set of B terms in
//     registers.
//   * Loads: A through its loader, by 16-byte cp.async.cg where every
//     4-value chunk at k % 4 == 0 is 16-byte aligned and lies in one piece
//     (a row-major A with A and lda 4-float aligned; a convolution's input
//     with Ci % 4 == 0), else by 4-byte cp.async.ca; a thread's four A rows
//     share one column, so a loader maps k once for all four.  int8 B, a row of k at a time, through
//     i8_mma.cuh's RowMajor loader and fetch/put: 16-byte cp.async where B
//     and N are 16-byte aligned, 4-byte where 4-byte aligned, and else
//     through registers (read before the stage's mma, stored after it).
//     float32 B by 16-byte cp.async where B and N are 4-float aligned, else
//     by 4-byte ones.  src-size zero-fills beyond K, M and N.  B stays in its
//     type in shared memory and is split (or converted exactly, for int8)
//     as its fragments are read: there is no ldmatrix for 32-bit B in the
//     col layout, so the fragments are scalar loads from the padded rows.
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

namespace f32mma {

using i8mma::clamp_bytes;
using i8mma::cp_async16;
using i8mma::cp_async4;

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;  // values of k per stage
constexpr int THREADS = 128;
constexpr int A_PITCH = BK + 4;  // float32 values per shared row of A

// A row-major float32 matrix with row stride lda: the A of both fused_gemm
// entries.
//
// Loader contract (the A operand of f32_mma_kernel):
//   * ``Row row(long long m) const`` prepares what a thread needs to read
//     row m (rows >= M read as zeros);
//   * ``Col col(int k) const`` prepares what it needs to read column k;
//     the thread's rows share it;
//   * ``bool vec16`` says that the four values from every k % 4 == 0 are
//     16-byte aligned and adjacent in memory; then
//     ``const float* chunk(const Row&, const Col&) const`` is the address
//     of A[m][k] and ``int chunk_bytes(const Row&, const Col&) const`` how
//     many of the 16 bytes from it lie inside the matrix (0, 4, ..., 16;
//     the rest are zero: k >= K, rows >= M, padding).  Without vec16 each
//     value is read alone at col(k + q), min(chunk_bytes, 4) bytes of it.
struct RowMajorF32 {
  const float* A;
  long long lda;
  long long rows;
  int K;
  bool vec16;  // A and lda multiples of 4 floats

  struct Row {
    const float* p;
    bool valid;
  };
  struct Col {
    int k;
  };

  __device__ Row row(long long m) const { return {A + (m < rows ? m : 0) * lda, m < rows}; }
  __device__ Col col(int k) const { return {k}; }
  __device__ const float* chunk(const Row& r, const Col& c) const {
    return r.p + (c.k < K ? c.k : 0);
  }
  __device__ int chunk_bytes(const Row& r, const Col& c) const {
    return r.valid ? 4 * clamp_bytes((long long)K - c.k, 4) : 0;
  }
};

__device__ __forceinline__ unsigned tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo in two TF32 terms, each rounded to nearest
__device__ __forceinline__ void split_rna(float x, unsigned& hi, unsigned& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// x = hi + lo in two TF32 terms, each cut toward zero: hi keeps x's top 11
// significant bits, x - hi is exact, and lo keeps its top 11; three integer
// and float instructions where cvt.rna costs about eight
__device__ __forceinline__ void split_trunc(float x, unsigned& hi, unsigned& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// int8 B, row-major (K, N), read a row of k at a time through i8_mma.cuh's
// loader: exact in TF32, two passes.
struct BInt8 {
  using T = int8_t;
  static constexpr int STAGES = 4;
  static constexpr int PITCH = BN + 16;  // bytes per shared row
  static constexpr int PASSES = 2;
  static constexpr int BLOCKS_PER_SM = 4;  // kernels/gemm.py's split plan counts on them

  i8mma::RowMajor rows;  // rows = K, ld = N

  // one 16-byte chunk a thread: row tid / 4, bytes (tid % 4) * 16
  struct Regs {
    int4 v;
  };
  __device__ __forceinline__ void issue(T (*dst)[PITCH], int k0, int col0, Regs& r) const {
    const int k = threadIdx.x / 4, n = (threadIdx.x % 4) * 16;
    i8mma::fetch(rows, rows.row(k0 + k), col0 + n, &dst[k][n], r.v);
  }
  __device__ __forceinline__ void store(T (*dst)[PITCH], const Regs& r) const {
    i8mma::put(rows, &dst[threadIdx.x / 4][(threadIdx.x % 4) * 16], r.v);
  }
  __device__ __forceinline__ static void split_a(float a, unsigned& hi, unsigned& lo) {
    split_rna(a, hi, lo);
  }
  __device__ __forceinline__ static void terms(T b, unsigned& hi, unsigned& lo) {
    hi = __float_as_uint(__int2float_rn(b));
    lo = 0;
  }
};

// float32 B, row-major (K, N): A and B each split in two TF32 terms, three
// passes.
struct BFloat {
  using T = float;
  static constexpr int STAGES = 3;
  static constexpr int PITCH = BN + 8;  // values per shared row: lanes hit 8t + g
  static constexpr int PASSES = 3;
  static constexpr int BLOCKS_PER_SM = 4;  // 54 KB of shared memory a block

  const float* B;
  int N, K;
  bool b16;  // B and N 4-float aligned

  struct Regs {};
  // 32 rows x 16 chunks of 4 values, four a thread: rows tid / 16 + 8 r,
  // values (tid % 16) * 4 .. + 3, so 16 threads read one 256-byte row
  __device__ __forceinline__ void issue(T (*dst)[PITCH], int k0, int col0, Regs&) const {
    const int c = (threadIdx.x % 16) * 4, gn = col0 + c;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = threadIdx.x / 16 + 8 * r, gk = k0 + k;
      const float* src = B + (long long)gk * N + gn;
      if (b16) {
        const int bytes = gk < K ? 4 * clamp_bytes((long long)N - gn, 4) : 0;
        cp_async16(&dst[k][c], bytes ? src : B, bytes);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool ok = gk < K && gn + q < N;
          cp_async4(&dst[k][c + q], ok ? src + q : B, ok ? 4 : 0);
        }
      }
    }
  }
  __device__ __forceinline__ void store(T (*)[PITCH], const Regs&) const {}
  __device__ __forceinline__ static void split_a(float a, unsigned& hi, unsigned& lo) {
    split_trunc(a, hi, lo);
  }
  __device__ __forceinline__ static void terms(T b, unsigned& hi, unsigned& lo) {
    split_trunc(b, hi, lo);
  }
};

template <class BL>
struct Smem {
  float a[BL::STAGES][BM][A_PITCH];
  typename BL::T b[BL::STAGES][BK][BL::PITCH];
};

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

extern __shared__ __align__(128) unsigned char dynamic_smem[];

// Grid: (tiles of M x N, N tiles fastest; 1; splits), sizeof(Smem<BL>) bytes
// of dynamic shared memory.  ws is null with one split, else a float32
// (splits, M, N) workspace for the partial sums.
template <class LA, class BL>
__global__ void __launch_bounds__(THREADS, BL::BLOCKS_PER_SM)
f32_mma_kernel(LA la, BL bl, const float* __restrict__ scale, const float* __restrict__ bias,
               float* __restrict__ C, float* __restrict__ ws, long long M, int N, int K,
               int kchunk, int act, float lo, float hi) {
  constexpr int STAGES = BL::STAGES;
  Smem<BL>& sm = *reinterpret_cast<Smem<BL>*>(dynamic_smem);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp % 2, wn = warp / 2;  // warp tile rows wm*32, columns wn*32
  const int n_tiles = (N + BN - 1) / BN;
  const long long row0 = (long long)(blockIdx.x / n_tiles) * BM;
  const int col0 = (int)(blockIdx.x % n_tiles) * BN;
  const int kb = blockIdx.z * kchunk;
  const int ke = min(K, kb + kchunk);
  const int nk = (ke - kb + BK - 1) / BK;

  // A: 64 rows x 8 chunks of 4 values, four a thread (rows a_m + 16 r, one
  // column a_k)
  const int a_m = tid / 8, a_k = (tid % 8) * 4;
  typename LA::Row a_row[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) a_row[r] = la.row(row0 + a_m + 16 * r);
  typename BL::Regs b_regs;

  auto issue = [&](int stage, int k0) {
    const int k = k0 + a_k;
    if (la.vec16) {
      const typename LA::Col c = la.col(k);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        cp_async16(&sm.a[stage][a_m + 16 * r][a_k], la.chunk(a_row[r], c),
                   la.chunk_bytes(a_row[r], c));
      }
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const typename LA::Col c = la.col(k + q);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          cp_async4(&sm.a[stage][a_m + 16 * r][a_k + q], la.chunk(a_row[r], c),
                    min(la.chunk_bytes(a_row[r], c), 4));
        }
      }
    }
    bl.issue(sm.b[stage], k0, col0, b_regs);
  };

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
      bl.store(sm.b[s], b_regs);
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
      unsigned ahi[2][4], alo[2][4], bhi[4][2], blo[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm * 32 + mi * 16 + g;
        const float x[4] = {sm.a[s][r][kk + t], sm.a[s][r + 8][kk + t], sm.a[s][r][kk + t + 4],
                            sm.a[s][r + 8][kk + t + 4]};
#pragma unroll
        for (int j = 0; j < 4; ++j) BL::split_a(x[j], ahi[mi][j], alo[mi][j]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = wn * 32 + ni * 8 + g;
        BL::terms(sm.b[s][kk + t][n], bhi[ni][0], blo[ni][0]);
        BL::terms(sm.b[s][kk + t + 4][n], bhi[ni][1], blo[ni][1]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          mma_tf32(acc[mi][ni], alo[mi], bhi[ni][0], bhi[ni][1]);
          if (BL::PASSES == 3) mma_tf32(acc[mi][ni], ahi[mi], blo[ni][0], blo[ni][1]);
          mma_tf32(acc[mi][ni], ahi[mi], bhi[ni][0], bhi[ni][1]);
        }
    }
    if (next < nk) bl.store(sm.b[next % STAGES], b_regs);
  }
  i8mma::cp_async_wait<0>();

  i8mma::store_warp_tile(acc, row0 + wm * 32, col0 + wn * 32, M, N,
                         ws == nullptr ? nullptr : ws + (long long)blockIdx.z * M * N, C, scale,
                         bias, act, lo, hi);
}

// Lets f32_mma_kernel<LA, BL> take its shared memory above the 48 KB
// default, once per device.
template <class LA, class BL>
cudaError_t allow_smem() {
  constexpr int bytes = (int)sizeof(Smem<BL>);
  if (bytes <= 48 * 1024) return cudaSuccess;
  static bool done[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(f32_mma_kernel<LA, BL>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

// la: the A loader, M rows of K values; kchunk: k per split, a multiple of
// BK (K or more for one split); ws: a float32 workspace of
// ceil(K / kchunk) * M * N values when that is above 1.
template <class LA, class BL>
int launch(const LA& la, const BL& bl, const void* scale, const void* bias, void* C, long long M,
           int N, int K, int kchunk, void* ws, int act, float lo, float hi, void* stream) {
  if (M == 0 || N == 0) return (int)cudaGetLastError();
  const i8mma::SplitGrid g = i8mma::split_grid<BM, BN, BK>(M, N, K, kchunk, ws);
  if (g.err != cudaSuccess) return (int)g.err;
  const cudaError_t err = allow_smem<LA, BL>();
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  float* partial = g.splits > 1 ? static_cast<float*>(ws) : nullptr;
  f32_mma_kernel<LA, BL><<<g.grid, THREADS, sizeof(Smem<BL>), s>>>(
      la, bl, static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<float*>(C), partial, M, N, K, kchunk, act, lo, hi);
  return i8mma::finish(g, partial, M, N, scale, bias, C, act, lo, hi, s);
}

}  // namespace f32mma
