// bf16_mma.cuh: a bfloat16 A times a bfloat16 or int8 B on Hopper's bf16
// tensor cores (mma.sync), fed through a cp.async ring, with split-K.
// fused_gemm.cu's fused_gemm_bf16 (bfloat16 B) and fused_gemm_bf16_i8w
// (int8 B, weight-only INT8) run it on a row-major A, conv_direct.cu's
// conv2d_direct_bf16 (both B types) on the implicit im2col matrix of a
// convolution.
//
// C[m][n] = bf16(act((sum_k A[m][k] * B[k][n]) * scale[n] + bias[n])), with
// A an (M, K) bfloat16 matrix that a loader reads (contract below: a
// row-major one with row stride lda, or a convolution's), B a row-major (K, N)
// bfloat16 or int8 matrix, scale per column (required with an int8 B, where
// it dequantizes; optional with a bfloat16 B) and bias in float32, C a
// row-major (M, N) bfloat16 matrix.
//
// Design note.
//   * Products: mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, one
//     pass at the card's bf16 rate (989 TFLOP/s dense), where a float32 A
//     needs two or three TF32 passes (f32_mma.cuh).  A product of two
//     bfloat16 values is exact in float32 and the accumulator is float32:
//     the TPU kernel's bf16 dot at DEFAULT precision with
//     preferred_element_type=float32 (pyopenvino_tpu/kernels/gemm.py:50-58).
//     An int8 code is exact in bfloat16 (|code| <= 127 < 2^8), so an int8 B
//     is converted exactly, as the TPU kernel's b.astype(a.dtype) is.
//   * Epilogue: epilogue.cuh's (scale, then bias, then ReLU or clamp, in
//     float32, each rounded alone), then one rounding to bfloat16
//     (i8_mma.cuh's to_out), as the TPU kernel's acc.astype(out dtype).
//     So the result is within one bfloat16 step of the plain version's
//     (float32 sums in another order, then the same epilogue and rounding).
//   * Tiles: BM x BN = 64 x 64 per block, 4 warps as 2 x 2, each a 32 x 32
//     warp tile of 2 x 4 mma tiles (32 float32 accumulators a thread).  The
//     ring holds STAGES = 4 stages of BK = 32 values of k.  A: 64 rows of
//     32 bfloat16, rows padded to 80 bytes; bfloat16 B: 32 rows of k x 64
//     columns, rows padded to 144 bytes.  Both pitches are odd multiples of
//     16 bytes, so the eight 16-byte rows of one ldmatrix fall in eight
//     bank groups.  A fragments come by ldmatrix.x4, bfloat16 B fragments
//     by ldmatrix.x4.trans (B is k-major in rows; .trans hands each lane
//     the two consecutive k of one column that the col-major B fragment
//     holds).  int8 B stays int8 in shared memory (32 rows of 80 bytes, the
//     f32_mma.cuh layout) and its fragments are built from scalar reads,
//     each code converted to bfloat16 exactly.  39 KB of static shared
//     memory a block.
//   * Loads: A through its loader, B by 16-byte cp.async.cg where the rows
//     are 16-byte aligned (a row-major A and lda, B and N multiples of 8
//     values: every main-path shape; a convolution's input with Ci % 8 ==
//     0); src-size zero-fills beyond K, M and N.  Other A or bfloat16 B rows
//     are read value by value into registers and stored to the freed stage
//     at once (slower, correct).  int8 B by i8_mma.cuh's RowMajor loader
//     (16-byte, 4-byte or byte path).
//   * Split-K: blockIdx.z takes k in [z * kchunk, (z + 1) * kchunk), kchunk a
//     multiple of BK chosen by the host (kernels/gemm.py::split_k, the
//     float32 loop's thresholds) when the tile grid would not fill the card.
//     Each split writes its float32 partial tile to a workspace and
//     i8_mma.cuh's reduction adds the splits in the fixed order z = 0, 1,
//     ... before the epilogue: two calls give the same bits.
//   * What bounds it: at the main paths' shapes every launch moves 2-byte
//     activations in and out, and all of them but the batch-64 classifier
//     FCs are bound by their bytes at 3.35 TB/s (the bf16 line is about 295
//     operations a byte).  wgmma and TMA would lift the loop's own
//     ceiling; that is later work.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "i8_mma.cuh"

namespace bf16mma {

using i8mma::clamp_bytes;
using i8mma::cp_async16;

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;  // values of k per stage
constexpr int STAGES = 4;
constexpr int THREADS = 128;
constexpr int A_PITCH = BK + 8;    // bfloat16 values per shared row of A (80 bytes)
constexpr int B_PITCH = BN + 8;    // bfloat16 values per shared row of B (144 bytes)
constexpr int B8_PITCH = BN + 16;  // bytes per shared row of an int8 B (80)

// A (M, K) bfloat16 with row stride lda.
//
// Loader contract (the A operand of bf16_mma_kernel):
//   * ``Row row(long long m) const`` prepares what a thread needs to read
//     row m (rows >= M read as zeros); the kernel asks once per row;
//   * ``void load8(__nv_bfloat16* dst, const Row& r, int k) const`` puts
//     the 8 values of row r from column k (k % 8 == 0) into the stage at
//     dst (16-byte aligned): one 16-byte cp.async where they lie together,
//     else read into registers and stored at once; values past K, rows
//     past M and padding are zeros.
struct RowMajorBf16 {
  const __nv_bfloat16* p;
  long long ld, rows;
  int cols;
  bool vec16;  // p and ld multiples of 8 values: every 8-value chunk at k % 8 == 0 is one cp.async

  using Row = long long;
  __device__ __forceinline__ Row row(long long m) const { return m; }

  // 8 values from (r, c): one 16-byte cp.async with zero fill, or value by
  // value through registers when the rows are not so aligned
  __device__ __forceinline__ void load8(__nv_bfloat16* dst, long long r, int c) const {
    if (vec16) {
      const int bytes = r < rows ? 2 * clamp_bytes((long long)cols - c, 8) : 0;
      cp_async16(dst, bytes ? p + r * ld + c : p, bytes);
    } else {
      const unsigned short* src = reinterpret_cast<const unsigned short*>(p);
      unsigned short v[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) v[q] = (r < rows && c + q < cols) ? __ldg(src + r * ld + c + q) : 0;
      uint4 u;
      u.x = v[0] | (unsigned)v[1] << 16;
      u.y = v[2] | (unsigned)v[3] << 16;
      u.z = v[4] | (unsigned)v[5] << 16;
      u.w = v[6] | (unsigned)v[7] << 16;
      *reinterpret_cast<uint4*>(dst) = u;
    }
  }
};

// bfloat16 B, row-major (K, N): 32 rows of k x 8 chunks of 8 values, two a
// thread (rows tid / 8 and + 16, values (tid % 8) * 8); fragments by
// ldmatrix.x4.trans.
struct BBf16 {
  static constexpr int BYTES = BK * B_PITCH * 2;
  RowMajorBf16 rows;  // rows = K, ld = N, cols = N

  __device__ __forceinline__ void issue(unsigned char* stage, int k0, int col0) const {
    __nv_bfloat16* b = reinterpret_cast<__nv_bfloat16*>(stage);
    const int k = threadIdx.x / 8, n = (threadIdx.x % 8) * 8;
#pragma unroll
    for (int r = 0; r < 2; ++r) rows.load8(&b[(k + 16 * r) * B_PITCH + n], k0 + k + 16 * r, col0 + n);
  }

  // the B fragments (b0, b1) of the four n8 tiles of a warp's 32 columns at
  // k step kk
  __device__ __forceinline__ void fragments(const unsigned char* stage, int kk, int wn,
                                            unsigned (&bf)[4][2]) const {
    const int lane = threadIdx.x % 32;
    const unsigned char* base = stage + (kk + lane % 16) * B_PITCH * 2 + wn * 32 * 2 + (lane / 16) * 16;
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {
      unsigned r[4];
      asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                   : "r"(i8mma::smem_u32(base + nj * 32)));
      bf[2 * nj][0] = r[0];
      bf[2 * nj][1] = r[1];
      bf[2 * nj + 1][0] = r[2];
      bf[2 * nj + 1][1] = r[3];
    }
  }
};

// int8 B, row-major (K, N), read a row of k at a time through i8_mma.cuh's
// loader (one 16-byte chunk a thread: row tid / 4, bytes (tid % 4) * 16);
// fragments from scalar reads, each code converted to bfloat16 exactly.
struct BInt8 {
  static constexpr int BYTES = BK * B8_PITCH;
  i8mma::RowMajor rows;  // rows = K, ld = N

  __device__ __forceinline__ void issue(unsigned char* stage, int k0, int col0) const {
    const int k = threadIdx.x / 4, n = (threadIdx.x % 4) * 16;
    int4 reg;
    int8_t* dst = reinterpret_cast<int8_t*>(stage) + k * B8_PITCH + n;
    i8mma::fetch(rows, rows.row(k0 + k), col0 + n, dst, reg);
    i8mma::put(rows, dst, reg);
  }

  __device__ __forceinline__ static unsigned pack(int8_t lo, int8_t hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn((float)lo, (float)hi);
    return *reinterpret_cast<const unsigned*>(&v);
  }

  __device__ __forceinline__ void fragments(const unsigned char* stage, int kk, int wn,
                                            unsigned (&bf)[4][2]) const {
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const int8_t* b = reinterpret_cast<const int8_t*>(stage);
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int n = wn * 32 + ni * 8 + g;
      const int k = kk + 2 * t;
      bf[ni][0] = pack(b[k * B8_PITCH + n], b[(k + 1) * B8_PITCH + n]);
      bf[ni][1] = pack(b[(k + 8) * B8_PITCH + n], b[(k + 9) * B8_PITCH + n]);
    }
  }
};

template <class BL>
struct Smem {
  __nv_bfloat16 a[STAGES][BM * A_PITCH];
  unsigned char b[STAGES][BL::BYTES];
};

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Grid: (tiles of M x N, N tiles fastest; 1; splits).  ws is null with one
// split, else a float32 (splits, M, N) workspace for the partial sums.
// The stores that a load of a misaligned A or B makes at once go to the
// stage that every thread finished reading before the __syncthreads of the
// same step.
template <class LA, class BL>
__global__ void __launch_bounds__(THREADS, 4)
bf16_mma_kernel(LA la, BL bl, const float* __restrict__ scale,
                const float* __restrict__ bias, __nv_bfloat16* __restrict__ C,
                float* __restrict__ ws, long long M, int N, int K, int kchunk, int act, float lo,
                float hi) {
  __shared__ __align__(128) Smem<BL> sm;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp % 2, wn = warp / 2;  // warp tile rows wm*32, columns wn*32
  const int n_tiles = (N + BN - 1) / BN;
  const long long row0 = (long long)(blockIdx.x / n_tiles) * BM;
  const int col0 = (int)(blockIdx.x % n_tiles) * BN;
  const int kb = blockIdx.z * kchunk;
  const int ke = min(K, kb + kchunk);
  const int nk = (ke - kb + BK - 1) / BK;

  // A: 64 rows x 4 chunks of 8 values, two a thread (rows tid / 4 and + 32)
  const int a_m = tid / 4, a_k = (tid % 4) * 8;
  typename LA::Row a_row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) a_row[r] = la.row(row0 + a_m + 32 * r);
  auto issue = [&](int stage, int k0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      la.load8(&sm.a[stage][(a_m + 32 * r) * A_PITCH + a_k], a_row[r], k0 + a_k);
    bl.issue(sm.b[stage], k0, col0);
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
    if (s < nk) issue(s, kb + s * BK);
    i8mma::cp_async_commit();
  }

  // this lane's A ldmatrix address inside a stage (rows wm*32 + lane % 16,
  // 8 values on for lanes 16..31)
  const int a_off = (wm * 32 + lane % 16) * A_PITCH + (lane / 16) * 8;
  for (int i = 0; i < nk; ++i) {
    i8mma::cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage i landed for every thread; stage i-1 is free
    const int next = i + STAGES - 1;
    if (next < nk) issue(next % STAGES, kb + next * BK);
    i8mma::cp_async_commit();

    const int s = i % STAGES;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      unsigned af[2][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        i8mma::ldmatrix_x4(af[mi], &sm.a[s][a_off + mi * 16 * A_PITCH + kk]);
      bl.fragments(sm.b[s], kk, wn, bf);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
    }
  }
  i8mma::cp_async_wait<0>();

  i8mma::store_warp_tile(acc, row0 + wm * 32, col0 + wn * 32, M, N,
                         ws == nullptr ? nullptr : ws + (long long)blockIdx.z * M * N, C, scale,
                         bias, act, lo, hi);
}

// la: the A loader, M rows of K values; kchunk: k per split, a multiple of
// BK (K or more for one split); ws: a float32 workspace of
// ceil(K / kchunk) * M * N values when that is above 1.
template <class LA, class BL>
int launch(const LA& la, const BL& bl, const void* scale, const void* bias, void* C,
           long long M, int N, int K, int kchunk, void* ws, int act, float lo, float hi,
           void* stream) {
  if (M == 0 || N == 0) return (int)cudaGetLastError();
  const i8mma::SplitGrid g = i8mma::split_grid<BM, BN, BK>(M, N, K, kchunk, ws);
  if (g.err != cudaSuccess) return (int)g.err;
  const cudaStream_t s = (cudaStream_t)stream;
  float* partial = g.splits > 1 ? static_cast<float*>(ws) : nullptr;
  bf16_mma_kernel<LA, BL><<<g.grid, THREADS, 0, s>>>(
      la, bl, static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(C), partial, M, N, K, kchunk, act, lo, hi);
  return i8mma::finish<float, __nv_bfloat16>(g, partial, M, N, scale, bias, C, act, lo, hi, s);
}

}  // namespace bf16mma
