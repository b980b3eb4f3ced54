// i8_mma.cuh: the int8 x int8 -> int32 GEMM on Hopper's tensor cores
// (mma.sync), fed through a cp.async ring, with split-K.  fused_gemm.cu's
// fused_gemm_i8i8 and conv_direct.cu's conv2d_direct_i8 run it; dw_pw.cu's
// pointwise stage runs its warp step (warp_mma_k32) on an A tile that it
// keeps in shared memory itself.
//
// C[m][n] = act(float(sum_k A[m][k] * B[k][n]) * scale[n] + bias[n]), with
//   * A an (M, K) int8 matrix that a loader reads (contract below): a
//     row-major matrix, or the implicit im2col matrix of a convolution;
//   * B K-major: row n of an (N, K) int8 matrix holds column n of B, K
//     contiguous bytes;
//   * C a row-major (M, N) float32 or bfloat16 matrix (OutT): the epilogue
//     runs in float32 and a bfloat16 C takes one rounding to nearest even
//     of its result, where the TPU kernel writes its compute dtype
//     (pyopenvino_tpu/kernels/gemm.py:76).
//
// Design note.
//   * Products: mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32.  Its B
//     fragment holds four consecutive k of one column per register, and
//     ldmatrix has no transposed form for 8-bit data, so B must be K-major in
//     shared memory, hence in device memory: the wrapper hands the kernel an
//     (N, K) contiguous matrix (the compiled network caches that copy once).
//     The int32 sum is exact: K <= 4608 in this package's paths, so
//     |sum| <= 4608 * 127 * 127 < 2^27, and the mma adds integers without
//     saturation.  This loop reaches 9.5-12.6 % of the card's int8 rate in
//     its main loop (mma.sync from ldmatrix, a barrier every 64 bytes of k,
//     the multiplying warps issuing the loads), so at a batch of 64 the
//     fused_gemm shapes with K of 64 and more ran at 13-45 % of their bound
//     (int8 in, float32 out; those with K of 576 and more within about two
//     times of their operations), and cuBLASLt's int8 GEMM moved the same
//     bytes in half the time.  i8_wgmma.cuh's wgmma loop takes those shapes
//     (kernels/gemm.py::i8_route, conv_direct.py::direct_route); this loop
//     keeps what that one does not take: rows not 16-byte aligned (the
//     K = 147 and 27 stems, ShuffleNet-v2's Split halves), K not a multiple
//     of 16, N below 64 and the small launches (batch 1, the SE gates, the
//     FCs), whose split K fills the card.
//   * Tiles: BM x BN = 128 x 64 per block, 8 warps as 4 (M) x 2 (N), each a
//     32 x 32 warp tile of 2 x 4 mma tiles (32 int32 accumulators a thread).
//     BN = 64 keeps the N = 16 ... 32 shapes of MobileNet-v2's early layers
//     at the waste of the __dp4a loop it replaced.  Fragments come from
//     shared memory by ldmatrix.x4; rows are 80 bytes (64 + 16), so the eight
//     16-byte rows of one ldmatrix fall in eight different bank groups.
//   * The ring: STAGES = 3 shared-memory stages of BK = 64 bytes of k (A 128
//     rows, B 64 rows, 45 KB in all, static).  Stage k+2 is in flight while
//     stage k multiplies.  A chunk of 16 bytes of a row comes in by
//     cp.async.cg when the loader's rows are 16-byte aligned (vec16); its
//     src-size zero-fills beyond K and beyond M or N; rows that are only
//     4-byte aligned (K = 24, 144) come in by four 4-byte cp.async.ca.  Rows
//     that are not 4-byte aligned (the K = 147 and K = 27 stems) take the
//     byte path inside the same kernel: the thread reads the 16 bytes into
//     registers before the mma of the current stage and stores them to
//     shared memory after it, so the loads still overlap the math; the
//     prologue reads both of its stages before it stores either.
//   * Split-K: blockIdx.z takes k in [z * kchunk, (z + 1) * kchunk), kchunk a
//     multiple of BK chosen by the host (kernels/gemm.py::split_k) when the
//     tile grid would not fill the card.  With one split the epilogue runs on
//     the registers; with more, each split writes its int32 partial tile to a
//     workspace the wrapper allocated, and a second kernel adds the splits in
//     a fixed order and runs the epilogue.  Integer addition is exact, so the
//     result is the same bit for bit as one split.
//   * The epilogue is epilogue.cuh's: __fmul_rn then __fadd_rn, then ReLU
//     or clamp, so the output equals the plain PyTorch version bit for bit.
//   * Tiles are numbered on a 1-D grid, N tiles fastest, so the blocks that
//     share an A row band run together and read it from device memory once.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "epilogue.cuh"

namespace i8mma {

// -- shared with f32_mma.cuh: PTX helpers, the row loader, the warp-tile
// -- store and split-K's grid and reduction -----------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared, the first `bytes` of them read, the rest
// zero.  dst and src are 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes));
}

// 4 bytes, the first `bytes` of them read; dst and src 4-byte aligned.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ int clamp_bytes(long long b, int most) {
  return b <= 0 ? 0 : (b >= most ? most : (int)b);
}

// four int8 values packed low byte first
__device__ __forceinline__ int pack4(int b0, int b1, int b2, int b3) {
  return (b0 & 0xff) | ((b1 & 0xff) << 8) | ((b2 & 0xff) << 16) |
         (int)((unsigned)(b3 & 0xff) << 24);
}

// A row-major int8 matrix with row stride ld: A of fused_gemm_i8i8, the
// K-major B of both int8 x int8 entries (rows = N, ld = K), and
// f32_mma.cuh's row-major int8 B (rows = K, ld = N, its rows N bytes long).
//
// Loader contract (the A operand of i8i8_mma_kernel):
//   * ``Row row(long long m) const`` prepares what a thread needs to read
//     row m (valid = m < rows);
//   * ``int group(const Row&, int k) const`` returns A[m][k..k+3] packed low
//     byte first, zero for k >= K, for an invalid row and for padding, for
//     rows that are not 4-byte aligned;
//   * ``bool vec16`` says that every 16-byte chunk at k % 16 == 0 is
//     16-byte aligned, ``bool vec4`` that every 4-byte group at k % 4 == 0
//     is 4-byte aligned; then ``const int8_t* chunk(const Row&, int k)
//     const`` and ``int chunk_bytes(const Row&, int k) const`` give the
//     address at k and how many of the 16 bytes from it lie inside the
//     matrix (0 ... 16).
struct RowMajor {
  const int8_t* base;
  long long ld;
  long long rows;
  int K;
  bool vec16;  // base and ld multiples of 16
  bool vec4;   // base and ld multiples of 4

  struct Row {
    const int8_t* p;
    bool valid;
  };

  __device__ Row row(long long m) const { return {base + (m < rows ? m : 0) * ld, m < rows}; }

  __device__ int group(const Row& r, int k) const {
    if (!r.valid || k >= K) return 0;
    return pack4(__ldg(r.p + k), k + 1 < K ? __ldg(r.p + k + 1) : 0,
                 k + 2 < K ? __ldg(r.p + k + 2) : 0, k + 3 < K ? __ldg(r.p + k + 3) : 0);
  }

  __device__ const int8_t* chunk(const Row& r, int k) const { return r.p + (k < K ? k : 0); }
  __device__ int chunk_bytes(const Row& r, int k) const {
    return r.valid ? clamp_bytes((long long)K - k, 16) : 0;
  }
};

// One 16-byte chunk of a row: one 16-byte or four 4-byte cp.async when the
// loader is so aligned, else gathered into `reg` now and stored to shared
// memory by put() later.
template <class Loader>
__device__ __forceinline__ void fetch(const Loader& ld, const typename Loader::Row& r, int k,
                                      int8_t* dst, int4& reg) {
  if (ld.vec16) {
    cp_async16(dst, ld.chunk(r, k), ld.chunk_bytes(r, k));
  } else if (ld.vec4) {
#pragma unroll
    for (int q = 0; q < 16; q += 4) {
      const int bytes = ld.chunk_bytes(r, k + q);
      cp_async4(dst + q, ld.chunk(r, k + q), bytes < 4 ? bytes : 4);
    }
  } else {
    reg = make_int4(ld.group(r, k), ld.group(r, k + 4), ld.group(r, k + 8), ld.group(r, k + 12));
  }
}

template <class Loader>
__device__ __forceinline__ void put(const Loader& ld, int8_t* dst, const int4& reg) {
  if (!ld.vec16 && !ld.vec4) *reinterpret_cast<int4*>(dst) = reg;
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

template <typename T>
struct Pair;
template <>
struct Pair<int> {
  using type = int2;
};
template <>
struct Pair<float> {
  using type = float2;
};

// v0, v1 to p[0], p[1] inside N (p at column gn): one 8-byte store where
// both are inside and aligned (N even).
template <typename T>
__device__ __forceinline__ void store_pair(T* p, int gn, int N, T v0, T v1) {
  if (gn + 1 < N && N % 2 == 0) {
    *reinterpret_cast<typename Pair<T>::type*>(p) = typename Pair<T>::type{v0, v1};
  } else {
    if (gn < N) p[0] = v0;
    if (gn + 1 < N) p[1] = v1;
  }
}

// An epilogue value (float32) in the output type: bfloat16 rounds to
// nearest even, as PyTorch's and XLA's casts do.
template <typename OutT>
__device__ __forceinline__ OutT to_out(float v) {
  if constexpr (std::is_same<OutT, float>::value) {
    return v;
  } else {
    return __float2bfloat16_rn(v);
  }
}

// Two epilogue values to p[0], p[1] inside N, in the output type (one
// 8-byte float32 or 4-byte bfloat16 store where both are inside and N is
// even).
template <typename OutT>
__device__ __forceinline__ void store_out(OutT* p, int gn, int N, float v0, float v1) {
  if constexpr (std::is_same<OutT, float>::value) {
    store_pair(p, gn, N, v0, v1);
  } else if (gn + 1 < N && N % 2 == 0) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  } else {
    if (gn < N) p[0] = to_out<OutT>(v0);
    if (gn + 1 < N) p[1] = to_out<OutT>(v1);
  }
}

// A 32 x 32 warp tile of 2 x 4 m16n8 accumulators with its top-left element
// at (r0, c0): accumulator (mi, ni, r) is row g (+8 for r >= 2), columns
// 2t, 2t+1.  With one split the epilogue's values go to C; with more, the
// raw sums go to ws, this split's (M, N) slice of the workspace.  kScale
// false: no scale (the float32 x float32 entry allows none).
template <bool kScale, typename Acc, typename OutT>
__device__ __forceinline__ void store_warp_tile_(const Acc (&acc)[2][4][4], long long r0,
                                                 int c0, long long M, int N, Acc* ws, OutT* C,
                                                 const float* __restrict__ scale,
                                                 const float* __restrict__ bias, int act,
                                                 float lo, float hi) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long gm = r0 + mi * 16 + g + h * 8;
      if (gm >= M) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int gn = c0 + ni * 8 + 2 * t;
        const Acc v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
        if (ws != nullptr) {
          store_pair(ws + gm * N + gn, gn, N, v0, v1);
        } else if (gn < N) {
          store_out(C + gm * N + gn, gn, N,
                    gemm::epilogue(v0, kScale ? scale[gn] : 1.f, bias, gn, act, lo, hi),
                    gn + 1 < N ? gemm::epilogue(v1, kScale ? scale[gn + 1] : 1.f, bias, gn + 1,
                                                act, lo, hi)
                               : 0.f);
        }
      }
    }
}

// The same; scale may be null with float32 sums (a multiply by 1 would be
// exact, but the branch is taken once, outside the store loops).
template <typename Acc, typename OutT>
__device__ __forceinline__ void store_warp_tile(const Acc (&acc)[2][4][4], long long r0, int c0,
                                                long long M, int N, Acc* ws, OutT* C,
                                                const float* __restrict__ scale,
                                                const float* __restrict__ bias, int act,
                                                float lo, float hi) {
  if (std::is_same<Acc, int>::value || scale != nullptr) {
    store_warp_tile_<true>(acc, r0, c0, M, N, ws, C, scale, bias, act, lo, hi);
  } else {
    store_warp_tile_<false>(acc, r0, c0, M, N, ws, C, scale, bias, act, lo, hi);
  }
}

// The splits' partial sums added in the order z = 0, 1, ..., then the
// epilogue: exact for int32 sums, the same bits every call for float32 ones.
template <typename Acc, bool kScale, typename OutT>
__global__ void splitk_reduce(const Acc* __restrict__ ws, int splits, long long MN, int N,
                              const float* __restrict__ scale, const float* __restrict__ bias,
                              OutT* __restrict__ C, int act, float lo, float hi) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < MN;
       i += (long long)gridDim.x * blockDim.x) {
    Acc s = ws[i];
    for (int z = 1; z < splits; ++z) s += ws[z * MN + i];
    const int n = (int)(i % N);
    C[i] = to_out<OutT>(gemm::epilogue(s, kScale ? scale[n] : 1.f, bias, n, act, lo, hi));
  }
}

// The grid of a split-K launch, (tiles of M x N, N tiles fastest; 1;
// splits), or err when the launch is refused: kchunk (k per split) must be
// a positive multiple of BK, a split K needs a workspace, and the grid must
// fit CUDA's limits.
struct SplitGrid {
  dim3 grid;
  int splits;
  cudaError_t err;
};

template <int BM_, int BN_, int BK_>
inline SplitGrid split_grid(long long M, int N, int K, int kchunk, const void* ws) {
  SplitGrid g{dim3(1), 1, cudaErrorInvalidValue};
  if (kchunk <= 0 || kchunk % BK_ != 0) return g;
  g.splits = K > 0 ? (K + kchunk - 1) / kchunk : 1;
  const long long tiles = ((M + BM_ - 1) / BM_) * (long long)((N + BN_ - 1) / BN_);
  if ((g.splits > 1 && ws == nullptr) || tiles > 0x7fffffffLL || g.splits > 65535) return g;
  g.grid = dim3((unsigned)tiles, 1, (unsigned)g.splits);
  g.err = cudaSuccess;
  return g;
}

// After a split-K launch's GEMM kernel: the reduction with the epilogue,
// writing C in OutT.
template <typename Acc, typename OutT = float>
inline int finish(const SplitGrid& g, const Acc* partial, long long M, int N, const void* scale,
                  const void* bias, void* C, int act, float lo, float hi, cudaStream_t s) {
  if (g.splits > 1) {
    const long long mn = M * N;
    const long long want = (mn + 255) / 256;
    const unsigned blocks = (unsigned)(want < 132 * 16 ? want : 132 * 16);
    const auto reduce = scale != nullptr ? splitk_reduce<Acc, true, OutT>
                                         : splitk_reduce<Acc, false, OutT>;
    reduce<<<blocks, 256, 0, s>>>(partial, g.splits, mn, N, static_cast<const float*>(scale),
                                  static_cast<const float*>(bias), static_cast<OutT*>(C), act,
                                  lo, hi);
  }
  return (int)cudaGetLastError();
}

// -- the int8 GEMM ------------------------------------------------------------

constexpr int BM = 128;
constexpr int BN = 64;
constexpr int BK = 64;  // int8 values of k per stage
constexpr int STAGES = 3;
constexpr int THREADS = 256;
constexpr int PITCH = BK + 16;  // bytes per shared-memory row

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The warp step: ldmatrix fragments and mma.sync m16n8k32 over 32 values of
// k of a warp's 32 x 32 tile.  Both operands lie in shared memory with rows
// of k: A row-major (a row per m, a_pitch bytes apart), B K-major (a row per
// n, b_pitch bytes apart); a pitch of 16 times an odd number puts the eight
// rows of one ldmatrix in eight different bank groups.  a and b are this
// lane's addresses, a_lane and b_lane below added to the warp tile's first
// row and the step's k.
__device__ __forceinline__ int a_lane(int lane, int a_pitch) {
  return (lane % 8 + ((lane / 8) % 2) * 8) * a_pitch + (lane / 16) * 16;
}
__device__ __forceinline__ int b_lane(int lane, int b_pitch) {
  return (lane % 8 + (lane / 16) * 8) * b_pitch + ((lane / 8) % 2) * 16;
}

__device__ __forceinline__ void warp_mma_k32(int (&acc)[2][4][4], const int8_t* a, int a_pitch,
                                             const int8_t* b, int b_pitch) {
  unsigned af[2][4], bf[2][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) ldmatrix_x4(af[mi], a + mi * 16 * a_pitch);
#pragma unroll
  for (int nj = 0; nj < 2; ++nj) ldmatrix_x4(bf[nj], b + nj * 16 * b_pitch);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
      mma_s8(acc[mi][ni], af[mi], bf[ni / 2][(ni % 2) * 2], bf[ni / 2][(ni % 2) * 2 + 1]);
}

struct Smem {
  int8_t a[STAGES][BM][PITCH];
  int8_t b[STAGES][BN][PITCH];
};

// Grid: (tiles of M x N, N tiles fastest; 1; splits).  ws is null with one
// split, else an int32 (splits, M, N) workspace for the partial sums.  C
// is float32 or bfloat16 (OutT).
template <class Loader, typename OutT>
__global__ void __launch_bounds__(THREADS)
i8i8_mma_kernel(Loader la, RowMajor lb, const float* __restrict__ scale,
                const float* __restrict__ bias, OutT* __restrict__ C, int* __restrict__ ws,
                long long M, int N, int K, int kchunk, int act, float lo, float hi) {
  __shared__ __align__(128) Smem sm;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp % 4, wn = warp / 4;  // warp tile rows wm*32, columns wn*32
  const int n_tiles = (N + BN - 1) / BN;
  const long long row0 = (long long)(blockIdx.x / n_tiles) * BM;
  const int col0 = (int)(blockIdx.x % n_tiles) * BN;
  const int kb = blockIdx.z * kchunk;
  const int ke = min(K, kb + kchunk);
  const int nk = (ke - kb + BK - 1) / BK;

  // Loads: A 128 rows x 4 chunks, two a thread; B 64 rows x 4 chunks, one.
  const int lrow = tid / 4, lk = (tid % 4) * 16;
  const typename Loader::Row a_row[2] = {la.row(row0 + lrow), la.row(row0 + lrow + 64)};
  const RowMajor::Row b_row = lb.row(col0 + lrow);
  // byte path registers: one set in the loop, STAGES - 1 in the prologue
  int4 a_reg[STAGES - 1][2], b_reg[STAGES - 1];

  auto issue = [&](int stage, int k0, int set) {
    fetch(la, a_row[0], k0 + lk, &sm.a[stage][lrow][lk], a_reg[set][0]);
    fetch(la, a_row[1], k0 + lk, &sm.a[stage][lrow + 64][lk], a_reg[set][1]);
    fetch(lb, b_row, k0 + lk, &sm.b[stage][lrow][lk], b_reg[set]);
  };
  auto store = [&](int stage, int set) {
    put(la, &sm.a[stage][lrow][lk], a_reg[set][0]);
    put(la, &sm.a[stage][lrow + 64][lk], a_reg[set][1]);
    put(lb, &sm.b[stage][lrow][lk], b_reg[set]);
  };

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) issue(s, kb + s * BK, s);
    cp_async_commit();
  }
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) store(s, s);
  }

  // this lane's ldmatrix addresses inside a stage
  const int a_off = wm * 32 * PITCH + a_lane(lane, PITCH);
  const int b_off = wn * 32 * PITCH + b_lane(lane, PITCH);

  for (int i = 0; i < nk; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage i landed for every thread; stage i-1 is free
    const int next = i + STAGES - 1;
    if (next < nk) issue(next % STAGES, kb + next * BK, 0);
    cp_async_commit();

    const int s = i % STAGES;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      warp_mma_k32(acc, &sm.a[s][0][0] + a_off + kk, PITCH, &sm.b[s][0][0] + b_off + kk, PITCH);
    }
    if (next < nk) store(next % STAGES, 0);
  }
  cp_async_wait<0>();

  store_warp_tile(acc, row0 + wm * 32, col0 + wn * 32, M, N,
                  ws == nullptr ? nullptr : ws + (long long)blockIdx.z * M * N, C, scale, bias,
                  act, lo, hi);
}

// kchunk: k per split, a multiple of BK (K or more for one split); ws: an
// int32 workspace of ceil(K / kchunk) * M * N values when that is above 1.
// C is float32, or bfloat16 when out_bf16 (one loop, its store chosen at
// launch).
template <class Loader>
int launch(const Loader& la, const RowMajor& lb, const void* scale, const void* bias, void* C,
           bool out_bf16, long long M, int N, int K, int kchunk, void* ws, int act, float lo,
           float hi, void* stream) {
  if (M == 0 || N == 0) return (int)cudaGetLastError();
  const SplitGrid g = split_grid<BM, BN, BK>(M, N, K, kchunk, ws);
  if (g.err != cudaSuccess) return (int)g.err;
  const cudaStream_t s = (cudaStream_t)stream;
  int* partial = g.splits > 1 ? static_cast<int*>(ws) : nullptr;
  const auto* sc = static_cast<const float*>(scale);
  const auto* bi = static_cast<const float*>(bias);
  if (out_bf16) {
    i8i8_mma_kernel<Loader, __nv_bfloat16><<<g.grid, THREADS, 0, s>>>(
        la, lb, sc, bi, static_cast<__nv_bfloat16*>(C), partial, M, N, K, kchunk, act, lo, hi);
    return finish<int, __nv_bfloat16>(g, partial, M, N, scale, bias, C, act, lo, hi, s);
  }
  i8i8_mma_kernel<Loader, float><<<g.grid, THREADS, 0, s>>>(
      la, lb, sc, bi, static_cast<float*>(C), partial, M, N, K, kchunk, act, lo, hi);
  return finish(g, partial, M, N, scale, bias, C, act, lo, hi, s);
}

}  // namespace i8mma
