// dw_pw_fused_i8: a 3x3 stride-1 depthwise convolution and the 1x1 pointwise
// convolution after it, on int8 codes, in one kernel for Hopper (sm_90a),
// with the intermediate kept in shared memory.
//
//   acc[n,y,x,c]  = sum_{dy,dx} X[n, y+dy-1, x+dx-1, c] * Wdw[3*dy+dx][c]  (int32, zero pad)
//   q[n,y,x,c]    = clamp(rint(act_dw(float(acc) * dw_scale[c] + dw_bias[c]) * r_mid), +-127)
//   pacc[n,y,x,o] = sum_c q[n,y,x,c] * Wpw[c][o]                          (int32)
//   o             = act_pw(float(pacc) * pw_scale[o] + pw_bias[o])
//   out           = clamp(rint(o * r_out), +-127) as int8, or o as float32, or o
//                   rounded once to bfloat16
//
// X is NHWC int8 (N, H, W, C), Wdw (9, C) int8, Wpw K-major: the (Co, C)
// contiguous int8 matrix (row o holds column o of the (C, Co) weight), out
// NHWC (N, H, W, Co).  r_mid and r_out are the float32 of the double
// 1.0 / s (Python's 1.0 / scale, as the TPU kernel multiplies by it); every
// epilogue step rounds on its own (__fmul_rn, __fadd_rn, rintf half to
// even), never an FMA, and a bfloat16 output is the float32 one rounded to
// nearest even, so the output is bit-identical to the plain version.
//
// Replaces the Pallas TPU kernel tools/dw_pw_kernel.py::dw_pw_fused
// (kernel body _make_kernel, dw_pw_kernel.py:80-130; pallas_call in _impl at
// :173; with s_out None its out_dtype, float32 or bfloat16, :122), which
// the JAX package keeps off its serving paths, with its microbenchmark.
// Its TPU design holds G whole padded images in VMEM in a P-pitched row
// space (:65-72, :124-130) so that every tap is a static sublane offset;
// that layout belongs to Mosaic and is not carried over.
//
// What bounds it on an H100 SXM: the int8 tensor cores' 1,979 TOPS dense
// and 3.35 TB/s of device memory, about 590 operations per byte.  A pixel
// costs 18*C + 2*C*Co operations against C + Co bytes (int8 out), about Co
// operations per byte at C = Co: bound by bytes at every SSD-MobileNet pair
// up to 19x19x512, by operations at 10x10x1024.  What the fusion saves is
// the intermediate's round trip, 2*C bytes a pixel.  The depthwise stage's
// 18*C operations a pixel have no tensor-core form here: they run on the
// CUDA cores' integer units (64 a clock an SM, about 1/60 of the int8 mma
// rate), which makes them the larger stage at small Co.
//
// Design:
//   * One block of 256 threads (8 warps) per BM output pixels of the
//     flattened N*H*W (a tile may span two images; each pixel reads its own
//     neighbours); BM = 64 or 128, a template argument the host picks.
//     Where those blocks would leave SMs idle (batch 1), blockIdx.y splits
//     the Co tiles among co_split blocks of the same pixels, each of which
//     repeats the depthwise stage.
//   * Stage 1, depthwise: the threads walk (pixel, V-channel chunk) pairs,
//     V = 16, 8 or 4 as C divides (one __ldg of V bytes of X and of Wdw a
//     tap), else 4 by byte loads.  The nine taps' loads carry no branch (a
//     tap outside the image reads the pixel itself, then counts zero), so
//     they issue together.  Each product is one __dp4a of X's word with all
//     bytes but one masked off, against Wdw's word: exact in int32.  The
//     depthwise epilogue and requantization write the int8 mid tile of BM
//     rows into dynamic shared memory.  Only channels below C are written:
//     the ring's loader zero-fills Wpw past C (to the pointwise K, a
//     multiple of 64), so the tile's other bytes, and its rows past the
//     last pixel, add nothing.
//   * Stage 2, pointwise: i8_mma.cuh's warp step (ldmatrix fragments and
//     mma.sync m16n8k32, int32 sums) with the mid tile read in place as A.
//     Its rows are mid_pitch(C) = C rounded up to 64, plus 16 bytes: a
//     16-byte aligned pitch of 16 times an odd number, so the eight rows of
//     one ldmatrix fall in eight different bank groups.  The warps cover
//     BM x BN of the output as (BM / 32) x (8 / (BM / 32)) warp tiles of
//     32 x 32 (BN = 128 with 64 rows, 64 with 128).  Wpw streams through a
//     3-stage cp.async ring of BN rows x 64 bytes of k (80-byte rows, as in
//     i8_mma.cuh, with its loader: 16-byte cp.async where C % 16 == 0,
//     4-byte where C % 4 == 0, else its byte path); the ring runs over the
//     Co tiles one after another, and its first stages are issued before
//     stage 1, so they load while the depthwise stage runs.  After each Co
//     tile the pointwise epilogue and the output store, straight from the
//     accumulators.  The mid tile never leaves the SM.
//   * Shared memory: BM * mid_pitch(C) bytes of mid tile (133 KB at 128
//     rows and C = 1024) and the ring (15 or 30 KB).  The largest C the
//     card takes is dw_pw_max_channels.
//   * With a non-null `clocks` each block adds its stage 1 and stage 2
//     clock64() counts to clocks[0] and clocks[1] (a microbenchmark's view
//     of where a block's time goes; the card has no profiler of stalls).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "i8_mma.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BK = 64;  // bytes of k per ring stage; the pointwise K is a multiple
constexpr int STAGES = 3;
constexpr int B_PITCH = BK + 16;

// round(v * r) clipped to the symmetric int8 code domain
__device__ __forceinline__ int requant(float v, float r) {
  return (int)fminf(fmaxf(rintf(__fmul_rn(v, r)), -127.f), 127.f);
}

// bytes of a mid tile row: C rounded up to BK, plus 16
__host__ __device__ __forceinline__ int mid_pitch(int C) { return (C + BK - 1) / BK * BK + 16; }

template <int BM>
struct Tile {
  static constexpr int WARPS_M = BM / 32;
  static constexpr int WARPS_N = THREADS / 32 / WARPS_M;
  static constexpr int BN = 32 * WARPS_N;
  static constexpr int B_CHUNKS = BN * (BK / 16) / THREADS;  // 16-byte ring chunks a thread
};

struct Params {
  const int8_t* x;
  const int8_t* wdw;
  const float* dws;
  const float* dwb;
  i8mma::RowMajor wpw;  // rows = Co, ld = K = C
  const float* pws;
  const float* pwb;
  void* out;
  int N, H, W, C, Co;
  int dw_act;
  float dw_lo, dw_hi;
  int pw_act;
  float pw_lo, pw_hi;
  float r_mid, r_out;
  int vec;  // 16, 8, 4 or 1: X's and Wdw's load width in bytes
  long long* clocks;
};

// V channels of X or Wdw from p as V / 4 words: one 16-, 8- or 4-byte
// load, or (BYTES) one load a byte, zero past C (`left` channels remain
// from p).
template <int V, bool BYTES>
__device__ __forceinline__ void load_channels(const int8_t* p, int (&w)[V / 4], int left) {
  if constexpr (V == 16) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(p));
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else if constexpr (V == 8) {
    const int2 v = __ldg(reinterpret_cast<const int2*>(p));
    w[0] = v.x;
    w[1] = v.y;
  } else if constexpr (!BYTES) {
    w[0] = __ldg(reinterpret_cast<const int*>(p));
  } else {
    w[0] = i8mma::pack4(__ldg(p), left > 1 ? __ldg(p + 1) : 0, left > 2 ? __ldg(p + 2) : 0,
                        left > 3 ? __ldg(p + 3) : 0);
  }
}

// Stage 1: the depthwise sums of the block's BM pixels, their epilogue and
// requantization into mid, V channels an item.  Only the channels below C
// are written: the pointwise B is zero past C (its loader zero-fills k >=
// C), so whatever the mid tile holds there, or in rows past M, adds zero.
// A tap outside the image reads the pixel itself and adds nothing, so the
// nine taps' loads carry no branch and issue together.
template <int BM, int V, bool BYTES>
__device__ __forceinline__ void depthwise(const Params& p, int8_t* mid, int pitch, int row0) {
  const int chunks = (p.C + V - 1) / V;
  const int M = p.N * p.H * p.W;
  for (int item = threadIdx.x; item < BM * chunks; item += THREADS) {
    const int ml = item / chunks, c0 = (item - ml * chunks) * V;
    const int m = row0 + ml;
    if (m >= M) break;  // items go in pixel order
    const int t = m / p.W, xw = m - t * p.W, yh = t - t / p.H * p.H;
    const int8_t* px = p.x + m * p.C + c0;  // NHWC: pixel m's channels
    int acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
      const bool in = (unsigned)(yh + dy) < (unsigned)p.H && (unsigned)(xw + dx) < (unsigned)p.W;
      int xv[V / 4], wv[V / 4];
      load_channels<V, BYTES>(px + (in ? (dy * p.W + dx) * p.C : 0), xv, p.C - c0);
      load_channels<V, BYTES>(p.wdw + tap * p.C + c0, wv, p.C - c0);
#pragma unroll
      for (int q = 0; q < V / 4; ++q) {
        const int xq = in ? xv[q] : 0;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[4 * q + j] = __dp4a(xq & (int)(0xffu << (8 * j)), wv[q], acc[4 * q + j]);
      }
    }
    int word[V / 4];
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      int code[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + 4 * q + j;
        code[j] = c < p.C ? requant(gemm::epilogue(acc[4 * q + j], __ldg(p.dws + c), p.dwb, c,
                                                   p.dw_act, p.dw_lo, p.dw_hi),
                                    p.r_mid)
                          : 0;
      }
      word[q] = i8mma::pack4(code[0], code[1], code[2], code[3]);
    }
    int8_t* dst = mid + ml * pitch + c0;
    if constexpr (V == 16) {
      *reinterpret_cast<int4*>(dst) = make_int4(word[0], word[1], word[2], word[3]);
    } else if constexpr (V == 8) {
      *reinterpret_cast<int2*>(dst) = make_int2(word[0], word[1]);
    } else {
      *reinterpret_cast<int*>(dst) = word[0];
    }
  }
}

// The pointwise epilogue of a warp's 32 x 32 tile at (r0, c0), straight from
// the m16n8 accumulators (row g, +8 for r >= 2; columns 2t, 2t+1), to int8
// codes (OutT int8_t), float32 or bfloat16 (i8_mma.cuh's store_out).
template <typename OutT>
__device__ __forceinline__ void store_tile(const Params& p, const int (&acc)[2][4][4], int r0,
                                           int c0) {
  const int M = p.N * p.H * p.W, Co = p.Co;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = r0 + mi * 16 + g + h * 8;
      if (gm >= M) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int gn = c0 + ni * 8 + 2 * t;
        if (gn >= Co) continue;
        const bool two = gn + 1 < Co;
        const float v0 = gemm::epilogue(acc[mi][ni][2 * h], __ldg(p.pws + gn), p.pwb, gn,
                                        p.pw_act, p.pw_lo, p.pw_hi);
        const float v1 = two ? gemm::epilogue(acc[mi][ni][2 * h + 1], __ldg(p.pws + gn + 1),
                                              p.pwb, gn + 1, p.pw_act, p.pw_lo, p.pw_hi)
                             : 0.f;
        if constexpr (std::is_same<OutT, int8_t>::value) {
          int8_t* o = static_cast<int8_t*>(p.out) + gm * Co + gn;
          const int q0 = requant(v0, p.r_out), q1 = requant(v1, p.r_out);
          if (two && Co % 2 == 0) {
            *reinterpret_cast<char2*>(o) = make_char2((signed char)q0, (signed char)q1);
          } else {
            o[0] = (int8_t)q0;
            if (two) o[1] = (int8_t)q1;
          }
        } else {
          i8mma::store_out(static_cast<OutT*>(p.out) + gm * Co + gn, gn, Co, v0, v1);
        }
      }
    }
}

// OutT: int8_t (codes at 1 / r_out), float or __nv_bfloat16
template <int BM, typename OutT>
__global__ void __launch_bounds__(THREADS, 2) dw_pw_kernel(Params p) {
  using T = Tile<BM>;
  extern __shared__ __align__(128) int8_t mid[];  // [BM][pitch]
  __shared__ __align__(128) int8_t ring[STAGES][T::BN][B_PITCH];
  __builtin_assume(p.dwb != nullptr && p.pwb != nullptr);  // the epilogues' bias

  const long long t0 = p.clocks != nullptr ? clock64() : 0;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp % T::WARPS_M, wn = warp / T::WARPS_M;
  const int pitch = mid_pitch(p.C);
  const int nk = (pitch - 16) / BK;  // ring stages per Co tile
  // this block's Co tiles: blockIdx.y's share of them
  const int n_tiles = (p.Co + T::BN - 1) / T::BN;
  const int per_block = (n_tiles + gridDim.y - 1) / gridDim.y;
  const int tile0 = blockIdx.y * per_block;
  const int steps = (min(n_tiles, tile0 + per_block) - tile0) * nk;
  if (steps <= 0) return;
  const int row0 = blockIdx.x * BM;

  // Wpw's ring: BN rows x 4 chunks of 16 bytes, B_CHUNKS a thread (rows
  // lrow + 64 c); step i holds Co tile tile0 + i / nk, k (i % nk) * BK
  const int lrow = tid / 4, lk = (tid % 4) * 16;
  int4 b_reg[T::B_CHUNKS];  // the loader's byte path
  auto issue = [&](int i) {
    const int col0 = (tile0 + i / nk) * T::BN, k0 = i % nk * BK;
#pragma unroll
    for (int c = 0; c < T::B_CHUNKS; ++c) {
      const int n = lrow + 64 * c;
      i8mma::fetch(p.wpw, p.wpw.row(col0 + n), k0 + lk, &ring[i % STAGES][n][lk], b_reg[c]);
    }
  };
  auto store = [&](int i) {
#pragma unroll
    for (int c = 0; c < T::B_CHUNKS; ++c) {
      i8mma::put(p.wpw, &ring[i % STAGES][lrow + 64 * c][lk], b_reg[c]);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) {
      issue(s);
      store(s);
    }
    i8mma::cp_async_commit();
  }

  // Stage 1: depthwise 3x3, exact int32, epilogue, requantize into mid.
  if (p.vec == 16) {
    depthwise<BM, 16, false>(p, mid, pitch, row0);
  } else if (p.vec == 8) {
    depthwise<BM, 8, false>(p, mid, pitch, row0);
  } else if (p.vec == 4) {
    depthwise<BM, 4, false>(p, mid, pitch, row0);
  } else {
    depthwise<BM, 4, true>(p, mid, pitch, row0);
  }
  __syncthreads();
  const long long t1 = p.clocks != nullptr ? clock64() : 0;

  // Stage 2: pointwise on the tensor cores, Co tile after Co tile.
  const int8_t* a_base = mid + wm * 32 * pitch + i8mma::a_lane(lane, pitch);
  const int b_off = wn * 32 * B_PITCH + i8mma::b_lane(lane, B_PITCH);
  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  for (int i = 0; i < steps; ++i) {
    i8mma::cp_async_wait<STAGES - 2>();
    __syncthreads();  // step i landed for every thread; step i-1's stage is free
    const int next = i + STAGES - 1;
    if (next < steps) issue(next);
    i8mma::cp_async_commit();

    const int8_t* a = a_base + i % nk * BK;
    const int8_t* b = &ring[i % STAGES][0][0] + b_off;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) i8mma::warp_mma_k32(acc, a + kk, pitch, b + kk, B_PITCH);
    if (next < steps) store(next);

    if (i % nk == nk - 1) {  // the Co tile's last k: epilogue and store
      store_tile<OutT>(p, acc, row0 + wm * 32, (tile0 + i / nk) * T::BN + wn * 32);
#pragma unroll
      for (int a2 = 0; a2 < 2; ++a2)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[a2][j][r] = 0;
    }
  }
  i8mma::cp_async_wait<0>();

  if (p.clocks != nullptr) {
    __syncthreads();
    if (tid == 0) {
      atomicAdd(reinterpret_cast<unsigned long long*>(p.clocks), (unsigned long long)(t1 - t0));
      atomicAdd(reinterpret_cast<unsigned long long*>(p.clocks) + 1,
                (unsigned long long)(clock64() - t1));
    }
  }
}

// The largest C that dw_pw_kernel<BM, *> takes on `device`: its BM rows of
// mid_pitch(C) bytes, with its static ring (the same for every output
// type), within the shared memory a block may opt into.  0 if the device
// cannot be asked.
template <int BM>
int max_channels(int device) {
  int optin = 0;
  cudaFuncAttributes attr;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
          cudaSuccess ||
      cudaFuncGetAttributes(&attr, dw_pw_kernel<BM, float>) != cudaSuccess) {
    return 0;
  }
  const int row = (optin - (int)attr.sharedSizeBytes) / BM - 16;
  return row / BK * BK;
}

template <int BM, typename OutT>
int launch(const Params& p, int co_split, cudaStream_t stream) {
  const int smem = BM * mid_pitch(p.C);
  // static ring and dynamic mid tile together above 48 KB only by the
  // kernel's own limit
  if (smem + STAGES * Tile<BM>::BN * B_PITCH > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dw_pw_kernel<BM, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int M = p.N * p.H * p.W;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)co_split);
  dw_pw_kernel<BM, OutT><<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// The largest C the kernel takes with `tile_rows` (64 or 128) pixels a
// block on `device`; 0 for another tile_rows or an unreadable device.
extern "C" int dw_pw_max_channels(int device, int tile_rows) {
  return tile_rows == 64 ? max_channels<64>(device)
                         : tile_rows == 128 ? max_channels<128>(device) : 0;
}

// Plain C interface for ctypes.  wpw is K-major: the (Co, C) contiguous int8
// matrix.  Every pointer but clocks is required; clocks, when not null, is
// two int64 counters that each block adds its stage clocks to.  out_type: 0
// float32, 1 int8 codes at 1 / r_out, 2 bfloat16.  tile_rows: 64 or 128 pixels
// a block; co_split: blocks that share a tile of pixels, each taking its
// share of the Co tiles (1 ... 65535; each repeats the depthwise stage).
// N*H*W*max(C, Co) must stay below 2^31.  Launches on `stream`,
// does not synchronise, and returns the first CUDA error (0 when the launch
// was accepted; C above dw_pw_max_channels fails in cudaFuncSetAttribute).
extern "C" int dw_pw_fused_i8(const void* x, const void* wdw, const void* dws,
                              const void* dwb, const void* wpw, const void* pws,
                              const void* pwb, void* out, int N, int H, int W, int C,
                              int Co, int dw_act, float dw_lo, float dw_hi, int pw_act,
                              float pw_lo, float pw_hi, float r_mid, int out_type,
                              float r_out, int tile_rows, int co_split, void* clocks,
                              void* stream) {
  if ((long long)N * H * W == 0 || Co == 0) return (int)cudaGetLastError();
  if (co_split < 1 || co_split > 65535) return (int)cudaErrorInvalidValue;
  const auto x_addr = reinterpret_cast<std::uintptr_t>(x);
  const auto dw_addr = reinterpret_cast<std::uintptr_t>(wdw);
  const auto pw_addr = reinterpret_cast<std::uintptr_t>(wpw);
  // the widest load that every pixel's and tap's channels allow
  int vec = 1;
  for (int v = 16; v >= 4 && vec == 1; v /= 2) {
    if (C % v == 0 && x_addr % v == 0 && dw_addr % v == 0) vec = v;
  }
  const Params p{static_cast<const int8_t*>(x), static_cast<const int8_t*>(wdw),
                 static_cast<const float*>(dws), static_cast<const float*>(dwb),
                 {static_cast<const int8_t*>(wpw), (long long)C, (long long)Co, C,
                  pw_addr % 16 == 0 && C % 16 == 0, pw_addr % 4 == 0 && C % 4 == 0},
                 static_cast<const float*>(pws), static_cast<const float*>(pwb), out, N, H, W, C,
                 Co, dw_act, dw_lo, dw_hi, pw_act, pw_lo, pw_hi, r_mid, r_out,
                 vec, static_cast<long long*>(clocks)};
  const cudaStream_t s = (cudaStream_t)stream;
  if (tile_rows != 64 && tile_rows != 128) return (int)cudaErrorInvalidValue;
  switch (out_type) {
    case 0:
      return tile_rows == 64 ? launch<64, float>(p, co_split, s)
                             : launch<128, float>(p, co_split, s);
    case 1:
      return tile_rows == 64 ? launch<64, int8_t>(p, co_split, s)
                             : launch<128, int8_t>(p, co_split, s);
    case 2:
      return tile_rows == 64 ? launch<64, __nv_bfloat16>(p, co_split, s)
                             : launch<128, __nv_bfloat16>(p, co_split, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
