// f32_wgmma.cuh: float32 A times a float32 or int8 B with float32 accuracy
// on Hopper's warpgroup TF32 tensor-core instruction (wgmma), A and B
// brought by the Tensor Memory Accelerator (TMA) through an mbarrier ring,
// B's TF32 terms made once a stage (or once a band) in shared memory.
// fused_gemm.cu's fused_gemm_f32_wgmma (float32 B, #1) and
// fused_gemm_f32_i8w_wgmma (int8 B, #1w) run it; kernels/gemm.py::f32_route
// sends a launch here or to f32_mma.cuh's mma.sync loop.
//
// C[m][n] = act((sum_k A[m][k] * B[k][n]) * scale[n] + bias[n]): the
// function of f32_mma.cuh and of the TPU kernel it replaces,
// pyopenvino_tpu/kernels/gemm.py::fused_gemm on float32 operands at
// Precision.HIGHEST (:50-58) and with an int8 B dequantized by its
// per-column scale (:44-47, :64-65): A a row-major (M, K) float32 matrix
// with row stride lda, B a row-major (K, N) float32 or int8 matrix, scale
// (required with an int8 B) and bias float32, C row-major float32.
//
// Design note.
//   * What bounds it: every main-path launch is a 1x1 conv or an FC with
//     K <= 1280, so the bytes (A in, C out: MobileNet-v2's 12544x96x576 at
//     batch 64 moves 33.9 MB, 10.1 us at 3.35 TB/s) bound it, and the three
//     TF32 passes (8.4 us at 495 TFLOP/s) sit just under that line.  So the
//     loop has to stream A in and C out while the passes hide underneath:
//     a producer warp keeps TMA loads in flight, the tensor cores run
//     asynchronous wgmma, and no warp splits B's terms again.
//     f32_mma.cuh's mma.sync loop (every warp splitting its own A and B
//     values every k step, scalar loads of B, all threads waiting at one
//     barrier a stage, 64 x 64 tiles) reached 14-29 % of this bound; this
//     one reaches 15-39 % a batch-64 forward, 37-67 % at the short-K shapes
//     and about 29 % of the TF32 rate at the long-K ones on small grids
//     (PERF.md §6).
//   * The split is f32_mma.cuh's: a float32 B splits both operands in
//     terms cut toward zero (split_trunc) and runs three passes, a_lo*b_hi,
//     a_hi*b_lo, a_hi*b_hi; an int8 B is exact as a float (codes as floats)
//     and runs two, a_lo*b and a_hi*b, A's terms rounded to nearest
//     (split_rna).  Every term is a TF32 value with its low 13 bits clear,
//     so nothing rests on how the tensor cores read a float32 operand's low
//     bits.  The passes go, k8 step by k8 step, into one float32
//     accumulator (tests/test_torch_port_gemm_tc.py::tc_product models it).
//   * Products: wgmma.mma_async m64nBNk8 .f32.tf32.tf32 with A from
//     registers (the RS form) and B from shared memory through a K-major,
//     128-byte-swizzled descriptor: wgmma takes a 32-bit type K-major only
//     (no transpose for tf32), and one 128-byte row holds the 32 values of
//     k of a stage, a k8 step 32 bytes of it.
//   * A: one tiled TMA map of the row-major A (box: 32 values of k x 128
//     rows, 128-byte swizzle) into a ring of `stages` stages, each with a
//     full and an empty mbarrier.  Each consumer thread reads its fragment
//     (rows g and g + 8 of its warp's 16, columns t and t + 4 of each k8
//     step; the swizzle puts the 32 lanes on 32 banks) into registers and
//     splits it there.  In the RS form a stage's A is free once it is in
//     registers, so the ring refills before the products finish.  One
//     buffer of fragments: each stage's products are retired before the
//     next stage is read (the other block on the SM fills the tensor cores
//     meanwhile).
//   * B: TMA brings the (K, N) tile as it lies in memory, 32 rows of k x BN
//     (float32 in 64-column boxes, int8 in one), and the consumers, once a
//     stage for the whole block, write its terms transposed into K-major
//     swizzled tiles (a float32 B: b_hi then b_lo; an int8 B: the codes as
//     floats), one 16-byte chunk of four k of one column a thread at a
//     time (conflict-free: the swizzle spreads eight columns' chunks over
//     the 32 banks).  Streaming, these tiles rotate through STREAM_SLOTS =
//     2 slots: with one barrier a stage and no group in flight past it,
//     slot j is written only after every warpgroup has retired the products
//     of step j - 2.  Where K is short enough that the whole band of
//     terms (K rounded up to 32, x BN) fits beside the ring (`band`), B's
//     tiles come through the ring when a block enters a band and are
//     converted once; the band's tiles then serve every M tile of it.
//   * Block: one TMA producer warp and two consumer warpgroups, each the
//     m64 half of a 128 x 64 tile, both reading the same B tiles; two
//     blocks an SM (96 registers a thread), which put one block's epilogue
//     and each stage's barrier under the other's products: on an H100 they
//     took 0.90-0.91x the time of 128 x 64 or 128 x 128 tiles at one block
//     an SM with double-buffered fragments (PERF.md §6), so only this
//     shape is built.  Persistent blocks walk a
//     contiguous run of work units numbered band by band (an N band of BN
//     columns, its M tiles, each M tile's K splits), so a block stays in a
//     band and its scale, bias and (band) terms; the producer runs ahead
//     across units, so the next tile's loads overlap this tile's epilogue.
//   * Epilogue: epilogue.cuh's order (scale, then bias, then ReLU or clamp,
//     each rounded alone; 1 and 0 where there is no scale or bias), scale
//     and bias staged in shared memory per band, float32 pairs stored from
//     the accumulators (beside the ring and the slots a 32 KB C tile does
//     not fit two blocks an SM).
//   * Split K (fewer tiles than SMs: MobileNet-v2's and EfficientNet-B0's
//     3136-row layers at batch 64 with N <= 320): split z
//     takes k steps [z * per, (z + 1) * per) and writes its float32 partial
//     tile to a workspace; i8_mma.cuh's reduction adds the splits in the
//     order z = 0, 1, ... and runs the epilogue.  No atomics: two calls give
//     the same bits.
//   * Ragged edges: TMA writes zeros for A's and B's boxes past K, M and N,
//     so their terms and products are zero; the stores clip at M and N.
//   * Requirements (f32_route checks them, the entries refuse the rest): A,
//     B and C 16-byte aligned, lda a multiple of 4 (TMA row strides), N a
//     multiple of 4 (float32 B) or 16 (int8 B) and at least 64; with an
//     int8 B a scale.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime
#include <cuda_runtime.h>

#include <cstdint>

#include "bf16_wgmma.cuh"  // mbarrier and TMA helpers, the tiled encoder, fence_regs
#include "epilogue.cuh"
#include "f32_mma.cuh"   // split_trunc, split_rna
#include "i8_mma.cuh"    // split K's reduction (finish)
#include "i8_wgmma.cuh"  // mbar_wait with its trap, consumers_sync, descriptors

namespace f32wgmma {

using bf16wgmma::fence_async_smem;
using bf16wgmma::mbar_arrive;
using bf16wgmma::mbar_expect;
using bf16wgmma::mbar_init;
using bf16wgmma::Slot;
using bf16wgmma::slot;
using bf16wgmma::smem_u32;
using bf16wgmma::tma_load;
using i8wgmma::consumers_sync;
using i8wgmma::mbar_wait;

constexpr int BM = 128;  // rows of a block tile: two consumer warpgroups of m64
constexpr int BN = 64;   // columns of a block tile: the wgmma's N
constexpr int BK = 32;   // values of k a step: one 128-byte swizzled row of float32
constexpr int CONSUMERS = 256;
constexpr int THREADS = CONSUMERS + 32;
constexpr int PER_SM = 2;  // blocks an SM the registers and shared memory are sized for
constexpr int MAX_STAGES = 8;
constexpr int STREAM_SLOTS = 2;  // B term tiles in rotation when B streams
constexpr int A_BYTES = BM * BK * 4;   // one stage's A box
constexpr int RAW_BOX_BYTES = 256;     // bytes of a row of one TMA box of B
// dynamic shared memory beyond the ring and the slots: the band's scale and
// bias, the barriers and the slack that aligns the base to 1024 bytes
// (kernels/gemm.py::f32w_smem)
constexpr int SMEM_EXTRA = 1024 + 2 * BN * 4 + 2 * MAX_STAGES * 8;
constexpr int SMEM_MAX = 232448;  // an H100's most a block may take

// one ring stage: A's box and B's raw 32 x BN tile of `tbytes`-byte values
__host__ __device__ constexpr int stage_bytes(int tbytes) { return A_BYTES + BK * BN * tbytes; }
// one slot: `terms` K-major tiles of BN rows of 128 bytes
__host__ __device__ constexpr int slot_bytes(int terms) { return terms * BN * BK * 4; }

// The raw B tile in a stage, as TMA writes it: boxes of COLS columns (at
// most RAW_BOX_BYTES bytes a row) side by side, each 32 rows of k.
template <typename T>
struct Raw {
  static constexpr int COLS = BN < RAW_BOX_BYTES / (int)sizeof(T) ? BN
                                                                   : RAW_BOX_BYTES / (int)sizeof(T);
  static constexpr int PITCH = COLS * (int)sizeof(T);  // bytes of a row of k of a box
  static constexpr int BOXES = BN / COLS;
  // value (k, n) of the tile
  __device__ __forceinline__ static T at(const unsigned char* raw, int k, int n) {
    return *reinterpret_cast<const T*>(raw + (n / COLS) * (BK * PITCH) + k * PITCH +
                                       (n % COLS) * (int)sizeof(T));
  }
};

// float32 B: three passes, both operands cut toward zero in two terms.
struct BFloat {
  using T = float;
  static constexpr int TERMS = 2;
  __device__ __forceinline__ static void split_a(float a, unsigned& hi, unsigned& lo) {
    f32mma::split_trunc(a, hi, lo);
  }
  // the terms of B[k0 .. k0 + 3][n] of a stage's raw tile
  __device__ __forceinline__ static void terms(const unsigned char* raw, int k0, int n, uint4& hi,
                                               uint4& lo) {
    unsigned h[4], l[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) f32mma::split_trunc(Raw<T>::at(raw, k0 + j, n), h[j], l[j]);
    hi = make_uint4(h[0], h[1], h[2], h[3]);
    lo = make_uint4(l[0], l[1], l[2], l[3]);
  }
};

// int8 B: two passes over A's terms rounded to nearest; a code is exact as a
// float (8 significant bits) and so in TF32.
struct BInt8 {
  using T = int8_t;
  static constexpr int TERMS = 1;
  __device__ __forceinline__ static void split_a(float a, unsigned& hi, unsigned& lo) {
    f32mma::split_rna(a, hi, lo);
  }
  __device__ __forceinline__ static void terms(const unsigned char* raw, int k0, int n, uint4& hi,
                                               uint4&) {
    using R = Raw<T>;
    hi = make_uint4(__float_as_uint(__int2float_rn(R::at(raw, k0, n))),
                    __float_as_uint(__int2float_rn(R::at(raw, k0 + 1, n))),
                    __float_as_uint(__int2float_rn(R::at(raw, k0 + 2, n))),
                    __float_as_uint(__int2float_rn(R::at(raw, k0 + 3, n))));
  }
};

#define F32W_F8(i)                                                                 \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d += A (64 x 8, four TF32 registers a thread) x B (8 x 64, K-major in
// shared memory)
__device__ __forceinline__ void wgmma64(float (&d)[32], const unsigned (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : F32W_F8(0), F32W_F8(8), F32W_F8(16), F32W_F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef F32W_F8

// Grid: persistent, units_per_block consecutive work units a block (unit
// u: tile u / splits, split u % splits; tile t: band t / m_tiles, M tile
// t % m_tiles); block size THREADS; dynamic shared memory: the ring, the
// slots (band: one a k step; else STREAM_SLOTS), the band's scale and bias,
// the barriers (host: f32w_smem).  ws: the float32 (splits, M, N)
// workspace when splits > 1, else unused; band only with one split.
template <class BT>
__global__ void __launch_bounds__(THREADS, PER_SM)
f32_wgmma_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                 const float* __restrict__ scale, const float* __restrict__ bias,
                 float* __restrict__ C, float* __restrict__ ws, int M, int N, int K, int stages,
                 int splits, int band, int units_per_block, int act, float lo, float hi) {
  using T = typename BT::T;
  constexpr int SB = stage_bytes((int)sizeof(T));
  constexpr int SLOT = slot_bytes(BT::TERMS);
  using R = Raw<T>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the base aligned to 1024 bytes by an offset into smem_raw (not through
  // an integer cast), so that the compiler keeps the consumers' loads and
  // stores in the shared window (LDS/STS, not generic LD/ST)
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int nk = (K + BK - 1) / BK;
  unsigned char* slots = ring + stages * SB;
  float* sc = reinterpret_cast<float*>(slots + (band ? nk : STREAM_SLOTS) * SLOT);
  float* bi = sc + BN;
  uint64_t* full = reinterpret_cast<uint64_t*>(bi + BN);
  uint64_t* empty = full + MAX_STAGES;

  // the warp index through a shuffle, so that ptxas knows it is the same in
  // every lane (wgmma on a path it takes as divergent is serialized, C7520)
  const int tid = threadIdx.x, warp = __shfl_sync(0xffffffffu, tid / 32, 0), lane = tid % 32;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int m_tiles = (M + BM - 1) / BM;
  const int units = m_tiles * ((N + BN - 1) / BN) * splits;
  const int u0 = blockIdx.x * units_per_block;
  const int u1 = min(units, u0 + units_per_block);
  const int per = (nk + splits - 1) / splits;  // k steps a split

  if (warp == CONSUMERS / 32) {  // the producer
    if (lane == 0) {
      int it = 0, cur = -1;
      // B's raw 32 x BN tile of k step s of band bnd into a stage
      auto load_b = [&](unsigned char* dst, int bnd, int s, uint64_t* bar) {
#pragma unroll
        for (int c = 0; c < R::BOXES; ++c)
          tma_load(dst + c * (BK * R::PITCH), &tb, bnd * BN + c * R::COLS, s * BK, bar);
      };
      for (int u = u0; u < u1; ++u) {
        const int tile = u / splits, z = u - tile * splits;
        const int bnd = tile / m_tiles, mt = tile - bnd * m_tiles;
        if (band && bnd != cur) {  // the band's tiles, for the consumers to convert
          cur = bnd;
          for (int s = 0; s < nk; ++s, ++it) {
            const Slot sl = slot(it, stages);
            mbar_wait(&empty[sl.stage], sl.parity ^ 1);
            mbar_expect(&full[sl.stage], SB - A_BYTES);
            load_b(ring + sl.stage * SB + A_BYTES, bnd, s, &full[sl.stage]);
          }
        }
        const int s1 = min(nk, (z + 1) * per);
        for (int s = z * per; s < s1; ++s, ++it) {
          const Slot sl = slot(it, stages);
          unsigned char* st = ring + sl.stage * SB;
          mbar_wait(&empty[sl.stage], sl.parity ^ 1);
          mbar_expect(&full[sl.stage], band ? A_BYTES : SB);
          tma_load(st, &ta, s * BK, mt * BM, &full[sl.stage]);
          if (!band) load_b(st + A_BYTES, bnd, s, &full[sl.stage]);
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg multiplies rows wg * 64 ... of each tile
  const int wg = warp / 4, g = lane / 4, t = lane % 4;
  const bool has_bias = bias != nullptr;
  const uint64_t dbits = i8wgmma::desc_bits(128);
  // this thread's A fragment in a stage: rows g and g + 8 of its warp's 16
  // (the same row % 8, so the same swizzle), byte 4t of a 16-byte chunk
  const int a_off = (wg * 64 + (warp % 4) * 16 + g) * 128 + t * 4;

  // A's fragment of the stage's four k8 steps, split in two TF32 terms:
  // a0 (row g, column t), a1 (row g + 8), a2 (column t + 4), a3
  auto load_a = [&](const unsigned char* st, unsigned (&ah)[4][4], unsigned (&al)[4][4]) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int c0 = ((2 * kk) ^ g) << 4, c1 = ((2 * kk + 1) ^ g) << 4;
      const float x[4] = {*reinterpret_cast<const float*>(st + a_off + c0),
                          *reinterpret_cast<const float*>(st + a_off + 1024 + c0),
                          *reinterpret_cast<const float*>(st + a_off + c1),
                          *reinterpret_cast<const float*>(st + a_off + 1024 + c1)};
#pragma unroll
      for (int j = 0; j < 4; ++j) BT::split_a(x[j], ah[kk][j], al[kk][j]);
    }
  };
  // a stage's raw B tile to its K-major terms in `dst`: chunk c (k 4c ..
  // 4c + 3) of column n at n * 128 + ((c ^ (n % 8)) * 16), each term a tile
  // of BN rows; the block's 256 threads, 8 * BN chunks
  auto convert = [&](const unsigned char* raw, unsigned char* dst) {
#pragma unroll
    for (int q = 0; q < BK / 4 * BN / CONSUMERS; ++q) {
      const int i = tid + q * CONSUMERS, n = i % BN, c = i / BN;
      uint4 h, l;
      BT::terms(raw, 4 * c, n, h, l);
      const int off = n * 128 + ((c ^ (n & 7)) << 4);
      *reinterpret_cast<uint4*>(dst + off) = h;
      if constexpr (BT::TERMS == 2) *reinterpret_cast<uint4*>(dst + BN * 128 + off) = l;
    }
  };

  float acc[BN / 2];
  // the products of one stage, k8 step by k8 step, the passes in
  // f32_mma.cuh's order, as one commit group
  auto mma = [&](unsigned (&ah)[4][4], unsigned (&al)[4][4], uint32_t b) {
    // every A term computed before the fence: ptxas otherwise sinks the
    // splits between the wgmma and injects a warpgroup.arrive before each
    // k8 step's (C7519)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(ah[kk][j]), "+r"(al[kk][j])::"memory");
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t bh = i8wgmma::desc(dbits, b + kk * 32);
      if constexpr (BT::TERMS == 2) {
        const uint64_t bl = i8wgmma::desc(dbits, b + BN * 128 + kk * 32);
        wgmma64(acc, al[kk], bh);
        wgmma64(acc, ah[kk], bl);
        wgmma64(acc, ah[kk], bh);
      } else {
        wgmma64(acc, al[kk], bh);
        wgmma64(acc, ah[kk], bh);
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  };

  int it = 0, cur = -1, cs = 0;
  unsigned ah[4][4], al[4][4];
  // k step s: its A into (ah, al); its B tiles from the band, or converted
  // into the next stream slot; the stage goes back to the producer once
  // read; then its products, retired before the next step
  auto step = [&](int s) {
    const Slot sl = slot(it++, stages);
    mbar_wait(&full[sl.stage], sl.parity);
    const unsigned char* st = ring + sl.stage * SB;
    load_a(st, ah, al);
    uint32_t b;
    if (band) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[sl.stage]);
      b = smem_u32(slots + s * SLOT);
    } else {
      unsigned char* dst = slots + (cs++ % STREAM_SLOTS) * SLOT;
      convert(st + A_BYTES, dst);
      fence_async_smem();
      consumers_sync();  // the tiles written, the stage read, by every thread
      if (lane == 0) mbar_arrive(&empty[sl.stage]);
      b = smem_u32(dst);
    }
    mma(ah, al, b);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  };

  for (int u = u0; u < u1; ++u) {
    const int tile = u / splits, z = u - tile * splits;
    const int bnd = tile / m_tiles, mt = tile - bnd * m_tiles, n0 = bnd * BN;
    if (bnd != cur) {
      // a new band: both warpgroups are past the last epilogue's reads of sc
      // and bi and past the old band's products
      consumers_sync();
      cur = bnd;
      for (int j = tid; j < BN; j += CONSUMERS) {
        const int n = n0 + j;
        sc[j] = scale != nullptr && n < N ? scale[n] : 1.f;
        bi[j] = has_bias && n < N ? bias[n] : 0.f;
      }
      if (band) {
        for (int s = 0; s < nk; ++s) {
          const Slot sl = slot(it++, stages);
          mbar_wait(&full[sl.stage], sl.parity);
          convert(ring + sl.stage * SB + A_BYTES, slots + s * SLOT);
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[sl.stage]);
        }
        fence_async_smem();
      }
      consumers_sync();
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    const int s0 = z * per, s1 = min(nk, s0 + per);
    for (int s = s0; s < s1; ++s) step(s);
    bf16wgmma::fence_regs(acc);

    // epilogue.  Accumulator j * 4 + r: row (warp % 4) * 16 + g (+ 8 for r
    // >= 2) of this warpgroup's 64, columns j * 8 + 2t (+ 1 for odd r).  N
    // is even, so a pair is inside N or outside.
    const int r0 = (warp % 4) * 16 + g, m_wg = mt * BM + wg * (BM / 2);
    if (splits > 1) {  // the raw sums to this split's slice of the workspace
      float* wz = ws + (long long)z * M * N;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = n0 + j * 8 + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m_wg + r0 + h * 8;
          if (n < N && m < M)
            *reinterpret_cast<float2*>(wz + (long long)m * N + n) =
                make_float2(acc[j * 4 + h * 2], acc[j * 4 + h * 2 + 1]);
        }
      }
      continue;
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int jn = j * 8 + 2 * t, n = n0 + jn;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m_wg + r0 + h * 8;
        if (n >= N || m >= M) continue;
        float v0 = __fmul_rn(acc[j * 4 + h * 2], sc[jn]);
        float v1 = __fmul_rn(acc[j * 4 + h * 2 + 1], sc[jn + 1]);
        if (has_bias) {
          v0 = __fadd_rn(v0, bi[jn]);
          v1 = __fadd_rn(v1, bi[jn + 1]);
        }
        *reinterpret_cast<float2*>(C + (long long)m * N + n) =
            make_float2(gemm::activate(v0, act, lo, hi), gemm::activate(v1, act, lo, hi));
      }
    }
  }
}

// Dynamic shared memory of a launch (kernels/gemm.py::f32w_smem).
inline int smem_bytes(bool b_int8, int stages, int slots) {
  return SMEM_EXTRA + stages * stage_bytes(b_int8 ? 1 : 4) + slots * slot_bytes(b_int8 ? 1 : 2);
}

template <class BT>
int launch_bt(const CUtensorMap& ta, const CUtensorMap& tb, const float* scale, const float* bias,
              float* C, float* ws, int M, int N, int K, int stages, int splits, bool band,
              int grid, int act, float lo, float hi, cudaStream_t s) {
  const int nk = (K + BK - 1) / BK;
  const int smem = smem_bytes(sizeof(typename BT::T) == 1, stages, band ? nk : STREAM_SLOTS);
  if (smem > (SMEM_MAX + 1024) / PER_SM - 1024) return (int)cudaErrorInvalidValue;
  const auto kernel = f32_wgmma_kernel<BT>;
  // the shared memory this kernel may take, raised once per device as
  // launches need more (a benign race: two threads set the same value)
  static int allowed[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || smem > allowed[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) allowed[dev] = smem;
  }
  const long long units = (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN) * splits;
  if (units > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int per_block = (int)((units + grid - 1) / grid);
  kernel<<<(int)((units + per_block - 1) / per_block), THREADS, smem, s>>>(
      ta, tb, scale, bias, C, ws, M, N, K, stages, splits, (int)band, per_block, act, lo, hi);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const i8mma::SplitGrid g{dim3(1), splits, cudaSuccess};
  return i8mma::finish(g, ws, (long long)M, N, scale, bias, C, act, lo, hi, s);
}

// A (M, K) float32 with row stride lda; B (K, N) float32 or int8 (b_int8,
// scale required); C (M, N) float32; the plan (kernels/gemm.py::f32_plan):
// stages in [2, MAX_STAGES], splits in [1, ceil(K / 32)] (ws a float32
// workspace of splits * M * N values when above 1), band (B's terms
// converted once a band; one split only), grid the most persistent blocks.
// Returns a cudaError: cudaErrorInvalidValue for arguments the loop does
// not take, shared memory beyond a block's share of the SM, or a tensor
// map that cuTensorMapEncodeTiled refuses.
inline int launch(const void* A, const void* B, bool b_int8, const void* scale, const void* bias,
                  void* C, int M, int N, int K, int lda, int act, float lo, float hi, int stages,
                  int splits, bool band, int grid, void* ws, void* stream) {
  if (M == 0 || N == 0) return (int)cudaGetLastError();
  const int nk = K > 0 ? (K + BK - 1) / BK : 0;
  if (M < 0 || K < 1 || lda < K || lda % 4 || N % (b_int8 ? 16 : 4) || N < BN || stages < 2 ||
      stages > MAX_STAGES || splits < 1 || splits > nk || (splits > 1 && (ws == nullptr || band)) ||
      grid < 1 || (b_int8 && scale == nullptr) || !i8wgmma::aligned16(A) ||
      !i8wgmma::aligned16(B) || !i8wgmma::aligned16(C))
    return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb;  // A: boxes of 32 values x BM rows, swizzled as the fragments read them
  if (!bf16wgmma::encode(&ta, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, A, K, M, lda, BK, BM,
                         CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  // B: boxes of Raw::COLS columns (64 float32 or int8 values) x 32 rows of
  // k, as they lie in memory
  const bool ok = b_int8 ? bf16wgmma::encode(&tb, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, B, N, K, N,
                                             Raw<int8_t>::COLS, BK, CU_TENSOR_MAP_SWIZZLE_NONE)
                         : bf16wgmma::encode(&tb, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, B, N, K, N,
                                             Raw<float>::COLS, BK, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (!ok) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  float* c = static_cast<float*>(C);
  float* w = static_cast<float*>(ws);
  return b_int8 ? launch_bt<BInt8>(ta, tb, sc, bi, c, w, M, N, K, stages, splits, band, grid, act,
                                   lo, hi, s)
                : launch_bt<BFloat>(ta, tb, sc, bi, c, w, M, N, K, stages, splits, band, grid,
                                    act, lo, hi, s);
}

}  // namespace f32wgmma
