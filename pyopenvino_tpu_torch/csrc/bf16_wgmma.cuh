// bf16_wgmma.cuh: a bfloat16 A times a bfloat16 or int8 B on Hopper's
// warpgroup tensor-core instruction (wgmma), fed by the Tensor Memory
// Accelerator (TMA) through an mbarrier ring, with the block's band of B
// resident in shared memory (or streamed with A where it does not fit).
// fused_gemm.cu's fused_gemm_bf16_wgmma and
// fused_gemm_bf16_i8w_wgmma run it; kernels/gemm.py::bf16_route sends a
// bf16 launch here or to bf16_mma.cuh's mma.sync loop.
//
// C[m][n] = bf16(act((sum_k A[m][k] * B[k][n]) * scale[n] + bias[n])): the
// function of bf16_mma.cuh (and of the TPU kernel's bf16 path,
// pyopenvino_tpu/kernels/gemm.py:48-75), A a row-major (M, K) bfloat16
// matrix with row stride lda, B a row-major (K, N) bfloat16 or int8 matrix,
// scale (required with an int8 B) and bias float32, C row-major bfloat16.
//
// Design note.
//   * What bounds it: every main-path launch is a 1x1 conv or an FC with
//     K, N <= 1280, so KN / (K + N) stays below the bf16 line (about 295
//     operations a byte): the loop's job is to stream A in and C out at
//     3.35 TB/s.  So the design keeps loads in flight all the time and
//     reads the weight from device memory once per block.
//   * Persistent blocks: the host launches at most 2 x SMs blocks, two an
//     SM (kernels/gemm.py::wgmma_plan sizes each block's shared memory for
//     that, and __launch_bounds__ its registers): while one block runs its
//     epilogue the other's loads and products go on.  Block b walks a
//     contiguous run of output tiles, numbered band by band (an N band of
//     BN columns, M tiles of BM = 64 rows inside it), so a block changes
//     band at most a few times and keeps its band of B in shared memory
//     meanwhile.
//   * Warp specialisation: warp 4 (the producer) has one lane issue every
//     TMA load into a ring of `stages` 8 KB stages, each with a full and an
//     empty mbarrier; warps 0-3 (one consumer warpgroup) wait on full,
//     multiply, and arrive on empty (one arrive a warp).  The producer runs
//     up to `stages` loads ahead, across tile and band boundaries, so the
//     next tile's A is in flight during this tile's epilogue.
//   * Products: wgmma.mma_async m64nBNk16 .f32.bf16.bf16, A (K-major) and B
//     (N-major, imm-trans-b) both read from shared memory through
//     descriptors, 128-byte swizzle; BK = 64, one 128-byte row of bf16, four
//     k16 steps a stage.  BN is 64, 128, 192 or 256 (the host's table:
//     the fewest bands that give every block a tile).
//     Products of two bf16 values are exact in float32, the sum is float32.
//   * The band: K_pad x BN bf16 (K_pad = K rounded up to 64) in 64-column
//     chunks of K_pad 128-byte swizzled rows, the layout wgmma's N-major
//     descriptor reads (SBO 1024 bytes between 8-row groups, LBO one chunk).
//     When the block starts a band, a bf16 B comes by TMA straight into it
//     (64 x 64 boxes, on a band_full mbarrier, once the consumers have
//     released the old band on band_empty); an int8 B comes through the
//     ring as A does, in pieces of up to 8 KB (128, 64 or 32 rows of k),
//     which the consumers convert exactly to bf16 (every int8 code is a
//     bf16 value) into the swizzled band.  So an int8 B costs one conversion per band, not one
//     per k step of every tile.  The band's scale and bias go to shared
//     memory at the same time (1 and 0 where there are none).
//   * Streaming: where the band does not fit a block's share (long K), B
//     comes with A through the ring instead, one k step a stage, in the
//     same chunk layout (64 rows a chunk); an int8 k step is converted in
//     the stage by the consumers before its products.
//   * Ragged edges: TMA fills rows and columns outside A and B with zeros
//     (M, K and N need not be multiples of the tile) and the store clips C
//     at M and N.  No box starts outside its tensor: the band rows of k
//     past the last int8 piece are zeroed once, when the block starts.
//   * Epilogue: epilogue.cuh's order (scale, then bias, then ReLU or clamp
//     in float32, each rounded alone), scale and bias read from shared
//     memory, one rounding to bf16, staged in a swizzled shared tile and
//     written by TMA stores of 64 x 64 boxes; the store's smem reads finish
//     before the next tile's epilogue writes.  (Read from device memory per
//     element, scale and bias made the epilogue most of a tile's clocks.)
//     No split K and no atomics: each output element is summed by one
//     warpgroup in one order, so two calls give the same bits.
//   * Requirements (the route checks them, the entry points refuse the
//     rest): A, B and C 16-byte aligned, lda, N and K multiples of 8, and
//     with an int8 B N a multiple of 16 (TMA's row strides are multiples
//     of 16 bytes).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "epilogue.cuh"

namespace bf16wgmma {

constexpr int BM = 64;  // rows of a tile: one wgmma m64
constexpr int BK = 64;  // k of an A stage: one 128-byte swizzled row of bf16
constexpr int STAGE_BYTES = BM * BK * 2;
constexpr int MAX_STAGES = 8;
constexpr int CONSUMERS = 128;  // one warpgroup
constexpr int THREADS = CONSUMERS + 32;
constexpr int MAX_BN = 256;  // wgmma's widest N
// dynamic shared memory beyond the ring, band and C tile: the band's scale
// and bias, the barriers and the slack that aligns the base to 1024 bytes
// (kernels/gemm.py::wgmma_smem)
constexpr int SMEM_EXTRA = 1024 + 2 * MAX_BN * 4 + (2 * MAX_STAGES + 2) * 8;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int x, int y,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x), "r"(y)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(x), "r"(y)
      : "memory");
}

// the consumer warpgroup's own barrier (id 1; 0 is __syncthreads)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// generic-proxy writes to shared memory made visible to wgmma and TMA
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a wgmma shared-memory descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

#define WG_F8(i)                                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_F32(i) WG_F8(i), WG_F8(i + 8), WG_F8(i + 16), WG_F8(i + 24)
#define WG_F64(i) WG_F32(i), WG_F32(i + 32)
#define WG_F96(i) WG_F64(i), WG_F32(i + 64)
#define WG_F128(i) WG_F64(i), WG_F64(i + 64)

// d += A (64 x 16, K-major) x B (16 x N, N-major: imm-trans-b 1)
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
        : WG_F32(0)
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void mma(float (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
        : WG_F64(0)
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<192> {
  __device__ __forceinline__ static void mma(float (&d)[96], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
        "}, %96, %97, p, 1, 1, 0, 1;\n}\n"
        : WG_F96(0)
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  __device__ __forceinline__ static void mma(float (&d)[128], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
        "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "
        "%125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
        : WG_F128(0)
        : "l"(a), "l"(b), "r"(1));
  }
};

#undef WG_F8
#undef WG_F32
#undef WG_F64
#undef WG_F96
#undef WG_F128

// keeps the compiler from touching the accumulators across the async wgmma
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// B's type, a template argument of the kernel (so a profiler tells the two
// apart by name)
struct BandBf16 {
  static constexpr bool kInt8 = false;
};
struct BandInt8 {
  static constexpr bool kInt8 = true;
};

// the ring position of load number `it`: stage and phase parity
struct Slot {
  int stage;
  uint32_t parity;
};
__device__ __forceinline__ Slot slot(int it, int stages) {
  return {it % stages, (uint32_t)((it / stages) & 1)};
}

// 16 int8 codes to 16 bf16 values, exactly (a code has 8 significant bits): each
// code c, biased to c + 128, becomes the low byte of the float 2^23 + c +
// 128 (one byte permute), from which one subtraction leaves c
__device__ __forceinline__ void codes_to_bf16(const uint4& v, uint4& lo, uint4& hi) {
  const unsigned w[4] = {v.x ^ 0x80808080u, v.y ^ 0x80808080u, v.z ^ 0x80808080u,
                         v.w ^ 0x80808080u};
  unsigned o[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const unsigned sel = 0x7540u + (q % 2) * 2;  // byte (q % 2) * 2 of w, under 0x4B0000
    const float f0 = __uint_as_float(__byte_perm(w[q / 2], 0x4B000000u, sel)) - 8388736.f;
    const float f1 = __uint_as_float(__byte_perm(w[q / 2], 0x4B000000u, sel + 1)) - 8388736.f;
    const __nv_bfloat162 h = __floats2bfloat162_rn(f0, f1);
    o[q] = *reinterpret_cast<const unsigned*>(&h);
  }
  lo = make_uint4(o[0], o[1], o[2], o[3]);
  hi = make_uint4(o[4], o[5], o[6], o[7]);
}

// The bytes of one ring stage: A's 64 x 64 box, and when B streams its
// k step too, as bf16 in the band's chunk layout (64 rows a chunk) and, for
// an int8 B, the codes as TMA brings them.
__host__ __device__ constexpr int stage_bytes(int bn, bool stream, bool int8) {
  return STAGE_BYTES + (stream ? bn * BK * 2 + (int8 ? bn * BK : 0) : 0);
}

// Grid: persistent, tiles_per_block consecutive tiles a block; block size
// THREADS; dynamic shared memory: the ring, the band (none when B streams),
// the C tile, the band's scale and bias, the barriers (host: wgmma_smem).
template <int BN, class Band>
__global__ void __launch_bounds__(THREADS, 2)
bf16_wgmma_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                  const __grid_constant__ CUtensorMap tc, const float* __restrict__ scale,
                  const float* __restrict__ bias, int M, int N, int K, int stages, int stream,
                  int tiles_per_block, int act, float lo, float hi) {
  constexpr bool kInt8 = Band::kInt8;
  // rows of k of an int8 band piece: one TMA box of at most a stage's 8 KB,
  // a multiple of 32 rows (the launcher's int8 map has the same box; BK rows
  // when B streams)
  constexpr int I8_ROWS = STAGE_BYTES / BN / 32 * 32;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int kpad = (K + BK - 1) / BK * BK;
  const int sbytes = stage_bytes(BN, stream, kInt8);
  unsigned char* ring = base;
  unsigned char* band = ring + stages * sbytes;
  unsigned char* ctile = band + (stream ? 0 : kpad * BN * 2);
  float* sc = reinterpret_cast<float*>(ctile + BM * BN * 2);  // the band's scale (1 if none)
  float* bi = sc + MAX_BN;                                     // and bias
  uint64_t* full = reinterpret_cast<uint64_t*>(bi + MAX_BN);
  uint64_t* empty = full + MAX_STAGES;
  uint64_t* band_full = empty + MAX_STAGES;  // a bf16 band landed
  uint64_t* band_empty = band_full + 1;      // the consumers are done with the old band

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32);
    }
    mbar_init(band_full, 1);
    mbar_init(band_empty, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int m_tiles = (M + BM - 1) / BM;
  const int tiles = m_tiles * ((N + BN - 1) / BN);
  const int t0 = blockIdx.x * tiles_per_block;
  const int t1 = min(tiles, t0 + tiles_per_block);
  const int nk = kpad / BK;
  // one 64-column chunk of the band, or of a streamed k step
  const uint32_t chunk_bytes = (uint32_t)(stream ? BK : kpad) * 128;
  // int8 band pieces: I8_ROWS rows of k each, none starting past K
  const int pieces = (K + I8_ROWS - 1) / I8_ROWS;

  if (warp == CONSUMERS / 32) {  // the producer
    if (lane == 0) {
      int it = 0, cur = -1;
      uint32_t bands = 0;
      for (int t = t0; t < t1; ++t) {
        const int bnd = t / m_tiles, mt = t % m_tiles, n0 = bnd * BN;
        if (bnd != cur && !stream) {
          cur = bnd;
          if (kInt8) {  // through the ring, for the consumers to convert
            for (int p = 0; p < pieces; ++p, ++it) {
              const Slot sl = slot(it, stages);
              mbar_wait(&empty[sl.stage], sl.parity ^ 1);
              mbar_expect(&full[sl.stage], I8_ROWS * BN);
              tma_load(ring + sl.stage * sbytes, &tb, n0, p * I8_ROWS, &full[sl.stage]);
            }
          } else {  // straight into the band, 64 x 64 boxes
            mbar_wait(band_empty, (bands & 1) ^ 1);
            mbar_expect(band_full, (uint32_t)nk * (BN / 64) * STAGE_BYTES);
            for (int c = 0; c < BN / 64; ++c)
              for (int kb = 0; kb < nk; ++kb)
                tma_load(band + c * chunk_bytes + kb * STAGE_BYTES, &tb, n0 + c * 64, kb * BK,
                         band_full);
          }
          ++bands;
        }
        for (int kb = 0; kb < nk; ++kb, ++it) {
          const Slot sl = slot(it, stages);
          unsigned char* st = ring + sl.stage * sbytes;
          mbar_wait(&empty[sl.stage], sl.parity ^ 1);
          mbar_expect(&full[sl.stage], sbytes - (stream && kInt8 ? BN * BK * 2 : 0));
          tma_load(st, &ta, kb * BK, mt * BM, &full[sl.stage]);
          if (stream && kInt8) {  // the codes, behind where the consumers convert them
            tma_load(st + STAGE_BYTES + BN * BK * 2, &tb, n0, kb * BK, &full[sl.stage]);
          } else if (stream) {
            for (int c = 0; c < BN / 64; ++c)
              tma_load(st + STAGE_BYTES + c * STAGE_BYTES, &tb, n0 + c * 64, kb * BK,
                       &full[sl.stage]);
          }
        }
      }
    }
    return;
  }

  // the consumers
  const uint32_t band_addr = smem_u32(band);
  if (kInt8 && !stream) {  // the band rows of k that no piece writes, zero for good
    const int from = min(kpad, pieces * I8_ROWS), per_chunk = (kpad - from) * 8;
    for (int i = tid; i < (BN / 64) * per_chunk; i += CONSUMERS)
      *reinterpret_cast<uint4*>(band + (i / per_chunk) * chunk_bytes + from * 128 +
                                (i % per_chunk) * 16) = make_uint4(0, 0, 0, 0);
  }
  const bool has_bias = bias != nullptr;
  int it = 0, cur = -1;
  uint32_t bands = 0;
  float acc[BN / 2];
  for (int t = t0; t < t1; ++t) {
    const int bnd = t / m_tiles, mt = t % m_tiles, n0 = bnd * BN;
    if (bnd != cur) {
      // a new band: every warp is past the old band's products and the
      // last epilogue's reads of sc and bi
      consumers_sync();
      if (!kInt8 && !stream && cur >= 0 && tid == 0) mbar_arrive(band_empty);
      cur = bnd;
      for (int j = tid; j < BN; j += CONSUMERS) {
        const int n = n0 + j;
        sc[j] = scale != nullptr && n < N ? scale[n] : 1.f;
        bi[j] = has_bias && n < N ? bias[n] : 0.f;
      }
      if (stream) {
        // B comes with each k step
      } else if (kInt8) {
        for (int p = 0; p < pieces; ++p, ++it) {
          const Slot sl = slot(it, stages);
          mbar_wait(&full[sl.stage], sl.parity);
          const unsigned char* st = ring + sl.stage * sbytes;
          // I8_ROWS rows x BN / 16 groups of 16 codes, rows past kpad skipped
          for (int i = tid; i < I8_ROWS * (BN / 16); i += CONSUMERS) {
            const int r = i / (BN / 16), g = i % (BN / 16), k = p * I8_ROWS + r;
            if (k >= kpad) break;
            uint4 v0, v1;
            codes_to_bf16(*reinterpret_cast<const uint4*>(st + r * BN + g * 16), v0, v1);
            unsigned char* row = band + (g / 4) * chunk_bytes + k * 128;
            *reinterpret_cast<uint4*>(row + (((2 * (g % 4)) ^ (k & 7)) << 4)) = v0;
            *reinterpret_cast<uint4*>(row + (((2 * (g % 4) + 1) ^ (k & 7)) << 4)) = v1;
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[sl.stage]);
        }
        fence_async_smem();
      } else {
        mbar_wait(band_full, bands & 1);
      }
      ++bands;
      consumers_sync();
    }

#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int kb = 0; kb < nk; ++kb, ++it) {
      const Slot sl = slot(it, stages);
      mbar_wait(&full[sl.stage], sl.parity);
      unsigned char* st = ring + sl.stage * sbytes;
      if (stream && kInt8) {
        // this k step's 64 rows of codes to bf16, into the stage's B chunks
        for (int i = tid; i < BK * (BN / 16); i += CONSUMERS) {
          const int r = i / (BN / 16), g = i % (BN / 16);
          uint4 v0, v1;
          codes_to_bf16(*reinterpret_cast<const uint4*>(st + STAGE_BYTES + BN * BK * 2 + r * BN +
                                                        g * 16),
                        v0, v1);
          unsigned char* row = st + STAGE_BYTES + (g / 4) * chunk_bytes + r * 128;
          *reinterpret_cast<uint4*>(row + (((2 * (g % 4)) ^ (r & 7)) << 4)) = v0;
          *reinterpret_cast<uint4*>(row + (((2 * (g % 4) + 1) ^ (r & 7)) << 4)) = v1;
        }
        fence_async_smem();
        consumers_sync();
      }
      const uint32_t a_addr = smem_u32(st);
      const uint32_t b_addr =
          stream ? smem_u32(st + STAGE_BYTES) : band_addr + (uint32_t)kb * BK * 128;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        Wgmma<BN>::mma(acc, desc(a_addr + kk * 32, 16, 1024),
                       desc(b_addr + kk * 16 * 128, chunk_bytes, 1024));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[sl.stage]);
    }

    // epilogue: the previous tile's TMA store has read the C tile.
    // Accumulator j * 4 + r: row warp * 16 + lane / 4 (+ 8 for r >= 2),
    // columns j * 8 + (lane % 4) * 2 (+ 1 for odd r).  Columns past N take
    // any value: the store clips them.
    if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    consumers_sync();
    const int row = warp * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int jn = j * 8 + (lane % 4) * 2;
      const float2 s2 = *reinterpret_cast<const float2*>(sc + jn);
      const float2 b2 = *reinterpret_cast<const float2*>(bi + jn);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v0 = __fmul_rn(acc[j * 4 + h * 2], s2.x);
        float v1 = __fmul_rn(acc[j * 4 + h * 2 + 1], s2.y);
        if (has_bias) {
          v0 = __fadd_rn(v0, b2.x);
          v1 = __fadd_rn(v1, b2.y);
        }
        const int r = row + h * 8;
        *reinterpret_cast<__nv_bfloat162*>(ctile + (j / 8) * (BM * 128) + r * 128 +
                                           (((j % 8) ^ (r & 7)) << 4) + (lane % 4) * 4) =
            __floats2bfloat162_rn(gemm::activate(v0, act, lo, hi), gemm::activate(v1, act, lo, hi));
      }
    }
    fence_async_smem();
    consumers_sync();
    if (tid == 0) {
#pragma unroll
      for (int c = 0; c < BN / 64; ++c)
        if (n0 + c * 64 < N) tma_store(&tc, ctile + c * (BM * 128), n0 + c * 64, mt * BM);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime, so the
// library needs no -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                                             12000, cudaEnableDefault, &q);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess ? (EncodeTiled)p : nullptr;
  }();
  return fn;
}

// A 2-D map of `rows` rows of `cols` values, row stride `ld` values.
inline bool encode(CUtensorMap* map, CUtensorMapDataType type, int elem, const void* p,
                   long long cols, long long rows, long long ld, int box_cols, int box_rows,
                   CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)(ld * elem)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t one[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(p), dims, strides, box, one,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, class Band>
int launch_bn(const CUtensorMap& ta, const CUtensorMap& tb, const CUtensorMap& tc,
              const float* scale, const float* bias, int M, int N, int K, int stages,
              bool stream, int grid, int act, float lo, float hi, cudaStream_t s) {
  const int kpad = (K + BK - 1) / BK * BK;
  const int smem = SMEM_EXTRA + stages * stage_bytes(BN, stream, Band::kInt8) +
                   (stream ? 0 : kpad * BN * 2) + BM * BN * 2;
  const auto kernel = bf16_wgmma_kernel<BN, Band>;
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
  const int tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int per_block = (tiles + grid - 1) / grid;
  kernel<<<(tiles + per_block - 1) / per_block, THREADS, smem, s>>>(
      ta, tb, tc, scale, bias, M, N, K, stages, (int)stream, per_block, act, lo, hi);
  return (int)cudaGetLastError();
}

// A (M, K) bf16 with row stride lda; B (K, N) bf16 or int8 (b_int8);
// C (M, N) bf16.  bn in {64, 128, 192, 256}, stages in [2, MAX_STAGES],
// streams (B comes with each k step instead of a resident band), grid the
// most blocks to launch (the host's plan).  Returns a cudaError:
// cudaErrorInvalidValue for arguments the loop does not take or a tensor
// map that cuTensorMapEncodeTiled refuses.
inline int launch(const void* A, const void* B, bool b_int8, const void* scale, const void* bias,
                  void* C, int M, int N, int K, int lda, int bn, int stages, bool streams,
                  int grid, int act, float lo, float hi, void* stream) {
  if (M == 0 || N == 0) return (int)cudaGetLastError();
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (K <= 0 || K % 8 || N % 8 || lda % 8 || lda < K || !aligned(A) || !aligned(B) ||
      !aligned(C) || stages < 2 || stages > MAX_STAGES || grid < 1 ||
      (bn != 64 && bn != 128 && bn != 192 && bn != 256) ||
      (b_int8 && (scale == nullptr || N % 16)))
    return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb, tc;
  const auto bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  bool ok = encode(&ta, bf, 2, A, K, M, lda, BK, BM, sw) &&
            encode(&tc, bf, 2, C, N, M, N, 64, BM, sw);
  const int i8_rows = streams ? BK : STAGE_BYTES / bn / 32 * 32;  // the kernel's boxes
  ok = ok && (b_int8 ? encode(&tb, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, B, N, K, N, bn, i8_rows,
                              CU_TENSOR_MAP_SWIZZLE_NONE)
                     : encode(&tb, bf, 2, B, N, K, N, 64, BK, sw));
  if (!ok) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
#define BF16_WGMMA_CASE(W)                                                                 \
  if (bn == W)                                                                             \
    return b_int8 ? launch_bn<W, BandInt8>(ta, tb, tc, sc, bi, M, N, K, stages, streams, grid, \
                                           act, lo, hi, s)                                      \
                  : launch_bn<W, BandBf16>(ta, tb, tc, sc, bi, M, N, K, stages, streams, grid, \
                                           act, lo, hi, s);
  BF16_WGMMA_CASE(64)
  BF16_WGMMA_CASE(128)
  BF16_WGMMA_CASE(192)
  BF16_WGMMA_CASE(256)
#undef BF16_WGMMA_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace bf16wgmma
