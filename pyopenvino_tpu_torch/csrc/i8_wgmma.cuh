// i8_wgmma.cuh: the int8 x int8 -> int32 GEMM on Hopper's warpgroup
// tensor-core instruction (wgmma), its A brought by the Tensor Memory
// Accelerator (TMA) through one of two loaders, a template argument of the
// kernel:
//   * ConvAIm2col: the implicit GEMM of a stride-1 conv, A gathered in
//     TMA's im2col mode.  conv_direct.cu's conv2d_direct_i8_wgmma runs it;
//     kernels/conv_direct.py::direct_route sends a launch here or to
//     i8_mma.cuh's mma.sync loop (conv2d_direct_i8).
//   * TiledA: a row-major (M, K) A with row stride lda, by tiled TMA loads.
//     fused_gemm.cu's fused_gemm_i8i8_wgmma runs it;
//     kernels/gemm.py::i8_route sends a launch here or to i8_mma.cuh's loop
//     (fused_gemm_i8i8).
// The same skeleton runs a bfloat16 conv (kernel 3f-bf16) through two more
// loaders, ConvABf16Im2col (a bfloat16 weight) and ConvABf16Im2colI8w (an
// int8 weight): conv_direct.cu's conv2d_direct_bf16_wgmma;
// kernels/conv_direct.py::direct_bf16_route sends a launch here or to
// bf16_mma.cuh's mma.sync loop (conv2d_direct_bf16).  See "bfloat16
// operands" below.
//
// out[m][co] = act(float(sum_k A[m][k] * W[co][k]) * scale[co] + bias[co]),
// the function of i8_mma.cuh with its loaders (and of the TPU kernels
// pyopenvino_tpu/kernels/conv_direct.py::conv2d_direct, body :33-73, and
// pyopenvino_tpu/kernels/gemm.py::fused_gemm on int8 A and B, :44-47): for
// a conv M = N*OH*OW output pixels, K = kh*kw*Ci in (i, j, c) order, A the
// implicit im2col matrix of the NHWC int8 input (padding read as zeros);
// W the K-major (Co, K) int8 weight matrix, scale required, bias optional,
// out float32 or bfloat16 (one rounding after the epilogue).
//
// Design note.
//   * What bounds it: at ResNet-18's 3x3 shapes in a batch of 64 a conv
//     does 14.8 G int8 operations; the 14x14 and 7x7 ones are bound by
//     them, the 56x56 and 28x28 ones by the output's bytes.  The old loop
//     (mma.sync from registers, 3 stages of 64 bytes of k, the warps that
//     multiply also computing each chunk's tap) spent 62-92 % of its
//     clocks in its main loop at 1.4-1.9 TOPS an SM, 9.5-12.6 % of the
//     card's int8 rate.  wgmma is the card's full int8 rate; a TMA producer
//     warp takes the address arithmetic off the warps that multiply.
//   * A by TMA in im2col mode: one tensor map of the NHWC input (dims C, W,
//     H, N), its bounding box from (-pl, -pt) to (pr - kw + 1, pb - kh + 1)
//     past the input's far corner, so it walks the same-size output's
//     pixels: a load from output pixel m0's (ox - pl, oy - pt, n) with the
//     tap (j, i) as its offsets brings BM consecutive output pixels' `sl`
//     channels of that tap, wrapping rows and images, zeros where the tap
//     falls in the padding or past the last image.  No padded copy, no
//     division in the kernel but one per k step of the producer.
//   * A k step is one tap (i, j) and one slice of `sl` = 128, 64 or 32
//     channels (the largest that divides Ci): one 128-, 64- or 32-byte
//     swizzled row a pixel, the swizzle wgmma's descriptor reads.  The k
//     steps run in K's (i, j, c) order; B's k step is the same (i, j,
//     c-slice) columns of the K-major weight, a tiled TMA box of BN rows of
//     `sl` bytes, the same swizzle.  A stage holds STAGE_K = 128 bytes of
//     k: 128 / sl consecutive k steps side by side (R's 56x56 conv: two
//     taps of 64 channels), so 4 wgmma k32 steps a stage whatever Ci;
//     with one 64-channel tap a stage that conv spent most of its main
//     loop on each stage's fixed cost.  Ci not a multiple of 32 stays on
//     the old loop: a 16-byte slice is half a k32 step.
//   * TiledA (fused_gemm's int8 x int8 launches, #1ii and #1ii-bf16): one
//     tiled map of A (dims K, M, row stride lda; a box of `sl` bytes by BM
//     rows, the swizzle of `sl`), B's map as the conv's; k step s is bytes
//     [s * sl, (s + 1) * sl) of K in both, the same shared-memory layout as
//     an im2col load, so the consumers do not change.  K need not be a
//     multiple of `sl`: TMA writes zeros for the box's bytes past K (and
//     rows past M or N) in both operands, so the last step's products add
//     nothing and the sum stays exact without a padded copy; the consumers
//     stop a stage's k32 steps at K's last byte (TiledA::K; a conv's K is
//     whole steps).  K and lda must be multiples of 16 (TMA row strides).
//     At batch 64 the mma.sync loop ran these shapes at 13-45 % of their
//     bound where cuBLASLt's int8 GEMM took half its time: the same main
//     loop as #3's before it (PERF.md §6), which this loop replaced there.
//   * B streams with A, one k step a stage: at BM = 128 rows B's bytes are
//     at most A's, both L2 hits after the first tile.  (bf16_wgmma.cuh
//     keeps a band of B resident; here the band of R's 7x7 conv is 2.4 MB
//     and even the 56x56 one's would cost a block a third of its share.)
//   * Block: one TMA producer warp and two consumer warpgroups, each the
//     m64 half of a 128 x BN tile (BN = 64 or 128, the wgmma N), so both
//     read one B stage; a ring of `stages` stages, each with a full and an
//     empty mbarrier.  Products: wgmma.mma_async m64nBNk32 .s32.s8.s8, A
//     and B both K-major in shared memory, read through descriptors; one
//     group stays in flight while the next stage's are issued, and a stage
//     goes back to the producer when its products are done.
//   * Persistent blocks, two an SM (kernels/conv_direct.py::direct_plan
//     sizes each block's ring for that): one block's epilogue runs under
//     the other's products.  Block b walks a contiguous run of work units,
//     numbered band by band (an N band of BN columns, its M tiles, each M
//     tile's K splits), and loads the band's scale and bias into shared
//     memory when it enters a band.
//   * Epilogue: epilogue.cuh's order (int32 to float32, __fmul_rn by the
//     scale, __fadd_rn of the bias, ReLU or clamp), one rounding to bf16
//     where out is bf16.  64-wide tiles stage it in a 128-byte swizzled C
//     tile in shared memory, written by TMA stores of 64-row boxes of 128
//     bytes, each warpgroup its own half (the store clips rows past M and
//     columns past Co): stored from the accumulators, each warp store
//     touches eight rows, and the epilogue took 29 % of a block's clocks at
//     R's 56x56 conv, as long for bf16 as for float32.  128-wide tiles
//     store from the accumulators (8-byte float32 or 4-byte bf16 pairs):
//     their float32 C tile (64 KB) would leave two blocks an SM no ring,
//     and one block an SM with it ran R's 28x28 ... 7x7 convs 1.05-1.4x
//     slower on an H100.
//   * Split K (fewer tiles than SMs; direct_plan keeps the work units in
//     one wave: R's 7x7 conv at batch 64, 100 tiles, takes two splits):
//     split z takes stages [z * per, (z + 1) * per) of k and writes its
//     int32 partial tile to a
//     workspace; i8_mma.cuh's reduction adds the splits in order and runs
//     the epilogue.  int32 sums are exact in any order, so every split
//     count, and the old loop, give the same bits.
//   * Requirements (direct_route and i8_route check them, the entry points
//     refuse the rest): x or A, the weight and out 16-byte aligned, Co a
//     multiple of 4 (float32 out) or 8 (bf16 out: C's rows are TMA row
//     strides), Co >= BN; a conv's Ci a multiple of 32, pads at most 64 and
//     kernels at most 64 wide (the im2col corners' range); a GEMM's K and
//     lda multiples of 16.
//   * bfloat16 operands (3f-bf16: bfloat16 x, a bfloat16 or an int8 weight,
//     out = bf16(act((sum xpad * w) * scale + bias)), scale optional with a
//     bfloat16 weight).  The old loop (bf16_mma.cuh's mma.sync from
//     registers, 64 x 64 tiles, the warps that multiply also finding each
//     chunk's tap) ran R's four batch-64 convs at about 130 TFLOP/s, 13 % of
//     bf16 wgmma's 989, whatever the shape.  A bf16 k16 step is 32 bytes of
//     k like an int8 k32 one, so everything here that counts bytes of k
//     stays: `sl` bytes a k step (64, 32 or 16 channels, the largest that
//     divides Ci: Ci a multiple of 16), STAGE_K = 128 bytes (64 values) of
//     k a stage, the swizzles, the descriptors' offsets, the producer's walk
//     over (tap, channel slice); the loader's element size E turns its
//     bytes into the maps' element coordinates.  What the type changes:
//     wgmma.mma_async m64nBNk16 .f32.bf16.bf16 (both K-major, no transpose)
//     into float32 accumulators (the products of two bf16 values exact, the
//     sum float32, as in the old loop), the maps' data types, and split K's
//     float32 partials, which i8_mma.cuh's reduction adds in the order z =
//     0, 1, ..., so two calls give the same bits.  B is the K-major (Co, K)
//     matrix (conv_weight_matrix_nk), the int8 conv's layout: one tiled box
//     of BN rows of `sl` bytes a k step.  An int8 weight's codes come by TMA
//     into the second half of the stage's B region (BN rows of sl / 2 bytes
//     a k step, no swizzle); the consumers read them into registers, meet
//     at a barrier, and write them as bf16 (exact: a code has 8 significant
//     bits) into the swizzled K-major rows the descriptor reads, so a stage
//     is the bf16 weight's size and the ring as deep; the scale multiplies
//     the finished float32 sum in the epilogue.  The conversion of stage g
//     runs while group g - 1 multiplies.  Converting a stage further ahead
//     (stage g + 1 while group g multiplies) held three of the ring's three
//     stages at once and took 1.10-1.23x the time on an H100; a
//     conversion with half the instructions (bf16x2 subtraction in place
//     of float32) took the same (PERF.md §6).  On an H100 the bf16
//     weight's loop brings its tiles' TMA loads (each tile re-reads A's
//     taps and B) from L2 at 5.0-5.5 TB/s, above an L2-resident copy's
//     rate: L2, not HBM or the tensor cores, bounds it (chip_smoke.py's
//     wgmma_load_bytes and l2_copy).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoders come through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "bf16_wgmma.cuh"  // mbarrier, TMA and descriptor helpers, the tiled encoder
#include "epilogue.cuh"
#include "i8_mma.cuh"  // split K's reduction (finish)

namespace i8wgmma {

using bf16wgmma::mbar_arrive;
using bf16wgmma::mbar_expect;
using bf16wgmma::mbar_init;
using bf16wgmma::Slot;
using bf16wgmma::slot;
using bf16wgmma::smem_u32;
using bf16wgmma::tma_load;
using bf16wgmma::tma_store;

constexpr int BM = 128;  // rows of a block tile: two consumer warpgroups of m64
constexpr int CONSUMERS = 256;
constexpr int THREADS = CONSUMERS + 32;
constexpr int PER_SM = 2;  // blocks an SM (__launch_bounds__, direct_plan's smem)
constexpr int STAGE_K = 128;  // bytes of k a stage: 128 / sl taps' slices
constexpr int MAX_STAGES = 8;
constexpr int MAX_BN = 128;
// dynamic shared memory beyond the ring: the band's scale and bias, the
// barriers and the slack that aligns the base to 1024 bytes
// (kernels/conv_direct.py::direct_smem)
constexpr int SMEM_EXTRA = 1024 + 2 * MAX_BN * 4 + 2 * MAX_STAGES * 8;

// one ring stage: A's BM pixels and B's bn rows, STAGE_K bytes of k each
__host__ __device__ constexpr int stage_bytes(int bn) { return (BM + bn) * STAGE_K; }

// 64-wide tiles stage their C tile in shared memory for TMA stores: each
// warpgroup's 64 rows in boxes of 128 bytes of columns (32 float32 or 64
// bf16 values), 128-byte swizzled; 128-wide tiles store from the
// accumulators (their float32 C tile would leave two blocks an SM no ring)
__host__ __device__ constexpr int ctile_bytes(int bn, int out_bytes) {
  return bn == 64 ? BM * bn * out_bytes : 0;
}

// Wait for an mbarrier's phase; a wait of more than about 2^32 clocks (two
// seconds) traps, so a load that never lands ends the launch with an error
// the wrapper raises instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 32)) __trap();
  }
}

// one im2col TMA load: BM pixels x the map's channels from (c, w, h, n),
// the tap (j, i) as offsets
__device__ __forceinline__ void tma_im2col(void* dst, const CUtensorMap* map, int c, int w, int h,
                                           int n, int j, int i, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c), "r"(w), "r"(h), "r"(n),
      "h"((unsigned short)j), "h"((unsigned short)i)
      : "memory");
}

// The implicit im2col A of a stride-1 conv on E-byte activations: k step s
// is tap s / slices and channel slice s % slices (sl / E channels); the
// producer turns an M tile's first pixel and a k step into one im2col load.
template <int E>
struct Im2col {
  static constexpr int kE = E;  // bytes of an activation (and of a B value in a B row)
  int M;  // N * OH * OW
  int K;  // kh * kw * Ci * E bytes of k
  int OH, OW, pt, pl, Ci, KW;
  int slices;  // Ci * E / sl
  int nk;      // kh * kw * slices k steps

  // A's BM pixels from m0 into a_dst and B's BN rows from n0 into b_dst,
  // k step s
  __device__ __forceinline__ void load(unsigned char* a_dst, unsigned char* b_dst,
                                       const CUtensorMap* tx, const CUtensorMap* tw, int m0,
                                       int n0, int s, int sl, uint64_t* bar) const {
    const int ox = m0 % OW, t = m0 / OW, oy = t % OH, img = t / OH;
    const int tap = s / slices, q = s - tap * slices;
    const int i = tap / KW, j = tap - i * KW;
    const int c0 = q * (sl / E);  // the slice's first channel
    tma_im2col(a_dst, tx, c0, ox - pl, oy - pt, img, j, i, bar);
    tma_load(b_dst, tw, tap * Ci + c0, n0, bar);
  }
};

// The loaders' operand types: the accumulator, and whether B comes as int8
// codes that the consumers convert to bf16 (kCodesB).  Named types, so that
// the kernels' names say which they run (runtime/profiling.py files them by
// it: "ConvAIm2col" under conv2d_direct, "ConvABf16" under
// conv2d_direct_float_bf16).
struct ConvAIm2col : Im2col<1> {  // int8 x, int8 weight (#3)
  using Acc = int;
  static constexpr bool kCodesB = false;
};
struct ConvABf16Im2col : Im2col<2> {  // bfloat16 x, bfloat16 weight (3f-bf16)
  using Acc = float;
  static constexpr bool kCodesB = false;
};
struct ConvABf16Im2colI8w : Im2col<2> {  // bfloat16 x, int8 weight (3f-bf16)
  using Acc = float;
  static constexpr bool kCodesB = true;
};

// The row-major (M, K) A of fused_gemm_i8i8, one tiled TMA map (dims K, M;
// row stride lda): k step s is bytes [s * sl, (s + 1) * sl) of K, of A and
// of the K-major B alike; the box's bytes past K (and rows past M or N)
// land as zeros, so a last, partial step adds nothing.
struct TiledA {
  using Acc = int;
  static constexpr bool kCodesB = false;
  static constexpr int kE = 1;
  int M;   // rows
  int K;   // bytes of k
  int nk;  // ceil(K / sl) k steps

  __device__ __forceinline__ void load(unsigned char* a_dst, unsigned char* b_dst,
                                       const CUtensorMap* ta, const CUtensorMap* tb, int m0,
                                       int n0, int s, int sl, uint64_t* bar) const {
    tma_load(a_dst, ta, s * sl, m0, bar);
    tma_load(b_dst, tb, s * sl, n0, bar);
  }
};

// the consumer warpgroups' own barrier (id 1; 0 is __syncthreads)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// one consumer warpgroup's barrier (ids 2 and 3)
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}

// the fixed bits of a wgmma shared-memory descriptor of a K-major operand:
// rows of `sl` bytes swizzled over `sl` bytes (layout 1: 128 B, 2: 64 B, 3:
// 32 B), 8-row groups 8 * sl bytes apart; desc() adds the start address
__device__ __forceinline__ uint64_t desc_bits(int sl) {
  const uint64_t layout = sl == 128 ? 1 : sl == 64 ? 2 : 3;
  return (1ull << 16) | ((uint64_t)(8 * sl >> 4) << 32) | (layout << 62);
}
__device__ __forceinline__ uint64_t desc(uint64_t bits, uint32_t addr) {
  return bits | (uint64_t)((addr & 0x3FFFF) >> 4);
}

#define WG_R8(i)                                                                   \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]), \
      "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
#define WG_R32(i) WG_R8(i), WG_R8(i + 8), WG_R8(i + 16), WG_R8(i + 24)
#define WG_F8(i)                                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_F32(i) WG_F8(i), WG_F8(i + 8), WG_F8(i + 16), WG_F8(i + 24)

// d += A (64 x 32 bytes of k, K-major) x B (32 bytes of k x N, K-major):
// int8 in, int32 sums (k32); or bf16 in, float32 sums (k16), by the
// accumulators' type
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(int (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p;\n}\n"
        : WG_R32(0)
        : "l"(a), "l"(b), "r"(1));
  }
  __device__ __forceinline__ static void mma(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : WG_F32(0)
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void mma(int (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p;\n}\n"
        : WG_R32(0), WG_R32(32)
        : "l"(a), "l"(b), "r"(1));
  }
  __device__ __forceinline__ static void mma(float (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : WG_F32(0), WG_F32(32)
        : "l"(a), "l"(b), "r"(1));
  }
};

#undef WG_R8
#undef WG_R32
#undef WG_F8
#undef WG_F32

// keeps the compiler from touching the accumulators across the async wgmma
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
using bf16wgmma::fence_regs;  // the float32 accumulators'

// an accumulator as the epilogue's float32: an exact int32 sum converted
// (epilogue.cuh's order), a float32 sum as it is
__device__ __forceinline__ float acc_float(int v) { return __int2float_rn(v); }
__device__ __forceinline__ float acc_float(float v) { return v; }

// a pair of raw sums to split K's workspace
__device__ __forceinline__ void store_pair(int* p, int a, int b) {
  *reinterpret_cast<int2*>(p) = make_int2(a, b);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Grid: persistent, units_per_block consecutive work units a block (unit
// u: tile u / splits, split u % splits; tile t: band t / m_tiles, M tile
// t % m_tiles); block size THREADS; dynamic shared memory: the ring, the
// band's scale and bias, the barriers (host: direct_smem).  ws: the (splits,
// M, Co) workspace of the loader's accumulator type (int32 or float32) when
// splits > 1, else unused.  scale may be null (1) only where the loader's B
// is bfloat16.
template <class ALoad, int BN, typename OutT>
__global__ void __launch_bounds__(THREADS, PER_SM)
i8_wgmma_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                const __grid_constant__ CUtensorMap tc, ALoad la, const float* __restrict__ scale,
                const float* __restrict__ bias, OutT* __restrict__ out,
                typename ALoad::Acc* __restrict__ ws, int Co, int sl, int stages, int splits,
                int units_per_block, int act, float lo, float hi) {
  using Acc = typename ALoad::Acc;
  // each bf16 difference below is under `if constexpr`, so that the int8
  // loaders' kernels (#3, #1ii) compile to the same SASS as without them:
  // at two blocks an SM their registers are at the cap and the 64-wide
  // tiles spill
  constexpr bool kBf16 = ALoad::kE == 2;
  constexpr int OUT_BYTES = (int)sizeof(OutT);
  constexpr int BOX_COLS = 128 / OUT_BYTES;  // C columns a TMA store box holds
  constexpr bool kStageC = ctile_bytes(BN, OUT_BYTES) > 0;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int sbytes = stage_bytes(BN);
  unsigned char* ctile = ring + stages * sbytes;
  float* sc = reinterpret_cast<float*>(ctile + ctile_bytes(BN, OUT_BYTES));  // the band's scale
  float* bi = sc + MAX_BN;                                        // and bias
  uint64_t* full = reinterpret_cast<uint64_t*>(bi + MAX_BN);
  uint64_t* empty = full + MAX_STAGES;

  // the warp index through a shuffle, so that the compiler knows it is the
  // same in every lane: wgmma on a path it takes as divergent is serialized
  // (ptxas C7520), which cost #3 7-17 % on an H100 (tools/ab_conv_direct.py)
  const int tid = threadIdx.x, warp = __shfl_sync(0xffffffffu, tid / 32, 0), lane = tid % 32;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int m_tiles = (la.M + BM - 1) / BM;
  const int units = m_tiles * ((Co + BN - 1) / BN) * splits;
  const int u0 = blockIdx.x * units_per_block;
  const int u1 = min(units, u0 + units_per_block);
  // a stage holds taps k steps (one STAGE_K-byte group of K); the splits
  // cut the groups
  const int taps = STAGE_K / sl;
  const int groups = (la.nk + taps - 1) / taps;
  const int per = (groups + splits - 1) / splits;  // groups a split

  if (warp == CONSUMERS / 32) {  // the producer
    if (lane == 0) {
      int it = 0;
      for (int u = u0; u < u1; ++u) {
        const int tile = u / splits, z = u - tile * splits;
        const int band = tile / m_tiles, mt = tile - band * m_tiles;
        const int g1 = min(groups, (z + 1) * per);
        for (int g = z * per; g < g1; ++g, ++it) {
          const Slot st = slot(it, stages);
          unsigned char* a_dst = ring + st.stage * sbytes;
          unsigned char* b_dst = a_dst + taps * BM * sl;
          const int s0 = g * taps, cnt = min(la.nk, s0 + taps) - s0;
          mbar_wait(&empty[st.stage], st.parity ^ 1);
          if constexpr (ALoad::kCodesB) {
            // an int8 weight's codes, sl / 2 bytes a row of a k step, into
            // the second half of the stage's B region
            mbar_expect(&full[st.stage], cnt * (BM * sl + BN * (sl / 2)));
            for (int t = 0; t < cnt; ++t)
              la.load(a_dst + t * BM * sl, b_dst + BN * STAGE_K / 2 + t * BN * (sl / 2), &tx,
                      &tw, mt * BM, band * BN, s0 + t, sl, &full[st.stage]);
          } else {
            mbar_expect(&full[st.stage], cnt * (BM + BN) * sl);
            for (int t = 0; t < cnt; ++t)
              la.load(a_dst + t * BM * sl, b_dst + t * BN * sl, &tx, &tw, mt * BM, band * BN,
                      s0 + t, sl, &full[st.stage]);
          }
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg multiplies rows wg * 64 ... of each tile
  const int wg = warp / 4;
  const bool has_bias = bias != nullptr;
  // a stage's K32 = STAGE_K / 32 wgmma k steps: k32 step q reads tap slice
  // q * 32 / sl of the stage, at byte (q * 32) % sl of its rows
  constexpr int K32 = STAGE_K / 32;
  const uint64_t dbits = desc_bits(sl);
  uint32_t a_off[K32], b_off[K32];
#pragma unroll
  for (int q = 0; q < K32; ++q) {
    a_off[q] = (q * 32 / sl) * BM * sl + (q * 32) % sl + wg * (BM / 2) * sl;
    b_off[q] = taps * BM * sl + (q * 32 / sl) * BN * sl + (q * 32) % sl;
  }
  // an int8 weight: this thread's 16-code chunks of a stage's codes (k step
  // t's BN rows of sl / 2 codes, t-major, as TMA lays them) and the two
  // 16-byte chunks of bf16 each becomes in its K-major row of sl bytes,
  // swizzled as TMA swizzles rows of `sl` bytes: the chunk index XOR the
  // row's address bits from bit 7, as many bits as the chunk index has
  constexpr int CHUNKS = ALoad::kCodesB ? BN * STAGE_K / 2 / 16 / CONSUMERS : 1;
  [[maybe_unused]] int cv_src[CHUNKS], cv_lo[CHUNKS], cv_hi[CHUNKS];
  if constexpr (ALoad::kCodesB) {
    const int row_chunks = sl / 32;  // 16-code chunks a row of codes
#pragma unroll
    for (int p = 0; p < CHUNKS; ++p) {
      const int c = tid + p * CONSUMERS;
      const int t = c / (BN * row_chunks), r = c / row_chunks % BN, h = c % row_chunks;
      const int swz = ((r * sl) >> 7) & (sl / 16 - 1);
      const int row = taps * BM * sl + t * BN * sl + r * sl;
      cv_src[p] = taps * BM * sl + BN * STAGE_K / 2 + c * 16;
      cv_lo[p] = row + (((2 * h) ^ swz) << 4);
      cv_hi[p] = row + (((2 * h + 1) ^ swz) << 4);
    }
  }
  int it = 0, cur = -1;
  Acc acc[BN / 2];
  for (int u = u0; u < u1; ++u) {
    const int tile = u / splits, z = u - tile * splits;
    const int band = tile / m_tiles, mt = tile - band * m_tiles, n0 = band * BN;
    if (splits == 1 && band != cur) {
      // a new band: both warpgroups are past the last epilogue's reads
      consumers_sync();
      cur = band;
      for (int j = tid; j < BN; j += CONSUMERS) {
        const int n = n0 + j;
        if constexpr (kBf16) {  // a bfloat16 weight's scale is optional
          sc[j] = n < Co ? (scale != nullptr ? scale[n] : 1.f) : 0.f;
        } else {
          sc[j] = n < Co ? scale[n] : 0.f;
        }
        bi[j] = has_bias && n < Co ? bias[n] : 0.f;
      }
      consumers_sync();
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    const int g0 = z * per, g1 = min(groups, g0 + per);
    for (int g = g0; g < g1; ++g, ++it) {
      const Slot st = slot(it, stages);
      mbar_wait(&full[st.stage], st.parity);
      if constexpr (ALoad::kCodesB) {
        // the codes to bf16 in place: every thread holds its chunks before
        // any is overwritten, and every row is written before any product
        unsigned char* stage = ring + st.stage * sbytes;
        uint4 v[CHUNKS];
#pragma unroll
        for (int p = 0; p < CHUNKS; ++p) v[p] = *reinterpret_cast<const uint4*>(stage + cv_src[p]);
        consumers_sync();
#pragma unroll
        for (int p = 0; p < CHUNKS; ++p) {
          uint4 lo, hi;
          bf16wgmma::codes_to_bf16(v[p], lo, hi);
          *reinterpret_cast<uint4*>(stage + cv_lo[p]) = lo;
          *reinterpret_cast<uint4*>(stage + cv_hi[p]) = hi;
        }
        bf16wgmma::fence_async_smem();
        consumers_sync();
      }
      const uint32_t base = smem_u32(ring + st.stage * sbytes);
      // k32 steps in this stage: all K32 but in a last, partial group
      // (TiledA: up to K's last byte, its step's zeros past K skipped)
      const int k32 = (min(la.K, (g + 1) * STAGE_K) - g * STAGE_K + 31) / 32;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int q = 0; q < K32; ++q)
        if (q < k32) Wgmma<BN>::mma(acc, desc(dbits, base + a_off[q]), desc(dbits, base + b_off[q]));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // the previous stage's products are done: it goes back to the producer
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (g > g0 && lane == 0) mbar_arrive(&empty[slot(it - 1, stages).stage]);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_regs(acc);
    if (g1 > g0 && lane == 0) mbar_arrive(&empty[slot(it - 1, stages).stage]);

    // epilogue.  Accumulator j * 4 + r: row (warp % 4) * 16 + lane / 4 (+ 8
    // for r >= 2) of this warpgroup's 64, columns j * 8 + (lane % 4) * 2
    // (+ 1 for odd r).  Co is even, so a pair is inside Co or outside.
    const int r0 = (warp % 4) * 16 + lane / 4, m_wg = mt * BM + wg * (BM / 2);
    if (splits > 1) {  // the raw sums to this split's slice of the workspace
      Acc* wz = ws + (long long)z * la.M * Co;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = n0 + j * 8 + (lane % 4) * 2;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m_wg + r0 + h * 8;
          if (n < Co && m < la.M)
            store_pair(wz + (long long)m * Co + n, acc[j * 4 + h * 2], acc[j * 4 + h * 2 + 1]);
        }
      }
      continue;
    }
    if constexpr (!kStageC) {  // from the accumulators, pairs inside M and Co
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int jn = j * 8 + (lane % 4) * 2, n = n0 + jn;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m_wg + r0 + h * 8;
          if (n >= Co || m >= la.M) continue;
          float v0 = __fmul_rn(acc_float(acc[j * 4 + h * 2]), sc[jn]);
          float v1 = __fmul_rn(acc_float(acc[j * 4 + h * 2 + 1]), sc[jn + 1]);
          if (has_bias) {
            v0 = __fadd_rn(v0, bi[jn]);
            v1 = __fadd_rn(v1, bi[jn + 1]);
          }
          v0 = gemm::activate(v0, act, lo, hi);
          v1 = gemm::activate(v1, act, lo, hi);
          OutT* p = out + (long long)m * Co + n;
          if constexpr (std::is_same<OutT, float>::value) {
            *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
          } else {
            *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
          }
        }
      }
      continue;
    }
    // the warpgroup's last TMA store has read its C tile
    unsigned char* cw = ctile + wg * (BM / 2) * BN * OUT_BYTES;
    if (tid % 128 == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    warpgroup_sync(wg);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int jn = j * 8 + (lane % 4) * 2;
      const int box = jn / BOX_COLS, byte = (jn % BOX_COLS) * OUT_BYTES;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + h * 8;
        float v0 = __fmul_rn(acc_float(acc[j * 4 + h * 2]), sc[jn]);
        float v1 = __fmul_rn(acc_float(acc[j * 4 + h * 2 + 1]), sc[jn + 1]);
        if (has_bias) {
          v0 = __fadd_rn(v0, bi[jn]);
          v1 = __fadd_rn(v1, bi[jn + 1]);
        }
        v0 = gemm::activate(v0, act, lo, hi);
        v1 = gemm::activate(v1, act, lo, hi);
        unsigned char* p = cw + box * (BM / 2) * 128 + r * 128 +
                           ((((byte >> 4) ^ (r & 7))) << 4) + (byte & 15);
        if constexpr (std::is_same<OutT, float>::value) {
          *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
        }
      }
    }
    bf16wgmma::fence_async_smem();
    warpgroup_sync(wg);
    if (tid % 128 == 0 && m_wg < la.M) {  // the store clips rows past M, columns past Co
#pragma unroll
      for (int b = 0; b < BN / BOX_COLS; ++b)
        if (n0 + b * BOX_COLS < Co) tma_store(&tc, cw + b * (BM / 2) * 128, n0 + b * BOX_COLS, m_wg);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  if (kStageC && tid % 128 == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// cuTensorMapEncodeIm2col, looked up through the CUDA runtime as
// bf16_wgmma.cuh looks up the tiled encoder
using EncodeIm2col = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const int*, const int*,
                                  cuuint32_t, cuuint32_t, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeIm2col im2col_encoder() {
  static const EncodeIm2col fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeIm2col", &p,
                                                             12000, cudaEnableDefault, &q);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeIm2col", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess ? (EncodeIm2col)p : nullptr;
  }();
  return fn;
}

inline CUtensorMapSwizzle swizzle_of(int sl) {
  return sl == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                   : sl == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
}

template <class ALoad, int BN, typename OutT>
int launch_bn(const CUtensorMap& tx, const CUtensorMap& tw, const CUtensorMap& tc,
              const ALoad& la, const void* scale, const void* bias, void* out, void* ws, int Co,
              int sl, int stages, int splits, int grid, int act, float lo, float hi,
              cudaStream_t s) {
  using Acc = typename ALoad::Acc;
  const int smem = SMEM_EXTRA + stages * stage_bytes(BN) + ctile_bytes(BN, (int)sizeof(OutT));
  const auto kernel = i8_wgmma_kernel<ALoad, BN, OutT>;
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
  const int units = ((la.M + BM - 1) / BM) * ((Co + BN - 1) / BN) * splits;
  const int per_block = (units + grid - 1) / grid;
  Acc* w = static_cast<Acc*>(ws);
  kernel<<<(units + per_block - 1) / per_block, THREADS, smem, s>>>(
      tx, tw, tc, la, static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<OutT*>(out), w, Co, sl, stages, splits, per_block, act, lo, hi);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const i8mma::SplitGrid g{dim3(1), splits, cudaSuccess};
  return i8mma::finish<Acc, OutT>(g, w, la.M, Co, scale, bias, out, act, lo, hi, s);
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// What the entries check: the plan's values, C's rows (Co a multiple of 4
// float32 or 8 bf16 values: TMA row strides), the bases, the workspace, a
// scale where the weight needs one.  `groups` is the stages' worth of k
// that splits cut.
inline bool plan_ok(bool out_bf16, int Co, int bn, int stages, int splits, int groups, int grid,
                    const void* ws, bool has_scale, bool need_scale, const void* out) {
  return (bn == 64 || bn == 128) && Co >= bn && Co % (out_bf16 ? 8 : 4) == 0 && stages >= 2 &&
         stages <= MAX_STAGES && grid >= 1 && splits >= 1 && splits <= groups &&
         (splits == 1 || ws != nullptr) && (has_scale || !need_scale) && aligned16(out);
}

// The B map (the K-major (Co, K) matrix: int8 or bfloat16 values in boxes
// of bn rows of `sl` bytes, the swizzle of `sl`; an int8 weight of a
// bfloat16 conv in boxes of bn rows of sl / 2 codes, unswizzled), the C map
// (boxes of 128 bytes of columns by 64 rows), then the launch of the
// loader's kernel at the plan's tile width and output type (bfloat16 only
// for bfloat16 activations).
template <class ALoad>
int encode_and_launch(const CUtensorMap& tx, const ALoad& la, const void* wmat,
                      const void* scale, const void* bias, void* out, bool out_bf16, int Co,
                      int act, float lo, float hi, int bn, int sl, int stages, int splits,
                      int grid, void* ws, void* stream) {
  constexpr int E = ALoad::kE;
  constexpr bool kBf16B = E == 2 && !ALoad::kCodesB;
  CUtensorMap tw, tc;
  const int kv = la.K / E;  // values of k a row of B
  if (!bf16wgmma::encode(&tw, kBf16B ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                         kBf16B ? 2 : 1, wmat, kv, Co, kv, sl / E, bn,
                         ALoad::kCodesB ? CU_TENSOR_MAP_SWIZZLE_NONE : swizzle_of(sl)))
    return (int)cudaErrorInvalidValue;
  const int ob = out_bf16 ? 2 : 4;
  if (!bf16wgmma::encode(&tc, out_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                         ob, out, Co, la.M, Co, 128 / ob, BM / 2, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if constexpr (E == 1) {
#define I8_WGMMA_CASE(BN_)                                                                    \
  if (bn == BN_)                                                                              \
    return out_bf16 ? launch_bn<ALoad, BN_, __nv_bfloat16>(tx, tw, tc, la, scale, bias, out,  \
                                                           ws, Co, sl, stages, splits, grid, \
                                                           act, lo, hi, s)                   \
                    : launch_bn<ALoad, BN_, float>(tx, tw, tc, la, scale, bias, out, ws, Co, \
                                                   sl, stages, splits, grid, act, lo, hi, s);
    I8_WGMMA_CASE(64)
    I8_WGMMA_CASE(128)
#undef I8_WGMMA_CASE
  } else {
    if (!out_bf16) return (int)cudaErrorInvalidValue;
    if (bn == 64)
      return launch_bn<ALoad, 64, __nv_bfloat16>(tx, tw, tc, la, scale, bias, out, ws, Co, sl,
                                                 stages, splits, grid, act, lo, hi, s);
    if (bn == 128)
      return launch_bn<ALoad, 128, __nv_bfloat16>(tx, tw, tc, la, scale, bias, out, ws, Co, sl,
                                                  stages, splits, grid, act, lo, hi, s);
  }
  return (int)cudaErrorInvalidValue;
}

// A stride-1 conv on the loader's E-byte activations: x NHWC (N, H, W, Ci),
// wmat the K-major (Co, KH*KW*Ci) matrix, out NHWC (N, OH, OW, Co) float32
// or bfloat16 (out_bf16); bn in {64, 128}, sl in {32, 64, 128} bytes, a
// whole number of channels dividing Ci, stages in [2, MAX_STAGES], splits in
// [1, stages' worth of k] (ws a (splits, M, Co) workspace of the
// accumulator type when above 1), grid the most blocks to launch (the
// host's plan).  Returns a cudaError: cudaErrorInvalidValue for arguments
// the loop does not take or a tensor map that the driver refuses.
template <class ALoad>
int conv_launch(const void* x, const void* wmat, const void* scale, const void* bias, void* out,
                bool out_bf16, int N, int H, int W, int Ci, int Co, int KH, int KW, int OH,
                int OW, int pt, int pl, int act, float lo, float hi, int bn, int sl, int stages,
                int splits, int grid, void* ws, void* stream) {
  constexpr int E = ALoad::kE;
  const long long M = (long long)N * OH * OW;
  if (M == 0 || Co == 0) return (int)cudaGetLastError();
  const int pb = OH - H - pt + KH - 1, pr = OW - W - pl + KW - 1;
  const int slices =
      (sl == 128 || sl == 64 || sl == 32) && Ci % (sl / E) == 0 ? Ci / (sl / E) : 0;
  const int nk = KH * KW * slices;
  const int groups = slices == 0 ? 0 : (nk + STAGE_K / sl - 1) / (STAGE_K / sl);
  const bool need_scale = std::is_same<typename ALoad::Acc, int>::value || ALoad::kCodesB;
  if (slices == 0 || M > 0x7fffffffLL || KH < 1 || KW < 1 || KH > 64 || KW > 64 || pt < 0 ||
      pl < 0 || pb < 0 || pr < 0 || pt > 64 || pl > 64 || pb > 64 || pr > 64 ||
      !plan_ok(out_bf16, Co, bn, stages, splits, groups, grid, ws, scale != nullptr, need_scale,
               out) ||
      !aligned16(x) || !aligned16(wmat))
    return (int)cudaErrorInvalidValue;
  const EncodeIm2col enc = im2col_encoder();
  if (enc == nullptr) return (int)cudaErrorInvalidValue;
  CUtensorMap tx;
  const cuuint64_t dims[4] = {(cuuint64_t)Ci, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)N};
  const cuuint64_t strides[3] = {(cuuint64_t)Ci * E, (cuuint64_t)W * Ci * E,
                                 (cuuint64_t)H * W * Ci * E};
  const int lower[2] = {-pl, -pt};
  const int upper[2] = {pr - (KW - 1), pb - (KH - 1)};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  if (enc(&tx, E == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
          const_cast<void*>(x), dims, strides, lower, upper, (cuuint32_t)(sl / E),
          (cuuint32_t)BM, one, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_of(sl),
          CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  const ALoad la{{(int)M, KH * KW * Ci * E, OH, OW, pt, pl, Ci, KW, slices, nk}};
  return encode_and_launch(tx, la, wmat, scale, bias, out, out_bf16, Co, act, lo, hi, bn, sl,
                           stages, splits, grid, ws, stream);
}

// The int8 conv (#3, #3-bf16): x int8, wmat the K-major int8 matrix, scale
// required; sl divides Ci; ws int32.
inline int launch(const void* x, const void* wmat, const void* scale, const void* bias,
                  void* out, bool out_bf16, int N, int H, int W, int Ci, int Co, int KH, int KW,
                  int OH, int OW, int pt, int pl, int act, float lo, float hi, int bn, int sl,
                  int stages, int splits, int grid, void* ws, void* stream) {
  return conv_launch<ConvAIm2col>(x, wmat, scale, bias, out, out_bf16, N, H, W, Ci, Co, KH, KW,
                                  OH, OW, pt, pl, act, lo, hi, bn, sl, stages, splits, grid, ws,
                                  stream);
}

// fused_gemm_i8i8 on this loop: A (M, K) int8 with row stride lda, B the
// K-major (N, K) int8 matrix, C (M, N) float32 or bfloat16 (out_bf16); K
// and lda multiples of 16 (TMA row strides), lda >= K, A, B and C 16-byte
// aligned; the plan's values as for launch (sl any of 32, 64, 128: the
// last k step's bytes past K are zeros).  Returns a cudaError as launch.
inline int launch_gemm(const void* A, const void* B, const void* scale, const void* bias,
                       void* C, bool out_bf16, int M, int N, int K, int lda, int act, float lo,
                       float hi, int bn, int sl, int stages, int splits, int grid, void* ws,
                       void* stream) {
  if (M == 0 || N == 0) return (int)cudaGetLastError();
  const bool sl_ok = sl == 128 || sl == 64 || sl == 32;
  const int nk = sl_ok ? (K + sl - 1) / sl : 0;
  const int groups = sl_ok ? (nk + STAGE_K / sl - 1) / (STAGE_K / sl) : 0;
  if (!sl_ok || M < 0 || K < 16 || K % 16 || lda < K || lda % 16 ||
      !plan_ok(out_bf16, N, bn, stages, splits, groups, grid, ws, scale != nullptr, true, C) ||
      !aligned16(A) || !aligned16(B))
    return (int)cudaErrorInvalidValue;
  CUtensorMap ta;  // A: boxes of BM rows of `sl` bytes, the swizzle wgmma reads
  if (!bf16wgmma::encode(&ta, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, A, K, M, lda, sl, BM,
                         swizzle_of(sl)))
    return (int)cudaErrorInvalidValue;
  const TiledA la{M, K, nk};
  return encode_and_launch(ta, la, B, scale, bias, C, out_bf16, N, act, lo, hi, bn, sl, stages,
                           splits, grid, ws, stream);
}

}  // namespace i8wgmma
