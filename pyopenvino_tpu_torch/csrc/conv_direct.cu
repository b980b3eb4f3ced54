// conv_direct.cu: a stride-1, dilation-1 convolution for Hopper (sm_90a) with
// no patch matrix in device memory, in three entries:
//   * conv2d_direct_i8: int8 codes by int8 weights,
//     out[n, y, x, co] = act(float(sum_{i,j,c} X[n, y+i-pt, x+j-pl, c] * W[i,j,c,co])
//                            * scale[co] + bias[co]);
//   * conv2d_direct_f32: float32 activations by a float32 weight, or by an
//     int8 weight whose (Co,) scale multiplies the float32 sum,
//     out[n, y, x, co] = act((sum_{i,j,c} X[n, y+i-pt, x+j-pl, c] * W[i,j,c,co])
//                            * scale[co] + bias[co]), scale optional;
//   * conv2d_direct_bf16: the same on bfloat16 activations, by a bfloat16
//     weight or an int8 one (its codes exact in bfloat16), the sum in
//     float32, the epilogue in float32, rounded once to a bfloat16 out.
//
// X is NHWC (N, H, W, Ci), out NHWC (N, OH, OW, Co), float32 (the int8 entry: or
// bfloat16; the bfloat16 entry: bfloat16), with
// OH = H + pt + pb - kh + 1, OW = W + pl + pr - kw + 1.  The weight is the
// GEMM operand of an OIHW weight with features ordered (i, j, c): K-major
// for int8 x, the (Co, kh*kw*Ci) contiguous matrix (row co holds column co
// of the (K, Co) product operand); row-major (kh*kw*Ci, Co) for float x.
//
// Replaces the Pallas TPU kernel pyopenvino_tpu/kernels/conv_direct.py::
// conv2d_direct (body _kernel, conv_direct.py:33-73; pallas_call at :138) in
// its variants: kh*kw shifted dots, an exact int32 sum for int8 codes
// (:49-50) or a float32 sum with an int8 weight cast to the activations'
// type (:51-62), at HIGHEST precision for float32 x and DEFAULT (one bf16
// pass) for bfloat16 x, then the scale, bias and activation epilogue
// (:64-71), written in out_dtype (default x's dtype, :95).
//
// What bounds it on an H100 SXM: int8 tensor cores reach 1,979 TOPS dense
// and device memory moves 3.35 TB/s.  At ResNet-18's 3x3 shapes (Ci = Co =
// 64 ... 512) a conv does 2*kh*kw*Ci = 1152 ... 9216 operations per output
// value against 1 byte in and 4 bytes out (each input read once, not its
// kh*kw-fold patch matrix), plus the weight.  So the card's roof is its
// bytes at every ResNet-18 shape at batch 1 and at 56x56 and 28x28 in a
// batch of 64, and its operations at 14x14 and 7x7 in a batch of 64.  The
// float32 entry's cheapest float32-accurate product is three bf16 passes
// (989 TFLOP/s dense, 330 of useful work); its own route, three TF32
// passes (495 TFLOP/s, 165 useful), or two against an int8 weight, is
// bound by its operations at every ResNet-18 3x3 shape in a batch of 64
// (3456 ... 27648 TF32 operations per 4-byte output value).  The bfloat16
// entry does one bf16 pass (989 TFLOP/s dense) against 2 bytes in and 2
// out a value: bound by its operations at ResNet-18's 3x3 shapes in a
// batch of 64 (about 290 operations a byte is the card's line).
//
// Both entries are implicit GEMMs, M = N*OH*OW output pixels by Co, K =
// kh*kw*Ci, on a tensor-core loop of this package, with split-K and an
// exact or fixed-order reduction for small grids (kernels/gemm.py::
// split_k):
//   * int8: i8_mma.cuh's int8 mma.sync loop (128 x 64 tiles, a 3-stage
//     cp.async ring, 64-byte slices of k), A read by ConvA below; or, where
//     kernels/conv_direct.py::direct_route sends a launch (Ci a multiple
//     of 32, enough output pixels), i8_wgmma.cuh's int8 wgmma loop, A by
//     TMA in im2col mode (conv2d_direct_i8_wgmma, its own design note);
//   * float32: f32_mma.cuh's TF32 mma.sync loop (64 x 64 tiles, 32 values
//     of k a stage), A read by ConvAF32 below, each value split in a hi
//     and a lo TF32 term; a float32 weight is split too (three passes,
//     BFloat), an int8 weight is exact in TF32 (two passes, BInt8, its
//     scale multiplying the finished sum).  See its design note;
//   * bfloat16: bf16_mma.cuh's bf16 mma.sync loop (64 x 64 tiles, 32
//     values of k a stage, one pass, float32 sums), A read by ConvABf16
//     below, a bfloat16 weight by ldmatrix.trans (BBf16), an int8 one
//     converted to bfloat16 as its fragments are read (BInt8); or, where
//     kernels/conv_direct.py::direct_bf16_route sends a launch (Ci a
//     multiple of 16, enough work), i8_wgmma.cuh's loop on bf16 operands
//     (bf16 wgmma, A by TMA in im2col mode, the K-major weight matrix, an
//     int8 weight converted to bf16 in shared memory;
//     conv2d_direct_bf16_wgmma, i8_wgmma.cuh's design note).
// The TPU kernel keeps one whole padded example in VMEM
// (conv_direct.py:113-121); on Hopper one 58 x 58 x 64 int8 example is
// already 215 KB, so the rings instead stream slices of k of a tile's
// output rows, gathered straight from the NHWC input by the loaders:
//   * each thread finds the (n, oy - pt, ox - pl) of its A rows once;
//   * k maps to its tap (i, j) and channel c by two divisions by run-time
//     constants (Ci, kw), each a multiply-high and a shift (FastDiv, magic
//     numbers found on the host); a thread's rows share them, and the
//     offset (i*W + j)*Ci + c is a 32-bit integer added to the row's;
//   * int8: with Ci % 16 == 0 (every ResNet-18 launch) a 16-byte chunk of
//     k lies in one tap and is one cp.async.cg; with Ci % 4 == 0 four
//     4-byte ones; other Ci (the Ci = 3 stems) take the loop's byte path;
//   * float32: with Ci % 4 == 0 (every ResNet-18 launch) a 4-value chunk
//     of k lies in one tap and is one 16-byte cp.async.cg; other Ci take
//     one 4-byte cp.async.ca per value;
//   * bfloat16: with Ci % 8 == 0 an 8-value chunk of k lies in one tap and
//     is one 16-byte cp.async.cg; other Ci are read value by value into
//     registers and stored to the stage at once;
//   * padding, k >= K and rows beyond M are read as zero through
//     cp.async's src-size 0 (the address handed over is then x itself), so
//     no padded copy is made;
//   * B is the (kh*kw*Ci, Co) weight matrix: K-major for int8 x, as the
//     int8 mma's B fragment needs (the compiled network caches that copy
//     in place of the row-major one); row-major for float x.
// The int32 sum is exact (K <= 4608, |sum| < 2^27) and the epilogue is
// epilogue.cuh's __fmul_rn then __fadd_rn, so the int8 entry's output is
// bit-identical to the plain version; the float32 entry's is within 1e-4 of
// max |plain| (three or two TF32 terms, the card tests and chip_smoke.py
// hold it there up to K = 4608) and the bfloat16 entry's within one
// bfloat16 step of it (or of the float32 sums' own error where a sum
// cancels), both the same bits on every call (split K adds its partial
// sums in a fixed order).

#include <cuda_runtime.h>

#include <cstdint>

#include "bf16_mma.cuh"
#include "f32_mma.cuh"
#include "i8_mma.cuh"
#include "i8_wgmma.cuh"

namespace {

// n / d for 0 <= n < 2^31 and a divisor d >= 1 fixed at launch: a
// multiply-high and a shift by a magic number found on the host (round-up
// method: p = 31 + ceil(log2 d), mul = ceil(2^p / d)).
struct FastDiv {
  unsigned mul;
  int shr, d;

  FastDiv() = default;
  explicit FastDiv(int d_) : mul(0), shr(0), d(d_) {
    if (d == 1) return;
    int l = 0;
    while ((1u << l) < (unsigned)d) ++l;
    mul = (unsigned)(((1ull << (31 + l)) + d - 1) / d);
    shr = l - 1;
  }

  __device__ __forceinline__ int operator()(int n) const {
    return d == 1 ? n : (int)(__umulhi((unsigned)n, mul) >> shr);
  }
};

// The implicit (N*OH*OW, kh*kw*Ci) im2col matrix of an NHWC int8 input, as
// an A loader of i8_mma.cuh (its contract: i8_mma.cuh, above RowMajor).
struct ConvA {
  const int8_t* x;
  long long M;  // N * OH * OW
  int H, W, Ci, KW, OH, OW, pt, pl, K;
  FastDiv by_ci, by_kw;
  bool vec16;  // Ci % 16 == 0 and x 16-byte aligned: a 16-byte chunk is in one tap
  bool vec4;   // Ci % 4 == 0 and x 4-byte aligned

  struct Row {
    int o;         // offset of X[n, iy0, ix0, 0] (negative where padded)
    int iy0, ix0;  // input coordinates of tap (0, 0)
    bool valid;
  };
  struct Tap {
    int i, j, off;  // tap of column k and the offset (i*W + j)*Ci + c
  };

  __device__ Row row(long long m) const {
    if (m >= M) return {0, 0, 0, false};
    const int ox = (int)(m % OW);
    const long long t = m / OW;
    const int oy = (int)(t % OH);
    const long long n = t / OH;
    const int iy0 = oy - pt, ix0 = ox - pl;
    return {(int)(((n * H + iy0) * W + ix0) * Ci), iy0, ix0, true};
  }

  __device__ __forceinline__ Tap tap(int k) const {
    const int t = by_ci(k), c = k - t * Ci;
    const int i = by_kw(t), j = t - i * KW;
    return {i, j, (i * W + j) * Ci + c};
  }

  // k < K, the row valid and its tap inside the input (not padding)
  __device__ __forceinline__ bool inside(const Row& r, int k, const Tap& t) const {
    return r.valid && k < K && (unsigned)(r.iy0 + t.i) < (unsigned)H &&
           (unsigned)(r.ix0 + t.j) < (unsigned)W;
  }

  __device__ int group(const Row& r, int k) const {
    int b[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const Tap t = tap(k + q);
      b[q] = inside(r, k + q, t) ? __ldg(x + (r.o + t.off)) : 0;
    }
    return i8mma::pack4(b[0], b[1], b[2], b[3]);
  }

  __device__ const int8_t* chunk(const Row& r, int k) const {
    const Tap t = tap(k);
    return inside(r, k, t) ? x + (r.o + t.off) : x;
  }
  __device__ int chunk_bytes(const Row& r, int k) const {
    return inside(r, k, tap(k)) ? (vec16 ? 16 : 4) : 0;
  }
};

// The same implicit matrix of a float NHWC input: float32 as an A loader of
// f32_mma.cuh (its contract: f32_mma.cuh, above RowMajorF32), bfloat16 as
// one of bf16_mma.cuh (above RowMajorBf16; load8).  An invalid row or
// column carries a coordinate far outside the input, so one test of the
// tap's input coordinates says whether a value is read.
template <class T>
struct ConvAFloat {
  static constexpr int CHUNK = 16 / (int)sizeof(T);  // values in one 16-byte chunk

  const T* x;
  long long M;  // N * OH * OW
  int H, W, Ci, KW, OH, OW, pt, pl, K;
  FastDiv by_ci, by_kw;
  bool vec16;  // Ci % CHUNK == 0 and x 16-byte aligned: a 16-byte chunk is in one tap

  static constexpr int FAR = 1 << 29;  // |coordinate| of rows >= M and columns >= K

  struct Row {
    int o;         // offset of X[n, iy0, ix0, 0] (negative where padded)
    int iy0, ix0;  // input coordinates of tap (0, 0); iy0 = -2 FAR beyond M
  };
  struct Col {
    int i, j, off;  // tap of column k (i = FAR beyond K), (i*W + j)*Ci + c
  };

  __device__ Row row(long long m) const {
    if (m >= M) return {0, -2 * FAR, 0};
    const int ox = (int)(m % OW);
    const long long t = m / OW;
    const int oy = (int)(t % OH);
    const long long n = t / OH;
    const int iy0 = oy - pt, ix0 = ox - pl;
    return {(int)(((n * H + iy0) * W + ix0) * Ci), iy0, ix0};
  }

  __device__ __forceinline__ Col col(int k) const {
    const int t = by_ci(k), c = k - t * Ci;
    const int i = by_kw(t), j = t - i * KW;
    return {k < K ? i : FAR, j, (i * W + j) * Ci + c};
  }

  // the row valid, k < K and the tap inside the input (not padding)
  __device__ __forceinline__ bool inside(const Row& r, const Col& c) const {
    return (unsigned)(r.iy0 + c.i) < (unsigned)H && (unsigned)(r.ix0 + c.j) < (unsigned)W;
  }

  __device__ const T* chunk(const Row& r, const Col& c) const {
    return inside(r, c) ? x + (r.o + c.off) : x;
  }
  __device__ int chunk_bytes(const Row& r, const Col& c) const {
    return inside(r, c) ? (vec16 ? 16 : (int)sizeof(T)) : 0;
  }

  // bf16_mma.cuh's A load: the 8 bfloat16 values of row r from column k,
  // one 16-byte cp.async where they lie in one tap (vec16), else value by
  // value through registers (the Ci = 3 stems, Ci % 8 != 0)
  __device__ __forceinline__ void load8(T* dst, const Row& r, int k) const {
    static_assert(sizeof(T) == 2, "load8 reads 2-byte values");
    if (vec16) {
      const Col c = col(k);
      i8mma::cp_async16(dst, chunk(r, c), chunk_bytes(r, c));
    } else {
      const unsigned short* src = reinterpret_cast<const unsigned short*>(x);
      unsigned short v[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const Col c = col(k + q);
        v[q] = inside(r, c) ? __ldg(src + (r.o + c.off)) : 0;
      }
      uint4 u;
      u.x = v[0] | (unsigned)v[1] << 16;
      u.y = v[2] | (unsigned)v[3] << 16;
      u.z = v[4] | (unsigned)v[5] << 16;
      u.w = v[6] | (unsigned)v[7] << 16;
      *reinterpret_cast<uint4*>(dst) = u;
    }
  }
};

// named types (not aliases), so that the kernels' names say which loader
// they run (runtime/profiling.py files them by it)
struct ConvAF32 : ConvAFloat<float> {};
struct ConvABf16 : ConvAFloat<__nv_bfloat16> {};

}  // namespace

// Plain C interface for ctypes.  wmat is K-major: the (Co, kh*kw*Ci)
// contiguous int8 matrix.  scale is required, bias may be null.  out is
// float32, or bfloat16 when out_bf16 != 0 (the TPU kernel's out_dtype, the
// compute dtype: conv_direct.py:95), rounded once after the epilogue.  kchunk: k
// per split, a multiple of 64 (K or more for one split); ws: an int32
// workspace of ceil(K / kchunk) * N*OH*OW * Co values when that is above 1.
// Launches on `stream` and does not synchronise.  Returns cudaGetLastError()
// after the launch: 0 when the launch was accepted.
extern "C" int conv2d_direct_i8(const void* x, const void* wmat, const void* scale,
                                const void* bias, void* out, int out_bf16, int N, int H, int W,
                                int Ci,
                                int Co, int KH, int KW, int OH, int OW, int pt, int pl,
                                int act, float lo, float hi, int kchunk, void* ws,
                                void* stream) {
  const long long M = (long long)N * OH * OW;
  const int K = KH * KW * Ci;
  const auto x_addr = reinterpret_cast<std::uintptr_t>(x);
  const auto w_addr = reinterpret_cast<std::uintptr_t>(wmat);
  const ConvA la{static_cast<const int8_t*>(x), M, H, W, Ci, KW, OH, OW, pt, pl, K,
                 FastDiv(Ci), FastDiv(KW), Ci % 16 == 0 && x_addr % 16 == 0,
                 Ci % 4 == 0 && x_addr % 4 == 0};
  const i8mma::RowMajor lb{static_cast<const int8_t*>(wmat), (long long)K, (long long)Co, K,
                           w_addr % 16 == 0 && K % 16 == 0, w_addr % 4 == 0 && K % 4 == 0};
  return i8mma::launch(la, lb, scale, bias, out, out_bf16 != 0, M, Co, K, kchunk, ws, act, lo,
                       hi, stream);
}

// The same function on i8_wgmma.cuh's loop (int8 wgmma, A by TMA in im2col
// mode), the arguments as conv2d_direct_i8's up to hi, then the plan
// (kernels/conv_direct.py::direct_plan): bn the tile's N (64 or 128), sl
// the channels of a k step (32, 64 or 128, dividing Ci), the ring's stages,
// the K splits (ws an int32 workspace of splits * N*OH*OW * Co values when
// above 1), grid the most persistent blocks.  Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a shape or a tensor map the loop does not take.
extern "C" int conv2d_direct_i8_wgmma(const void* x, const void* wmat, const void* scale,
                                      const void* bias, void* out, int out_bf16, int N, int H,
                                      int W, int Ci, int Co, int KH, int KW, int OH, int OW,
                                      int pt, int pl, int act, float lo, float hi, int bn, int sl,
                                      int stages, int splits, int grid, void* ws, void* stream) {
  return i8wgmma::launch(x, wmat, scale, bias, out, out_bf16 != 0, N, H, W, Ci, Co, KH, KW, OH,
                         OW, pt, pl, act, lo, hi, bn, sl, stages, splits, grid, ws, stream);
}

// Float32 activations.  w_int8 != 0: wmat is the row-major (kh*kw*Ci, Co)
// int8 matrix and scale (required) dequantizes the sum per output channel;
// otherwise wmat is float32 and scale may be null.  bias may be null.
// kchunk: k per split, a multiple of 32 (K or more for one split); ws: a
// float32 workspace of ceil(K / kchunk) * N*OH*OW * Co values when that is
// above 1.  Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() after the launch.
extern "C" int conv2d_direct_f32(const void* x, const void* wmat, int w_int8,
                                 const void* scale, const void* bias, void* out, int N,
                                 int H, int W, int Ci, int Co, int KH, int KW, int OH,
                                 int OW, int pt, int pl, int act, float lo, float hi,
                                 int kchunk, void* ws, void* stream) {
  const long long M = (long long)N * OH * OW;
  const int K = KH * KW * Ci;
  const auto x_addr = reinterpret_cast<std::uintptr_t>(x);
  const auto w_addr = reinterpret_cast<std::uintptr_t>(wmat);
  const ConvAF32 la{{static_cast<const float*>(x), M, H, W, Ci, KW, OH, OW, pt, pl, K,
                     FastDiv(Ci), FastDiv(KW), Ci % 4 == 0 && x_addr % 16 == 0}};
  if (w_int8) {
    if (scale == nullptr) return (int)cudaErrorInvalidValue;
    const f32mma::BInt8 bl{{static_cast<const int8_t*>(wmat), (long long)Co, (long long)K, Co,
                            w_addr % 16 == 0 && Co % 16 == 0, w_addr % 4 == 0 && Co % 4 == 0}};
    return f32mma::launch(la, bl, scale, bias, out, M, Co, K, kchunk, ws, act, lo, hi, stream);
  }
  const f32mma::BFloat bl{static_cast<const float*>(wmat), Co, K,
                          w_addr % 16 == 0 && Co % 4 == 0};
  return f32mma::launch(la, bl, scale, bias, out, M, Co, K, kchunk, ws, act, lo, hi, stream);
}

// bfloat16 activations (kernel 3f-bf16): x NHWC bfloat16, out NHWC bfloat16
// (the epilogue in float32, rounded once).  w_int8 != 0: wmat is the
// row-major (kh*kw*Ci, Co) int8 matrix, its codes converted to bfloat16
// exactly, and scale (required) dequantizes the sum per output channel;
// otherwise wmat is bfloat16 and scale may be null.  bias may be null.
// kchunk: k per split, a multiple of 32 (K or more for one split); ws: a
// float32 workspace of ceil(K / kchunk) * N*OH*OW * Co values when that is
// above 1.  Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() after the launch.
extern "C" int conv2d_direct_bf16(const void* x, const void* wmat, int w_int8,
                                  const void* scale, const void* bias, void* out, int N,
                                  int H, int W, int Ci, int Co, int KH, int KW, int OH,
                                  int OW, int pt, int pl, int act, float lo, float hi,
                                  int kchunk, void* ws, void* stream) {
  const long long M = (long long)N * OH * OW;
  const int K = KH * KW * Ci;
  const auto x_addr = reinterpret_cast<std::uintptr_t>(x);
  const auto w_addr = reinterpret_cast<std::uintptr_t>(wmat);
  const ConvABf16 la{{static_cast<const __nv_bfloat16*>(x), M, H, W, Ci, KW, OH, OW, pt, pl,
                      K, FastDiv(Ci), FastDiv(KW),
                      Ci % ConvABf16::CHUNK == 0 && x_addr % 16 == 0}};
  if (w_int8) {
    if (scale == nullptr) return (int)cudaErrorInvalidValue;
    const bf16mma::BInt8 bl{{static_cast<const int8_t*>(wmat), (long long)Co, (long long)K, Co,
                             w_addr % 16 == 0 && Co % 16 == 0, w_addr % 4 == 0 && Co % 4 == 0}};
    return bf16mma::launch(la, bl, scale, bias, out, M, Co, K, kchunk, ws, act, lo, hi, stream);
  }
  const bf16mma::BBf16 bl{{static_cast<const __nv_bfloat16*>(wmat), (long long)Co, (long long)K,
                           Co, w_addr % 16 == 0 && Co % 8 == 0}};
  return bf16mma::launch(la, bl, scale, bias, out, M, Co, K, kchunk, ws, act, lo, hi, stream);
}

// The same function on i8_wgmma.cuh's loop (bf16 wgmma into float32 sums, A
// by TMA in im2col mode), the arguments as conv2d_direct_bf16's up to hi,
// except that wmat is K-major: the (Co, kh*kw*Ci) contiguous bfloat16 or
// (w_int8) int8 matrix; then the plan (kernels/conv_direct.py::
// direct_bf16_plan): bn the tile's N (64 or 128), sl the bytes of a k step
// (128, 64 or 32: 64, 32 or 16 channels, dividing Ci), the ring's stages,
// the K splits (ws a float32 workspace of splits * N*OH*OW * Co values when
// above 1, added in split order), grid the most persistent blocks.
// Launches on `stream`, does not synchronise, and returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for a shape or a tensor map the
// loop does not take.
extern "C" int conv2d_direct_bf16_wgmma(const void* x, const void* wmat, int w_int8,
                                        const void* scale, const void* bias, void* out, int N,
                                        int H, int W, int Ci, int Co, int KH, int KW, int OH,
                                        int OW, int pt, int pl, int act, float lo, float hi,
                                        int bn, int sl, int stages, int splits, int grid,
                                        void* ws, void* stream) {
  // instantiated here only: fused_gemm.cu, which includes the same header,
  // builds no bfloat16 conv
  return w_int8 ? i8wgmma::conv_launch<i8wgmma::ConvABf16Im2colI8w>(
                      x, wmat, scale, bias, out, true, N, H, W, Ci, Co, KH, KW, OH, OW, pt, pl,
                      act, lo, hi, bn, sl, stages, splits, grid, ws, stream)
                : i8wgmma::conv_launch<i8wgmma::ConvABf16Im2col>(
                      x, wmat, scale, bias, out, true, N, H, W, Ci, Co, KH, KW, OH, OW, pt, pl,
                      act, lo, hi, bn, sl, stages, splits, grid, ws, stream);
}
