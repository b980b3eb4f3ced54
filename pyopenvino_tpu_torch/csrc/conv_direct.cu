// conv_direct.cu: a stride-1, dilation-1 convolution for Hopper (sm_90a) with
// no patch matrix in device memory, in two entries:
//   * conv2d_direct_i8: int8 codes by int8 weights,
//     out[n, y, x, co] = act(float(sum_{i,j,c} X[n, y+i-pt, x+j-pl, c] * W[i,j,c,co])
//                            * scale[co] + bias[co]);
//   * conv2d_direct_f32: float32 activations by a float32 weight, or by an
//     int8 weight whose (Co,) scale multiplies the float32 sum,
//     out[n, y, x, co] = act((sum_{i,j,c} X[n, y+i-pt, x+j-pl, c] * W[i,j,c,co])
//                            * scale[co] + bias[co]), scale optional.
//
// X is NHWC (N, H, W, Ci), W the (kh*kw*Ci, Co) row-major matrix of an OIHW
// weight (features ordered (i, j, c)), out NHWC float32 (N, OH, OW, Co) with
// OH = H + pt + pb - kh + 1, OW = W + pl + pr - kw + 1.
//
// Replaces the Pallas TPU kernel pyopenvino_tpu/kernels/conv_direct.py::
// conv2d_direct (body _kernel, conv_direct.py:33-73; pallas_call at :138) in
// both its variants: kh*kw shifted dots, an exact int32 sum for int8 codes
// (:49-50) or a float32 sum at HIGHEST precision with an int8 weight cast to
// the activations' type (:51-62), then the scale, bias and activation
// epilogue (:64-71).
//
// What bounds it on an H100 SXM: int8 tensor cores reach 1,979 TOPS dense
// and device memory moves 3.35 TB/s.  At ResNet-18's 3x3 shapes (Ci = Co =
// 64 ... 512) a conv does 2*kh*kw*Ci = 1152 ... 9216 operations per output
// value against 1 byte in and 4 bytes out (each input read once, not its
// kh*kw-fold patch matrix), plus the weight.  So the card's roof is its
// bytes at batch 1 and at 56x56 and 28x28 in a batch of 64, and its
// operations at 14x14 and 7x7 in a batch of 64.  This first version runs
// __dp4a on the CUDA cores (int8_tile.cuh), far below that roof.  The float
// entry's roof is float32 FMAs outside the tensor cores (67 TFLOP/s) at every
// ResNet-18 3x3 shape, batch 1 included (1152 ... 9216 operations per 4-byte
// output value); it runs the FFMA tile loop of f32_tile.cuh (full float32,
// no TF32).
//
// Design (right and simple first):
//   * The TPU kernel keeps one whole padded example in VMEM
//     (conv_direct.py:113-121).  On Hopper one 58 x 58 x 64 int8 example is
//     already 215 KB, so instead this is an implicit GEMM: M = N*OH*OW output
//     pixels by Co, K = kh*kw*Ci, tiled 64 x 64, looping over the taps and Ci
//     in 32-value steps.  Each thread finds the (n, y, x) of its two A rows
//     once; each 4-value k group maps to its (tap, c) on the fly.
//   * Padding is read as zero by masking the input coordinates: no padded
//     copy is made.  With Ci % 4 == 0 a k group lies in one tap and is one
//     aligned 4-byte load; otherwise (Ci = 3 stems) byte by byte.
//   * The int32 sum is exact, and the epilogue is __fmul_rn then __fadd_rn,
//     never an FMA, so the output is bit-identical to the plain version.
//   * The float entry walks the same implicit matrix, one value at a time:
//     each K step maps its k to (tap, channel) once for all four of a
//     thread's rows; Ci need not divide the K step (ragged K is zero in
//     shared memory, as in int8_tile.cuh).
// Later work: mma.sync / wgmma on the int8 tensor cores, TMA or cp.async
// staging of the input rows and a pipelined K loop.

#include <cuda_runtime.h>

#include <cstdint>

#include "f32_tile.cuh"
#include "int8_tile.cuh"

namespace {

// The implicit (N*OH*OW, kh*kw*Ci) im2col matrix of an NHWC int8 input.
struct ConvA {
  const int8_t* x;
  long long M;  // N * OH * OW
  int H, W, Ci, KW, OH, OW, pt, pl, K;
  bool vec4;  // Ci % 4 == 0 and x 4-byte aligned

  struct Row {
    const int8_t* base;  // example n
    int iy0, ix0;        // input coordinates of tap (0, 0)
    bool valid;
  };

  __device__ Row row(long long m) const {
    if (m >= M) return {x, 0, 0, false};
    const int ox = (int)(m % OW);
    const long long t = m / OW;
    const int oy = (int)(t % OH);
    const long long n = t / OH;
    return {x + n * H * W * Ci, oy - pt, ox - pl, true};
  }

  __device__ int at(const Row& r, int k) const {
    if (k >= K) return 0;
    const int tap = k / Ci, c = k - tap * Ci;
    const int i = tap / KW, j = tap - i * KW;
    const int iy = r.iy0 + i, ix = r.ix0 + j;
    if (iy < 0 || iy >= H || ix < 0 || ix >= W) return 0;
    return r.base[((long long)iy * W + ix) * Ci + c];
  }

  __device__ int group(const Row& r, int k) const {
    if (!r.valid || k >= K) return 0;
    if (vec4) {  // k % 4 == 0 and Ci % 4 == 0: k .. k+3 share one tap
      const int tap = k / Ci, c = k - tap * Ci;
      const int i = tap / KW, j = tap - i * KW;
      const int iy = r.iy0 + i, ix = r.ix0 + j;
      if (iy < 0 || iy >= H || ix < 0 || ix >= W) return 0;
      return *reinterpret_cast<const int*>(r.base + ((long long)iy * W + ix) * Ci + c);
    }
    return i8tile::pack4(at(r, k), at(r, k + 1), at(r, k + 2), at(r, k + 3));
  }
};

// The same implicit matrix of a float32 NHWC input, for f32_tile.cuh.
struct ConvF32A {
  const float* x;
  long long M;  // N * OH * OW
  int H, W, Ci, KW, OH, OW, pt, pl, K;

  struct Row {
    const float* base;  // example n
    int iy0, ix0;       // input coordinates of tap (0, 0)
    bool valid;
  };
  struct Col {
    int di, dj, c;  // tap offsets and channel of column k
    bool valid;
  };

  __device__ Row row(long long m) const {
    if (m >= M) return {x, 0, 0, false};
    const int ox = (int)(m % OW);
    const long long t = m / OW;
    const int oy = (int)(t % OH);
    const long long n = t / OH;
    return {x + n * H * W * Ci, oy - pt, ox - pl, true};
  }

  __device__ Col col(int k) const {
    if (k >= K) return {0, 0, 0, false};
    const int tap = k / Ci, c = k - tap * Ci;
    const int i = tap / KW;
    return {i, tap - i * KW, c, true};
  }

  __device__ float at(const Row& r, const Col& k) const {
    if (!r.valid || !k.valid) return 0.f;
    const int iy = r.iy0 + k.di, ix = r.ix0 + k.dj;
    if (iy < 0 || iy >= H || ix < 0 || ix >= W) return 0.f;
    return r.base[((long long)iy * W + ix) * Ci + k.c];
  }
};

}  // namespace

// Plain C interface for ctypes.  scale is required, bias may be null.
// Launches on `stream` and does not synchronise.  Returns cudaGetLastError()
// after the launch: 0 when the launch was accepted.
extern "C" int conv2d_direct_i8(const void* x, const void* wmat, const void* scale,
                                const void* bias, void* out, int N, int H, int W, int Ci,
                                int Co, int KH, int KW, int OH, int OW, int pt, int pl,
                                int act, float lo, float hi, void* stream) {
  const long long M = (long long)N * OH * OW;
  const int K = KH * KW * Ci;
  const bool vec4 = Ci % 4 == 0 && reinterpret_cast<std::uintptr_t>(x) % 4 == 0;
  const ConvA ld{static_cast<const int8_t*>(x), M, H, W, Ci, KW, OH, OW, pt, pl, K, vec4};
  return i8tile::launch(ld, wmat, scale, bias, out, M, Co, K, act, lo, hi, stream);
}

// Float32 activations.  w_int8 != 0: wmat holds int8 codes and scale (required)
// dequantizes the sum per output channel; otherwise wmat is float32 and scale
// may be null.  bias may be null.  Launches on `stream`, does not synchronise,
// and returns cudaGetLastError() after the launch.
extern "C" int conv2d_direct_f32(const void* x, const void* wmat, int w_int8,
                                 const void* scale, const void* bias, void* out, int N,
                                 int H, int W, int Ci, int Co, int KH, int KW, int OH,
                                 int OW, int pt, int pl, int act, float lo, float hi,
                                 void* stream) {
  const long long M = (long long)N * OH * OW;
  const int K = KH * KW * Ci;
  const ConvF32A ld{static_cast<const float*>(x), M, H, W, Ci, KW, OH, OW, pt, pl, K};
  if (w_int8) {
    return f32tile::launch<ConvF32A, int8_t>(ld, wmat, scale, bias, out, M, Co, K, act, lo,
                                             hi, stream);
  }
  return f32tile::launch<ConvF32A, float>(ld, wmat, scale, bias, out, M, Co, K, act, lo, hi,
                                          stream);
}
