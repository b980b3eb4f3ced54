// dw_pw_fused_i8: a 3x3 stride-1 depthwise convolution and the 1x1 pointwise
// convolution after it, on int8 codes, in one kernel for Hopper (sm_90a),
// with the intermediate kept in shared memory.
//
//   acc[n,y,x,c]  = sum_{dy,dx} X[n, y+dy-1, x+dx-1, c] * Wdw[3*dy+dx][c]  (int32, zero pad)
//   q[n,y,x,c]    = clamp(rint(act_dw(float(acc) * dw_scale[c] + dw_bias[c]) * r_mid), +-127)
//   pacc[n,y,x,o] = sum_c q[n,y,x,c] * Wpw[c][o]                          (int32)
//   o             = act_pw(float(pacc) * pw_scale[o] + pw_bias[o])
//   out           = clamp(rint(o * r_out), +-127) as int8, or o as float32
//
// X is NHWC int8 (N, H, W, C), Wdw (9, C) int8, Wpw (C, Co) int8 row-major,
// out NHWC (N, H, W, Co).  r_mid and r_out are the float32 of the double
// 1.0 / s (Python's 1.0 / scale, as the TPU kernel multiplies by it); every
// epilogue step rounds on its own (__fmul_rn, __fadd_rn, rintf half to
// even), never an FMA, so the output is bit-identical to the plain version.
//
// Replaces the Pallas TPU kernel tools/dw_pw_kernel.py::dw_pw_fused
// (kernel body _make_kernel, dw_pw_kernel.py:80-130; pallas_call in _impl at
// :173), which the JAX package keeps off its serving paths, with its
// microbenchmark.  Its TPU design holds G whole padded images in VMEM in a
// P-pitched row space (:65-72, :124-130) so that every tap is a static
// sublane offset; that layout belongs to Mosaic and is not carried over.
//
// What bounds it on an H100 SXM: the int8 tensor cores' 1,979 TOPS dense
// and 3.35 TB/s of device memory, about 590 operations per byte.  A pixel
// costs 18*C + 2*C*Co operations against C + Co bytes (int8 out), about Co
// operations per byte at C = Co: bound by bytes at every SSD-MobileNet pair
// up to 19x19x512, by operations at 10x10x1024.  What the fusion saves is
// the intermediate's round trip, 2*C bytes a pixel.  This first version
// runs __dp4a on the CUDA cores, far below that roof.
//
// Design (right and simple first):
//   * One block per 64 output pixels of the flattened N*H*W (a tile may span
//     two images; each pixel reads its own neighbours).  Stage 1: the block's
//     threads walk (pixel, 4-channel group) pairs, sum the 9 taps exactly in
//     int32, run the depthwise epilogue and requantize into an int8 mid
//     tile of 64 x C in dynamic shared memory (64 KB at C = 1024: the block's
//     shared memory limit is raised above 48 KB where the tile needs it).
//     Its rows are zero past C (to a multiple of the 32-value K step) and
//     past the last pixel, so stage 2 needs no bounds on the mid tile.
//   * Stage 2: the pointwise product of the mid tile by Wpw, Co tile by Co
//     tile, with int8_tile.cuh's loop (64 x 64 output tile, 256 threads of
//     4 x 4 int32 sums, __dp4a on 4-byte groups; its BStage, mma_step and
//     store_tile): Wpw's groups are staged in shared memory as there, and the
//     mid tile, already in shared memory, is read in place as A.  Then the
//     pointwise epilogue and the output store.  The mid tile never leaves
//     the SM.

#include <cuda_runtime.h>

#include <cstdint>

#include "int8_tile.cuh"

namespace {

// round(v * r) clipped to the symmetric int8 code domain
__device__ __forceinline__ int requant(float v, float r) {
  return (int)fminf(fmaxf(rintf(__fmul_rn(v, r)), -127.f), 127.f);
}

// bytes of a mid tile row: C rounded up to the K step, plus MID_PAD (one
// 4-byte bank) so that the rows a warp reads at once fall in different banks
constexpr int MID_PAD = 4;
__host__ __device__ __forceinline__ int mid_pitch(int C) {
  return (C + i8tile::BK - 1) / i8tile::BK * i8tile::BK + MID_PAD;
}

__global__ void __launch_bounds__(i8tile::THREADS)
dw_pw_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wdw,
             const float* __restrict__ dws, const float* __restrict__ dwb,
             const int8_t* __restrict__ wpw, const float* __restrict__ pws,
             const float* __restrict__ pwb, void* __restrict__ out, int N, int H, int W,
             int C, int Co, int dw_act, float dw_lo, float dw_hi, int pw_act, float pw_lo,
             float pw_hi, float r_mid, int int8_out, float r_out, bool vec4) {
  using namespace i8tile;
  extern __shared__ __align__(16) int8_t mid[];  // [BM][pitch]
  __shared__ __align__(16) int Bs[KG][BN];       // Bs[g][n], Wpw's k groups

  const int pitch = mid_pitch(C);
  const int groups = pitch / 4;
  const long long M = (long long)N * H * W;
  const long long row0 = (long long)blockIdx.x * BM;
  const int tid = threadIdx.x;
  __builtin_assume(dwb != nullptr && pwb != nullptr);  // the epilogues' bias

  // Stage 1: depthwise 3x3, exact int32, epilogue, requantize into mid.
  for (int item = tid; item < BM * groups; item += THREADS) {
    const int ml = item / groups, c0 = (item - ml * groups) * 4;
    const long long m = row0 + ml;
    int acc[4] = {0, 0, 0, 0};
    if (m < M && c0 < C) {
      const int xw = (int)(m % W);
      const long long t = m / W;
      const int yh = (int)(t % H);
      const int8_t* img = x + (t / H) * H * W * C;
      for (int tap = 0; tap < 9; ++tap) {
        const int iy = yh + tap / 3 - 1, ix = xw + tap % 3 - 1;
        if (iy < 0 || iy >= H || ix < 0 || ix >= W) continue;
        const int8_t* px = img + ((long long)iy * W + ix) * C + c0;
        const int8_t* pw = wdw + (long long)tap * C + c0;
        if (vec4) {
          const char4 a = *reinterpret_cast<const char4*>(px);
          const char4 b = *reinterpret_cast<const char4*>(pw);
          acc[0] += a.x * b.x;
          acc[1] += a.y * b.y;
          acc[2] += a.z * b.z;
          acc[3] += a.w * b.w;
        } else {
          for (int j = 0; j < 4 && c0 + j < C; ++j) acc[j] += px[j] * pw[j];
        }
      }
    }
    int q[4] = {0, 0, 0, 0};
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + j;
      if (m < M && c < C) {
        q[j] = requant(epilogue(acc[j], dws[c], dwb, c, dw_act, dw_lo, dw_hi), r_mid);
      }
    }
    *reinterpret_cast<int*>(mid + ml * pitch + c0) = pack4(q[0], q[1], q[2], q[3]);
  }
  __syncthreads();

  // Stage 2: pointwise, Co tile by Co tile, int8_tile.cuh's loop with the
  // mid tile read in place as its A.
  const int tx = tid % 16, ty = tid / 16;  // columns tx*4.., rows ty*4..
  const int8_t* a_rows = mid + ty * 4 * pitch;
  for (int col0 = 0; col0 < Co; col0 += BN) {
    const BStage stage_b(wpw, Co, C, col0);
    int acc[4][4] = {};
    for (int k0 = 0; k0 < C; k0 += BK) {
      stage_b(Bs, k0);
      __syncthreads();
      const int8_t* a = a_rows + k0;
      mma_step(acc, [&](int g) {
        const int8_t* p = a + 4 * g;
        return make_int4(*reinterpret_cast<const int*>(p),
                         *reinterpret_cast<const int*>(p + pitch),
                         *reinterpret_cast<const int*>(p + 2 * pitch),
                         *reinterpret_cast<const int*>(p + 3 * pitch));
      }, Bs, tx);
      __syncthreads();
    }
    store_tile(acc, row0, col0, ty, tx, M, Co, pws, pwb, pw_act, pw_lo, pw_hi,
               [&](long long gm, int gn, float v) {
                 if (int8_out) {
                   static_cast<int8_t*>(out)[gm * Co + gn] = (int8_t)requant(v, r_out);
                 } else {
                   static_cast<float*>(out)[gm * Co + gn] = v;
                 }
               });
  }
}

// The largest C the kernel takes on `device`: its BM rows of mid_pitch(C)
// bytes, with its static Bs tile, within the shared memory a block may opt
// into.  0 if the device cannot be asked.
int max_channels(int device) {
  int optin = 0;
  cudaFuncAttributes attr;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
          cudaSuccess ||
      cudaFuncGetAttributes(&attr, dw_pw_kernel) != cudaSuccess) {
    return 0;
  }
  const int rows = (optin - (int)attr.sharedSizeBytes) / i8tile::BM - MID_PAD;
  return rows / i8tile::BK * i8tile::BK;
}

}  // namespace

extern "C" int dw_pw_max_channels(int device) { return max_channels(device); }

// Plain C interface for ctypes.  Every pointer is required.  int8_out != 0:
// out is int8 codes at 1 / r_out, else float32.  Launches on `stream`, does
// not synchronise, and returns the first CUDA error (0 when the launch was
// accepted; C above dw_pw_max_channels fails in cudaFuncSetAttribute).
extern "C" int dw_pw_fused_i8(const void* x, const void* wdw, const void* dws,
                              const void* dwb, const void* wpw, const void* pws,
                              const void* pwb, void* out, int N, int H, int W, int C,
                              int Co, int dw_act, float dw_lo, float dw_hi, int pw_act,
                              float pw_lo, float pw_hi, float r_mid, int int8_out,
                              float r_out, void* stream) {
  const long long M = (long long)N * H * W;
  if (M == 0 || Co == 0) return (int)cudaGetLastError();
  const int smem = i8tile::BM * mid_pitch(C);
  // four channels in one 4-byte load: C % 4 == 0 and x, wdw 4-byte aligned
  const bool vec4 = C % 4 == 0 && reinterpret_cast<std::uintptr_t>(x) % 4 == 0 &&
                    reinterpret_cast<std::uintptr_t>(wdw) % 4 == 0;
  if (smem > 48 * 1024) {  // above 48 KB only by the kernel's own limit
    const cudaError_t err = cudaFuncSetAttribute(
        dw_pw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  dw_pw_kernel<<<(unsigned)((M + i8tile::BM - 1) / i8tile::BM), i8tile::THREADS, smem,
                 (cudaStream_t)stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(wdw),
      static_cast<const float*>(dws), static_cast<const float*>(dwb),
      static_cast<const int8_t*>(wpw), static_cast<const float*>(pws),
      static_cast<const float*>(pwb), out, N, H, W, C, Co, dw_act, dw_lo, dw_hi, pw_act,
      pw_lo, pw_hi, r_mid, int8_out, r_out, vec4);
  return (int)cudaGetLastError();
}
