// The port's native host library: the host side of serving.
//
// Batched image -> NCHW blob conversion (bilinear resize, per-channel scale
// and bias, or raw uint8 for the u8 ingress that PrePostProcessor's
// set_element_type("u8") bakes into the graph), fp16 weight decode for the
// IR parser, the server's batch stacking copy and a background loader, all
// multi-threaded, over a plain C ABI that pyopenvino_tpu_torch/native
// binds with ctypes.  g++ builds it on first use (native/__init__.py).
//
// Everything here is host-side data movement; the device work stays in the
// port's CUDA and Triton kernels.  The arithmetic is fixed: float32
// coordinates, (int) truncation for the neighbour picks, the
// (1 - wy)*((1 - wx)*p00 + wx*p01) + wy*(...) order and round half up in
// u8 mode.  g++ may contract those multiply-adds into FMAs under
// -march=native (it does so under -std=c++17 as under gnu++17), so bits are
// fixed by the source and the flags together: native/__init__.py builds
// with one set of flags and hashes them into the library's name.

#include <algorithm>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <map>
#include <mutex>
#include <queue>
#include <thread>
#include <utility>
#include <vector>

namespace {

inline float half_to_float(uint16_t h) {
  uint32_t sign = (uint32_t)(h & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1Fu;
  uint32_t mant = h & 0x3FFu;
  uint32_t bits;
  if (exp == 0) {
    if (mant == 0) {
      bits = sign;  // +-0
    } else {
      // subnormal: value = mant * 2^-24; normalize so the leading bit is
      // implicit → exponent = 113 - shift (E-127 = -14 - shift)
      int shift = 0;
      while (!(mant & 0x400u)) {
        mant <<= 1;
        ++shift;
      }
      mant &= 0x3FFu;
      bits = sign | ((uint32_t)(113 - shift) << 23) | (mant << 13);
    }
  } else if (exp == 31) {
    bits = sign | 0x7F800000u | (mant << 13);  // inf / nan
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (mant << 13);
  }
  float f;
  std::memcpy(&f, &bits, sizeof(f));
  return f;
}

void parallel_for(int64_t n, int nthreads, const std::function<void(int64_t, int64_t)>& fn) {
  if (nthreads <= 1 || n < 2) {
    fn(0, n);
    return;
  }
  nthreads = std::min<int64_t>(nthreads, n);
  std::vector<std::thread> threads;
  int64_t chunk = (n + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min<int64_t>(lo + chunk, n);
    if (lo >= hi) break;
    threads.emplace_back(fn, lo, hi);
  }
  for (auto& th : threads) th.join();
}

// Bilinear-resize one HWC uint8 image to (oh, ow) and write NCHW float32,
// optionally scaled/biased per-channel: out = px * scale + bias.
void preprocess_one(const uint8_t* img, int ih, int iw, int c, float* out,
                    int oh, int ow, const float* scale, const float* bias) {
  const float ry = oh > 1 ? (float)(ih - 1) / (float)(oh - 1) : 0.f;
  const float rx = ow > 1 ? (float)(iw - 1) / (float)(ow - 1) : 0.f;
  for (int y = 0; y < oh; ++y) {
    float fy = y * ry;
    int y0 = (int)fy;
    int y1 = std::min(y0 + 1, ih - 1);
    float wy = fy - y0;
    for (int x = 0; x < ow; ++x) {
      float fx = x * rx;
      int x0 = (int)fx;
      int x1 = std::min(x0 + 1, iw - 1);
      float wx = fx - x0;
      const uint8_t* p00 = img + (y0 * iw + x0) * c;
      const uint8_t* p01 = img + (y0 * iw + x1) * c;
      const uint8_t* p10 = img + (y1 * iw + x0) * c;
      const uint8_t* p11 = img + (y1 * iw + x1) * c;
      for (int ch = 0; ch < c; ++ch) {
        float v = (1 - wy) * ((1 - wx) * p00[ch] + wx * p01[ch]) +
                  wy * ((1 - wx) * p10[ch] + wx * p11[ch]);
        if (scale) v = v * scale[ch];
        if (bias) v = v + bias[ch];
        out[(int64_t)ch * oh * ow + (int64_t)y * ow + x] = v;
      }
    }
  }
}

// Bilinear-resize one HWC uint8 image to (oh, ow) and write NCHW uint8
// (round half up).  The u8-ingress path: scale, bias and the cast run on
// the device (PrePostProcessor set_element_type("u8")), so the host-to-
// device copy is 1 byte a pixel instead of 4.
void preprocess_one_u8(const uint8_t* img, int ih, int iw, int c,
                       uint8_t* out, int oh, int ow) {
  const float ry = oh > 1 ? (float)(ih - 1) / (float)(oh - 1) : 0.f;
  const float rx = ow > 1 ? (float)(iw - 1) / (float)(ow - 1) : 0.f;
  for (int y = 0; y < oh; ++y) {
    float fy = y * ry;
    int y0 = (int)fy;
    int y1 = std::min(y0 + 1, ih - 1);
    float wy = fy - y0;
    for (int x = 0; x < ow; ++x) {
      float fx = x * rx;
      int x0 = (int)fx;
      int x1 = std::min(x0 + 1, iw - 1);
      float wx = fx - x0;
      const uint8_t* p00 = img + (y0 * iw + x0) * c;
      const uint8_t* p01 = img + (y0 * iw + x1) * c;
      const uint8_t* p10 = img + (y1 * iw + x0) * c;
      const uint8_t* p11 = img + (y1 * iw + x1) * c;
      for (int ch = 0; ch < c; ++ch) {
        float v = (1 - wy) * ((1 - wx) * p00[ch] + wx * p01[ch]) +
                  wy * ((1 - wx) * p10[ch] + wx * p11[ch]);
        out[(int64_t)ch * oh * ow + (int64_t)y * ow + x] =
            (uint8_t)std::min(255.f, std::max(0.f, v + 0.5f));
      }
    }
  }
}

}  // namespace

extern "C" {

// fp16 buffer -> fp32, parallel: the IR parser's decode of fp16 Consts.
void ov_fp16_to_fp32(const uint16_t* src, float* dst, int64_t n, int nthreads) {
  parallel_for(n, nthreads, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) dst[i] = half_to_float(src[i]);
  });
}

// (B, ih, iw, c) uint8 -> (B, c, oh, ow) float32 blobs, bilinear, parallel
// over the batch.  scale/bias are per-channel and may be null.
void ov_preprocess_batch(const uint8_t* imgs, int batch, int ih, int iw, int c,
                         float* out, int oh, int ow, const float* scale,
                         const float* bias, int nthreads) {
  const int64_t in_stride = (int64_t)ih * iw * c;
  const int64_t out_stride = (int64_t)c * oh * ow;
  parallel_for(batch, nthreads, [&](int64_t lo, int64_t hi) {
    for (int64_t b = lo; b < hi; ++b) {
      preprocess_one(imgs + b * in_stride, ih, iw, c, out + b * out_stride,
                     oh, ow, scale, bias);
    }
  });
}

// (B, ih, iw, c) uint8 -> (B, c, oh, ow) uint8 blobs (u8 ingress mode).
void ov_preprocess_batch_u8(const uint8_t* imgs, int batch, int ih, int iw,
                            int c, uint8_t* out, int oh, int ow,
                            int nthreads) {
  const int64_t in_stride = (int64_t)ih * iw * c;
  const int64_t out_stride = (int64_t)c * oh * ow;
  parallel_for(batch, nthreads, [&](int64_t lo, int64_t hi) {
    for (int64_t b = lo; b < hi; ++b) {
      preprocess_one_u8(imgs + b * in_stride, ih, iw, c,
                        out + b * out_stride, oh, ow);
    }
  });
}

// Gather `batch` separately-allocated float32 example blobs (each `elems`
// long) into one contiguous batch buffer — the server's stacking step,
// parallel memcpy.
void ov_stack_f32(const float** srcs, int batch, int64_t elems, float* dst,
                  int nthreads) {
  parallel_for(batch, nthreads, [&](int64_t lo, int64_t hi) {
    for (int64_t b = lo; b < hi; ++b) {
      std::memcpy(dst + b * elems, srcs[b], elems * sizeof(float));
    }
  });
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Asynchronous prefetching data loader.
//
// A worker pool preprocesses submitted uint8 image batches into NCHW float32
// (or uint8) blobs in the background, so that host-side input preparation
// overlaps the device's work on the batch before.  Results are handed back
// strictly in submission order; a bounded in-flight window gives
// backpressure.  Blocking calls run outside the Python GIL (ctypes releases
// it), so one Python thread can keep submitting while another consumes.
// ---------------------------------------------------------------------------

namespace {

struct Loader {
  int ih, iw, c, oh, ow;
  std::vector<float> scale, bias;
  bool has_scale = false, has_bias = false;
  bool u8_out = false;  // u8-ingress mode: emit uint8 NCHW blobs
  size_t depth;

  std::mutex mu;
  std::condition_variable cv_in;   // workers: work available / dying
  std::condition_variable cv_out;  // consumer: result ready; submit: room
  std::queue<std::pair<uint64_t, std::vector<uint8_t>>> in_q;
  // result blobs as raw bytes (float32 or uint8 depending on u8_out)
  std::map<uint64_t, std::pair<int, std::vector<uint8_t>>> done;
  uint64_t next_submit = 0;
  uint64_t next_emit = 0;
  size_t inflight = 0;  // submitted and not yet consumed
  bool closed = false;  // no further submits; next() drains then returns 0
  bool dying = false;   // destroy(): unblock everyone
  int ext_calls = 0;    // external threads inside submit()/next() —
                        // destroy() must wait them out before `delete this`
  std::condition_variable cv_ext;
  std::vector<std::thread> workers;
};

// RAII guard counting external callers so ov_loader_destroy never deletes
// the Loader while another thread is blocked on its mutex/condvars.
struct ExtGuard {
  Loader* L;
  explicit ExtGuard(Loader* l) : L(l) { ++L->ext_calls; }  // caller holds mu
  ~ExtGuard() {
    --L->ext_calls;  // caller holds mu
    if (L->ext_calls == 0) L->cv_ext.notify_all();
  }
};

void loader_worker(Loader* L) {
  for (;;) {
    std::pair<uint64_t, std::vector<uint8_t>> job;
    {
      std::unique_lock<std::mutex> lk(L->mu);
      L->cv_in.wait(lk, [&] { return L->dying || !L->in_q.empty(); });
      if (L->dying) return;
      job = std::move(L->in_q.front());
      L->in_q.pop();
    }
    const size_t in_stride = (size_t)L->ih * L->iw * L->c;
    const size_t out_stride = (size_t)L->c * L->oh * L->ow;
    const int batch = (int)(job.second.size() / in_stride);
    const size_t elem_size = L->u8_out ? 1 : sizeof(float);
    std::vector<uint8_t> out((size_t)batch * out_stride * elem_size);
    const float* sc = L->has_scale ? L->scale.data() : nullptr;
    const float* bi = L->has_bias ? L->bias.data() : nullptr;
    for (int b = 0; b < batch; ++b) {
      if (L->u8_out) {
        preprocess_one_u8(job.second.data() + (size_t)b * in_stride, L->ih,
                          L->iw, L->c, out.data() + (size_t)b * out_stride,
                          L->oh, L->ow);
      } else {
        preprocess_one(job.second.data() + (size_t)b * in_stride, L->ih,
                       L->iw, L->c,
                       (float*)out.data() + (size_t)b * out_stride, L->oh,
                       L->ow, sc, bi);
      }
    }
    {
      std::lock_guard<std::mutex> lk(L->mu);
      L->done.emplace(job.first,
                      std::make_pair(batch, std::move(out)));
    }
    L->cv_out.notify_all();
  }
}

}  // namespace

extern "C" {

void* ov_loader_create(int ih, int iw, int c, int oh, int ow,
                       const float* scale, const float* bias, int workers,
                       int depth, int u8_out) {
  Loader* L = new Loader();
  L->ih = ih; L->iw = iw; L->c = c; L->oh = oh; L->ow = ow;
  L->u8_out = u8_out != 0;
  if (scale) {
    L->scale.assign(scale, scale + c);
    L->has_scale = true;
  }
  if (bias) {
    L->bias.assign(bias, bias + c);
    L->has_bias = true;
  }
  L->depth = depth < 1 ? 1 : (size_t)depth;
  workers = std::max(1, workers);
  for (int i = 0; i < workers; ++i) {
    L->workers.emplace_back(loader_worker, L);
  }
  return L;
}

// Copies `imgs` ((batch, ih, iw, c) uint8) and enqueues it; blocks while the
// in-flight window is full.  Returns the sequence id, or -1 after
// close()/destroy() (a close() while blocked RELEASES the submitter).
int64_t ov_loader_submit(void* h, const uint8_t* imgs, int batch) {
  Loader* L = (Loader*)h;
  const size_t bytes = (size_t)batch * L->ih * L->iw * L->c;
  std::vector<uint8_t> copy(imgs, imgs + bytes);
  std::unique_lock<std::mutex> lk(L->mu);
  ExtGuard guard(L);
  if (L->closed || L->dying) return -1;
  L->cv_out.wait(lk, [&] {
    return L->dying || L->closed || L->inflight < L->depth;
  });
  if (L->closed || L->dying) return -1;
  const uint64_t seq = L->next_submit++;
  L->inflight++;
  L->in_q.emplace(seq, std::move(copy));
  L->cv_in.notify_one();
  return (int64_t)seq;
}

// Blocks for the next batch IN SUBMISSION ORDER and writes its blob
// ((batch, c, oh, ow) float32, or uint8 in u8_out mode) into `out`.
// Returns the batch size, 0 when the loader is closed and drained, -1 if
// destroyed while waiting, -2 if `cap_elems` (elements) is too small.
int64_t ov_loader_next(void* h, void* out, int64_t cap_elems) {
  Loader* L = (Loader*)h;
  std::unique_lock<std::mutex> lk(L->mu);
  ExtGuard guard(L);
  const size_t elem_size = L->u8_out ? 1 : sizeof(float);
  for (;;) {
    auto it = L->done.find(L->next_emit);
    if (it != L->done.end()) {
      const int batch = it->second.first;
      std::vector<uint8_t>& blob = it->second.second;
      if ((int64_t)(blob.size() / elem_size) > cap_elems) return -2;
      std::memcpy(out, blob.data(), blob.size());
      L->done.erase(it);
      L->next_emit++;
      L->inflight--;
      L->cv_out.notify_all();  // room for blocked submitters
      return batch;
    }
    if (L->dying) return -1;
    if (L->closed && L->next_emit >= L->next_submit) return 0;
    L->cv_out.wait(lk);
  }
}

void ov_loader_close(void* h) {
  Loader* L = (Loader*)h;
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->closed = true;
  }
  L->cv_out.notify_all();
}

void ov_loader_destroy(void* h) {
  Loader* L = (Loader*)h;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    L->dying = true;
    L->cv_in.notify_all();
    L->cv_out.notify_all();
    // wait out any thread still blocked inside submit()/next(): deleting
    // a mutex/condvar with a live waiter is undefined behavior
    L->cv_ext.wait(lk, [&] { return L->ext_calls == 0; });
  }
  for (auto& t : L->workers) t.join();
  delete L;
}

int ov_native_abi_version() { return 3; }

}  // extern "C"
