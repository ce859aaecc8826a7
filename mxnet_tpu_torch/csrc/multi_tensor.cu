// Multi-tensor optimizer kernels for Hopper (sm_90a), with a plain C
// interface.
//
// Two kernels over every parameter of a training step:
//   multi_tensor_update      the fused optimizer update (adam_update or
//                            sgd_mom_update of ops/optimizer_ops.py) of
//                            every (weight, grad, state) of the step, all
//                            float32 or all bfloat16: one launch a
//                            kMaxTensors tensors;
//   multi_tensor_norm_finite the global sum of squares of the gradients and
//                            the all-finite flag over the gradients and the
//                            loss outputs, with the clip scale
//                            gscale = min(1, clip / max(rescale * sqrt(S), 1e-12)):
//                            one launch a kMaxTensors tensors, then one to
//                            sum the partials.
// Each entry point returns the number of kernels it launched in *launched.
// They replace no TPU kernel: the JAX package gets this fusion from XLA
// inside its one jitted training step (mxnet_tpu/parallel/trainer.py
// _build_step). Here the step is eager, and the registry's update op costs
// about eighteen eager launches a parameter (Adam).
//
// Bound on the H100: both move bytes. The Adam update reads w, g, mean and
// var and writes w, mean and var: 28 bytes a parameter in float32, 14 in
// bfloat16 (SGD with momentum 20, 10); the reduction reads each gradient
// once: 4 bytes a parameter (plus the loss outputs). A few flops an element
// cannot compete with 3.35 TB/s. The design's aim is to move each byte
// once, four elements a thread where the tensors allow it.
//
// Design.
// - The host passes a table of the tensors (sizes and pointers) as the
//   kernel's parameter (__grid_constant__, up to kMaxTensors tensors a
//   launch; more are launched in batches), so a new list of gradient
//   tensors each step costs no copy and no host sync. Each block takes
//   kChunk elements of one tensor; it finds its tensor by a binary search
//   over the table's block offsets.
// - Exactness: the update computes exactly the registry op's arithmetic in
//   its order, one IEEE rounding an operation (__fmul_rn, __fadd_rn,
//   __fsub_rn, __fdiv_rn, __fsqrt_rn: nvcc contracts a*b + c into an FMA
//   under -O3 otherwise), with the scalars rounded to float on the host as
//   PyTorch rounds a Python scalar. So the kernel is bit-equal to the eager
//   ops: the gradient is unscaled (loss scaler), clipped (gscale), then
//   rescaled, clamped to clip_gradient, and wd * w is added; then the
//   moments and the weight. Multiplying by an unscale or a gscale of 1 is
//   the identity, so those factors are always applied.
// - bfloat16 tensors: the eager ops compute each operation in float32 and
//   round its result to bfloat16, with a Python scalar in float32 and
//   clamp's bounds in bfloat16; the kernel does the same (Elt<T>::rnd after
//   every operation). The unscale and the clip scale are applied in
//   float32 and rounded once each.
// - Four device scalars are read on the device, with no host sync: the
//   guard's finite flag (when false nothing is written in place, and the
//   old bits are copied to fresh outputs), the clip scale, the loss
//   scaler's 1/scale and the learning rate. Null pointers stand for true,
//   1, 1 and the lr of the host's table. A step captured as a CUDA graph
//   passes its lr this way, so each replay reads the lr written before
//   it.
// - The reduction sums in a fixed order: a per-thread sum over its
//   elements, warp shuffles and a shared-memory tree give one partial a
//   block, and a second kernel sums the partials in a fixed order. No float
//   atomics: the result is the same on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 16384;        // elements a block
constexpr int kMaxTensors = 256;     // tensors a launch
constexpr int kFinalThreads = 1024;

// the update's table: 17.4 KB of kernel parameters
template <typename T>
struct UpdateTable {
  int n;
  int block_start[kMaxTensors + 1];
  long long size[kMaxTensors];
  const T* w[kMaxTensors];
  const T* g[kMaxTensors];
  const T* s0[kMaxTensors];
  const T* s1[kMaxTensors];
  T* w_out[kMaxTensors];
  T* s0_out[kMaxTensors];
  T* s1_out[kMaxTensors];
};

// an element type's loads and stores (one element, or four at an index
// that is a multiple of 4 of a pointer aligned to four elements) and the
// rounding of a float32 result to it; stored values are of the type
// already
template <typename T> struct Elt;
template <> struct Elt<float> {
  static __device__ __forceinline__ float ld(const float* p, long long i) {
    return p[i];
  }
  static __device__ __forceinline__ void st(float* p, long long i, float x) {
    p[i] = x;
  }
  static __device__ __forceinline__ void ld4(const float* p, long long i,
                                             float v[4]) {
    const float4 r = *reinterpret_cast<const float4*>(p + i);
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
  }
  static __device__ __forceinline__ void st4(float* p, long long i,
                                             const float v[4]) {
    *reinterpret_cast<float4*>(p + i) = make_float4(v[0], v[1], v[2], v[3]);
  }
  static __device__ __forceinline__ float rnd(float x) { return x; }
};
template <> struct Elt<__nv_bfloat16> {
  static __device__ __forceinline__ float ld(const __nv_bfloat16* p,
                                            long long i) {
    return __bfloat162float(p[i]);
  }
  static __device__ __forceinline__ void st(__nv_bfloat16* p, long long i,
                                            float x) {
    p[i] = __float2bfloat16_rn(x);
  }
  static __device__ __forceinline__ void ld4(const __nv_bfloat16* p,
                                             long long i, float v[4]) {
    const uint2 r = *reinterpret_cast<const uint2*>(p + i);
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&r.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&r.y);
    v[0] = __low2float(a); v[1] = __high2float(a);
    v[2] = __low2float(b); v[3] = __high2float(b);
  }
  static __device__ __forceinline__ void st4(__nv_bfloat16* p, long long i,
                                             const float v[4]) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    uint2 r;
    r.x = *reinterpret_cast<const unsigned*>(&a);
    r.y = *reinterpret_cast<const unsigned*>(&b);
    *reinterpret_cast<uint2*>(p + i) = r;
  }
  static __device__ __forceinline__ float rnd(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

// lr, rescale, clip (<= 0: none), wd, then the optimizer's own:
// adam: beta1, 1 - beta1, beta2, 1 - beta2, epsilon; sgd_mom: momentum
struct Hyper {
  float lr, rescale, clip, wd, a, b, c, d, eps;
};

enum Kind { kSgdMom = 0, kAdam = 1 };

__device__ __forceinline__ int find_tensor(const int* block_start, int n,
                                           int b) {
  // the largest k in [0, n) with block_start[k] <= b
  int lo = 0, hi = n;
  while (hi - lo > 1) {
    int mid = (lo + hi) >> 1;
    if (block_start[mid] <= b) lo = mid; else hi = mid;
  }
  return lo;
}

// the registry's _prep after the fit step's unscale and clip:
// g * inv, * gscale, * rescale_grad, clamp, + wd * w; R rounds each
// result to the element type
template <typename T>
__device__ __forceinline__ float prep(float g, float w, float inv, float gs,
                                      const Hyper& h) {
  using E = Elt<T>;
  g = E::rnd(__fmul_rn(g, inv));
  g = E::rnd(__fmul_rn(g, gs));
  g = E::rnd(__fmul_rn(g, h.rescale));
  if (h.clip > 0.f && !isnan(g)) {
    const float c = E::rnd(h.clip);
    g = fminf(fmaxf(g, -c), c);
  }
  return E::rnd(__fadd_rn(g, E::rnd(__fmul_rn(w, h.wd))));
}

template <int K, typename T>
__device__ __forceinline__ void update_one(float w, float g, float s0,
                                           float s1, float inv, float gs,
                                           const Hyper& h, float& w1,
                                           float& s0n, float& s1n) {
  using E = Elt<T>;
  const float gg = prep<T>(g, w, inv, gs, h);
  if (K == kAdam) {
    // mean = beta1 * mean + (1 - beta1) * g
    s0n = E::rnd(__fadd_rn(E::rnd(__fmul_rn(s0, h.a)),
                           E::rnd(__fmul_rn(gg, h.b))));
    // var = beta2 * var + (1 - beta2) * square(g)
    s1n = E::rnd(__fadd_rn(E::rnd(__fmul_rn(s1, h.c)),
                           E::rnd(__fmul_rn(E::rnd(__fmul_rn(gg, gg)),
                                            h.d))));
    // w = w - lr * mean / (sqrt(var) + epsilon)
    const float num = E::rnd(__fmul_rn(s0n, h.lr));
    const float den = E::rnd(__fadd_rn(E::rnd(__fsqrt_rn(s1n)), h.eps));
    w1 = E::rnd(__fsub_rn(w, E::rnd(__fdiv_rn(num, den))));
  } else {
    // mom = momentum * mom - lr * g;  w = w + mom
    s0n = E::rnd(__fsub_rn(E::rnd(__fmul_rn(s0, h.a)),
                           E::rnd(__fmul_rn(gg, h.lr))));
    s1n = 0.f;
    w1 = E::rnd(__fadd_rn(w, s0n));
  }
}

template <int K, typename T>
__global__ void __launch_bounds__(kThreads)
mt_update_kernel(const __grid_constant__ UpdateTable<T> t, const Hyper hp,
                 const float* __restrict__ lr,
                 const float* __restrict__ gscale,
                 const float* __restrict__ inv_scale,
                 const unsigned char* __restrict__ flag, int donate) {
  const bool ok = flag == nullptr || *flag != 0;
  if (!ok && donate) return;                 // masked: nothing moves
  Hyper h = hp;
  if (lr != nullptr) h.lr = *lr;
  const float gs = gscale == nullptr ? 1.f : *gscale;
  const float inv = inv_scale == nullptr ? 1.f : *inv_scale;
  const int k = find_tensor(t.block_start, t.n, blockIdx.x);
  const long long start =
      static_cast<long long>(blockIdx.x - t.block_start[k]) * kChunk;
  const long long stop = min(start + kChunk, t.size[k]);
  using E = Elt<T>;
  const T* w = t.w[k];
  const T* g = t.g[k];
  const T* s0 = t.s0[k];
  const T* s1 = K == kAdam ? t.s1[k] : nullptr;
  T* wo = t.w_out[k];
  T* s0o = t.s0_out[k];
  T* s1o = K == kAdam ? t.s1_out[k] : nullptr;

  if (!ok) {                     // masked, fresh outputs: the old bits
    for (long long i = start + threadIdx.x; i < stop; i += kThreads) {
      wo[i] = w[i];
      s0o[i] = s0[i];
      if (K == kAdam) s1o[i] = s1[i];
    }
    return;
  }

  // four elements a thread (16 bytes of float32, 8 of bfloat16) where
  // every pointer allows it; start is a multiple of kChunk, so of 4
  uintptr_t bits = reinterpret_cast<uintptr_t>(w) |
                   reinterpret_cast<uintptr_t>(g) |
                   reinterpret_cast<uintptr_t>(s0) |
                   reinterpret_cast<uintptr_t>(wo) |
                   reinterpret_cast<uintptr_t>(s0o);
  if (K == kAdam)
    bits |= reinterpret_cast<uintptr_t>(s1) | reinterpret_cast<uintptr_t>(s1o);
  long long vec_stop = start;
  if ((bits & (4 * sizeof(T) - 1)) == 0)
    vec_stop = start + ((stop - start) & ~3LL);

  for (long long i = start + 4LL * threadIdx.x; i < vec_stop;
       i += 4LL * kThreads) {
    float wv[4], gv[4], s0v[4], s1v[4] = {0.f, 0.f, 0.f, 0.f};
    E::ld4(w, i, wv);
    E::ld4(g, i, gv);
    E::ld4(s0, i, s0v);
    if (K == kAdam) E::ld4(s1, i, s1v);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      update_one<K, T>(wv[j], gv[j], s0v[j], s1v[j], inv, gs, h, wv[j],
                       s0v[j], s1v[j]);
    E::st4(wo, i, wv);
    E::st4(s0o, i, s0v);
    if (K == kAdam) E::st4(s1o, i, s1v);
  }
  // the rest, element by element
  for (long long i = vec_stop + threadIdx.x; i < stop; i += kThreads) {
    float wn, s0n, s1n;
    update_one<K, T>(E::ld(w, i), E::ld(g, i), E::ld(s0, i),
                     K == kAdam ? E::ld(s1, i) : 0.f, inv, gs, h, wn, s0n,
                     s1n);
    E::st(wo, i, wn);
    E::st(s0o, i, s0n);
    if (K == kAdam) E::st(s1o, i, s1n);
  }
}

// the reduction's table
struct NormTable {
  int n;
  int n_grads;                 // tensors [0, n_grads) are gradients
  int base;                    // this launch's first partial
  int block_start[kMaxTensors + 1];
  long long size[kMaxTensors];
  const void* p[kMaxTensors];
  int dtype[kMaxTensors];      // 0 float32, 1 bfloat16
};

__device__ __forceinline__ float load_elt(const void* p, int dtype,
                                          long long i) {
  return dtype == 0 ? static_cast<const float*>(p)[i]
                    : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

__global__ void __launch_bounds__(kThreads)
mt_norm_kernel(const __grid_constant__ NormTable t, float inject,
               const float* __restrict__ inv_scale,
               float* __restrict__ partial, int* __restrict__ okp) {
  __shared__ float s_sum[kThreads / 32];
  __shared__ int s_ok[kThreads / 32];
  const int k = find_tensor(t.block_start, t.n, blockIdx.x);
  const long long start =
      static_cast<long long>(blockIdx.x - t.block_start[k]) * kChunk;
  const long long stop = min(start + kChunk, t.size[k]);
  const bool grad = k < t.n_grads;
  const float inv = inv_scale == nullptr ? 1.f : *inv_scale;
  const void* p = t.p[k];
  const int dtype = t.dtype[k];
  float acc = 0.f;
  int ok = 1;
  for (long long i = start + threadIdx.x; i < stop; i += kThreads) {
    float x = load_elt(p, dtype, i);
    if (grad) {
      x = __fmul_rn(x, inject);            // the nan@N multiplier
      ok &= isfinite(x) ? 1 : 0;            // on the scaled gradient
      const float u = __fmul_rn(x, inv);   // unscaled
      acc = __fmaf_rn(u, u, acc);
    } else {
      ok &= isfinite(x) ? 1 : 0;
    }
  }
  // a fixed tree: warp shuffles, then the warps' sums in order
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, off);
    ok &= __shfl_down_sync(0xffffffffu, ok, off);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    s_sum[warp] = acc;
    s_ok[warp] = ok;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    int o = 1;
    for (int i = 0; i < kThreads / 32; ++i) {
      s += s_sum[i];
      o &= s_ok[i];
    }
    partial[t.base + blockIdx.x] = s;
    okp[t.base + blockIdx.x] = o;
  }
}

__global__ void __launch_bounds__(kFinalThreads)
mt_norm_finalize(const float* __restrict__ partial,
                 const int* __restrict__ okp, int nparts, float rescale,
                 float clip, float* __restrict__ sumsq,
                 unsigned char* __restrict__ finite,
                 float* __restrict__ gscale) {
  __shared__ float s_sum[kFinalThreads / 32];
  __shared__ int s_ok[kFinalThreads / 32];
  float acc = 0.f;
  int ok = 1;
  for (int i = threadIdx.x; i < nparts; i += kFinalThreads) {
    acc += partial[i];
    ok &= okp[i];
  }
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, off);
    ok &= __shfl_down_sync(0xffffffffu, ok, off);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    s_sum[warp] = acc;
    s_ok[warp] = ok;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    int o = 1;
    for (int i = 0; i < kFinalThreads / 32; ++i) {
      s += s_sum[i];
      o &= s_ok[i];
    }
    *sumsq = s;
    *finite = static_cast<unsigned char>(o);
    // gscale = min(1, clip / max(rescale * sqrt(S), 1e-12)), NaN kept
    float q = 1.f;
    if (clip > 0.f) {
      const float gn = __fmul_rn(rescale, __fsqrt_rn(s));
      const float den = isnan(gn) ? gn : fmaxf(gn, 1e-12f);
      q = __fdiv_rn(clip, den);
      q = isnan(q) ? q : fminf(q, 1.f);
    }
    *gscale = q;
  }
}

int blocks_of(long long size) {
  return static_cast<int>((size + kChunk - 1) / kChunk);
}

template <typename T>
int update_all(int kind, int n, const long long* sizes, void* const* w,
               void* const* g, void* const* s0, void* const* s1,
               void* const* w_out, void* const* s0_out, void* const* s1_out,
               const Hyper& h, const float* lr, const float* gs,
               const float* inv,
               const unsigned char* fl, int donate, cudaStream_t st,
               int* launched) {
  for (int first = 0; first < n; first += kMaxTensors) {
    UpdateTable<T> t;
    t.n = 0;
    int blocks = 0;
    for (int i = first; i < n && t.n < kMaxTensors; ++i) {
      const int j = t.n++;
      t.block_start[j] = blocks;
      t.size[j] = sizes[i];
      t.w[j] = static_cast<const T*>(w[i]);
      t.g[j] = static_cast<const T*>(g[i]);
      t.s0[j] = static_cast<const T*>(s0[i]);
      t.s1[j] = kind == kAdam ? static_cast<const T*>(s1[i]) : nullptr;
      t.w_out[j] = static_cast<T*>(w_out[i]);
      t.s0_out[j] = static_cast<T*>(s0_out[i]);
      t.s1_out[j] = kind == kAdam ? static_cast<T*>(s1_out[i]) : nullptr;
      blocks += blocks_of(sizes[i]);
    }
    t.block_start[t.n] = blocks;
    if (blocks == 0) continue;
    if (kind == kAdam)
      mt_update_kernel<kAdam, T><<<blocks, kThreads, 0, st>>>(
          t, h, lr, gs, inv, fl, donate);
    else
      mt_update_kernel<kSgdMom, T><<<blocks, kThreads, 0, st>>>(
          t, h, lr, gs, inv, fl, donate);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launched;
  }
  return 0;
}

}  // namespace

// One fused update of n tensors (in batches of kMaxTensors). kind: 0
// sgd_mom_update, 1 adam_update. dtype: 0 float32, 1 bfloat16, for every
// w/g/s0/s1 (contiguous); *_out may alias the inputs (donate). hyper: 9
// floats (struct Hyper). lr: a float32 on the device that replaces
// hyper[0], or null. *launched: the kernels launched.
extern "C" int multi_tensor_update(int kind, int dtype, int n,
                                   const long long* sizes, void* const* w,
                                   void* const* g, void* const* s0,
                                   void* const* s1, void* const* w_out,
                                   void* const* s0_out, void* const* s1_out,
                                   const float* hyper, const void* lr,
                                   const void* gscale, const void* inv_scale,
                                   const void* flag, int donate,
                                   void* stream, int* launched) {
  const Hyper h = {hyper[0], hyper[1], hyper[2], hyper[3], hyper[4],
                   hyper[5], hyper[6], hyper[7], hyper[8]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lrp = static_cast<const float*>(lr);
  const float* gs = static_cast<const float*>(gscale);
  const float* inv = static_cast<const float*>(inv_scale);
  const unsigned char* fl = static_cast<const unsigned char*>(flag);
  *launched = 0;
  if (dtype == 1)
    return update_all<__nv_bfloat16>(kind, n, sizes, w, g, s0, s1, w_out,
                                     s0_out, s1_out, h, lrp, gs, inv, fl,
                                     donate, st, launched);
  return update_all<float>(kind, n, sizes, w, g, s0, s1, w_out, s0_out,
                           s1_out, h, lrp, gs, inv, fl, donate, st,
                           launched);
}

// Partials the reduction needs for these sizes (the workspace's length).
extern "C" int multi_tensor_norm_parts(int n, const long long* sizes) {
  int parts = 0;
  for (int i = 0; i < n; ++i) parts += blocks_of(sizes[i]);
  return parts;
}

// Sum of squares of the unscaled gradients (tensors [0, n_grads)), the
// all-finite flag over the inject-scaled gradients and the other tensors
// (loss outputs), and the clip scale. partial/okp: workspaces of
// multi_tensor_norm_parts() floats and ints. sumsq and gscale: float32
// scalars, finite: a bool scalar. *launched: the kernels launched.
extern "C" int multi_tensor_norm_finite(
    int n, int n_grads, const long long* sizes, void* const* ptrs,
    const int* dtypes, float inject, float rescale, float clip,
    const void* inv_scale, void* partial, void* okp, void* sumsq,
    void* finite, void* gscale, void* stream, int* launched) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int base = 0;
  *launched = 0;
  for (int first = 0; first < n; first += kMaxTensors) {
    NormTable t;
    t.n = 0;
    t.n_grads = 0;
    t.base = base;
    int blocks = 0;
    for (int i = first; i < n && t.n < kMaxTensors; ++i) {
      const int j = t.n++;
      if (i < n_grads) t.n_grads = j + 1;
      t.block_start[j] = blocks;
      t.size[j] = sizes[i];
      t.p[j] = ptrs[i];
      t.dtype[j] = dtypes[i];
      blocks += blocks_of(sizes[i]);
    }
    t.block_start[t.n] = blocks;
    if (blocks == 0) continue;
    mt_norm_kernel<<<blocks, kThreads, 0, st>>>(
        t, inject, static_cast<const float*>(inv_scale),
        static_cast<float*>(partial), static_cast<int*>(okp));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launched;
    base += blocks;
  }
  mt_norm_finalize<<<1, kFinalThreads, 0, st>>>(
      static_cast<const float*>(partial), static_cast<const int*>(okp), base,
      rescale, clip, static_cast<float*>(sumsq),
      static_cast<unsigned char*>(finite), static_cast<float*>(gscale));
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return static_cast<int>(err);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
