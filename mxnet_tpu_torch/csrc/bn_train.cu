// BatchNorm training kernels for Hopper (sm_90a), with a plain C interface.
//
// Replaces the four kernels of mxnet_tpu/ops/bn_pallas.py (custom VJP
// bn_train_pallas), each over an NCHW input viewed as (N, C, HW):
//   bn_stats       <- _stats_kernel:      s1 = sum(x - c), s2 = sum((x - c)^2)
//                                          per channel, c a per-channel shift
//   bn_apply       <- _apply_kernel:      y = x * a + b per channel
//   bn_bwd_reduce  <- _bwd_reduce_kernel: db = sum(dy), dxc = sum(dy * (x - mean))
//   bn_bwd_dx      <- _bwd_dx_kernel:     dx = dy * a + (x - mean) * c2 + b
// x, dy, y and dx are f32 or bf16 (dy, y and dx in x's dtype); every
// per-channel operand and every sum is f32.
//
// Bound on the H100: each kernel does a few flops per element and moves
// every element once (stats reads x; apply reads x and writes y; the
// backward reduce reads dy and x; dx reads dy and x and writes dx), so all
// four are bound by device-memory bytes: at ResNet-50's stage-2 shape
// (128, 256, 56, 56) in bf16, 205.5 MB per tensor, 0.061 ms per tensor
// pass at 3.35 TB/s. The design's aim is to move each byte once with
// enough loads in flight, and nothing more.
//
// Design. The TPU kernels walk a sequential grid over N and carry the sums
// in VMEM from one sample to the next; blocks here run in parallel and in
// no order, so:
// - The reductions split each channel's N*HW elements into S slabs and run
//   a (C, S) grid with S chosen for about 8 blocks per SM. A block walks its
//   slab with a cursor that steps over row ends without a division per
//   element (a channel is N rows of HW contiguous values, C*HW apart), keeps
//   several loads in flight, sums in f32 registers, then reduces by warp
//   shuffles and shared memory. Partials go to a (2, C, S) workspace and a
//   second kernel sums each channel's S partials in a fixed order: no float
//   atomics, so the result is the same on every run. Rows whose length is a
//   multiple of the 16-byte vector (HW % 8 for bf16, % 4 for f32) are read
//   16 bytes a thread; others (HW = 49 or 196 at ResNet's deep stages, where
//   a row of 98 or 392 bytes does not start on a 16-byte boundary) element
//   by element.
// - apply and dx are one flat elementwise pass over the contiguous N*C*HW
//   buffer, 16 bytes a thread (the buffer's base is 16-byte aligned; the
//   ragged tail goes element by element); the channel of each element is
//   (index / HW) % C, advanced per element without a division, and the
//   per-channel coefficients are read through the cache. Arithmetic is f32
//   in the plain version's order with one rounding per operation (no fused
//   multiply-add), and the result rounds once at the store.
// What it does not do yet: fuse the shift's first-sample mean into the
// stats pass, or fuse apply/dx into the neighbouring convolutions; that is
// a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTargetBlocks = 132 * 8;   // about 8 reduction blocks per SM
constexpr long long kMinSlab = 2048;     // elements: at least 8 a thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}

// One load unit: V consecutive elements, as a 16-byte vector when V > 1.
template <typename T, int V>
__device__ __forceinline__ void load_unit(const T* __restrict__ base,
                                          long long unit, float (&out)[V]) {
  if constexpr (V == 1) {
    out[0] = to_f32(base[unit]);
  } else {
    static_assert(V * sizeof(T) == 16, "a vector unit is 16 bytes");
    const uint4 raw = reinterpret_cast<const uint4*>(base)[unit];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int k = 0; k < V; ++k) out[k] = to_f32(e[k]);
  }
}

// Step the slab cursor by `step` units: `off` is the unit's offset in the
// (N, C, HWu) buffer and `i` its position in its row of `hwu` units; a step
// is `sn` whole rows and `si` units, and crossing a row end jumps to the
// same channel's next row (`rs` = C * hwu units later).
__device__ __forceinline__ void advance(long long& off, long long& i,
                                        long long sn, long long si,
                                        long long rs, long long hwu) {
  i += si;
  off += sn * rs + si;
  if (i >= hwu) {
    i -= hwu;
    off += rs - hwu;
  }
}

// The two per-channel sums of one (channel, slab) block.
// MODE 0 (stats): p = x, center = the shift c: (x - c, (x - c)^2).
// MODE 1 (backward reduce): p = dy, q = x, center = mean:
//   (dy, dy * (x - mean)).
template <typename T, int MODE, int V>
__device__ __forceinline__ void reduce_slab(
    const T* __restrict__ p, const T* __restrict__ q,
    const float* __restrict__ center, float* __restrict__ work, int C,
    long long hwu, long long mu, long long chunk, int S) {
  constexpr int U = V == 1 ? 8 : 4;   // units in flight per thread
  const int c = blockIdx.x;
  const int s = blockIdx.y;
  const float ctr = center[c];
  const long long start = (long long)s * chunk;
  const long long end = min(mu, start + chunk);
  const long long rs = (long long)C * hwu;
  const long long step = blockDim.x;
  const long long sn = step / hwu, si = step - sn * hwu;
  float a0 = 0.f, a1 = 0.f;
  long long j = start + threadIdx.x;
  if (j < end) {
    long long n = j / hwu;
    long long i = j - n * hwu;
    long long off = n * rs + (long long)c * hwu + i;
    for (; j + (U - 1) * step < end; j += U * step) {
      long long o[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        o[u] = off;
        advance(off, i, sn, si, rs, hwu);
      }
      float v[U][V], w[U][V];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        load_unit<T, V>(p, o[u], v[u]);
        if constexpr (MODE == 1) load_unit<T, V>(q, o[u], w[u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          if constexpr (MODE == 0) {
            const float t = v[u][k] - ctr;
            a0 += t;
            a1 += t * t;
          } else {
            a0 += v[u][k];
            a1 += v[u][k] * (w[u][k] - ctr);
          }
        }
      }
    }
    for (; j < end; j += step) {
      float v[V], w[V];
      load_unit<T, V>(p, off, v);
      if constexpr (MODE == 1) load_unit<T, V>(q, off, w);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        if constexpr (MODE == 0) {
          const float t = v[k] - ctr;
          a0 += t;
          a1 += t * t;
        } else {
          a0 += v[k];
          a1 += v[k] * (w[k] - ctr);
        }
      }
      advance(off, i, sn, si, rs, hwu);
    }
  }
  __shared__ float part[2][kWarps];
  a0 = warp_sum(a0);
  a1 = warp_sum(a1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    part[0][warp] = a0;
    part[1][warp] = a1;
  }
  __syncthreads();
  if (warp == 0) {
    a0 = lane < kWarps ? part[0][lane] : 0.f;
    a1 = lane < kWarps ? part[1][lane] : 0.f;
    a0 = warp_sum(a0);
    a1 = warp_sum(a1);
    if (lane == 0) {
      work[(long long)c * S + s] = a0;
      work[(long long)C * S + (long long)c * S + s] = a1;
    }
  }
}

#define BN_REDUCE_KERNEL(NAME, T, MODE)                                      \
  template <int V>                                                           \
  __global__ void __launch_bounds__(kThreads) NAME(                          \
      const T* __restrict__ p, const T* __restrict__ q,                      \
      const float* __restrict__ center, float* __restrict__ work, int C,     \
      long long hwu, long long mu, long long chunk, int S) {                 \
    reduce_slab<T, MODE, V>(p, q, center, work, C, hwu, mu, chunk, S);       \
  }

BN_REDUCE_KERNEL(bn_stats_f32, float, 0)
BN_REDUCE_KERNEL(bn_stats_bf16, __nv_bfloat16, 0)
BN_REDUCE_KERNEL(bn_bwd_reduce_f32, float, 1)
BN_REDUCE_KERNEL(bn_bwd_reduce_bf16, __nv_bfloat16, 1)

// Sum each channel's S partials in a fixed order: one warp per channel,
// lanes over slabs, then the shuffle tree.
__global__ void __launch_bounds__(kThreads)
bn_finalize(const float* __restrict__ work, float* __restrict__ out0,
            float* __restrict__ out1, int C, int S) {
  const int c = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (c >= C) return;
  float r0 = 0.f, r1 = 0.f;
  for (int k = lane; k < S; k += 32) {
    r0 += work[(long long)c * S + k];
    r1 += work[(long long)C * S + (long long)c * S + k];
  }
  r0 = warp_sum(r0);
  r1 = warp_sum(r1);
  if (lane == 0) {
    out0[c] = r0;
    out1[c] = r1;
  }
}

// y = x * a + b (MODE 0, the apply pass) or
// dx = dy * a + (x - mean) * c2 + b (MODE 1, the dx pass), per element of
// the flat (N, C, HW) buffer. p = x (MODE 0) or dy (MODE 1); q = x.
template <typename T, int MODE>
__device__ __forceinline__ float eltwise(float pv, float qv, int ch,
                                         const float* __restrict__ a,
                                         const float* __restrict__ c2,
                                         const float* __restrict__ b,
                                         const float* __restrict__ mean) {
  if constexpr (MODE == 0) {
    return __fadd_rn(__fmul_rn(pv, a[ch]), b[ch]);
  } else {
    const float xc = __fsub_rn(qv, mean[ch]);
    return __fadd_rn(__fadd_rn(__fmul_rn(pv, a[ch]), __fmul_rn(xc, c2[ch])),
                     b[ch]);
  }
}

template <typename T, int MODE>
__device__ __forceinline__ void eltwise_pass(
    const T* __restrict__ p, const T* __restrict__ q,
    const float* __restrict__ a, const float* __restrict__ c2,
    const float* __restrict__ b, const float* __restrict__ mean,
    T* __restrict__ out, long long total, int C, int HW) {
  constexpr int V = 16 / sizeof(T);
  const long long nvec = total / V;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long u = tid; u < nvec; u += stride) {
    const long long e = u * V;
    const long long row = e / HW;
    int r = (int)(e - row * HW);
    int ch = (int)(row % C);
    float pv[V], qv[V];
    load_unit<T, V>(p, u, pv);
    if constexpr (MODE == 1) load_unit<T, V>(q, u, qv);
    uint4 raw;
    T* o = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      o[k] = from_f32<T>(eltwise<T, MODE>(
          pv[k], MODE == 1 ? qv[k] : 0.f, ch, a, c2, b, mean));
      if (++r == HW) {
        r = 0;
        if (++ch == C) ch = 0;
      }
    }
    reinterpret_cast<uint4*>(out)[u] = raw;
  }
  for (long long e = nvec * V + tid; e < total; e += stride) {
    const int ch = (int)((e / HW) % C);
    const float qv = MODE == 1 ? to_f32(q[e]) : 0.f;
    out[e] = from_f32<T>(eltwise<T, MODE>(to_f32(p[e]), qv, ch, a, c2, b,
                                          mean));
  }
}

#define BN_ELTWISE_KERNEL(NAME, T, MODE)                                     \
  __global__ void __launch_bounds__(kThreads) NAME(                          \
      const T* __restrict__ p, const T* __restrict__ q,                      \
      const float* __restrict__ a, const float* __restrict__ c2,             \
      const float* __restrict__ b, const float* __restrict__ mean,           \
      T* __restrict__ out, long long total, int C, int HW) {                 \
    eltwise_pass<T, MODE>(p, q, a, c2, b, mean, out, total, C, HW);          \
  }

BN_ELTWISE_KERNEL(bn_apply_f32, float, 0)
BN_ELTWISE_KERNEL(bn_apply_bf16, __nv_bfloat16, 0)
BN_ELTWISE_KERNEL(bn_bwd_dx_f32, float, 1)
BN_ELTWISE_KERNEL(bn_bwd_dx_bf16, __nv_bfloat16, 1)

bool bad_shape(int n, int c, int hw) { return n <= 0 || c <= 0 || hw <= 0; }

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

// Slabs per channel: enough (C, S) blocks for about 8 per SM, none smaller
// than kMinSlab elements, within the grid's y limit.
int slabs(int n, int c, int hw) {
  const long long m = (long long)n * hw;
  long long s = (kTargetBlocks + c - 1) / c;
  const long long by_work = (m + kMinSlab - 1) / kMinSlab;
  if (s > by_work) s = by_work;
  if (s < 1) s = 1;
  if (s > 65535) s = 65535;
  return (int)s;
}

template <typename T>
using ReduceKernel = void (*)(const T*, const T*, const float*, float*, int,
                              long long, long long, long long, int);

// Launch a reduction's partial kernel (KV in 16-byte units when every row
// is a whole number of them and the operands are aligned, else K1 element
// by element) and its finalize.
template <typename T>
int launch_reduce(ReduceKernel<T> KV, ReduceKernel<T> K1, const void* p,
                  const void* q, const float* center, float* out0,
                  float* out1, float* work, int n, int c, int hw,
                  cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const int S = slabs(n, c, hw);
  const bool vec = hw % V == 0 && aligned16(p) && (!q || aligned16(q));
  const long long hwu = vec ? hw / V : hw;
  const long long mu = (long long)n * hwu;
  const long long chunk = (mu + S - 1) / S;
  const dim3 grid(c, S);
  (vec ? KV : K1)<<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(p), static_cast<const T*>(q), center, work, c,
      hwu, mu, chunk, S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int warps_per_block = kThreads / 32;
  bn_finalize<<<(c + warps_per_block - 1) / warps_per_block, kThreads, 0,
                st>>>(work, out0, out1, c, S);
  return (int)cudaGetLastError();
}

int eltwise_blocks(long long total, int vec) {
  long long units = (total + vec - 1) / vec;
  long long blocks = (units + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  return blocks < 1 ? 1 : (int)blocks;
}

}  // namespace

extern "C" int bn_slabs(int n, int c, int hw) {
  return bad_shape(n, c, hw) ? 0 : slabs(n, c, hw);
}

extern "C" int bn_stats(const void* x, const float* shift, float* s1,
                        float* s2, float* work, int n, int c, int hw,
                        int dtype, void* stream) {
  if (bad_shape(n, c, hw)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_reduce<float>(bn_stats_f32<4>, bn_stats_f32<1>, x,
                                nullptr, shift, s1, s2, work, n, c, hw, st);
  if (dtype == 1)
    return launch_reduce<__nv_bfloat16>(bn_stats_bf16<8>, bn_stats_bf16<1>,
                                        x, nullptr, shift, s1, s2, work, n,
                                        c, hw, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int bn_bwd_reduce(const void* dy, const void* x,
                             const float* mean, float* db, float* dxc,
                             float* work, int n, int c, int hw, int dtype,
                             void* stream) {
  if (bad_shape(n, c, hw)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_reduce<float>(bn_bwd_reduce_f32<4>, bn_bwd_reduce_f32<1>,
                                dy, x, mean, db, dxc, work, n, c, hw, st);
  if (dtype == 1)
    return launch_reduce<__nv_bfloat16>(bn_bwd_reduce_bf16<8>,
                                        bn_bwd_reduce_bf16<1>, dy, x, mean,
                                        db, dxc, work, n, c, hw, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int bn_apply(const void* x, const float* a, const float* b,
                        void* y, int n, int c, int hw, int dtype,
                        void* stream) {
  if (bad_shape(n, c, hw) || !aligned16(x) || !aligned16(y))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long total = (long long)n * c * hw;
  if (dtype == 0) {
    bn_apply_f32<<<eltwise_blocks(total, 4), kThreads, 0, st>>>(
        static_cast<const float*>(x), nullptr, a, nullptr, b, nullptr,
        static_cast<float*>(y), total, c, hw);
  } else if (dtype == 1) {
    bn_apply_bf16<<<eltwise_blocks(total, 8), kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), nullptr, a, nullptr, b,
        nullptr, static_cast<__nv_bfloat16*>(y), total, c, hw);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int bn_bwd_dx(const void* dy, const void* x, const float* a,
                         const float* c2, const float* b, const float* mean,
                         void* dx, int n, int c, int hw, int dtype,
                         void* stream) {
  if (bad_shape(n, c, hw) || !aligned16(dy) || !aligned16(x) ||
      !aligned16(dx))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long total = (long long)n * c * hw;
  if (dtype == 0) {
    bn_bwd_dx_f32<<<eltwise_blocks(total, 4), kThreads, 0, st>>>(
        static_cast<const float*>(dy), static_cast<const float*>(x), a, c2,
        b, mean, static_cast<float*>(dx), total, c, hw);
  } else if (dtype == 1) {
    bn_bwd_dx_bf16<<<eltwise_blocks(total, 8), kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(dy),
        static_cast<const __nv_bfloat16*>(x), a, c2, b, mean,
        static_cast<__nv_bfloat16*>(dx), total, c, hw);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
