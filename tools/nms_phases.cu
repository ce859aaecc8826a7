// The greedy-NMS kernel of commit 0930d9f (one 1024-thread block an image),
// unchanged but for clock64() stamps at each phase boundary of image 0's
// block, for tools/nms_variants.py --phases. Not part of the port: it
// splits the old kernel's time by phase where no ncu or nsys runs.
//
// stamps (int64), written by thread 0 of image 0's block:
//   [0], [1]  %globaltimer (ns) at the start and at the end, to convert
//             cycles to time;
//   [2]       clock64() at the start; [3] after the pass over the valid
//             flags; [4] the number of live row blocks recorded; [5]
//             clock64() at the end, after the keep flags are written;
//   [6 + 5k ...] for the k-th live row block: after the box load, after
//             the suppression bits, after the walk, after the compaction,
//             after the inter-block step.
// The arithmetic is csrc/nms.cu's at commit 0930d9f.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;
constexpr int kWords = kBlock / 32;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxAnchors = 200000;
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxStamps = 4096;

__device__ __forceinline__ long long gtimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ bool suppresses(float4 a, float ca, float4 b,
                                           float cb, float thr, int force) {
  if (!force && ca != cb) return false;
  const float iw = fmaxf(0.f, __fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)));
  const float ih = fmaxf(0.f, __fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)));
  const float inter = __fmul_rn(iw, ih);
  if (inter == 0.f && thr > 0.f) return false;
  const float area_a = __fmul_rn(__fsub_rn(a.z, a.x), __fsub_rn(a.w, a.y));
  const float area_b = __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  const float iou = uni <= 0.f ? 0.f : __fdiv_rn(inter, fmaxf(uni, 1e-12f));
  return iou >= thr;
}

__global__ void __launch_bounds__(kThreads)
nms_phases_kernel(const float4* __restrict__ boxes,
                  const float* __restrict__ cls,
                  const uint8_t* __restrict__ valid,
                  uint8_t* __restrict__ keep_out, int A, float thr, int force,
                  long long* __restrict__ stamps) {
  extern __shared__ uint8_t keep[];
  __shared__ float4 sbox[kBlock];
  __shared__ float scls[kBlock];
  __shared__ uint32_t sup[kBlock][kWords];
  __shared__ float4 vbox[kBlock];
  __shared__ float vcls[kBlock];
  __shared__ int n_surv;
  __shared__ int last_valid;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool rec = blockIdx.x == 0 && tid == 0;
  int k = 0;                                  // live blocks recorded
  auto stamp = [&](int slot) {
    const int at = 6 + 5 * k + slot;
    if (rec && at < kMaxStamps) stamps[at] = clock64();
  };
  if (rec) {
    stamps[0] = gtimer();
    stamps[2] = clock64();
  }
  const size_t base = (size_t)blockIdx.x * A;
  boxes += base;
  cls += base;
  valid += base;
  keep_out += base;

  if (tid == 0) last_valid = -1;
  __syncthreads();
  int my_last = -1;
  for (int j = tid; j < A; j += kThreads) {
    const uint8_t v = valid[j] != 0;
    keep[j] = v;
    if (v) my_last = j;
  }
  my_last = __reduce_max_sync(0xffffffffu, my_last);
  if (lane == 0) atomicMax(&last_valid, my_last);
  __syncthreads();
  if (rec) stamps[3] = clock64();
  const int end = last_valid + 1;

  for (int offs = 0; offs < end; offs += kBlock) {
    const int n = min(kBlock, A - offs);
    const int live = tid < n ? keep[offs + tid] : 0;
    if (!__syncthreads_or(live)) continue;
    if (tid < n) {
      sbox[tid] = boxes[offs + tid];
      scls[tid] = cls[offs + tid];
    }
    __syncthreads();
    stamp(0);

    {
      const int i = tid / (kWords * 2), word = (tid / 2) % kWords;
      const int k0 = (tid & 1) * 16;
      uint32_t bits = 0;
      if (i < n && keep[offs + i]) {
        const float4 bi = sbox[i];
        const float ci = scls[i];
        for (int kk = k0; kk < k0 + 16; ++kk) {
          const int j = word * 32 + kk;
          if (j > i && j < n &&
              suppresses(bi, ci, sbox[j], scls[j], thr, force))
            bits |= 1u << kk;
        }
      }
      bits |= __shfl_xor_sync(0xffffffffu, bits, 1);
      if ((tid & 1) == 0) sup[i][word] = bits;
    }
    __syncthreads();
    stamp(1);

    if (warp == 0) {
      uint32_t km = 0;
      if (lane < kWords) {
        for (int kk = 0; kk < 32; ++kk) {
          const int j = lane * 32 + kk;
          if (j < n && keep[offs + j]) km |= 1u << kk;
        }
      }
      for (int i = 0; i < n; ++i) {
        const uint32_t owner = __shfl_sync(0xffffffffu, km, i >> 5);
        if ((owner >> (i & 31)) & 1u) {
          if (lane < kWords) km &= ~sup[i][lane];
        }
      }
      __syncwarp();
      stamp(2);
      if (lane < kWords) {
        for (int kk = 0; kk < 32; ++kk) {
          const int j = lane * 32 + kk;
          if (j < n) keep[offs + j] = (km >> kk) & 1u;
        }
      }
      const int cnt = lane < kWords ? __popc(km) : 0;
      int incl = cnt;
      for (int d = 1; d < 32; d <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += t;
      }
      int pos = incl - cnt;
      for (uint32_t m = km; m; m &= m - 1, ++pos) {
        const int i = lane * 32 + __ffs(m) - 1;
        vbox[pos] = sbox[i];
        vcls[pos] = scls[i];
      }
      if (lane == 31) n_surv = incl;
      __syncwarp();
      stamp(3);
    }
    __syncthreads();

    const int ns = n_surv;
    for (int j = offs + kBlock + warp; j < end; j += kWarps) {
      if (!keep[j]) continue;
      const float4 bj = boxes[j];
      const float cj = cls[j];
      for (int s0 = 0; s0 < ns; s0 += 32) {
        const int s = s0 + lane;
        const bool hit =
            s < ns && suppresses(vbox[s], vcls[s], bj, cj, thr, force);
        if (__any_sync(0xffffffffu, hit)) {
          if (lane == 0) keep[j] = 0;
          break;
        }
      }
    }
    __syncthreads();
    stamp(4);
    ++k;
  }

  for (int j = tid; j < A; j += kThreads) keep_out[j] = keep[j];
  __syncthreads();
  if (rec) {
    stamps[4] = k;
    stamps[5] = clock64();
    stamps[1] = gtimer();
  }
}

}  // namespace

// As csrc/nms.cu's nms_keep at 0930d9f, with `stamps` (kMaxStamps int64 on
// the card) filled for image 0.
extern "C" int nms_keep_phases(const void* boxes, const float* cls,
                               const uint8_t* valid, uint8_t* keep, int B,
                               int A, float thr, int force_suppress,
                               long long* stamps, void* stream) {
  if (B <= 0 || A <= 0 || A > kMaxAnchors ||
      reinterpret_cast<uintptr_t>(boxes) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int smem = (A + 15) & ~15;
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        nms_phases_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  nms_phases_kernel<<<B, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), cls, valid, keep, A, thr,
      force_suppress != 0, stamps);
  return (int)cudaGetLastError();
}

extern "C" int nms_phases_capacity() { return kMaxStamps; }

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
