// Greedy non-maximum suppression for Hopper (sm_90a), with a plain C
// interface.
//
// Replaces the TPU kernel mxnet_tpu/ops/nms_pallas.py:49 _nms_kernel
// (behind nms_keep, :95): over each image's score-sorted corner boxes
// (A, 4) f32, class ids (A,) f32 and valid flags (A,), the keep mask of
// greedy NMS. Rows go in score order; a row that is still alive (and
// valid) suppresses every later row whose IoU with it is >= the
// threshold and, unless force_suppress, whose class is equal. The result
// is exactly the dense path's (mxnet_tpu/ops/detection_ops.py:300-311)
// and the plain version's (ops/nms_kernels.py _nms_reference), bit for
// bit: the IoU is the source's f32 formula with every operation rounded
// on its own (__fsub_rn, __fmul_rn, __fadd_rn, __fdiv_rn, no FMA
// contraction), in the order the jnp source writes it:
//   iw = max(0, min(ax2, bx2) - max(ax1, bx1)), ih likewise,
//   inter = iw * ih,
//   union = (ax2 - ax1) * (ay2 - ay1) + (bx2 - bx1) * (by2 - by1) - inter,
//   iou = union <= 0 ? 0 : inter / max(union, 1e-12).
// Classes are compared as f32 with ==, the threshold arrives as f32 (the
// rounding jnp and torch give a Python float compared with f32 values).
//
// Bound on the H100 (chip_smoke.py nms_bound, from a run's inputs): a
// later valid row is tested only against the rows kept before it; such
// a pair costs one class test, and an IoU test (14 f32 operations) where
// the classes are equal or force_suppress is set, at 67 TFLOP/s; against
// 2 bytes a row (valid read, keep written) and 20 more a valid row (box
// and class read) at 3.35 TB/s. Its values at SSD300's shapes are in
// PERF.md's kernel table. The kernel is bound by
// latency, not by the card: greedy NMS is sequential in the rows, and
// this design gives each image one block, so a batch of 8 uses 8 of the
// 132 SMs. Using more SMs per image (a cluster sharing the keep flags
// through distributed shared memory, or a parallel pass of suppression
// bitmasks over all SMs) is later work.
//
// Design. The TPU kernel walks a sequential grid of 128-row blocks and
// carries the keep mask from one grid step to the next through
// input/output aliasing. Blocks here run in parallel and in no order, so
// the greedy order lives inside one block per image:
// - The keep flags sit in dynamic shared memory, one byte a row (8.7 KB at
//   8732 rows); above 48 KB the launch raises the block's shared-memory
//   limit, up to kMaxAnchors rows, past which the entry refuses.
// - The block walks the rows in blocks of 128 in order. A row block with
//   no live row changes nothing and is skipped (under nms_topk = 400, 65
//   of SSD300's 69 row blocks); the walk stops after the last valid row.
// - Intra-block step: the 1024 threads build the 128 x 128 suppression
//   bits of the block's live rows against its later rows in parallel into
//   shared memory (16 pairs a thread); then one warp walks the 128 rows in
//   order, each of four lanes holding 32 keep bits, a live row clearing
//   the bits it suppresses.
// - Inter-block step: the block's survivors are compacted in row order
//   (boxes and classes); each warp then takes later live rows up to the
//   last valid row, its lanes testing 32 survivors at a time, and clears
//   a row's flag as soon as one suppresses it.
// - Pairs of another class (unless force_suppress) and pairs that do not
//   intersect are settled before the areas and the division.
// - Boxes and classes of later rows are read through L2 (140 KB + 35 KB
//   an image at 8732 rows). Rows past A are never read.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;               // rows per row block (the TPU's)
constexpr int kWords = kBlock / 32;       // 32-bit words of a row's bits
constexpr int kThreads = 1024;           // = kBlock * kWords * 2 bit tasks
constexpr int kWarps = kThreads / 32;
constexpr int kMaxAnchors = 200000;       // keep flags in shared memory
                                          // (ops/nms_kernels.py MAX_ANCHORS)
constexpr int kDefaultSmem = 48 * 1024;

// Does row a (class ca) suppress row b (class cb)? IoU(a, b) >= thr and,
// unless force, ca == cb, with the IoU's f32 operations each rounded on
// its own, in the jnp source's order. A pair that does not intersect
// (inter == 0, so the IoU is 0, or NaN when the union is) is settled
// before the areas and the division when thr > 0: 0 >= thr is false.
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
nms_kernel(const float4* __restrict__ boxes, const float* __restrict__ cls,
           const uint8_t* __restrict__ valid, uint8_t* __restrict__ keep_out,
           int A, float thr, int force) {
  extern __shared__ uint8_t keep[];          // A flags, 0 or 1
  __shared__ float4 sbox[kBlock];            // the row block's rows
  __shared__ float scls[kBlock];
  __shared__ uint32_t sup[kBlock][kWords];   // bit j of row i: i kills j
  __shared__ float4 vbox[kBlock];            // its survivors, in row order
  __shared__ float vcls[kBlock];
  __shared__ int n_surv;
  __shared__ int last_valid;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
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
  // rows past the last valid one are never alive and never suppress
  const int end = last_valid + 1;

  for (int offs = 0; offs < end; offs += kBlock) {
    const int n = min(kBlock, A - offs);
    const int live = tid < n ? keep[offs + tid] : 0;
    if (!__syncthreads_or(live)) continue;    // nothing alive: no change
    if (tid < n) {
      sbox[tid] = boxes[offs + tid];
      scls[tid] = cls[offs + tid];
    }
    __syncthreads();

    // the block's live rows against its later rows: one thread for each
    // half of each row's word, 16 pairs a thread
    {
      const int i = tid / (kWords * 2), word = (tid / 2) % kWords;
      const int k0 = (tid & 1) * 16;
      uint32_t bits = 0;
      if (i < n && keep[offs + i]) {
        const float4 bi = sbox[i];
        const float ci = scls[i];
        for (int k = k0; k < k0 + 16; ++k) {
          const int j = word * 32 + k;
          if (j > i && j < n &&
              suppresses(bi, ci, sbox[j], scls[j], thr, force))
            bits |= 1u << k;
        }
      }
      bits |= __shfl_xor_sync(0xffffffffu, bits, 1);
      if ((tid & 1) == 0) sup[i][word] = bits;
    }
    __syncthreads();

    // one warp walks the block's rows in order
    if (warp == 0) {
      uint32_t km = 0;      // lane w < kWords: keep bits of rows 32w..32w+31
      if (lane < kWords) {
        for (int k = 0; k < 32; ++k) {
          const int j = lane * 32 + k;
          if (j < n && keep[offs + j]) km |= 1u << k;
        }
      }
      for (int i = 0; i < n; ++i) {
        const uint32_t owner = __shfl_sync(0xffffffffu, km, i >> 5);
        if ((owner >> (i & 31)) & 1u) {       // row i alive (warp-uniform)
          if (lane < kWords) km &= ~sup[i][lane];
        }
      }
      if (lane < kWords) {
        for (int k = 0; k < 32; ++k) {
          const int j = lane * 32 + k;
          if (j < n) keep[offs + j] = (km >> k) & 1u;
        }
      }
      // the survivors' rows in row order: an exclusive prefix of the
      // lanes' counts
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
    }
    __syncthreads();

    // the survivors suppress every later live row: a warp per row, its
    // lanes over the survivors
    const int ns = n_surv;
    for (int j = offs + kBlock + warp; j < end; j += kWarps) {
      if (!keep[j]) continue;                 // warp-uniform
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
  }

  for (int j = tid; j < A; j += kThreads) keep_out[j] = keep[j];
}

}  // namespace

// boxes (B, A, 4) f32, 16-byte aligned; cls (B, A) f32; valid (B, A) and
// keep (B, A) one byte a row (torch.bool). One launch for the batch, one
// block an image, on `stream`. Returns a cudaError_t code (0 = launched).
extern "C" int nms_keep(const void* boxes, const float* cls,
                        const uint8_t* valid, uint8_t* keep, int B, int A,
                        float thr, int force_suppress, void* stream) {
  if (B <= 0 || A <= 0 || A > kMaxAnchors ||
      reinterpret_cast<uintptr_t>(boxes) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int smem = (A + 15) & ~15;
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  nms_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), cls, valid, keep, A, thr,
      force_suppress != 0);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
