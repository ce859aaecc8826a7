// Greedy non-maximum suppression for Hopper (sm_90a), with a plain C
// interface: one thread-block cluster an image, its CTAs sharing the keep
// flags through distributed shared memory.
//
// Replaces the TPU kernel mxnet_tpu/ops/nms_pallas.py:49 _nms_kernel
// (pallas_call at :114, behind nms_keep, :95): over each image's
// score-sorted corner boxes (A, 4) f32, class ids (A,) f32 and valid
// flags (A,), the keep mask of greedy NMS. Rows go in score order; a row
// that is still alive (and valid) suppresses every later row whose IoU
// with it is >= the threshold and, unless force_suppress, whose class is
// equal. The result is exactly the dense path's
// (mxnet_tpu/ops/detection_ops.py:300-311) and the plain version's
// (ops/nms_kernels.py _nms_reference), bit for bit: the IoU is the
// source's f32 formula with every operation rounded on its own
// (__fsub_rn, __fmul_rn, __fadd_rn, __fdiv_rn, no FMA contraction), in the
// order the jnp source writes it:
//   iw = max(0, min(ax2, bx2) - max(ax1, bx1)), ih likewise,
//   inter = iw * ih,
//   union = (ax2 - ax1) * (ay2 - ay1) + (bx2 - bx1) * (by2 - by1) - inter,
//   iou = union <= 0 ? 0 : inter / max(union, 1e-12).
// Classes are compared as f32 with ==, the threshold arrives as f32 (the
// rounding jnp and torch give a Python float compared with f32 values).
// The keep mask is a pure function of the pairwise relation "row i
// suppresses later row j", so the order of the parallel tests below
// changes no bit, and no float atomic is used.
//
// Bound on the H100 (chip_smoke.py nms_bound, from a run's inputs): a
// later valid row is tested only against the rows kept before it; such a
// pair costs one class test, and an IoU test (14 f32 operations) where
// the classes are equal or force_suppress is set, at 67 TFLOP/s; against
// 2 bytes a row (valid read, keep written) and 20 more a valid row (box
// and class read) at 3.35 TB/s. Both are microseconds or less at
// SSD300's shapes (PERF.md's kernel table). What bounds the kernel is
// latency: greedy NMS is a chain over the 128-row blocks (each block's
// survivors are known only after every earlier block's), and each link
// costs barriers and dependent shared-memory reads, not bytes or flops.
// The earlier design (commit 0930d9f) ran that chain with one block an
// image, so a batch of 8 used 8 of the 132 SMs, and its walk inside a row
// block was 128 dependent shuffle + shared-load steps; measured by phase
// (tools/nms_phases.cu), the walk and the later-row tests took most of
// its time. The cluster spreads the later-row tests over kCluster SMs an
// image and shortens the walk to the contested rows.
//
// Design. The TPU kernel walks a sequential grid of 128-row blocks and
// carries the keep mask from one grid step to the next through
// input/output aliasing. Here each image gets one cluster of kCluster
// CTAs of 1024 threads (grid kCluster * B, cluster dims (kCluster, 1, 1),
// through cudaLaunchKernelEx), so a batch of 8 runs on 8 * kCluster SMs:
// - Ownership: 32-row chunk c belongs to CTA c % kCluster (interleaved,
//   so every CTA owns a share of any row range). The owner keeps its
//   chunks' keep flags as one 32-bit word a chunk in its shared memory,
//   and its rows' boxes and classes there too (copied in by cp.async), as
//   far as they fit (all of SSD300's 8732 rows: 1120 rows, 22.5 KB a
//   CTA). Rows past that cache (A of tens of thousands and more) are read
//   through L2.
// - Start: each CTA reads its own chunks' valid flags (a ballot a warp),
//   and the cluster agrees on end = last valid row + 1 by a max over the
//   CTAs' shared memory after a cluster barrier. Rows at or past end are
//   never read.
// - One step per 128-row block b below end, in order, the same in every
//   CTA. Read b's four flag words from their owners' shared memory
//   (cluster.map_shared_rank); b's rows and its class table (class ->
//   the block's rows of it, hashed in shared memory) were made during the
//   last step. A block with no live row is skipped (every CTA sees the
//   same words, so the skip is uniform across the cluster). Else:
//   * bits: 1024 threads build the block's suppression bits by column
//     (bit j of row i: earlier live row j suppresses live row i), 16
//     pairs a thread, only pairs of one class unless force_suppress (a
//     table lookup); a row with any bit is "contested".
//   * walk, in one thread: uncontested live rows live; the contested ones
//     go in order, each alive unless (col[i] & alive). The chain is a few
//     integer operations a contested row: no shuffle, no dependent load.
//   * suppression: each CTA tests the later live rows it owns, below end,
//     against the block's survivors of the row's class (one table lookup
//     a row), T = 8, 4, 2 or 1 threads a row (as many as the CTA's later
//     rows leave room for) each taking every T-th survivor; a warp's
//     ballot clears its rows' flags (an integer atomicAnd on the word).
//   * one cluster barrier (arrive.release / wait.acquire) ends the step;
//     the next block's rows (loaded into registers at the step's start)
//     are stored and entered in its class table between the arrival and
//     the wait, and after it the owners store block b's survivors.
// - End: a last cluster barrier (no CTA exits while another may read its
//   shared memory), then each CTA writes its chunks' flags to keep_out
//   (rows past end keep their valid flag, 0).
// - An IoU test is settled without the division unless its quotient lies
//   within 2^-16 of the threshold (iou_suppresses below).
// Measured on an H100 80GB HBM3 (700 W), tools/nms_variants.py, PERF.md:
// at B 8, A 8732 this kernel takes 0.019 ms with the top 400 rows valid
// and 0.57 ms with every row valid, against 0.060 and 8.03 ms for the
// one-block-an-image design in the same run. kCluster = 8, the portable
// size: the card runs 15 such clusters at once (22.5 KB of shared memory
// a CTA), so a batch of 8 fits one wave. At 16 it ran 7 at once, a batch
// of 8 took two waves, and the times were 0.042 and 0.89 ms (against
// 0.020 and 0.60 at 8 in that run).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBlock = 128;               // rows per row block (the TPU's)
constexpr int kWords = kBlock / 32;       // 32-row chunks of a row block
constexpr int kThreads = 1024;            // = kBlock * 8 bit tasks
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;               // CTAs an image
constexpr int kMaxAnchors = 200000;       // ops/nms_kernels.py MAX_ANCHORS
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kHashBits = 8;              // class table: 256 slots for at
constexpr int kHash = 1 << kHashBits;     // most 128 classes a row block

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

// The same decision for a pair whose classes already match (or under
// force), with the rows' areas passed in (area(): the same __fmul_rn of
// the same differences) and the division replaced by an
// approximate quotient q (rcp.approx, then one multiply: within 2^-22 of
// inter / union, relative) wherever q is more than 2^-16 from thr: there
// the rounded quotient lies on the same side of thr as q, so the decision
// is suppresses()'s bit for bit. Pairs nearer the threshold, and any
// threshold or union outside the normal range, go to suppresses() itself.
struct Thr {
  float thr, lo, hi;   // thr * (1 -+ 2^-16)
  bool fast;           // thr positive and normal: the screen applies
};

__device__ __forceinline__ Thr make_thr(float thr) {
  return {thr, __fmul_rn(thr, 1.f - 0x1p-16f), __fmul_rn(thr, 1.f + 0x1p-16f),
          thr >= 1e-30f && thr <= 1e30f};
}

__device__ __forceinline__ float area(float4 a) {
  return __fmul_rn(__fsub_rn(a.z, a.x), __fsub_rn(a.w, a.y));
}

__device__ __forceinline__ bool iou_suppresses(float4 a, float area_a,
                                               float4 b, float area_b,
                                               const Thr& t) {
  if (t.fast) {
    const float iw = fmaxf(0.f, __fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)));
    const float ih = fmaxf(0.f, __fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)));
    const float inter = __fmul_rn(iw, ih);
    if (inter == 0.f) return false;                // IoU 0 (or NaN) < thr
    const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
    if (uni <= 0.f) return false;                  // IoU 0 < thr
    if (uni < 1e30f) {                             // normal, not NaN
      float r;
      asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(fmaxf(uni, 1e-12f)));
      const float q = __fmul_rn(inter, r);
      if (q >= t.hi) return true;
      if (q <= t.lo) return false;
    }
  }
  return suppresses(a, 0.f, b, 0.f, t.thr, 1);
}

// Does any row of the set m (bit k: row base + k of the block's rows sb,
// with areas sa) suppress row b (area ab)? Classes are settled in m.
__device__ __forceinline__ bool any_suppresses(uint64_t m, int base,
                                               const float4* sb,
                                               const float* sa, float4 b,
                                               float ab, const Thr& t) {
  while (m) {
    const int s = base + __ffsll((long long)m) - 1;
    m &= m - 1;
    if (iou_suppresses(sb[s], sa[s], b, ab, t)) return true;
  }
  return false;
}

// The cluster barrier, as its two halves: every thread of the cluster
// arrives, then waits; the CTA's shared-memory writes before its arrival
// are visible to the cluster's reads after the wait.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_barrier() {
  cluster_arrive();
  cluster_wait();
}

// The class table of a row block: open addressing over kHash slots, the
// key a class's f32 bits (-0 as +0), the value the mask of the block's
// rows (below end) of that class. Keys compare as the classes do under
// ==: a NaN class is never entered and never found (NaN == x is false),
// and kEmpty, a NaN pattern, is no key.
constexpr uint32_t kEmpty = 0xffffffffu;

__device__ __forceinline__ uint32_t class_slot(uint32_t key) {
  return (key * 2654435761u) >> (32 - kHashBits);
}

__device__ __forceinline__ uint32_t class_key(float c) {
  return c == 0.f ? 0u : __float_as_uint(c);
}

// Thread t < 128 enters row t of the block, of class c, when `enter`.
__device__ __forceinline__ void table_insert(uint32_t* keys, uint4* masks,
                                             float c, bool enter) {
  if (!enter || c != c) return;
  const uint32_t key = class_key(c);
  for (uint32_t h = class_slot(key);; h = (h + 1) & (kHash - 1)) {
    const uint32_t prev = atomicCAS(&keys[h], kEmpty, key);
    if (prev == kEmpty || prev == key) {
      atomicOr(reinterpret_cast<uint32_t*>(&masks[h]) + (threadIdx.x >> 5),
               1u << (threadIdx.x & 31));
      return;
    }
  }
}

// Threads 256..511 empty a table.
__device__ __forceinline__ void clear_table(uint32_t* keys, uint4* masks) {
  const int h = (int)threadIdx.x - 2 * kBlock;
  if (h >= 0 && h < kHash) {
    keys[h] = kEmpty;
    masks[h] = make_uint4(0u, 0u, 0u, 0u);
  }
}

__device__ __forceinline__ uint4 table_find(const uint32_t* keys,
                                            const uint4* masks, float c) {
  if (c != c) return make_uint4(0u, 0u, 0u, 0u);
  const uint32_t key = class_key(c);
  for (uint32_t h = class_slot(key);; h = (h + 1) & (kHash - 1)) {
    const uint32_t k = keys[h];
    if (k == key) return masks[h];
    if (k == kEmpty) return make_uint4(0u, 0u, 0u, 0u);
  }
}

// Copy `bytes` (4 or 16) from global to shared memory, asynchronously.
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(d), "l"(src) : "memory");
}

// Built with -DNMS_STAMPS (tools/nms_variants.py --phases), thread 0 of
// image 0's first CTA records clock64() at each phase boundary; the
// library the port loads has none of it.
#ifdef NMS_STAMPS
constexpr int kStamps = 4096;
__device__ long long nms_stamps[kStamps];
#define STAMP(slot, value)                                              \
  do {                                                                  \
    if (blockIdx.x == 0 && threadIdx.x == 0 && (slot) < kStamps)        \
      nms_stamps[(slot)] = (value);                                     \
  } while (0)
#define STAMP_SYNC() __syncthreads()
__device__ __forceinline__ long long gtimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#else
#define STAMP(slot, value) \
  do {                     \
  } while (0)
#define STAMP_SYNC() \
  do {               \
  } while (0)
#endif

// The CTA's share of image blockIdx.x / kCluster. nlc: its 32-row chunks
// (chunk lc here is the image's chunk lc * kCluster + rank); cap: how many
// of its rows (a multiple of 32, from the first) have their box and class
// in shared memory.
__global__ void __launch_bounds__(kThreads, 1)
nms_cluster_kernel(const float4* __restrict__ boxes,
                   const float* __restrict__ cls,
                   const uint8_t* __restrict__ valid,
                   uint8_t* __restrict__ keep_out, int A, float thr,
                   int force, int nlc, int cap) {
  extern __shared__ float4 dyn[];
  float4* cbox = dyn;                                     // [cap]
  float* ccls = reinterpret_cast<float*>(dyn + cap);      // [cap]
  uint32_t* kw = reinterpret_cast<uint32_t*>(ccls + cap);  // [nlc] flags
  // the row block's rows and flag words, double-buffered by the block's
  // parity (a thread may start block b + 1 while another still reads b)
  __shared__ float4 sblk[2][kBlock];
  __shared__ __align__(16) float sbcls[2][kBlock];
  __shared__ float sbarea[2][kBlock];
  __shared__ __align__(16) uint32_t slive[2][kWords];
  __shared__ __align__(16) uint32_t salive[2][kWords];  // the survivors
  __shared__ __align__(16) uint32_t scont[2][kWords];   // contested rows
  __shared__ uint32_t hkey[2][kHash];        // the class tables
  __shared__ uint4 hmask[2][kHash];
  __shared__ uint4 col[kBlock];              // bit j of row i: j kills i
  __shared__ int s_last;                     // this CTA's last valid row

  STAMP(0, clock64());
  STAMP(4, gtimer());
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t base = (size_t)(blockIdx.x / kCluster) * A;
  boxes += base;
  cls += base;
  valid += base;
  keep_out += base;
  const int nchunks = (A + 31) / 32;
  const Thr t = make_thr(thr);

  // the valid flags of this CTA's chunks
  if (tid == 0) s_last = -1;
  __syncthreads();
  int my_last = -1;
  for (int lc = warp; lc < nlc; lc += kWarps) {
    const int c = lc * kCluster + rank;
    const int j = c * 32 + lane;
    const uint32_t w = __ballot_sync(0xffffffffu, j < A && valid[j] != 0);
    if (lane == 0) kw[lc] = w;
    if (w) my_last = c * 32 + 31 - __clz(w);
  }
  if (lane == 0 && my_last >= 0) atomicMax(&s_last, my_last);
  cluster_barrier();
  // rows past the cluster's last valid one are never alive or read
  int last = lane < kCluster ? *cluster.map_shared_rank(&s_last, lane) : -1;
  const int end = __reduce_max_sync(0xffffffffu, last) + 1;
  const int nce = (end + 31) / 32;          // chunks below end
  const int lc_end = nce > rank ? (nce - rank + kCluster - 1) / kCluster : 0;

  // this CTA's rows below end into the shared-memory cache, by cp.async:
  // the copies land while the first step runs, and each step waits for
  // them before its suppression
  for (int lc = warp; lc < lc_end && lc * 32 < cap; lc += kWarps) {
    const int j = (lc * kCluster + rank) * 32 + lane;
    if (j < end) {
      cp_async(cbox + lc * 32 + lane, boxes + j, 16);
      cp_async(ccls + lc * 32 + lane, cls + j, 4);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  STAMP(1, clock64());

  int steps = 0;                            // live row blocks so far
  int fetched = -1;                         // block whose rows are loaded
  const int nblocks = (end + kBlock - 1) / kBlock;
  for (int b = 0; b < nblocks; ++b) {
    const int par = b & 1;
    // the block's rows and class table, unless the last step's barrier
    // window made them (block 0, and a block after a skipped one)
    if (b != fetched) {
      clear_table(hkey[par], hmask[par]);
      const int r = b * kBlock + tid;
      if (tid < kBlock && r < end) {
        const float4 box = boxes[r];
        sblk[par][tid] = box;
        sbcls[par][tid] = cls[r];
        sbarea[par][tid] = area(box);
      }
      __syncthreads();
      if (!force && tid < kBlock)
        table_insert(hkey[par], hmask[par], sbcls[par][tid],
                     b * kBlock + tid < end);
    }
    // its flags from their owners; the contested rows and the next
    // block's class table cleared
    if (tid >= kBlock && tid < kBlock + kWords) {
      const int w = tid - kBlock, c = b * kWords + w;
      slive[par][w] =
          c < nchunks ? *cluster.map_shared_rank(kw + c / kCluster,
                                                 c % kCluster)
                      : 0u;
      scont[par][w] = 0u;
    }
    clear_table(hkey[par ^ 1], hmask[par ^ 1]);
    __syncthreads();
    const uint4 live = *reinterpret_cast<const uint4*>(slive[par]);
    if (!(live.x | live.y | live.z | live.w)) continue;   // no change
    const int st [[maybe_unused]] = 8 + 6 * steps++;   // stamp slots
    STAMP(st, clock64());
    // the next block's rows, into registers while this step runs
    const int nr = (b + 1) * kBlock + tid;
    const bool pre = tid < kBlock && nr < end;
    float4 nbox = make_float4(0.f, 0.f, 0.f, 0.f);
    float ncls = 0.f;
    if (pre) {
      nbox = boxes[nr];
      ncls = cls[nr];
    }

    // suppression bits by column: thread (i, part) tests the earlier
    // live rows j in [16 part, 16 part + 16) of i's class (any class
    // under force) against live row i; a row with a bit is contested
    {
      const int i = tid >> 3, part = tid & 7, j0 = part * 16;
      const uint32_t li = slive[par][i >> 5], lj = slive[par][part >> 1];
      uint32_t bits = 0;
      if (((li >> (i & 31)) & 1u) && j0 < i) {
        const int sh = (part & 1) * 16;
        uint32_t m = (lj >> sh) & 0xffffu;
        if (i - j0 < 16) m &= (1u << (i - j0)) - 1u;
        const float ci = sbcls[par][i];
        if (!force) {
          const uint4 same = table_find(hkey[par], hmask[par], ci);
          const int w = part >> 1;
          m &= (w == 0 ? same.x : w == 1 ? same.y : w == 2 ? same.z : same.w)
               >> sh;
        }
        const float4 bi = sblk[par][i];
        const float ai = sbarea[par][i];
        while (m) {
          const int k = __ffs(m) - 1;
          m &= m - 1;
          if (iou_suppresses(sblk[par][j0 + k], sbarea[par][j0 + k], bi, ai,
                             t))
            bits |= 1u << (k + sh);
        }
      }
      bits |= __shfl_xor_sync(0xffffffffu, bits, 1);
      if (!(part & 1)) {
        reinterpret_cast<uint32_t*>(&col[i])[part >> 1] = bits;
        if (bits) atomicOr(&scont[par][i >> 5], 1u << (i & 31));
      }
    }
    __syncthreads();
    STAMP(st + 1, clock64());

    asm volatile("cp.async.wait_all;\n" ::: "memory");   // the row cache
    // the walk, in one thread: an uncontested live row lives; the
    // contested ones go in order, each alive unless (col[i] & alive)
    if (tid == 0) {
      const uint4 cont = *reinterpret_cast<const uint4*>(scont[par]);
      const uint32_t cw[kWords] = {cont.x, cont.y, cont.z, cont.w};
      uint32_t a[kWords] = {live.x & ~cont.x, live.y & ~cont.y,
                            live.z & ~cont.z, live.w & ~cont.w};
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        for (uint32_t m = cw[w]; m; m &= m - 1) {
          const int k = __ffs(m) - 1;
          const uint4 ci = col[w * 32 + k];
          a[w] |= (uint32_t)(((ci.x & a[0]) | (ci.y & a[1]) | (ci.z & a[2]) |
                              (ci.w & a[3])) == 0u)
                  << k;
        }
      }
      *reinterpret_cast<uint4*>(salive[par]) = make_uint4(a[0], a[1], a[2],
                                                          a[3]);
    }
    __syncthreads();
    STAMP(st + 2, clock64());

    // the survivors suppress this CTA's later live rows below end, T
    // threads a row (T = 8, 4, 2 or 1, as many as the rows leave room
    // for), each over every T-th survivor of the row's class; a row's T
    // threads sit in one warp, whose ballot clears the suppressed rows'
    // flags
    const uint4 alive = *reinterpret_cast<const uint4*>(salive[par]);
    const int cfirst = (b + 1) * kWords - rank;
    const int lc0 = cfirst > 0 ? (cfirst + kCluster - 1) / kCluster : 0;
    const int nrows = lc_end > lc0 ? (lc_end - lc0) * 32 : 0;
    const int lg = nrows * 8 <= kThreads   ? 3
                   : nrows * 4 <= kThreads ? 2
                   : nrows * 2 <= kThreads ? 1
                                           : 0;
    const uint64_t every = lg == 3   ? 0x0101010101010101ull
                           : lg == 2 ? 0x1111111111111111ull
                           : lg == 1 ? 0x5555555555555555ull
                                     : ~0ull;
    const uint64_t mine = every << (lane & ((1 << lg) - 1));
    for (int q = tid >> lg; q < nrows; q += kThreads >> lg) {
      const int lr = lc0 * 32 + q, lc = lr >> 5;
      const uint32_t w = kw[lc];                 // one chunk a warp
      if (!w) continue;                          // warp-uniform
      bool hit = false;
      if ((w >> (lr & 31)) & 1u) {
        const int j = (lc * kCluster + rank) * 32 + (lr & 31);
        const bool cached = lr < cap;
        const float4 bj = cached ? cbox[lr] : boxes[j];
        const float cj = cached ? ccls[lr] : cls[j];
        const float aj = area(bj);
        uint4 m = alive;
        if (!force) {
          const uint4 same = table_find(hkey[par], hmask[par], cj);
          m = make_uint4(m.x & same.x, m.y & same.y, m.z & same.z,
                         m.w & same.w);
        }
        hit = any_suppresses((m.x | (uint64_t)m.y << 32) & mine, 0,
                             sblk[par], sbarea[par], bj, aj, t) ||
              any_suppresses((m.z | (uint64_t)m.w << 32) & mine, 64,
                             sblk[par], sbarea[par], bj, aj, t);
      }
      const uint32_t hits = __ballot_sync(0xffffffffu, hit);
      if (lane == 0 && hits) {
        uint32_t rows = hits;                    // lanes -> the warp's rows
        if (lg) {
          rows = 0;
          for (int r = 0; r < (32 >> lg); ++r)
            if ((hits >> (r << lg)) & ((1u << (1 << lg)) - 1u))
              rows |= 1u << r;
        }
        atomicAnd(&kw[lc], ~(rows << (lr & 31)));
      }
    }
    STAMP_SYNC();
    STAMP(st + 3, clock64());
    // one cluster barrier ends the step; the next block's rows, loaded
    // into registers at the step's start, are stored between its arrival
    // and its wait (the other parity's buffers are free: block b - 1's
    // readers are past this step's first sync)
    cluster_arrive();
    if (pre) {
      sblk[par ^ 1][tid] = nbox;
      sbcls[par ^ 1][tid] = ncls;
      sbarea[par ^ 1][tid] = area(nbox);
    }
    if (!force && tid < kBlock)
      table_insert(hkey[par ^ 1], hmask[par ^ 1], ncls, pre);
    fetched = b + 1;
    cluster_wait();
    STAMP(st + 4, clock64());
    // block b's flags are read by no CTA after the barrier: the owners
    // store its survivors
    if (tid < kWords) {
      const int c = b * kWords + tid;
      if (c % kCluster == rank && c < nchunks)
        kw[c / kCluster] = salive[par][tid];
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");   // none in flight
  cluster_barrier();
  STAMP(6, clock64());

  for (int lc = warp; lc < nlc; lc += kWarps) {
    const int j = (lc * kCluster + rank) * 32 + lane;
    if (j < A) keep_out[j] = (kw[lc] >> lane) & 1u;
  }
  STAMP(2, steps);
  STAMP_SYNC();
  STAMP(3, clock64());
  STAMP(5, gtimer());
}

// The launch for B images of A rows: nlc 32-row chunks a CTA, cap rows
// cached a CTA, smem bytes of dynamic shared memory a CTA, and the launch
// configuration (grid kCluster * B, cluster dims (kCluster, 1, 1)).
struct Launch {
  int nlc, cap, smem;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute cluster;
};

// Fill *L and set the kernel's attributes for it; a cudaError_t code.
int prepare(int B, int A, void* stream, Launch* L) {
  static int static_smem = -1;
  if (static_smem < 0) {
    cudaFuncAttributes fa;
    const cudaError_t e = cudaFuncGetAttributes(&fa, nms_cluster_kernel);
    if (e != cudaSuccess) return (int)e;
    static_smem = (int)fa.sharedSizeBytes;
  }
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  constexpr int kRowBytes = 20;             // box 16, class 4
  L->nlc = ((A + 31) / 32 + kCluster - 1) / kCluster;
  const int words = (L->nlc * 4 + 15) & ~15;
  const int room = optin - static_smem - words;
  if (room < 0) return (int)cudaErrorInvalidValue;
  L->cap = L->nlc * 32 < room / kRowBytes ? L->nlc * 32
                                          : (room / kRowBytes) & ~31;
  L->smem = L->cap * kRowBytes + words;
  if (L->smem > kDefaultSmem) {
    e = cudaFuncSetAttribute(nms_cluster_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L->smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (kCluster > 8) {
    e = cudaFuncSetAttribute(nms_cluster_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
    if (e != cudaSuccess) return (int)e;
  }
  L->cfg = {};
  L->cfg.gridDim = dim3(kCluster * B);
  L->cfg.blockDim = dim3(kThreads);
  L->cfg.dynamicSmemBytes = L->smem;
  L->cfg.stream = static_cast<cudaStream_t>(stream);
  L->cluster.id = cudaLaunchAttributeClusterDimension;
  L->cluster.val.clusterDim.x = kCluster;
  L->cluster.val.clusterDim.y = 1;
  L->cluster.val.clusterDim.z = 1;
  L->cfg.attrs = &L->cluster;
  L->cfg.numAttrs = 1;
  return 0;
}

}  // namespace

// boxes (B, A, 4) f32, 16-byte aligned; cls (B, A) f32; valid (B, A) and
// keep (B, A) one byte a row (torch.bool). One launch for the batch, one
// cluster of kCluster CTAs an image, on `stream`. Returns a cudaError_t
// code (0 = launched).
extern "C" int nms_keep(const void* boxes, const float* cls,
                        const uint8_t* valid, uint8_t* keep, int B, int A,
                        float thr, int force_suppress, void* stream) {
  if (B <= 0 || A <= 0 || A > kMaxAnchors || B > INT_MAX / kCluster ||
      reinterpret_cast<uintptr_t>(boxes) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Launch L;
  const int rc = prepare(B, A, stream, &L);
  if (rc) return rc;
  const cudaError_t e = cudaLaunchKernelEx(
      &L.cfg, nms_cluster_kernel, static_cast<const float4*>(boxes), cls,
      valid, keep, A, thr, (int)(force_suppress != 0), L.nlc, L.cap);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The launch shape nms_keep uses for A rows an image, into out[4]: CTAs
// an image (the cluster size), dynamic shared memory bytes a CTA, rows a
// CTA caches in shared memory, and the most clusters of that shape the
// current device runs at once (cudaOccupancyMaxActiveClusters). Returns a
// cudaError_t code.
extern "C" int nms_launch_shape(int A, int* out) {
  if (A <= 0 || A > kMaxAnchors) return (int)cudaErrorInvalidValue;
  Launch L;
  const int rc = prepare(1, A, nullptr, &L);
  if (rc) return rc;
  int clusters = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveClusters(&clusters, nms_cluster_kernel, &L.cfg);
  if (e != cudaSuccess) return (int)e;
  out[0] = kCluster;
  out[1] = L.smem;
  out[2] = L.cap;
  out[3] = clusters;
  return 0;
}

#ifdef NMS_STAMPS
// The stamps of the last launch (kStamps int64) into host memory.
extern "C" int nms_read_stamps(long long* host) {
  return (int)cudaMemcpyFromSymbol(host, nms_stamps, sizeof(nms_stamps));
}
#endif

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
