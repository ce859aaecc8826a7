// Flash-attention forward for Hopper (sm_90a), with a plain C interface.
//
// Replaces mxnet_tpu/ops/attention.py:_flash_fwd_kernel (wrapper
// _flash_forward). It computes what that kernel computes:
//   o[r] = sum_c softmax_c(scale * q[r].k[c]) v[c] over the valid columns c,
// with the running max, denominator and accumulator in f32; masking by
// _band_valid (causal, sliding window, band_offset) and by the ragged key
// tail; tiles wholly outside the band skipped as _band_run does; p rounded
// to V's dtype before the PV product while the denominator sums the
// unrounded p; fully-masked rows give 0 through max(l, 1e-30) and an lse of
// -1e30; and the optional per-row lse = m + log(l) as one f32 per row (the
// TPU kernel replicates it over 128 lanes).
//
// Bound on the H100 at the flagship shape (B*H = 128, T = Tk = 2048,
// D = 128, bf16, causal): 4*BH*D*T*(T+1)/2 = 137 GFLOP of matrix work,
// 0.14 ms at 989 TFLOP/s, against 268 MB of q/k/v/o traffic, 0.08 ms at
// 3.35 TB/s: operations. So the design keeps the (T, T) scores out of
// device memory, skips the tiles above the causal diagonal, and spends its
// effort on keeping the tensor cores fed.
//
// Design of flash_fwd_bf16 (persistent: one CTA an SM, 384 threads):
// - Work. A work unit is two 128-row q tiles of one head, nq - 1 - j and
//   j: under the causal mask every unit then has the same length, so the
//   units, strided over the CTAs, keep them balanced without a queue, and
//   neighbouring CTAs walk the same head, whose K and V stay in L2 (every
//   q tile of a head reads them again; an order that spread a wave over
//   128 heads was HBM-bound, 0.43 against 0.31 ms). A tile walks the
//   128-key K/V tiles that meet its band ([kt0, kt1), a contiguous run).
//   Being persistent, one tile's epilogue and the next tile's loads
//   overlap (4% over one CTA a tile, which ordered the longest rows first).
// - Warp specialisation. Warpgroup 0 gives its registers away (setmaxnreg
//   24); its thread 0 issues every TMA load: per tile Q (once the last
//   tile's S products are done with it) and K and V per K/V tile into a
//   2-stage ring that runs on across tiles, K and V each with their own
//   full and empty mbarriers, so the S product starts as soon as K lands.
//   Warpgroups 1 and 2 are the consumers, 64 q rows each, at 240 registers
//   (24 * 128 + 240 * 256 fits the 168 * 384 of the launch; 1.5% faster
//   than 40 / 232). The TMA maps are 3-D over (BH, T, D), so a ragged tail
//   and the head dims past D read zeros and never the next head's rows; a
//   box is one 128-byte swizzled panel (64 bf16 columns) of 128 rows. DP
//   (16, 32, 64, 128) sets the depth of the S product; tiles are
//   NP = max(DP, 64) columns wide, whole panels, and the PV product and O
//   are NP wide (the columns past D are zeros, clipped by the O map).
//   Shared memory at D = 128: Q 32 KB, O 32 KB, the ring 128 KB.
// - Products on wgmma with f32 accumulation. S = Q K^T (m64n128, both
//   operands in shared memory, K-major). O += P V with P from registers:
//   the S accumulator of k-step j (columns 16 j .. 16 j + 15) is already
//   the A fragment of k-step j (mma.sync's m16n8k16 A layout per warp), so
//   p is rounded to bf16 and packed in place, without shared memory; V is
//   the N-major B operand (LBO = panel stride, SBO = 1024).
// - Overlap, two ways. (1) Ping-pong: the two consumers take turns on the
//   tensor cores under two named barriers; a turn issues one tile's
//   products, then hands the turn over, so one warpgroup's softmax runs
//   while the other's products run. A tile starts in step: consumer 1
//   arrives on a third barrier when it reaches the tile, and consumer 0's
//   first turn waits there instead of on its turn barrier; after its
//   last turn consumer 0 takes consumer 1's last hand-over. So on every
//   barrier the arrivals strictly alternate with the syncs (consumer 1
//   arrives again only after a turn of its own, which needs consumer 0's
//   hand-over, which follows consumer 0's last sync there). Carrying the
//   turn across tiles instead, so that consumer 0 starts a tile without
//   waiting for consumer 1 to reach it, measured 6% slower. (2) Within a warpgroup, a turn issues
//   S of tile j together with PV of tile j - 1, and the softmax of tile j
//   runs while that PV is in flight (S 64 + P 32 + O 64 registers a thread
//   at D = 128). Every consumer issues the same wgmma sequence; nothing a
//   wgmma depends on branches on the warpgroup. Ping-pong alone bought 1%
//   (the softmax's latency, not its tensor time, is what it hides).
// - Softmax in base 2 on ex2.approx: the row max is taken over the raw
//   scores and scaled once, and scale * log2 e folds into one FFMA before
//   each ex2 (4% faster than scaling every score first; it needs scale > 0,
//   which the wrapper guarantees exactly by flipping the sign of k); rows
//   reduced by quad shuffles in the accumulator layout. Only the tiles
//   that cross the band's edge or the ragged tail (a CTA-wide test) pay for
//   a per-element mask, which sets the score to -1e30. A row whose max is
//   still -1e30 subtracts 0 instead (a select), so its masked scores give
//   p = exp2(-1e30) = 0 and never exp(-1e30 - (-1e30)) = 1.
// - Epilogue: o / max(l, 1e-30) (a reciprocal a row and a multiply an
//   element: 11% faster than dividing every element) as bf16 into the
//   warpgroup's rows of the O buffer (once its last store has read them),
//   then one TMA store a
//   panel, left to finish while the next tile runs; rows past T and
//   columns past D are clipped by the map. lse only when asked. Every
//   output row has one owner: two launches give the same bits.
//
// The f32 path is exact float32 FMA on the CUDA cores (one warp per q row,
// lanes over keys for S and over head dims for PV): tensor-core TF32 would
// change the numbers.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's masked-score value
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ bool band_valid(int row, int col, int tk,
                                           int causal, int window,
                                           int off) {
  if (col >= tk) return false;  // ragged tail: padded keys are masked
  if (!causal) return true;
  const int r = row + off;
  if (r < col) return false;
  if (window && r - col >= window) return false;
  return true;
}

// The (q tile x k tile) rectangle meets the causal band (_band_run).
__device__ __forceinline__ bool band_run(int q0, int bq, int k0, int bk,
                                         int causal, int window, int off) {
  if (!causal) return true;
  bool run = q0 + bq - 1 + off >= k0;
  if (window) run = run && (k0 + bk - 1 > q0 + off - window);
  return run;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, s));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}

// ---------------------------------------------------------------------------
// bf16: TMA, mbarriers, wgmma, warp specialisation, ping-pong
// ---------------------------------------------------------------------------

constexpr int kBQ = 128;            // q rows per CTA, 64 per consumer
constexpr int kBK = 128;            // keys per K/V tile
constexpr int kStages = 2;          // depth of the K/V ring
constexpr int kFwdThreads = 384;    // producer warpgroup + 2 consumers

template <int DP>
struct Fwd {  // shared-memory plan; every tile starts on 1024 bytes
  static constexpr int NP = DP < 64 ? 64 : DP;   // stored width (columns)
  static constexpr int NPAN = NP / 64;           // 128-byte panels a row
  static constexpr int QPANEL = kBQ * kRow;      // one panel of Q (and O)
  static constexpr int KPANEL = kBK * kRow;      // one panel of K or V
  static constexpr int Q_BYTES = NPAN * QPANEL;
  static constexpr int KV_BYTES = NPAN * KPANEL;
  static constexpr int OFF_Q = 0;
  static constexpr int OFF_O = Q_BYTES;                      // O staging
  static constexpr int OFF_K = 2 * Q_BYTES;                  // ring
  static constexpr int OFF_V = OFF_K + kStages * KV_BYTES;   // ring
  static constexpr int OFF_BAR = OFF_V + kStages * KV_BYTES; // mbarriers
  static constexpr size_t SMEM = OFF_BAR + (4 * kStages + 3) * 8 + 1024;
};

// Every pair of the rectangle is valid: no per-element mask needed (rows
// past T are never stored, so they do not count)
__device__ __forceinline__ bool tile_full(int q0, int bq, int k0, int bk,
                                          int tk, int causal, int window,
                                          int off) {
  if (k0 + bk > tk) return false;
  if (!causal) return true;
  return q0 + off >= k0 + bk - 1 &&
         (!window || q0 + bq - 1 + off - k0 < window);
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// keep the compiler from moving accesses of wgmma A fragments across
// fences and waits (a wgmma reads them until its group completes)
template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// The thread's two rows of a 64 x 128 score tile, in the accumulator
// layout (element 4 n + e: row 16 wi + g + 8 (e >= 2), column
// 8 n + 2 t4 + (e & 1)).
struct Rows {
  float m0, m1;  // running max of the scaled scores (base 2)
  float l0, l1;  // this thread's part of the running denominator
  float a0, a1;  // rescale of O owed by the last tile's max
};

// One tile's online softmax over the raw scores s (masked to -1e30 on an
// edge tile): the row max of s (quad shuffles), scaled by sl = scale
// log2 e > 0 (the wrapper makes the scale positive), the rescale a =
// 2^(m_old - m_new), p = 2^(s sl - m) (one FFMA and one ex2) left in s,
// and l = l a + sum p. `lo`, `hi` bound the valid columns of each row
// (only read when `edge`).
template <int N>
__device__ __forceinline__ void softmax_tile(float (&s)[N], Rows& r, float sl,
                                             bool edge, int col0, int lo0,
                                             int hi0, int lo1, int hi1) {
  float mx0 = kNegInf, mx1 = kNegInf;
  if (edge) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int col = col0 + 8 * (i / 4) + (i & 1);
      const bool ok = (i & 2) ? (col >= lo1) & (col <= hi1)
                              : (col >= lo0) & (col <= hi0);
      s[i] = ok ? s[i] : kNegInf;
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i & 2)
      mx1 = fmaxf(mx1, s[i]);
    else
      mx0 = fmaxf(mx0, s[i]);
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  mx0 = mx0 == kNegInf ? kNegInf : mx0 * sl;  // in base 2; -1e30 kept
  mx1 = mx1 == kNegInf ? kNegInf : mx1 * sl;
  const float mn0 = fmaxf(r.m0, mx0), mn1 = fmaxf(r.m1, mx1);
  r.a0 = fast_exp2(r.m0 - mn0);
  r.a1 = fast_exp2(r.m1 - mn1);
  r.m0 = mn0;
  r.m1 = mn1;
  // a row with no valid column yet subtracts 0: its -1e30 give p = 0
  const float u0 = mn0 == kNegInf ? 0.f : mn0;
  const float u1 = mn1 == kNegInf ? 0.f : mn1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float p = fast_exp2(fmaf(s[i], sl, -((i & 2) ? u1 : u0)));
    s[i] = p;
    if (i & 2)
      sum1 += p;
    else
      sum0 += p;
  }
  r.l0 = r.l0 * r.a0 + sum0;
  r.l1 = r.l1 * r.a1 + sum1;
}

// p (the S accumulator, 64 x 128) rounded to bf16 as the A fragments of the
// PV product's eight k-steps
__device__ __forceinline__ void pack_p(const float (&s)[64],
                                       uint32_t (&pf)[kBK / 16][4]) {
#pragma unroll
  for (int j = 0; j < kBK / 16; ++j) {
    pf[j][0] = pack_bf16(s[8 * j], s[8 * j + 1]);
    pf[j][1] = pack_bf16(s[8 * j + 2], s[8 * j + 3]);
    pf[j][2] = pack_bf16(s[8 * j + 4], s[8 * j + 5]);
    pf[j][3] = pack_bf16(s[8 * j + 6], s[8 * j + 7]);
  }
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], const Rows& r) {
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] *= (i & 2) ? r.a1 : r.a0;
}

// S = Q K^T over depth DP: both K-major, k-step kk 32 (kk % 4) bytes into
// panel kk / 4
template <int DP>
__device__ __forceinline__ void s_product(float (&s)[64], uint64_t dsc_q,
                                          uint64_t dsc_k) {
  using L = Fwd<DP>;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    wgmma_ss<0, 0>(s, desc_at(dsc_q, (kk / 4) * L::QPANEL + (kk % 4) * 32),
                   desc_at(dsc_k, (kk / 4) * L::KPANEL + (kk % 4) * 32),
                   kk > 0);
}

// O += P V over the tile's 128 keys: V N-major, k-step j 16 j rows in
template <int N>
__device__ __forceinline__ void pv_product(float (&o)[N],
                                           const uint32_t (&pf)[kBK / 16][4],
                                           uint64_t dsc_v) {
#pragma unroll
  for (int j = 0; j < kBK / 16; ++j)
    wgmma_rs<1>(o, pf[j], desc_at(dsc_v, j * 16 * kRow), 1);
}

// Named barriers: 0 is __syncthreads; 2 + w is consumer w's turn on the
// tensor cores (its 128 threads sync, the other consumer's 128 arrive);
// 4 + w gathers consumer w before its O store.
constexpr int kTurnBar = 2;
constexpr int kStoreBar = 4;
constexpr int kTileBar = 6;

// Tile h of work unit u (q tiles nq - 1 - j, then j, of head u / npairs;
// see the note at the top) and the K/V tiles that meet its band
struct Work {
  int bh, q0, kt0, n_it;
};

__device__ __forceinline__ Work work_of(int u, int h, int npairs, int nq,
                                        int nk, int causal, int window,
                                        int off) {
  Work wk;
  const int j = u % npairs;
  wk.bh = u / npairs;
  wk.q0 = (h ? j : nq - 1 - j) * kBQ;
  int kt0 = 0;
  while (kt0 < nk &&
         !band_run(wk.q0, kBQ, kt0 * kBK, kBK, causal, window, off))
    ++kt0;
  int kt1 = kt0;
  while (kt1 < nk &&
         band_run(wk.q0, kBQ, kt1 * kBK, kBK, causal, window, off))
    ++kt1;
  wk.kt0 = kt0;
  wk.n_it = kt1 - kt0;
  return wk;
}

// The CTA's work items t = 2 u + h run u = blockIdx.x, blockIdx.x + grid,
// ..., h = 0, 1 each; the second tile of a unit whose two tiles are one
// (the middle of an odd nq) is empty.
__device__ __forceinline__ int next_work(int t) {
  return (t & 1) ? t + 2 * (int)gridDim.x - 1 : t + 1;
}

__device__ __forceinline__ bool empty_work(int t, int npairs, int nq) {
  const int j = (t / 2) % npairs;
  return (t & 1) && j == nq - 1 - j;
}

template <int DP>
__global__ void __launch_bounds__(kFwdThreads, 1)
    flash_fwd_bf16(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_o,
                   float* __restrict__ lse, int BH, int T, int Tk,
                   float scale, int causal, int window, int off) {
  using L = Fwd<DP>;
  constexpr int NP = L::NP;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full_k = reinterpret_cast<uint64_t*>(sm + L::OFF_BAR);
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty_k = full_v + kStages;
  uint64_t* empty_v = empty_k + kStages;
  uint64_t* qfull = empty_v + kStages;
  uint64_t* qempty = qfull + 1;
  uint64_t* sink = qempty + 1;  // arrivals that release nothing

  const int nq = (T + kBQ - 1) / kBQ;
  const int nk = (Tk + kBK - 1) / kBK;
  const int npairs = (nq + 1) / 2;
  const int n_work = BH * npairs * 2;  // (unit, h) pairs, some empty

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_k[s], 1);     // the producer's arrival + TMA bytes
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], 256);  // every consumer thread
      mbar_init(&empty_v[s], 256);
    }
    mbar_init(qfull, 1);
    mbar_init(qempty, 256);
    mbar_init(sink, 256);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread loads, the rest leave ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int kv = 0, qc = 0;
      for (int t = 2 * blockIdx.x; t < n_work; t = next_work(t)) {
        if (empty_work(t, npairs, nq)) continue;
        const Work wk =
            work_of(t / 2, t & 1, npairs, nq, nk, causal, window, off);
        for (int it = 0; it < wk.n_it; ++it, ++kv) {
          const int s = kv % kStages, ph = ((kv / kStages) & 1) ^ 1;
          const int k0 = (wk.kt0 + it) * kBK;
          mbar_wait(&empty_k[s], ph);
          mbar_expect_tx(&full_k[s], L::KV_BYTES);
          mbar_arrive(&full_k[s]);
          for (int p = 0; p < L::NPAN; ++p)
            tma_load_3d(sm + L::OFF_K + s * L::KV_BYTES + p * L::KPANEL,
                        &tm_k, &full_k[s], 64 * p, k0, wk.bh);
          if (it == 0) {  // Q, once the last tile's S products are done
            mbar_wait(qempty, (qc & 1) ^ 1);
            mbar_expect_tx(qfull, L::Q_BYTES);
            mbar_arrive(qfull);
            for (int p = 0; p < L::NPAN; ++p)
              tma_load_3d(sm + L::OFF_Q + p * L::QPANEL, &tm_q, qfull,
                          64 * p, wk.q0, wk.bh);
            ++qc;
          }
          mbar_wait(&empty_v[s], ph);
          mbar_expect_tx(&full_v[s], L::KV_BYTES);
          mbar_arrive(&full_v[s]);
          for (int p = 0; p < L::NPAN; ++p)
            tma_load_3d(sm + L::OFF_V + s * L::KV_BYTES + p * L::KPANEL,
                        &tm_v, &full_v[s], 64 * p, k0, wk.bh);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: q rows [q0 + 64 w, q0 + 64 w + 64) ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int w = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int wi = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
    const float sl = scale * kLog2e;
    const uint64_t dsc_q =
        gmma_desc(smem_addr(sm + L::OFF_Q) + 64 * w * kRow, 16, 1024);
    const uint64_t dsc_k0 = gmma_desc(smem_addr(sm + L::OFF_K), 16, 1024);
    const uint64_t dsc_v0 =
        gmma_desc(smem_addr(sm + L::OFF_V), L::KPANEL, 1024);
    const int me = kTurnBar + w, other = kTurnBar + 1 - w;
    int kv = 0, qc = 0;

    for (int t = 2 * blockIdx.x; t < n_work; t = next_work(t)) {
      if (empty_work(t, npairs, nq)) continue;
      const Work wk =
          work_of(t / 2, t & 1, npairs, nq, nk, causal, window, off);
      const int q0 = wk.q0, kt0 = wk.kt0, n_it = wk.n_it;
      const int row0 = q0 + 64 * w + 16 * wi + g, row1 = row0 + 8;
      // the valid columns of each row, [lo, hi] (edge tiles only)
      int hi0 = Tk - 1, hi1 = Tk - 1, lo0 = 0, lo1 = 0;
      if (causal) {
        hi0 = min(hi0, row0 + off);
        hi1 = min(hi1, row1 + off);
        if (window) {
          lo0 = row0 + off - window + 1;
          lo1 = row1 + off - window + 1;
        }
      }
      Rows r = {kNegInf, kNegInf, 0.f, 0.f, 1.f, 1.f};
      float o[NP / 2];
#pragma unroll
      for (int i = 0; i < NP / 2; ++i) o[i] = 0.f;

      if (n_it > 0) {
        float s[64];
        uint32_t pf[kBK / 16][4];
        if (w == 1) bar_arrive(kTileBar, 256);  // consumer 0 goes first
        mbar_wait(qfull, qc & 1);

        // tile kt0: S alone
        {
          const int st = kv % kStages;
          mbar_wait(&full_k[st], (kv / kStages) & 1);
          bar_sync(w == 0 ? kTileBar : me, 256);
          wg_fence();
          s_product<DP>(s, dsc_q, dsc_k0 + st * (L::KV_BYTES >> 4));
          wg_commit();
          bar_arrive(other, 256);
          wg_wait<0>();
          fence_regs(s);
          mbar_arrive(&empty_k[st]);
          mbar_arrive(n_it == 1 ? qempty : sink);
          softmax_tile(s, r, sl,
                       !tile_full(q0, kBQ, kt0 * kBK, kBK, Tk, causal,
                                  window, off),
                       kt0 * kBK + 2 * t4, lo0, hi0, lo1, hi1);
          pack_p(s, pf);
        }

        for (int it = 1; it < n_it; ++it) {
          const int c = kv + it;
          const int st = c % kStages, sp = (c - 1) % kStages;
          const int k0 = (kt0 + it) * kBK;
          mbar_wait(&full_k[st], (c / kStages) & 1);
          rescale(o, r);
          fence_regs(o);
          fence_frags(pf);
          mbar_wait(&full_v[sp], ((c - 1) / kStages) & 1);
          bar_sync(me, 256);
          wg_fence();
          s_product<DP>(s, dsc_q, dsc_k0 + st * (L::KV_BYTES >> 4));
          wg_commit();
          pv_product(o, pf, dsc_v0 + sp * (L::KV_BYTES >> 4));
          wg_commit();
          bar_arrive(other, 256);
          wg_wait<1>();
          fence_regs(s);
          mbar_arrive(&empty_k[st]);
          mbar_arrive(it == n_it - 1 ? qempty : sink);
          softmax_tile(s, r, sl,
                       !tile_full(q0, kBQ, k0, kBK, Tk, causal, window, off),
                       k0 + 2 * t4, lo0, hi0, lo1, hi1);
          wg_wait<0>();
          fence_regs(o);
          fence_frags(pf);
          mbar_arrive(&empty_v[sp]);
          pack_p(s, pf);
        }

        // the last tile's PV
        const int c = kv + n_it - 1, sp = c % kStages;
        rescale(o, r);
        fence_regs(o);
        fence_frags(pf);
        mbar_wait(&full_v[sp], (c / kStages) & 1);
        bar_sync(me, 256);
        wg_fence();
        pv_product(o, pf, dsc_v0 + sp * (L::KV_BYTES >> 4));
        wg_commit();
        bar_arrive(other, 256);
        wg_wait<0>();
        fence_regs(o);
        fence_frags(pf);
        mbar_arrive(&empty_v[sp]);
        if (w == 0) bar_sync(me, 256);  // takes consumer 1's last hand-over
        kv += n_it;
        ++qc;
      }

      // o / max(l, 1e-30) as bf16 into this warpgroup's rows of the O
      // buffer (once its last store has read them), then one TMA store a
      // panel, left to run into the next tile
      float l0 = r.l0, l1 = r.l1;
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
      const float i0 = 1.f / d0, i1 = 1.f / d1;
      if (tid == 0)
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      bar_sync(kStoreBar + w, 128);
      const int rr = 64 * w + 16 * wi + g;  // rr % 8 == (rr + 8) % 8 == g
#pragma unroll
      for (int n = 0; n < NP / 8; ++n) {
        unsigned char* pan = sm + L::OFF_O + (n / 8) * L::QPANEL;
        const int cc = (((n % 8) ^ g) << 4) + 4 * t4;
        *reinterpret_cast<uint32_t*>(pan + rr * kRow + cc) =
            pack_bf16(o[4 * n] * i0, o[4 * n + 1] * i0);
        *reinterpret_cast<uint32_t*>(pan + (rr + 8) * kRow + cc) =
            pack_bf16(o[4 * n + 2] * i1, o[4 * n + 3] * i1);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bar_sync(kStoreBar + w, 128);
      if (tid == 0) {
        for (int p = 0; p < L::NPAN; ++p)
          tma_store_3d(&tm_o, sm + L::OFF_O + p * L::QPANEL + 64 * w * kRow,
                       64 * p, q0 + 64 * w, wk.bh);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
      if (lse != nullptr && t4 == 0) {
        // back to base e; a row with no valid column keeps -1e30
        constexpr float kLn2 = 0.6931471805599453f;
        if (row0 < T)
          lse[(size_t)wk.bh * T + row0] =
              (r.m0 > kNegInf ? r.m0 * kLn2 : kNegInf) + logf(d0);
        if (row1 < T)
          lse[(size_t)wk.bh * T + row1] =
              (r.m1 > kNegInf ? r.m1 * kLn2 : kNegInf) + logf(d1);
      }
    }
    if (tid == 0)
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

template <int DP>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        float* lse, int bh, int t, int tk, int d, float scale,
                        int causal, int window, int off, cudaStream_t st) {
  CUtensorMap mq, mk, mv, mo;
  if (!make_map(&mq, q, false, bh, t, d, kBQ) ||
      !make_map(&mk, k, false, bh, tk, d, kBK) ||
      !make_map(&mv, v, false, bh, tk, d, kBK) ||
      !make_map(&mo, o, false, bh, t, d, kBQ / 2))
    return cudaErrorInvalidValue;
  const size_t smem = Fwd<DP>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_bf16<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  // persistent: one CTA an SM (at most one a work unit)
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  const int units = ((t + kBQ - 1) / kBQ + 1) / 2 * bh;
  flash_fwd_bf16<DP><<<min(units, sms), kFwdThreads, smem, st>>>(
      mq, mk, mv, mo, lse, bh, t, tk, scale, causal, window, off);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: exact float32 on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;  // 4 warps
constexpr int kFRows = 16;     // q rows per block: 4 warps x 4 rows
constexpr int kFBK = 32;       // keys per k tile: one per lane

__global__ void __launch_bounds__(kThreads)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  float* __restrict__ lse, int T, int Tk, int D, int nq,
                  float scale, int causal, int window, int off) {
  extern __shared__ float fsm[];
  const int DS = D + 1;  // odd stride: lane j reading key j hits its own bank
  float* sQ = fsm;
  float* sK = sQ + kFRows * D;
  float* sV = sK + kFBK * DS;
  float* sP = sV + kFBK * D;

  const int bh = blockIdx.x / nq;
  const int q0 = (nq - 1 - blockIdx.x % nq) * kFRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* qb = q + (size_t)bh * T * D;
  const float* kb = k + (size_t)bh * Tk * D;
  const float* vb = v + (size_t)bh * Tk * D;

  for (int i = tid; i < kFRows * D; i += kThreads) {
    const int row = q0 + i / D;
    sQ[i] = row < T ? qb[(size_t)row * D + i % D] : 0.f;
  }

  constexpr int kRows = kFRows / 4;  // rows per warp
  float m[kRows], l[kRows], acc[kRows][4];
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[rr][i] = 0.f;
  }
  const int nk = (Tk + kFBK - 1) / kFBK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kFBK;
    if (!band_run(q0, kFRows, k0, kFBK, causal, window, off)) continue;
    __syncthreads();
    for (int i = tid; i < kFBK * D; i += kThreads) {
      const int r = i / D, dd = i % D, key = k0 + r;
      const bool in = key < Tk;
      sK[r * DS + dd] = in ? kb[(size_t)key * D + dd] : 0.f;
      sV[r * D + dd] = in ? vb[(size_t)key * D + dd] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      const int r = warp * kRows + rr, row = q0 + r, col = k0 + lane;
      float sc = 0.f;
      for (int dd = 0; dd < D; ++dd)
        sc = fmaf(sQ[r * D + dd], sK[lane * DS + dd], sc);
      const bool ok = band_valid(row, col, Tk, causal, window, off);
      const float sm = ok ? sc * scale : kNegInf;
      const float mn = fmaxf(m[rr], warp_max(sm));
      const float a = expf(m[rr] - mn);
      const float p = ok ? expf(sm - mn) : 0.f;
      m[rr] = mn;
      l[rr] = l[rr] * a + warp_sum(p);
      sP[warp * kFBK + lane] = p;
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[rr][i] *= a;
      for (int j = 0; j < kFBK; ++j) {
        const float pj = sP[warp * kFBK + j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int dd = lane + 32 * i;
          if (dd < D) acc[rr][i] = fmaf(pj, sV[j * D + dd], acc[rr][i]);
        }
      }
      __syncwarp();
    }
  }
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    const int row = q0 + warp * kRows + rr;
    if (row >= T) continue;
    const float den = fmaxf(l[rr], 1e-30f);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int dd = lane + 32 * i;
      if (dd < D) o[((size_t)bh * T + row) * D + dd] = acc[rr][i] / den;
    }
    if (lse != nullptr && lane == 0)
      lse[(size_t)bh * T + row] = m[rr] + logf(den);
  }
}

}  // namespace

// q, k, v: contiguous (bh, t, d) / (bh, tk, d) / (bh, tk, d), 16-byte
// aligned, all of one dtype (0 = float32, 1 = bfloat16); o like q; lse
// (bh, t) float32 or null. d <= 128 and a multiple of 8 (the TMA maps
// need 16-byte rows; the wrapper pads smaller head dims with zeros);
// bfloat16 takes scale > 0 (the wrapper flips the sign of k for a negative
// one). Launches on `stream`, allocates nothing, and returns the launch's
// cudaError_t.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* o, float* lse, int bh, int t, int tk, int d,
                         float scale, int causal, int window,
                         int band_offset, int dtype, void* stream) {
  if (bh <= 0 || t <= 0 || tk <= 0 || d <= 0 || d > 128 || d % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const int nq = (t + kFRows - 1) / kFRows;
    const size_t smem = sizeof(float) * ((size_t)kFRows * d +
                                         (size_t)kFBK * (d + 1) +
                                         (size_t)kFBK * d + 4 * kFBK);
    flash_fwd_f32<<<bh * nq, kThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, t, tk, d,
        nq, scale, causal, window, band_offset);
    return (int)cudaGetLastError();
  }
  if (dtype != 1 || !(scale > 0.f)) return (int)cudaErrorInvalidValue;
  if (d <= 16)
    return (int)launch_bf16<16>(q, k, v, o, lse, bh, t, tk, d, scale, causal,
                                window, band_offset, st);
  if (d <= 32)
    return (int)launch_bf16<32>(q, k, v, o, lse, bh, t, tk, d, scale, causal,
                                window, band_offset, st);
  if (d <= 64)
    return (int)launch_bf16<64>(q, k, v, o, lse, bh, t, tk, d, scale, causal,
                                window, band_offset, st);
  return (int)launch_bf16<128>(q, k, v, o, lse, bh, t, tk, d, scale, causal,
                               window, band_offset, st);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
