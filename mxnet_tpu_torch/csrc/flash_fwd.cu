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
// The f32 path, flash_fwd_f32<DP> (DP = 64 or 128, the head dim padded), is
// exact float32 FMA on the CUDA cores: tensor-core TF32 would change the
// numbers the port's float32 contract holds to. Bound at the flagship
// shape in f32: 137 GFLOP at the 67 TFLOP/s FFMA peak, 2.05 ms, against
// 0.54 GB (0.16 ms): operations, so the design feeds the FMA pipes from
// register tiles instead of reading both operands of every FMA from
// shared memory:
// - Work. One CTA of 128 threads (a 16 x 8 grid: tx = tid % 16,
//   ty = tid / 16) a pair of 64-row q tiles of one head, nq - 1 - j then
//   j (equal causal work for every j); two CTAs an SM (112 KB of shared
//   memory each: Q, K, V 32 KB, P 16 KB).
// - Register tiles. S = Q K^T: a thread owns rows 8 ty .. 8 ty + 7 and keys
//   tx + 16 j, an 8 x 4 tile: per four depths it reads four K chunks and
//   eight Q chunks (LDS.128; Q a broadcast in the half warp) and does 128
//   FMAs, one depth at a time over all 32 sums (in depth order, so each
//   sum is the plain dot product's). O += P V: the same rows and columns
//   4 tx + 64 c (8 x 8 at DP = 128): per key two P chunks and two V
//   chunks for 64 FMAs. Tiles are row-major with 16-byte chunks
//   XOR-swizzled by row (ftile.cuh), so every read and every cp.async
//   write is free of bank conflicts; P is stored key-major.
// - Loads. Q, K and V arrive by cp.async (zero-filled past T, Tk and D):
//   V of tile j lands while S of tile j runs, K of tile j + 1 while PV of
//   tile j runs; two barriers a K/V tile.
// - Softmax in base 2 (ex2.approx, 2^-22 relative): scores scaled by
//   scale log2 e (any sign); the 16 threads of a row reduce its max and
//   sum by shuffles in the half warp, and each rescales its own O rows.
//   The per-element mask (the band's edge, the ragged tail) runs on edge
//   tiles only; masked scores are -1e30 and give p = 0 by a select, so a
//   row with no valid column gives o = 0 and lse = -1e30 + log(1e-30).
//   Every sum runs in a fixed order and every output row has one owner:
//   two launches give the same bits.
// What holds it at about half the FFMA peak (tools/flash_variants.py,
// variants with parts removed, H100): the S and PV loops run at about 55%
// and 70% of the FFMA rate by themselves although four of five
// instructions there are FFMA (the loads are not the limit: dropping seven
// of eight Q loads saved 6%; unrolling the PV loop by 8 saved 3%), and
// softmax, loads and barriers take a fifth of the time; two CTAs of four
// warps an SM leave each scheduler two warps.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "ftile.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's masked-score value
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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
// f32: exact float32 on the CUDA cores, register-tiled
// ---------------------------------------------------------------------------

using ftile::kTile;

// max and sum over the 16 lanes of a half warp (the threads of one row)
__device__ __forceinline__ float half_max(float v) {
#pragma unroll
  for (int s = 8; s > 0; s >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, s));
  return v;
}

__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int s = 8; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}

constexpr int kFwdF32Threads = 128;  // a 16 x 8 grid: tx = tid % 16,
                                     // ty = tid / 16
constexpr int kRowsF32 = 8;          // q rows a thread: 8 ty .. 8 ty + 7

template <int DP>
__global__ void __launch_bounds__(kFwdF32Threads, 2)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  float* __restrict__ lse, int T, int Tk, int D, int nq,
                  int npairs, float scale, int causal, int window, int off) {
  using ftile::chunk;
  constexpr int R = kRowsF32;
  constexpr int NV = DP / 64;  // 4-column chunks of O a thread owns
  extern __shared__ float4 fsm4[];
  float* sQ = reinterpret_cast<float*>(fsm4);
  float* sK = sQ + kTile * DP;
  float* sV = sK + kTile * DP;
  float* sP = sV + kTile * DP;  // p, key-major: [key][q row]

  const int bh = blockIdx.x / npairs, pj = blockIdx.x % npairs;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float* qb = q + (size_t)bh * T * D;
  const float* kb = k + (size_t)bh * Tk * D;
  const float* vb = v + (size_t)bh * Tk * D;
  const int nk = (Tk + kTile - 1) / kTile;
  const float sl = scale * kLog2e;  // scores in base 2: exp(x) = 2^(x log2 e)

  for (int h = 0; h < 2; ++h) {
    // q tiles nq - 1 - pj, then pj: the pair's causal work is the same for
    // every pj (the middle tile of an odd nq runs once)
    const int qt = h ? pj : nq - 1 - pj;
    if (h && qt == nq - 1 - pj) break;
    const int q0 = qt * kTile;
    int kt0 = 0;
    while (kt0 < nk &&
           !band_run(q0, kTile, kt0 * kTile, kTile, causal, window, off))
      ++kt0;
    int kt1 = kt0;
    while (kt1 < nk &&
           band_run(q0, kTile, kt1 * kTile, kTile, causal, window, off))
      ++kt1;

    __syncthreads();  // the last tile's reads of sQ, sV, sP are done
    if (kt0 < kt1) {
      ftile::load_tile<DP, kFwdF32Threads>(sQ, qb, q0, T, D, tid);
      ftile::load_tile<DP, kFwdF32Threads>(sK, kb, kt0 * kTile, Tk, D, tid);
      ftile::cp_commit();
    }
    // the thread's rows R ty + i: running max m (base-2 scores), its part of
    // the running denominator l, and O's columns 4 tx + 64 c
    float m[R], l[R];
    float4 acc[R][NV];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      m[i] = kNegInf;
      l[i] = 0.f;
#pragma unroll
      for (int c = 0; c < NV; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
    }

    for (int kt = kt0; kt < kt1; ++kt) {
      const int k0 = kt * kTile;
      ftile::cp_wait_all();
      __syncthreads();  // K (and Q) landed; the last PV is done with sV, sP
      ftile::load_tile<DP, kFwdF32Threads>(sV, vb, k0, Tk, D, tid);
      ftile::cp_commit();  // V lands during S

      // S = Q K^T: rows R ty + i, keys tx + 16 j; in depth order
      float s[R][4];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 2
      for (int c = 0; c < D / 4; ++c) {
        float4 kf[4], qf[R];
#pragma unroll
        for (int j = 0; j < 4; ++j) kf[j] = *chunk<DP>(sK, tx + 16 * j, c);
#pragma unroll
        for (int i = 0; i < R; ++i) qf[i] = *chunk<DP>(sQ, R * ty + i, c);
        // one depth at a time over all R x 4 sums: 32 independent FMAs
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int i = 0; i < R; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              s[i][j] = fmaf(ftile::get(qf[i], e), ftile::get(kf[j], e),
                             s[i][j]);
      }

      // online softmax of the thread's rows over the half warp that holds
      // them; masked scores are -1e30 and give p = 0 by a select
      const bool edge = !tile_full(q0, kTile, k0, kTile, Tk, causal, window,
                                   off);
      float alpha[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int row = q0 + R * ty + i;
        uint32_t ok = 0xfu;
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (edge && !band_valid(row, k0 + tx + 16 * j, Tk, causal, window,
                                  off))
            ok &= ~(1u << j);
          s[i][j] = (ok >> j) & 1 ? s[i][j] * sl : kNegInf;
          mx = fmaxf(mx, s[i][j]);
        }
        const float mn = fmaxf(m[i], half_max(mx));
        alpha[i] = fast_exp2(m[i] - mn);
        m[i] = mn;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = (ok >> j) & 1 ? fast_exp2(s[i][j] - mn) : 0.f;
          sum += s[i][j];
        }
        l[i] = l[i] * alpha[i] + sum;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h4 = 0; h4 < R / 4; ++h4)
          *chunk<kTile>(sP, tx + 16 * j, (R / 4) * ty + h4) =
              make_float4(s[4 * h4][j], s[4 * h4 + 1][j], s[4 * h4 + 2][j],
                          s[4 * h4 + 3][j]);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < NV; ++c) {
          acc[i][c].x *= alpha[i];
          acc[i][c].y *= alpha[i];
          acc[i][c].z *= alpha[i];
          acc[i][c].w *= alpha[i];
        }
      ftile::cp_wait_all();
      __syncthreads();  // V landed, P stored, every read of sK done
      if (kt + 1 < kt1) {  // the next K lands during PV
        ftile::load_tile<DP, kFwdF32Threads>(sK, kb, k0 + kTile, Tk, D, tid);
        ftile::cp_commit();
      }

      // O += P V: rows R ty + i, columns 4 tx + 64 c; in key order
#pragma unroll 8
      for (int key = 0; key < kTile; ++key) {
        float4 pf[R / 4], vf[NV];
#pragma unroll
        for (int h4 = 0; h4 < R / 4; ++h4)
          pf[h4] = *chunk<kTile>(sP, key, (R / 4) * ty + h4);
#pragma unroll
        for (int c = 0; c < NV; ++c) vf[c] = *chunk<DP>(sV, key, tx + 16 * c);
#pragma unroll
        for (int c = 0; c < NV; ++c)
#pragma unroll
          for (int i = 0; i < R; ++i)
            ftile::fma4(acc[i][c], ftile::get(pf[i / 4], i % 4), vf[c]);
      }
    }

    // o = acc / max(l, 1e-30); lse = m + log(max(l, 1e-30)), back in base e
    // (a row with no valid column keeps m = -1e30)
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float den = fmaxf(half_sum(l[i]), 1e-30f);
      const int row = q0 + R * ty + i;
      if (row >= T) continue;
      float* orow = o + ((size_t)bh * T + row) * D;
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        const int col = 4 * tx + 64 * c;
        if (col < D)
          *reinterpret_cast<float4*>(orow + col) =
              make_float4(acc[i][c].x / den, acc[i][c].y / den,
                          acc[i][c].z / den, acc[i][c].w / den);
      }
      if (lse != nullptr && tx == 0)
        lse[(size_t)bh * T + row] =
            (m[i] > kNegInf ? m[i] * kLn2 : kNegInf) + logf(den);
    }
  }
}

template <int DP>
cudaError_t launch_f32(const float* q, const float* k, const float* v,
                       float* o, float* lse, int bh, int t, int tk, int d,
                       float scale, int causal, int window, int off,
                       cudaStream_t st) {
  const size_t smem = sizeof(float) * (3 * kTile * DP + kTile * kTile);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_f32<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(flash_fwd_f32<DP>,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  const int nq = (t + kTile - 1) / kTile, npairs = (nq + 1) / 2;
  flash_fwd_f32<DP><<<bh * npairs, kFwdF32Threads, smem, st>>>(
      q, k, v, o, lse, t, tk, d, nq, npairs, scale, causal, window, off);
  return cudaGetLastError();
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
    const float* qf = static_cast<const float*>(q);
    const float* kf = static_cast<const float*>(k);
    const float* vf = static_cast<const float*>(v);
    float* of = static_cast<float*>(o);
    if (d <= 64)
      return (int)launch_f32<64>(qf, kf, vf, of, lse, bh, t, tk, d, scale,
                                 causal, window, band_offset, st);
    return (int)launch_f32<128>(qf, kf, vf, of, lse, bh, t, tk, d, scale,
                                causal, window, band_offset, st);
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
