// Flash-attention backward for Hopper (sm_90a), with a plain C interface:
// one fused, deterministic pass for each dtype (bf16 on wgmma, float32
// exactly on FFMA).
//
// Replaces mxnet_tpu/ops/attention.py:_flash_dq_kernel and
// _flash_dkv_kernel (wrapper _flash_backward). Given the forward's q, k, v,
// the output cotangent do, the forward's per-row lse and
// delta = rowsum(do * o) (minus the lse cotangent, folded in by the caller),
// it computes what those kernels compute, over the valid (row, col) pairs:
//   p  = exp(scale * q.k - lse)          (f32)
//   ds = p * (do.v - delta) * scale      (f32, then rounded to bf16)
//   dq = sum_col ds k,  dk = sum_row ds q,  dv = sum_row p do
// with p rounded to bf16 before the dv product; validity by _band_valid
// (causal, sliding window, band_offset) and the ragged tails; masked pairs
// give p = 0 and ds = 0 through a select that wraps the whole product
// (never exp(s - lse) unmasked: a row with no valid column carries
// lse ~ -1e30); padded rows and head dims zero; tiles wholly outside the
// band skipped as _band_run does; every output summed in f32 and cast once.
//
// Bound on the H100 at the flagship training shape (B*H = 128, T = Tk =
// 2048, D = 128, bf16, causal): operations. The fused pass does five
// products of 2*D flops per valid pair (k.q, v.do, p.do, ds.q, ds.k),
// 10*D*BH*T*(T+1)/2 = 344 GFLOP, 0.348 ms at 989 TFLOP/s, against 0.27 GB
// of traffic (0.08 ms at 3.35 TB/s). The TPU's two-pass split would do
// 14*D a pair (q.k and do.v twice).
//
// Design of flash_bwd_bf16 (one CTA per (bh, 128-key tile), 384 threads):
// - Grid. blockIdx = j * BH + bh, kv-tile-major: the longest causal CTAs
//   (j = 0) start first, and every CTA that a later one waits on (below)
//   was dispatched before it. The CTA walks the 64-row q tiles that meet
//   its band, from the last one down, and keeps dK and dV for its keys in
//   registers.
// - Warp specialisation. Warpgroup 0 gives its registers away (setmaxnreg
//   40; at 24 its code spilled): its warp 0 issues the TMA loads (K and V once; Q and dO per q
//   tile into a 2-stage ring under full/empty mbarriers) and stages the
//   tile's lse (in base 2) and delta; one thread of warp 1 writes dq (the
//   last point). Warpgroups 1 and 2 are the consumers, 64 keys each, at
//   232 registers (40 * 128 + 232 * 256 = the 168 * 384 of the launch). TMA maps are 3-D over (BH, T, D), so a ragged tail
//   reads zeros and never the next head's rows; a box is one 128-byte
//   swizzled panel (64 bf16 columns), so head dims past D read zeros too.
//   DP (16, 32, 64, 128) sets the depth of the k.q and v.do products; the
//   tiles are NP = max(DP, 64) columns wide, whole panels.
// - Products, all wgmma with f32 accumulation, every operand in shared
//   memory: S^T = K Q^T and dP^T = V dO^T; P^T and dS^T are formed in
//   registers (lse and delta indexed by column, validity a bitmask made
//   without branches, all set on tiles inside the band) and stored as bf16
//   in the swizzled layout; then dV += P^T dO and dK += dS^T Q (B
//   N-major), and dQ_partial = dS K over the CTA's 128 keys (both operands
//   transposed), each consumer warpgroup taking one 64-column half of D
//   (warpgroup 0's half only when NP = 64). A from registers would save
//   shared-memory bandwidth, but dK, dV, S^T, dP^T and the fragments do
//   not fit those registers at D = 128 (ptxas spilled and serialized).
// - dq in a fixed order, without float atomics. dQ_partial of q tile i
//   joins an f32 scratch dq_acc (BH, T, D) under a per-(bh, i) turn
//   counter: kv tile j adds when the counter equals the number of band kv
//   tiles before j (band_span), then increments it with a release. The
//   consumers stage the partial in shared memory (32-column f32 panels,
//   swizzled); the writer thread waits for the turn and puts it into
//   dq_acc by TMA, a plain store for the first contributor and an f32
//   add for the others, waits for completion, releases the turn and frees
//   the stage. The last contributor skips the stage: its consumers wait
//   for the turn and write the bf16 dq rows from registers (acc + own
//   partial). q tiles no kv tile meets keep the wrapper's zeros. It cannot
//   deadlock: a CTA waits only on CTAs of smaller j, which the kv-major
//   launch order dispatched before it and which never wait on a larger j.
// - Shared memory at D = 128: K, V 64 KB, the ring 64 KB, P^T and dS^T
//   32 KB, the dq stage 32 KB: 194 KB, one CTA an SM.
// What it leaves on the table: the two consumer warpgroups run in step
// (two barriers a tile), so the tensor cores idle while both form P and
// dS; S^T, dP^T and dQ are 64-wide products with both operands in shared
// memory, which bounds them by shared-memory bandwidth; nothing overlaps
// one tile's elementwise work with the next tile's products.
//
// The f32 path, flash_bwd_f32<DP> (DP = 64 or 128, the head dim padded),
// is the same fused pass in exact float32 FMA on the CUDA cores (tensor-core
// TF32 would change the numbers the port's float32 contract holds to).
// Bound at the flagship shape in f32: 344 GFLOP at the 67 TFLOP/s FFMA
// peak, 5.13 ms: operations. So it does the fused count (10 D flops a
// pair, against 14 D for a dq pass and a dk/dv pass that each recompute
// S and dP) and feeds the FMA pipes from registers:
// - Grid. One CTA of 256 threads per (bh, 64-key tile), kv-tile-major as
//   above; K and V stay in shared memory, Q, dO, lse and delta of the
//   band's 64-row q tiles (last first) stream through two cp.async stages,
//   the next tile landing while this one computes (225 KB at DP = 128: one
//   CTA an SM, up to 255 registers a thread).
// - Two groups of four warps (tx = tid % 16, gy = tid % 128 / 16). Group
//   0 computes S^T = K Q^T and owns dV, group 1 dP^T = V dO^T and owns dK:
//   keys 8 gy .. 8 gy + 7 against q rows tx + 16 b (an 8 x 4 tile, per
//   four depths eight K or V chunks, broadcasts, and four Q or dO chunks
//   for 128 FMAs, one depth at a time over all 32 sums); dV += P^T dO and
//   dK += dS^T Q over the same keys and columns 4 tx + 64 c (8 x 8 at
//   DP = 128, per q row two P or dS chunks and two dO or Q chunks for 64
//   FMAs). P^T and dS^T: each group hands the other half of its S^T or
//   dP^T over through shared memory, then forms P^T = exp(scale s - lse)
//   (ex2.approx) and dS^T = P^T (dP^T - delta) scale for its half, stored
//   [q row][key]. dQ_i = dS K over the CTA's 64 keys: all 256 threads,
//   rows 4 (tid / 16) + a, columns 4 tx + 64 c. Tiles are swizzled as in
//   ftile.cuh: no bank conflicts.
// - dq in a fixed order, without float atomics: each thread adds its dQ_i
//   part straight into the f32 dq under the q tile's turn counter. Thread
//   0 waits by ld.acquire and a barrier releases the rest before dS K is
//   computed, so the loads of the sum so far (through L2) hide behind it;
//   the first kv tile of the band stores, later ones add and store; the
//   turn passes on (a release by thread 0) at the next tile's exchange
//   barrier, when the stores are done and the fence is cheap. The waits
//   cannot deadlock, by the bf16 kernel's argument: a CTA waits only on
//   CTAs of smaller j, dispatched before it in the kv-tile-major order,
//   resident or finished, and those never wait on a larger j; a CTA
//   passes on every turn it holds before it waits for another. Walking
//   the band from its last q tile down keeps the waits short: every kv
//   tile reaches a q tile after the same number of tiles.
// What holds it at about half the FFMA peak (tools/flash_variants.py,
// variants with parts removed, H100): the three product loops run at
// about 55-60% of the FFMA rate by themselves (unrolling the dV/dK loop
// whole saved 7%), and the exchange, the dq sums and the barriers (four a
// q tile) take a sixth of the time.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "ftile.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

// (row, col) is a valid pair: inside both sequences and inside the band
// (_band_valid over global positions, row r sitting at r + off)
__device__ __forceinline__ bool band_valid(int row, int col, int t, int tk,
                                           int causal, int window,
                                           int off) {
  if (row >= t || col >= tk) return false;
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

// Every pair of the rectangle is valid: no per-element mask needed.
__device__ __forceinline__ bool tile_full(int q0, int bq, int k0, int bk,
                                          int t, int tk, int causal,
                                          int window, int off) {
  if (q0 + bq > t || k0 + bk > tk) return false;
  if (!causal) return true;
  return q0 + off >= k0 + bk - 1 &&
         (!window || q0 + bq - 1 + off - k0 < window);
}

// ---------------------------------------------------------------------------
// bf16: the fused pass (TMA, mbarriers, wgmma, warp specialisation)
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;              // q rows per tile
constexpr int kBK = 128;             // keys per CTA, 64 per consumer warpgroup
constexpr int kStages = 2;           // depth of the Q/dO ring
constexpr int kFusedThreads = 384;   // producer warpgroup + 2 consumers

template <int DP>
struct Fused {  // shared-memory plan; every tile starts on 1024 bytes
  static constexpr int NP = DP < 64 ? 64 : DP;   // stored width (columns)
  static constexpr int NPAN = NP / 64;           // 128-byte panels a row
  static constexpr int KPANEL = kBK * kRow;      // one panel of K or V
  static constexpr int QPANEL = kBQ * kRow;      // one panel of Q or dO
  static constexpr int K_BYTES = NPAN * KPANEL;
  static constexpr int Q_BYTES = NPAN * QPANEL;
  static constexpr int OFF_K = 0;
  static constexpr int OFF_V = K_BYTES;
  static constexpr int OFF_Q = 2 * K_BYTES;                  // ring
  static constexpr int OFF_O = OFF_Q + kStages * Q_BYTES;    // ring
  static constexpr int OFF_S = OFF_O + kStages * Q_BYTES;    // dS^T bf16
  static constexpr int OFF_P = OFF_S + kBK * kRow;           // P^T bf16
  static constexpr int OFF_Z = OFF_P + kBK * kRow;           // dQ_partial f32
  static constexpr int OFF_L = OFF_Z + kBQ * NP * 4;         // lse ring
  static constexpr int OFF_D = OFF_L + kStages * kBQ * 4;    // delta ring
  static constexpr int OFF_BAR = OFF_D + kStages * kBQ * 4;  // mbarriers
  static constexpr size_t SMEM = OFF_BAR + (2 * kStages + 3) * 8 + 1024;
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void red_release(int* p, int v) {
  asm volatile(
      "fence.acq_rel.gpu;\n"
      "red.relaxed.gpu.global.add.s32 [%0], %1;\n" ::"l"(p),
      "r"(v)
      : "memory");
}


__device__ __forceinline__ void tma_add_3d(const CUtensorMap* map,
                                           const void* src, int c0, int c1,
                                           int c2) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.3d.global.shared::cta.add.tile.bulk_group "
      "[%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wait until the bulk copies issued so far are complete, their writes
// made before any later generic access (the turn counter's release)
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile(
      "cp.async.bulk.commit_group;\n"
      "cp.async.bulk.wait_group 0;\n"
      "fence.proxy.async.global;\n" ::
          : "memory");
}

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// The kv tiles [jf, jl] whose band meets q tile [q0, q0 + kBQ), for a q
// tile that meets one: band_run solved for the kv tile index
__device__ __forceinline__ void band_span(int q0, int nk, int causal,
                                          int window, int off, int& jf,
                                          int& jl) {
  jf = 0;
  jl = nk - 1;
  if (!causal) return;
  jl = min(jl, floor_div(q0 + kBQ - 1 + off, kBK));
  if (window) jf = max(0, floor_div(q0 + off - window - (kBK - 1), kBK) + 1);
}

// band_valid without branches (every term evaluated), for the masks of a
// tile that is not wholly inside the band
__device__ __forceinline__ bool band_ok(int row, int col, int t, int tk,
                                        int causal, int window, int off) {
  const int r = row + off;
  return (row < t) & (col < tk) &
         ((causal == 0) | ((r >= col) & ((window == 0) | (r - col < window))));
}

template <int DP>
__global__ void __launch_bounds__(kFusedThreads, 1)
    flash_bwd_bf16(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_o,
                   const __grid_constant__ CUtensorMap tm_acc,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dq,
                   bf16* __restrict__ dk, bf16* __restrict__ dv,
                   float* __restrict__ dq_acc, int* __restrict__ turns,
                   int BH, int T, int Tk, int D, float scale, int causal,
                   int window, int off) {
  using L = Fused<DP>;
  constexpr int NP = L::NP;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::OFF_BAR);
  uint64_t* empty = full + kStages;
  uint64_t* kvbar = empty + kStages;
  uint64_t* zfull = kvbar + 1;   // a dQ_partial is staged
  uint64_t* zempty = zfull + 1;  // the staging buffer is free again
  float* sZ = reinterpret_cast<float*>(sm + L::OFF_Z);
  float* sL = reinterpret_cast<float*>(sm + L::OFF_L);
  float* sD = reinterpret_cast<float*>(sm + L::OFF_D);

  const int bh = blockIdx.x % BH;
  const int j = blockIdx.x / BH;  // kv tile: kv-tile-major launch order
  const int k0 = j * kBK;
  const int nq = (T + kBQ - 1) / kBQ;
  const int nk = (Tk + kBK - 1) / kBK;
  // the q tiles that meet the band: one contiguous run [i0, i1)
  int i0 = 0;
  while (i0 < nq && !band_run(i0 * kBQ, kBQ, k0, kBK, causal, window, off))
    ++i0;
  int i1 = i0;
  while (i1 < nq && band_run(i1 * kBQ, kBQ, k0, kBK, causal, window, off))
    ++i1;
  const int n_it = i1 - i0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);     // the producer warp's lanes
      mbar_init(&empty[s], 256);   // every consumer thread
    }
    mbar_init(kvbar, 1);
    mbar_init(zfull, 256);
    mbar_init(zempty, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one warp loads, three idle ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_expect_tx(kvbar, 2 * L::K_BYTES);
        mbar_arrive(kvbar);
        for (int p = 0; p < L::NPAN; ++p) {
          tma_load_3d(sm + L::OFF_K + p * L::KPANEL, &tm_k, kvbar, 64 * p,
                      k0, bh);
          tma_load_3d(sm + L::OFF_V + p * L::KPANEL, &tm_v, kvbar, 64 * p,
                      k0, bh);
        }
      }
      const float* lb = lse + (size_t)bh * T;
      const float* db = delta + (size_t)bh * T;
      for (int it = 0; it < n_it; ++it) {
        const int s = it % kStages;
        const int q0 = (i1 - 1 - it) * kBQ;  // the band, last tile first
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(&full[s], 2 * L::Q_BYTES);
          for (int p = 0; p < L::NPAN; ++p) {
            tma_load_3d(sm + L::OFF_Q + s * L::Q_BYTES + p * L::QPANEL,
                        &tm_q, &full[s], 64 * p, q0, bh);
            tma_load_3d(sm + L::OFF_O + s * L::Q_BYTES + p * L::QPANEL,
                        &tm_o, &full[s], 64 * p, q0, bh);
          }
        }
        for (int r = lane; r < kBQ; r += 32) {
          const int row = q0 + r;
          sL[s * kBQ + r] = row < T ? lb[row] * kLog2e : 0.f;
          sD[s * kBQ + r] = row < T ? db[row] : 0.f;
        }
        mbar_arrive(&full[s]);
      }
    } else if (threadIdx.x == 32) {
      // dq writer: each staged dQ_partial (all but the last of its q tile)
      // goes into dq_acc when its turn comes, by one bulk copy
      int nz = 0;  // partials taken so far
      for (int it = 0; it < n_it; ++it) {
        const int i = i1 - 1 - it, q0 = i * kBQ;
        int jf, jl;
        band_span(q0, nk, causal, window, off, jf, jl);
        if (j == jl) continue;  // the consumers write the last one
        mbar_wait(zfull, nz & 1);
        int* cnt = turns + (size_t)bh * nq + i;
        while (ld_acquire(cnt) != j - jf) __nanosleep(64);
        for (int p = 0; p < NP / 32; ++p) {  // 32-column panels
          if (j == jf)
            tma_store_3d(&tm_acc, sZ + p * kBQ * 32, 32 * p, q0, bh);
          else
            tma_add_3d(&tm_acc, sZ + p * kBQ * 32, 32 * p, q0, bh);
        }
        bulk_wait_all();
        red_release(cnt, 1);
        mbar_arrive(zempty);
        ++nz;
      }
    }
  } else {
    // ---- consumer warpgroups: keys [k0 + 64 w, k0 + 64 w + 64) ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int w = threadIdx.x / 128 - 1;
    const int ct = threadIdx.x - 128;  // 0..255 over both consumers
    const int tid = threadIdx.x % 128;
    const int wi = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
    const int kw0 = k0 + 64 * w;
    const int key0 = kw0 + 16 * wi + g, key1 = key0 + 8;
    const float scale_log2 = scale * kLog2e;
    const bool has_dq = w < L::NPAN;  // NP = 64: warpgroup 0 alone
    // descriptors: K, V as A (K-major), K as B of dQ (N-major), dS^T as
    // A of dQ (M-major)
    const uint64_t dsc_k = gmma_desc(smem_addr(sm + L::OFF_K) + 64 * w * kRow, 16, 1024);
    const uint64_t dsc_v = gmma_desc(smem_addr(sm + L::OFF_V) + 64 * w * kRow, 16, 1024);
    const uint64_t dsc_kt = gmma_desc(smem_addr(sm + L::OFF_K) + w * L::KPANEL, L::KPANEL, 1024);
    // P^T, dS^T as A of dV, dK (K-major: this warpgroup's 64 rows);
    // dS^T as A of dQ (M-major, all 128 rows)
    const uint64_t dsc_p = gmma_desc(smem_addr(sm + L::OFF_P) + 64 * w * kRow, 16, 1024);
    const uint64_t dsc_sa = gmma_desc(smem_addr(sm + L::OFF_S) + 64 * w * kRow, 16, 1024);
    const uint64_t dsc_s = gmma_desc(smem_addr(sm + L::OFF_S), kBK * kRow, 1024);
    unsigned char* sSg = sm + L::OFF_S;
    unsigned char* sPg = sm + L::OFF_P;

    int nz = 0;  // partials staged so far
    float dka[NP / 2], dva[NP / 2];
#pragma unroll
    for (int i = 0; i < NP / 2; ++i) dka[i] = dva[i] = 0.f;

    mbar_wait(kvbar, 0);
    for (int it = 0; it < n_it; ++it) {
      const int s = it % kStages;
      const int i = i1 - 1 - it, q0 = i * kBQ;
      const uint32_t tq = smem_addr(sm + L::OFF_Q + s * L::Q_BYTES);
      const uint32_t to = smem_addr(sm + L::OFF_O + s * L::Q_BYTES);
      // Q, dO as B of S^T, dP^T (K-major) and of dK, dV (N-major)
      const uint64_t dsc_q = gmma_desc(tq, 16, 1024);
      const uint64_t dsc_o = gmma_desc(to, 16, 1024);
      const uint64_t dsc_qt = gmma_desc(tq, L::QPANEL, 1024);
      const uint64_t dsc_ot = gmma_desc(to, L::QPANEL, 1024);
      const float* tL = sL + s * kBQ;
      const float* tD = sD + s * kBQ;
      mbar_wait(&full[s], (it / kStages) & 1);

      // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 q rows, depth DP
      float st[32], dpt[32];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t ko = (kk / 4) * L::KPANEL + (kk % 4) * 32;
        const uint32_t qo = (kk / 4) * L::QPANEL + (kk % 4) * 32;
        wgmma_ss<0, 0>(st, desc_at(dsc_k, ko), desc_at(dsc_q, qo), kk > 0);
      }
      wg_commit();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t ko = (kk / 4) * L::KPANEL + (kk % 4) * 32;
        const uint32_t qo = (kk / 4) * L::QPANEL + (kk % 4) * 32;
        wgmma_ss<0, 0>(dpt, desc_at(dsc_v, ko), desc_at(dsc_o, qo), kk > 0);
      }
      wg_commit();
      wg_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

      // P^T and dS^T = P^T (dP^T - delta) scale over the valid pairs, 0
      // elsewhere (the q row is the column: lse and delta index by
      // column), each rounded to bf16 into shared memory in the swizzled
      // layout (row = key): the A operands of dV, dK and dQ
      // validity: bit 4 n + e for element 4 n + e, all set on a tile
      // wholly inside the band
      uint32_t ok = 0xffffffffu;
      if (!tile_full(q0, kBQ, kw0, 64, T, Tk, causal, window, off)) {
        ok = 0;
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            ok |= (uint32_t)band_ok(q0 + 8 * n + 2 * t4 + (e & 1),
                                    e >= 2 ? key1 : key0, T, Tk, causal,
                                    window, off)
                  << (4 * n + e);
      }
      const int r0 = 64 * w + 16 * wi + g;  // r0 % 8 == (r0 + 8) % 8 == g
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        // lse and delta of this thread's two q columns 8 n + 2 t4 (+1)
        const float2 l2 = *reinterpret_cast<const float2*>(tL + 8 * n + 2 * t4);
        const float2 d2 = *reinterpret_cast<const float2*>(tD + 8 * n + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool v = (ok >> (4 * n + e)) & 1;
          const float lq = (e & 1) ? l2.y : l2.x;
          const float dl = (e & 1) ? d2.y : d2.x;
          const float p = v ? fast_exp2(st[4 * n + e] * scale_log2 - lq) : 0.f;
          st[4 * n + e] = p;
          dpt[4 * n + e] = v ? p * (dpt[4 * n + e] - dl) * scale : 0.f;
        }
        const int c = ((n ^ g) << 4) + 4 * t4;
        *reinterpret_cast<uint32_t*>(sPg + r0 * kRow + c) =
            pack_bf16(st[4 * n], st[4 * n + 1]);
        *reinterpret_cast<uint32_t*>(sPg + (r0 + 8) * kRow + c) =
            pack_bf16(st[4 * n + 2], st[4 * n + 3]);
        *reinterpret_cast<uint32_t*>(sSg + r0 * kRow + c) =
            pack_bf16(dpt[4 * n], dpt[4 * n + 1]);
        *reinterpret_cast<uint32_t*>(sSg + (r0 + 8) * kRow + c) =
            pack_bf16(dpt[4 * n + 2], dpt[4 * n + 3]);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bar_sync(1, 256);  // both warpgroups' P^T and dS^T rows are stored

      // dV += P^T dO, dK += dS^T Q; dQ_partial = dS K over the CTA's 128
      // keys, this warpgroup's half of the head dims (in st's registers)
      float (&dqa)[32] = st;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<0, 1>(dva, desc_at(dsc_p, kk * 32),
                       desc_at(dsc_ot, kk * 16 * kRow), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<0, 1>(dka, desc_at(dsc_sa, kk * 32),
                       desc_at(dsc_qt, kk * 16 * kRow), 1);
      // (with NP = 64 warpgroup 1 computes a product it never stores: the
      // same instruction stream in both keeps the wgmma pipeline whole)
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_ss<1, 1>(dqa, desc_at(dsc_s, kk * 16 * kRow),
                       desc_at(dsc_kt, kk * 16 * kRow), kk > 0);
      wg_commit();
      wg_wait<0>();
      fence_regs(dva);
      fence_regs(dka);
      fence_regs(dqa);
      mbar_arrive(&empty[s]);  // this stage's Q, dO, lse, delta are used

      bar_sync(1, 256);  // both warpgroups are done reading dS^T

      // dq of q tile i, added in kv-tile order under the tile's turn
      // counter: staged for the dq writer, or by the last contributor
      // itself straight into the bf16 dq
      int jf, jl;
      band_span(q0, nk, causal, window, off, jf, jl);
      if (j != jl) {
        mbar_wait(zempty, (nz & 1) ^ 1);
        if (has_dq) {  // 32-column panels of 128-byte swizzled f32 rows
#pragma unroll
          for (int n = 0; n < 8; ++n) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = 16 * wi + g + 8 * h;  // r % 8 == g
              const int col = 64 * w + 8 * n + 2 * t4;
              const int chunk = ((col % 32) / 4) ^ g;
              *reinterpret_cast<float2*>(sZ + (col / 32) * kBQ * 32 + r * 32 +
                                         chunk * 4 + col % 4) =
                  make_float2(dqa[4 * n + 2 * h], dqa[4 * n + 2 * h + 1]);
            }
          }
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(zfull);
        ++nz;
      } else {
        const int* cnt = turns + (size_t)bh * nq + i;
        if (ct == 0)
          while (ld_acquire(cnt) != j - jf) __nanosleep(64);
        bar_sync(1, 256);  // the earlier kv tiles' sum is in dq_acc
        if (has_dq) {
#pragma unroll
          for (int n = 0; n < 8; ++n) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = q0 + 16 * wi + g + 8 * h;
              const int col = 64 * w + 8 * n + 2 * t4;
              if (row >= T || col >= D) continue;
              const size_t at = ((size_t)bh * T + row) * D + col;
              float2 sum =
                  make_float2(dqa[4 * n + 2 * h], dqa[4 * n + 2 * h + 1]);
              if (j > jf) {
                const float2 old =
                    __ldcg(reinterpret_cast<const float2*>(dq_acc + at));
                sum = make_float2(old.x + sum.x, old.y + sum.y);
              }
              *reinterpret_cast<__nv_bfloat162*>(dq + at) =
                  __floats2bfloat162_rn(sum.x, sum.y);
            }
          }
        }
      }
    }

    // dK, dV rows key0 / key1, columns 8 n + 2 t4
    const size_t koff = (size_t)bh * Tk * D;
#pragma unroll
    for (int n = 0; n < NP / 8; ++n) {
      const int col = 8 * n + 2 * t4;
      if (col >= D) continue;
      if (key0 < Tk) {
        *reinterpret_cast<__nv_bfloat162*>(dk + koff + (size_t)key0 * D + col) =
            __floats2bfloat162_rn(dka[4 * n], dka[4 * n + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + koff + (size_t)key0 * D + col) =
            __floats2bfloat162_rn(dva[4 * n], dva[4 * n + 1]);
      }
      if (key1 < Tk) {
        *reinterpret_cast<__nv_bfloat162*>(dk + koff + (size_t)key1 * D + col) =
            __floats2bfloat162_rn(dka[4 * n + 2], dka[4 * n + 3]);
        *reinterpret_cast<__nv_bfloat162*>(dv + koff + (size_t)key1 * D + col) =
            __floats2bfloat162_rn(dva[4 * n + 2], dva[4 * n + 3]);
      }
    }
  }
}

template <int DP>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse,
                        const float* delta, void* dq, void* dk, void* dv,
                        float* dq_acc, int* turns, int bh, int t, int tk,
                        int d, float scale, int causal, int window, int off,
                        cudaStream_t st) {
  CUtensorMap mq, mk, mv, mo, macc;
  if (!make_map(&mq, q, false, bh, t, d, kBQ) ||
      !make_map(&mk, k, false, bh, tk, d, kBK) ||
      !make_map(&mv, v, false, bh, tk, d, kBK) ||
      !make_map(&mo, dout, false, bh, t, d, kBQ) ||
      !make_map(&macc, dq_acc, true, bh, t, d, kBQ))
    return cudaErrorInvalidValue;
  const size_t smem = Fused<DP>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_bf16<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const int nk = (tk + kBK - 1) / kBK;
  flash_bwd_bf16<DP><<<nk * bh, kFusedThreads, smem, st>>>(
      mq, mk, mv, mo, macc, lse, delta, static_cast<bf16*>(dq),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), dq_acc, turns, bh, t,
      tk, d, scale, causal, window, off);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: one fused pass, exact float32 on the CUDA cores, register-tiled
// ---------------------------------------------------------------------------

using ftile::chunk;
using ftile::kTile;

constexpr int kBwdF32Threads = 256;  // a 16 x 16 grid: tx = tid % 16,
                                     // ty = tid / 16

// The kv tiles [jf, jl] whose band meets the 64-row q tile at q0 (f32
// tiling: 64 q rows, 64 keys), for a q tile that meets one
__device__ __forceinline__ void band_span64(int q0, int nk, int causal,
                                            int window, int off, int& jf,
                                            int& jl) {
  jf = 0;
  jl = nk - 1;
  if (!causal) return;
  jl = min(jl, floor_div(q0 + kTile - 1 + off, kTile));
  if (window)
    jf = max(0, floor_div(q0 + off - window - (kTile - 1), kTile) + 1);
}

template <int DP>
struct BwdF32 {  // shared-memory plan, in floats
  static constexpr int TILE = kTile * DP;
  static constexpr int OFF_K = 0;
  static constexpr int OFF_V = TILE;
  static constexpr int OFF_Q = 2 * TILE;              // 2 stages
  static constexpr int OFF_O = 4 * TILE;              // 2 stages (dO)
  static constexpr int OFF_P = 6 * TILE;              // P, [q row][key]
  static constexpr int OFF_S = OFF_P + kTile * kTile;  // dS, [q row][key]
  static constexpr int OFF_L = OFF_S + kTile * kTile;  // lse, 2 stages
  static constexpr int OFF_D = OFF_L + 2 * kTile;      // delta, 2 stages
  static constexpr size_t SMEM = sizeof(float) * (OFF_D + 2 * kTile);
};

template <int DP>
__global__ void __launch_bounds__(kBwdF32Threads, 1)
    flash_bwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v,
                  const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dq,
                  float* __restrict__ dk, float* __restrict__ dv,
                  int* __restrict__ turns, int BH, int T, int Tk, int D,
                  float scale, int causal, int window, int off) {
  using L = BwdF32<DP>;
  constexpr int NV = DP / 64;  // 4-column chunks of dK, dV, dQ a thread owns
  extern __shared__ float4 fsm4[];
  float* sm = reinterpret_cast<float*>(fsm4);
  float* sK = sm + L::OFF_K;
  float* sV = sm + L::OFF_V;
  float* sP = sm + L::OFF_P;
  float* sS = sm + L::OFF_S;

  const int bh = blockIdx.x % BH;
  const int j = blockIdx.x / BH;  // kv tile: kv-tile-major launch order
  const int k0 = j * kTile;
  const int nq = (T + kTile - 1) / kTile;
  const int nk = (Tk + kTile - 1) / kTile;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t qoff = (size_t)bh * T * D, koff = (size_t)bh * Tk * D;
  // the q tiles that meet the band: one contiguous run [i0, i1), walked
  // from the last one down
  int i0 = 0;
  while (i0 < nq &&
         !band_run(i0 * kTile, kTile, k0, kTile, causal, window, off))
    ++i0;
  int i1 = i0;
  while (i1 < nq && band_run(i1 * kTile, kTile, k0, kTile, causal, window,
                             off))
    ++i1;
  const int n_it = i1 - i0;

  // Q, dO, lse and delta of q tile i into stage st
  auto load_stage = [&](int st, int i) {
    const int q0 = i * kTile;
    ftile::load_tile<DP, kBwdF32Threads>(sm + L::OFF_Q + st * L::TILE, q + qoff, q0, T, D,
                        tid);
    ftile::load_tile<DP, kBwdF32Threads>(sm + L::OFF_O + st * L::TILE, dout + qoff, q0, T, D,
                        tid);
    if (tid < 2 * kTile) {
      const int r = tid % kTile, row = q0 + r;
      const float* src = (tid < kTile ? lse : delta) + (size_t)bh * T;
      float* dst = sm + (tid < kTile ? L::OFF_L : L::OFF_D) + st * kTile + r;
      ftile::cp_async4(dst, row < T ? src + row : src, row < T);
    }
  };
  if (n_it > 0) {
    ftile::load_tile<DP, kBwdF32Threads>(sK, k + koff, k0, Tk, D, tid);
    ftile::load_tile<DP, kBwdF32Threads>(sV, v + koff, k0, Tk, D, tid);
    load_stage(0, i1 - 1);
    ftile::cp_commit();
  }

  // Two groups of four warps: group 0 computes S^T and owns dV, group 1
  // dP^T and dK (keys k0 + 8 ty + a, columns 4 tx + 64 c); both share dQ.
  const int grp = tid / 128, gt = tid % 128, gy = gt / 16;
  const float sl = scale * kLog2e;  // exp(x) = 2^(x log2 e)
  float4 acc[8][NV];
  int* pending = nullptr;  // the turn counter of the last tile's dq part
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int c = 0; c < NV; ++c) acc[a][c] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1, i = i1 - 1 - it, q0 = i * kTile;
    float* sQ = sm + L::OFF_Q + st * L::TILE;
    float* sO = sm + L::OFF_O + st * L::TILE;
    const float* sL = sm + L::OFF_L + st * kTile;
    const float* sD = sm + L::OFF_D + st * kTile;
    ftile::cp_wait_all();
    __syncthreads();  // this stage landed; the last tile is done with the
                      // other stage, sP and sS
    if (it + 1 < n_it) {  // the next q tile lands during this one
      load_stage(st ^ 1, i - 1);
      ftile::cp_commit();
    }

    // group 0: S^T = K Q^T, group 1: dP^T = V dO^T; keys 8 gy + a, q rows
    // tx + 16 b; in depth order
    float* sA = grp ? sV : sK;
    float* sB = grp ? sO : sQ;
    float s[8][4];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = 0.f;
#pragma unroll 2
    for (int c = 0; c < D / 4; ++c) {
      float4 af[8], bf[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) bf[b] = *chunk<DP>(sB, tx + 16 * b, c);
#pragma unroll
      for (int a = 0; a < 8; ++a) af[a] = *chunk<DP>(sA, 8 * gy + a, c);
      // one depth at a time over all 8 x 4 sums: 32 independent FMAs
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b)
            s[a][b] = fmaf(ftile::get(af[a], e), ftile::get(bf[b], e),
                           s[a][b]);
    }

    // P^T = exp(scale s - lse) and dS^T = P^T (dP^T - delta) scale over the
    // valid pairs, 0 elsewhere (a select: a row with no valid column
    // carries lse ~ -1e30); stored [q row][key]. The groups swap halves:
    // group 1 hands dP^T of q rows tx, tx + 16 over through sS, group 0 S^T
    // of q rows tx + 32, tx + 48 through sP; each then forms P^T and dS^T
    // of its half.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = tx + 16 * (h + 2 * (1 - grp));
      float* dst = grp ? sS : sP;
#pragma unroll
      for (int h4 = 0; h4 < 2; ++h4)
        *chunk<kTile>(dst, r, 2 * gy + h4) =
            grp ? make_float4(s[4 * h4][h], s[4 * h4 + 1][h],
                              s[4 * h4 + 2][h], s[4 * h4 + 3][h])
                : make_float4(s[4 * h4][h + 2], s[4 * h4 + 1][h + 2],
                              s[4 * h4 + 2][h + 2], s[4 * h4 + 3][h + 2]);
    }
    __syncthreads();
    {
      const bool edge =
          !tile_full(q0, kTile, k0, kTile, T, Tk, causal, window, off);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int b = h + 2 * grp, r = tx + 16 * b, row = q0 + r;
        const float lq = sL[r] * kLog2e, dl = sD[r];
#pragma unroll
        for (int h4 = 0; h4 < 2; ++h4) {
          float4* pp = chunk<kTile>(sP, r, 2 * gy + h4);
          float4* dsp = chunk<kTile>(sS, r, 2 * gy + h4);
          // the other group's half: S^T for group 1, dP^T for group 0
          const float4 other = grp ? *pp : *dsp;
          float p[4], ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int a = 4 * h4 + e;
            const float mine = grp ? s[a][h + 2] : s[a][h];
            const float sv = grp ? ftile::get(other, e) : mine;
            const float dpv = grp ? mine : ftile::get(other, e);
            const bool ok = !edge || band_valid(row, k0 + 8 * gy + a, T, Tk,
                                                causal, window, off);
            p[e] = ok ? fast_exp2(fmaf(sv, sl, -lq)) : 0.f;
            ds[e] = ok ? p[e] * (dpv - dl) * scale : 0.f;
          }
          *pp = make_float4(p[0], p[1], p[2], p[3]);
          *dsp = make_float4(ds[0], ds[1], ds[2], ds[3]);
        }
      }
    }
    __syncthreads();  // every P and dS of the tile is stored (and the last
                      // tile's dq part: its turn passes on)
    if (pending != nullptr) {
      if (tid == 0) red_release(pending, 1);
      pending = nullptr;
    }

    // group 0: dV += P^T dO, group 1: dK += dS^T Q; keys 8 gy + a, columns
    // 4 tx + 64 c; in q row order
    {
      float* sX = grp ? sS : sP;
      float* sY = grp ? sQ : sO;
#pragma unroll
      for (int r = 0; r < kTile; ++r) {
        const float4 x0 = *chunk<kTile>(sX, r, 2 * gy);
        const float4 x1 = *chunk<kTile>(sX, r, 2 * gy + 1);
#pragma unroll
        for (int c = 0; c < NV; ++c) {
          const float4 yf = *chunk<DP>(sY, r, tx + 16 * c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ftile::fma4(acc[e][c], ftile::get(x0, e), yf);
            ftile::fma4(acc[4 + e][c], ftile::get(x1, e), yf);
          }
        }
      }
    }

    // dq of q tile i, summed in kv-tile order under the tile's turn
    // counter: kv tile j adds when the counter equals the number of band kv
    // tiles before it (the first one stores), then passes the turn on. The
    // turn is taken, and the sum so far loaded, before dS K is computed, so
    // the loads' latency hides behind it (a later kv tile rarely waits:
    // it started later, or one turn behind).
    int jf, jl;
    band_span64(q0, nk, causal, window, off, jf, jl);
    int* cnt = turns + (size_t)bh * nq + i;
    float4 dqa[4][NV];
    if (j > jf) {
      if (tid == 0)
        while (ld_acquire(cnt) != j - jf) __nanosleep(32);
      __syncthreads();  // the earlier kv tiles' sum is in dq
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = q0 + 4 * ty + a;
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        const int col = 4 * tx + 64 * c;
        dqa[a][c] = j > jf && row < T && col < D
                        ? __ldcg(reinterpret_cast<const float4*>(
                              dq + qoff + (size_t)row * D + col))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }

    // dQ_i = dS K over this kv tile: rows 4 ty + a, columns 4 tx + 64 c, in
    // key order, summed apart and then added to the sum so far
    float4 part[4][NV];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < NV; ++c) part[a][c] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int kc = 0; kc < kTile / 4; ++kc) {
      float4 sf[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) sf[a] = *chunk<kTile>(sS, 4 * ty + a, kc);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int c = 0; c < NV; ++c) {
          const float4 kf = *chunk<DP>(sK, 4 * kc + e, tx + 16 * c);
#pragma unroll
          for (int a = 0; a < 4; ++a)
            ftile::fma4(part[a][c], ftile::get(sf[a], e), kf);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = q0 + 4 * ty + a;
      if (row >= T) continue;
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        const int col = 4 * tx + 64 * c;
        if (col >= D) continue;
        const float4 old = dqa[a][c], x = part[a][c];
        __stcg(reinterpret_cast<float4*>(dq + qoff + (size_t)row * D + col),
               j > jf ? make_float4(old.x + x.x, old.y + x.y, old.z + x.z,
                                    old.w + x.w)
                      : x);
      }
    }
    // the turn passes on at the next tile's exchange barrier, when these
    // stores are long done and the release's fence costs little
    if (j < jl) pending = cnt;
  }
  if (pending != nullptr) {
    __syncthreads();  // every thread's part is stored
    if (tid == 0) red_release(pending, 1);
  }

  // group 0 stores dV, group 1 dK: rows k0 + 8 gy + a, columns 4 tx + 64 c
  // (zeros for a kv tile no q tile meets)
  float* out = grp ? dk : dv;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int key = k0 + 8 * gy + a;
    if (key >= Tk) continue;
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const int col = 4 * tx + 64 * c;
      if (col < D)
        *reinterpret_cast<float4*>(out + koff + (size_t)key * D + col) =
            acc[a][c];
    }
  }
}

template <int DP>
cudaError_t launch_f32(const float* q, const float* k, const float* v,
                       const float* dout, const float* lse,
                       const float* delta, float* dq, float* dk, float* dv,
                       int* turns, int bh, int t, int tk, int d, float scale,
                       int causal, int window, int off, cudaStream_t st) {
  const size_t smem = BwdF32<DP>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_f32<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(flash_bwd_f32<DP>,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  const int nk = (tk + kTile - 1) / kTile;
  flash_bwd_f32<DP><<<nk * bh, kBwdF32Threads, smem, st>>>(
      q, k, v, dout, lse, delta, dq, dk, dv, turns, bh, t, tk, d, scale,
      causal, window, off);
  return cudaGetLastError();
}

}  // namespace

// q, dout: contiguous (bh, t, d); k, v: (bh, tk, d); lse, delta: (bh, t)
// float32; all 16-byte aligned, q/k/v/dout of one dtype (0 = float32,
// 1 = bfloat16); dq like q, dk and dv like k. d <= 128 and a multiple of 8.
// Both dtypes take dq zero-filled and int32 turn counters of
// (bh, ceil(t / 64)), zeroed; bf16 also takes an f32 scratch dq_acc of
// (bh, t, d) (uninitialised), float32 none (null). Launches one kernel on
// `stream`, allocates nothing, and returns the launch's cudaError_t.
extern "C" int flash_bwd(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, void* dq, void* dk, void* dv,
                         float* dq_acc, int* turns, int bh, int t, int tk,
                         int d, float scale, int causal, int window,
                         int band_offset, int dtype, void* stream) {
  if (bh <= 0 || t <= 0 || tk <= 0 || d <= 0 || d > 128 || d % 8 ||
      dq == nullptr || dk == nullptr || dv == nullptr || turns == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const float* qf = static_cast<const float*>(q);
    const float* kf = static_cast<const float*>(k);
    const float* vf = static_cast<const float*>(v);
    const float* of = static_cast<const float*>(dout);
    float* dqf = static_cast<float*>(dq);
    float* dkf = static_cast<float*>(dk);
    float* dvf = static_cast<float*>(dv);
    if (d <= 64)
      return (int)launch_f32<64>(qf, kf, vf, of, lse, delta, dqf, dkf, dvf,
                                 turns, bh, t, tk, d, scale, causal, window,
                                 band_offset, st);
    return (int)launch_f32<128>(qf, kf, vf, of, lse, delta, dqf, dkf, dvf,
                                turns, bh, t, tk, d, scale, causal, window,
                                band_offset, st);
  }
  if (dtype != 1 || dq_acc == nullptr) return (int)cudaErrorInvalidValue;
  if (d <= 16)
    return (int)launch_bf16<16>(q, k, v, dout, lse, delta, dq, dk, dv,
                                dq_acc, turns, bh, t, tk, d, scale, causal,
                                window, band_offset, st);
  if (d <= 32)
    return (int)launch_bf16<32>(q, k, v, dout, lse, delta, dq, dk, dv,
                                dq_acc, turns, bh, t, tk, d, scale, causal,
                                window, band_offset, st);
  if (d <= 64)
    return (int)launch_bf16<64>(q, k, v, dout, lse, delta, dq, dk, dv,
                                dq_acc, turns, bh, t, tk, d, scale, causal,
                                window, band_offset, st);
  return (int)launch_bf16<128>(q, k, v, dout, lse, delta, dq, dk, dv, dq_acc,
                               turns, bh, t, tk, d, scale, causal, window,
                               band_offset, st);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
