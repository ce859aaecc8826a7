// Flash-attention backward for Hopper (sm_90a), with a plain C interface:
// the FlashAttention-2 dq pass and dk/dv pass.
//
// Replaces mxnet_tpu/ops/attention.py:_flash_dq_kernel and
// _flash_dkv_kernel (wrapper _flash_backward). Given the forward's q, k, v,
// the output cotangent do, the forward's per-row lse and
// delta = rowsum(do * o) (minus the lse cotangent, folded in by the caller),
// they compute what those kernels compute, over the valid (row, col) pairs:
//   p  = exp(scale * q.k - lse)          (f32)
//   ds = p * (do.v - delta) * scale      (f32, then rounded to q's dtype)
//   dq = sum_col ds k,  dk = sum_row ds q,  dv = sum_row p do
// with p rounded to do's dtype before the dv product; validity by
// _band_valid (causal, sliding window, band_offset) and the ragged tails;
// masked pairs give p = 0 and ds = 0 through a select that wraps the whole
// product (never exp(s - lse) unmasked: a row with no valid column carries
// lse ~ -1e30); padded rows of every operand zero-filled; tiles wholly
// outside the band skipped as _band_run does; the outputs cast once at the
// end. No atomics: each output element has one owner, so results are
// deterministic.
//
// Design. The TPU's two-pass split stays: the dq kernel has one block per
// (bh, 64-row q tile) and walks the k tiles of the band with dq in
// registers; the dkv kernel has one block per (bh, 64-key k tile) and walks
// the q tiles of the band (32 rows each) with dk and dv in registers. The
// bf16 path runs every product on the tensor cores with mma.sync m16n8k16
// (f32 accumulation), one warp per 16 rows of the block's own tile, in the
// FlashAttention-2 register layout: the dkv kernel computes s^T = k q^T
// directly, so p^T and ds^T land in registers as the A fragments of the
// p^T do and ds^T q products, with lse and delta indexed by column. Tiles
// that stream (k/v in dq, q/do/lse/delta in dkv) are double-buffered with
// cp.async; B operands whose reduction runs over their rows (k in dq, q and
// do in dkv) are read with ldmatrix.trans. Registers: dkv holds two 16 x D
// f32 accumulators per warp (128 registers at D = 128), so its q tile is 32
// rows (s^T and dp^T take 16 registers each) and the block runs 4 warps
// under a 2-blocks-per-SM register cap (255). The f32 path is exact
// float32 FMA on the CUDA cores (lanes over keys or rows for the scores,
// over head dims for the products): tensor-core TF32 would change the
// numbers.
//
// Bound on the H100 at the flagship training shape (B*H = 128, T = Tk =
// 2048, D = 128, bf16, causal): dq does 3 products of 2*D flops per valid
// pair (q.k, do.v, ds.k), 6*D*BH*T*(T+1)/2 = 206 GFLOP, 0.209 ms at 989
// TFLOP/s, against 0.27 GB of traffic, 0.08 ms at 3.35 TB/s; dkv does 4
// (k.q, v.do, p.do, ds.q), 0.278 ms. Both are bound by operations, so the
// design keeps the (T, T) scores out of device memory and skips the tiles
// above the causal diagonal. The pair recomputes q.k and do.v once each;
// a fused one-pass design (atomic dq) needs 10*D per pair, 0.348 ms. What
// it does not do yet: wgmma, TMA, warp specialisation, the fused pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 128;  // 4 warps
constexpr int kPad = 8;        // bf16 elements of row padding (bank spread)

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global->shared copy that bypasses registers; pred = false
// writes zeros (the padded rows and head dims)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8x8 b16 matrices from shared memory; lanes 8i..8i+7 address the
// rows of matrix i. .trans hands each lane a column pair instead of a row
// pair: row-major (k, n) data becomes B fragments with k on the rows.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit (relative error ~2^-22, far below the
// bf16 rounding that p and ds get next)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Stage rows [row0, row0 + ROWS) of a (limit, D) bf16 matrix into shared
// memory with row stride DP + kPad, zero past `limit` and past D.
template <int DP, int ROWS>
__device__ __forceinline__ void stage_rows(bf16* s, const bf16* g, int row0,
                                           int limit, int D, int tid) {
  constexpr int CH = DP / 8;
  for (int c = tid; c < ROWS * CH; c += kThreads) {
    const int r = c / CH, d = (c % CH) * 8, row = row0 + r;
    const bool ok = row < limit && d < D;
    cp_async16(s + r * (DP + kPad) + d, ok ? g + (size_t)row * D + d : g,
               ok);
  }
}

// The 16 x 16 A fragment at (row r0, col c0) of a row-major bf16 tile with
// row stride S, through one ldmatrix: matrix i covers rows r0 + (i & 1) * 8
// and cols c0 + (i >> 1) * 8, giving a0..a3 in mma.sync's order.
template <int S>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int r0, int c0, int lane) {
  const int mi = lane >> 3, mr = lane & 7;
  ldsm_x4(a, tile + (r0 + (mi & 1) * 8 + mr) * S + c0 + (mi >> 1) * 8);
}

// B fragments of two n-tiles (rows n0..n0+15 of the tile are the n index,
// cols c0..c0+15 the reduction): b[0], b[1] for n0..n0+7, b[2], b[3] for
// n0+8..n0+15.
template <int S>
__device__ __forceinline__ void load_b_rows(uint32_t (&b)[4],
                                            const bf16* tile, int n0, int c0,
                                            int lane) {
  const int mi = lane >> 3, mr = lane & 7;
  ldsm_x4(b, tile + (n0 + (mi >> 1) * 8 + mr) * S + c0 + (mi & 1) * 8);
}

// B fragments of two n-tiles where the tile's rows are the reduction
// (rows r0..r0+15) and its cols the n index (cols n0..n0+15).
template <int S>
__device__ __forceinline__ void load_b_trans(uint32_t (&b)[4],
                                             const bf16* tile, int r0,
                                             int n0, int lane) {
  const int mi = lane >> 3, mr = lane & 7;
  ldsm_x4_trans(b, tile + (r0 + (mi & 1) * 8 + mr) * S + n0 + (mi >> 1) * 8);
}

// Accumulator n-tiles 2j, 2j+1 (16 columns) as the A fragment of k-step j,
// each value rounded to bf16.
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&c)[N][4], int j) {
  a[0] = pack_bf16(c[2 * j][0], c[2 * j][1]);
  a[1] = pack_bf16(c[2 * j][2], c[2 * j][3]);
  a[2] = pack_bf16(c[2 * j + 1][0], c[2 * j + 1][1]);
  a[3] = pack_bf16(c[2 * j + 1][2], c[2 * j + 1][3]);
}

// Write a warp's 16 x DP f32 accumulator (rows row0 and row0 + 8 of this
// thread) to a (limit, D) bf16 matrix.
template <int DP>
__device__ __forceinline__ void store_acc(bf16* out, const float (&c)[DP / 8][4],
                                          int row0, int limit, int D,
                                          int t4) {
  const int row1 = row0 + 8;
#pragma unroll
  for (int nd = 0; nd < DP / 8; ++nd) {
    const int col = nd * 8 + 2 * t4;
    if (col >= D) continue;
    if (row0 < limit)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row0 * D + col) =
          __floats2bfloat162_rn(c[nd][0], c[nd][1]);
    if (row1 < limit)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row1 * D + col) =
          __floats2bfloat162_rn(c[nd][2], c[nd][3]);
  }
}

// ---------------------------------------------------------------------------
// bf16 dq: one block per (bh, 64-row q tile), k tiles of 64 keys
// ---------------------------------------------------------------------------

constexpr int kDqBQ = 64;
constexpr int kDqBK = 64;

template <int DP>
constexpr size_t dq_smem_bytes() {  // Q, dO, two K and two V buffers
  return sizeof(bf16) * 6 * (size_t)kDqBK * (DP + kPad);
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 2)
    flash_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dq,
                  int T, int Tk, int D, int nq, float scale, int causal,
                  int window, int off) {
  constexpr int S = DP + kPad;
  constexpr int TILE = kDqBK * S;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sO = sQ + TILE;
  bf16* sK = sO + TILE;      // two buffers
  bf16* sV = sK + 2 * TILE;  // two buffers

  const int bh = blockIdx.x / nq;
  const int q0 = (nq - 1 - blockIdx.x % nq) * kDqBQ;  // longest rows first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t qoff = (size_t)bh * T * D;
  const bf16* kb = k + (size_t)bh * Tk * D;
  const bf16* vb = v + (size_t)bh * Tk * D;

  // the k tiles that meet the band: one contiguous run
  const int nk = (Tk + kDqBK - 1) / kDqBK;
  int kt0 = 0;
  while (kt0 < nk &&
         !band_run(q0, kDqBQ, kt0 * kDqBK, kDqBK, causal, window, off))
    ++kt0;
  int kt1 = kt0;
  while (kt1 < nk &&
         band_run(q0, kDqBQ, kt1 * kDqBK, kDqBK, causal, window, off))
    ++kt1;

  stage_rows<DP, kDqBQ>(sQ, q + qoff, q0, T, D, tid);
  stage_rows<DP, kDqBQ>(sO, dout + qoff, q0, T, D, tid);
  if (kt0 < kt1) {
    stage_rows<DP, kDqBK>(sK, kb, kt0 * kDqBK, Tk, D, tid);
    stage_rows<DP, kDqBK>(sV, vb, kt0 * kDqBK, Tk, D, tid);
  }
  cp_async_commit();

  const int wr = warp * 16;  // this warp's rows within the tile
  const int row0 = q0 + wr + g, row1 = row0 + 8;
  // lse in base 2, so each p costs one FMA and one ex2
  const float l0 = row0 < T ? lse[(size_t)bh * T + row0] * kLog2e : 0.f;
  const float l1 = row1 < T ? lse[(size_t)bh * T + row1] * kLog2e : 0.f;
  const float d0 = row0 < T ? delta[(size_t)bh * T + row0] : 0.f;
  const float d1 = row1 < T ? delta[(size_t)bh * T + row1] : 0.f;
  const float scale_log2 = scale * kLog2e;

  float acc[DP / 8][4];
#pragma unroll
  for (int nd = 0; nd < DP / 8; ++nd)
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;

  for (int kt = kt0; kt < kt1; ++kt) {
    const int buf = (kt - kt0) & 1, k0 = kt * kDqBK;
    if (kt + 1 < kt1) {  // prefetch the next tile while this one computes
      stage_rows<DP, kDqBK>(sK + (buf ^ 1) * TILE, kb, k0 + kDqBK, Tk, D,
                            tid);
      stage_rows<DP, kDqBK>(sV + (buf ^ 1) * TILE, vb, k0 + kDqBK, Tk, D,
                            tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile (and Q, dO) has landed for every warp
    const bf16* tK = sK + buf * TILE;
    const bf16* tV = sV + buf * TILE;

    // s = Q K^T and dp = dO V^T for 16 rows x 64 keys
    float s[kDqBK / 8][4], dp[kDqBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kDqBK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t qa[4], oa[4];
      load_a<S>(qa, sQ, wr, kk * 16, lane);
      load_a<S>(oa, sO, wr, kk * 16, lane);
#pragma unroll
      for (int np = 0; np < kDqBK / 16; ++np) {
        uint32_t b[4];
        load_b_rows<S>(b, tK, np * 16, kk * 16, lane);
        mma_bf16(s[2 * np], qa, b[0], b[1]);
        mma_bf16(s[2 * np + 1], qa, b[2], b[3]);
        load_b_rows<S>(b, tV, np * 16, kk * 16, lane);
        mma_bf16(dp[2 * np], oa, b[0], b[1]);
        mma_bf16(dp[2 * np + 1], oa, b[2], b[3]);
      }
    }

    // ds = p (dp - delta) scale over the valid pairs, 0 elsewhere (in s)
    const bool full =
        tile_full(q0, kDqBQ, k0, kDqBK, T, Tk, causal, window, off);
#pragma unroll
    for (int nt = 0; nt < kDqBK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool hi = e >= 2;
        const int col = k0 + nt * 8 + 2 * t4 + (e & 1);
        const bool ok = full || band_valid(hi ? row1 : row0, col, T, Tk,
                                           causal, window, off);
        const float p =
            ok ? fast_exp2(s[nt][e] * scale_log2 - (hi ? l1 : l0)) : 0.f;
        s[nt][e] = ok ? p * (dp[nt][e] - (hi ? d1 : d0)) * scale : 0.f;
      }
    }

    // dq += ds K (ds rounded to bf16 as the A fragment)
#pragma unroll
    for (int j = 0; j < kDqBK / 16; ++j) {
      uint32_t a[4];
      acc_to_a<kDqBK / 8>(a, s, j);
#pragma unroll
      for (int np = 0; np < DP / 16; ++np) {
        uint32_t b[4];
        load_b_trans<S>(b, tK, j * 16, np * 16, lane);
        mma_bf16(acc[2 * np], a, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer
  }
  cp_async_wait<0>();  // a block whose run is empty still staged Q and dO

  store_acc<DP>(dq + qoff, acc, row0, T, D, t4);
}

// ---------------------------------------------------------------------------
// bf16 dk/dv: one block per (bh, 64-key k tile), q tiles of 32 rows
// ---------------------------------------------------------------------------

constexpr int kKvBK = 64;
constexpr int kKvBQ = 32;

template <int DP>
constexpr size_t dkv_smem_bytes() {  // K, V, two Q and two dO buffers,
                                     // two lse and two delta vectors
  return sizeof(bf16) * (2 * (size_t)kKvBK + 4 * (size_t)kKvBQ) * (DP + kPad) +
         sizeof(float) * 4 * kKvBQ;
}

// lse (in base 2) and delta of q rows [q0, q0 + kKvBQ), 0 past T
__device__ __forceinline__ void stage_stats(float* sl, float* sd,
                                            const float* lse,
                                            const float* delta, int q0,
                                            int T, int tid) {
  if (tid < kKvBQ) {
    const int row = q0 + tid;
    sl[tid] = row < T ? lse[row] * kLog2e : 0.f;
  } else if (tid < 2 * kKvBQ) {
    const int row = q0 + tid - kKvBQ;
    sd[tid - kKvBQ] = row < T ? delta[row] : 0.f;
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 2)
    flash_dkv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, int T, int Tk, int D, int nk,
                   float scale, int causal, int window, int off) {
  constexpr int S = DP + kPad;
  constexpr int KT = kKvBK * S, QT = kKvBQ * S;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + KT;
  bf16* sQ = sV + KT;       // two buffers
  bf16* sO = sQ + 2 * QT;   // two buffers
  float* sL = reinterpret_cast<float*>(sO + 2 * QT);  // two buffers
  float* sD = sL + 2 * kKvBQ;                          // two buffers

  const int bh = blockIdx.x / nk;
  const int k0 = (blockIdx.x % nk) * kKvBK;  // most q tiles first (causal)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t koff = (size_t)bh * Tk * D;
  const bf16* qb = q + (size_t)bh * T * D;
  const bf16* ob = dout + (size_t)bh * T * D;
  const float* lb = lse + (size_t)bh * T;
  const float* db = delta + (size_t)bh * T;

  // the q tiles that meet the band: one contiguous run
  const int nqt = (T + kKvBQ - 1) / kKvBQ;
  int qt0 = 0;
  while (qt0 < nqt &&
         !band_run(qt0 * kKvBQ, kKvBQ, k0, kKvBK, causal, window, off))
    ++qt0;
  int qt1 = qt0;
  while (qt1 < nqt &&
         band_run(qt1 * kKvBQ, kKvBQ, k0, kKvBK, causal, window, off))
    ++qt1;

  stage_rows<DP, kKvBK>(sK, k + koff, k0, Tk, D, tid);
  stage_rows<DP, kKvBK>(sV, v + koff, k0, Tk, D, tid);
  if (qt0 < qt1) {
    stage_rows<DP, kKvBQ>(sQ, qb, qt0 * kKvBQ, T, D, tid);
    stage_rows<DP, kKvBQ>(sO, ob, qt0 * kKvBQ, T, D, tid);
    stage_stats(sL, sD, lb, db, qt0 * kKvBQ, T, tid);
  }
  cp_async_commit();

  const int wr = warp * 16;  // this warp's keys within the tile
  const int key0 = k0 + wr + g, key1 = key0 + 8;
  const float scale_log2 = scale * kLog2e;

  float dka[DP / 8][4], dva[DP / 8][4];
#pragma unroll
  for (int nd = 0; nd < DP / 8; ++nd) {
    dka[nd][0] = dka[nd][1] = dka[nd][2] = dka[nd][3] = 0.f;
    dva[nd][0] = dva[nd][1] = dva[nd][2] = dva[nd][3] = 0.f;
  }

  for (int qt = qt0; qt < qt1; ++qt) {
    const int buf = (qt - qt0) & 1, q0 = qt * kKvBQ;
    if (qt + 1 < qt1) {  // prefetch the next tile while this one computes
      const int nb = buf ^ 1;
      stage_rows<DP, kKvBQ>(sQ + nb * QT, qb, q0 + kKvBQ, T, D, tid);
      stage_rows<DP, kKvBQ>(sO + nb * QT, ob, q0 + kKvBQ, T, D, tid);
      stage_stats(sL + nb * kKvBQ, sD + nb * kKvBQ, lb, db, q0 + kKvBQ, T,
                  tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile (and K, V) has landed for every warp
    const bf16* tQ = sQ + buf * QT;
    const bf16* tO = sO + buf * QT;
    const float* tL = sL + buf * kKvBQ;
    const float* tD = sD + buf * kKvBQ;

    // s^T = K Q^T and dp^T = V dO^T for 16 keys x 32 q rows
    float st[kKvBQ / 8][4], dpt[kKvBQ / 8][4];
#pragma unroll
    for (int nt = 0; nt < kKvBQ / 8; ++nt) {
      st[nt][0] = st[nt][1] = st[nt][2] = st[nt][3] = 0.f;
      dpt[nt][0] = dpt[nt][1] = dpt[nt][2] = dpt[nt][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t ka[4], va[4];
      load_a<S>(ka, sK, wr, kk * 16, lane);
      load_a<S>(va, sV, wr, kk * 16, lane);
#pragma unroll
      for (int np = 0; np < kKvBQ / 16; ++np) {
        uint32_t b[4];
        load_b_rows<S>(b, tQ, np * 16, kk * 16, lane);
        mma_bf16(st[2 * np], ka, b[0], b[1]);
        mma_bf16(st[2 * np + 1], ka, b[2], b[3]);
        load_b_rows<S>(b, tO, np * 16, kk * 16, lane);
        mma_bf16(dpt[2 * np], va, b[0], b[1]);
        mma_bf16(dpt[2 * np + 1], va, b[2], b[3]);
      }
    }

    // p^T (in st) and ds^T (in dpt) over the valid pairs, 0 elsewhere;
    // the q row is the column here, so lse and delta index by column
    const bool full =
        tile_full(q0, kKvBQ, k0, kKvBK, T, Tk, causal, window, off);
#pragma unroll
    for (int nt = 0; nt < kKvBQ / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = nt * 8 + 2 * t4 + (e & 1);
        const bool ok = full || band_valid(q0 + qi, e >= 2 ? key1 : key0, T,
                                           Tk, causal, window, off);
        const float p = ok ? fast_exp2(st[nt][e] * scale_log2 - tL[qi]) : 0.f;
        st[nt][e] = p;
        dpt[nt][e] = ok ? p * (dpt[nt][e] - tD[qi]) * scale : 0.f;
      }
    }

    // dv += p^T dO and dk += ds^T Q (p and ds rounded to bf16)
#pragma unroll
    for (int j = 0; j < kKvBQ / 16; ++j) {
      uint32_t pa[4], sa[4];
      acc_to_a<kKvBQ / 8>(pa, st, j);
      acc_to_a<kKvBQ / 8>(sa, dpt, j);
#pragma unroll
      for (int np = 0; np < DP / 16; ++np) {
        uint32_t b[4];
        load_b_trans<S>(b, tO, j * 16, np * 16, lane);
        mma_bf16(dva[2 * np], pa, b[0], b[1]);
        mma_bf16(dva[2 * np + 1], pa, b[2], b[3]);
        load_b_trans<S>(b, tQ, j * 16, np * 16, lane);
        mma_bf16(dka[2 * np], sa, b[0], b[1]);
        mma_bf16(dka[2 * np + 1], sa, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer
  }
  cp_async_wait<0>();  // a block whose run is empty still staged K and V

  store_acc<DP>(dk + koff, dka, key0, Tk, D, t4);
  store_acc<DP>(dv + koff, dva, key0, Tk, D, t4);
}

template <int DP>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse,
                        const float* delta, void* dq, void* dk, void* dv,
                        int bh, int t, int tk, int d, float scale,
                        int causal, int window, int off, cudaStream_t st) {
  if (dq != nullptr) {
    const size_t smem = dq_smem_bytes<DP>();
    cudaError_t e = cudaFuncSetAttribute(
        flash_dq_bf16<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
    const int nq = (t + kDqBQ - 1) / kDqBQ;
    flash_dq_bf16<DP><<<bh * nq, kThreads, smem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
        delta, static_cast<bf16*>(dq), t, tk, d, nq, scale, causal, window,
        off);
    return cudaGetLastError();
  }
  const size_t smem = dkv_smem_bytes<DP>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_dkv_bf16<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const int nk = (tk + kKvBK - 1) / kKvBK;
  flash_dkv_bf16<DP><<<bh * nk, kThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), t, tk, d, nk, scale,
      causal, window, off);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: exact float32 on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kFRows = 16;  // rows of the block's own tile: 4 warps x 4
constexpr int kFCols = 32;  // rows of a streamed tile: one per lane

size_t dq_f32_smem(int d) {  // Q, dO; K, V (odd stride); ds per warp
  return sizeof(float) * (2 * (size_t)kFRows * d +
                          2 * (size_t)kFCols * (d + 1) + 4 * kFCols);
}

__global__ void __launch_bounds__(kThreads)
    flash_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq,
                 int T, int Tk, int D, int nq, float scale, int causal,
                 int window, int off) {
  extern __shared__ float fsm[];
  const int DS = D + 1;  // odd stride: lane j reading key j hits its own bank
  float* sQ = fsm;
  float* sO = sQ + kFRows * D;
  float* sK = sO + kFRows * D;
  float* sV = sK + kFCols * DS;
  float* sP = sV + kFCols * DS;

  const int bh = blockIdx.x / nq;
  const int q0 = (nq - 1 - blockIdx.x % nq) * kFRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t qoff = (size_t)bh * T * D;
  const float* kb = k + (size_t)bh * Tk * D;
  const float* vb = v + (size_t)bh * Tk * D;

  for (int i = tid; i < kFRows * D; i += kThreads) {
    const int row = q0 + i / D;
    const bool in = row < T;
    sQ[i] = in ? q[qoff + (size_t)row * D + i % D] : 0.f;
    sO[i] = in ? dout[qoff + (size_t)row * D + i % D] : 0.f;
  }

  constexpr int kRows = kFRows / 4;  // rows per warp
  float lr[kRows], dr[kRows], acc[kRows][4];
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    const int row = q0 + warp * kRows + rr;
    lr[rr] = row < T ? lse[(size_t)bh * T + row] : 0.f;
    dr[rr] = row < T ? delta[(size_t)bh * T + row] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[rr][i] = 0.f;
  }
  const int nk = (Tk + kFCols - 1) / kFCols;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kFCols;
    if (!band_run(q0, kFRows, k0, kFCols, causal, window, off)) continue;
    __syncthreads();
    for (int i = tid; i < kFCols * D; i += kThreads) {
      const int r = i / D, dd = i % D, key = k0 + r;
      const bool in = key < Tk;
      sK[r * DS + dd] = in ? kb[(size_t)key * D + dd] : 0.f;
      sV[r * DS + dd] = in ? vb[(size_t)key * D + dd] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      const int r = warp * kRows + rr, row = q0 + r, col = k0 + lane;
      float sc = 0.f, dpv = 0.f;
      for (int dd = 0; dd < D; ++dd) {
        sc = fmaf(sQ[r * D + dd], sK[lane * DS + dd], sc);
        dpv = fmaf(sO[r * D + dd], sV[lane * DS + dd], dpv);
      }
      const bool ok = band_valid(row, col, T, Tk, causal, window, off);
      const float p = ok ? expf(sc * scale - lr[rr]) : 0.f;
      sP[warp * kFCols + lane] = ok ? p * (dpv - dr[rr]) * scale : 0.f;
      __syncwarp();
      for (int j = 0; j < kFCols; ++j) {
        const float dsj = sP[warp * kFCols + j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int dd = lane + 32 * i;
          if (dd < D) acc[rr][i] = fmaf(dsj, sK[j * DS + dd], acc[rr][i]);
        }
      }
      __syncwarp();
    }
  }
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    const int row = q0 + warp * kRows + rr;
    if (row >= T) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int dd = lane + 32 * i;
      if (dd < D) dq[qoff + (size_t)row * D + dd] = acc[rr][i];
    }
  }
}

size_t dkv_f32_smem(int d) {  // K, V; Q, dO (odd stride); lse, delta;
                              // p and ds per warp
  return sizeof(float) * (2 * (size_t)kFRows * d +
                          2 * (size_t)kFCols * (d + 1) + 2 * kFCols +
                          8 * kFCols);
}

__global__ void __launch_bounds__(kThreads)
    flash_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dk,
                  float* __restrict__ dv, int T, int Tk, int D, int nk,
                  float scale, int causal, int window, int off) {
  extern __shared__ float fsm[];
  const int DS = D + 1;  // odd stride: lane j reading row j hits its own bank
  float* sK = fsm;
  float* sV = sK + kFRows * D;
  float* sQ = sV + kFRows * D;
  float* sO = sQ + kFCols * DS;
  float* sL = sO + kFCols * DS;
  float* sD = sL + kFCols;
  float* sP = sD + kFCols;        // p, 4 warps x 32
  float* sS = sP + 4 * kFCols;    // ds, 4 warps x 32

  const int bh = blockIdx.x / nk;
  const int k0 = (blockIdx.x % nk) * kFRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t koff = (size_t)bh * Tk * D;
  const float* qb = q + (size_t)bh * T * D;
  const float* ob = dout + (size_t)bh * T * D;

  for (int i = tid; i < kFRows * D; i += kThreads) {
    const int key = k0 + i / D;
    const bool in = key < Tk;
    sK[i] = in ? k[koff + (size_t)key * D + i % D] : 0.f;
    sV[i] = in ? v[koff + (size_t)key * D + i % D] : 0.f;
  }

  constexpr int kRows = kFRows / 4;  // keys per warp
  float dka[kRows][4], dva[kRows][4];
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr)
#pragma unroll
    for (int i = 0; i < 4; ++i) dka[rr][i] = dva[rr][i] = 0.f;

  const int nqt = (T + kFCols - 1) / kFCols;
  for (int qt = 0; qt < nqt; ++qt) {
    const int q0 = qt * kFCols;
    if (!band_run(q0, kFCols, k0, kFRows, causal, window, off)) continue;
    __syncthreads();
    for (int i = tid; i < kFCols * D; i += kThreads) {
      const int r = i / D, dd = i % D, row = q0 + r;
      const bool in = row < T;
      sQ[r * DS + dd] = in ? qb[(size_t)row * D + dd] : 0.f;
      sO[r * DS + dd] = in ? ob[(size_t)row * D + dd] : 0.f;
    }
    if (tid < kFCols) {
      const int row = q0 + tid;
      sL[tid] = row < T ? lse[(size_t)bh * T + row] : 0.f;
      sD[tid] = row < T ? delta[(size_t)bh * T + row] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      const int r = warp * kRows + rr, key = k0 + r, row = q0 + lane;
      float sc = 0.f, dpv = 0.f;
      for (int dd = 0; dd < D; ++dd) {
        sc = fmaf(sQ[lane * DS + dd], sK[r * D + dd], sc);
        dpv = fmaf(sO[lane * DS + dd], sV[r * D + dd], dpv);
      }
      const bool ok = band_valid(row, key, T, Tk, causal, window, off);
      const float p = ok ? expf(sc * scale - sL[lane]) : 0.f;
      sP[warp * kFCols + lane] = p;
      sS[warp * kFCols + lane] = ok ? p * (dpv - sD[lane]) * scale : 0.f;
      __syncwarp();
      for (int j = 0; j < kFCols; ++j) {
        const float pj = sP[warp * kFCols + j];
        const float dsj = sS[warp * kFCols + j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int dd = lane + 32 * i;
          if (dd < D) {
            dva[rr][i] = fmaf(pj, sO[j * DS + dd], dva[rr][i]);
            dka[rr][i] = fmaf(dsj, sQ[j * DS + dd], dka[rr][i]);
          }
        }
      }
      __syncwarp();
    }
  }
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    const int key = k0 + warp * kRows + rr;
    if (key >= Tk) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int dd = lane + 32 * i;
      if (dd < D) {
        dk[koff + (size_t)key * D + dd] = dka[rr][i];
        dv[koff + (size_t)key * D + dd] = dva[rr][i];
      }
    }
  }
}

cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, void* dk, void* dv, int bh, int t, int tk, int d,
                   float scale, int causal, int window, int off, int dtype,
                   cudaStream_t st) {
  if (bh <= 0 || t <= 0 || tk <= 0 || d <= 0 || d > 128 || d % 8)
    return cudaErrorInvalidValue;
  if (dtype == 0) {
    if (dq != nullptr) {
      const size_t smem = dq_f32_smem(d);
      cudaError_t e = cudaFuncSetAttribute(
          flash_dq_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return e;
      const int nq = (t + kFRows - 1) / kFRows;
      flash_dq_f32<<<bh * nq, kThreads, smem, st>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<const float*>(dout), lse,
          delta, static_cast<float*>(dq), t, tk, d, nq, scale, causal,
          window, off);
      return cudaGetLastError();
    }
    const size_t smem = dkv_f32_smem(d);
    cudaError_t e = cudaFuncSetAttribute(
        flash_dkv_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
    const int nk = (tk + kFRows - 1) / kFRows;
    flash_dkv_f32<<<bh * nk, kThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, static_cast<float*>(dk), static_cast<float*>(dv), t, tk, d, nk,
        scale, causal, window, off);
    return cudaGetLastError();
  }
  if (dtype != 1) return cudaErrorInvalidValue;
  if (d <= 16)
    return launch_bf16<16>(q, k, v, dout, lse, delta, dq, dk, dv, bh, t, tk,
                           d, scale, causal, window, off, st);
  if (d <= 32)
    return launch_bf16<32>(q, k, v, dout, lse, delta, dq, dk, dv, bh, t, tk,
                           d, scale, causal, window, off, st);
  if (d <= 64)
    return launch_bf16<64>(q, k, v, dout, lse, delta, dq, dk, dv, bh, t, tk,
                           d, scale, causal, window, off, st);
  return launch_bf16<128>(q, k, v, dout, lse, delta, dq, dk, dv, bh, t, tk,
                          d, scale, causal, window, off, st);
}

}  // namespace

// q, dout: contiguous (bh, t, d); k, v: (bh, tk, d); lse, delta: (bh, t)
// float32; all 16-byte aligned, q/k/v/dout of one dtype (0 = float32,
// 1 = bfloat16); dq like q. d <= 128 and a multiple of 8. Launches on
// `stream`, allocates nothing, and returns the launch's cudaError_t.
extern "C" int flash_dq(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse,
                        const float* delta, void* dq, int bh, int t, int tk,
                        int d, float scale, int causal, int window,
                        int band_offset, int dtype, void* stream) {
  if (dq == nullptr) return (int)cudaErrorInvalidValue;
  return (int)launch(q, k, v, dout, lse, delta, dq, nullptr, nullptr, bh, t,
                     tk, d, scale, causal, window, band_offset, dtype,
                     static_cast<cudaStream_t>(stream));
}

// As flash_dq; dk and dv like k.
extern "C" int flash_dkv(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, void* dk, void* dv, int bh,
                         int t, int tk, int d, float scale, int causal,
                         int window, int band_offset, int dtype,
                         void* stream) {
  if (dk == nullptr || dv == nullptr) return (int)cudaErrorInvalidValue;
  return (int)launch(q, k, v, dout, lse, delta, nullptr, dk, dv, bh, t, tk,
                     d, scale, causal, window, band_offset, dtype,
                     static_cast<cudaStream_t>(stream));
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
