// Flash-attention forward for Hopper (sm_90a), with a plain C interface.
//
// Replaces mxnet_tpu/ops/attention.py:_flash_fwd_kernel (wrapper
// _flash_forward). It computes what that kernel computes:
//   o[r] = sum_c softmax_c(scale * q[r].k[c]) v[c] over the valid columns c,
// with the running max, denominator and accumulator in f32; masking by
// _band_valid (causal, sliding window, band_offset) and by the ragged key
// tail; tiles wholly outside the band skipped as _band_run does; p rounded
// to V's dtype before the PV product; fully-masked rows give 0 through
// max(l, 1e-30); and the optional per-row lse = m + log(l) as one f32 per
// row (the TPU kernel replicates it over 128 lanes).
//
// Design. One CUDA block owns one (bh, 64-row q tile) and walks the k tiles
// that meet the band itself: that loop replaces the TPU grid's sequential
// kb axis, and the running statistics live in registers instead of VMEM
// scratch. The bf16 path runs both products on the tensor cores with
// mma.sync m16n8k16 (f32 accumulation), one warp per 16 q rows, in the
// FlashAttention-2 register layout: the S accumulator fragment is repacked
// into the A fragment of the PV product without touching shared memory.
// K and V tiles are double-buffered in shared memory with cp.async (the
// next tile loads while this one computes; padded rows and head dims are
// zero-filled by the copy, never garbage), and read with ldmatrix (.trans
// for V). Only the tiles that cross the band's edge or the ragged tail pay
// for per-element masking, and the softmax runs in base 2 on ex2. The f32 path is exact float32 FMA on the CUDA
// cores (one warp per q row, lanes over keys for S and over head dims for
// PV): tensor-core TF32 would change the numbers.
//
// Bound on the H100 at the flagship serving shape (B*H = 128, T = Tk =
// 2048, D = 128, bf16, causal): 4*BH*D*T*(T+1)/2 = 137 GFLOP of matrix
// work, 0.14 ms at 989 TFLOP/s, against 268 MB of q/k/v/o traffic, 0.08 ms
// at 3.35 TB/s — the kernel is bound by operations, so the design keeps
// the (T, T) scores out of device memory entirely and skips the tiles above
// the causal diagonal (half the work). What it does not do yet: wgmma, TMA
// and warp-specialised producer/consumer pipelining, the way to the card's
// full tensor rate; those belong to a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's masked-score value

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
// bf16: tensor cores through mma.sync
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;   // q rows per block: 4 warps x 16 rows
constexpr int kBK = 64;   // keys per k tile
constexpr int kPad = 8;   // bf16 elements of row padding (bank spread)
constexpr int kThreads = 128;
static_assert(kBQ == kBK, "stage_tile stages Q and K/V tiles alike");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global->shared copy that bypasses registers; src_bytes = 0
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
// rows of matrix i. .trans hands each lane a column pair instead of a
// row pair, which turns row-major V into the PV product's B fragments.
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

// 2^x on the special-function unit (relative error ~2^-22, far below
// the bf16 rounding that p gets next)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two K and two V tile buffers; the Q tile is staged once into the second
// K buffer, read into registers, and then overwritten by the k loop.
template <int DP>
constexpr size_t bf16_smem_bytes() {
  return sizeof(__nv_bfloat16) * 4 * (size_t)kBK * (DP + kPad);
}

// Stage `rows` rows [row0, row0 + rows) of a (limit, D) bf16 matrix into
// shared memory with row stride DP + kPad, zero past `limit` and past D.
template <int DP>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* s,
                                           const __nv_bfloat16* g, int row0,
                                           int limit, int D, int tid) {
  constexpr int CH = DP / 8;
  for (int c = tid; c < kBK * CH; c += kThreads) {
    const int r = c / CH, d = (c % CH) * 8, row = row0 + r;
    const bool ok = row < limit && d < D;
    cp_async16(s + r * (DP + kPad) + d, ok ? g + (size_t)row * D + d : g,
               ok);
  }
}

// One k tile's online-softmax update for a thread's two rows: scale (and,
// for tiles that cross the band's edge or the ragged tail, mask) the
// scores, rescale the running state, and leave p = exp(s - m) in s. The
// scores and the running max m are kept in base 2 (scale_log2 = scale *
// log2 e), so each p costs one subtract and one ex2.
template <bool kMask, int NDT>
__device__ __forceinline__ void softmax_tile(
    float (&s)[kBK / 8][4], float (&acc)[NDT][4], float& m0, float& m1,
    float& l0, float& l1, float scale_log2, int row0, int row1, int k0,
    int t4, int Tk, int causal, int window, int off) {
  uint32_t valid = 0xffffffffu;
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v0 = s[nt][e] * scale_log2, v1 = s[nt][2 + e] * scale_log2;
      if (kMask) {
        const int col = k0 + nt * 8 + 2 * t4 + e;
        const bool ok0 = band_valid(row0, col, Tk, causal, window, off);
        const bool ok1 = band_valid(row1, col, Tk, causal, window, off);
        v0 = ok0 ? v0 : kNegInf;
        v1 = ok1 ? v1 : kNegInf;
        valid &= ~(((ok0 ? 0u : 1u) << (nt * 4 + e)) |
                   ((ok1 ? 0u : 1u) << (nt * 4 + 2 + e)));
      }
      s[nt][e] = v0;
      s[nt][2 + e] = v1;
      mx0 = fmaxf(mx0, v0);
      mx1 = fmaxf(mx1, v1);
    }
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  const float a0 = fast_exp2(m0 - mn0), a1 = fast_exp2(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  l0 *= a0;
  l1 *= a1;
#pragma unroll
  for (int nd = 0; nd < NDT; ++nd) {
    acc[nd][0] *= a0;
    acc[nd][1] *= a0;
    acc[nd][2] *= a1;
    acc[nd][3] *= a1;
  }
  // p = exp(s - m); a masked column contributes exactly 0
#pragma unroll
  for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = (valid >> (nt * 4 + e)) & 1u
                          ? fast_exp2(s[nt][e] - (e < 2 ? mn0 : mn1))
                          : 0.f;
      s[nt][e] = p;
      if (e < 2) l0 += p; else l1 += p;
    }
  }
}

// DP: head dim rounded up to 16, 32, 64 or 128; dims >= D are zero-filled.
// Three blocks per SM (3 x 70 KB of shared memory at DP = 128): the
// register cap this sets (168 at DP = 128, with a few bytes of spill) beat
// two blocks with 206 registers on the H100.
template <int DP>
__global__ void __launch_bounds__(kThreads, 3)
    flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                   int T, int Tk, int D, int nq, float scale, int causal,
                   int window, int off) {
  constexpr int QS = DP + kPad;  // row stride of every tile buffer
  constexpr int TILE = kBK * QS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + 2 * TILE;
  __nv_bfloat16* sQ = sK + TILE;  // aliases K buffer 1 until the loop

  const int bh = blockIdx.x / nq;
  const int q0 = (nq - 1 - blockIdx.x % nq) * kBQ;  // longest rows first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const __nv_bfloat16* kb = k + (size_t)bh * Tk * D;
  const __nv_bfloat16* vb = v + (size_t)bh * Tk * D;

  // the k tiles that meet the band: one contiguous run
  const int nk = (Tk + kBK - 1) / kBK;
  int kt0 = 0;
  while (kt0 < nk && !band_run(q0, kBQ, kt0 * kBK, kBK, causal, window, off))
    ++kt0;
  int kt1 = kt0;
  while (kt1 < nk && band_run(q0, kBQ, kt1 * kBK, kBK, causal, window, off))
    ++kt1;

  // prologue: Q and the first K/V tile, then Q into mma A fragments
  stage_tile<DP>(sQ, q + (size_t)bh * T * D, q0, T, D, tid);
  if (kt0 < kt1) {
    stage_tile<DP>(sK, kb, kt0 * kBK, Tk, D, tid);
    stage_tile<DP>(sV, vb, kt0 * kBK, Tk, D, tid);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[DP / 16][4];
  const int qr = warp * 16 + g;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const __nv_bfloat16* p0 = sQ + qr * QS + kk * 16 + 2 * t4;
    const __nv_bfloat16* p1 = p0 + 8 * QS;
    qf[kk][0] = ld32(p0);
    qf[kk][1] = ld32(p1);
    qf[kk][2] = ld32(p0 + 8);
    qf[kk][3] = ld32(p1 + 8);
  }
  __syncthreads();  // sQ is K buffer 1 from here on

  float acc[DP / 8][4];
#pragma unroll
  for (int nd = 0; nd < DP / 8; ++nd)
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  const int row0 = q0 + qr, row1 = row0 + 8;
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: matrix, row
  const float scale_log2 = scale * 1.4426950408889634f;

  for (int kt = kt0; kt < kt1; ++kt) {
    const int buf = (kt - kt0) & 1, k0 = kt * kBK;
    if (kt + 1 < kt1) {  // prefetch the next tile while this one computes
      stage_tile<DP>(sK + (buf ^ 1) * TILE, kb, k0 + kBK, Tk, D, tid);
      stage_tile<DP>(sV + (buf ^ 1) * TILE, vb, k0 + kBK, Tk, D, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile has landed for every warp
    const __nv_bfloat16* tK = sK + buf * TILE;
    const __nv_bfloat16* tV = sV + buf * TILE;

    // S = Q K^T for 16 rows x 64 keys: 8 n-tiles of 8 keys
    float s[kBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < kBK / 16; ++np) {
        uint32_t b[4];
        ldsm_x4(b, tK + ((2 * np + (mi >> 1)) * 8 + mr) * QS + kk * 16 +
                       (mi & 1) * 8);
        mma_bf16(s[2 * np], qf[kk], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qf[kk], b[2], b[3]);
      }
    }

    const bool full =
        k0 + kBK <= Tk &&
        (!causal || (q0 + off >= k0 + kBK - 1 &&
                     (!window || q0 + kBQ - 1 + off - k0 < window)));
    if (full)
      softmax_tile<false>(s, acc, m0, m1, l0, l1, scale_log2, row0, row1, k0,
                          t4, Tk, causal, window, off);
    else
      softmax_tile<true>(s, acc, m0, m1, l0, l1, scale_log2, row0, row1, k0,
                         t4, Tk, causal, window, off);

    // O += P V: the S accumulators of n-tiles 2j, 2j+1 are the A
    // fragment of k-step j (p rounded to bf16 here, as on the TPU)
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                              pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int np = 0; np < DP / 16; ++np) {
        uint32_t b[4];
        ldsm_x4_trans(b, tV + (j * 16 + (mi & 1) * 8 + mr) * QS +
                             (2 * np + (mi >> 1)) * 8);
        mma_bf16(acc[2 * np], pa, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int nd = 0; nd < DP / 8; ++nd) {
    const int col = nd * 8 + 2 * t4;
    if (col >= D) continue;
    if (row0 < T)
      *reinterpret_cast<__nv_bfloat162*>(o + ((size_t)bh * T + row0) * D +
                                         col) =
          __floats2bfloat162_rn(acc[nd][0] / d0, acc[nd][1] / d0);
    if (row1 < T)
      *reinterpret_cast<__nv_bfloat162*>(o + ((size_t)bh * T + row1) * D +
                                         col) =
          __floats2bfloat162_rn(acc[nd][2] / d1, acc[nd][3] / d1);
  }
  if (lse != nullptr && t4 == 0) {
    // back to base e; a row with no valid column keeps the -1e30 sentinel
    constexpr float kLn2 = 0.6931471805599453f;
    if (row0 < T)
      lse[(size_t)bh * T + row0] = (m0 > kNegInf ? m0 * kLn2 : kNegInf) +
                                   logf(d0);
    if (row1 < T)
      lse[(size_t)bh * T + row1] = (m1 > kNegInf ? m1 * kLn2 : kNegInf) +
                                   logf(d1);
  }
}

template <int DP>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        float* lse, int bh, int t, int tk, int d, float scale,
                        int causal, int window, int off, cudaStream_t st) {
  const size_t smem = bf16_smem_bytes<DP>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_bf16<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const int nq = (t + kBQ - 1) / kBQ;
  flash_fwd_bf16<DP><<<bh * nq, kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lse, t, tk, d, nq, scale, causal, window, off);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: exact float32 on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kFRows = 16;  // q rows per block: 4 warps x 4 rows
constexpr int kFBK = 32;    // keys per k tile: one per lane

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
// (bh, t) float32 or null. d <= 128 and a multiple of 8. Launches on
// `stream`, allocates nothing, and returns the launch's cudaError_t.
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
  if (dtype != 1) return (int)cudaErrorInvalidValue;
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
