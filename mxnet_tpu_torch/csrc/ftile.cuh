// Helpers of the exact-f32 flash kernels (flash_fwd_f32, flash_bwd_f32):
// 64-row tiles of f32 in shared memory, filled by cp.async and read as
// 16-byte chunks by register-tiled FFMA loops.
//
// A tile holds rows of W floats (W = the padded head dim DP, or 64 for the
// score tiles), row-major, without padding; 16-byte chunk c of row r sits at
// chunk c ^ (r & 7). So the eight lanes of a quarter warp that read chunk c
// of eight consecutive rows, or eight consecutive chunks of one row, hit
// eight different 4-bank groups: no bank conflict either way (W / 4 >= 8).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace ftile {

constexpr int kTile = 64;  // q rows or keys a tile

template <int W>
__device__ __forceinline__ float4* chunk(float* tile, int row, int c) {
  return reinterpret_cast<float4*>(tile + row * W + 4 * (c ^ (row & 7)));
}

// 16 bytes from global to shared memory, or 16 zero bytes when !in (src
// is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every copy this thread issued has landed (a __syncthreads after it makes
// every thread's copies visible to all)
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows [r0, r0 + 64) of a contiguous (n, d) f32 matrix into a DP-wide
// tile, zeros past row n and past column d (d a multiple of 4): ragged
// tails and padded head dims read as exact zeros, never as the next head.
// NT threads share the copies.
template <int DP, int NT>
__device__ __forceinline__ void load_tile(float* tile, const float* base,
                                          int r0, int n, int d, int tid) {
  constexpr int C = DP / 4;  // chunks a row
  static_assert(NT % C == 0 && (kTile * C) % NT == 0, "whole rows a pass");
  // the thread's chunk column is fixed; its rows step by NT / C
  const int c = tid % C;
  const bool col_in = 4 * c < d;
#pragma unroll
  for (int k = 0; k < kTile * C / NT; ++k) {
    const int r = tid / C + k * (NT / C);
    const bool in = col_in && r0 + r < n;
    cp_async16(chunk<DP>(tile, r, c),
               in ? base + (size_t)(r0 + r) * d + 4 * c : base, in);
  }
}

// acc += a * b, elementwise over the four lanes of b
__device__ __forceinline__ void fma4(float4& acc, float a, const float4& b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

// lane e of v (e a compile-time constant after unrolling)
__device__ __forceinline__ float get(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

}  // namespace ftile
