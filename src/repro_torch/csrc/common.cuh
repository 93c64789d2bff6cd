// Helpers shared by the kernel sources in this directory: storage-type
// loads and stores with f32 arithmetic, cp.async copies, a fixed-order block
// sum, and the fixed-order reduce of per-tile logdet partials.  Every .cu file here
// includes it; the build hashes it with each source.

#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float load_f(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16(v);
}

// Asynchronous global -> shared copies (cp.async): 16 bytes (both addresses
// 16-byte aligned) or 4; a commit closes a group, a wait lets all but the
// newest group (wait_prev) or every group (wait_all) land first.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Sum of v over the block in a fixed order; the result is valid in thread 0.
__device__ float block_sum(float v, float* warp_buf) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_buf[warp] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) s += warp_buf[w];
  return s;
}

// ld[b] = sum_tile partial[b, tile], one warp per batch row, fixed order.
__global__ void ld_reduce_kernel(const float* __restrict__ partial, float* __restrict__ ld,
                                 int n_tiles) {
  const int b = blockIdx.x;
  float s = 0.f;
  for (int i = threadIdx.x; i < n_tiles; i += 32) s += partial[(long long)b * n_tiles + i];
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  if (threadIdx.x == 0) ld[b] = s;
}

}  // namespace
