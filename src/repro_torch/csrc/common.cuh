// Helpers shared by the kernel sources in this directory: storage-type
// loads and stores with f32 arithmetic; the ring helpers (cp.async copies of
// contiguous slabs into shared memory, 16-byte accesses of staged values,
// 16-byte stores back); a fixed-order block sum and the fixed-order reduces
// of per-block partials; the TF32 tensor-core product with its 3xTF32 split;
// and the sum of per-block values over a thread-block cluster in rank
// order.  Every .cu file here includes it; the build hashes it with each
// source.

#pragma once

#include <cstdint>

#include <cooperative_groups.h>
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
// newest N groups (cp_async_wait<N>) land first.
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
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp_async_wait_prev() { cp_async_wait<1>(); }
__device__ __forceinline__ void cp_async_wait_all() { cp_async_wait<0>(); }

// n contiguous elements of T from src into shared dst (both 16-byte
// aligned): 16-byte cp.async copies, the elements past the last 16 bytes one
// at a time; thread tid of nthreads takes pieces tid, tid + nthreads, ...
template <typename T>
__device__ __forceinline__ void stage_elems(unsigned char* dst, const T* __restrict__ src, int n,
                                            int tid, int nthreads) {
  const int chunks = n * (int)sizeof(T) / 16;
  for (int c = tid; c < chunks; c += nthreads)
    cp_async16(dst + 16 * c, reinterpret_cast<const unsigned char*>(src) + 16 * c);
  for (int e = chunks * 16 / (int)sizeof(T) + tid; e < n; e += nthreads)
    reinterpret_cast<T*>(dst)[e] = src[e];
}

// n contiguous elements of T from shared src back to dst (both 16-byte
// aligned): 16-byte stores, the elements past the last 16 bytes one at a time
template <typename T>
__device__ __forceinline__ void store_elems(T* __restrict__ dst, const unsigned char* src, int n,
                                            int tid, int nthreads) {
  const int chunks = n * (int)sizeof(T) / 16;
  for (int c = tid; c < chunks; c += nthreads)
    *reinterpret_cast<uint4*>(reinterpret_cast<unsigned char*>(dst) + 16 * c) =
        *reinterpret_cast<const uint4*>(src + 16 * c);
  for (int e = chunks * 16 / (int)sizeof(T) + tid; e < n; e += nthreads)
    dst[e] = reinterpret_cast<const T*>(src)[e];
}

// VB bytes (16, 8 or 4) as 32-bit words, from or to shared memory
template <int VB>
__device__ __forceinline__ void load_words(const unsigned char* p, uint32_t* w) {
  if constexpr (VB == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
  } else if constexpr (VB == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x, w[1] = u.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
}
template <int VB>
__device__ __forceinline__ void store_words(unsigned char* p, const uint32_t* w) {
  if constexpr (VB == 16) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if constexpr (VB == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
    *reinterpret_cast<uint32_t*>(p) = w[0];
  }
}

// The widest access (16, 8 or 4 bytes) that n values of type T split into
template <typename T, int n>
__host__ __device__ constexpr int vec_bytes() {
  return (n * sizeof(T)) % 16 == 0 ? 16 : (n * sizeof(T)) % 8 == 0 ? 8 : 4;
}

// n values of type T at p (n * sizeof(T) a multiple of 4, p aligned to its
// vec_bytes) to f32, and back (rounded to nearest even, as store_f)
template <typename T, int n>
__device__ __forceinline__ void load_vals(const unsigned char* p, float* out) {
  constexpr int kWords = n * (int)sizeof(T) / 4;
  constexpr int VB = vec_bytes<T, n>();
  uint32_t w[kWords];
#pragma unroll
  for (int v = 0; v < kWords / (VB / 4); ++v) load_words<VB>(p + VB * v, w + (VB / 4) * v);
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    if constexpr (sizeof(T) == 4) {
      out[i] = __uint_as_float(w[i]);
    } else {
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}
template <typename T, int n>
__device__ __forceinline__ void store_vals(unsigned char* p, const float* in) {
  constexpr int kWords = n * (int)sizeof(T) / 4;
  constexpr int VB = vec_bytes<T, n>();
  uint32_t w[kWords];
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    if constexpr (sizeof(T) == 4) {
      w[i] = __float_as_uint(in[i]);
    } else {
      const __nv_bfloat162 b2 = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&b2);
    }
  }
#pragma unroll
  for (int v = 0; v < kWords / (VB / 4); ++v) store_words<VB>(p + VB * v, w + (VB / 4) * v);
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
// kDependent: launched as a programmatic dependent of the grid that stores
// the partials (cudaLaunchAttributeProgrammaticStreamSerialization), it is
// scheduled while that grid's last blocks run and waits in
// griddepcontrol.wait for the grid to complete and its stores to be
// visible; the wait returns at once in a plain launch.
template <bool kDependent = false>
__global__ void ld_reduce_kernel(const float* __restrict__ partial, float* __restrict__ ld,
                                 int n_tiles) {
  if constexpr (kDependent) asm volatile("griddepcontrol.wait;" ::: "memory");
  const int b = blockIdx.x;
  float s = 0.f;
  for (int i = threadIdx.x; i < n_tiles; i += 32) s += partial[(long long)b * n_tiles + i];
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  if (threadIdx.x == 0) ld[b] = s;
}

// out[o] = sum over parts of partial[part, o]: one warp per entry o, lane l
// summing parts l, l + 32, ... in order, then a fixed shuffle tree.  Launch
// with ceil(width * 32 / kThreads) blocks of kThreads.
__global__ void reduce_partials_kernel(const float* __restrict__ partial, float* __restrict__ out,
                                       int n_parts, int width) {
  const int o = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (o >= width) return;  // o is the same across a warp
  float s = 0.f;
  for (int c = lane; c < n_parts; c += 32) s += partial[(long long)c * width + o];
  for (int d = 16; d > 0; d >>= 1) s += __shfl_down_sync(0xffffffffu, s, d);
  if (lane == 0) out[o] = s;
}

inline cudaError_t launch_reduce_partials(const float* partial, float* out, int n_parts,
                                          int width, cudaStream_t s) {
  const long long blocks = ((long long)width * 32 + kThreads - 1) / kThreads;
  reduce_partials_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(partial, out, n_parts, width);
  return cudaGetLastError();
}

// f32 to TF32 (round to nearest, ties away), as a TF32 operand's bits
__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// v as a TF32 hi and, with kSplit, the TF32 lo of what hi leaves; without
// kSplit (a value TF32 holds exactly, such as a bf16 one) lo is 0
template <bool kSplit>
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = kSplit ? to_tf32(v) : __float_as_uint(v);
  lo = kSplit ? to_tf32(v - __uint_as_float(hi)) : 0u;
}

// d += a b: a 16 x 8 (row), b 8 x 8 (col), TF32 operands, f32 sums
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32 from split operands: a_lo b_hi + a_hi b_lo + a_hi b_hi
// (2^-22 of each term dropped); a product whose lo halves are both 0 is one
// TF32 product (kA / kB: whether a / b carry a lo half)
template <bool kA, bool kB>
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  if constexpr (kA) mma_tf32(d, al, bh);
  if constexpr (kB) mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// Element (r, i) of a staged (rows, W) slab as f32, 0 past its rows or w
template <typename T, int W>
__device__ __forceinline__ float slab_at(const unsigned char* s, int r, int i, int rows, int w) {
  return r < rows && i < w ? load_f(reinterpret_cast<const T*>(s), r * W + i) : 0.f;
}

// The entries of E that each block of a cl-block cluster sums
__host__ __device__ constexpr int cluster_slice(int E, int cl) { return (E + cl - 1) / cl; }

// The sum over the blocks of this thread-block cluster of E values a block,
// in rank order, over distributed shared memory.  Every block gives value(e)
// for each e < E; block o owns entries [o per, (o+1) per), per =
// cluster_slice(E, cl), and writes their sums to dst[e].  inbox: cl * per
// floats of the block's shared memory, written by the cluster's blocks
// before the one cluster barrier and read only by its own block after it.
template <typename F>
__device__ __forceinline__ void cluster_sum(int E, F value, float* inbox, float* __restrict__ dst) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int per = cluster_slice(E, cl);
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    const float s = value(e);
    const int o = e / per;
    cluster.map_shared_rank(inbox, o)[rank * per + e - o * per] = s;
  }
  cluster.sync();  // every inbox is full
  for (int e = threadIdx.x; e < per && rank * per + e < E; e += blockDim.x) {
    float s = 0.f;
    for (int q = 0; q < cl; ++q) s += inbox[q * per + e];
    dst[rank * per + e] = s;
  }
}

// The launch of kernel on grid blocks of `threads`, in clusters of cl
// blocks, with `smem` bytes of dynamic shared memory (opted in to above
// 48 KB); attr holds the cluster attribute cfg points to
template <typename... KArgs>
cudaError_t cluster_config(void (*kernel)(KArgs...), int grid, int threads, size_t smem, int cl,
                           cudaStream_t s, cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && cl > 8)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cl;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return err;
}

template <typename... KArgs, typename... Args>
cudaError_t launch_clustered(void (*kernel)(KArgs...), int grid, int threads, size_t smem, int cl,
                             cudaStream_t s, Args... args) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config(kernel, grid, threads, smem, cl, s, cfg, attr);
  if (err == cudaSuccess) err = cudaLaunchKernelEx(&cfg, kernel, static_cast<KArgs>(args)...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace
