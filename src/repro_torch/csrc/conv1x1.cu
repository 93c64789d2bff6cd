// Invertible 1x1 convolution for Hopper (sm_90a): the channel-mixing product
// and its weight cotangent, on the (N = B*M, C) rows of a (B, M, C) tensor.
//
// conv1x1_mm_stream_kernel (C = 12, 24, 48) and conv1x1_mm_kernel (other C)
// replace the Pallas kernel
//   src/repro/kernels/conv1x1/conv1x1.py::conv1x1_mm (_kernel)
// conv1x1_gw_kernel (with gw_reduce_kernel) replaces
//   src/repro/kernels/conv1x1/conv1x1.py::conv1x1_gw (_gw_kernel)
//
//   conv1x1_mm:  y[r, :] = x[r, :] @ W            (W in x's storage type, f32 sums)
//   conv1x1_gw:  gW = sum over r of x[r, :]^T gy[r, :]      ((C, C) float32)
//
// What bounds them: memory at the widths GLOW uses.  Each reads two values
// and writes one (conv1x1_mm) or reads two (conv1x1_gw) per element: 12.6 MB
// at (8, 16384, 12) in f32, 3.76 us at 3.35 TB/s, against 2*C flops an
// element (37.7 MFLOP, 0.56 us at 67 TFLOP/s f32).  C <= 48 is far below a
// tensor-core tile worth filling, so both run on the CUDA cores with f32
// accumulation and move each input byte once.
//
// conv1x1_mm at the GLOW widths C = 12, 24, 48 (conv1x1_mm_stream_kernel,
// C a template parameter): a persistent, vectorised stream.  The grid is
// sized from the occupancy (every SM full, no more blocks than tiles), and
// each block stages W (or W^T, read through its strides) in shared memory
// once, as f32, while its warps' first tiles load.  A lane computes OUT
// output columns of RPL rows; a warp's tile is the whole rows its lanes
// cover.  Each warp walks its tiles with a 2-stage ring of 16-byte cp.async
// copies: the next tile is in flight while the current one computes.  A lane
// reads x four columns at a time from shared memory (16- or 8-byte loads)
// and W as float4 (or float2) broadcasts, each feeding RPL rows: shared
// memory's 128 bytes a clock, not the FMAs, bound this loop, so each W load
// serves 8 FMAs.  The sum over i runs in the same order as the panel
// kernel's (the two agree bitwise); the outputs go back over the tile's
// slots once every lane has read its rows, and the warp stores the tile with
// 16-byte stores.  Any N: the last tile is masked, its bytes past the last
// 16 copied one element at a time.
//
// conv1x1_mm at other widths (conv1x1_mm_kernel), and for an x whose base is
// not 16-byte aligned: a block stages block_m rows of x and a column panel
// of W (the whole of W up to C = 90) in shared memory, as flowstep_fwd does,
// then each thread forms outputs of the tile from shared memory.  Wider C is
// cut into column panels (grid.y) so a block never needs more than 48 KB:
// C = 192 in f32 (147 KB of W) takes five panels of 42 columns.  W is read
// through its strides, so W^T (the backward's gx = gy @ W^T) needs no copy.
// The last tile of rows is masked, so any M works.
//
// conv1x1_gw: a cross-block reduction.  The TPU kernel adds into one output
// block it revisits in grid order; blocks here run in no order.  So block k
// owns a fixed chunk of rows and writes its (C, C) partial sum to partial[k];
// gw_reduce_kernel then sums each entry over the chunks, one warp per entry,
// in a fixed order.  No atomics: repeated runs are bitwise equal.  Unlike
// spine_bwd (whose per-block partials outweighed its tiles), the caller picks
// the number of chunks so the partials stay under a quarter of the inputs'
// bytes, and each thread keeps a 4x4 tile of gW in registers over a strided
// subset of the chunk's rows (8 shared-memory loads per 16 FMAs); the row
// groups are added in a fixed order at the end.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kTile = 4;  // the gW entries a thread keeps: kTile x kTile

// Shared memory: W panel (C * panel) | x tile (block_m * C)
template <typename T>
__global__ void __launch_bounds__(kThreads)
conv1x1_mm_kernel(const T* __restrict__ x, const T* __restrict__ w, long long w_si,
                  long long w_sj, T* __restrict__ y, long long N, int C, int block_m,
                  int panel) {
  extern __shared__ float smem[];
  float* ws = smem;
  float* xs = ws + C * panel;
  const int p0 = blockIdx.y * panel;
  const int P = min(panel, C - p0);
  const long long r0 = (long long)blockIdx.x * block_m;
  const int rows = (int)min((long long)block_m, N - r0);
  const long long base = r0 * C;

  for (int k = threadIdx.x; k < C * P; k += kThreads) {
    const int i = k / P;
    const int jj = k - i * P;
    ws[k] = load_f(w, i * w_si + (p0 + jj) * w_sj);
  }
  for (int k = threadIdx.x; k < rows * C; k += kThreads) xs[k] = load_f(x, base + k);
  __syncthreads();
  for (int k = threadIdx.x; k < rows * P; k += kThreads) {
    const int r = k / P;
    const int jj = k - r * P;
    const float* xr = xs + r * C;
    float acc = 0.f;
    for (int i = 0; i < C; ++i) acc = fmaf(xr[i], ws[i * P + jj], acc);
    store_f(y, base + (long long)r * C + p0 + jj, acc);
  }
}


__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_prev() {  // all but the newest group
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
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

// Tile t of a warp: rows [t*R, t*R + R) of x, contiguous in memory, copied
// into buf: 16-byte cp.async copies, and the bytes past the last 16 (a
// ragged last tile) one element at a time.
template <typename T, int C, int R>
__device__ __forceinline__ void mm_issue(const T* __restrict__ x, long long N, long long t,
                                         unsigned char* buf, int lane) {
  const long long r0 = t * R;
  const int n = (int)min((long long)R, N - r0) * C;  // elements of the tile
  const unsigned char* src = reinterpret_cast<const unsigned char*>(x + r0 * C);
  const int chunks = n * (int)sizeof(T) / 16;
  for (int c = lane; c < chunks; c += 32) cp_async16(buf + 16 * c, src + 16 * c);
  for (int e = chunks * 16 / (int)sizeof(T) + lane; e < n; e += 32)
    reinterpret_cast<T*>(buf)[e] = x[r0 * C + e];
}

// OUT: the output columns a lane computes; RPL: the rows it computes them
// for; WARPS: warps of a block.  Grid: from the occupancy, at most one tile
// per warp.  Shared memory: W (C * C f32) | each warp's ring (2 tiles of
// 32 * OUT * RPL elements of T)
template <typename T, int C, int OUT, int RPL, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
conv1x1_mm_stream_kernel(const T* __restrict__ x, const T* __restrict__ w, long long w_si,
                         long long w_sj, T* __restrict__ y, long long N) {
  constexpr int G = C / OUT;      // lanes of a row
  constexpr int R = RPL * 32 / G;  // rows of a tile
  constexpr int kTileBytes = 32 * OUT * RPL * (int)sizeof(T);
  constexpr int WV = OUT % 4 == 0 ? 4 : 2;  // W's columns a shared load reads
  static_assert(C % OUT == 0 && 32 % G == 0 && kTileBytes % 16 == 0 && OUT % 2 == 0 &&
                    C % 4 == 0, "a GLOW width");
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* ring = reinterpret_cast<unsigned char*>(ws + C * C) + warp * 2 * kTileBytes;

  const long long n_tiles = (N + R - 1) / R;
  const long long step = (long long)gridDim.x * WARPS;
  long long t = (long long)blockIdx.x * WARPS + warp;
  if (t < n_tiles) mm_issue<T, C, R>(x, N, t, ring, lane);
  cp_async_commit();
  for (int k = threadIdx.x; k < C * C; k += WARPS * 32) {
    const int i = k / C;
    ws[k] = load_f(w, i * w_si + (k - i * C) * w_sj);
  }
  __syncthreads();

  const int row0 = (lane / G) * RPL;        // the lane's first row of the tile
  const int j0 = (lane % G) * OUT;          // and its first output column
  for (int s = 0; t < n_tiles; t += step, s ^= 1) {
    unsigned char* cur = ring + s * kTileBytes;
    if (t + step < n_tiles) mm_issue<T, C, R>(x, N, t + step, ring + (s ^ 1) * kTileBytes, lane);
    cp_async_commit();
    cp_async_wait_prev();  // this thread's copies of tile t have landed
    __syncwarp();          // and every lane's
    const long long r0 = t * R;
    const int rows = (int)min((long long)R, N - r0);
    float acc[RPL][OUT];
#pragma unroll
    for (int u = 0; u < RPL; ++u)
#pragma unroll
      for (int j = 0; j < OUT; ++j) acc[u][j] = 0.f;
    if (row0 < rows) {  // rows past the end of x read what the tile holds there
#pragma unroll
      for (int i0 = 0; i0 < C; i0 += 4) {
        float xb[RPL][4];  // x[row0 + u, i0 .. i0 + 3]
#pragma unroll
        for (int u = 0; u < RPL; ++u)
          load_vals<T, 4>(cur + ((row0 + u) * C + i0) * (int)sizeof(T), xb[u]);
#pragma unroll
        for (int di = 0; di < 4; ++di) {
          const float* wr = ws + (i0 + di) * C + j0;
#pragma unroll
          for (int q = 0; q < OUT / WV; ++q) {
            float wv[WV];
            if constexpr (WV == 4) {
              const float4 w4 = reinterpret_cast<const float4*>(wr)[q];
              wv[0] = w4.x, wv[1] = w4.y, wv[2] = w4.z, wv[3] = w4.w;
            } else {
              const float2 w2 = reinterpret_cast<const float2*>(wr)[q];
              wv[0] = w2.x, wv[1] = w2.y;
            }
#pragma unroll
            for (int u = 0; u < RPL; ++u)
#pragma unroll
              for (int e = 0; e < WV; ++e)
                acc[u][WV * q + e] = fmaf(xb[u][di], wv[e], acc[u][WV * q + e]);
          }
        }
      }
    }
    __syncwarp();  // every lane has read its rows of x: y goes over them
#pragma unroll
    for (int u = 0; u < RPL; ++u)
      if (row0 + u < rows) store_vals<T, OUT>(cur + ((row0 + u) * C + j0) * (int)sizeof(T), acc[u]);
    __syncwarp();  // the tile holds y
    const int n = rows * C;
    unsigned char* dst = reinterpret_cast<unsigned char*>(y + r0 * C);
    const int chunks = n * (int)sizeof(T) / 16;
    for (int c = lane; c < chunks; c += 32)
      *reinterpret_cast<uint4*>(dst + 16 * c) = *reinterpret_cast<const uint4*>(cur + 16 * c);
    for (int e = chunks * 16 / (int)sizeof(T) + lane; e < n; e += 32)
      y[r0 * C + e] = reinterpret_cast<const T*>(cur)[e];
    __syncwarp();  // the buffer is free for the tile after next
  }
}

// kept equal to stream_smem_bytes() in kernels/conv1x1/conv1x1.py
size_t mm_stream_smem_bytes(int C, int tile_elems, int warps, int elem_size) {
  return sizeof(float) * (size_t)C * C + (size_t)warps * 2 * tile_elems * elem_size;
}

template <typename T, int C, int OUT, int RPL, int WARPS>
cudaError_t launch_stream(const void* x, const void* w, long long w_si, long long w_sj, void* y,
                          long long N, int device, cudaStream_t s) {
  auto kernel = conv1x1_mm_stream_kernel<T, C, OUT, RPL, WARPS>;
  const size_t smem = mm_stream_smem_bytes(C, 32 * OUT * RPL, WARPS, sizeof(T));
  static int per_sm = 0, n_sm = 0, n_sm_device = -1;  // asked once per instantiation and device
  if (per_sm == 0 || n_sm_device != device) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, WARPS * 32, smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    n_sm_device = device;
  }
  constexpr int R = RPL * 32 / (C / OUT);
  const long long tiles = (N + R - 1) / R;
  const long long grid = min((tiles + WARPS - 1) / WARPS, (long long)max(per_sm, 1) * n_sm);
  kernel<<<(unsigned)grid, WARPS * 32, smem, s>>>(static_cast<const T*>(x),
                                                  static_cast<const T*>(w), w_si, w_sj,
                                                  static_cast<T*>(y), N);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_stream_c(const void* x, const void* w, long long w_si, long long w_sj, void* y,
                            long long N, int C, int device, cudaStream_t s) {
  switch (C) {
    // (output columns, rows) a lane, warps a block: the fastest in f32 of a
    // sweep at GLOW's shapes on the H100 (PERF.md); kept equal to
    // STREAM_PLAN in kernels/conv1x1/conv1x1.py
    case 12: return launch_stream<T, 12, 12, 1, 8>(x, w, w_si, w_sj, y, N, device, s);
    case 24: return launch_stream<T, 24, 12, 2, 4>(x, w, w_si, w_sj, y, N, device, s);
    case 48: return launch_stream<T, 48, 6, 2, 8>(x, w, w_si, w_sj, y, N, device, s);
    default: return cudaErrorInvalidValue;
  }
}

// Block (k, s): rows [k*chunk_rows, (k+1)*chunk_rows) and the s-th set of
// per_block 4x4 tiles of gW.  Thread tid takes tile tid % per_block of the set
// and rows g, g + groups, ... of each staged slab, g = tid / per_block.
// Shared memory: x slab (stage_rows * C) | gy slab (stage_rows * C) |
//                group sums (kThreads * 16)
template <typename T>
__global__ void __launch_bounds__(kThreads)
conv1x1_gw_kernel(const T* __restrict__ x, const T* __restrict__ gy,
                  float* __restrict__ partial, long long N, int C, long long chunk_rows,
                  int stage_rows) {
  extern __shared__ float smem[];
  float* xs = smem;
  float* gs = xs + stage_rows * C;
  float* red = gs + stage_rows * C;
  const int nt = (C + kTile - 1) / kTile;
  const int tiles = nt * nt;
  const int per_block = min(tiles, kThreads);
  const int groups = kThreads / per_block;
  const int g = threadIdx.x / per_block;
  const int slot = threadIdx.x - g * per_block;
  const int tile = blockIdx.y * per_block + slot;
  const bool active = g < groups && tile < tiles;
  const int i0 = (tile / nt) * kTile;
  const int j0 = (tile % nt) * kTile;

  float acc[kTile][kTile];
#pragma unroll
  for (int u = 0; u < kTile; ++u)
#pragma unroll
    for (int v = 0; v < kTile; ++v) acc[u][v] = 0.f;

  const long long r0 = (long long)blockIdx.x * chunk_rows;
  const long long r1 = min(r0 + chunk_rows, N);
  for (long long s0 = r0; s0 < r1; s0 += stage_rows) {
    const int n = (int)min((long long)stage_rows, r1 - s0);
    __syncthreads();  // the previous slab is consumed
    for (int k = threadIdx.x; k < n * C; k += kThreads) {
      xs[k] = load_f(x, s0 * C + k);
      gs[k] = load_f(gy, s0 * C + k);
    }
    __syncthreads();
    if (active) {
      for (int r = g; r < n; r += groups) {
        float a[kTile], b[kTile];
#pragma unroll
        for (int u = 0; u < kTile; ++u) {
          a[u] = i0 + u < C ? xs[r * C + i0 + u] : 0.f;
          b[u] = j0 + u < C ? gs[r * C + j0 + u] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kTile; ++u)
#pragma unroll
          for (int v = 0; v < kTile; ++v) acc[u][v] = fmaf(a[u], b[v], acc[u][v]);
      }
    }
  }
  if (active) {
#pragma unroll
    for (int u = 0; u < kTile; ++u)
#pragma unroll
      for (int v = 0; v < kTile; ++v) red[threadIdx.x * 16 + u * kTile + v] = acc[u][v];
  }
  __syncthreads();
  // the row groups of each tile, added in group order
  if (g == 0 && tile < tiles) {
    float* out = partial + (long long)blockIdx.x * C * C;
#pragma unroll
    for (int u = 0; u < kTile; ++u)
#pragma unroll
      for (int v = 0; v < kTile; ++v) {
        float s = 0.f;
        for (int gg = 0; gg < groups; ++gg) s += red[(gg * per_block + slot) * 16 + u * kTile + v];
        if (i0 + u < C && j0 + v < C) out[(i0 + u) * C + j0 + v] = s;
      }
  }
}

// out[o] = sum over chunks of partial[chunk, o]: one warp per entry o, lane l
// summing chunks l, l + 32, ... in order, then a fixed shuffle tree.
__global__ void gw_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out,
                                 int n_chunks, int width) {
  const int o = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (o >= width) return;  // o is the same across a warp
  float s = 0.f;
  for (int c = lane; c < n_chunks; c += 32) s += partial[(long long)c * width + o];
  for (int d = 16; d > 0; d >>= 1) s += __shfl_down_sync(0xffffffffu, s, d);
  if (lane == 0) out[o] = s;
}

// kept equal to mm_smem_bytes() in kernels/conv1x1/conv1x1.py, which checks it
size_t mm_smem_bytes(int C, int block_m, int panel) {
  return sizeof(float) * ((size_t)C * panel + (size_t)block_m * C);
}

// kept equal to gw_smem_bytes() in kernels/conv1x1/conv1x1.py
size_t gw_smem_bytes(int C, int stage_rows) {
  return sizeof(float) * (2 * (size_t)stage_rows * C + (size_t)kThreads * 16);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, w and y).  x, y: (N, C) contiguous;
// w: (C, C), element (i, j) at i*w_si + j*w_sj.  device: the CUDA device of
// every pointer; stream: a cudaStream_t on that device.  Returns the
// cudaError_t of the launch.
int conv1x1_mm(int dtype, const void* x, const void* w, long long w_si, long long w_sj,
               void* y, long long N, int C, int block_m, int panel, int device,
               void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((unsigned)((N + block_m - 1) / block_m), (C + panel - 1) / panel);
  const size_t smem = mm_smem_bytes(C, block_m, panel);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    conv1x1_mm_kernel<float><<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), w_si, w_sj,
        static_cast<float*>(y), N, C, block_m, panel);
  } else if (dtype == 1) {
    using bf = __nv_bfloat16;
    conv1x1_mm_kernel<bf><<<grid, kThreads, smem, s>>>(
        static_cast<const bf*>(x), static_cast<const bf*>(w), w_si, w_sj,
        static_cast<bf*>(y), N, C, block_m, panel);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 = float32, 1 = bfloat16 (x, gy).  x, gy: (N, C) contiguous.
// partial: (n_chunks, C*C) float32 scratch, n_chunks = ceil(N / chunk_rows);
// gw: (C, C) float32.  Returns the cudaError_t of the launches.
int conv1x1_gw(int dtype, const void* x, const void* gy, float* partial, float* gw,
               long long N, int C, long long chunk_rows, int stage_rows, int device,
               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_chunks = (int)((N + chunk_rows - 1) / chunk_rows);
  const int nt = (C + kTile - 1) / kTile;
  const int per_block = nt * nt < kThreads ? nt * nt : kThreads;
  const dim3 grid(n_chunks, (nt * nt + per_block - 1) / per_block);
  const size_t smem = gw_smem_bytes(C, stage_rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    conv1x1_gw_kernel<float><<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(gy), partial, N, C,
        chunk_rows, stage_rows);
  } else if (dtype == 1) {
    using bf = __nv_bfloat16;
    conv1x1_gw_kernel<bf><<<grid, kThreads, smem, s>>>(
        static_cast<const bf*>(x), static_cast<const bf*>(gy), partial, N, C, chunk_rows,
        stage_rows);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int width = C * C;
  const long long reduce_blocks = ((long long)width * 32 + kThreads - 1) / kThreads;
  gw_reduce_kernel<<<(unsigned)reduce_blocks, kThreads, 0, s>>>(partial, gw, n_chunks, width);
  return static_cast<int>(cudaGetLastError());
}

// The stream path: C in {12, 24, 48}, x 16-byte aligned (the caller
// checks); otherwise as conv1x1_mm.  Returns the cudaError_t of the launch.
int conv1x1_mm_stream(int dtype, const void* x, const void* w, long long w_si, long long w_sj,
                      void* y, long long N, int C, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch_stream_c<float>(x, w, w_si, w_sj, y, N, C, device, s));
  if (dtype == 1)
    return static_cast<int>(launch_stream_c<__nv_bfloat16>(x, w, w_si, w_sj, y, N, C, device, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
