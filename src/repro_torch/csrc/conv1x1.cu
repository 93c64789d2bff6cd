// Invertible 1x1 convolution for Hopper (sm_90a): the channel-mixing product
// and its weight cotangent, on the (N = B*M, C) rows of a (B, M, C) tensor.
//
// conv1x1_mm_kernel replaces the Pallas kernel
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
// conv1x1_mm: a block stages block_m rows of x and a column panel of W (the
// whole of W up to C = 90) in shared memory, as flowstep_fwd does, then each
// thread forms outputs of the tile from shared memory.  Wider C is cut into
// column panels (grid.y) so a block never needs more than 48 KB: C = 192 in
// f32 (147 KB of W) takes five panels of 42 columns.  W is read through its
// strides, so W^T (the backward's gx = gy @ W^T) needs no copy.  The last
// tile of rows is masked, so any M works.
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

}  // extern "C"
