// Fused GLOW flow step for Hopper (sm_90a): actnorm -> 1x1 conv -> affine
// coupling, forward and inverse, on the (B, M, C) view.
//
// flowstep_fwd_kernel replaces the Pallas kernel
//   src/repro/kernels/flowstep/flowstep.py::flowstep_fwd (_fwd_kernel)
// flowstep_inv_kernel replaces
//   src/repro/kernels/flowstep/flowstep.py::flowstep_inv (_inv_kernel)
// spine_bwd_kernel (with spine_reduce_kernel) replaces
//   src/repro/kernels/flowstep/flowstep.py::spine_bwd (_spine_bwd_kernel)
//
// What bounds them: memory.  A step reads x (or y), raw and t and writes y
// (or x): with ca = C/2 that is 3*B*M*C elements, 12*B*M*C bytes in f32
// (about 18.9 MB at (8, 16384, 12), about 5.6 us at 3.35 TB/s), against
// 2*C flops per element for the C x C product, about 0.6 us at 67 TFLOP/s
// f32.  So the design moves each byte once: a block stages its tile of rows
// in shared memory, applies the elementwise part there, and does the C x C
// product out of shared memory on the CUDA cores with f32 accumulation (at
// C <= 48 no tensor core is needed).  W (or W^-1) sits in shared memory for
// the block's life; at C <= 48 in f32 that is at most 9 KB.  At the two
// smaller scales of the served model, (8, 4096, 24) and (8, 1024, 48), a step
// moves 9.4 MB and 4.7 MB, 2.8 us and 1.4 us at full bandwidth, so launch
// latency (a few us) will likely dominate there.
//
// Grid: (tiles of block_m rows, B); the kernel masks the ragged last tile
// itself, so any M works.  raw and t may be strided views (the two halves of
// the conditioner output): element (b, m, j) sits at b*h_sb + m*h_sm + j.
//
// The coupling log-determinant ld[b] = sum over (m, j < ca) of log_s is a sum
// across tiles.  The TPU kernel adds into a revisited output block, which is
// right only because the TPU grid runs in order.  Here each block writes its
// tile's partial sum, reduced in a fixed order, into partial[b, tile], and a
// second small kernel sums each row of partial in a fixed order.  No atomics:
// repeated runs are bitwise equal.

#include "common.cuh"

namespace {

// Shared memory: W (C*C) | exp(an_log_s) (C) | an_b (C) | tile (block_m*C) | warp sums
template <typename T>
__global__ void __launch_bounds__(kThreads)
flowstep_fwd_kernel(const T* __restrict__ x, const float* __restrict__ an_ls,
                    const float* __restrict__ an_b, const float* __restrict__ w,
                    const T* __restrict__ raw, const T* __restrict__ t,
                    long long h_sb, long long h_sm, T* __restrict__ y,
                    float* __restrict__ partial, int M, int C, int ca, int block_m,
                    float clamp) {
  extern __shared__ float smem[];
  float* ws = smem;
  float* es = ws + C * C;
  float* bs = es + C;
  float* x1s = bs + C;
  float* warp_buf = x1s + block_m * C;

  const int b = blockIdx.y;
  const int tile = blockIdx.x;
  const long long m0 = (long long)tile * block_m;
  const int rows = min((long long)block_m, (long long)M - m0);
  const int n = rows * C;
  const long long base = ((long long)b * M + m0) * C;

  for (int k = threadIdx.x; k < C * C; k += kThreads) ws[k] = w[k];
  for (int k = threadIdx.x; k < C; k += kThreads) {
    es[k] = expf(an_ls[k]);
    bs[k] = an_b[k];
  }
  __syncthreads();
  // actnorm, tile rows contiguous in memory: coalesced
  for (int k = threadIdx.x; k < n; k += kThreads) {
    const int c = k % C;
    x1s[k] = load_f(x, base + k) * es[c] + bs[c];
  }
  __syncthreads();

  float ld = 0.f;
  for (int k = threadIdx.x; k < n; k += kThreads) {
    const int r = k / C;
    const int j = k - r * C;
    const float* xr = x1s + r * C;
    float acc = 0.f;
    for (int i = 0; i < C; ++i) acc = fmaf(xr[i], ws[i * C + j], acc);
    if (j < ca) {
      const long long hi = (long long)b * h_sb + (m0 + r) * h_sm + j;
      const float ls = clamp * tanhf(load_f(raw, hi) / clamp);
      acc = acc * expf(ls) + load_f(t, hi);
      ld += ls;
    }
    store_f(y, base + k, acc);
  }
  const float s = block_sum(ld, warp_buf);
  if (threadIdx.x == 0) partial[(long long)b * gridDim.x + tile] = s;
}

// Shared memory: W^-1 (C*C) | exp(-an_log_s) (C) | an_b (C) | tile (block_m*C)
template <typename T>
__global__ void __launch_bounds__(kThreads)
flowstep_inv_kernel(const T* __restrict__ y, const float* __restrict__ an_ls,
                    const float* __restrict__ an_b, const float* __restrict__ w_inv,
                    const T* __restrict__ raw, const T* __restrict__ t,
                    long long h_sb, long long h_sm, T* __restrict__ x, int M, int C,
                    int ca, int block_m, float clamp) {
  extern __shared__ float smem[];
  float* ws = smem;
  float* es = ws + C * C;
  float* bs = es + C;
  float* x2s = bs + C;

  const int b = blockIdx.y;
  const long long m0 = (long long)blockIdx.x * block_m;
  const int rows = min((long long)block_m, (long long)M - m0);
  const int n = rows * C;
  const long long base = ((long long)b * M + m0) * C;

  for (int k = threadIdx.x; k < C * C; k += kThreads) ws[k] = w_inv[k];
  for (int k = threadIdx.x; k < C; k += kThreads) {
    es[k] = expf(-an_ls[k]);
    bs[k] = an_b[k];
  }
  // uncouple the first ca channels; the rest pass through
  for (int k = threadIdx.x; k < n; k += kThreads) {
    const int r = k / C;
    const int j = k - r * C;
    float v = load_f(y, base + k);
    if (j < ca) {
      const long long hi = (long long)b * h_sb + (m0 + r) * h_sm + j;
      const float ls = clamp * tanhf(load_f(raw, hi) / clamp);
      v = (v - load_f(t, hi)) * expf(-ls);
    }
    x2s[k] = v;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < n; k += kThreads) {
    const int r = k / C;
    const int j = k - r * C;
    const float* xr = x2s + r * C;
    float acc = 0.f;
    for (int i = 0; i < C; ++i) acc = fmaf(xr[i], ws[i * C + j], acc);
    store_f(x, base + k, (acc - bs[j]) * es[j]);
  }
}

// Reversible backward of actnorm -> 1x1 conv from the conv output side.  Given
// x2 (the conv output) and gx2 (its cotangent):
//   x1 = x2 @ W^-1,  x = (x1 - an_b) * exp(-an_ls)   (both inputs rebuilt)
//   gx1 = gx2 @ W^T, gx = gx1 * exp(an_ls)
//   gW = sum_(b,m) x1^T gx2,  g_b = sum gx1,  g_ls = sum gx1 * (x1 - an_b)
// What bounds it: memory at C = 12 and 24, close to balance at C = 48.  It
// reads x2, gx2 and writes x, gx (16*B*M*C bytes in f32), against 6*C flops
// an element for the three C-long products.  A block stages its tile of x2
// and gx2 in shared memory once, rebuilds x1 there, and writes x and gx in
// the same visit; W and W^-1 stay in shared memory for the block's life.
//
// The three sums run over every (b, m).  The TPU kernel adds into output
// blocks it revisits in grid order; blocks on this card run in no order.  So
// each block writes its tile's sums, taken in a fixed order, to its row of
// partial (n_blocks, C*C + 2*C), and spine_reduce_kernel sums each column
// over the blocks in a fixed order: no atomics, bitwise-repeatable, f32
// whatever the storage type.
//
// Shared memory: W (C*C) | W^-1 (C*C) | exp(an_ls) (C) | exp(-an_ls) (C) | an_b (C) |
//                tile a (block_m*C) | tile g (block_m*C) | tile x1 (block_m*C)
template <typename T>
__global__ void __launch_bounds__(kThreads)
spine_bwd_kernel(const T* __restrict__ x2, const T* __restrict__ gx2,
                 const float* __restrict__ w, const float* __restrict__ w_inv,
                 const float* __restrict__ an_ls, const float* __restrict__ an_b,
                 T* __restrict__ x, T* __restrict__ gx, float* __restrict__ partial, int M,
                 int C, int block_m) {
  extern __shared__ float smem[];
  float* ws = smem;
  float* wis = ws + C * C;
  float* es = wis + C * C;
  float* eis = es + C;
  float* bs = eis + C;
  float* ta = bs + C;              // x2, then gx1
  float* tg = ta + block_m * C;    // gx2
  float* tx1 = tg + block_m * C;   // x1

  const int b = blockIdx.y;
  const long long m0 = (long long)blockIdx.x * block_m;
  const int rows = min((long long)block_m, (long long)M - m0);
  const int n = rows * C;
  const long long base = ((long long)b * M + m0) * C;

  for (int k = threadIdx.x; k < C * C; k += kThreads) {
    ws[k] = w[k];
    wis[k] = w_inv[k];
  }
  for (int k = threadIdx.x; k < C; k += kThreads) {
    es[k] = expf(an_ls[k]);
    eis[k] = expf(-an_ls[k]);
    bs[k] = an_b[k];
  }
  for (int k = threadIdx.x; k < n; k += kThreads) {
    ta[k] = load_f(x2, base + k);
    tg[k] = load_f(gx2, base + k);
  }
  __syncthreads();
  // x1 = x2 @ W^-1 and the rebuilt step input x
  for (int k = threadIdx.x; k < n; k += kThreads) {
    const int r = k / C;
    const int j = k - r * C;
    const float* xr = ta + r * C;
    float acc = 0.f;
    for (int i = 0; i < C; ++i) acc = fmaf(xr[i], wis[i * C + j], acc);
    tx1[k] = acc;
    store_f(x, base + k, (acc - bs[j]) * eis[j]);
  }
  __syncthreads();
  // gx1 = gx2 @ W^T (row j of W), over x2's tile, which is no longer needed
  for (int k = threadIdx.x; k < n; k += kThreads) {
    const int r = k / C;
    const int j = k - r * C;
    const float* gr = tg + r * C;
    const float* wr = ws + j * C;
    float acc = 0.f;
    for (int i = 0; i < C; ++i) acc = fmaf(gr[i], wr[i], acc);
    ta[k] = acc;
    store_f(gx, base + k, acc * es[j]);
  }
  __syncthreads();
  // this tile's sums, each over its rows in order
  float* out = partial + ((long long)b * gridDim.x + blockIdx.x) * (C * C + 2 * C);
  for (int o = threadIdx.x; o < C * C + 2 * C; o += kThreads) {
    float acc = 0.f;
    if (o < C * C) {
      const int i = o / C;
      const int j = o - i * C;
      for (int r = 0; r < rows; ++r) acc = fmaf(tx1[r * C + i], tg[r * C + j], acc);
    } else if (o < C * C + C) {
      const int c = o - C * C;
      for (int r = 0; r < rows; ++r) acc = fmaf(ta[r * C + c], tx1[r * C + c] - bs[c], acc);
    } else {
      const int c = o - C * C - C;
      for (int r = 0; r < rows; ++r) acc += ta[r * C + c];
    }
    out[o] = acc;
  }
}

// out[o] = sum over blocks of partial[blk, o], each column in block order.
__global__ void spine_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out,
                                    int n_blocks, int width) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= width) return;
  float s = 0.f;
  for (int blk = 0; blk < n_blocks; ++blk) s += partial[(long long)blk * width + o];
  out[o] = s;
}

// kept equal to smem_bytes() in kernels/flowstep/flowstep.py, which checks it
size_t smem_bytes(int C, int block_m) {
  return sizeof(float) * ((size_t)C * C + 2 * C + (size_t)block_m * C + kWarps);
}

// kept equal to spine_smem_bytes() in kernels/flowstep/flowstep.py
size_t spine_smem_bytes(int C, int block_m) {
  return sizeof(float) * (2 * (size_t)C * C + 3 * C + 3 * (size_t)block_m * C);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, raw, t, y).  an_ls, an_b, w: float32.
// partial: (B, ceil(M / block_m)) float32 scratch; ld: (B,) float32.
// device: the CUDA device of every pointer (this library's runtime keeps its
// own current device); stream: a cudaStream_t on that device.
// Returns the cudaError_t of the launches (0 on success).
int flowstep_fwd(int dtype, const void* x, const float* an_ls, const float* an_b,
                 const float* w, const void* raw, const void* t, long long h_sb,
                 long long h_sm, void* y, float* partial, float* ld, int B, int M,
                 int C, int ca, int block_m, float clamp, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (M + block_m - 1) / block_m;
  const dim3 grid(n_tiles, B);
  const size_t smem = smem_bytes(C, block_m);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    flowstep_fwd_kernel<float><<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(x), an_ls, an_b, w, static_cast<const float*>(raw),
        static_cast<const float*>(t), h_sb, h_sm, static_cast<float*>(y), partial, M, C,
        ca, block_m, clamp);
  } else if (dtype == 1) {
    flowstep_fwd_kernel<__nv_bfloat16><<<grid, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), an_ls, an_b, w,
        static_cast<const __nv_bfloat16*>(raw), static_cast<const __nv_bfloat16*>(t), h_sb,
        h_sm, static_cast<__nv_bfloat16*>(y), partial, M, C, ca, block_m, clamp);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ld_reduce_kernel<<<B, 32, 0, s>>>(partial, ld, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

int flowstep_inv(int dtype, const void* y, const float* an_ls, const float* an_b,
                 const float* w_inv, const void* raw, const void* t, long long h_sb,
                 long long h_sm, void* x, int B, int M, int C, int ca, int block_m,
                 float clamp, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((M + block_m - 1) / block_m, B);
  const size_t smem = smem_bytes(C, block_m);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    flowstep_inv_kernel<float><<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(y), an_ls, an_b, w_inv, static_cast<const float*>(raw),
        static_cast<const float*>(t), h_sb, h_sm, static_cast<float*>(x), M, C, ca,
        block_m, clamp);
  } else if (dtype == 1) {
    flowstep_inv_kernel<__nv_bfloat16><<<grid, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(y), an_ls, an_b, w_inv,
        static_cast<const __nv_bfloat16*>(raw), static_cast<const __nv_bfloat16*>(t), h_sb,
        h_sm, static_cast<__nv_bfloat16*>(x), M, C, ca, block_m, clamp);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// x2, gx2 -> x, gx: (B, M, C) of dtype (0 = float32, 1 = bfloat16); w, w_inv:
// (C, C), an_ls, an_b: (C,), all float32.  partial: (B * ceil(M / block_m),
// C*C + 2*C) float32 scratch; sums: (C*C + 2*C,) float32, laid out gW (C, C)
// | g_ls (C) | g_b (C).  Returns the cudaError_t of the launches.
int spine_bwd(int dtype, const void* x2, const void* gx2, const float* w, const float* w_inv,
              const float* an_ls, const float* an_b, void* x, void* gx, float* partial,
              float* sums, int B, int M, int C, int block_m, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (M + block_m - 1) / block_m;
  const dim3 grid(n_tiles, B);
  const size_t smem = spine_smem_bytes(C, block_m);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    spine_bwd_kernel<float><<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(x2), static_cast<const float*>(gx2), w, w_inv, an_ls, an_b,
        static_cast<float*>(x), static_cast<float*>(gx), partial, M, C, block_m);
  } else if (dtype == 1) {
    using bf = __nv_bfloat16;
    spine_bwd_kernel<bf><<<grid, kThreads, smem, s>>>(
        static_cast<const bf*>(x2), static_cast<const bf*>(gx2), w, w_inv, an_ls, an_b,
        static_cast<bf*>(x), static_cast<bf*>(gx), partial, M, C, block_m);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int width = C * C + 2 * C;
  spine_reduce_kernel<<<(width + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      partial, sums, n_tiles * B, width);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
