// Fused affine coupling for Hopper (sm_90a), on the (B, M, ca) view of the
// transformed half: forward, inverse and the backward from the output side.
//
// coupling_fwd_kernel (with ld_reduce_kernel) replaces the Pallas kernel
//   src/repro/kernels/coupling/coupling.py::coupling_fwd (_fwd_kernel)
// coupling_inv_kernel replaces
//   src/repro/kernels/coupling/coupling.py::coupling_inv (_inv_kernel)
// coupling_bwd_kernel replaces
//   src/repro/kernels/coupling/coupling.py::coupling_bwd (_bwd_kernel)
//
// Per element (b, m, j < ca), with th = tanh(raw / clamp), log_s = clamp * th:
//   forward   y = x * exp(log_s) + t,   ld[b] = sum over (m, j) of log_s
//   inverse   x = (y - t) * exp(-log_s)
//   backward  x    = (y - t) * exp(-log_s)            (reconstructed input)
//             gx   = gy * exp(log_s)
//             gt   = gy
//             graw = (gy * x * exp(log_s) + gld[b]) * (1 - th^2)
//
// What bounds them: memory.  The forward and the inverse read three values
// and write one an element: 16 bytes in f32 (12.6 MB at (8, 16384, 6), 3.76
// us at 3.35 TB/s).  The backward reads y, raw, t, gy and writes x, gx, graw,
// gt: 32 bytes in f32 (7.5 us).  Each does some 10 flops and one or two
// transcendentals an element.  So the design is one pass, one element a
// thread, nothing staged: every value is read once and written once, with f32
// arithmetic whatever the storage type.
//
// The forward's logdet ld[b] is a sum across blocks.  The TPU kernel adds
// into an output block it revisits in grid order; blocks here run in no
// order.  So a forward block owns a fixed range of tile_elems elements of
// one batch row, sums its log_s in a fixed order into partial[b, tile], and
// ld_reduce_kernel sums each row of partial in a fixed order.  No atomics:
// repeated runs are bitwise equal.
//
// Layout: x (or y, gy) is the first ca channels of a (B, M, C) tensor and
// raw/t the two halves of one conditioner output, so all of them are strided
// views: element (b, m, j) of x sits at b*x_sb + m*x_sm + j (raw and t share
// h_sb, h_sm).  Nothing is copied to make them contiguous.  The outputs are
// contiguous (B, M, ca).

#include "common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(kThreads)
coupling_fwd_kernel(const T* __restrict__ x, long long x_sb, long long x_sm,
                    const T* __restrict__ raw, const T* __restrict__ t, long long h_sb,
                    long long h_sm, T* __restrict__ y, float* __restrict__ partial, int M,
                    int ca, int tile_elems, float clamp) {
  __shared__ float warp_buf[kWarps];
  const long long b = blockIdx.y;
  const long long per_b = (long long)M * ca;
  const long long e0 = (long long)blockIdx.x * tile_elems;
  const long long e1 = min(e0 + tile_elems, per_b);
  float ld = 0.f;
  for (long long e = e0 + threadIdx.x; e < e1; e += kThreads) {
    const long long m = e / ca;
    const int j = (int)(e - m * ca);
    const long long hi = b * h_sb + m * h_sm + j;
    const float ls = clamp * tanhf(load_f(raw, hi) / clamp);
    store_f(y, b * per_b + e, load_f(x, b * x_sb + m * x_sm + j) * expf(ls) + load_f(t, hi));
    ld += ls;
  }
  const float s = block_sum(ld, warp_buf);
  if (threadIdx.x == 0) partial[b * gridDim.x + blockIdx.x] = s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
coupling_inv_kernel(const T* __restrict__ y, long long y_sb, long long y_sm,
                    const T* __restrict__ raw, const T* __restrict__ t, long long h_sb,
                    long long h_sm, T* __restrict__ x, int M, int ca, long long n,
                    float clamp) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x; e < n; e += stride) {
    const long long row = e / ca;  // b * M + m
    const int j = (int)(e - row * ca);
    const long long b = row / M;
    const long long m = row - b * M;
    const long long hi = b * h_sb + m * h_sm + j;
    const float ls = clamp * tanhf(load_f(raw, hi) / clamp);
    store_f(x, e, (load_f(y, b * y_sb + m * y_sm + j) - load_f(t, hi)) * expf(-ls));
  }
}

// enough blocks of a grid-stride loop over n elements to fill the card
// several times over; the loop takes the rest
int stride_blocks(long long n) {
  const long long want = (n + kThreads - 1) / kThreads;
  return (int)(want < 132LL * 32 ? want : 132LL * 32);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
coupling_bwd_kernel(const T* __restrict__ y, long long y_sb, long long y_sm,
                    const T* __restrict__ raw, const T* __restrict__ t, long long h_sb,
                    long long h_sm, const T* __restrict__ gy, long long g_sb, long long g_sm,
                    const float* __restrict__ gld, T* __restrict__ x, T* __restrict__ gx,
                    T* __restrict__ graw, T* __restrict__ gt, int M, int ca, long long n,
                    float clamp) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x; e < n; e += stride) {
    const long long row = e / ca;  // b * M + m
    const int j = (int)(e - row * ca);
    const long long b = row / M;
    const long long m = row - b * M;
    const long long hi = b * h_sb + m * h_sm + j;
    const float th = tanhf(load_f(raw, hi) / clamp);
    const float ls = clamp * th;
    const float es = expf(ls);
    const float g = load_f(gy, b * g_sb + m * g_sm + j);
    const float xv = (load_f(y, b * y_sb + m * y_sm + j) - load_f(t, hi)) * expf(-ls);
    store_f(x, e, xv);
    store_f(gx, e, g * es);
    store_f(graw, e, (g * xv * es + gld[b]) * (1.f - th * th));
    store_f(gt, e, g);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, raw, t, y).  partial: (B, n_tiles)
// float32 scratch with n_tiles = ceil(M * ca / tile_elems); ld: (B,) float32.
// device: the CUDA device of every pointer; stream: a cudaStream_t on that
// device.  Returns the cudaError_t of the launches.
int coupling_fwd(int dtype, const void* x, long long x_sb, long long x_sm, const void* raw,
                 const void* t, long long h_sb, long long h_sm, void* y, float* partial,
                 float* ld, int B, int M, int ca, int tile_elems, float clamp, int device,
                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long per_b = (long long)M * ca;
  const int n_tiles = (int)((per_b + tile_elems - 1) / tile_elems);
  const dim3 grid(n_tiles, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    coupling_fwd_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), x_sb, x_sm, static_cast<const float*>(raw),
        static_cast<const float*>(t), h_sb, h_sm, static_cast<float*>(y), partial, M, ca,
        tile_elems, clamp);
  } else if (dtype == 1) {
    using bf = __nv_bfloat16;
    coupling_fwd_kernel<bf><<<grid, kThreads, 0, s>>>(
        static_cast<const bf*>(x), x_sb, x_sm, static_cast<const bf*>(raw),
        static_cast<const bf*>(t), h_sb, h_sm, static_cast<bf*>(y), partial, M, ca,
        tile_elems, clamp);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ld_reduce_kernel<<<B, 32, 0, s>>>(partial, ld, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

// dtype as coupling_fwd (y, raw, t, x).  Returns the cudaError_t of the launch.
int coupling_inv(int dtype, const void* y, long long y_sb, long long y_sm, const void* raw,
                 const void* t, long long h_sb, long long h_sm, void* x, int B, int M, int ca,
                 float clamp, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = (long long)B * M * ca;
  if (n == 0) return 0;
  const int blocks = stride_blocks(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    coupling_inv_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(y), y_sb, y_sm, static_cast<const float*>(raw),
        static_cast<const float*>(t), h_sb, h_sm, static_cast<float*>(x), M, ca, n, clamp);
  } else if (dtype == 1) {
    using bf = __nv_bfloat16;
    coupling_inv_kernel<bf><<<blocks, kThreads, 0, s>>>(
        static_cast<const bf*>(y), y_sb, y_sm, static_cast<const bf*>(raw),
        static_cast<const bf*>(t), h_sb, h_sm, static_cast<bf*>(x), M, ca, n, clamp);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 = float32, 1 = bfloat16 (y, raw, t, gy and the four outputs).
// gld: (B,) float32.  device: the CUDA device of every pointer; stream: a
// cudaStream_t on that device.  Returns the cudaError_t of the launch.
int coupling_bwd(int dtype, const void* y, long long y_sb, long long y_sm, const void* raw,
                 const void* t, long long h_sb, long long h_sm, const void* gy,
                 long long g_sb, long long g_sm, const float* gld, void* x, void* gx,
                 void* graw, void* gt, int B, int M, int ca, float clamp, int device,
                 void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = (long long)B * M * ca;
  if (n == 0) return 0;
  const int blocks = stride_blocks(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    coupling_bwd_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(y), y_sb, y_sm, static_cast<const float*>(raw),
        static_cast<const float*>(t), h_sb, h_sm, static_cast<const float*>(gy), g_sb, g_sm,
        gld, static_cast<float*>(x), static_cast<float*>(gx), static_cast<float*>(graw),
        static_cast<float*>(gt), M, ca, n, clamp);
  } else if (dtype == 1) {
    using bf = __nv_bfloat16;
    coupling_bwd_kernel<bf><<<blocks, kThreads, 0, s>>>(
        static_cast<const bf*>(y), y_sb, y_sm, static_cast<const bf*>(raw),
        static_cast<const bf*>(t), h_sb, h_sm, static_cast<const bf*>(gy), g_sb, g_sm, gld,
        static_cast<bf*>(x), static_cast<bf*>(gx), static_cast<bf*>(graw),
        static_cast<bf*>(gt), M, ca, n, clamp);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
