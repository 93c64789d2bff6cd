// Fused affine-coupling backward for Hopper (sm_90a), on the (B, M, ca) view
// of the transformed half.
//
// coupling_bwd_kernel replaces the Pallas kernel
//   src/repro/kernels/coupling/coupling.py::coupling_bwd (_bwd_kernel)
//
// From the output side, per element (b, m, j < ca):
//   th   = tanh(raw / clamp),  log_s = clamp * th
//   x    = (y - t) * exp(-log_s)                     (reconstructed input)
//   gx   = gy * exp(log_s)
//   gt   = gy
//   graw = (gy * x * exp(log_s) + gld[b]) * (1 - th^2)
//
// What bounds it: memory.  It reads y, raw, t, gy and writes x, gx, graw, gt:
// 8 values an element, 32 bytes in f32 (25.2 MB at (8, 16384, 6), 7.5 us at
// 3.35 TB/s), against some 10 flops and two transcendentals an element.  So
// the design is one pass, one element a thread, nothing staged: every value
// is read once and written once, with f32 arithmetic whatever the storage
// type.
//
// Layout: y and gy are the first ca channels of (B, M, C) tensors and raw/t
// the two halves of one conditioner output, so all four are strided views:
// element (b, m, j) of y sits at b*y_sb + m*y_sm + j (likewise gy with its
// strides, raw and t with the shared h_sb, h_sm).  Nothing is copied to make
// them contiguous.  The outputs are contiguous (B, M, ca).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load_f(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16(v);
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
  // enough blocks to fill the card several times over; the loop takes the rest
  const long long want = (n + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 132LL * 32 ? want : 132LL * 32);
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
