// RWKV6 wkv recurrence for Hopper (sm_90a).
//
// wkv_scan_kernel replaces the Pallas kernel
//   src/repro/kernels/rwkv/rwkv.py::wkv_scan (_wkv_kernel)
//
//   y_t[j] = sum_i r_t[i] (S[i][j] + u[i] k_t[i] v_t[j]);   S[i][j] <- w_t[i] S[i][j] + k_t[i] v_t[j]
//
// r, k, v, w (B, H, S, K), f32 or bf16 (one type), any strides over (b, h, s)
// with the K axis contiguous; u (H, K) f32; state0 (B, H, K, K) f32 or null
// (zeros, the TPU kernel's case); y (B, H, S, K) f32 with its own strides;
// the final state (B, H, K, K) f32, contiguous.  K is 16, 32 or 64.
//
// What bounds it: operations.  Each (token, head) takes about 7 K^2 f32
// operations (the products r (S + u k v) and the rank-1 update of S): at
// rwkv6-7b's prefill, (8, 64, 2048, 64), 30.1 GFLOP against 1.35 GB of r, k,
// v, w and y, 0.45 ms at the card's f32 rate and 0.40 ms at its bytes rate.
// The recurrence is sequential in time; the parallelism is B * H blocks and
// K columns.
//
// Design.  One block of K threads per (head, batch), walking time in order.
// Thread j owns column j of the (K, K) state in registers for the whole
// sequence, so y_t[j] and the update of S[:, j] need no exchange between
// threads.  Time is staged kT steps at a time: r, k, u*k, w and v of the
// steps go to shared memory (widened to f32 on load), and each thread reads
// the i-indexed values as float4 broadcasts.  Any S works (the last stage is
// partial); there is no S % chunk rule.  The sum over i for y keeps four
// partial sums in a fixed order.  No atomics: every result is bitwise
// repeatable.

#include "common.cuh"

namespace {

constexpr int kT = 32;  // time steps staged per pass

template <typename T, int K>
__global__ void __launch_bounds__(K)
wkv_scan_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ w, const float* __restrict__ u,
                const float* __restrict__ state0, float* __restrict__ y,
                float* __restrict__ state, int H, int S, long long r_sb, long long r_sh,
                long long r_ss, long long k_sb, long long k_sh, long long k_ss, long long v_sb,
                long long v_sh, long long v_ss, long long w_sb, long long w_sh, long long w_ss,
                long long y_sb, long long y_sh, long long y_ss) {
  __shared__ __align__(16) float rs[kT * K];
  __shared__ __align__(16) float ks[kT * K];
  __shared__ __align__(16) float uks[kT * K];
  __shared__ __align__(16) float ws[kT * K];
  __shared__ __align__(16) float vs[kT * K];

  const int j = threadIdx.x;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const T* rb = r + b * r_sb + h * r_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  const T* wb = w + b * w_sb + h * w_sh;
  float* yb = y + b * y_sb + h * y_sh;
  const long long st_base = ((long long)b * H + h) * K * K;
  const float uj = u[h * K + j];

  float st[K];  // st[i] = S[i][j]
#pragma unroll
  for (int i = 0; i < K; ++i) st[i] = state0 != nullptr ? state0[st_base + i * K + j] : 0.f;

  for (int t0 = 0; t0 < S; t0 += kT) {
    const int n = min(kT, S - t0);
    __syncthreads();  // the previous stage is no longer read
#pragma unroll 8
    for (int tt = 0; tt < n; ++tt) {
      const long long t = t0 + tt;
      const float kv = load_f(kb, t * k_ss + j);
      rs[tt * K + j] = load_f(rb, t * r_ss + j);
      ks[tt * K + j] = kv;
      uks[tt * K + j] = uj * kv;
      ws[tt * K + j] = load_f(wb, t * w_ss + j);
      vs[tt * K + j] = load_f(vb, t * v_ss + j);
    }
    __syncthreads();

    for (int tt = 0; tt < n; ++tt) {
      const float vj = vs[tt * K + j];
      const float* rt = rs + tt * K;
      const float* kt = ks + tt * K;
      const float* ukt = uks + tt * K;
      const float* wt = ws + tt * K;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < K; i += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(rt + i);
        const float4 k4 = *reinterpret_cast<const float4*>(kt + i);
        const float4 uk4 = *reinterpret_cast<const float4*>(ukt + i);
        const float4 w4 = *reinterpret_cast<const float4*>(wt + i);
        const float rv[4] = {r4.x, r4.y, r4.z, r4.w}, kv[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ukv[4] = {uk4.x, uk4.y, uk4.z, uk4.w}, wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[q] = fmaf(rv[q], fmaf(ukv[q], vj, st[i + q]), acc[q]);
          st[i + q] = fmaf(wv[q], st[i + q], kv[q] * vj);
        }
      }
      yb[(t0 + tt) * y_ss + j] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    }
  }

#pragma unroll
  for (int i = 0; i < K; ++i) state[st_base + i * K + j] = st[i];
}

template <typename T, int K>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w, const float* u,
                   const float* state0, float* y, float* state, int B, int H, int S,
                   const long long* st, cudaStream_t s) {
  const dim3 grid(H, B);
  wkv_scan_kernel<T, K><<<grid, K, 0, s>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(w), u, state0, y, state, H, S, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], st[9], st[10], st[11], st[12], st[13], st[14]);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_k(const void* r, const void* k, const void* v, const void* w, const float* u,
                     const float* state0, float* y, float* state, int B, int H, int S, int K,
                     const long long* st, cudaStream_t s) {
  switch (K) {
    case 16: return launch<T, 16>(r, k, v, w, u, state0, y, state, B, H, S, st, s);
    case 32: return launch<T, 32>(r, k, v, w, u, state0, y, state, B, H, S, st, s);
    case 64: return launch<T, 64>(r, k, v, w, u, state0, y, state, B, H, S, st, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (r, k, v, w).  strides: 15 element
// strides, (batch, head, time) of r, k, v, w, y in that order; the K axis of
// each is contiguous.  state0 may be null (zeros).  Needs K in {16, 32, 64}
// and S >= 1 (the caller checks).  Returns the cudaError_t of the launch.
int wkv_scan(int dtype, const void* r, const void* k, const void* v, const void* w,
             const float* u, const float* state0, float* y, float* state, int B, int H, int S,
             int K, const long long* strides, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    err = launch_k<float>(r, k, v, w, u, state0, y, state, B, H, S, K, strides, s);
  } else if (dtype == 1) {
    err = launch_k<__nv_bfloat16>(r, k, v, w, u, state0, y, state, B, H, S, K, strides, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

}  // extern "C"
