// Mamba2 chunked SSD scan for Hopper (sm_90a).
//
// ssd_scan_kernel replaces the Pallas kernel
//   src/repro/kernels/ssd/ssd.py::ssd_scan (_ssd_kernel)
//
// For each chunk of c time steps (cum = cumsum(da) over the chunk):
//   y     = (C state^T) * exp(cum) + ((C B^T) * decay) @ (x * dt),
//           decay[t][s] = exp(cum_t - cum_s) where t >= s, else 0
//   state <- state * exp(cum_end) + sum_s exp(cum_end - cum_s) (x dt)_s (x) B_s
//
// x (B, H, S, P) f32 or bf16, and b_in, c_in (B, S, N) of the same type (one
// group, shared by the heads); da, dt (B, H, S) f32; any strides over the
// leading axes with the last axis of x, b_in and c_in contiguous.  y comes
// back in x's type with its own strides, the final state (B, H, P, N) in f32,
// contiguous; state0 (B, H, P, N) f32 or null (zeros, the TPU kernel's case).
// P, N <= 64; the chunk divides S (the caller checks, as the TPU kernel
// asserts).
//
// What bounds it: operations.  Per (batch, head, chunk) the four products
// (C state^T, C B^T, G (x dt), the state update) count 2 c N P + 2 c^2 N +
// 2 c^2 P + 2 c N P operations: at zamba2-7b's prefill, (8, 112, 2048, 64),
// N 64, chunk 256, 21.0 MFLOP, 150 GFLOP in all against 0.97 GB of x,
// y, da, dt, B, C and the state: 2.24 ms at the card's f32 rate (0.29 ms at
// its bytes rate).  The reference computes in f32 and holds its kernel to
// 2e-4, which leaves no room for TF32's 10-bit mantissa over N = 64 terms,
// so this kernel runs every product as f32 FMAs on the CUDA cores.
//
// Design.  One block of 256 threads per (head, batch) walks the chunks in
// order with the (P, N) state resident in shared memory (transposed, N x P).
// Per chunk: cum is a block scan of da (warp shuffles plus a fixed-order
// carry).  The chunk is cut into 64-row tiles; each 64 x 64 product runs as
// 4 x 4 register tiles per thread over float4 reads of transposed shared
// tiles.  For each output tile of 64 time steps: the carried-state term
// C state^T scaled by exp(cum); then for every source tile at or below the
// diagonal, G = C B^T, the decay applied only where t >= s (never
// exp(positive) * 0, which could be inf * 0 = NaN), G^T to shared memory,
// and y += G (x dt).  Tiles above the diagonal are skipped, so the (c, c)
// matrix (256 KB at c = 256) never exists.  Then the state update, a sum over
// the chunk's source tiles.  C B^T is recomputed for every head, as the TPU
// kernel does (B and C have one group).  Padded rows and columns are zero, so
// P, N < 64 and any chunk length work.  No atomics: bitwise repeatable.

#include "common.cuh"

namespace {

constexpr int kL = 64;       // rows of a tile; P and N are at most kL
constexpr int kLD = kL + 4;  // row stride of the shared tiles (float4-aligned)
constexpr int kTile = kL * kLD;

size_t ssd_smem_bytes(int chunk) {
  // ct | bt | xs | gt | st, each (kL, kLD), then cum (chunk) and the scan's
  // per-warp totals
  return sizeof(float) * ((size_t)5 * kTile + chunk + kWarps);
}

// acc[i][j] += sum_{q < kk} a[q][ty*4 + i] * b[q][tx*4 + j] over two (kL, kLD)
// tiles stored with the reduction axis first.
__device__ __forceinline__ void mma_tile(float (&acc)[4][4], const float* __restrict__ a,
                                         const float* __restrict__ b, int kk, int ty, int tx) {
  for (int q = 0; q < kk; ++q) {
    const float4 av = *reinterpret_cast<const float4*>(a + q * kLD + ty * 4);
    const float4 bv = *reinterpret_cast<const float4*>(b + q * kLD + tx * 4);
    const float ar[4] = {av.x, av.y, av.z, av.w}, br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
  }
}

// cum[i] = da[0] + ... + da[i] for i < c: a block scan, 256 steps at a time,
// each a warp scan by shuffles plus the warps' totals in a fixed order.
__device__ void chunk_cumsum(const float* __restrict__ da, long long stride, int c,
                             float* __restrict__ cum, float* __restrict__ warp_buf) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float carry = 0.f;
  for (int base = 0; base < c; base += kThreads) {
    const int i = base + tid;
    float v = i < c ? da[i * stride] : 0.f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += up;
    }
    if (lane == 31) warp_buf[warp] = v;
    __syncthreads();
    float pre = carry;
    for (int q = 0; q < warp; ++q) pre += warp_buf[q];
    if (i < c) cum[i] = pre + v;
    for (int q = 0; q < kWarps; ++q) carry += warp_buf[q];
    __syncthreads();  // warp_buf is rewritten by the next pass
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ da,
                const float* __restrict__ dt, const T* __restrict__ bm,
                const T* __restrict__ cm, const float* __restrict__ state0, T* __restrict__ y,
                float* __restrict__ state, int H, int S, int P, int N, int chunk,
                long long x_sb, long long x_sh, long long x_ss, long long da_sb,
                long long da_sh, long long da_ss, long long dt_sb, long long dt_sh,
                long long dt_ss, long long b_sb, long long b_ss, long long c_sb, long long c_ss,
                long long y_sb, long long y_sh, long long y_ss) {
  extern __shared__ __align__(16) float smem[];
  float* ct = smem;        // ct[n * kLD + t] = C[t][n]
  float* bt = ct + kTile;  // bt[n * kLD + s] = B[s][n]; in the state update bt[s * kLD + n]
  float* xs = bt + kTile;  // xs[s * kLD + p] = x[s][p] dt[s] (times exp(cum_end - cum_s) later)
  float* gt = xs + kTile;  // gt[s * kLD + t] = G[t][s] decay[t][s]
  float* st = gt + kTile;  // st[n * kLD + p] = state[p][n]
  float* cum = st + kTile;
  float* warp_buf = cum + chunk;

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // output columns tx*4..+3
  const int ty = tid >> 4;  // output rows ty*4..+3
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const T* xb = x + b * x_sb + h * x_sh;
  const float* dab = da + b * da_sb + h * da_sh;
  const float* dtb = dt + b * dt_sb + h * dt_sh;
  const T* bb = bm + b * b_sb;
  const T* cb = cm + b * c_sb;
  T* yb = y + b * y_sb + h * y_sh;
  const long long st_base = ((long long)b * H + h) * P * N;

  for (int i = tid; i < kL * kL; i += kThreads) {
    const int n = i / kL, p = i - n * kL;
    st[n * kLD + p] = state0 != nullptr && n < N && p < P ? state0[st_base + p * N + n] : 0.f;
  }

  for (int t0 = 0; t0 < S; t0 += chunk) {
    chunk_cumsum(dab + t0 * da_ss, da_ss, chunk, cum, warp_buf);  // ends in a barrier
    const float cum_end = cum[chunk - 1];

    for (int r0 = 0; r0 < chunk; r0 += kL) {
      const int nr = min(kL, chunk - r0);
      __syncthreads();  // ct, bt, xs, gt are no longer read
      for (int i = tid; i < kL * kL; i += kThreads) {
        const int t = i / kL, n = i - t * kL;
        ct[n * kLD + t] = t < nr && n < N ? load_f(cb, (t0 + r0 + t) * c_ss + n) : 0.f;
      }
      __syncthreads();

      float acc[4][4] = {};
      mma_tile(acc, ct, st, N, ty, tx);  // the carried state: sum_n C[t][n] state[p][n]
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty * 4 + i;
        const float e = t < nr ? expf(cum[r0 + t]) : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= e;
      }

      for (int s0 = 0; s0 <= r0; s0 += kL) {
        const int ns = min(kL, chunk - s0);
        __syncthreads();  // bt, xs, gt of the previous source tile are no longer read
        for (int i = tid; i < kL * kL; i += kThreads) {
          const int s = i / kL, q = i - s * kL;
          const bool row = s < ns;
          bt[q * kLD + s] = row && q < N ? load_f(bb, (t0 + s0 + s) * b_ss + q) : 0.f;
          xs[s * kLD + q] = row && q < P
              ? load_f(xb, (t0 + s0 + s) * x_ss + q) * dtb[(t0 + s0 + s) * dt_ss] : 0.f;
        }
        __syncthreads();

        float g[4][4] = {};
        mma_tile(g, ct, bt, N, ty, tx);  // G[t][s] = sum_n C[t][n] B[s][n]
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = r0 + ty * 4 + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = s0 + tx * 4 + j;
            // the decay only where t >= s: exp(cum_t - cum_s) may overflow above
            g[i][j] = t < chunk && s < chunk && t >= s ? g[i][j] * expf(cum[t] - cum[s]) : 0.f;
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<float4*>(gt + (tx * 4 + j) * kLD + ty * 4) =
              make_float4(g[0][j], g[1][j], g[2][j], g[3][j]);
        __syncthreads();

        mma_tile(acc, gt, xs, ns, ty, tx);  // y[t][p] += sum_s G[t][s] (x dt)[s][p]
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty * 4 + i;
        if (t >= nr) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx * 4 + j;
          if (p < P) store_f(yb, (t0 + r0 + t) * y_ss + p, acc[i][j]);
        }
      }
    }

    // the state update: state[p][n] = state[p][n] exp(cum_end)
    //   + sum_s B[s][n] (x dt)[s][p] exp(cum_end - cum_s); rows n, columns p
    const float decay_end = expf(cum_end);
    float sacc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sacc[i][j] = st[(ty * 4 + i) * kLD + tx * 4 + j] * decay_end;
    for (int s0 = 0; s0 < chunk; s0 += kL) {
      const int ns = min(kL, chunk - s0);
      __syncthreads();  // bt and xs are no longer read
      for (int i = tid; i < kL * kL; i += kThreads) {
        const int s = i / kL, q = i - s * kL;
        const bool row = s < ns;
        bt[s * kLD + q] = row && q < N ? load_f(bb, (t0 + s0 + s) * b_ss + q) : 0.f;
        xs[s * kLD + q] = row && q < P
            ? load_f(xb, (t0 + s0 + s) * x_ss + q) * dtb[(t0 + s0 + s) * dt_ss] *
                  expf(cum_end - cum[s0 + s])
            : 0.f;
      }
      __syncthreads();
      mma_tile(sacc, bt, xs, ns, ty, tx);
    }
    __syncthreads();  // every read of st for this chunk is done
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[(ty * 4 + i) * kLD + tx * 4 + j] = sacc[i][j];
    // the next chunk's scan begins with a barrier before any read of st
  }

  __syncthreads();
  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N, n = i - p * N;
    state[st_base + i] = st[n * kLD + p];
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* da, const float* dt, const void* bm,
                   const void* cm, const float* state0, void* y, float* state, int B, int H,
                   int S, int P, int N, int chunk, const long long* st, cudaStream_t s) {
  const size_t smem = ssd_smem_bytes(chunk);
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B);
  ssd_scan_kernel<T><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(x), da, dt, static_cast<const T*>(bm), static_cast<const T*>(cm),
      state0, static_cast<T*>(y), state, H, S, P, N, chunk, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], st[9], st[10], st[11], st[12], st[13], st[14], st[15]);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, b_in, c_in and y).  strides: 16
// element strides: x (batch, head, time), da (batch, head, time), dt (batch,
// head, time), b_in (batch, time), c_in (batch, time), y (batch, head, time);
// the last axis of x, b_in, c_in and y is contiguous.  state0 may be null
// (zeros).  Needs 1 <= P, N <= 64, S % chunk == 0 and chunk <= 4096 (the
// caller checks).  Returns the cudaError_t of the launch.
int ssd_scan(int dtype, const void* x, const float* da, const float* dt, const void* b_in,
             const void* c_in, const float* state0, void* y, float* state, int B, int H, int S,
             int P, int N, int chunk, const long long* strides, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    err = launch<float>(x, da, dt, b_in, c_in, state0, y, state, B, H, S, P, N, chunk, strides, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(x, da, dt, b_in, c_in, state0, y, state, B, H, S, P, N, chunk,
                                strides, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

}  // extern "C"
