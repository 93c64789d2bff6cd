// Fused GLOW flow step for Hopper (sm_90a): actnorm -> 1x1 conv -> affine
// coupling, forward and inverse, on the (B, M, C) view.
//
// flowstep_fwd_stream_kernel (C = 12, 24, 48, with ld_reduce_kernel) and
// flowstep_fwd_kernel (other widths and layouts, with ld_reduce_kernel)
// replace the Pallas kernel
//   src/repro/kernels/flowstep/flowstep.py::flowstep_fwd (_fwd_kernel)
// flowstep_inv_stream_kernel (C = 12, 24, 48) and flowstep_inv_kernel (other
// widths and layouts) replace
//   src/repro/kernels/flowstep/flowstep.py::flowstep_inv (_inv_kernel)
// spine_bwd_kernel (with reduce_partials_kernel) replaces
//   src/repro/kernels/flowstep/flowstep.py::spine_bwd (_spine_bwd_kernel)
//
// What bounds the forward and inverse: memory.  A step reads x (or y), raw
// and t and writes y (or x): with ca = C/2 that is 3*B*M*C elements,
// 12*B*M*C bytes in f32 (about 18.9 MB at (8, 16384, 12), about 5.6 us at
// 3.35 TB/s), against 2*C flops per element for the C x C product, about
// 0.6 us at 67 TFLOP/s f32.  So each byte moves once, and the C x C product
// runs out of shared memory on the CUDA cores with f32 accumulation (at
// C <= 48 no tensor core is needed).  At the two smaller scales of the
// served model, (8, 4096, 24) and (8, 1024, 48), a step moves 9.4 MB and
// 4.7 MB, 2.8 us and 1.4 us at full bandwidth, so a call's fixed costs
// (launch, the first loads' latency) weigh as much as its bytes.
//
// At the GLOW widths C = 12, 24, 48 (flowstep_{fwd,inv}_stream_kernel, C a
// template parameter; flowstep_path() in kernels/flowstep/flowstep.py picks
// them when raw and t are the two halves of one contiguous (B, M, C)
// conditioner output h and x, h and each batch's rows are 16-byte aligned):
// a persistent, vectorised stream in the shape of conv1x1_mm's (conv1x1.cu),
// with its lane layout but at C = 24 (FLOW_PLAN in
// kernels/flowstep/flowstep.py; the fastest of tools/flow_plan_sweep.py).
// The grid is sized from the occupancy (every SM full, no more blocks than
// tiles); each block stages W (or W^-1, read through its strides) and an_b
// in shared memory once, as f32, by 4-byte cp.async copies in a group of
// their own, and exp(+-an_log_s), while its warps' first tiles load.  A tile
// is R = RPL * 32 / (C / OUT) whole rows of one batch (a batch's last tile
// is ragged), tiles are numbered batch by batch, and warp g walks tiles g,
// g + grid * warps, ... behind a 2-stage ring of 16-byte cp.async copies:
// the x (or y) tile and the h tile, read as whole C-wide rows (raw | t
// together), the next tile in flight while the current one computes (the
// bytes past the last 16 one element at a time): RowWalk in row_stream.cuh,
// which coupling.cu's row stream shares.  A lane computes OUT output
// columns of RPL rows; C is a compile-time constant, so the product's loop
// is unrolled with no / or % by C, reads its rows four columns at a time
// (bf16 widened once, in registers) and W as float4 (or float2) broadcasts,
// each feeding RPL rows.  Forward: actnorm as x is read (x1 = x e^an_ls +
// an_b per column), then x1 @ W; for the lane's columns j < ca, ls = clamp
// tanh(raw / clamp) from the staged h row (raw times 1 / clamp, exact for
// GLOW's clamp of 2) and y = acc e^ls + t; the columns j >= ca pass the
// product through.  Inverse: the lanes first uncouple the first ca columns
// of their rows, v = (y - t) e^-ls, into the h row's slots as f32 (a warp
// owns whole rows, so __syncwarp orders this before the product reads
// them), then x = (v | y_b) @ W^-1 - an_b, times e^-an_ls.  The outputs go
// back over the tile's slots, and the warp stores whole rows with 16-byte
// stores.  tanhf and expf, not tanh.approx: the work is bound by memory, and
// the gate is 1e-4 in f32.
//
// At the served sizes each warp gets about one tile, so a call is one
// latency chain (launch, W and the first tile, the product, the stores) and
// what sits before the first product costs its full latency: W staged by
// plain loads, or actnorm folded into W there (W' = diag(e) W and b W),
// measured slower (PERF.md, PR 20).  Other measured alternatives that lost:
// the coupled entries of a tile spread over all 32 lanes (balanced tanh and
// exp, an f32 scratch and a barrier more), the forward's ld summed in the
// same launch over thread-block clusters of 8 or 16 blocks, one a batch
// (slower at every served shape), and caps on blocks an SM.
//
// At other widths, or for raw and t that are not the halves of one tensor,
// or a base that is not 16-byte aligned (flowstep_fwd_kernel,
// flowstep_inv_kernel): grid (tiles of block_m rows, B); the kernel masks
// the ragged last tile itself, so any M works; raw and t may be strided
// views: element (b, m, j) sits at b*h_sb + m*h_sm + j.
//
// The coupling log-determinant ld[b] = sum over (m, j < ca) of log_s is a sum
// across tiles.  The TPU kernel adds into a revisited output block, which is
// right only because the TPU grid runs in order.  Here each tile's sum is
// taken in a fixed order (the stream: each lane over its rows and columns,
// then the warp's lanes by a fixed shuffle tree; the tile kernel: the block's
// threads, then its warps in order) into partial[b, tile], and
// ld_reduce_kernel sums each row of partial in a fixed order.  The stream's
// partials do not depend on the grid.  No atomics: repeated runs are bitwise
// equal.

#include "row_stream.cuh"

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

// The flow-step stream (C = 12, 24, 48).  OUT: the output columns a lane
// computes; RPL: the rows it computes them for; WARPS: warps of a block.
// kInv: the inverse (in = y, w = W^-1, out = x, no partial).
// Shared memory, kept equal to flow_stream_smem_bytes() in
// kernels/flowstep/flowstep.py: W (C * C f32) | e^+-an_ls (C) | an_b (C) |
// each warp's ring: 2 stages of (in tile | h tile), R * C elements of T each.

template <int C, int OUT, int RPL>
__host__ __device__ constexpr int flow_rows() {  // rows of a tile
  return RPL * 32 / (C / OUT);
}

template <typename T, int C, int OUT, int RPL, int WARPS, bool kInv>
__device__ __forceinline__ void flow_stream(const T* __restrict__ in,
                                            const float* __restrict__ an_ls,
                                            const float* __restrict__ an_b,
                                            const float* __restrict__ w, long long w_si,
                                            long long w_sj, const T* __restrict__ h,
                                            T* __restrict__ out, float* __restrict__ partial,
                                            int B, int M, float clamp) {
  constexpr int G = C / OUT;               // lanes of a row
  constexpr int R = flow_rows<C, OUT, RPL>();
  constexpr int CA = C / 2;                // the coupled columns
  constexpr int KC = OUT < CA ? OUT : CA;  // coupled columns of a lane that has any
  constexpr int ES = (int)sizeof(T);
  constexpr int kTileBytes = R * C * ES;
  constexpr int WV = OUT % 4 == 0 ? 4 : 2;     // W's columns a shared load reads
  constexpr bool kRow16 = (C * ES) % 16 == 0;  // rows start 16-byte aligned
  static_assert(C % OUT == 0 && 32 % G == 0 && kTileBytes % 16 == 0 && OUT % 2 == 0 &&
                    C % 4 == 0 && (OUT == C || CA % OUT == 0),
                "a GLOW width");
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;
  float* ev = ws + C * C;
  float* bv = ev + C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  RowWalk<T, C, R, WARPS> walk(in, h, reinterpret_cast<unsigned char*>(bv + C) +
                                          warp * 4 * kTileBytes, B, M, warp, lane);
  // W (read through its strides) and an_b by 4-byte cp.async copies, a group
  // of their own, then the first tile; e^+-an_ls while they fly
  for (int k = threadIdx.x; k < C * C; k += WARPS * 32) {
    const int i = k / C;
    cp_async4(ws + k, w + i * w_si + (k - i * C) * w_sj);
  }
  for (int k = threadIdx.x; k < C; k += WARPS * 32) cp_async4(bv + k, an_b + k);
  cp_async_commit();
  walk.first();
  for (int k = threadIdx.x; k < C; k += WARPS * 32) ev[k] = expf(kInv ? -an_ls[k] : an_ls[k]);
  cp_async_wait_prev();  // this thread's copies of W and an_b have landed
  __syncthreads();       // and every thread's

  const int row0 = (lane / G) * RPL;  // the lane's first row of the tile
  const int j0 = (lane % G) * OUT;    // and its first output column
  const bool coupled = j0 < CA;       // its first KC columns are coupled
  const float rclamp = 1.f / clamp;   // log_s = clamp tanh(raw rclamp)
  walk.template run<!kInv>(out, partial, [&](unsigned char* xt, unsigned char* ht, int rows) {
    if constexpr (kInv) {  // v = (y - t) e^-ls over the h row's slots, as f32
      float v[RPL][KC];
#pragma unroll
      for (int u = 0; u < RPL; ++u) {
        if (coupled && row0 + u < rows) {
          const int r = row0 + u;
          float yv[KC], rv[KC], tv[KC];
          load_vals<T, KC>(xt + (r * C + j0) * ES, yv);
          load_vals<T, KC>(ht + (r * C + j0) * ES, rv);
          load_vals<T, KC>(ht + (r * C + CA + j0) * ES, tv);
#pragma unroll
          for (int j = 0; j < KC; ++j)
            v[u][j] = (yv[j] - tv[j]) * expf(-(clamp * tanhf(rv[j] * rclamp)));
        }
      }
      __syncwarp();  // every lane has read raw | t of its rows: v goes over them
#pragma unroll
      for (int u = 0; u < RPL; ++u)
        if (coupled && row0 + u < rows)
          store_vals<float, KC>(ht + (row0 + u) * C * ES + j0 * 4, v[u]);
      __syncwarp();  // the rows' v are in place
    }

    float acc[RPL][OUT];
#pragma unroll
    for (int u = 0; u < RPL; ++u)
#pragma unroll
      for (int j = 0; j < OUT; ++j) acc[u][j] = 0.f;
    if (row0 < rows) {  // rows past the end read what the tile holds there
#pragma unroll
      for (int i0 = 0; i0 < C; i0 += 4) {
        float xb[RPL][4];  // the product's inputs [row0 + u, i0 .. i0 + 3]
#pragma unroll
        for (int u = 0; u < RPL; ++u) {
          const int r = row0 + u;
          if constexpr (!kInv) {  // actnorm as x is read
            load_vals<T, 4>(xt + (r * C + i0) * ES, xb[u]);
            const float4 e4 = *reinterpret_cast<const float4*>(ev + i0);
            const float4 b4 = *reinterpret_cast<const float4*>(bv + i0);
            xb[u][0] = xb[u][0] * e4.x + b4.x;
            xb[u][1] = xb[u][1] * e4.y + b4.y;
            xb[u][2] = xb[u][2] * e4.z + b4.z;
            xb[u][3] = xb[u][3] * e4.w + b4.w;
          } else if (i0 + 4 <= CA) {  // v, f32 in the h row
            const unsigned char* p = ht + r * C * ES + i0 * 4;
            if constexpr (kRow16) {
              const float4 q = *reinterpret_cast<const float4*>(p);
              xb[u][0] = q.x, xb[u][1] = q.y, xb[u][2] = q.z, xb[u][3] = q.w;
            } else {
              const float2 q0 = reinterpret_cast<const float2*>(p)[0];
              const float2 q1 = reinterpret_cast<const float2*>(p)[1];
              xb[u][0] = q0.x, xb[u][1] = q0.y, xb[u][2] = q1.x, xb[u][3] = q1.y;
            }
          } else if (i0 >= CA) {  // the pass-through half of y
            load_vals<T, 4>(xt + (r * C + i0) * ES, xb[u]);
          } else {  // C = 12: columns 4, 5 of v, then 6, 7 of y
#pragma unroll
            for (int di = 0; di < 4; ++di)
              xb[u][di] = i0 + di < CA
                              ? reinterpret_cast<const float*>(ht + r * C * ES)[i0 + di]
                              : load_f(reinterpret_cast<const T*>(xt), r * C + i0 + di);
          }
        }
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

    float ld = 0.f;  // the lane's log_s, over its rows and then its columns
#pragma unroll
    for (int u = 0; u < RPL; ++u) {
      const int r = row0 + u;
      if constexpr (kInv) {
#pragma unroll
        for (int j = 0; j < OUT; ++j) acc[u][j] = (acc[u][j] - bv[j0 + j]) * ev[j0 + j];
      } else if (coupled && r < rows) {
        float rv[KC], tv[KC];
        load_vals<T, KC>(ht + (r * C + j0) * ES, rv);
        load_vals<T, KC>(ht + (r * C + CA + j0) * ES, tv);
#pragma unroll
        for (int j = 0; j < KC; ++j) {
          const float ls = clamp * tanhf(rv[j] * rclamp);
          acc[u][j] = acc[u][j] * expf(ls) + tv[j];
          ld += ls;
        }
      }
    }
    __syncwarp();  // every lane has read its rows: the outputs go over them
#pragma unroll
    for (int u = 0; u < RPL; ++u)
      if (row0 + u < rows)
        store_vals<T, OUT>(xt + ((row0 + u) * C + j0) * ES, acc[u]);
    return ld;
  });
}

// C = 12 holds 4 blocks an SM (its shared memory allows 4 in f32): at most
// 64 registers a thread
template <int C>
__host__ __device__ constexpr int flow_min_blocks() {
  return C == 12 ? 4 : 1;
}

template <typename T, int C, int OUT, int RPL, int WARPS>
__global__ void __launch_bounds__(WARPS * 32, flow_min_blocks<C>())
flowstep_fwd_stream_kernel(const T* __restrict__ x, const float* __restrict__ an_ls,
                           const float* __restrict__ an_b, const float* __restrict__ w,
                           long long w_si, long long w_sj, const T* __restrict__ h,
                           T* __restrict__ y, float* __restrict__ partial, int B, int M,
                           float clamp) {
  flow_stream<T, C, OUT, RPL, WARPS, false>(x, an_ls, an_b, w, w_si, w_sj, h, y, partial, B, M,
                                            clamp);
}

template <typename T, int C, int OUT, int RPL, int WARPS>
__global__ void __launch_bounds__(WARPS * 32, flow_min_blocks<C>())
flowstep_inv_stream_kernel(const T* __restrict__ y, const float* __restrict__ an_ls,
                           const float* __restrict__ an_b, const float* __restrict__ w_inv,
                           long long w_si, long long w_sj, const T* __restrict__ h,
                           T* __restrict__ x, int B, int M, float clamp) {
  flow_stream<T, C, OUT, RPL, WARPS, true>(y, an_ls, an_b, w_inv, w_si, w_sj, h, x, nullptr, B,
                                           M, clamp);
}

// kept equal to flow_stream_smem_bytes() in kernels/flowstep/flowstep.py
size_t flow_stream_smem_bytes(int C, int R, int warps, int elem_size) {
  return sizeof(float) * ((size_t)C * C + 2 * C) + (size_t)warps * 2 * 2 * R * C * elem_size;
}

// The stream's launch: the grid from the occupancy (asked once per
// instantiation and device), then, forward, the fixed-order sum of the
// tiles' partials.  Returns the cudaError_t of the launches.
template <typename T, int C, int OUT, int RPL, int WARPS>
cudaError_t launch_flow_stream(bool inverse, const void* in, const float* an_ls,
                               const float* an_b, const float* w, long long w_si, long long w_sj,
                               const void* h, void* out, float* partial, float* ld, int B, int M,
                               float clamp, int device, cudaStream_t s) {
  auto fwd = flowstep_fwd_stream_kernel<T, C, OUT, RPL, WARPS>;
  auto inv = flowstep_inv_stream_kernel<T, C, OUT, RPL, WARPS>;
  constexpr int R = flow_rows<C, OUT, RPL>();
  const size_t smem = flow_stream_smem_bytes(C, R, WARPS, sizeof(T));
  // blocks an SM holds and SMs, asked once per direction and device
  static int per_sm[2] = {0, 0}, n_sm[2] = {0, 0}, asked_on[2] = {-1, -1};
  const int d = inverse ? 1 : 0;
  if (asked_on[d] != device) {
    cudaError_t err = inverse
        ? cudaFuncSetAttribute(inv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)
        : cudaFuncSetAttribute(fwd, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = inverse
          ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[d], inv, WARPS * 32, smem)
          : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[d], fwd, WARPS * 32, smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n_sm[d], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    asked_on[d] = device;
  }
  const int tpb = (M + R - 1) / R;
  const long long grid = stream_grid((long long)B * tpb, WARPS, per_sm[d], n_sm[d]);
  if (inverse) {
    inv<<<(unsigned)grid, WARPS * 32, smem, s>>>(static_cast<const T*>(in), an_ls, an_b, w, w_si,
                                                 w_sj, static_cast<const T*>(h),
                                                 static_cast<T*>(out), B, M, clamp);
    return cudaGetLastError();
  }
  fwd<<<(unsigned)grid, WARPS * 32, smem, s>>>(static_cast<const T*>(in), an_ls, an_b, w, w_si,
                                               w_sj, static_cast<const T*>(h),
                                               static_cast<T*>(out), partial, B, M, clamp);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ld_reduce_kernel<<<B, 32, 0, s>>>(partial, ld, tpb);
  return cudaGetLastError();
}

// The stream's plan at each width, (OUT, RPL, WARPS) as OUT * 10000 + RPL *
// 100 + WARPS: kept equal to FLOW_PLAN in kernels/flowstep/flowstep.py;
// tools/flow_plan_sweep.py builds this source with other plans to time them
#ifndef FLOW_PLAN_12
#define FLOW_PLAN_12 120108
#endif
#ifndef FLOW_PLAN_24
#define FLOW_PLAN_24 240108
#endif
#ifndef FLOW_PLAN_48
#define FLOW_PLAN_48 60208
#endif
#define FLOW_PLAN_ARGS(P) (P) / 10000, (P) / 100 % 100, (P) % 100

template <typename T>
cudaError_t launch_flow_stream_c(bool inverse, const void* in, const float* an_ls,
                                 const float* an_b, const float* w, long long w_si,
                                 long long w_sj, const void* h, void* out, float* partial,
                                 float* ld, int B, int M, int C, float clamp, int device,
                                 cudaStream_t s) {
  switch (C) {
    case 12: return launch_flow_stream<T, 12, FLOW_PLAN_ARGS(FLOW_PLAN_12)>(
        inverse, in, an_ls, an_b, w, w_si, w_sj, h, out, partial, ld, B, M, clamp, device, s);
    case 24: return launch_flow_stream<T, 24, FLOW_PLAN_ARGS(FLOW_PLAN_24)>(
        inverse, in, an_ls, an_b, w, w_si, w_sj, h, out, partial, ld, B, M, clamp, device, s);
    case 48: return launch_flow_stream<T, 48, FLOW_PLAN_ARGS(FLOW_PLAN_48)>(
        inverse, in, an_ls, an_b, w, w_si, w_sj, h, out, partial, ld, B, M, clamp, device, s);
    default: return cudaErrorInvalidValue;
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
// partial (n_blocks, C*C + 2*C), and reduce_partials_kernel (common.cuh)
// sums each column over the blocks in a fixed order, a warp a column: no
// atomics, bitwise-repeatable, f32 whatever the storage type.
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

// spine_bwd at the GLOW widths C = 12, 24, 48 (spine_bwd_cluster_kernel, C a
// template parameter): one pass, summed in thread-block clusters, in the
// shape of conv1x1_gw's cluster kernel (conv1x1.cu).  What bounds it, by
// chip_smoke.py's cost() and units(): bytes in f32 at every width (16 B*M*C
// bytes: 25.2, 12.6 and 6.3 MB, 7.5, 3.8 and 1.9 us), against 6 C + 6
// operations an element, of which gW's 2 C run on the TF32 tensor cores and
// the other 4 C + 6 on the CUDA cores (1.34, 1.27 and 1.24 us); in bf16 the
// bytes halve and C = 48 is bound by its operations.
// At those sizes a call's fixed costs (launch, the cross-block sum, the
// first loads' latency) weigh as much as the pass itself, so the design
// keeps one pass and few serial steps, and fits two blocks to an SM.
//
// The grid is clusters x cl blocks (the plan, spine_plan() in
// kernels/flowstep/flowstep.py: 128 pairs at C = 12, 24, 64 at C = 48); block k
// takes rows [k cta_rows, (k+1) cta_rows) of x2 and gx2 and streams them as
// (rows x C) slabs of both through two stages of 16-byte cp.async copies,
// the next slab in flight while one computes.  Per slab, in one visit:
//  - x1 = x2 W^-1 and gx1 = gx2 W^T on the CUDA cores: lane l of warp q
//    takes row q RW + l / G of the slab (RW = 32 / G rows a warp, G = C / 12
//    lanes a row) and 12 output columns of both products, reading its rows
//    of x2 and gx2 four channels at a time and W^-1, W^T (f32 in shared
//    memory for the block's life) as float4 broadcasts, summed over i in
//    order as the plain version's product;
//  - x = (x1 - b) e^-ls goes over x2's row in the slab and gx = gx1 e^ls
//    into a staging slab; x1 into an f32 slab; the lane adds gx1 (x1 - b)
//    and gx1 of its columns to its g_ls and g_b sums, row after row;
//  - after one barrier, x and gx go back to HBM as 16-byte stores, and gW +=
//    x1^T gx2 runs on the tensor cores in m16n8k8 TF32 products: each warp
//    owns (16 x 8 tile, group of 8-row steps) pairs of gW (at C = 12 the two
//    tiles over four groups of steps, at C = 24 and 48 whole tiles), with two
//    sums (even and odd steps) a pair, x1 split into a TF32 hi and lo, gx2
//    too in f32 (3xTF32: a_lo b_hi + a_hi b_lo + a_hi b_hi, 2^-22 of each
//    term dropped), bf16 gx2 exact in TF32.
// After the last slab the groups' gW (in group order) and the lanes' g_ls
// and g_b (added over a warp's rows by a fixed shuffle tree, then the warps
// in order) are added over the cluster in rank order through distributed
// shared memory (cluster_sum, common.cuh).  One cluster writes the sums;
// several write a partial each, which reduce_partials_kernel adds in cluster
// order.  No atomics: bitwise repeatable.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; PERF.md, PR 18): 2 to 4.5 times
// faster than the per-tile kernel and its reduce, and still 2 to 8 times its
// bound.  Removing each phase in turn (diagnostic builds) showed every phase
// costing time of its own: within a block the phases run one after another,
// and one or two blocks share an SM, so their times add.  Clusters of 4, 8 or
// 16 blocks measured slower than pairs.

// Shared memory, kept equal to spine_cluster_smem_bytes() in
// kernels/flowstep/flowstep.py: W^-1 | W^T (C x C f32 each) | e^ls | e^-ls |
// an_b (C each) | the tail: two stages of (x2 slab | gx2 slab), TR x C in T
// each | x1 slab (TR x C f32) | gx slab (TR x C in T), which the groups'
// gW and the warps' column sums then reuse | the inbox of the block's share
// of the C*C + 2*C sums from each block of its cluster.
constexpr int kSpineOut = 12;  // the output columns a lane computes

__host__ __device__ constexpr int spine_slab_rows(int C) { return 8 * 32 / (C / kSpineOut); }
// gW's 16 x 8 tiles, and the groups of 8-row steps their products split into
__host__ __device__ constexpr int spine_tiles(int C) { return ((C + 15) / 16) * ((C + 7) / 8); }
__host__ __device__ constexpr int spine_groups(int C) {
  return spine_tiles(C) >= kWarps ? 1 : kWarps / spine_tiles(C);
}
__host__ __device__ constexpr int spine_tail_bytes(int C, int elem_size) {
  return (2 * 2 * elem_size + 4 + elem_size) * spine_slab_rows(C) * C >
                 4 * (spine_groups(C) * C * C + kWarps * 2 * C)
             ? (2 * 2 * elem_size + 4 + elem_size) * spine_slab_rows(C) * C
             : 4 * (spine_groups(C) * C * C + kWarps * 2 * C);
}
size_t spine_cluster_smem_bytes(int C, int elem_size, int cl) {
  return sizeof(float) * (2 * C * C + 3 * C) + spine_tail_bytes(C, elem_size) +
         sizeof(float) * cl * cluster_slice(C * C + 2 * C, cl);
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads, 2)
spine_bwd_cluster_kernel(const T* __restrict__ x2, const T* __restrict__ gx2,
                         const float* __restrict__ w, long long w_si, long long w_sj,
                         const float* __restrict__ w_inv, long long wi_si, long long wi_sj,
                         const float* __restrict__ an_ls, const float* __restrict__ an_b,
                         T* __restrict__ x, T* __restrict__ gx, float* __restrict__ out,
                         long long N, long long cta_rows, int slab_rows, int clusters) {
  constexpr int G = C / kSpineOut, RW = 32 / G, TR = spine_slab_rows(C);
  constexpr int NT = (C + 7) / 8;                      // gW's 8-column tiles
  constexpr int TILES = spine_tiles(C), KG = spine_groups(C);
  constexpr int PW = (TILES * KG + kWarps - 1) / kWarps;  // (tile, group) pairs a warp
  constexpr int E = C * C + 2 * C;                     // gW | g_ls | g_b
  constexpr int ES = (int)sizeof(T);
  constexpr bool kSplitB = sizeof(T) == 4;             // gx2; x1 is always f32
  static_assert(C % kSpineOut == 0 && 32 % G == 0, "a GLOW width");
  extern __shared__ __align__(16) unsigned char ssm[];
  float* wi = reinterpret_cast<float*>(ssm);
  float* wt = wi + C * C;
  float* ep = wt + C * C;
  float* em = ep + C;
  float* bb = em + C;
  unsigned char* tail = reinterpret_cast<unsigned char*>(bb + C);
  constexpr int kSlab = TR * C * ES;  // bytes of one slab in T
  float* x1s = reinterpret_cast<float*>(tail + 2 * 2 * kSlab);
  unsigned char* gxs = reinterpret_cast<unsigned char*>(x1s + TR * C);
  float* red = reinterpret_cast<float*>(tail);  // KG x C*C, then kWarps x 2C
  float* cs = red + KG * C * C;
  float* inbox = reinterpret_cast<float*>(tail + spine_tail_bytes(C, ES));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row = warp * RW + lane / G, j0 = (lane % G) * kSpineOut;
  const long long r0 = min((long long)blockIdx.x * cta_rows, N);
  const long long r1 = min(r0 + cta_rows, N);
  const int n_slabs = (int)((r1 - r0 + slab_rows - 1) / slab_rows);

  auto issue = [&](int sl) {  // slab sl into stage sl & 1: x2, then gx2
    const long long s0 = r0 + (long long)sl * slab_rows;
    const int n = (int)min((long long)slab_rows, r1 - s0) * C;
    unsigned char* dst = tail + (sl & 1) * 2 * kSlab;
    stage_elems<T>(dst, x2 + s0 * C, n, tid, kThreads);
    stage_elems<T>(dst + kSlab, gx2 + s0 * C, n, tid, kThreads);
  };
  if (n_slabs > 0) issue(0);
  cp_async_commit();
  for (int k = tid; k < C * C; k += kThreads) {  // W and W^-1 read through their strides
    const int i = k / C, j = k - i * C;
    wi[k] = w_inv[i * wi_si + j * wi_sj];
    wt[j * C + i] = w[i * w_si + j * w_sj];
  }
  for (int k = tid; k < C; k += kThreads) {
    ep[k] = expf(an_ls[k]);
    em[k] = expf(-an_ls[k]);
    bb[k] = an_b[k];
  }

  // this warp's (tile, group) pairs of gW, each as two sums (even, odd steps)
  float acc[PW][2][4];
#pragma unroll
  for (int p = 0; p < PW; ++p)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[p][h][c] = 0.f;
  float gls[kSpineOut], gb[kSpineOut];  // this lane's columns, over its rows
#pragma unroll
  for (int c = 0; c < kSpineOut; ++c) gls[c] = gb[c] = 0.f;

  for (int sl = 0; sl < n_slabs; ++sl) {
    cp_async_wait_all();
    __syncthreads();  // slab sl has landed; slab sl - 1 is no longer read
    if (sl + 1 < n_slabs) issue(sl + 1);
    cp_async_commit();
    unsigned char* xs = tail + (sl & 1) * 2 * kSlab;
    const unsigned char* gs = xs + kSlab;
    const long long s0 = r0 + (long long)sl * slab_rows;
    const int rows = (int)min((long long)slab_rows, r1 - s0);

    float x1[kSpineOut], g1[kSpineOut];
#pragma unroll
    for (int c = 0; c < kSpineOut; ++c) x1[c] = g1[c] = 0.f;
    if (row < rows) {
#pragma unroll 4
      for (int i0 = 0; i0 < C; i0 += 4) {
        float xv[4], gv[4];
        load_vals<T, 4>(xs + (row * C + i0) * ES, xv);
        load_vals<T, 4>(gs + (row * C + i0) * ES, gv);
#pragma unroll
        for (int di = 0; di < 4; ++di) {
          const float4* wir = reinterpret_cast<const float4*>(wi + (i0 + di) * C + j0);
          const float4* wtr = reinterpret_cast<const float4*>(wt + (i0 + di) * C + j0);
#pragma unroll
          for (int q = 0; q < kSpineOut / 4; ++q) {
            const float4 a = wir[q], bq = wtr[q];
            x1[4 * q] = fmaf(xv[di], a.x, x1[4 * q]);
            x1[4 * q + 1] = fmaf(xv[di], a.y, x1[4 * q + 1]);
            x1[4 * q + 2] = fmaf(xv[di], a.z, x1[4 * q + 2]);
            x1[4 * q + 3] = fmaf(xv[di], a.w, x1[4 * q + 3]);
            g1[4 * q] = fmaf(gv[di], bq.x, g1[4 * q]);
            g1[4 * q + 1] = fmaf(gv[di], bq.y, g1[4 * q + 1]);
            g1[4 * q + 2] = fmaf(gv[di], bq.z, g1[4 * q + 2]);
            g1[4 * q + 3] = fmaf(gv[di], bq.w, g1[4 * q + 3]);
          }
        }
      }
    }
    __syncwarp();  // the lanes of each row have read its x2: x goes over it
    if (row < rows) {
      float xo[kSpineOut], go[kSpineOut];
#pragma unroll
      for (int c = 0; c < kSpineOut; ++c) {
        const float d = x1[c] - bb[j0 + c];
        xo[c] = d * em[j0 + c];
        go[c] = g1[c] * ep[j0 + c];
        gls[c] = fmaf(g1[c], d, gls[c]);
        gb[c] += g1[c];
      }
      store_vals<float, kSpineOut>(reinterpret_cast<unsigned char*>(x1s + row * C + j0), x1);
      store_vals<T, kSpineOut>(xs + (row * C + j0) * ES, xo);
      store_vals<T, kSpineOut>(gxs + (row * C + j0) * ES, go);
    }
    __syncthreads();  // the slab holds x, gx and x1

    store_elems<T>(x + s0 * C, xs, rows * C, tid, kThreads);
    store_elems<T>(gx + s0 * C, gxs, rows * C, tid, kThreads);
    const unsigned char* xb = reinterpret_cast<const unsigned char*>(x1s);
#pragma unroll
    for (int p = 0; p < PW; ++p) {
      const int pair = warp + p * kWarps;  // past the slab's rows, values read 0
      if (pair >= TILES * KG) break;
      const int tile = pair % TILES, grp = pair / TILES;
      const int i0 = (tile / NT) * 16, n0 = (tile % NT) * 8;
      // two steps at a time, one into each sum, so their products overlap
      for (int k0 = 8 * grp; k0 < rows; k0 += 16 * KG) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = k0 + 8 * KG * h;
          uint32_t ah[4], al[4], bh[2], bl[2];
          split_tf32<true>(slab_at<float, C>(xb, k + t, i0 + g, rows, C), ah[0], al[0]);
          split_tf32<true>(slab_at<float, C>(xb, k + t, i0 + g + 8, rows, C), ah[1], al[1]);
          split_tf32<true>(slab_at<float, C>(xb, k + t + 4, i0 + g, rows, C), ah[2], al[2]);
          split_tf32<true>(slab_at<float, C>(xb, k + t + 4, i0 + g + 8, rows, C), ah[3], al[3]);
          split_tf32<kSplitB>(slab_at<T, C>(gs, k + t, n0 + g, rows, C), bh[0], bl[0]);
          split_tf32<kSplitB>(slab_at<T, C>(gs, k + t + 4, n0 + g, rows, C), bh[1], bl[1]);
          mma_3xtf32<true, kSplitB>(acc[p][h], ah, al, bh, bl);
        }
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();  // the tail is no longer read: the sums go over it

#pragma unroll
  for (int p = 0; p < PW; ++p) {
    const int pair = warp + p * kWarps;
    if (pair >= TILES * KG) break;
    const int tile = pair % TILES, grp = pair / TILES;
    const int i0 = (tile / NT) * 16, n0 = (tile % NT) * 8;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = i0 + g + (c >= 2 ? 8 : 0), j = n0 + 2 * t + (c & 1);
      if (i < C && j < C) red[grp * C * C + i * C + j] = acc[p][0][c] + acc[p][1][c];
    }
  }
  // the warp's rows, lane ^ 16 first and lane ^ G last: the warp's column sums
#pragma unroll
  for (int o = 16; o >= G; o >>= 1)
#pragma unroll
    for (int c = 0; c < kSpineOut; ++c) {
      gls[c] += __shfl_xor_sync(0xffffffffu, gls[c], o);
      gb[c] += __shfl_xor_sync(0xffffffffu, gb[c], o);
    }
  if (lane < G)
#pragma unroll
    for (int c = 0; c < kSpineOut; ++c) {
      cs[warp * 2 * C + j0 + c] = gls[c];
      cs[warp * 2 * C + C + j0 + c] = gb[c];
    }
  __syncthreads();
  // the groups (warps) in order, then over the cluster in rank order
  const int cid = blockIdx.x / (int)cooperative_groups::this_cluster().num_blocks();
  cluster_sum(
      E,
      [&](int e) {
        float s = 0.f;
        if (e < C * C) {
          for (int q = 0; q < KG; ++q) s += red[q * C * C + e];
        } else {
          for (int q = 0; q < kWarps; ++q) s += cs[q * 2 * C + e - C * C];
        }
        return s;
      },
      inbox, out + (long long)(clusters == 1 ? 0 : cid) * E);
}

template <typename T, int C>
cudaError_t launch_spine_cluster(const void* x2, const void* gx2, const float* w,
                                 const long long* ws, const float* w_inv, const float* an_ls,
                                 const float* an_b, void* x, void* gx, float* out, long long N,
                                 long long cta_rows, int slab_rows, int clusters, int cl,
                                 cudaStream_t s) {
  return launch_clustered(spine_bwd_cluster_kernel<T, C>, clusters * cl, kThreads,
                          spine_cluster_smem_bytes(C, sizeof(T), cl), cl, s,
                          static_cast<const T*>(x2), static_cast<const T*>(gx2), w, ws[0], ws[1],
                          w_inv, ws[2], ws[3], an_ls, an_b, static_cast<T*>(x),
                          static_cast<T*>(gx), out, N, cta_rows, slab_rows, clusters);
}

template <typename T>
cudaError_t launch_spine_cluster_c(const void* x2, const void* gx2, const float* w,
                                   const long long* ws, const float* w_inv, const float* an_ls,
                                   const float* an_b, void* x, void* gx, float* out, long long N,
                                   int C, long long cta_rows, int slab_rows, int clusters, int cl,
                                   cudaStream_t s) {
  switch (C) {  // kept equal to SPINE_WIDTHS in kernels/flowstep/flowstep.py
    case 12: return launch_spine_cluster<T, 12>(x2, gx2, w, ws, w_inv, an_ls, an_b, x, gx, out,
                                                N, cta_rows, slab_rows, clusters, cl, s);
    case 24: return launch_spine_cluster<T, 24>(x2, gx2, w, ws, w_inv, an_ls, an_b, x, gx, out,
                                                N, cta_rows, slab_rows, clusters, cl, s);
    case 48: return launch_spine_cluster<T, 48>(x2, gx2, w, ws, w_inv, an_ls, an_b, x, gx, out,
                                                N, cta_rows, slab_rows, clusters, cl, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int C>
cudaError_t spine_clusters_of(int cl, int* n) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const cudaError_t err = cluster_config(spine_bwd_cluster_kernel<T, C>, cl, kThreads,
                                         spine_cluster_smem_bytes(C, sizeof(T), cl), cl, 0, cfg,
                                         attr);
  return err != cudaSuccess ? err
                            : cudaOccupancyMaxActiveClusters(n, spine_bwd_cluster_kernel<T, C>, &cfg);
}

template <typename T>
cudaError_t spine_clusters_c(int C, int cl, int* n) {
  switch (C) {
    case 12: return spine_clusters_of<T, 12>(cl, n);
    case 24: return spine_clusters_of<T, 24>(cl, n);
    case 48: return spine_clusters_of<T, 48>(cl, n);
    default: return cudaErrorInvalidValue;
  }
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

// The stream path: C in {12, 24, 48}; in (x or y) and out (B, M, C)
// contiguous; h (B, M, C) contiguous, raw = h[..., :C/2] and t = h[..., C/2:];
// in, h and each batch's rows (M * C elements) 16-byte aligned (the caller
// checks).  w: (C, C) float32, element (i, j) at i*w_si + j*w_sj.  inverse:
// 0 = forward (w = W; partial: (B, ceil(M / R)) float32 scratch, R =
// stream_rows(C); ld: (B,) float32), 1 = inverse (w = W^-1; partial and ld
// unused, may be null).  Returns the cudaError_t of the launches.
int flowstep_stream(int dtype, int inverse, const void* in, const float* an_ls,
                    const float* an_b, const float* w, long long w_si, long long w_sj,
                    const void* h, void* out, float* partial, float* ld, int B, int M, int C,
                    float clamp, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch_flow_stream_c<float>(inverse != 0, in, an_ls, an_b, w, w_si,
                                                         w_sj, h, out, partial, ld, B, M, C, clamp,
                                                         device, s));
  if (dtype == 1)
    return static_cast<int>(launch_flow_stream_c<__nv_bfloat16>(
        inverse != 0, in, an_ls, an_b, w, w_si, w_sj, h, out, partial, ld, B, M, C, clamp, device,
        s));
  return static_cast<int>(cudaErrorInvalidValue);
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
  return static_cast<int>(launch_reduce_partials(partial, sums, n_tiles * B, C * C + 2 * C, s));
}

// The cluster path: C in {12, 24, 48}, x2 and gx2 16-byte aligned (the
// caller checks); otherwise as spine_bwd, but W and W^-1 are read through
// their strides, w_strides = (W's row and column, W^-1's row and column
// element strides).  N = B * M rows, clusters x
// cluster_size blocks of cta_rows rows (a multiple of 8), slab_rows (a
// multiple of 8, at most spine_slab_rows(C)) staged at a time; partial:
// (clusters, C*C + 2*C) float32 scratch, unused (may be null) for one
// cluster.  Returns the cudaError_t of the launches.
int spine_bwd_cluster(int dtype, const void* x2, const void* gx2, const float* w,
                      const float* w_inv, const long long* w_strides, const float* an_ls,
                      const float* an_b, void* x, void* gx, float* partial, float* sums,
                      long long N, int C, long long cta_rows, int slab_rows, int clusters,
                      int cluster_size, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = clusters == 1 ? sums : partial;
  if (dtype == 0) {
    err = launch_spine_cluster_c<float>(x2, gx2, w, w_strides, w_inv, an_ls, an_b, x, gx, out,
                                        N, C, cta_rows, slab_rows, clusters, cluster_size, s);
  } else if (dtype == 1) {
    err = launch_spine_cluster_c<__nv_bfloat16>(x2, gx2, w, w_strides, w_inv, an_ls, an_b, x, gx,
                                                out, N, C, cta_rows, slab_rows, clusters,
                                                cluster_size, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess || clusters == 1) return static_cast<int>(err);
  return static_cast<int>(launch_reduce_partials(partial, sums, clusters, C * C + 2 * C, s));
}

// *n: how many clusters of cluster_size blocks of the cluster kernel at
// width C the card holds at once.  Returns the cudaError_t of the query.
int spine_max_clusters(int dtype, int C, int cluster_size, int device, int* n) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dtype == 0) return static_cast<int>(spine_clusters_c<float>(C, cluster_size, n));
  if (dtype == 1) return static_cast<int>(spine_clusters_c<__nv_bfloat16>(C, cluster_size, n));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
