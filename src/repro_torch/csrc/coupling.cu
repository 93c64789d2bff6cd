// Fused affine coupling for Hopper (sm_90a): forward, inverse and the
// backward from the output side.
//
// coupling_rows_kernel (forward) and coupling_fwd_kernel, each with
// ld_reduce_kernel, replace the Pallas kernel
//   src/repro/kernels/coupling/coupling.py::coupling_fwd (_fwd_kernel)
// coupling_rows_kernel (inverse) and coupling_inv_kernel replace
//   src/repro/kernels/coupling/coupling.py::coupling_inv (_inv_kernel)
// coupling_bwd_rows_kernel and coupling_bwd_kernel replace
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
// What bounds them: memory.  Each does some 10 flops and one or two
// transcendentals an element, against 16 bytes an element in f32 for the
// forward and the inverse on the transformed half and 32 for the backward.
//
// The row stream (coupling_rows_kernel, the "rows" path; coupling_path() in
// kernels/coupling/coupling.py picks it): at the GLOW widths C = 2 ca = 12,
// 24, 48, when the coupled half is the first, x (or y) is a contiguous
// (B, M, C) tensor, raw and t are the two halves of one contiguous (B, M, C)
// conditioner output h, and the bases and each batch's rows are 16-byte
// aligned.  It computes the coupling layer's whole output row: the coupled
// columns and the pass-through half, into one contiguous (B, M, C) tensor,
// so the layer joins no halves afterwards (the half kernels' caller paid a
// second full pass for that, torch.cat, as much device time as the kernel).
// It reads x and h and writes the output once: 3 C-wide rows, 12*B*M*C
// bytes in f32 (18.9 MB at (8, 16384, 12), 5.63 us at 3.35 TB/s; 2.82 and
// 1.41 us at (8, 4096, 24) and (8, 1024, 48)).  It is the flow-step stream's
// walk (RowWalk, row_stream.cuh, shared with flowstep.cu) with no actnorm and
// no C x C product: a persistent grid sized from the occupancy; each warp
// takes tiles g, g + grid * warps, ... of R whole rows of one batch, staged
// as C-wide rows of x and of h (raw | t together) by 16-byte cp.async into a
// 2-stage ring, the next tile in flight while the current one computes.  C
// is a template parameter, so no index is divided per element (the half
// kernels divide a 64-bit index by ca, and the inverse's once more by M, for
// every element, and load one element at a time).  A lane takes K coupled
// columns of RPL rows (G = ca / K lanes a row, R = RPL * 32 / G; all 32
// lanes compute, none idles on the pass-through half), reads them as
// 8- or 16-byte vectors (bf16 widened once, in registers), computes in f32
// (tanhf and expf, not the approximate instructions: the gate is 1e-4 in
// f32) and writes the results over their slots in the x tile; the
// pass-through half is already there, so the warp stores whole rows with
// 16-byte stores.  The forward's ld: each lane sums its log_s over its rows
// and then its columns, the tile's lanes by a fixed shuffle tree into
// partial[b, tile], and ld_reduce_kernel sums each batch's partials in a
// fixed order: no atomics, bitwise repeatable, and independent of the grid.
// The reduce is launched as a programmatic dependent of the stream
// (ld_reduce_kernel<true>; the stream's blocks call
// griddepcontrol.launch_dependents once their partials are stored, the
// reduce waits in griddepcontrol.wait), so its launch overlaps the stream's
// tail: about 1 us less on the span of queued calls, where the summed
// kernel time cannot show it (PERF.md).  One plan serves every width and
// both types: (K, RPL, WARPS) = (6, 1, 8), the fastest or within 0.1 us of
// it in f32.  Measured alternatives that lost (tools/flow_plan_sweep.py
// --coupling, which builds this file with -DCOUPLING_PLAN and
// -DCOUPLING_PDL): 4 or 16 warps a block, two rows a lane (faster in bf16
// at C = 12 and 24, slower in f32), the reduce as a plain launch after the
// stream; and a whole coupled half a lane at C = 24 and 48, the reduce
// with its loads made 8 ahead of its adds (no faster).
//
// The backward's row stream (coupling_bwd_rows_kernel, the "rows" path of
// coupling_bwd; the same rule, with gy contiguous and aligned too) computes
// the backward's whole rows from y, h and gy: x (the rebuilt coupled half,
// y's pass-through half after it), gx (gy exp(log_s) on the coupled half,
// gy's pass-through half as it is: the caller adds the conditioner's
// cotangent into that half in place) and gh = (graw | gt), the cotangent of
// h in h's layout.  So none of its callers joins halves (the half kernel's
// callers paid three torch.cat a call for x, gx and gh, each about as much
// device time as the kernel).  It reads 3 C-wide rows and writes 3: 24*B*M*C
// bytes in f32 (11.27 us at 3.35 TB/s at (8, 16384, 12); 5.63 and 2.82 us
// at (8, 4096, 24) and (8, 1024, 48)).  It is the forward's walk with a
// third staged tile (RowWalk<..., 3>: y | h | gy a stage), the same lane
// layout (K coupled columns of RPL rows a lane): a lane rewrites only the
// slots it alone reads, x over its y slots, gx over its gy slots, graw and
// gt over its raw and t slots, and the warp stores the three tiles as whole
// rows.  The arithmetic is the half kernel's, in the same order (tanhf,
// expf; graw from the f32 x), and nothing is summed (gld is an input), so
// the output is bitwise repeatable.  Shared memory: 8 warps x 2 stages x 3
// tiles x R*C*4 bytes = 72 KB a block in f32 at every width (R*C = 384), so
// three blocks share an SM.
//
// The half kernels (coupling_fwd_kernel, coupling_inv_kernel,
// coupling_bwd_kernel, the "tile" path) take every other call (the second half coupled, other widths, raw
// and t that are not the halves of one h, a base off 16 bytes) on the
// (B, M, ca) view of the transformed half, with the half-in / half-out
// contract.  One element a thread, nothing staged: every value is read once
// and written once.  The forward's ld: a block owns a fixed range of
// tile_elems elements of one batch row, sums its log_s in a fixed order into
// partial[b, tile], and ld_reduce_kernel sums each row of partial.
//
// Layout of the half kernels: x (or y, gy) is one half of a (B, M, C) tensor
// and raw/t the two halves of one conditioner output, so all of them are
// strided views: element (b, m, j) of x sits at b*x_sb + m*x_sm + j (raw and
// t share h_sb, h_sm).  Nothing is copied to make them contiguous.  The
// outputs are contiguous (B, M, ca).

#include "row_stream.cuh"

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

// The row stream's plan, (K, RPL, WARPS) as K * 10000 + RPL * 100 + WARPS,
// kept equal to COUPLING_PLAN in kernels/coupling/coupling.py: K the coupled
// columns a lane computes (it divides C / 2 at every width), RPL the rows it
// computes them for, WARPS the warps of a block.  COUPLING_PDL 0 launches
// the forward's reduce after the stream's grid, as a plain launch.  Both are
// set otherwise only by tools/flow_plan_sweep.py --coupling.
#ifndef COUPLING_PLAN
#define COUPLING_PLAN 60108
#endif
#ifndef COUPLING_PDL
#define COUPLING_PDL 1
#endif
constexpr int kRowK = COUPLING_PLAN / 10000, kRowRpl = COUPLING_PLAN / 100 % 100,
              kRowWarps = COUPLING_PLAN % 100;

// Rows of a row-stream tile: G = C / 2 / K lanes share each of RPL rows
template <int C>
__host__ __device__ constexpr int coupling_rows_per_tile() {
  return kRowRpl * 32 / (C / 2 / kRowK);
}

// The row stream (C = 12, 24, 48).  kInv: the inverse (in = y, out = x, no
// partial).  Shared memory, kept equal to coupling_rows_smem_bytes() in
// kernels/coupling/coupling.py: each warp's ring, 2 stages of (in tile | h
// tile), R * C elements of T each.
template <typename T, int C, bool kInv>
__global__ void __launch_bounds__(kRowWarps * 32)
coupling_rows_kernel(const T* __restrict__ in, const T* __restrict__ h, T* __restrict__ out,
                     float* __restrict__ partial, int B, int M, float clamp) {
  constexpr int K = kRowK, RPL = kRowRpl;
  constexpr int CA = C / 2;  // the coupled columns
  constexpr int G = CA / K;  // lanes of a row
  constexpr int R = coupling_rows_per_tile<C>();
  constexpr int ES = (int)sizeof(T);
  static_assert(CA % K == 0 && 32 % G == 0 && (K * ES) % 4 == 0, "a GLOW width");
  extern __shared__ __align__(16) unsigned char ring[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  RowWalk<T, C, R, kRowWarps> walk(in, h, ring + warp * 4 * R * C * ES, B, M, warp, lane);
  walk.first();
  const int row0 = (lane / G) * RPL;  // the lane's first row of the tile
  const int j0 = (lane % G) * K;      // and its first coupled column
  const float rclamp = 1.f / clamp;   // log_s = clamp tanh(raw rclamp)
  // a lane rewrites only the x slots it alone reads; the h tile is read only
  walk.template run<!kInv>(out, partial, [&](unsigned char* xt, unsigned char* ht, int rows) {
    float ld = 0.f;  // the lane's log_s, over its rows and then its columns
#pragma unroll
    for (int u = 0; u < RPL; ++u) {
      const int r = row0 + u;
      if (r < rows) {
        float v[K], rv[K], tv[K];
        load_vals<T, K>(xt + (r * C + j0) * ES, v);
        load_vals<T, K>(ht + (r * C + j0) * ES, rv);
        load_vals<T, K>(ht + (r * C + CA + j0) * ES, tv);
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const float ls = clamp * tanhf(rv[j] * rclamp);
          if constexpr (kInv) {
            v[j] = (v[j] - tv[j]) * expf(-ls);
          } else {
            v[j] = v[j] * expf(ls) + tv[j];
            ld += ls;
          }
        }
        store_vals<T, K>(xt + (r * C + j0) * ES, v);
      }
    }
    return ld;
  });
  // the partials are stored: the reduce, a programmatic dependent, may
  // start (it still waits for this grid's memory in griddepcontrol.wait)
  if constexpr (!kInv) asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// The row stream's launch: the grid from the occupancy (asked once per
// instantiation, direction and device), then, forward, the fixed-order sum
// of the tiles' partials as a programmatic dependent launch.  Returns the
// cudaError_t of the launches.
template <typename T, int C>
cudaError_t launch_coupling_rows(bool inverse, const void* in, const void* h, void* out,
                                 float* partial, float* ld, int B, int M, float clamp,
                                 int device, cudaStream_t s) {
  auto fwd = coupling_rows_kernel<T, C, false>;
  auto inv = coupling_rows_kernel<T, C, true>;
  constexpr int R = coupling_rows_per_tile<C>();
  constexpr int threads = kRowWarps * 32;
  const size_t smem = (size_t)kRowWarps * 2 * 2 * R * C * sizeof(T);
  static int per_sm[2] = {0, 0}, n_sm[2] = {0, 0}, asked_on[2] = {-1, -1};
  const int d = inverse ? 1 : 0;
  if (asked_on[d] != device) {
    cudaError_t err = cudaFuncSetAttribute(inverse ? inv : fwd,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[d], inverse ? inv : fwd,
                                                          threads, smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n_sm[d], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    asked_on[d] = device;
  }
  const int tpb = (M + R - 1) / R;
  const unsigned grid = (unsigned)stream_grid((long long)B * tpb, kRowWarps, per_sm[d], n_sm[d]);
  const T* in_t = static_cast<const T*>(in);
  const T* h_t = static_cast<const T*>(h);
  T* out_t = static_cast<T*>(out);
  if (inverse) {
    inv<<<grid, threads, smem, s>>>(in_t, h_t, out_t, nullptr, B, M, clamp);
    return cudaGetLastError();
  }
  fwd<<<grid, threads, smem, s>>>(in_t, h_t, out_t, partial, B, M, clamp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)B);
  cfg.blockDim = dim3(32);
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = COUPLING_PDL ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, ld_reduce_kernel<true>, (const float*)partial, ld, tpb);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
cudaError_t launch_coupling_rows_c(bool inverse, const void* in, const void* h, void* out,
                                   float* partial, float* ld, int B, int M, int C, float clamp,
                                   int device, cudaStream_t s) {
  switch (C) {  // kept equal to STREAM_WIDTHS in kernels/common.py
    case 12: return launch_coupling_rows<T, 12>(inverse, in, h, out, partial, ld, B, M, clamp,
                                                device, s);
    case 24: return launch_coupling_rows<T, 24>(inverse, in, h, out, partial, ld, B, M, clamp,
                                                device, s);
    case 48: return launch_coupling_rows<T, 48>(inverse, in, h, out, partial, ld, B, M, clamp,
                                                device, s);
    default: return cudaErrorInvalidValue;
  }
}

// The backward's row stream (C = 12, 24, 48): y, h, gy in; x, gx, gh out,
// each (B, M, C) contiguous.  Shared memory, kept equal to
// coupling_bwd_rows_smem_bytes() in kernels/coupling/coupling.py: each
// warp's ring, 2 stages of (y tile | h tile | gy tile), R * C elements of T
// each.
template <typename T, int C>
__global__ void __launch_bounds__(kRowWarps * 32)
coupling_bwd_rows_kernel(const T* __restrict__ y, const T* __restrict__ h,
                         const T* __restrict__ gy, const float* __restrict__ gld,
                         T* __restrict__ x, T* __restrict__ gx, T* __restrict__ gh, int B,
                         int M, float clamp) {
  constexpr int K = kRowK, RPL = kRowRpl;
  constexpr int CA = C / 2;  // the coupled columns
  constexpr int G = CA / K;  // lanes of a row
  constexpr int R = coupling_rows_per_tile<C>();
  constexpr int ES = (int)sizeof(T);
  static_assert(CA % K == 0 && 32 % G == 0 && (K * ES) % 4 == 0, "a GLOW width");
  extern __shared__ __align__(16) unsigned char ring[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  RowWalk<T, C, R, kRowWarps, 3> walk(y, h, ring + warp * 6 * R * C * ES, B, M, warp, lane, gy);
  walk.first();
  const int row0 = (lane / G) * RPL;  // the lane's first row of the tile
  const int j0 = (lane % G) * K;      // and its first coupled column
  // each lane rewrites only the y, h and gy slots it alone reads
  walk.template run<false>(
      x, nullptr,
      [&](unsigned char* yt, unsigned char* ht, unsigned char* gt, int rows, long long b) {
        const float gl = gld[b];
#pragma unroll
        for (int u = 0; u < RPL; ++u) {
          const int r = row0 + u;
          if (r < rows) {
            float v[K], rv[K], tv[K], g[K];
            load_vals<T, K>(yt + (r * C + j0) * ES, v);
            load_vals<T, K>(ht + (r * C + j0) * ES, rv);
            load_vals<T, K>(ht + (r * C + CA + j0) * ES, tv);
            load_vals<T, K>(gt + (r * C + j0) * ES, g);
#pragma unroll
            for (int j = 0; j < K; ++j) {
              const float th = tanhf(rv[j] / clamp);
              const float ls = clamp * th;
              const float es = expf(ls);
              const float xv = (v[j] - tv[j]) * expf(-ls);
              v[j] = xv;                                           // x
              rv[j] = (g[j] * xv * es + gl) * (1.f - th * th);     // graw
              tv[j] = g[j];                                        // gt
              g[j] = g[j] * es;                                    // gx
            }
            store_vals<T, K>(yt + (r * C + j0) * ES, v);
            store_vals<T, K>(ht + (r * C + j0) * ES, rv);
            store_vals<T, K>(ht + (r * C + CA + j0) * ES, tv);
            store_vals<T, K>(gt + (r * C + j0) * ES, g);
          }
        }
        return 0.f;
      },
      gh, gx);
}

// The backward row stream's launch: the grid from the occupancy, asked once
// per instantiation and device.  Returns the cudaError_t of the launch.
template <typename T, int C>
cudaError_t launch_coupling_bwd_rows(const void* y, const void* h, const void* gy,
                                     const float* gld, void* x, void* gx, void* gh, int B, int M,
                                     float clamp, int device, cudaStream_t s) {
  auto kernel = coupling_bwd_rows_kernel<T, C>;
  constexpr int R = coupling_rows_per_tile<C>();
  constexpr int threads = kRowWarps * 32;
  const size_t smem = (size_t)kRowWarps * 2 * 3 * R * C * sizeof(T);
  static int per_sm = 0, n_sm = 0, asked_on = -1;
  if (asked_on != device) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    asked_on = device;
  }
  const int tpb = (M + R - 1) / R;
  const unsigned grid = (unsigned)stream_grid((long long)B * tpb, kRowWarps, per_sm, n_sm);
  kernel<<<grid, threads, smem, s>>>(static_cast<const T*>(y), static_cast<const T*>(h),
                                     static_cast<const T*>(gy), gld, static_cast<T*>(x),
                                     static_cast<T*>(gx), static_cast<T*>(gh), B, M, clamp);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_coupling_bwd_rows_c(const void* y, const void* h, const void* gy,
                                       const float* gld, void* x, void* gx, void* gh, int B,
                                       int M, int C, float clamp, int device, cudaStream_t s) {
  switch (C) {  // kept equal to STREAM_WIDTHS in kernels/common.py
    case 12: return launch_coupling_bwd_rows<T, 12>(y, h, gy, gld, x, gx, gh, B, M, clamp,
                                                    device, s);
    case 24: return launch_coupling_bwd_rows<T, 24>(y, h, gy, gld, x, gx, gh, B, M, clamp,
                                                    device, s);
    case 48: return launch_coupling_bwd_rows<T, 48>(y, h, gy, gld, x, gx, gh, B, M, clamp,
                                                    device, s);
    default: return cudaErrorInvalidValue;
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

// The row stream: C in {12, 24, 48}; in (x or y) and out (B, M, C)
// contiguous; h (B, M, C) contiguous, raw = h[..., :C/2] and t = h[..., C/2:];
// in, h and each batch's rows (M * C elements) 16-byte aligned (the caller
// checks).  inverse: 0 = forward (partial: (B, ceil(M / R)) float32 scratch,
// R the plan's rows a tile; ld: (B,) float32), 1 = inverse (partial and ld
// unused; the pointers may be null).  Returns the cudaError_t of the
// launches.
int coupling_rows(int dtype, int inverse, const void* in, const void* h, void* out,
                  float* partial, float* ld, int B, int M, int C, float clamp, int device,
                  void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch_coupling_rows_c<float>(inverse != 0, in, h, out, partial, ld,
                                                          B, M, C, clamp, device, s));
  if (dtype == 1)
    return static_cast<int>(launch_coupling_rows_c<__nv_bfloat16>(
        inverse != 0, in, h, out, partial, ld, B, M, C, clamp, device, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward's row stream: C in {12, 24, 48}; y, gy and the outputs x,
// gx, gh (B, M, C) contiguous; h (B, M, C) contiguous, raw = h[..., :C/2]
// and t = h[..., C/2:]; gld (B,) float32; y, h, gy and each batch's rows
// (M * C elements) 16-byte aligned (the caller checks).  dtype as
// coupling_bwd.  Returns the cudaError_t of the launch.
int coupling_bwd_rows(int dtype, const void* y, const void* h, const void* gy, const float* gld,
                      void* x, void* gx, void* gh, int B, int M, int C, float clamp, int device,
                      void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch_coupling_bwd_rows_c<float>(y, h, gy, gld, x, gx, gh, B, M, C,
                                                              clamp, device, s));
  if (dtype == 1)
    return static_cast<int>(launch_coupling_bwd_rows_c<__nv_bfloat16>(y, h, gy, gld, x, gx, gh,
                                                                      B, M, C, clamp, device, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
