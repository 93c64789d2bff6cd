// Invertible 1x1 convolution for Hopper (sm_90a): the channel-mixing product
// and its weight cotangent, on the (N = B*M, C) rows of a (B, M, C) tensor.
//
// conv1x1_mm_stream_kernel (C = 12, 24, 48) and conv1x1_mm_kernel (other C)
// replace the Pallas kernel
//   src/repro/kernels/conv1x1/conv1x1.py::conv1x1_mm (_kernel)
// conv1x1_gw_cluster_kernel (C = 12, 24, 48) and conv1x1_gw_kernel (other C,
// each with reduce_partials_kernel where its partials need it) replace
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
// block it revisits in grid order; blocks here run in no order, and no atomic
// adds are used, so every sum runs in a fixed order and repeated runs are
// bitwise equal.  Its 2 C flops per element put it near the card's f32 ridge
// at C = 48 (12 flops a byte in f32, 24 in bf16, against 20), so the sum needs
// most of the SMs and not only their bandwidth.
//
// At the GLOW widths C = 12, 24, 48 (conv1x1_gw_cluster_kernel, C a template
// parameter): one pass, summed in thread-block clusters.  The grid is
// clusters x cluster_size blocks (the plan, gw_plan() in
// kernels/conv1x1/conv1x1.py); block k owns rows [k cta_rows, (k+1)
// cta_rows).  It streams them as flat (rows x C) slabs of x and gy through a
// 4-stage ring of 16-byte cp.async copies (the bytes past the last 16 one
// element at a time), so three slabs are in flight while one is summed.  The
// sum runs on the tensor cores, which the CUDA cores could not match here on
// the few SMs of one cluster: each warp takes 8-row steps of the slab into
// the whole (C, C) gW with m16n8k8 TF32 products, exact for bf16 inputs and
// 3xTF32 for f32 (hi/lo operand halves, a_lo b_hi + a_hi b_lo + a_hi b_hi).
// The warps' sums are added in warp order through shared memory; after a
// cluster barrier, each block of the cluster sums its slice of the (C, C)
// entries over the cluster's blocks in rank order, reading their shared
// memory (distributed shared memory).  One cluster writes gW; several write a
// partial each, which reduce_partials_kernel adds in cluster order.
//
// At other widths, and for a base that is not 16-byte aligned
// (conv1x1_gw_kernel): block k owns a fixed chunk of rows and writes its
// (C, C) partial sum to partial[k]; reduce_partials_kernel then sums each entry
// over the chunks, one warp per entry, in a fixed order.  The caller picks
// the number of chunks so the partials stay under a quarter of the inputs'
// bytes, and each thread keeps a 4x4 tile of gW in registers over a strided
// subset of the chunk's rows; the row groups are added in a fixed order.

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


// Tile t of a warp: rows [t*R, t*R + R) of x, contiguous in memory, copied
// into buf (a ragged last tile's bytes past the last 16 one element at a time)
template <typename T, int C, int R>
__device__ __forceinline__ void mm_issue(const T* __restrict__ x, long long N, long long t,
                                         unsigned char* buf, int lane) {
  const long long r0 = t * R;
  stage_elems<T>(buf, x + r0 * C, (int)min((long long)R, N - r0) * C, lane, 32);
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
    store_elems<T>(y + r0 * C, cur, rows * C, lane, 32);
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
    // STREAM_PLAN in kernels/common.py
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

constexpr int kGwStages = 4;  // the cluster kernel's ring: slabs in flight + 1

// kept equal to gw_cluster_smem_bytes() in kernels/conv1x1/conv1x1.py: the
// ring (kGwStages x (x slab | gy slab)), which the warps' sums then reuse;
// the block's sum of its XW x C entries; the inbox of its slice of them from
// each block of its cluster
__host__ __device__ constexpr int gw_ring_bytes(int C, int XW, int slab_rows, int elem_size) {
  return kGwStages * slab_rows * (XW + C) * elem_size > 4 * kWarps * XW * C
             ? kGwStages * slab_rows * (XW + C) * elem_size
             : 4 * kWarps * XW * C;
}
size_t gw_cluster_smem_bytes(int C, int XW, int slab_rows, int elem_size, int cl) {
  return (size_t)gw_ring_bytes(C, XW, slab_rows, elem_size) +
         sizeof(float) * (XW * C + cl * cluster_slice(XW * C, cl));
}

// Grid: slices x clusters x cl blocks, blockIdx = (slice * clusters +
// cluster) * cl + rank.  Slice z takes gW's rows [z XW, (z+1) XW) (x's
// columns); row block cluster * cl + rank takes rows [that * cta_rows, + cta_rows)
// of x and gy, slab_rows (a multiple of 8) at a time through a kGwStages
// ring.  Warp w takes the slab's 16-row steps w, w + 8, ... into the slice's
// (XW, C) block of gW, as two sums of 8 rows: m16n8k8 tensor-core products, A = x^T and B = gy.
// bf16 values are TF32 values, so one product is exact; f32 splits each
// operand into a TF32 hi and lo and adds a_lo b_hi + a_hi b_lo + a_hi b_hi
// (3xTF32, 2^-22 of each term dropped).  The warps' sums are added in warp
// order; then each block pushes its rank-o slice of them into block o's
// inbox (distributed shared memory), and after one cluster barrier each block
// sums its inbox in rank order.  out: gW (one cluster a slice) or one (C, C)
// partial per cluster.
template <typename T, int C, int XW>
__global__ void __launch_bounds__(kThreads)
conv1x1_gw_cluster_kernel(const T* __restrict__ x, const T* __restrict__ gy,
                          float* __restrict__ out, long long N, long long cta_rows,
                          int slab_rows, int clusters) {
  constexpr int MT = (XW + 15) / 16, NT = (C + 7) / 8;  // the slice's 16 x 8 tiles
  constexpr int E = XW * C;                             // entries of a slice
  constexpr bool kSplit = sizeof(T) == 4;
  extern __shared__ __align__(16) unsigned char gsm[];
  const int cl = (int)cooperative_groups::this_cluster().num_blocks();
  const int rank = (int)cooperative_groups::this_cluster().block_rank();
  const int xbytes = slab_rows * XW * (int)sizeof(T), gbytes = slab_rows * C * (int)sizeof(T);
  float* red = reinterpret_cast<float*>(gsm);  // kWarps x E, over the ring
  float* part = reinterpret_cast<float*>(gsm + gw_ring_bytes(C, XW, slab_rows, sizeof(T)));
  float* inbox = part + E;  // cl x cluster_slice(E, cl)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int cid = blockIdx.x / cl, slice = cid / clusters, rc = cid % clusters;
  const int i0 = slice * XW, w = min(XW, C - i0);  // x's columns of this slice
  const long long r0 = min(((long long)rc * cl + rank) * cta_rows, N);
  const long long r1 = min(r0 + cta_rows, N);
  const int n_slabs = (int)((r1 - r0 + slab_rows - 1) / slab_rows);

  auto issue = [&](int sl) {  // slab sl into stage sl % kGwStages: x's slice, then gy
    const long long s0 = r0 + (long long)sl * slab_rows;
    const int rows = (int)min((long long)slab_rows, r1 - s0);
    unsigned char* dst = gsm + (sl % kGwStages) * (xbytes + gbytes);
    if constexpr (XW == C) {
      stage_elems<T>(dst, x + s0 * C, rows * C, tid, kThreads);
    } else {  // rows of XW values, whole 16-byte pieces (the plan's widths)
      constexpr int kPieces = XW * (int)sizeof(T) / 16;
      for (int c = tid; c < rows * kPieces; c += kThreads) {
        const int r = c / kPieces, q = c % kPieces;
        cp_async16(dst + r * XW * (int)sizeof(T) + 16 * q,
                   reinterpret_cast<const unsigned char*>(x + (s0 + r) * C + i0) + 16 * q);
      }
    }
    stage_elems<T>(dst + xbytes, gy + s0 * C, rows * C, tid, kThreads);
  };

  // two sums, of the even and the odd 8-row steps of the warp, so that two
  // steps' products are in flight; added in that order at the end
  float acc[2][MT][NT][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[h][mi][ni][c] = 0.f;
#pragma unroll
  for (int sl = 0; sl < kGwStages - 1; ++sl) {
    if (sl < n_slabs) issue(sl);
    cp_async_commit();
  }
  for (int sl = 0; sl < n_slabs; ++sl) {
    cp_async_wait<kGwStages - 2>();
    __syncthreads();  // slab sl has landed; slab sl - 1 is no longer read
    if (sl + kGwStages - 1 < n_slabs) issue(sl + kGwStages - 1);
    cp_async_commit();
    const unsigned char* xs = gsm + (sl % kGwStages) * (xbytes + gbytes);
    const unsigned char* gs = xs + xbytes;
    const int rows = (int)min((long long)slab_rows, r1 - r0 - (long long)sl * slab_rows);
    for (int k00 = warp * 16; k00 < rows; k00 += kWarps * 16) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k0 = k00 + 8 * h;  // past the slab's rows its values read 0
        float a[MT][4], b[NT][2];
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          a[mi][0] = slab_at<T, XW>(xs, k0 + t, mi * 16 + g, rows, w);
          a[mi][1] = slab_at<T, XW>(xs, k0 + t, mi * 16 + g + 8, rows, w);
          a[mi][2] = slab_at<T, XW>(xs, k0 + t + 4, mi * 16 + g, rows, w);
          a[mi][3] = slab_at<T, XW>(xs, k0 + t + 4, mi * 16 + g + 8, rows, w);
        }
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) {
          b[ni][0] = slab_at<T, C>(gs, k0 + t, ni * 8 + g, rows, C);
          b[ni][1] = slab_at<T, C>(gs, k0 + t + 4, ni * 8 + g, rows, C);
        }
        uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32<kSplit>(a[mi][e], ah[mi][e], al[mi][e]);
#pragma unroll
        for (int ni = 0; ni < NT; ++ni)
#pragma unroll
          for (int e = 0; e < 2; ++e) split_tf32<kSplit>(b[ni][e], bh[ni][e], bl[ni][e]);
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int ni = 0; ni < NT; ++ni)
            mma_3xtf32<kSplit, kSplit>(acc[h][mi][ni], ah[mi], al[mi], bh[ni], bl[ni]);
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();  // the ring is no longer read: the warps' sums go over it

#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = mi * 16 + g + (c >= 2 ? 8 : 0), j = ni * 8 + 2 * t + (c & 1);
        if (i < w && j < C) red[warp * E + i * C + j] = acc[0][mi][ni][c] + acc[1][mi][ni][c];
      }
  __syncthreads();
  // the warps in order, then over the cluster in rank order
  cluster_sum(
      w * C,
      [&](int e) {
        float s = 0.f;
        for (int q = 0; q < kWarps; ++q) s += red[q * E + e];
        return s;
      },
      inbox, out + (long long)(clusters == 1 ? 0 : rc) * C * C + (long long)i0 * C);
}

template <typename T, int C, int XW>
cudaError_t launch_gw_cluster(const void* x, const void* gy, float* out, long long N,
                              long long cta_rows, int slab_rows, int clusters, int cl,
                              cudaStream_t s) {
  return launch_clustered(conv1x1_gw_cluster_kernel<T, C, XW>, C / XW * clusters * cl, kThreads,
                          gw_cluster_smem_bytes(C, XW, slab_rows, sizeof(T), cl), cl, s,
                          static_cast<const T*>(x), static_cast<const T*>(gy), out, N, cta_rows,
                          slab_rows, clusters);
}

template <typename T>
cudaError_t launch_gw_cluster_c(const void* x, const void* gy, float* out, long long N, int C,
                                int xw, long long cta_rows, int slab_rows, int clusters, int cl,
                                cudaStream_t s) {
  // (C, slice width): kept equal to GW_PLAN in kernels/conv1x1/conv1x1.py
  if (C == 12 && xw == 12)
    return launch_gw_cluster<T, 12, 12>(x, gy, out, N, cta_rows, slab_rows, clusters, cl, s);
  if (C == 24 && xw == 24)
    return launch_gw_cluster<T, 24, 24>(x, gy, out, N, cta_rows, slab_rows, clusters, cl, s);
  if (C == 48 && xw == 16)
    return launch_gw_cluster<T, 48, 16>(x, gy, out, N, cta_rows, slab_rows, clusters, cl, s);
  return cudaErrorInvalidValue;
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
  return static_cast<int>(launch_reduce_partials(partial, gw, n_chunks, C * C, s));
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

// The cluster path: C in {12, 24, 48}, x and gy 16-byte aligned (the caller
// checks).  C / xw slices of gW's rows, each clusters x cluster_size blocks
// of cta_rows rows (a multiple of 8), slab_rows (a multiple of 8) staged at a
// time; partial: (clusters, C*C) float32 scratch, unused (may be null) for
// one cluster a slice; gw: (C, C) float32.  Returns the cudaError_t of the
// launches.
int conv1x1_gw_cluster(int dtype, const void* x, const void* gy, float* partial, float* gw,
                       long long N, int C, int xw, long long cta_rows, int slab_rows,
                       int clusters, int cluster_size, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = clusters == 1 ? gw : partial;
  if (dtype == 0) {
    err = launch_gw_cluster_c<float>(x, gy, out, N, C, xw, cta_rows, slab_rows, clusters,
                                     cluster_size, s);
  } else if (dtype == 1) {
    err = launch_gw_cluster_c<__nv_bfloat16>(x, gy, out, N, C, xw, cta_rows, slab_rows,
                                             clusters, cluster_size, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess || clusters == 1) return static_cast<int>(err);
  return static_cast<int>(launch_reduce_partials(partial, gw, clusters, C * C, s));
}

}  // extern "C"
