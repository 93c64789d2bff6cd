// Fused GLOW flow step for Hopper (sm_90a): actnorm -> 1x1 conv -> affine
// coupling, forward and inverse, on the (B, M, C) view.
//
// flowstep_fwd_kernel replaces the Pallas kernel
//   src/repro/kernels/flowstep/flowstep.py::flowstep_fwd (_fwd_kernel)
// flowstep_inv_kernel replaces
//   src/repro/kernels/flowstep/flowstep.py::flowstep_inv (_inv_kernel)
// spine_bwd_kernel (with reduce_partials_kernel) replaces
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
