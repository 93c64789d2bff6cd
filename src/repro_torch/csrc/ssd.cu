// Mamba2 chunked SSD scan for Hopper (sm_90a), as chunk-parallel passes.
//
// ssd_scan (five kernels, one call) replaces the Pallas kernel
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
// What bounds it.  The function needs, per (batch, head, chunk), C state^T
// and the state update (2 c N P each) and (G * decay) (x dt) over the
// c (c + 1) / 2 causal pairs (P c (c + 1)); G = C B^T itself is the same for
// every head (one B/C group), N c (c + 1) per (batch, chunk).  At zamba2-7b's
// prefill, (8, 112, 2048, 64), N 64, chunk 256: 60.5 GFLOP against 0.99 GB of
// x, y, da, dt, B, C and the states: 0.90 ms at the CUDA cores' f32 rate, so
// the products go to the tensor cores, where the bytes bound it (0.30 ms at
// 3.35 TB/s against 0.12 ms at the TF32 rate).  The reference computes in f32
// and holds its kernel to 2e-4, which single-pass TF32's 10-bit mantissa does
// not keep over N = 64 terms; 3xTF32 does (tests/test_torch_ssd_passes.py
// emulates both).  A kernel that walks the chunks of one (batch, head) in
// order (the TPU kernel's grid) keeps 896 blocks busy on 8 serial steps each,
// stages every operand synchronously and recomputes C B^T for each of the
// 112 heads; this design removes all three.
//
// Design: SSD's chunked decomposition (Mamba2, arXiv:2405.21060, sections
// 6-7) as five launches, each parallel over chunks:
//   1. ssd_prep_kernel, per (32 heads, chunk, batch): cum (summed in f64 in a
//      fixed order, read across heads, where the model's (B, S, H) layout is
//      contiguous, and kept as an f32 high and low part) and dt, written
//      time-contiguous per (batch, head), and whether the chunk's cum never
//      rises; and per (64-row tile, chunk, batch): B and C as f32 tiles
//      zero-padded to 64 rows and columns, B both ways (B and B^T) and C
//      transposed, so that every later operand is a 16-byte copy.
//   2. ssd_cb_kernel, per (tile pair, chunk, batch): G^T = B C^T for the 64 x
//      64 tile pairs at or below the diagonal, once per (batch, chunk), for
//      all heads (10 pairs at chunk 256: 10.5 MB at zamba2-7b's shape, read
//      from L2 by the 112 heads).
//   3. ssd_state_kernel, per (head, chunk, batch): the chunk's own state,
//      sum_s (B_s exp(cum_end - cum_s) dt_s) (x) x_s, into a (64, 64) f32
//      scratch slot per (batch, head, chunk).
//   4. ssd_pass_kernel, per (head, batch): the carry in chunk order, state_k
//      = state_{k-1} exp(cum_end) + local_k from state0 or zeros; each slot
//      is overwritten with the state entering its chunk, and the last one is
//      the final state.
//   5. ssd_out_kernel, per (64-row tile, head, chunk, batch), heaviest tile
//      first: the carried term (C state_in^T) exp(cum_t), then for each
//      source tile at or below the diagonal G' = G * exp(cum_t - cum_s) dt_s,
//      taken only where t >= s (never exp(positive) * 0), and y += G' x.
//      Below the diagonal of a chunk whose cum never rises (Mamba2's
//      da = dt A, A < 0) the decay is a column factor times a row factor,
//      both in [0, 1]; elsewhere it is taken per element.
// Passes 2, 3 and 5 run one product: 128 threads, four warps of a 32 x 32
// block of a 64 x 64 output, m16n8k8 TF32 mma.sync in 3xTF32 (each operand
// a TF32 hi and lo, a_lo b_hi + a_hi b_lo + a_hi b_hi), over shared tiles
// stored with the reduction axis first, rows 72 floats apart so that the
// fragment loads hit 32 banks; the next operand pair lands by cp.async while
// the current one computes (a 2-stage ring, three blocks an SM).  On the
// diagonal a warp's reduction stops at its last row.  Every decay takes
// (cum_t - cum_s) + (cuml_t - cuml_s): cum reaches -233 within a chunk at the
// reference's test decays, where one f32 would carry 1e-5 into the decay of
// every pair of close steps.  Padded rows are zero, so P, N < 64 and any
// chunk length work.  No atomics, and every sum runs in a fixed order:
// bitwise repeatable.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kL = 64;             // tile rows and columns; P and N are at most kL
constexpr int kTileF = kL * kL;    // floats of a scratch tile (row stride kL)
constexpr int kLD = kL + 8;        // row stride of a shared tile: fragment loads hit 32 banks
constexpr int kTileS = kL * kLD;   // floats of a shared tile
constexpr int kPT = 128;           // threads of a product block: 4 warps of 32 x 32
constexpr int kStageF = 2 * kTileS + 3 * kL;  // a stage: A tile | B tile | three row vectors

// acc += sum_{k < kend} a[k][m] b[k][n] over the warp's 32 x 32 block (rows
// wm*32.., columns wn*32..) of a 64 x 64 output, two shared tiles stored with
// the reduction axis first (row stride kLD); kend a multiple of 8.  3xTF32:
// each operand splits into a TF32 hi and lo, and a b = a_lo b_hi + a_hi b_lo +
// a_hi b_hi, which drops only a_lo b_lo (2^-22 of a b).  acc[mi][ni][c] is
// row wm*32 + mi*16 + lane/4 (+8 for c >= 2), column wn*32 + ni*8 +
// 2 (lane % 4) + c % 2.
__device__ __forceinline__ void tile_mma_3xtf32(float (&acc)[2][4][4], const float* __restrict__ a,
                                           const float* __restrict__ b, int kend, int wm,
                                           int wn) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* ap = a + t * kLD + wm * 32 + g;
  const float* bp = b + t * kLD + wn * 32 + g;
  for (int k0 = 0; k0 < kend; k0 += 8) {
    const float* ak = ap + k0 * kLD;
    const float* bk = bp + k0 * kLD;
    uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      split_tf32<true>(ak[mi * 16], ah[mi][0], al[mi][0]);
      split_tf32<true>(ak[mi * 16 + 8], ah[mi][1], al[mi][1]);
      split_tf32<true>(ak[4 * kLD + mi * 16], ah[mi][2], al[mi][2]);
      split_tf32<true>(ak[4 * kLD + mi * 16 + 8], ah[mi][3], al[mi][3]);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      split_tf32<true>(bk[ni * 8], bh[ni][0], bl[ni][0]);
      split_tf32<true>(bk[4 * kLD + ni * 8], bh[ni][1], bl[ni][1]);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        mma_3xtf32<true, true>(acc[mi][ni], ah[mi], al[mi], bh[ni], bl[ni]);
      }
  }
}

// The output row and column of acc[mi][ni][c] (tile_mma_3xtf32's layout)
__device__ __forceinline__ int acc_row(int wm, int mi, int c) {
  return wm * 32 + mi * 16 + ((threadIdx.x & 31) >> 2) + (c >= 2 ? 8 : 0);
}
__device__ __forceinline__ int acc_col(int wn, int ni, int c) {
  return wn * 32 + ni * 8 + 2 * (threadIdx.x & 3) + (c & 1);
}

// acc as a 64 x 64 tile, row stride kL, two columns at a time
__device__ __forceinline__ void store_acc(float* __restrict__ out, const float (&acc)[2][4][4],
                                          int wm, int wn) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int c = 0; c < 4; c += 2)
        *reinterpret_cast<float2*>(out + acc_row(wm, mi, c) * kL + acc_col(wn, ni, c)) =
            make_float2(acc[mi][ni][c], acc[mi][ni][c + 1]);
}

__device__ __forceinline__ int round8(int n) { return (n + 7) & ~7; }

// A 64 x 64 tile of a padded f32 scratch array (rows ld floats apart, 16-byte
// aligned) into the shared tile dst
__device__ __forceinline__ void issue_tile(float* dst, const float* src, long long ld) {
  for (int i = threadIdx.x; i < kTileF / 4; i += kPT) {
    const int r = i >> 4, c = (i & 15) * 4;
    cp_async16(dst + r * kLD + c, src + r * ld + c);
  }
}

// n floats (any alignment) into dst, zeros from n to kL
__device__ __forceinline__ void issue_vec(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < kL; i += kPT) {
    if (i < n) cp_async4(dst + i, src + i);
    else dst[i] = 0.f;
  }
}

// Rows [0, ns) of x (P values each, rows x_ss elements apart): f32 straight
// into the shared tile dst, rows [ns, kL) zeroed; bf16 into the staging tile
// stage (row stride kL; convert_x finishes it).  vec16: every row start and P values are whole
// 16-byte pieces.
template <typename T>
__device__ __forceinline__ void issue_x(float* dst, T* stage, const T* __restrict__ src,
                                        long long x_ss, int ns, int P, bool vec16) {
  constexpr int kPer16 = 16 / (int)sizeof(T);  // values of a 16-byte piece
  constexpr int kPieces = kL / kPer16;          // pieces of a 64-wide row
  if (vec16) {
    for (int i = threadIdx.x; i < kL * kPieces; i += kPT) {
      const int r = i / kPieces, c = (i % kPieces) * kPer16;
      if (r >= ns || c >= P) continue;
      if constexpr (sizeof(T) == 4) cp_async16(dst + r * kLD + c, src + r * x_ss + c);
      else cp_async16(stage + r * kL + c, src + r * x_ss + c);
    }
  } else {
    for (int i = threadIdx.x; i < ns * P; i += kPT) {
      const int r = i / P, c = i - r * P;
      if constexpr (sizeof(T) == 4) cp_async4(dst + r * kLD + c, src + r * x_ss + c);
      else stage[r * kL + c] = src[r * x_ss + c];
    }
  }
  if constexpr (sizeof(T) == 4)
    for (int i = threadIdx.x; i < (kL - ns) * kL; i += kPT) dst[(ns + i / kL) * kLD + i % kL] = 0.f;
}

// bf16: the staged rows [0, ns) as f32 into dst, zeros elsewhere (after the
// copies have landed); f32: nothing
template <typename T>
__device__ __forceinline__ void convert_x(float* dst, const T* stage, int ns, int P) {
  if constexpr (sizeof(T) == 2) {
    for (int i = threadIdx.x; i < kTileF; i += kPT) {
      const int r = i >> 6, c = i & (kL - 1);
      dst[r * kLD + c] = r < ns && c < P ? __bfloat162float(stage[i]) : 0.f;
    }
  }
}

// 1. Blocks [0, B K G), G = ceil(H / 32): heads g*32 .. +31 of chunk k of
// batch b.  The chunk's cumulative sum da[t0] + ... + da[t0 + t], in f64, as
// an f32 pair cum + cuml (its high part and the rest), and dts = dt, each
// [b][h][t0 + t], time-contiguous: lane = head, so the model's (B, S, H)
// layout reads coalesced; warp w takes steps [w seg, (w+1) seg) of the chunk,
// first its total, then its prefix from the earlier warps' totals (in warp
// order), written 32 steps at a time through a transposing buffer.  A decay
// exp(cum_t - cum_s) then takes (cum_t - cum_s) + (cuml_t - cuml_s): cum
// reaches -233 within a chunk of 256 at the card tests' decays, where one f32
// would carry an error of 1e-5 into every decay between close steps.
// falls[b][h][k] = 1 where no da of the chunk is positive (cum never rises).
// Blocks [B K G, + B K tiles): tile u of chunk k of batch b: bp[s][n] =
// B[s][n], bt[n][s] = B[s][n] and ct[n][t] = C[t][n] in f32, zero past the
// chunk's c rows and N columns, as (cp, kL) and (kL, cp) slabs per (batch,
// chunk).
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_prep_kernel(const float* __restrict__ da, const float* __restrict__ dt,
                const T* __restrict__ bm, const T* __restrict__ cm, float* __restrict__ cum,
                float* __restrict__ cuml, float* __restrict__ dts, float* __restrict__ bp,
                float* __restrict__ bt,
                float* __restrict__ ct, float* __restrict__ falls, int B, int H, int S, int N,
                int chunk, int cp,
                long long da_sb, long long da_sh, long long da_ss, long long dt_sb,
                long long dt_sh, long long dt_ss, long long b_sb, long long b_ss, long long c_sb,
                long long c_ss) {
  __shared__ float buf[kWarps * 32 * 33];
  __shared__ double totals[kWarps][32];
  __shared__ int rises[kWarps][32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = S / chunk, G = (H + 31) / 32;
  const int n_cum = B * K * G;
  if ((int)blockIdx.x < n_cum) {
    const int g = blockIdx.x % G, k = (blockIdx.x / G) % K, b = blockIdx.x / (G * K);
    const int t0 = k * chunk, g0 = g * 32;
    const int h = min(g0 + lane, H - 1);
    const float* dap = da + b * da_sb + h * da_sh + t0 * da_ss;
    const float* dtp = dt + b * dt_sb + h * dt_sh + t0 * dt_ss;
    const int seg = (chunk + kWarps - 1) / kWarps;
    const int a = min(chunk, warp * seg), e = min(chunk, a + seg);
    double tot = 0.0;
    int rise = 0;
    for (int p0 = a; p0 < e; p0 += 32) {
      float va[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) va[i] = p0 + i < e ? dap[(p0 + i) * da_ss] : 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i) tot += va[i], rise |= va[i] > 0.f;
    }
    totals[warp][lane] = tot;
    rises[warp][lane] = rise;
    __syncthreads();
    double run = 0.0;
    for (int w = 0; w < warp; ++w) run += totals[w][lane];
    if (warp == 0 && g0 + lane < H) {
      for (int w = 1; w < kWarps; ++w) rise |= rises[w][lane];
      falls[((long long)b * H + g0 + lane) * K + k] = rise ? 0.f : 1.f;
    }
    float* wb = buf + warp * 32 * 33;
    for (int p0 = a; p0 < e; p0 += 32) {
      const int n = min(32, e - p0);
      float va[32], vt[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        va[i] = i < n ? dap[(p0 + i) * da_ss] : 0.f;
        vt[i] = i < n ? dtp[(p0 + i) * dt_ss] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        run += va[i];
        const float hi = (float)run;
        wb[lane * 33 + i] = hi;
        va[i] = (float)(run - (double)hi);  // cum's low part
      }
      __syncwarp();
      for (int j = 0; j < 32 && g0 + j < H; ++j)
        if (lane < n) cum[((long long)b * H + g0 + j) * S + t0 + p0 + lane] = wb[j * 33 + lane];
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 32; ++i) wb[lane * 33 + i] = va[i];
      __syncwarp();
      for (int j = 0; j < 32 && g0 + j < H; ++j)
        if (lane < n) cuml[((long long)b * H + g0 + j) * S + t0 + p0 + lane] = wb[j * 33 + lane];
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 32; ++i) wb[lane * 33 + i] = vt[i];
      __syncwarp();
      for (int j = 0; j < 32 && g0 + j < H; ++j)
        if (lane < n) dts[((long long)b * H + g0 + j) * S + t0 + p0 + lane] = wb[j * 33 + lane];
      __syncwarp();
    }
    return;
  }
  const int tiles = cp / kL, i = blockIdx.x - n_cum;
  const int u = i % tiles, k = (i / tiles) % K, b = i / (tiles * K);
  const int t0 = k * chunk;
  const long long slab = ((long long)b * K + k) * kL * cp;
  for (int which = 0; which < 2; ++which) {
    const T* src = which == 0 ? bm + b * b_sb : cm + b * c_sb;
    const long long ss = which == 0 ? b_ss : c_ss;
    for (int j = tid; j < kTileF; j += kThreads) {
      const int r = j >> 6, n = j & (kL - 1), s = u * kL + r;
      const float v = s < chunk && n < N ? load_f(src, (long long)(t0 + s) * ss + n) : 0.f;
      if (which == 0) bp[slab + (long long)s * kL + n] = v;
      buf[r * (kL + 1) + n] = v;
    }
    __syncthreads();
    float* dstT = which == 0 ? bt : ct;
    for (int j = tid; j < kTileF; j += kThreads) {
      const int n = j >> 6, r = j & (kL - 1);
      dstT[slab + (long long)n * cp + u * kL + r] = buf[r * (kL + 1) + n];
    }
    __syncthreads();
  }
}

// 2. Block (pair, k, b): tile pair (r, q), q <= r, pair = r (r + 1) / 2 + q,
// of chunk k of batch b: g0t[s][t] = sum_n B[q*64 + s][n] C[r*64 + t][n].
__global__ void __launch_bounds__(kPT)
ssd_cb_kernel(const float* __restrict__ bt, const float* __restrict__ ct, float* __restrict__ g0t,
              int N, int cp, int pairs) {
  __shared__ __align__(16) float tiles[2 * kTileS];
  const int pair = blockIdx.x, k = blockIdx.y, b = blockIdx.z, K = gridDim.y;
  int r = 0;
  while ((r + 1) * (r + 2) / 2 <= pair) ++r;
  const int q = pair - r * (r + 1) / 2;
  const long long slab = ((long long)b * K + k) * kL * cp;
  issue_tile(tiles, bt + slab + q * kL, cp);
  issue_tile(tiles + kTileS, ct + slab + r * kL, cp);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  const int wm = threadIdx.x >> 6, wn = (threadIdx.x >> 5) & 1;
  float acc[2][4][4] = {};
  tile_mma_3xtf32(acc, tiles, tiles + kTileS, round8(N), wm, wn);
  store_acc(g0t + (((long long)b * K + k) * pairs + pair) * kTileF, acc, wm, wn);
}

// 3. Block (h, k, b) (h fastest): the state chunk k of (b, h) adds,
// local[n][p] = sum_s (B[s][n] exp(cum_end - cum_s) dt_s) x[s][p], into
// states[b][h][k] (64 x 64, n-major).  Shared memory: 2 stages of (B tile |
// x tile | cum_s | dt_s), then (bf16) 2 staging tiles of x.
template <typename T>
__global__ void __launch_bounds__(kPT)
ssd_state_kernel(const T* __restrict__ x, const float* __restrict__ cum,
                 const float* __restrict__ cuml, const float* __restrict__ dts, const float* __restrict__ bp,
                 float* __restrict__ states, int H, int S, int P, int chunk, int cp, int K,
                 long long x_sb, long long x_sh, long long x_ss, int vec16) {
  extern __shared__ __align__(16) float smem[];
  T* stage = reinterpret_cast<T*>(smem + 2 * kStageF);
  const int h = blockIdx.x % H, k = (blockIdx.x / H) % K, b = blockIdx.x / (H * K);
  const int t0 = k * chunk, tiles = cp / kL;
  const float* cumb = cum + ((long long)b * H + h) * S + t0;
  const float* cumlb = cuml + ((long long)b * H + h) * S + t0;
  const float* dtb = dts + ((long long)b * H + h) * S + t0;
  const T* xb = x + b * x_sb + h * x_sh + t0 * x_ss;
  const float* bpb = bp + ((long long)b * K + k) * cp * kL;
  const float cum_end = cumb[chunk - 1], cuml_end = cumlb[chunk - 1];
  const int wm = threadIdx.x >> 6, wn = (threadIdx.x >> 5) & 1;

  auto issue = [&](int u) {
    float* st = smem + (u & 1) * kStageF;
    const int ns = min(kL, chunk - u * kL);
    issue_tile(st, bpb + u * kL * kL, kL);
    issue_x<T>(st + kTileS, stage + (u & 1) * kTileF, xb + u * kL * x_ss, x_ss, ns, P, vec16);
    issue_vec(st + 2 * kTileS, cumb + u * kL, ns);
    issue_vec(st + 2 * kTileS + kL, dtb + u * kL, ns);
    issue_vec(st + 2 * kTileS + 2 * kL, cumlb + u * kL, ns);
  };

  float acc[2][4][4] = {};
  issue(0);
  cp_async_commit();
  for (int u = 0; u < tiles; ++u) {
    float* st = smem + (u & 1) * kStageF;
    const int ns = min(kL, chunk - u * kL);
    cp_async_wait_all();
    __syncthreads();  // tile u has landed; tile u - 1 is no longer read
    if (u + 1 < tiles) issue(u + 1);
    cp_async_commit();
    // B's rows times exp(cum_end - cum_s) dt_s (cs: cum | dt | cuml of the
    // tile's rows): thread rows s = tid/16 + 8m,
    // columns (tid % 16)*4 .. +3
    const float* cs = st + 2 * kTileS;
#pragma unroll
    for (int m = 0; m < kL / 8; ++m) {
      const int s = (threadIdx.x >> 4) + 8 * m;
      const float f =
          s < ns ? expf((cum_end - cs[s]) + (cuml_end - cs[2 * kL + s])) * cs[kL + s] : 0.f;
      float4* v = reinterpret_cast<float4*>(st + s * kLD + (threadIdx.x & 15) * 4);
      const float4 o = *v;
      *v = make_float4(o.x * f, o.y * f, o.z * f, o.w * f);
    }
    convert_x<T>(st + kTileS, stage + (u & 1) * kTileF, ns, P);
    __syncthreads();
    tile_mma_3xtf32(acc, st, st + kTileS, round8(ns), wm, wn);
  }
  store_acc(states + (((long long)b * H + h) * K + k) * kTileF, acc, wm, wn);
}

// 4. Block (h, b): the carry over the chunks of (b, h) in order.  Thread tid
// keeps entries tid*4 + 1024 j .. + 3 (j < 4) of the n-major state; state0
// and the final state, (P, N) p-major, go through a transposing tile.
__global__ void __launch_bounds__(kThreads)
ssd_pass_kernel(const float* __restrict__ cum, const float* __restrict__ state0,
                float* __restrict__ states, float* __restrict__ state, int H, int S, int P,
                int N, int chunk, int K) {
  __shared__ float tr[kL * (kL + 1)];  // tr[p][n]
  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const long long bh = (long long)b * H + h;
  for (int i = threadIdx.x; i < kL * (kL + 1); i += kThreads) tr[i] = 0.f;
  __syncthreads();
  if (state0 != nullptr)
    for (int i = threadIdx.x; i < P * N; i += kThreads)
      tr[(i / N) * (kL + 1) + i % N] = state0[bh * P * N + i];
  __syncthreads();
  float4 s[4], loc[4];
  float4* slots = reinterpret_cast<float4*>(states + bh * K * kTileF);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int i0 = threadIdx.x * 4 + 1024 * j;
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = tr[((i0 + e) & (kL - 1)) * (kL + 1) + ((i0 + e) >> 6)];
    s[j] = make_float4(v[0], v[1], v[2], v[3]);
    loc[j] = slots[threadIdx.x + 256 * j];
  }
  for (int k = 0; k < K; ++k) {
    const float dec = expf(cum[bh * S + k * chunk + chunk - 1]);
    float4 nxt[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      nxt[j] = k + 1 < K ? slots[(k + 1) * (kTileF / 4) + threadIdx.x + 256 * j] : loc[j];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      slots[k * (kTileF / 4) + threadIdx.x + 256 * j] = s[j];  // the state entering chunk k
      s[j] = make_float4(fmaf(s[j].x, dec, loc[j].x), fmaf(s[j].y, dec, loc[j].y),
                         fmaf(s[j].z, dec, loc[j].z), fmaf(s[j].w, dec, loc[j].w));
      loc[j] = nxt[j];
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int i0 = threadIdx.x * 4 + 1024 * j;
    const float v[4] = {s[j].x, s[j].y, s[j].z, s[j].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) tr[((i0 + e) & (kL - 1)) * (kL + 1) + ((i0 + e) >> 6)] = v[e];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < P * N; i += kThreads)
    state[bh * P * N + i] = tr[(i / N) * (kL + 1) + i % N];
}

// 5. Block (r', h, k, b) (r' fastest): row tile r = tiles - 1 - r' of chunk k
// of (b, h).  Stage 0: C^T tile r and the state entering chunk k; stage
// 1 + q: G^T pair (r, q) and x tile q, with cum_s and dt_s.  Shared memory:
// 2 stages, cum of the rows, then (bf16) 2 staging tiles of x.
template <typename T>
__global__ void __launch_bounds__(kPT)
ssd_out_kernel(const T* __restrict__ x, const float* __restrict__ cum,
               const float* __restrict__ cuml, const float* __restrict__ dts, const float* __restrict__ ct,
               const float* __restrict__ g0t, const float* __restrict__ states,
               const float* __restrict__ falls, T* __restrict__ y, int H, int S, int P, int N,
               int chunk, int cp, int K,
               int pairs, long long x_sb, long long x_sh, long long x_ss, long long y_sb,
               long long y_sh, long long y_ss, int vec16) {
  extern __shared__ __align__(16) float smem[];
  float* crow = smem + 2 * kStageF;  // cum | cuml of the rows
  T* stage = reinterpret_cast<T*>(crow + 2 * kL);
  const int tiles = cp / kL;
  int idx = blockIdx.x;
  const int r = tiles - 1 - idx % tiles;
  idx /= tiles;
  const int h = idx % H;
  idx /= H;
  const int k = idx % K, b = idx / K;
  const int t0 = k * chunk, nr = min(kL, chunk - r * kL);
  const long long bh = (long long)b * H + h;
  const float* cumb = cum + bh * S + t0;
  const float* cumlb = cuml + bh * S + t0;
  const float* dtb = dts + bh * S + t0;
  const T* xb = x + b * x_sb + h * x_sh + t0 * x_ss;
  const long long bk = (long long)b * K + k;
  const int wm = threadIdx.x >> 6, wn = (threadIdx.x >> 5) & 1;
  const bool falling = falls[bh * K + k] != 0.f;

  auto issue = [&](int j) {
    float* st = smem + (j & 1) * kStageF;
    if (j == 0) {
      issue_tile(st, ct + bk * kL * cp + r * kL, cp);
      issue_tile(st + kTileS, states + (bh * K + k) * kTileF, kL);
      issue_vec(crow, cumb + r * kL, nr);
      issue_vec(crow + kL, cumlb + r * kL, nr);
    } else {
      const int q = j - 1, ns = min(kL, chunk - q * kL);
      issue_tile(st, g0t + (bk * pairs + r * (r + 1) / 2 + q) * kTileF, kL);
      issue_x<T>(st + kTileS, stage + (j & 1) * kTileF, xb + q * kL * x_ss, x_ss, ns, P, vec16);
      issue_vec(st + 2 * kTileS, cumb + q * kL, ns);
      issue_vec(st + 2 * kTileS + kL, dtb + q * kL, ns);
      issue_vec(st + 2 * kTileS + 2 * kL, cumlb + q * kL, ns);
    }
  };

  float acc[2][4][4] = {};
  const int n_stages = r + 2;
  issue(0);
  cp_async_commit();
  for (int j = 0; j < n_stages; ++j) {
    float* st = smem + (j & 1) * kStageF;
    cp_async_wait_all();
    __syncthreads();  // stage j has landed; stage j - 1 is no longer read
    if (j + 1 < n_stages) issue(j + 1);
    cp_async_commit();
    if (j == 0) {
      // the carried state: sum_n C[t][n] state[p][n], times exp(cum_t)
      tile_mma_3xtf32(acc, st, st + kTileS, round8(N), wm, wn);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int c = 0; c < 4; c += 2) {
          const int t = acc_row(wm, mi, c);
          const float e = t < nr ? expf(crow[t]) : 0.f;
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) acc[mi][ni][c] *= e, acc[mi][ni][c + 1] *= e;
        }
      continue;
    }
    const int q = j - 1, ns = min(kL, chunk - q * kL);
    const float* cs = st + 2 * kTileS;  // cum | dt | cuml of the source rows
    const float* ds = cs + kL;
    const float* csl = cs + 2 * kL;
    // G'[t][s] = G[t][s] exp(cum_t - cum_s) dt_s, only where t >= s: the
    // exponent may be positive above the diagonal.  Thread rows s = tid/16 +
    // 8m, columns t = (tid % 16)*4 .. +3.  Below the diagonal of a chunk
    // where cum never rises, exp(cum_t - cum_s) = exp(cum_t - cum_e)
    // exp(cum_e - cum_s) with e the source tile's last row, both factors in
    // [0, 1]: a factor per column and per row.  __expf: 2 ulp plus the
    // rounding of its argument times log2(e), ~3e-6 relative at |arg| <= 41
    {
      const int tc = (threadIdx.x & 15) * 4;
      const bool factored = falling && q < r;
      const float ce = cs[kL - 1], cel = csl[kL - 1];  // tiles below the diagonal's are whole
      float ct4[4], ctl4[4];
      bool row_ok[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        row_ok[e] = tc + e < nr;
        ct4[e] = crow[tc + e], ctl4[e] = crow[kL + tc + e];
        if (factored) ct4[e] = row_ok[e] ? __expf((ct4[e] - ce) + (ctl4[e] - cel)) : 0.f;
      }
#pragma unroll
      for (int m = 0; m < kL / 8; ++m) {
        const int s = (threadIdx.x >> 4) + 8 * m;
        float4* v = reinterpret_cast<float4*>(st + s * kLD + tc);
        const float4 o = *v;
        const float g[4] = {o.x, o.y, o.z, o.w};
        float out4[4];
        if (factored) {
          const float f = __expf((ce - cs[s]) + (cel - csl[s])) * ds[s];
#pragma unroll
          for (int e = 0; e < 4; ++e) out4[e] = g[e] * ct4[e] * f;
        } else {
          const float c_s = cs[s], cl_s = csl[s], d_s = ds[s];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool keep = row_ok[e] && s < ns && (q < r || tc + e >= s);
            out4[e] = keep ? g[e] * __expf((ct4[e] - c_s) + (ctl4[e] - cl_s)) * d_s : 0.f;
          }
        }
        *v = make_float4(out4[0], out4[1], out4[2], out4[3]);
      }
    }
    convert_x<T>(st + kTileS, stage + (j & 1) * kTileF, ns, P);
    __syncthreads();
    // on the diagonal, a warp's rows wm*32 .. +31 take sources up to its last row
    const int kend = q < r ? round8(ns) : min(round8(ns), wm * 32 + 32);
    tile_mma_3xtf32(acc, st, st + kTileS, kend, wm, wn);
  }

  // y two columns at a time where they are whole and aligned pairs
  T* yb = y + b * y_sb + h * y_sh + (long long)(t0 + r * kL) * y_ss;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int c = 0; c < 4; c += 2) {
        const int t = acc_row(wm, mi, c), p = acc_col(wn, ni, c);
        if (t >= nr || p >= P) continue;
        T* dst = yb + t * y_ss + p;
        if (p + 1 < P && reinterpret_cast<uintptr_t>(dst) % (2 * sizeof(T)) == 0) {
          if constexpr (sizeof(T) == 4)
            *reinterpret_cast<float2*>(dst) = make_float2(acc[mi][ni][c], acc[mi][ni][c + 1]);
          else
            *reinterpret_cast<__nv_bfloat162*>(dst) =
                __floats2bfloat162_rn(acc[mi][ni][c], acc[mi][ni][c + 1]);
        } else {
          store_f(dst, 0, acc[mi][ni][c]);
          if (p + 1 < P) store_f(dst, 1, acc[mi][ni][c + 1]);
        }
      }
}

// kept equal to ssd_smem_bytes() in kernels/ssd/ssd.py
size_t state_smem_bytes(int elem_size) {
  return sizeof(float) * 2 * kStageF + (elem_size == 2 ? 2 * kTileF * 2 : 0);
}
size_t out_smem_bytes(int elem_size) {
  return sizeof(float) * (2 * kStageF + 2 * kL) + (elem_size == 2 ? 2 * kTileF * 2 : 0);
}

template <typename T>
cudaError_t launch(const void* x, const float* da, const float* dt, const void* bm,
                   const void* cm, const float* state0, void* y, float* state, float* scratch,
                   int B, int H, int S, int P, int N, int chunk, const long long* st,
                   int vec16, cudaStream_t s) {
  const int K = S / chunk, cp = (chunk + kL - 1) / kL * kL, tiles = cp / kL;
  const int pairs = tiles * (tiles + 1) / 2;
  // scratch: cum | cuml | dts | bp | bt | ct | g0t | states | falls, each a
  // multiple of 64 floats (kept equal to ssd_scratch() in kernels/ssd/ssd.py)
  auto up = [](long long n) { return (n + 63) / 64 * 64; };
  float* cum = scratch;
  float* cuml = cum + up((long long)B * H * S);
  float* dts = cuml + up((long long)B * H * S);
  float* bp = dts + up((long long)B * H * S);
  float* bt = bp + (long long)B * K * cp * kL;
  float* ct = bt + (long long)B * K * cp * kL;
  float* g0t = ct + (long long)B * K * cp * kL;
  float* states = g0t + (long long)B * K * pairs * kTileF;
  float* falls = states + (long long)B * H * K * kTileF;
  const T* xt = static_cast<const T*>(x);

  const long long prep_blocks = (long long)B * K * ((H + 31) / 32 + tiles);
  ssd_prep_kernel<T><<<(unsigned)prep_blocks, kThreads, 0, s>>>(
      da, dt, static_cast<const T*>(bm), static_cast<const T*>(cm), cum, cuml, dts, bp, bt, ct,
      falls,
      B, H, S, N, chunk, cp, st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], st[12]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_cb_kernel<<<dim3(pairs, K, B), kPT, 0, s>>>(bt, ct, g0t, N, cp, pairs);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t smem_state = state_smem_bytes(sizeof(T));
  err = cudaFuncSetAttribute(ssd_state_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_state);
  if (err != cudaSuccess) return err;
  ssd_state_kernel<T><<<(unsigned)((long long)B * K * H), kPT, smem_state, s>>>(
      xt, cum, cuml, dts, bp, states, H, S, P, chunk, cp, K, st[0], st[1], st[2], vec16);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  ssd_pass_kernel<<<(unsigned)(B * H), kThreads, 0, s>>>(cum, state0, states, state, H, S, P, N,
                                                         chunk, K);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t smem_out = out_smem_bytes(sizeof(T));
  err = cudaFuncSetAttribute(ssd_out_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_out);
  if (err != cudaSuccess) return err;
  ssd_out_kernel<T><<<(unsigned)((long long)B * K * H * tiles), kPT, smem_out, s>>>(
      xt, cum, cuml, dts, ct, g0t, states, falls, static_cast<T*>(y), H, S, P, N, chunk, cp, K,
      pairs,
      st[0],
      st[1], st[2], st[13], st[14], st[15], vec16);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, b_in, c_in and y).  strides: 16
// element strides: x (batch, head, time), da (batch, head, time), dt (batch,
// head, time), b_in (batch, time), c_in (batch, time), y (batch, head, time);
// the last axis of x, b_in, c_in and y is contiguous.  state0 may be null
// (zeros).  scratch: ssd_scratch() floats, 16-byte aligned.  vec16: x's base,
// its strides and P values are whole 16-byte pieces.  Needs 1 <= P, N <= 64,
// S % chunk == 0 and chunk <= 4096 (the caller checks).  Runs five kernels;
// returns the cudaError_t of the first launch that fails.
int ssd_scan(int dtype, const void* x, const float* da, const float* dt, const void* b_in,
             const void* c_in, const float* state0, void* y, float* state, float* scratch,
             int B, int H, int S, int P, int N, int chunk, const long long* strides, int vec16,
             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    err = launch<float>(x, da, dt, b_in, c_in, state0, y, state, scratch, B, H, S, P, N, chunk,
                        strides, vec16, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(x, da, dt, b_in, c_in, state0, y, state, scratch, B, H, S, P, N,
                                chunk, strides, vec16, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

}  // extern "C"
