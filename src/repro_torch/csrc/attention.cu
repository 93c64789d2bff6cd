// Flash attention forward for Hopper (sm_90a): grouped-query attention with
// an online softmax over key/value tiles.  Two kernels, one function:
//
// flash_attention_tc_kernel (bf16, head_dim a multiple of 16 up to 128),
// flash_attention_tf32_kernel (f32, head_dim a multiple of 8 up to 128, rows
// 16-byte aligned) and flash_attention_kernel (every other call) replace the
// Pallas kernel
//   src/repro/kernels/attention/attention.py::flash_attention (_flash_kernel)
//
//   o[b, h, q, :] = sum_k softmax_k(q[b,h,q,:] . k[b,h/g,k,:] * D^-1/2) v[b,h/g,k,:]
//
// q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), any strides over (b, h, s)
// with the D axis contiguous; o in q's storage type.  The KV head of query
// head h is h / (Hq / Hkv): K and V are never broadcast.  Causal masking keeps
// the reference's top-left alignment (q_pos >= k_pos); masked scores take its
// -1e30 in the CUDA-core and TF32 kernels and -inf in the bf16 tensor-core
// one, which agree
// since every query row sees key 0; key rows past Skv take -inf; key tiles
// wholly above the diagonal are skipped, so any Sq and Skv work.  No atomics:
// every result is bitwise repeatable.
//
// What bounds it: operations.  At yi-6b's prefill, (8, 32, 4, 2048, 128) bf16
// causal, the two products take 4 * B*Hq*D * (pairs q >= k) = 275 GFLOP
// against 302 MB of q, k, v and o: 0.28 ms on bf16 tensor cores, 4.1 ms at
// the card's f32 rate.
//
// The tensor-core kernel (bf16, D % 16 == 0, D <= 128).  One CTA per (128
// query rows, query head, batch), q tiles launched heaviest (latest) first so
// the causal tail is short; 288 threads: two consumer warpgroups of 64 query
// rows each and one producer warp (nine warps hold at most 168 registers a
// thread: three share an SM sub-partition's 16K).
//  - Copies: the producer's one thread issues TMA loads (cp.async.bulk.tensor,
//    4-D maps (D, S, H, B) built on the host from the caller's strides) of the
//    q tile once and of each 128-row K and V tile into a 3-stage ring, with
//    full and empty mbarriers.  K and V of a stage have their own, so Q K^T
//    starts while V is in flight and K is reloaded as soon as Q K^T is done.
//    Tiles are 64-column halves of 128-byte rows in TMA's 128-byte swizzle;
//    D is padded to 64 or 128 by TMA's zero fill (zero q/k columns add
//    nothing to a score, and padded output columns are never stored), so two
//    instantiations take every D.  TMA needs a 16-byte-aligned base and
//    16-byte-multiple strides: the wrapper checks both and sends a call that
//    lacks them to the CUDA-core kernel, whose scalar loads take any.
//  - Products: S = Q K^T by wgmma m64n128k16 (bf16 from shared memory, f32
//    accumulator); P V by wgmma m64n64k16 per 64 output columns, P from
//    registers (the S accumulator's layout is the A fragment's) and V from
//    shared memory read MN-major (V is (keys, D) with D contiguous).  Each
//    warpgroup runs S, softmax, P V in turn; the two warpgroups interleave
//    on the SM as they drift apart.
//  - Softmax: online, in f32 on the accumulator fragments, in base 2.  Masks
//    (only on tiles that cross the diagonal or the end of the keys) set raw
//    scores to -inf; the row max is taken on raw scores, in four partial
//    maxima a row, across the 4 threads of a row by shuffles, then scaled by
//    D^-1/2 log2 e (a positive scale keeps the max); p = 2^(s scale - m) is
//    one FMA and one ex2.approx; alpha = 2^(m_old - m_new) rescales O and
//    the row sum, kept per thread in partial sums until the end.  P is
//    rounded to bf16 for the second product (as SDPA and the einsum path
//    do); the scores stay f32; O is normalised by l in f32 and stored once
//    as bf16.
//  Shared memory at D = 128: Q 32 KB + 3 stages x (K 32 KB + V 32 KB) = 224 KB.
//  Tried and measured slower on the H100 (PERF.md): warpgroups taking turns
//  on the tensor cores by named barriers, and issuing S_{t+1} before the
//  softmax of S_t (ptxas serialises the wgmmas of that schedule).
//
// The TF32 kernel (f32, D % 8 == 0, D <= 128, every base and (b, h, s)
// stride of q, k and v a multiple of 16 bytes).  Both products run on the
// tensor cores by mma.sync.m16n8k8 in 3xTF32: each operand is split into a
// TF32 hi and the TF32 lo of what hi leaves, and a_lo b_hi + a_hi b_lo +
// a_hi b_hi is summed in f32 (common.cuh's split_tf32 / mma_3xtf32, as
// ssd_scan and conv1x1_gw run them), which keeps f32's gate: no operand is
// rounded to fewer bits anywhere, P included.  One block of 8 warps per
// (128 query rows, query head, batch), q tiles launched heaviest first, each
// warp 16 query rows.
//  - Q is loaded once, split, and kept in registers as the A fragments of
//    every k-step (hi and lo).
//  - K and V come in tiles of 64 keys through a 2-stage cp.async ring (16-
//    byte copies; keys past Skv and columns past D land as zeros), so one
//    tile loads while one computes; one barrier a tile.  A tile's rows are
//    D padded to 32, 64 or 128 (three instantiations) plus 4 floats, so each
//    fragment read of K or V hits 32 distinct banks.  K and V are split as
//    their fragments are read.
//  - S = Q K^T lands in accumulator fragments (rows g and g + 8, keys 2t and
//    2t + 1 of each 8); the online softmax runs on them in f32 with expf and
//    the CUDA-core kernel's masks, the row max and sum across the 4 threads
//    of a row by shuffles.  P feeds P V from those registers: the A fragment
//    of a k-step takes keys (2t, 2t + 1) where it names columns (t, t + 4),
//    and the B fragment reads V's rows 2t and 2t + 1 to match, so no value
//    moves between threads.
//  - O stays in accumulator fragments, is normalised by l at the end and
//    stored once.
// Bound: at yi-6b's prefill the two products are 275 GFLOP, 4.1 ms at the
// card's f32 rate and 0.56 ms at its TF32 rate counted once (three TF32
// products each make it 1.67 ms).  Registers bound the tile: at D = 128 the
// split Q takes 128 registers a thread and O 64, so one block of 8 warps
// fills an SM (255 registers, 192 bytes spilled).  The plan is the fastest of
// tools/attention_sweep.py's candidates at yi-6b's prefill (PERF.md): 4
// warps of 32-key tiles (two blocks an SM), Q split at each use, and each K
// and V tile split once for the block into shared memory all measured
// slower.
//
// The CUDA-core kernel (bf16 with D % 16 != 0, f32 that the TF32 kernel
// does not take).  One block of 256
// threads per (q tile of 64 rows, query head, batch).  The q tile lives in
// shared memory, transposed to (D, 64), for the whole block.  For each key
// tile of 64 rows: K is staged transposed to (D, 64); each thread forms a 4x4
// tile of scores from float4 reads (three shared-memory wavefronts per 16
// FMAs a warp); the row max and row sum are taken across the 16 threads of a
// row by shuffles; the probabilities go to shared memory transposed to (64
// keys, 64 rows); then V is staged into the buffer K used and each thread
// adds P V into its 4 rows x 8 columns of the output.  The running max,
// normaliser and accumulator stay in registers, in f32, across all key
// tiles; the output is written once.  Key rows past Skv are excluded outright
// (their V rows are zero).  Its floor is the f32 rate: f32 inputs stay f32.

#include <cuda.h>
#include <dlfcn.h>

#include "common.cuh"

namespace {

constexpr int kBQ = 64;       // query rows of a block
constexpr int kBK = 64;       // key rows of a tile
constexpr int kDMax = 128;    // largest head_dim
constexpr int kLT = kBQ + 4;  // row stride of the transposed tiles (float4-aligned)
constexpr float kNegInf = -1e30f;
static_assert(kBQ == kBK, "the transposed tiles share one row stride");

size_t attention_smem_bytes(int D) {
  // Qt (D x kLT) | K^T (D x kLT) or V (kBK x D) | P^T (kBK x kLT)
  return sizeof(float) * ((size_t)2 * D * kLT + (size_t)kBK * kLT);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Hq, int Hkv, int Sq,
                       int Skv, int D, long long q_sb, long long q_sh, long long q_ss,
                       long long k_sb, long long k_sh, long long k_ss, long long v_sb,
                       long long v_sh, long long v_ss, long long o_sb, long long o_sh,
                       long long o_ss, int causal, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;            // (D, kLT): qt[d * kLT + r] = q[q0 + r, d]
  float* kv = qt + D * kLT;    // K^T (D, kLT), then V (kBK, D)
  float* pt = kv + D * kLT;    // (kBK, kLT): pt[c * kLT + r] = p[r, c]

  const int tid = threadIdx.x;
  const int tx = tid & 15;     // score columns tx*4..+3; output columns tx*4.., 64+tx*4..
  const int ty = tid >> 4;     // rows ty*4..+3
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    qt[d * kLT + r] = q0 + r < Sq ? load_f(qb, (q0 + r) * q_ss + d) : 0.f;
  }

  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  int n_tiles = (Skv + kBK - 1) / kBK;
  if (causal) n_tiles = min(n_tiles, (q0 + kBQ - 1) / kBK + 1);
  const bool lo_cols = tx * 4 < D, hi_cols = 64 + tx * 4 < D;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's V and P are no longer read
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int c = i / D, d = i - c * D;
      kv[d * kLT + c] = k0 + c < Skv ? load_f(kb, (k0 + c) * k_ss + d) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * kLT + ty * 4);
      const float4 c = *reinterpret_cast<const float4*>(kv + d * kLT + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w}, cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kr = k0 + tx * 4 + j;
        if (kr >= Skv) s[i][j] = -INFINITY;
        else if (causal && qr < kr) s[i][j] = kNegInf;
        else s[i][j] *= scale;
        mx = fmaxf(mx, s[i][j]);
      }
      for (int off = 1; off < 16; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = expf(s[i][j] - m_new);
        sum += p[i][j];
      }
      for (int off = 1; off < 16; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pt + (tx * 4 + j) * kLT + ty * 4) =
          make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
    __syncthreads();  // K^T is no longer read; P is complete

    for (int i = tid; i < kBK * D; i += kThreads) {
      const int c = i / D;
      kv[i] = k0 + c < Skv ? load_f(vb, (k0 + c) * v_ss + (i - c * D)) : 0.f;
    }
    __syncthreads();

    for (int c = 0; c < kBK; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(pt + c * kLT + ty * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float* vr = kv + c * D;
      if (lo_cols) {
        const float4 w = *reinterpret_cast<const float4*>(vr + tx * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][0] = fmaf(av[i], w.x, acc[i][0]);
          acc[i][1] = fmaf(av[i], w.y, acc[i][1]);
          acc[i][2] = fmaf(av[i], w.z, acc[i][2]);
          acc[i][3] = fmaf(av[i], w.w, acc[i][3]);
        }
      }
      if (hi_cols) {
        const float4 w = *reinterpret_cast<const float4*>(vr + 64 + tx * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4] = fmaf(av[i], w.x, acc[i][4]);
          acc[i][5] = fmaf(av[i], w.y, acc[i][5]);
          acc[i][6] = fmaf(av[i], w.z, acc[i][6]);
          acc[i][7] = fmaf(av[i], w.w, acc[i][7]);
        }
      }
    }
  }

  T* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty * 4 + i;
    if (qr >= Sq) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = (j < 4 ? tx * 4 : 64 + tx * 4) + (j & 3);
      if (c < D) store_f(ob, qr * o_ss + c, acc[i][j] * inv);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Hq,
                   int Hkv, int Sq, int Skv, int D, const long long* st, int causal,
                   float scale, cudaStream_t s) {
  const size_t smem = attention_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)attention_smem_bytes(kDMax));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_attention_kernel<T><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Hq, Hkv, Sq, Skv, D, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11], causal, scale);
  return cudaGetLastError();
}

// ---- the TF32 tensor-core kernel (f32, 3xTF32) -------------------------------
// The TF32 kernel's plan, KEYS * 10000 + STAGES * 100 + WARPS, kept equal to
// TF32_PLAN in kernels/attention/attention.py: key rows of a K or V tile,
// stages of the K/V ring, warps of a block (16 query rows each).  Set
// otherwise only by tools/attention_sweep.py, which builds this file once
// per candidate plan.
#ifndef TF32_PLAN
#define TF32_PLAN 640208
#endif
constexpr int kTfKeys = TF32_PLAN / 10000, kTfStages = TF32_PLAN / 100 % 100,
              kTfWarps = TF32_PLAN % 100;
constexpr int kTfRows = 16 * kTfWarps;     // query rows of a block
constexpr int kTfThreads = 32 * kTfWarps;
constexpr int kTfPad = 4;                  // floats past D_pad in a staged row
static_assert(kTfKeys % 8 == 0 && kTfStages >= 2, "whole 8-key steps, a ring");

// kept equal to tf32_smem_bytes() in kernels/attention/attention.py
constexpr size_t tf32_smem_bytes(int dp) {
  // each stage a K and a V tile of kTfKeys rows of dp + kTfPad floats
  return (size_t)kTfStages * 2 * kTfKeys * (dp + kTfPad) * sizeof(float);
}

// 16 bytes from global into shared memory, or 16 zero bytes when !valid
__device__ __forceinline__ void cp_async16_or_zero(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// One tile of K or V: rows k0 .. k0 + kTfKeys - 1, columns 0 .. DP - 1, into
// dst with rows DP + kTfPad floats apart; rows past Skv and columns past D
// as zeros (D and every row a whole number of 16-byte copies)
template <int DP>
__device__ __forceinline__ void stage_kv(float* dst, const float* __restrict__ src, long long ss,
                                         int k0, int Skv, int D, int tid) {
  constexpr int kChunks = DP / 4;  // 16-byte copies a row
  static_assert(kTfKeys * kChunks % kTfThreads == 0, "whole copies a thread");
#pragma unroll
  for (int i = 0; i < kTfKeys * kChunks / kTfThreads; ++i) {
    const int c = tid + i * kTfThreads;
    const int r = c / kChunks, col = (c % kChunks) * 4;
    const bool ok = k0 + r < Skv && col < D;
    cp_async16_or_zero(dst + r * (DP + kTfPad) + col, ok ? src + (k0 + r) * ss + col : src, ok);
  }
}

// DP: D padded to 32, 64 or 128.  Grid (B * Hq, ceil(Sq / kTfRows)).  Q is
// split once into hi and lo fragments kept in registers; each warp splits the
// K and V values it reads from the staged f32 tile.
template <int DP>
__global__ void __launch_bounds__(kTfThreads, kTfWarps <= 4 ? 2 : 1)
flash_attention_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, float* __restrict__ o, int Hq, int Hkv,
                            int Sq, int Skv, int D, long long q_sb, long long q_sh, long long q_ss,
                            long long k_sb, long long k_sh, long long k_ss, long long v_sb,
                            long long v_sh, long long v_ss, long long o_sb, long long o_sh,
                            long long o_ss, int causal, float scale) {
  constexpr int KS = DP / 8;          // k-steps of Q K^T; 8-column tiles of O
  constexpr int NS = kTfKeys / 8;     // 8-key tiles of S; k-steps of P V
  constexpr int LD = DP + kTfPad;     // row stride of a staged tile
  constexpr int kTile = kTfKeys * LD;  // floats of a staged tile
  extern __shared__ __align__(16) float ring[];  // stage s: K tile, V tile
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;  // fragment row group, column pair
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTfRows;  // heaviest tiles first
  const int h = blockIdx.x % Hq;
  const int b = blockIdx.x / Hq;
  const int hk = h / (Hq / Hkv);
  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + hk * k_sh;
  const float* vb = v + b * v_sb + hk * v_sh;
  int n_tiles = (Skv + kTfKeys - 1) / kTfKeys;
  if (causal) n_tiles = min(n_tiles, (q0 + kTfRows - 1) / kTfKeys + 1);

#pragma unroll
  for (int st = 0; st < kTfStages - 1; ++st) {  // tiles 0 .. stages - 2 in flight
    if (st < n_tiles) {
      stage_kv<DP>(ring + 2 * st * kTile, kb, k_ss, st * kTfKeys, Skv, D, tid);
      stage_kv<DP>(ring + (2 * st + 1) * kTile, vb, v_ss, st * kTfKeys, Skv, D, tid);
    }
    cp_async_commit();
  }

  // this warp's 16 query rows, r0 and r0 + 8 in this thread's fragments:
  // a0 (r0, 8kk + tq), a1 (r0 + 8, ..), a2 (r0, .. + 4), a3; split once
  // into qh[kk] and ql[kk]
  const int r0 = q0 + warp * 16 + g;
  uint32_t qh[KS][4], ql[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + (e & 1) * 8, col = kk * 8 + tq + (e >> 1) * 4;
      const float val = row < Sq && col < D ? qb[row * q_ss + col] : 0.f;
      split_tf32<true>(val, qh[kk][e], ql[kk][e]);
    }

  float oacc[KS][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kTfStages - 2>();  // this thread's copies of tile t have landed
    __syncthreads();                 // and every thread's; tile t - 1 is no longer read
    const int tn = t + kTfStages - 1;
    if (tn < n_tiles) {
      const int sn = tn % kTfStages;
      stage_kv<DP>(ring + 2 * sn * kTile, kb, k_ss, tn * kTfKeys, Skv, D, tid);
      stage_kv<DP>(ring + (2 * sn + 1) * kTile, vb, v_ss, tn * kTfKeys, Skv, D, tid);
    }
    cp_async_commit();
    const float* ks = ring + 2 * (t % kTfStages) * kTile;
    const float* vs = ks + kTile;
    const int k0 = t * kTfKeys;

    // S = Q K^T: s[n] holds rows (r0, r0 + 8) x keys k0 + 8n + 2tq + {0, 1}
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        uint32_t bh[2], bl[2];  // b0 = K[8n + g][8kk + tq], b1 = K[8n + g][8kk + tq + 4]
        split_tf32<true>(ks[(8 * n + g) * LD + 8 * kk + tq], bh[0], bl[0]);
        split_tf32<true>(ks[(8 * n + g) * LD + 8 * kk + tq + 4], bh[1], bl[1]);
        mma_3xtf32<true, true>(s[n], qh[kk], ql[kk], bh, bl);
      }

    // the online softmax, as the CUDA-core kernel's: scale, masks, max, exp
    const bool masked = k0 + kTfKeys > Skv || (causal && k0 + kTfKeys - 1 > q0 + warp * 16);
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale;
        if (masked) {
          const int key = k0 + 8 * n + 2 * tq + (e & 1);
          if (key >= Skv) x = -INFINITY;
          else if (causal && r0 + (e >> 1) * 8 < key) x = kNegInf;
        }
        s[n][e] = x;
      }
    float alpha[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < NS; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * rr], s[n][2 * rr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[rr], mx);
      alpha[rr] = expf(m[rr] - m_new);
      m[rr] = m_new;
    }
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m[e >> 1]);
        ps[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) l[rr] = l[rr] * alpha[rr] + ps[rr];
#pragma unroll
    for (int n = 0; n < KS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[n][e] *= alpha[e >> 1];

    // O += P V: k-step j takes keys k0 + 8j + (2tq, 2tq + 1) as its columns
    // (tq, tq + 4), so P's A fragment is s[j] reordered in place and V's B
    // fragment reads rows 8j + 2tq and 8j + 2tq + 1
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      uint32_t ah[4], al[4];
      split_tf32<true>(s[j][0], ah[0], al[0]);
      split_tf32<true>(s[j][2], ah[1], al[1]);
      split_tf32<true>(s[j][1], ah[2], al[2]);
      split_tf32<true>(s[j][3], ah[3], al[3]);
#pragma unroll
      for (int n = 0; n < KS; ++n) {
        uint32_t bh[2], bl[2];
        split_tf32<true>(vs[(8 * j + 2 * tq) * LD + 8 * n + g], bh[0], bl[0]);
        split_tf32<true>(vs[(8 * j + 2 * tq + 1) * LD + 8 * n + g], bh[1], bl[1]);
        mma_3xtf32<true, true>(oacc[n], ah, al, bh, bl);
      }
    }
  }
  cp_async_wait_all();

  float inv[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
    inv[rr] = 1.f / l[rr];
  }
  float* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + (e >> 1) * 8, col = 8 * n + 2 * tq + (e & 1);
      if (row < Sq && col < D) ob[row * o_ss + col] = oacc[n][e] * inv[e >> 1];
    }
}

template <int DP>
cudaError_t launch_tf32(const void* q, const void* k, const void* v, void* o, int B, int Hq,
                        int Hkv, int Sq, int Skv, int D, const long long* st, int causal,
                        float scale, cudaStream_t s) {
  constexpr size_t smem = tf32_smem_bytes(DP);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_tf32_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * Hq, (Sq + kTfRows - 1) / kTfRows);
  flash_attention_tf32_kernel<DP><<<grid, kTfThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), Hq, Hkv, Sq, Skv, D, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11], causal, scale);
  return cudaGetLastError();
}

// ---- the tensor-core kernel (bf16) -------------------------------------------

constexpr int kTcRows = 128;                 // query rows of a CTA: two warpgroups of 64
constexpr int kTcKeys = 128;                 // key rows of a K or V tile
constexpr int kTcStages = 3;                 // K/V ring
constexpr int kTcConsumers = 256;            // two consumer warpgroups
constexpr int kTcThreads = kTcConsumers + 32;  // and one producer warp
constexpr int kTcHalf = 128 * 128;           // bytes of a 64-column half of a 128-row bf16 tile
constexpr int kTcBarriers = 128;             // q_full; k_full, v_full, k_empty, v_empty per stage
static_assert(kTcRows == kTcKeys, "one 128-row half size for Q, K and V tiles");

// kept equal to tc_smem_bytes() in kernels/attention/attention.py
constexpr size_t tc_smem_bytes(int dp) {
  // Q, then K and V of each stage, each dp/64 halves; 1 KB to align the base
  // to the 128-byte swizzle's 1024-byte period; the barriers
  return (size_t)(1 + 2 * kTcStages) * (dp / 64) * kTcHalf + 1024 + kTcBarriers;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.  A phase
// that never completes is a fault: trap (the launch fails) after 2^24 polls
// rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (polls == (1u << 24)) asm volatile("trap;");
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a tile in TMA's 128-byte swizzle: start
// address, leading and stride byte offsets (16-byte units), layout 1 = B128.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Registers an async wgmma writes: reads of them are not moved above the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// S (64 x 128, f32) += A (64 x 16) B (16 x 128): A and B bf16 in shared
// memory, both K-major (the D axis contiguous); scale_d = 0 overwrites S.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// O (64 x 64, f32) += P (64 x 16, bf16 in registers, the A fragment) V (16 x
// 64, bf16 in shared memory, MN-major: the 64 output columns contiguous).
__device__ __forceinline__ void wgmma_m64n64k16_rs_tb(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {  // 2^x, one MUFU op; 0 for -inf
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// DP: the padded head dim, 64 or 128.  Grid (B * Hq, ceil(Sq / 128)).
template <int DP>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                          int Hq, int Hkv, int Sq, int Skv, int D, long long o_sb, long long o_sh,
                          long long o_ss, int causal, float scale_log2) {
  constexpr int NH = DP / 64;            // 64-column halves of a tile
  constexpr int kTile = NH * kTcHalf;    // bytes of a Q, K or V tile
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;
  const uint32_t bars = base + (1 + 2 * kTcStages) * kTile;
  const uint32_t q_full = bars;
  auto sk = [&](int s) { return base + (1 + 2 * s) * kTile; };
  auto sv = [&](int s) { return base + (2 + 2 * s) * kTile; };
  auto k_full = [&](int s) { return bars + 8 + 8 * s; };
  auto v_full = [&](int s) { return bars + 8 + 8 * kTcStages + 8 * s; };
  auto k_empty = [&](int s) { return bars + 8 + 16 * kTcStages + 8 * s; };
  auto v_empty = [&](int s) { return bars + 8 + 24 * kTcStages + 8 * s; };

  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcRows;  // heaviest tiles first
  const int h = blockIdx.x % Hq;
  const int b = blockIdx.x / Hq;
  const int hk = h / (Hq / Hkv);
  int n_tiles = (Skv + kTcKeys - 1) / kTcKeys;
  if (causal) n_tiles = min(n_tiles, (q0 + kTcRows - 1) / kTcKeys + 1);

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), kTcConsumers / 32);  // one arrival per consumer warp
      mbar_init(v_empty(s), kTcConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kTcConsumers) {  // the producer warp: one thread issues every copy
    if (tid == kTcConsumers) {
      mbar_expect_tx(q_full, kTile);
      for (int hh = 0; hh < NH; ++hh) tma_load_4d(sq + hh * kTcHalf, &tq, q_full, hh * 64, q0, h, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kTcStages;
        const uint32_t parity = ((t / kTcStages) - 1) & 1;  // of the release of tile t - stages
        if (t >= kTcStages) mbar_wait(k_empty(s), parity);
        mbar_expect_tx(k_full(s), kTile);
        for (int hh = 0; hh < NH; ++hh)
          tma_load_4d(sk(s) + hh * kTcHalf, &tk, k_full(s), hh * 64, t * kTcKeys, hk, b);
        if (t >= kTcStages) mbar_wait(v_empty(s), parity);
        mbar_expect_tx(v_full(s), kTile);
        for (int hh = 0; hh < NH; ++hh)
          tma_load_4d(sv(s) + hh * kTcHalf, &tv, v_full(s), hh * 64, t * kTcKeys, hk, b);
      }
    }
    return;
  }

  // a consumer: warpgroup wg takes q rows wg*64.., its warp w rows w*16..; a
  // thread holds rows r0 and r0 + 8, columns 8j + 2*(lane % 4) + {0, 1}
  const int wg = tid >> 7;
  const int lane = tid & 31;
  const int r0 = q0 + wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  const uint32_t q_rows = sq + wg * 64 * 128;  // this warpgroup's 64 rows in each half

  float oacc[NH][32];
#pragma unroll
  for (int hh = 0; hh < NH; ++hh)
#pragma unroll
    for (int i = 0; i < 32; ++i) oacc[hh][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  mbar_wait(q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kTcStages;
    const uint32_t parity = (t / kTcStages) & 1;
    const int k0 = t * kTcKeys;

    float sacc[64];  // the first product overwrites it (scale_d = 0)
    mbar_wait(k_full(s), parity);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
      const uint32_t off = (ks / 4) * kTcHalf + (ks % 4) * 32;  // 16 columns = 32 bytes
      wgmma_m64n128k16_ss(sacc, sw128_desc(q_rows + off, 16, 1024),
                          sw128_desc(sk(s) + off, 16, 1024), ks > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sacc);
    __syncwarp();
    if (lane == 0) mbar_arrive(k_empty(s));  // this warp no longer reads K of stage s

    // the softmax of the source note: masks, partial maxima, one FMA + ex2
    const bool masked = k0 + kTcKeys > Skv || (causal && k0 + kTcKeys - 1 > q0);
    if (masked) {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int col = k0 + 8 * (i >> 2) + c0 + (i & 1);
        if (col >= Skv || (causal && r0 + 8 * ((i >> 1) & 1) < col)) sacc[i] = -INFINITY;
      }
    }
    uint32_t pa[8][4];
    float mx[2][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) mx[(i >> 1) & 1][((i >> 2) & 1) * 2 + (i & 1)] = sacc[i];
#pragma unroll
    for (int i = 8; i < 64; ++i) {
      float& a = mx[(i >> 1) & 1][((i >> 2) & 1) * 2 + (i & 1)];
      a = fmaxf(a, sacc[i]);
    }
    float alpha[2], neg_m[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float v = fmaxf(fmaxf(mx[rr][0], mx[rr][1]), fmaxf(mx[rr][2], mx[rr][3]));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
      const float m_new = fmaxf(m[rr], v * scale_log2);
      alpha[rr] = ex2(m[rr] - m_new);
      m[rr] = m_new;
      neg_m[rr] = -m_new;
    }
    float ps[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int rr = (i >> 1) & 1;
      const float p0 = ex2(fmaf(sacc[i], scale_log2, neg_m[rr]));
      const float p1 = ex2(fmaf(sacc[i + 1], scale_log2, neg_m[rr]));
      ps[rr][(i >> 2) & 1] += p0 + p1;
      pa[i >> 3][(i >> 1) & 3] = pack_bf16(p0, p1);
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) l[rr] = l[rr] * alpha[rr] + (ps[rr][0] + ps[rr][1]);
#pragma unroll
    for (int hh = 0; hh < NH; ++hh)
#pragma unroll
      for (int i = 0; i < 32; ++i) oacc[hh][i] *= alpha[(i >> 1) & 1];

    mbar_wait(v_full(s), parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcKeys / 16; ++kk)
#pragma unroll
      for (int hh = 0; hh < NH; ++hh)
        wgmma_m64n64k16_rs_tb(oacc[hh], pa[kk],
                              sw128_desc(sv(s) + hh * kTcHalf + kk * 16 * 128, 1024, 1024));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) fence_regs(oacc[hh]);
    __syncwarp();
    if (lane == 0) mbar_arrive(v_empty(s));  // nor V
  }

  float inv[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
    inv[rr] = 1.f / l[rr];
  }
  __nv_bfloat16* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int hh = 0; hh < NH; ++hh)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int rr = (i >> 1) & 1;
      const int row = r0 + 8 * rr;
      const int col = hh * 64 + 8 * (i >> 2) + c0;  // even, and D is: col < D means col + 1 < D
      if (row < Sq && col < D)
        *reinterpret_cast<__nv_bfloat162*>(ob + row * o_ss + col) =
            __floats2bfloat162_rn(oacc[hh][i] * inv[rr], oacc[hh][i + 1] * inv[rr]);
    }
}

// cuTensorMapEncodeTiled from the driver the process has loaded: the library
// links no libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_LAZY | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_LAZY);
    if (lib != nullptr) fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// A 4-D map (D, S, H, B) of a bf16 tensor with element strides (sb, sh, ss)
// and a contiguous D axis; boxes of 64 columns x 128 rows, 128-byte swizzle,
// out-of-range elements read as zero.
CUresult make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int D, int S, int H,
                  int B, long long sb, long long sh, long long ss) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)kTcKeys, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int DP>
cudaError_t launch_tc(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                      void* o, int B, int Hq, int Hkv, int Sq, int Skv, int D,
                      const long long* st, int causal, float scale, cudaStream_t s) {
  constexpr size_t smem = tc_smem_bytes(DP);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_tc_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * Hq, (Sq + kTcRows - 1) / kTcRows);
  flash_attention_tc_kernel<DP><<<grid, kTcThreads, smem, s>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), Hq, Hkv, Sq, Skv, D, st[9], st[10], st[11],
      causal, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o).  strides: 12 element
// strides, (batch, head, row) of q, k, v, o in that order; the D axis of each
// is contiguous.  Needs Hq % Hkv == 0, D % 4 == 0 and 4 <= D <= 128 (the
// caller checks).  Returns the cudaError_t of the launch.
int flash_attention(int dtype, const void* q, const void* k, const void* v, void* o, int B,
                    int Hq, int Hkv, int Sq, int Skv, int D, const long long* strides,
                    int causal, float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    err = launch<float>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, strides, causal, scale, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, strides, causal, scale, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// The tensor-core path: q, k, v and o bf16 with D % 16 == 0 and D <= 128;
// strides as flash_attention's, every q, k, v stride and base 16-byte
// aligned in bytes (the caller checks).  Returns the cudaError_t of the
// launch, or kMapError + the CUresult when a tensor map cannot be encoded
// (kMapError alone: the driver has no cuTensorMapEncodeTiled).
int flash_attention_tc(const void* q, const void* k, const void* v, void* o, int B, int Hq,
                       int Hkv, int Sq, int Skv, int D, const long long* strides, int causal,
                       float scale, int device, void* stream) {
  constexpr int kMapError = 100000;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kMapError;
  CUtensorMap tq, tk, tv;
  const long long* st = strides;
  CUresult r = make_map(encode, &tq, q, D, Sq, Hq, B, st[0], st[1], st[2]);
  if (r == CUDA_SUCCESS) r = make_map(encode, &tk, k, D, Skv, Hkv, B, st[3], st[4], st[5]);
  if (r == CUDA_SUCCESS) r = make_map(encode, &tv, v, D, Skv, Hkv, B, st[6], st[7], st[8]);
  if (r != CUDA_SUCCESS) return kMapError + static_cast<int>(r);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = D <= 64 ? launch_tc<64>(tq, tk, tv, o, B, Hq, Hkv, Sq, Skv, D, st, causal, scale, s)
                : launch_tc<128>(tq, tk, tv, o, B, Hq, Hkv, Sq, Skv, D, st, causal, scale, s);
  return static_cast<int>(err);
}

// The TF32 path: q, k, v and o f32 with D % 8 == 0 and D <= 128; strides as
// flash_attention's, every q, k, v base and (b, h, s) stride a multiple of
// 16 bytes (the caller checks).  Returns the cudaError_t of the launch.
int flash_attention_tf32(const void* q, const void* k, const void* v, void* o, int B, int Hq,
                         int Hkv, int Sq, int Skv, int D, const long long* strides, int causal,
                         float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* st = strides;
  if (D <= 32) err = launch_tf32<32>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, st, causal, scale, s);
  else if (D <= 64) err = launch_tf32<64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, st, causal, scale, s);
  else err = launch_tf32<128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, st, causal, scale, s);
  return static_cast<int>(err);
}

}  // extern "C"
