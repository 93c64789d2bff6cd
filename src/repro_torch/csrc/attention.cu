// Flash attention forward for Hopper (sm_90a): grouped-query attention with
// an online softmax over key/value tiles.
//
// flash_attention_kernel replaces the Pallas kernel
//   src/repro/kernels/attention/attention.py::flash_attention (_flash_kernel)
//
//   o[b, h, q, :] = sum_k softmax_k(q[b,h,q,:] . k[b,h/g,k,:] * D^-1/2) v[b,h/g,k,:]
//
// q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), f32 or bf16, any strides over
// (b, h, s) with the D axis contiguous; o in q's storage type.  The KV head
// of query head h is h / (Hq / Hkv): K and V are never broadcast.  Causal
// masking keeps the reference's top-left alignment (q_pos >= k_pos), and key
// tiles wholly above the diagonal are skipped.
//
// What bounds it: operations.  At yi-6b's prefill, (8, 32, 4, 2048, 128) bf16
// causal, the two products take 4 * B*Hq*D * (pairs q >= k) = 275 GFLOP
// against 302 MB of q, k, v and o: 0.28 ms on bf16 tensor cores, 4.1 ms at
// the card's f32 rate.  This first kernel runs both products on the CUDA
// cores in f32 (f32 inputs must stay f32, and bf16 inputs are widened on
// load), so its floor is the f32 rate; tensor cores (mma.sync / wgmma) are
// later work.
//
// Design.  One block of 256 threads per (q tile of 64 rows, query head,
// batch).  The q tile lives in shared memory, transposed to (D, 64), for the
// whole block.  For each key tile of 64 rows: K is staged transposed to
// (D, 64); each thread forms a 4x4 tile of scores from float4 reads (three
// shared-memory wavefronts per 16 FMAs a warp); the row max and row sum are
// taken across the 16 threads of a row by shuffles; the probabilities go to
// shared memory transposed to (64 keys, 64 rows); then V is staged into the
// buffer K used and each thread adds P V into its 4 rows x 8 columns of the
// output.  The running max, normaliser and accumulator stay in registers,
// in f32, across all key tiles; the output is written once.  No atomics:
// every result is bitwise repeatable.  Masked scores take the reference's
// -1e30; key rows past Skv are excluded outright (their V rows are zero), so
// any Sq and Skv work.

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

}  // extern "C"
