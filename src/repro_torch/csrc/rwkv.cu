// RWKV6 wkv recurrence for Hopper (sm_90a).
//
// wkv_scan_kernel replaces the Pallas kernel
//   src/repro/kernels/rwkv/rwkv.py::wkv_scan (_wkv_kernel)
//
//   y_t[j] = sum_i r_t[i] (S[i][j] + u[i] k_t[i] v_t[j]);   S[i][j] <- w_t[i] S[i][j] + k_t[i] v_t[j]
//
// r, k, v, w (B, H, S, K), f32 or bf16 (one type), any strides over (b, h, s)
// with the K axis contiguous and every row 16-byte aligned (the wrapper
// copies a tensor that is not); u (H, K) f32; state0 (B, H, K, K) f32 or null
// (zeros, the TPU kernel's case); y (B, H, S, K) f32 with its own strides,
// rows 16-byte aligned; the final state (B, H, K, K) f32, contiguous.  K is
// 16, 32 or 64.
//
// What bounds it.  chip_smoke.py's cost() counts 5 K^2 + 5 K operations per
// (token, head), since r (S + u k v) = r S + (r . (u k)) v: r S (2 K^2), the
// update w S + k v^T (3 K^2), the dot r . (u k) and its multiple of v.  At
// rwkv6-7b's prefill, (8, 64, 2048, 64) in f32 with a state, that is 21.8
// GFLOP, 0.325 ms at the card's 67 TFLOP/s f32 rate, against 1.36 GB of r,
// k, v, w, y and the states, 0.406 ms at 3.35 TB/s: the bytes bound it, with
// the FP32 units close behind.  In instructions the recurrence is 3 per state
// entry a step (an FMA for r S, a multiply k v and an FMA w S + k v), 0.39 ms
// of FP32 issue at 1.98 GHz, so whatever else a step issues (shared loads,
// the sum over i) comes out of the same issue slots.  The recurrence is
// sequential in time; the parallelism is B * H * K^2 state entries.
//
// Design.  One block of 2K threads per (head, batch), walking time in order.
// Each thread owns a TI x 4 tile of the state in registers (TI = K / 8 rows,
// 8 x 4 at K = 64): per step it reads 3 TI + 4 staged values (r, k, w of its
// rows, v of its columns) as float4 / float2 broadcasts for 3 TI * 4 FP32
// instructions.  Lane l of warp q takes row group g = l >> 2 (rows
// [g TI, (g+1) TI)) and columns [4 (4 q + (l & 3)), + 4), so the 8 row groups
// of a column are the lanes l ^ 4, l ^ 8, l ^ 16 of one warp.  y's partial
// sums over the row groups are added by a reduce-scatter over those lanes in
// a fixed order (4 shuffles a step: ((g0 + g4) + (g2 + g6)) + ((g1 + g5) +
// (g3 + g7))); the upper half of the warp keeps its column pairs swapped, so
// the first level sends and keeps the same registers in every lane, and the
// even row group of each pair of lanes then holds one column of y.
// r . (u k) is taken once per step, by K / 8 lanes of 8 products each (in
// order) added by a shuffle tree ((p0 + p1) + (p2 + p3)) + ..., before the
// stage's steps run, and added to y as one FMA.  The same order is
// kernels/rwkv/ref.py::wkv_tiled_ref.  The steps are unrolled by 8.
//
// Staging is asynchronous: a ring of kStages = 2 stages of kT = 16 steps of
// r, k, w and v in their storage type, filled by 16-byte cp.async copies, so
// the next stage is in flight while one computes.  bf16 stages are widened
// once, by the same pass that takes r . (u k), into an f32 copy the steps
// read.  Each stage's y goes to shared memory as the steps run and back to
// HBM as 16-byte row stores while the next stage computes.  The state comes
// in and goes out as 16-byte loads and stores of each thread's rows.  A
// decode step (S = 1) is that I/O and one step with no staging and no
// barrier: each thread reads its rows of r, k, w and its columns of v
// straight from HBM, and every group of K / 8 lanes takes the dot as the
// stage's pass would, so the result is the staged path's, bit for bit.  Any
// S works (the last stage is partial).  At K = 64 a block takes 37 KB of shared memory in either type
// and at most 128 registers a thread, so four blocks (16 warps) fit
// an SM: rwkv6-7b's 512 (b, h) are one wave on 132 SMs.  No atomics: every
// result is bitwise repeatable.
//
// Measured at rwkv6-7b's prefill (NVIDIA H100 80GB HBM3, 700 W; PERF.md,
// PR 18): 0.82 ms, twice the bytes bound, about 1.7 times faster than one
// thread a column.  Diagnostic builds put the rest in stalls on the steps'
// shared-memory broadcasts and the per-stage barriers, not in bytes or FP32
// issue.  Variants that measured no faster: a third stage; an 8 x 8 tile a
// thread (fewer shuffles and loads an FMA, half the warps); y's sum over the
// row groups through shared memory once per stage; r . (u k) folded into each
// row group's sum; two chains for r S.

#include "common.cuh"

namespace {

constexpr int kT = 16;      // time steps a stage holds
constexpr int kStages = 2;  // the ring: stages in flight + 1

// Shared memory of one block, kept equal to wkv_smem_bytes() in
// kernels/rwkv/rwkv.py: the ring (kStages x r | k | w | v, kT x K each, in
// the storage type), an f32 copy of one stage for bf16, y of one stage (f32)
// and r . (u k) of each of its steps
constexpr size_t wkv_smem_bytes(int K, int elem_size) {
  return (size_t)kStages * 4 * kT * K * elem_size + (elem_size == 4 ? 0 : 4 * kT * K * 4) +
         (size_t)kT * K * 4 + kT * 4;
}

template <int n>
__device__ __forceinline__ void load_f32(const float* p, float* out) {
  load_vals<float, n>(reinterpret_cast<const unsigned char*>(p), out);
}

template <typename T, int K>
__global__ void __launch_bounds__(2 * K, 4)
wkv_scan_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ w, const float* __restrict__ u,
                const float* __restrict__ state0, float* __restrict__ y,
                float* __restrict__ state, int H, int S, long long r_sb, long long r_sh,
                long long r_ss, long long k_sb, long long k_sh, long long k_ss, long long v_sb,
                long long v_sh, long long v_ss, long long w_sb, long long w_sh, long long w_ss,
                long long y_sb, long long y_sh, long long y_ss) {
  constexpr int kThreadsK = 2 * K;
  constexpr int TI = K / 8;                            // state rows a thread owns
  constexpr int kRowChunks = K * (int)sizeof(T) / 16;  // 16-byte pieces of a row
  constexpr int kStageElems = 4 * kT * K;
  constexpr bool kWiden = sizeof(T) != 4;
  constexpr int kQ = K / 8;                            // lanes that take r . (u k) of a step
  static_assert(kThreadsK == kT * kQ, "one stage's dots take every thread once");
  extern __shared__ __align__(16) unsigned char wsm[];
  T* ring = reinterpret_cast<T*>(wsm);
  float* wide = reinterpret_cast<float*>(wsm + (size_t)kStages * kStageElems * sizeof(T));
  float* ybuf = wide + (kWiden ? kStageElems : 0);
  float* ruk = ybuf + kT * K;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x, b = blockIdx.y;
  const int hi = lane >> 4, mid = (lane >> 3) & 1;
  const bool writer = !((lane >> 2) & 1);
  const int i0 = (lane >> 2) * TI;                 // the thread's state rows
  const int j0 = 4 * (4 * warp + (lane & 3));      // and columns
  const int col = j0 + 2 * hi + mid;               // the column of y it holds after the sum
  const T* src[4] = {r + b * r_sb + h * r_sh, k + b * k_sb + h * k_sh, w + b * w_sb + h * w_sh,
                     v + b * v_sb + h * v_sh};
  const long long ss[4] = {r_ss, k_ss, w_ss, v_ss};
  float* yb = y + b * y_sb + h * y_sh;
  const long long st_base = ((long long)b * H + h) * K * K;
  const int n_stages = (S + kT - 1) / kT;

  auto issue = [&](int sg) {  // stage sg into ring slot sg % kStages: r | k | w | v
    const int t0 = sg * kT, n = min(kT, S - t0);
    unsigned char* dst = reinterpret_cast<unsigned char*>(ring + (sg % kStages) * kStageElems);
#pragma unroll
    for (int x = 0; x < 4; ++x)
      for (int c = tid; c < n * kRowChunks; c += kThreadsK) {
        const int tt = c / kRowChunks, q = c - tt * kRowChunks;
        cp_async16(dst + ((x * kT + tt) * K) * (int)sizeof(T) + 16 * q,
                   reinterpret_cast<const unsigned char*>(src[x] + (t0 + tt) * ss[x]) + 16 * q);
      }
  };

  // st[a][c] = S[i0 + a][j0 + (c ^ 2 hi)]: a lane of the upper half of the
  // warp keeps its column pairs swapped, so that the first step of the sum
  // over row groups sends and keeps the same registers in every lane
  float st[TI][4];
#pragma unroll
  for (int a = 0; a < TI; ++a) {
    float4 v4 = make_float4(0.f, 0.f, 0.f, 0.f);
    if (state0 != nullptr)
      v4 = *reinterpret_cast<const float4*>(state0 + st_base + (i0 + a) * K + j0);
    st[a][0] = hi ? v4.z : v4.x, st[a][1] = hi ? v4.w : v4.y;
    st[a][2] = hi ? v4.x : v4.z, st[a][3] = hi ? v4.y : v4.w;
  }
  auto store_state = [&]() {
#pragma unroll
    for (int a = 0; a < TI; ++a)
      *reinterpret_cast<float4*>(state + st_base + (i0 + a) * K + j0) =
          hi ? make_float4(st[a][2], st[a][3], st[a][0], st[a][1])
             : make_float4(st[a][0], st[a][1], st[a][2], st[a][3]);
  };
  // this thread's share of r . (u k): step tid / kQ, elements [8 q, 8 q + 8)
  const int dt = tid / kQ, dq = tid - dt * kQ;
  float ud[8];
  load_f32<8>(u + h * K + 8 * dq, ud);
  // r . (u k) of a step from this thread's 8 elements of r and k, summed
  // over the step's kQ lanes; every one of them holds the sum
  auto dot = [&](const float* rv, const float* kv) {
    float p = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) p = fmaf(rv[e] * ud[e], kv[e], p);
#pragma unroll
    for (int o = 1; o < kQ; o <<= 1) p += __shfl_xor_sync(0xffffffffu, p, o);
    return p;
  };
  // one step: r S over the thread's rows, in order, added over the row groups
  // g ^ 4 (lane ^ 16; columns j0 + 2 hi + {0, 1} stay), then g ^ 2 (column
  // j0 + 2 hi + mid stays), then g ^ 1; and the update of the state
  auto step = [&](const float* rr, const float* kk, const float* ww, const float* vv) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int a = 0; a < TI; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[c] = fmaf(rr[a], st[a][c], acc[c]);
#pragma unroll
    for (int a = 0; a < TI; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) st[a][c] = fmaf(ww[a], st[a][c], kk[a] * vv[c]);
    const float k0 = acc[0] + __shfl_xor_sync(0xffffffffu, acc[2], 16);
    const float k1 = acc[1] + __shfl_xor_sync(0xffffffffu, acc[3], 16);
    float ys = mid ? k1 : k0;
    ys += __shfl_xor_sync(0xffffffffu, mid ? k0 : k1, 8);
    return ys + __shfl_xor_sync(0xffffffffu, ys, 4);
  };

  if (S == 1) {  // a decode step: straight from HBM, no staging, no barrier
    const unsigned char* rb = reinterpret_cast<const unsigned char*>(src[0]);
    const unsigned char* kb = reinterpret_cast<const unsigned char*>(src[1]);
    float rr[TI], kk[TI], ww[TI], vv[4], rv[8], kv[8];
    load_vals<T, TI>(rb + i0 * (int)sizeof(T), rr);
    load_vals<T, TI>(kb + i0 * (int)sizeof(T), kk);
    load_vals<T, TI>(reinterpret_cast<const unsigned char*>(src[2] + i0), ww);
    load_vals<T, 2>(reinterpret_cast<const unsigned char*>(src[3] + j0 + 2 * hi), vv);
    load_vals<T, 2>(reinterpret_cast<const unsigned char*>(src[3] + j0 + 2 - 2 * hi), vv + 2);
    load_vals<T, 8>(rb + 8 * dq * (int)sizeof(T), rv);
    load_vals<T, 8>(kb + 8 * dq * (int)sizeof(T), kv);
    const float d = dot(rv, kv);
    const float ys = step(rr, kk, ww, vv);
    if (writer) yb[col] = fmaf(d, mid ? vv[1] : vv[0], ys);
    store_state();
    return;
  }

#pragma unroll
  for (int sg = 0; sg < kStages - 1; ++sg) {
    if (sg < n_stages) issue(sg);
    cp_async_commit();
  }

  auto store_y = [&](int sg) {  // stage sg's rows of y, from ybuf
    const int t0 = sg * kT, n = min(kT, S - t0);
    for (int c = tid; c < n * (K / 4); c += kThreadsK) {
      const int tt = c / (K / 4), q = c - tt * (K / 4);
      *reinterpret_cast<float4*>(yb + (t0 + tt) * y_ss + 4 * q) =
          *reinterpret_cast<const float4*>(ybuf + tt * K + 4 * q);
    }
  };

  for (int sg = 0; sg < n_stages; ++sg) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage sg has landed; stage sg - 1 is no longer read
    if (sg + kStages - 1 < n_stages) issue(sg + kStages - 1);
    cp_async_commit();
    if (sg > 0) store_y(sg - 1);

    const T* slot = ring + (sg % kStages) * kStageElems;
    const float* cur = kWiden ? wide : reinterpret_cast<const float*>(slot);
    {  // r . (u k) of step dt, widening the stage for bf16
      const unsigned char* sb = reinterpret_cast<const unsigned char*>(slot);
      const int at = dt * K + 8 * dq;
      float rv[8], kv[8];
      load_vals<T, 8>(sb + (0 * kT * K + at) * (int)sizeof(T), rv);
      load_vals<T, 8>(sb + (1 * kT * K + at) * (int)sizeof(T), kv);
      if constexpr (kWiden) {
        float wv[8], vv[8];
        load_vals<T, 8>(sb + (2 * kT * K + at) * (int)sizeof(T), wv);
        load_vals<T, 8>(sb + (3 * kT * K + at) * (int)sizeof(T), vv);
        const float* vals[4] = {rv, kv, wv, vv};
#pragma unroll
        for (int x = 0; x < 4; ++x)
          store_vals<float, 8>(reinterpret_cast<unsigned char*>(wide + x * kT * K + at), vals[x]);
      }
      const float d = dot(rv, kv);
      if (dq == 0) ruk[dt] = d;
    }
    __syncthreads();  // the stage's dots (and its f32 copy) are in place

    const int n = min(kT, S - sg * kT);
#pragma unroll 8
    for (int tt = 0; tt < n; ++tt) {
      float rr[TI], kk[TI], ww[TI], vv[4];
      load_f32<TI>(cur + 0 * kT * K + tt * K + i0, rr);
      load_f32<TI>(cur + 1 * kT * K + tt * K + i0, kk);
      load_f32<TI>(cur + 2 * kT * K + tt * K + i0, ww);
      load_f32<2>(cur + 3 * kT * K + tt * K + j0 + 2 * hi, vv);
      load_f32<2>(cur + 3 * kT * K + tt * K + j0 + 2 - 2 * hi, vv + 2);
      const float ys = step(rr, kk, ww, vv);
      if (writer) ybuf[tt * K + col] = fmaf(ruk[tt], mid ? vv[1] : vv[0], ys);
    }
  }
  cp_async_wait_all();
  __syncthreads();
  store_y(n_stages - 1);
  store_state();
}

template <typename T, int K>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w, const float* u,
                   const float* state0, float* y, float* state, int B, int H, int S,
                   const long long* st, int device, cudaStream_t s) {
  auto kernel = wkv_scan_kernel<T, K>;
  const size_t smem = wkv_smem_bytes(K, sizeof(T));
  static int configured = -1;  // the device the attribute was set for
  if (configured != device) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured = device;
  }
  const dim3 grid(H, B);
  kernel<<<grid, 2 * K, smem, s>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(w), u, state0, y, state, H, S, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], st[9], st[10], st[11], st[12], st[13], st[14]);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_k(const void* r, const void* k, const void* v, const void* w, const float* u,
                     const float* state0, float* y, float* state, int B, int H, int S, int K,
                     const long long* st, int device, cudaStream_t s) {
  switch (K) {
    case 16: return launch<T, 16>(r, k, v, w, u, state0, y, state, B, H, S, st, device, s);
    case 32: return launch<T, 32>(r, k, v, w, u, state0, y, state, B, H, S, st, device, s);
    case 64: return launch<T, 64>(r, k, v, w, u, state0, y, state, B, H, S, st, device, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (r, k, v, w).  strides: 15 element
// strides, (batch, head, time) of r, k, v, w, y in that order; the K axis of
// each is contiguous, and the base and the strides of each are 16-byte
// multiples.  u and state0 (may be null: zeros) 16-byte aligned.  Needs K in
// {16, 32, 64} and S >= 1 (the caller checks).  Returns the cudaError_t of
// the launch.
int wkv_scan(int dtype, const void* r, const void* k, const void* v, const void* w,
             const float* u, const float* state0, float* y, float* state, int B, int H, int S,
             int K, const long long* strides, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    err = launch_k<float>(r, k, v, w, u, state0, y, state, B, H, S, K, strides, device, s);
  } else if (dtype == 1) {
    err = launch_k<__nv_bfloat16>(r, k, v, w, u, state0, y, state, B, H, S, K, strides, device, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

}  // extern "C"
