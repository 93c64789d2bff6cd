// The walk of the persistent row streams (flowstep.cu's flow_stream,
// coupling.cu's coupling_rows_kernel and coupling_bwd_rows_kernel): the tiles
// of a (B, M, C) tensor that each warp takes, the 2-stage ring of 16-byte
// cp.async copies that stages them, and the stores of whole output rows.
//
// A tile is R whole rows of one batch (a batch's last tile is ragged); tiles
// are numbered batch by batch, and warp g of the grid walks tiles g, g +
// grid * WARPS, ...  Its ring holds 2 stages of NT staged tiles, R * C
// elements of T each: the tile's rows of each input, the next tile in flight
// while the current one computes (the bytes past the last 16 one element at
// a time).  NT = 2 (the forward and inverse streams): the input and the
// conditioner output h (raw | t together); the body computes the tile in
// place, its outputs over the in tile's slots, and returns the lane's share
// of the tile's ld; the warp then stores whole rows of the in tile with
// 16-byte stores and, with kLd, sums the lanes' ld by a fixed shuffle tree
// (lane 0 + lane 16, ...) into partial[tile].  A tile's partial depends on
// its rows alone, not on the grid.  NT = 3 (the coupling backward): y, h and
// gy; the body writes an output over each of the three tiles, and the warp
// stores all three as whole rows.  C is a compile-time constant, so no index
// is divided by it per element.
//
// The caller sizes the grid (from the occupancy: every SM full, no more
// blocks than tiles), gives each warp its 2 * NT * R * C * sizeof(T) bytes
// of 16-byte aligned shared memory, calls first() (after any cp.async group
// of its own, which the first wait then also lands) and then run().

#pragma once

#include "common.cuh"

namespace {

template <typename T, int C, int R, int WARPS, int NT = 2>
struct RowWalk {
  static constexpr int ES = (int)sizeof(T);
  static constexpr int kTileBytes = R * C * ES;
  static_assert(kTileBytes % 16 == 0, "a tile is whole 16-byte copies");
  static_assert(NT == 2 || NT == 3, "(in | h) or (y | h | gy)");

  const T* __restrict__ in;
  const T* __restrict__ h;
  const T* __restrict__ g;  // the third staged input (NT = 3)
  unsigned char* ring;      // this warp's 2 stages of NT tiles
  int M, tpb, lane;         // tpb: tiles of a batch
  long long n_tiles, step, t;

  __device__ __forceinline__ RowWalk(const T* in_, const T* h_, unsigned char* ring_, int B,
                                     int M_, int warp, int lane_, const T* g_ = nullptr)
      : in(in_), h(h_), g(g_), ring(ring_), M(M_), tpb((M_ + R - 1) / R), lane(lane_) {
    n_tiles = (long long)B * tpb;
    step = (long long)gridDim.x * WARPS;
    t = (long long)blockIdx.x * WARPS + warp;
  }

  // tile tt into buf: its rows of in, then of h (then of g)
  __device__ __forceinline__ void stage(long long tt, unsigned char* buf) const {
    const long long b = tt / tpb;
    const int m0 = (int)(tt - b * tpb) * R;
    const long long e0 = (b * M + m0) * C;
    const int n = min(R, M - m0) * C;
    stage_elems<T>(buf, in + e0, n, lane, 32);
    stage_elems<T>(buf + kTileBytes, h + e0, n, lane, 32);
    if constexpr (NT == 3) stage_elems<T>(buf + 2 * kTileBytes, g + e0, n, lane, 32);
  }

  // the warp's first tile into stage 0, a cp.async group of its own
  __device__ __forceinline__ void first() const {
    if (t < n_tiles) stage(t, ring);
    cp_async_commit();
  }

  // NT = 2: body(in tile, h tile, rows) -> the lane's ld; the outputs go
  // over the in tile's slots and are stored to out.  NT = 3: body(in tile,
  // h tile, g tile, rows, batch) -> 0; the outputs go over all three tiles
  // and are stored to out, out_h and out_g.  A lane may rewrite only slots no
  // other lane reads, or order its writes after every lane's reads with
  // __syncwarp.
  template <bool kLd, typename Body>
  __device__ __forceinline__ void run(T* __restrict__ out, float* __restrict__ partial,
                                      Body body, T* __restrict__ out_h = nullptr,
                                      T* __restrict__ out_g = nullptr) {
    for (int s = 0; t < n_tiles; t += step, s ^= 1) {
      unsigned char* xt = ring + s * NT * kTileBytes;
      unsigned char* ht = xt + kTileBytes;
      if (t + step < n_tiles) stage(t + step, ring + (s ^ 1) * NT * kTileBytes);
      cp_async_commit();
      cp_async_wait_prev();  // this thread's copies of tile t have landed
      __syncwarp();          // and every lane's
      const long long b = t / tpb;
      const int m0 = (int)(t - b * tpb) * R;
      const int rows = min(R, M - m0);
      float ld;
      if constexpr (NT == 2) ld = body(xt, ht, rows);
      else ld = body(xt, ht, ht + kTileBytes, rows, b);
      __syncwarp();  // the tiles hold the outputs
      store_elems<T>(out + (b * M + m0) * C, xt, rows * C, lane, 32);
      if constexpr (NT == 3) {
        store_elems<T>(out_h + (b * M + m0) * C, ht, rows * C, lane, 32);
        store_elems<T>(out_g + (b * M + m0) * C, ht + kTileBytes, rows * C, lane, 32);
      }
      if constexpr (kLd) {  // the tile's sum: lane 0 + lane 16, ..., a fixed tree
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) ld += __shfl_down_sync(0xffffffffu, ld, o);
        if (lane == 0) partial[t] = ld;
      }
      __syncwarp();  // the buffer is free for the tile after next
    }
  }
};

// The grid of a stream launch: no more blocks than the tiles need, at most
// as many as the card holds at once (per_sm blocks an SM, n_sm SMs)
inline long long stream_grid(long long tiles, int warps, int per_sm, int n_sm) {
  const long long want = (tiles + warps - 1) / warps;
  const long long most = (long long)(per_sm > 1 ? per_sm : 1) * n_sm;
  return want < most ? want : most;
}

}  // namespace
