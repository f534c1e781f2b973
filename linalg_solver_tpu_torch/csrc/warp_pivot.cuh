// Warp-level pieces of the pivoted steps of gauss_jordan.cu and
// lu_panel.cu, for a warp that holds a whole column: lane l keeps the
// entries of rows l + 32 i (i < R) in cv[i].

#pragma once

#include "gj_pivot.cuh"

namespace {

// Non-finite entries of the column (rows < n).
template <int R>
__device__ __forceinline__ int column_nonfinite(const float (&cv)[R], int n,
                                                int lane) {
  unsigned cnt = 0;
#pragma unroll
  for (int i = 0; i < R; ++i) cnt += lane + 32 * i < n && nonfinite(cv[i]);
  return (int)__reduce_add_sync(GJ_FULL, cnt);
}

// The argmax key of a candidate: 0 for a masked row, else the bits of |v|
// plus one, every NaN the same largest key.  Keys order the candidates as
// jnp.argmax orders where(masked, -inf, |v|).
__device__ __forceinline__ unsigned argmax_key(float v, bool masked) {
  const unsigned bits = v != v ? 0x7fffffffu : __float_as_uint(fabsf(v));
  return masked ? 0u : bits + 1u;
}

// First argmax of where(masked, -inf, |cv|) over the rows < n, in
// jnp.argmax's order (a NaN the largest, the lower row first); bit i of
// `masked` stands for row lane + 32 i.  Branch-free: the lane's largest
// key and its first row, then a warp max and min (redux).  Every lane
// returns it.
template <int R>
__device__ __forceinline__ int warp_argmax(const float (&cv)[R],
                                           unsigned masked, int n,
                                           int lane) {
  unsigned key[R], best = 0;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    key[i] = lane + 32 * i < n ? argmax_key(cv[i], (masked >> i) & 1u) : 0u;
    best = max(best, key[i]);
  }
  unsigned row = 0xffffffffu;
#pragma unroll
  for (int i = R - 1; i >= 0; --i)
    if (key[i] == best) row = lane + 32 * i;
  const unsigned top = __reduce_max_sync(GJ_FULL, best);
  return (int)__reduce_min_sync(GJ_FULL, best == top ? row : 0xffffffffu);
}

// v[i] of lane src for i = ri (warp-uniform), in every lane.
template <int R>
__device__ __forceinline__ float row_value(const float (&v)[R], int ri,
                                           int src) {
  float x = v[0];
#pragma unroll
  for (int i = 1; i < R; ++i) x = i == ri ? v[i] : x;
  return __shfl_sync(GJ_FULL, x, src);
}

}  // namespace
