// Pivoted Gauss-Jordan steps on a tile in shared or device memory, used
// by inv_rbt.cu (its level-3 rescue, in a device-memory scratch); the
// layout is also the one gauss_jordan.cu's shared-memory reach is
// measured in.
//
// Ports the step of the Pallas TPU kernel `_gj_kernel`
// (linalg_solver_tpu/ops/pallas/gj_kernel.py:79-115), which
// `_inv_rbt_kernel` repeats for its level 3 (inv_rbt_kernel.py:226-254).
// Step j, for one matrix held as an [n, w] tile T (row stride ld):
//   p      = first argmax over rows of where(pivoted, -inf, |T[:, j]|),
//            a NaN counting as the largest (jnp.argmax's order)
//   piv    = sum(T[:, j] * onehot(p)),  prow = sum(T * onehot(p), rows)
//   has    = |piv| > tol,  inv = 1 / (has ? piv : 1),  act = has
//   coeff  = (row == p ? 1 - inv : T[row, j] * inv) * act
//   T      = T - coeff * prow                  (one rounding: fmaf)
//   pivoted[p] |= has, perm[j] = p, pivs[j] = has ? piv : 0
// Rows are never swapped.  The one-hot sums make piv and prow[c] NaN
// whenever another row of their column holds an Inf or NaN; the tile
// keeps a count of non-finite entries per column (`nfc`) so that a
// single read reproduces that.  The update is not skipped for a
// skipped column (act = 0): NaN * 0 = NaN, as on the TPU.
//
// One thread block per matrix.  Each step is an argmax (warp shuffles,
// then one pass over the warp results), one staging pass (coefficients
// and pivot row) and the rank-1 update of the whole tile: three
// barriers.  The update reads and writes n*w floats of shared memory
// per step, and that traffic bounds the routine.

#pragma once

#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>

namespace {

constexpr int GJ_NT = 256;  // threads per block of both kernels
constexpr int GJ_NWARP = GJ_NT / 32;
constexpr unsigned GJ_FULL = 0xffffffffu;

// Row stride of the tile: odd, so that a column read by consecutive
// threads hits 32 different banks.
__host__ __device__ inline int gj_ld(int w) { return w | 1; }

// Floats of shared memory the routine takes for an [n, w] tile: the
// tile, prow [w], nfc [2][w], coeff [n], pivoted [n], perm [n],
// pivs [n], and the argmax slots [2][GJ_NWARP].
__host__ __device__ inline size_t gj_smem_floats(int n, int w) {
  return (size_t)n * gj_ld(w) + 3 * (size_t)w + 4 * (size_t)n +
         2 * GJ_NWARP;
}

struct GJTile {
  float* T;
  float* prow;
  int* nfc;
  float* coeff;
  int* pivoted;
  int* perm;
  float* pivs;
  float* redv;
  int* redi;
  int ld;
};

// Carve the routine's arrays out of `base` (gj_smem_floats(n, w) floats).
__device__ inline GJTile gj_carve(float* base, int n, int w) {
  GJTile s;
  s.ld = gj_ld(w);
  s.T = base;
  s.prow = s.T + (size_t)n * s.ld;
  s.nfc = reinterpret_cast<int*>(s.prow + w);
  s.coeff = reinterpret_cast<float*>(s.nfc + 2 * w);
  s.pivoted = reinterpret_cast<int*>(s.coeff + n);
  s.perm = s.pivoted + n;
  s.pivs = reinterpret_cast<float*>(s.perm + n);
  s.redv = s.pivs + n;
  s.redi = reinterpret_cast<int*>(s.redv + GJ_NWARP);
  return s;
}

__device__ __forceinline__ int nonfinite(float v) { return !isfinite(v); }

// Whether (v, i) comes before (bv, bi) in jnp.argmax's order: a NaN is
// the largest value, and among equal values (or NaNs) the lower row wins.
__device__ __forceinline__ bool argmax_before(float v, int i, float bv,
                                              int bi) {
  const bool vn = v != v, bn = bv != bv;
  if (vn || bn) return vn && (!bn || i < bi);
  return v > bv || (v == bv && i < bi);
}

// The pivoted steps j = 0..n-1 on the tile, with threshold `tol`, by a
// block of NT threads (redv and redi hold NT / 32 slots each).  The tile
// must be loaded and visible to the block (a __syncthreads() after the
// load); it may lie in shared or in device memory.  On return the tile is
// reduced and perm/pivs hold the pivot order and values, all visible to
// the block.  The result does not depend on NT: the argmax is a total
// order, each update one fmaf and the counts integers.
template <int NT = GJ_NT>
__device__ void gj_pivot_steps(const GJTile& s, int n, int w, float tol) {
  constexpr int NWARP = NT / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ld = s.ld;
  float* T = s.T;
  int* nf_cur = s.nfc;
  int* nf_next = s.nfc + w;
  for (int c = tid; c < w; c += NT) {
    int k = 0;
    for (int r = 0; r < n; ++r) k += nonfinite(T[r * ld + c]);
    nf_cur[c] = k;
  }
  for (int r = tid; r < n; r += NT) s.pivoted[r] = 0;
  __syncthreads();

  const int dr = NT / w, dc = NT % w;  // update walk over [n, w]
  for (int j = 0; j < n; ++j) {
    float bv = -INFINITY;
    int bi = n;
    for (int r = tid; r < n; r += NT) {
      const float v = s.pivoted[r] ? -INFINITY : fabsf(T[r * ld + j]);
      if (argmax_before(v, r, bv, bi)) {
        bv = v;
        bi = r;
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(GJ_FULL, bv, o);
      const int oi = __shfl_xor_sync(GJ_FULL, bi, o);
      if (argmax_before(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      s.redv[warp] = bv;
      s.redi[warp] = bi;
    }
    __syncthreads();
    bv = s.redv[0];
    bi = s.redi[0];
    for (int q = 1; q < NWARP; ++q) {
      if (argmax_before(s.redv[q], s.redi[q], bv, bi)) {
        bv = s.redv[q];
        bi = s.redi[q];
      }
    }
    const int p = bi;  // < n: at most j < n rows are pivoted

    const float tp = T[p * ld + j];
    const float piv = nf_cur[j] - nonfinite(tp) > 0 ? NAN : tp;
    const bool has = fabsf(piv) > tol;
    const float inv = 1.f / (has ? piv : 1.f);
    const float act = has ? 1.f : 0.f;
    for (int r = tid; r < n; r += NT) {
      const float cf = r == p ? 1.f - inv : T[r * ld + j] * inv;
      s.coeff[r] = cf * act;
    }
    for (int c = tid; c < w; c += NT) {
      const float x = T[p * ld + c];
      s.prow[c] = nf_cur[c] - nonfinite(x) > 0 ? NAN : x;
      nf_next[c] = 0;
    }
    if (tid == 0) {
      s.perm[j] = p;
      s.pivs[j] = has ? piv : 0.f;
      if (has) s.pivoted[p] = 1;
    }
    __syncthreads();

    int r = tid / w, c = tid % w;
    for (; r < n; r += dr) {
      float* e = T + r * ld + c;
      const float v = fmaf(-s.coeff[r], s.prow[c], *e);
      *e = v;
      if (nonfinite(v)) atomicAdd(nf_next + c, 1);
      c += dc;
      if (c >= w) {
        c -= w;
        ++r;
      }
    }
    __syncthreads();
    int* t = nf_cur;
    nf_cur = nf_next;
    nf_next = t;
  }
}

}  // namespace
