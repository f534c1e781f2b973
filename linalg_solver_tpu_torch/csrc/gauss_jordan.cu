// Batched Gauss-Jordan with in-place partial pivoting and a per-matrix
// pivot threshold.
//
// Replaces the Pallas TPU kernel `_gj_kernel` in
// linalg_solver_tpu/ops/pallas/gj_kernel.py (launched by `_gj_call`
// from `gauss_jordan_tiled`).  Same math, per matrix of the batch: the n
// pivoted steps of gj_pivot.cuh's header note on the [n, w] array
// (w >= n), then the reduced array, the pivot order `perm` and the pivot
// values.  Kernel 2's level 3 (inv_rbt.cu) keeps gj_pivot.cuh's routine;
// this file has its own mapping of the same step.
//
// Mapping on the H100.  The TPU kernel keeps a tile of 128 matrices in
// the vector lanes, [n, w, 128] in VMEM, and pays a one-hot select for
// every dynamic index.  Here one thread block holds one matrix; its
// threads form NW warps x 32 lanes, and the thread (warp, lane) owns rows
// lane + 32 i (i < R) and columns warp + NW k (k < C): a warp owns whole
// columns.
//
// What bounds it.  The result needs n (w - j) FMAs at step j (the j
// reduced columns hold zeros off their pivot rows), n^2 (w - (n - 1) / 2)
// a matrix (0.094 ms of FP32 at B=1024, [127, 254]), but each of the n
// steps is a chain: a pivot search over column j, the pivot row, then
// the rank-1 update, which here goes over all n w elements.
// The time is that chain's latency times n, and in shared memory the
// update's traffic, not the FMAs.  From n = 128 on one block fills an
// SM, so its own warps must hide the chain.  This design:
//  - keeps the elements in registers where the register file holds them
//    (variants 1 and 2: 32 floats a thread, 8 warps at [64, 128] with
//    four blocks an SM, 32 warps at [128, 256]); each thread reads its R
//    coefficients once a step and updates its R x C elements with one
//    fmaf each;
//  - elsewhere (variant 0, n > 128 or w > 256) keeps the tile in shared
//    memory, 32 warps a block, with the same update: two shared-memory
//    accesses an element-step, the pivot row's entry read once a column;
//  - takes one barrier a step.  The warp that owns column j + 1 computes
//    that column's updated entries first, searches its pivot (a warp
//    argmax, no cross-warp reduction, no other warp repeats it) and
//    publishes the next step's coefficients and pivot into the second of
//    two buffers, then updates the rest; every warp takes the pivot row
//    of its own columns from the lane that holds row p, by shuffles (in
//    registers) or one broadcast read a column (in shared memory), so no
//    pivot row goes through shared memory and the update follows the
//    barrier at once;
//  - counts a column's non-finite entries (which reproduce the TPU
//    kernel's one-hot reads) in the warp that owns the column, by ballot,
//    only after an update that produced one: the per-element test is one
//    compare folded into a flag;
//  - stages the array through shared memory on the way in and out, so
//    both device-memory copies coalesce.
// The arithmetic is that of gj_pivot.cuh, element for element: coefficient
// (row == p ? 1 - inv : T[row, j] * inv) * act, update fmaf(-coeff,
// prow, T), so the kernel agrees with `gauss_jordan_reference`.
// Reach: gj_smem_floats(n, w) <= 58,112 floats, gj_pivot.cuh's layout
// and budget (the inverse to n = 167, det and rank to n = 237), so the
// routes that follow from `fits` are those of the shared-memory routine;
// variant 0 leaves the layout's argmax slots and coefficients unused.
// Past it, variant 3 takes the tiles of the reference's big VMEM budget
// (gj_kernel.py:49-52, VMEM_TILE_BUDGET_BIG over 128 lanes of 4 bytes:
// n * ceil8(w) <= 180,224 elements, rank [n, n] to n = 424 and the
// affine [s, s + 1] to s = 423), which only the callers without a blocked
// alternative take.  Such a tile (263 KB at [256, 257], 720 KB at
// [424, 424]) is past one block's shared memory, and in device memory
// each step streamed the whole tile through an L2 that a batch of them
// overflows.  So it lives in the shared memory of a thread-block cluster
// of 2, 4 or 8 blocks (the fewest whose share fits: 2 at [256, 257], 4
// at [424, 424]), the columns dealt round-robin to the blocks, each block
// in variant 0's layout and step; only the next step's coefficients and
// pivot cross blocks, pushed through distributed shared memory, with one
// cluster barrier a step.  Device memory sees one read of A and one write
// of the result.
// Not ported: the padding of w to a multiple of 8, the identity filler to
// 128 lanes and the [n, w, batch] transpose, which exist only for the
// TPU's tiles and lanes.

#include <cooperative_groups.h>

#include "warp_pivot.cuh"

namespace {

// Variant 0: the tile in shared memory.
constexpr int SM_NW = 32;
constexpr int SM_RMAX = 8;  // rows a lane: n <= 241 wherever it fits

// The pivot of step j from its value tp: (piv, has, inv, act).
struct Pivot {
  float piv, inv, act;
  bool has;
};

__device__ __forceinline__ Pivot pivot_of(float tp, int nf_col, float tol) {
  Pivot q;
  q.piv = nf_col - nonfinite(tp) > 0 ? NAN : tp;
  q.has = fabsf(q.piv) > tol;
  q.inv = 1.f / (q.has ? q.piv : 1.f);
  q.act = q.has ? 1.f : 0.f;
  return q;
}

__device__ __forceinline__ float coefficient(int r, int p, float t,
                                             const Pivot& q) {
  const float cf = r == p ? 1.f - q.inv : t * q.inv;
  return cf * q.act;
}

// The pivot search of step j, by the warp that owns column j, on its
// entries cv[i] (rows lane + 32 i): publishes every row's coefficient,
// p and has, and writes perm[j], pivs[j].
template <int R>
__device__ __forceinline__ void pivot_step(const float (&cv)[R],
                                           unsigned pivbits, int n,
                                           float tol, float* coeff,
                                           int* slots, int* perm_j,
                                           float* pivs_j, int lane) {
  const int nf_col = column_nonfinite(cv, n, lane);
  const int p = warp_argmax(cv, pivbits, n, lane);  // < n
  const Pivot q = pivot_of(row_value(cv, p >> 5, p & 31), nf_col, tol);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = lane + 32 * i;
    if (r < n) coeff[r] = coefficient(r, p, cv[i], q);
  }
  if (lane == 0) {
    slots[0] = p;
    slots[1] = q.has;
    *perm_j = p;
    *pivs_j = q.has ? q.piv : 0.f;
  }
}

// Variants 1 and 2: thread (warp, lane) keeps x[i][k] = T[lane + 32 i]
// [warp + NW k] in registers (n <= 32 R, w <= NW C): a warp owns whole
// columns.  The array goes through shared memory (row stride w | 1) once
// on the way in and once on the way out, so that both copies coalesce.
template <int NW, int R, int C, int MINB>
__global__ void __launch_bounds__(NW * 32, MINB)
gj_regs_kernel(const float* __restrict__ a, const float* __restrict__ tol,
               float* __restrict__ out, int* __restrict__ perm,
               float* __restrict__ pivs, int n, int w) {
  constexpr int NT = NW * 32, NR = 32 * R, NC = NW * C;
  extern __shared__ float stage[];  // [n, w | 1]
  __shared__ float coeff[2][NR];    // the coefficients of steps j, j + 1
  __shared__ int slots[2][2];       // p, has of steps j, j + 1
  __shared__ int nf[NC];  // non-finite entries a column, kept by its warp
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ld = gj_ld(w);
  const size_t m = blockIdx.x, nw = (size_t)n * w;
  const float t = tol[m];
  int* perm_m = perm + m * n;
  float* pivs_m = pivs + m * n;

  for (int idx = tid; idx < n * w; idx += NT) {
    const int r = idx / w;
    stage[r * ld + idx - r * w] = a[m * nw + idx];
  }
  for (int c = tid; c < NC; c += NT) nf[c] = 0;
  __syncthreads();
  float x[R][C];
  bool bad = false;
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int r = lane + 32 * i, c = warp + NW * k;
      x[i][k] = r < n && c < w ? stage[r * ld + c] : 0.f;
      bad |= nonfinite(x[i][k]);
    }
  }
  // after an update that made a non-finite entry in this warp's columns,
  // recount them (by ballot); zero them once after that
  bool dirty = false;
  auto recount = [&]() {
    if (__any_sync(GJ_FULL, bad)) {
#pragma unroll
      for (int k = 0; k < C; ++k) {
        int cnt = 0;
#pragma unroll
        for (int i = 0; i < R; ++i)
          cnt += __popc(__ballot_sync(
              GJ_FULL, lane + 32 * i < n && nonfinite(x[i][k])));
        if (lane == 0 && warp + NW * k < w) nf[warp + NW * k] = cnt;
      }
      dirty = true;
    } else if (dirty) {
      if (lane == 0)
        for (int k = 0; k < C; ++k)
          if (warp + NW * k < w) nf[warp + NW * k] = 0;
      dirty = false;
    }
    __syncwarp();
  };
  recount();
  unsigned pivbits = 0;  // bit i: row lane + 32 i is pivoted
  if (warp == 0) {
    float cv[R];
#pragma unroll
    for (int i = 0; i < R; ++i) cv[i] = x[i][0];
    pivot_step(cv, pivbits, n, t, coeff[0], slots[0], perm_m, pivs_m, lane);
  }
  __syncthreads();

  for (int j = 0; j < n; ++j) {
    const int buf = j & 1, p = slots[buf][0], ip = p >> 5;
    const bool has = slots[buf][1];
    float cf[R];
#pragma unroll
    for (int i = 0; i < R; ++i)
      cf[i] = lane + 32 * i < n ? coeff[buf][lane + 32 * i] : 0.f;
    // the pivot row in this warp's columns, from the lane that holds it
    float pk[C];
#pragma unroll
    for (int k = 0; k < C; ++k) {
      float v[R];
#pragma unroll
      for (int i = 0; i < R; ++i) v[i] = x[i][k];
      pk[k] = row_value(v, ip, p & 31);
    }
    if (dirty) {  // the one-hot sum is NaN where another row is not finite
#pragma unroll
      for (int k = 0; k < C; ++k) {
        const int c = warp + NW * k;
        if (c < w && nf[c] - nonfinite(pk[k]) > 0) pk[k] = NAN;
      }
    }
    if (has && lane == (p & 31)) pivbits |= 1u << ip;
    // the warp that owns column j + 1 searches its pivot first
    if (j + 1 < n && warp == (j + 1) % NW) {
      const int kj = (j + 1) / NW;
      float pj = pk[0], cv[R];
#pragma unroll
      for (int k = 1; k < C; ++k) pj = k == kj ? pk[k] : pj;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        float xv = x[i][0];
#pragma unroll
        for (int k = 1; k < C; ++k) xv = k == kj ? x[i][k] : xv;
        cv[i] = fmaf(-cf[i], pj, xv);
      }
      pivot_step(cv, pivbits, n, t, coeff[buf ^ 1], slots[buf ^ 1],
                 perm_m + j + 1, pivs_m + j + 1, lane);
    }
    // a sum of the thread's entries flags a non-finite one (or an
    // overflow, which only costs an exact recount)
    float chk = 0.f;
#pragma unroll
    for (int k = 0; k < C; ++k) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        x[i][k] = fmaf(-cf[i], pk[k], x[i][k]);
        chk += x[i][k];
      }
    }
    bad = nonfinite(chk);
    recount();
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int r = lane + 32 * i, c = warp + NW * k;
      if (r < n && c < w) stage[r * ld + c] = x[i][k];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < n * w; idx += NT) {
    const int r = idx / w;
    out[m * nw + idx] = stage[r * ld + idx - r * w];
  }
}

// Variant 0: the tile in shared memory, column-major with the odd column
// stride n | 1 (element (r, c) at c (n | 1) + r), so that a warp's 32
// rows of a column are 32 banks and every update access is the column's
// base plus a constant.  Thread (warp, lane) updates rows lane + 32 i of
// columns warp + 32 k, so a warp owns whole columns as in variants 1 and
// 2.  It allocates gj_smem_floats(n, w) (the reach) and uses
// w (n | 1) + 2 n + w + 4 floats of it: the tile, two coefficient
// buffers, the column counts and two (p, has) slots.
__global__ void __launch_bounds__(SM_NW * 32, 1)
gj_smem_kernel(const float* __restrict__ a, const float* __restrict__ tol,
               float* __restrict__ out, int* __restrict__ perm,
               float* __restrict__ pivs, int n, int w) {
  constexpr int NT = SM_NW * 32;
  extern __shared__ float smem[];
  const int ldc = n | 1;
  float* T = smem;
  float* coeff = T + (size_t)w * ldc;  // [2][n]
  int* nf = reinterpret_cast<int*>(coeff + 2 * n);
  int* slots = nf + w;                 // [2][2]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int full = n >> 5, part = n & 31;  // whole 32-row blocks, the rest
  const size_t m = blockIdx.x, nw = (size_t)n * w;
  const float t = tol[m];
  int* perm_m = perm + m * n;
  float* pivs_m = pivs + m * n;
  for (int idx = tid; idx < n * w; idx += NT) {
    const int r = idx / w;
    T[(idx - r * w) * ldc + r] = a[m * nw + idx];
  }
  __syncthreads();

  bool bad = true, dirty = false;
  auto recount = [&]() {
    if (__any_sync(GJ_FULL, bad)) {
      for (int c = warp; c < w; c += SM_NW) {
        int cnt = 0;
#pragma unroll
        for (int i = 0; i < SM_RMAX; ++i) {
          const int r = lane + 32 * i;
          cnt += __popc(
              __ballot_sync(GJ_FULL, r < n && nonfinite(T[c * ldc + r])));
        }
        if (lane == 0) nf[c] = cnt;
      }
      dirty = true;
    } else if (dirty) {
      for (int c = warp + SM_NW * lane; c < w; c += SM_NW * 32) nf[c] = 0;
      dirty = false;
    }
    __syncwarp();
  };
  // the column's entries of this lane's rows
  auto column = [&](int c, float (&cv)[SM_RMAX]) {
#pragma unroll
    for (int i = 0; i < SM_RMAX; ++i) {
      const int r = lane + 32 * i;
      cv[i] = r < n ? T[c * ldc + r] : 0.f;
    }
  };
  recount();
  unsigned pivbits = 0;
  if (warp == 0) {
    float cv[SM_RMAX];
    column(0, cv);
    pivot_step(cv, pivbits, n, t, coeff, slots, perm_m, pivs_m, lane);
  }
  __syncthreads();

  for (int j = 0; j < n; ++j) {
    const int buf = j & 1, p = slots[2 * buf];
    const bool has = slots[2 * buf + 1];
    float cf[SM_RMAX];
#pragma unroll
    for (int i = 0; i < SM_RMAX; ++i)
      cf[i] = lane + 32 * i < n ? coeff[buf * n + lane + 32 * i] : 0.f;
    if (has && lane == (p & 31)) pivbits |= 1u << (p >> 5);
    const bool subst = dirty;
    // the pivot row's entry of column c (NaN where its one-hot sum is)
    auto prow = [&](int c) {
      const float v = T[c * ldc + p];
      return subst && nf[c] - nonfinite(v) > 0 ? NAN : v;
    };
    if (j + 1 < n && warp == (j + 1) % SM_NW) {
      const float pk = prow(j + 1);
      float cv[SM_RMAX];
      column(j + 1, cv);
#pragma unroll
      for (int i = 0; i < SM_RMAX; ++i) cv[i] = fmaf(-cf[i], pk, cv[i]);
      pivot_step(cv, pivbits, n, t, coeff + (buf ^ 1) * n,
                 slots + 2 * (buf ^ 1), perm_m + j + 1, pivs_m + j + 1,
                 lane);
    }
    // a sum of the entries flags a non-finite one (or an overflow, which
    // only costs an exact recount)
    float chk = 0.f;
    for (int c = warp; c < w; c += SM_NW) {
      const float pk = prow(c);
      float* col = T + c * ldc + lane;
#pragma unroll
      for (int i = 0; i < SM_RMAX; ++i) {
        if (i < full || (i == full && lane < part)) {
          const float v = fmaf(-cf[i], pk, col[32 * i]);
          col[32 * i] = v;
          chk += v;
        }
      }
    }
    bad = nonfinite(chk);
    recount();
    __syncthreads();
  }

  for (int idx = tid; idx < n * w; idx += NT) {
    const int r = idx / w;
    out[m * nw + idx] = T[(idx - r * w) * ldc + r];
  }
}

// Variant 3: the tile in the shared memory of a cluster of C blocks
// (C = gj_cluster_size(n, w): 2, 4 or 8), block r of the cluster holding
// the columns c = r + C k in variant 0's layout (column-major, stride
// n | 1), a warp owning whole columns: local column k is warp k mod 32's.
// Every element lives in one block and is only ever touched by the warp
// that owns its column, so the tile needs no barrier; what crosses blocks
// is the next step's coefficients [n] and (p, has), which the warp that
// owns column j + 1 pushes into the second coefficient buffer of every
// block through distributed shared memory.  One cluster barrier a step
// (arrive.release, wait.acquire) publishes them, as variant 0's one
// __syncthreads does.  It allocates gj_cluster_floats(n, w, C): the
// block's share ceil(w / C) (n | 1), two coefficient buffers [2][n], the
// column counts [ceil(w / C)] and two (p, has) slots.  R rows a lane.
constexpr int CL_NW = 32;

__host__ __device__ inline size_t gj_cluster_floats(int n, int w, int C) {
  const size_t cmax = (w + C - 1) / C;
  return cmax * (size_t)(n | 1) + 2 * (size_t)n + cmax + 4;
}

// Step j + 1's pivot search by the warp that owns column j + 1, on its
// updated entries cv[i] (rows lane + 32 i): pivot_step's coefficients,
// p and has written into buffer `buf` of every block of the cluster, and
// perm[j + 1], pivs[j + 1].
template <int C, int R>
__device__ __forceinline__ void cluster_pivot_step(
    const float (&cv)[R], unsigned pivbits, int n, float tol, float* coeff,
    int* slots, int* perm_j, float* pivs_j, int lane) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int nf_col = column_nonfinite(cv, n, lane);
  const int p = warp_argmax(cv, pivbits, n, lane);  // < n
  const Pivot q = pivot_of(row_value(cv, p >> 5, p & 31), nf_col, tol);
  float cf[R];
#pragma unroll
  for (int i = 0; i < R; ++i) cf[i] = coefficient(lane + 32 * i, p, cv[i], q);
#pragma unroll
  for (int b = 0; b < C; ++b) {
    float* dst = cluster.map_shared_rank(coeff, b);
#pragma unroll
    for (int i = 0; i < R; ++i)
      if (lane + 32 * i < n) dst[lane + 32 * i] = cf[i];
    if (lane == 0) {
      int* s = cluster.map_shared_rank(slots, b);
      s[0] = p;
      s[1] = q.has;
    }
  }
  if (lane == 0) {
    *perm_j = p;
    *pivs_j = q.has ? q.piv : 0.f;
  }
}

template <int C, int R>
__global__ void __launch_bounds__(CL_NW * 32, 1)
gj_cluster_kernel(const float* __restrict__ a, const float* __restrict__ tol,
                  float* __restrict__ out, int* __restrict__ perm,
                  float* __restrict__ pivs, int n, int w) {
  namespace cg = cooperative_groups;
  constexpr int NT = CL_NW * 32;
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int ldc = n | 1, cmax = (w + C - 1) / C;
  const int cols = (w - rank + C - 1) / C;  // this block's columns
  float* T = smem;                          // [cmax][n | 1]
  float* coeff = T + (size_t)cmax * ldc;    // [2][n]
  int* nf = reinterpret_cast<int*>(coeff + 2 * n);  // [cmax]
  int* slots = nf + cmax;                   // [2][2]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int full = n >> 5, part = n & 31;
  const size_t m = blockIdx.x / C, nw = (size_t)n * w;
  const float t = tol[m];
  int* perm_m = perm + m * n;
  float* pivs_m = pivs + m * n;
  const float* am = a + m * nw + rank;
  for (int idx = tid; idx < n * cols; idx += NT) {
    const int r = idx / cols, k = idx - r * cols;
    T[k * ldc + r] = am[(size_t)r * w + C * k];
  }
  __syncthreads();

  bool bad = true, dirty = false;
  auto recount = [&]() {
    if (__any_sync(GJ_FULL, bad)) {
      for (int k = warp; k < cols; k += CL_NW) {
        int cnt = 0;
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int r = lane + 32 * i;
          cnt += __popc(
              __ballot_sync(GJ_FULL, r < n && nonfinite(T[k * ldc + r])));
        }
        if (lane == 0) nf[k] = cnt;
      }
      dirty = true;
    } else if (dirty) {
      for (int k = warp + CL_NW * lane; k < cols; k += CL_NW * 32) nf[k] = 0;
      dirty = false;
    }
    __syncwarp();
  };
  auto column = [&](int k, float (&cv)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = lane + 32 * i;
      cv[i] = r < n ? T[k * ldc + r] : 0.f;
    }
  };
  recount();
  unsigned pivbits = 0;
  cluster.sync();  // every block of the cluster runs before any remote write
  if (rank == 0 && warp == 0) {
    float cv[R];
    column(0, cv);
    cluster_pivot_step<C, R>(cv, pivbits, n, t, coeff, slots, perm_m, pivs_m,
                             lane);
  }
  cluster.sync();

  for (int j = 0; j < n; ++j) {
    const int buf = j & 1, p = slots[2 * buf];
    const bool has = slots[2 * buf + 1];
    float cf[R];
#pragma unroll
    for (int i = 0; i < R; ++i)
      cf[i] = lane + 32 * i < n ? coeff[buf * n + lane + 32 * i] : 0.f;
    if (has && lane == (p & 31)) pivbits |= 1u << (p >> 5);
    const bool subst = dirty;
    // the pivot row's entry of local column k (NaN where its one-hot sum
    // is)
    auto prow = [&](int k) {
      const float v = T[k * ldc + p];
      return subst && nf[k] - nonfinite(v) > 0 ? NAN : v;
    };
    const int jn = j + 1, kn = jn / C;
    if (jn < n && rank == jn - C * kn && warp == kn % CL_NW) {
      const float pk = prow(kn);
      float cv[R];
      column(kn, cv);
#pragma unroll
      for (int i = 0; i < R; ++i) cv[i] = fmaf(-cf[i], pk, cv[i]);
      cluster_pivot_step<C, R>(cv, pivbits, n, t, coeff + (buf ^ 1) * n,
                               slots + 2 * (buf ^ 1), perm_m + jn,
                               pivs_m + jn, lane);
    }
    float chk = 0.f;
    for (int k = warp; k < cols; k += CL_NW) {
      const float pk = prow(k);
      float* col = T + k * ldc + lane;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        if (i < full || (i == full && lane < part)) {
          const float v = fmaf(-cf[i], pk, col[32 * i]);
          col[32 * i] = v;
          chk += v;
        }
      }
    }
    bad = nonfinite(chk);
    recount();
    // the coefficients pushed this step are visible in every block, and
    // every read of the other buffer is done; after the last step no block
    // writes into another, so a block may leave
    cluster.sync();
  }

  float* om = out + m * nw + rank;
  for (int idx = tid; idx < n * cols; idx += NT) {
    const int r = idx / cols, k = idx - r * cols;
    om[(size_t)r * w + C * k] = T[k * ldc + r];
  }
}

// The register variants' shapes, (NW, R, C) and blocks an SM asked of
// the compiler (64 registers a thread in both).
constexpr int V1_NW = 8, V1_R = 2, V1_C = 16, V1_B = 4;  // n <= 64, w <= 128
constexpr int V2_NW = 32, V2_R = 4, V2_C = 8, V2_B = 1;  // n <= 128, w <= 256

// Shared memory a block may take on sm_90, and the big reach in elements
// of an [n, ceil8(w)] tile (88 MiB / (128 lanes * 4 bytes)).
constexpr size_t GJ_MAX_SMEM = 232448;
constexpr size_t GJ_BIG_ELEMS = 180224;

// Variant 3's rows a lane: 8 to n = 256, else 14 (n <= 448; fits_big
// ends at n = 424).
constexpr int CL_R_SMALL = 8, CL_R_LARGE = 14;

// Variant 3's cluster size at [n, w]: the least of 2, 4 and 8 blocks whose
// share fits a block's shared memory (0: none does).
int cluster_size_of(int n, int w) {
  for (int c = 2; c <= 8; c *= 2)
    if (gj_cluster_floats(n, w, c) * sizeof(float) <= GJ_MAX_SMEM) return c;
  return 0;
}

template <int R>
const void* cluster_function(int c) {
  switch (c) {
    case 2: return (const void*)gj_cluster_kernel<2, R>;
    case 4: return (const void*)gj_cluster_kernel<4, R>;
    default: return (const void*)gj_cluster_kernel<8, R>;
  }
}

cudaLaunchConfig_t cluster_config(int c, int batch, size_t smem,
                                  cudaStream_t st,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c * batch);
  cfg.blockDim = dim3(CL_NW * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int R>
cudaError_t launch_cluster(int c, const float* a, const float* tol,
                           float* out, int* perm, float* pivs, int batch,
                           int n, int w, size_t smem, cudaStream_t st) {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(c, batch, smem, st, attr);
  switch (c) {
    case 2:
      return cudaLaunchKernelEx(&cfg, gj_cluster_kernel<2, R>, a, tol, out,
                                perm, pivs, n, w);
    case 4:
      return cudaLaunchKernelEx(&cfg, gj_cluster_kernel<4, R>, a, tol, out,
                                perm, pivs, n, w);
    default:
      return cudaLaunchKernelEx(&cfg, gj_cluster_kernel<8, R>, a, tol, out,
                                perm, pivs, n, w);
  }
}

}  // namespace

extern "C" {

// Shared memory the kernel's reach is measured in for an [n, w] array,
// in bytes (variant 0's dynamic shared memory).
size_t gj_smem_bytes(int n, int w) {
  return gj_smem_floats(n, w) * sizeof(float);
}

// The variant that takes an [n, w] array: 1 and 2 keep it in registers,
// 0 in shared memory (where gj_smem_bytes fits a block), 3 in a cluster's
// shared memory (past that, within the big reach, where a block's share
// of gj_cluster_size(n, w) blocks fits); -1 where none does.
int gj_variant(int n, int w) {
  if (n <= 32 * V1_R && w <= V1_NW * V1_C) return 1;
  if (n <= 32 * V2_R && w <= V2_NW * V2_C) return 2;
  if (n < 1 || n > w) return -1;
  if (gj_smem_bytes(n, w) <= GJ_MAX_SMEM) return 0;
  if ((size_t)n * ((w + 7) / 8 * 8) <= GJ_BIG_ELEMS &&
      n <= 32 * CL_R_LARGE && cluster_size_of(n, w) > 0)
    return 3;
  return -1;
}

// Variant 3's blocks a cluster at [n, w] (2, 4 or 8; 0 where it does not
// fit) and the dynamic shared memory of one of them, in bytes.
int gj_cluster_size(int n, int w) { return cluster_size_of(n, w); }
size_t gj_cluster_smem_bytes(int n, int w) {
  const int c = cluster_size_of(n, w);
  return c ? gj_cluster_floats(n, w, c) * sizeof(float) : 0;
}

static const void* gj_function(int variant, int n, int w) {
  switch (variant) {
    case 1: return (const void*)gj_regs_kernel<V1_NW, V1_R, V1_C, V1_B>;
    case 2: return (const void*)gj_regs_kernel<V2_NW, V2_R, V2_C, V2_B>;
    case 3:
      return n <= 32 * CL_R_SMALL
                 ? cluster_function<CL_R_SMALL>(cluster_size_of(n, w))
                 : cluster_function<CL_R_LARGE>(cluster_size_of(n, w));
    default: return (const void*)gj_smem_kernel;
  }
}

static int gj_threads(int variant) {
  return variant == 1   ? V1_NW * 32
         : variant == 2 ? V2_NW * 32
         : variant == 3 ? CL_NW * 32
                        : SM_NW * 32;
}

// Dynamic shared memory of `variant` at [n, w], in bytes: variant 0 the
// reach's budget, variants 1 and 2 the staging tile [n, w | 1], variant 3
// a block's share of the cluster.
static size_t gj_variant_smem(int variant, int n, int w) {
  if (variant == 0) return gj_smem_bytes(n, w);
  if (variant == 3) return gj_cluster_smem_bytes(n, w);
  return (size_t)n * gj_ld(w) * sizeof(float);
}

// Set the shared-memory limit of `variant` for [n, w]; 0 on success.
static cudaError_t gj_prepare(int variant, int n, int w) {
  return cudaFuncSetAttribute(gj_function(variant, n, w),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)gj_variant_smem(variant, n, w));
}

// Registers a thread, local (spill) bytes a thread and resident blocks an
// SM of `variant` at [n, w], into out[0..2]; returns the cudaError_t.
int gj_attributes(int variant, int n, int w, int* out) {
  const void* fn = gj_function(variant, n, w);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err == cudaSuccess) err = gj_prepare(variant, n, w);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, fn, gj_threads(variant), gj_variant_smem(variant, n, w));
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = blocks;
  return (int)err;
}

// Variant 3's clusters resident on the card at once at [n, w]
// (cudaOccupancyMaxActiveClusters), or minus the cudaError_t of the query.
int gj_clusters(int n, int w) {
  cudaError_t err = gj_prepare(3, n, w);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(
      cluster_size_of(n, w), 1, gj_cluster_smem_bytes(n, w), 0, attr);
  int count = 0;
  err = cudaOccupancyMaxActiveClusters(&count, gj_function(3, n, w), &cfg);
  return err == cudaSuccess ? count : -(int)err;
}

// Launches the variant gj_variant(n, w) on `stream`; returns the
// cudaError_t of the launch (0 on success).  Device pointers to
// contiguous data: a and out [batch, n, w] f32 (distinct), tol [batch]
// f32, perm [batch, n] int32, pivs [batch, n] f32.  Variant 0 needs
// n <= 256; variant 3 needs a card that holds one of its clusters
// (gj_clusters(n, w) > 0, which the wrapper checks once a shape).
int gauss_jordan_f32(const void* a, const void* tol, void* out, void* perm,
                     void* pivs, int batch, int n, int w, void* stream) {
  const int variant = gj_variant(n, w);
  if (variant < 0 || (variant == 0 && n > 32 * SM_RMAX))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = gj_prepare(variant, n, w);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = gj_variant_smem(variant, n, w);
  const float* A = (const float*)a;
  const float* tl = (const float*)tol;
  switch (variant) {
    case 1:
      gj_regs_kernel<V1_NW, V1_R, V1_C, V1_B>
          <<<batch, V1_NW * 32, smem, st>>>(A, tl, (float*)out, (int*)perm,
                                            (float*)pivs, n, w);
      break;
    case 2:
      gj_regs_kernel<V2_NW, V2_R, V2_C, V2_B>
          <<<batch, V2_NW * 32, smem, st>>>(A, tl, (float*)out, (int*)perm,
                                            (float*)pivs, n, w);
      break;
    case 3: {
      const int c = cluster_size_of(n, w);
      err = n <= 32 * CL_R_SMALL
                ? launch_cluster<CL_R_SMALL>(c, A, tl, (float*)out,
                                             (int*)perm, (float*)pivs, batch,
                                             n, w, smem, st)
                : launch_cluster<CL_R_LARGE>(c, A, tl, (float*)out,
                                             (int*)perm, (float*)pivs, batch,
                                             n, w, smem, st);
      if (err != cudaSuccess) return (int)err;
      break;
    }
    default:
      gj_smem_kernel<<<batch, SM_NW * 32, smem, st>>>(
          A, tl, (float*)out, (int*)perm, (float*)pivs, n, w);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
