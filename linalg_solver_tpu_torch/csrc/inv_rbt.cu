// Fused random-butterfly inverse of a batch of small matrices, with its
// gate and rescue inside the kernel.
//
// Replaces the Pallas TPU kernel `_inv_rbt_kernel` in
// linalg_solver_tpu/ops/pallas/inv_rbt_kernel.py (launched by
// `_inv_rbt_call` from `inverse_rbt_fused_batched`).  Same math, per
// matrix (n % 4 == 0, n <= 180: the reference's `supported`):
//   1. A' = U^T A V                                 (depth-2 butterflies)
//   2. Gauss-Jordan without pivoting on [A' | I], pivot(j) = row j; step
//      j updates only the live columns [j, n+j], zero-pivot rule
//      inv = 1/(pv + (1 - has)), ok *= has
//   3. X = V inv(A') U^T
//   4. Rademacher probe against the ORIGINAL A: r = A (X v) - v,
//      bad = !(max|r| <= 1e-2 && ok)           (NaN-proof)
//   5. rescue, if bad: steps 1-4 again from A with the second draw
//      (R, S) (level 2); if still bad, the pivoted Gauss-Jordan of
//      gj_pivot.cuh on [A | I] with tol 0, rows un-permuted by perm
//      (level 3).  A matrix that reaches level 3 stays flagged.
//
// In-place elimination.  Step j's span [j, n+j] is n + 1 wide, but only n
// of its columns are ever read again: A-column j dies at step j (no later
// span starts at or before it), and I-column n + j enters the span at step
// j, where it is still exactly e_j (no earlier span reached it) with a
// pivot-row entry of exactly 1.  So the tile keeps n slots: slot c holds
// A'-column c until step c, and at step c it is overwritten by I-column
// n + c, computed as fmaf(-coeff[r], 1, r == c): the very operation the
// [n, 2n] tile performs on that column.  Every other slot takes the usual
// fmaf(-coeff[r], prow[slot], T[r, slot]), and the dropped update of the
// dying A-column was never read.  After n steps the slots hold inv(A') in
// natural column order, bitwise the [n, 2n] tile's right half on every
// input, non-finite ones included, on n * n floats instead of n * 2n.
//
// Mapping on the H100.  The TPU kernel holds 128 matrices in the vector
// lanes, [n, 2n, 128] in VMEM plus a pristine copy of A and a stash for
// the lanes a rescue must not touch.  Here one thread block holds one
// matrix, so levels 2 and 3 are branches on the block's own flag, and the
// original A stays in device memory (the TPU kernel's `acopy`), where the
// probe and the rebuilds read it again through L2.  A block of NW warps:
//  - loads A once, coalesced, one orbit (rows r + i n/4, columns
//    c + j n/4) a thread, applies U^T and V to the orbit in registers (the
//    butterflies of butterfly.cu) and stages A' in a column-major tile
//    T[c * (n | 1) + r] in shared memory;
//  - eliminates with the tile in registers: thread (warp, lane) owns rows
//    lane + 32 i (i < R) and slots warp + NW k (k < C), so a warp owns
//    whole columns.  The warp that owns slot j + 1 updates that column
//    first, computes step j + 1's pivot and coefficients and publishes
//    them into the second of two buffers; then every warp updates its
//    slots, one fmaf an element, and the lane that holds row j + 1 writes
//    that row's entries of its warp's slots to the second of two pivot-row
//    buffers; one barrier a step.  The four variants (NW, R, C) differ in
//    the shape they hold (n <= 32, 64, 128, 180; `inv_variant`); a
//    tile in shared memory (two accesses an element-step) measured
//    slower than registers at every n it was tried on;
//  - un-butterflies the inverse in place (V, then U^T, one orbit a
//    thread), probes it, and stores X coalesced from the tile.
// Level 3 needs the [n, 2n] tile of the pivoted steps, which does not fit
// a block's shared memory at n = 180; it lives in a device-memory scratch
// slot of the matrix (the wrapper's, n (2n | 1) floats a matrix), with
// the routine's small slots in shared memory.
//
// What bounds it.  The result needs n^2 (n + 1) FMAs a matrix (0.27 GFLOP
// at 1024 matrices of 64x64, 4 us at the FP32 rate) against n^2 floats
// read and written once in device memory (10 us at HBM's rate): bytes
// bound the ideal.  In practice each of the n steps is a chain (the
// owner's column, a division, the barrier) and the time is that chain's
// latency times n, hidden by the blocks an SM.
// Arithmetic: the butterflies round each product and sum separately and
// the eliminations use one fmaf per update, as the plain version and the
// JAX kernel on the CPU do, so that the kernel tracks the plain version
// to the bit, but for the order of the probe's sums (which moves only
// the probe's residual) and the plain version's double rounding.

#include "warp_pivot.cuh"

namespace {

constexpr float SQRT_HALF = 0.7071067811865476f;
constexpr float RTOL = 1e-2f;
constexpr int DEPTH = 2;           // n % 4 == 0: both levels' segments even
constexpr int ORB = 1 << DEPTH;    // an orbit is ORB x ORB
constexpr int INV_MAX_N = 180;     // the reference's cap

// Floats of the tile area: the n x n tile with column stride n | 1, or
// level 3's small slots (prow [2n], nfc [2][2n], coeff, pivoted, perm,
// pivs [n], argmax slots [2][nw]) if those are more.
__host__ __device__ inline size_t tile_floats(int n, int nw) {
  const size_t t = (size_t)n * (n | 1), l3 = 10 * (size_t)n + 2 * nw;
  return t > l3 ? t : l3;
}

// Floats of shared memory a block of nw warps takes for n: the tile area,
// two coefficient buffers [2][n], four diagonal pairs [2][n] (U, V, R, S),
// the probe v and X v [n], the block-max slots [nw] and the zero-pivot
// flag.
__host__ __device__ inline size_t inv_smem_floats(int n, int nw) {
  return tile_floats(n, nw) + 12 * (size_t)n + nw + 1;
}

struct Smem {
  float* T;      // the tile area, T[c * ld + r]
  float* coeff;  // [2][n]: the coefficients of steps j, j + 1
  float* diags;  // du, dv, eu, ev, [2][n] each
  float* v;      // the probe [n]
  float* xv;     // X v [n]
  float* red;    // [nw]
  int* zero;     // a zero pivot was met in this pass
  int ld;
};

__device__ inline Smem carve(float* base, int n, int nw) {
  Smem s;
  s.ld = n | 1;
  s.T = base;
  s.coeff = s.T + tile_floats(n, nw);
  s.diags = s.coeff + 2 * n;
  s.v = s.diags + 8 * n;
  s.xv = s.v + n;
  s.red = s.xv + n;
  s.zero = reinterpret_cast<int*>(s.red + nw);
  return s;
}

// NaN-propagating max, as jnp.max / torch.amax (fmaxf drops NaN).
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(GJ_FULL, v, o);
  return v;
}

// Max over the block of NT threads; `red` holds NT / 32 floats.
template <int NT>
__device__ float block_nanmax(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1)
    v = nanmax(v, __shfl_xor_sync(GJ_FULL, v, o));
  __syncthreads();  // `red` may still be read from its last use
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int q = 1; q < NT / 32; ++q) r = nanmax(r, red[q]);
  return r;
}

// One butterfly level on a line of ORB orbit values x[i * stride]: pairs
// (i, i + h) for the i with bit log2(h) clear, with the level's diagonal
// entries r[i] of the orbit.  TRANS applies B^T = (1/sqrt2)[[R0, R0],
// [R1, -R1]], else B = (1/sqrt2)[[R0, R1], [R0, -R1]], as butterfly.cu
// and ops/rbt.py's _bf_level.
template <bool TRANS>
__device__ __forceinline__ void bf_level(float* x, int stride, int h,
                                         const float* r) {
#pragma unroll
  for (int i = 0; i < ORB; ++i) {
    if (i & h) continue;
    const float t = x[i * stride], b = x[(i + h) * stride];
    const float r0 = r[i], r1 = r[i + h];
    float nt, nb;
    if (TRANS) {
      nt = __fmul_rn(r0, __fadd_rn(t, b));
      nb = __fmul_rn(r1, __fsub_rn(t, b));
    } else {
      nt = __fadd_rn(__fmul_rn(r0, t), __fmul_rn(r1, b));
      nb = __fsub_rn(__fmul_rn(r0, t), __fmul_rn(r1, b));
    }
    x[i * stride] = __fmul_rn(nt, SQRT_HALF);
    x[(i + h) * stride] = __fmul_rn(nb, SQRT_HALF);
  }
}

// The depth-2 butterfly along one side of the orbit: ORB lines, line k at
// x[k * line], entry i at x[i * stride]; r[l * ORB + i] is level l's
// diagonal at orbit entry i.  TRANS runs levels 0, 1, else 1, 0.
template <bool TRANS>
__device__ __forceinline__ void bf_side(float* x, int line, int stride,
                                        const float* r) {
#pragma unroll
  for (int k = 0; k < DEPTH; ++k) {
    const int lvl = TRANS ? k : DEPTH - 1 - k;
#pragma unroll
    for (int ln = 0; ln < ORB; ++ln)
      bf_level<TRANS>(x + ln * line, stride, 1 << (DEPTH - 1 - lvl),
                      r + lvl * ORB);
  }
}

// The orbits of the n x n matrix, one a thread: orbit t has rows
// r + i n/4 and columns c + j n/4 (r = t / (n/4), c = t % (n/4)), so that
// neighbouring threads take neighbouring columns.  `dr` / `dc` are the
// row and column sides' [2][n] diagonals.  LOAD reads the orbit from A
// (row-major, device memory) and applies B^T on both sides (A' = U^T A
// V); else it reads the orbit from the tile and applies B on both sides
// (X = V inv(A') U^T).  Either way it writes the orbit to the tile.
template <int NT, bool LOAD>
__device__ void butterfly_orbits(const float* __restrict__ A, float* T,
                                 int ld, int n, const float* dr,
                                 const float* dc) {
  const int q = n >> DEPTH;
  for (int t = threadIdx.x; t < q * q; t += NT) {
    const int r = t / q, c = t - r * q;
    float x[ORB * ORB], rr[DEPTH * ORB], rc[DEPTH * ORB];
#pragma unroll
    for (int i = 0; i < ORB; ++i) {
#pragma unroll
      for (int l = 0; l < DEPTH; ++l) {
        rr[l * ORB + i] = dr[l * n + r + i * q];
        rc[l * ORB + i] = dc[l * n + c + i * q];
      }
#pragma unroll
      for (int j = 0; j < ORB; ++j)
        x[i * ORB + j] = LOAD ? A[(size_t)(r + i * q) * n + c + j * q]
                              : T[(c + j * q) * ld + r + i * q];
    }
    bf_side<LOAD>(x, 1, ORB, rr);  // rows: line j, entries i
    bf_side<LOAD>(x, ORB, 1, rc);  // columns: line i, entries j
#pragma unroll
    for (int i = 0; i < ORB; ++i)
#pragma unroll
      for (int j = 0; j < ORB; ++j)
        T[(c + j * q) * ld + r + i * q] = x[i * ORB + j];
  }
}

// Step j's pivot and coefficients from column j's entries cv[i] (rows
// lane + 32 i) after step j - 1, by the warp that holds them: coefficients
// into cb, a zero pivot into *zero.
template <int R>
__device__ __forceinline__ void publish(const float (&cv)[R], int j,
                                        float* cb, int n, int lane,
                                        int* zero) {
  const float pv = row_value(cv, j >> 5, j & 31);
  const float has = fabsf(pv) > 0.f ? 1.f : 0.f;
  const float inv = 1.f / (pv + (1.f - has));
  if (lane == 0 && has == 0.f) *zero = 1;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = lane + 32 * i;
    if (r < n) cb[r] = r == j ? 1.f - inv : cv[i] * inv;
  }
}

// The n steps with the tile in registers, x[i][k] = T[lane + 32 i]
// [warp + NW k] (n <= 32 R, n <= NW C).  Reads the tile staged in shared
// memory and writes the result back there.  Step j's pivot row reaches
// each warp through shared memory: after its update of step j - 1 the
// lane that holds row j writes the row's entries of its warp's C slots,
// contiguous, into the buffer of step j, and after the barrier every lane
// of the warp reads them back as C / 4 broadcast 16-byte loads.
template <int NW, int R, int C>
__device__ void eliminate(const Smem& s, int n) {
  static_assert(C % 4 == 0, "the pivot row is read as float4");
  __shared__ __align__(16) float prow[2][NW * C];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ld = s.ld;
  float x[R][C];
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int r = lane + 32 * i, c = warp + NW * k;
      x[i][k] = r < n && c < n ? s.T[c * ld + r] : 0.f;
    }
  }
  // row j of this warp's slots into prow[b] (by the lane that holds it)
  auto put_row = [&](int j, int b) {
    const int ij = j >> 5;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (i == ij && lane == (j & 31)) {
        float4* dst = reinterpret_cast<float4*>(prow[b] + warp * C);
#pragma unroll
        for (int k = 0; k < C; k += 4)
          dst[k / 4] = make_float4(x[i][k], x[i][k + 1], x[i][k + 2],
                                   x[i][k + 3]);
      }
    }
  };
  put_row(0, 0);
  if (warp == 0) {  // step 0's column is warp 0's slot 0
    float cv[R];
#pragma unroll
    for (int i = 0; i < R; ++i) cv[i] = x[i][0];
    publish(cv, 0, s.coeff, n, lane, s.zero);
  }
  __syncthreads();

#pragma unroll 1
  for (int j = 0; j < n; ++j) {
    const float* cb = s.coeff + (j & 1) * n;
    float cf[R];
#pragma unroll
    for (int i = 0; i < R; ++i)
      cf[i] = lane + 32 * i < n ? cb[lane + 32 * i] : 0.f;
    float pk[C];
    const float4* src = reinterpret_cast<const float4*>(prow[j & 1] + warp * C);
#pragma unroll
    for (int k = 0; k < C; k += 4) {
      const float4 q = src[k / 4];
      pk[k] = q.x;
      pk[k + 1] = q.y;
      pk[k + 2] = q.z;
      pk[k + 3] = q.w;
    }
    // slot j turns into I-column n + j: e_j, with pivot-row entry 1
    if (warp == j % NW) {
      const int kj = j / NW;
#pragma unroll
      for (int k = 0; k < C; ++k) {
        if (k == kj) {
          pk[k] = 1.f;
#pragma unroll
          for (int i = 0; i < R; ++i) x[i][k] = lane + 32 * i == j ? 1.f : 0.f;
        }
      }
    }
    // the warp that owns slot j + 1 publishes step j + 1 first
    if (j + 1 < n && warp == (j + 1) % NW) {
      const int k1 = (j + 1) / NW;
      float cv[R];
#pragma unroll
      for (int k = 0; k < C; ++k) {
        if (k == k1) {
#pragma unroll
          for (int i = 0; i < R; ++i) cv[i] = fmaf(-cf[i], pk[k], x[i][k]);
        }
      }
      publish(cv, j + 1, s.coeff + ((j + 1) & 1) * n, n, lane, s.zero);
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int k = 0; k < C; ++k) x[i][k] = fmaf(-cf[i], pk[k], x[i][k]);
    }
    if (j + 1 < n) put_row(j + 1, (j + 1) & 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int r = lane + 32 * i, c = warp + NW * k;
      if (r < n && c < n) s.T[c * ld + r] = x[i][k];
    }
  }
}

// Levels 1 and 2: A' from A with the diagonals (du, dv), the n steps,
// the un-butterfly and the probe.  Returns the (block-uniform) flag; the
// inverse is left in the tile.
template <int NW, int R, int C>
__device__ bool nopivot_pass(const Smem& s, const float* __restrict__ A,
                             int n, const float* du, const float* dv) {
  constexpr int NT = NW * 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) *s.zero = 0;
  butterfly_orbits<NT, true>(A, s.T, s.ld, n, du, dv);
  __syncthreads();
  eliminate<NW, R, C>(s, n);
  __syncthreads();
  butterfly_orbits<NT, false>(nullptr, s.T, s.ld, n, dv, du);
  __syncthreads();

  // r = A (X v) - v, one warp a row: PG rows a warp at once, their loads
  // issued together, each row's sum in the order of one row at a time
  constexpr int PG = 4;
  for (int i0 = warp; i0 < n; i0 += PG * NW) {
    float acc[PG];
#pragma unroll
    for (int g = 0; g < PG; ++g) acc[g] = 0.f;
    for (int c = lane; c < n; c += 32) {
#pragma unroll
      for (int g = 0; g < PG; ++g) {
        const int i = i0 + g * NW;
        const float t = i < n ? s.T[c * s.ld + i] : 0.f;
        acc[g] = fmaf(t, s.v[c], acc[g]);
      }
    }
#pragma unroll
    for (int g = 0; g < PG; ++g) {
      const int i = i0 + g * NW;
      const float r = warp_sum(acc[g]);
      if (lane == 0 && i < n) s.xv[i] = r;
    }
  }
  __syncthreads();
  const bool ok = *s.zero == 0;  // read before the next pass resets it
  float rm = 0.f;
  for (int i0 = warp; i0 < n; i0 += PG * NW) {
    float acc[PG];
#pragma unroll
    for (int g = 0; g < PG; ++g) acc[g] = 0.f;
    for (int c = lane; c < n; c += 32) {
      float av[PG];
#pragma unroll
      for (int g = 0; g < PG; ++g) {
        const int i = i0 + g * NW;
        av[g] = i < n ? A[(size_t)i * n + c] : 0.f;
      }
#pragma unroll
      for (int g = 0; g < PG; ++g) acc[g] = fmaf(av[g], s.xv[c], acc[g]);
    }
#pragma unroll
    for (int g = 0; g < PG; ++g) {
      const int i = i0 + g * NW;
      const float r = warp_sum(acc[g]);
      if (i < n) rm = nanmax(rm, fabsf(r - s.v[i]));
    }
  }
  const float rmax = block_nanmax<NT>(rm, s.red);
  return !(rmax <= RTOL && ok);
}

// Level 3: pivoted Gauss-Jordan with tol 0 on [A | I] in the scratch slot
// W (n rows, stride 2n | 1, device memory), the routine's small slots
// carved from the tile area `area`; row j of the inverse is physical row
// perm[j] of the right half.  Writes X.
template <int NT>
__device__ void pivoted_level(float* area, float* W,
                              const float* __restrict__ A, int n,
                              float* __restrict__ X) {
  const int w = 2 * n;
  GJTile g;
  g.ld = gj_ld(w);
  g.T = W;
  g.prow = area;
  g.nfc = reinterpret_cast<int*>(g.prow + w);
  g.coeff = reinterpret_cast<float*>(g.nfc + 2 * w);
  g.pivoted = reinterpret_cast<int*>(g.coeff + n);
  g.perm = g.pivoted + n;
  g.pivs = reinterpret_cast<float*>(g.perm + n);
  g.redv = g.pivs + n;
  g.redi = reinterpret_cast<int*>(g.redv + NT / 32);
  for (int idx = threadIdx.x; idx < n * n; idx += NT) {
    const int r = idx / n, c = idx - r * n;
    W[r * g.ld + c] = A[idx];
    W[r * g.ld + n + c] = r == c ? 1.f : 0.f;
  }
  __syncthreads();
  gj_pivot_steps<NT>(g, n, w, 0.f);
  for (int idx = threadIdx.x; idx < n * n; idx += NT) {
    const int j = idx / n, c = idx - j * n;
    X[idx] = W[g.perm[j] * g.ld + n + c];
  }
}

// One block a matrix, NW warps, the tile in registers (R rows, C slots a
// thread).
template <int NW, int R, int C, int MINB>
__global__ void __launch_bounds__(NW * 32, MINB)
inv_rbt_kernel(const float* __restrict__ a, const float* __restrict__ du,
               const float* __restrict__ dv, const float* __restrict__ eu,
               const float* __restrict__ ev, const float* __restrict__ vr,
               float* __restrict__ x, bool* __restrict__ bad,
               float* __restrict__ scratch, int n, int rescue) {
  constexpr int NT = NW * 32;
  extern __shared__ float smem[];
  const Smem s = carve(smem, n, NW);
  const int tid = threadIdx.x;
  for (int i = tid; i < 2 * n; i += NT) {
    s.diags[i] = du[i];
    s.diags[2 * n + i] = dv[i];
    s.diags[4 * n + i] = eu[i];
    s.diags[6 * n + i] = ev[i];
  }
  for (int i = tid; i < n; i += NT) s.v[i] = vr[i];
  __syncthreads();

  const size_t m = blockIdx.x, nn = (size_t)n * n;
  const float* A = a + m * nn;
  float* X = x + m * nn;
  bool flag = nopivot_pass<NW, R, C>(s, A, n, s.diags, s.diags + 2 * n);
  bool level3 = false;
  if (rescue && flag) {
    flag = nopivot_pass<NW, R, C>(s, A, n, s.diags + 4 * n,
                                  s.diags + 6 * n);
    if (flag) {
      __syncthreads();  // the tile area becomes level 3's slots
      pivoted_level<NT>(s.T, scratch + m * n * (size_t)gj_ld(2 * n), A, n,
                        X);
      level3 = true;
    }
  }
  if (!level3) {
    for (int idx = tid; idx < n * n; idx += NT) {
      const int r = idx / n, c = idx - r * n;
      X[idx] = s.T[c * s.ld + r];
    }
  }
  if (tid == 0) bad[m] = flag;
}

// The variants, (V, NW, R, C, blocks an SM asked of the compiler): the
// tile in registers for n <= 32 R and n <= NW C.
#define INV_VARIANTS(X) \
  X(1, 4, 1, 8, 8)      \
  X(2, 8, 2, 8, 4)      \
  X(3, 16, 4, 8, 1)     \
  X(4, 16, 6, 12, 1)

// Whether `variant` takes n (n % 4 == 0, 4 <= n <= 180 besides).
__host__ __device__ inline bool inv_takes(int variant, int n) {
#define INV_TAKES(V, NW, R, C, MINB) \
  if (variant == V) return n <= 32 * R && n <= NW * C;
  INV_VARIANTS(INV_TAKES)
#undef INV_TAKES
  return false;
}

static const void* inv_function(int variant, int* nw) {
#define INV_CASE(V, NW, R, C, MINB) \
  if (variant == V) {               \
    *nw = NW;                       \
    return (const void*)inv_rbt_kernel<NW, R, C, MINB>; \
  }
  INV_VARIANTS(INV_CASE)
#undef INV_CASE
  *nw = 0;
  return nullptr;
}

}  // namespace

extern "C" {

// The variant that takes n: the smallest tile that holds it.
int inv_variant(int n) {
  if (n <= 32) return 1;
  if (n <= 64) return 2;
  if (n <= 128) return 3;
  return 4;
}

// Dynamic shared memory of `variant` at n, in bytes (0 for a variant that
// does not exist).
size_t inv_variant_smem(int variant, int n) {
  int nw = 0;
  return inv_function(variant, &nw) ? inv_smem_floats(n, nw) * sizeof(float)
                                     : 0;
}

// Shared memory the kernel takes for n, in bytes (its variant's).
size_t inv_rbt_smem_bytes(int n) {
  return inv_variant_smem(inv_variant(n), n);
}

// Registers a thread, local (spill) bytes a thread and resident blocks an
// SM of `variant` at n into out[0..2] (`unused` keeps the signature of the
// other kernels' attribute functions); returns the cudaError_t.
int inv_attributes(int variant, int n, int unused, int* out) {
  (void)unused;
  int nw = 0;
  const void* fn = inv_function(variant, &nw);
  if (!fn) return (int)cudaErrorInvalidValue;
  const size_t smem = inv_variant_smem(variant, n);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, nw * 32,
                                                      smem);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = blocks;
  return (int)err;
}

// Launches `variant` (inv_variant(n) when < 0) on `stream`; returns the
// cudaError_t of the launch (0 on success), or cudaErrorInvalidValue for
// an n the kernel does not take (n % 4 != 0, n < 4, n > 180) or a variant
// that does not take n.  Device pointers to contiguous f32 data: a and x
// [batch, n, n] (not the same memory), du, dv, eu, ev [2, n], vr [n]; bad
// is [batch] bool; scratch holds n (2n | 1) floats a matrix and is used
// only with `rescue` != 0 (levels 2 and 3).
int inv_rbt_f32(const void* a, const void* du, const void* dv,
                const void* eu, const void* ev, const void* vr, void* x,
                void* bad, void* scratch, int batch, int n, int variant,
                int rescue, void* stream) {
  if (n < 4 || n % 4 || n > INV_MAX_N) return (int)cudaErrorInvalidValue;
  if (variant < 0) variant = inv_variant(n);
  int nw = 0;
  const void* fn = inv_function(variant, &nw);
  if (!fn || !inv_takes(variant, n) || (rescue && !scratch))
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  const size_t smem = inv_variant_smem(variant, n);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  const float* A = (const float*)a;
  switch (variant) {
#define INV_LAUNCH(V, NW, R, C, MINB)                                        \
  case V:                                                                    \
    inv_rbt_kernel<NW, R, C, MINB><<<batch, NW * 32, smem, st>>>(            \
        A, (const float*)du, (const float*)dv, (const float*)eu,             \
        (const float*)ev, (const float*)vr, (float*)x, (bool*)bad,           \
        (float*)scratch, n, rescue);                                         \
    break;
    INV_VARIANTS(INV_LAUNCH)
#undef INV_LAUNCH
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
