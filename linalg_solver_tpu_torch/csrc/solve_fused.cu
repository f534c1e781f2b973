// One-launch random-butterfly solve of a batch of dense systems A x = b.
//
// Replaces the Pallas TPU kernel `_fused_kernel` in
// linalg_solver_tpu/ops/pallas/solve_fused_kernel.py (launched by
// `_fused_call` from `solve_fused_rbt`).  Same math, per system:
//   1. amax = max|A|, bmax = max|b|                (NaN-propagating)
//   2. A' = U^T A V, b' = U^T b                     (depth <= 2 butterflies)
//   3. pivot-free LU of A' (pivot(c) = row c), zero-pivot rule
//      inv = 1/(pv + (1 - has)), ok *= has
//   4. forward + back substitution, x = V y
//   5. ir_steps rounds of f32 refinement against the ORIGINAL A
//   6. the NaN-proof per-system gate of the TPU kernel
//
// Mapping on the H100.  The TPU kernel keeps 128 systems in the vector
// lanes with the whole [N, N, 128] tile in VMEM.  Here the kernel has
// three variants, chosen by shape (`solve_variant`):
//  - 1 and 2, the on-chip variants (96 <= N <= 256; see the section
//    below): A' stays in shared memory from load to solution, in one
//    thread block a system (1) or, where it does not fit, in a cluster of
//    two blocks (2, k <= 4);
//  - 0, every other shape: one thread block solves one system.  A
//    256x256 f32 matrix (256 KB) exceeds the 227 KB of shared memory a
//    block may use, so the working copy of A' lives in a device-memory
//    scratch (`work`, [B, N, N], stored column-major so that a column of
//    L or U is contiguous), where it sits mostly in the 50 MB L2.
// The original `a` is left untouched for the refinement residuals (the
// TPU kernel's `hold_orig` copy).
//
// What bounds variant 0.  A rank-1 right-looking LU straight on the
// scratch reads and writes the trailing matrix once per column:
// ~N^3/3 * 8 bytes of L2/HBM traffic per system (11 GB at B = N = 256).
// The design therefore factors in panels of NB = 32 columns: the panel is
// factored rank-1 in shared memory, the block row U12 is a small
// triangular solve, and the trailing matrix takes one rank-32 update per
// panel from shared L21/U12 tiles (register micro-tiles of 4x4), which
// cuts that traffic 32-fold.  What remains is latency inside each block:
// scalar FP32 FMA chains and a barrier per rank-1 step of each panel,
// plus ~3 barriers per 32 columns of each substitution (measured on an
// H100 at 700 W, B = N = 256: 1.27 ms, 3.4% of the FP32 peak).  The
// subtraction order of every element is the rank-1 order of the TPU
// kernel.  The substitutions solve each 32x32 diagonal block in one warp
// with shuffles, then update the rest with a block-wide GEMV.
// Not ported: the streamed-residual variant, `unroll`, `nb` and the VMEM
// budgets, which exist only for Mosaic and VMEM.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int NT = 256;           // threads per block
constexpr int NWARP = NT / 32;
constexpr int NB = 32;            // LU panel width == warp width
constexpr int MAX_K = 8;          // RHS columns (MAX_K_RHS)
constexpr unsigned FULL = 0xffffffffu;
constexpr float SQRT_HALF = 0.7071067811865476f;
constexpr size_t MAX_SMEM = 232448;  // shared memory a block may use, sm_90

// NaN-propagating max, as jnp.max / torch.amax (fmaxf drops NaN).
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// Max over a block of NTH threads; every thread passes its partial and
// gets the result.  `red` holds NTH / 32 floats of shared memory.
template <int NTH = NT>
__device__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = nanmax(v, __shfl_xor_sync(FULL, v, o));
  __syncthreads();  // `red` may still be read from the previous call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < NTH / 32; ++w) r = nanmax(r, red[w]);
  return r;
}

template <int NTH = NT>
__device__ float absmax(const float* v, int len, float* red) {
  float m = 0.f;
  for (int i = threadIdx.x; i < len; i += NTH) m = nanmax(m, fabsf(v[i]));
  return block_max<NTH>(m, red);
}

// One butterfly level (segment `seg`) along the `mix` axis of a set of
// lines: element (p, o) sits at M[p * sm + o * so], p < n, o < n_other.
// `trans` applies B^T = (1/sqrt2)[[R0, R0], [R1, -R1]], else
// B = (1/sqrt2)[[R0, R1], [R0, -R1]], as ops/rbt.py's _bf_level.
template <int NTH = NT>
__device__ void bf_level(float* M, int n, int sm, int so, int n_other,
                         const float* r, int seg, bool trans,
                         bool other_fast) {
  const int h = seg >> 1, half = n >> 1, total = half * n_other;
  for (int idx = threadIdx.x; idx < total; idx += NTH) {
    int p, o;
    if (other_fast) {
      o = idx % n_other;
      p = idx / n_other;
    } else {
      p = idx % half;
      o = idx / half;
    }
    const int top = (p / h) * seg + (p % h), bot = top + h;
    float* pt = M + (size_t)top * sm + (size_t)o * so;
    float* pb = M + (size_t)bot * sm + (size_t)o * so;
    const float t = *pt, b = *pb, r0 = r[top], r1 = r[bot];
    float nt, nb;
    if (trans) {
      nt = r0 * (t + b);
      nb = r1 * (t - b);
    } else {
      nt = r0 * t + r1 * b;
      nb = r0 * t - r1 * b;
    }
    *pt = nt * SQRT_HALF;
    *pb = nb * SQRT_HALF;
  }
}

// Depth-d butterfly: `trans` applies levels 0..d-1, else d-1..0.
// `diags` is [2][n]; only the first `depth` levels are read.
template <int NTH = NT>
__device__ void butterfly(float* M, int n, int sm, int so, int n_other,
                          const float* diags, int depth, bool trans,
                          bool other_fast) {
  for (int i = 0; i < depth; ++i) {
    const int lvl = trans ? i : depth - 1 - i;
    bf_level<NTH>(M, n, sm, so, n_other, diags + lvl * n, n >> lvl, trans,
                  other_fast);
    __syncthreads();
  }
}

// Vector slabs in shared memory: slab kk of length n at v + kk * n.
template <int NTH = NT>
__device__ void butterfly_vec(float* v, int n, int k, const float* diags,
                              int depth, bool trans) {
  butterfly<NTH>(v, n, 1, n, k, diags, depth, trans, false);
}

// S[j * n + i] = A[i * n + j] through 32x33 shared tiles; returns max|A|.
__device__ float load_transposed(const float* A, float* S, int n,
                                 float* tile, float* red) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  float m = 0.f;
  for (int i0 = 0; i0 < n; i0 += 32) {
    for (int j0 = 0; j0 < n; j0 += 32) {
      for (int q = ty; q < 32; q += NWARP) {
        const int i = i0 + q, j = j0 + tx;
        if (i < n && j < n) {
          const float v = A[(size_t)i * n + j];
          m = nanmax(m, fabsf(v));
          tile[q * 33 + tx] = v;
        }
      }
      __syncthreads();
      for (int q = ty; q < 32; q += NWARP) {
        const int j = j0 + q, i = i0 + tx;
        if (i < n && j < n) S[(size_t)j * n + i] = tile[tx * 33 + q];
      }
      __syncthreads();
    }
  }
  return block_max(m, red);
}

// Pivot-free LU of the column-major S in place: unit-lower multipliers
// below the diagonal, U on and above it, ipiv[c] = 1 / U[c][c] (with the
// zero-pivot rule).  P and U12 are NB * n floats of shared memory each.
// Returns ok (0 if any pivot was zero or NaN).
__device__ float lu_factor(float* S, int n, float* P, float* U12,
                           float* ipiv) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float ok = 1.f;
  for (int k0 = 0; k0 < n; k0 += NB) {
    const int w = min(NB, n - k0), m = n - k0;
    // Panel: P[s * n + r] = A'(k0 + r, k0 + s), r < m, s < w.
    for (int idx = tid; idx < w * m; idx += NT) {
      const int s = idx / m, r = idx % m;
      P[s * n + r] = S[(size_t)(k0 + s) * n + k0 + r];
    }
    __syncthreads();
    for (int s = 0; s < w; ++s) {
      const float pv = P[s * n + s];
      const float has = fabsf(pv) > 0.f ? 1.f : 0.f;
      const float inv = 1.f / (pv + (1.f - has));
      ok *= has;
      for (int r = s + 1 + tid; r < m; r += NT) {
        const float l = P[s * n + r] * inv;
        P[s * n + r] = l;
        for (int t = s + 1; t < w; ++t) P[t * n + r] -= P[t * n + s] * l;
      }
      if (tid == 0) ipiv[k0 + s] = inv;
      __syncthreads();
    }
    for (int idx = tid; idx < w * m; idx += NT) {
      const int s = idx / m, r = idx % m;
      S[(size_t)(k0 + s) * n + k0 + r] = P[s * n + r];
    }
    __syncthreads();
    const int k1 = k0 + w, mr = n - k1;
    if (mr == 0) break;  // w == NB below: only the last panel is narrower
    // U12 = L11^{-1} A12, one column per thread; U12[s * n + jj].
    for (int jj = tid; jj < mr; jj += NT) {
      float* col = S + (size_t)(k1 + jj) * n + k0;
      float u[NB];
#pragma unroll
      for (int r = 0; r < NB; ++r) u[r] = col[r];
#pragma unroll
      for (int r = 1; r < NB; ++r) {
        float acc = u[r];
#pragma unroll
        for (int s = 0; s < r; ++s) acc -= P[s * n + r] * u[s];
        u[r] = acc;
      }
#pragma unroll
      for (int r = 0; r < NB; ++r) {
        col[r] = u[r];
        U12[r * n + jj] = u[r];
      }
    }
    __syncthreads();
    // A22 -= L21 U12: each warp owns 4 columns of a 128 x 32 tile, each
    // lane rows lane + 32q (coalesced on the column-major scratch).
    for (int i0 = 0; i0 < mr; i0 += 128) {
      for (int j0 = 0; j0 < mr; j0 += 4 * NWARP) {
        const int jb = j0 + 4 * warp;
        float acc[4][4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int i = i0 + lane + 32 * q, j = jb + c;
            acc[q][c] = (i < mr && j < mr)
                            ? S[(size_t)(k1 + j) * n + k1 + i] : 0.f;
          }
        }
#pragma unroll 4
        for (int s = 0; s < NB; ++s) {
          float lv[4], uv[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int i = i0 + lane + 32 * q;
            lv[q] = i < mr ? P[s * n + w + i] : 0.f;
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = jb + c;
            uv[c] = j < mr ? U12[s * n + j] : 0.f;
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[q][c] -= lv[q] * uv[c];
          }
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int i = i0 + lane + 32 * q, j = jb + c;
            if (i < mr && j < mr) S[(size_t)(k1 + j) * n + k1 + i] = acc[q][c];
          }
        }
      }
    }
    __syncthreads();
  }
  return ok;
}

// vec := L^{-1} vec for each of the k slabs (L unit lower, in S).
__device__ void forward(const float* S, int n, float* vec, int k) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int k0 = 0; k0 < n; k0 += NB) {
    const int w = min(NB, n - k0);
    if (warp < k) {  // warp kk solves the diagonal block of slab kk
      float lrow[NB];  // lrow[s] = L(k0 + lane, k0 + s)
#pragma unroll
      for (int s = 0; s < NB; ++s)
        lrow[s] = (s < w && lane < w) ? S[(size_t)(k0 + s) * n + k0 + lane]
                                      : 0.f;
      float* v = vec + warp * n + k0;
      float y = lane < w ? v[lane] : 0.f;
#pragma unroll
      for (int s = 0; s < NB; ++s) {
        if (s < w) {
          const float ys = __shfl_sync(FULL, y, s);
          if (lane > s) y -= lrow[s] * ys;
        }
      }
      if (lane < w) v[lane] = y;
    }
    __syncthreads();
    const int k1 = k0 + w, mr = n - k1;
    for (int idx = tid; idx < mr * k; idx += NT) {
      const int i = idx % mr, kk = idx / mr;
      const float* yb = vec + kk * n + k0;
      float acc = vec[kk * n + k1 + i];
      for (int s = 0; s < w; ++s)
        acc -= S[(size_t)(k0 + s) * n + k1 + i] * yb[s];
      vec[kk * n + k1 + i] = acc;
    }
    __syncthreads();
  }
}

// vec := U^{-1} vec for each of the k slabs (U upper in S, 1/diag ipiv).
__device__ void backward(const float* S, int n, const float* ipiv,
                         float* vec, int k) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int k0 = ((n - 1) / NB) * NB; k0 >= 0; k0 -= NB) {
    const int w = min(NB, n - k0);
    if (warp < k) {
      float urow[NB];  // urow[s] = U(k0 + lane, k0 + s)
#pragma unroll
      for (int s = 0; s < NB; ++s)
        urow[s] = (s < w && lane < w) ? S[(size_t)(k0 + s) * n + k0 + lane]
                                      : 0.f;
      float* v = vec + warp * n + k0;
      float y = lane < w ? v[lane] : 0.f;
      const float ip = lane < w ? ipiv[k0 + lane] : 0.f;
#pragma unroll
      for (int s = NB - 1; s >= 0; --s) {
        if (s < w) {
          if (lane == s) y *= ip;
          const float xs = __shfl_sync(FULL, y, s);
          if (lane < s) y -= urow[s] * xs;
        }
      }
      if (lane < w) v[lane] = y;
    }
    __syncthreads();
    for (int idx = tid; idx < k0 * k; idx += NT) {
      const int i = idx % k0, kk = idx / k0;
      const float* xb = vec + kk * n + k0;
      float acc = vec[kk * n + i];
      for (int s = w - 1; s >= 0; --s)
        acc -= S[(size_t)(k0 + s) * n + i] * xb[s];
      vec[kk * n + i] = acc;
    }
    __syncthreads();
  }
}

// rv := bo - A xv against the original row-major A: a warp takes four
// rows at a time and issues the loads of four 32-column chunks of each
// before it sums them (a row's sum over the lanes' columns in order, then
// over the lanes).
template <int NTH = NT>
__device__ void residual(const float* A, int n, const float* bo,
                         const float* xv, float* rv, int k) {
  constexpr int NWP = NTH / 32, ROWS = 4, CH = 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i0 = warp; i0 < n; i0 += ROWS * NWP) {
    const float* row[ROWS];
#pragma unroll
    for (int q = 0; q < ROWS; ++q)
      row[q] = A + (size_t)min(i0 + q * NWP, n - 1) * n;
    float acc[ROWS][MAX_K];
#pragma unroll
    for (int q = 0; q < ROWS; ++q) {
#pragma unroll
      for (int kk = 0; kk < MAX_K; ++kk) acc[q][kk] = 0.f;
    }
    for (int j0 = 0; j0 < n; j0 += 32 * CH) {
      float a[CH][ROWS];
#pragma unroll
      for (int t = 0; t < CH; ++t) {
        const int j = min(j0 + 32 * t + lane, n - 1);
#pragma unroll
        for (int q = 0; q < ROWS; ++q) a[t][q] = row[q][j];
      }
#pragma unroll
      for (int t = 0; t < CH; ++t) {
        const int j = j0 + 32 * t + lane;
        if (j < n) {
#pragma unroll
          for (int kk = 0; kk < MAX_K; ++kk) {
            if (kk < k) {
              const float xj = xv[kk * n + j];
#pragma unroll
              for (int q = 0; q < ROWS; ++q)
                acc[q][kk] = fmaf(a[t][q], xj, acc[q][kk]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < ROWS; ++q) {
      const int i = i0 + q * NWP;
#pragma unroll
      for (int kk = 0; kk < MAX_K; ++kk) {
        if (kk < k) {
          float sum = acc[q][kk];
          for (int o = 16; o > 0; o >>= 1)
            sum += __shfl_xor_sync(FULL, sum, o);
          if (lane == 0 && i < n) rv[kk * n + i] = bo[kk * n + i] - sum;
        }
      }
    }
  }
  __syncthreads();
}

// Steps 4-6, once A' is factored, in a block of NTH threads: with yv
// holding b' = U^T b, solve for y, x = V y, ir_steps rounds of f32
// refinement against the original A (gate statistics as the TPU kernel:
// rmax and xmax before the last correction, zcmax after the un-butterfly
// of the last correction), then the NaN-proof gate (nan <= t is false,
// the TPU kernel's thresholds).  solve(v) runs the forward and back
// substitution on the k slabs of v in place.  Writes xo ([n, k]
// row-major, like b) and *bad_out.
template <int NTH, class Solve>
__device__ void solve_refine_gate(const float* A, int n, int k, int depth,
                                  int ir_steps, const float* sdu,
                                  const float* sdv, const float* bo,
                                  float* yv, float* xv, float* rv,
                                  float* red, float ok, float amax,
                                  float bmax, float* xo, bool* bad_out,
                                  Solve&& solve) {
  const int tid = threadIdx.x, kn = k * n;
  solve(yv);
  for (int i = tid; i < kn; i += NTH) xv[i] = yv[i];
  __syncthreads();
  butterfly_vec<NTH>(xv, n, k, sdv, depth, false);  // x = V y

  float rmax = 0.f, xmax = 0.f, zcmax = 0.f;
  for (int step = 0; step < ir_steps; ++step) {
    const bool last = step == ir_steps - 1;
    residual<NTH>(A, n, bo, xv, rv, k);
    if (last) {
      rmax = absmax<NTH>(rv, kn, red);
      xmax = absmax<NTH>(xv, kn, red);
    }
    butterfly_vec<NTH>(rv, n, k, sdu, depth, true);
    solve(rv);
    butterfly_vec<NTH>(rv, n, k, sdv, depth, false);
    if (last) zcmax = absmax<NTH>(rv, kn, red);
    __syncthreads();
    for (int i = tid; i < kn; i += NTH) xv[i] += rv[i];
    __syncthreads();
  }
  float xnow = 0.f;
  if (ir_steps == 0) {
    residual<NTH>(A, n, bo, xv, rv, k);
    rmax = absmax<NTH>(rv, kn, red);
    xnow = absmax<NTH>(xv, kn, red);
  }

  const float eps = 1e-30f;
  bool flag = ok < 0.5f;
  if (ir_steps == 0) {
    const float scale = nanmax(bmax, amax * xnow);
    flag = flag || !(rmax <= 1e-2f * nanmax(scale, eps));
  } else {
    flag = flag || !(zcmax <= 0.3f * nanmax(xmax, eps));
    if (ir_steps >= 2) {
      const float scale = nanmax(bmax, amax * xmax);
      flag = flag || !(rmax <= 1e-4f * nanmax(scale, eps));
    }
  }
  for (int idx = tid; idx < kn; idx += NTH)
    xo[idx] = xv[(idx % k) * n + idx / k];
  if (tid == 0) *bad_out = flag;
}

// P and U12 (NB * n floats each; at least one 32x33 transpose tile).
__host__ __device__ size_t panel_floats(int n) {
  const size_t pu = (size_t)2 * NB * n;
  return pu > 32 * 33 ? pu : 32 * 33;
}

size_t smem_floats(int n, int k) {
  // P + U12, du + dv, bo/yv/xv/rv, ipiv, reduction slots
  return panel_floats(n) + 4 * (size_t)n + 4 * (size_t)k * n + n + NWARP;
}

__global__ void __launch_bounds__(NT, 2)
solve_fused_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   const float* __restrict__ du, const float* __restrict__ dv,
                   float* __restrict__ work, float* __restrict__ x,
                   bool* __restrict__ bad, int n, int k, int depth,
                   int ir_steps) {
  extern __shared__ float smem[];
  float* P = smem;
  float* U12 = P + NB * n;
  float* sdu = smem + panel_floats(n);
  float* sdv = sdu + 2 * n;
  float* bo = sdv + 2 * n;
  float* yv = bo + k * n;
  float* xv = yv + k * n;
  float* rv = xv + k * n;
  float* ipiv = rv + k * n;
  float* red = ipiv + n;

  const int tid = threadIdx.x, kn = k * n;
  const size_t sys = blockIdx.x;
  const float* A = a + sys * n * n;
  float* S = work + sys * n * n;
  const float* bb = b + sys * kn;

  for (int i = tid; i < 2 * n; i += NT) {
    sdu[i] = du[i];
    sdv[i] = dv[i];
  }
  float bm = 0.f;
  for (int idx = tid; idx < kn; idx += NT) {  // b is [n, k] row-major
    const float v = bb[idx];
    bo[(idx % k) * n + idx / k] = v;
    bm = nanmax(bm, fabsf(v));
  }
  const float bmax = block_max(bm, red);
  const float amax = load_transposed(A, S, n, P, red);

  // A' = U^T A V (rows by U^T, then columns by V^T); b' = U^T b.
  butterfly(S, n, 1, n, n, sdu, depth, true, false);
  butterfly(S, n, n, 1, n, sdv, depth, true, true);
  for (int i = tid; i < kn; i += NT) yv[i] = bo[i];
  __syncthreads();
  butterfly_vec(yv, n, k, sdu, depth, true);

  const float ok = lu_factor(S, n, P, U12, ipiv);
  solve_refine_gate<NT>(A, n, k, depth, ir_steps, sdu, sdv, bo, yv, xv, rv,
                        red, ok, amax, bmax, x + sys * kn, bad + sys,
                        [&](float* v) {
                          forward(S, n, v, k);
                          backward(S, n, ipiv, v, k);
                        });
}


// ---------------------------------------------------------------------
// The on-chip variants (N <= 256): A' never leaves the chip.
//
// A block of OC_NT = 512 threads holds, column-major with the odd column
// stride n + 1, the columns of A' in its 32-wide panels: all of them
// (variant 1, one block a system, where they fit its shared memory with
// the vectors), or every other panel (variant 2: a cluster of two blocks
// a system, panel p in block p % 2, the blocks reading each other's
// shared memory; at N = 256 the 256 KB of A' exceed one block's 227 KB).
//  - Load: each thread takes groups of 2^depth x 2^depth rows and columns
//    {i + q n/2^depth} x {j + r n/2^depth}, which a depth <= 2 two-sided
//    butterfly maps onto themselves; it reads them from A once (coalesced
//    across the warp), applies U^T to the rows and V^T to the columns
//    with the plain version's formulas and order, and stores A' into the
//    block that owns each column.
//  - Panel p: its owner factors the 32 x 32 diagonal block in one warp
//    (a lane a row, the pivot read directly: the TPU kernel's
//    pv = work[c, c], shuffles and no barrier), then, every thread a row,
//    the rows below it (L21 = A21 U11^-1, each row on its own) and, a
//    thread a column, U12 = L11^-1 A12 for its own later columns.  After
//    a cluster barrier the peer copies the panel into its own shared
//    memory and solves U12 for its columns, and each block updates its
//    part of A22 with 4 x 4 register tiles.  Every entry takes its
//    rank-1 terms in the plain version's order, one fmaf each.  (The
//    panel of kernel 5, lu_nopivot.cu, cannot split its rows so: its
//    one-hot pivot reads the whole column at every step.)
//  - The diagonal blocks then take their inverses in place (L^-1 below
//    the diagonal, U^-1 on and above it, 1 / U(r, r) the zero-pivot
//    rule's ipiv), two warps a block.
//  - Solves (block 0 of the system, reading the peer's columns through
//    distributed shared memory): a 32-row block at a time, warp kk < k
//    first applies the previous block's contribution to this block's rows
//    for slab kk, then multiplies by the diagonal block's inverse (32
//    shuffles, no chain of them); the other warps meanwhile apply the
//    previous block's contribution to every later row.  One barrier a
//    block; every load issued before the sums, each sum in four partial
//    sums (the substitutions' order of terms is the kernel's own: the
//    refinement, not the order, sets the result's accuracy).
//  - Residuals re-read the original A from device memory, a warp four
//    rows at a time.
// What bounds it: the serial chains (the diagonal blocks' 32 steps, the
// 6 N / 32 substitution blocks, the barriers between the phases) and the
// latency of the A reads, not the 2.9 GFLOP of a B = N = 256 call (44 us
// at 67 TFLOP/s) nor its A reads (3 x 67 MB, 60 us at 3.35 TB/s):
// measured on an H100 at 700 W, B = N = 256, k = 1, 1.15 ms (variant 0:
// 1.27), each system holding two SMs for a quarter of it.

constexpr int OC_NW = 16;            // warps a block
constexpr int OC_NT = OC_NW * 32;
constexpr int OC_MAX_N = 256;        // past it a block cannot hold its
                                     // panels of A' with the vectors
constexpr int OC_MIN_N = 96;         // the routes (solve_variant)
constexpr int OC_CLUSTER_MAX_K = 4;

// Local columns of A' a block of a `cl`-block system holds (whole panels).
__host__ __device__ inline int onchip_cols(int n, int cl) {
  const int panels = (n + NB - 1) / NB;
  return NB * ((panels + cl - 1) / cl);
}

__host__ __device__ inline size_t onchip_smem_floats(int n, int k, int cl) {
  const size_t ld = (size_t)n + 1;
  return onchip_cols(n, cl) * ld          // the block's columns of A'
         + (cl > 1 ? NB * ld : 0)         // a copy of a peer's panel
         + 4 * (size_t)n                  // du, dv
         + 4 * (size_t)k * n              // bo, yv, xv, rv
         + n                              // ipiv (of its own panels)
         + OC_NW + 4;                     // reduction, amax and flag slots
}

template <int CL>
__device__ __forceinline__ void cluster_barrier() {
  if constexpr (CL > 1)
    cooperative_groups::this_cluster().sync();
  else
    __syncthreads();
}

// A' of the 2^D x 2^D group of rows {i + a Q} and columns {j + c Q}
// (Q = n >> D), stored into the column-major blocks of A' that own its
// columns (`dst[0]` owns the panels p % CL == 0, `dst[1]` the others;
// column stride ld); am takes max |A| (NaN-propagating).
template <int D, int CL>
__device__ __forceinline__ void load_group(const float* A, int n, int i,
                                           int j, const float* sdu,
                                           const float* sdv,
                                           float* const (&dst)[CL], int ld,
                                           float& am) {
  constexpr int G = 1 << D;
  const int Q = n >> D;
  float v[G][G];
#pragma unroll
  for (int a = 0; a < G; ++a) {
#pragma unroll
    for (int c = 0; c < G; ++c) {
      v[a][c] = A[(size_t)(i + a * Q) * n + j + c * Q];
      am = nanmax(am, fabsf(v[a][c]));
    }
  }
#pragma unroll
  for (int l = 0; l < D; ++l) {  // rows by U^T: levels 0 .. D-1
    const int half = G >> (l + 1);
    const float* r = sdu + l * n;
#pragma unroll
    for (int a = 0; a < G; ++a) {
      if (a & half) continue;
      const float r0 = r[i + a * Q], r1 = r[i + (a + half) * Q];
#pragma unroll
      for (int c = 0; c < G; ++c) {
        const float t = v[a][c], b = v[a + half][c];
        v[a][c] = (r0 * (t + b)) * SQRT_HALF;
        v[a + half][c] = (r1 * (t - b)) * SQRT_HALF;
      }
    }
  }
#pragma unroll
  for (int l = 0; l < D; ++l) {  // then columns by V^T
    const int half = G >> (l + 1);
    const float* r = sdv + l * n;
#pragma unroll
    for (int c = 0; c < G; ++c) {
      if (c & half) continue;
      const float r0 = r[j + c * Q], r1 = r[j + (c + half) * Q];
#pragma unroll
      for (int a = 0; a < G; ++a) {
        const float t = v[a][c], b = v[a][c + half];
        v[a][c] = (r0 * (t + b)) * SQRT_HALF;
        v[a][c + half] = (r1 * (t - b)) * SQRT_HALF;
      }
    }
  }
#pragma unroll
  for (int c = 0; c < G; ++c) {
    const int col = j + c * Q;
    float* d = dst[0];
    if constexpr (CL > 1) d = (col / NB) % CL ? dst[1] : dst[0];
    d += (size_t)((col / NB / CL) * NB + col % NB) * ld;
#pragma unroll
    for (int a = 0; a < G; ++a) d[i + a * Q] = v[a][c];
  }
}

// The system's factored A' as its solves read it: column s of panel p is
// blocks[p % CL] + ((p / CL) * NB + s) * ld.
template <int CL>
struct Columns {
  const float* blocks[CL];
  int ld;
  __device__ __forceinline__ const float* panel(int p) const {
    const float* base = blocks[0];
    if constexpr (CL > 1) base = (p & 1) ? blocks[1] : blocks[0];
    return base + (size_t)(p / CL) * NB * ld;
  }
};

// vec := L^{-1} vec for the k slabs (L unit lower in A', the diagonal
// blocks holding their inverses).
template <int CL>
__device__ void onchip_forward(const Columns<CL> A, int n, float* vec,
                               int k) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ld = A.ld, panels = (n + NB - 1) / NB;
  float yprev = 0.f;  // warp kk < k: the previous block's y, lane s entry s
  for (int p = 0; p < panels; ++p) {
    const int k0 = p * NB, w = min(NB, n - k0);
    if (warp < k) {
      // Every load is issued before the chain that uses it; rows past n
      // (lane >= w) read what follows the column in shared memory, and
      // their results are never used.
      float* v = vec + warp * n + k0;
      float y = lane < w ? v[lane] : 0.f;
      float e[NB];
      if (p > 0) {  // the previous block's (full) columns, rows of block p
        const float* Lp = A.panel(p - 1) + k0;
#pragma unroll
        for (int s = 0; s < NB; ++s) e[s] = Lp[s * ld + lane];
        float part[4] = {y, 0.f, 0.f, 0.f};
#pragma unroll
        for (int s = 0; s < NB; ++s)
          part[s % 4] = fmaf(-e[s], __shfl_sync(FULL, yprev, s), part[s % 4]);
        y = (part[0] + part[1]) + (part[2] + part[3]);
      }
      // y_p = L_pp^{-1} z: the block holds the inverse below its diagonal
      const float* Di = A.panel(p) + k0;
#pragma unroll
      for (int s = 0; s < NB; ++s) e[s] = Di[s * ld + lane];
      const float z = y;
      float part[4] = {y, 0.f, 0.f, 0.f};
#pragma unroll
      for (int s = 0; s < NB; ++s) {
        const float t = fmaf(e[s], __shfl_sync(FULL, z, s), part[s % 4]);
        part[s % 4] = s < lane && s < w ? t : part[s % 4];
      }
      y = (part[0] + part[1]) + (part[2] + part[3]);
      if (lane < w) v[lane] = y;
      yprev = y;
    } else if (p > 0) {  // rows past block p take block p - 1
      const float* Lp = A.panel(p - 1);
      for (int i = k0 + NB + tid - k * 32; i < n; i += OC_NT - k * 32) {
        float l[NB];
#pragma unroll
        for (int s = 0; s < NB; ++s) l[s] = Lp[s * ld + i];
        for (int kk = 0; kk < k; ++kk) {
          const float* yb = vec + kk * n + k0 - NB;
          float part[4] = {vec[kk * n + i], 0.f, 0.f, 0.f};
#pragma unroll
          for (int s = 0; s < NB; ++s)
            part[s % 4] = fmaf(-l[s], yb[s], part[s % 4]);
          vec[kk * n + i] = (part[0] + part[1]) + (part[2] + part[3]);
        }
      }
    }
    __syncthreads();
  }
}

// vec := U^{-1} vec for the k slabs (U upper in A', the diagonal blocks
// holding their inverses).
template <int CL>
__device__ void onchip_backward(const Columns<CL> A, int n, float* vec,
                                int k) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ld = A.ld, panels = (n + NB - 1) / NB;
  float xnext = 0.f;  // warp kk < k: the next block's x, lane s entry s
  for (int p = panels - 1; p >= 0; --p) {
    const int k0 = p * NB, w = min(NB, n - k0);
    const int wn = p + 1 < panels ? min(NB, n - k0 - NB) : 0;
    if (warp < k) {
      // loads before the chains, as in onchip_forward
      float* v = vec + warp * n + k0;
      float y = lane < w ? v[lane] : 0.f;
      float e[NB];
      if (wn > 0) {  // the next block's columns, rows of block p (w == NB)
        const float* Un = A.panel(p + 1) + k0;
#pragma unroll
        for (int s = 0; s < NB; ++s) e[s] = Un[s * ld + lane];
        float part[4] = {y, 0.f, 0.f, 0.f};
#pragma unroll
        for (int s = NB - 1; s >= 0; --s) {
          const float t =
              fmaf(-e[s], __shfl_sync(FULL, xnext, s), part[s % 4]);
          part[s % 4] = s < wn ? t : part[s % 4];
        }
        y = (part[0] + part[1]) + (part[2] + part[3]);
      }
      // x_p = U_pp^{-1} z: the block holds the inverse on and above its
      // diagonal
      const float* Di = A.panel(p) + k0;
#pragma unroll
      for (int s = 0; s < NB; ++s) e[s] = Di[s * ld + lane];
      const float z = y;
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int s = NB - 1; s >= 0; --s) {
        const float t = fmaf(e[s], __shfl_sync(FULL, z, s), part[s % 4]);
        part[s % 4] = s >= lane && s < w ? t : part[s % 4];
      }
      y = (part[0] + part[1]) + (part[2] + part[3]);
      if (lane < w) v[lane] = y;
      xnext = y;
    } else if (wn > 0) {  // rows before block p take block p + 1
      const float* Un = A.panel(p + 1);
      for (int i = tid - k * 32; i < k0; i += OC_NT - k * 32) {
        float u[NB];
#pragma unroll
        for (int s = 0; s < NB; ++s) u[s] = Un[s * ld + i];
        for (int kk = 0; kk < k; ++kk) {
          const float* xb = vec + kk * n + k0 + NB;
          float part[4] = {vec[kk * n + i], 0.f, 0.f, 0.f};
#pragma unroll
          for (int s = NB - 1; s >= 0; --s) {
            const float t = fmaf(-u[s], xb[s], part[s % 4]);
            part[s % 4] = s < wn ? t : part[s % 4];
          }
          vec[kk * n + i] = (part[0] + part[1]) + (part[2] + part[3]);
        }
      }
    }
    __syncthreads();
  }
}


// The LU of the diagonal block (w x w, column-major at D with stride ld)
// in one warp, lane r holding row r: step c reads the pivot from lane c,
// inv = 1 / (pv + (1 - has)) goes to ipiv[c], the rows
// below take their multipliers col * inv and the rank-1 update, one fmaf
// an entry.  A zero (or NaN) pivot sets *zero_pivot.
__device__ __forceinline__ void diagonal_lu(float* D, int ld, int w, int lane,
                                            float* ipiv, int* zero_pivot) {
  float a[NB];
#pragma unroll
  for (int h = 0; h < NB; ++h)
    a[h] = h < w && lane < w ? D[h * ld + lane] : 0.f;
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    if (c < w) {
      const float pv = __shfl_sync(FULL, a[c], c);
      const float has = fabsf(pv) > 0.f ? 1.f : 0.f;
      const float inv = 1.f / (pv + (1.f - has));
      if (lane == 0) {
        ipiv[c] = inv;
        if (has == 0.f) *zero_pivot = 1;
      }
      if (lane > c) a[c] = a[c] * inv;
#pragma unroll
      for (int h = c + 1; h < NB; ++h) {
        const float ph = __shfl_sync(FULL, a[h], c);
        if (lane > c) a[h] = fmaf(-a[c], ph, a[h]);
      }
    }
  }
#pragma unroll
  for (int h = 0; h < NB; ++h)
    if (h < w && lane < w) D[h * ld + lane] = a[h];
}

// L21 = A21 U11^{-1} of a full panel (rows NB .. m - 1 of D), a thread a
// row: column c's multiplier a[c] * inv[c], then the row's rank-1 update
// of the columns h > c with U(c, h), in the plain version's order.
__device__ __forceinline__ void l21_rows(float* D, int ld, int m,
                                         const float* inv) {
  for (int r = NB + threadIdx.x; r < m; r += OC_NT) {
    float a[NB];
#pragma unroll
    for (int h = 0; h < NB; ++h) a[h] = D[h * ld + r];
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      a[c] = a[c] * inv[c];
#pragma unroll
      for (int h = c + 1; h < NB; ++h) a[h] = fmaf(-a[c], D[h * ld + c], a[h]);
    }
#pragma unroll
    for (int h = 0; h < NB; ++h) D[h * ld + r] = a[h];
  }
}

// U12 = L11^{-1} A12 for ncols columns (column jj at C + jj ld, rows 0 ..
// NB - 1; the unit-lower L11 at L, stride ld), a thread a column, thread
// t taking columns t, t + OC_NT, ...; `keep` says which columns exist.
template <class Keep>
__device__ __forceinline__ void u12_columns(const float* L, float* C, int ld,
                                            int ncols, Keep&& keep, int t) {
  for (int jj = t; jj < ncols; jj += OC_NT) {
    if (!keep(jj)) continue;
    float* col = C + (size_t)jj * ld;
    float u[NB];
#pragma unroll
    for (int r = 0; r < NB; ++r) u[r] = col[r];
#pragma unroll
    for (int r = 1; r < NB; ++r) {
      float acc = u[r];
#pragma unroll
      for (int s = 0; s < r; ++s) acc = fmaf(-L[s * ld + r], u[s], acc);
      u[r] = acc;
    }
#pragma unroll
    for (int r = 0; r < NB; ++r) col[r] = u[r];
  }
}

// The factored diagonal block (w x w at D, stride ld) replaced by its
// inverses, one warp for each triangle, lane j computing column j:
// which = 0 the unit-lower L^{-1} below the diagonal, which = 1 U^{-1} on
// and above it (1 / U(r, r) taken as ipiv[r], the zero-pivot rule's).
// The warp reads its whole triangle before it writes, and the two
// triangles do not overlap.
__device__ __forceinline__ void diagonal_inverse(float* D, int ld, int w,
                                                 const float* ipiv,
                                                 int which, int lane) {
  float x[NB];
  if (which == 0) {
#pragma unroll
    for (int r = 0; r < NB; ++r) {
      float acc = r == lane ? 1.f : 0.f;
#pragma unroll
      for (int s = 0; s < r; ++s)
        if (s >= lane && r < w) acc = fmaf(-D[s * ld + r], x[s], acc);
      x[r] = acc;
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < NB; ++r)
      if (r > lane && r < w) D[lane * ld + r] = x[r];
  } else {
    const float ipj = lane < w ? ipiv[lane] : 0.f;
#pragma unroll
    for (int r = NB - 1; r >= 0; --r) {
      float acc = 0.f;
#pragma unroll
      for (int s = r + 1; s < NB; ++s)
        if (s <= lane && lane < w) acc = fmaf(D[s * ld + r], x[s], acc);
      const float ipr = r < w ? ipiv[r] : 0.f;
      x[r] = r > lane ? 0.f : r == lane ? ipj : -ipr * acc;
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < NB; ++r)
      if (r <= lane && lane < w) D[lane * ld + r] = x[r];
  }
}

template <int CL>
__global__ void __launch_bounds__(OC_NT, 1)
solve_onchip_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    const float* __restrict__ du,
                    const float* __restrict__ dv, float* __restrict__ x,
                    bool* __restrict__ bad, int n, int k, int depth,
                    int ir_steps) {
  extern __shared__ float smem[];
  const int ld = n + 1, ncl = onchip_cols(n, CL), kn = k * n;
  float* Aloc = smem;                                 // [ncl][ld]
  float* Lbuf = Aloc + (size_t)ncl * ld;              // [NB][ld] (CL > 1)
  float* sdu = Lbuf + (CL > 1 ? NB * ld : 0);
  float* sdv = sdu + 2 * n;
  float* bo = sdv + 2 * n;
  float* yv = bo + kn;
  float* xv = yv + kn;
  float* rv = xv + kn;
  float* ipiv = rv + kn;
  float* red = ipiv + n;                              // [OC_NW]
  float* amax_slot = red + OC_NW;                     // [2]
  int* flags = reinterpret_cast<int*>(amax_slot + 2);  // zero pivot

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t sys = blockIdx.x / CL;
  const float* A = a + sys * n * n;
  int rank = 0;
  Columns<CL> cols;
  int* flags0 = flags;
  float* amax0 = amax_slot;
  float* dst[CL];             // each block's Aloc
  dst[0] = Aloc;
  if constexpr (CL > 1) {
    cooperative_groups::cluster_group cluster =
        cooperative_groups::this_cluster();
    rank = (int)cluster.block_rank();
    for (int r = 0; r < CL; ++r)
      dst[r] = r == rank ? Aloc : cluster.map_shared_rank(Aloc, r);
    flags0 = cluster.map_shared_rank(flags, 0);
    amax0 = cluster.map_shared_rank(amax_slot, 0);
  }
  for (int r = 0; r < CL; ++r) cols.blocks[r] = dst[r];
  cols.ld = ld;

  for (int i = tid; i < 2 * n; i += OC_NT) {
    sdu[i] = du[i];
    sdv[i] = dv[i];
  }
  if (tid == 0) flags[0] = 0;
  cluster_barrier<CL>();  // every block of the system runs: its shared
                          // memory may be written

  // A' = U^T A V, straight from A into the blocks that own its columns.
  float am = 0.f;
  {
    const int Q = n >> depth;
    for (int g = rank * OC_NT + tid; g < Q * Q; g += CL * OC_NT) {
      if (depth == 2)
        load_group<2, CL>(A, n, g / Q, g % Q, sdu, sdv, dst, ld, am);
      else
        load_group<1, CL>(A, n, g / Q, g % Q, sdu, sdv, dst, ld, am);
    }
  }
  am = block_max<OC_NT>(am, red);
  if (tid == 0) amax0[rank] = am;
  float bmax = 0.f;
  if (rank == 0) {  // b' = U^T b, in the block that solves
    const float* bb = b + sys * kn;
    float bm = 0.f;
    for (int idx = tid; idx < kn; idx += OC_NT) {  // b is [n, k] row-major
      const float v = bb[idx];
      bo[(idx % k) * n + idx / k] = v;
      yv[(idx % k) * n + idx / k] = v;
      bm = nanmax(bm, fabsf(v));
    }
    bmax = block_max<OC_NT>(bm, red);
    butterfly_vec<OC_NT>(yv, n, k, sdu, depth, true);
  }
  cluster_barrier<CL>();

  // Pivot-free LU, panel by panel.
  const int panels = (n + NB - 1) / NB;
  const int lc_end = NB * ((panels - rank + CL - 1) / CL);
  auto global_col = [&](int lc) {
    return ((lc / NB) * CL + rank) * NB + lc % NB;
  };
  // the owner of panel p: its diagonal block in one warp, then L21 (a
  // thread a row, from thread 0 up) and its own U12 (a thread a column,
  // from the last thread down) at once
  auto factor = [&](int p) {
    const int k0 = p * NB, w = min(NB, n - k0), m = n - k0;
    float* D = Aloc + (size_t)(p / CL) * NB * ld + k0;
    if (warp == 0) diagonal_lu(D, ld, w, lane, ipiv + k0, flags0);
    __syncthreads();
    if (m > w) {
      l21_rows(D, ld, m, ipiv + k0);
      const int c0 = NB * (p / CL + 1);
      u12_columns(D, Aloc + (size_t)c0 * ld + k0, ld, lc_end - c0,
                  [&](int jj) { return global_col(c0 + jj) < n; },
                  OC_NT - 1 - tid);
    }
    __syncthreads();
  };
  // panel p (a full one, L at L with stride ld from row k0) applied to
  // this block's local columns [c0, c1): U12, then A22 -= L21 U12 with a
  // warp taking 4 columns of a 128-row tile, a lane rows lane + 32 q
  auto apply = [&](int p, const float* L, int c0, int c1) {
    const int k0 = p * NB, mr = n - k0 - NB, ncols = c1 - c0;
    if (ncols <= 0) return;
    if (p % CL != rank) {  // the owner solved its U12 in factor()
      u12_columns(L, Aloc + (size_t)c0 * ld + k0, ld, ncols,
                  [&](int jj) { return global_col(c0 + jj) < n; }, tid);
      __syncthreads();
    }
    for (int i0 = 0; i0 < mr; i0 += 128) {
      for (int j0 = 0; j0 < ncols; j0 += 4 * OC_NW) {
        const int jb = j0 + 4 * warp;
        if (jb >= ncols) continue;
        float* cp[4];
        bool cv[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int lc = c0 + jb + c;
          cv[c] = jb + c < ncols && global_col(lc) < n;
          cp[c] = Aloc + (size_t)(cv[c] ? lc : c0) * ld + k0;
        }
        float acc[4][4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = i0 + lane + 32 * q;
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[q][c] = i < mr && cv[c] ? cp[c][NB + i] : 0.f;
        }
#pragma unroll 4
        for (int s2 = 0; s2 < NB; ++s2) {
          float lv[4], uv[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int i = i0 + lane + 32 * q;
            lv[q] = i < mr ? L[s2 * ld + NB + i] : 0.f;
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) uv[c] = cp[c][s2];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[q][c] = fmaf(-lv[q], uv[c], acc[q][c]);
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = i0 + lane + 32 * q;
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (i < mr && cv[c]) cp[c][NB + i] = acc[q][c];
        }
      }
    }
    __syncthreads();
  };
  for (int p = 0; p < panels; ++p) {
    const int k0 = p * NB, m = n - k0;
    const bool own = p % CL == rank;
    if (own) factor(p);
    cluster_barrier<CL>();  // the panel is final
    if (p + 1 == panels) break;  // the last panel: no trailing matrix
    // the panel in its owner, or a copy of it in this block
    const float* L = cols.panel(p) + k0;
    if (!own) {
      for (int idx = tid; idx < NB * m; idx += OC_NT) {
        const int s2 = idx / m, r = idx - s2 * m;
        Lbuf[s2 * ld + r] = L[s2 * ld + r];
      }
      __syncthreads();
      L = Lbuf;
    }
    apply(p, L, NB * ((p + 1 - rank + CL - 1) / CL), lc_end);
  }
  // each diagonal block of this block's panels takes its inverses: two
  // warps a block, L's below the diagonal, U's on and above it
  for (int lp = warp >> 1; lp * NB < lc_end; lp += OC_NW / 2) {
    const int p = lp * CL + rank;
    if (p >= panels) break;
    const int k0 = p * NB;
    diagonal_inverse(Aloc + (size_t)lp * NB * ld + k0, ld, min(NB, n - k0),
                     ipiv + k0, warp & 1, lane);
  }
  cluster_barrier<CL>();  // every panel and flag is in place

  if (rank == 0) {
    float amax = amax_slot[0];
    if constexpr (CL > 1) amax = nanmax(amax, amax_slot[1]);
    const float ok = flags[0] ? 0.f : 1.f;
    solve_refine_gate<OC_NT>(A, n, k, depth, ir_steps, sdu, sdv, bo, yv, xv,
                             rv, red, ok, amax, bmax, x + sys * kn,
                             bad + sys, [&](float* v) {
                               onchip_forward<CL>(cols, n, v, k);
                               onchip_backward<CL>(cols, n, v, k);
                             });
  }
  if constexpr (CL > 1) cluster_barrier<CL>();  // block 0 has read the peer
}

}  // namespace

extern "C" {

// Shared memory variant 0 needs for (n, k), in bytes; the reach of the
// kernel.
size_t solve_fused_smem_bytes(int n, int k) {
  return smem_floats(n, k) * sizeof(float);
}

// The variant that takes (n, k), by where each beat variant 0 on an H100
// (B = 256, N = 64 .. 256 in steps of 32, k = 1, 2, 4, 8): 1 (one block
// a system) from N = 96 where its layout fits a block's shared memory,
// 2 (a cluster of two) past that up to N = 256 for k <= 4; else 0 (the
// device-memory scratch), which also keeps N < 96 and the cluster's
// k > 4, where the on-chip variants lost.
int solve_variant(int n, int k) {
  if (n % 2 || n < OC_MIN_N || n > OC_MAX_N || k < 1 || k > MAX_K) return 0;
  if (onchip_smem_floats(n, k, 1) * sizeof(float) <= MAX_SMEM) return 1;
  if (k <= OC_CLUSTER_MAX_K &&
      onchip_smem_floats(n, k, 2) * sizeof(float) <= MAX_SMEM)
    return 2;
  return 0;
}

static const void* solve_function(int variant, int* threads) {
  *threads = variant == 0 ? NT : OC_NT;
  if (variant == 1) return (const void*)solve_onchip_kernel<1>;
  if (variant == 2) return (const void*)solve_onchip_kernel<2>;
  return (const void*)solve_fused_kernel;
}

static size_t solve_variant_smem(int variant, int n, int k) {
  return variant == 0 ? solve_fused_smem_bytes(n, k)
                      : onchip_smem_floats(n, k, variant) * sizeof(float);
}

// Registers a thread, local (spill) bytes a thread and resident blocks an
// SM of `variant` at (n, k), into out[0..2]; returns the cudaError_t.
int solve_attributes(int variant, int n, int k, int* out) {
  int threads = 0;
  const void* fn = solve_function(variant, &threads);
  const size_t smem = solve_variant_smem(variant, n, k);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads,
                                                      smem);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = blocks;
  return (int)err;
}

// Launches the variant solve_variant(n, k) on `stream`; returns the
// cudaError_t of the launch (0 on success).  Pointers are device pointers
// to contiguous f32 data: a [batch, n, n], b and x [batch, n, k], du and
// dv [2, n], work [batch, n, n] (variant 0 only; may be null otherwise);
// bad is [batch] bool.
int solve_fused_rbt_f32(const void* a, const void* b, const void* du,
                        const void* dv, void* work, void* x, void* bad,
                        int batch, int n, int k, int depth, int ir_steps,
                        void* stream) {
  if (batch == 0) return 0;
  const int variant = solve_variant(n, k);
  int threads = 0;
  const void* fn = solve_function(variant, &threads);
  const size_t smem = solve_variant_smem(variant, n, k);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  const float* A = (const float*)a;
  const float* Bv = (const float*)b;
  const float* U = (const float*)du;
  const float* V = (const float*)dv;
  if (variant == 0) {
    if (work == nullptr) return (int)cudaErrorInvalidValue;
    solve_fused_kernel<<<batch, NT, smem, st>>>(
        A, Bv, U, V, (float*)work, (float*)x, (bool*)bad, n, k, depth,
        ir_steps);
  } else if (variant == 1) {
    solve_onchip_kernel<1><<<batch, OC_NT, smem, st>>>(
        A, Bv, U, V, (float*)x, (bool*)bad, n, k, depth, ir_steps);
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(2 * batch);
    cfg.blockDim = dim3(OC_NT);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 2;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, solve_onchip_kernel<2>, A, Bv, U, V,
                             (float*)x, (bool*)bad, n, k, depth, ir_steps);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

const char* kernels_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
