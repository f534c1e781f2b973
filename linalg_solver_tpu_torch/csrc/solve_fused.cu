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
// lanes with the whole [N, N, 128] tile in VMEM.  Here one thread block
// solves one system (grid = B).  A 256x256 f32 matrix (256 KB) exceeds
// the 227 KB of shared memory a block may use, so the working copy of
// A' lives in a device-memory scratch (`work`, [B, N, N], stored
// column-major so that a column of L or U is contiguous), where it sits
// mostly in the 50 MB L2.  The original `a` is left untouched for the
// refinement residuals (the TPU kernel's `hold_orig` copy).
//
// What bounds it.  A rank-1 right-looking LU straight on the scratch
// reads and writes the trailing matrix once per column: ~N^3/3 * 8 bytes
// of L2/HBM traffic per system (11 GB at B = N = 256).  The design
// therefore factors in panels of NB = 32 columns: the panel is factored
// rank-1 in shared memory, the block row U12 is a small triangular solve,
// and the trailing matrix takes one rank-32 update per panel from shared
// L21/U12 tiles (register micro-tiles of 4x4), which cuts that traffic
// 32-fold.  What remains is latency inside each block: scalar FP32 FMA
// chains and a barrier per rank-1 step of each panel, plus ~3 barriers
// per 32 columns of each substitution (measured on an H100 at 700 W,
// B = N = 256: 1.27 ms, 3.4% of the FP32 peak; the factorization and
// first solve take ~83% of it).  The subtraction order
// of every element is the rank-1 order of the TPU kernel.  The
// substitutions solve each 32x32 diagonal block in one warp with
// shuffles, then update the rest with a block-wide GEMV.
// Not ported: the streamed-residual variant, `unroll`, `nb` and the VMEM
// budgets, which exist only for Mosaic and VMEM.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int NT = 256;           // threads per block
constexpr int NWARP = NT / 32;
constexpr int NB = 32;            // LU panel width == warp width
constexpr int MAX_K = 8;          // RHS columns (MAX_K_RHS)
constexpr unsigned FULL = 0xffffffffu;
constexpr float SQRT_HALF = 0.7071067811865476f;

// NaN-propagating max, as jnp.max / torch.amax (fmaxf drops NaN).
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// Max over the block; every thread passes its partial and gets the
// result.  `red` holds NWARP floats of shared memory.
__device__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = nanmax(v, __shfl_xor_sync(FULL, v, o));
  __syncthreads();  // `red` may still be read from the previous call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < NWARP; ++w) r = nanmax(r, red[w]);
  return r;
}

__device__ float absmax(const float* v, int len, float* red) {
  float m = 0.f;
  for (int i = threadIdx.x; i < len; i += NT) m = nanmax(m, fabsf(v[i]));
  return block_max(m, red);
}

// One butterfly level (segment `seg`) along the `mix` axis of a set of
// lines: element (p, o) sits at M[p * sm + o * so], p < n, o < n_other.
// `trans` applies B^T = (1/sqrt2)[[R0, R0], [R1, -R1]], else
// B = (1/sqrt2)[[R0, R1], [R0, -R1]], as ops/rbt.py's _bf_level.
__device__ void bf_level(float* M, int n, int sm, int so, int n_other,
                         const float* r, int seg, bool trans,
                         bool other_fast) {
  const int h = seg >> 1, half = n >> 1, total = half * n_other;
  for (int idx = threadIdx.x; idx < total; idx += NT) {
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
__device__ void butterfly(float* M, int n, int sm, int so, int n_other,
                          const float* diags, int depth, bool trans,
                          bool other_fast) {
  for (int i = 0; i < depth; ++i) {
    const int lvl = trans ? i : depth - 1 - i;
    bf_level(M, n, sm, so, n_other, diags + lvl * n, n >> lvl, trans,
             other_fast);
    __syncthreads();
  }
}

// Vector slabs in shared memory: slab kk of length n at v + kk * n.
__device__ void butterfly_vec(float* v, int n, int k, const float* diags,
                              int depth, bool trans) {
  butterfly(v, n, 1, n, k, diags, depth, trans, false);
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

// rv := bo - A xv against the original row-major A, one warp per row.
__device__ void residual(const float* A, int n, const float* bo,
                         const float* xv, float* rv, int k) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < n; i += NWARP) {
    const float* row = A + (size_t)i * n;
    float acc[MAX_K];
#pragma unroll
    for (int kk = 0; kk < MAX_K; ++kk) acc[kk] = 0.f;
#pragma unroll 4
    for (int j = lane; j < n; j += 32) {
      const float a = row[j];
#pragma unroll
      for (int kk = 0; kk < MAX_K; ++kk)
        if (kk < k) acc[kk] += a * xv[kk * n + j];
    }
#pragma unroll
    for (int kk = 0; kk < MAX_K; ++kk) {
      if (kk < k) {
        float s = acc[kk];
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
        if (lane == 0) rv[kk * n + i] = bo[kk * n + i] - s;
      }
    }
  }
  __syncthreads();
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
  forward(S, n, yv, k);
  backward(S, n, ipiv, yv, k);
  for (int i = tid; i < kn; i += NT) xv[i] = yv[i];
  __syncthreads();
  butterfly_vec(xv, n, k, sdv, depth, false);  // x = V y

  // Refinement against the original A; gate statistics as the TPU
  // kernel: rmax and xmax before the last correction, zcmax after the
  // un-butterfly of the last correction.
  float rmax = 0.f, xmax = 0.f, zcmax = 0.f;
  for (int step = 0; step < ir_steps; ++step) {
    const bool last = step == ir_steps - 1;
    residual(A, n, bo, xv, rv, k);
    if (last) {
      rmax = absmax(rv, kn, red);
      xmax = absmax(xv, kn, red);
    }
    butterfly_vec(rv, n, k, sdu, depth, true);
    forward(S, n, rv, k);
    backward(S, n, ipiv, rv, k);
    butterfly_vec(rv, n, k, sdv, depth, false);
    if (last) zcmax = absmax(rv, kn, red);
    __syncthreads();
    for (int i = tid; i < kn; i += NT) xv[i] += rv[i];
    __syncthreads();
  }
  float xnow = 0.f;
  if (ir_steps == 0) {
    residual(A, n, bo, xv, rv, k);
    rmax = absmax(rv, kn, red);
    xnow = absmax(xv, kn, red);
  }

  // NaN-proof flags (nan <= t is false), thresholds of the TPU kernel.
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

  float* xo = x + sys * kn;  // x is [n, k] row-major, like b
  for (int idx = tid; idx < kn; idx += NT) xo[idx] = xv[(idx % k) * n + idx / k];
  if (tid == 0) bad[sys] = flag;
}

}  // namespace

extern "C" {

// Shared memory the kernel needs for (n, k), in bytes.
size_t solve_fused_smem_bytes(int n, int k) {
  return smem_floats(n, k) * sizeof(float);
}

// Launches the kernel on `stream`; returns the cudaError_t of the launch
// (0 on success).  Pointers are device pointers to contiguous f32 data:
// a [batch, n, n], b and x [batch, n, k], du and dv [2, n], work
// [batch, n, n]; bad is [batch] bool.
int solve_fused_rbt_f32(const void* a, const void* b, const void* du,
                        const void* dv, void* work, void* x, void* bad,
                        int batch, int n, int k, int depth, int ir_steps,
                        void* stream) {
  const size_t smem = solve_fused_smem_bytes(n, k);
  cudaError_t err = cudaFuncSetAttribute(
      solve_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  solve_fused_kernel<<<batch, NT, smem, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (const float*)du, (const float*)dv,
      (float*)work, (float*)x, (bool*)bad, n, k, depth, ir_steps);
  return (int)cudaGetLastError();
}

const char* kernels_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
