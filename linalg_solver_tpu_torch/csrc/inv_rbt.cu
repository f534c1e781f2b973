// Fused random-butterfly inverse of a batch of small matrices, with its
// gate and rescue inside the kernel.
//
// Replaces the Pallas TPU kernel `_inv_rbt_kernel` in
// linalg_solver_tpu/ops/pallas/inv_rbt_kernel.py (launched by
// `_inv_rbt_call` from `inverse_rbt_fused_batched`).  Same math, per
// matrix:
//   1. [A' | I] with A' = U^T A V                  (depth <= 2 butterflies)
//   2. Gauss-Jordan without pivoting, pivot(j) = row j; step j updates
//      only the live columns [j, n+j] (n+1 wide, not 2n), zero-pivot
//      rule inv = 1/(pv + (1 - has)), ok *= has
//   3. X = V inv(A') U^T on the right half
//   4. Rademacher probe against the ORIGINAL A: r = A (X v) - v,
//      bad = !(max|r| <= 1e-2 && ok)           (NaN-proof)
//   5. rescue, if bad: steps 1-4 again from A with the second draw
//      (R, S) (level 2); if still bad, the pivoted Gauss-Jordan of
//      gj_pivot.cuh on [A | I] with tol 0, rows un-permuted by perm
//      (level 3).  A matrix that reaches level 3 stays flagged.
//
// Mapping on the H100.  The TPU kernel holds 128 matrices in the vector
// lanes, [n, 2n, 128] in VMEM plus a pristine copy of A and a stash for
// the lanes a rescue must not touch; its rescue runs for the whole tile
// under pl.when and is merged back with where().  Here one thread block
// holds one matrix's [n, 2n] tile in shared memory, so levels 2 and 3
// are plain branches on the block's own flag: no stash, and a clean
// matrix pays nothing for them.  The original A stays untouched in
// device memory (the TPU kernel's `acopy`), where the probe and the
// rebuilds read it through L1/L2.
//
// What bounds it.  Step j reads and writes n(n+1) floats of shared
// memory and takes two barriers; the elimination is n^3 FMAs a matrix
// (0.27 GFLOP at 1024 matrices of 64x64) against n^2 floats read and
// written once in device memory.  Shared-memory traffic and barrier
// latency set the time, and several blocks an SM (four at n = 64: 38 KB
// and 52 registers a thread each) hide part of the latency; from
// n = 128 on a block takes over half the shared memory and runs alone on
// its SM, which is why the time grows faster than n^3 there.  The
// butterflies and the probe are
// O(n^2) passes.  Reach: inv_smem_floats(n) <= 58,112 floats, n <= 164
// (the TPU kernel reaches 180 in VMEM).
// Arithmetic: the butterflies round each product and sum separately and
// the eliminations use one fmaf per update, as the plain version and the
// JAX kernel on the CPU do, so that the kernel tracks the plain version
// to the bit, but for the order of the probe's sums (which moves only
// the probe's residual) and the plain version's double rounding.

#include "gj_pivot.cuh"

namespace {

constexpr float SQRT_HALF = 0.7071067811865476f;
constexpr float RTOL = 1e-2f;

// The pivoted routine's tile and slots for [n, 2n], four diagonal pairs
// (U, V, R, S: [2][n] each), the probe v and X v.
__host__ __device__ inline size_t inv_smem_floats(int n) {
  return gj_smem_floats(n, 2 * n) + 8 * (size_t)n + 2 * (size_t)n;
}

// NaN-propagating max, as jnp.max / torch.amax (fmaxf drops NaN).
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// Max over the block; `red` holds GJ_NWARP floats of shared memory.
__device__ float block_nanmax(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1)
    v = nanmax(v, __shfl_xor_sync(GJ_FULL, v, o));
  __syncthreads();  // `red` may still be read from its last use
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int q = 1; q < GJ_NWARP; ++q) r = nanmax(r, red[q]);
  return r;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(GJ_FULL, v, o);
  return v;
}

// One butterfly level (segment `seg`) on the n x n block of the tile at
// columns [off, off + n).  `rows` mixes rows (element (p, o) at
// T[p * ld + off + o]), else columns (at T[o * ld + off + p]).  `trans`
// applies B^T = (1/sqrt2)[[R0, R0], [R1, -R1]], else
// B = (1/sqrt2)[[R0, R1], [R0, -R1]], as ops/rbt.py's _bf_level.
__device__ void bf_level(float* T, int ld, int n, int off, const float* r,
                         int seg, bool trans, bool rows) {
  const int h = seg >> 1, half = n >> 1;
  for (int idx = threadIdx.x; idx < half * n; idx += GJ_NT) {
    int p, o;
    if (rows) {
      o = idx % n;
      p = idx / n;
    } else {
      p = idx % half;
      o = idx / half;
    }
    const int top = (p / h) * seg + (p % h), bot = top + h;
    float* pt = rows ? T + top * ld + off + o : T + o * ld + off + top;
    float* pb = rows ? T + bot * ld + off + o : T + o * ld + off + bot;
    const float t = *pt, b = *pb, r0 = r[top], r1 = r[bot];
    float nt, nb;
    if (trans) {
      nt = __fmul_rn(r0, __fadd_rn(t, b));
      nb = __fmul_rn(r1, __fsub_rn(t, b));
    } else {
      nt = __fadd_rn(__fmul_rn(r0, t), __fmul_rn(r1, b));
      nb = __fsub_rn(__fmul_rn(r0, t), __fmul_rn(r1, b));
    }
    *pt = __fmul_rn(nt, SQRT_HALF);
    *pb = __fmul_rn(nb, SQRT_HALF);
  }
}

// Depth-d butterfly: `trans` applies levels 0..d-1, else d-1..0.
// `diags` is [2][n]; only the first `depth` levels are read.
__device__ void butterfly(float* T, int ld, int n, int off,
                          const float* diags, int depth, bool trans,
                          bool rows) {
  for (int i = 0; i < depth; ++i) {
    const int lvl = trans ? i : depth - 1 - i;
    bf_level(T, ld, n, off, diags + lvl * n, n >> lvl, trans, rows);
    __syncthreads();
  }
}

// Levels 1 and 2: rebuild [U^T A V | I] from A, eliminate without
// pivoting, un-butterfly the inverse into the right half and probe it.
// Returns the (block-uniform) flag.
__device__ bool nopivot_pass(const GJTile& s, const float* __restrict__ A,
                             int n, const float* du, const float* dv,
                             const float* v, float* xv, int depth) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ld = s.ld;
  float* T = s.T;
  for (int idx = tid; idx < n * n; idx += GJ_NT) {
    const int r = idx / n, c = idx - r * n;
    T[r * ld + c] = A[idx];
    T[r * ld + n + c] = r == c ? 1.f : 0.f;
  }
  __syncthreads();
  butterfly(T, ld, n, 0, du, depth, true, true);   // U^T A
  butterfly(T, ld, n, 0, dv, depth, true, false);  // (U^T A) V

  float ok = 1.f;
  const int span = n + 1, dr = GJ_NT / span, dc = GJ_NT % span;
  for (int j = 0; j < n; ++j) {
    const float pv = T[j * ld + j];
    const float has = fabsf(pv) > 0.f ? 1.f : 0.f;
    const float inv = 1.f / (pv + (1.f - has));
    ok *= has;
    for (int r = tid; r < n; r += GJ_NT)
      s.coeff[r] = r == j ? 1.f - inv : T[r * ld + j] * inv;
    for (int c = tid; c < span; c += GJ_NT) s.prow[c] = T[j * ld + j + c];
    __syncthreads();
    int r = tid / span, c = tid % span;
    for (; r < n; r += dr) {
      float* e = T + r * ld + j + c;
      *e = fmaf(-s.coeff[r], s.prow[c], *e);
      c += dc;
      if (c >= span) {
        c -= span;
        ++r;
      }
    }
    __syncthreads();
  }

  butterfly(T, ld, n, n, dv, depth, false, true);   // V inv(A')
  butterfly(T, ld, n, n, du, depth, false, false);  // (V inv(A')) U^T

  // r = A (X v) - v, one warp per row.
  for (int i = warp; i < n; i += GJ_NWARP) {
    float acc = 0.f;
    for (int c = lane; c < n; c += 32) acc = fmaf(T[i * ld + n + c], v[c], acc);
    acc = warp_sum(acc);
    if (lane == 0) xv[i] = acc;
  }
  __syncthreads();
  float rm = 0.f;
  for (int i = warp; i < n; i += GJ_NWARP) {
    const float* row = A + (size_t)i * n;
    float acc = 0.f;
    for (int c = lane; c < n; c += 32) acc = fmaf(row[c], xv[c], acc);
    acc = warp_sum(acc);
    rm = nanmax(rm, fabsf(acc - v[i]));
  }
  const float rmax = block_nanmax(rm, s.redv);
  return !(rmax <= RTOL && ok > 0.f);
}

// Level 3: pivoted Gauss-Jordan with tol 0 on [A | I]; row j of the
// inverse is physical row perm[j] of the right half.  Writes X.
__device__ void pivoted_level(const GJTile& s, const float* __restrict__ A,
                              int n, float* __restrict__ X) {
  const int ld = s.ld;
  for (int idx = threadIdx.x; idx < n * n; idx += GJ_NT) {
    const int r = idx / n, c = idx - r * n;
    s.T[r * ld + c] = A[idx];
    s.T[r * ld + n + c] = r == c ? 1.f : 0.f;
  }
  __syncthreads();
  gj_pivot_steps(s, n, 2 * n, 0.f);
  for (int idx = threadIdx.x; idx < n * n; idx += GJ_NT) {
    const int j = idx / n, c = idx - j * n;
    X[idx] = s.T[s.perm[j] * ld + n + c];
  }
}

__global__ void __launch_bounds__(GJ_NT)
inv_rbt_kernel(const float* __restrict__ a, const float* __restrict__ du,
               const float* __restrict__ dv, const float* __restrict__ eu,
               const float* __restrict__ ev, const float* __restrict__ vr,
               float* __restrict__ x, bool* __restrict__ bad, int n,
               int depth, int rescue) {
  extern __shared__ float smem[];
  const GJTile s = gj_carve(smem, n, 2 * n);
  float* sd = smem + gj_smem_floats(n, 2 * n);  // du, dv, eu, ev
  float* sv = sd + 8 * n;
  float* xv = sv + n;
  const int tid = threadIdx.x;
  for (int i = tid; i < 2 * n; i += GJ_NT) {
    sd[i] = du[i];
    sd[2 * n + i] = dv[i];
    sd[4 * n + i] = eu[i];
    sd[6 * n + i] = ev[i];
  }
  for (int i = tid; i < n; i += GJ_NT) sv[i] = vr[i];
  // (nopivot_pass's first barrier makes these visible before use)

  const size_t m = blockIdx.x, nn = (size_t)n * n;
  const float* A = a + m * nn;
  float* X = x + m * nn;
  bool flag = nopivot_pass(s, A, n, sd, sd + 2 * n, sv, xv, depth);
  bool level3 = false;
  if (rescue && flag) {
    flag = nopivot_pass(s, A, n, sd + 4 * n, sd + 6 * n, sv, xv, depth);
    if (flag) {
      pivoted_level(s, A, n, X);
      level3 = true;
    }
  }
  if (!level3) {
    for (int idx = tid; idx < n * n; idx += GJ_NT) {
      const int r = idx / n, c = idx - r * n;
      X[idx] = s.T[r * s.ld + n + c];
    }
  }
  if (tid == 0) bad[m] = flag;
}

}  // namespace

extern "C" {

// Shared memory the kernel needs for n, in bytes.
size_t inv_rbt_smem_bytes(int n) { return inv_smem_floats(n) * sizeof(float); }

// Launches the kernel on `stream`; returns the cudaError_t of the launch
// (0 on success).  Device pointers to contiguous f32 data: a and x
// [batch, n, n], du, dv, eu, ev [2, n], vr [n]; bad is [batch] bool.
// `rescue` != 0 runs levels 2 and 3.
int inv_rbt_f32(const void* a, const void* du, const void* dv,
                const void* eu, const void* ev, const void* vr, void* x,
                void* bad, int batch, int n, int depth, int rescue,
                void* stream) {
  const size_t smem = inv_rbt_smem_bytes(n);
  cudaError_t err = cudaFuncSetAttribute(
      inv_rbt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  inv_rbt_kernel<<<batch, GJ_NT, smem, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)du, (const float*)dv,
      (const float*)eu, (const float*)ev, (const float*)vr, (float*)x,
      (bool*)bad, n, depth, rescue);
  return (int)cudaGetLastError();
}

}  // extern "C"
