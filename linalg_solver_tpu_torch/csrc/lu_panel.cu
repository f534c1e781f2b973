// Partial-pivot LU of a batch of [n, nb] panels in place: no row is ever
// swapped, and rows marked as pivoted by earlier panels are skipped.
//
// Replaces the Pallas TPU kernel `_panel_kernel` in
// linalg_solver_tpu/ops/pallas/lu_panel_kernel.py (launched by
// `panel_factor_masked` from the pivoted phase loop, ops/lu_blocked.py's
// `_pallas_lu_phases`).  Same math, per panel, for steps c = 0 .. nb-1:
//   masked = pivoted ? -inf : |col|,   p = first argmax (NaN the largest),
//   has  = masked[p] > 0,
//   pv   = sum_r col[r] * (r == p)                      (a one-hot read)
//   inv  = 1 / (pv + (1 - has)),
//   elim = !pivoted[r] * (r != p) * has,   f = col * inv * elim
//   prow = sum_r a[r][:] * (r == p)                     (a one-hot read)
//   columns h > c, every row:  a[r][h] -= f[r] * prow[h]
//   column c:                  a[r][c]  = elim f + (1 - elim) col
//   pivoted[p] |= has, piv_step[p] = c where has, piv_row[c] = p (always),
//   ok &= has.
// The one-hot reads make pv and prow[h] NaN as soon as another row of
// their column holds an Inf or NaN (0 * Inf = NaN); the block keeps a
// count of non-finite entries per column (`nfc`, two buffers: this
// step's and the next one's) so that a single read gives the same value.
// The argmax is the (value, row) total order of gj_pivot.cuh in warp
// shuffles.  Pre-pivoted rows are never candidates and never eliminated,
// but, as on the TPU, they go through the update with f = 0 (so an Inf
// in the pivot row still reaches them as NaN).
//
// Mapping on the H100.  The TPU kernel keeps 128 panels in the vector
// lanes, [nb, n, 128] in VMEM, and folds two steps into one pass over the
// live block (`lookahead`); that fold is Mosaic scheduling and is not
// ported.  Here one thread block of 256 threads holds one panel in shared
// memory, column-major with the odd column stride n + 1 (kernel 5's
// layout), so the coalesced row-major load and the walk down a column are
// both free of bank conflicts.  Each step: argmax partials (barrier),
// pivot value, staged pivot row and mask update (barrier), the update of
// the columns h > c of each thread's rows (barrier); the finished column c
// is written in the next step's first phase.  Three barriers a step.  The
// pivot state of every row is one int in shared memory: -1 pre-pivoted, n
// not pivoted yet, else the step that pivoted it.
//
// What bounds it.  The panel is read from and written to device memory
// once; in between, nb steps of n (nb - c - 1) fused multiply-adds from
// shared memory and three barriers.  At the phase loop's panels (n <= 960,
// nb <= 64) that is the latency of shared memory and barriers, not the 67
// TFLOP/s of FP32 nor HBM.  Reach: panel_smem_floats(n, nb) = nb (n + 4) +
// n + 16 <= 58,112 floats, i.e. n <= 889 at nb = 64, 1756 at nb = 32 (the
// caller splits a wider panel, ops/lu_blocked.py `panel_split`).
// Arithmetic: one fmaf per update, as the plain version's float64 product
// and difference (gauss_jordan.fms) reproduce; the multipliers round each
// product on its own.  Kernel and plain version agree to the bit but for
// the plain version's double rounding of a rare halfway case.

#include "gj_pivot.cuh"

namespace {

constexpr int PRE_PIVOTED = -1;

__host__ __device__ inline size_t panel_smem_floats(int n, int nb) {
  // the panel, prow [nb], nfc [2][nb], state [n], argmax slots [2][NWARP]
  return (size_t)nb * (n + 1) + 3 * (size_t)nb + n + 2 * GJ_NWARP;
}

// f = col * inv * elim, each product rounded on its own.
__device__ __forceinline__ float multiplier(float col, float inv,
                                            float elim) {
  return __fmul_rn(__fmul_rn(col, inv), elim);
}

__global__ void __launch_bounds__(GJ_NT)
panel_kernel(const float* __restrict__ in, const int* __restrict__ mask_in,
             float* __restrict__ out, int* __restrict__ step_out,
             int* __restrict__ row_out, int* __restrict__ mask_out,
             bool* __restrict__ ok_out, int n, int nb) {
  extern __shared__ float smem[];
  const int ld = n + 1;
  float* P = smem;                       // P[h * ld + r] = panel[r][h]
  float* prow = P + (size_t)nb * ld;     // pivot row of the current step
  int* nf_cur = reinterpret_cast<int*>(prow + nb);
  int* nf_next = nf_cur + nb;
  int* state = nf_next + nb;
  float* redv = reinterpret_cast<float*>(state + n);
  int* redi = reinterpret_cast<int*>(redv + GJ_NWARP);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t b = blockIdx.x;
  const size_t base = b * (size_t)n * nb;

  for (int h = tid; h < 2 * nb; h += GJ_NT) nf_cur[h] = 0;
  for (int r = tid; r < n; r += GJ_NT)
    state[r] = mask_in[b * n + r] > 0 ? PRE_PIVOTED : n;
  __syncthreads();
  for (int idx = tid; idx < n * nb; idx += GJ_NT) {
    const int r = idx / nb, h = idx - r * nb;
    const float v = in[base + idx];
    P[h * ld + r] = v;
    if (nonfinite(v)) atomicAdd(nf_cur + h, 1);
  }
  // update walk: rows go to `rows` threads (a power of two >=
  // min(n, GJ_NT)), columns to GJ_NT / rows groups of them
  int rows = 32;
  while (rows < n && rows < GJ_NT) rows <<= 1;
  const int groups = GJ_NT / rows, rt = tid % rows, g = tid / rows;

  float ok = 1.f, inv_prev = 0.f, has_prev = 0.f;
  int p_prev = 0;
  __syncthreads();
  for (int c = 0;; ++c) {
    if (c > 0 && g == 0) {  // store column c - 1: its multipliers
      float* col = P + (c - 1) * ld;
      for (int r = rt; r < n; r += rows) {
        const float elim = state[r] == n && r != p_prev ? has_prev : 0.f;
        const float v = col[r];
        const float f = multiplier(v, inv_prev, elim);
        col[r] = __fadd_rn(__fmul_rn(elim, f), __fmul_rn(1.f - elim, v));
      }
    }
    if (c == nb) break;

    // the pivot: first argmax of |column c| over the rows not pivoted
    const float* colc = P + c * ld;
    float bv = -INFINITY;
    int bi = n;
    for (int r = tid; r < n; r += GJ_NT) {
      const float v = state[r] != n ? -INFINITY : fabsf(colc[r]);
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
      redv[warp] = bv;
      redi[warp] = bi;
    }
    __syncthreads();
    bv = redv[0];
    bi = redi[0];
    for (int q = 1; q < GJ_NWARP; ++q) {
      if (argmax_before(redv[q], redi[q], bv, bi)) {
        bv = redv[q];
        bi = redi[q];
      }
    }
    const int p = bi;  // < n: a first row always exists
    const float has = bv > 0.f ? 1.f : 0.f;  // a NaN maximum is no pivot
    const float xp = colc[p];
    const float pv = nf_cur[c] - nonfinite(xp) > 0 ? NAN : xp;
    const float inv = __fdiv_rn(1.f, __fadd_rn(pv, 1.f - has));
    for (int h = c + 1 + tid; h < nb; h += GJ_NT) {
      const float x = P[h * ld + p];
      prow[h] = nf_cur[h] - nonfinite(x) > 0 ? NAN : x;
      nf_next[h] = 0;
    }
    ok *= has;
    if (tid == 0) {
      row_out[b * nb + c] = p;
      if (has > 0.f) state[p] = c;
    }
    __syncthreads();

    // the update of columns h > c (every row; f = 0 off the eliminated)
    for (int r = rt; r < n; r += rows) {
      const float elim = state[r] == n && r != p ? has : 0.f;
      const float f = multiplier(colc[r], inv, elim);
      for (int h = c + 1 + g; h < nb; h += groups) {
        float* e = P + h * ld + r;
        const float v = fmaf(-f, prow[h], *e);
        *e = v;
        if (nonfinite(v)) atomicAdd(nf_next + h, 1);
      }
    }
    inv_prev = inv;
    has_prev = has;
    p_prev = p;
    __syncthreads();
    int* t = nf_cur;
    nf_cur = nf_next;
    nf_next = t;
  }
  __syncthreads();
  for (int idx = tid; idx < n * nb; idx += GJ_NT) {
    const int r = idx / nb, h = idx - r * nb;
    out[base + idx] = P[h * ld + r];
  }
  for (int r = tid; r < n; r += GJ_NT) {
    const int s = state[r];
    step_out[b * n + r] = s == PRE_PIVOTED ? n : s;
    mask_out[b * n + r] = s != n;
  }
  if (tid == 0) ok_out[b] = ok > 0.f;
}

}  // namespace

extern "C" {

// Shared memory the kernel needs for an [n, nb] panel, in bytes.
size_t panel_smem_bytes(int n, int nb) {
  return panel_smem_floats(n, nb) * sizeof(float);
}

// Launches the kernel on `stream`; returns the cudaError_t of the launch
// (0 on success).  Device pointers to contiguous data: panel and out
// [batch, n, nb] f32 (not the same memory), pivoted, piv_step and
// pivoted_out [batch, n] int32, piv_row [batch, nb] int32, ok [batch]
// bool.  Needs an even nb with 2 <= nb <= n: the row state's n means
// "not pivoted", which a step c >= n could otherwise record.
int lu_panel_f32(const void* panel, const void* pivoted, void* out,
                 void* piv_step, void* piv_row, void* pivoted_out, void* ok,
                 int batch, int n, int nb, void* stream) {
  if (nb < 2 || nb % 2 || n < nb) return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  const size_t smem = panel_smem_bytes(n, nb);
  cudaError_t err = cudaFuncSetAttribute(
      panel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  panel_kernel<<<batch, GJ_NT, smem, (cudaStream_t)stream>>>(
      (const float*)panel, (const int*)pivoted, (float*)out, (int*)piv_step,
      (int*)piv_row, (int*)pivoted_out, (bool*)ok, n, nb);
  return (int)cudaGetLastError();
}

}  // extern "C"
