// LU factorization of a batch of [m, nb] panels without a pivot search:
// the pivot of column c is row c.
//
// Replaces the Pallas TPU kernel `_nopivot_kernel` in
// linalg_solver_tpu/ops/pallas/lu_nopivot_kernel.py (launched by
// `panel_factor_nopivot` from the RBT phase engine, ops/rbt.py's
// `_nopivot_lu_phases`).  Same math, per panel: nb right-looking rank-1
// steps with the TPU kernel's zero-pivot rule, formula for formula,
//   pv  = sum_r col[r] * (r == c)            (a one-hot read)
//   has = |pv| > 0,   inv = 1 / (pv + (1 - has)),
//   f   = col * inv * below * has            (below: rows r > c)
//   columns h > c, every row:   a[r][h] -= f[r] * a[c][h]
//   column c:                   a[r][c]  = f[r] + col[r] * (1 - below)
// and ok = every pivot nonzero.  The one-hot read makes the pivot NaN as
// soon as any entry of its column is Inf or NaN (0 * Inf = NaN); here a
// barrier that ORs a per-thread scan of the column gives the same value.
// A NaN pivot counts as zero and is flagged, and its NaN still spreads
// through inv and f.  Rows past nb end up holding the L21 multipliers.
//
// Mapping on the H100.  The TPU kernel keeps 128 panels in the vector
// lanes, [nb, m, 128] in VMEM, and folds `lookahead` steps into one pass
// over the live block to cut Mosaic's per-step overhead; that folding is
// scheduling and is not ported.  Here one thread block holds one panel in
// shared memory, column-major with an odd column stride (m + 1), so the
// coalesced row-major load from device memory and the update's walk down
// a column are both free of bank conflicts.  Step c stages the pivot row
// and scans its column, then each thread recomputes the multipliers of its
// rows and updates the columns h > c of those rows; the finished column c
// is written in the next step's staging phase.  Two barriers a step.
// When a panel has fewer rows than threads, the threads split the columns
// as well.
//
// What bounds it.  The panel is read from and written to device memory
// once; in between, nb steps of up to m (nb - 1) fused multiply-adds from
// shared memory, two barriers each.  At the phase engine's panels
// (m <= 1016, nb <= 64) that is latency of shared memory and barriers, not
// the 67 TFLOP/s of FP32 nor HBM.  Reach: nopivot_smem_floats(m, nb) =
// nb (m + 2) <= 58,112 floats, i.e. m <= 906 at nb = 64 (the TPU kernel's
// VMEM budget is 100 MB for 128 panels).
// Arithmetic: one fmaf per update, as the plain version's float64 product
// and difference (gauss_jordan.fms) reproduce; the multipliers round each
// product on its own.  Kernel and plain version agree to the bit but for
// the plain version's double rounding of a rare halfway case.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;

__host__ __device__ inline size_t nopivot_smem_floats(int m, int nb) {
  return (size_t)nb * (m + 1) + nb;  // the panel, the staged pivot row
}

// f = col * inv * below * has, each product rounded on its own.
__device__ __forceinline__ float multiplier(float col, float inv, float below,
                                            float has) {
  return __fmul_rn(__fmul_rn(__fmul_rn(col, inv), below), has);
}

__global__ void __launch_bounds__(NT)
nopivot_kernel(const float* __restrict__ in, float* __restrict__ out,
               bool* __restrict__ ok_out, int m, int nb) {
  extern __shared__ float smem[];
  const int ld = m + 1;
  float* P = smem;                      // P[h * ld + r] = panel[r][h]
  float* prow = smem + (size_t)nb * ld;  // pivot row of the current step
  const size_t base = blockIdx.x * (size_t)m * nb;
  const int tid = threadIdx.x;
  for (int idx = tid; idx < m * nb; idx += NT) {
    const int r = idx / nb, h = idx - r * nb;
    P[h * ld + r] = in[base + idx];
  }
  // rows go to `rows` threads (a power of two >= min(m, NT)), columns to
  // NT / rows groups of them
  int rows = 32;
  while (rows < m && rows < NT) rows <<= 1;
  const int groups = NT / rows, rt = tid % rows, g = tid / rows;

  float ok = 1.f, inv_prev = 0.f, has_prev = 0.f;
  __syncthreads();
  for (int c = 0;; ++c) {
    if (c > 0 && g == 0) {  // store column c - 1
      float* col = P + (c - 1) * ld;
      for (int r = rt; r < m; r += rows) {
        const float below = r > c - 1 ? 1.f : 0.f;
        const float v = col[r];
        const float f = multiplier(v, inv_prev, below, has_prev);
        col[r] = __fadd_rn(f, __fmul_rn(v, 1.f - below));
      }
    }
    if (c == nb) break;
    for (int h = c + 1 + tid; h < nb; h += NT) prow[h] = P[h * ld + c];
    const float* colc = P + c * ld;
    int other = 0;  // a non-finite entry of column c off the diagonal
    for (int r = tid; r < m; r += NT) other |= r != c && !isfinite(colc[r]);
    other = __syncthreads_or(other);
    const float pv = other ? __int_as_float(0x7fc00000) : colc[c];
    const float has = fabsf(pv) > 0.f ? 1.f : 0.f;
    const float inv = __fdiv_rn(1.f, __fadd_rn(pv, 1.f - has));
    ok *= has;
    for (int r = rt; r < m; r += rows) {
      const float f = multiplier(colc[r], inv, r > c ? 1.f : 0.f, has);
      for (int h = c + 1 + g; h < nb; h += groups) {
        float* e = P + h * ld + r;
        *e = fmaf(-f, prow[h], *e);
      }
    }
    inv_prev = inv;
    has_prev = has;
    __syncthreads();
  }
  __syncthreads();
  for (int idx = tid; idx < m * nb; idx += NT) {
    const int r = idx / nb, h = idx - r * nb;
    out[base + idx] = P[h * ld + r];
  }
  if (tid == 0) ok_out[blockIdx.x] = ok > 0.f;
}

}  // namespace

extern "C" {

// Shared memory the kernel needs for an [m, nb] panel, in bytes.
size_t nopivot_smem_bytes(int m, int nb) {
  return nopivot_smem_floats(m, nb) * sizeof(float);
}

// Launches the kernel on `stream`; returns the cudaError_t of the launch
// (0 on success).  Device pointers to contiguous data: panel and out
// [batch, m, nb] f32 (not the same memory), ok [batch] bool.
int lu_nopivot_f32(const void* panel, void* out, void* ok, int batch, int m,
                   int nb, void* stream) {
  if (batch == 0) return 0;
  const size_t smem = nopivot_smem_bytes(m, nb);
  cudaError_t err = cudaFuncSetAttribute(
      nopivot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  nopivot_kernel<<<batch, NT, smem, (cudaStream_t)stream>>>(
      (const float*)panel, (float*)out, (bool*)ok, m, nb);
  return (int)cudaGetLastError();
}

}  // extern "C"
