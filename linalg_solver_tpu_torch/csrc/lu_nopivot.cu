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
// scheduling and is not ported.  One thread block holds one panel, in one
// of two designs chosen by shape (`nopivot_variant`):
//  - the register variants (nb = 32 and nb = 64 up to m = 256: the panels
//    of the phase engine's 256-wide solve and inverse): the panel in
//    registers, a warp owning whole columns with the rows on its lanes,
//    one barrier a step (nopivot_panel_regs).  The warp that owns column
//    c + 1 updates it first, reads its pivot, counts the column's other
//    non-finite entries with one vote (the one-hot read), and publishes
//    the next step's multipliers into the second of two buffers; the
//    pivot row reaches every warp by shuffles.  The panel goes through
//    shared memory (row stride nb + 1) once on the way in and once on
//    the way out, so that both copies coalesce.
//  - nopivot_kernel, for every other shape (other nb, more rows): the
//    whole panel in shared memory, column-major with an odd column stride
//    (m + 1), so the coalesced row-major load from device memory and the
//    update's walk down a column are both free of bank conflicts.  Step c
//    stages the pivot row and scans its column, then each thread
//    recomputes the multipliers of its rows and updates the columns h > c
//    of those rows; the finished column c is written in the next step's
//    staging phase.  Two barriers a step.  When a panel has fewer rows
//    than threads, the threads split the columns as well.
//
// What bounds it.  The panel is read from and written to device memory
// once; in between, nb steps of up to m (nb - 1) fused multiply-adds.  At
// the phase engine's panels (m <= 1016, nb <= 64) that is the latency of
// a step's chain (the owner's column, the division, the barrier), not
// the 67 TFLOP/s of FP32 nor HBM.  Reach: nopivot_kernel's shared
// memory, nopivot_smem_floats(m, nb) = nb (m + 2) <= 58,112 floats, i.e.
// m <= 906 at nb = 64 (the TPU kernel's VMEM budget is 100 MB for 128
// panels); the register variants take a subset of those shapes.
// Arithmetic: one fmaf per update, as the plain version's float64 product
// and difference (gauss_jordan.fms) reproduce; the multipliers round each
// product on its own.  Kernel and plain version agree to the bit but for
// the plain version's double rounding of a rare halfway case.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;
constexpr unsigned FULL = 0xffffffffu;

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

// The register variants' panel: thread (warp, lane) of NW warps keeps
// x[i][k] = panel[lane + 32 i][warp + NW (k + done)] (C = NB / NW slots),
// so a warp owns whole columns with the rows on its lanes.  Step c:
//  - every thread reads the multipliers of its rows (the buffer of step
//    c, written in the previous step by the warp that owns column c);
//  - every warp takes the pivot row's entries of its columns from the
//    lane that holds row c, by shuffles;
//  - the warp that owns column c + 1 updates it first, publishes step
//    c + 1 into the other buffer (OneHotPivot::publish) and writes the
//    finished column to the staging tile; then it updates its other
//    columns;
//  - every other warp updates its columns h > c, one fmaf an entry;
//  - one barrier.
// A warp's finished columns leave its registers and the rest shift down
// one slot (`done` of them are gone), so the warp's next column is always
// slot 0 and every register index is a compile-time constant, as in
// lu_panel.cu's panel_regs_kernel.

// v[i] of lane src for i = ri (warp-uniform), in every lane.
template <int R>
__device__ __forceinline__ float row_value(const float (&v)[R], int ri,
                                           int src) {
  float x = v[0];
#pragma unroll
  for (int i = 1; i < R; ++i) x = i == ri ? v[i] : x;
  return __shfl_sync(FULL, x, src);
}

// Kernel 5's step: the pivot is the one-hot sum of column c (NaN when
// another row of the column is not finite), multipliers
// f = col * inv * below * has into fb, the stored column f + col (1 -
// below); a zero (or NaN) pivot sets *zero_pivot.
struct OneHotPivot {
  int m;
  int* zero_pivot;

  template <int R>
  __device__ __forceinline__ void publish(float (&cv)[R], int c, float* fb,
                                          int lane) {
    bool other = false;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = lane + 32 * i;
      other |= r < m && r != c && !isfinite(cv[i]);
    }
    other = __any_sync(FULL, other);
    const float xc = row_value(cv, c >> 5, c & 31);
    const float pv = other ? __int_as_float(0x7fc00000) : xc;
    const float has = fabsf(pv) > 0.f ? 1.f : 0.f;
    const float inv = __fdiv_rn(1.f, __fadd_rn(pv, 1.f - has));
    if (lane == 0 && has == 0.f) *zero_pivot = 1;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = lane + 32 * i;
      const float below = r > c ? 1.f : 0.f;
      const float f = multiplier(cv[i], inv, below, has);
      if (r < m) fb[r] = f;
      cv[i] = __fadd_rn(f, __fmul_rn(cv[i], 1.f - below));
    }
  }
};

// The nb steps of the panel held in x (m rows, every thread of the block
// calls it); fbuf holds 2 * 32 * R floats of shared memory, and the
// finished column col goes to stage[r * ld + col].
template <int NB, int NW, int R>
__device__ __forceinline__ void nopivot_panel_regs(float (&x)[R][NB / NW],
                                                   OneHotPivot& rule,
                                                   float* fbuf, float* stage,
                                                   int ld) {
  constexpr int C = NB / NW;
  static_assert(NB % NW == 0 && R <= 32, "nopivot_panel_regs shape");
  const int m = rule.m, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  auto retire = [&](const float (&cv)[R], int col) {
#pragma unroll
    for (int i = 0; i < R; ++i)
      if (lane + 32 * i < m) stage[(lane + 32 * i) * ld + col] = cv[i];
  };
  if (warp == 0) {  // step 0's pivot column is warp 0's slot 0
    float cv[R];
#pragma unroll
    for (int i = 0; i < R; ++i) cv[i] = x[i][0];
    rule.publish(cv, 0, fbuf, lane);
    retire(cv, 0);
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int k = 0; k + 1 < C; ++k) x[i][k] = x[i][k + 1];
    }
  }
  __syncthreads();

#pragma unroll 1
  for (int c = 0; c + 1 < NB; ++c) {  // the last step updates no column
    const float* fcur = fbuf + (c & 1) * 32 * R;
    float* fnext = fbuf + ((c + 1) & 1) * 32 * R;
    const int ic = c >> 5, src = c & 31;
    const int done = (c + NW - warp) / NW, live = C - done;
    float pk[C];
#pragma unroll
    for (int k = 0; k < C; ++k) pk[k] = 0.f;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (i == ic) {
#pragma unroll
        for (int k = 0; k < C; ++k) pk[k] = __shfl_sync(FULL, x[i][k], src);
      }
    }
    float f[R];
#pragma unroll
    for (int i = 0; i < R; ++i)
      f[i] = lane + 32 * i < m ? fcur[lane + 32 * i] : 0.f;
    if (warp == (c + 1) % NW) {
      float cv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) cv[i] = fmaf(-f[i], pk[0], x[i][0]);
      rule.publish(cv, c + 1, fnext, lane);
      retire(cv, c + 1);
#pragma unroll
      for (int i = 0; i < R; ++i) {
#pragma unroll
        for (int k = 0; k + 1 < C; ++k)
          if (k + 1 < live) x[i][k] = fmaf(-f[i], pk[k + 1], x[i][k + 1]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < R; ++i) {
#pragma unroll
        for (int k = 0; k < C; ++k)
          if (k < live) x[i][k] = fmaf(-f[i], pk[k], x[i][k]);
      }
    }
    __syncthreads();
  }
}

// The register variants: NW warps, rows lane + 32 i (i < R, m <= 32 R),
// columns warp + NW k (NB = NW C).
template <int NB, int NW, int R, int MINB>
__global__ void __launch_bounds__(NW * 32, MINB)
nopivot_regs_kernel(const float* __restrict__ in, float* __restrict__ out,
                    bool* __restrict__ ok_out, int m) {
  constexpr int NTR = NW * 32, C = NB / NW, LD = NB + 1;
  extern __shared__ float stage[];     // [m, NB + 1]
  __shared__ float fbuf[2 * 32 * R];  // the multipliers of steps c, c + 1
  __shared__ int zero_pivot;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t base = blockIdx.x * (size_t)m * NB;
  for (int idx = tid; idx < m * NB; idx += NTR)
    stage[idx / NB * LD + idx % NB] = in[base + idx];
  if (tid == 0) zero_pivot = 0;
  __syncthreads();
  float x[R][C];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = lane + 32 * i;
#pragma unroll
    for (int k = 0; k < C; ++k)
      x[i][k] = r < m ? stage[r * LD + warp + NW * k] : 0.f;
  }
  OneHotPivot rule{m, &zero_pivot};
  nopivot_panel_regs<NB, NW, R>(x, rule, fbuf, stage, LD);
  __syncthreads();
  for (int idx = tid; idx < m * NB; idx += NTR)
    out[base + idx] = stage[idx / NB * LD + idx % NB];
  if (tid == 0) ok_out[blockIdx.x] = !zero_pivot;
}

// The register variants, (V, NB, NW, R, blocks an SM asked of the
// compiler): 1 takes nb = 32, 2 nb = 64, both up to m = 256 (the panels
// of the 256-wide phase paths); 0 is nopivot_kernel.
#define NOPIVOT_VARIANTS(X) \
  X(1, 32, 8, 8, 2)         \
  X(2, 64, 8, 8, 2)

}  // namespace

extern "C" {

// Shared memory nopivot_kernel (variant 0) needs for an [m, nb] panel, in
// bytes; the reach of the kernel.
size_t nopivot_smem_bytes(int m, int nb) {
  return nopivot_smem_floats(m, nb) * sizeof(float);
}

// The variant that takes an [m, nb] panel (1 <= nb <= m).
int nopivot_variant(int m, int nb) {
  if ((nb == 32 || nb == 64) && m <= 256) return nb == 32 ? 1 : 2;
  return 0;
}

static const void* nopivot_function(int variant, int* threads) {
#define NOPIVOT_CASE(V, NB, NW, R, MINB) \
  case V:                                \
    *threads = NW * 32;                  \
    return (const void*)nopivot_regs_kernel<NB, NW, R, MINB>;
  switch (variant) {
    NOPIVOT_VARIANTS(NOPIVOT_CASE)
    default:
      *threads = NT;
      return (const void*)nopivot_kernel;
  }
#undef NOPIVOT_CASE
}

// Dynamic shared memory of `variant` at [m, nb], in bytes.
static size_t nopivot_variant_smem(int variant, int m, int nb) {
  return variant == 0 ? nopivot_smem_bytes(m, nb)
                      : (size_t)m * (nb + 1) * sizeof(float);
}

// Registers a thread, local (spill) bytes a thread and resident blocks an
// SM of `variant` at [m, nb], into out[0..2]; returns the cudaError_t.
int nopivot_attributes(int variant, int m, int nb, int* out) {
  int threads = 0;
  const void* fn = nopivot_function(variant, &threads);
  const size_t smem = nopivot_variant_smem(variant, m, nb);
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

// Launches the variant nopivot_variant(m, nb) on `stream`; returns the
// cudaError_t of the launch (0 on success).  Device pointers to
// contiguous data: panel and out [batch, m, nb] f32 (not the same
// memory), ok [batch] bool.
int lu_nopivot_f32(const void* panel, void* out, void* ok, int batch, int m,
                   int nb, void* stream) {
  if (batch == 0) return 0;
  const int variant = nopivot_variant(m, nb);
  int threads = 0;
  const void* fn = nopivot_function(variant, &threads);
  const size_t smem = nopivot_variant_smem(variant, m, nb);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (variant) {
#define NOPIVOT_LAUNCH(V, NB, NW, R, MINB)                                 \
  case V:                                                                  \
    nopivot_regs_kernel<NB, NW, R, MINB><<<batch, NW * 32, smem, st>>>(    \
        (const float*)panel, (float*)out, (bool*)ok, m);                   \
    break;
    NOPIVOT_VARIANTS(NOPIVOT_LAUNCH)
#undef NOPIVOT_LAUNCH
    default:
      nopivot_kernel<<<batch, NT, smem, st>>>((const float*)panel, (float*)out,
                                              (bool*)ok, m, nb);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
