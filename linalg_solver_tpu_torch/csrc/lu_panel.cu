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
// ported.  One thread block holds one panel, in one of two designs chosen
// by shape (`panel_variant`):
//  - the register variants (nb = 32 up to n = 1024: reach-960's
//    sub-panels; nb = 64 up to n = 256: the phase loop's 256-row
//    panels): the panel in registers, a warp owning whole columns (rows
//    on the lanes), one barrier a step; see panel_regs_kernel.  The
//    pivot search of column c + 1 is one warp's (its owner's, right
//    after it updates that column), the pivot row reaches each warp by
//    shuffles, and the multipliers go through two shared-memory buffers:
//    no pivot row through shared memory, no block-wide argmax, one
//    barrier where the design below takes three.
//  - panel_kernel, for every other shape (nb other than 32 and 64, or
//    more rows than the register variant of that nb takes): one thread
//    block of 256
//    threads holds one panel in shared memory, column-major with the
//    odd column stride n + 1 (kernel 5's layout), so the coalesced
//    row-major load and the walk down a column are both free of bank
//    conflicts.  Each step: argmax partials (barrier), pivot value,
//    staged pivot row and mask update (barrier), the update of the
//    columns h > c of each thread's rows (barrier); the finished column c
//    is written in the next step's first phase.  The pivot state of every
//    row is one int in shared memory: -1 pre-pivoted, n not pivoted yet,
//    else the step that pivoted it.
// Both designs update pre-pivoted rows with f = 0, as the TPU kernel
// does; skipping them would save nothing in a warp whose other rows work.
//
// What bounds it.  The panel is read from and written to device memory
// once; in between, nb steps of n (nb - c - 1) fused multiply-adds.  At
// the phase loop's panels (n <= 960, nb <= 64) the time is the latency of
// a step's chain (pivot search, division, barrier) times nb, and the
// shared-memory traffic of the update, not the 67 TFLOP/s of FP32 nor
// HBM: the register variants cut the chain to one barrier and one warp's
// search, and move no pivot row through shared memory.
// Reach: panel_kernel's shared memory, panel_smem_floats(n, nb) =
// nb (n + 4) + n + 16 <= 58,112 floats, i.e. n <= 889 at nb = 64, 1756
// at nb = 32 (the caller splits a wider panel, ops/lu_blocked.py
// `panel_split`); the register variants take a subset of those shapes.
// Arithmetic: one fmaf per update, as the plain version's float64 product
// and difference (gauss_jordan.fms) reproduce; the multipliers round each
// product on its own.  Kernel and plain version agree to the bit but for
// the plain version's double rounding of a rare halfway case.

#include "warp_pivot.cuh"

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

// The register variants: thread (warp, lane) keeps x[i][k] = panel
// [lane + 32 i][warp + NW k] in registers (n <= 32 R, NB = NW C), so a
// warp owns whole columns.  A step c takes one barrier:
//  - every thread reads p, has (slots) and the multipliers f of its rows
//    (fbuf), both written in the previous step by the warp that owns
//    column c, into the one of two buffers that step c reads;
//  - every warp takes the pivot row of its own columns from the lane that
//    holds row p, by shuffles (NaN where its one-hot sum is);
//  - the warp that owns column c + 1 computes that column's updated
//    entries first, searches its pivot (warp argmax), writes its stored
//    column (elim f + (1 - elim) col) and publishes p, has and the
//    multipliers of step c + 1 into the other buffers;
//  - every warp updates its columns h > c with one fmaf an entry, and
//    recounts a column's non-finite entries by ballot only after an
//    update that made one.
// The panel goes through shared memory (row stride NB + 1) once on the
// way in and once on the way out, so that both copies coalesce.
template <int R>
__device__ __forceinline__ void panel_search(
    float (&cv)[R], unsigned masked, int n, int c, float* fb, int* slots,
    int* row_out_c, int* step_out_b, int lane) {
  const int p = warp_argmax(cv, masked, n, lane);  // < n
  const float xp = row_value(cv, p >> 5, p & 31);
  const unsigned pbits = __shfl_sync(GJ_FULL, masked, p & 31);
  const bool pmasked = (pbits >> (p >> 5)) & 1u;
  const float has = !pmasked && fabsf(xp) > 0.f ? 1.f : 0.f;
  const float pv = column_nonfinite(cv, n, lane) - nonfinite(xp) > 0 ? NAN
                                                                      : xp;
  const float inv = __fdiv_rn(1.f, __fadd_rn(pv, 1.f - has));
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = lane + 32 * i;
    const float elim = !((masked >> i) & 1u) && r != p ? has : 0.f;
    const float f = multiplier(cv[i], inv, elim);
    if (r < n) fb[r] = f;
    cv[i] = __fadd_rn(__fmul_rn(elim, f), __fmul_rn(1.f - elim, cv[i]));
  }
  if (lane == 0) {
    slots[0] = p;
    slots[1] = has > 0.f;
    *row_out_c = p;
    if (has > 0.f) step_out_b[p] = c;
  }
}

template <int NB, int NW, int R, int MINB>
__global__ void __launch_bounds__(NW * 32, MINB)
panel_regs_kernel(const float* __restrict__ in,
                  const int* __restrict__ mask_in, float* __restrict__ out,
                  int* __restrict__ step_out, int* __restrict__ row_out,
                  int* __restrict__ mask_out, bool* __restrict__ ok_out,
                  int n) {
  constexpr int NT = NW * 32, C = NB / NW, LD = NB + 1;
  static_assert(NB % NW == 0 && R <= 32, "panel_regs_kernel shape");
  extern __shared__ float stage[];  // [n, NB + 1]
  __shared__ float fbuf[2][32 * R];  // the multipliers of steps c, c + 1
  __shared__ int slots[2][2];        // p, has of steps c, c + 1
  __shared__ int nf[NB];  // non-finite entries a column, kept by its warp
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t b = blockIdx.x;
  const float* P = in + b * n * NB;
  int* step_b = step_out + b * n;
  int* row_b = row_out + b * NB;

  for (int idx = tid; idx < n * NB; idx += NT)
    stage[idx / NB * LD + idx % NB] = P[idx];
  for (int h = tid; h < NB; h += NT) nf[h] = 0;
  __syncthreads();
  float x[R][C];
  unsigned masked = 0;  // bit i: row lane + 32 i is pre-pivoted or pivoted
  unsigned pre = 0;
  bool bad = false;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = lane + 32 * i;
    if (r < n && mask_in[b * n + r] > 0) pre |= 1u << i;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      x[i][k] = r < n ? stage[r * LD + warp + NW * k] : 0.f;
      bad |= nonfinite(x[i][k]);
    }
  }
  masked = pre;
  // slot k of this warp holds column warp + NW (k + done) for k < C -
  // done: finished columns leave the registers for the staging tile and
  // the rest shift down, so the warp's next column is always slot 0; the
  // slots past them are dead and never read
  auto column = [&](int k, int done) { return warp + NW * (k + done); };
  bool dirty = false;
  auto recount = [&](int done) {
    if (__any_sync(GJ_FULL, bad)) {
#pragma unroll
      for (int k = 0; k < C; ++k) {
        int cnt = 0;
#pragma unroll
        for (int i = 0; i < R; ++i)
          cnt += __popc(__ballot_sync(
              GJ_FULL, lane + 32 * i < n && nonfinite(x[i][k])));
        if (lane == 0 && k + done < C) nf[column(k, done)] = cnt;
      }
      dirty = true;
    } else if (dirty) {
      if (lane < C) nf[warp + NW * lane] = 0;
      dirty = false;
    }
    __syncwarp();
  };
  // the stored column leaves slot 0 for the staging tile
  auto retire = [&](const float (&cv)[R], int col) {
#pragma unroll
    for (int i = 0; i < R; ++i)
      if (lane + 32 * i < n) stage[(lane + 32 * i) * LD + col] = cv[i];
  };
  recount(0);
  if (warp == 0) {  // the pivot of step 0
    float cv[R];
#pragma unroll
    for (int i = 0; i < R; ++i) cv[i] = x[i][0];
    panel_search(cv, masked, n, 0, fbuf[0], slots[0], row_b, step_b, lane);
    retire(cv, 0);
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int k = 0; k + 1 < C; ++k) x[i][k] = x[i][k + 1];
    }
  }
  __syncthreads();

  bool ok = true;
#pragma unroll 1
  for (int c = 0; c < NB; ++c) {
    const int buf = c & 1, p = slots[buf][0], ip = p >> 5;
    const bool has = slots[buf][1];
    const int done = (c + NW - warp) / NW, live = C - done;
    ok = ok && has;
    // the pivot row in this warp's columns, from the lane that holds it
    float pk[C];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (i == ip) {
#pragma unroll
        for (int k = 0; k < C; ++k)
          pk[k] = __shfl_sync(GJ_FULL, x[i][k], p & 31);
      }
    }
    if (dirty) {  // the one-hot sum is NaN where another row is not finite
#pragma unroll
      for (int k = 0; k < C; ++k)
        if (k < live && nf[column(k, done)] - nonfinite(pk[k]) > 0)
          pk[k] = NAN;
    }
    if (has && lane == (p & 31)) masked |= 1u << ip;
    // the update of columns h > c (every row; f = 0 off the eliminated);
    // a sum of the entries flags a non-finite one (or an overflow, which
    // only costs an exact recount)
    float chk = 0.f;
    if (c + 1 < NB && warp == (c + 1) % NW) {
      // this warp owns column c + 1 (slot 0): its pivot search first,
      // then the update of the other slots, shifted down one
      float f[R], cv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = lane + 32 * i;
        f[i] = r < n ? fbuf[buf][r] : 0.f;
        cv[i] = fmaf(-f[i], pk[0], x[i][0]);
      }
      panel_search(cv, masked, n, c + 1, fbuf[buf ^ 1], slots[buf ^ 1],
                   row_b + c + 1, step_b, lane);
      retire(cv, c + 1);
      // slots from live - 1 on are dead: never read again
#pragma unroll
      for (int i = 0; i < R; ++i) {
#pragma unroll
        for (int k = 0; k + 1 < C; ++k) {
          if (k + 1 < live) {
            x[i][k] = fmaf(-f[i], pk[k + 1], x[i][k + 1]);
            chk += x[i][k];
          }
        }
      }
      bad = nonfinite(chk);
      recount(done + 1);
    } else {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = lane + 32 * i;
        const float f = r < n ? fbuf[buf][r] : 0.f;
#pragma unroll
        for (int k = 0; k < C; ++k) {
          if (k < live) {
            x[i][k] = fmaf(-f, pk[k], x[i][k]);
            chk += x[i][k];
          }
        }
      }
      bad = nonfinite(chk);
      recount(done);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = lane + 32 * i;
    if (r < n && warp == 0) {
      const bool pivoted_here = ((masked & ~pre) >> i) & 1u;
      if (!pivoted_here) step_b[r] = n;
      mask_out[b * n + r] = (masked >> i) & 1u;
    }
  }
  if (tid == 0) ok_out[b] = ok;
  float* O = out + b * n * NB;
  for (int idx = tid; idx < n * NB; idx += NT)
    O[idx] = stage[idx / NB * LD + idx % NB];
}

// The register variants, (NB, NW, R, blocks an SM asked of the
// compiler): 1 takes nb = 32 up to n = 1024, 2 takes nb = 64 up to
// n = 256; 0 is panel_kernel.  Only the shapes the phase loop gives the
// kernel have one: the 64-wide panels of the 256-wide paths and the
// 32-wide sub-panels of reach-960.
#define PANEL_VARIANTS(X) \
  X(1, 32, 32, 32, 1)     \
  X(2, 64, 8, 8, 2)

}  // namespace

extern "C" {

// Shared memory panel_kernel (variant 0) needs for an [n, nb] panel, in
// bytes; the reach of the kernel.
size_t panel_smem_bytes(int n, int nb) {
  return panel_smem_floats(n, nb) * sizeof(float);
}

// The variant that takes an [n, nb] panel (nb even, 2 <= nb <= n).
int panel_variant(int n, int nb) {
  if (nb == 32) return n <= 1024 ? 1 : 0;
  if (nb == 64) return n <= 256 ? 2 : 0;
  return 0;
}

static const void* panel_function(int variant, int* threads) {
#define PANEL_CASE(V, NB, NW, R, MINB) \
  case V:                              \
    *threads = NW * 32;                \
    return (const void*)panel_regs_kernel<NB, NW, R, MINB>;
  switch (variant) {
    PANEL_VARIANTS(PANEL_CASE)
    default:
      *threads = GJ_NT;
      return (const void*)panel_kernel;
  }
#undef PANEL_CASE
}

// Dynamic shared memory of `variant` at [n, nb], in bytes: variant 0 the
// panel and its state, the register variants the staging tile.
static size_t panel_variant_smem(int variant, int n, int nb) {
  return variant == 0 ? panel_smem_bytes(n, nb)
                      : (size_t)n * (nb + 1) * sizeof(float);
}

// Registers a thread, local (spill) bytes a thread and resident blocks an
// SM of `variant` at [n, nb], into out[0..2]; returns the cudaError_t.
int panel_attributes(int variant, int n, int nb, int* out) {
  int threads = 0;
  const void* fn = panel_function(variant, &threads);
  const size_t smem = panel_variant_smem(variant, n, nb);
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

// Launches the variant panel_variant(n, nb) on `stream`; returns the
// cudaError_t of the launch (0 on success).  Device pointers to
// contiguous data: panel and out [batch, n, nb] f32 (not the same
// memory), pivoted, piv_step and pivoted_out [batch, n] int32, piv_row
// [batch, nb] int32, ok [batch] bool.  Needs an even nb with
// 2 <= nb <= n: the row state's n means "not pivoted", which a step
// c >= n could otherwise record.
int lu_panel_f32(const void* panel, const void* pivoted, void* out,
                 void* piv_step, void* piv_row, void* pivoted_out, void* ok,
                 int batch, int n, int nb, void* stream) {
  if (nb < 2 || nb % 2 || n < nb) return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  const int variant = panel_variant(n, nb);
  int threads = 0;
  const void* fn = panel_function(variant, &threads);
  const size_t smem = panel_variant_smem(variant, n, nb);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  const float* P = (const float*)panel;
  const int* M = (const int*)pivoted;
  switch (variant) {
#define PANEL_LAUNCH(V, NB, NW, R, MINB)                                \
  case V:                                                               \
    panel_regs_kernel<NB, NW, R, MINB><<<batch, NW * 32, smem, st>>>(   \
        P, M, (float*)out, (int*)piv_step, (int*)piv_row,               \
        (int*)pivoted_out, (bool*)ok, n);                               \
    break;
    PANEL_VARIANTS(PANEL_LAUNCH)
#undef PANEL_LAUNCH
    default:
      panel_kernel<<<batch, GJ_NT, smem, st>>>(
          P, M, (float*)out, (int*)piv_step, (int*)piv_row,
          (int*)pivoted_out, (bool*)ok, n, nb);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
