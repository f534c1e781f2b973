// Two-sided random butterfly of depth <= 2 on a batch of square matrices:
// U^T A V (both sides transposed, the preconditioning of the RBT phase
// engine) or V X U^T (both sides plain, with the diagonals (v, u), the
// reconstruction of its inverse), or any mix of the two.
//
// Replaces the Pallas TPU kernel `_bf2_kernel` in
// linalg_solver_tpu/ops/pallas/butterfly_kernel.py (launched by
// `butterfly_two_sided`).  Same math: ops/rbt.py's butterfly_apply on the
// rows, then on the columns.  Level l splits an index range into segments
// of n >> l; in a segment with halves (t, b) and diagonals (r0, r1)
//   trans:  t' = r0 (t + b) / sqrt2,        b' = r1 (t - b) / sqrt2
//   plain:  t' = (r0 t + r1 b) / sqrt2,     b' = (r0 t - r1 b) / sqrt2
// `trans` runs levels 0..d-1, plain d-1..0.
//
// Mapping on the H100.  The TPU kernel holds 8 whole matrices in VMEM per
// grid step and applies level after level to them.  Here nothing needs a
// whole matrix: at depth d every output entry depends only on its orbit,
// rows {r + i n/2^d} x columns {c + j n/2^d}, i, j < 2^d.  One thread
// loads one orbit (16 values at depth 2) into registers, applies every
// level of both sides there, and stores it.  Neighbouring threads take
// neighbouring c, so each of the 2^{2d} loads and stores of a warp is one
// coalesced 128-byte line.  No shared memory, no barriers.
//
// What bounds it.  One read and one write of the batch in device memory
// (128 MB at B = N = 256) against 3 operations an entry a level: far below
// the card's 295 operations a byte, so HBM bandwidth (3.35 TB/s) sets the
// time, about 0.04 ms at that shape.
// Arithmetic: every product and sum is rounded on its own (__fmul_rn,
// __fadd_rn, __fsub_rn; nvcc would otherwise contract r0 t + r1 b into an
// FMA), as the plain version's elementwise passes round, so that kernel
// and plain version agree to the bit.

#include <cuda_runtime.h>

namespace {

constexpr float SQRT_HALF = 0.7071067811865476f;
constexpr int NT = 256;

// One level on a line of S = 2^D orbit values, `x[i * stride]`: pairs
// (i, i + h) for the i with bit log2(h) clear, with the level's diagonal
// entries `r[i]` of the orbit.
template <int D, bool TRANS>
__device__ __forceinline__ void level(float* x, int stride, int h,
                                      const float* r) {
  constexpr int S = 1 << D;
#pragma unroll
  for (int i = 0; i < S; ++i) {
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

// The depth-D butterfly along one side of the orbit: S lines of S values,
// line k at x[k * line], entry i of a line at x[i * stride]; `r[l S + i]`
// is level l's diagonal at orbit entry i.  Level l pairs orbit entries
// 2^{D-1-l} apart.
template <int D, bool TRANS>
__device__ __forceinline__ void side(float* x, int line, int stride,
                                     const float* r) {
  constexpr int S = 1 << D;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const int lvl = TRANS ? k : D - 1 - k;
#pragma unroll
    for (int ln = 0; ln < S; ++ln)
      level<D, TRANS>(x + ln * line, stride, 1 << (D - 1 - lvl), r + lvl * S);
  }
}

template <int D, bool TR, bool TC>
__global__ void __launch_bounds__(NT)
bf2_kernel(const float* __restrict__ a, const float* __restrict__ dr,
           const float* __restrict__ dc, float* __restrict__ out, int n,
           size_t total) {
  constexpr int S = 1 << D;
  const int q = n >> D;
  const size_t per = (size_t)q * q;
  for (size_t t = blockIdx.x * (size_t)NT + threadIdx.x; t < total;
       t += (size_t)gridDim.x * NT) {
    const size_t m = t / per;
    const int rem = (int)(t - m * per);
    const int r = rem / q, c = rem - r * q;
    const float* A = a + m * n * (size_t)n;
    float x[S * S];  // x[i * S + j] = A[r + i q][c + j q]
    float rr[D * S], rc[D * S];  // the orbit's diagonal entries by level
#pragma unroll
    for (int i = 0; i < S; ++i) {
#pragma unroll
      for (int l = 0; l < D; ++l) {
        rr[l * S + i] = __ldg(dr + l * n + r + i * q);
        rc[l * S + i] = __ldg(dc + l * n + c + i * q);
      }
#pragma unroll
      for (int j = 0; j < S; ++j)
        x[i * S + j] = A[(size_t)(r + i * q) * n + c + j * q];
    }
    side<D, TR>(x, 1, S, rr);   // rows: line j, entries i
    side<D, TC>(x, S, 1, rc);   // columns: line i, entries j
    float* O = out + m * n * (size_t)n;
#pragma unroll
    for (int i = 0; i < S; ++i)
#pragma unroll
      for (int j = 0; j < S; ++j)
        O[(size_t)(r + i * q) * n + c + j * q] = x[i * S + j];
  }
}

template <int D, bool TR, bool TC>
cudaError_t launch(const float* a, const float* dr, const float* dc,
                   float* out, int batch, int n, cudaStream_t stream) {
  const int q = n >> D;
  const size_t total = (size_t)batch * q * q;
  const size_t want = (total + NT - 1) / NT;
  const unsigned grid = (unsigned)(want < (1u << 30) ? want : (1u << 30));
  bf2_kernel<D, TR, TC><<<grid, NT, 0, stream>>>(a, dr, dc, out, n, total);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_depth(const float* a, const float* dr, const float* dc,
                         float* out, int batch, int n, int tr, int tc,
                         cudaStream_t stream) {
  if (tr && tc) return launch<D, true, true>(a, dr, dc, out, batch, n, stream);
  if (tr) return launch<D, true, false>(a, dr, dc, out, batch, n, stream);
  if (tc) return launch<D, false, true>(a, dr, dc, out, batch, n, stream);
  return launch<D, false, false>(a, dr, dc, out, batch, n, stream);
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns the cudaError_t of the launch
// (0 on success), or cudaErrorInvalidValue for a depth other than 1 or 2
// or an n that is not a multiple of 2^depth.  Device pointers to
// contiguous f32 data: a and out [batch, n, n] (not the same memory), dr
// and dc [depth, n] (row-side and column-side diagonals; further rows are
// not read).  `trans_rows` / `trans_cols` != 0 apply B^T on that side.
int butterfly_two_sided_f32(const void* a, const void* dr, const void* dc,
                            void* out, int batch, int n, int depth,
                            int trans_rows, int trans_cols, void* stream) {
  if ((depth != 1 && depth != 2) || n < (1 << depth) || n % (1 << depth))
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  const float* A = (const float*)a;
  const float* R = (const float*)dr;
  const float* C = (const float*)dc;
  float* O = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  const int tr = trans_rows, tc = trans_cols;
  if (depth == 1) return (int)launch_depth<1>(A, R, C, O, batch, n, tr, tc, s);
  return (int)launch_depth<2>(A, R, C, O, batch, n, tr, tc, s);
}

}  // extern "C"
