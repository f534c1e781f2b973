// The masked triangular Sylvester solve of a reordered complex Schur form,
// one launch a solve (ops/ordschur.py's cluster condition numbers, through
// ops/kernels/trsyl.py).
//
// Replaces the reference's `_trsyl_masked` (linalg_solver_tpu/ops/
// ordschur.py:510), which is not a Pallas kernel: the TPU runs it as an XLA
// `lax.scan` over rows (:649) with an inner `lax.scan` over columns (:637),
// n^2 dependent steps of a dozen vector operations each.  Run eagerly that
// is about a million small launches a solve at n = 256, and
// `schur_cluster_cond_batched` solves 1 + 2 sep_iters times.
//
// Math, a lane (M = T forward, M = T^H for the adjoint, complex as (re, im)
// pairs, m the lane's cluster size): for each row i < m, from the last
// (forward) or the first (adjoint),
//   rhs_j = C[i, j] - sum_k M[i, k] X[k, j]   over the rows k < m solved
//                                              before i (k > i or k < i)
//   den_j = M[i, i] - M[j, j], floored to +-smin with pert set where
//           |den_j|^2 < smin^2
//   x_j   = (rhs_j + acc_j) / den_j            columns j >= m, ascending
//                                              (forward) or descending
//   acc_l += x_j M[j, l]                       for the columns l after j
// X is zero outside rows < m x columns >= m.
//
// Mapping on the H100: one block a lane, a thread a column (n <= 1024).
// The row's masked product runs first, each thread summing its own column
// of X (which it wrote itself) a term at a time, M's row read as a
// broadcast; then the n - m column steps: the thread of column j forms x_j,
// puts it in shared memory, one barrier, and every later column adds
// x_j M[j, l] (row j of M read coalesced).  T stays in device memory and
// L2 (32 lanes of complex 256 x 256 f32 are 16 MB).  Bound: the column
// steps are a dependent chain of m (n - m) barrier steps a lane, ~16k at
// n = 256: latency, not bytes or operations; 32 lanes fill 32 of the 132
// SMs.
//
// Arithmetic: every product, sum, difference and quotient rounded on its
// own (schur_rn.cuh), the row's product summed a term at a time in the
// plain version's order (four sums: re*re, im*im, re*im, im*re), so the
// kernel agrees with ops/kernels/trsyl.py's plain version to the bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "schur_rn.cuh"

namespace {

using namespace schur_rn;

constexpr int MAX_N = 1024;

template <typename T>
__global__ void trsyl_kernel(const T* __restrict__ mre,
                             const T* __restrict__ mim,
                             const int32_t* __restrict__ mvec,
                             const T* __restrict__ cre,
                             const T* __restrict__ cim,
                             const T* __restrict__ sminv, T* xre, T* xim,
                             uint8_t* __restrict__ pert_out, int n,
                             int adjoint) {
  extern __shared__ unsigned char smem_raw[];
  T* xs_re = reinterpret_cast<T*>(smem_raw);
  T* xs_im = xs_re + n;
  const int b = blockIdx.x;
  const int j = threadIdx.x;
  const size_t off = (size_t)b * n * n;
  mre += off;
  mim += off;
  cre += off;
  cim += off;
  xre += off;
  xim += off;
  const int m = mvec[b];
  const T smin = sminv[b];
  const T smin2 = mul(smin, smin);
  const bool col = j >= m;
  const T djr = col ? mre[(size_t)j * n + j] : T(0);
  const T dji = col ? mim[(size_t)j * n + j] : T(0);
  bool pert = false;
  for (int t = 0; t < m; ++t) {
    const int i = adjoint ? t : m - 1 - t;
    const size_t ri = (size_t)i * n;
    T rr = T(0), rim = T(0), dr = T(1), di = T(0), d2 = T(1);
    T accr = T(0), acci = T(0);
    if (col) {
      T sr = T(0), si = T(0), tr = T(0), ti = T(0);
      const int k0 = adjoint ? 0 : i + 1;
      const int k1 = adjoint ? i : m;
      for (int k = k0; k < k1; ++k) {
        const T wr = mre[ri + k], wi = mim[ri + k];
        const T xr = xre[(size_t)k * n + j], xi = xim[(size_t)k * n + j];
        sr = add(sr, mul(wr, xr));
        si = add(si, mul(wi, xi));
        tr = add(tr, mul(wr, xi));
        ti = add(ti, mul(wi, xr));
      }
      rr = sub(cre[ri + j], sub(sr, si));
      rim = sub(cim[ri + j], add(tr, ti));
      dr = sub(mre[ri + i], djr);
      di = sub(mim[ri + i], dji);
      if (add(mul(dr, dr), mul(di, di)) < smin2) {
        dr = dr < T(0) ? -smin : smin;
        di = T(0);
        pert = true;
      }
      d2 = add(mul(dr, dr), mul(di, di));
    }
    for (int s = 0; s < n - m; ++s) {
      const int jj = adjoint ? n - 1 - s : m + s;
      if (j == jj) {
        const T nr = add(rr, accr), ni = add(rim, acci);
        const T xr = dvd(add(mul(nr, dr), mul(ni, di)), d2);
        const T xi = dvd(sub(mul(ni, dr), mul(nr, di)), d2);
        xs_re[jj] = xr;
        xs_im[jj] = xi;
        xre[ri + j] = xr;
        xim[ri + j] = xi;
      }
      __syncthreads();
      if (col && (adjoint ? j < jj : j > jj)) {
        const T xr = xs_re[jj], xi = xs_im[jj];
        const T mr = mre[(size_t)jj * n + j], mi = mim[(size_t)jj * n + j];
        accr = add(accr, sub(mul(xr, mr), mul(xi, mi)));
        acci = add(acci, add(mul(xr, mi), mul(xi, mr)));
      }
    }
    // every read of this row's slots is done before the next row writes
    // them (the last step's reads end here)
    __syncthreads();
  }
  pert = __syncthreads_or(pert);
  if (j == 0) pert_out[b] = pert ? 1 : 0;
}

template <typename T>
int launch(const void* mre, const void* mim, const void* m, const void* cre,
           const void* cim, const void* smin, void* xre, void* xim,
           void* pert, int batch, int n, int adjoint, cudaStream_t s) {
  const size_t smem = 2 * (size_t)n * sizeof(T);
  trsyl_kernel<T><<<batch, n, smem, s>>>(
      (const T*)mre, (const T*)mim, (const int32_t*)m, (const T*)cre,
      (const T*)cim, (const T*)smin, (T*)xre, (T*)xim, (uint8_t*)pert, n,
      adjoint);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Registers a thread, local (spill) bytes a thread and the dynamic shared
// memory of the kernel that takes n (f32 when f64 is 0), into out[0..2];
// one kernel serves both directions (`adjoint` is a kernel argument).
// Returns the cudaError_t.
int trsyl_attributes(int n, int f64, int adjoint, int* out) {
  (void)adjoint;
  const void* fn = f64 ? (const void*)trsyl_kernel<double>
                       : (const void*)trsyl_kernel<float>;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)(2 * (size_t)n * (f64 ? sizeof(double) : sizeof(float)));
  return (int)err;
}

// Launches the masked Sylvester solve on `stream`: M (re, im) [batch, n, n]
// (T forward, T^H when adjoint is 1), m [batch] int32, C (re, im)
// [batch, n, n], smin [batch], all contiguous, f32 when f64 is 0, else f64;
// X (re, im) [batch, n, n] zero on entry, the solution on exit; pert
// [batch] bool.  Returns the cudaError_t of the launch (0 on success), or
// cudaErrorInvalidValue past the kernel's reach (n > 1024).
int trsyl_masked(const void* mre, const void* mim, const void* m,
                 const void* cre, const void* cim, const void* smin,
                 void* xre, void* xim, void* pert, int batch, int n,
                 int adjoint, int f64, void* stream) {
  if (n < 1 || n > MAX_N) return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (f64)
    return launch<double>(mre, mim, m, cre, cim, smin, xre, xim, pert, batch,
                          n, adjoint, s);
  return launch<float>(mre, mim, m, cre, cim, smin, xre, xim, pert, batch, n,
                       adjoint, s);
}

}  // extern "C"
