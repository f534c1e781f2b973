// A form of the trsyl kernel (linalg_solver_tpu_torch/csrc/trsyl.cu) that
// lost to the package's (one block a lane, a thread a column) when the two
// were timed in turns, kept so that its times can be measured again:
//
//   python3 tools/time_pivoted.py --big --trsyl-form tools/trsyl_warp.cu
//
// builds it beside the package's kernel and times both in turns on the
// same operands, after checking that the two agree to the bit.  It keeps
// its own C entry `trsyl_attributes` (registers, spills, shared memory).
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
// Mapping on the H100: one warp a lane (a block of 32 threads).  A row's
// n - m columns are taken in the order they are solved, position p being
// column m + p (forward) or n - 1 - p (adjoint), and thread t owns the
// positions t + 32 q; each column's rhs and running sum acc live in shared
// memory, written and read by its own thread only.  The row's masked
// product runs first, each thread summing its own columns of X a term at
// a time, row i of M read as a broadcast.  Then the positions are solved
// 32 at a time: in block q the thread of the next position forms x from
// its running sum, two shuffles (re, im) give it to the warp, and each
// thread of a later position in the block adds x M[j, l] to its own sum
// in registers (a select; the thread's column of the block's triangle is
// loaded into registers before the chain): a chain of 32 steps with no
// barrier, no branch and no load.  Only then are the block's 32 x applied
// to the later blocks' sums, each sum taking its terms in the order the
// columns were solved, as the plain version adds them.  T22's triangle
// (the M[j, l] those steps read, in position order) and then X's block
// (rows < m, columns >= m) are kept in shared memory where they fit (f32
// at n = 256: both from m ~ 100 on, the triangle always), else read from
// L2.  Bound: the chain is m (n - m) dependent steps a lane, ~16k at
// n = 256, each a complex multiply-add, a quotient and two shuffles:
// latency, not bytes or operations; 32 lanes fill 32 of the 132 SMs.
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
constexpr size_t SMEM_MAX = 232448;
constexpr unsigned FULL = 0xffffffffu;

// (re, im) arrays [n] of a lane's shared memory: rhs, acc, row i of M,
// M's diagonal; then the block's 32 x
constexpr int COL_ARRAYS = 8;

// Dynamic shared memory of a lane at n: the column arrays, then T22's
// triangle and X's block (re, im; at most n^2 / 2 + n entries together)
// up to the block's limit.
template <typename T>
size_t smem_bytes(int n) {
  const size_t cols = (COL_ARRAYS * (size_t)n + 64) * sizeof(T);
  const size_t st = ((size_t)n * n + 2 * (size_t)n) * sizeof(T);
  return cols + st < SMEM_MAX ? cols + st : SMEM_MAX;
}

// The column of position p
template <int ADJ>
__device__ __forceinline__ int col_of(int p, int m, int n) {
  return ADJ ? n - 1 - p : m + p;
}

// Offset in T22's packed triangle of M[col(p), col(p')], p < p' < k22
__device__ __forceinline__ int tri_at(int p, int pp, int k22) {
  return p * k22 - p * (p + 1) / 2 + pp - p - 1;
}

// The row's masked product for the thread's positions 32 (q0 + v) + t,
// v < 4: X's rows k0 <= k < k1 from X's block in shared memory (XS) or
// from X itself
template <typename T, int ADJ, bool XS>
__device__ __forceinline__ void row_product(
    T (&sr)[4], T (&si)[4], T (&tr)[4], T (&ti)[4], const T* row_re,
    const T* row_im, const T* x_re, const T* x_im, int k22, int q0, int t,
    int k0, int k1, int m, int n) {
#pragma unroll
  for (int v = 0; v < 4; ++v) sr[v] = si[v] = tr[v] = ti[v] = T(0);
#pragma unroll 4
  for (int k = k0; k < k1; ++k) {
    const T wr = row_re[k], wi = row_im[k];
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int p = 32 * (q0 + v) + t;
      if (p < k22) {
        const size_t a = XS ? (size_t)k * k22 + p
                            : (size_t)k * n + col_of<ADJ>(p, m, n);
        const T xr = x_re[a], xi = x_im[a];
        sr[v] = add(sr[v], mul(wr, xr));
        si[v] = add(si[v], mul(wi, xi));
        tr[v] = add(tr[v], mul(wr, xi));
        ti[v] = add(ti[v], mul(wi, xr));
      }
    }
  }
}

template <typename T, int ADJ>
__global__ void __launch_bounds__(32, 1)
trsyl_kernel(const T* __restrict__ mre, const T* __restrict__ mim,
             const int32_t* __restrict__ mvec, const T* __restrict__ cre,
             const T* __restrict__ cim, const T* __restrict__ sminv,
             T* __restrict__ xre, T* __restrict__ xim,
             uint8_t* __restrict__ pert_out, int n, int smem) {
  extern __shared__ unsigned char smem_raw[];
  T* rs_re = reinterpret_cast<T*>(smem_raw);  // by position
  T* rs_im = rs_re + n;
  T* ac_re = rs_im + n;  // by position
  T* ac_im = ac_re + n;
  T* row_re = ac_im + n;  // row i of M, by column
  T* row_im = row_re + n;
  T* dg_re = row_im + n;  // M's diagonal, by position
  T* dg_im = dg_re + n;
  T* xb_re = dg_im + n;  // the block's x
  T* xb_im = xb_re + 32;
  T* st = xb_im + 32;  // T22's triangle, then X's block [m][n - m]
  const int b = blockIdx.x, t = threadIdx.x;
  const size_t off = (size_t)b * n * n;
  mre += off;
  mim += off;
  cre += off;
  cim += off;
  xre += off;
  xim += off;
  const int m = mvec[b];
  if (m <= 0 || m >= n) {  // no block to solve: X stays zero
    if (t == 0) pert_out[b] = 0;
    return;
  }
  const int k22 = n - m;
  const size_t cap = (smem / sizeof(T) - COL_ARRAYS * (size_t)n - 64) / 2;
  const size_t tsz = (size_t)k22 * (k22 - 1) / 2, xsz = (size_t)m * k22;
  const bool tri_on = tsz <= cap;
  const bool xs_on = (tri_on ? tsz : 0) + xsz <= cap;
  T* tr_re = st;
  T* tr_im = tr_re + (tri_on ? tsz : 0);
  T* xs_re = tr_im + (tri_on ? tsz : 0);
  T* xs_im = xs_re + (xs_on ? xsz : 0);
  if (tri_on) {
    for (int p = 0; p + 1 < k22; ++p) {
      const size_t g = (size_t)col_of<ADJ>(p, m, n) * n;
      for (int pp = p + 1 + t; pp < k22; pp += 32) {
        const size_t a = g + col_of<ADJ>(pp, m, n);
        tr_re[tri_at(p, pp, k22)] = mre[a];
        tr_im[tri_at(p, pp, k22)] = mim[a];
      }
    }
  }
  for (int p = t; p < k22; p += 32) {
    const size_t l = col_of<ADJ>(p, m, n);
    dg_re[p] = mre[l * n + l];
    dg_im[p] = mim[l * n + l];
  }
  const T smin = sminv[b];
  const T smin2 = mul(smin, smin);
  const int nq = (k22 + 31) / 32;
  bool pert = false;
  for (int u = 0; u < m; ++u) {
    const int i = ADJ ? u : m - 1 - u;
    const size_t ri = (size_t)i * n;
    __syncwarp();  // every read of the last row's arrays is done
    for (int k = t; k < m; k += 32) {  // i < m: the diagonal too
      row_re[k] = mre[ri + k];
      row_im[k] = mim[ri + k];
    }
    __syncwarp();
    // the row's masked product over the rows solved before it, a term at
    // a time (sr = sum re*re, si = im*im, tr = re*im, ti = im*re), four
    // of the thread's positions at once
    const int k0 = ADJ ? 0 : i + 1;
    const int k1 = ADJ ? i : m;
    for (int q0 = 0; q0 < nq; q0 += 4) {
      T sr[4], si[4], tr[4], ti[4];
      if (xs_on)
        row_product<T, ADJ, true>(sr, si, tr, ti, row_re, row_im, xs_re,
                                  xs_im, k22, q0, t, k0, k1, m, n);
      else
        row_product<T, ADJ, false>(sr, si, tr, ti, row_re, row_im, xre, xim,
                                   k22, q0, t, k0, k1, m, n);
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int p = 32 * (q0 + v) + t;
        if (p < k22) {
          const size_t a = ri + col_of<ADJ>(p, m, n);
          rs_re[p] = sub(cre[a], sub(sr[v], si[v]));
          rs_im[p] = sub(cim[a], add(tr[v], ti[v]));
          ac_re[p] = T(0);
          ac_im[p] = T(0);
        }
      }
    }
    const T dir = row_re[i], dii = row_im[i];
    for (int q = 0; q < nq; ++q) {
      const int p0 = 32 * q, nb = min(32, k22 - p0), p = p0 + t;
      const bool mine = t < nb;
      // a thread past the block forms 1 / 1, never used (a zero dividend
      // may take the quotient's slow path for the whole warp)
      T cur_r = T(0), cur_i = T(0), hr = T(1), hi = T(0);
      T dr = T(1), di = T(0), d2 = T(1);
      if (mine) {
        cur_r = ac_re[p];
        cur_i = ac_im[p];
        hr = rs_re[p];
        hi = rs_im[p];
        dr = sub(dir, dg_re[p]);
        di = sub(dii, dg_im[p]);
        if (add(mul(dr, dr), mul(di, di)) < smin2) {
          dr = dr < T(0) ? -smin : smin;
          di = T(0);
          pert = true;
        }
        d2 = add(mul(dr, dr), mul(di, di));
      }
      // the thread's column of the block's triangle, M[col(p0 + s),
      // col(p)] for s < t, in registers before the chain
      T pr[32], pi[32];
#pragma unroll
      for (int s = 0; s < 32; ++s) {
        pr[s] = pi[s] = T(0);
        if (mine && s < t) {
          if (tri_on) {
            pr[s] = tr_re[tri_at(p0 + s, p, k22)];
            pi[s] = tr_im[tri_at(p0 + s, p, k22)];
          } else {
            const size_t a = (size_t)col_of<ADJ>(p0 + s, m, n) * n +
                             col_of<ADJ>(p, m, n);
            pr[s] = mre[a];
            pi[s] = mim[a];
          }
        }
      }
      // the chain: position p0 + s is solved by thread s, its x shuffled
      // to the warp and added to the block's later positions (a select:
      // no branch splits the warp)
      T myr = T(0), myi = T(0);
#pragma unroll
      for (int s = 0; s < 32; ++s) {
        if (s < nb) {
          const T nr = add(hr, cur_r), ni = add(hi, cur_i);
          T xr = dvd(add(mul(nr, dr), mul(ni, di)), d2);
          T xi = dvd(sub(mul(ni, dr), mul(nr, di)), d2);
          xr = __shfl_sync(FULL, xr, s);
          xi = __shfl_sync(FULL, xi, s);
          myr = t == s ? xr : myr;
          myi = t == s ? xi : myi;
          const T ur = add(cur_r, sub(mul(xr, pr[s]), mul(xi, pi[s])));
          const T ui = add(cur_i, add(mul(xr, pi[s]), mul(xi, pr[s])));
          cur_r = t > s ? ur : cur_r;
          cur_i = t > s ? ui : cur_i;
        }
      }
      if (mine) {
        const size_t a = ri + col_of<ADJ>(p, m, n);
        xre[a] = myr;
        xim[a] = myi;
        if (xs_on) {
          xs_re[(size_t)i * k22 + p] = myr;
          xs_im[(size_t)i * k22 + p] = myi;
        }
        xb_re[t] = myr;
        xb_im[t] = myi;
      }
      __syncwarp();
      // the block's x applied to the later positions' sums, in the order
      // they were solved
      for (int pp = p0 + 32 + t; pp < k22; pp += 32) {
        T ar = ac_re[pp], ai = ac_im[pp];
        const size_t g = (size_t)col_of<ADJ>(pp, m, n);
#pragma unroll 8
        for (int s = 0; s < nb; ++s) {
          const T xr = xb_re[s], xi = xb_im[s];
          T mr, mi;
          if (tri_on) {
            mr = tr_re[tri_at(p0 + s, pp, k22)];
            mi = tr_im[tri_at(p0 + s, pp, k22)];
          } else {
            const size_t a = (size_t)col_of<ADJ>(p0 + s, m, n) * n + g;
            mr = mre[a];
            mi = mim[a];
          }
          ar = add(ar, sub(mul(xr, mr), mul(xi, mi)));
          ai = add(ai, add(mul(xr, mi), mul(xi, mr)));
        }
        ac_re[pp] = ar;
        ac_im[pp] = ai;
      }
      __syncwarp();  // the block's x are read before the next block writes
    }
  }
  pert = __any_sync(FULL, pert);
  if (t == 0) pert_out[b] = pert ? 1 : 0;
}

template <typename T, int ADJ>
int launch_dir(const void* mre, const void* mim, const void* m,
               const void* cre, const void* cim, const void* smin, void* xre,
               void* xim, void* pert, int batch, int n, cudaStream_t s) {
  const size_t smem = smem_bytes<T>(n);
  const cudaError_t err = cudaFuncSetAttribute(
      trsyl_kernel<T, ADJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  trsyl_kernel<T, ADJ><<<batch, 32, smem, s>>>(
      (const T*)mre, (const T*)mim, (const int32_t*)m, (const T*)cre,
      (const T*)cim, (const T*)smin, (T*)xre, (T*)xim, (uint8_t*)pert, n,
      (int)smem);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* mre, const void* mim, const void* m, const void* cre,
           const void* cim, const void* smin, void* xre, void* xim,
           void* pert, int batch, int n, int adjoint, cudaStream_t s) {
  if (adjoint)
    return launch_dir<T, 1>(mre, mim, m, cre, cim, smin, xre, xim, pert,
                            batch, n, s);
  return launch_dir<T, 0>(mre, mim, m, cre, cim, smin, xre, xim, pert, batch,
                          n, s);
}

}  // namespace

extern "C" {

// Registers a thread, local (spill) bytes a thread and the dynamic shared
// memory of the kernel that takes n (f32 when f64 is 0) in the direction
// `adjoint`, into out[0..2]; returns the cudaError_t.
int trsyl_attributes(int n, int f64, int adjoint, int* out) {
  const void* fn =
      f64 ? (adjoint ? (const void*)trsyl_kernel<double, 1>
                     : (const void*)trsyl_kernel<double, 0>)
          : (adjoint ? (const void*)trsyl_kernel<float, 1>
                     : (const void*)trsyl_kernel<float, 0>);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)(f64 ? smem_bytes<double>(n) : smem_bytes<float>(n));
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
