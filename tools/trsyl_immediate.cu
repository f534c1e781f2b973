// A form of the trsyl kernel (linalg_solver_tpu_torch/csrc/trsyl.cu) that
// lost, kept so that its times can be measured again:
//
//   python3 tools/time_pivoted.py --big --trsyl-form tools/trsyl_immediate.cu
//
// builds it beside the package's kernel and times both in turns on the
// same operands, after checking that the two agree to the bit.  The math
// and the arithmetic are the package kernel's (see there).
//
// Mapping: one warp a lane (a block of 32 threads), thread t owning
// columns t + 32 q (q < NC), with their running sums acc in registers.
// The row's masked product runs first, each thread summing its own
// columns of X a term at a time, M's row read as a broadcast; each
// column's rhs and floored denominator go to shared memory.  Then the
// n - m column steps: every thread forms x_jj from its own copy of column
// jj's sums, two shuffles (re, im) give the owner's to the warp, and every
// thread adds x_jj M[jj, l] to all its later columns l at once, before
// the next step: the update of every later column stands between two
// steps of the chain.  Row i of M, X's block and T22's triangle are kept
// in shared memory where they fit; the lanes' masks are selects.

#include <cuda_runtime.h>
#include <stdint.h>

#include "schur_rn.cuh"

namespace {

using namespace schur_rn;

constexpr int MAX_N = 1024;
constexpr size_t SMEM_MAX = 232448;
constexpr unsigned FULL = 0xffffffffu;

// a[k] for a warp-uniform k < NC
template <typename T, int NC>
__device__ __forceinline__ T pick(const T (&a)[NC], int k) {
  T v = a[0];
#pragma unroll
  for (int q = 1; q < NC; ++q) v = q == k ? a[q] : v;
  return v;
}

// Dynamic shared memory of a lane at n: nine arrays [n] (rhs re, im;
// denominator re, im, |.|^2; the diagonal's re, im; row i of M, re, im),
// then X's block and T22's triangle (re, im; at most n^2 / 2 entries
// together) up to the block's limit.
template <typename T>
size_t smem_bytes(int n) {
  const size_t cols = 9 * (size_t)n * sizeof(T);
  const size_t st = 2 * ((size_t)n * n / 2) * sizeof(T);
  return cols + st < SMEM_MAX ? cols + st : SMEM_MAX;
}

// Offset of row r (0-based within T22) of T22's triangle, packed: the
// columns after the row's own (ADJ = 0: r + 1 ... k22 - 1) or before it
// (ADJ = 1: 0 ... r - 1).
template <int ADJ>
__device__ __forceinline__ int tri_row(int r, int k22) {
  return ADJ ? r * (r - 1) / 2 : r * (2 * k22 - r - 1) / 2;
}

// A lane's column steps run in the direction ADJ (0: columns ascending,
// later columns above; 1: descending, later columns below).  Every block
// of the thread's columns is worked on at every step, its lanes masked by
// selects: no branch splits the step, so the blocks' loads and
// multiply-adds overlap one another and the chain.
template <typename T, int NC, int ADJ>
__global__ void __launch_bounds__(32, 1)
trsyl_kernel(const T* __restrict__ mre, const T* __restrict__ mim,
             const int32_t* __restrict__ mvec, const T* __restrict__ cre,
             const T* __restrict__ cim, const T* __restrict__ sminv, T* xre,
             T* xim, uint8_t* __restrict__ pert_out, int n, int smem) {
  extern __shared__ unsigned char smem_raw[];
  T* rs_re = reinterpret_cast<T*>(smem_raw);
  T* rs_im = rs_re + n;
  T* dn_re = rs_im + n;
  T* dn_im = dn_re + n;
  T* dn_2 = dn_im + n;
  T* dg_re = dn_2 + n;   // M's diagonal
  T* dg_im = dg_re + n;
  T* row_re = dg_im + n;  // row i of M, for the row product
  T* row_im = row_re + n;
  T* st = row_im + n;  // X's block [m][n - m], then T22's triangle
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
  // X's block first (the row products read the thread's own earlier
  // entries there and not from L2), then T22's triangle (what the column
  // steps read), each where it fits
  const size_t cap = (smem / sizeof(T) - 9 * (size_t)n) / 2;
  const size_t xsz = (size_t)m * k22, tsz = (size_t)k22 * (k22 - 1) / 2;
  const bool xs_on = xsz <= cap;
  const bool staged = tsz > 0 && (xs_on ? xsz : 0) + tsz <= cap;
  T* xs_re = st;
  T* xs_im = xs_re + (xs_on ? xsz : 0);
  T* st_re = xs_im + (xs_on ? xsz : 0);
  T* st_im = st_re + (staged ? tsz : 0);
  if (staged) {
    for (int r = 0; r < k22; ++r) {
      const int c0 = ADJ ? 0 : r + 1, c1 = ADJ ? r : k22;
      const size_t g = (size_t)(m + r) * n + m;
      T* dre = st_re + tri_row<ADJ>(r, k22) - c0;
      T* dim = st_im + tri_row<ADJ>(r, k22) - c0;
      for (int c = c0 + t; c < c1; c += 32) {
        dre[c] = mre[g + c];
        dim[c] = mim[g + c];
      }
    }
  }
  const T smin = sminv[b];
  const T smin2 = mul(smin, smin);
  for (int l = m + t; l < n; l += 32) {
    dg_re[l] = mre[(size_t)l * n + l];
    dg_im[l] = mim[(size_t)l * n + l];
  }
  bool pert = false;
  for (int u = 0; u < m; ++u) {
    const int i = ADJ ? u : m - 1 - u;
    const size_t ri = (size_t)i * n;
    __syncwarp();  // every read of the last row's arrays is done
    for (int k = t; k < n; k += 32) {
      row_re[k] = mre[ri + k];
      row_im[k] = mim[ri + k];
    }
    __syncwarp();
    // the row's masked product over the rows solved before it, a term at a
    // time: sr = sum re*re, si = im*im, tr = re*im, ti = im*re
    T sr[NC], si[NC], tr[NC], ti[NC];
#pragma unroll
    for (int q = 0; q < NC; ++q) sr[q] = si[q] = tr[q] = ti[q] = T(0);
    const int k0 = ADJ ? 0 : i + 1;
    const int k1 = ADJ ? i : m;
    for (int k = k0; k < k1; ++k) {
      const T wr = row_re[k], wi = row_im[k];
#pragma unroll
      for (int q = 0; q < NC; ++q) {
        const int l = t + 32 * q;
        const int lc = min(max(l, m), n - 1);
        T xr, xi;
        if (xs_on) {  // the thread's own entries of X
          xr = xs_re[(size_t)k * k22 + lc - m];
          xi = xs_im[(size_t)k * k22 + lc - m];
        } else {
          xr = xre[(size_t)k * n + lc];
          xi = xim[(size_t)k * n + lc];
        }
        const bool use = l >= m && l < n;
        const T a = add(sr[q], mul(wr, xr)), c = add(si[q], mul(wi, xi));
        const T d = add(tr[q], mul(wr, xi)), e = add(ti[q], mul(wi, xr));
        sr[q] = use ? a : sr[q];
        si[q] = use ? c : si[q];
        tr[q] = use ? d : tr[q];
        ti[q] = use ? e : ti[q];
      }
    }
    const T dir = row_re[i], dii = row_im[i];
    T accr[NC], acci[NC];
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      accr[q] = acci[q] = T(0);
      const int l = t + 32 * q;
      if (l >= m && l < n) {
        rs_re[l] = sub(cre[ri + l], sub(sr[q], si[q]));
        rs_im[l] = sub(cim[ri + l], add(tr[q], ti[q]));
        T dr = sub(dir, dg_re[l]), di = sub(dii, dg_im[l]);
        if (add(mul(dr, dr), mul(di, di)) < smin2) {
          dr = dr < T(0) ? -smin : smin;
          di = T(0);
          pert = true;
        }
        dn_re[l] = dr;
        dn_im[l] = di;
        dn_2[l] = add(mul(dr, dr), mul(di, di));
      }
    }
    __syncwarp();  // the row's column arrays are in place
    for (int s = 0; s < k22; ++s) {
      const int jj = ADJ ? n - 1 - s : m + s;
      const int kq = jj >> 5, rj = jj - m;
      // row jj of M in the thread's columns, loaded before the chain (the
      // address clamped into the row: a column not after jj is masked)
      T mr[NC], mi[NC];
#pragma unroll
      for (int q = 0; q < NC; ++q) {
        const int l = t + 32 * q;
        if (staged) {
          const int at = tri_row<ADJ>(rj, k22) + l - m - (ADJ ? 0 : rj + 1);
          const int a = min(max(at, 0), (int)tsz - 1);
          mr[q] = st_re[a];
          mi[q] = st_im[a];
        } else {
          const size_t g = (size_t)jj * n + min(max(l, m), n - 1);
          mr[q] = mre[g];
          mi[q] = mim[g];
        }
      }
      // column jj's sums are complete in the thread that owns it; every
      // thread forms the quotient from its own copy, the owner's is kept
      const T nr = add(rs_re[jj], pick(accr, kq));
      const T ni = add(rs_im[jj], pick(acci, kq));
      const T dr = dn_re[jj], di = dn_im[jj], d2 = dn_2[jj];
      T xr = dvd(add(mul(nr, dr), mul(ni, di)), d2);
      T xi = dvd(sub(mul(ni, dr), mul(nr, di)), d2);
      xr = __shfl_sync(FULL, xr, jj & 31);
      xi = __shfl_sync(FULL, xi, jj & 31);
      if (t == (jj & 31)) {
        xre[ri + jj] = xr;
        xim[ri + jj] = xi;
        if (xs_on) {
          xs_re[(size_t)i * k22 + rj] = xr;
          xs_im[(size_t)i * k22 + rj] = xi;
        }
      }
#pragma unroll
      for (int q = 0; q < NC; ++q) {
        const int l = t + 32 * q;
        const bool use = l >= m && l < n && (ADJ ? l < jj : l > jj);
        const T ar = add(accr[q], sub(mul(xr, mr[q]), mul(xi, mi[q])));
        const T ai = add(acci[q], add(mul(xr, mi[q]), mul(xi, mr[q])));
        accr[q] = use ? ar : accr[q];
        acci[q] = use ? ai : acci[q];
      }
    }
  }
  pert = __any_sync(FULL, pert);
  if (t == 0) pert_out[b] = pert ? 1 : 0;
}

template <typename T, int NC, int ADJ>
int launch_nc(const void* mre, const void* mim, const void* m,
              const void* cre, const void* cim, const void* smin, void* xre,
              void* xim, void* pert, int batch, int n, cudaStream_t s) {
  const size_t smem = smem_bytes<T>(n);
  const cudaError_t err = cudaFuncSetAttribute(
      trsyl_kernel<T, NC, ADJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  trsyl_kernel<T, NC, ADJ><<<batch, 32, smem, s>>>(
      (const T*)mre, (const T*)mim, (const int32_t*)m, (const T*)cre,
      (const T*)cim, (const T*)smin, (T*)xre, (T*)xim, (uint8_t*)pert, n,
      (int)smem);
  return (int)cudaGetLastError();
}

template <typename T, int NC>
int launch_dir(const void* mre, const void* mim, const void* m,
               const void* cre, const void* cim, const void* smin, void* xre,
               void* xim, void* pert, int batch, int n, int adjoint,
               cudaStream_t s) {
  if (adjoint)
    return launch_nc<T, NC, 1>(mre, mim, m, cre, cim, smin, xre, xim, pert,
                               batch, n, s);
  return launch_nc<T, NC, 0>(mre, mim, m, cre, cim, smin, xre, xim, pert,
                             batch, n, s);
}

template <typename T, int NC>
const void* kernel_of(int adjoint) {
  return adjoint ? (const void*)trsyl_kernel<T, NC, 1>
                 : (const void*)trsyl_kernel<T, NC, 0>;
}

// columns a thread: 2 to n = 64, 8 to 256, 32 to 1024
template <typename T>
int launch(const void* mre, const void* mim, const void* m, const void* cre,
           const void* cim, const void* smin, void* xre, void* xim,
           void* pert, int batch, int n, int adjoint, cudaStream_t s) {
  if (n <= 64)
    return launch_dir<T, 2>(mre, mim, m, cre, cim, smin, xre, xim, pert,
                            batch, n, adjoint, s);
  if (n <= 256)
    return launch_dir<T, 8>(mre, mim, m, cre, cim, smin, xre, xim, pert,
                            batch, n, adjoint, s);
  return launch_dir<T, 32>(mre, mim, m, cre, cim, smin, xre, xim, pert,
                           batch, n, adjoint, s);
}

template <typename T>
const void* kernel_for(int n, int adjoint) {
  return n <= 64    ? kernel_of<T, 2>(adjoint)
         : n <= 256 ? kernel_of<T, 8>(adjoint)
                    : kernel_of<T, 32>(adjoint);
}

}  // namespace

extern "C" {

// Launches the masked Sylvester solve on `stream`: M (re, im) [batch, n, n]
// (T forward, T^H when adjoint is 1), m [batch] int32, C (re, im)
// [batch, n, n], smin [batch], all contiguous, f32 when f64 is 0, else f64;
// X (re, im) [batch, n, n] zero on entry, the solution on exit; pert
// [batch] bool.  Returns the cudaError_t of the launch (0 on success), or
// cudaErrorInvalidValue past the kernel's reach (n > 1024).
// Registers a thread, local (spill) bytes a thread and the dynamic shared
// memory of the kernel that takes n (f32 when f64 is 0) in the direction
// `adjoint`, into out[0..2]; returns the cudaError_t.
int trsyl_attributes(int n, int f64, int adjoint, int* out) {
  const void* fn =
      f64 ? kernel_for<double>(n, adjoint) : kernel_for<float>(n, adjoint);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)(f64 ? smem_bytes<double>(n) : smem_bytes<float>(n));
  return (int)err;
}

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
