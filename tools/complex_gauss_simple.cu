// The first form of the complex elimination kernel: one block of 512 a
// lane, the planes row-major in shared memory (variant 0, to n = 170 in
// f32, 120 in f64) or in a [batch, 2, n, n] device-memory scratch
// (variant 1), four barriers a step.  Kept as the earlier form of
// linalg_solver_tpu_torch/csrc/complex_gauss.cu, with the same C entry
// points, for timing the two in turns:
//
//   python3 tools/time_pivoted.py --complex-gauss-form \
//       tools/complex_gauss_simple.cu
//
// Pivoted complex Gauss elimination on (re, im) planes, one launch a batch
// (ops/complexlin.py's det and slogdet, through
// ops/kernels/complex_gauss.py).
//
// Replaces the reference's `_gauss_pivots_complex` (linalg_solver_tpu/ops/
// complexlin.py:61), which is not a Pallas kernel: the TPU runs it as an XLA
// `lax.fori_loop` of n steps (:132).  Run eagerly in PyTorch a step is
// about 25 small launches, so about 3,200 a call at n = 128, and the call
// is bound by the host.
//
// Math, a lane (A = re + i im, [n, n]), for k = 0 .. n-1:
//   mag_i = re[i,k]^2 + im[i,k]^2 for rows i >= k
//   p     = the first row of largest mag (NaN counts as largest, as
//           torch.argmax); has = mag_p > 0; ok &= has
//   rows k and p exchanged where has and p != k; sign = -sign there
//   pivot_k = A[k, k]
//   den   = |pivot_k|^2 (1 where not has)
//   f_i   = A[i, k] / pivot_k for rows i > k (0 where not has):
//           fre = (xr pre + xi pim) / den, fim = (xi pre - xr pim) / den
//   A[i, j] -= f_i A[k, j] for rows i > k, columns j > k:
//           re -= fre pr_j - fim pi_j,  im -= fre pi_j + fim pr_j
// Only rows > k and columns > k are read again, so only they are updated
// (the plain version's outputs are the same either way).
//
// Mapping on the H100: one block of 512 threads a lane.  Variant 0 holds
// the lane's two planes in shared memory, row-major (8 n^2 bytes in f32:
// n <= 170 within the 232,448-byte limit; 16 n^2 in f64: n <= 120);
// variant 1 runs the same code on a device-memory copy of the planes (the
// wrapper's scratch, [batch, 2, n, n]) for larger n.  A step: warp 0
// finds the pivot (a lane a row, then shuffles); the block exchanges the
// rows; a thread a row forms the factors in place of column k (never read
// again); the warps take the trailing rows, the lanes their columns, for
// the rank-1 update; four barriers a step.  Bound: n dependent steps of
// O((n - k)^2) shared-memory work each: at n = 128 the update is ~2/3 n^3
// complex multiply-adds a lane, latency and barrier bound, not bytes.
//
// Arithmetic: every product, sum, difference and quotient rounded on its
// own in the reference's order (schur_rn.cuh, no fused multiply-adds), so
// the kernel agrees with the plain version in ops/kernels/complex_gauss.py
// to the bit, flags included.

#include <cuda_runtime.h>
#include <stdint.h>

#include "schur_rn.cuh"

namespace {

using namespace schur_rn;

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
// the dynamic shared memory variant 0 may take (the static scalars below
// take the rest of a block's 232,448 bytes)
constexpr size_t SMEM_LIMIT = 232448 - 64;

template <typename T>
__host__ __device__ size_t planes_bytes(int n) {
  return 2 * (size_t)n * n * sizeof(T);
}

// (v, i) beats (w, j) in torch.argmax's order: NaN above every number,
// then the larger value, then the first index
template <typename T>
__device__ __forceinline__ bool beats(T v, int i, T w, int j) {
  const bool vn = v != v, wn = w != w;
  if (vn != wn) return vn;
  if (!vn && v != w) return v > w;
  return i < j;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    complex_gauss_kernel(const T* __restrict__ are, const T* __restrict__ aim,
                         T* work, T* __restrict__ piv_re,
                         T* __restrict__ piv_im, T* __restrict__ sign_out,
                         uint8_t* __restrict__ ok_out, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_p;
  __shared__ int s_has;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const size_t nn = (size_t)n * n;
  T* re;
  if (work == nullptr) {
    re = reinterpret_cast<T*>(smem_raw);
  } else {
    re = work + 2 * nn * b;
  }
  T* im = re + nn;
  are += nn * b;
  aim += nn * b;
  for (size_t e = tid; e < nn; e += THREADS) {
    re[e] = are[e];
    im[e] = aim[e];
  }
  T sg = T(1);
  bool ok = true;
  __syncthreads();
  for (int k = 0; k < n; ++k) {
    // the pivot: warp 0, a lane a row, then a shuffle reduction
    if (warp == 0) {
      T best = T(-1);
      int bi = n;
      for (int i = k + lane; i < n; i += 32) {
        const T r = re[(size_t)i * n + k], m = im[(size_t)i * n + k];
        const T mag = add(mul(r, r), mul(m, m));
        if (beats(mag, i, best, bi)) {
          best = mag;
          bi = i;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const T ov = __shfl_down_sync(0xffffffffu, best, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        if (beats(ov, oi, best, bi)) {
          best = ov;
          bi = oi;
        }
      }
      if (lane == 0) {
        s_p = bi;
        s_has = best > T(0) ? 1 : 0;
      }
    }
    __syncthreads();
    const int p = s_p;
    const bool has = s_has != 0;
    ok = ok && has;
    if (has && p != k) {
      // exchange rows k and p over the columns still read (j >= k)
      for (int j = k + tid; j < n; j += THREADS) {
        const size_t ek = (size_t)k * n + j, ep = (size_t)p * n + j;
        const T r = re[ek], m = im[ek];
        re[ek] = re[ep];
        im[ek] = im[ep];
        re[ep] = r;
        im[ep] = m;
      }
      sg = -sg;
      __syncthreads();
    }
    const T pre = re[(size_t)k * n + k], pim = im[(size_t)k * n + k];
    if (tid == 0) {
      piv_re[(size_t)b * n + k] = pre;
      piv_im[(size_t)b * n + k] = pim;
    }
    if (k + 1 == n) break;
    const T den = has ? add(mul(pre, pre), mul(pim, pim)) : T(1);
    // the factors, in place of column k below the pivot
    for (int i = k + 1 + tid; i < n; i += THREADS) {
      const size_t e = (size_t)i * n + k;
      const T xr = re[e], xi = im[e];
      T fr = dvd(add(mul(xr, pre), mul(xi, pim)), den);
      T fi = dvd(sub(mul(xi, pre), mul(xr, pim)), den);
      re[e] = has ? fr : T(0);
      im[e] = has ? fi : T(0);
    }
    __syncthreads();
    // the rank-1 update of the trailing rows and columns
    const T* prow_re = re + (size_t)k * n;
    const T* prow_im = im + (size_t)k * n;
    for (int i = k + 1 + warp; i < n; i += WARPS) {
      T* rrow = re + (size_t)i * n;
      T* irow = im + (size_t)i * n;
      const T fr = rrow[k], fi = irow[k];
      for (int j = k + 1 + lane; j < n; j += 32) {
        const T pr = prow_re[j], pi = prow_im[j];
        rrow[j] = sub(rrow[j], sub(mul(fr, pr), mul(fi, pi)));
        irow[j] = sub(irow[j], add(mul(fr, pi), mul(fi, pr)));
      }
    }
    __syncthreads();
  }
  if (tid == 0) {
    sign_out[b] = sg;
    ok_out[b] = ok ? 1 : 0;
  }
}

template <typename T>
int variant_of(int n) {
  return planes_bytes<T>(n) <= SMEM_LIMIT ? 0 : 1;
}

template <typename T>
int launch(const void* are, const void* aim, void* work, void* pre,
           void* pim, void* sign, void* ok, int batch, int n,
           cudaStream_t s) {
  const bool shared = variant_of<T>(n) == 0;
  if (shared != (work == nullptr)) return (int)cudaErrorInvalidValue;
  const size_t smem = shared ? planes_bytes<T>(n) : 0;
  const cudaError_t err = cudaFuncSetAttribute(
      complex_gauss_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  complex_gauss_kernel<T><<<batch, THREADS, smem, s>>>(
      (const T*)are, (const T*)aim, (T*)work, (T*)pre, (T*)pim, (T*)sign,
      (uint8_t*)ok, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The variant that takes n (f32 when f64 is 0): 0, the planes in shared
// memory; 1, in a device-memory scratch of [batch, 2, n, n].
int complex_gauss_variant(int n, int f64) {
  return f64 ? variant_of<double>(n) : variant_of<float>(n);
}

// Dynamic shared memory of variant 0 at n, in bytes (2 n^2 elements).
size_t complex_gauss_smem_bytes(int n, int f64) {
  return f64 ? planes_bytes<double>(n) : planes_bytes<float>(n);
}

// Registers a thread, local (spill) bytes a thread and the dynamic shared
// memory of the kernel at n, into out[0..2].  Returns the cudaError_t.
int complex_gauss_attributes(int n, int f64, int* out) {
  const void* fn = f64 ? (const void*)complex_gauss_kernel<double>
                       : (const void*)complex_gauss_kernel<float>;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  const bool shared = complex_gauss_variant(n, f64) == 0;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = shared ? (int)complex_gauss_smem_bytes(n, f64) : 0;
  return (int)err;
}

// Launches the elimination on `stream`: A (re, im) [batch, n, n] contiguous,
// left as it was; work null for variant 0, else a [batch, 2, n, n] scratch
// of the same type; outputs pivots (re, im) [batch, n], sign [batch] (the
// type of A) and ok [batch] bool.  f32 when f64 is 0, else f64.  Returns the
// cudaError_t of the launch (0 on success), cudaErrorInvalidValue when work
// does not match the variant.
int complex_gauss(const void* are, const void* aim, void* work, void* pre,
                  void* pim, void* sign, void* ok, int batch, int n, int f64,
                  void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (f64)
    return launch<double>(are, aim, work, pre, pim, sign, ok, batch, n, s);
  return launch<float>(are, aim, work, pre, pim, sign, ok, batch, n, s);
}

}  // extern "C"
