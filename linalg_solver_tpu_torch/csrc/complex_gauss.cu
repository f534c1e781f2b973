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
// Only rows > k and columns > k are read again, so only they are updated.
//
// Mapping on the H100 (variant 2, `cg_regs_kernel`, f32 to n = 192, f64
// to n = 128): one block of 16 warps a lane; warp w owns the columns
// w + 16 s, lane l the rows l + 32 i.  Rows never move: each row keeps its
// position (pos, in registers, the same in every warp), initially its
// index; at step k the candidates are the rows with pos >= k, ordered as
// torch.argmax orders positions (NaN largest, then the larger |.|^2, then
// the smaller position), and an exchange gives the winner position k and
// the row that held position k the winner's old position.  Every entry
// sees the same operations on the same operands as in the plain version,
// which exchanges by gathers, so the two agree to the bit.  A warp's first
// CR column slots live in registers, the other CS in shared memory
// (column-major, a lane a row: no bank conflicts), so that the planes fit
// at n = 192 in f32 (73,728 words against the SM's 65,536 registers).
// A step: the owner of column k + 1 updates that column first, searches
// its pivot (lane keys, then three warp reductions), writes the pivot and
// the factors of step k + 1 into the second of two shared buffers, then
// updates its other columns; every other warp updates its live columns,
// the pivot row reaching each register column by one shuffle from the
// lane that holds it; one __syncthreads a step.  Bound: n dependent steps
// (search, two divisions, a barrier) and the update's 8 rounded
// operations an entry issued by 16 warps; not bytes.
//
// Variant 1 (`complex_gauss_kernel`, past that reach): the first form's
// block of 512 on a device-memory copy of the planes (the wrapper's
// scratch, [batch, 2, n, ld] with the odd row stride ld = n | 1), four
// barriers a step.  (The first form, with its shared-memory variant 0,
// is tools/complex_gauss_simple.cu.)
//
// Arithmetic: every product, sum, difference and quotient rounded on its
// own in the reference's order (schur_rn.cuh, no fused multiply-adds).

#include <cuda_runtime.h>
#include <stdint.h>

#include "schur_rn.cuh"

namespace {

using namespace schur_rn;

constexpr unsigned FULL = 0xffffffffu;
constexpr int NW = 16;               // warps of the register variant
constexpr int RT = NW * 32;          // its threads
constexpr int THREADS = 512;         // the device-memory variant's block
constexpr size_t SMEM_LIMIT = 232448 - 256;

__host__ __device__ inline int scratch_ld(int n) { return n | 1; }

// ---------------------------------------------------------------------------
// variant 2: the planes in registers and shared memory, rows in place

// The argmax key of |.|^2 >= 0 (or NaN): its bits plus one, NaN the
// largest; 0 for a row that is not a candidate.
__device__ __forceinline__ unsigned long long mag_key(float m) {
  return m != m ? 0xffffffffull : (unsigned long long)__float_as_uint(m) + 1;
}
__device__ __forceinline__ unsigned long long mag_key(double m) {
  return m != m ? ~0ull : (unsigned long long)__double_as_longlong(m) + 1;
}
__device__ __forceinline__ unsigned long long nan_key(float) {
  return 0xffffffffull;
}
__device__ __forceinline__ unsigned long long nan_key(double) { return ~0ull; }

// the warp's largest key (64 bits from two 32-bit reductions)
__device__ __forceinline__ unsigned long long warp_max_key(
    unsigned long long k) {
  const unsigned hi = __reduce_max_sync(FULL, (unsigned)(k >> 32));
  const unsigned lo = __reduce_max_sync(
      FULL, (unsigned)(k >> 32) == hi ? (unsigned)k : 0u);
  return ((unsigned long long)hi << 32) | lo;
}

// Layout of the dynamic shared memory of one block, in elements of T:
// the CS shared column slots of every warp [NW][CS][2][32 R], the
// factors [2][2][32 R] of steps k and k + 1, the staging rows [32][n + 1]
// of the load; then the step slots as ints.
template <typename T, int R, int CS>
__host__ __device__ inline size_t regs_smem_bytes(int n) {
  return ((size_t)NW * CS * 2 * 32 * R + 4 * 32 * R + 32 * (size_t)(n + 1))
             * sizeof(T)
         + 2 * 8 * sizeof(int);
}

template <typename T, int R, int CR, int CS>
__global__ void __launch_bounds__(RT, 1)
    cg_regs_kernel(const T* __restrict__ are, const T* __restrict__ aim,
                   T* __restrict__ piv_re, T* __restrict__ piv_im,
                   T* __restrict__ sign_out, uint8_t* __restrict__ ok_out,
                   int n) {
  constexpr int C = CR + CS, LR = 32 * R;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* cs = reinterpret_cast<T*>(smem_raw);           // [NW][CS][2][LR]
  T* fb = cs + (size_t)NW * CS * 2 * LR;            // [2][2][LR]
  T* stage = fb + 4 * LR;                           // [32][n + 1]
  int* slots = reinterpret_cast<int*>(stage + 32 * (n + 1));  // [2][8]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t b = blockIdx.x, nn = (size_t)n * n;
  T* mycs = cs + (size_t)warp * CS * 2 * LR;
  auto cslot = [&](int s, int plane) -> T* {
    return mycs + ((size_t)(s - CR) * 2 + plane) * LR;
  };

  T xr[R][CR], xi[R][CR];
  int pos[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    pos[i] = lane + 32 * i < n ? lane + 32 * i : -1;
#pragma unroll
    for (int s = 0; s < CR; ++s) xr[i][s] = xi[i][s] = T(0);
  }
  // the load: 32 rows of one plane at a time through the staging rows
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int plane = 0; plane < 2; ++plane) {
      const T* src = (plane ? aim : are) + b * nn + (size_t)32 * i * n;
      const int rows = min(32, n - 32 * i);
      if (rows > 0) {
        for (int e = tid; e < rows * n; e += RT)
          stage[(e / n) * (n + 1) + e % n] = src[e];
      }
      __syncthreads();
#pragma unroll
      for (int s = 0; s < C; ++s) {
        const int j = warp + NW * s;
        const T v = lane < rows && j < n ? stage[lane * (n + 1) + j] : T(0);
        if (s < CR) {
          if (plane) xi[i][s < CR ? s : 0] = v;
          else xr[i][s < CR ? s : 0] = v;
        } else {
          cslot(s, plane)[lane + 32 * i] = v;
        }
      }
      __syncthreads();
    }
  }

  // The pivot search of step kk on column slot s (its owner warp, the
  // column already updated): the winner, its position, the row at
  // position kk, has; the pivot and the factors of the rows with
  // pos >= kk other than the pivot row, into buffer nb.
  auto search = [&](int kk, int s, int nb) {
    T cr[R], ci[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      cr[i] = ci[i] = T(0);
      if (s >= CR) {
        cr[i] = cslot(s, 0)[lane + 32 * i];
        ci[i] = cslot(s, 1)[lane + 32 * i];
      }
#pragma unroll
      for (int q = 0; q < CR; ++q) {
        if (q == s) {
          cr[i] = xr[i][q];
          ci[i] = xi[i][q];
        }
      }
    }
    unsigned long long best = 0;
    unsigned enc = 0xffffffffu, atk = 0xffffffffu;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const bool cand = pos[i] >= kk;
      const T mag = add(mul(cr[i], cr[i]), mul(ci[i], ci[i]));
      const unsigned long long key = cand ? mag_key(mag) : 0ull;
      const unsigned e = ((unsigned)pos[i] << 8) | (unsigned)(lane + 32 * i);
      if (key > best || (key == best && cand && e < enc)) {
        best = key;
        enc = e;
      }
      if (pos[i] == kk) atk = lane + 32 * i;
    }
    const unsigned long long top = warp_max_key(best);
    const unsigned win =
        __reduce_min_sync(FULL, best == top && top != 0 ? enc : 0xffffffffu);
    const int rowk = (int)__reduce_min_sync(FULL, atk);
    const int w = win & 0xff, pw = (int)(win >> 8);
    const bool has = top > 1 && top != nan_key(T(0));
    const int prow = has ? w : rowk;
    const bool swap = has && pw != kk;
    // the pivot: column kk at row prow
    T pr = cr[0], pi = ci[0];
#pragma unroll
    for (int i = 1; i < R; ++i) {
      if (i == (prow >> 5)) {
        pr = cr[i];
        pi = ci[i];
      }
    }
    pr = __shfl_sync(FULL, pr, prow & 31);
    pi = __shfl_sync(FULL, pi, prow & 31);
    const T den = has ? add(mul(pr, pr), mul(pi, pi)) : T(1);
    T* fr = fb + (size_t)nb * 2 * LR;
    T* fi = fr + LR;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = lane + 32 * i;
      if (pos[i] >= kk && r != prow) {
        const T xr_ = cr[i], xi_ = ci[i];
        const T f0 = dvd(add(mul(xr_, pr), mul(xi_, pi)), den);
        const T f1 = dvd(sub(mul(xi_, pr), mul(xr_, pi)), den);
        fr[r] = has ? f0 : T(0);
        fi[r] = has ? f1 : T(0);
      }
    }
    if (lane == 0) {
      int* sl = slots + 8 * nb;
      sl[0] = prow;
      sl[1] = has;
      sl[2] = swap;
      sl[3] = rowk;
      sl[4] = pw;
      piv_re[b * n + kk] = pr;
      piv_im[b * n + kk] = pi;
    }
  };

  if (warp == 0) search(0, 0, 0);
  __syncthreads();

  T sg = T(1);
  bool ok = true;
#pragma unroll 1
  for (int k = 0; k < n; ++k) {
    const int buf = k & 1;
    const int* sl = slots + 8 * buf;
    const int prow = sl[0], swap = sl[2], rowk = sl[3], pw = sl[4];
    const bool has = sl[1] != 0;
    ok = ok && has;
    if (swap) sg = -sg;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = lane + 32 * i;
      if (swap && r == prow) pos[i] = k;
      else if (swap && r == rowk) pos[i] = pw;
    }
    if (k + 1 == n) break;
    const T* fr = fb + (size_t)buf * 2 * LR;
    const T* fi = fr + LR;
    T f0[R], f1[R];
    bool up[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      up[i] = pos[i] > k;
      f0[i] = up[i] ? fr[lane + 32 * i] : T(0);
      f1[i] = up[i] ? fi[lane + 32 * i] : T(0);
    }
    const int ip = prow >> 5, lp = prow & 31;
    // the update of column slot s (column warp + NW s > k)
    auto update = [&](int s) {
      T pr, pi;
      if (s >= CR) {
        pr = cslot(s, 0)[prow];
        pi = cslot(s, 1)[prow];
        T* cr = cslot(s, 0);
        T* ci = cslot(s, 1);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          if (up[i]) {
            const int r = lane + 32 * i;
            const T a = cr[r], c = ci[r];
            cr[r] = sub(a, sub(mul(f0[i], pr), mul(f1[i], pi)));
            ci[r] = sub(c, add(mul(f0[i], pi), mul(f1[i], pr)));
          }
        }
      } else {
#pragma unroll
        for (int q = 0; q < CR; ++q) {
          if (q == s) {
            T vr = xr[0][q], vi = xi[0][q];
#pragma unroll
            for (int i = 1; i < R; ++i) {
              if (i == ip) {
                vr = xr[i][q];
                vi = xi[i][q];
              }
            }
            pr = __shfl_sync(FULL, vr, lp);
            pi = __shfl_sync(FULL, vi, lp);
#pragma unroll
            for (int i = 0; i < R; ++i) {
              const T a = sub(xr[i][q], sub(mul(f0[i], pr), mul(f1[i], pi)));
              const T c = sub(xi[i][q], add(mul(f0[i], pi), mul(f1[i], pr)));
              xr[i][q] = up[i] ? a : xr[i][q];
              xi[i][q] = up[i] ? c : xi[i][q];
            }
          }
        }
      }
    };
    const int owner = (k + 1) % NW, s1 = (k + 1) / NW;
    if (warp == owner) {
      update(s1);
      __syncwarp();
      search(k + 1, s1, buf ^ 1);
    }
#pragma unroll
    for (int s = 0; s < C; ++s) {
      const int j = warp + NW * s;
      if (j > k && j < n && !(warp == owner && s == s1)) update(s);
    }
    __syncthreads();
  }
  if (tid == 0) {
    sign_out[b] = sg;
    ok_out[b] = ok ? 1 : 0;
  }
}

// (T, R, CR, CS) of the register variant by rows: f32 to n = 192, f64 to
// n = 128 (R = ceil(n / 32), 2R column slots a warp)
#define CG_REGS_F32(X) \
  X(float, 1, 2, 0)    \
  X(float, 2, 4, 0)    \
  X(float, 3, 6, 0)    \
  X(float, 4, 6, 2)    \
  X(float, 5, 5, 5)    \
  X(float, 6, 4, 8)
#define CG_REGS_F64(X) \
  X(double, 1, 2, 0)   \
  X(double, 2, 4, 0)   \
  X(double, 3, 3, 3)   \
  X(double, 4, 3, 5)

template <typename T>
int regs_reach() {
  return sizeof(T) == 4 ? 192 : 128;
}

template <typename T>
const void* regs_fn(int n) {
  const int R = (n + 31) / 32;
#define CG_FN(TT, RR, CRR, CSS)                                   \
  if (sizeof(T) == sizeof(TT) && R == RR)                         \
    return (const void*)cg_regs_kernel<TT, RR, CRR, CSS>;
  CG_REGS_F32(CG_FN)
  CG_REGS_F64(CG_FN)
#undef CG_FN
  return nullptr;
}

template <typename T>
size_t regs_bytes(int n) {
  const int R = (n + 31) / 32;
#define CG_BYTES(TT, RR, CRR, CSS)                \
  if (sizeof(T) == sizeof(TT) && R == RR)         \
    return regs_smem_bytes<TT, RR, CSS>(n);
  CG_REGS_F32(CG_BYTES)
  CG_REGS_F64(CG_BYTES)
#undef CG_BYTES
  return 0;
}

// ---------------------------------------------------------------------------
// variant 1: the first form's kernel on a device-memory copy (stride ld)

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
  __shared__ int s_p;
  __shared__ int s_has;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int ld = scratch_ld(n);
  const size_t nn = (size_t)n * n, pl = (size_t)n * ld;
  T* re = work + 2 * pl * b;
  T* im = re + pl;
  are += nn * b;
  aim += nn * b;
  for (size_t e = tid; e < nn; e += THREADS) {
    const size_t r = e / n, c = e % n;
    re[r * ld + c] = are[e];
    im[r * ld + c] = aim[e];
  }
  T sg = T(1);
  bool ok = true;
  __syncthreads();
  for (int k = 0; k < n; ++k) {
    if (warp == 0) {
      T best = T(-1);
      int bi = n;
      for (int i = k + lane; i < n; i += 32) {
        const T r = re[(size_t)i * ld + k], m = im[(size_t)i * ld + k];
        const T mag = add(mul(r, r), mul(m, m));
        if (beats(mag, i, best, bi)) {
          best = mag;
          bi = i;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const T ov = __shfl_down_sync(FULL, best, off);
        const int oi = __shfl_down_sync(FULL, bi, off);
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
      for (int j = k + tid; j < n; j += THREADS) {
        const size_t ek = (size_t)k * ld + j, ep = (size_t)p * ld + j;
        const T r = re[ek], m = im[ek];
        re[ek] = re[ep];
        im[ek] = im[ep];
        re[ep] = r;
        im[ep] = m;
      }
      sg = -sg;
      __syncthreads();
    }
    const T pre = re[(size_t)k * ld + k], pim = im[(size_t)k * ld + k];
    if (tid == 0) {
      piv_re[(size_t)b * n + k] = pre;
      piv_im[(size_t)b * n + k] = pim;
    }
    if (k + 1 == n) break;
    const T den = has ? add(mul(pre, pre), mul(pim, pim)) : T(1);
    for (int i = k + 1 + tid; i < n; i += THREADS) {
      const size_t e = (size_t)i * ld + k;
      const T xr = re[e], xi = im[e];
      T fr = dvd(add(mul(xr, pre), mul(xi, pim)), den);
      T fi = dvd(sub(mul(xi, pre), mul(xr, pim)), den);
      re[e] = has ? fr : T(0);
      im[e] = has ? fi : T(0);
    }
    __syncthreads();
    const T* prow_re = re + (size_t)k * ld;
    const T* prow_im = im + (size_t)k * ld;
    for (int i = k + 1 + warp; i < n; i += THREADS / 32) {
      T* rrow = re + (size_t)i * ld;
      T* irow = im + (size_t)i * ld;
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
  return n <= regs_reach<T>() && regs_bytes<T>(n) <= SMEM_LIMIT ? 2 : 1;
}

template <typename T>
int launch(const void* are, const void* aim, void* work, void* pre,
           void* pim, void* sign, void* ok, int batch, int n,
           cudaStream_t s) {
  const bool regs = variant_of<T>(n) == 2;
  if (regs != (work == nullptr)) return (int)cudaErrorInvalidValue;
  if (!regs) {
    complex_gauss_kernel<T><<<batch, THREADS, 0, s>>>(
        (const T*)are, (const T*)aim, (T*)work, (T*)pre, (T*)pim, (T*)sign,
        (uint8_t*)ok, n);
    return (int)cudaGetLastError();
  }
  const void* fn = regs_fn<T>(n);
  const size_t smem = regs_bytes<T>(n);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const T* a = (const T*)are;
  const T* c = (const T*)aim;
  T* pr = (T*)pre;
  T* pi = (T*)pim;
  T* sg = (T*)sign;
  uint8_t* okp = (uint8_t*)ok;
  void* args[] = {(void*)&a, (void*)&c, (void*)&pr, (void*)&pi,
                  (void*)&sg, (void*)&okp, (void*)&n};
  err = cudaLaunchKernel(fn, dim3(batch), dim3(RT), args, smem, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The variant that takes n (f32 when f64 is 0): 2, the planes in
// registers and shared memory (n <= 192 in f32, 128 in f64); 1, in a
// device-memory scratch of [batch, 2, n, n | 1].
int complex_gauss_variant(int n, int f64) {
  return f64 ? variant_of<double>(n) : variant_of<float>(n);
}

// Dynamic shared memory of variant 2 at n, in bytes (0 for variant 1).
size_t complex_gauss_smem_bytes(int n, int f64) {
  if (complex_gauss_variant(n, f64) != 2) return 0;
  return f64 ? regs_bytes<double>(n) : regs_bytes<float>(n);
}

// Registers a thread, local (spill) bytes a thread, the dynamic shared
// memory and the resident blocks an SM of the kernel that takes n, into
// out[0..3].  Returns the cudaError_t.
int complex_gauss_attributes(int n, int f64, int* out) {
  const bool regs = complex_gauss_variant(n, f64) == 2;
  const void* fn =
      regs ? (f64 ? regs_fn<double>(n) : regs_fn<float>(n))
           : (f64 ? (const void*)complex_gauss_kernel<double>
                  : (const void*)complex_gauss_kernel<float>);
  const size_t smem = complex_gauss_smem_bytes(n, f64);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  if (regs) {
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)smem;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[3], fn, regs ? RT : THREADS, smem);
}

// Launches the elimination on `stream`: A (re, im) [batch, n, n] contiguous,
// left as it was; work null for variant 2, else a [batch, 2, n, n | 1]
// scratch of the same type; outputs pivots (re, im) [batch, n], sign
// [batch] (the type of A) and ok [batch] bool.  f32 when f64 is 0, else
// f64.  Returns the cudaError_t of the launch (0 on success),
// cudaErrorInvalidValue when work does not match the variant.
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
