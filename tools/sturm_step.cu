// The Sturm bisection and count kernels as PR 17 wrote them: one launch a
// bisection step, a thread a (lane, index) pair running the whole n-step
// count for every pair, d and e2 in shared memory as two arrays.  Kept as
// the earlier form of linalg_solver_tpu_torch/csrc/sturm.cu, with the same
// C entry points (sturm_bisect takes the package's scratch arguments and
// ignores them), for timing the two in turns:
//
//   python3 tools/time_pivoted.py --sturm-form tools/sturm_step.cu
//
// See csrc/sturm.cu for the math.  Bound: the step's B n^2 (sub, div, sub)
// chains; a thread's count is a dependent chain of n divisions.

#include <cuda_runtime.h>
#include <stdint.h>

#include "schur_rn.cuh"

namespace {

using namespace schur_rn;

constexpr int THREADS = 256;
constexpr int STEPS = 64;

// torch.finfo(dtype).eps * 2 and the tolerance's absolute term
__device__ __forceinline__ float two_eps(float) { return 0x1p-22f; }
__device__ __forceinline__ double two_eps(double) { return 0x1p-51; }
__device__ __forceinline__ float abs_tol(float) { return 1e-30f; }
__device__ __forceinline__ double abs_tol(double) { return 1e-30; }

template <typename T>
__device__ __forceinline__ int count_below(const T* ds, const T* es, T pm,
                                           T x, int n) {
  T q = T(1);
  int c = 0;
  for (int i = 0; i < n; ++i) {
    T qn = sub(sub(ds[i], x), dvd(es[i], q));
    if (mag(qn) < pm) qn = -pm;
    c += qn < T(0);
    q = qn;
  }
  return c;
}

template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ d,
                                      const T* __restrict__ e2, T* ds, T* es,
                                      int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    ds[i] = d[i];
    es[i] = e2[i];
  }
  __syncthreads();
}

// counts at arbitrary query points: x, cnt [batch, g]
template <typename T>
__global__ void count_kernel(const T* __restrict__ d,
                             const T* __restrict__ e2,
                             const T* __restrict__ pivmin,
                             const T* __restrict__ x, int32_t* cnt, int n,
                             int g) {
  extern __shared__ unsigned char smem_raw[];
  T* ds = reinterpret_cast<T*>(smem_raw);
  T* es = ds + n;
  const int lane = blockIdx.y;
  stage(d + (size_t)lane * n, e2 + (size_t)lane * n, ds, es, n);
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < g) {
    const size_t at = (size_t)lane * g + j;
    cnt[at] = count_below(ds, es, pivmin[lane], x[at], n);
  }
}

// one bisection step s on a, b [batch, n]
template <typename T>
__global__ void bisect_kernel(const T* __restrict__ d,
                              const T* __restrict__ e2,
                              const T* __restrict__ pivmin, T* a, T* b,
                              int32_t* live, int n, int s) {
  if (live[s] == 0) return;  // uniform over the grid
  extern __shared__ unsigned char smem_raw[];
  T* ds = reinterpret_cast<T*>(smem_raw);
  T* es = ds + n;
  const int lane = blockIdx.y;
  stage(d + (size_t)lane * n, e2 + (size_t)lane * n, ds, es, n);
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  bool wide = false;
  if (k < n) {
    const size_t at = (size_t)lane * n + k;
    T ak = a[at], bk = b[at];
    const T m = mul(T(0.5), add(ak, bk));
    if (count_below(ds, es, pivmin[lane], m, n) <= k)
      ak = m;
    else
      bk = m;
    a[at] = ak;
    b[at] = bk;
    const T tol = add(mul(two_eps(T(0)), nan_max(mag(ak), mag(bk))),
                      abs_tol(T(0)));
    wide = sub(bk, ak) > tol;
  }
  if (__syncthreads_or(wide) && threadIdx.x == 0) live[s + 1] = 1;
}

template <typename T>
size_t smem_bytes(int n) {
  return 2 * (size_t)n * sizeof(T);
}

template <typename T>
cudaError_t prepare(const void* fn, int n) {
  const size_t smem = smem_bytes<T>(n);
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(fn,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Dynamic shared memory of a launch at n (f32 when f64 is 0).
size_t sturm_smem_bytes(int n, int f64) {
  return f64 ? smem_bytes<double>(n) : smem_bytes<float>(n);
}

// Registers a thread and local (spill) bytes a thread of the bisection
// kernel into out[0..1].  Returns the cudaError_t.
int sturm_attributes(int f64, int* out) {
  const void* fn = f64 ? (const void*)bisect_kernel<double>
                       : (const void*)bisect_kernel<float>;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  return (int)err;
}

// Counts of eigenvalues below x on `stream`: d, e2 [batch, n], pivmin
// [batch], x [batch, g], all contiguous, f32 when f64 is 0, else f64; cnt
// [batch, g] int32.  Returns the cudaError_t of the launch.
int sturm_count(const void* d, const void* e2, const void* pivmin,
                const void* x, void* cnt, int batch, int n, int g, int f64,
                void* stream) {
  if (batch == 0 || g == 0) return 0;
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((g + THREADS - 1) / THREADS, batch);
  cudaError_t err;
  if (f64) {
    err = prepare<double>((const void*)count_kernel<double>, n);
    if (err != cudaSuccess) return (int)err;
    count_kernel<double><<<grid, THREADS, smem_bytes<double>(n), st>>>(
        (const double*)d, (const double*)e2, (const double*)pivmin,
        (const double*)x, (int32_t*)cnt, n, g);
  } else {
    err = prepare<float>((const void*)count_kernel<float>, n);
    if (err != cudaSuccess) return (int)err;
    count_kernel<float><<<grid, THREADS, smem_bytes<float>(n), st>>>(
        (const float*)d, (const float*)e2, (const float*)pivmin,
        (const float*)x, (int32_t*)cnt, n, g);
  }
  return (int)cudaGetLastError();
}

// The bisection's 64 steps on `stream`, one launch each: d, e2 [batch, n],
// pivmin [batch], a, b [batch, n] (the enclosures on entry, the final
// intervals on exit), live [65] int32 zero but live[0] (set where an
// initial interval is wider than its tolerance); the four scratch arrays
// of the package's form are not used.  Returns the cudaError_t of the
// launches.
int sturm_bisect(const void* d, const void* e2, const void* pivmin, void* a,
                 void* b, void* live, void*, void*, void*, void*, int batch,
                 int n, int f64, void* stream) {
  if (batch == 0) return 0;
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((n + THREADS - 1) / THREADS, batch);
  cudaError_t err;
  if (f64)
    err = prepare<double>((const void*)bisect_kernel<double>, n);
  else
    err = prepare<float>((const void*)bisect_kernel<float>, n);
  if (err != cudaSuccess) return (int)err;
  for (int s = 0; s < STEPS; ++s) {
    if (f64)
      bisect_kernel<double><<<grid, THREADS, smem_bytes<double>(n), st>>>(
          (const double*)d, (const double*)e2, (const double*)pivmin,
          (double*)a, (double*)b, (int32_t*)live, n, s);
    else
      bisect_kernel<float><<<grid, THREADS, smem_bytes<float>(n), st>>>(
          (const float*)d, (const float*)e2, (const float*)pivmin,
          (float*)a, (float*)b, (int32_t*)live, n, s);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"
