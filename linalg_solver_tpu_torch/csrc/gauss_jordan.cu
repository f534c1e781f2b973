// Batched Gauss-Jordan with in-place partial pivoting and a per-matrix
// pivot threshold.
//
// Replaces the Pallas TPU kernel `_gj_kernel` in
// linalg_solver_tpu/ops/pallas/gj_kernel.py (launched by `_gj_call`
// from `gauss_jordan_tiled`).  Same math, per matrix of the batch: the
// n pivoted steps of gj_pivot.cuh on the [n, w] array (w >= n), then
// the reduced array, the pivot order `perm` and the pivot values.
//
// Mapping on the H100.  The TPU kernel keeps a tile of 128 matrices in
// the vector lanes, [n, w, 128] in VMEM, and pays a one-hot select for
// every dynamic index.  Here one thread block holds one matrix in shared
// memory (grid = batch) and indexes it directly.  At the inverse's
// [64, 128] that is 35.6 KB a block; at 48 registers a thread, five
// blocks fit an SM.
//
// What bounds it.  Every step updates the whole [n, w] tile from shared
// memory (2n^2 w FMAs and 2n^2 w shared-memory accesses per matrix over
// the n steps) and takes three barriers; the argmax is a chain of warp
// shuffles.  Shared-memory bandwidth and the barrier latency, not the
// 67 TFLOP/s of FP32, set the time.  The design keeps the whole
// elimination on chip (the array is read from device memory once and
// written once) and runs several matrices per SM to hide the barriers.
// Reach: gj_smem_floats(n, w) <= 58,112 floats, which covers the inverse
// up to n = 167 (the TPU's own budget stops at n*w = 16,384).
// Not ported: the padding of w to a multiple of 8, the identity filler
// to 128 lanes and the [n, w, batch] transpose, which exist only for
// the TPU's tiles and lanes.

#include "gj_pivot.cuh"

namespace {

__global__ void __launch_bounds__(GJ_NT)
gauss_jordan_kernel(const float* __restrict__ a, const float* __restrict__ tol,
                    float* __restrict__ out, int* __restrict__ perm,
                    float* __restrict__ pivs, int n, int w) {
  extern __shared__ float smem[];
  const GJTile s = gj_carve(smem, n, w);
  const size_t m = blockIdx.x, nw = (size_t)n * w;
  const float* A = a + m * nw;
  for (int idx = threadIdx.x; idx < n * w; idx += GJ_NT) {
    const int r = idx / w, c = idx - r * w;
    s.T[r * s.ld + c] = A[idx];
  }
  __syncthreads();
  gj_pivot_steps(s, n, w, tol[m]);
  float* O = out + m * nw;
  for (int idx = threadIdx.x; idx < n * w; idx += GJ_NT) {
    const int r = idx / w, c = idx - r * w;
    O[idx] = s.T[r * s.ld + c];
  }
  for (int j = threadIdx.x; j < n; j += GJ_NT) {
    perm[m * n + j] = s.perm[j];
    pivs[m * n + j] = s.pivs[j];
  }
}

}  // namespace

extern "C" {

// Shared memory the kernel needs for an [n, w] array, in bytes.
size_t gj_smem_bytes(int n, int w) {
  return gj_smem_floats(n, w) * sizeof(float);
}

// Launches the kernel on `stream`; returns the cudaError_t of the launch
// (0 on success).  Device pointers to contiguous data: a and out
// [batch, n, w] f32, tol [batch] f32, perm [batch, n] int32, pivs
// [batch, n] f32.
int gauss_jordan_f32(const void* a, const void* tol, void* out, void* perm,
                     void* pivs, int batch, int n, int w, void* stream) {
  const size_t smem = gj_smem_bytes(n, w);
  cudaError_t err = cudaFuncSetAttribute(
      gauss_jordan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  gauss_jordan_kernel<<<batch, GJ_NT, smem, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)tol, (float*)out, (int*)perm,
      (float*)pivs, n, w);
  return (int)cudaGetLastError();
}

}  // extern "C"
