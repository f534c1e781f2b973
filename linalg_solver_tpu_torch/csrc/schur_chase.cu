// One multibulge Francis sweep's bulge chase on a batch of padded
// Hessenberg matrices (the real Schur solver of ops/schur.py).
//
// Replaces the XLA scan of `_chase_step` / `_apply_bulge` in
// linalg_solver_tpu/ops/schur.py (`_one_sweep`'s `lax.scan`, :869-891),
// which is not a Pallas kernel: the reference chases on the TPU as one
// compiled loop, and the port's plain version (ops/kernels/schur_chase.py)
// as ~40 small batched PyTorch operations a chase step, which on the H100
// are launch-bound (0.15 s a sweep at B = 32, n = 256 under a CUDA graph).
//
// Math: at chase step k, bulge i (0: one per unreduced block; 1..nc: the
// bottom block's chain) sits at position p = k - 3i.  A live bulge forms
// its 3-vector (x, y, z): on creation the first column of
// (H - aI)(H - bI) restricted to rows p..p+2 (shift sum s, product p), else
// the bulge column H[p..p+2, p-1]; z is cut at the window's foot.  The
// Householder reflector I - beta v v^T (v0 = x + sign(x)|v|, a subnormal
// |v|^2 counting as zero) is applied to rows p..p+2 (all columns), the
// bulge tail H[p+1..p+2, p-1] is zeroed while chasing, then to columns
// p..p+2 (all rows) and Q's columns p..p+2.  The control (live, creating,
// chasing, z cut, s, p) comes from tables [B, nc+1, n+1] the caller builds
// before the sweep; row r is bulge nc - r.
//
// Mapping on the H100.  One block of 256 threads a matrix; the matrix
// stays in device memory (257 x 257 f32 is 264 KB, past a block's shared
// memory; a batch of 32 is 8.4 MB, resident in the 50 MB L2).  A step:
// the live bulges' reflectors (one thread each, from values no other
// bulge of the step touches: supports are 3 apart), a barrier, the row
// updates of all of them (threads over (bulge, column), coalesced), a
// barrier, the tails, a barrier, the column updates of H and Q (threads
// over (bulge, row)), a barrier.  Rows before columns for every bulge at
// once is the reference's per-bulge sequence up to the rounding of the
// entries where one bulge's rows cross another's columns.
//
// Arithmetic: every product, sum and difference rounded on its own (no
// contraction), in the plain version's order, so that the two agree to
// the bit (a chase through nearly deflated subdiagonals amplifies a
// rounding's difference by orders of magnitude).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int MAXB = 64;        // bulges a step: nc + 1 <= 64

#define DEV __device__ __forceinline__
DEV float mul(float a, float b) { return __fmul_rn(a, b); }
DEV float add(float a, float b) { return __fadd_rn(a, b); }
DEV float sub(float a, float b) { return __fsub_rn(a, b); }
DEV float dvd(float a, float b) { return __fdiv_rn(a, b); }
DEV float sqr(float a) { return __fsqrt_rn(a); }
DEV double mul(double a, double b) { return __dmul_rn(a, b); }
DEV double add(double a, double b) { return __dadd_rn(a, b); }
DEV double sub(double a, double b) { return __dsub_rn(a, b); }
DEV double dvd(double a, double b) { return __ddiv_rn(a, b); }
DEV double sqr(double a) { return __dsqrt_rn(a); }

// the smallest normal number: a smaller |v|^2 counts as zero
DEV float tiny(float) { return 1.17549435e-38f; }
DEV double tiny(double) { return 2.2250738585072014e-308; }

// One step of the bulges at positions p0, p0 + 3, ... (table rows r0,
// r0 + 1, ...): reflectors, row updates, tails, column updates, each
// phase behind a barrier.
template <typename T>
DEV void chase_group(
    T* h, T* q, const uint8_t* act, const uint8_t* cre, const uint8_t* chs,
    const uint8_t* zcut, const T* S, const T* P, int npad, int nq, int p0,
    int r0, int nb, T (*sv)[3], T (*sbv)[3], int* slive, int* schase) {
  const int tid = threadIdx.x;
  for (int j = tid; j < nb; j += NT) {
    const int p = p0 + 3 * j;
    const size_t t = (size_t)(r0 + j) * npad + p;
    int live = act[t];
    T x = 0, y = 0, z = 0;
    if (live) {
      if (cre[t]) {
        const T s = S[t], pp = P[t];
        const T a00 = h[p * npad + p], a01 = h[p * npad + p + 1];
        const T a10 = h[(p + 1) * npad + p], a11 = h[(p + 1) * npad + p + 1];
        const T a21 = h[(p + 2) * npad + p + 1];
        x = add(sub(add(mul(a00, a00), mul(a01, a10)), mul(s, a00)), pp);
        y = mul(a10, sub(add(a00, a11), s));
        z = mul(a10, a21);
      } else {
        x = h[p * npad + p - 1];
        y = h[(p + 1) * npad + p - 1];
        z = h[(p + 2) * npad + p - 1];
      }
      if (zcut[t]) z = 0;
    }
    const T nrm = sqr(add(add(mul(x, x), mul(y, y)), mul(z, z)));
    const T v0 = add(x, mul(x < 0 ? T(-1) : T(1), nrm));
    const T vn2 = add(add(mul(v0, v0), mul(y, y)), mul(z, z));
    const T beta = (live && vn2 >= tiny(vn2)) ? dvd(T(2), vn2) : T(0);
    sv[j][0] = v0; sv[j][1] = y; sv[j][2] = z;
    sbv[j][0] = mul(beta, v0); sbv[j][1] = mul(beta, y);
    sbv[j][2] = mul(beta, z);
    slive[j] = live && beta != T(0);     // beta = 0 leaves H as it is
    schase[j] = live && chs[t];
  }
  __syncthreads();

  // rows p..p+2, full width: H <- (I - beta v v^T) H
  for (int e = tid; e < nb * npad; e += NT) {
    const int j = e / npad, c = e - j * npad;
    if (!slive[j]) continue;
    T* r = h + (size_t)(p0 + 3 * j) * npad + c;
    const T h0 = r[0], h1 = r[npad], h2 = r[2 * npad];
    const T vr = add(add(mul(sv[j][0], h0), mul(sv[j][1], h1)),
                     mul(sv[j][2], h2));
    r[0] = sub(h0, mul(sbv[j][0], vr));
    r[npad] = sub(h1, mul(sbv[j][1], vr));
    r[2 * npad] = sub(h2, mul(sbv[j][2], vr));
  }
  __syncthreads();
  // the bulge tail (and a deepened start's leak) in column p - 1
  for (int j = tid; j < nb; j += NT) {
    if (!schase[j]) continue;
    const int p = p0 + 3 * j;
    h[(p + 1) * npad + p - 1] = 0;
    h[(p + 2) * npad + p - 1] = 0;
  }
  __syncthreads();

  // columns p..p+2, full height: H <- H (I - beta v v^T); Q likewise
  const int rows = npad + (q ? nq : 0);
  for (int e = tid; e < nb * rows; e += NT) {
    const int j = e / rows, i = e - j * rows;
    if (!slive[j]) continue;
    const int p = p0 + 3 * j;
    T* r = i < npad ? h + (size_t)i * npad + p
                    : q + (size_t)(i - npad) * npad + p;
    const T c0 = r[0], c1 = r[1], c2 = r[2];
    const T cv = add(add(mul(c0, sv[j][0]), mul(c1, sv[j][1])),
                     mul(c2, sv[j][2]));
    r[0] = sub(c0, mul(cv, sbv[j][0]));
    r[1] = sub(c1, mul(cv, sbv[j][1]));
    r[2] = sub(c2, mul(cv, sbv[j][2]));
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(NT)
chase_kernel(T* __restrict__ H, T* __restrict__ Q,
             const uint8_t* __restrict__ act, const uint8_t* __restrict__ cre,
             const uint8_t* __restrict__ chs, const uint8_t* __restrict__ zcut,
             const T* __restrict__ S, const T* __restrict__ P,
             int n, int nc, int nq) {
  const int npad = n + 1;
  const size_t toff = (size_t)blockIdx.x * (nc + 1) * npad;
  T* h = H + (size_t)blockIdx.x * npad * npad;
  T* q = Q ? Q + (size_t)blockIdx.x * nq * npad : nullptr;
  act += toff; cre += toff; chs += toff; zcut += toff; S += toff; P += toff;

  __shared__ T sv[MAXB][3];     // v
  __shared__ T sbv[MAXB][3];    // beta v
  __shared__ int slive[MAXB];
  __shared__ int schase[MAXB];

  const int nsteps = max(n - 1 + 3 * nc, 1);
  for (int k = 0; k < nsteps; ++k) {
    // bulge i sits at k - 3i; only 0 <= k - 3i <= n - 2 can be live
    const int over = k - (n - 2);
    const int i_lo = over > 0 ? (over + 2) / 3 : 0;
    const int i_hi = min(nc, k / 3);
    if (i_lo > i_hi) continue;
    const int nb = i_hi - i_lo + 1;
    const int p0 = k - 3 * i_hi;
    const int r0 = nc - i_hi;
    if (p0 == 0 && nb > 1) {
      // a bulge created at row 0 has no column -1: a step of its own,
      // as the plain version takes it
      chase_group(h, q, act, cre, chs, zcut, S, P, npad, nq, 0, r0, 1, sv,
                  sbv, slive, schase);
      chase_group(h, q, act, cre, chs, zcut, S, P, npad, nq, 3, r0 + 1,
                  nb - 1, sv, sbv, slive, schase);
    } else {
      chase_group(h, q, act, cre, chs, zcut, S, P, npad, nq, p0, r0, nb, sv,
                  sbv, slive, schase);
    }
  }
}

template <typename T>
int launch(void* H, void* Q, const void* act, const void* cre,
           const void* chs, const void* zcut, const void* S, const void* P,
           int batch, int n, int nc, int nq, cudaStream_t s) {
  chase_kernel<T><<<batch, NT, 0, s>>>(
      (T*)H, (T*)Q, (const uint8_t*)act, (const uint8_t*)cre,
      (const uint8_t*)chs, (const uint8_t*)zcut, (const T*)S, (const T*)P,
      n, nc, nq);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the chase on `stream`, in place on H [batch, n+1, n+1] and, when
// Q is not null, Q [batch, nq, n+1] (contiguous, f32 when `f64` is 0, else
// f64).  Tables [batch, nc+1, n+1]: act, cre, chs, zcut one byte an entry
// (0/1), S and P of H's type.  Returns the cudaError_t of the launch (0 on
// success), or cudaErrorInvalidValue for n < 1 or nc outside [0, 63].
int schur_chase(void* H, void* Q, const void* act, const void* cre,
                const void* chs, const void* zcut, const void* S,
                const void* P, int batch, int n, int nc, int nq, int f64,
                void* stream) {
  if (n < 1 || nc < 0 || nc + 1 > MAXB || nq < 0)
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (f64)
    return launch<double>(H, Q, act, cre, chs, zcut, S, P, batch, n, nc, nq,
                          s);
  return launch<float>(H, Q, act, cre, chs, zcut, S, P, batch, n, nc, nq, s);
}

}  // extern "C"
