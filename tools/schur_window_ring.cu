// A two-warp form of the AED window kernel, kept as a measured result:
// warp 0 runs the sweep's bookkeeping, each step's reflector and H's
// updates, and hands each step to warp 1 through a ring of 16 reflectors
// in shared memory (two counters, the waits backed off by __nanosleep);
// warp 1 applies them to Q's rows.  Bitwise the package's kernel, but
// slower on the H100 than linalg_solver_tpu_torch/csrc/schur_window.cu,
// which keeps Q in its one warp's column update (PERF.md).  Same C
// entry point schur_window; time it in turns with the package's kernel:
//
//   python3 tools/time_schur.py --window-form tools/schur_window_ring.cu
//
// The inner real Schur form of an aggressive-early-deflation window, with
// its orthogonal accumulator, and the window's trailing deflation run, in
// one launch (the AED round of ops/schur.py, `_aed`).
//
// Replaces the reference's `lax.while_loop` of up to 2w strict sweeps in
// `_aed` (linalg_solver_tpu/ops/schur.py:571-597) and the `lax.scan` of
// dlaqr3's deflation test after it (:622-654), which are not Pallas
// kernels: the TPU runs them as compiled loops, and the port's plain version
// (ops/schur.py `_window_schur`, `_trailing_deflation`) as Python loops of
// small batched PyTorch operations: ~180 a sweep (deflation, block bounds,
// shifts, bulge starts, the chase tables, the chase), ~11k CUDA-graph
// nodes an AED round at w = 32, and ~1,700 for the deflation test.
//
// Math, a lane (one padded window Hw [w+1, w+1], Qw [w, w+1], its bottom
// hw and norm anorm_w), a sweep being what `_one_sweep(..., strict_deflate=
// True)` does with one shift pair:
//  - deflate: zero H[j+1, j] where |H[j+1, j]| <= tiny/eps, or where it and
//    the eigenvalue perturbation |H[j+1,j] H[j,j+1]| / max(|H[j,j] -
//    H[j+1,j+1]|, sqrt(.) + tiny) are both <= eps anorm_w; pull hw up past
//    converged 1x1 and 2x2 trailing blocks (four rounds); count the
//    sweeps without deflation (`stagnant`);
//  - per position: its unreduced block [start, end] (capped at hw), the
//    block's double shift from its trailing 2x2 (dlahqr's exceptional
//    shift every 10 stagnant sweeps, bottom block), and the deepest safe
//    bulge start (two consecutive small subdiagonals);
//  - the chase: at step k = 0 .. w - 2 the 3x3 Householder reflector at
//    row k, created from the shifts at a block's start, else taken from
//    the bulge column k - 1, applied to rows k..k+2, the tail zeroed, then
//    to columns k..k+2 of H and Q.
// A lane stops once hw < 1.  Stopping each lane on its own is the plain
// version's batch loop (which sweeps every lane while any is live): once a
// sweep leaves a lane's hw < 1 the strict deflation changes nothing more
// and the chase has no live bulge.  Only a lane that enters with hw < 1
// differs: the batch loop deflates it once when another lane is live, so
// the kernel sweeps it once when the batch was live on entry (`live`).
// Then the deflation test: from the window's bottom row p = hi_w0 up, a
// 1x1 or 2x2 block deflates while its spike entries beta Q[0, .] are at
// most max(eps |its eigenvalue scale|, smlnum) and the inner iteration
// converged it; outputs the rows deflated (nd) and the last row left
// (p_fin).
//
// Dead steps.  A step at a position outside every active block (every
// position past hw, and more as the window converges) has beta = 0: it
// applies (I - 0 v v^T), which on finite values changes at most the sign
// of a zero (h - 0 * vr).  The kernel skips such a step (p > 0, not
// active) when every value of H it has held in this launch is below
// 2^60 in f32 (2^500 in f64): then x, y, z are entries, |v0| < 3 max,
// and every row and column sum vr, cv stays finite, so the plain
// version's update gives back each entry up to its zero's sign, which
// NaN-equality (the repo's comparison) does not see and no later
// division meets (the deflation test divides by a value >= tiny, the
// reflector by vn2 >= tiny, and `_aed` takes torch.sign of u0 only where
// u0 != 0).  Each lane keeps the largest |value| it wrote (as its bits;
// NaN and Inf above every finite value) and the warp votes; an Inf or NaN
// anywhere stops the skipping, so non-finite values spread exactly as in
// the plain version.  ops/kernels/schur_window.window_schedule_reference
// is this rule written plainly, and `window_live_steps` counts the steps
// the kernel did not skip.
//
// Mapping on the H100: a block of two warps a lane, the window and Q
// resident in shared memory for the whole launch ((w+1)^2 + w(w+1) words:
// 8.6 KB at w = 32 in f32, 67 KB at w = 64 in f64), nothing written back
// until the end.  Warp 0 holds the chain: the sweep's bookkeeping
// (positions spread over the lanes, NPL = ceil((w+1)/32) each, warp
// shuffles for the block scans), each step's reflector (formed by every
// lane from a broadcast read), the row update (a lane a column) and the
// column update of H (a lane a row), each lane's loads issued before its
// arithmetic, __syncwarp between phases.  Warp 1 applies each step's
// reflector to Q's rows (a lane a row, no barrier of its own): warp 0
// hands it the steps in order through a ring of RING entries in shared
// memory with two counters, so Q's updates leave the chain.  Bound: each
// live step is a dependent chain (reflector, rows, columns) of a few
// hundred cycles; latency, not bytes or operations.
//
// Arithmetic: every operation rounded on its own, in the plain version's
// order (schur_rn.cuh), so that the kernel agrees with the plain version
// to the bit (NaN-equal), NaN lanes included.  The first one-warp form is
// tools/schur_window_warp.cu.

#include <cuda_runtime.h>
#include <stdint.h>

#include "schur_rn.cuh"

namespace {

using namespace schur_rn;

constexpr int MAXNPL = 4;
constexpr int MAXPAD = 32 * MAXNPL;     // w + 1 <= 128
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t SMEM_MAX = 232448;     // a block's shared memory, H100
constexpr int RING = 16;                // reflectors in flight to warp 1
constexpr int STEP_FULL = 0, STEP_SKIP = 1, STEP_END = 2;

// steps the kernel did not skip, over every launch since the last reset
__device__ unsigned long long g_window_live_steps;

template <typename T>
struct Ring {
  T v[RING][6];   // v0, y, z, b0, b1, b2 (a skipped step: x, y, z)
  int p[RING];
  int kind[RING];
  int pub, cons;  // entries published by warp 0, consumed by warp 1
};

// the static shared memory beside the dynamic
constexpr size_t RING_BYTES = sizeof(Ring<double>) + 16;

__host__ __device__ inline int window_ld(int npad) { return npad | 1; }

// shared memory of one lane: H, Q, the shifts S, P, the running maxima
// and the control bits of each position
__host__ __device__ inline size_t window_bytes(int w, int esize) {
  const size_t npad = w + 1, ld = window_ld(w + 1);
  const size_t b = (npad * ld + (size_t)w * ld + 2 * npad) * esize
                   + 2 * npad * sizeof(int);
  return (b + 15) & ~(size_t)15;
}

// |x| as an unsigned key, monotone in |x|, NaN and Inf above every finite
// value (f64: the high word); and the key of the skipping bound
SCHUR_DEV unsigned mag_key(float x) { return __float_as_uint(fabsf(x)); }
SCHUR_DEV unsigned mag_key(double x) {
  return (unsigned)(__double_as_longlong(fabs(x)) >> 32);
}
SCHUR_DEV unsigned skip_bound(float) { return (60u + 127u) << 23; }
SCHUR_DEV unsigned skip_bound(double) { return (500u + 1023u) << 20; }

SCHUR_DEV int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// inclusive prefix maximum over the warp's lanes
SCHUR_DEV int scan_max(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v = max(v, u);
  }
  return v;
}

// inclusive suffix minimum over the warp's lanes
SCHUR_DEV int scan_min_rev(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_down_sync(FULL, v, o);
    if (lane + o < 32) v = min(v, u);
  }
  return v;
}

// warp 0 hands step `seq` to warp 1 (lane 0 writes; the ring slot is free
// once warp 1 has consumed the entry RING steps back)
template <typename T>
SCHUR_DEV void publish(Ring<T>& rg, int& seq, int p, int kind, T a, T b,
                       T c, T d, T e, T f, int lane) {
  if (lane == 0) {
    while (seq - *(volatile int*)&rg.cons >= RING) __nanosleep(32);
    const int slot = seq % RING;
    rg.v[slot][0] = a;
    rg.v[slot][1] = b;
    rg.v[slot][2] = c;
    rg.v[slot][3] = d;
    rg.v[slot][4] = e;
    rg.v[slot][5] = f;
    rg.p[slot] = p;
    rg.kind[slot] = kind;
    __threadfence_block();
    *(volatile int*)&rg.pub = seq + 1;
  }
  ++seq;
}

// One strict sweep of a lane's window in shared memory (hs: [npad, ld]),
// warp 0; Q's updates go to warp 1 through the ring.  hi and stg are the
// lane's hw and stagnant count, the same in every warp lane; mh is the
// lane's largest key of a value of H so far; live counts the steps run.
template <typename T, int NPL>
SCHUR_DEV void window_sweep(T* hs, T* sS, T* sP, int* srun, int* sflag,
                            Ring<T>& rg, int& seq, int npad, int ld,
                            int lane, T ea, int& hi, int& stg, unsigned& mh,
                            unsigned& live) {
  const int n = npad - 1;
  const T TINY = tiny(T(0)), EPS = eps(T(0)), TOE = tiny_over_eps(T(0));
  const unsigned BOUND = skip_bound(T(0));

  // --- deflate (strict criteria) ---
  bool small[NPL];
#pragma unroll
  for (int s = 0; s < NPL; ++s) {
    const int j = lane + 32 * s;
    small[s] = false;
    if (j < n) {
      const T asub = mag(hs[(j + 1) * ld + j]);
      const T asup = mag(hs[j * ld + j + 1]);
      const T gap = mag(sub(hs[j * ld + j], hs[(j + 1) * ld + j + 1]));
      const T prod = mul(asub, asup);
      const T pert = dvd(prod, nan_max(gap, add(sqr(prod), TINY)));
      small[s] = asub <= TOE || (asub <= ea && pert <= ea);
    }
  }
  __syncwarp();
#pragma unroll
  for (int s = 0; s < NPL; ++s) {
    const int j = lane + 32 * s;
    if (small[s]) hs[(j + 1) * ld + j] = T(0);
  }
  __syncwarp();
  bool moved = false;
  for (int r = 0; r < 4; ++r) {
    const T a = hs[clampi(hi, 0, n) * ld + clampi(hi - 1, 0, n)];
    const T c = hs[clampi(hi - 1, 0, n) * ld + clampi(hi - 2, 0, n)];
    const bool d1 = hi > 0 && a == T(0);
    const bool d2 = !d1 && hi > 1 && c == T(0);
    const bool d2e = !d1 && hi == 1;
    const int hn = d1 ? hi - 1 : (d2 || d2e) ? hi - 2 : hi;
    moved = moved || hn != hi;
    hi = max(hn, -1);
  }
  stg = moved ? 0 : stg + 1;

  // --- unreduced blocks: start = after the last zero above, end = the
  // first zero at or below, capped at hi ---
  int start[NPL], end[NPL];
  {
    int run[NPL], cand[NPL];
#pragma unroll
    for (int s = 0; s < NPL; ++s) {
      const int k = lane + 32 * s;
      const bool z = k <= npad - 2 && hs[(k + 1) * ld + k] == T(0);
      run[s] = z ? k + 1 : 0;
      cand[s] = z ? k : npad;
    }
    int carry = 0;
#pragma unroll
    for (int s = 0; s < NPL; ++s) {
      const int inc = max(scan_max(run[s], lane), carry);
      const int up = __shfl_up_sync(FULL, inc, 1);
      start[s] = lane == 0 ? carry : up;
      carry = __shfl_sync(FULL, inc, 31);
    }
    carry = npad;
#pragma unroll
    for (int s = NPL - 1; s >= 0; --s) {
      const int inc = min(scan_min_rev(cand[s], lane), carry);
      end[s] = inc;
      carry = __shfl_sync(FULL, inc, 0);
    }
#pragma unroll
    for (int s = 0; s < NPL; ++s) {
      end[s] = min(end[s], hi);
      start[s] = min(start[s], max(end[s], 0));
    }
  }

  // --- shifts per block, and the bulge-start test at each position ---
  T sk[NPL], pk[NPL];
  int rv[NPL];
#pragma unroll
  for (int s = 0; s < NPL; ++s) {
    const int k = lane + 32 * s;
    sk[s] = pk[s] = T(0);
    rv[s] = 0;
    if (k >= npad) continue;
    const int e = clampi(end[s], 1, n);
    const T h00 = hs[(e - 1) * ld + e - 1], h01 = hs[(e - 1) * ld + e];
    const T h10 = hs[e * ld + e - 1], h11 = hs[e * ld + e];
    T sv = add(h00, h11);
    T pv = sub(mul(h00, h11), mul(h01, h10));
    if (stg > 0 && stg % 10 == 0 && end[s] == hi) {
      const int m = max(e - 2, 0);
      const T t = add(mag(h10), mag(hs[(m + 1) * ld + m]));
      const T d = add(mul(T(0.75), t), h11);
      sv = mul(T(2), d);
      pv = add(mul(d, d), mul(mul(T(0.4375), t), t));
    }
    sk[s] = sv;
    pk[s] = pv;
    const T a00 = hs[k * ld + k];
    const T a10 = k <= npad - 2 ? hs[(k + 1) * ld + k] : T(0);
    const T a01 = k <= npad - 2 ? hs[k * ld + k + 1] : T(0);
    const T a11 = k <= npad - 2 ? hs[(k + 1) * ld + k + 1] : T(0);
    const T a21 = k <= npad - 3 ? hs[(k + 2) * ld + k + 1] : T(0);
    const T x = add(sub(add(mul(a00, a00), mul(a01, a10)), mul(sv, a00)),
                    pv);
    const T y = mul(a10, sub(add(a00, a11), sv));
    const T z = mul(a10, a21);
    const T sm1 = k > 0 ? hs[k * ld + k - 1] : T(0);
    const T dm1 = k > 0 ? hs[(k - 1) * ld + k - 1] : T(0);
    const bool ok = mul(mag(sm1), add(mag(y), mag(z)))
                    <= mul(mul(EPS, mag(x)),
                           add(add(mag(dm1), mag(a00)), mag(a11)));
    rv[s] = (ok && k >= start[s] + 1 && k <= end[s] - 2) ? k : 0;
  }
  {
    int carry = 0;
#pragma unroll
    for (int s = 0; s < NPL; ++s) {
      const int k = lane + 32 * s;
      const int inc = max(scan_max(rv[s], lane), carry);
      if (k < npad) srun[k] = inc;
      carry = __shfl_sync(FULL, inc, 31);
    }
  }
  __syncwarp();
#pragma unroll
  for (int s = 0; s < NPL; ++s) {
    const int k = lane + 32 * s;
    if (k >= npad) continue;
    const int lo = max(start[s], srun[clampi(end[s] - 2, 0, n)]);
    const int e = end[s];
    const bool act = k >= lo && k <= e - 1 && e >= 2;
    sflag[k] = (act ? 1 : 0) | (act && k == lo ? 2 : 0)
               | (act && k > 0 ? 4 : 0) | (k + 2 > e ? 8 : 0);
    sS[k] = sk[s];
    sP[k] = pk[s];
  }
  __syncwarp();

  // --- the chase: one reflector a step, rows then columns of H ---
  for (int p = 0; p <= n - 2; ++p) {
    const int f = sflag[p];
    if (p > 0 && !(f & 1) && __all_sync(FULL, mh < BOUND)) {
      // a dead step: warp 1 gets the bulge column in case a row of Q
      // needs the full step (a value of Q at or past the bound)
      const T x = hs[p * ld + p - 1], y = hs[(p + 1) * ld + p - 1];
      const T z = (f & 8) ? T(0) : hs[(p + 2) * ld + p - 1];
      publish(rg, seq, p, STEP_SKIP, x, y, z, T(0), T(0), T(0), lane);
      continue;
    }
    ++live;
    const T s_ = sS[p], pp = sP[p];
    const T a00 = hs[p * ld + p], a01 = hs[p * ld + p + 1];
    const T a10 = hs[(p + 1) * ld + p], a11 = hs[(p + 1) * ld + p + 1];
    const T a21 = hs[(p + 2) * ld + p + 1];
    T x = add(sub(add(mul(a00, a00), mul(a01, a10)), mul(s_, a00)), pp);
    T y = mul(a10, sub(add(a00, a11), s_));
    T z = mul(a10, a21);
    if (p > 0 && !(f & 2)) {
      x = hs[p * ld + p - 1];
      y = hs[(p + 1) * ld + p - 1];
      z = hs[(p + 2) * ld + p - 1];
    }
    if (f & 8) z = T(0);
    const T nrm = sqr(add(add(mul(x, x), mul(y, y)), mul(z, z)));
    const T v0 = add(x, mul(x < T(0) ? T(-1) : T(1), nrm));
    const T vn2 = add(add(mul(v0, v0), mul(y, y)), mul(z, z));
    const T beta = ((f & 1) && vn2 >= TINY) ? two_over(vn2) : T(0);
    const T b0 = mul(beta, v0), b1 = mul(beta, y), b2 = mul(beta, z);
    const bool tail = p > 0 && (f & 4);
    publish(rg, seq, p, STEP_FULL, v0, y, z, b0, b1, b2, lane);
    __syncwarp();
    {
      T h0[NPL], h1[NPL], h2[NPL];
#pragma unroll
      for (int s = 0; s < NPL; ++s) {
        const int c = min(lane + 32 * s, npad - 1);
        const T* r = hs + p * ld + c;
        h0[s] = r[0];
        h1[s] = r[ld];
        h2[s] = r[2 * ld];
      }
#pragma unroll
      for (int s = 0; s < NPL; ++s) {
        const int c = lane + 32 * s;
        if (c < npad) {
          T* r = hs + p * ld + c;
          const T vr = add(add(mul(v0, h0[s]), mul(y, h1[s])), mul(z, h2[s]));
          const T n0 = sub(h0[s], mul(b0, vr));
          const bool zero = tail && c == p - 1;   // the bulge tail
          const T n1 = zero ? T(0) : sub(h1[s], mul(b1, vr));
          const T n2 = zero ? T(0) : sub(h2[s], mul(b2, vr));
          r[0] = n0;
          r[ld] = n1;
          r[2 * ld] = n2;
          mh = max(mh, max(mag_key(n0), max(mag_key(n1), mag_key(n2))));
        }
      }
    }
    __syncwarp();
    {
      T c0[NPL], c1[NPL], c2[NPL];
#pragma unroll
      for (int s = 0; s < NPL; ++s) {
        const int i = min(lane + 32 * s, npad - 1);
        const T* r = hs + i * ld + p;
        c0[s] = r[0];
        c1[s] = r[1];
        c2[s] = r[2];
      }
#pragma unroll
      for (int s = 0; s < NPL; ++s) {
        const int i = lane + 32 * s;
        if (i < npad) {
          T* r = hs + i * ld + p;
          const T cv = add(add(mul(c0[s], v0), mul(c1[s], y)), mul(c2[s], z));
          const T n0 = sub(c0[s], mul(cv, b0));
          const T n1 = sub(c1[s], mul(cv, b1));
          const T n2 = sub(c2[s], mul(cv, b2));
          r[0] = n0;
          r[1] = n1;
          r[2] = n2;
          mh = max(mh, max(mag_key(n0), max(mag_key(n1), mag_key(n2))));
        }
      }
    }
    __syncwarp();
  }
}

// Warp 1: the steps' reflectors on the rows of Q (qs: [w, ld]), a lane its
// rows lane + 32 s, in step order, until warp 0's end entry.
template <typename T, int NPL>
SCHUR_DEV void q_worker(T* qs, Ring<T>& rg, int w, int npad, int ld,
                        int lane) {
  const unsigned BOUND = skip_bound(T(0));
  unsigned mq = 0;   // the lane's largest key of a value of its rows
#pragma unroll
  for (int s = 0; s < NPL; ++s) {
    const int i = lane + 32 * s;
    if (i < w)
      for (int c = 0; c < npad; ++c) mq = max(mq, mag_key(qs[i * ld + c]));
  }
  for (int seq = 0;; ++seq) {
    while (*(volatile int*)&rg.pub <= seq) __nanosleep(64);
    __threadfence_block();
    const int slot = seq % RING;
    const int kind = rg.kind[slot], p = rg.p[slot];
    if (kind == STEP_END) break;
    T v0 = rg.v[slot][0], y = rg.v[slot][1], z = rg.v[slot][2];
    T b0 = rg.v[slot][3], b1 = rg.v[slot][4], b2 = rg.v[slot][5];
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();
      *(volatile int*)&rg.cons = seq + 1;
    }
    // a dead step leaves a row below the bound as it is (up to a zero's
    // sign); a row past it takes the full step with beta = 0
    bool run = true;
    if (kind == STEP_SKIP) {
      run = mq >= BOUND;
      const T x = v0;
      const T nrm = sqr(add(add(mul(x, x), mul(y, y)), mul(z, z)));
      v0 = add(x, mul(x < T(0) ? T(-1) : T(1), nrm));
      b0 = mul(T(0), v0);
      b1 = mul(T(0), y);
      b2 = mul(T(0), z);
    }
    if (!run) continue;
    T c0[NPL], c1[NPL], c2[NPL];
#pragma unroll
    for (int s = 0; s < NPL; ++s) {
      const int i = min(lane + 32 * s, w - 1);
      const T* r = qs + i * ld + p;
      c0[s] = r[0];
      c1[s] = r[1];
      c2[s] = r[2];
    }
#pragma unroll
    for (int s = 0; s < NPL; ++s) {
      const int i = lane + 32 * s;
      if (i < w) {
        T* r = qs + i * ld + p;
        const T cv = add(add(mul(c0[s], v0), mul(c1[s], y)), mul(c2[s], z));
        const T n0 = sub(c0[s], mul(cv, b0));
        const T n1 = sub(c1[s], mul(cv, b1));
        const T n2 = sub(c2[s], mul(cv, b2));
        r[0] = n0;
        r[1] = n1;
        r[2] = n2;
        mq = max(mq, max(mag_key(n0), max(mag_key(n1), mag_key(n2))));
      }
    }
  }
}

// dlaqr3's deflation test on the converged window (one thread; hs, qs as
// in window_sweep): the bottom row p moves up past each negligible
// block.  Returns the rows deflated; p ends at the last row left.
template <typename T>
SCHUR_DEV int trailing_deflation(const T* hs, const T* qs, int w, int ld,
                                 int hi, T beta, int n, int& p) {
  const T EPS = eps(T(0));
  const T sml = mul(T(n), tiny_over_eps(T(0)));    // tiny (n / eps)
  auto diag = [&](int j) { return hs[j * ld + j]; };
  auto below = [&](int j) { return j < w - 1 ? hs[(j + 1) * ld + j] : T(0); };
  auto above = [&](int j) { return j < w - 1 ? hs[j * ld + j + 1] : T(0); };
  auto spike = [&](int j) { return mag(mul(beta, qs[j])); };
  const bool conv_all = hi < 1;
  int nd = 0;
  bool stop = false;
  for (int it = 0; it < w; ++it) {
    const int pc = clampi(p, 0, w - 1), pm = clampi(p - 1, 0, w - 1);
    const bool is2 = p >= 1 && below(pm) != T(0);
    T foo = mag(diag(pc));
    if (is2) foo = add(foo, mul(sqr(mag(below(pm))), sqr(mag(above(pm)))));
    T sv = spike(pc);
    if (is2) sv = nan_max(sv, spike(pm));
    // only blocks the inner iteration converged read as eigenvalues
    const bool conv_ok = conv_all || p - (is2 ? 1 : 0) > hi;
    T thr = mul(EPS, foo);
    thr = thr < sml ? sml : thr;                    // clamp(min=), NaN kept
    const bool defl = !stop && p >= 0 && conv_ok && sv <= thr;
    if (defl) {
      nd += is2 ? 2 : 1;
      p -= is2 ? 2 : 1;
    }
    stop = stop || !defl;
  }
  return nd;
}

template <typename T, int NPL>
__global__ void __launch_bounds__(64)
window_kernel(T* __restrict__ H, T* __restrict__ Q,
              long long* __restrict__ hw, const T* __restrict__ anorm,
              const T* __restrict__ beta, long long* __restrict__ p_io,
              long long* __restrict__ nd_out, const bool* __restrict__ live,
              int w, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Ring<T> rg;
  __shared__ int s_hi;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int npad = w + 1, ld = window_ld(npad);
  T* hs = (T*)smem;
  T* qs = hs + (size_t)npad * ld;
  T* sS = qs + (size_t)w * ld;
  T* sP = sS + npad;
  int* srun = (int*)(sP + npad);
  int* sflag = srun + npad;
  T* Hg = H + (size_t)blockIdx.x * npad * npad;
  T* Qg = Q + (size_t)blockIdx.x * w * npad;

  for (int e = tid; e < npad * npad; e += 64) {
    const int r = e / npad;
    hs[r * ld + e - r * npad] = Hg[e];
  }
  for (int e = tid; e < w * npad; e += 64) {
    const int r = e / npad;
    qs[r * ld + e - r * npad] = Qg[e];
  }
  if (tid == 0) rg.pub = rg.cons = 0;
  __syncthreads();
  if (warp == 0) {
    int hi = (int)hw[blockIdx.x];
    int stg = 0, seq = 0;
    const T ea = mul(eps(T(0)), anorm[blockIdx.x]);
    unsigned mh = 0, steps = 0;
    for (int e = lane; e < npad * npad; e += 32) {
      const int r = e / npad;
      mh = max(mh, mag_key(hs[r * ld + e - r * npad]));
    }
    mh = __reduce_max_sync(FULL, mh);
    if (*live) {
      // the plain version sweeps every lane while any is live
      for (int it = 0; it < 2 * w; ++it) {
        window_sweep<T, NPL>(hs, sS, sP, srun, sflag, rg, seq, npad, ld,
                             lane, ea, hi, stg, mh, steps);
        if (hi < 1) break;
      }
    }
    publish(rg, seq, 0, STEP_END, T(0), T(0), T(0), T(0), T(0), T(0), lane);
    if (lane == 0) {
      s_hi = hi;
      atomicAdd(&g_window_live_steps, (unsigned long long)steps);
    }
  } else {
    q_worker<T, NPL>(qs, rg, w, npad, ld, lane);
  }
  __syncthreads();
  const int hi = s_hi;
  if (tid == 0) {
    int p = (int)p_io[blockIdx.x];
    nd_out[blockIdx.x] = trailing_deflation(hs, qs, w, ld, hi,
                                            beta[blockIdx.x], n, p);
    p_io[blockIdx.x] = p;
  }
  for (int e = tid; e < npad * npad; e += 64) {
    const int r = e / npad;
    Hg[e] = hs[r * ld + e - r * npad];
  }
  for (int e = tid; e < w * npad; e += 64) {
    const int r = e / npad;
    Qg[e] = qs[r * ld + e - r * npad];
  }
  if (tid == 0) hw[blockIdx.x] = hi;
}

template <typename T, int NPL>
int launch_npl(void* H, void* Q, void* hw, const void* anorm,
               const void* beta, void* p, void* nd, const void* live,
               int batch, int w, int n, cudaStream_t s) {
  const size_t smem = window_bytes(w, sizeof(T));
  static size_t attr_set = 48 * 1024 - RING_BYTES;  // once a size (graphs)
  if (smem > attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        window_kernel<T, NPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    attr_set = smem;
  }
  window_kernel<T, NPL><<<batch, 64, smem, s>>>(
      (T*)H, (T*)Q, (long long*)hw, (const T*)anorm, (const T*)beta,
      (long long*)p, (long long*)nd, (const bool*)live, w, n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(void* H, void* Q, void* hw, const void* anorm, const void* beta,
           void* p, void* nd, const void* live, int batch, int w, int n,
           cudaStream_t s) {
  switch ((w + 32) / 32) {   // ceil((w + 1) / 32) positions a lane
    case 1:
      return launch_npl<T, 1>(H, Q, hw, anorm, beta, p, nd, live, batch, w,
                              n, s);
    case 2:
      return launch_npl<T, 2>(H, Q, hw, anorm, beta, p, nd, live, batch, w,
                              n, s);
    case 3:
      return launch_npl<T, 3>(H, Q, hw, anorm, beta, p, nd, live, batch, w,
                              n, s);
    default:
      return launch_npl<T, 4>(H, Q, hw, anorm, beta, p, nd, live, batch, w,
                              n, s);
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory a block of the window kernel takes at window size
// w (f32 when f64 is 0); 0 past the kernel's reach (w + 1 > 128 or more
// than a block's 232,448 bytes with the ring's static shared memory).
size_t schur_window_smem_bytes(int w, int f64) {
  if (w < 1 || w + 1 > MAXPAD) return 0;
  const size_t b = window_bytes(w, f64 ? 8 : 4);
  return b + RING_BYTES > SMEM_MAX ? 0 : b;
}

// Launches the AED window solve on `stream`, in place: H [batch, w+1, w+1]
// and Q [batch, w, w+1] (contiguous, f32 when f64 is 0, else f64), hw
// [batch] int64 (each lane's bottom row; its value on exit), anorm and
// beta [batch] of H's type (the windows' norms; the entries left of them),
// p [batch] int64 (the trailing run's start; on exit its end), nd [batch]
// int64 (on exit the rows deflated), live a device bool (some lane had
// hw >= 1 on entry), n the matrix size (the deflation floor is
// tiny n / eps).  Returns the cudaError_t of the launch (0 on success), or
// cudaErrorInvalidValue past the kernel's reach.
int schur_window(void* H, void* Q, void* hw, const void* anorm,
                 const void* beta, void* p, void* nd, const void* live,
                 int batch, int w, int n, int f64, void* stream) {
  if (schur_window_smem_bytes(w, f64) == 0 || n < w)
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (f64)
    return launch<double>(H, Q, hw, anorm, beta, p, nd, live, batch, w, n, s);
  return launch<float>(H, Q, hw, anorm, beta, p, nd, live, batch, w, n, s);
}

// The steps the window kernel ran (did not skip) over its launches since
// the last reset, into the int64 device word `out`, on `stream`.
int schur_window_live_steps(void* out, void* stream) {
  return (int)cudaMemcpyFromSymbolAsync(
      out, g_window_live_steps, sizeof(unsigned long long), 0,
      cudaMemcpyDeviceToDevice, (cudaStream_t)stream);
}

// Sets the count of steps run back to 0, on `stream`.
int schur_window_live_reset(void* stream) {
  void* addr = nullptr;
  const cudaError_t err = cudaGetSymbolAddress(&addr, g_window_live_steps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemsetAsync(addr, 0, sizeof(unsigned long long),
                              (cudaStream_t)stream);
}

// Registers a thread, local (spill) bytes a thread, the dynamic shared
// memory and the resident blocks an SM of the kernel at window size w,
// into out[0..3].  Returns the cudaError_t.
int schur_window_attributes(int w, int f64, int* out) {
  const int npl = (w + 32) / 32;
  const void* fn = nullptr;
  if (f64)
    fn = npl == 1   ? (const void*)window_kernel<double, 1>
         : npl == 2 ? (const void*)window_kernel<double, 2>
         : npl == 3 ? (const void*)window_kernel<double, 3>
                    : (const void*)window_kernel<double, 4>;
  else
    fn = npl == 1   ? (const void*)window_kernel<float, 1>
         : npl == 2 ? (const void*)window_kernel<float, 2>
         : npl == 3 ? (const void*)window_kernel<float, 3>
                    : (const void*)window_kernel<float, 4>;
  const size_t smem = schur_window_smem_bytes(w, f64);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)smem;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], fn, 64,
                                                            smem);
}

}  // extern "C"
