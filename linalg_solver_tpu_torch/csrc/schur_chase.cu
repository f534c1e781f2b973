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
// Two variants, chosen by shape (`chase_variant`; Python
// `schur_chase.variant`).  Each step is a chain of dependent phases (the
// reflectors, the rows, the columns) over a few KB: the chase is bound by
// latency, not by bytes (a sweep reads and writes H once: 0.005 ms at
// [32, 257, 257]) or operations.
//
// Variant 0, device memory: one block of 256 threads a matrix, the matrix
// in device memory (257 x 257 f32 is 264 KB, past a block's shared
// memory; a batch of 32 is 8.4 MB, resident in the 50 MB L2).  A step:
// the live bulges' reflectors (one thread each, from values no other
// bulge of the step touches: supports are 3 apart), a barrier, the row
// updates of all of them (threads over (bulge, column), coalesced), a
// barrier, the tails, a barrier, the column updates of H and Q (threads
// over (bulge, row)), a barrier.  Rows before columns for every bulge at
// once is the reference's per-bulge sequence up to the rounding of the
// entries where one bulge's rows cross another's columns.
//
// Variant 1, a cluster's shared memory (from n = 128, where it beat
// variant 0 on the H100): a cluster of CS blocks of 1024 threads a matrix
// holds H in the blocks' joint shared memory for the whole sweep, block r
// owning rows [rR, rR + R) (R = ceil((n+1)/CS); CS = 2 where half of H
// fits a block, f32 to n = 256 at 130 KB, so 32 matrices run as one wave
// of 64 blocks; else 4).  A step: the block that owns a bulge's first row
// forms its reflector (reading the rows below through distributed shared
// memory) and writes it into every block of the cluster; a block barrier;
// the owner updates the bulge's three rows over all columns, the tail
// zeroed in the same pass; a cluster barrier; every block updates columns
// p..p+2 of its own rows of H (no remote access); a cluster barrier.
// Three barriers a step, where variant 0 has four, and H's accesses in
// shared memory; steps with no live bulge are skipped.  A cluster barrier
// with release semantics costs ~0.76 us on the H100 (a relaxed one ~0.16,
// tools/cluster_barriers.cu), and a release waits for the thread's
// outstanding device-memory stores: so Q stays in device memory, its rows
// split as H's, each row updated by one of 128 threads of the block that
// take no part in H's phases and pass the barriers with relaxed arrivals
// (nothing in the sweep reads Q back but the thread that wrote it).

// Arithmetic: every product, sum and difference rounded on its own (no
// contraction), in the plain version's order (schur_rn.cuh), so that both
// variants agree with it to the bit (a chase through nearly deflated
// subdiagonals amplifies a rounding's difference by orders of magnitude).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "schur_rn.cuh"

namespace {

using namespace schur_rn;

constexpr int NT = 256;
constexpr int MAXB = 64;        // bulges a step: nc + 1 <= 64
constexpr int CNT = 1024;       // variant 1: threads a block
constexpr int N_CLUSTER_MIN = 128;  // variant 1 from this n (H100)
constexpr size_t SMEM_MAX = 232448;

// The reflector of the bulge at row p (table entry t): v, beta v, whether
// it changes anything (beta != 0) and whether it zeroes its tail.
// `at(r, c)` reads H[r, c].
template <typename T, typename At>
SCHUR_DEV void reflector(At at, int p, size_t t, const uint8_t* act,
                         const uint8_t* cre, const uint8_t* chs,
                         const uint8_t* zcut, const T* S, const T* P, T* v,
                         T* bv, int& applies, int& chases) {
  const int live = act[t];
  T x = 0, y = 0, z = 0;
  if (live) {
    if (cre[t]) {
      const T s = S[t], pp = P[t];
      const T a00 = at(p, p), a01 = at(p, p + 1);
      const T a10 = at(p + 1, p), a11 = at(p + 1, p + 1);
      const T a21 = at(p + 2, p + 1);
      x = add(sub(add(mul(a00, a00), mul(a01, a10)), mul(s, a00)), pp);
      y = mul(a10, sub(add(a00, a11), s));
      z = mul(a10, a21);
    } else {
      x = at(p, p - 1);
      y = at(p + 1, p - 1);
      z = at(p + 2, p - 1);
    }
    if (zcut[t]) z = 0;
  }
  const T nrm = sqr(add(add(mul(x, x), mul(y, y)), mul(z, z)));
  const T v0 = add(x, mul(x < 0 ? T(-1) : T(1), nrm));
  const T vn2 = add(add(mul(v0, v0), mul(y, y)), mul(z, z));
  const T beta = (live && vn2 >= tiny(vn2)) ? two_over(vn2) : T(0);
  v[0] = v0; v[1] = y; v[2] = z;
  bv[0] = mul(beta, v0); bv[1] = mul(beta, y); bv[2] = mul(beta, z);
  applies = live && beta != T(0);     // beta = 0 leaves H as it is
  chases = live && chs[t];
}

// One step of the bulges at positions p0, p0 + 3, ... (table rows r0,
// r0 + 1, ...): reflectors, row updates, tails, column updates, each
// phase behind a barrier.
template <typename T>
SCHUR_DEV void chase_group(
    T* h, T* q, const uint8_t* act, const uint8_t* cre, const uint8_t* chs,
    const uint8_t* zcut, const T* S, const T* P, int npad, int nq, int p0,
    int r0, int nb, T (*sv)[3], T (*sbv)[3], int* slive, int* schase) {
  const int tid = threadIdx.x;
  auto at = [&](int r, int c) { return h[(size_t)r * npad + c]; };
  for (int j = tid; j < nb; j += NT) {
    const int p = p0 + 3 * j;
    reflector(at, p, (size_t)(r0 + j) * npad + p, act, cre, chs, zcut, S, P,
              sv[j], sbv[j], slive[j], schase[j]);
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

// variant 1's clusters: CS blocks, each owning ceil((n+1)/CS) rows of H
template <int CS>
__host__ __device__ inline int rows_per(int rows) {
  return (rows + CS - 1) / CS;
}
// variant 1's dynamic shared memory a block: its rows of H and a live flag
// a chase step (for up to MAXB bulges)
template <int CS>
__host__ __device__ inline size_t cluster_bytes(int n, int esize) {
  const size_t b = (size_t)rows_per<CS>(n + 1) * (n + 1) * esize
                   + (size_t)(n + 3 * (MAXB - 1));
  return (b + 15) & ~(size_t)15;
}

template <typename T>
struct Reflectors {     // a step's reflectors, in every block of a cluster
  T v[MAXB][3];
  T bv[MAXB][3];
  int applies[MAXB];
  int chases[MAXB];
};

// variant 1's cluster size at n: 2, or 4 where half of H does not fit a
// block; 0 where a quarter does not either
inline int cluster_size(int n, int f64) {
  const int esize = f64 ? 8 : 4;
  const size_t fixed = f64 ? sizeof(Reflectors<double>)
                           : sizeof(Reflectors<float>);
  if (cluster_bytes<2>(n, esize) + fixed <= SMEM_MAX) return 2;
  if (cluster_bytes<4>(n, esize) + fixed <= SMEM_MAX) return 4;
  return 0;
}

// With Q, the last NQT threads of a block update Q's rows (in device
// memory) and take no part in H's phases: they arrive at the cluster
// barriers without release semantics, so that no barrier waits for their
// stores (nothing in the sweep reads Q back but the thread that wrote
// it); each owns whole rows, and loads its first row's entries of a step
// before the step's barriers.
constexpr int NQT = 128;
constexpr int QJB = 8;      // bulges whose Q entries are loaded ahead

SCHUR_DEV void arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
SCHUR_DEV void arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
SCHUR_DEV void wait_acquire() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One step of variant 1 (see the file's header): this block (`rank`) holds
// H's rows [rank R, rank R + hrows) in hs and updates Q's rows qg[0 ..
// qrows); hb[r] is block r's hs, rb[r] its reflectors; nh threads work on
// H (all of them without Q).
template <typename T, int CS>
SCHUR_DEV void cluster_group(
    T* hs, T* qg, T* const* hb, Reflectors<T>* const* rb, Reflectors<T>& rf,
    const uint8_t* act, const uint8_t* cre, const uint8_t* chs,
    const uint8_t* zcut, const T* S, const T* P, int npad, int R, int rank,
    int hrows, int qrows, int nh, int p0, int r0, int nb) {
  const int tid = threadIdx.x;
  auto col = [&](T* r, int j, T c0, T c1, T c2) {
    const T cv = add(add(mul(c0, rf.v[j][0]), mul(c1, rf.v[j][1])),
                     mul(c2, rf.v[j][2]));
    r[0] = sub(c0, mul(cv, rf.bv[j][0]));
    r[1] = sub(c1, mul(cv, rf.bv[j][1]));
    r[2] = sub(c2, mul(cv, rf.bv[j][2]));
  };

  if (tid >= nh) {
    // Q's rows qt, qt + NQT, ...: columns p..p+2 of each bulge
    const int qt = tid - nh;
    T pre[QJB][3];
#pragma unroll
    for (int j = 0; j < QJB; ++j) {
      if (j < nb && qt < qrows) {
        const T* r = qg + (size_t)qt * npad + p0 + 3 * j;
        pre[j][0] = r[0]; pre[j][1] = r[1]; pre[j][2] = r[2];
      }
    }
    arrive_relaxed();
    wait_acquire();   // the step's reflectors are in place
    if (qt < qrows) {
#pragma unroll
      for (int j = 0; j < QJB; ++j) {
        if (j < nb && rf.applies[j])
          col(qg + (size_t)qt * npad + p0 + 3 * j, j, pre[j][0], pre[j][1],
              pre[j][2]);
      }
      for (int j = QJB; j < nb; ++j) {
        if (!rf.applies[j]) continue;
        T* r = qg + (size_t)qt * npad + p0 + 3 * j;
        col(r, j, r[0], r[1], r[2]);
      }
    }
    for (int i = qt + NQT; i < qrows; i += NQT) {
      for (int j = 0; j < nb; ++j) {
        if (!rf.applies[j]) continue;
        T* r = qg + (size_t)i * npad + p0 + 3 * j;
        col(r, j, r[0], r[1], r[2]);
      }
    }
    arrive_relaxed();
    wait_acquire();
    return;
  }

  const int hr0 = rank * R;
  auto ptr = [&](int r, int c) {
    int blk = 0;
#pragma unroll
    for (int i = 1; i < CS; ++i) blk += r >= i * R;
    return hb[blk] + (size_t)(r - blk * R) * npad + c;
  };
  auto at = [&](int r, int c) { return *ptr(r, c); };

  // the reflectors of the bulges whose first row this block owns, into
  // every block of the cluster
  for (int j = tid; j < nb; j += nh) {
    const int p = p0 + 3 * j;
    if (p < hr0 || p >= hr0 + R) continue;
    T v[3], bv[3];
    int applies, chases;
    reflector(at, p, (size_t)(r0 + j) * npad + p, act, cre, chs, zcut, S, P,
              v, bv, applies, chases);
    for (int r = 0; r < CS; ++r) {
      Reflectors<T>* d = rb[r];
      for (int i = 0; i < 3; ++i) {
        d->v[j][i] = v[i];
        d->bv[j][i] = bv[i];
      }
      d->applies[j] = applies;
      d->chases[j] = chases;
    }
  }
  // the H threads' barrier (named barrier 1)
  asm volatile("bar.sync 1, %0;\n" ::"r"(nh) : "memory");

  // rows p..p+2 of the owned bulges, full width, the tail in column p - 1
  // zeroed in the same pass
  const int j_lo = max(0, (hr0 - p0 + 2) / 3);
  const int last = hr0 + hrows - 1 - p0;
  const int j_hi = min(nb - 1, last < 0 ? -1 : last / 3);
  const int nown = j_hi - j_lo + 1;
  for (int e = tid; e < nown * npad; e += nh) {
    const int jj = e / npad, c = e - jj * npad;
    const int j = j_lo + jj;
    const int p = p0 + 3 * j;
    T* r0p = ptr(p, c);
    T* r1p = ptr(p + 1, c);
    T* r2p = ptr(p + 2, c);
    const bool tail = p > 0 && c == p - 1 && rf.chases[j];
    if (!rf.applies[j]) {
      if (tail) { *r1p = 0; *r2p = 0; }
      continue;
    }
    const T h0 = *r0p, h1 = *r1p, h2 = *r2p;
    const T vr = add(add(mul(rf.v[j][0], h0), mul(rf.v[j][1], h1)),
                     mul(rf.v[j][2], h2));
    *r0p = sub(h0, mul(rf.bv[j][0], vr));
    *r1p = tail ? T(0) : sub(h1, mul(rf.bv[j][1], vr));
    *r2p = tail ? T(0) : sub(h2, mul(rf.bv[j][2], vr));
  }
  arrive_release();
  wait_acquire();

  // columns p..p+2 of this block's rows of H
  for (int e = tid; e < nb * hrows; e += nh) {
    const int j = e / hrows, i = e - j * hrows;
    if (!rf.applies[j]) continue;
    T* r = hs + (size_t)i * npad + p0 + 3 * j;
    col(r, j, r[0], r[1], r[2]);
  }
  arrive_release();
  wait_acquire();
}

template <typename T, int CS>
__global__ void __launch_bounds__(CNT, 1)
chase_cluster_kernel(T* __restrict__ H, T* __restrict__ Q,
                     const uint8_t* __restrict__ act,
                     const uint8_t* __restrict__ cre,
                     const uint8_t* __restrict__ chs,
                     const uint8_t* __restrict__ zcut,
                     const T* __restrict__ S, const T* __restrict__ P,
                     int n, int nc, int nq) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Reflectors<T> rf;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int m = blockIdx.x / CS;
  const int tid = threadIdx.x;
  const int npad = n + 1;
  const int R = rows_per<CS>(npad), RQ = rows_per<CS>(nq);
  const int hr0 = rank * R, hrows = max(0, min(npad, hr0 + R) - hr0);
  const int qr0 = rank * RQ;
  const int qrows = Q ? max(0, min(nq, qr0 + RQ) - qr0) : 0;
  const int nh = Q ? CNT - NQT : CNT;   // threads on H
  T* hs = (T*)smem;
  uint8_t* step_live = (uint8_t*)(hs + (size_t)R * npad);
  T* hb[CS];
  Reflectors<T>* rb[CS];
  for (int r = 0; r < CS; ++r) {
    hb[r] = cluster.map_shared_rank(hs, r);
    rb[r] = cluster.map_shared_rank(&rf, r);
  }
  const size_t toff = (size_t)m * (nc + 1) * npad;
  T* h = H + (size_t)m * npad * npad + (size_t)hr0 * npad;
  T* qg = Q ? Q + (size_t)m * nq * npad + (size_t)qr0 * npad : nullptr;
  act += toff; cre += toff; chs += toff; zcut += toff; S += toff; P += toff;

  for (int e = tid; e < hrows * npad; e += CNT) hs[e] = h[e];
  const int nsteps = max(n - 1 + 3 * nc, 1);
  for (int k = tid; k < nsteps; k += CNT) step_live[k] = 0;
  __syncthreads();
  // step k moves bulge i = nc - r from position k - 3i: the live steps
  for (int e = tid; e < (nc + 1) * npad; e += CNT) {
    if (!act[e]) continue;
    const int r = e / npad;
    const int k = e - r * npad + 3 * (nc - r);
    if (k < nsteps) step_live[k] = 1;
  }
  cluster.sync();   // every block's rows are in place

  for (int k = 0; k < nsteps; ++k) {
    if (!step_live[k]) continue;   // the same in every block
    const int over = k - (n - 2);
    const int i_lo = over > 0 ? (over + 2) / 3 : 0;
    const int i_hi = min(nc, k / 3);
    if (i_lo > i_hi) continue;
    const int nb = i_hi - i_lo + 1;
    const int p0 = k - 3 * i_hi;
    const int r0 = nc - i_hi;
    if (p0 == 0 && nb > 1) {
      cluster_group<T, CS>(hs, qg, hb, rb, rf, act, cre, chs, zcut, S, P,
                           npad, R, rank, hrows, qrows, nh, 0, r0, 1);
      cluster_group<T, CS>(hs, qg, hb, rb, rf, act, cre, chs, zcut, S, P,
                           npad, R, rank, hrows, qrows, nh, 3, r0 + 1,
                           nb - 1);
    } else {
      cluster_group<T, CS>(hs, qg, hb, rb, rf, act, cre, chs, zcut, S, P,
                           npad, R, rank, hrows, qrows, nh, p0, r0, nb);
    }
  }
  // every group ended with a cluster barrier: no block reads or writes
  // these rows any more
  for (int e = tid; e < hrows * npad; e += CNT) h[e] = hs[e];
}

int variant_of(int n, int f64) {
  return n >= N_CLUSTER_MIN && cluster_size(n, f64) ? 1 : 0;
}

// raise variant 1's dynamic shared memory limit to `smem` (never lower
// it: a sweep's CUDA graph holds launches of the larger size)
template <typename T, int CS>
cudaError_t cluster_smem_limit(size_t smem) {
  static size_t set = 48 * 1024;
  if (smem <= set) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      chase_cluster_kernel<T, CS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) set = smem;
  return err;
}

template <int CS>
cudaLaunchConfig_t cluster_config(int batch, size_t smem, cudaStream_t s,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CS * batch);
  cfg.blockDim = dim3(CNT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T, int CS>
int launch_cluster(void* H, void* Q, const void* act, const void* cre,
                   const void* chs, const void* zcut, const void* S,
                   const void* P, int batch, int n, int nc, int nq,
                   cudaStream_t s) {
  const size_t smem = cluster_bytes<CS>(n, sizeof(T));
  cudaError_t err = cluster_smem_limit<T, CS>(smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config<CS>(batch, smem, s, attr);
  err = cudaLaunchKernelEx(&cfg, chase_cluster_kernel<T, CS>, (T*)H, (T*)Q,
                           (const uint8_t*)act, (const uint8_t*)cre,
                           (const uint8_t*)chs, (const uint8_t*)zcut,
                           (const T*)S, (const T*)P, n, nc, Q ? nq : 0);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch(void* H, void* Q, const void* act, const void* cre,
           const void* chs, const void* zcut, const void* S, const void* P,
           int batch, int n, int nc, int nq, int variant, int cs,
           cudaStream_t s) {
  if (variant == 0) {
    chase_kernel<T><<<batch, NT, 0, s>>>(
        (T*)H, (T*)Q, (const uint8_t*)act, (const uint8_t*)cre,
        (const uint8_t*)chs, (const uint8_t*)zcut, (const T*)S,
        (const T*)P, n, nc, nq);
    return (int)cudaGetLastError();
  }
  if (cs == 2)
    return launch_cluster<T, 2>(H, Q, act, cre, chs, zcut, S, P, batch, n,
                                nc, nq, s);
  return launch_cluster<T, 4>(H, Q, act, cre, chs, zcut, S, P, batch, n, nc,
                              nq, s);
}

template <typename T, int CS>
int max_clusters(int n) {
  const size_t smem = cluster_bytes<CS>(n, sizeof(T));
  cudaError_t err = cluster_smem_limit<T, CS>(smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config<CS>(32, smem, 0, attr);
  int count = 0;
  err = cudaOccupancyMaxActiveClusters(&count, chase_cluster_kernel<T, CS>,
                                       &cfg);
  return err == cudaSuccess ? count : -(int)err;
}

}  // namespace

extern "C" {

// The chase variant the launch takes at n (f32 when f64 is 0): 1 (a
// cluster's shared memory) from n = N_CLUSTER_MIN where a quarter of H
// fits a block, else 0 (device memory).
int chase_variant(int n, int f64) { return variant_of(n, f64); }

// Variant 1's blocks a cluster at n (2 or 4; 0: variant 1 does not take
// n) and its dynamic shared memory a block.
int chase_cluster_size(int n, int f64) { return cluster_size(n, f64); }
size_t chase_cluster_smem_bytes(int n, int f64) {
  const int cs = cluster_size(n, f64), esize = f64 ? 8 : 4;
  return cs == 2 ? cluster_bytes<2>(n, esize)
                 : cs == 4 ? cluster_bytes<4>(n, esize) : 0;
}

// How many of variant 1's clusters the card runs at once at n
// (cudaOccupancyMaxActiveClusters; minus a cudaError_t on failure).
int chase_clusters(int n, int f64) {
  const int cs = cluster_size(n, f64);
  if (cs == 0) return 0;
  if (f64)
    return cs == 2 ? max_clusters<double, 2>(n) : max_clusters<double, 4>(n);
  return cs == 2 ? max_clusters<float, 2>(n) : max_clusters<float, 4>(n);
}

// Launches the chase on `stream`, in place on H [batch, n+1, n+1] and, when
// Q is not null, Q [batch, nq, n+1] (contiguous, f32 when `f64` is 0, else
// f64).  Tables [batch, nc+1, n+1]: act, cre, chs, zcut one byte an entry
// (0/1), S and P of H's type.  `v` forces a variant (-1: by shape).
// Returns the cudaError_t of the launch (0 on success), or
// cudaErrorInvalidValue for n < 1, nc outside [0, 63] or a variant that
// does not take the shape.
int schur_chase(void* H, void* Q, const void* act, const void* cre,
                const void* chs, const void* zcut, const void* S,
                const void* P, int batch, int n, int nc, int nq, int f64,
                int v, void* stream) {
  if (n < 1 || nc < 0 || nc + 1 > MAXB || nq < 0)
    return (int)cudaErrorInvalidValue;
  if (v < 0) v = variant_of(n, f64);
  const int cs = cluster_size(n, f64);
  if (v > 1 || (v == 1 && cs == 0)) return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (f64)
    return launch<double>(H, Q, act, cre, chs, zcut, S, P, batch, n, nc, nq,
                          v, cs, s);
  return launch<float>(H, Q, act, cre, chs, zcut, S, P, batch, n, nc, nq, v,
                       cs, s);
}

}  // extern "C"
