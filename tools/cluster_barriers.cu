// Barrier and shared-memory latencies on the card, for the chase
// kernel's design (csrc/schur_chase.cu): __syncthreads, a cluster barrier
// with release/acquire semantics (cooperative_groups' cluster.sync(), twice
// an iteration) and without (barrier.cluster.arrive.relaxed + wait), and a
// dependent chain of loads from the block's own and from a peer block's
// shared memory, in clusters of 2 and 4.  Prints microseconds an
// iteration.  Build and run on a machine with an sm_90a card:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o /tmp/cluster_barriers \
//       tools/cluster_barriers.cu && /tmp/cluster_barriers

#include <cooperative_groups.h>

#include <cstdio>

namespace cg = cooperative_groups;

__global__ void k_sync(int iters, float* out) {
  __shared__ float s[1024];
  float acc = 0;
  for (int i = 0; i < iters; ++i) {
    s[threadIdx.x] = acc;
    __syncthreads();
    acc += s[(threadIdx.x + 1) & 1023];
  }
  if (acc == -1) out[0] = acc;
}

__global__ void k_cluster(int iters, float* out) {
  __shared__ float s[1024];
  cg::cluster_group cl = cg::this_cluster();
  float* peer = cl.map_shared_rank(s, (cl.block_rank() + 1) % cl.num_blocks());
  float acc = 0;
  for (int i = 0; i < iters; ++i) {
    s[threadIdx.x] = acc;
    cl.sync();
    acc += peer[(threadIdx.x + 1) & 1023];
    cl.sync();
  }
  if (acc == -1) out[0] = acc;
}

__global__ void k_cluster_relaxed(int iters, float* out) {
  __shared__ float s[1024];
  float acc = 0;
  for (int i = 0; i < iters; ++i) {
    s[threadIdx.x] = acc;
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    acc += s[(threadIdx.x + 1) & 1023];
  }
  if (acc == -1) out[0] = acc;
}

// one thread: dependent loads from a peer block's shared memory
__global__ void k_remote_chain(int iters, float* out) {
  __shared__ float s[1024];
  cg::cluster_group cl = cg::this_cluster();
  for (int i = threadIdx.x; i < 1024; i += blockDim.x) s[i] = 0;
  cl.sync();
  float* peer = cl.map_shared_rank(s, (cl.block_rank() + 1) % cl.num_blocks());
  float acc = 0;
  if (threadIdx.x == 0)
    for (int i = 0; i < iters; ++i) acc += peer[(int)acc & 1023];
  cl.sync();
  if (acc == -1) out[0] = acc;
}

// one thread: dependent loads from its own block's shared memory
__global__ void k_local_chain(int iters, float* out) {
  __shared__ float s[1024];
  for (int i = threadIdx.x; i < 1024; i += blockDim.x) s[i] = 0;
  __syncthreads();
  float acc = 0;
  if (threadIdx.x == 0)
    for (int i = 0; i < iters; ++i) acc += s[(int)acc & 1023];
  if (acc == -1) out[0] = acc;
}

// microseconds an iteration of `f` on `blocks` blocks in clusters of `cs`
template <typename F>
float run(F f, int cs, int blocks, int threads, int iters) {
  float* out;
  cudaMalloc(&out, 4);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, f, iters, out);   // warm-up
  cudaDeviceSynchronize();
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a);
  cudaLaunchKernelEx(&cfg, f, iters, out);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  const cudaError_t e = cudaGetLastError();
  if (e) printf("error %s\n", cudaGetErrorString(e));
  cudaFree(out);
  return ms * 1e3f / iters;
}

int main() {
  const int it = 10000;
  printf("syncthreads 1024 thr: %.3f us/iter\n",
         run(k_sync, 1, 64, 1024, it));
  for (int cs : {2, 4}) {
    printf("cluster.sync x2 cs=%d 1024 thr: %.3f us/iter\n", cs,
           run(k_cluster, cs, 64, 1024, it));
    printf("cluster relaxed cs=%d 1024 thr: %.3f us/iter\n", cs,
           run(k_cluster_relaxed, cs, 64, 1024, it));
    printf("cluster.sync x2 cs=%d 256 thr: %.3f us/iter\n", cs,
           run(k_cluster, cs, 64, 256, it));
    printf("remote load chain cs=%d: %.3f us/iter\n", cs,
           run(k_remote_chain, cs, 64, 256, it));
  }
  printf("local load chain: %.3f us/iter\n",
         run(k_local_chain, 1, 64, 256, it));
  return 0;
}
