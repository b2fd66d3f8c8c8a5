// Empty barrier loops, the floor a kernel pays per iteration for its
// barrier alone: n grid-wide barriers (cooperative_groups'
// this_grid().sync(), one cooperative launch) or n cluster barriers
// (this_cluster().sync(), one cluster of `cluster` blocks launched with a
// cluster-dimension attribute). scripts/k6k10_probe.py builds it with the
// port's nvcc flags and times n = 1 and n = 1 + m launches: the difference
// over m is one barrier.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

__global__ void grid_sync_loop_kernel(int n, int* sink) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < n; ++i) grid.sync();
  if (blockIdx.x == 0 && threadIdx.x == 0) *sink = n;
}

__global__ void cluster_sync_loop_kernel(int n, int* sink) {
  cg::cluster_group cluster = cg::this_cluster();
  for (int i = 0; i < n; ++i) cluster.sync();
  if (blockIdx.x == 0 && threadIdx.x == 0) *sink = n;
}

}  // namespace

extern "C" int ns3d_grid_sync_loop(int n, int blocks, int threads, int* sink,
                                   cudaStream_t stream) {
  void* args[] = {&n, &sink};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(grid_sync_loop_kernel), dim3(blocks),
      dim3(threads), args, 0, stream));
}

// One cluster of `cluster` blocks of `threads` threads, each with `smem`
// bytes of dynamic shared memory (so that one block fills an SM as the
// resident kernel's blocks do). Returns the launch's error, or
// cudaErrorInvalidConfiguration where the card admits no such cluster.
extern "C" int ns3d_cluster_sync_loop(int n, int cluster, int threads,
                                      int smem, int* sink,
                                      cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      cluster_sync_loop_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
      1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(cluster_sync_loop_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, cluster_sync_loop_kernel,
                                     &cfg);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  return static_cast<int>(
      cudaLaunchKernelEx(&cfg, cluster_sync_loop_kernel, n, sink));
}
