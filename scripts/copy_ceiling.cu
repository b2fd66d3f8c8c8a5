// A plain copy, the ceiling a kernel of a given size can reach on the card:
// n4 float4 words from src to dst in a grid-stride loop, each thread moving
// 16 bytes per trip. scripts/kdist_probe.py builds it with the port's nvcc
// flags, launches it over the bytes a Poisson kernel moves (half read, half
// written) at several grid sizes, and prints the fastest beside the
// kernel's bound: what launch ramp and tail leave of the HBM rate at that
// size.
#include <cuda_runtime.h>

namespace {

__global__ void copy_float4_kernel(const float4* __restrict__ src,
                                   float4* __restrict__ dst, long n4) {
  const long stride = static_cast<long>(gridDim.x) * blockDim.x;
  for (long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n4; i += stride)
    dst[i] = src[i];
}

}  // namespace

extern "C" int ns3d_copy_float4(const float* src, float* dst, long n4,
                                int blocks, int threads,
                                cudaStream_t stream) {
  copy_float4_kernel<<<blocks, threads, 0, stream>>>(
      reinterpret_cast<const float4*>(src), reinterpret_cast<float4*>(dst),
      n4);
  return static_cast<int>(cudaGetLastError());
}
