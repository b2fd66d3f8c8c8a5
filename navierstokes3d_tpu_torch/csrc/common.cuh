// Shared launch shape and block reductions of the port's CUDA kernels.
//
// Every kernel runs one thread per output cell of a canonical 3D field
// (x slowest, z fastest): threadIdx.x walks z so that a warp reads
// consecutive addresses, threadIdx.y walks y, and blockIdx.z is the x
// plane. The block reductions run once per block and are off the hot
// path (the Poisson kernel reduces only on check iterations, one in nchk).
//
// Below them: the asynchronous copy K3 and K8 stream their planes with (a
// 4-byte cp.async, commit and wait), each behind a small function so that
// a host rehearsal of the kernels can map the copy onto a memcpy and the
// group operations onto no-ops.
#pragma once

#include <cuda_runtime.h>

namespace ns3d {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kBlockThreads = kBlockX * kBlockY;

// Grid covering an (n0, n1, n2) index space with (x, y, z) = (z-index,
// y-index, x-plane).
inline dim3 grid_for(int n0, int n1, int n2) {
  return dim3((n2 + kBlockX - 1) / kBlockX, (n1 + kBlockY - 1) / kBlockY,
              n0);
}

inline dim3 block_shape() { return dim3(kBlockX, kBlockY, 1); }

__device__ inline int thread_rank() {
  return threadIdx.x + blockDim.x * threadIdx.y;
}

constexpr int kWarps = kBlockThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;

// Block reductions: a warp-shuffle reduction within each warp, the warp
// results through shared memory, a shuffle reduction of those in warp 0,
// then ONE atomic per block into the device scalar (which the caller
// zeroes). Every thread of the block must call them: the shuffles use the
// full warp mask.

__device__ inline unsigned int warp_max(unsigned int v) {
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned int u = __shfl_down_sync(kFullMask, v, o);
    v = v > u ? v : u;
  }
  return v;
}

__device__ inline int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFullMask, v, o);
  return v;
}

// Max of `v` over a block of kThreads threads, valid in thread 0. For the
// bit patterns of non-negative floats the unsigned order is the float
// order, and a positive NaN sorts above +inf, so a NaN propagates as
// jnp.max propagates it.
template <int kThreads>
__device__ inline unsigned int block_max(unsigned int v) {
  __shared__ unsigned int per_warp[kThreads / 32];
  const int t = thread_rank();
  v = warp_max(v);
  if ((t & 31) == 0) per_warp[t >> 5] = v;
  __syncthreads();
  if (t < 32) v = warp_max(t < kThreads / 32 ? per_warp[t] : 0u);
  return v;
}

// Max of `v` over the block into *out.
__device__ inline void block_max_to(unsigned int v, unsigned int* out) {
  v = block_max<kBlockThreads>(v);
  if (thread_rank() == 0 && v != 0u) atomicMax(out, v);
}

// Sum of `v` over the block into *out.
__device__ inline void block_sum_to(int v, int* out) {
  __shared__ int per_warp[kWarps];
  const int t = thread_rank();
  v = warp_sum(v);
  if ((t & 31) == 0) per_warp[t >> 5] = v;
  __syncthreads();
  if (t < 32) {
    v = warp_sum(t < kWarps ? per_warp[t] : 0);
    if (t == 0 && v != 0) atomicAdd(out, v);
  }
}

// ---- cp.async (Ampere and Hopper) ----

// The shared-memory address of a generic pointer into shared memory.
__device__ inline unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copy 4 bytes from global src to shared dst, asynchronously.
__device__ inline void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// Copy 4 bytes from global src to shared dst asynchronously where `full`,
// else write 4 zero bytes to dst and read nothing.
__device__ inline void cp_async4(void* dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}

// Close this thread's group of copies issued since the last commit.
__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until every group of this thread's copies has landed.
__device__ inline void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// Wait until at most the newest `pending` groups of this thread's copies
// are still in flight.
template <int pending>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(pending) : "memory");
}

}  // namespace ns3d
