// K1: one damped pseudo-transient Poisson iteration with the boundary
// conditions folded into the stencil.
//
// Replaces the Pallas kernel of navierstokes3d_tpu/kernels/poisson.py:914
// (build_poisson_iter(mode='blocked', folded=True): `kernel` :872,
// `compute_slab_folded` :305, `lap_of_rows_folded` :281, `resid_max` :298).
// Per interior cell, in compute_slab_folded's expression order:
//   lap   = (xp + xm) * inv_dx2 + ((yp*wyp + ym*wym)) + ((zp*wzp + zm*wzm))
//   resid = lap - rhs
//   dpr   = dpr*decay + dtau*resid              (in place, as the Pallas
//                                                kernel aliases dpr)
//   pr'   = pr + dtau*dpr                       (Jacobi: separate output)
// with (p+ - pc) neighbor differences and the y/z weight rows mask/h^2
// (0 where that neighbor is a zero-gradient copy). Boundary and frozen
// Dirichlet cells get dpr = 0 and pr' = pr + dtau*0, so EVERY cell of
// pr_out is written and two ping-pong buffers never drift apart. On a
// check iteration (err_bits non-null) the kernel also reduces the max
// |resid| over interior cells: the residual of the state ENTERING the
// iteration, which the convergence loop reads once per nchk iterations.
//
// What bounds it on this card: device-memory bytes. Each iteration reads
// pr, dpr and rhs and writes dpr and pr' once (5 x 4 B per cell, ~120 MB
// at 255x153x153) against ~20 flops per cell. The design reads each input
// once from DRAM (the +-1 neighbors of a warp's z-run hit L1/L2: the y
// and x neighbors were just read by adjacent warps and planes), keeps no
// intermediate in memory, and skips the reduction on the 151 in 152
// iterations that are not checked. Temporal blocking (several iterations
// per round trip, the TPU's K8) is later work.
#include "common.cuh"

namespace {

__global__ void poisson_iter_kernel(
    const float* __restrict__ pr, float* __restrict__ pr_out,
    float* __restrict__ dpr, const float* __restrict__ rhs,
    const float* __restrict__ wyp, const float* __restrict__ wym,
    const float* __restrict__ wzp, const float* __restrict__ wzm,
    float inv_dx2, float dtau, float decay, int nx, int ny, int nz,
    unsigned int* __restrict__ err_bits) {
  const int z = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int x = blockIdx.z;
  unsigned int bits = 0u;
  if (y < ny && z < nz) {
    const long i = (static_cast<long>(x) * ny + y) * nz + z;
    const float pc = pr[i];
    if (x >= 1 && x <= nx - 2 && y >= 1 && y <= ny - 2 && z >= 1 &&
        z <= nz - 2) {
      const long sx = static_cast<long>(ny) * nz;
      const float xp = pr[i + sx] - pc;
      const float xm = pr[i - sx] - pc;
      float lap = (xp + xm) * inv_dx2;
      lap = lap + ((pr[i + nz] - pc) * wyp[y] + (pr[i - nz] - pc) * wym[y]);
      lap = lap + ((pr[i + 1] - pc) * wzp[z] + (pr[i - 1] - pc) * wzm[z]);
      const float resid = lap - rhs[i];
      const float d = dpr[i] * decay + dtau * resid;
      dpr[i] = d;
      pr_out[i] = pc + dtau * d;
      bits = __float_as_uint(fabsf(resid));
    } else {
      dpr[i] = 0.0f;
      pr_out[i] = pc + dtau * 0.0f;
    }
  }
  if (err_bits != nullptr) ns3d::block_max_to(bits, err_bits);
}

}  // namespace

extern "C" int ns3d_poisson_iter(const float* pr, float* pr_out, float* dpr,
                                 const float* rhs, const float* wyp,
                                 const float* wym, const float* wzp,
                                 const float* wzm, float inv_dx2, float dtau,
                                 float decay, int nx, int ny, int nz,
                                 unsigned int* err_bits,
                                 cudaStream_t stream) {
  const dim3 grid = ns3d::grid_for(nx, ny, nz);
  const dim3 block = ns3d::block_shape();
  poisson_iter_kernel<<<grid, block, 0, stream>>>(pr, pr_out, dpr, rhs, wyp, wym, wzp, wzm, inv_dx2, dtau, decay, nx, ny, nz, err_bits);
  return static_cast<int>(cudaGetLastError());
}
