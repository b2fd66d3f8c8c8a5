// K1: one damped pseudo-transient Poisson iteration with the boundary
// conditions folded into the stencil, and K2: the same iteration on a
// double-single (hi, lo) pressure pair.
//
// K1 replaces the Pallas kernel of navierstokes3d_tpu/kernels/poisson.py:914
// (build_poisson_iter(mode='blocked', folded=True): `kernel` :872,
// `compute_slab_folded` :305, `lap_of_rows_folded` :281, `resid_max` :298).
// Per interior cell, in compute_slab_folded's expression order:
//   lap   = (xp + xm) * inv_dx2 + ((yp*wyp + ym*wym)) + ((zp*wzp + zm*wzm))
//   resid = lap - rhs
//   dpr   = dpr*decay + dtau*resid              (in place, as the Pallas
//                                                kernel aliases dpr)
//   pr'   = pr + dtau*dpr                       (Jacobi: separate output)
// with (p+ - pc) neighbor differences and the y/z weight rows mask/h^2
// (0 where that neighbor is a zero-gradient copy). Where x-lo is
// zero-gradient (zero_grad_x, the multi variant) xm is REPLACED by 0 at
// x == 1, a select as in the Pallas kernel (:289-290): a weight multiply
// would round differently. Boundary and frozen Dirichlet cells get dpr = 0
// and pr' = pr + dtau*0, so EVERY cell of pr_out is written and two
// ping-pong buffers never drift apart. On a check iteration (err_bits
// non-null) the kernel also reduces the max |resid| over interior cells:
// the residual of the state ENTERING the iteration, which the convergence
// loop reads once per nchk iterations.
//
// K2 replaces the Pallas kernel of navierstokes3d_tpu/kernels/poisson.py:1230
// (build_poisson_iter(extended=True, folded=True): `kernel` :1190,
// `compute_slab_ext_folded` :317). The same Laplacian is taken of hi and of
// lo, then
//   resid = (lap_h - rhs) + lap_l
//   d     = dpr*decay + dtau*resid              (0 off the interior)
//   u     = lo + dtau*d
//   (hi', lo') = two_sum(hi, u):  s = hi + u; ap = s - u; bp = s - ap;
//                                 lo' = (hi - ap) + (u - bp); hi' = s
// on EVERY cell: off the interior d = 0 and the two_sum renormalizes the
// pair (hi absorbs lo), the JAX docstring's rule (:319-321). two_sum is an
// error-free transform only when each operation rounds on its own: the
// library is built with --fmad=false and without fast-math, and nvcc does
// not reassociate float arithmetic.
//
// What bounds them on this card: device-memory bytes. K1 reads pr, dpr and
// rhs and writes dpr and pr' (5 x 4 B per cell, ~120 MB at 255x153x153);
// K2 reads hi, lo, dpr and rhs and writes hi', lo' and dpr (7 x 4 B per
// cell, ~167 MB), against ~20 (K1) and ~45 (K2) flops per cell. The design
// reads each input once from DRAM (the +-1 neighbors of a warp's z-run hit
// L1/L2: the y and x neighbors were just read by adjacent warps and
// planes), keeps no intermediate in memory, and skips the reduction on the
// iterations that are not checked. Temporal blocking (several iterations
// per round trip, the TPU's K8) is later work.
#include "common.cuh"

namespace {

struct Weights {
  const float* yp;
  const float* ym;
  const float* zp;
  const float* zm;
};

// The folded Laplacian of p at interior cell i = (x, y, z) in
// lap_of_rows_folded's order; pc = p[i].
__device__ inline float lap_folded(const float* __restrict__ p, long i,
                                   long sx, int nz, int y, int z, float pc,
                                   bool drop_xm, float inv_dx2,
                                   const Weights& w) {
  const float xp = p[i + sx] - pc;
  const float xm = drop_xm ? 0.0f : p[i - sx] - pc;
  float lap = (xp + xm) * inv_dx2;
  lap = lap + ((p[i + nz] - pc) * w.yp[y] + (p[i - nz] - pc) * w.ym[y]);
  lap = lap + ((p[i + 1] - pc) * w.zp[z] + (p[i - 1] - pc) * w.zm[z]);
  return lap;
}

__device__ inline bool interior(int x, int y, int z, int nx, int ny,
                                int nz) {
  return x >= 1 && x <= nx - 2 && y >= 1 && y <= ny - 2 && z >= 1 &&
         z <= nz - 2;
}

__global__ void poisson_iter_kernel(
    const float* __restrict__ pr, float* __restrict__ pr_out,
    float* __restrict__ dpr, const float* __restrict__ rhs, Weights w,
    float inv_dx2, float dtau, float decay, int zero_grad_x, int nx, int ny,
    int nz, unsigned int* __restrict__ err_bits) {
  const int z = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int x = blockIdx.z;
  unsigned int bits = 0u;
  if (y < ny && z < nz) {
    const long i = (static_cast<long>(x) * ny + y) * nz + z;
    const float pc = pr[i];
    if (interior(x, y, z, nx, ny, nz)) {
      const long sx = static_cast<long>(ny) * nz;
      const float lap = lap_folded(pr, i, sx, nz, y, z, pc,
                                   zero_grad_x && x == 1, inv_dx2, w);
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

__global__ void poisson_iter_ext_kernel(
    const float* __restrict__ hi, const float* __restrict__ lo,
    float* __restrict__ hi_out, float* __restrict__ lo_out,
    float* __restrict__ dpr, const float* __restrict__ rhs, Weights w,
    float inv_dx2, float dtau, float decay, int zero_grad_x, int nx, int ny,
    int nz, unsigned int* __restrict__ err_bits) {
  const int z = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int x = blockIdx.z;
  unsigned int bits = 0u;
  if (y < ny && z < nz) {
    const long i = (static_cast<long>(x) * ny + y) * nz + z;
    const float hc = hi[i];
    const float lc = lo[i];
    float d = 0.0f;
    if (interior(x, y, z, nx, ny, nz)) {
      const long sx = static_cast<long>(ny) * nz;
      const bool drop_xm = zero_grad_x && x == 1;
      const float lap_h = lap_folded(hi, i, sx, nz, y, z, hc, drop_xm,
                                     inv_dx2, w);
      const float lap_l = lap_folded(lo, i, sx, nz, y, z, lc, drop_xm,
                                     inv_dx2, w);
      const float resid = (lap_h - rhs[i]) + lap_l;
      d = dpr[i] * decay + dtau * resid;
      bits = __float_as_uint(fabsf(resid));
    }
    dpr[i] = d;
    const float u = lc + dtau * d;
    const float s = hc + u;
    const float ap = s - u;
    const float bp = s - ap;
    hi_out[i] = s;
    lo_out[i] = (hc - ap) + (u - bp);
  }
  if (err_bits != nullptr) ns3d::block_max_to(bits, err_bits);
}

}  // namespace

extern "C" int ns3d_poisson_iter(const float* pr, float* pr_out, float* dpr,
                                 const float* rhs, const float* wyp,
                                 const float* wym, const float* wzp,
                                 const float* wzm, float inv_dx2, float dtau,
                                 float decay, int zero_grad_x, int nx, int ny,
                                 int nz, unsigned int* err_bits,
                                 cudaStream_t stream) {
  const dim3 grid = ns3d::grid_for(nx, ny, nz);
  const dim3 block = ns3d::block_shape();
  const Weights w{wyp, wym, wzp, wzm};
  poisson_iter_kernel<<<grid, block, 0, stream>>>(pr, pr_out, dpr, rhs, w, inv_dx2, dtau, decay, zero_grad_x, nx, ny, nz, err_bits);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ns3d_poisson_iter_ext(const float* hi, const float* lo,
                                     float* hi_out, float* lo_out,
                                     float* dpr, const float* rhs,
                                     const float* wyp, const float* wym,
                                     const float* wzp, const float* wzm,
                                     float inv_dx2, float dtau, float decay,
                                     int zero_grad_x, int nx, int ny, int nz,
                                     unsigned int* err_bits,
                                     cudaStream_t stream) {
  const dim3 grid = ns3d::grid_for(nx, ny, nz);
  const dim3 block = ns3d::block_shape();
  const Weights w{wyp, wym, wzp, wzm};
  poisson_iter_ext_kernel<<<grid, block, 0, stream>>>(hi, lo, hi_out, lo_out, dpr, rhs, w, inv_dx2, dtau, decay, zero_grad_x, nx, ny, nz, err_bits);
  return static_cast<int>(cudaGetLastError());
}
