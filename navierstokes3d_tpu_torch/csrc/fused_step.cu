// K3 (predict) and K4 (correct): the non-Poisson chain of the Chorin step.
//
// K3 replaces the Pallas kernel of navierstokes3d_tpu/kernels/fused_step.py:440
// (build_predict: `kernel` :369, `body` :280): stress tau -> predictor
// V* = V + dt/rho * div(tau) (- rho*g_eff on Vz) -> cylinder mask -> the
// divergence of the masked V*. It reads Vx/Vy/Vz and writes Vx*/Vy*/Vz*
// and divV; the six stress fields are recomputed from the velocities in
// registers and never stored.
//
// K4 replaces the Pallas kernel of navierstokes3d_tpu/kernels/fused_step.py:632
// (build_correct: `kernel` :563, `body` :500): V** = V* - dt/rho * grad p
// -> cylinder mask -> the variant's velocity BC stack. The BC stack is a
// separable clamped read (fused_step.py:40-48, `bc` :547-561):
//   gpu   (zero-gradient x/y, no-slip bottom, free-slip top;
//          NavierStokes3D_gpu.jl:264-279):
//         out(x,y,z) = 0 if z == 0, else q(cx(x), cy(y), cz_top(z));
//   multi (zero-gradient on all faces, then the inlet plane Vx = vin;
//          NavierStokes3D_multi_gpu.jl:156-166):
//         out(x,y,z) = q(cx(x), cy(y), cz(z)), and vx(0,y,z) = vin last,
// with q the CORRECTED AND MASKED value, so each thread recomputes the
// correction at its clamped source index (a read of the uncorrected input
// there would be wrong).
//
// Expression order and constant rounding follow ops/physics.py (the JAX
// functions' order; constants pre-rounded to f32 by the caller exactly as
// jnp's weak-type promotion rounds them): interior updates are ADDS of
// 0.0f elsewhere, so the boundary keeps the `x + 0.0` semantics. Built
// with --fmad=false, so `v + s*f` rounds as the plain version does.
//
// What bounds them on this card: device-memory bytes — K3 moves 7 fields
// (~170 MB at 255x153x153), K4 7 fields, against a few hundred flops per
// cell. The design reads each input once from DRAM and writes each output
// once: the neighbor values a thread recomputes (stresses at the adjacent
// edges, predicted faces at +1 for the divergence, corrected values at
// clamped BC sources) come from L1/L2, at the price of recomputing each
// stress several times. Tiling the stresses in shared memory is later work.
#include "common.cuh"

namespace {

struct Vel {
  const float* vx;  // (nx+1, ny, nz)
  const float* vy;  // (nx, ny+1, nz)
  const float* vz;  // (nx, ny, nz+1)
  int nx, ny, nz;
  __device__ float VX(int x, int y, int z) const {
    return vx[(static_cast<long>(x) * ny + y) * nz + z];
  }
  __device__ float VY(int x, int y, int z) const {
    return vy[(static_cast<long>(x) * (ny + 1) + y) * nz + z];
  }
  __device__ float VZ(int x, int y, int z) const {
    return vz[(static_cast<long>(x) * ny + y) * (nz + 1) + z];
  }
};

struct Masks {
  const unsigned char* vx;  // (nx+1, ny)
  const unsigned char* vy;  // (nx, ny+1)
  const unsigned char* vz;  // (nx, ny)
};

struct PredictConsts {
  float dx, dy, dz, mu, two_mu, three, dt_rho, rho_g;
};

// ---- K3: stresses (ops/physics.py update_tau) ----

// One normal stress component at cell (x, y, z): axis 0 -> txx, 1 -> tyy,
// 2 -> tzz.
__device__ float normal_stress(const Vel& v, const PredictConsts& c, int x,
                               int y, int z, int axis) {
  const float dvxdx = (v.VX(x + 1, y, z) - v.VX(x, y, z)) / c.dx;
  const float dvydy = (v.VY(x, y + 1, z) - v.VY(x, y, z)) / c.dy;
  const float dvzdz = (v.VZ(x, y, z + 1) - v.VZ(x, y, z)) / c.dz;
  const float th = ((dvxdx + dvydy) + dvzdz) / c.three;
  const float d = axis == 0 ? dvxdx : (axis == 1 ? dvydy : dvzdz);
  return c.two_mu * (d - th);
}

// Shear stresses at edge (e0, e1, e2) of the (nx-1, ny-1, nz-1) edge grid.
__device__ float txy(const Vel& v, const PredictConsts& c, int e0, int e1,
                     int e2) {
  return c.mu * ((v.VX(e0 + 1, e1 + 1, e2 + 1) - v.VX(e0 + 1, e1, e2 + 1)) /
                     c.dy +
                 (v.VY(e0 + 1, e1 + 1, e2 + 1) - v.VY(e0, e1 + 1, e2 + 1)) /
                     c.dx);
}

__device__ float txz(const Vel& v, const PredictConsts& c, int e0, int e1,
                     int e2) {
  return c.mu * ((v.VX(e0 + 1, e1 + 1, e2 + 1) - v.VX(e0 + 1, e1 + 1, e2)) /
                     c.dz +
                 (v.VZ(e0 + 1, e1 + 1, e2 + 1) - v.VZ(e0, e1 + 1, e2 + 1)) /
                     c.dx);
}

__device__ float tyz(const Vel& v, const PredictConsts& c, int e0, int e1,
                     int e2) {
  return c.mu * ((v.VY(e0 + 1, e1 + 1, e2 + 1) - v.VY(e0 + 1, e1 + 1, e2)) /
                     c.dz +
                 (v.VZ(e0 + 1, e1 + 1, e2 + 1) - v.VZ(e0 + 1, e1, e2 + 1)) /
                     c.dy);
}

// ---- K3: predicted + masked face velocities (ops/physics.py predict_v,
// ops/cylinder.py apply_cylinder) ----

__device__ float vx_star(const Vel& v, const Masks& m, const PredictConsts& c,
                         int X, int Y, int Z) {
  float upd = 0.0f;
  if (X >= 1 && X <= v.nx - 1 && Y >= 1 && Y <= v.ny - 2 && Z >= 1 &&
      Z <= v.nz - 2) {
    const float fx =
        ((normal_stress(v, c, X, Y, Z, 0) - normal_stress(v, c, X - 1, Y, Z, 0)) /
             c.dx +
         (txy(v, c, X - 1, Y, Z - 1) - txy(v, c, X - 1, Y - 1, Z - 1)) / c.dy) +
        (txz(v, c, X - 1, Y - 1, Z) - txz(v, c, X - 1, Y - 1, Z - 1)) / c.dz;
    upd = c.dt_rho * fx;
  }
  const float s = v.VX(X, Y, Z) + upd;
  return m.vx[static_cast<long>(X) * v.ny + Y] ? 0.0f : s;
}

__device__ float vy_star(const Vel& v, const Masks& m, const PredictConsts& c,
                         int X, int Y, int Z) {
  float upd = 0.0f;
  if (X >= 1 && X <= v.nx - 2 && Y >= 1 && Y <= v.ny - 1 && Z >= 1 &&
      Z <= v.nz - 2) {
    const float fy =
        ((normal_stress(v, c, X, Y, Z, 1) - normal_stress(v, c, X, Y - 1, Z, 1)) /
             c.dy +
         (txy(v, c, X, Y - 1, Z - 1) - txy(v, c, X - 1, Y - 1, Z - 1)) / c.dx) +
        (tyz(v, c, X - 1, Y - 1, Z) - tyz(v, c, X - 1, Y - 1, Z - 1)) / c.dz;
    upd = c.dt_rho * fy;
  }
  const float s = v.VY(X, Y, Z) + upd;
  return m.vy[static_cast<long>(X) * (v.ny + 1) + Y] ? 0.0f : s;
}

__device__ float vz_star(const Vel& v, const Masks& m, const PredictConsts& c,
                         int X, int Y, int Z) {
  float upd = 0.0f;
  if (X >= 1 && X <= v.nx - 2 && Y >= 1 && Y <= v.ny - 2 && Z >= 1 &&
      Z <= v.nz - 1) {
    const float fz =
        (((normal_stress(v, c, X, Y, Z, 2) - normal_stress(v, c, X, Y, Z - 1, 2)) /
              c.dz +
          (txz(v, c, X, Y - 1, Z - 1) - txz(v, c, X - 1, Y - 1, Z - 1)) / c.dx) +
         (tyz(v, c, X - 1, Y, Z - 1) - tyz(v, c, X - 1, Y - 1, Z - 1)) / c.dy) -
        c.rho_g;
    upd = c.dt_rho * fz;
  }
  const float s = v.VZ(X, Y, Z) + upd;
  return m.vz[static_cast<long>(X) * v.ny + Y] ? 0.0f : s;
}

// One thread per point of the (nx+1, ny+1, nz+1) union of the staggered
// shapes: it writes each field that has that point, and the divergence of
// the masked predictor at cell (x, y, z).
__global__ void predict_kernel(Vel v, Masks m, PredictConsts c,
                               float* __restrict__ vx_out,
                               float* __restrict__ vy_out,
                               float* __restrict__ vz_out,
                               float* __restrict__ divv) {
  const int z = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int x = blockIdx.z;
  const int nx = v.nx, ny = v.ny, nz = v.nz;
  if (y > ny || z > nz) return;
  const bool cell = x < nx && y < ny && z < nz;
  if (x <= nx && y < ny && z < nz) {
    vx_out[(static_cast<long>(x) * ny + y) * nz + z] = vx_star(v, m, c, x, y, z);
  }
  if (x < nx && y <= ny && z < nz) {
    vy_out[(static_cast<long>(x) * (ny + 1) + y) * nz + z] =
        vy_star(v, m, c, x, y, z);
  }
  if (x < nx && y < ny && z <= nz) {
    vz_out[(static_cast<long>(x) * ny + y) * (nz + 1) + z] =
        vz_star(v, m, c, x, y, z);
  }
  if (cell) {
    // ops/stencil.py divergence: d_xa/dx + d_ya/dy + d_za/dz
    const float ddx = (vx_star(v, m, c, x + 1, y, z) - vx_star(v, m, c, x, y, z)) / c.dx;
    const float ddy = (vy_star(v, m, c, x, y + 1, z) - vy_star(v, m, c, x, y, z)) / c.dy;
    const float ddz = (vz_star(v, m, c, x, y, z + 1) - vz_star(v, m, c, x, y, z)) / c.dz;
    divv[(static_cast<long>(x) * ny + y) * nz + z] = (ddx + ddy) + ddz;
  }
}

// ---- K4: corrected + masked face velocities (ops/physics.py correct_v,
// ops/cylinder.py apply_cylinder) ----

struct CorrectConsts {
  float dx, dy, dz, minus_dt_rho;
};

struct Pressure {
  const float* p;  // (nx, ny, nz)
  int ny, nz;
  __device__ float at(int x, int y, int z) const {
    return p[(static_cast<long>(x) * ny + y) * nz + z];
  }
};

__device__ float vx_corr(const Vel& v, const Masks& m, const Pressure& p,
                         const CorrectConsts& c, int X, int Y, int Z) {
  float upd = 0.0f;
  if (X >= 1 && X <= v.nx - 1 && Y >= 1 && Y <= v.ny - 2 && Z >= 1 &&
      Z <= v.nz - 2) {
    upd = (c.minus_dt_rho * (p.at(X, Y, Z) - p.at(X - 1, Y, Z))) / c.dx;
  }
  const float s = v.VX(X, Y, Z) + upd;
  return m.vx[static_cast<long>(X) * v.ny + Y] ? 0.0f : s;
}

__device__ float vy_corr(const Vel& v, const Masks& m, const Pressure& p,
                         const CorrectConsts& c, int X, int Y, int Z) {
  float upd = 0.0f;
  if (X >= 1 && X <= v.nx - 2 && Y >= 1 && Y <= v.ny - 1 && Z >= 1 &&
      Z <= v.nz - 2) {
    upd = (c.minus_dt_rho * (p.at(X, Y, Z) - p.at(X, Y - 1, Z))) / c.dy;
  }
  const float s = v.VY(X, Y, Z) + upd;
  return m.vy[static_cast<long>(X) * (v.ny + 1) + Y] ? 0.0f : s;
}

__device__ float vz_corr(const Vel& v, const Masks& m, const Pressure& p,
                         const CorrectConsts& c, int X, int Y, int Z) {
  float upd = 0.0f;
  if (X >= 1 && X <= v.nx - 2 && Y >= 1 && Y <= v.ny - 2 && Z >= 1 &&
      Z <= v.nz - 1) {
    upd = (c.minus_dt_rho * (p.at(X, Y, Z) - p.at(X, Y, Z - 1))) / c.dz;
  }
  const float s = v.VZ(X, Y, Z) + upd;
  return m.vz[static_cast<long>(X) * v.ny + Y] ? 0.0f : s;
}

// zero-gradient source index of the BC stack: the first/last index
// copies its inner neighbor (bc_x!/bc_y!, and bc_zV!'s free-slip top)
__device__ inline int clamp_in(int i, int n) {
  return i == 0 ? 1 : (i == n - 1 ? n - 2 : i);
}

__device__ inline int clamp_top(int i, int n) { return i == n - 1 ? n - 2 : i; }

// variant codes of ns3d_correct (kernels/fused_step.py VARIANTS)
constexpr int kGpu = 0;
constexpr int kMulti = 1;

// z source index of the BC stack: gpu clamps the top only (its floor is
// the no-slip 0 the caller writes), multi clamps both ends
__device__ inline int clamp_z(int variant, int z, int n) {
  return variant == kMulti ? clamp_in(z, n) : clamp_top(z, n);
}

__global__ void correct_kernel(Vel v, Masks m, Pressure p, CorrectConsts c,
                               int variant, float vin,
                               float* __restrict__ vx_out,
                               float* __restrict__ vy_out,
                               float* __restrict__ vz_out) {
  const int z = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int x = blockIdx.z;
  const int nx = v.nx, ny = v.ny, nz = v.nz;
  const bool noslip_floor = variant == kGpu && z == 0;
  if (x <= nx && y < ny && z < nz) {
    float q;
    if (variant == kMulti && x == 0) {
      q = vin;  // the inlet plane overrides last
    } else if (noslip_floor) {
      q = 0.0f;
    } else {
      q = vx_corr(v, m, p, c, clamp_in(x, nx + 1), clamp_in(y, ny),
                  clamp_z(variant, z, nz));
    }
    vx_out[(static_cast<long>(x) * ny + y) * nz + z] = q;
  }
  if (x < nx && y <= ny && z < nz) {
    vy_out[(static_cast<long>(x) * (ny + 1) + y) * nz + z] =
        noslip_floor ? 0.0f
                     : vy_corr(v, m, p, c, clamp_in(x, nx),
                               clamp_in(y, ny + 1), clamp_z(variant, z, nz));
  }
  if (x < nx && y < ny && z <= nz) {
    vz_out[(static_cast<long>(x) * ny + y) * (nz + 1) + z] =
        noslip_floor ? 0.0f
                     : vz_corr(v, m, p, c, clamp_in(x, nx), clamp_in(y, ny),
                               clamp_z(variant, z, nz + 1));
  }
}

}  // namespace

extern "C" int ns3d_predict(const float* vx, const float* vy, const float* vz,
                            const unsigned char* mask_vx,
                            const unsigned char* mask_vy,
                            const unsigned char* mask_vz, float* vx_out,
                            float* vy_out, float* vz_out, float* divv,
                            float dx, float dy, float dz, float mu,
                            float two_mu, float three, float dt_rho,
                            float rho_g, int nx, int ny, int nz,
                            cudaStream_t stream) {
  const Vel v{vx, vy, vz, nx, ny, nz};
  const Masks m{mask_vx, mask_vy, mask_vz};
  const PredictConsts c{dx, dy, dz, mu, two_mu, three, dt_rho, rho_g};
  const dim3 grid = ns3d::grid_for(nx + 1, ny + 1, nz + 1);
  const dim3 block = ns3d::block_shape();
  predict_kernel<<<grid, block, 0, stream>>>(v, m, c, vx_out, vy_out, vz_out, divv);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ns3d_correct(const float* vx, const float* vy, const float* vz,
                            const float* pr, const unsigned char* mask_vx,
                            const unsigned char* mask_vy,
                            const unsigned char* mask_vz, float* vx_out,
                            float* vy_out, float* vz_out, float dx, float dy,
                            float dz, float minus_dt_rho, int variant,
                            float vin, int nx, int ny, int nz,
                            cudaStream_t stream) {
  if (variant != kGpu && variant != kMulti) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Vel v{vx, vy, vz, nx, ny, nz};
  const Masks m{mask_vx, mask_vy, mask_vz};
  const Pressure p{pr, ny, nz};
  const CorrectConsts c{dx, dy, dz, minus_dt_rho};
  const dim3 grid = ns3d::grid_for(nx + 1, ny + 1, nz + 1);
  const dim3 block = ns3d::block_shape();
  correct_kernel<<<grid, block, 0, stream>>>(v, m, p, c, variant, vin, vx_out, vy_out, vz_out);
  return static_cast<int>(cudaGetLastError());
}
