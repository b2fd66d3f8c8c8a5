// K3 (predict) and K4 (correct): the non-Poisson chain of the Chorin step.
//
// K3 replaces the Pallas kernel of navierstokes3d_tpu/kernels/fused_step.py:440
// (build_predict: `kernel` :369, `body` :280; its lane-tiled form :420
// too): stress tau -> predictor V* = V + dt/rho * div(tau) (- rho*g_eff
// on Vz) -> cylinder mask -> the divergence of the masked V*. It reads
// Vx/Vy/Vz and writes Vx*/Vy*/Vz* and divV; the six stress fields live in
// shared memory and registers only.
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
// with --fmad=false, so `v + s*f` rounds as the plain version does. Every
// value is computed by the plain version's expression from the same
// operands, so each kernel is bitwise equal to its plain version.
//
// What bounds K3 on this card: instruction issue, not bytes. It moves 7
// fields (168.1 MB at 255x153x153: 0.0502 ms at 3.35 TB/s), but each
// point needs 22 IEEE divisions (four for the normal stresses, two for
// each shear stress, three for each face velocity, three for divV), and
// a division is ~10 SASS instructions with a branch to its slow path,
// which also keeps the compiler from interleaving two of them. The plane
// loop below is 712 SASS instructions (cuobjdump), ~870 per output point
// with the halo: at 4 instructions per cycle on 132 SMs at 1.98 GHz the
// issue floor at 255 is ~0.16 ms, three times the byte floor; the kernel
// takes 0.33 ms on an H100 80GB HBM3 at 700 W (PERF.md). Recomputing
// each stress where it is read, one thread per point, costs ~170
// divisions per thread and 1.02 ms there.
// The design computes each intermediate once per point: a block streams
// a (y, z) tile along x (the loop comment below), the stresses of a plane
// in shared memory for their y/z neighbours and in registers for their x
// neighbours, with the velocities copied by cp.async an iteration before
// they are read and one barrier a plane.
//
// K4 is bound by device-memory bytes (7 fields, ~50% of the bound): it
// reads each input once from DRAM and writes each output once, the
// neighbor values a thread recomputes (corrected values at clamped BC
// sources) coming from L1/L2.
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

// ---- K3: the predictor, streamed along x ----
//
// A block owns a (y, z) tile of kTileY x kTileZ points of the union grid
// and walks a segment of x planes. Its 16 x 32 threads cover the tile
// and a halo of one on each side: thread (ty, tx) sits at y = y0 - 1 + ty,
// z = z0 - 1 + tx, and owns the outputs there when 1 <= ty <= kTileY and
// 1 <= tx <= kTileZ. Iteration j of the plane loop computes, each value
// once and each with the expression of ops/physics.py:
//   A  the normal stresses of cell j, txy and txz at the (j+1, y, z)
//      edges, tyz at the (j, y, z) edges;
//   B  vx* at j and vy*, vz* at j-1 (one row/lane of halo for the last
//      two, which the divergence reads), from A of j and j-1;
//   C  div V* at cell j-2, from B of j-1 and j-2.
// Each stage reads in shared memory only what the one before it wrote in
// the previous iteration, and writes the other half of a double buffer,
// so ONE barrier a plane orders all. A plane's x neighbours live in the
// thread's registers (txx of cell j-1, txy/txz of planes j and j-1, the
// thread's own velocities, vx* of j-1 and j-2), its y/z neighbours in
// shared memory. The velocities arrive through a ring of three stages,
// stage q holding the planes vx[q+1], vy[q], vz[q] over the block's 17 x 33
// points, each thread copying its own cells with 4-byte cp.async one
// iteration before A first reads them.

constexpr int kThreadsZ = 32;
constexpr int kThreadsY = 16;
constexpr int kTileZ = kThreadsZ - 2;
constexpr int kTileY = kThreadsY - 2;
constexpr int kStageZ = kThreadsZ + 1;      // lanes of a staged plane
constexpr int kStageY = kThreadsY + 1;      // rows of a staged plane
constexpr int kStage = kStageY * kStageZ;
constexpr int kThreads = kThreadsY * kThreadsZ;
constexpr int kRing = 3;

struct PredictConsts {
  float dx, dy, dz, mu, two_mu, three, dt_rho, rho_g;
};

struct PredictPlan {
  int tiles_y, tiles_z, seg;
};

// 48868 bytes: within the 48 KB of a static allocation, two blocks an SM
struct PredictSmem {
  float vx[kRing][kStage], vy[kRing][kStage], vz[kRing][kStage];
  float tyy[2][kThreads], tzz[2][kThreads];  // cells of plane j
  float txy[2][kThreads], txz[2][kThreads];  // edges of plane j + 1
  float tyz[2][kThreads];                    // edges of plane j
  float vys[2][kThreads], vzs[2][kThreads];  // vy*, vz* of plane j - 1
};

// A thread's share of one staged plane: its own point (ty, tx), and for
// the first kStage - kThreads threads one point of the 17th row or the
// 33rd lane; for each, its (y, z) offset into each velocity array, or -1
// where the array has no such point.
struct StageCopy {
  int e1;                 // the second point, or -1
  int ox0, oy0, oz0, ox1, oy1, oz1;
};

__device__ inline void yz_offsets(int y, int z, int ny, int nz, int* ox,
                                  int* oy, int* oz) {
  const bool in = y >= 0 && z >= 0;
  *ox = in && y < ny && z < nz ? y * nz + z : -1;
  *oy = in && y <= ny && z < nz ? y * nz + z : -1;
  *oz = in && y < ny && z <= nz ? y * (nz + 1) + z : -1;
}

__device__ inline StageCopy stage_copy(int t, int y0, int z0, int ny,
                                       int nz) {
  StageCopy s;
  const int ty = t / kThreadsZ, tx = t % kThreadsZ;
  yz_offsets(y0 - 1 + ty, z0 - 1 + tx, ny, nz, &s.ox0, &s.oy0, &s.oz0);
  // the 17th row (33 points), then the 33rd lane of rows 0..15
  const int extra = kStageZ + kThreadsY;
  static_assert(kStage - kThreads == kStageZ + kThreadsY, "stage shape");
  const int r = t < kStageZ ? kThreadsY : t - kStageZ;
  const int c = t < kStageZ ? t : kThreadsZ;
  s.e1 = t < extra ? r * kStageZ + c : -1;
  yz_offsets(y0 - 1 + r, z0 - 1 + c, ny, nz, &s.ox1, &s.oy1, &s.oz1);
  return s;
}

// One point of one velocity plane into shared memory: 0 where the array
// has no point (never used by a written output). Indices are 32-bit: the
// wrapper refuses arrays of 2^31 elements or more.
__device__ inline void copy_or_zero(float* dst, const float* src, bool x_in,
                                    int plane, int off) {
  if (x_in && off >= 0) {
    ns3d::cp_async4(dst, src + (plane + off));
  } else {
    *dst = 0.0f;
  }
}

// Stage q: vx[q+1], vy[q], vz[q].
__device__ inline void stage_load(PredictSmem& sm, int slot, const Vel& v,
                                  int q, int e0, const StageCopy& s) {
  const int nx = v.nx, ny = v.ny, nz = v.nz;
  const bool inx = q + 1 >= 0 && q + 1 <= nx, inyz = q >= 0 && q < nx;
  const int bx = (q + 1) * ny * nz, by = q * (ny + 1) * nz;
  const int bz = q * ny * (nz + 1);
  copy_or_zero(sm.vx[slot] + e0, v.vx, inx, bx, s.ox0);
  copy_or_zero(sm.vy[slot] + e0, v.vy, inyz, by, s.oy0);
  copy_or_zero(sm.vz[slot] + e0, v.vz, inyz, bz, s.oz0);
  if (s.e1 >= 0) {
    copy_or_zero(sm.vx[slot] + s.e1, v.vx, inx, bx, s.ox1);
    copy_or_zero(sm.vy[slot] + s.e1, v.vy, inyz, by, s.oy1);
    copy_or_zero(sm.vz[slot] + s.e1, v.vz, inyz, bz, s.oz1);
  }
  ns3d::cp_async_commit();
}

__global__ void __launch_bounds__(kThreads, 2)
    predict_kernel(Vel v, Masks m, PredictConsts c, PredictPlan plan,
                   float* __restrict__ vx_out, float* __restrict__ vy_out,
                   float* __restrict__ vz_out, float* __restrict__ divv) {
  __shared__ PredictSmem sm;
  const int nx = v.nx, ny = v.ny, nz = v.nz;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int t = ty * kThreadsZ + tx;   // this thread's cell of a 512 plane
  const int e = ty * kStageZ + tx;     // and of a staged plane
  const int y0 = blockIdx.y * kTileY, z0 = blockIdx.x * kTileZ;
  const int Y = y0 - 1 + ty, Z = z0 - 1 + tx;
  const int xs = blockIdx.z * plan.seg;
  const int xe = min(xs + plan.seg, nx + 1);
  const bool owner = ty >= 1 && ty <= kTileY && tx >= 1 && tx <= kTileZ;
  const StageCopy sc = stage_copy(t, y0, z0, ny, nz);
  const int row = Y * nz + Z;  // (y, z) in vx, vy (rows of nz) and divv
  const int sxy = ny * nz, syy = (ny + 1) * nz, szy = ny * (nz + 1);
  // which of this thread's (y, z) points exist, and where the interior
  // guards of vx*, vy*, vz* hold in y and z
  const bool at_cell = owner && Y < ny && Z < nz;
  const bool at_vy = ty >= 1 && tx >= 1 && tx <= kTileZ && Y <= ny && Z < nz;
  const bool at_vz = tx >= 1 && ty >= 1 && ty <= kTileY && Y < ny && Z <= nz;
  const bool in_vx = Y >= 1 && Y <= ny - 2 && Z >= 1 && Z <= nz - 2;
  const bool in_vy = Y >= 1 && Y <= ny - 1 && Z >= 1 && Z <= nz - 2;
  const bool in_vz = Y >= 1 && Y <= ny - 2 && Z >= 1 && Z <= nz - 1;
  const int j0 = xs - 1, cend = min(xe, nx);
  int sa = 0, sb = 1, sn = 2;  // the ring slots of stages j, j+1, j+2
  stage_load(sm, sa, v, j0, e, sc);
  stage_load(sm, sb, v, j0 + 1, e, sc);
  // carried from plane to plane: this thread's vx[j], vy[j-1], vz[j-1];
  // txx of cell j-1; txy/txz of planes j and j-1; vx* of j-1 and j-2
  float vx_own = j0 >= 0 && sc.ox0 >= 0 ? v.vx[j0 * sxy + sc.ox0] : 0.0f;
  float vy_own = 0.0f, vz_own = 0.0f, txx_prev = 0.0f;
  float txy1 = 0.0f, txz1 = 0.0f, txy2 = 0.0f, txz2 = 0.0f;
  float vxs1 = 0.0f, vxs2 = 0.0f;
  for (int j = j0;; ++j) {
    const int h = (j - j0) & 1;  // the half of each double buffer A writes
    const int g = h ^ 1;         // the half A wrote one plane before
    ns3d::cp_async_wait_all();
    __syncthreads();
    // C: div V* at cell j - 2 (ops/stencil.py divergence)
    if (at_cell && j - 2 >= xs && j - 2 < cend) {
      const float ddx = (vxs1 - vxs2) / c.dx;
      const float ddy = (sm.vys[h][t + kThreadsZ] - sm.vys[h][t]) / c.dy;
      const float ddz = (sm.vzs[h][t + 1] - sm.vzs[h][t]) / c.dz;
      divv[(j - 2) * sxy + row] = (ddx + ddy) + ddz;
    }
    if (j > xe) break;
    if (j < xe) stage_load(sm, sn, v, j + 2, e, sc);
    // A: stresses (ops/physics.py update_tau)
    const float* ax = sm.vx[sa];  // vx[j+1]
    const float* ay = sm.vy[sa];  // vy[j]
    const float* az = sm.vz[sa];  // vz[j]
    const float* by = sm.vy[sb];  // vy[j+1]
    const float* bz = sm.vz[sb];  // vz[j+1]
    float txx, txy0 = 0.0f, txz0 = 0.0f;
    {
      const float dvxdx = (ax[e] - vx_own) / c.dx;
      const float dvydy = (ay[e + kStageZ] - ay[e]) / c.dy;
      const float dvzdz = (az[e + 1] - az[e]) / c.dz;
      const float th = ((dvxdx + dvydy) + dvzdz) / c.three;
      txx = c.two_mu * (dvxdx - th);
      sm.tyy[h][t] = c.two_mu * (dvydy - th);
      sm.tzz[h][t] = c.two_mu * (dvzdz - th);
    }
    if (ty >= 1) {
      txy0 = c.mu * ((ax[e] - ax[e - kStageZ]) / c.dy +
                     (by[e] - ay[e]) / c.dx);
      sm.txy[h][t] = txy0;
    }
    if (tx >= 1) {
      txz0 = c.mu * ((ax[e] - ax[e - 1]) / c.dz + (bz[e] - az[e]) / c.dx);
      sm.txz[h][t] = txz0;
    }
    if (ty >= 1 && tx >= 1) {
      sm.tyz[h][t] = c.mu * ((ay[e] - ay[e - 1]) / c.dz +
                             (az[e] - az[e - kStageZ]) / c.dy);
    }
    // B: predicted + masked face velocities (ops/physics.py predict_v,
    // ops/cylinder.py apply_cylinder) from A of j and of j - 1
    float vxs0 = 0.0f;
    if (j > j0) {
      if (at_cell && j <= nx) {  // vx* at X = j
        float upd = 0.0f;
        if (in_vx && j >= 1 && j <= nx - 1) {
          const float fx =
              ((txx - txx_prev) / c.dx +
               (sm.txy[g][t + kThreadsZ] - txy1) / c.dy) +
              (sm.txz[g][t + 1] - txz1) / c.dz;
          upd = c.dt_rho * fx;
        }
        const float s = vx_own + upd;
        vxs0 = m.vx[j * ny + Y] ? 0.0f : s;
        if (j < xe) vx_out[j * sxy + row] = vxs0;
      }
      const int P = j - 1;
      {  // vy* at P, rows 1..kTileY + 1
        float q = 0.0f;
        if (at_vy && P >= 0 && P < nx) {
          float upd = 0.0f;
          if (in_vy && P >= 1 && P <= nx - 2) {
            const float fy =
                ((sm.tyy[g][t] - sm.tyy[g][t - kThreadsZ]) / c.dy +
                 (txy1 - txy2) / c.dx) +
                (sm.tyz[g][t + 1] - sm.tyz[g][t]) / c.dz;
            upd = c.dt_rho * fy;
          }
          const float s = vy_own + upd;
          q = m.vy[P * (ny + 1) + Y] ? 0.0f : s;
          if (owner && P >= xs) vy_out[P * syy + row] = q;
        }
        sm.vys[g][t] = q;
      }
      {  // vz* at P, lanes 1..kTileZ + 1
        float q = 0.0f;
        if (at_vz && P >= 0 && P < nx) {
          float upd = 0.0f;
          if (in_vz && P >= 1 && P <= nx - 2) {
            const float fz =
                (((sm.tzz[g][t] - sm.tzz[g][t - 1]) / c.dz +
                  (txz1 - txz2) / c.dx) +
                 (sm.tyz[g][t + kThreadsZ] - sm.tyz[g][t]) / c.dy) -
                c.rho_g;
            upd = c.dt_rho * fz;
          }
          const float s = vz_own + upd;
          q = m.vz[P * ny + Y] ? 0.0f : s;
          if (owner && P >= xs) vz_out[P * szy + Y * (nz + 1) + Z] = q;
        }
        sm.vzs[g][t] = q;
      }
    }
    const int s0 = sa;
    sa = sb;
    sb = sn;
    sn = s0;
    vx_own = ax[e];
    vy_own = ay[e];
    vz_own = az[e];
    txx_prev = txx;
    txy2 = txy1;
    txy1 = txy0;
    txz2 = txz1;
    txz1 = txz0;
    vxs2 = vxs1;
    vxs1 = vxs0;
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

// K3 under a plan of tiles_y x tiles_z tiles of kTileY x kTileZ points
// and x segments of `seg` planes (kernels/fused_step.py predict_plan),
// which must cover the (nx+1, ny+1, nz+1) union grid.
extern "C" int ns3d_predict(const float* vx, const float* vy, const float* vz,
                            const unsigned char* mask_vx,
                            const unsigned char* mask_vy,
                            const unsigned char* mask_vz, float* vx_out,
                            float* vy_out, float* vz_out, float* divv,
                            float dx, float dy, float dz, float mu,
                            float two_mu, float three, float dt_rho,
                            float rho_g, int nx, int ny, int nz, int tiles_y,
                            int tiles_z, int seg, cudaStream_t stream) {
  if (nx < 1 || ny < 1 || nz < 1 || seg < 1 ||
      tiles_y * kTileY < ny + 1 || tiles_z * kTileZ < nz + 1 ||
      static_cast<long>(nx + 1) * (ny + 1) * (nz + 1) >= (1L << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Vel v{vx, vy, vz, nx, ny, nz};
  const Masks m{mask_vx, mask_vy, mask_vz};
  const PredictConsts c{dx, dy, dz, mu, two_mu, three, dt_rho, rho_g};
  const PredictPlan plan{tiles_y, tiles_z, seg};
  const dim3 grid(tiles_z, tiles_y, (nx + 1 + seg - 1) / seg);
  const dim3 block(kThreadsZ, kThreadsY, 1);
  predict_kernel<<<grid, block, 0, stream>>>(v, m, c, plan, vx_out, vy_out, vz_out, divv);
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
