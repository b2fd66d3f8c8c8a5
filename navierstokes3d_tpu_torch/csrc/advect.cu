// K5 and K6: semi-Lagrangian advection (select-shift semantics), one
// per-point body (`backtrack`) behind two kernels that differ in where the
// advecting velocities come from.
//
// K5 (`advect_kernel`) replaces the Pallas kernel of
// navierstokes3d_tpu/kernels/advect.py:537 (build_advect_branch_flat:
// `kernel` :423, `body` :380; its lane-tiled form :516; the four branches
// assembled by build_advect_flat :556-630), which forms the face averages
// in-kernel: one launch advects all four fields. K6 (`advect_pre_kernel`)
// replaces the one of kernels/advect.py:218 (build_advect_branch: `kernel`
// :138; assembled by build_advect :245-310), which takes them
// precomputed: each branch's three advecting velocities arrive as arrays
// of the branch's staggered shape (computed outside, the pads zero), read
// at the output point. The TPU runs one launch per branch; here one
// launch advects every branch of a mask, as K5 does. Per output point
// of a branch's write region the body
//   * takes the advecting velocities: K5 face-averages the post-BC
//     snapshots (ops/advect.py's ((a+b)+c)+d expressions, times 0.25 or
//     0.5), K6 reads the branch's three operands;
//   * per axis, computes the displacement dl = (dt*v)/h, clamps it to
//     [-k, k] (counting points where |dl| exceeded k on any axis), and
//     the departure cell i1 = clip(idx - ceil(dl), 1, n) (ops/advect.py
//     departure_cell: floor(idx - dl) computed exactly), the corner
//     offsets o1 = i1 - idx, o2 = min(i1+1, n) - idx and the fraction
//     t = (dl > 0) - fmod(dl, 1), computed as (dl > 0) - (dl - trunc(dl));
//   * sums the trilinear interpolant in the select-shift backend's
//     (p, q, o) term order with its weight expressions
//     w(o) = (o1==o ? 1-t : 0) + (o2==o ? t : 0) and terms
//     (wx * (wy*wz)) * sample (ops/advect.py:155-174).
// The select-shift sum runs over all (2k+2)^3 offsets, but every term
// whose offset is neither o1 nor o2 on some axis has weight exactly 0 and
// adds exactly +0.0 to the running sum, so summing only the <= 8 terms at
// the (sorted) corner offsets gives the same sum bit for bit when the
// samples are finite. Where i1+1 clamps to n, o1 == o2 and the single
// weight is (1-t) + t, as in the select-shift form. Points outside the
// write region copy the input. Inputs are read-only snapshots; the outputs
// are new tensors. Built with --fmad=false, so the accumulation rounds as
// the plain version does.
//
// The write region discards K6's padded rows, lanes and planes (the
// Pallas kernel's `wmask`, kernels/advect.py:154, applied at :178): a
// point outside the write region copies the input and never reads a
// velocity, and its clamp is not counted.
//
// What bounds K5 on this card: instruction issue. One launch moves 8
// field passes (191.8 MB at 255x153x153, 0.0573 ms at 3.35 TB/s; four
// one-branch launches would move 17, a bound of 0.1218 ms), but each
// branch-point issues three IEEE divisions, three clamped corners and
// fractions, up to 8 gathers and their weights: the kernel is 1280 SASS
// instructions for the four branches (cuobjdump). The design: one thread
// per point of the union grid runs all four branches, so the velocities
// come from device memory once and the 18 velocity values the four
// branches' face averages read are loaded once; the fraction uses trunc
// where CUDA's fmodf is a long branching sequence (~10% of the kernel's
// time); indices are 32-bit, one multiply-add per gather; the gathers of
// a warp fall within k+1 cells of its points, so they come from L1/L2.
// K6 moves 20 field passes for the four branches (each its field, three
// velocities and its output: 479.6 MB at 255x153x153, 0.1432 ms) through
// the same per-point body: bytes and issue both near the bound, so the
// design is K5's one launch, one thread per union-grid point running every
// branch, its twelve velocity loads issued before any branch's arithmetic
// so that one branch's divisions and gathers overlap the others' loads,
// with one launch ramp and tail for the four instead of four.
#include "common.cuh"

namespace {

// Indices are 32-bit: the wrapper refuses arrays of 2^31 elements or
// more, and an index then costs one multiply-add per load.
struct Field {
  const float* __restrict__ p;
  int n1, n2, n3;
};

struct AxisTerms {
  int o1, o2;
  float t;
  bool clamped;
};

// ops/advect.py axis_terms for one axis: v the advecting velocity, d the
// spacing, idx the 1-based index, n the field's extent along the axis.
__device__ inline AxisTerms axis_terms(float v, float d, float dt, float kf,
                                       float idx, int n) {
  const float fn = static_cast<float>(n);
  const float dl_raw = (dt * v) / d;
  // jnp.clip semantics (NaN stays NaN)
  const float dl = dl_raw < -kf ? -kf : (dl_raw > kf ? kf : dl_raw);
  // floor(idx - dl) in exact arithmetic: the rounded idx - dl may land
  // on a whole number where t (below) is taken from dl unrounded
  float i1 = idx - ceilf(dl);
  i1 = i1 < 1.0f ? 1.0f : (i1 > fn ? fn : i1);
  const float i2 = (i1 + 1.0f) < fn ? (i1 + 1.0f) : fn;
  AxisTerms r;
  // t = (dl > 0) - fmod(dl, 1). For finite dl, fmod(dl, 1) is dl -
  // trunc(dl) exactly; the two differ only in the sign of a zero, which
  // t's subtraction from 0 or 1 maps to the same value, and a NaN stays
  // NaN (tests/test_torch_predict_advect.py holds the identity on float32).
  r.t = (dl > 0.0f ? 1.0f : 0.0f) - (dl - truncf(dl));
  r.o1 = static_cast<int>(i1 - idx);
  r.o2 = static_cast<int>(i2 - idx);
  r.clamped = fabsf(dl_raw) > kf;
  return r;
}

// The select-shift weights of an axis's two corners, w(o) = (o1 == o ?
// 1-t : 0) + (o2 == o ? t : 0): at o1, (1-t) + (o2 == o1 ? t : 0); at o2,
// which is read only where it differs from o1, 0 + t, which is t itself
// (t is never -0, and a NaN t stays NaN).
struct Weights {
  float w[2];
};

__device__ inline Weights weights(const AxisTerms& a) {
  return {{(1.0f - a.t) + (a.o2 == a.o1 ? a.t : 0.0f), a.t}};
}

// The corner offsets of one axis that fall in the select-shift window
// [-(k+1), k], ascending (o2 is o1 + 1, or o1 where i1+1 clamped to n):
// how many there are (1 or 2).
__device__ inline int corners(const AxisTerms& a, int k) {
  return a.o2 != a.o1 && a.o2 <= k ? 2 : 1;
}

struct Step {
  float dt, dx, dy, dz;
  int k;
};

// The select-shift interpolant of field a at point (X, Y, Z), whose index
// in a is i, for the advecting velocities (vxc, vyc, vzc); adds 1 to
// *clamped where the displacement was clamped on any axis.
__device__ inline float backtrack(const Field& a, int i, int X, int Y,
                                  int Z, float vxc, float vyc, float vzc,
                                  const Step& s, int* clamped) {
  const float kf = static_cast<float>(s.k);
  const AxisTerms ax = axis_terms(vxc, s.dx, s.dt, kf, X + 1.0f, a.n1);
  const AxisTerms ay = axis_terms(vyc, s.dy, s.dt, kf, Y + 1.0f, a.n2);
  const AxisTerms az = axis_terms(vzc, s.dz, s.dt, kf, Z + 1.0f, a.n3);
  *clamped += (ax.clamped || ay.clamped || az.clamped) ? 1 : 0;
  const int nox = corners(ax, s.k), noy = corners(ay, s.k);
  const int noz = corners(az, s.k);
  const Weights wx = weights(ax), wy = weights(ay), wz = weights(az);
  // the corners' x offsets o1, o2 as element offsets from the point
  const int sx = a.n2 * a.n3;
  const int ox[2] = {i + ax.o1 * sx, i + ax.o2 * sx};
  float acc = 0.0f;
#pragma unroll
  for (int ip = 0; ip < 2; ++ip) {
    if (ip < noy) {
      const int p = ip ? ay.o2 : ay.o1;
#pragma unroll
      for (int iq = 0; iq < 2; ++iq) {
        if (iq < noz) {
          const float wyz = wy.w[ip] * wz.w[iq];
          const int row = p * a.n3 + (iq ? az.o2 : az.o1);
#pragma unroll
          for (int io = 0; io < 2; ++io) {
            if (io < nox) acc = acc + (wx.w[io] * wyz) * a.p[ox[io] + row];
          }
        }
      }
    }
  }
  return acc;
}

enum Branch { kVx = 0, kVy = 1, kVz = 2, kC = 3 };

// ---- K5: the four branches from the post-BC velocities ----

struct Vel {
  const float* __restrict__ vx;  // (nx+1, ny, nz)
  const float* __restrict__ vy;  // (nx, ny+1, nz)
  const float* __restrict__ vz;  // (nx, ny, nz+1)
  int nx, ny, nz;
};

// The fields of the branches a launch advects (null where not).
struct Fields {
  const float* a[4];
  float* out[4];
};

// One branch at one point of its write region (or a copy of the input
// outside it, where the point exists): the interpolant for the advecting
// velocities (vxc, vyc, vzc) at index i of the branch's field.
template <int kBranch>
__device__ inline void advect_at(const Vel& v, const Fields& f, bool write,
                                 bool inside, int X, int Y, int Z, int i,
                                 float vxc, float vyc, float vzc,
                                 const Step& s, int* clamped) {
  const Field a{f.a[kBranch], v.nx + (kBranch == kVx),
                v.ny + (kBranch == kVy), v.nz + (kBranch == kVz)};
  if (write) {
    f.out[kBranch][i] = backtrack(a, i, X, Y, Z, vxc, vyc, vzc, s, clamped);
  } else if (inside) {
    f.out[kBranch][i] = a.p[i];
  }
}

// Where the branches of `mask` stand at point (X, Y, Z) of the (nx+1,
// ny+1, nz+1) union grid: whether each branch's field has the point
// (inside), whether it lies in the branch's write region (gpu.jl:308-332:
// the interior of its own staggered axis, everything for the tracer), and
// the point's index in each field (the tracer's is vx's: both have nz
// lanes and ny rows).
struct Points {
  bool in_vx, in_vy, in_vz, in_c, w_vx, w_vy, w_vz, w_c;
  int ivx, ivy, ivz;
};

__device__ inline Points points(const Vel& v, unsigned mask, int X, int Y,
                                int Z) {
  const int nx = v.nx, ny = v.ny, nz = v.nz;
  Points p;
  p.in_c = X < nx && Y < ny && Z < nz;
  p.in_vx = (mask & (1u << kVx)) && X <= nx && Y < ny && Z < nz;
  p.in_vy = (mask & (1u << kVy)) && X < nx && Y <= ny && Z < nz;
  p.in_vz = (mask & (1u << kVz)) && X < nx && Y < ny && Z <= nz;
  p.w_vx = p.in_vx && X >= 1 && X <= nx - 1;
  p.w_vy = p.in_vy && Y >= 1 && Y <= ny - 1;
  p.w_vz = p.in_vz && Z >= 1 && Z <= nz - 1;
  p.w_c = (mask & (1u << kC)) && p.in_c;
  p.ivx = (X * ny + Y) * nz + Z;
  p.ivy = (X * (ny + 1) + Y) * nz + Z;
  p.ivz = (X * ny + Y) * (nz + 1) + Z;
  return p;
}

// One thread per point of the (nx+1, ny+1, nz+1) union grid advects every
// branch of `mask` that has that point. It first loads the 18 velocity
// values the four branches' face averages read there, each once and only
// where a branch that reads it writes (where the per-branch form read
// it), then forms each branch's advecting velocities with ops/advect.py's
// ((a+b)+c)+d expressions, times 0.25 or 0.5. One launch reads vx, vy, vz
// and the fields once from device memory.
__global__ void advect_kernel(Vel v, Fields f, unsigned mask,
                              int* __restrict__ n_clamped, Step s) {
  const int Z = blockIdx.x * blockDim.x + threadIdx.x;
  const int Y = blockIdx.y * blockDim.y + threadIdx.y;
  const int X = blockIdx.z;
  const int ny = v.ny, nz = v.nz;
  const Points pt = points(v, mask, X, Y, Z);
  const bool w_vx = pt.w_vx, w_vy = pt.w_vy, w_vz = pt.w_vz, w_c = pt.w_c;
  const int ivx = pt.ivx, ivy = pt.ivy, ivz = pt.ivz;
  // x strides of vx, vy, vz; vz's y stride is nz + 1, the others' nz
  const int sx = ny * nz, sy = (ny + 1) * nz, sz = ny * (nz + 1);
  const float* __restrict__ px = v.vx;
  const float* __restrict__ py = v.vy;
  const float* __restrict__ pz = v.vz;
  const bool any = w_vx || w_vy || w_vz || w_c;
  // vx at (X, Y, Z), (X+1, Y, Z), (X, Y-1, Z), (X+1, Y-1, Z), (X, Y, Z-1),
  // (X+1, Y, Z-1); vy and vz likewise around their own axes
  const float x000 = any ? px[ivx] : 0.0f;
  const float x100 = w_vy || w_vz || w_c ? px[ivx + sx] : 0.0f;
  const float x0m0 = w_vy ? px[ivx - nz] : 0.0f;
  const float x1m0 = w_vy ? px[ivx + sx - nz] : 0.0f;
  const float x00m = w_vz ? px[ivx - 1] : 0.0f;
  const float x10m = w_vz ? px[ivx + sx - 1] : 0.0f;
  const float y000 = any ? py[ivy] : 0.0f;
  const float y010 = w_vx || w_vz || w_c ? py[ivy + nz] : 0.0f;
  const float ym00 = w_vx ? py[ivy - sy] : 0.0f;
  const float ym10 = w_vx ? py[ivy + nz - sy] : 0.0f;
  const float y00m = w_vz ? py[ivy - 1] : 0.0f;
  const float y01m = w_vz ? py[ivy + nz - 1] : 0.0f;
  const float z000 = any ? pz[ivz] : 0.0f;
  const float z001 = w_vx || w_vy || w_c ? pz[ivz + 1] : 0.0f;
  const float zm00 = w_vx ? pz[ivz - sz] : 0.0f;
  const float zm01 = w_vx ? pz[ivz + 1 - sz] : 0.0f;
  const float z0m0 = w_vy ? pz[ivz - (nz + 1)] : 0.0f;
  const float z0m1 = w_vy ? pz[ivz - nz] : 0.0f;
  int clamped = 0;
  advect_at<kVx>(v, f, w_vx, pt.in_vx, X, Y, Z, ivx, x000,
                 0.25f * (((ym00 + ym10) + y000) + y010),
                 0.25f * (((zm00 + zm01) + z000) + z001), s, &clamped);
  advect_at<kVy>(v, f, w_vy, pt.in_vy, X, Y, Z, ivy,
                 0.25f * (((x0m0 + x1m0) + x000) + x100), y000,
                 0.25f * (((z0m0 + z0m1) + z000) + z001), s, &clamped);
  advect_at<kVz>(v, f, w_vz, pt.in_vz, X, Y, Z, ivz,
                 0.25f * (((x00m + x10m) + x000) + x100),
                 0.25f * (((y00m + y01m) + y000) + y010), z000, s, &clamped);
  advect_at<kC>(v, f, w_c, w_c, X, Y, Z, ivx, 0.5f * (x000 + x100),
                0.5f * (y000 + y010), 0.5f * (z000 + z001), s, &clamped);
  ns3d::block_sum_to(clamped, n_clamped);
}

// ---- K6: the branches of a mask from precomputed advecting velocities ----

// Each branch's three advecting velocities at its field's shape (null
// outside the mask).
struct PreVel {
  const float* v[4][3];
};

// As advect_kernel, one thread per point of the union grid running every
// branch of `mask` that has the point, but each branch reads its own three
// advecting velocities at its own staggered index, and only where it
// writes: the pads, outside every write region, are never read. All twelve
// loads are issued before any branch's arithmetic.
__global__ void advect_pre_kernel(Vel v, Fields f, PreVel u, unsigned mask,
                                  int* __restrict__ n_clamped, Step s) {
  const int Z = blockIdx.x * blockDim.x + threadIdx.x;
  const int Y = blockIdx.y * blockDim.y + threadIdx.y;
  const int X = blockIdx.z;
  const Points pt = points(v, mask, X, Y, Z);
  const bool w[4] = {pt.w_vx, pt.w_vy, pt.w_vz, pt.w_c};
  const int i[4] = {pt.ivx, pt.ivy, pt.ivz, pt.ivx};
  float a[4][3];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
#pragma unroll
    for (int q = 0; q < 3; ++q) a[b][q] = w[b] ? u.v[b][q][i[b]] : 0.0f;
  }
  int clamped = 0;
  advect_at<kVx>(v, f, pt.w_vx, pt.in_vx, X, Y, Z, pt.ivx, a[kVx][0],
                 a[kVx][1], a[kVx][2], s, &clamped);
  advect_at<kVy>(v, f, pt.w_vy, pt.in_vy, X, Y, Z, pt.ivy, a[kVy][0],
                 a[kVy][1], a[kVy][2], s, &clamped);
  advect_at<kVz>(v, f, pt.w_vz, pt.in_vz, X, Y, Z, pt.ivz, a[kVz][0],
                 a[kVz][1], a[kVz][2], s, &clamped);
  advect_at<kC>(v, f, pt.w_c, pt.w_c, X, Y, Z, pt.ivx, a[kC][0], a[kC][1],
                a[kC][2], s, &clamped);
  ns3d::block_sum_to(clamped, n_clamped);
}

}  // namespace

// Advects each branch b (0..3 = Vx, Vy, Vz, C) whose bit is set in `mask`,
// field a[b] into out[b] (null for the others), on the (nx, ny, nz) grid,
// in one launch. K5 (pre 0): vels[0..2] are the post-BC velocities vx, vy,
// vz. K6 (pre nonzero): vels[3b..3b+2] are branch b's advecting
// velocities at its field's shape (null outside the mask). n_clamped
// accumulates (the caller zeroes it once per step).
extern "C" int ns3d_advect(unsigned mask, const float* a_vx, const float* a_vy,
                           const float* a_vz, const float* a_c, float* out_vx,
                           float* out_vy, float* out_vz, float* out_c,
                           const float* const* vels, int* n_clamped,
                           float dt, float dx, float dy, float dz, int k,
                           int nx, int ny, int nz, int pre,
                           cudaStream_t stream) {
  const Fields f{{a_vx, a_vy, a_vz, a_c}, {out_vx, out_vy, out_vz, out_c}};
  if (mask == 0 || mask > 15) return static_cast<int>(cudaErrorInvalidValue);
  for (int b = 0; b < 4; ++b) {
    if (!(mask >> b & 1u)) continue;
    if (f.a[b] == nullptr || f.out[b] == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    for (int q = 0; q < 3; ++q) {
      if (vels[pre ? 3 * b + q : q] == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  // the largest array, (nx+1, ny+1, nz+1) bounding all, in 32-bit indices
  if (static_cast<long>(nx + 1) * (ny + 1) * (nz + 1) >= (1L << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Step s{dt, dx, dy, dz, k};
  const dim3 grid = ns3d::grid_for(nx + 1, ny + 1, nz + 1);
  const dim3 block = ns3d::block_shape();
  if (pre) {
    const Vel v{nullptr, nullptr, nullptr, nx, ny, nz};
    PreVel u;
    for (int b = 0; b < 4; ++b) {
      for (int q = 0; q < 3; ++q) u.v[b][q] = vels[3 * b + q];
    }
    advect_pre_kernel<<<grid, block, 0, stream>>>(v, f, u, mask, n_clamped, s);
  } else {
    const Vel v{vels[0], vels[1], vels[2], nx, ny, nz};
    advect_kernel<<<grid, block, 0, stream>>>(v, f, mask, n_clamped, s);
  }
  return static_cast<int>(cudaGetLastError());
}
