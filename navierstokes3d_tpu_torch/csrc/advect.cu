// K5 and K6: one semi-Lagrangian advection branch (select-shift
// semantics), two instances of one kernel template that differ only in
// where the advecting velocities come from.
//
// K5 replaces the Pallas kernel of navierstokes3d_tpu/kernels/advect.py:537
// (build_advect_branch_flat: `kernel` :423, `body` :380; the four
// branches assembled by build_advect_flat :556-630), which forms the face
// averages in-kernel. K6 replaces the one of kernels/advect.py:218
// (build_advect_branch: `kernel` :138; assembled by build_advect
// :245-310), which takes them precomputed: the three advecting velocities
// arrive as arrays of the branch's staggered shape (computed outside, the
// pads zero), and it reads them at the output point. Everything else is
// one body. Per output point of the branch's write region it
//   * takes the advecting velocities: K5 face-averages the post-BC
//     snapshots (ops/advect.py's ((a+b)+c)+d expressions, times 0.25 or
//     0.5), K6 reads its three operands;
//   * per axis, computes the displacement dl = (dt*v)/h, clamps it to
//     [-k, k] (counting points where |dl| exceeded k on any axis), and
//     the departure cell i1 = clip(floor(idx - dl), 1, n), the corner
//     offsets o1 = i1 - idx, o2 = min(i1+1, n) - idx and the fraction
//     t = (dl > 0) - fmod(dl, 1);
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
// write region copy the input. Inputs are read-only snapshots; the output
// is a new tensor. Built with --fmad=false, so the accumulation rounds as
// the plain version does.
//
// The write mask discards K6's padded rows, lanes and planes (the
// Pallas kernel's `wmask`, kernels/advect.py:154, applied at :178): a
// point outside the write region copies the input and never reads a
// velocity, and its clamp is not counted.
//
// What bounds it on this card: gathers. Each output point reads up to 8
// data-dependent samples plus 3 (K6) or 9-12 (K5) velocity values; the
// departure points lie within +-k cells, so the gathers of a warp fall in
// a few cache lines of L1/L2 and DRAM traffic stays near one read of the
// field and the velocities and one write (K6 reads three velocity arrays
// of the field's size where K5 reads the three staggered velocities). The design
// keeps the <= 8 live terms in registers instead of the TPU's 216-term
// shifted-slab accumulation.
#include "common.cuh"

namespace {

struct Field {
  const float* p;
  int n1, n2, n3;
  __device__ float at(int a, int b, int c) const {
    return p[(static_cast<long>(a) * n2 + b) * n3 + c];
  }
};

struct AxisTerms {
  int o1, o2;
  float t;
  bool clamped;
};

// ops/advect.py axis_terms for one axis: v the advecting velocity, d the
// spacing, idx the 1-based index, n the field's extent along the axis.
__device__ AxisTerms axis_terms(float v, float d, float dt, float kf,
                                float idx, int n) {
  const float fn = static_cast<float>(n);
  const float dl_raw = (dt * v) / d;
  // jnp.clip semantics (NaN stays NaN)
  const float dl = dl_raw < -kf ? -kf : (dl_raw > kf ? kf : dl_raw);
  float i1 = floorf(idx - dl);
  i1 = i1 < 1.0f ? 1.0f : (i1 > fn ? fn : i1);
  const float i2 = (i1 + 1.0f) < fn ? (i1 + 1.0f) : fn;
  AxisTerms r;
  r.t = (dl > 0.0f ? 1.0f : 0.0f) - fmodf(dl, 1.0f);
  r.o1 = static_cast<int>(i1 - idx);
  r.o2 = static_cast<int>(i2 - idx);
  r.clamped = fabsf(dl_raw) > kf;
  return r;
}

__device__ inline float weight(const AxisTerms& a, int o) {
  return (a.o1 == o ? 1.0f - a.t : 0.0f) + (a.o2 == o ? a.t : 0.0f);
}

// The corner offsets of one axis that fall in the select-shift window
// [-(k+1), k], ascending (o2 is o1 + 1, or o1 where i1+1 clamped to n).
__device__ inline int corner_offsets(const AxisTerms& a, int k, int* offs) {
  int n = 0;
  offs[n++] = a.o1;
  if (a.o2 != a.o1 && a.o2 <= k) offs[n++] = a.o2;
  return n;
}

enum Branch { kVx = 0, kVy = 1, kVz = 2, kC = 3 };

// kPre false (K5): vx, vy, vz are the post-BC velocities of the (nx, ny,
// nz) grid, face-averaged here. kPre true (K6): they are the branch's
// advecting velocities at the field's own shape.
template <bool kPre>
__global__ void advect_kernel(int branch, Field a, Field vx, Field vy,
                              Field vz, float* __restrict__ out,
                              int* __restrict__ n_clamped, float dt,
                              float dx, float dy, float dz, int k) {
  const int Z = blockIdx.x * blockDim.x + threadIdx.x;
  const int Y = blockIdx.y * blockDim.y + threadIdx.y;
  const int X = blockIdx.z;
  const bool inside = Y < a.n2 && Z < a.n3;
  // the branch's write region (gpu.jl:308-332): interior of its own
  // staggered axis, everything for the tracer
  bool write = inside;
  if (branch == kVx) write = write && X >= 1 && X <= a.n1 - 2;
  if (branch == kVy) write = write && Y >= 1 && Y <= a.n2 - 2;
  if (branch == kVz) write = write && Z >= 1 && Z <= a.n3 - 2;
  int clamped = 0;
  if (write) {
    float vxc, vyc, vzc;
    if (kPre) {
      vxc = vx.at(X, Y, Z);
      vyc = vy.at(X, Y, Z);
      vzc = vz.at(X, Y, Z);
    } else if (branch == kVx) {
      vxc = vx.at(X, Y, Z);
      vyc = 0.25f * (((vy.at(X - 1, Y, Z) + vy.at(X - 1, Y + 1, Z)) +
                      vy.at(X, Y, Z)) + vy.at(X, Y + 1, Z));
      vzc = 0.25f * (((vz.at(X - 1, Y, Z) + vz.at(X - 1, Y, Z + 1)) +
                      vz.at(X, Y, Z)) + vz.at(X, Y, Z + 1));
    } else if (branch == kVy) {
      vxc = 0.25f * (((vx.at(X, Y - 1, Z) + vx.at(X + 1, Y - 1, Z)) +
                      vx.at(X, Y, Z)) + vx.at(X + 1, Y, Z));
      vyc = vy.at(X, Y, Z);
      vzc = 0.25f * (((vz.at(X, Y - 1, Z) + vz.at(X, Y - 1, Z + 1)) +
                      vz.at(X, Y, Z)) + vz.at(X, Y, Z + 1));
    } else if (branch == kVz) {
      vxc = 0.25f * (((vx.at(X, Y, Z - 1) + vx.at(X + 1, Y, Z - 1)) +
                      vx.at(X, Y, Z)) + vx.at(X + 1, Y, Z));
      vyc = 0.25f * (((vy.at(X, Y, Z - 1) + vy.at(X, Y + 1, Z - 1)) +
                      vy.at(X, Y, Z)) + vy.at(X, Y + 1, Z));
      vzc = vz.at(X, Y, Z);
    } else {
      vxc = 0.5f * (vx.at(X, Y, Z) + vx.at(X + 1, Y, Z));
      vyc = 0.5f * (vy.at(X, Y, Z) + vy.at(X, Y + 1, Z));
      vzc = 0.5f * (vz.at(X, Y, Z) + vz.at(X, Y, Z + 1));
    }
    const float kf = static_cast<float>(k);
    const AxisTerms ax = axis_terms(vxc, dx, dt, kf, X + 1.0f, a.n1);
    const AxisTerms ay = axis_terms(vyc, dy, dt, kf, Y + 1.0f, a.n2);
    const AxisTerms az = axis_terms(vzc, dz, dt, kf, Z + 1.0f, a.n3);
    clamped = (ax.clamped || ay.clamped || az.clamped) ? 1 : 0;
    int ox[2], oy[2], oz[2];
    const int nox = corner_offsets(ax, k, ox);
    const int noy = corner_offsets(ay, k, oy);
    const int noz = corner_offsets(az, k, oz);
    float acc = 0.0f;
    for (int ip = 0; ip < noy; ++ip) {
      const int p = oy[ip];
      const float wy = weight(ay, p);
      for (int iq = 0; iq < noz; ++iq) {
        const int q = oz[iq];
        const float wyz = wy * weight(az, q);
        for (int io = 0; io < nox; ++io) {
          const int o = ox[io];
          acc = acc + (weight(ax, o) * wyz) * a.at(X + o, Y + p, Z + q);
        }
      }
    }
    out[(static_cast<long>(X) * a.n2 + Y) * a.n3 + Z] = acc;
  } else if (inside) {
    const long i = (static_cast<long>(X) * a.n2 + Y) * a.n3 + Z;
    out[i] = a.p[i];
  }
  ns3d::block_sum_to(clamped, n_clamped);
}

}  // namespace

// branch 0..3 = Vx, Vy, Vz, C; a is that branch's field (its shape gives
// the clamp bounds); vx/vy/vz the post-BC velocities of the (nx, ny, nz)
// grid (K5) or the branch's advecting velocities at a's shape (K6, pre
// nonzero). n_clamped accumulates (the caller zeroes it once per step).
extern "C" int ns3d_advect(int branch, const float* a, const float* vx,
                           const float* vy, const float* vz, float* out,
                           int* n_clamped, float dt, float dx, float dy,
                           float dz, int k, int nx, int ny, int nz, int pre,
                           cudaStream_t stream) {
  const int n1 = nx + (branch == kVx ? 1 : 0);
  const int n2 = ny + (branch == kVy ? 1 : 0);
  const int n3 = nz + (branch == kVz ? 1 : 0);
  const Field fa{a, n1, n2, n3};
  const dim3 grid = ns3d::grid_for(n1, n2, n3);
  const dim3 block = ns3d::block_shape();
  if (pre) {
    const Field fvx{vx, n1, n2, n3};
    const Field fvy{vy, n1, n2, n3};
    const Field fvz{vz, n1, n2, n3};
    advect_kernel<true><<<grid, block, 0, stream>>>(branch, fa, fvx, fvy, fvz, out, n_clamped, dt, dx, dy, dz, k);
  } else {
    const Field fvx{vx, nx + 1, ny, nz};
    const Field fvy{vy, nx, ny + 1, nz};
    const Field fvz{vz, nx, ny, nz + 1};
    advect_kernel<false><<<grid, block, 0, stream>>>(branch, fa, fvx, fvy, fvz, out, n_clamped, dt, dx, dy, dz, k);
  }
  return static_cast<int>(cudaGetLastError());
}
