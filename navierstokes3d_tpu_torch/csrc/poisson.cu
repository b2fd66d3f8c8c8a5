// K1: one damped pseudo-transient Poisson iteration with the boundary
// conditions folded into the stencil, K2: the same iteration on a
// double-single (hi, lo) pressure pair, K7: the iteration followed by the
// reference's boundary-condition sequence, as compat mode and the
// dma-mode solve run it, K8: s folded iterations per launch, K10: nit
// of them in one cooperative launch, K12: nit of K2's in one, and K13:
// the compensated residual of the accuracy phases.
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
// iterations that are not checked.
//
// K8 replaces the Pallas kernels of navierstokes3d_tpu/kernels/poisson.py:836
// (`mk_sweep_fn`'s `kernelS` :756, the lane-tiled s-sweep) and :1007
// (`kernel2` :967, the untiled two-sweep): s chained folded iterations per
// device-memory round trip (temporal blocking), 2 <= s <= 4. Per cell and
// per sweep the arithmetic is K1's exactly (lap_folded, resid,
// dpr*decay + dtau*resid, pc + dtau*d; off the interior d = 0 and
// pc + dtau*0.0f at EVERY sweep), so one launch is bitwise equal to s K1
// launches. The check value is the residual entering the LAST sweep,
// reduced over each tile's own interior cells (a recomputed halo cell
// holds partial data and never enters the max): the value the s-th K1
// launch would emit. Design (the K8 section below: tile, region, bytes
// per cell, thread maps, pipeline): a block streams one (y, z) region of
// tiles along a segment of x, each plane's copies landing two planes
// ahead, and computes level j of the plane j behind the newest one, for
// j = 1..s, with one block barrier per plane; each thread owns a run of
// four z-consecutive cells of a region row at every level, whose x and z
// neighbours, dpr and rhs stay in its registers. Bound: device-memory
// bytes, K1's 5 x 4 B per cell for s iterations.
//
// K10 replaces the Pallas kernel of navierstokes3d_tpu/kernels/poisson.py:1151
// (`make_resident` :1066, `kernelR` :1116): nit folded iterations in ONE
// launch, pr and dpr updated in place, emitting the check value of the
// state entering the last iteration (what the flagged K1 launch closing a
// chunk emits). The TPU kernel's idea is residency: pr, dpr and rhs are
// copied into VMEM once, nit sweeps run there with no per-iteration HBM
// traffic, and two copies go out. On this card the fast memory is each
// SM's shared memory (227 KB a block), too small for the whole state, so
// K10 keeps dpr there: a cooperative grid of one block of 1024 threads
// per SM (kernels/poisson.py `resident_plan`; 255x153x153: 23.9 MB of
// dpr, a region of at most 6 x 32 (y, z) columns through all 255 planes,
// 195,840 B, in each of 130 blocks). Each block owns its region's columns
// for all nit iterations, loads their dpr once and writes it once; pr
// ping-pongs through device memory (L2) and rhs streams, so an iteration
// moves 12 B per cell instead of K1's 20. Each thread streams one
// column's run of planes along x, its x neighbours in registers. A grid
// barrier (cooperative_groups' this_grid().sync(), ~1.1 us) separates the
// iterations. Where the largest region's dpr through every plane does not
// fit a block (511x307x307: 24 x 32 columns through 511 planes, 1.57 MB)
// there is no K10, as the JAX package has none above its VMEM budget. Per
// cell and iteration K10 computes K1's arithmetic in K1's order, so a
// launch is bitwise nit K1 launches; the check value is K1's (float bits
// as unsigned, block max). The folded loops run all their check
// intervals in one launch: after each check a grid barrier, then every
// block takes the loop's exit decision (err < eps_it, a non-finite err,
// the stall window, the budget) from the check values on the card, so
// the host reads once a loop (ptloop.py `pt_loop_device`), where the JAX
// package's loop is one lax.while_loop on the device. Bound:
// device-memory bytes, 12 B per cell and iteration.
//
// K12 replaces no TPU kernel: it is K10's design carried over to K2's
// (hi, lo) iteration, nit of K2's iterations in one cooperative launch
// under K10's plan, hi, lo and dpr updated in place, emitting the check
// value of the state entering the last iteration (what K2 emits when
// launched with the check on that iteration). It exists because K2, one
// launch an iteration, moves dpr through device memory every iteration
// (8 of its 28 B a cell) and costs a launch and a dispatch gap each:
// ~24 ms of the multi preset's step at 255x153x153 (PERF.md). K12 keeps
// dpr in shared memory for the whole launch; hi and lo ping-pong through
// device memory (L2) and rhs streams: 20 B per cell and iteration. Per
// cell and iteration it computes K2's arithmetic in K2's order, so a
// launch is bitwise nit K2 launches. K2 stays: the stored-state
// guarantee, the trailing partial chunk, grids without a resident plan
// and the distributed solve still run it. Bound: device-memory bytes,
// 20 B per cell and iteration.
//
// K13 replaces no TPU kernel: the compensated folded residual, which XLA
// computes in the JAX package (navierstokes3d_tpu/kernels/poisson.py:1362
// `compensated_residual`, models/chorin.py:909 `_comp_residual_fn`). Per
// interior cell, for each of the six neighbours, with ops/ds.py's
// error-free transformations:
//   (dh, dl) = two_sum(nb, -pc)         [+ (nb_lo - pc_lo) into dl: W = 2]
//   (p, e)   = weighted_term(dh, dl, the neighbour's weight quad)
// then the compensated sum of the six (p, e) pairs and (-rhs_hi, -rhs_lo)
// (two_sum of the running sum, the errors summed beside it), r = s + c.
// W = 1, the defect phase's restart from phase 1's pressure, takes the
// Pallas path's order x+, x-, y+, y-, z+, z- and writes r on the whole
// grid, 0 off the interior; W = 2, the stored (hi, lo) pair's residual
// (the stored-state guarantee, stored_residual_err, the fdm refinement,
// the dma-mode pair solve), the order x-, x+, y-, y+, z-, z+ and r on the
// interior, or only the max. Both reduce max |r| as K1 reduces its check
// value. Every operation rounds on its own in the plain version's order
// (--fmad=false), so r and the max are bitwise the plain version's.
// What bounds it on this card: it moves 16 B a cell (the words and the
// rhs pair read, r written for W = 1: 770.6 MB at 511x307x307, 0.230 ms
// at 3.35 TB/s) against ~190 float32 adds and multiplies a cell that
// --fmad=false keeps from pairing into FMAs: at one a lane and clock,
// ~0.27 ms at 511, so instruction issue weighs as much as the bytes. The
// design (the K13 section below) spends few instructions beside that
// arithmetic: each neighbour difference once, the words streamed along x
// (x neighbours in registers, y and z neighbours from a staged plane, one
// barrier a plane), the weight quads loaded once a block, no branch on
// the boundary ring.
//
// K7 replaces the Pallas kernel of navierstokes3d_tpu/kernels/poisson.py:914
// built with folded=False (`kernel` :872, `compute_slab` :334,
// `lap_of_rows` :241, `apply_bc_rows` :257). Per interior cell, in
// lap_of_rows's order:
//   lap   = ((p[x+1]-pc) + (p[x-1]-pc))*inv_dx2
//   lap  += ((p[y+1]-pc) + (p[y-1]-pc))*inv_dy2
//   lap  += ((p[z+1]-pc) + (p[z-1]-pc))*inv_dz2
//   resid = lap - rhs;  d = dpr*decay + dtau*resid;  q = pc + dtau*d
// and off the interior d = 0 and q = pc + dtau*0. The updated field then
// takes set_bc_Pr!'s sequence: x copies (zero_grad_x, the multi variant),
// y copies, z copies each plus its constant (added only where nonzero, as
// the Pallas kernel does), then the Dirichlet x planes. Composed over the
// axes in that order, every ring cell ends as q at its clamped source
// cell (x clamped only where x is zero-gradient) plus the z constant of
// its z face, or as a Dirichlet plane value.
// The race this raises: a ring cell needs its source's UPDATED value,
// which depends on the source's old dpr, while the source's own thread
// writes the new dpr. K7 therefore ping-pongs dpr as well as pr (reads
// dpr, writes dpr_out: the same 5 x 4 B per cell as K1's in-place update),
// and a ring cell takes its source's update from the thread that computed
// it, through a shared tile (the K7 section below). One launch writes
// every cell of both outputs. It reduces nothing: compat's check value is
// a separate residual evaluation (torch ops), once per chunk. Bound:
// device-memory bytes, as K1 (~120 MB per launch at 255x153x153).
//
// K7-dist and K2-dist replace the same call sites built for one shard of
// an x-decomposed mesh (build_poisson_iter(local_rows=bx): `rows_of` :503,
// `p_ext_of` :515, the `dist` operands :874-883 and :1193-1202), which the
// distributed Poisson solve runs per shard (parallel/halo.py:238-270).
// K7-dist is K7 on a shard of bx owned x-planes at global offset x_off;
// K2-dist iterates the (hi, lo) pair there with the unfolded Laplacian
// (`compute_slab_ext` :353):
//   resid = (lap_h - rhs) + lap_l;  d = dpr*decay + dtau*resid
//   u = lo + dtau*d;  (hi', lo') = two_sum(hi, u)
// then set_bc_Pr!'s sequence on hi with the BC constants and on lo with
// their lo words: the z offsets' (hi, lo) split, 0 on the Dirichlet x
// planes. A cell updates only where its GLOBAL position x_off + lx is
// interior, and every BC guard keys on the global position, so each shard
// applies exactly its own piece of the sequence. Layout: native 3D, x
// slowest; the shard's two x-halo planes (the -x neighbour's last owned
// plane and the +x neighbour's first) are separate (ny, nz) operands, one
// pair per word, null at an open global face (nothing reads them there:
// only interior cells take the Laplacian). On a check iteration the
// kernel reduces the max |resid| over the shard's interior cells (the
// residual of the state entering the iteration, as K1), which the caller
// max-reduces over the mesh. K7, K7-dist and K2-dist are one kernel
// template over the number of pressure words (K7: one word at x_off = 0,
// bx = nx, without halo planes or the check). Bytes bound as K7 (5 x 4 B
// per cell) and K2 (7 x 4 B per cell: hi, lo, dpr, rhs in; hi', lo', dpr'
// out) plus the halo planes.
#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace {

struct Weights {
  const float* yp;
  const float* ym;
  const float* zp;
  const float* zm;
};

// The folded Laplacian at an interior cell in lap_of_rows_folded's order,
// from its value pc, its six neighbours' values and its weights wyp..wzm
// (its entries of the y and z weight rows); drop_xm replaces the x-1
// term by 0 (a select, as the Pallas kernel does).
__device__ inline float lap_folded(float xpv, float xmv, float ypv,
                                   float ymv, float zpv, float zmv, float pc,
                                   bool drop_xm, float inv_dx2, float wyp,
                                   float wym, float wzp, float wzm) {
  const float xp = xpv - pc;
  const float xm = drop_xm ? 0.0f : xmv - pc;
  float lap = (xp + xm) * inv_dx2;
  lap = lap + ((ypv - pc) * wyp + (ymv - pc) * wym);
  lap = lap + ((zpv - pc) * wzp + (zmv - pc) * wzm);
  return lap;
}

// lap_folded at interior cell i of a canonical field p (x-stride sx,
// y-stride sy), at (y, z) for the weight rows.
__device__ inline float lap_folded_at(const float* __restrict__ p, long i,
                                      long sx, int sy, int y, int z,
                                      float pc, bool drop_xm, float inv_dx2,
                                      const Weights& w) {
  return lap_folded(p[i + sx], p[i - sx], p[i + sy], p[i - sy], p[i + 1],
                    p[i - 1], pc, drop_xm, inv_dx2, w.yp[y], w.ym[y],
                    w.zp[z], w.zm[z]);
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
      const float lap = lap_folded_at(pr, i, sx, nz, y, z, pc,
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
      const float lap_h = lap_folded_at(hi, i, sx, nz, y, z, hc, drop_xm,
                                        inv_dx2, w);
      const float lap_l = lap_folded_at(lo, i, sx, nz, y, z, lc, drop_xm,
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

// ---- K8: s folded iterations per launch, streamed along x ----
//
// What bounds it on this card: device-memory bytes. One launch reads pr,
// dpr and rhs and writes pr_out and dpr_out, 5 x 4 B per cell for s
// iterations (963 MB at 511x307x307, 0.2875 ms at 3.35 TB/s); its s x 22
// flops per cell take a fifth of that at the float32 rate.
//
// Tile and region. The wrapper's plan (kernels/poisson.py `sweep_plan`)
// cuts (y, z) into tiles of uy x uz cells and x into segments; a block
// owns one tile and one segment. Level j of the s sweeps is needed on the
// tile grown by s - j cells per side, so the block streams the REGION
// (uy + 2s) x (uz + 2s) through shared memory, plane by plane, from s
// planes before its segment to s planes after it. At 511x307x307, s = 3:
// tiles of 28 x 52 in 34 x 58 regions, 11 x 6 tiles x 2 segments of 256
// planes = 132 blocks, one per SM, one wave. The region's own bytes per
// output cell: pr 34 x 58 / (28 x 52) = 1.35 reads, dpr and rhs 32 x 56 /
// (28 x 52) = 1.23 (a region's edge cells take no update), times 262 / 256
// planes: 15.6 B read + 8 B written = 23.6 B against the bound's 20 B, a
// ceiling of 85% if every halo byte came from device memory. All blocks
// start together and walk x at one rate, so the tiles on both sides of a
// halo row read it within microseconds, the second time from L2.
//
// The compute map: runs of z. A thread owns one RUN of kSweepRun = 4
// z-consecutive cells of one region row, the same at every level and
// plane. A row of the region is padded in shared memory to whole runs
// (w rounded up to a multiple of 4 floats), so thread tid's run starts at
// float 4 * tid of every plane and each run is one 16-byte word: 34 rows
// x 15 runs = 510 of the 512 threads at 511x307x307, s = 3. Per level
// and plane a thread issues two 16-byte shared loads (its y + 1 and y - 1
// rows), two 4-byte loads (the z neighbours past the run's ends) and one
// 16-byte store of the level's plane; the z neighbours inside the run are
// its own registers, level 0's pr, dpr and rhs are three 16-byte loads of
// the ring, and the run's four cells share one base offset and one pair
// of y weights. Every cell of a run computes every level (branch-free, so
// the four interleave) and the whole run is stored: a cell outside the
// level's shrinking region holds a value no covered cell reads. The map
// it replaces gave a thread four cells 512 apart, each with its own
// offsets, weights, predicate and four scalar neighbour loads a level
// (889 SASS instructions a plane at s = 3; 0.545 ms a launch, 52.7% of
// the bound).
//
// The copy map. The copies and the writes out keep the old map: thread
// tid copies cells tid + k x 512 of the padded plane, so that one
// instruction of a warp touches consecutive addresses (in the run map its
// 4-byte accesses lie 16 B apart: four times the lines and a four-way
// bank conflict on the shared side; that form took 0.80 ms). So level S's
// pr and dpr go out through shared memory: the run map stores them as
// 16-byte words into a staging plane (two per field, by parity), and the
// next step writes them to pr_out and dpr_out in the copy map.
//
// Loads. 4-byte cp.async (pr of every cell in the domain, dpr and rhs of
// the cells a level updates; a row of the native layout starts on no
// 16-byte boundary at nz = 307) into a ring of four slots: planes t + 2
// and t + 1 in flight, t and t - 1. Every cell of the copy map issues its
// three copies, those it does not need with a source size of 0 (they
// fill zeros and read nothing), so that no copy sits behind a branch:
// 0.449 against 0.487 ms a launch at s = 3 with the copies branched on
// (PERF.md); copying real bytes for those cells instead took 0.533 (10%
// more bytes from L2). The step issues its copies and its writes out
// after its arithmetic at s = 2, 3 and before it at s = 4 (as measured:
// at s = 3 with branched copies 0.488 ms, with them first 0.509, with one
// plane in flight 0.639, with three 0.489). (A TMA form, one box of a
// rank-1 tensor map per region row completing on an mbarrier, came first
// and took 1.27-1.33 ms per s = 3 launch: on the H100 a box must start on
// a 16-byte boundary, which a row of the native layout does not at nz =
// 307, and the ~90 small boxes a plane needs are issued one by one; a
// 16-byte cp.async form with the same row phases took 0.86 ms; PERF.md.)
//
// What bounds it now (scripts/k8_probe.py --cut, s = 3 at
// 511x307x307): 0.448 ms a launch, 64% of the bound; the levels'
// arithmetic and barriers alone take 0.311 ms, the copies and writes
// alone 0.369 ms (scripts/copy_ceiling.cu over the same 963 MB: 0.339
// ms), a launch without the copies 0.366 ms, without the writes 0.380:
// the two overlap only in part. Both go through the SM's one load/store
// path with the levels' shared loads and stores, in one block of 16 warps
// (128 registers a thread: no room for more warps or for copy warps).
//
// One block barrier per plane. Level j at step t computes plane t - j from
// level j-1's planes t-j-1, t-j and t-j+1 of its own run, which the same
// thread holds in registers (a queue three deep per level), and from the
// y neighbours and the run's two outer z neighbours of plane t-j, which
// level j-1 wrote to shared memory in step t-1. Each level's plane is
// double-buffered by parity, so the barrier that starts step t orders
// every write of step t-1 before its reads and every read of step t-1
// before the next write into the slot; it also publishes plane t, whose
// copies each thread has waited for. A cell's dpr and rhs wait in
// registers (a queue s deep each) for the level that needs them. Both
// outputs ping-pong with the inputs: neighbouring blocks read the inputs
// over their halos, so neither output may alias an input.

constexpr int kSweepThreads = 512;  // threads of a K8 block (16 warps)
constexpr int kSweepRun = 4;        // z-consecutive cells a thread owns
constexpr int kSweepCells = kSweepThreads * kSweepRun;  // most in a plane
constexpr int kSweepAhead = 2;      // planes whose copies are in flight
// ring slots: planes t + kSweepAhead .. t + 1 (in flight), t and t - 1
constexpr int kSweepRing = kSweepAhead + 2;

// The wrapper's plan (kernels/poisson.py SweepPlan, same fields).
struct SweepPlan {
  int uy, uz;            // a tile's own rows (y) and lanes (z)
  int tiles_y, tiles_z;  // tiles per axis
  int seg;               // planes per x segment (the last may be shorter)
};

// The region and shared-memory geometry of a plan at depth S: a plane is
// the region's ry rows of `runs` runs, each row padded to wp = 4 x runs
// floats (cell (r, zc) at r * wp + zc; thread tid's run at 4 * tid).
template <int S>
struct SweepGeom {
  int ry, w, runs, wp, plane;
  size_t smem;
  __host__ __device__ explicit SweepGeom(const SweepPlan& p)
      : ry(p.uy + 2 * S), w(p.uz + 2 * S),
        runs((w + kSweepRun - 1) / kSweepRun), wp(runs * kSweepRun),
        plane(ry * wp),
        // the ring (three fields of kSweepCells per slot), two planes per
        // level 1..S-1, two per field of level S on its way out, 32 words
        // of reduction scratch
        smem(sizeof(float) * (3 * kSweepRing * kSweepCells +
                              plane * (2 * (S - 1) + 4)) +
             4 * 32) {}
};

__device__ inline float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <int S>
__global__ void __launch_bounds__(kSweepThreads, 1) poisson_sweeps_kernel(
    const float* __restrict__ pr, const float* __restrict__ dpr,
    const float* __restrict__ rhs, float* __restrict__ pr_out,
    float* __restrict__ dpr_out, Weights wt, float inv_dx2, float dtau,
    float decay, int zero_grad_x, int nx, int ny, int nz, SweepPlan p,
    unsigned int* __restrict__ err_bits) {
  constexpr int R = kSweepRun;
  const SweepGeom<S> g(p);
  // [slot][field][kSweepCells] of the ring, then [level-1][parity][plane] of
  // levels 1..S-1, then [field][parity][plane] of level S's pr and dpr on
  // their way out, then the reduction scratch; every plane 16 B aligned
  extern __shared__ float4 sweep_smem[];
  float* const ring = reinterpret_cast<float*>(sweep_smem);
  float* const lev = ring + 3 * kSweepRing * kSweepCells;
  float* const outs = lev + 2 * (S - 1) * g.plane;
  unsigned int* const red =
      reinterpret_cast<unsigned int*>(outs + 4 * g.plane);

  // the block's tile and segment
  int b = blockIdx.x;
  const int tz = b % p.tiles_z;
  b /= p.tiles_z;
  const int ty = b % p.tiles_y;
  const int xb = b / p.tiles_y * p.seg;
  const int xe = min(xb + p.seg, nx);
  const int y0 = ty * p.uy - S;  // the region's first row and lane
  const int z0 = tz * p.uz - S;
  const long sx = static_cast<long>(ny) * nz;
  // planes loaded: [l0, l1)
  const int l0 = max(xb - S, 0);
  const int l1 = min(xe + S, nx);
  const int tid = threadIdx.x;

  // The copy map: the thread copies, and writes out, cells c = tid + k x
  // kSweepThreads of the padded plane (R of them: a plane holds at most
  // kSweepThreads runs), so that a warp's cp.async and stores touch
  // consecutive addresses. cdepth: the deepest level the cell takes, -1
  // outside the domain or the region, or past the plane; coff: its offset
  // in a plane of the inputs and outputs, clamped into the domain, so that
  // every copy has an address and none waits on a branch: a copy the cell
  // does not need fills zeros and reads nothing (a ring slot's fields
  // hold kSweepCells each, so the cells past the plane land in them).
  int cdepth[R], coff[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int c = tid + k * kSweepThreads;
    const int rr = c / g.wp, zc = c - rr * g.wp;
    const int gy = y0 + rr, gz = z0 + zc;
    const bool in = c < g.plane && zc < g.w && gy >= 0 && gy < ny &&
                    gz >= 0 && gz < nz;
    cdepth[k] = in ? min(min(rr, g.ry - 1 - rr), min(zc, g.w - 1 - zc)) : -1;
    coff[k] = min(max(gy, 0), ny - 1) * nz + min(max(gz, 0), nz - 1);
  }

  // The compute map: the thread's run, row r, lanes zc0 .. zc0 + R - 1; a
  // thread past the region's runs owns none, reads row 0 and stores
  // nothing
  const bool owns = tid < g.ry * g.runs;
  const int r = owns ? tid / g.runs : 0;
  const int zc0 = owns ? (tid - r * g.runs) * R : 0;
  const int o = r * g.wp + zc0;
  // its neighbours' offsets, kept inside the plane at the region's edges
  // (the cells there take no level)
  const int oym = r > 0 ? o - g.wp : o;
  const int oyp = r + 1 < g.ry ? o + g.wp : o;
  const int ozm = zc0 > 0 ? o - 1 : o;
  const int ozp = zc0 + R < g.wp ? o + R : o + R - 1;
  const int gy = y0 + r, gz0 = z0 + zc0;
  const bool y_ok = owns && gy >= 0 && gy < ny;
  const bool y_in = gy >= 1 && gy <= ny - 2;
  const int rdepth = min(r, g.ry - 1 - r);
  const float wyp = y_ok ? wt.yp[gy] : 0.0f;
  const float wym = y_ok ? wt.ym[gy] : 0.0f;
  // per cell of the run: whether it reaches level S and is interior in
  // (y, z) (its residual enters the check), and its z weights
  bool last[R], yz_in[R];
  float wzp[R], wzm[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int zc = zc0 + k, gz = gz0 + k;
    const bool in = y_ok && zc < g.w && gz >= 0 && gz < nz;
    last[k] = in && min(rdepth, min(zc, g.w - 1 - zc)) >= S;
    yz_in[k] = y_in && gz >= 1 && gz <= nz - 2;
    wzp[k] = in ? wt.zp[gz] : 0.0f;
    wzm[k] = in ? wt.zm[gz] : 0.0f;
  }

  // per level j-1 = 0..S-1, entering step t: its values of planes
  // t-j (p1) and t-j-1 (p2); the dpr of plane t-j after j-1 levels (dq)
  // and the rhs of plane t-j (rq)
  float p1[S][R], p2[S][R], dq[S][R], rq[S][R];
#pragma unroll
  for (int j = 0; j < S; ++j)
#pragma unroll
    for (int k = 0; k < R; ++k)
      p1[j][k] = p2[j][k] = dq[j][k] = rq[j][k] = 0.0f;
  unsigned int bits = 0u;

  // plane x into ring slot `slot`: pr of every cell in the domain, dpr
  // and rhs of those a level updates, zeros for the rest
  auto load = [&](int x, int slot) {
    float* const dst = ring + slot * 3 * kSweepCells + tid;
    const float* const px = pr + x * sx;
    const float* const dx = dpr + x * sx;
    const float* const rx = rhs + x * sx;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      float* const d = dst + k * kSweepThreads;
      ns3d::cp_async4(d, px + coff[k], cdepth[k] >= 0);
      ns3d::cp_async4(d + kSweepCells, dx + coff[k], cdepth[k] >= 1);
      ns3d::cp_async4(d + 2 * kSweepCells, rx + coff[k], cdepth[k] >= 1);
    }
  };

  // level S's plane xs from its staging planes to pr_out and dpr_out
  auto write_out = [&](int xs) {
    if (xs < xb || xs >= xe) return;
    const float* const sq = outs + (xs & 1) * g.plane + tid;
    const float* const sd = sq + 2 * g.plane;
    float* const pox = pr_out + xs * sx;
    float* const dox = dpr_out + xs * sx;
#pragma unroll
    for (int k = 0; k < R; ++k)
      if (cdepth[k] >= S) {
        pox[coff[k]] = sq[k * kSweepThreads];
        dox[coff[k]] = sd[k * kSweepThreads];
      }
  };

  // The step's memory work: the copies of plane t + kSweepAhead (into the
  // slot plane t - 2 left) and the writes of level S's plane t - S - 1,
  // which step t-1 left in the staging planes of its parity. It follows
  // the step's arithmetic, except at s = 4, where it precedes it: 0.453-
  // 0.460 against 0.463 ms a launch at s = 3, 0.895 against 1.057 at s = 4
  // (PERF.md).
  constexpr bool memory_first = S >= 4;
  auto memory_work = [&](int t, int slot) {
    if (t + kSweepAhead < l1)
      load(t + kSweepAhead, (slot + kSweepAhead) % kSweepRing);
    ns3d::cp_async_commit();
    write_out(t - S - 1);
  };

  // planes l0 .. l0 + kSweepAhead - 1 in flight; one group of copies a
  // plane, empty past l1, so that step t waits for plane t by count
#pragma unroll
  for (int a = 0; a < kSweepAhead; ++a) {
    if (l0 + a < l1) load(l0 + a, a);
    ns3d::cp_async_commit();
  }
  // step t computes level j of plane t - j, j = 1..S, from plane t (level
  // 0) and the levels' planes of step t-1, and does its memory work;
  // plane t sits in ring slot `slot`, plane t - 1 in `prev`. The last step
  // only writes out.
  int slot = 0, prev = kSweepRing - 1;
  for (int t = l0; t <= xe + S; ++t) {
    // this thread's copies of plane t (those of later planes may fly on)
    ns3d::cp_async_wait<kSweepAhead - 1>();
    __syncthreads();
    if (memory_first) memory_work(t, slot);
    float cur[S][R];  // level j's value of plane t - j (j = 0: loaded)
    float dnew[S][R];
    float rnew[R];
    if (t < l1) {
      const float* const s = ring + slot * 3 * kSweepCells + o;
      const float4 a = ld4(s), c = ld4(s + kSweepCells),
                   e = ld4(s + 2 * kSweepCells);
      cur[0][0] = a.x, cur[0][1] = a.y, cur[0][2] = a.z, cur[0][3] = a.w;
      dnew[0][0] = c.x, dnew[0][1] = c.y, dnew[0][2] = c.z, dnew[0][3] = c.w;
      rnew[0] = e.x, rnew[1] = e.y, rnew[2] = e.z, rnew[3] = e.w;
    } else {
#pragma unroll
      for (int k = 0; k < R; ++k) cur[0][k] = dnew[0][k] = rnew[k] = 0.0f;
    }
#pragma unroll
    for (int j = 1; j <= S; ++j) {
      const int x = t - j;
      const bool active =
          x >= max(xb - (S - j), 0) && x < min(xe + (S - j), nx);
      if (!active) {  // keep the queues defined
        if (j < S) {
#pragma unroll
          for (int k = 0; k < R; ++k) {
            cur[j][k] = p1[j][k];
            dnew[j][k] = dq[j][k];
          }
        }
        continue;
      }
      const bool x_in = x >= 1 && x <= nx - 2;
      const bool drop_xm = zero_grad_x && x == 1;
      // level j-1's plane x: the ring slot (j = 1) or its parity buffer
      const float* const src =
          j == 1 ? ring + prev * 3 * kSweepCells
                 : lev + (2 * (j - 2) + (x & 1)) * g.plane;
      const float4 yp4 = ld4(src + oyp), ym4 = ld4(src + oym);
      const float ypv[R] = {yp4.x, yp4.y, yp4.z, yp4.w};
      const float ymv[R] = {ym4.x, ym4.y, ym4.z, ym4.w};
      const float zlo = src[ozm], zhi = src[ozp];
      float q[R], d[R];
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const float pc = p1[j - 1][k];
        // z neighbours inside the run from registers, past its ends from
        // shared memory; K1's expressions in K1's order (poisson_iter_kernel)
        const float zmv = k == 0 ? zlo : p1[j - 1][k - 1];
        const float zpv = k == R - 1 ? zhi : p1[j - 1][k + 1];
        const float lap = lap_folded(cur[j - 1][k], p2[j - 1][k], ypv[k],
                                     ymv[k], zpv, zmv, pc, drop_xm, inv_dx2,
                                     wyp, wym, wzp[k], wzm[k]);
        const float resid = lap - rq[j - 1][k];
        const bool in = x_in && yz_in[k];
        d[k] = in ? dq[j - 1][k] * decay + dtau * resid : 0.0f;
        q[k] = pc + dtau * d[k];
        if (j < S) {
          cur[j][k] = q[k];
          dnew[j][k] = d[k];
        } else {
          const unsigned int e = __float_as_uint(fabsf(resid));
          bits = last[k] && in && e > bits ? e : bits;
        }
      }
      // level j's plane x, for level j + 1 or (j = S) for writing out
      float* const dst = j < S ? lev + (2 * (j - 1) + (x & 1)) * g.plane
                               : outs + (x & 1) * g.plane;
      if (owns) {
        *reinterpret_cast<float4*>(dst + o) =
            make_float4(q[0], q[1], q[2], q[3]);
        if (j == S)
          *reinterpret_cast<float4*>(dst + 2 * g.plane + o) =
              make_float4(d[0], d[1], d[2], d[3]);
      }
    }
    if (!memory_first) memory_work(t, slot);
    prev = slot;
    slot = (slot + 1) % kSweepRing;
    // advance the queues by one plane
#pragma unroll
    for (int k = 0; k < R; ++k) {
#pragma unroll
      for (int j = S - 1; j >= 1; --j) rq[j][k] = rq[j - 1][k];
      rq[0][k] = rnew[k];
#pragma unroll
      for (int j = 0; j < S; ++j) {
        p2[j][k] = p1[j][k];
        p1[j][k] = cur[j][k];
        dq[j][k] = dnew[j][k];
      }
    }
  }
  if (err_bits == nullptr) return;
  // the block's max into *err_bits (float bits as unsigned: the order of
  // non-negative floats, a NaN above +inf)
  bits = ns3d::warp_max(bits);
  if ((tid & 31) == 0) red[tid >> 5] = bits;
  __syncthreads();
  if (tid < 32) {
    bits = ns3d::warp_max(tid < kSweepThreads / 32 ? red[tid] : 0u);
    if (tid == 0 && bits != 0u) atomicMax(err_bits, bits);
  }
}

// One K8 launch at depth S under plan p.
template <int S>
cudaError_t launch_sweeps(const float* pr, const float* dpr, const float* rhs,
                          float* pr_out, float* dpr_out, const Weights& w,
                          float inv_dx2, float dtau, float decay,
                          int zero_grad_x, int nx, int ny, int nz,
                          const SweepPlan& p, unsigned int* err_bits,
                          cudaStream_t stream) {
  const SweepGeom<S> g(p);
  // the plan must cover the grid with regions the block can hold
  if (p.uy < 1 || p.uz < 1 || p.seg < 1 ||
      static_cast<long>(p.tiles_y) * p.uy < ny ||
      static_cast<long>(p.tiles_z) * p.uz < nz ||
      g.ry * g.runs > kSweepThreads)
    return cudaErrorInvalidValue;
  const int segs = (nx + p.seg - 1) / p.seg;
  // raise the block's shared-memory limit once per depth and device (past
  // 48 KB it must be allowed explicitly)
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  static size_t allowed[64] = {};
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (g.smem > allowed[dev]) {
    e = cudaFuncSetAttribute(poisson_sweeps_kernel<S>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(g.smem));
    if (e != cudaSuccess) return e;
    allowed[dev] = g.smem;
  }
  if (err_bits != nullptr &&
      (e = cudaMemsetAsync(err_bits, 0, sizeof(unsigned int), stream)) !=
          cudaSuccess)
    return e;
  const int blocks = p.tiles_y * p.tiles_z * segs;
  poisson_sweeps_kernel<S><<<blocks, kSweepThreads, g.smem, stream>>>(pr, dpr, rhs, pr_out, dpr_out, w, inv_dx2, dtau, decay, zero_grad_x, nx, ny, nz, p, err_bits);
  return cudaGetLastError();
}

// ---- K10: nit folded iterations in one launch, resident on chip ----

// threads of a block (at most one column each), the z cells of a
// region's row (one warp), and the planes whose loads a thread issues
// before their arithmetic
constexpr int kResidentThreads = 1024;
constexpr int kResidentLanes = 32;
constexpr int kResidentUnroll = 3;

// Part i of n cut into `parts` parts whose sizes differ by at most one
// (kernels/poisson.py `balanced_part`).
struct Part {
  int start, size;
};

__host__ __device__ inline Part balanced_part(int n, int parts, int i) {
  const int q = n / parts, r = n % parts;
  return {i * q + (i < r ? i : r), q + (i < r ? 1 : 0)};
}

// One block of kResidentThreads threads per SM, x-streamed columns.
//
// Why columns and not K1's 32 x 8 (z, y) tiles: a block walking tiles
// issues seven pr loads, one rhs load and four weight loads per cell and
// iteration, steps a tile cursor and runs 8.6% of its slots on padding at
// 153 = 4 x 32 + 25 lanes; cut apart on the card (PERF.md), the index
// work, weight loads and padding took ~7.7 us of its ~40 us an iteration
// at 255x153x153, the x neighbours' L2 re-reads only ~1.4 us.
//
// Bound: device-memory bytes, 12 B per cell and iteration (pr in, pr out,
// rhs in; dpr stays on chip): 21.4 us at 255x153x153 and 3.35 TB/s, and
// 21.7-22.1 us measured as a warm copy of the pr pair (PERF.md).
//
// Design. The (y, z) column plane is cut into gridDim.x = cut_y x cut_z
// regions, one per block (kernels/poisson.py `grid_cut`): z into rows of
// kResidentLanes = 32 cells, a warp's width (cut_z = ceil(nz / 32), the
// last row the remainder), y into cut_y balanced parts; the block owns
// its region's columns through all nx planes. Its column slots are
// row-major, 32 a row, so each warp stands on one row segment of 32
// consecutive z: a warp's loads touch two 128 B lines, where a warp on
// the rows of a narrower region spreads them over two or three rows (the
// lines a warp touches set the time: a balanced 13 x 14 region took 7.00 ms at nit
// 152, 7 x 26 5.60, these rows 5.01, PERF.md). Each thread owns one column
// and a fixed run of consecutive planes balanced_part(nx, runs, run),
// runs = kResidentThreads / column slots (at most nx), the same in every
// iteration. Along its run a thread carries x - 1, x and x + 1 in
// registers, so each pr value is loaded once an iteration by its owner
// (only a run's first and last planes read an x neighbour from memory);
// its column's four weights, interior flag and index are registers for
// the whole launch; the y and z neighbours are the neighbouring threads'
// own cells (L1, L2 at the region's edges); the loads of kResidentUnroll
// planes issue before their arithmetic (1, 2, 3 and 4 took 7.27, 5.01,
// 4.74 and 4.93 ms; y and z neighbours from warp shuffles and a software
// pipeline were slower). The region's dpr sits in shared memory at plane
// x * slots + slot: a warp's slots are consecutive, conflict free, and
// the block needs slots x nx x 4 B (192 x 255 x 4 = 195,840 B at
// 255x153x153 on 132 SMs, cut 26 x 5: 130 blocks of 5-6 rows, 5 runs of
// 51 planes a column; the rest of the SM's 256 KB, ~60 KB, is the L1
// that the y and z neighbour reads hit).
//
// pr ping-pongs between pr_a (the caller's tensor, which holds the result
// at the end of every check interval) and pr_b (scratch). Neither is
// declared const or __restrict__: each is written during the launch, so
// neither may be read through the read-only (non-coherent) cache, whose
// lines a grid barrier does not refresh.
//
// The launch runs check intervals of the folded loop (ptloop.py
// `ExitRule`, kernels/poisson.py `poisson_loop_resident`): from global
// iteration it = rule.it0, interval k runs nit = nchk - it % nchk
// iterations (as one launch of that nit would: for an odd nit pr_a is
// first copied into pr_b), reduces the residual entering its last
// iteration into err_bits[k] and, unless it ends the budget, passes a
// grid barrier, after which every block takes the same decision from
// err_bits[0..k] (resident_runs_on). dpr stays in shared memory for the
// whole launch. A launch of nit iterations is the rule {0, nit, nit}: one
// interval, no decision. *checks (where not null) gets the intervals run.
struct ExitRule {
  int it0, niter, nchk;  // it0 < niter, niter a multiple of nchk
  int window;            // the stall window in checks, 0: none
  float eps, scale, thresh, big;
};

// The check value of interval k: its max |resid| (float bits, read in L2,
// where the blocks' atomics landed) times the loop's scale, one float32
// rounding, as the host's torch multiply rounds it.
__device__ inline float resident_err(const unsigned int* bits, int k,
                                     float scale) {
  return __fmul_rn(__uint_as_float(__ldcg(bits + k)), scale);
}

// Whether the loop runs on after its k-th check (k >= 1; the budget is
// not yet spent): pt_loop_fused's `running` in float32, on the check
// values err_bits[0..k-1].
__device__ inline bool resident_runs_on(const ExitRule& r,
                                        const unsigned int* bits, int k) {
  const float err = resident_err(bits, k - 1, r.scale);
  if (!(err >= r.eps) || isinf(err)) return false;
  if (r.window == 0 || k <= r.window) return true;
  const float e0 = resident_err(bits, k - 1 - r.window, r.scale);
  return !(err > __fmul_rn(r.thresh, e0) && e0 < r.big);
}

__global__ void __launch_bounds__(kResidentThreads, 1)
    poisson_resident_grid_kernel(float* pr_a, float* pr_b,
                                 float* __restrict__ dpr,
                                 const float* __restrict__ rhs, Weights w,
                                 float inv_dx2, float dtau, float decay,
                                 int zero_grad_x, int nx, int ny, int nz,
                                 ExitRule rule, int cut_y, int cut_z,
                                 unsigned int* __restrict__ err_bits,
                                 int* __restrict__ checks) {
  namespace cg = cooperative_groups;
  const cg::grid_group grid = cg::this_grid();
  // the region's dpr, plane x of column c at x * cols + c
  extern __shared__ float dsm[];
  // the region: rows ry of y, lanes [z0, z0 + kResidentLanes) of z; its
  // column slots row-major, a warp's slots one row
  const Part ry = balanced_part(ny, cut_y, blockIdx.x / cut_z);
  const int z0 = blockIdx.x % cut_z * kResidentLanes;
  const int cols = ry.size * kResidentLanes;
  const int runs = min(nx, kResidentThreads / cols);
  const int c = threadIdx.x % cols, run = threadIdx.x / cols;
  const int y = ry.start + c / kResidentLanes, z = z0 + c % kResidentLanes;
  // the thread's planes [x0, x1): none past the runs or past nz
  const Part xr = run < runs && z < nz ? balanced_part(nx, runs, run)
                                       : Part{0, 0};
  const int x0 = xr.start, x1 = xr.start + xr.size;
  const int nyz = ny * nz, col = y * nz + z;
  const bool yz_in = y >= 1 && y <= ny - 2 && z >= 1 && z <= nz - 2;
  const float wyp = yz_in ? w.yp[y] : 0.0f, wym = yz_in ? w.ym[y] : 0.0f;
  const float wzp = yz_in ? w.zp[z] : 0.0f, wzm = yz_in ? w.zm[z] : 0.0f;
  float* const dcol = dsm + c;
#pragma unroll 4
  for (int x = x0; x < x1; ++x) dcol[x * cols] = dpr[x * nyz + col];
  int it = rule.it0, k = 0;
  for (;;) {
    const int nit = rule.nchk - it % rule.nchk;
    // an even iteration j reads `even` and writes `odd`, an odd one the
    // reverse; for an odd nit the input is first copied into pr_b, so that
    // the last iteration (j = nit - 1) writes pr_a either way
    float* const even = nit % 2 == 0 ? pr_a : pr_b;
    float* const odd = nit % 2 == 0 ? pr_b : pr_a;
    if (nit % 2 != 0) {
#pragma unroll 4
      for (int x = x0; x < x1; ++x) pr_b[x * nyz + col] = pr_a[x * nyz + col];
    }
    // after the copy, and before the first interval (as a launch of nit
    // iterations has it); a later even interval follows the decision's
    // barrier
    if (nit % 2 != 0 || k == 0) grid.sync();
    unsigned int bits = 0u;
    for (int j = 0; j < nit; ++j) {
      const float* const p = j % 2 == 0 ? even : odd;
      float* const q = j % 2 == 0 ? odd : even;
      const bool last = j == nit - 1;
      // the cell's x - 1 and x values, carried along the run
      float pm = x0 > 0 && x0 < x1 ? p[(x0 - 1) * nyz + col] : 0.0f;
      float pc = x0 < x1 ? p[x0 * nyz + col] : 0.0f;
      for (int xb = x0; xb < x1; xb += kResidentUnroll) {
        // the loads of kResidentUnroll planes, then their arithmetic
        float pn[kResidentUnroll], yp[kResidentUnroll], ym[kResidentUnroll];
        float zp[kResidentUnroll], zm[kResidentUnroll], r[kResidentUnroll];
#pragma unroll
        for (int u = 0; u < kResidentUnroll; ++u) {
          const int x = xb + u;
          const int i = x * nyz + col;
          pn[u] = x < x1 && x + 1 < nx ? p[i + nyz] : 0.0f;
          if (x < x1 && yz_in && x >= 1 && x <= nx - 2) {
            yp[u] = p[i + nz];
            ym[u] = p[i - nz];
            zp[u] = p[i + 1];
            zm[u] = p[i - 1];
            // rhs streams (evict first), so that the pr buffers stay in L2
            r[u] = __ldcs(rhs + i);
          }
        }
#pragma unroll
        for (int u = 0; u < kResidentUnroll; ++u) {
          const int x = xb + u;
          if (x >= x1) continue;
          const int i = x * nyz + col;
          float* const dp = dcol + x * cols;
          // K1's expressions in K1's order (poisson_iter_kernel)
          if (yz_in && x >= 1 && x <= nx - 2) {
            const float lap =
                lap_folded(pn[u], pm, yp[u], ym[u], zp[u], zm[u], pc,
                           zero_grad_x && x == 1, inv_dx2, wyp, wym, wzp, wzm);
            const float resid = lap - r[u];
            const float d = *dp * decay + dtau * resid;
            *dp = d;
            q[i] = pc + dtau * d;
            if (last) {
              const unsigned int b = __float_as_uint(fabsf(resid));
              bits = b > bits ? b : bits;
            }
          } else {
            *dp = 0.0f;
            q[i] = pc + dtau * 0.0f;
          }
          pm = pc;
          pc = pn[u];
        }
      }
      if (!last) grid.sync();
    }
    bits = ns3d::block_max<kResidentThreads>(bits);
    if (ns3d::thread_rank() == 0 && bits != 0u) atomicMax(err_bits + k, bits);
    it += nit;
    ++k;
    if (it >= rule.niter) break;
    // every block's max is in err_bits[k - 1]: all take the same decision
    grid.sync();
    if (!resident_runs_on(rule, err_bits, k)) break;
  }
#pragma unroll 4
  for (int x = x0; x < x1; ++x) dpr[x * nyz + col] = dcol[x * cols];
  if (checks != nullptr && blockIdx.x == 0 && ns3d::thread_rank() == 0)
    *checks = k;
}

// ---- K12: nit of K2's iterations in one launch, resident on chip ----
//
// threads of a block (at most one column each, so K12 runs under K10's
// plans of at most this many column slots a block) and the planes whose
// loads a thread issues before their arithmetic: of 512, 768 and 1024
// threads and 1-3 planes, this form took 8.26 ms at 255x153x153 and nit
// 152, 1024 threads and 2 planes 8.74 (64 registers a thread, the cap),
// 1024 and 3 12.57 (spilled), 768 and 3 8.64, 512 and 3 9.53 (PERF.md)
constexpr int kResidentExtThreads = 768;
constexpr int kResidentExtUnroll = 2;

// K10's grid form with K2's iteration: the same cut, the same column
// slots and runs of planes, dpr of the region in shared memory at plane
// x * slots + slot for the whole launch. A thread carries x - 1, x and x
// + 1 of both words along its run; per plane it loads hi and lo at x + 1
// and at the four y and z neighbours, and rhs (evict first): 11 loads
// where K10 takes 6. hi and lo each ping-pong between the caller's
// tensor (_a, which holds the result at the end) and a scratch tensor
// (_b); none of the four is const or __restrict__, as K10's pr_a and
// pr_b: each is written during the launch, so none may be read through
// the read-only (non-coherent) cache, whose lines a grid barrier does not
// refresh.
__global__ void __launch_bounds__(kResidentExtThreads, 1)
    poisson_resident_ext_kernel(float* hi_a, float* lo_a, float* hi_b,
                                float* lo_b, float* __restrict__ dpr,
                                const float* __restrict__ rhs, Weights w,
                                float inv_dx2, float dtau, float decay,
                                int zero_grad_x, int nx, int ny, int nz,
                                int nit, int cut_y, int cut_z,
                                unsigned int* __restrict__ err_bits) {
  constexpr int U = kResidentExtUnroll;
  namespace cg = cooperative_groups;
  const cg::grid_group grid = cg::this_grid();
  extern __shared__ float dsm[];
  const Part ry = balanced_part(ny, cut_y, blockIdx.x / cut_z);
  const int z0 = blockIdx.x % cut_z * kResidentLanes;
  const int cols = ry.size * kResidentLanes;
  const int runs = min(nx, kResidentExtThreads / cols);
  const int c = threadIdx.x % cols, run = threadIdx.x / cols;
  const int y = ry.start + c / kResidentLanes, z = z0 + c % kResidentLanes;
  const Part xr = run < runs && z < nz ? balanced_part(nx, runs, run)
                                       : Part{0, 0};
  const int x0 = xr.start, x1 = xr.start + xr.size;
  const int nyz = ny * nz, col = y * nz + z;
  const bool yz_in = y >= 1 && y <= ny - 2 && z >= 1 && z <= nz - 2;
  const float wyp = yz_in ? w.yp[y] : 0.0f, wym = yz_in ? w.ym[y] : 0.0f;
  const float wzp = yz_in ? w.zp[z] : 0.0f, wzm = yz_in ? w.zm[z] : 0.0f;
  float* const dcol = dsm + c;
  // as K10: for an odd nit both words are first copied into the scratch
  // tensors, so that the last iteration writes the caller's
  float* const even_h = nit % 2 == 0 ? hi_a : hi_b;
  float* const odd_h = nit % 2 == 0 ? hi_b : hi_a;
  float* const even_l = nit % 2 == 0 ? lo_a : lo_b;
  float* const odd_l = nit % 2 == 0 ? lo_b : lo_a;
#pragma unroll 4
  for (int x = x0; x < x1; ++x) {
    const int i = x * nyz + col;
    dcol[x * cols] = dpr[i];
    if (nit % 2 != 0) {
      hi_b[i] = hi_a[i];
      lo_b[i] = lo_a[i];
    }
  }
  grid.sync();
  unsigned int bits = 0u;
  for (int j = 0; j < nit; ++j) {
    const float* const ph = j % 2 == 0 ? even_h : odd_h;
    const float* const pl = j % 2 == 0 ? even_l : odd_l;
    float* const qh = j % 2 == 0 ? odd_h : even_h;
    float* const ql = j % 2 == 0 ? odd_l : even_l;
    const bool last = j == nit - 1;
    // the cell's x - 1 and x values of both words, carried along the run
    const bool has_xm = x0 > 0 && x0 < x1;
    float hm = has_xm ? ph[(x0 - 1) * nyz + col] : 0.0f;
    float lm = has_xm ? pl[(x0 - 1) * nyz + col] : 0.0f;
    float hc = x0 < x1 ? ph[x0 * nyz + col] : 0.0f;
    float lc = x0 < x1 ? pl[x0 * nyz + col] : 0.0f;
    for (int xb = x0; xb < x1; xb += U) {
      // the loads of U planes, then their arithmetic
      float hn[U], ln[U], r[U];
      float hyp[U], hym[U], hzp[U], hzm[U], lyp[U], lym[U], lzp[U], lzm[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int x = xb + u;
        const int i = x * nyz + col;
        const bool has_xp = x < x1 && x + 1 < nx;
        hn[u] = has_xp ? ph[i + nyz] : 0.0f;
        ln[u] = has_xp ? pl[i + nyz] : 0.0f;
        if (x < x1 && yz_in && x >= 1 && x <= nx - 2) {
          hyp[u] = ph[i + nz];
          hym[u] = ph[i - nz];
          hzp[u] = ph[i + 1];
          hzm[u] = ph[i - 1];
          lyp[u] = pl[i + nz];
          lym[u] = pl[i - nz];
          lzp[u] = pl[i + 1];
          lzm[u] = pl[i - 1];
          // rhs streams (evict first), so that hi and lo stay in L2
          r[u] = __ldcs(rhs + i);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int x = xb + u;
        if (x >= x1) continue;
        const int i = x * nyz + col;
        float* const dp = dcol + x * cols;
        // K2's expressions in K2's order (poisson_iter_ext_kernel)
        float d = 0.0f;
        if (yz_in && x >= 1 && x <= nx - 2) {
          const bool drop_xm = zero_grad_x && x == 1;
          const float lap_h =
              lap_folded(hn[u], hm, hyp[u], hym[u], hzp[u], hzm[u], hc,
                         drop_xm, inv_dx2, wyp, wym, wzp, wzm);
          const float lap_l =
              lap_folded(ln[u], lm, lyp[u], lym[u], lzp[u], lzm[u], lc,
                         drop_xm, inv_dx2, wyp, wym, wzp, wzm);
          const float resid = (lap_h - r[u]) + lap_l;
          d = *dp * decay + dtau * resid;
          if (last) {
            const unsigned int b = __float_as_uint(fabsf(resid));
            bits = b > bits ? b : bits;
          }
        }
        *dp = d;
        const float uu = lc + dtau * d;
        const float s = hc + uu;
        const float ap = s - uu;
        const float bp = s - ap;
        qh[i] = s;
        ql[i] = (hc - ap) + (uu - bp);
        hm = hc;
        hc = hn[u];
        lm = lc;
        lc = ln[u];
      }
    }
    if (!last) grid.sync();
  }
#pragma unroll 4
  for (int x = x0; x < x1; ++x) dpr[x * nyz + col] = dcol[x * cols];
  bits = ns3d::block_max<kResidentExtThreads>(bits);
  if (ns3d::thread_rank() == 0 && bits != 0u) atomicMax(err_bits, bits);
}

// The checks and the cooperative launch of K10 and K12 (kernel, blocks of
// `threads` threads, its arguments `args`) under the wrapper's plan: z
// cut into rows of kResidentLanes, y into cut_y parts, one block a region
// (blocks = cut_y x cut_z, at most one per SM), the largest region's
// column slots at most one a thread, their dpr through every plane
// within smem. A refused launch returns its error
// (cudaErrorNotSupported where the device has no cooperative launch,
// cudaErrorCooperativeLaunchTooLarge where the blocks cannot all be
// resident) and takes it back from the runtime; nothing falls back.
cudaError_t launch_resident_grid(const void* kernel, int threads,
                                 void** args, int nx, int ny, int nz,
                                 int nit, int blocks, int cut_y, int cut_z,
                                 int smem, cudaStream_t stream) {
  if (nit < 1 || blocks < 1 || nx < 1 || ny < 1 || nz < 1 ||
      static_cast<long>(nx) * ny * nz >= (1L << 31))
    return cudaErrorInvalidValue;
  if (cut_y < 1 || cut_y > ny ||
      cut_z != (nz + kResidentLanes - 1) / kResidentLanes ||
      static_cast<long>(cut_y) * cut_z != blocks)
    return cudaErrorInvalidValue;
  const long cols =
      static_cast<long>((ny + cut_y - 1) / cut_y) * kResidentLanes;
  if (cols > threads || 4L * cols * nx > smem) return cudaErrorInvalidValue;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return e;
  }
  if (!coop) return cudaErrorNotSupported;
  if (static_cast<long>(per_sm) * sms < blocks)
    return cudaErrorCooperativeLaunchTooLarge;
  e = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(threads), args,
                                  smem, stream);
  // a refused call also leaves its error as the runtime's last one, which
  // the next launch of any kernel would report: take it back
  if (e != cudaSuccess) {
    cudaGetLastError();
    return e;
  }
  return cudaGetLastError();
}

struct BCConsts {
  float inv_dx2, inv_dy2, inv_dz2, dtau, decay, z_lo_add, z_hi_add;
  int zero_grad_x;
  const float* xlo;  // (ny, nz) Dirichlet plane at x = 0, or null
  const float* xhi;  // (ny, nz) Dirichlet plane at x = nx-1, or null
  float zlo_lo, zhi_lo;  // K2-dist: the lo words of z_lo_add, z_hi_add
};

__device__ inline int clamp_int(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// One shard's view of a field: its bx owned planes (bx, ny, nz) and the
// halo planes at local x = -1 (lo) and x = bx (hi), null at an open face.
struct Slab {
  const float* p;
  const float* lo;
  const float* hi;
};

// The shard: global x offset and extent, owned planes, y and z extents.
struct DistShape {
  int x_off, nx, bx, ny, nz;
};

// ---- K7, K7-dist and K2-dist: the unfolded iteration with set_bc_Pr! ----
//
// One template over the pressure words W: K7-dist (W = 1), K2-dist (W =
// 2), and K7, K7-dist's instance on the whole grid (x_off = 0, bx = nx, no
// halo planes, no check), which took 0.0490-0.0497 ms at 255x153x153
// against 0.0514-0.0515 for the K7 kernel it replaced, in the same runs
// (PERF.md).
//
// What bounds them on this card: device-memory bytes. K7-dist reads pr,
// dpr and rhs and writes pr_out and dpr_out (5 x 4 B per cell, 40.0 MB on
// a shard of 85x153x153, 0.0119 ms at 3.35 TB/s); K2-dist reads hi, lo,
// dpr and rhs and writes hi', lo' and dpr' (7 x 4 B, 56.1 MB, 0.0167 ms);
// the halo and Dirichlet planes add 0.1-0.3 MB.
//
// What held the form this replaces (the halo instance of K7's earlier
// template, also a thread per cell) to 47% and 44% of that
// (scripts/kdist_probe.py, PERF.md): (1) a ring thread recomputed its
// clamped source's whole update, one Laplacian for K7-dist and two for
// K2-dist, inside warps whose other lanes took the interior path: storing
// a constant there instead took 28% and 36% off; (2) the halo reads'
// branches per cell: on the whole grid the halo instance took 0.0742 ms
// where K7, the same template without them, took 0.0504. An
// x-streamed form (tiles streaming their x segment through a ring of
// cp.async slots, PERF.md) removed both and was slower: 0.0355 ms, issue
// bound at ~150 instructions per thread and plane.
//
// Design. A block of kDistLanes x kDistRows threads stands on one (y, z)
// tile of one plane; the plan (kernels/poisson.py `dist_plan`) cuts y and
// z into balanced parts of at least two rows and lanes, so a ring cell's
// clamped source (its y and z one cell inward) lies in its own tile. Each
// thread computes its cell's update once, in compute_slab's order
// (K7-dist) or compute_slab_ext's (K2-dist), and writes it to a shared
// tile; after one block barrier a ring cell (off the global interior, not
// on a Dirichlet plane) takes the update at its source plus the z
// constants, each added only where nonzero, in set_bc_Pr!'s order: the
// same floats as the plain version, so bitwise by construction. The x
// neighbour planes are chosen once per block (a halo plane at the shard's
// ends, nothing at an open global face). Under zero_grad_x the global
// plane 0 takes plane 1's updates and plane nx - 1 those of plane nx - 2:
// the block of such a plane computes its tile of the source plane
// instead of its own (a whole plane of ring cells, no divergence). The
// check value is reduced as K1's (float bits of |resid| over the interior
// cells, block max, one atomicMax). Outputs never alias inputs: a cell's
// neighbours are read from the inputs by other blocks. Indices are
// 32-bit: the wrapper refuses shards of 2^31 cells or more.

// a block: 32 lanes (z) x 8 rows (y), the shape ns3d::block_max_to reduces
constexpr int kDistLanes = ns3d::kBlockX;
constexpr int kDistRows = ns3d::kBlockY;

// The balanced cut of y and z into the wrapper's tiles (kernels/poisson.py
// `balanced_part`): part i starts at i*q + min(i, r) and holds q + (i < r).
struct DistCut {
  int qy, ry, qz, rz;
};

// A shard's pressure words (one Slab each) and their outputs.
template <int W>
struct DistWords {
  Slab in[W];
  float* out[W];
};

template <int W>
__global__ void __launch_bounds__(kDistLanes* kDistRows)
    poisson_dist_kernel(DistWords<W> f, const float* __restrict__ dpr,
                        const float* __restrict__ rhs,
                        float* __restrict__ dpr_out, BCConsts k,
                        DistShape sh, DistCut p,
                        unsigned int* __restrict__ err_bits) {
  __shared__ float upd[W][kDistRows][kDistLanes];
  const int tz = blockIdx.x, ty = blockIdx.y, lx = blockIdx.z;
  const int z0 = tz * p.qz + min(tz, p.rz), uz = p.qz + (tz < p.rz);
  const int y0 = ty * p.qy + min(ty, p.ry), uy = p.qy + (ty < p.ry);
  const int l = threadIdx.x, r = threadIdx.y;
  const int y = y0 + r, z = z0 + l;
  const bool on = l < uz && r < uy;
  const int gx = sh.x_off + lx;
  const int sx = sh.ny * sh.nz;
  const int yz = on ? y * sh.nz + z : 0;
  const bool yz_in = y >= 1 && y <= sh.ny - 2 && z >= 1 && z <= sh.nz - 2;
  const bool dirichlet = (gx == 0 && k.xlo != nullptr) ||
                         (gx == sh.nx - 1 && k.xhi != nullptr);
  unsigned int bits = 0u;
  if (dirichlet) {  // the Dirichlet x planes: every cell a plane value
    if (on) {
      const int i = lx * sx + yz;
      f.out[0][i] = gx == 0 ? k.xlo[yz] : k.xhi[yz];
      if constexpr (W == 2) f.out[1][i] = 0.0f;
      dpr_out[i] = 0.0f;
    }
  } else {
    // the plane whose updates this block computes: its own, or under
    // zero_grad_x a global face's source plane (block-uniform)
    const int cgx = k.zero_grad_x ? clamp_int(gx, 1, sh.nx - 2) : gx;
    const int cx = cgx - sh.x_off;
    const bool in = on && yz_in && cgx >= 1 && cgx <= sh.nx - 2;
    const int ic = cx * sx + yz;
    float pc[W], q[W], d = 0.0f;
#pragma unroll
    for (int w = 0; w < W; ++w) pc[w] = on ? f.in[w].p[ic] : 0.0f;
    if (in) {
      // lap_of_rows's order: x+ then x-, y+ then y-, z+ then z-
      float lap[W];
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const Slab& s = f.in[w];
        const float* xp = cx + 1 < sh.bx ? s.p + (cx + 1) * sx : s.hi;
        const float* xm = cx > 0 ? s.p + (cx - 1) * sx : s.lo;
        const float c = pc[w];
        float a = ((xp[yz] - c) + (xm[yz] - c)) * k.inv_dx2;
        a = a + ((s.p[ic + sh.nz] - c) + (s.p[ic - sh.nz] - c)) * k.inv_dy2;
        a = a + ((s.p[ic + 1] - c) + (s.p[ic - 1] - c)) * k.inv_dz2;
        lap[w] = a;
      }
      float resid = lap[0] - rhs[ic];
      if constexpr (W == 2) resid = resid + lap[1];
      d = dpr[ic] * k.decay + k.dtau * resid;
      if (cx == lx) bits = __float_as_uint(fabsf(resid));
    }
    if constexpr (W == 1) {
      q[0] = pc[0] + k.dtau * d;
    } else {  // u = lo + dtau*d, (hi', lo') = two_sum(hi, u)
      const float u = pc[1] + k.dtau * d;
      const float sum = pc[0] + u;
      const float ap = sum - u;
      const float bp = sum - ap;
      q[0] = sum;
      q[1] = (pc[0] - ap) + (u - bp);
    }
#pragma unroll
    for (int w = 0; w < W; ++w) upd[w][r][l] = q[w];
    __syncthreads();
    if (on) {
      const int i = lx * sx + yz;
      if (in && cx == lx) {
#pragma unroll
        for (int w = 0; w < W; ++w) f.out[w][i] = q[w];
        dpr_out[i] = d;
      } else {  // a ring cell: its source's update plus the z constants
        const int sr = clamp_int(y, 1, sh.ny - 2) - y0;
        const int sl = clamp_int(z, 1, sh.nz - 2) - z0;
        const float za[2] = {k.z_lo_add, k.zlo_lo};
        const float zb[2] = {k.z_hi_add, k.zhi_lo};
#pragma unroll
        for (int w = 0; w < W; ++w) {
          float v = upd[w][sr][sl];
          if (z == 0 && za[w] != 0.0f) v = v + za[w];
          if (z == sh.nz - 1 && zb[w] != 0.0f) v = v + zb[w];
          f.out[w][i] = v;
        }
        dpr_out[i] = 0.0f;
      }
    }
  }
  if (err_bits != nullptr) ns3d::block_max_to(bits, err_bits);
}

// One K7-dist (W = 1) or K2-dist (W = 2) launch over tiles_y x tiles_z
// tiles of every plane of the shard: the tiles must fit a block and hold
// at least two rows and lanes each (so that each ring cell's source lies
// in its own tile), and under zero_grad_x a shard holding a global x face
// must hold the plane next to it (bx >= 2, the wrapper's check).
template <int W>
cudaError_t launch_dist(const DistWords<W>& f, const float* dpr,
                        const float* rhs, float* dpr_out, const BCConsts& k,
                        const DistShape& sh, int tiles_y, int tiles_z,
                        unsigned int* err_bits, cudaStream_t stream) {
  if (sh.bx < 2 || sh.ny < 3 || sh.nz < 3 || tiles_y < 1 || tiles_z < 1 ||
      tiles_y > sh.ny / 2 || tiles_z > sh.nz / 2 ||
      (sh.ny + tiles_y - 1) / tiles_y > kDistRows ||
      (sh.nz + tiles_z - 1) / tiles_z > kDistLanes)
    return cudaErrorInvalidValue;
  const DistCut p{sh.ny / tiles_y, sh.ny % tiles_y, sh.nz / tiles_z,
                  sh.nz % tiles_z};
  cudaError_t e;
  if (err_bits != nullptr &&
      (e = cudaMemsetAsync(err_bits, 0, sizeof(unsigned int), stream)) !=
          cudaSuccess)
    return e;
  const dim3 grid(tiles_z, tiles_y, sh.bx);
  const dim3 block(kDistLanes, kDistRows);
  poisson_dist_kernel<W><<<grid, block, 0, stream>>>(f, dpr, rhs, dpr_out, k, sh, p, err_bits);
  return cudaGetLastError();
}

// ---- K13: the compensated folded residual ----
//
// One template over the pressure words W (the expressions: the header's
// K13 paragraph). A block of 32 lanes by kResThreadRows rows of threads
// stands on a (y, z) tile of the WHOLE plane, 32 lanes by 12 rows (ring
// rows and lanes included, so that no warp branches on the ring), each
// thread owning kResCellRows y-consecutive cells of its lane, and streams
// a segment of interior x planes. Each plane of the words, with a halo of
// one row and lane, arrives by 4-byte cp.async in a ring of three slots:
// plane x + 2 is copied while plane x is computed, after the one barrier
// of the plane, which also frees the slot plane x - 1 held. The plane
// loop is unrolled over a turn of the ring, so that every slot offset is
// a constant. A thread keeps its cells' x - 1 and x values in registers,
// takes x + 1's and the z neighbours from the staged planes, and the y
// neighbours too, except between its own cells, which are its registers;
// its y and z weight quads are loaded once a block, the plane's x quads
// by two uniform 16-byte loads, and the rhs pair of plane x + 1 into
// registers while plane x is computed; the copies, the rhs and r walk the
// planes by pointer. Every thread computes every cell of its tile and a
// select writes 0 (W = 1) or skips the cell (W = 2) off the interior,
// where the max takes nothing. The max |r| is reduced as K1's check value
// (float bits as unsigned, a block max, one atomicMax into the word the
// entry point zeroes). The segment length fills the card's resident
// blocks in the fewest waves (launch_comp_residual).
//
// Of the forms measured at 511x307x307 (threads x cells a thread in y,
// W = 1; PERF.md): 8 x 1 0.511 ms, 8 x 2 0.608, 4 x 2 0.454, 4 x 3 0.447,
// 8 x 3 0.440, 4 x 4 0.465; 4 x 3 is the fastest at 255 for both W
// (0.062 and 0.068 ms). The loop then issues ~228 instructions a cell for
// W = 1, 188 of them float adds and multiplies, 127 registers a thread.

constexpr int kResLanes = 32;        // z lanes a tile: a warp's width
constexpr int kResThreadRows = 4;    // y rows of a block's threads
constexpr int kResCellRows = 3;      // y-consecutive cells a thread owns
constexpr int kResThreads = kResLanes * kResThreadRows;
constexpr int kResRows = kResThreadRows * kResCellRows;  // y rows a tile
constexpr int kResStride = kResLanes + 2;                 // a staged row
constexpr int kResPlane = (kResRows + 2) * kResStride;    // a staged plane
constexpr int kResCopies = (kResPlane + kResThreads - 1) / kResThreads;
constexpr int kResRing = 3;                               // staged planes

// The right-hand side pair at the interior cells: element (i, j, k) of
// the (nx-2, ny-2, nz-2) interior at hi[i*hsx + j*hsy + k] (lo alike).
struct RhsPair {
  const float* hi;
  const float* lo;
  int hsx, hsy, lsx, lsy;
};

// The weight quads (w_hi, w_lo, w1, w2) of ops/ds.py weight_quad, a row
// per interior index of each axis: the minus neighbour's quad, then the
// plus neighbour's (kernels/poisson.py `quad_rows`).
struct QuadRows {
  const float4* x;
  const float4* y;
  const float4* z;
};

// ops/ds.py two_sum: s = fl(a + b), e with a + b = s + e exactly.
__device__ inline void two_sum(float a, float b, float& s, float& e) {
  s = a + b;
  const float bp = s - a;
  e = (a - (s - bp)) + (b - bp);
}

// ops/ds.py weighted_term: (dh + dl) * w64 as (p, e), Dekker's product of
// dh against the quad with dh*w_lo and dl*w_hi folded into e.
__device__ inline void weighted_term(float dh, float dl, float4 q, float& p,
                                     float& e) {
  const float t = dh * 4097.0f;
  const float a1 = t - (t - dh);
  const float a2 = dh - a1;
  p = dh * q.x;
  const float err = ((a1 * q.z - p) + a1 * q.w + a2 * q.z) + a2 * q.w;
  e = err + (dh * q.y + dl * q.x);
}

// The residual of one cell from its W words' centre values pc and six
// neighbours nb (x-, x+, y-, y+, z-, z+), their weight quads and the rhs
// pair, in the plain version's order (the header's K13 paragraph).
template <int W>
__device__ inline float comp_residual_cell(const float (&nb)[W][6],
                                           const float (&pc)[W],
                                           const float4 (&quad)[6],
                                           float rh, float rl) {
  // x+, x-, y+, y-, z+, z- for one word (compensated_residual); x-, x+,
  // y-, y+, z-, z+ with the lo words' differences folded in for two (the
  // solver's _comp_residual)
  float p[6], e[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const int j = W == 1 ? (k ^ 1) : k;
    float dh, dl;
    two_sum(nb[0][j], -pc[0], dh, dl);
    if constexpr (W == 2) dl = dl + (nb[1][j] - pc[1]);
    weighted_term(dh, dl, quad[j], p[k], e[k]);
  }
  // ops/ds.py accumulate over the six terms, then (-rhs_hi, -rhs_lo)
  float s = p[0], c = e[0];
#pragma unroll
  for (int k = 1; k < 6; ++k) {
    float t;
    two_sum(s, p[k], s, t);
    c = c + (t + e[k]);
  }
  float t;
  two_sum(s, -rh, s, t);
  c = c + (t + -rl);
  return s + c;
}

template <int W>
__global__ void __launch_bounds__(kResThreads) comp_residual_kernel(
    const float* __restrict__ hi, const float* __restrict__ lo, RhsPair rhs,
    float* __restrict__ r, QuadRows q, int nx, int ny, int nz, int seg,
    unsigned int* __restrict__ err_bits) {
  constexpr int R = kResCellRows;
  __shared__ float stage[kResRing][W][kResPlane];
  const int lane = threadIdx.x;
  const int t = lane + kResLanes * threadIdx.y;
  const int z0 = blockIdx.x * kResLanes, y0 = blockIdx.y * kResRows;
  const int z = z0 + lane;
  const int xa = 1 + blockIdx.z * seg;
  const int xb = min(xa + seg, nx - 1);
  const long sx = static_cast<long>(ny) * nz;

  // the copy map: cells t + k x kResThreads of a staged plane, their rows
  // and lanes clamped into the grid (a clamped cell feeds only cells off
  // the interior); src walks the planes from xa
  const float* src[W][kResCopies];
#pragma unroll
  for (int k = 0; k < kResCopies; ++k) {
    const int c = t + k * kResThreads;
    const long o = xa * sx + clamp_int(y0 - 1 + c / kResStride, 0, ny - 1) *
                                 nz +
                   clamp_int(z0 - 1 + c % kResStride, 0, nz - 1);
    src[0][k] = hi + o;
    if constexpr (W == 2) src[1][k] = lo + o;
  }
  // copy the plane src points at into `slot` (none past the grid: an
  // empty group), then step src to the next plane
  auto copy_plane = [&](int x, int slot) {
    if (x < nx) {
#pragma unroll
      for (int w = 0; w < W; ++w)
#pragma unroll
        for (int k = 0; k < kResCopies; ++k)
          if (k < kResCopies - 1 || t + k * kResThreads < kResPlane)
            ns3d::cp_async4(&stage[slot][w][t + k * kResThreads], src[w][k]);
    }
    ns3d::cp_async_commit();
#pragma unroll
    for (int w = 0; w < W; ++w)
#pragma unroll
      for (int k = 0; k < kResCopies; ++k) src[w][k] += sx;
  };

  // this thread's R cells: rows y0 + R*threadIdx.y + i of lane z, where
  // they are, their staged offset, their y and z weight quads, their rhs
  // pointers and r offsets walking the planes (interior indices clamped)
  const int iz = clamp_int(z, 1, nz - 2) - 1;
  const float4 qzm = q.z[2 * iz], qzp = q.z[2 * iz + 1];
  bool on[R], in[R];
  int own[R];
  const float *rhp[R], *rlp[R];
  long ro[R];
  float4 qym[R], qyp[R];
  float pm[R][W], pc[R][W], pp[R][W], rh[R], rl[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int y = y0 + R * threadIdx.y + i;
    const int iy = clamp_int(y, 1, ny - 2) - 1;
    const long yz = static_cast<long>(min(y, ny - 1)) * nz + min(z, nz - 1);
    on[i] = y < ny && z < nz;
    in[i] = y >= 1 && y <= ny - 2 && z >= 1 && z <= nz - 2;
    own[i] = (R * threadIdx.y + i + 1) * kResStride + lane + 1;
    qym[i] = q.y[2 * iy];
    qyp[i] = q.y[2 * iy + 1];
    rhp[i] = rhs.hi + (xa - 1) * static_cast<long>(rhs.hsx) +
             static_cast<long>(iy) * rhs.hsy + iz;
    rlp[i] = rhs.lo + (xa - 1) * static_cast<long>(rhs.lsx) +
             static_cast<long>(iy) * rhs.lsy + iz;
    ro[i] = W == 1 ? xa * sx + yz
                   : (static_cast<long>(xa - 1) * (ny - 2) + iy) * (nz - 2) +
                         iz;
    pm[i][0] = hi[(xa - 1) * sx + yz];
    if constexpr (W == 2) pm[i][1] = lo[(xa - 1) * sx + yz];
    rh[i] = *rhp[i];
    rl[i] = *rlp[i];
    // W = 1: r is 0 on the x ring planes too
    if constexpr (W == 1) {
      if (on[i] && blockIdx.z == 0) r[yz] = 0.0f;
      if (on[i] && blockIdx.z == gridDim.z - 1) r[(nx - 1) * sx + yz] = 0.0f;
    }
  }
  const float4* qx = q.x + 2 * (xa - 1);
  const long rsx = W == 1 ? sx : static_cast<long>(ny - 2) * (nz - 2);

  copy_plane(xa, 0);
  copy_plane(xa + 1, 1);
  ns3d::cp_async_wait<1>();
  __syncthreads();
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int w = 0; w < W; ++w) pc[i][w] = stage[0][w][own[i]];
  unsigned int bits = 0u;

  // one plane: plane x staged in slot CUR, x + 1 in NXT, and plane x + 2
  // copied into FREE (the slot plane x - 1 held)
  auto step = [&](auto cur_c, auto nxt_c, auto free_c, int x) {
    constexpr int CUR = decltype(cur_c)::value;
    constexpr int NXT = decltype(nxt_c)::value;
    constexpr int FREE = decltype(free_c)::value;
    // plane x + 1 has landed for every thread, and every read of plane
    // x - 1 is done
    ns3d::cp_async_wait<0>();
    __syncthreads();
    copy_plane(x + 2, FREE);
    // the rhs of plane x + 1, into registers while plane x is computed
    float rh_next[R], rl_next[R];
    const bool more = x + 1 <= nx - 2;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      rhp[i] += rhs.hsx;
      rlp[i] += rhs.lsx;
      rh_next[i] = more ? *rhp[i] : 0.0f;
      rl_next[i] = more ? *rlp[i] : 0.0f;
    }
    const float4 qxm = qx[0], qxp = qx[1];
    qx += 2;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float nb[W][6];
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const float* sc = stage[CUR][w];
        pp[i][w] = stage[NXT][w][own[i]];
        nb[w][0] = pm[i][w];
        nb[w][1] = pp[i][w];
        // a y neighbour in this thread's own rows is its centre value
        nb[w][2] = i > 0 ? pc[i > 0 ? i - 1 : 0][w]
                         : sc[own[i] - kResStride];
        nb[w][3] = i < R - 1 ? pc[i < R - 1 ? i + 1 : i][w]
                             : sc[own[i] + kResStride];
        nb[w][4] = sc[own[i] - 1];
        nb[w][5] = sc[own[i] + 1];
      }
      const float4 quad[6] = {qxm, qxp, qym[i], qyp[i], qzm, qzp};
      const float res = comp_residual_cell<W>(nb, pc[i], quad, rh[i], rl[i]);
      if constexpr (W == 1) {
        if (on[i]) r[ro[i]] = in[i] ? res : 0.0f;
      } else {
        if (r != nullptr && in[i]) r[ro[i]] = res;
      }
      ro[i] += rsx;
      const unsigned int b = in[i] ? __float_as_uint(fabsf(res)) : 0u;
      bits = b > bits ? b : bits;
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int w = 0; w < W; ++w) {
        pm[i][w] = pc[i][w];
        pc[i][w] = pp[i][w];
      }
      rh[i] = rh_next[i];
      rl[i] = rl_next[i];
    }
  };
  using S0 = std::integral_constant<int, 0>;
  using S1 = std::integral_constant<int, 1>;
  using S2 = std::integral_constant<int, 2>;
  // three planes a turn of the ring, so that every slot is a constant
  int x = xa;
  for (; x + 3 <= xb; x += 3) {
    step(S0{}, S1{}, S2{}, x);
    step(S1{}, S2{}, S0{}, x + 1);
    step(S2{}, S0{}, S1{}, x + 2);
  }
  if (x < xb) step(S0{}, S1{}, S2{}, x);
  if (x + 1 < xb) step(S1{}, S2{}, S0{}, x + 1);
  ns3d::cp_async_wait<0>();
  bits = ns3d::block_max<kResThreads>(bits);
  if (t == 0 && bits != 0u) atomicMax(err_bits, bits);
}

// One K13 launch: tiles of the whole (y, z) plane times segments of the
// nx - 2 interior planes, as many segments as fill the card's resident
// blocks in the fewest waves of the least cost (waves x (planes a segment
// + the two it stages besides)); err_bits zeroed here.
template <int W>
cudaError_t launch_comp_residual(const float* hi, const float* lo,
                                 const RhsPair& rhs, float* r,
                                 const QuadRows& q, int nx, int ny, int nz,
                                 unsigned int* err_bits,
                                 cudaStream_t stream) {
  if (nx < 3 || ny < 3 || nz < 3 ||
      static_cast<long>(nx) * ny * nz >= (1L << 31) || err_bits == nullptr ||
      (W == 1 && r == nullptr))
    return cudaErrorInvalidValue;
  // blocks an SM, asked once a process (the kernel's registers decide it)
  static int per_sm = 0;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && per_sm == 0)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, comp_residual_kernel<W>, kResThreads, 0);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return e;
  }
  const long cap = static_cast<long>(sms) * (per_sm > 0 ? per_sm : 1);
  const int tiles_z = (nz + kResLanes - 1) / kResLanes;
  const int tiles_y = (ny + kResRows - 1) / kResRows;
  const long tiles = static_cast<long>(tiles_y) * tiles_z;
  const long planes = nx - 2;
  long best_seg = planes, best_cost = -1;
  for (long waves = 1;; ++waves) {
    long segs = waves * cap / tiles;
    segs = segs < 1 ? 1 : (segs > planes ? planes : segs);
    const long seg = (planes + segs - 1) / segs;
    const long blocks = tiles * ((planes + seg - 1) / seg);
    const long cost = (blocks + cap - 1) / cap * (seg + 2);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best_seg = seg;
    }
    if (segs == planes) break;
  }
  const int seg = static_cast<int>(best_seg);
  e = cudaMemsetAsync(err_bits, 0, sizeof(unsigned int), stream);
  if (e != cudaSuccess) return e;
  const dim3 grid(tiles_z, tiles_y, static_cast<int>((planes + seg - 1) / seg));
  comp_residual_kernel<W><<<grid, dim3(kResLanes, kResThreadRows), 0, stream>>>(hi, lo, rhs, r, q, nx, ny, nz, seg, err_bits);
  return cudaGetLastError();
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

extern "C" int ns3d_poisson_iter_sweeps(
    const float* pr, const float* dpr, const float* rhs, float* pr_out,
    float* dpr_out, const float* wyp, const float* wym, const float* wzp,
    const float* wzm, float inv_dx2, float dtau, float decay,
    int zero_grad_x, int nx, int ny, int nz, int s, int uy, int uz,
    int tiles_y, int tiles_z, int seg, unsigned int* err_bits,
    cudaStream_t stream) {
  const Weights w{wyp, wym, wzp, wzm};
  const SweepPlan p{uy, uz, tiles_y, tiles_z, seg};
  cudaError_t e = cudaErrorInvalidValue;
  switch (s) {
    case 2:
      e = launch_sweeps<2>(pr, dpr, rhs, pr_out, dpr_out, w, inv_dx2, dtau,
                           decay, zero_grad_x, nx, ny, nz, p, err_bits,
                           stream);
      break;
    case 3:
      e = launch_sweeps<3>(pr, dpr, rhs, pr_out, dpr_out, w, inv_dx2, dtau,
                           decay, zero_grad_x, nx, ny, nz, p, err_bits,
                           stream);
      break;
    case 4:
      e = launch_sweeps<4>(pr, dpr, rhs, pr_out, dpr_out, w, inv_dx2, dtau,
                           decay, zero_grad_x, nx, ny, nz, p, err_bits,
                           stream);
      break;
  }
  return static_cast<int>(e);
}

extern "C" int ns3d_poisson_iter_bc(const float* pr, const float* dpr,
                                    const float* rhs, float* pr_out,
                                    float* dpr_out, const float* xlo,
                                    const float* xhi, float inv_dx2,
                                    float inv_dy2, float inv_dz2, float dtau,
                                    float decay, float z_lo_add,
                                    float z_hi_add, int zero_grad_x, int nx,
                                    int ny, int nz, int tiles_y, int tiles_z,
                                    cudaStream_t stream) {
  const BCConsts k{inv_dx2, inv_dy2, inv_dz2, dtau, decay, z_lo_add,
                   z_hi_add, zero_grad_x, xlo, xhi, 0.0f, 0.0f};
  const DistWords<1> f{{Slab{pr, nullptr, nullptr}}, {pr_out}};
  return static_cast<int>(launch_dist<1>(
      f, dpr, rhs, dpr_out, k, DistShape{0, nx, nx, ny, nz}, tiles_y,
      tiles_z, nullptr, stream));
}

extern "C" int ns3d_poisson_iter_bc_dist(
    const float* pr, const float* pr_lo, const float* pr_hi, const float* dpr,
    const float* rhs, float* pr_out, float* dpr_out, const float* xlo,
    const float* xhi, float inv_dx2, float inv_dy2, float inv_dz2,
    float dtau, float decay, float z_lo_add, float z_hi_add,
    int zero_grad_x, int x_off, int nx, int bx, int ny, int nz, int tiles_y,
    int tiles_z, unsigned int* err_bits, cudaStream_t stream) {
  const BCConsts k{inv_dx2, inv_dy2, inv_dz2, dtau, decay, z_lo_add,
                   z_hi_add, zero_grad_x, xlo, xhi, 0.0f, 0.0f};
  const DistWords<1> f{{Slab{pr, pr_lo, pr_hi}}, {pr_out}};
  return static_cast<int>(launch_dist<1>(
      f, dpr, rhs, dpr_out, k, DistShape{x_off, nx, bx, ny, nz}, tiles_y,
      tiles_z, err_bits, stream));
}

extern "C" int ns3d_poisson_iter_ext_bc_dist(
    const float* hi, const float* hi_lo, const float* hi_hi, const float* lo,
    const float* lo_lo, const float* lo_hi, const float* dpr,
    const float* rhs, float* hi_out, float* lo_out, float* dpr_out,
    const float* xlo, const float* xhi, float inv_dx2, float inv_dy2,
    float inv_dz2, float dtau, float decay, float zlo_hi, float zhi_hi,
    float zlo_lo, float zhi_lo, int zero_grad_x, int x_off, int nx, int bx,
    int ny, int nz, int tiles_y, int tiles_z, unsigned int* err_bits,
    cudaStream_t stream) {
  const BCConsts k{inv_dx2, inv_dy2, inv_dz2, dtau, decay, zlo_hi,
                   zhi_hi, zero_grad_x, xlo, xhi, zlo_lo, zhi_lo};
  const DistWords<2> f{{Slab{hi, hi_lo, hi_hi}, Slab{lo, lo_lo, lo_hi}},
                       {hi_out, lo_out}};
  return static_cast<int>(launch_dist<2>(
      f, dpr, rhs, dpr_out, k, DistShape{x_off, nx, bx, ny, nz}, tiles_y,
      tiles_z, err_bits, stream));
}

// K10: a folded loop's check intervals in one launch, from global
// iteration it0 < niter (a multiple of nchk) under the exit rule (eps,
// scale, thresh, big: float32; window 0 for no stall exit), or nit
// iterations (it0 = 0, niter = nchk = nit); the result in pr (the
// caller's tensor) and dpr, each interval's check value (the state
// entering its last iteration) in err_bits, one zeroed slot a check the
// loop may take, and the intervals run in *checks (nullable): a
// cooperative grid of blocks = cut_y x cut_z blocks (at most one per SM),
// block b owning the (y, z) columns of y part b / cut_z and z part b %
// cut_z, scratch the second pr buffer. smem: the dynamic shared memory
// per block the plan asked for, which must hold the largest region's dpr.
// A refused launch returns its error (launch_resident_grid); nothing
// falls back to K1 launches.
extern "C" int ns3d_poisson_iter_resident(
    float* pr, float* scratch, float* dpr, const float* rhs,
    const float* wyp, const float* wym, const float* wzp, const float* wzm,
    float inv_dx2, float dtau, float decay, int zero_grad_x, int nx, int ny,
    int nz, int it0, int niter, int nchk, float eps, float scale,
    float thresh, float big, int window, int blocks, int cut_y, int cut_z,
    int smem, unsigned int* err_bits, int* checks, cudaStream_t stream) {
  if (nchk < 1 || it0 < 0 || it0 >= niter || niter % nchk != 0 ||
      window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Weights w{wyp, wym, wzp, wzm};
  ExitRule rule{it0, niter, nchk, window, eps, scale, thresh, big};
  void* args[] = {&pr, &scratch, &dpr, &rhs, &w, &inv_dx2, &dtau, &decay,
                  &zero_grad_x, &nx, &ny, &nz, &rule, &cut_y, &cut_z,
                  &err_bits, &checks};
  return static_cast<int>(launch_resident_grid(
      reinterpret_cast<const void*>(poisson_resident_grid_kernel),
      kResidentThreads, args, nx, ny, nz, nchk - it0 % nchk, blocks, cut_y,
      cut_z, smem, stream));
}

// K12: nit of K2's iterations in one launch under K10's plan, the result
// in hi and lo (the caller's tensors) and dpr, the check value of the
// state entering the last iteration in err_bits (zeroed by the caller);
// hi_scratch and lo_scratch the second buffers of the two words. A
// refused launch returns its error; nothing falls back to K2 launches.
extern "C" int ns3d_poisson_iter_resident_ext(
    float* hi, float* lo, float* hi_scratch, float* lo_scratch, float* dpr,
    const float* rhs, const float* wyp, const float* wym, const float* wzp,
    const float* wzm, float inv_dx2, float dtau, float decay,
    int zero_grad_x, int nx, int ny, int nz, int nit, int blocks,
    int cut_y, int cut_z, int smem, unsigned int* err_bits,
    cudaStream_t stream) {
  Weights w{wyp, wym, wzp, wzm};
  void* args[] = {&hi, &lo, &hi_scratch, &lo_scratch, &dpr, &rhs, &w,
                  &inv_dx2, &dtau, &decay, &zero_grad_x, &nx, &ny, &nz,
                  &nit, &cut_y, &cut_z, &err_bits};
  return static_cast<int>(launch_resident_grid(
      reinterpret_cast<const void*>(poisson_resident_ext_kernel),
      kResidentExtThreads, args, nx, ny, nz, nit, blocks, cut_y, cut_z,
      smem, stream));
}

// K13: the compensated residual of `words` pressure words (1: hi alone,
// compensated_residual; 2: the (hi, lo) pair, the solver's _comp_residual)
// against the right-hand side pair at the interior cells (RhsPair's
// strides), each weight quad row of qx, qy, qz two float4 (minus, plus).
// r: words 1, the whole (nx, ny, nz) grid with 0 off the interior
// (required); words 2, the (nx-2, ny-2, nz-2) interior, or null where the
// caller reads only the max. The max |r| over the interior lands in
// err_bits as float bits.
extern "C" int ns3d_comp_residual(int words, const float* hi,
                                  const float* lo, const float* rhs_hi,
                                  const float* rhs_lo, int hsx, int hsy,
                                  int lsx, int lsy, float* r,
                                  const float* qx, const float* qy,
                                  const float* qz, int nx, int ny, int nz,
                                  unsigned int* err_bits,
                                  cudaStream_t stream) {
  const RhsPair rhs{rhs_hi, rhs_lo, hsx, hsy, lsx, lsy};
  const QuadRows q{reinterpret_cast<const float4*>(qx),
                   reinterpret_cast<const float4*>(qy),
                   reinterpret_cast<const float4*>(qz)};
  cudaError_t e = cudaErrorInvalidValue;
  if (words == 1)
    e = launch_comp_residual<1>(hi, nullptr, rhs, r, q, nx, ny, nz,
                                err_bits, stream);
  else if (words == 2 && lo != nullptr)
    e = launch_comp_residual<2>(hi, lo, rhs, r, q, nx, ny, nz, err_bits,
                                stream);
  return static_cast<int>(e);
}
