"""K1, the folded-BC pseudo-transient Poisson iteration, K8, s of them per
launch, K10, nit of them in one launch resident on chip, K2, its double-single
(hi, lo) form, K12, nit of K2's in one launch resident on chip, K7, the
iteration with the boundary conditions applied in-kernel (compat mode and
the dma-mode solve), and the residual evaluations of the Poisson solve.

`poisson_iter`, `poisson_iter_sweeps`, `poisson_iter_resident`,
`poisson_loop_resident`, `poisson_iter_ext`, `poisson_iter_resident_ext`
and `poisson_iter_bc` launch the CUDA kernels of csrc/poisson.cu for CUDA
tensors and run `poisson_iter_plain`, `poisson_iter_sweeps_plain`,
`poisson_iter_resident_plain`, `poisson_loop_resident_plain`,
`poisson_iter_ext_plain`, `poisson_iter_resident_ext_plain` and
`poisson_iter_bc_plain`, their plain PyTorch versions, for CPU tensors.
K1 computes the Pallas kernel's iteration (navierstokes3d_tpu/kernels/
poisson.py:914, `compute_slab_folded` :305) on the canonical 3D layout:

  lap   = (xp + xm)*inv_dx2 + (yp*wyp + ym*wym) + (zp*wzp + zm*wzm)
  resid = lap - rhs;   dpr <- dpr*decay + dtau*resid   (interior, in place)
  pr'   = pr + dtau*dpr                                 (written to pr_out)

with neighbor differences (p+ - pc), the weight rows mask/h^2 of the
folded boundary conditions, and xm replaced by 0 at x == 1 where x-lo is
zero-gradient (the multi variant; `lap_of_rows_folded` :281). K2 (:1230,
`compute_slab_ext_folded` :317) iterates the pair (hi, lo) whose sum is
the pressure:

  resid = (lap(hi) - rhs) + lap(lo);   dpr as K1
  u = lo + dtau*dpr;   (hi', lo') = two_sum(hi, u)       (every cell)

The caller's protocol is the JAX package's (its docstring at
kernels/poisson.py:130-142): one exact first iteration plus set_bc_pr,
the affine-z constants hoisted into the RHS, and the boundary planes
materialized at the end.

K8 (:836, `kernelS` :756, the lane-tiled s-sweep; :1007, `kernel2` :967,
the untiled two-sweep) runs s of K1's iterations per launch with pr and
dpr both ping-ponged, bitwise equal to s K1 launches, and emits the
residual entering the last one: the check value the s-th K1 launch would
emit, so the convergence loop takes the same decisions. Both versions
count the iterations they advanced (`.iterations`, s a launch or call).

K10 (:1151, `kernelR` :1116, `make_resident` :1066) advances nit folded
iterations in one launch with pr and dpr updated in place, bitwise equal
to nit K1 launches, and emits the check value entering the last one. It
keeps dpr on chip, in the shared memory of a grid of one block per SM
(`resident_plan`), and moves 12 B a cell and iteration where K1 moves
20; a grid whose dpr does not fit has no K10 (`make_resident` returns
None, as the JAX package's does above its VMEM budget). The solver's
folded loops run as ONE K10 launch each wherever it has a plan and the
sweep plan is off (models/chorin.py `_folded_loop`,
`poisson_loop_resident`): the launch runs check interval after check
interval, takes each exit decision on the card (ptloop.ExitRule) and
hands the host the loop's check values in one read, as the JAX package
runs the loop in one lax.while_loop on the device. `make_resident` and
ptloop.pt_loop_fused's `seed0` compose a launch of nit iterations with a
K1 loop as the JAX package does. Both versions count the iterations they
advanced (`.iterations`) and the checks the loop took on the card
(`.checks`) beside their launches or calls.

K12 replaces no TPU kernel: it is K10's design carried over to K2, nit of
K2's iterations in one launch under K10's plan (`resident_plan`), hi, lo
and dpr updated in place, bitwise equal to nit K2 launches, emitting the
check value entering the last one. It keeps dpr in shared memory and
moves 20 B a cell and iteration where K2 moves 28. The extended accuracy
phase runs one K12 launch per check interval wherever the grid has a
plan (models/chorin.py `_poisson_solve_extended`); K2 runs the rest.
Both versions count their iterations (`.iterations`), as K10's do, and
so do K2's, one a launch or call.

K7 (:914 with folded=False, `compute_slab` :334, `apply_bc_rows` :257) is
the reference's own loop body: the unfolded iteration on every interior
cell, then set_bc_Pr!'s sequence in-kernel, described by a PoissonBCSpec
(`poisson_bc_spec`, a copy of the JAX package's :43-80). Its Dirichlet
planes are computed in float64 and rounded once, as the JAX kernel's
`lanes()` does; they can differ by an ulp from bc.hydrostatic_x's, which
evaluates the profile in the field's dtype. K7 also computes the dma-mode
kernel K11 (:1451, `kernel` :1398, the same `compute_slab` and
`apply_bc_rows` behind a manual DMA pipeline, with no check value): the
interpreted K11 is bitwise equal to `poisson_iter_bc_plain` under the
split gpu spec and the multi spec (tests/test_torch_dma.py).

K7-dist (`poisson_iter_bc_dist`) and K2-dist (`poisson_iter_ext_bc_dist`)
are the same call sites built with local_rows (`rows_of` :503, `p_ext_of`
:515): one x-shard of the distributed solve (parallel/halo.py), K7's
iteration and the (hi, lo) pair's unfolded one (`compute_slab_ext` :353),
with every BC guard keyed on the global x position, the neighbours' face
planes as operands and the check value of the shard's interior cells.
K7, K7-dist and K2-dist launch one kernel template (K7: K7-dist's on the
whole grid without halo planes) under `dist_plan`'s tiling.

K13 replaces no TPU kernel (XLA computes it in the JAX package): the
compensated folded residual of the accuracy phases, ~190 float32
operations a cell that eager torch ran as as many full-grid passes, in
one launch at 16 B a cell. `compensated_residual` (the Pallas path's
`compensated_residual`, :1362, single word: the defect phase's restart)
and `pair_residual` / `pair_residual_max` (the JAX solver's
`_comp_residual_fn`, models/chorin.py:909, on the stored (hi, lo) pair:
the stored-state guarantee, stored_residual_err, the fdm refinement and
the dma-mode pair solve) launch it for CUDA tensors and run
`compensated_residual_plain` and `pair_residual_plain` for CPU tensors;
r and the max are bitwise the plain versions'. `residual_max`
(`residual_flat`, :1287-1309) and `folded_lap` stay torch ops, as XLA
computes them in the JAX package.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops import ds
from ..ops.stencil import div
from ..ptloop import ExitRule, host_array
from . import _build


@dataclasses.dataclass(frozen=True)
class PoissonOperator:
    """The folded Poisson operator's constants on one device and dtype.

    inv_dx2/dtau/decay are Python floats already rounded to the dtype (as
    the JAX kernel pre-rounds them); wyp..wzm are the kernel's weight rows
    over the full y (ny,) and z (nz,) index ranges; masks are the six
    interior coefficient masks of folded_lap, broadcast-shaped (order xm,
    xp, ym, yp, zm, zp); quads their (w_hi, w_lo, w1, w2) weight quads
    (mask/h^2 split from float64) for the compensated residuals, and
    quad_rows the same quads as K13 reads them: per axis ("x", "y", "z")
    a float32 (n-2, 8) row per interior index, the minus neighbour's quad
    then the plus neighbour's; zero_grad_x drops the x-1 neighbor of the
    first interior plane (x-lo zero-gradient, the multi variant)."""
    dx: float
    dy: float
    dz: float
    inv_dx2: float
    dtau: float
    decay: float
    wyp: torch.Tensor
    wym: torch.Tensor
    wzp: torch.Tensor
    wzm: torch.Tensor
    masks: Tuple[torch.Tensor, ...]
    quads: Dict[str, tuple]
    zero_grad_x: bool
    quad_rows: Dict[str, torch.Tensor]


def make_operator(masks1d: Dict[str, np.ndarray], grid, dtype: torch.dtype,
                  device) -> PoissonOperator:
    """Build the operator from bc.folded_masks and the grid."""
    npdt = {torch.float32: np.float32, torch.float64: np.float64}[dtype]
    rnd = lambda v: float(npdt(v))  # noqa: E731

    def row(mask, h):
        # full-length row, interior entries from the mask (the JAX rows
        # are (mask != 0) * f32(1/h/h); the ring entries are never read)
        full = np.ones(len(mask) + 2, np.float64)
        full[1:-1] = mask
        inv_h2 = npdt(1.0 / h / h)
        return torch.tensor((full * inv_h2).astype(npdt), device=device)

    shapes = {"x": (-1, 1, 1), "y": (1, -1, 1), "z": (1, 1, -1)}
    hs = {"x": grid.dx, "y": grid.dy, "z": grid.dz}
    keys = ("xm", "xp", "ym", "yp", "zm", "zp")
    masks = tuple(torch.tensor(masks1d[k].astype(npdt), device=device)
                  .reshape(shapes[k[0]]) for k in keys)
    quads = {k: tuple(q.reshape(shapes[k[0]]) for q in ds.weight_quad(
        masks1d[k] / hs[k[0]] / hs[k[0]], device=device)) for k in keys}
    quad_rows = {a: torch.cat([torch.stack([q.reshape(-1) for q in quads[k]],
                                           dim=1) for k in (a + "m", a + "p")],
                              dim=1).contiguous() for a in "xyz"}
    return PoissonOperator(
        dx=grid.dx, dy=grid.dy, dz=grid.dz,
        inv_dx2=rnd(1.0 / grid.dx / grid.dx), dtau=rnd(grid.dtau),
        decay=rnd(1.0 - grid.damp),
        wyp=row(masks1d["yp"], grid.dy), wym=row(masks1d["ym"], grid.dy),
        wzp=row(masks1d["zp"], grid.dz), wzm=row(masks1d["zm"], grid.dz),
        masks=masks, quads=quads, zero_grad_x=bool(masks1d["xm"][0] == 0),
        quad_rows=quad_rows)


INNER = (slice(1, -1),) * 3


def _lap_folded(p, op: PoissonOperator):
    """The kernels' interior Laplacian in `lap_of_rows_folded`'s order
    (kernels/poisson.py:281-296): (lap, pc)."""
    pc = p[INNER]
    xp = p[2:, 1:-1, 1:-1] - pc
    xm = p[:-2, 1:-1, 1:-1] - pc
    if op.zero_grad_x:
        # a select, as the kernels do: x == 1 reads no x-1 neighbor
        xm = torch.cat((torch.zeros_like(xm[:1]), xm[1:]))
    lap = (xp + xm) * op.inv_dx2
    lap = lap + ((p[1:-1, 2:, 1:-1] - pc) * op.wyp[1:-1, None]
                 + (p[1:-1, :-2, 1:-1] - pc) * op.wym[1:-1, None])
    lap = lap + ((p[1:-1, 1:-1, 2:] - pc) * op.wzp[1:-1]
                 + (p[1:-1, 1:-1, :-2] - pc) * op.wzm[1:-1])
    return lap, pc


def _update_dpr(dpr, resid, op: PoissonOperator):
    """dpr <- dpr*decay + dtau*resid on the interior, 0 on the ring (as
    the kernels write it); returns the interior update."""
    d = dpr[INNER] * op.decay + op.dtau * resid
    dpr.zero_()
    dpr[INNER] = d
    return d


def _check_operands(op: PoissonOperator, shape, dev, **fields):
    for fname, t in fields.items():
        _build.require(fname, t, shape, torch.float32, dev)
    nx, ny, nz = shape
    for fname, t, n in (("wyp", op.wyp, ny), ("wym", op.wym, ny),
                        ("wzp", op.wzp, nz), ("wzm", op.wzm, nz)):
        _build.require(fname, t, (n,), torch.float32, dev)


# ---- K1: the iteration ----

def _iter_math(pr, pr_out, dpr, rhs, op: PoissonOperator,
               check: bool) -> Optional[torch.Tensor]:
    """K1's arithmetic, uncounted (poisson_iter_plain and
    poisson_iter_sweeps_plain)."""
    lap, pc = _lap_folded(pr, op)
    resid = lap - rhs[INNER]
    d = _update_dpr(dpr, resid, op)
    # boundary and frozen cells: pr' = pr (as the kernel writes)
    pr_out.copy_(pr)
    pr_out[INNER] = pc + op.dtau * d
    return torch.max(torch.abs(resid)) if check else None


def poisson_iter_plain(pr, pr_out, dpr, rhs, op: PoissonOperator,
                       check: bool) -> Optional[torch.Tensor]:
    """Plain PyTorch version of K1 (same arguments and effects as
    poisson_iter)."""
    poisson_iter_plain.calls += 1
    return _iter_math(pr, pr_out, dpr, rhs, op, check)


poisson_iter_plain.calls = 0


def poisson_iter(pr, pr_out, dpr, rhs, op: PoissonOperator,
                 check: bool) -> Optional[torch.Tensor]:
    """One folded PT iteration: reads pr and rhs, updates dpr in place and
    writes every cell of pr_out (which must not alias pr). With check=True
    returns the max |resid| over interior cells (a 0-dim tensor on the
    device; the residual of the state ENTERING the iteration), else None.
    CUDA tensors launch the kernel (or raise); CPU tensors run the plain
    version."""
    if not _build.on_cuda(pr, "poisson_iter"):
        return poisson_iter_plain(pr, pr_out, dpr, rhs, op, check)
    dev = pr.device
    _check_operands(op, pr.shape, dev, pr=pr, pr_out=pr_out,
                    dpr=dpr, rhs=rhs)
    if pr_out.data_ptr() == pr.data_ptr():
        raise ValueError("poisson_iter: pr_out must not alias pr (Jacobi)")
    err = torch.zeros((1,), dtype=torch.int32, device=dev) if check else None
    nx, ny, nz = pr.shape
    lib = _build.load()
    rc = lib.ns3d_poisson_iter(
        pr.data_ptr(), pr_out.data_ptr(), dpr.data_ptr(), rhs.data_ptr(),
        op.wyp.data_ptr(), op.wym.data_ptr(), op.wzp.data_ptr(),
        op.wzm.data_ptr(), ctypes.c_float(op.inv_dx2),
        ctypes.c_float(op.dtau), ctypes.c_float(op.decay),
        int(op.zero_grad_x), nx, ny, nz, _build.ptr(err),
        _build.stream_of(pr))
    _build.check(rc, "poisson_iter")
    poisson_iter.launches += 1
    return err.view(torch.float32)[0] if check else None


poisson_iter.launches = 0


# ---- K8: s folded iterations per launch ----

MAX_SWEEPS = 4   # the depths ns3d_poisson_iter_sweeps instantiates: 2..4


def _check_sweeps(s: int, name: str) -> None:
    if not 2 <= s <= MAX_SWEEPS:
        raise ValueError(f"{name}: s={s}, expected 2 <= s <= {MAX_SWEEPS}")


def poisson_iter_sweeps_plain(pr, dpr, rhs, pr_out, dpr_out,
                              op: PoissonOperator, s: int,
                              check: bool) -> Optional[torch.Tensor]:
    """Plain PyTorch version of K8 (same arguments and effects as
    poisson_iter_sweeps): K1's arithmetic s times, dpr carried in
    dpr_out."""
    _check_sweeps(s, "poisson_iter_sweeps_plain")
    poisson_iter_sweeps_plain.calls += 1
    poisson_iter_sweeps_plain.iterations += s
    dpr_out.copy_(dpr)
    spare = torch.empty_like(pr)
    p = pr
    for j in range(s):
        # the last sweep lands in pr_out
        dst = pr_out if (s - 1 - j) % 2 == 0 else spare
        err = _iter_math(p, dst, dpr_out, rhs, op, check and j == s - 1)
        p = dst
    return err


poisson_iter_sweeps_plain.calls = 0
poisson_iter_sweeps_plain.iterations = 0


# K8's launch geometry (csrc/poisson.cu, the K8 section): each of a
# block's SWEEP_THREADS threads owns a run of SWEEP_RUN z-consecutive cells
# of one row of its (y, z) region, a row padded to whole runs in shared
# memory, which holds a ring of SWEEP_RING planes of pr, dpr and rhs (two
# in flight, t and t - 1) within the block's limit (SMEM_LIMIT, Hopper's
# 227 KB)
SWEEP_THREADS = 512
SWEEP_RUN = 4
SWEEP_RING = 4
SMEM_LIMIT = 232448


@dataclasses.dataclass(frozen=True)
class SweepPlan:
    """How one K8 launch at depth s cuts the grid: (y, z) tiles of uy x uz
    cells (tiles_y x tiles_z of them, the last of each axis ragged) times
    x segments of `seg` planes; one block per (tile, segment). A block
    streams its region, the tile grown by s cells per side, through shared
    memory. The kernel derives the same geometry (SweepGeom) and refuses a
    plan whose region it cannot hold."""
    s: int
    uy: int
    uz: int
    tiles_y: int
    tiles_z: int
    seg: int
    segs: int

    @property
    def ry(self) -> int:          # region rows
        return self.uy + 2 * self.s

    @property
    def w(self) -> int:           # region lanes
        return self.uz + 2 * self.s

    @property
    def runs(self) -> int:        # a region row's runs (threads)
        return -(-self.w // SWEEP_RUN)

    @property
    def wp(self) -> int:          # a region row's floats in shared memory
        return self.runs * SWEEP_RUN

    @property
    def blocks(self) -> int:
        return self.tiles_y * self.tiles_z * self.segs

    @property
    def smem_bytes(self) -> int:
        """SweepGeom::smem: the ring (three fields of SWEEP_THREADS x
        SWEEP_RUN floats per slot), two planes per level 1..s-1, two per
        field (pr, dpr) of level s on its way out (a plane: ry rows of wp
        floats), reduction scratch."""
        plane = self.ry * self.wp
        ring = 3 * SWEEP_RING * SWEEP_THREADS * SWEEP_RUN
        return 4 * (ring + plane * (2 * (self.s - 1) + 4)) + 4 * 32


@functools.lru_cache(maxsize=64)
def sweep_plan(shape: Tuple[int, int, int], s: int, sms: int) -> SweepPlan:
    """K8's plan for a grid of `shape` on a card of `sms` SMs (one block
    per SM: a block's shared memory is most of an SM's). Among the region
    shapes that fit a block (a thread a run: ry * ceil(w / SWEEP_RUN) <=
    SWEEP_THREADS; shared memory within SMEM_LIMIT) and the x cuts, it
    minimises the estimated time: waves x the planes a block streams (its
    segment, the 2s recomputed ones and one of fill) x the floats a plane
    of its region moves (ry rows of w, plus 8 for the 32-byte sector a row
    at an arbitrary offset adds). Ties go to fewer blocks. At 511x307x307,
    s = 3 on 132 SMs: tiles of 28 x 52 in 34 x 58 regions (34 rows of 15
    runs: 510 threads), 11 x 6 of them, 2 segments of 256 planes: 132
    blocks, one wave."""
    _check_sweeps(s, "sweep_plan")
    nx, ny, nz = shape
    if min(shape) < 1 or sms < 1:
        raise ValueError(f"sweep_plan: shape {shape}, sms {sms}")
    best, best_key = None, None
    for uz in sorted({-(-nz // tz) for tz in range(1, nz + 1)}):
        w = uz + 2 * s
        runs = -(-w // SWEEP_RUN)
        if runs * (2 * s + 1) > SWEEP_THREADS:
            continue
        uy = min(SWEEP_THREADS // runs - 2 * s, ny)
        tiles_y = -(-ny // uy)
        uy = -(-ny // tiles_y)
        tiles_z = -(-nz // uz)
        plan = SweepPlan(s, uy, uz, tiles_y, tiles_z, nx, 1)
        if plan.smem_bytes > SMEM_LIMIT:
            continue
        tiles = tiles_y * tiles_z
        for waves in range(1, -(-tiles * nx // sms) + 1):
            segs = min(waves * sms // tiles, nx)
            if segs < 1:
                continue
            seg = -(-nx // segs)
            segs = -(-nx // seg)
            blocks = tiles * segs
            cost = (-(-blocks // sms) * (seg + 2 * s + 1)
                    * plan.ry * (w + 8))
            key = (cost, blocks)
            if best_key is None or key < best_key:
                best_key = key
                best = dataclasses.replace(plan, seg=seg, segs=segs)
    return best


def poisson_iter_sweeps(pr, dpr, rhs, pr_out, dpr_out, op: PoissonOperator,
                        s: int, check: bool) -> Optional[torch.Tensor]:
    """s folded PT iterations (2 <= s <= 4) in one launch, bitwise equal to
    s poisson_iter calls: reads pr, dpr and rhs and writes every cell of
    pr_out and dpr_out, neither of which may alias an input (blocks read
    the inputs over their halos). With check=True returns the max |resid|
    over interior cells entering the LAST iteration (a 0-dim tensor on the
    device), else None. CUDA tensors launch the kernel under
    `sweep_plan` (or raise); CPU tensors run the plain version."""
    _check_sweeps(s, "poisson_iter_sweeps")
    if not _build.on_cuda(pr, "poisson_iter_sweeps"):
        return poisson_iter_sweeps_plain(pr, dpr, rhs, pr_out, dpr_out, op,
                                         s, check)
    plan = sweep_plan(tuple(pr.shape), s, _build.sm_count(pr.device))
    return launch_sweeps(pr, dpr, rhs, pr_out, dpr_out, op, plan, check)


def launch_sweeps(pr, dpr, rhs, pr_out, dpr_out, op: PoissonOperator,
                  plan: SweepPlan, check: bool) -> Optional[torch.Tensor]:
    """One K8 launch under a given plan (poisson_iter_sweeps takes
    `sweep_plan`'s; the card tests force others): the operand checks, the
    launch, the count."""
    _check_sweeps(plan.s, "launch_sweeps")
    dev = pr.device
    _check_operands(op, pr.shape, dev, pr=pr, dpr=dpr, rhs=rhs,
                    pr_out=pr_out, dpr_out=dpr_out)
    outs = {pr_out.data_ptr(), dpr_out.data_ptr()}
    if len(outs) != 2 or outs & {pr.data_ptr(), dpr.data_ptr(),
                                 rhs.data_ptr()}:
        raise ValueError("poisson_iter_sweeps: pr_out and dpr_out must be "
                         "distinct and alias no input")
    # the check word: reset by a stream-ordered memset in the C entry
    err = torch.empty((1,), dtype=torch.int32, device=dev) if check else None
    nx, ny, nz = pr.shape
    lib = _build.load()
    rc = lib.ns3d_poisson_iter_sweeps(
        pr.data_ptr(), dpr.data_ptr(), rhs.data_ptr(), pr_out.data_ptr(),
        dpr_out.data_ptr(), op.wyp.data_ptr(), op.wym.data_ptr(),
        op.wzp.data_ptr(), op.wzm.data_ptr(), ctypes.c_float(op.inv_dx2),
        ctypes.c_float(op.dtau), ctypes.c_float(op.decay),
        int(op.zero_grad_x), nx, ny, nz, plan.s, plan.uy, plan.uz,
        plan.tiles_y, plan.tiles_z, plan.seg, _build.ptr(err),
        _build.stream_of(pr))
    _build.check(rc, "poisson_iter_sweeps")
    poisson_iter_sweeps.launches += 1
    poisson_iter_sweeps.iterations += plan.s
    return err.view(torch.float32)[0] if check else None


poisson_iter_sweeps.launches = 0
poisson_iter_sweeps.iterations = 0


# ---- K10: nit folded iterations in one launch, resident on chip ----

def _check_nit(nit: int, name: str) -> None:
    if int(nit) < 1:
        raise ValueError(f"{name}: nit={nit}, expected >= 1")


def _resident_math(pr, dpr, rhs, op: PoissonOperator, nit: int, spare):
    """K10's arithmetic over nit iterations, uncounted
    (poisson_iter_resident_plain and poisson_loop_resident_plain)."""
    # as the kernel: iteration j reads src and writes dst, then they
    # swap; for an odd nit the input is first copied into the scratch, so
    # that the last iteration writes the caller's pr
    src, dst = pr, spare
    if nit % 2:
        spare.copy_(pr)
        src, dst = spare, pr
    for j in range(nit):
        err = _iter_math(src, dst, dpr, rhs, op, j == nit - 1)
        src, dst = dst, src
    return err


def poisson_iter_resident_plain(pr, dpr, rhs, op: PoissonOperator, nit: int,
                                scratch=None) -> torch.Tensor:
    """Plain PyTorch version of K10 (same arguments and effects as
    poisson_iter_resident): K1's arithmetic nit times, only the last
    iteration checked, pr ping-ponging with scratch."""
    _check_nit(nit, "poisson_iter_resident_plain")
    poisson_iter_resident_plain.calls += 1
    poisson_iter_resident_plain.iterations += int(nit)
    spare = torch.empty_like(pr) if scratch is None else scratch
    return _resident_math(pr, dpr, rhs, op, nit, spare)


poisson_iter_resident_plain.calls = 0
poisson_iter_resident_plain.iterations = 0
poisson_iter_resident_plain.checks = 0


def poisson_loop_resident_plain(pr, dpr, rhs, op: PoissonOperator,
                                rule: ExitRule, scratch=None) -> torch.Tensor:
    """Plain PyTorch version of the launch behind poisson_loop_resident:
    from global iteration rule.it0, K10's arithmetic over check intervals
    of nit = nchk - it % nchk iterations (the result in the caller's pr
    after each), each exit decision taken from the check values as the
    kernel takes it (`rule`). Returns the launch's result: an int32
    tensor of the checks taken, then each check's max |resid| as float
    bits (rule.max_checks slots, zero past the last). It counts as one
    call of K10's plain version, with the loop's iterations and checks."""
    poisson_iter_resident_plain.calls += 1
    spare = torch.empty_like(pr) if scratch is None else scratch
    res = torch.zeros((1 + rule.max_checks,), dtype=torch.int32)
    it, errs = rule.it0, []
    while True:
        nit = rule.nchk - it % rule.nchk
        raw = _resident_math(pr, dpr, rhs, op, nit, spare).cpu()
        it += nit
        res[1 + len(errs)] = raw.view(torch.int32)
        errs.append(raw.numpy() * rule.scale)
        if rule.stops(it, errs):
            break
    res[0] = len(errs)
    poisson_iter_resident_plain.iterations += it - rule.it0
    poisson_iter_resident_plain.checks += len(errs)
    return res


# K10's launch geometry (csrc/poisson.cu, the K10 section): blocks of
# RESIDENT_THREADS threads, one per SM, each holding the dpr of a region
# of (y, z) columns through all planes, rows of RESIDENT_LANES z cells (a
# warp's width), at most one column a thread (`grid_smem`). A block's
# dynamic shared memory stays within SMEM_LIMIT less RESIDENT_STATIC_SMEM
# (its static reduction words) and is at least RESIDENT_SOLO_SMEM, more
# than half of an SM's 228 KB, so that no SM holds two blocks. The H100's
# numbers decide for the CPU's plain version.
RESIDENT_THREADS = 1024
RESIDENT_LANES = 32
RESIDENT_STATIC_SMEM = 256
RESIDENT_SOLO_SMEM = 118784
H100_SMS = 132


@dataclasses.dataclass(frozen=True)
class ResidentPlan:
    """One K10 launch: dpr in the shared memory of `blocks` = cut[0] x
    cut[1] blocks, at most one per SM, block b owning the (y, z) columns
    of y part balanced_part(ny, cut[0], b // cut[1]) and z row b % cut[1]
    (RESIDENT_LANES cells from RESIDENT_LANES * (b % cut[1])) through all
    planes, at most `per_block` column slots, RESIDENT_LANES a y row
    (`grid_cut`); `smem_bytes` of dynamic shared memory per block."""
    blocks: int
    per_block: int
    smem_bytes: int
    cut: Tuple[int, int]


def grid_smem(columns: int, nx: int) -> int:
    """Bytes of shared memory a block of K10 needs for a region of
    `columns` (y, z) column slots through `nx` planes: their dpr, 4 B a
    cell."""
    return 4 * columns * nx


def grid_cut(ny: int, nz: int, sms: int) -> Tuple[int, int]:
    """K10's cut of the (y, z) column plane, one region a block: z into
    cut_z = ceil(nz / RESIDENT_LANES) rows of RESIDENT_LANES cells (a
    warp's width; the last the remainder), y into cut_y balanced parts, as
    many as leave a block per SM (cut_y = sms // cut_z, at most ny; 0
    where the z rows alone outnumber the SMs). At 153x153 on 132 SMs: 26 x
    5, regions of 5-6 y by 32 z (25 in the last z row), at most 192
    column slots."""
    if min(ny, nz, sms) < 1:
        raise ValueError(f"grid_cut: ny {ny}, nz {nz}, sms {sms}")
    gz = -(-nz // RESIDENT_LANES)
    return min(ny, sms // gz), gz


@functools.lru_cache(maxsize=64)
def resident_plan(shape: Tuple[int, int, int],
                  sms: int) -> Optional[ResidentPlan]:
    """K10's plan for a grid of `shape` on a card of `sms` SMs: the cut of
    `grid_cut`, where its largest region holds at most RESIDENT_THREADS
    column slots and their dpr through nx planes fits a block
    (`grid_smem`); else None. At 63x38x38 on 132 SMs: 38 x 2 = 76 blocks
    of 32 slots; at 255x153x153: 26 x 5 = 130 blocks of at most 6 x 32 =
    192 slots (195,840 B of dpr); at 511x307x307 none (13 x 10, 24 x 32
    slots through 511 planes, 1.57 MB a block)."""
    nx, ny, nz = shape
    if min(shape) < 1 or sms < 1 or nx * ny * nz >= 2 ** 31:
        raise ValueError(f"resident_plan: shape {shape}, sms {sms}")
    gy, gz = grid_cut(ny, nz, sms)
    if gy >= 1:
        columns = -(-ny // gy) * RESIDENT_LANES
        need = grid_smem(columns, nx)
        if (columns <= RESIDENT_THREADS
                and need <= SMEM_LIMIT - RESIDENT_STATIC_SMEM):
            return ResidentPlan(gy * gz, columns,
                                max(need, RESIDENT_SOLO_SMEM), (gy, gz))
    return None


def resident_sms(device) -> int:
    """The SMs of a CUDA device, which K10's plan cuts the grid for; the
    H100's for the CPU (whose plain version answers as an H100 would)."""
    device = torch.device(device)
    return (_build.sm_count(device) if device.type == "cuda"
            else H100_SMS)


def poisson_iter_resident(pr, dpr, rhs, op: PoissonOperator, nit: int,
                          scratch=None) -> torch.Tensor:
    """nit folded PT iterations in one launch resident on chip, bitwise
    equal to nit poisson_iter calls: pr and dpr are updated in place (the
    result lands in the caller's pr; `scratch`, a tensor of pr's shape
    that aliases no operand, takes the other half of the kernel's
    ping-pong and is allocated when None). Returns the max |resid| over
    interior cells of the state entering the LAST iteration (a 0-dim
    tensor on the device): the check value the flagged K1 launch closing
    a chunk emits. CUDA tensors launch the kernel under `resident_plan`'s
    plan, and raise where the grid has none or the card refuses the
    launch; CPU tensors run the plain version."""
    _check_nit(nit, "poisson_iter_resident")
    if not _build.on_cuda(pr, "poisson_iter_resident"):
        return poisson_iter_resident_plain(pr, dpr, rhs, op, nit, scratch)
    plan = resident_plan(tuple(pr.shape), resident_sms(pr.device))
    if plan is None:
        raise ValueError(f"poisson_iter_resident: no resident plan for a "
                         f"grid of {tuple(pr.shape)}")
    return launch_resident(pr, dpr, rhs, op, nit, plan, scratch)


def _launch_k10(pr, dpr, rhs, op: PoissonOperator, rule: ExitRule,
                plan: ResidentPlan, scratch, res: torch.Tensor) -> None:
    """One K10 launch under `rule` and `plan`: the operand checks, the
    launch, the launch count. res: int32, zeroed, the checks taken then
    rule.max_checks slots of check values."""
    dev = pr.device
    if scratch is None:
        scratch = torch.empty_like(pr)
    _check_operands(op, pr.shape, dev, pr=pr, dpr=dpr, rhs=rhs,
                    scratch=scratch)
    ptrs = [t.data_ptr() for t in (pr, dpr, rhs, scratch)]
    if len(set(ptrs)) != 4:
        raise ValueError("poisson_iter_resident: pr, dpr, rhs and scratch "
                         "must be distinct")
    nx, ny, nz = pr.shape
    lib = _build.load()
    f32 = ctypes.c_float
    floats = (f32(float(v)) for v in (rule.eps, rule.scale, rule.thresh,
                                      rule.big))
    rc = lib.ns3d_poisson_iter_resident(
        pr.data_ptr(), scratch.data_ptr(), dpr.data_ptr(), rhs.data_ptr(),
        op.wyp.data_ptr(), op.wym.data_ptr(), op.wzp.data_ptr(),
        op.wzm.data_ptr(), f32(op.inv_dx2), f32(op.dtau), f32(op.decay),
        int(op.zero_grad_x), nx, ny, nz, rule.it0, rule.niter, rule.nchk,
        *floats, rule.window, plan.blocks, *plan.cut, plan.smem_bytes,
        res[1:].data_ptr(), res.data_ptr(), _build.stream_of(pr))
    _build.check(rc, "poisson_iter_resident")
    poisson_iter_resident.launches += 1


def launch_resident(pr, dpr, rhs, op: PoissonOperator, nit: int,
                    plan: ResidentPlan, scratch=None) -> torch.Tensor:
    """One K10 launch of nit iterations under a given plan
    (poisson_iter_resident takes `resident_plan`'s; the card tests force
    others): the operand checks, the launch, the counts."""
    _check_nit(nit, "launch_resident")
    one = np.float32(1.0)
    res = torch.zeros((2,), dtype=torch.int32, device=pr.device)
    _launch_k10(pr, dpr, rhs, op, ExitRule(0, nit, nit, one, one, 0, one,
                                           one), plan, scratch, res)
    poisson_iter_resident.iterations += int(nit)
    return res[1:].view(torch.float32)[0]


poisson_iter_resident.launches = 0
poisson_iter_resident.iterations = 0
poisson_iter_resident.checks = 0


def poisson_loop_resident(pr, dpr, rhs, op: PoissonOperator,
                          rule: ExitRule, scratch=None) -> np.ndarray:
    """A folded loop's check intervals in ONE K10 launch that takes each
    exit decision on the card: from global iteration rule.it0, intervals
    of nit = nchk - it % nchk iterations, each bitwise one
    poisson_iter_resident launch of that nit (pr and dpr in place,
    `scratch` the other half of pr's ping-pong), until `rule` stops the
    loop (ptloop.ExitRule: pt_loop_fused's decision after each check).
    Returns the check values the loop took, in order, in err units
    (max|resid| x rule.scale, float32), read by the host in one
    ptloop.host_array, which also adds the loop's iterations and checks
    to the counts. CUDA tensors launch the kernel under `resident_plan`'s
    plan, and raise where the grid has none or the card refuses the
    launch; CPU tensors run the plain version."""
    if not _build.on_cuda(pr, "poisson_loop_resident"):
        res = poisson_loop_resident_plain(pr, dpr, rhs, op, rule, scratch)
    else:
        plan = resident_plan(tuple(pr.shape), resident_sms(pr.device))
        if plan is None:
            raise ValueError(f"poisson_loop_resident: no resident plan for "
                             f"a grid of {tuple(pr.shape)}")
        res = torch.zeros((1 + rule.max_checks,), dtype=torch.int32,
                          device=pr.device)
        _launch_k10(pr, dpr, rhs, op, rule, plan, scratch, res)
    words = host_array(res)
    n = int(words[0])
    if res.is_cuda:
        poisson_iter_resident.iterations += (
            (rule.it0 // rule.nchk + n) * rule.nchk - rule.it0)
        poisson_iter_resident.checks += n
    return words[1:1 + n].view(np.float32) * rule.scale


def make_resident(nit: int, shape: Optional[Tuple[int, int, int]] = None,
                  device="cpu"):
    """The counterpart of the JAX package's `make_resident`
    (kernels/poisson.py:1066): a callable run(pr, dpr, rhs, op) -> (pr,
    dpr, err) that advances nit folded iterations in one K10 launch, with
    the result in the caller's pr and dpr (K10's aliasing) and err the
    check value of the state entering the last iteration; the scratch
    half of the ping-pong is kept between calls of one shape. Given the
    grid's `shape`, it returns None where K10 has no plan for that grid
    on `device` (`resident_plan`; the CPU's plain version answers as an
    H100 would), as the JAX package's returns None above its VMEM
    budget."""
    _check_nit(nit, "make_resident")
    if shape is not None and resident_plan(
            tuple(shape), resident_sms(device)) is None:
        return None
    scratch = {}

    def run(pr, dpr, rhs, op: PoissonOperator):
        key = (tuple(pr.shape), pr.dtype, pr.device)
        if key not in scratch:
            scratch.clear()
            scratch[key] = torch.empty_like(pr)
        err = poisson_iter_resident(pr, dpr, rhs, op, nit, scratch[key])
        return pr, dpr, err
    return run


# ---- K2: the double-single iteration ----

def _ext_math(hi, lo, hi_out, lo_out, dpr, rhs, op: PoissonOperator,
              check: bool) -> Optional[torch.Tensor]:
    """K2's arithmetic, uncounted (poisson_iter_ext_plain and
    poisson_iter_resident_ext_plain)."""
    lap_h, _ = _lap_folded(hi, op)
    lap_l, _ = _lap_folded(lo, op)
    resid = (lap_h - rhs[INNER]) + lap_l
    _update_dpr(dpr, resid, op)
    # every cell: u = lo + dtau*dpr (dpr = 0 off the interior, so there
    # the two_sum renormalizes the pair: hi absorbs lo)
    u = lo + op.dtau * dpr
    s = hi + u
    ap = s - u
    bp = s - ap
    hi_out.copy_(s)
    lo_out.copy_((hi - ap) + (u - bp))
    return torch.max(torch.abs(resid)) if check else None


def poisson_iter_ext_plain(hi, lo, hi_out, lo_out, dpr, rhs,
                           op: PoissonOperator,
                           check: bool) -> Optional[torch.Tensor]:
    """Plain PyTorch version of K2 (same arguments and effects as
    poisson_iter_ext)."""
    poisson_iter_ext_plain.calls += 1
    poisson_iter_ext_plain.iterations += 1
    return _ext_math(hi, lo, hi_out, lo_out, dpr, rhs, op, check)


poisson_iter_ext_plain.calls = 0
poisson_iter_ext_plain.iterations = 0


def poisson_iter_ext(hi, lo, hi_out, lo_out, dpr, rhs, op: PoissonOperator,
                     check: bool) -> Optional[torch.Tensor]:
    """One folded PT iteration of the (hi, lo) pressure pair: reads hi, lo
    and rhs, updates dpr in place and writes every cell of hi_out and
    lo_out (which must alias neither input). The residual is
    (lap(hi) - rhs) + lap(lo) and the update an exact two_sum, so the
    pair carries ~48 bits where K1's single word carries 24. With
    check=True returns the max |resid| over interior cells (a 0-dim
    tensor on the device), else None. CUDA tensors launch the kernel (or
    raise); CPU tensors run the plain version."""
    if not _build.on_cuda(hi, "poisson_iter_ext"):
        return poisson_iter_ext_plain(hi, lo, hi_out, lo_out, dpr, rhs, op,
                                      check)
    dev = hi.device
    _check_operands(op, hi.shape, dev, hi=hi, lo=lo,
                    hi_out=hi_out, lo_out=lo_out, dpr=dpr, rhs=rhs)
    outs = {hi_out.data_ptr(), lo_out.data_ptr()}
    if len(outs) != 2 or outs & {hi.data_ptr(), lo.data_ptr()}:
        raise ValueError("poisson_iter_ext: hi_out and lo_out must be "
                         "distinct and alias neither input (Jacobi)")
    err = torch.zeros((1,), dtype=torch.int32, device=dev) if check else None
    nx, ny, nz = hi.shape
    lib = _build.load()
    rc = lib.ns3d_poisson_iter_ext(
        hi.data_ptr(), lo.data_ptr(), hi_out.data_ptr(), lo_out.data_ptr(),
        dpr.data_ptr(), rhs.data_ptr(), op.wyp.data_ptr(), op.wym.data_ptr(),
        op.wzp.data_ptr(), op.wzm.data_ptr(), ctypes.c_float(op.inv_dx2),
        ctypes.c_float(op.dtau), ctypes.c_float(op.decay),
        int(op.zero_grad_x), nx, ny, nz, _build.ptr(err),
        _build.stream_of(hi))
    _build.check(rc, "poisson_iter_ext")
    poisson_iter_ext.launches += 1
    poisson_iter_ext.iterations += 1
    return err.view(torch.float32)[0] if check else None


poisson_iter_ext.launches = 0
poisson_iter_ext.iterations = 0


# ---- K12: nit of K2's iterations in one launch, resident on chip ----

# K12's blocks (csrc/poisson.cu kResidentExtThreads): at most one column
# slot a thread, so K12 runs under those of K10's plans whose blocks hold
# at most this many slots (all of them on the presets' grids)
RESIDENT_EXT_THREADS = 768


def resident_ext_fits(plan: Optional[ResidentPlan]) -> bool:
    """Whether K12 runs under K10's plan `plan` (None: no plan): its
    blocks of RESIDENT_EXT_THREADS threads hold the plan's column slots.
    At 255x153x153 (192 slots) and 63x38x38 (32) they do; a plan of more
    than RESIDENT_EXT_THREADS slots needs a grid of at most 72 planes
    with more than 24 y rows in a block's region, such as 8x1650x33."""
    return plan is not None and plan.per_block <= RESIDENT_EXT_THREADS


def poisson_iter_resident_ext_plain(hi, lo, dpr, rhs, op: PoissonOperator,
                                    nit: int, hi_scratch=None,
                                    lo_scratch=None) -> torch.Tensor:
    """Plain PyTorch version of K12 (same arguments and effects as
    poisson_iter_resident_ext): K2's arithmetic nit times, only the last
    iteration checked, hi and lo ping-ponging with their scratch."""
    _check_nit(nit, "poisson_iter_resident_ext_plain")
    poisson_iter_resident_ext_plain.calls += 1
    poisson_iter_resident_ext_plain.iterations += int(nit)
    sh = torch.empty_like(hi) if hi_scratch is None else hi_scratch
    sl = torch.empty_like(lo) if lo_scratch is None else lo_scratch
    # as the kernel (and K10's plain version): for an odd nit both words
    # are first copied into the scratch, so that the last iteration
    # writes the caller's hi and lo
    src, dst = (hi, lo), (sh, sl)
    if nit % 2:
        sh.copy_(hi)
        sl.copy_(lo)
        src, dst = dst, src
    for j in range(nit):
        err = _ext_math(*src, *dst, dpr, rhs, op, j == nit - 1)
        src, dst = dst, src
    return err


poisson_iter_resident_ext_plain.calls = 0
poisson_iter_resident_ext_plain.iterations = 0


def poisson_iter_resident_ext(hi, lo, dpr, rhs, op: PoissonOperator,
                              nit: int, hi_scratch=None,
                              lo_scratch=None) -> torch.Tensor:
    """nit PT iterations of the (hi, lo) pressure pair in one launch
    resident on chip, bitwise equal to nit poisson_iter_ext calls: hi, lo
    and dpr are updated in place (the result lands in the caller's hi and
    lo; hi_scratch and lo_scratch, tensors of hi's shape that alias no
    operand, take the other half of each word's ping-pong and are
    allocated when None). Returns the max |resid| over interior cells of
    the state entering the LAST iteration (a 0-dim tensor on the device):
    what poisson_iter_ext returns when called with check=True on that
    iteration. CUDA tensors launch the kernel under K10's plan
    (`resident_plan`), and raise where the grid has none that K12's
    blocks hold (`resident_ext_fits`) or the card refuses the launch; CPU
    tensors run the plain version."""
    _check_nit(nit, "poisson_iter_resident_ext")
    if not _build.on_cuda(hi, "poisson_iter_resident_ext"):
        return poisson_iter_resident_ext_plain(hi, lo, dpr, rhs, op, nit,
                                               hi_scratch, lo_scratch)
    plan = resident_plan(tuple(hi.shape), resident_sms(hi.device))
    if not resident_ext_fits(plan):
        raise ValueError(f"poisson_iter_resident_ext: no resident plan for "
                         f"a grid of {tuple(hi.shape)} that K12's blocks "
                         f"hold ({plan})")
    return launch_resident_ext(hi, lo, dpr, rhs, op, nit, plan, hi_scratch,
                               lo_scratch)


def launch_resident_ext(hi, lo, dpr, rhs, op: PoissonOperator, nit: int,
                        plan: ResidentPlan, hi_scratch=None,
                        lo_scratch=None) -> torch.Tensor:
    """One K12 launch under a given plan (poisson_iter_resident_ext takes
    `resident_plan`'s; the card tests force others): the operand checks,
    the launch, the counts."""
    _check_nit(nit, "launch_resident_ext")
    dev = hi.device
    if hi_scratch is None:
        hi_scratch = torch.empty_like(hi)
    if lo_scratch is None:
        lo_scratch = torch.empty_like(lo)
    _check_operands(op, hi.shape, dev, hi=hi, lo=lo, dpr=dpr, rhs=rhs,
                    hi_scratch=hi_scratch, lo_scratch=lo_scratch)
    ptrs = [t.data_ptr() for t in (hi, lo, dpr, rhs, hi_scratch,
                                   lo_scratch)]
    if len(set(ptrs)) != 6:
        raise ValueError("poisson_iter_resident_ext: hi, lo, dpr, rhs and "
                         "the two scratch tensors must be distinct")
    err = torch.zeros((1,), dtype=torch.int32, device=dev)
    nx, ny, nz = hi.shape
    lib = _build.load()
    rc = lib.ns3d_poisson_iter_resident_ext(
        hi.data_ptr(), lo.data_ptr(), hi_scratch.data_ptr(),
        lo_scratch.data_ptr(), dpr.data_ptr(), rhs.data_ptr(),
        op.wyp.data_ptr(), op.wym.data_ptr(), op.wzp.data_ptr(),
        op.wzm.data_ptr(), ctypes.c_float(op.inv_dx2),
        ctypes.c_float(op.dtau), ctypes.c_float(op.decay),
        int(op.zero_grad_x), nx, ny, nz, int(nit),
        plan.blocks, *plan.cut, plan.smem_bytes, err.data_ptr(),
        _build.stream_of(hi))
    _build.check(rc, "poisson_iter_resident_ext")
    poisson_iter_resident_ext.launches += 1
    poisson_iter_resident_ext.iterations += int(nit)
    return err.view(torch.float32)[0]


poisson_iter_resident_ext.launches = 0
poisson_iter_resident_ext.iterations = 0


# ---- K7: the iteration with the BCs applied in-kernel ----

class PoissonBCSpec(NamedTuple):
    """BC sequence applied in-kernel after the pressure update.

    multi variant: zero_grad_x=True,  xlo_plane=None,     xhi_plane=zeros
                   (bc_x!, bc_y!, bc_z!, outlet Dirichlet — multi_gpu.jl:175-184)
    gpu variant:   zero_grad_x=False, xlo_plane=prof+100, xhi_plane=prof
                   (bc_y!, bc_z!, hydrostatic x — gpu.jl:281-286)
    gpu + split:   xlo_plane=100s, xhi_plane=zeros, z_lo_add=-rho*g*dz,
                   z_hi_add=+rho*g*dz (the p' = Pr - P_static(z) image of
                   the same BC sequence; bc.affine_grad_z)
    """
    zero_grad_x: bool
    xlo_plane: Optional[np.ndarray]   # (ny*nz,) or None
    xhi_plane: Optional[np.ndarray]   # (ny*nz,) or None
    z_lo_add: float = 0.0             # additive offset on the z-lo copy
    z_hi_add: float = 0.0             # additive offset on the z-hi copy


def poisson_bc_spec(variant: str, grid, phys,
                    pressure_split: bool = False) -> PoissonBCSpec:
    """The configured variant's BC sequence as a kernel spec (planes in
    float64)."""
    nyz = grid.ny * grid.nz
    if variant == "multi":
        return PoissonBCSpec(zero_grad_x=True, xlo_plane=None,
                             xhi_plane=np.zeros(nyz))
    if pressure_split:
        rho_g_dz = phys.rho * phys.g * grid.dz
        return PoissonBCSpec(zero_grad_x=False,
                             xlo_plane=np.full(nyz, 100.0),
                             xhi_plane=np.zeros(nyz),
                             z_lo_add=-rho_g_dz, z_hi_add=+rho_g_dz)
    iz = np.arange(1, grid.nz + 1, dtype=np.float64)
    prof = phys.rho * phys.g * (grid.nz - iz + 0.5) * grid.dz
    prof2d = np.broadcast_to(prof[None, :], (grid.ny, grid.nz))
    return PoissonBCSpec(zero_grad_x=False,
                         xlo_plane=(prof2d + 100.0).ravel(),
                         xhi_plane=prof2d.ravel())


@dataclasses.dataclass(frozen=True)
class BCOperator:
    """K7's constants on one device, float32: the inverse squared spacings,
    dtau and decay and the z constants rounded as the JAX kernel rounds
    them, and the Dirichlet planes (ny, nz) rounded once from float64
    (None where that x face has no plane). K2-dist also takes the z
    constants' lo words zlo_lo/zhi_lo (float64 minus its float32 rounding,
    rounded: the JAX kernel's `zlo_lo`, kernels/poisson.py:234-239) and
    writes 0 on the lo word's Dirichlet planes; the dist kernels key their
    guards on the global x extent nx."""
    inv_dx2: float
    inv_dy2: float
    inv_dz2: float
    dtau: float
    decay: float
    zero_grad_x: bool
    xlo: Optional[torch.Tensor]
    xhi: Optional[torch.Tensor]
    z_lo_add: float
    z_hi_add: float
    zlo_lo: float
    zhi_lo: float
    nx: int


def make_bc_operator(spec: PoissonBCSpec, grid, device) -> BCOperator:
    f32 = lambda v: float(np.float32(v))  # noqa: E731

    def lo_word(v):
        return f32(np.float64(v) - np.float64(np.float32(v)))

    def plane(p):
        if p is None:
            return None
        return torch.tensor(np.asarray(p, np.float32).reshape(
            grid.ny, grid.nz), device=device)
    return BCOperator(
        inv_dx2=f32(1.0 / grid.dx / grid.dx),
        inv_dy2=f32(1.0 / grid.dy / grid.dy),
        inv_dz2=f32(1.0 / grid.dz / grid.dz), dtau=f32(grid.dtau),
        decay=f32(1.0 - grid.damp), zero_grad_x=bool(spec.zero_grad_x),
        xlo=plane(spec.xlo_plane), xhi=plane(spec.xhi_plane),
        z_lo_add=f32(spec.z_lo_add), z_hi_add=f32(spec.z_hi_add),
        zlo_lo=lo_word(spec.z_lo_add), zhi_lo=lo_word(spec.z_hi_add),
        nx=grid.nx)


def apply_bc_sequence(q, op: BCOperator, lo_word: bool = False,
                      x_lo: bool = True, x_hi: bool = True):
    """set_bc_Pr!'s sequence on the updated field (`apply_bc_rows`): x
    copies where x is zero-gradient, y copies, z copies plus their nonzero
    constants, then the Dirichlet x planes. lo_word: the sequence of the
    pair's lo word (the z constants' lo words, 0 on the Dirichlet planes).
    x_lo / x_hi: whether q's first / last x-plane is the global x face (a
    shard holds only its own). Returns a new tensor."""
    q = q.clone()
    if op.zero_grad_x:
        if x_lo:
            q[0] = q[1]
        if x_hi:
            q[-1] = q[-2]
    q[:, 0] = q[:, 1]
    q[:, -1] = q[:, -2]
    za, zb = (op.zlo_lo, op.zhi_lo) if lo_word else (op.z_lo_add,
                                                      op.z_hi_add)
    lo, hi = q[:, :, 1], q[:, :, -2]
    if za != 0.0:
        lo = lo + za
    if zb != 0.0:
        hi = hi + zb
    q[:, :, 0] = lo
    q[:, :, -1] = hi
    if op.xlo is not None and x_lo:
        q[0] = 0.0 if lo_word else op.xlo
    if op.xhi is not None and x_hi:
        q[-1] = 0.0 if lo_word else op.xhi
    return q


def poisson_iter_bc_plain(pr, dpr, rhs, pr_out, dpr_out,
                          op: BCOperator) -> None:
    """Plain PyTorch version of K7 (same arguments and effects as
    poisson_iter_bc)."""
    poisson_iter_bc_plain.calls += 1
    pc = pr[INNER]
    lap = ((pr[2:, 1:-1, 1:-1] - pc) + (pr[:-2, 1:-1, 1:-1] - pc)) * op.inv_dx2
    lap = lap + ((pr[1:-1, 2:, 1:-1] - pc)
                 + (pr[1:-1, :-2, 1:-1] - pc)) * op.inv_dy2
    lap = lap + ((pr[1:-1, 1:-1, 2:] - pc)
                 + (pr[1:-1, 1:-1, :-2] - pc)) * op.inv_dz2
    d = dpr[INNER] * op.decay + op.dtau * (lap - rhs[INNER])
    dpr_out.zero_()
    dpr_out[INNER] = d
    # off the interior q = pc + dtau*0, as the kernels compute it
    pr_out.copy_(apply_bc_sequence(pr + op.dtau * dpr_out, op))


poisson_iter_bc_plain.calls = 0


def poisson_iter_bc(pr, dpr, rhs, pr_out, dpr_out, op: BCOperator) -> None:
    """One PT iteration with the reference's BC sequence applied to the
    updated field: reads pr, dpr and rhs, writes every cell of pr_out and
    dpr_out (which must alias neither input: a ring cell is filled from
    its source cell's update, which reads the source's old dpr). dpr_out
    is 0 off the interior. No reduction: the caller evaluates the
    residual. CUDA tensors launch the kernel (or raise); CPU tensors run
    the plain version."""
    if not _build.on_cuda(pr, "poisson_iter_bc"):
        return poisson_iter_bc_plain(pr, dpr, rhs, pr_out, dpr_out, op)
    dev = pr.device
    for fname, t in (("pr", pr), ("dpr", dpr), ("rhs", rhs),
                     ("pr_out", pr_out), ("dpr_out", dpr_out)):
        _build.require(fname, t, pr.shape, torch.float32, dev)
    nx, ny, nz = pr.shape
    for fname, t in (("xlo", op.xlo), ("xhi", op.xhi)):
        if t is not None:
            _build.require(fname, t, (ny, nz), torch.float32, dev)
    outs = {pr_out.data_ptr(), dpr_out.data_ptr()}
    if len(outs) != 2 or outs & {pr.data_ptr(), dpr.data_ptr()}:
        raise ValueError("poisson_iter_bc: pr_out and dpr_out must be "
                         "distinct and alias neither input")
    if pr.numel() >= 2 ** 31:
        raise ValueError("poisson_iter_bc: the kernel indexes with 32 bits")
    # K7-dist's kernel on the whole grid (x_off = 0, no halo planes)
    plan = dist_plan((nx, ny, nz))
    lib = _build.load()
    f = ctypes.c_float
    rc = lib.ns3d_poisson_iter_bc(
        pr.data_ptr(), dpr.data_ptr(), rhs.data_ptr(), pr_out.data_ptr(),
        dpr_out.data_ptr(), _build.ptr(op.xlo), _build.ptr(op.xhi),
        f(op.inv_dx2), f(op.inv_dy2), f(op.inv_dz2), f(op.dtau),
        f(op.decay), f(op.z_lo_add), f(op.z_hi_add), int(op.zero_grad_x),
        nx, ny, nz, plan.tiles_y, plan.tiles_z, _build.stream_of(pr))
    _build.check(rc, "poisson_iter_bc")
    poisson_iter_bc.launches += 1


poisson_iter_bc.launches = 0


# ---- K7-dist and K2-dist: one x-shard of the distributed solve ----

# K7-dist's and K2-dist's launch geometry (csrc/poisson.cu, their section):
# a block of DIST_LANES x DIST_ROWS threads stands on one (y, z) tile of
# one plane of the shard, one thread per cell
DIST_LANES = 32
DIST_ROWS = 8


@dataclasses.dataclass(frozen=True)
class DistPlan:
    """How one K7-dist or K2-dist launch cuts each plane of a shard: y into
    tiles_y and z into tiles_z balanced parts (`balanced_part`: sizes
    differ by at most one); one block per (tile, plane), block (tz, ty,
    x) at z part tz, y part ty and plane x."""
    tiles_y: int
    tiles_z: int


def balanced_part(n: int, parts: int, i: int) -> Tuple[int, int]:
    """(start, size) of part i of n cut into `parts` parts whose sizes
    differ by at most one, as csrc/poisson.cu cuts a plane into tiles."""
    q, r = divmod(n, parts)
    return i * q + min(i, r), q + (i < r)


@functools.lru_cache(maxsize=64)
def dist_plan(shape: Tuple[int, int, int]) -> DistPlan:
    """The tiles of K7-dist and K2-dist for a shard of `shape` (bx, ny,
    nz): the fewest of at most DIST_ROWS x DIST_LANES cells. Every part
    has at least two rows and lanes (ny, nz >= 3), so a ring cell's
    clamped source, its y and z one cell inward, lies in its own tile. At
    85x153x153: 20 x 5 tiles (rows of 8 and 7, lanes of 31 and 30) x 85
    planes = 8500 blocks of 256 threads, eight waves of the 132 SMs' 1056
    resident blocks."""
    bx, ny, nz = shape
    if bx < 2 or ny < 3 or nz < 3:
        raise ValueError(f"dist_plan: shape {shape}")
    return DistPlan(-(-ny // DIST_ROWS), -(-nz // DIST_LANES))


def _x_ext(p, h_lo, h_hi):
    """p with its -x and +x halo planes, (bx+2, ny, nz); an open face (None)
    reads as zeros, as lax.ppermute's missing links give."""
    def plane(h):
        return torch.zeros_like(p[:1]) if h is None else h[None]
    return torch.cat((plane(h_lo), p, plane(h_hi)))


def _lap_unfolded(pe, op: BCOperator):
    """K7's Laplacian (lap_of_rows's order) on every owned cell of a shard,
    from its x-extended field pe: (lap, pc) over (bx, ny-2, nz-2)."""
    pc = pe[1:-1, 1:-1, 1:-1]
    lap = ((pe[2:, 1:-1, 1:-1] - pc) + (pe[:-2, 1:-1, 1:-1] - pc)) * op.inv_dx2
    lap = lap + ((pe[1:-1, 2:, 1:-1] - pc)
                 + (pe[1:-1, :-2, 1:-1] - pc)) * op.inv_dy2
    lap = lap + ((pe[1:-1, 1:-1, 2:] - pc)
                 + (pe[1:-1, 1:-1, :-2] - pc)) * op.inv_dz2
    return lap, pc


def _live_rows(bx: int, x_off: int, op: BCOperator, device):
    """The shard's planes that update (`rows_of`): globally interior in x,
    broadcast-shaped (bx, 1, 1)."""
    gx = x_off + torch.arange(bx, device=device)
    return ((gx >= 1) & (gx <= op.nx - 2)).reshape(bx, 1, 1)


def _dist_step(fields, dpr, rhs, dpr_out, x_off, op: BCOperator, check):
    """The damped update of a shard from its x-extended words `fields`
    (one for K7-dist, (hi, lo) for K2-dist): dpr_out written (0 off the
    interior); returns (the check value or None, the faces (x_lo, x_hi)
    of the global domain the shard holds)."""
    bx = dpr.shape[0]
    live = _live_rows(bx, x_off, op, dpr.device)
    laps = [_lap_unfolded(pe, op)[0] for pe in fields]
    resid = laps[0] - rhs[:, 1:-1, 1:-1]
    if len(laps) == 2:
        resid = resid + laps[1]
    d = dpr[:, 1:-1, 1:-1] * op.decay + op.dtau * resid
    dpr_out.zero_()
    dpr_out[:, 1:-1, 1:-1] = torch.where(live, d, torch.zeros_like(d))
    err = (torch.max(torch.where(live, torch.abs(resid),
                                 torch.zeros_like(resid)))
           if check else None)
    return err, (x_off == 0, x_off + bx == op.nx)


def _check_dist(name, p, halos, x_off, op: BCOperator, outs, ins):
    """Validate a dist launch: shapes, the shard's place in the global x
    extent, a halo plane wherever a neighbour exists, Jacobi outputs."""
    bx, ny, nz = p.shape
    if p.numel() >= 2 ** 31:
        raise ValueError(f"{name}: a shard of {p.numel()} cells; the kernel "
                         "indexes with 32 bits")
    if bx < 2 or not 0 <= x_off <= op.nx - bx:
        raise ValueError(f"{name}: a shard of {bx} planes at x_off={x_off} "
                         f"does not fit nx={op.nx} with >= 2 planes")
    for i, (lo, hi) in enumerate(halos):
        for side, h, needed in (("lo", lo, x_off > 0),
                                ("hi", hi, x_off + bx < op.nx)):
            if h is None:
                if needed:
                    raise ValueError(f"{name}: halo plane {i} {side} is "
                                     "missing where a neighbour exists")
                continue
            _build.require(f"halo {i} {side}", h, (ny, nz), torch.float32,
                           p.device)
    for fname, t in (("xlo", op.xlo), ("xhi", op.xhi)):
        if t is not None:
            _build.require(fname, t, (ny, nz), torch.float32, p.device)
    optr = {t.data_ptr() for t in outs}
    if len(optr) != len(outs) or optr & {t.data_ptr() for t in ins}:
        raise ValueError(f"{name}: the outputs must be distinct and alias "
                         "no input")


def poisson_iter_bc_dist_plain(pr, dpr, rhs, pr_out, dpr_out, h_lo, h_hi,
                               x_off: int, op: BCOperator,
                               check: bool) -> Optional[torch.Tensor]:
    """Plain PyTorch version of K7-dist (same arguments and effects as
    poisson_iter_bc_dist)."""
    poisson_iter_bc_dist_plain.calls += 1
    err, (x_lo, x_hi) = _dist_step([_x_ext(pr, h_lo, h_hi)], dpr, rhs,
                                   dpr_out, x_off, op, check)
    # off the interior q = pc + dtau*0, as the kernels compute it
    pr_out.copy_(apply_bc_sequence(pr + op.dtau * dpr_out, op, x_lo=x_lo,
                                   x_hi=x_hi))
    return err


poisson_iter_bc_dist_plain.calls = 0


def poisson_iter_bc_dist(pr, dpr, rhs, pr_out, dpr_out, h_lo, h_hi,
                         x_off: int, op: BCOperator,
                         check: bool) -> Optional[torch.Tensor]:
    """K7 on one x-shard: pr, dpr, rhs are the shard's (bx, ny, nz) owned
    planes at global x offset x_off, h_lo / h_hi the (ny, nz) planes of
    its -x / +x neighbour (None at an open global face). Writes every cell
    of pr_out and dpr_out (which must alias no input), updating the
    globally interior cells and applying the BC sequence where the global
    faces lie. With check=True returns the max |resid| over the shard's
    interior cells (a 0-dim tensor, the residual of the state entering the
    iteration), else None. CUDA tensors launch the kernel (or raise); CPU
    tensors run the plain version."""
    if not _build.on_cuda(pr, "poisson_iter_bc_dist"):
        return poisson_iter_bc_dist_plain(pr, dpr, rhs, pr_out, dpr_out,
                                          h_lo, h_hi, x_off, op, check)
    dev = pr.device
    for fname, t in (("dpr", dpr), ("rhs", rhs), ("pr_out", pr_out),
                     ("dpr_out", dpr_out), ("pr", pr)):
        _build.require(fname, t, pr.shape, torch.float32, dev)
    ins = [t for t in (pr, dpr, rhs, h_lo, h_hi) if t is not None]
    _check_dist("poisson_iter_bc_dist", pr, [(h_lo, h_hi)], x_off, op,
                (pr_out, dpr_out), ins)
    # the check word: reset by a stream-ordered memset in the C entry
    err = torch.empty((1,), dtype=torch.int32, device=dev) if check else None
    bx, ny, nz = pr.shape
    plan = dist_plan((bx, ny, nz))
    lib = _build.load()
    f = ctypes.c_float
    rc = lib.ns3d_poisson_iter_bc_dist(
        pr.data_ptr(), _build.ptr(h_lo), _build.ptr(h_hi), dpr.data_ptr(),
        rhs.data_ptr(), pr_out.data_ptr(), dpr_out.data_ptr(),
        _build.ptr(op.xlo), _build.ptr(op.xhi), f(op.inv_dx2),
        f(op.inv_dy2), f(op.inv_dz2), f(op.dtau), f(op.decay),
        f(op.z_lo_add), f(op.z_hi_add), int(op.zero_grad_x), x_off, op.nx,
        bx, ny, nz, plan.tiles_y, plan.tiles_z, _build.ptr(err),
        _build.stream_of(pr))
    _build.check(rc, "poisson_iter_bc_dist")
    poisson_iter_bc_dist.launches += 1
    return err.view(torch.float32)[0] if check else None


poisson_iter_bc_dist.launches = 0


def poisson_iter_ext_bc_dist_plain(hi, lo, dpr, rhs, hi_out, lo_out,
                                   dpr_out, h_lo, h_hi, l_lo, l_hi,
                                   x_off: int, op: BCOperator,
                                   check: bool) -> Optional[torch.Tensor]:
    """Plain PyTorch version of K2-dist (same arguments and effects as
    poisson_iter_ext_bc_dist)."""
    poisson_iter_ext_bc_dist_plain.calls += 1
    err, (x_lo, x_hi) = _dist_step(
        [_x_ext(hi, h_lo, h_hi), _x_ext(lo, l_lo, l_hi)], dpr, rhs, dpr_out,
        x_off, op, check)
    # every cell: u = lo + dtau*d (d = 0 off the interior), then two_sum
    u = lo + op.dtau * dpr_out
    s = hi + u
    ap = s - u
    bp = s - ap
    ql = (hi - ap) + (u - bp)
    hi_out.copy_(apply_bc_sequence(s, op, x_lo=x_lo, x_hi=x_hi))
    lo_out.copy_(apply_bc_sequence(ql, op, lo_word=True, x_lo=x_lo,
                                   x_hi=x_hi))
    return err


poisson_iter_ext_bc_dist_plain.calls = 0


def poisson_iter_ext_bc_dist(hi, lo, dpr, rhs, hi_out, lo_out, dpr_out, h_lo,
                             h_hi, l_lo, l_hi, x_off: int, op: BCOperator,
                             check: bool) -> Optional[torch.Tensor]:
    """K2's unfolded iteration of the (hi, lo) pressure pair on one
    x-shard: the residual (lap(hi) - rhs) + lap(lo) and an exact two_sum
    update, then the BC sequence on hi and, with the lo words of its
    constants, on lo. Operands as poisson_iter_bc_dist's, with a halo pair
    per word (h_lo, h_hi for hi; l_lo, l_hi for lo). Writes every cell of
    hi_out, lo_out and dpr_out (which must alias no input). x_off = 0 on
    the whole grid with no halo planes is K2's unfolded single-device form.
    CUDA tensors launch the kernel (or raise); CPU tensors run the plain
    version."""
    if not _build.on_cuda(hi, "poisson_iter_ext_bc_dist"):
        return poisson_iter_ext_bc_dist_plain(
            hi, lo, dpr, rhs, hi_out, lo_out, dpr_out, h_lo, h_hi, l_lo,
            l_hi, x_off, op, check)
    dev = hi.device
    for fname, t in (("lo", lo), ("dpr", dpr), ("rhs", rhs),
                     ("hi_out", hi_out), ("lo_out", lo_out),
                     ("dpr_out", dpr_out), ("hi", hi)):
        _build.require(fname, t, hi.shape, torch.float32, dev)
    ins = [t for t in (hi, lo, dpr, rhs, h_lo, h_hi, l_lo, l_hi)
           if t is not None]
    _check_dist("poisson_iter_ext_bc_dist", hi, [(h_lo, h_hi), (l_lo, l_hi)],
                x_off, op, (hi_out, lo_out, dpr_out), ins)
    err = torch.empty((1,), dtype=torch.int32, device=dev) if check else None
    bx, ny, nz = hi.shape
    plan = dist_plan((bx, ny, nz))
    lib = _build.load()
    f = ctypes.c_float
    rc = lib.ns3d_poisson_iter_ext_bc_dist(
        hi.data_ptr(), _build.ptr(h_lo), _build.ptr(h_hi), lo.data_ptr(),
        _build.ptr(l_lo), _build.ptr(l_hi), dpr.data_ptr(), rhs.data_ptr(),
        hi_out.data_ptr(), lo_out.data_ptr(), dpr_out.data_ptr(),
        _build.ptr(op.xlo), _build.ptr(op.xhi), f(op.inv_dx2),
        f(op.inv_dy2), f(op.inv_dz2), f(op.dtau), f(op.decay),
        f(op.z_lo_add), f(op.z_hi_add), f(op.zlo_lo), f(op.zhi_lo),
        int(op.zero_grad_x), x_off, op.nx, bx, ny, nz, plan.tiles_y,
        plan.tiles_z, _build.ptr(err), _build.stream_of(hi))
    _build.check(rc, "poisson_iter_ext_bc_dist")
    poisson_iter_ext_bc_dist.launches += 1
    return err.view(torch.float32)[0] if check else None


poisson_iter_ext_bc_dist.launches = 0


# ---- residual evaluations (torch ops, as XLA computes them in JAX) ----

def folded_lap(p, op: PoissonOperator):
    """Interior Laplacian with the boundary conditions folded in, in the
    JAX package's jnp form (models/chorin.py _folded_lap_fn: masked
    neighbor differences, then the two successive divisions)."""
    axm, axp, aym, ayp, azm, azp = op.masks
    pc = p[1:-1, 1:-1, 1:-1]
    return (div(div(axp * (p[2:, 1:-1, 1:-1] - pc)
                    + axm * (p[:-2, 1:-1, 1:-1] - pc), op.dx), op.dx)
            + div(div(ayp * (p[1:-1, 2:, 1:-1] - pc)
                      + aym * (p[1:-1, :-2, 1:-1] - pc), op.dy), op.dy)
            + div(div(azp * (p[1:-1, 1:-1, 2:] - pc)
                      + azm * (p[1:-1, 1:-1, :-2] - pc), op.dz), op.dz))


def residual_max(p, rhs, op: PoissonOperator) -> torch.Tensor:
    """max |folded_lap(p) - rhs| over interior cells: a plain (single
    rounding per operation) evaluation, the 3D form of residual_flat."""
    return torch.max(torch.abs(folded_lap(p, op) - rhs[1:-1, 1:-1, 1:-1]))


# ---- K13: the compensated residual ----

def compensated_residual_plain(p, rhs_hi, rhs_lo, op: PoissonOperator):
    """Plain PyTorch version of compensated_residual (same arguments and
    results)."""
    compensated_residual_plain.calls += 1
    q = op.quads
    pc = p[1:-1, 1:-1, 1:-1]
    nbs = ((p[2:, 1:-1, 1:-1], q["xp"]), (p[:-2, 1:-1, 1:-1], q["xm"]),
           (p[1:-1, 2:, 1:-1], q["yp"]), (p[1:-1, :-2, 1:-1], q["ym"]),
           (p[1:-1, 1:-1, 2:], q["zp"]), (p[1:-1, 1:-1, :-2], q["zm"]))
    pairs = [ds.weighted_term(*ds.two_sum(nb, -pc), quad)
             for nb, quad in nbs]
    pairs.append((-rhs_hi[1:-1, 1:-1, 1:-1], -rhs_lo[1:-1, 1:-1, 1:-1]))
    s, c = ds.accumulate(pairs)
    r = torch.zeros_like(p)
    r[1:-1, 1:-1, 1:-1] = s + c
    return r, torch.max(torch.abs(r))


compensated_residual_plain.calls = 0


def pair_residual_plain(hi, lo, rhs_hi, rhs_lo, op: PoissonOperator):
    """Plain PyTorch version of pair_residual (same arguments and
    results)."""
    pair_residual_plain.calls += 1
    q = op.quads
    hic, loc = hi[INNER], lo[INNER]
    nbs = ((hi[:-2, 1:-1, 1:-1], lo[:-2, 1:-1, 1:-1], q["xm"]),
           (hi[2:, 1:-1, 1:-1], lo[2:, 1:-1, 1:-1], q["xp"]),
           (hi[1:-1, :-2, 1:-1], lo[1:-1, :-2, 1:-1], q["ym"]),
           (hi[1:-1, 2:, 1:-1], lo[1:-1, 2:, 1:-1], q["yp"]),
           (hi[1:-1, 1:-1, :-2], lo[1:-1, 1:-1, :-2], q["zm"]),
           (hi[1:-1, 1:-1, 2:], lo[1:-1, 1:-1, 2:], q["zp"]))
    pairs = []
    for nb_hi, nb_lo, quad in nbs:
        dh, dl = ds.two_sum(nb_hi, -hic)
        dl = dl + (nb_lo - loc)
        pairs.append(ds.weighted_term(dh, dl, quad))
    pairs.append((-rhs_hi, -rhs_lo))
    s, c = ds.accumulate(pairs)
    r = s + c
    return r, torch.max(torch.abs(r))


pair_residual_plain.calls = 0


def _check_k13(name: str, words, rhs_hi, rhs_lo, r,
               op: PoissonOperator) -> None:
    """K13's operand checks: the pressure words of one contiguous float32
    (nx, ny, nz) shape, the rhs pair interior-shaped with contiguous z
    rows (any x and y strides: a view of a whole-grid field's interior
    will do), r contiguous (None for no r), the quad rows on the device,
    a grid of at least 3 cells an axis and fewer than 2^31 cells."""
    shape, dev = tuple(words[0].shape), words[0].device
    if len(shape) != 3 or min(shape) < 3 or int(np.prod(shape)) >= 2 ** 31:
        raise ValueError(f"{name}: grid {shape}, expected 3 to 2^31 cells")
    for i, w in enumerate(words):
        _build.require(("hi", "lo")[i], w, shape, torch.float32, dev)
    inner = tuple(n - 2 for n in shape)
    for fname, t in (("rhs_hi", rhs_hi), ("rhs_lo", rhs_lo)):
        if (t.device != dev or t.dtype != torch.float32
                or tuple(t.shape) != inner or t.stride(2) != 1):
            raise ValueError(f"{name}: {fname} must be float32 {inner} on "
                             f"{dev} with contiguous z rows, got "
                             f"{t.dtype} {tuple(t.shape)} stride "
                             f"{t.stride()} on {t.device}")
    if r is not None:
        _build.require("r", r, shape if len(words) == 1 else inner,
                       torch.float32, dev)
    for a, n in zip("xyz", shape):
        _build.require(f"quad_rows[{a!r}]", op.quad_rows[a], (n - 2, 8),
                       torch.float32, dev)


def _launch_k13(name: str, words, rhs_hi, rhs_lo, r,
                op: PoissonOperator) -> torch.Tensor:
    """One K13 launch over len(words) pressure words; returns max |r| (a
    0-dim tensor on the device)."""
    _check_k13(name, words, rhs_hi, rhs_lo, r, op)
    hi = words[0]
    # the max word: zeroed by a stream-ordered memset in the C entry
    err = torch.empty((1,), dtype=torch.int32, device=hi.device)
    nx, ny, nz = hi.shape
    qr = op.quad_rows
    rc = _build.load().ns3d_comp_residual(
        len(words), hi.data_ptr(), _build.ptr(words[1] if len(words) == 2
                                               else None),
        rhs_hi.data_ptr(), rhs_lo.data_ptr(), rhs_hi.stride(0),
        rhs_hi.stride(1), rhs_lo.stride(0), rhs_lo.stride(1), _build.ptr(r),
        qr["x"].data_ptr(), qr["y"].data_ptr(), qr["z"].data_ptr(), nx, ny,
        nz, err.data_ptr(), _build.stream_of(hi))
    _build.check(rc, name)
    return err.view(torch.float32)[0]


def compensated_residual(p, rhs_hi, rhs_lo, op: PoissonOperator):
    """Compensated folded residual of a single field p against an (hi, lo)
    RHS pair (whole-grid fields), in the Pallas path's term order (x+, x-,
    y+, y-, z+, z-, then -rhs): two_sum neighbor differences, Dekker
    products against f64-split weights, compensated accumulation — error
    ~eps*|resid| instead of eps*|rhs|. Returns (r, max|r|) with r
    full-shape and zero on the boundary ring (the defect-correction RHS is
    -r), max|r| a 0-dim tensor on p's device. CUDA tensors launch K13 (or
    raise); CPU tensors run the plain version."""
    if not _build.on_cuda(p, "compensated_residual"):
        return compensated_residual_plain(p, rhs_hi, rhs_lo, op)
    for fname, t in (("rhs_hi", rhs_hi), ("rhs_lo", rhs_lo)):
        _build.require(fname, t, p.shape, torch.float32, p.device)
    r = torch.empty_like(p)
    emax = _launch_k13("compensated_residual", (p,), rhs_hi[INNER],
                       rhs_lo[INNER], r, op)
    compensated_residual.launches += 1
    return r, emax


compensated_residual.launches = 0


def pair_residual(hi, lo, rhs_hi, rhs_lo, op: PoissonOperator):
    """Compensated folded residual of a (hi, lo) pressure pair (whole-grid
    fields) against a (hi, lo) RHS pair (interior-shaped; views of a
    whole-grid field's interior do), the JAX package's _comp_residual_fn
    (models/chorin.py:909, term order x-, x+, y-, y+, z-, z+, the lo
    words' differences folded into each term). Returns (r, max|r|) with r
    interior-shaped and max|r| a 0-dim tensor on hi's device. CUDA tensors
    launch K13 (or raise); CPU tensors run the plain version."""
    if not _build.on_cuda(hi, "pair_residual"):
        return pair_residual_plain(hi, lo, rhs_hi, rhs_lo, op)
    r = torch.empty(tuple(n - 2 for n in hi.shape), dtype=hi.dtype,
                    device=hi.device)
    emax = _launch_k13("pair_residual", (hi, lo), rhs_hi, rhs_lo, r, op)
    pair_residual.launches += 1
    return r, emax


pair_residual.launches = 0


def pair_residual_max(hi, lo, rhs_hi, rhs_lo, op: PoissonOperator):
    """pair_residual's max|r| alone (a 0-dim tensor), for callers that
    read no r: the launch writes no r (counted in pair_residual.launches;
    CPU tensors run pair_residual_plain)."""
    if not _build.on_cuda(hi, "pair_residual_max"):
        return pair_residual_plain(hi, lo, rhs_hi, rhs_lo, op)[1]
    emax = _launch_k13("pair_residual_max", (hi, lo), rhs_hi, rhs_lo, None,
                       op)
    pair_residual.launches += 1
    return emax
