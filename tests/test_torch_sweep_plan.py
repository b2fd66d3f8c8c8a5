"""K8's launch plan (kernels/poisson.py `sweep_plan`) and the solver's
state-device check, on the CPU.

The plan cuts a grid into the (y, z) tiles and x segments that K8's blocks
stream (csrc/poisson.cu, the K8 section). It is plain Python, so these
tests hold here what the kernel relies on: every cell belongs to exactly
one (tile, segment) in the kernel's block order, no tile or segment is
empty, the region fits a block (a thread a run of 4 z-consecutive cells of
a region row: rows x runs a row within 512 threads, the rows padded to
whole runs; its shared memory within Hopper's 227 KB), and the wide grid
runs in one wave of 132 SMs with nearly every thread owning a run.
"""

import dataclasses

import numpy as np
import pytest
import torch

import navierstokes3d_tpu_torch as nt
from navierstokes3d_tpu_torch.kernels import poisson as kp

torch.set_num_threads(2)

SHAPES = [(511, 307, 307), (255, 153, 153), (127, 77, 77), (64, 39, 39),
          (17, 11, 11), (7, 13, 11), (9, 9, 9), (5, 3, 3), (3, 40, 200),
          (40, 3, 300)]


def _blocks(plan, shape):
    """Each block's (x0, x1, y0, y1, z0, z1) of owned cells, decoded from
    its index as the kernel decodes blockIdx.x."""
    nx, ny, nz = shape
    out = []
    for b in range(plan.blocks):
        tz, rest = b % plan.tiles_z, b // plan.tiles_z
        ty, xs = rest % plan.tiles_y, rest // plan.tiles_y
        out.append((xs * plan.seg, min((xs + 1) * plan.seg, nx),
                    ty * plan.uy, min((ty + 1) * plan.uy, ny),
                    tz * plan.uz, min((tz + 1) * plan.uz, nz)))
    return out


@pytest.mark.parametrize("s", [2, 3, 4])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda t: "x".join(map(str, t)))
def test_plan_covers_every_cell_once(shape, s):
    plan = kp.sweep_plan(shape, s, 132)
    nx, ny, nz = shape
    blocks = _blocks(plan, shape)
    for x0, x1, y0, y1, z0, z1 in blocks:
        assert x0 < x1 and y0 < y1 and z0 < z1, "an empty tile or segment"
    # per axis: the cuts tile [0, n) without gaps or overlaps ...
    for cuts, n in ((sorted({b[:2] for b in blocks}), nx),
                    (sorted({b[2:4] for b in blocks}), ny),
                    (sorted({b[4:] for b in blocks}), nz)):
        assert cuts[0][0] == 0 and cuts[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(cuts, cuts[1:]))
    # ... and every (x, y, z) cut appears once
    assert len(set(blocks)) == len(blocks)
    if nx * ny * nz <= 2e6:
        count = np.zeros(shape, np.int32)
        for x0, x1, y0, y1, z0, z1 in blocks:
            count[x0:x1, y0:y1, z0:z1] += 1
        assert (count == 1).all()


@pytest.mark.parametrize("s", [2, 3, 4])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda t: "x".join(map(str, t)))
def test_plan_fits_a_block(shape, s):
    plan = kp.sweep_plan(shape, s, 132)
    assert plan.s == s
    assert plan.ry == plan.uy + 2 * s and plan.w == plan.uz + 2 * s
    assert kp.SWEEP_RUN == 4
    assert plan.runs == -(-plan.w // 4) and plan.wp == 4 * plan.runs
    assert plan.ry * plan.runs <= kp.SWEEP_THREADS == 512
    assert plan.smem_bytes <= kp.SMEM_LIMIT == 227 * 1024


@pytest.mark.parametrize("s", [2, 3, 4])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda t: "x".join(map(str, t)))
def test_plan_fit_rule(shape, s):
    """The fit rule: a thread a run, so a region of ry rows of w lanes
    takes ry * ceil(w / 4) threads, at most 512; its shared memory is the
    ring's 4 x 3 fields (two planes in flight, t and t - 1; pr, dpr, rhs)
    of 512 x 4 floats each, then 2 planes per level 1..s-1 and 4 for level
    s's pr and dpr on their way out, of ry rows padded to whole runs (wp
    floats), plus 32 words. The plan's rows are the most the rule allows
    for its lanes, unless the grid has fewer (then balanced over the tiles
    y needs)."""
    plan = kp.sweep_plan(shape, s, 132)
    runs = -(-(plan.uz + 2 * s) // 4)
    assert plan.runs == runs and plan.ry * runs <= 512
    assert kp.SWEEP_RING == 4
    assert plan.smem_bytes == (4 * (3 * 4 * 2048 + plan.ry * 4 * runs
                                    * (2 * (s - 1) + 4)) + 128)
    most = min(512 // runs - 2 * s, shape[1])
    assert plan.tiles_y == -(-shape[1] // most)
    assert plan.uy == -(-shape[1] // plan.tiles_y) <= most


def test_plan_wide_grid_is_one_wave():
    """At 511x307x307 every block runs at once on 132 SMs, at the depths
    the wide path launches (s = 3 bodies, the s = 2 pre-run), each in a
    region whose own tile is at least 70% of it."""
    for s in (2, 3):
        plan = kp.sweep_plan((511, 307, 307), s, 132)
        assert 120 <= plan.blocks <= 132
        assert plan.uy * plan.uz / (plan.ry * plan.w) >= 0.7
        assert plan.segs == 2 and plan.seg == 256


def test_plan_wide_grid_s3_keeps_its_tile_and_threads():
    """At 511x307x307, s = 3 (the wide path's bodies): the 28 x 52 tiles
    in 34 x 58 regions, 11 x 6 of them x 2 segments, one wave on 132 SMs;
    34 rows of 15 runs, so 510 of the 512 threads (at least 95%) own a
    run, in 34 x 60 floats of shared memory a plane."""
    plan = kp.sweep_plan((511, 307, 307), 3, 132)
    assert (plan.uy, plan.uz, plan.tiles_y, plan.tiles_z) == (28, 52, 11, 6)
    assert (plan.ry, plan.w, plan.runs, plan.wp) == (34, 58, 15, 60)
    assert plan.blocks == 132 and plan.segs == 2
    assert plan.ry * plan.runs == 510
    assert plan.ry * plan.runs >= 0.95 * kp.SWEEP_THREADS


def test_plan_smem_matches_the_kernel_formula():
    """SweepGeom::smem in csrc/poisson.cu: three fields of 512 x 4
    floats per slot of the four-slot ring, two planes per level 1..s-1,
    two per field of level s on its way out (pr, dpr), 32 words of
    reduction scratch, a plane being the region's ry rows padded to whole
    runs of 4 floats (58 lanes: 15 runs, 60 floats a row)."""
    plan = kp.SweepPlan(3, 28, 52, 11, 6, 256, 2)
    assert (plan.ry, plan.w, plan.wp) == (34, 58, 60)
    assert plan.smem_bytes == 4 * (3 * 4 * 2048 + 34 * 60 * (4 + 4)) + 128


def test_plan_refuses_depths_and_shapes():
    for s in (1, 5):
        with pytest.raises(ValueError, match="2 <= s"):
            kp.sweep_plan((20, 20, 20), s, 132)
    with pytest.raises(ValueError, match="shape"):
        kp.sweep_plan((0, 20, 20), 3, 132)
    # a long row is cut into z tiles that fit a block
    plan = kp.sweep_plan((20, 20, 5000), 2, 132)
    assert plan.tiles_z > 1 and plan.ry * plan.w <= 2048


@pytest.mark.parametrize("sms", [1, 8, 132])
def test_plan_more_sms_never_costs_more(sms):
    """A card with more SMs gets at least as many blocks (the plan fills
    the card it is given)."""
    small = kp.sweep_plan((64, 39, 39), 3, sms)
    big = kp.sweep_plan((64, 39, 39), 3, 2 * sms)
    assert big.blocks >= small.blocks


def test_state_defaults_are_the_card():
    """state_from_numpy and zeros_state place a state on the card unless
    asked for the CPU, as ChorinSolver does."""
    import inspect
    for fn in (nt.state_from_numpy, nt.zeros_state):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert (inspect.signature(nt.ChorinSolver).parameters["device"].default
            == "cuda")


@pytest.mark.parametrize("field", ["pr", "vx", "dprdtau"])
def test_step_refuses_a_state_on_another_device(field):
    solver = nt.ChorinSolver(nt.preset_gpu(nx=15, nt=1, compat=False,
                                           dtype="float32"), device="cpu")
    st = solver.init_state()
    moved = dataclasses.replace(st, **{field: getattr(st, field).to("meta")})
    with pytest.raises(ValueError, match=f"state.{field} lies on meta"):
        solver.step(moved)
    # the state on the solver's device steps
    st2, stats = solver.step(st)
    assert st2.pr.device.type == "cpu" and stats.iters > 0
