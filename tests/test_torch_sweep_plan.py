"""K8's launch plan (kernels/poisson.py `sweep_plan`) and the solver's
state-device check, on the CPU.

The plan cuts a grid into the (y, z) tiles and x segments that K8's blocks
stream (csrc/poisson.cu, the K8 section). It is plain Python, so these
tests hold here what the kernel relies on: every cell belongs to exactly
one (tile, segment) in the kernel's block order, no tile or segment is
empty, the region fits a block (its cells in 512 threads x 4, its shared
memory within Hopper's 227 KB), and the wide grid runs in one wave of 132 SMs.
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
    assert plan.ry * plan.w <= kp.SWEEP_THREADS * kp.SWEEP_COLS
    assert plan.smem_bytes <= kp.SMEM_LIMIT == 227 * 1024


def test_plan_wide_grid_is_one_wave():
    """At 511x307x307 every block runs at once on 132 SMs, at the depths
    the wide path launches (s = 3 bodies, the s = 2 pre-run), each in a
    region whose own tile is at least 70% of it."""
    for s in (2, 3):
        plan = kp.sweep_plan((511, 307, 307), s, 132)
        assert 120 <= plan.blocks <= 132
        assert plan.uy * plan.uz / (plan.ry * plan.w) >= 0.7
        assert plan.segs == 2 and plan.seg == 256


def test_plan_smem_matches_the_kernel_formula():
    """SweepGeom::smem in csrc/poisson.cu: three fields per slot of the
    three-slot ring, two planes per level 1..s-1, 32 words of reduction
    scratch, a plane being the region's ry x w floats."""
    plan = kp.SweepPlan(3, 28, 52, 11, 6, 256, 2)
    assert (plan.ry, plan.w) == (34, 58)
    assert plan.smem_bytes == 4 * 34 * 58 * (3 * 3 + 4) + 128


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
