"""K10's launch plan (`resident_plan`): the plan a grid gets, and where
it gets none.

  * `balanced_part` cuts n into parts whose sizes differ by at most one
    and that cover every index once;
  * K10 (dpr in shared memory, x-streamed columns) cuts the (y, z) column
    plane into one rectangle a block (`grid_cut`): z into rows of a
    warp's 32 lanes (the last the remainder), y into balanced parts, as
    many as the SMs leave; every column in exactly one region, the y
    parts within one row of each other, no more blocks than SMs and no
    fewer y parts than fit;
  * 63x38x38 and 255x153x153 get a plan, 511x307x307 none, on an H100's
    132 SMs, and so does every grid of the presets from 7 to 75;
  * one cell past the limit changes the answer;
  * `make_resident` returns None exactly where the plan does, and at the
    presets' grids where the JAX package's `make_resident` does (above
    its VMEM budget), which it decides without running a kernel. The two
    budgets differ between the presets' grids (the JAX one is 110 MB of
    VMEM, the port's a block's shared memory), so the packages are held
    to the same answer only at those grids."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import navierstokes3d_tpu_torch as nt
from navierstokes3d_tpu.kernels.poisson import (PoissonBCSpec,
                                                build_poisson_iter)
from navierstokes3d_tpu_torch.grid import make_grid
from navierstokes3d_tpu_torch.kernels import poisson as kp

torch.set_num_threads(2)
SMS = kp.H100_SMS
ROOM = kp.SMEM_LIMIT - kp.RESIDENT_STATIC_SMEM
# the presets' grids: whether K10 has a plan there
PRESETS = {(63, 38, 38): True, (255, 153, 153): True,
           (511, 307, 307): False}


def _has_plan(shape):
    return kp.resident_plan(shape, SMS) is not None


@pytest.mark.parametrize("parts", [16, 8])
@pytest.mark.parametrize("n", [1, 5, 8, 15, 16, 17, 37, 63, 160])
def test_balanced_parts_cover_every_index_once(parts, n):
    cut = [kp.balanced_part(n, parts, b) for b in range(parts)]
    indices = [x for start, size in cut for x in range(start, start + size)]
    assert indices == list(range(n))
    sizes = [size for _, size in cut]
    assert max(sizes) - min(sizes) <= 1
    assert max(sizes) == -(-n // parts)


@pytest.mark.parametrize("shape,has", list(PRESETS.items()))
def test_presets_pick_their_forms(shape, has):
    plan = kp.resident_plan(shape, SMS)
    assert (plan is not None) == has
    if shape == (63, 38, 38):
        # 38 x 38 columns cut 38 x 2: one y row of 32 z (6 in the last z
        # row) a block, their dpr through 63 planes under the floor that
        # keeps a block alone on its SM
        assert plan == kp.ResidentPlan(76, 32, kp.RESIDENT_SOLO_SMEM,
                                       (38, 2))
        assert kp.grid_smem(32, 63) < kp.RESIDENT_SOLO_SMEM
    if shape == (255, 153, 153):
        # 153 x 153 columns cut 26 x 5: regions of 5-6 y by 32 z (25 in
        # the last z row), at most 6 x 32 = 192 slots, their dpr through
        # 255 planes 195,840 B
        assert plan == kp.ResidentPlan(130, 192, 195840, (26, 5))
        assert kp.grid_smem(192, 255) == 195840


def _fits_a_block_and_covers_the_grid(shape, plan):
    assert kp.RESIDENT_SOLO_SMEM <= plan.smem_bytes <= ROOM
    nx, ny, nz = shape
    gy, gz = plan.cut
    assert plan.blocks == gy * gz <= SMS
    assert gz == -(-nz // kp.RESIDENT_LANES)
    assert plan.per_block == -(-ny // gy) * kp.RESIDENT_LANES
    assert plan.per_block <= kp.RESIDENT_THREADS
    assert plan.per_block * plan.blocks >= ny * nz
    assert kp.grid_smem(plan.per_block, nx) <= plan.smem_bytes


@pytest.mark.parametrize("shape", [(63, 38, 38), (255, 153, 153),
                                   (160, 38, 38), (12, 9, 33),
                                   (298, 153, 153)])
def test_plans_fit_a_block_and_cover_the_grid(shape):
    _fits_a_block_and_covers_the_grid(shape, kp.resident_plan(shape, SMS))


@pytest.mark.parametrize("preset", ["gpu", "multi"])
@pytest.mark.parametrize("nx", [7, 15, 31, 63, 75])
def test_small_preset_grids_have_a_plan(preset, nx):
    """The presets' grids from 7 to 75 (where K10 once kept the whole
    state in one thread block cluster) get a plan that fits a block, has
    at most one block per SM and covers every column."""
    make = nt.preset_gpu if preset == "gpu" else nt.preset_multi
    shape = make_grid(make(nx=nx, compat=False, dtype="float32")).shape_c
    plan = kp.resident_plan(shape, SMS)
    assert plan is not None
    _fits_a_block_and_covers_the_grid(shape, plan)


CUTS = [(153, 153, 132), (38, 38, 132), (9, 33, 132), (307, 307, 132),
        (17, 65, 7), (25, 70, 4), (3, 3, 1), (5, 200, 16), (200, 5, 16),
        (153, 153, 114), (1, 1, 132), (40, 3, 9), (7, 300, 4), (4, 64, 2)]


@pytest.mark.parametrize("ny,nz,sms", CUTS)
def test_grid_cut_covers_every_column_once(ny, nz, sms):
    gy, gz = kp.grid_cut(ny, nz, sms)
    lanes = kp.RESIDENT_LANES
    assert gz == -(-nz // lanes)
    if gz > sms:
        # more z rows than SMs: no cut
        assert gy == 0
        return
    assert 1 <= gy <= ny and gy * gz <= sms
    # the most y parts the SMs leave, at most one a row
    assert gy == ny or (gy + 1) * gz > sms
    owner = np.full((ny, nz), -1)
    for b in range(gy * gz):
        y0, uy = kp.balanced_part(ny, gy, b // gz)
        z0 = b % gz * lanes
        uz = min(lanes, nz - z0)
        assert uy >= 1 and uz >= 1
        assert (owner[y0:y0 + uy, z0:z0 + uz] == -1).all()
        owner[y0:y0 + uy, z0:z0 + uz] = b
    assert (owner >= 0).all()
    # y parts within one row of each other; z rows of 32 lanes but the
    # last
    rows = [kp.balanced_part(ny, gy, i)[1] for i in range(gy)]
    assert max(rows) - min(rows) <= 1
    assert all(min(lanes, nz - z0) == lanes for z0 in range(0, nz - lanes,
                                                             lanes))


def test_grid_cut_refuses_empty_planes():
    for args in ((0, 5, 132), (5, 0, 132), (5, 5, 0)):
        with pytest.raises(ValueError, match="grid_cut"):
            kp.grid_cut(*args)


def _last(shape, axis):
    """The largest extent along `axis` (from shape's) with a plan."""
    s = list(shape)
    while _has_plan(tuple(s[:axis] + [s[axis] + 1] + s[axis + 1:])):
        s[axis] += 1
    return tuple(s)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_one_cell_past_the_grid_limit(axis):
    start = (255, 153, 153)
    at = _last(start, axis)
    past = tuple(n + (i == axis) for i, n in enumerate(at))
    assert _has_plan(at) and not _has_plan(past)
    if axis == 0:
        # 192 column slots of dpr a block through every plane: 302 planes
        assert at[0] == ROOM // (4 * 192) == 302
    # the largest region through every plane fits the room, one more
    # cell's plane does not
    plan = kp.resident_plan(at, SMS)
    assert kp.grid_smem(plan.per_block, at[0]) <= ROOM


def test_plan_refuses_empty_or_huge_grids():
    for shape in ((0, 5, 5), (5, 0, 5), (1291, 1291, 1291)):
        with pytest.raises(ValueError, match="resident_plan"):
            kp.resident_plan(shape, SMS)
    with pytest.raises(ValueError, match="resident_plan"):
        kp.resident_plan((63, 38, 38), 0)


@pytest.mark.parametrize("shape", list(PRESETS) + [(303, 153, 153),
                                                   (20, 6, 6)])
def test_make_resident_none_where_the_plan_has_no_form(shape):
    res = kp.make_resident(3, shape)
    assert (res is None) == (not _has_plan(shape))
    assert (res is None) == (shape in ((511, 307, 307), (303, 153, 153)))
    # without a shape it decides at the call (the CPU runs the plain
    # version of any grid)
    assert callable(kp.make_resident(3))


@pytest.mark.parametrize("shape", list(PRESETS) + [(20, 6, 6)])
def test_make_resident_none_as_the_jax_package(shape):
    nx, ny, nz = shape
    it, _, _ = build_poisson_iter(
        nx, ny, nz, 0.1, 0.1, 0.1, dtau=0.01, damp=0.9,
        bc=PoissonBCSpec(False, None, np.zeros(ny * nz)),
        dtype=jnp.float32, interpret=True, mode="blocked", folded=True)
    jax_none = it.make_resident(37) is None
    assert (kp.make_resident(37, shape) is None) == jax_none
    assert jax_none == (not PRESETS.get(shape, True))
