"""K10's launch plan (`resident_plan`): which of its two forms a grid gets,
and where it gets none.

  * the cluster form (the whole state in one cluster's shared memory)
    cuts x into balanced slabs that cover every plane once;
  * the grid form (dpr in shared memory, x-streamed columns) cuts the
    (y, z) column plane into one rectangle a block (`grid_cut`): z into
    rows of a warp's 32 lanes (the last the remainder), y into balanced
    parts, as many as the SMs leave; every column in exactly one region,
    the y parts within one row of each other, no more blocks than SMs and
    no fewer y parts than fit;
  * 63x38x38 picks the cluster form, 255x153x153 the grid form (dpr in
    shared memory), 511x307x307 neither, on an H100's 132 SMs with
    clusters of 16 (and of 8);
  * one cell past each limit changes the answer;
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

from navierstokes3d_tpu.kernels.poisson import (PoissonBCSpec,
                                                build_poisson_iter)
from navierstokes3d_tpu_torch.kernels import poisson as kp

torch.set_num_threads(2)
SMS, CLUSTER = kp.H100_SMS, kp.H100_MAX_CLUSTER
ROOM = kp.SMEM_LIMIT - kp.RESIDENT_STATIC_SMEM
PRESETS = {(63, 38, 38): "cluster", (255, 153, 153): "grid",
           (511, 307, 307): None}


def _form(shape, sms=SMS, max_cluster=CLUSTER):
    plan = kp.resident_plan(shape, sms, max_cluster)
    return None if plan is None else plan.form


@pytest.mark.parametrize("blocks", kp.RESIDENT_CLUSTERS)
@pytest.mark.parametrize("nx", [1, 5, 8, 15, 16, 17, 37, 63, 160])
def test_cluster_slabs_cover_every_plane_once(blocks, nx):
    parts = [kp.balanced_part(nx, blocks, b) for b in range(blocks)]
    planes = [x for start, size in parts for x in range(start, start + size)]
    assert planes == list(range(nx))
    sizes = [size for _, size in parts]
    assert max(sizes) - min(sizes) <= 1
    assert max(sizes) == -(-nx // blocks)


@pytest.mark.parametrize("shape,form", list(PRESETS.items()))
def test_presets_pick_their_forms(shape, form):
    plan = kp.resident_plan(shape, SMS, CLUSTER)
    assert (None if plan is None else plan.form) == form
    if shape == (63, 38, 38):
        assert plan == kp.ResidentPlan("cluster", 16, 4,
                                       kp.cluster_smem(4, 38, 38))
        # 8 planes in each block of a cluster of 8
        assert kp.resident_plan(shape, SMS, 8) == kp.ResidentPlan(
            "cluster", 8, 8, kp.cluster_smem(8, 38, 38))
        assert kp.cluster_smem(8, 38, 38) == 16 * 10 * 38 * 38
        # a card without clusters takes the grid form
        assert _form(shape, SMS, 0) == "grid"
    if shape == (255, 153, 153):
        # 153 x 153 columns cut 26 x 5: regions of 5-6 y by 32 z (25 in
        # the last z row), at most 6 x 32 = 192 slots, their dpr through
        # 255 planes 195,840 B
        assert plan == kp.ResidentPlan("grid", 130, 192, 195840, (26, 5))
        assert kp.grid_smem(192, 255) == 195840


@pytest.mark.parametrize("shape", [(63, 38, 38), (255, 153, 153),
                                   (160, 38, 38), (12, 9, 33),
                                   (298, 153, 153)])
def test_plans_fit_a_block_and_cover_the_grid(shape):
    for max_cluster in (0, 8, 16):
        plan = kp.resident_plan(shape, SMS, max_cluster)
        assert kp.RESIDENT_SOLO_SMEM <= plan.smem_bytes <= ROOM
        nx, ny, nz = shape
        if plan.form == "cluster":
            assert plan.blocks in kp.RESIDENT_CLUSTERS
            assert plan.blocks <= max_cluster
            assert plan.per_block * plan.blocks >= nx
            assert kp.cluster_smem(plan.per_block, ny, nz) <= plan.smem_bytes
        else:
            gy, gz = plan.cut
            assert plan.blocks == gy * gz <= SMS
            assert gz == -(-nz // kp.RESIDENT_LANES)
            assert plan.per_block == -(-ny // gy) * kp.RESIDENT_LANES
            assert plan.per_block <= kp.RESIDENT_THREADS
            assert plan.per_block * plan.blocks >= ny * nz
            assert kp.grid_smem(plan.per_block, nx) <= plan.smem_bytes


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


def _last(shape, axis, form, max_cluster=CLUSTER):
    """The largest extent along `axis` (from shape's) with `form`."""
    s = list(shape)
    while _form(tuple(s[:axis] + [s[axis] + 1] + s[axis + 1:]),
                SMS, max_cluster) == form:
        s[axis] += 1
    return tuple(s)


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("max_cluster", [8, 16])
def test_one_cell_past_the_cluster_limit(axis, max_cluster):
    at = _last((20, 20, 20), axis, "cluster", max_cluster)
    past = tuple(n + (i == axis) for i, n in enumerate(at))
    assert _form(at, SMS, max_cluster) == "cluster"
    assert _form(past, SMS, max_cluster) == "grid"
    plan = kp.resident_plan(at, SMS, max_cluster)
    assert kp.cluster_smem(plan.per_block, at[1], at[2]) <= ROOM
    assert kp.cluster_smem(plan.per_block + 1, at[1], at[2]) > ROOM or (
        axis != 0)
    if axis == 0 and max_cluster == 16:
        # pr twice with ghosts, dpr, rhs and the column weights: 16
        # (planes + 2) B per (y, z) column
        assert at == (16 * (ROOM // (16 * 400) - 2), 20, 20)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_one_cell_past_the_grid_limit(axis):
    start = (255, 153, 153)
    at = _last(start, axis, "grid")
    past = tuple(n + (i == axis) for i, n in enumerate(at))
    assert _form(at) == "grid" and _form(past) is None
    if axis == 0:
        # 192 column slots of dpr a block through every plane: 302 planes
        assert at[0] == ROOM // (4 * 192) == 302
    # the largest region through every plane fits the room, one more
    # cell's plane does not
    plan = kp.resident_plan(at, SMS, CLUSTER)
    assert kp.grid_smem(plan.per_block, at[0]) <= ROOM


def test_plan_refuses_empty_or_huge_grids():
    for shape in ((0, 5, 5), (5, 0, 5), (1291, 1291, 1291)):
        with pytest.raises(ValueError, match="resident_plan"):
            kp.resident_plan(shape, SMS, CLUSTER)
    with pytest.raises(ValueError, match="resident_plan"):
        kp.resident_plan((63, 38, 38), 0, CLUSTER)


@pytest.mark.parametrize("shape", list(PRESETS) + [(303, 153, 153),
                                                   (20, 6, 6)])
def test_make_resident_none_where_the_plan_has_no_form(shape):
    res = kp.make_resident(3, shape)
    assert (res is None) == (kp.resident_plan(shape, SMS, CLUSTER) is None)
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
    assert jax_none == (PRESETS.get(shape, "cluster") is None)
