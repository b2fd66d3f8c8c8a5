"""K7-dist's and K2-dist's tiling (kernels/poisson.py `dist_plan`), on the
CPU.

The plan cuts each plane of one x-shard of the distributed Poisson solve
into the (y, z) tiles the kernels' blocks stand on, one thread per cell
(csrc/poisson.cu, their section). It is plain Python, so these tests hold
here what the kernels rely on: the blocks, decoded as the kernel decodes
its block index, cover every cell of the shard exactly once; every tile
fits a block and holds at least two rows and lanes, so a ring cell's
clamped source (its y and z one cell inward) lies in its own tile, and
under zero_grad_x a global x face's source plane lies in the same shard;
the shard of the 255 grid over three fills more than one wave of the
card.
"""

import numpy as np
import pytest

from navierstokes3d_tpu_torch.kernels import poisson as kp

# shard shapes (bx, ny, nz): the 255 grid over 3 (85) and the whole grid,
# the 511 grid's shards, ragged ones, ny and nz one past a tile multiple
# (9, 17, 33, 65) and one short of one (15, 31), and two-plane shards
SHAPES = [(85, 153, 153), (255, 153, 153), (170, 307, 307), (2, 153, 153),
          (2, 11, 37), (3, 3, 3), (4, 9, 33), (13, 17, 65), (40, 24, 37),
          (7, 15, 31), (9, 200, 5), (5, 4, 300)]
# the card's resident blocks of 256 threads: 2048 threads on each of its
# 132 SMs
WAVE = 132 * 2048 // (kp.DIST_LANES * kp.DIST_ROWS)


def _blocks(plan, shape):
    """Each block's owned cells (x, y0, y1, z0, z1), decoded as the kernel
    decodes (blockIdx.x, blockIdx.y, blockIdx.z) = (z part, y part,
    plane)."""
    bx, ny, nz = shape
    out = []
    for x in range(bx):
        for ty in range(plan.tiles_y):
            for tz in range(plan.tiles_z):
                (y0, uy), (z0, uz) = (kp.balanced_part(ny, plan.tiles_y, ty),
                                      kp.balanced_part(nz, plan.tiles_z, tz))
                out.append((x, y0, y0 + uy, z0, z0 + uz))
    return out


@pytest.mark.parametrize("shape", SHAPES, ids=lambda t: "x".join(map(str, t)))
def test_plan_covers_each_shard_once(shape):
    plan = kp.dist_plan(shape)
    count = np.zeros(shape, np.int32)
    for x, y0, y1, z0, z1 in _blocks(plan, shape):
        assert y0 < y1 and z0 < z1, "an empty tile"
        count[x, y0:y1, z0:z1] += 1
    assert (count == 1).all()


@pytest.mark.parametrize("shape", SHAPES, ids=lambda t: "x".join(map(str, t)))
def test_tiles_fit_a_block_and_hold_two(shape):
    """Every tile fits the block (at most 8 rows of 32 lanes) and holds at
    least two rows and lanes: the conditions the kernel's launcher checks
    before it launches."""
    bx, ny, nz = shape
    plan = kp.dist_plan(shape)
    assert plan.tiles_y <= ny // 2 and plan.tiles_z <= nz // 2
    assert -(-ny // plan.tiles_y) <= kp.DIST_ROWS
    assert -(-nz // plan.tiles_z) <= kp.DIST_LANES
    for _, y0, y1, z0, z1 in _blocks(plan, shape):
        assert min(y1 - y0, z1 - z0) >= 2
    # the fewest tiles of that size
    assert plan.tiles_y == -(-ny // kp.DIST_ROWS)
    assert plan.tiles_z == -(-nz // kp.DIST_LANES)


@pytest.mark.parametrize("nshards", [1, 2, 3, 4, 6])
@pytest.mark.parametrize("zero_grad_x", [False, True], ids=["gpu", "multi"])
def test_ring_sources_in_their_own_tile(zero_grad_x, nshards):
    """Over every shard of a grid split along x: each ring cell's clamped
    source lies in the tile of the block that writes the ring cell (read
    from its shared tile), on the same plane or, for a global x face
    under zero_grad_x, on the shard's plane next to it (the plane that
    block computes instead of its own)."""
    for nx, ny, nz in ((12, 11, 37), (255, 153, 153), (24, 17, 33)):
        bx = nx // nshards
        for s in range(nshards):
            x_off = s * bx
            shape = (bx if s < nshards - 1 else nx - x_off, ny, nz)
            plan = kp.dist_plan(shape)
            for x, y0, y1, z0, z1 in _blocks(plan, shape):
                gx = x_off + x
                cgx = min(max(gx, 1), nx - 2) if zero_grad_x else gx
                assert 0 <= cgx - x_off < shape[0]
                for y in range(y0, y1):
                    for z in (z0, z1 - 1):
                        if 1 <= gx <= nx - 2 and 1 <= y <= ny - 2 \
                                and 1 <= z <= nz - 2:
                            continue
                        sy, sz = min(max(y, 1), ny - 2), min(max(z, 1), nz - 2)
                        assert y0 <= sy < y1 and z0 <= sz < z1


def test_plan_at_the_dist_shard():
    """The middle shard of the 255 grid over three (85x153x153): 20 x 5
    tiles of each of its 85 planes, 8500 blocks, more than one wave of the
    card's resident blocks; the whole grid three times that."""
    plan = kp.dist_plan((85, 153, 153))
    assert (plan.tiles_y, plan.tiles_z) == (20, 5)
    assert 85 * plan.tiles_y * plan.tiles_z == 8500 > WAVE
    whole = kp.dist_plan((255, 153, 153))
    assert (whole.tiles_y, whole.tiles_z) == (20, 5)


def test_balanced_part():
    for n in range(1, 60):
        for parts in range(1, n + 1):
            cuts = [kp.balanced_part(n, parts, i) for i in range(parts)]
            assert cuts[0][0] == 0
            assert all(a + s == b for (a, s), (b, _) in zip(cuts, cuts[1:]))
            assert sum(s for _, s in cuts) == n
            assert max(s for _, s in cuts) - min(s for _, s in cuts) <= 1


@pytest.mark.parametrize("shape", [(1, 153, 153), (85, 2, 153),
                                   (85, 153, 2), (0, 3, 3)])
def test_plan_refuses(shape):
    with pytest.raises(ValueError, match="dist_plan"):
        kp.dist_plan(shape)
