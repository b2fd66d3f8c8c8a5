"""Host-side pieces of K3 (predict) and K5 (advect) that the CPU can hold:
K3's launch plan, and the identity K5's kernel computes its interpolation
fraction by, t = (dl > 0) - (dl - trunc(dl)) for the plain version's
(dl > 0) - fmod(dl, 1)."""

import numpy as np
import pytest
import torch

from navierstokes3d_tpu_torch.kernels import fused_step as kf
from navierstokes3d_tpu_torch.kernels.poisson import SMEM_LIMIT

torch.set_num_threads(2)

SHAPES = [(3, 3, 3), (3, 14, 30), (5, 13, 29), (9, 28, 60), (17, 17, 17),
          (40, 27, 59), (63, 38, 38), (255, 153, 153), (511, 307, 307)]


def _covered(plan, shape):
    """How many blocks of `plan` own each point of the union grid, as the
    kernel assigns them (csrc/fused_step.cu predict_kernel)."""
    nx, ny, nz = shape
    count = np.zeros((nx + 1, ny + 1, nz + 1), dtype=np.int32)
    for bz in range(plan.segs):
        xs = bz * plan.seg
        xe = min(xs + plan.seg, nx + 1)
        for by in range(plan.tiles_y):
            y0 = by * kf.PREDICT_TILE_Y
            for bx in range(plan.tiles_z):
                z0 = bx * kf.PREDICT_TILE_Z
                count[xs:xe, y0:y0 + kf.PREDICT_TILE_Y,
                      z0:z0 + kf.PREDICT_TILE_Z] += 1
    return count


@pytest.mark.parametrize("sms", [1, 8, 132])
@pytest.mark.parametrize("shape", SHAPES[:-2],
                         ids=lambda t: "x".join(map(str, t)))
def test_predict_plan_covers_every_point_once(shape, sms):
    plan = kf.predict_plan(shape, sms)
    assert (_covered(plan, shape) == 1).all()
    # no empty tile or segment
    nx, ny, nz = shape
    assert (plan.tiles_y - 1) * kf.PREDICT_TILE_Y < ny + 1
    assert (plan.tiles_z - 1) * kf.PREDICT_TILE_Z < nz + 1
    assert (plan.segs - 1) * plan.seg < nx + 1


@pytest.mark.parametrize("shape", SHAPES[-2:],
                         ids=lambda t: "x".join(map(str, t)))
def test_predict_plan_main_grids_are_one_wave(shape):
    """At 255 and 511 on the H100's 132 SMs the plan is one wave of two
    blocks per SM, and covers the union grid exactly (by extents: the
    count array would be large)."""
    plan = kf.predict_plan(shape, 132)
    nx, ny, nz = shape
    assert plan.blocks <= kf.PREDICT_BLOCKS_PER_SM * 132
    assert plan.tiles_y == -(-(ny + 1) // kf.PREDICT_TILE_Y)
    assert plan.tiles_z == -(-(nz + 1) // kf.PREDICT_TILE_Z)
    assert plan.seg * plan.segs >= nx + 1 > plan.seg * (plan.segs - 1)
    expected = {255: (11, 6, 64, 4), 511: (22, 11, 512, 1)}[nx]
    assert (plan.tiles_y, plan.tiles_z, plan.seg, plan.segs) == expected


def test_predict_shared_memory_fits_two_blocks():
    """PredictSmem: 3 ring stages of three 17 x 33 planes, fourteen 16 x 32
    planes (seven double buffers); two blocks per SM within the card's 227
    KB per block and the 48 KB a static allocation may take."""
    assert kf.PREDICT_SMEM_BYTES == 4 * (9 * 17 * 33 + 14 * 16 * 32)
    assert kf.PREDICT_SMEM_BYTES <= 48 * 1024
    assert kf.PREDICT_BLOCKS_PER_SM * kf.PREDICT_SMEM_BYTES <= SMEM_LIMIT


def test_predict_plan_refuses_empty_shapes():
    with pytest.raises(ValueError):
        kf.predict_plan((0, 5, 5), 132)
    with pytest.raises(ValueError):
        kf.predict_plan((5, 5, 5), 0)


def _edge_values(k):
    """+-0, the integers of [-4, 4], their float32 neighbours, those of
    +-k, and NaN."""
    vals = [0.0, -0.0, float("nan")]
    for i in list(range(-4, 5)) + [k, -k]:
        x = np.float32(i)
        vals += [x, np.nextafter(x, np.float32(np.inf)),
                 np.nextafter(x, np.float32(-np.inf))]
    return np.array(vals, dtype=np.float32)


def _dense_sample(stride):
    """Every `stride`-th float32 bit pattern of [0, 4], and its negation."""
    top = np.array([4.0], dtype=np.float32).view(np.int32)[0]
    pos = np.arange(0, top + 1, stride, dtype=np.int32).view(np.float32)
    return np.concatenate([pos, -pos])


@pytest.mark.parametrize("k", [2, 3, 4])
def test_trunc_fraction_equals_fmod_fraction(k):
    """t = (dl > 0) - fmod(dl, 1) (ops/advect.py) and (dl > 0) - (dl -
    trunc(dl)) (csrc/advect.cu) agree bit for bit on every clipped
    displacement in [-k, k]: the two remainders differ only in the sign
    of a zero, which t's subtraction from 0 or 1 maps to the same value."""
    dl = torch.from_numpy(np.concatenate([_edge_values(k),
                                          _dense_sample(97)]))
    dl = torch.clamp(dl, -k, k)   # the kernel's clip (NaN stays NaN)
    pos = (dl > 0).to(torch.float32)
    t_fmod = pos - torch.fmod(dl, 1.0)
    t_trunc = pos - (dl - torch.trunc(dl))
    assert dl.numel() > 2 * 10 ** 7
    nan = torch.isnan(t_fmod)
    assert torch.equal(nan, torch.isnan(t_trunc)) and int(nan.sum()) == 1
    assert torch.equal(t_fmod[~nan].view(torch.int32),
                       t_trunc[~nan].view(torch.int32))
