"""K5's plain version (select-shift advection, four branches) against the
JAX package: its common-layout Pallas kernel in interpret mode
(build_advect_flat, unflattened through its layout) and the jnp
`advect(method='selectshift', k=2)` run op by op. One case without and
one with clamped displacements (after tests/test_advect_pallas.py).

Against the eager jnp backend the values must be bitwise equal; against
the jitted kernel, to 4 ulp per element (or 1e-6 of max|field| where an
element is near zero — XLA may contract the accumulation per compilation,
docs/numerics.md "Cross-program rounding"). Clamp counts must be equal.

The gather method (compat mode's, with and without the reference's Vz
bug) is held bitwise against the JAX `advect(method='gather')` run op by
op, in float64 and float32 (after tests/test_kernels.py:105-118)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokes3d_tpu.kernels.advect import build_advect_flat
from navierstokes3d_tpu.ops.advect import advect as jadvect
from navierstokes3d_tpu_torch.kernels import advect as ka
from navierstokes3d_tpu_torch.kernels.fused_step import StepConsts
from navierstokes3d_tpu_torch.ops import advect as tadv

torch.set_num_threads(2)
DX, DY, DZ = 1.0, 1.1, 0.95


def _fields(nx, ny, nz, seed, scale):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.normal(size=(nx + 1, ny, nz)).astype(f) * scale,
            rng.normal(size=(nx, ny + 1, nz)).astype(f) * scale,
            rng.normal(size=(nx, ny, nz + 1)).astype(f) * scale,
            rng.uniform(size=(nx, ny, nz)).astype(f))


def _close(a, b):
    a, b = a.numpy(), np.asarray(b)
    ok = np.abs(a - b) <= np.maximum(
        4 * np.spacing(np.abs(b).astype(np.float32)),
        1e-6 * np.abs(b).max())
    assert ok.all(), np.abs(a - b).max()


@pytest.mark.parametrize("dims,dt,scale,clamps", [
    ((17, 9, 9), 0.9, 0.5, False),
    ((16, 8, 8), 1.0, 3.0, True),
])
def test_advect_plain_matches_jax(dims, dt, scale, clamps):
    nx, ny, nz = dims
    fields = _fields(nx, ny, nz, seed=0, scale=scale)
    jf = [jnp.asarray(a) for a in fields]
    tf = [torch.tensor(a) for a in fields]
    kern = build_advect_flat(nx, ny, nz, dt, DX, DY, DZ, k=2,
                             dtype=jnp.float32, interpret=True)
    want_k = jax.jit(kern.on3d)(*jf)
    want_e = jadvect(*jf, dt, DX, DY, DZ, compat=False, method="selectshift",
                     with_stats=True, k=2)
    consts = StepConsts(dt=dt, dx=DX, dy=DY, dz=DZ, mu=0.0, rho=1.0,
                        g_eff=0.0, variant="gpu", vin=1.0)
    got = ka.advect(*tf, consts, 2)
    for a, bk, be in zip(got[:4], want_k[:4], want_e[:4]):
        _close(a, bk)
        np.testing.assert_array_equal(a.numpy(), np.asarray(be))
    n = int(got[4].item())
    assert n == int(want_k[4]) == int(want_e[4])
    assert (n > 0) == clamps


def test_branch_writes_only_its_region():
    """Points outside a branch's write region keep the input value."""
    nx, ny, nz = 12, 7, 5
    vx, vy, vz, c = map(torch.tensor, _fields(nx, ny, nz, seed=4, scale=0.5))
    k = StepConsts(dt=0.9, dx=DX, dy=DY, dz=DZ, mu=0.0, rho=1.0, g_eff=0.0,
                   variant="gpu", vin=1.0)
    out = ka.advect_branch("vx", vx, vx, vy, vz, k, 2)
    assert torch.equal(out[0], vx[0]) and torch.equal(out[-1], vx[-1])
    out = ka.advect_branch("vy", vy, vx, vy, vz, k, 2)
    assert torch.equal(out[:, 0], vy[:, 0])
    assert torch.equal(out[:, -1], vy[:, -1])
    out = ka.advect_branch("vz", vz, vx, vy, vz, k, 2)
    assert torch.equal(out[:, :, 0], vz[:, :, 0])
    assert torch.equal(out[:, :, -1], vz[:, :, -1])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("compat", [True, False])
def test_gather_advect_matches_jax(compat, dtype):
    """Displacements of up to ~3 cells with some departure points clamped
    at the domain edges; compat=True leaves Vz as it is and writes Vy's
    third branch."""
    nx, ny, nz = 8, 6, 5
    fields = [a.astype(dtype) for a in _fields(nx, ny, nz, seed=7,
                                               scale=0.8)]
    dt = 1.3
    want = jadvect(*(jnp.asarray(a) for a in fields), dt, DX, DY, DZ,
                   compat=compat, method="gather", with_stats=True)
    got = tadv.advect(*(torch.tensor(a) for a in fields), dt, DX, DY, DZ,
                      compat=compat, method="gather")
    for a, b in zip(got[:4], want[:4]):
        assert a.dtype == torch.from_numpy(fields[0]).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(got[4]) == int(want[4]) == 0
    assert torch.equal(got[2], torch.tensor(fields[2])) == compat
    # the compat third branch rewrites Vy where branch 2 wrote it
    plain_vy = tadv.advect(*(torch.tensor(a) for a in fields), dt, DX, DY,
                           DZ, compat=False, method="gather")[1]
    assert torch.equal(got[1], plain_vy) != compat


def test_gather_keeps_nan_displacements_in_bounds():
    """A NaN velocity gives NaN where it is sampled and no out-of-range
    index."""
    fields = [torch.tensor(a) for a in _fields(6, 5, 4, seed=8, scale=0.5)]
    fields[0][3, 2, 1] = float("nan")
    out = tadv.advect(*fields, 0.9, DX, DY, DZ, compat=True,
                      method="gather")
    assert bool(torch.isnan(out[0][3, 2, 1]))
    assert bool(torch.isfinite(out[3]).any())
