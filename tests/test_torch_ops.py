"""The port's plain ops against the JAX package's jnp functions.

Stencil/physics/cylinder and both variants' boundary conditions (with and
without compat mode, split and unsplit) must be EXACT in float64 (identical expression trees, each operation rounded on its
own in both frameworks); the double-single building blocks must be bitwise
equal in float32. Inputs come from a seeded numpy generator and go to both
packages. Distinct nx/ny/nz catch axis mix-ups.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import navierstokes3d_tpu as ns
from navierstokes3d_tpu import bc as jbc
from navierstokes3d_tpu.ops import cylinder as jcyl
from navierstokes3d_tpu.ops import ds as jds
from navierstokes3d_tpu.ops import physics as jph
import navierstokes3d_tpu_torch as nt
from navierstokes3d_tpu_torch import bc as tbc
from navierstokes3d_tpu_torch.ops import cylinder as tcyl
from navierstokes3d_tpu_torch.ops import ds as tds
from navierstokes3d_tpu_torch.ops import physics as tph

torch.set_num_threads(2)

NX, NY, NZ = 8, 6, 5
DX, DY, DZ = 0.11, 0.21, 0.31
RHO, MU, G, DT = 1000.0, 0.001, 9.81, 0.013


def _rand(rng, shape, dtype=np.float64, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(dtype)


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.tensor(a) for a in arrays])


def _eq(got_t, want_j):
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_j))


def _velocities(rng, dtype=np.float64):
    return (_rand(rng, (NX + 1, NY, NZ), dtype),
            _rand(rng, (NX, NY + 1, NZ), dtype),
            _rand(rng, (NX, NY, NZ + 1), dtype))


def test_update_tau_predict_divv_exact():
    rng = np.random.default_rng(1)
    (jvx, jvy, jvz), (tvx, tvy, tvz) = _both(*_velocities(rng))
    jt = jph.update_tau(jvx, jvy, jvz, MU, DX, DY, DZ)
    tt = tph.update_tau(tvx, tvy, tvz, MU, DX, DY, DZ)
    for a, b in zip(tt, jt):
        _eq(a, b)
    for g in (G, 0.0):
        jv = jph.predict_v(jvx, jvy, jvz, *jt, RHO, g, DT, DX, DY, DZ)
        tv = tph.predict_v(tvx, tvy, tvz, *tt, RHO, g, DT, DX, DY, DZ)
        for a, b in zip(tv, jv):
            _eq(a, b)
    _eq(tph.update_divv(tvx, tvy, tvz, DX, DY, DZ),
        jph.update_divv(jvx, jvy, jvz, DX, DY, DZ))


def test_poisson_iter_and_correct_exact():
    rng = np.random.default_rng(2)
    pr, divv = _rand(rng, (NX, NY, NZ)), _rand(rng, (NX, NY, NZ))
    dpr = np.zeros((NX, NY, NZ))
    dpr[1:-1, 1:-1, 1:-1] = _rand(rng, (NX - 2, NY - 2, NZ - 2))
    (jp, jd, jdv), (tp, td, tdv) = _both(pr, dpr, divv)
    args = (RHO, DT, 0.017, 2.0 / NX, DX, DY, DZ)
    for a, b in zip(tph.poisson_iter(tp, td, tdv, *args),
                    jph.poisson_iter(jp, jd, jdv, *args)):
        _eq(a, b)
    (jvx, jvy, jvz), (tvx, tvy, tvz) = _both(*_velocities(rng))
    for a, b in zip(tph.correct_v(tvx, tvy, tvz, tp, DT, RHO, DX, DY, DZ),
                    jph.correct_v(jvx, jvy, jvz, jp, DT, RHO, DX, DY, DZ)):
        _eq(a, b)


@pytest.mark.parametrize("nx", [15, 17, 24])
def test_cylinder_masks_and_apply(nx):
    cfgj = ns.preset_gpu(nx=nx, compat=False)
    cfgt = nt.preset_gpu(nx=nx, compat=False)
    grid = nt.make_grid(cfgt)
    mj = jcyl.build_masks(cfgj, ns.make_grid(cfgj))
    mt = tcyl.build_masks(cfgt, grid)
    for name in ("mask_c", "mask_vx", "mask_vy", "mask_vz"):
        np.testing.assert_array_equal(getattr(mt, name).numpy(),
                                      np.asarray(getattr(mj, name)))
    assert bool(mt.mask_vx.any())
    rng = np.random.default_rng(nx)
    f = [_rand(rng, s) for s in (grid.shape_c, grid.shape_vx,
                                 grid.shape_vy, grid.shape_vz)]
    j, t = _both(*f)
    for a, b in zip(tcyl.apply_cylinder(*t, mt),
                    jcyl.apply_cylinder(*j, mj)):
        _eq(a, b)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_gpu_split_bcs_exact(dtype):
    nx = 17
    cfgj = ns.preset_gpu(nx=nx, compat=False)
    cfgt = nt.preset_gpu(nx=nx, compat=False)
    gj, gt = ns.make_grid(cfgj), nt.make_grid(cfgt)
    vel_j, pr_j = jbc.make_bc_fns(cfgj, gj, pressure_split=True)
    vel_t, pr_t = tbc.make_bc_fns(cfgt, gt, pressure_split=True)
    pair_j = jbc.make_bc_pr_pair(cfgj, gj, pressure_split=True)
    pair_t = tbc.make_bc_pr_pair(cfgt, gt, pressure_split=True)
    rng = np.random.default_rng(3)
    v = [_rand(rng, s, dtype) for s in (gt.shape_vx, gt.shape_vy,
                                        gt.shape_vz)]
    j, t = _both(*v)
    for a, b in zip(vel_t(*t), vel_j(*j)):
        _eq(a, b)
    p = _rand(rng, gt.shape_c, dtype, scale=100.0)
    lo = _rand(rng, gt.shape_c, dtype, scale=1e-5)
    (jp, jl), (tp, tl) = _both(p, lo)
    _eq(pr_t(tp), pr_j(jp))
    for a, b in zip(pair_t(tp, tl), pair_j(jp, jl)):
        _eq(a, b)
    _eq(tp, p)  # inputs are not modified


def test_folded_masks_match_solver():
    cfgj = ns.preset_gpu(nx=17, compat=False, dtype="float32")
    s = ns.ChorinSolver(cfgj)
    cfgt = nt.preset_gpu(nx=17, compat=False, dtype="float32")
    m = tbc.folded_masks(cfgt, nt.make_grid(cfgt), pressure_split=True)
    want = s._folded_masks(np.float64)
    for key, w in zip(("xm", "xp", "ym", "yp", "zm", "zp"), want):
        np.testing.assert_array_equal(m[key], w.ravel())


def test_ds_ops_bitwise_f32():
    rng = np.random.default_rng(4)
    a = _rand(rng, (40, 30), np.float32, scale=1e4)
    b = _rand(rng, (40, 30), np.float32, scale=1e-2)
    (ja, jb), (ta, tb) = _both(a, b)
    for fn in ("two_sum", "two_prod"):
        for x, y in zip(getattr(tds, fn)(ta, tb), getattr(jds, fn)(ja, jb)):
            _eq(x, y)
    for x, y in zip(tds.split(ta), jds.split(ja)):
        _eq(x, y)
    # RHS pair, with and without the z hoist along the last axis
    zh = rng.standard_normal(30) * 1e6
    for hoist in (None, zh):
        for x, y in zip(tds.rhs_pair(ta, 1234.5678, hoist),
                        jds.rhs_pair(ja, 1234.5678, hoist)):
            _eq(x, y)
    w64 = np.abs(rng.standard_normal(30)) * 1e5
    qt, qj = tds.weight_quad(w64), jds.weight_quad(w64)
    for x, y in zip(qt, qj):
        _eq(x, y)
    dl = _rand(rng, (40, 30), np.float32, scale=1e-3)
    jdl, tdl = jnp.asarray(dl), torch.tensor(dl)
    pt = tds.weighted_term(ta, tdl, qt)
    pj = jds.weighted_term(ja, jdl, qj)
    for x, y in zip(pt, pj):
        _eq(x, y)
    pairs_t = [pt, tds.two_sum(ta, tb), (tb, tdl)]
    pairs_j = [pj, jds.two_sum(ja, jb), (jb, jdl)]
    for x, y in zip(tds.accumulate(pairs_t), jds.accumulate(pairs_j)):
        _eq(x, y)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_multi_bcs_exact(dtype):
    """The multi variant (compat=False): zero-gradient faces, the inlet
    Vx = vin and the outlet Pr = 0, and the (hi, lo) pair image."""
    nx = 17
    cfgj = ns.preset_multi(nx=nx, compat=False)
    cfgt = nt.preset_multi(nx=nx, compat=False)
    gj, gt = ns.make_grid(cfgj), nt.make_grid(cfgt)
    vel_j, pr_j = jbc.make_bc_fns(cfgj, gj)
    vel_t, pr_t = tbc.make_bc_fns(cfgt, gt)
    pair_j = jbc.make_bc_pr_pair(cfgj, gj)
    pair_t = tbc.make_bc_pr_pair(cfgt, gt)
    rng = np.random.default_rng(6)
    v = [_rand(rng, s, dtype) for s in (gt.shape_vx, gt.shape_vy,
                                        gt.shape_vz)]
    j, t = _both(*v)
    for a, b in zip(vel_t(*t), vel_j(*j)):
        _eq(a, b)
    assert bool((vel_t(*t)[0][0] == cfgt.physics.vin).all())
    p = _rand(rng, gt.shape_c, dtype, scale=100.0)
    lo = _rand(rng, gt.shape_c, dtype, scale=1e-5)
    (jp, jl), (tp, tl) = _both(p, lo)
    _eq(pr_t(tp), pr_j(jp))
    for a, b in zip(pair_t(tp, tl), pair_j(jp, jl)):
        _eq(a, b)
    _eq(tp, p)  # inputs are not modified


def test_multi_folded_masks_match_solver():
    cfgj = ns.preset_multi(nx=17, compat=False, dtype="float32")
    s = ns.ChorinSolver(cfgj)
    cfgt = nt.preset_multi(nx=17, compat=False, dtype="float32")
    m = tbc.folded_masks(cfgt, nt.make_grid(cfgt))
    want = s._folded_masks(np.float64)
    for key, w in zip(("xm", "xp", "ym", "yp", "zm", "zp"), want):
        np.testing.assert_array_equal(m[key], w.ravel())
    assert m["xm"][0] == 0 and m["xp"].all()


@pytest.mark.parametrize("nx", [15, 63])
def test_multi_cylinder_masks(nx):
    cfgj = ns.preset_multi(nx=nx, compat=False)
    cfgt = nt.preset_multi(nx=nx, compat=False)
    mj = jcyl.build_masks(cfgj, ns.make_grid(cfgj))
    mt = tcyl.build_masks(cfgt, nt.make_grid(cfgt))
    for name in ("mask_c", "mask_vx", "mask_vy", "mask_vz"):
        np.testing.assert_array_equal(getattr(mt, name).numpy(),
                                      np.asarray(getattr(mj, name)))
    assert bool(mt.mask_vx.any())


def test_unported_bcs_raise():
    """What still raises: the hydrostatic split on the multi variant (its
    g is 0), for every BC builder and with compat on or off, and an
    unknown variant."""
    for compat in (True, False):
        cfg = nt.preset_multi(nx=15, compat=compat)
        grid = nt.make_grid(cfg)
        for build in (tbc.make_bc_fns, tbc.folded_masks,
                      tbc.make_bc_pr_pair):
            with pytest.raises(NotImplementedError, match="pressure_split"):
                build(cfg, grid, pressure_split=True)
    cfg = nt.preset_multi(nx=15).replace(variant="other")
    with pytest.raises(ValueError, match="variant"):
        tbc.make_bc_fns(cfg, nt.make_grid(cfg))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("variant", ["multi", "gpu"])
def test_compat_bcs_exact(variant, dtype):
    """compat mode's BCs (after tests/test_kernels.py:141-171): the multi
    reference's velocity BCs without bc_y!(Vy) and bc_z!(Vz), and the
    unsplit gpu pressure BCs with their hydrostatic planes, which
    hydrostatic_x evaluates in the field's dtype; the unsplit gpu (hi, lo)
    pair BCs too."""
    nx = 17
    preset_j = ns.preset_multi if variant == "multi" else ns.preset_gpu
    preset_t = nt.preset_multi if variant == "multi" else nt.preset_gpu
    cfgj, cfgt = preset_j(nx=nx), preset_t(nx=nx)
    assert cfgj.compat and cfgt.compat
    gj, gt = ns.make_grid(cfgj), nt.make_grid(cfgt)
    vel_j, pr_j = jbc.make_bc_fns(cfgj, gj)
    vel_t, pr_t = tbc.make_bc_fns(cfgt, gt)
    rng = np.random.default_rng(7)
    v = [_rand(rng, s, dtype) for s in (gt.shape_vx, gt.shape_vy,
                                        gt.shape_vz)]
    j, t = _both(*v)
    out = vel_t(*t)
    for a, b in zip(out, vel_j(*j)):
        _eq(a, b)
    if variant == "multi":
        # the omitted copies leave Vy's y faces and Vz's z faces alone
        assert torch.equal(out[1][1:-1, 0, 1:-1], t[1][1:-1, 0, 1:-1])
        assert torch.equal(out[2][1:-1, 1:-1, 0], t[2][1:-1, 1:-1, 0])
    p = _rand(rng, gt.shape_c, dtype, scale=100.0)
    lo = _rand(rng, gt.shape_c, dtype, scale=1e-5)
    (jp, jl), (tp, tl) = _both(p, lo)
    _eq(pr_t(tp), pr_j(jp))
    if variant == "gpu":
        pair_j = jbc.make_bc_pr_pair(cfgj, gj)
        pair_t = tbc.make_bc_pr_pair(cfgt, gt)
        for a, b in zip(pair_t(tp, tl), pair_j(jp, jl)):
            _eq(a, b)
    _eq(tp, p)  # inputs are not modified


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_poisson_residual_exact(dtype):
    rng = np.random.default_rng(8)
    pr, divv = _rand(rng, (NX, NY, NZ), dtype), _rand(rng, (NX, NY, NZ),
                                                      dtype)
    (jp, jd), (tp, td) = _both(pr, divv)
    _eq(tph.poisson_residual(tp, td, RHO, DT, DX, DY, DZ),
        jph.poisson_residual(jp, jd, RHO, DT, DX, DY, DZ))
