"""K3 (predict) and K4 (correct) plain versions against the JAX package's
fused Pallas kernels in interpret mode (build_predict / build_correct) and
its jnp chain, gpu variant under the hydrostatic split.

The plain versions round every operation on its own, as the JAX functions
do when JAX runs them op by op: against that eager chain they must be
BITWISE equal. The jitted kernel (and the jitted jnp chain, which agrees
with it bitwise) may contract or rewrite `v + s*f` per compilation, which
moves O(1) velocities by ~1 ulp; at the few elements near zero that is
many ulps of the element itself, so the kernel comparison uses the
repository's per-element standard (docs/numerics.md "Cross-program
rounding"): 4 ulp, or an absolute 1e-6 of max|field|, and
tests/test_fused_step.py's divergence bound."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import navierstokes3d_tpu as ns
from navierstokes3d_tpu.kernels.fused_step import build_correct, build_predict
from navierstokes3d_tpu.ops import physics as jph
from navierstokes3d_tpu.ops.cylinder import apply_cylinder
import navierstokes3d_tpu_torch as nt
from navierstokes3d_tpu_torch.kernels import fused_step as kf

torch.set_num_threads(2)


def _setup(nx):
    js = ns.ChorinSolver(ns.preset_gpu(nx=nx, nt=1, compat=False,
                                       dtype="float32"))
    ts = nt.ChorinSolver(nt.preset_gpu(nx=nx, nt=1, compat=False,
                                       dtype="float32"), device="cpu")
    return js, ts


def _fields(g, seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.normal(size=g.shape_vx).astype(f),
            rng.normal(size=g.shape_vy).astype(f),
            rng.normal(size=g.shape_vz).astype(f),
            rng.normal(size=g.shape_c).astype(f))


def _close(got, want):
    """Per element: within 4 ulp, or within 1e-6 of the field's max."""
    for a, b in zip(got, want):
        a, b = a.numpy(), np.asarray(b)
        scale = np.abs(b).max()
        ok = np.abs(a - b) <= np.maximum(
            4 * np.spacing(np.abs(b).astype(np.float32)), 1e-6 * scale)
        assert ok.all(), (np.abs(a - b).max(), scale)


@pytest.mark.parametrize("nx", [17, 24])
def test_predict_plain_matches_kernel(nx):
    js, ts = _setup(nx)
    g, phys = js.grid, js.cfg.physics
    assert bool(ts.masks.mask_vx.any()), "cylinder off-grid"
    vx, vy, vz, _ = _fields(ts.grid, 0)
    fn = build_predict(g.nx, g.ny, g.nz, dt=g.dt, dx=g.dx, dy=g.dy, dz=g.dz,
                       mu=phys.mu, rho=phys.rho, g_eff=0.0, masks=js.masks,
                       interpret=True)
    want = jax.jit(fn)(*map(jnp.asarray, (vx, vy, vz)))
    got = kf.predict(*map(torch.tensor, (vx, vy, vz)), ts.masks, ts._consts)
    _close(got[:3], want[:3])
    taus = jph.update_tau(*map(jnp.asarray, (vx, vy, vz)), phys.mu, g.dx,
                          g.dy, g.dz)
    eager = jph.predict_v(*map(jnp.asarray, (vx, vy, vz)), *taus, phys.rho,
                          0.0, g.dt, g.dx, g.dy, g.dz)
    _, *eager = apply_cylinder(jnp.zeros((g.nx, g.ny, g.nz),
                                         jnp.float32),
                               *eager, js.masks)
    eager.append(jph.update_divv(*eager, g.dx, g.dy, g.dz))
    for a, b in zip(got, eager):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    dv_def = jph.update_divv(*(jnp.asarray(a.numpy()) for a in got[:3]),
                             g.dx, g.dy, g.dz)
    scale = np.abs(np.asarray(dv_def)).max()
    for other in (dv_def, want[3]):
        np.testing.assert_allclose(got[3].numpy(), np.asarray(other),
                                   rtol=1e-5, atol=8 * 1.2e-7 * scale)


@pytest.mark.parametrize("nx", [17, 24])
def test_correct_plain_matches_kernel(nx):
    js, ts = _setup(nx)
    g, phys = js.grid, js.cfg.physics
    vx, vy, vz, pr = _fields(ts.grid, 3)
    fn = build_correct(g.nx, g.ny, g.nz, dt=g.dt, dx=g.dx, dy=g.dy, dz=g.dz,
                       rho=phys.rho, masks=js.masks, interpret=True,
                       variant="gpu", vin=phys.vin)
    want = jax.jit(fn)(*map(jnp.asarray, (vx, vy, vz, pr)))
    got = kf.correct(*map(torch.tensor, (vx, vy, vz, pr)), ts.masks,
                     ts._consts)
    _close(got, want)
    eager = jph.correct_v(*map(jnp.asarray, (vx, vy, vz, pr)), g.dt,
                          phys.rho, g.dx, g.dy, g.dz)
    _, *eager = apply_cylinder(jnp.zeros((g.nx, g.ny, g.nz), jnp.float32),
                               *eager, js.masks)
    for a, b in zip(got, js.set_bc_vel(*eager)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_predictor_divv_matches_jax_solver():
    """The solver-level prelude on a developed state: the port's
    predictor_divv equals the JAX solver's (same kernel math)."""
    js, ts = _setup(17)
    st = js.init_state()
    st, _ = jax.jit(js.step)(st)
    want = jax.jit(js.predictor_divv)(st)
    got = ts.predictor_divv(nt.state_from_numpy(
        {k: np.asarray(getattr(st, k)) for k in
         ("pr", "vx", "vy", "vz", "c", "dprdtau")}, device="cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
