"""K1's plain version and the Poisson residual evaluations against the JAX
package: the folded Pallas iteration in interpret mode
(build_poisson_iter(..., folded=True, interpret=True)), its flat-layout
compensated residual and residual_flat, and the solver's 3D compensated
residual and folded Laplacian. Inputs are seeded numpy arrays handed to
both packages; gpu variant under the hydrostatic split."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import navierstokes3d_tpu as ns
from navierstokes3d_tpu.kernels.poisson import (build_poisson_iter,
                                                poisson_bc_spec)
import navierstokes3d_tpu_torch as nt
from navierstokes3d_tpu_torch.kernels import poisson as kp
from navierstokes3d_tpu_torch.ops import ds as tds

torch.set_num_threads(2)
NX = 17


def _solvers(dtype="float32", nx=NX):
    js = ns.ChorinSolver(ns.preset_gpu(nx=nx, compat=False, dtype=dtype))
    ts = nt.ChorinSolver(nt.preset_gpu(nx=nx, compat=False, dtype=dtype),
                         device="cpu")
    return js, ts


def _bc_consistent_state(ts, rng):
    """A pressure with the split BCs applied (frozen Dirichlet planes, as
    the folded protocol's caller leaves them) and a zero-ring dpr."""
    g = ts.grid
    pr = ts.set_bc_pr(torch.tensor(
        rng.standard_normal(g.shape_c).astype(np.float32) * 100))
    dpr = torch.zeros(g.shape_c)
    dpr[1:-1, 1:-1, 1:-1] = torch.tensor(rng.standard_normal(
        (g.nx - 2, g.ny - 2, g.nz - 2)).astype(np.float32) * 1e3)
    rhs = torch.tensor(rng.standard_normal(g.shape_c).astype(np.float32)
                       * 1e5)
    return pr, dpr, rhs


def _jax_iter(js):
    g = js.grid
    bc = poisson_bc_spec("gpu", g, js.cfg.physics, pressure_split=True)
    return build_poisson_iter(g.nx, g.ny, g.nz, g.dx, g.dy, g.dz, g.dtau,
                              g.damp, bc, dtype=jnp.float32, slab=8,
                              interpret=True, mode="blocked", folded=True)


def test_k1_plain_matches_interpret_kernel():
    js, ts = _solvers()
    it_fn, pack, unpack = _jax_iter(js)
    step = jax.jit(it_fn)
    rng = np.random.default_rng(11)
    pr, dpr, rhs = _bc_consistent_state(ts, rng)
    pj, dj, rj = pack(jnp.asarray(pr.numpy()), jnp.asarray(dpr.numpy()),
                      jnp.asarray(rhs.numpy()))
    p_in, p_out = pr.clone(), torch.empty_like(pr)
    n_checked = 0
    for it in range(30):
        chk = it % 3 == 2
        pj, dj, ej = step(pj, dj, rj, chk)
        et = kp.poisson_iter(p_in, p_out, dpr, rhs, ts._op, chk)
        p_in, p_out = p_out, p_in
        if chk:
            np.testing.assert_allclose(float(et), float(np.max(ej)),
                                       rtol=1e-6)
            n_checked += 1
        else:
            assert et is None
    assert n_checked == 10
    # docs/numerics.md "Cross-program rounding": XLA's CPU compilation of
    # the interpreted kernel contracts a*b + c into FMAs (the plain version
    # and the CUDA kernel round every operation), so fields agree to the
    # repository's scaled per-element bound atol 1e-6 of max|field|; where
    # an iterate crosses zero, ulp counts are not a meaningful measure
    pj3, dj3 = unpack(pj, dj)
    for got, want in ((p_in, pj3), (dpr, dj3)):
        want = np.asarray(want)
        scale = np.abs(want).max()
        np.testing.assert_allclose(got.numpy() / scale, want / scale,
                                   rtol=0, atol=1e-6)


def test_k1_writes_every_cell():
    """pr_out gets every cell (boundary = pr) and dpr's ring stays 0, so
    ping-pong buffers never drift apart."""
    _, ts = _solvers()
    pr, dpr, rhs = _bc_consistent_state(ts, np.random.default_rng(2))
    out = torch.full_like(pr, float("nan"))
    kp.poisson_iter(pr, out, dpr, rhs, ts._op, False)
    assert bool(torch.isfinite(out).all())
    ring = torch.ones_like(pr, dtype=torch.bool)
    ring[1:-1, 1:-1, 1:-1] = False
    assert torch.equal(out[ring], pr[ring])
    assert bool((dpr[ring] == 0).all())


def test_compensated_residual_matches_kernel_form():
    """kernels/poisson.py compensated_residual (flat layout, Pallas path
    term order) vs the port's 3D form: bitwise; plus the f64 oracle."""
    js, ts = _solvers()
    it_fn, pack, unpack = _jax_iter(js)
    g = ts.grid
    rng = np.random.default_rng(7)
    p = ts.set_bc_pr(torch.tensor(
        rng.standard_normal(g.shape_c).astype(np.float32) * 100))
    divv = torch.tensor(rng.standard_normal(g.shape_c).astype(np.float32))
    rhs_hi, rhs_lo = tds.rhs_pair(divv, 1234.5, ts._z_hoist)
    pp, _, rf = pack(jnp.asarray(p.numpy()), jnp.zeros(g.shape_c,
                                                       jnp.float32),
                     jnp.asarray(rhs_hi.numpy()))
    rlo = pack(jnp.asarray(p.numpy()), jnp.zeros(g.shape_c, jnp.float32),
               jnp.asarray(rhs_lo.numpy()))[2]
    rj, ej = jax.jit(it_fn.compensated_residual)(pp, rf, rlo)
    rj3 = np.asarray(rj[:g.nx, :g.ny * g.nz]).reshape(g.shape_c)
    rt, et = kp.compensated_residual(p, rhs_hi, rhs_lo, ts._op)
    np.testing.assert_array_equal(rt.numpy(), rj3)
    assert float(et) == float(ej)
    # the residual of the (hi, lo) problem in f64
    p64 = p.numpy().astype(np.float64)
    rhs64 = rhs_hi.numpy().astype(np.float64) + rhs_lo.numpy()
    op64 = _solvers(dtype="float64")[1]._op
    lap = kp.folded_lap(torch.tensor(p64), op64)
    oracle = lap.numpy() - rhs64[1:-1, 1:-1, 1:-1]
    np.testing.assert_allclose(rt.numpy()[1:-1, 1:-1, 1:-1], oracle,
                               rtol=0, atol=1e-5 * np.abs(oracle).max())
    # a plain f32 evaluation (residual_flat) over-reports it
    naive = float(kp.residual_max(p, rhs_hi, ts._op))
    np.testing.assert_allclose(naive, float(jax.jit(it_fn.residual_flat)(
        pp, rf)), rtol=1e-6)


def test_pair_compensated_residual_matches_solver():
    """The solver's 3D (hi, lo) compensated residual (stored-state check)
    vs the JAX solver's _comp_residual_fn: bitwise."""
    js, ts = _solvers()
    g = ts.grid
    rng = np.random.default_rng(5)
    hi = rng.standard_normal(g.shape_c).astype(np.float32) * 100
    lo = rng.standard_normal(g.shape_c).astype(np.float32) * 1e-5
    rh = rng.standard_normal((g.nx - 2, g.ny - 2, g.nz - 2)
                             ).astype(np.float32) * 1e5
    rl = rng.standard_normal(rh.shape).astype(np.float32)
    rj, ej = jax.jit(js._comp_residual_fn())(*map(jnp.asarray,
                                                  (hi, lo, rh, rl)))
    rt, et = ts._comp_residual(*map(torch.tensor, (hi, lo, rh, rl)))
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    assert float(et) == float(ej)


def test_folded_lap_matches_solver_f64():
    js, ts = _solvers(dtype="float64")
    rng = np.random.default_rng(9)
    p = rng.standard_normal(ts.grid.shape_c) * 100
    np.testing.assert_array_equal(
        kp.folded_lap(torch.tensor(p), ts._op).numpy(),
        np.asarray(js._folded_lap_fn()(jnp.asarray(p))))


@pytest.mark.parametrize("weights", ["wyp", "wym", "wzp", "wzm"])
def test_weight_rows_match_kernel_rows(weights):
    """The kernel's weight rows: f32(1/h^2) where the neighbor is live, 0
    where it is a zero-gradient copy (the JAX rows at poisson.py:216-219)."""
    _, ts = _solvers()
    g = ts.grid
    n, h = (g.ny, g.dy) if weights[1] == "y" else (g.nz, g.dz)
    skip = n - 2 if weights[2] == "p" else 1
    want = np.full(n, np.float32(1.0 / h / h), np.float32)
    want[skip] = 0.0
    got = getattr(ts._op, weights).numpy()
    np.testing.assert_array_equal(got[1:-1], want[1:-1])
