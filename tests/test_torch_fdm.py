"""The fdm backend of the port (ops/fdm_poisson.py and the solver's
`_poisson_solve_fdm`, on the CPU) against the JAX package's, against a
scipy sparse direct solve of the folded operator, and against a tightly
converged pseudo-transient step.

Tolerances:
  * module level: solve_host_f64 is the same numpy code, so bitwise; the
    float64 direct solve to 1e-10 of max|p| (both are exact to ~1e-15;
    the matmuls sum in another order); float32 to 5e-6 of max|p| (six
    transforms of n ~ 18 terms each, ~1e-7 per transform, the modal
    division amplifying by cond ~ 10); apply_a to 1e-13 of max|A p| in
    float64 (XLA contracts the weighted sum into FMAs).
  * step level: the JAX state enters the port before every step (the
    state is carried across), so each step compares one step's work.
    Equal refinement rounds, err and the stored-state error below eps_it,
    and pr within the residual-derived bound: both pressures satisfy
    |A p - rhs| <= err * psc/ly^2, so |p1 - p2| <= sqrt(N) (err1 + err2)
    psc/ly^2 / lam_min (||A^-1||_2 = 1/lam_min, the smallest eigenvalue
    magnitude), plus 4 float32 ulp of max|pr| for the stored rounding. The
    velocities and tracer agree to 1e-5 of their max (float32) or 1e-12
    (float64) everywhere but on vy's face plane of the flow's y symmetry
    (ny even: face ny/2), where vy is 0 or +-1e-13 noise whose sign two
    correct evaluations need not share, and the advection's floor()
    discontinuity (docs/numerics.md "Cross-program rounding";
    tests/test_torch_slice_f64.py) samples the neighbouring cell; and at
    the points where the JAX package's departure corner, the source's
    floor(fl(i - dl)), reads the cell next to the port's exact i -
    ceil(dl) (tests/advect_faults.py, marked from the port's advection
    inputs of the step).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import advect_faults
import navierstokes3d_tpu as ns
import navierstokes3d_tpu_torch as nt
from navierstokes3d_tpu.ops import fdm_poisson as jfdm
from navierstokes3d_tpu_torch.ops import fdm_poisson as tfdm
from navierstokes3d_tpu_torch.parallel import make_mesh

torch.set_num_threads(2)
NX = 20
FIELDS = ("pr", "vx", "vy", "vz", "c", "dprdtau")
PRESETS = {"multi": (ns.preset_multi, nt.preset_multi),
           "gpu": (ns.preset_gpu, nt.preset_gpu)}


def _fdm_cfg(make, nx=NX, dtype="float32", **num):
    cfg = make(nx=nx, compat=False, dtype=dtype)
    return cfg.replace(numerics=dataclasses.replace(
        cfg.numerics, poisson_backend="fdm", **num))


def _np_state(st):
    out = {k: np.asarray(getattr(st, k)) for k in FIELDS}
    out["pr_lo"] = None if st.pr_lo is None else np.asarray(st.pr_lo)
    return out


def _rhs(grid, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(grid.nx - 2, grid.ny - 2, grid.nz - 2)) * 1e4


@pytest.mark.parametrize("variant", ["multi", "gpu"])
def test_solve_host_f64_bitwise(variant):
    g = nt.make_grid(PRESETS[variant][1](nx=12))
    rhs = _rhs(g)
    np.testing.assert_array_equal(
        tfdm.solve_host_f64(g, variant, rhs),
        jfdm.solve_host_f64(ns.make_grid(PRESETS[variant][0](nx=12)),
                            variant, rhs))


@pytest.mark.parametrize("variant", ["multi", "gpu"])
@pytest.mark.parametrize("dtype,tol", [("float64", 1e-10), ("float32", 5e-6)])
@pytest.mark.parametrize("refine", [0, 1])
def test_build_fdm_solver_matches_jax(variant, dtype, tol, refine):
    jg = ns.make_grid(PRESETS[variant][0](nx=NX))
    tg = nt.make_grid(PRESETS[variant][1](nx=NX))
    js = jfdm.build_fdm_solver(jg, variant, getattr(jnp, dtype))
    ts = tfdm.build_fdm_solver(tg, variant, getattr(torch, dtype), "cpu")
    for a, b in zip(ts.eig_consts, js.eig_consts):
        np.testing.assert_array_equal(a, b)
    rhs = _rhs(tg).astype(dtype)
    # refine is a Python loop count: the JAX solve's jit traces it, so
    # call the function it wraps
    want = np.asarray(js.__wrapped__(jnp.asarray(rhs), refine=refine))
    got = ts(torch.tensor(rhs), refine=refine).numpy()
    assert got.dtype == want.dtype == np.dtype(dtype)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=tol)


@pytest.mark.parametrize("variant", ["multi", "gpu"])
def test_apply_a_matches_jax(variant):
    jg = ns.make_grid(PRESETS[variant][0](nx=NX))
    tg = nt.make_grid(PRESETS[variant][1](nx=NX))
    js = jfdm.build_fdm_solver(jg, variant, jnp.float64)
    ts = tfdm.build_fdm_solver(tg, variant, torch.float64, "cpu")
    p = _rhs(tg, 1)
    want = np.asarray(js.apply_a(jnp.asarray(p)))
    got = ts.apply_a(torch.tensor(p)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-13 * np.abs(want).max())
    # and the solve inverts it: A solve(f) = f
    f = torch.tensor(_rhs(tg, 2))
    back = ts.apply_a(ts(f, refine=0))
    np.testing.assert_allclose(back.numpy(), f.numpy(), rtol=0,
                               atol=1e-10 * float(f.abs().max()))


def _assemble(grid, x_lo_zero_grad):
    """The folded operator as a sparse matrix: zero-gradient faces drop
    the neighbor term, Dirichlet faces (the gpu variant's two x planes,
    the multi variant's outlet) keep it with the boundary value in the
    RHS (homogeneous here)."""
    ix, iy, iz = grid.nx - 2, grid.ny - 2, grid.nz - 2
    n = ix * iy * iz
    idx = np.arange(n).reshape(ix, iy, iz)
    rows, cols, vals = [], [], []
    diag = np.zeros((ix, iy, iz))
    for axis, m, h in ((0, ix, grid.dx), (1, iy, grid.dy), (2, iz, grid.dz)):
        c = 1.0 / (h * h)
        for side in (-1, 1):
            src = [slice(None)] * 3
            dst = [slice(None)] * 3
            src[axis] = slice(max(0, -side), m - max(0, side))
            dst[axis] = slice(max(0, side), m - max(0, -side))
            rows.append(idx[tuple(src)].ravel())
            cols.append(idx[tuple(dst)].ravel())
            vals.append(np.full(rows[-1].size, c))
            diag[tuple(src)] -= c
            edge = [slice(None)] * 3
            edge[axis] = 0 if side == -1 else m - 1
            dirichlet = axis == 0 and (side == 1 or not x_lo_zero_grad)
            if dirichlet:
                diag[tuple(edge)] -= c
    rows.append(idx.ravel())
    cols.append(idx.ravel())
    vals.append(diag.ravel())
    return sp.csr_matrix((np.concatenate(vals),
                          (np.concatenate(rows), np.concatenate(cols))),
                         shape=(n, n))


@pytest.mark.parametrize("variant", ["multi", "gpu"])
def test_fdm_matches_sparse_direct_solve(variant):
    """float64: the direct solve against scipy's sparse LU of the folded
    operator, to 1e-9 of max|p| (both are exact; the operator's condition
    number at nx=20 is ~1e3)."""
    g = nt.make_grid(PRESETS[variant][1](nx=NX))
    a = _assemble(g, x_lo_zero_grad=variant == "multi")
    rhs = _rhs(g, 3)
    want = spla.spsolve(a.tocsc(), rhs.ravel()).reshape(rhs.shape)
    got = tfdm.build_fdm_solver(g, variant, torch.float64, "cpu")(
        torch.tensor(rhs), refine=0).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-9 * np.abs(want).max())


def _jax_fdm_run(variant, dtype, nsteps, **num):
    """nsteps of the JAX fdm step from init_state, on the select-shift
    advection the port runs (the JAX package's CPU default is gather):
    the state before each step and each step's stats."""
    s = ns.ChorinSolver(_fdm_cfg(PRESETS[variant][0], dtype=dtype, **num))
    s.advect_method = "selectshift"
    st = s.init_state()
    states, stats = [_np_state(st)], []
    for _ in range(nsteps):
        st, sts = s.step_jit(st)
        states.append(_np_state(st))
        stats.append(sts)
    return states, stats


@pytest.fixture(scope="module")
def jax_runs():
    return {(v, d): _jax_fdm_run(v, d, 3) for v in ("multi", "gpu")
            for d in ("float32", "float64")}


def _pr_bound(solver, err_a, err_b, pr):
    g, phys = solver.grid, solver.cfg.physics
    lx, ly, lz = solver._fdm.eig_consts
    lam_min = np.abs(lx[:, None, None] + ly[None, :, None]
                     + lz[None, None, :]).min()
    n = (g.nx - 2) * (g.ny - 2) * (g.nz - 2)
    ulp = np.finfo(pr.dtype).eps
    return (np.sqrt(n) * (float(err_a) + float(err_b)) * phys.psc
            / g.ly ** 2 / float(lam_min) + 4 * ulp * np.abs(pr).max())


@pytest.mark.parametrize("variant", ["multi", "gpu"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_fdm_step_matches_jax(jax_runs, variant, dtype, monkeypatch):
    states, stats = jax_runs[(variant, dtype)]
    faults = advect_faults.record_advect(monkeypatch)
    s = nt.ChorinSolver(_fdm_cfg(PRESETS[variant][1], dtype=dtype),
                        device="cpu")
    assert s._fdm is not None and not s.pressure_split
    assert s.grid.ny % 2 == 0
    assert s.acc == "none" and not s.extended
    st = s.init_state()
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(st, k).numpy(), states[0][k])
    eps_it = s.cfg.numerics.eps_it
    vtol = 1e-5 if dtype == "float32" else 1e-12
    for step in range(3):
        st = nt.state_from_numpy(states[step], device="cpu")
        divv = s.predictor_divv(st)
        st, got = s.step(st)
        want, ref = stats[step], states[step + 1]
        assert got.iters == int(want.iters) <= s.cfg.numerics.fdm_refine
        assert got.err < eps_it and float(want.err) < eps_it
        assert got.advect_clamped == int(want.advect_clamped)
        if dtype == "float32":
            assert st.pr_lo is not None
            assert s.stored_residual_err(st, divv=divv) < eps_it
        else:
            assert st.pr_lo is None
        for k in FIELDS:
            assert bool(torch.isfinite(getattr(st, k)).all()), k
        pr = st.pr.numpy()
        bound = _pr_bound(s, got.err, want.err, ref["pr"])
        assert np.abs(pr - ref["pr"]).max() <= bound, (step, bound)
        np.testing.assert_array_equal(st.dprdtau.numpy(), ref["dprdtau"])
        for k in ("vx", "vy", "vz", "c"):
            a, b = getattr(st, k).numpy(), ref[k]
            far = np.abs(a - b) > vtol * max(1.0, np.abs(b).max())
            if k == "vy":
                far[:, s.grid.ny // 2] = False   # the symmetry plane
            far &= ~faults[-1][k]
            assert not far.any(), (k, step, np.argwhere(far)[:5])


def test_fdm_refinement_rounds_match_jax():
    """A tolerance the direct solve alone misses (gpu, eps_it 1e-7): one
    refinement round in both packages, the same err_hist entries before
    it, and err after it below eps_it."""
    states, stats = _jax_fdm_run("gpu", "float32", 1, eps_it=1e-7)
    s = nt.ChorinSolver(_fdm_cfg(nt.preset_gpu, eps_it=1e-7), device="cpu")
    st, got = s.step(s.init_state())
    assert got.iters == int(stats[0].iters) == 1
    assert got.err < 1e-7
    hist = np.asarray(stats[0].err_hist)
    assert got.err_hist[0] == hist[0]
    assert np.isnan(got.err_hist[2:]).all() and np.isnan(hist[2:]).all()
    bound = _pr_bound(s, got.err, stats[0].err, states[1]["pr"])
    assert np.abs(st.pr.numpy() - states[1]["pr"]).max() <= bound


def test_fdm_refine_budget_exhaustion():
    """fdm_refine=0 with an unreachable eps returns the direct solve: zero
    rounds, an honest err above the tolerance (the JAX package's err to
    float32 rounding), finite fields."""
    num = dict(fdm_refine=0, eps_it=1e-12)
    _, stats = _jax_fdm_run("gpu", "float32", 1, **num)
    s = nt.ChorinSolver(_fdm_cfg(nt.preset_gpu, **num), device="cpu")
    st, got = s.step(s.init_state())
    assert got.iters == int(stats[0].iters) == 0
    assert got.err > 1e-12
    np.testing.assert_allclose(got.err, float(stats[0].err), rtol=1e-5)
    for k in FIELDS:
        assert bool(torch.isfinite(getattr(st, k)).all()), k


@pytest.mark.parametrize("variant", ["multi", "gpu"])
def test_fdm_step_matches_tight_pt_step(variant):
    """The fdm step (float64) solves the pressure system outright and
    matches the pseudo-transient step converged to eps_it = 1e-6 (as the
    JAX package's test_fdm_backend_full_step): velocities within 2e-4."""
    make = PRESETS[variant][1]
    cfg = make(nx=NX, compat=False)
    s_pt = nt.ChorinSolver(cfg.replace(numerics=dataclasses.replace(
        cfg.numerics, eps_it=1e-6)), device="cpu")
    s_fdm = nt.ChorinSolver(_fdm_cfg(make, dtype="float64"), device="cpu")
    a, _ = s_pt.step(s_pt.init_state())
    b, stats = s_fdm.step(s_fdm.init_state())
    assert stats.err < 1e-10
    for k in ("vx", "vy", "vz"):
        np.testing.assert_allclose(getattr(b, k).numpy(),
                                   getattr(a, k).numpy(), rtol=0, atol=2e-4,
                                   err_msg=f"{variant}:{k}")


def test_fdm_rules():
    """The JAX package's fdm rules (models/chorin.py:193-216, :251-255):
    compat raises, an explicit split raises, the auto split and the
    extended pair are off (so the gpu variant's K3 carries g, and its
    static boundary field is solved on the host); the solver targets the
    card; the distributed step refuses fdm."""
    cfg = nt.preset_multi(nx=9, compat=True)
    with pytest.raises(ValueError, match="compat"):
        nt.ChorinSolver(cfg.replace(numerics=dataclasses.replace(
            cfg.numerics, poisson_backend="fdm")), device="cpu")
    cfg = _fdm_cfg(nt.preset_gpu, nx=9, pressure_split=True)
    with pytest.raises(NotImplementedError, match="pressure_split"):
        nt.ChorinSolver(cfg, device="cpu")
    for variant, make in (("gpu", nt.preset_gpu), ("multi", nt.preset_multi)):
        s = nt.ChorinSolver(_fdm_cfg(make, nx=9), device="cpu")
        assert not s.pressure_split and not s.extended
        assert s._consts.g_eff == s.cfg.physics.g
        assert (s._fdm_static is not None) == (variant == "gpu")
        with pytest.raises(NotImplementedError, match="fdm"):
            s.step_shard_map(make_mesh((1, 1, 1), "cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            nt.ChorinSolver(_fdm_cfg(nt.preset_gpu, nx=9))


def test_full_pressure_and_gather_inner_match_jax():
    """full_pressure and the gather_inner method (the physical pressure
    under the hydrostatic split) against the JAX package's, on the gpu
    preset's split state after one step."""
    js = ns.ChorinSolver(ns.preset_gpu(nx=15, compat=False))
    ts = nt.ChorinSolver(nt.preset_gpu(nx=15, compat=False), device="cpu")
    assert js.pressure_split and ts.pressure_split
    rng = np.random.default_rng(5)
    fields = {k: rng.normal(size=v) for k, v in
              ts.grid.field_shapes().items()}
    jst = ns.FlowState(**{k: jnp.asarray(fields[k]) for k in FIELDS})
    tst = nt.state_from_numpy({k: fields[k] for k in FIELDS}, device="cpu")
    np.testing.assert_array_equal(ts.full_pressure(tst.pr).numpy(),
                                  np.asarray(js.full_pressure(jst.pr)))
    for a, b in zip(ts.gather_inner(tst), js.gather_inner(jst)):
        np.testing.assert_array_equal(a, np.asarray(b))
    # without the split both are the identity
    tm = nt.ChorinSolver(nt.preset_multi(nx=9, compat=False), device="cpu")
    assert tm.full_pressure(tst.pr) is tst.pr
