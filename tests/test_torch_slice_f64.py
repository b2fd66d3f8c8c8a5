"""The port's float64 path on the CPU against the JAX package's float64
path: preset_gpu(nx=15, float64, compat=False) under NS3D_FUSED_INTERPRET=1,
which keeps the JAX solver on the select-shift advection the port runs
(without it JAX on the CPU picks the gather method). In float64 both run
the plain folded Poisson solve with no accuracy phase.

Standard: equal iteration counts and clamp counts, and fields within
1e-9 of max|field| — all fields after step 1, pr/dprdtau/vy after step 2.
After step 2 the advected vx, vz and c may differ at O(1) where the
reference's backtrack formula is discontinuous: a departure displacement
0 < dl < ulp(idx)/2 is absorbed by idx - dl (the corner stays at idx)
while t = 1 - fmod(dl, 1) rounds to 1, so the sample jumps to the next
cell, whereas dl <= 0 keeps it; on the flow's y-symmetry plane the
advecting vy is 0 or +-1e-17 noise whose sign two correct evaluations
need not share (JAX's own jitted and op-by-op evaluations of this step
disagree there the same way). The test asserts that every such difference
sits at a point with a displacement of that size, and nowhere else."""

import jax
import numpy as np
import pytest
import torch

import navierstokes3d_tpu as ns
import navierstokes3d_tpu_torch as nt
from navierstokes3d_tpu_torch.ops import advect as adv
from navierstokes3d_tpu_torch.ops.cylinder import mask_tracer

torch.set_num_threads(2)
NX = 15
FIELDS = ("pr", "vx", "vy", "vz", "c", "dprdtau")


@pytest.fixture(scope="module")
def runs():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NS3D_FUSED_INTERPRET", "1")
        js = ns.ChorinSolver(ns.preset_gpu(nx=NX, dtype="float64",
                                           compat=False))
        assert js.advect_method == "selectshift"
        step = jax.jit(js.step)
        st = js.init_state()
        jstates, jstats = [], []
        for _ in range(2):
            st, s = step(st)
            jstates.append({k: np.asarray(getattr(st, k)) for k in FIELDS})
            jstats.append(s)
    ts = nt.ChorinSolver(nt.preset_gpu(nx=NX, dtype="float64",
                                       compat=False), device="cpu")
    st = ts.init_state()
    tstates, tstats = [st], []
    for _ in range(2):
        st, s = ts.step(st)
        tstates.append(st)
        tstats.append(s)
    return ts, jstates, jstats, tstates, tstats


def _close(got, want, msg, where=None):
    scale = max(1.0, np.abs(want).max())
    bad = np.abs(got - want) > 1e-9 * scale
    if where is not None:
        bad &= ~where
    assert not bad.any(), (msg, int(bad.sum()),
                           np.abs(got - want).max() / scale)


def test_f64_counts_match(runs):
    ts, _, jstats, _, tstats = runs
    for j, t in zip(jstats, tstats):
        assert t.iters == int(j.iters)
        assert t.advect_clamped == int(j.advect_clamped)
        assert t.iters_ext is None
        np.testing.assert_allclose(t.err, float(j.err), rtol=1e-9)
        assert t.err.dtype == np.float64


def test_f64_step1_fields_match(runs):
    _, jstates, _, tstates, _ = runs
    for k in FIELDS:
        _close(getattr(tstates[1], k).numpy(), jstates[0][k], k)


def test_f64_step2_fields_match_off_the_discontinuity(runs):
    ts, jstates, _, tstates, _ = runs
    for k in ("pr", "dprdtau", "vy"):
        _close(getattr(tstates[2], k).numpy(), jstates[1][k], k)
    # the step-2 advection inputs, rebuilt with the solver's own pieces
    prev, k = tstates[1], ts._consts
    vx, vy, vz, divv = ts._predict(prev.vx, prev.vy, prev.vz, ts.masks, k)
    pr, _, _ = ts.poisson_solve(prev.pr, prev.dprdtau, divv)
    vx, vy, vz = ts._correct(vx, vy, vz, pr, ts.masks, k)
    exempt_total = 0
    for branch in ("vx", "vz", "c"):
        vals = adv.face_velocities(branch, vx, vy, vz)
        tiny = None
        for v, h in zip(vals, (k.dx, k.dy, k.dz)):
            dl = np.abs((k.dt * v / h).numpy())
            t = dl < 1e-12
            tiny = t if tiny is None else tiny | t
        start = adv._STARTS[branch]
        where = np.zeros(jstates[1][branch].shape, bool)
        where[start[0] - 1:start[0] - 1 + tiny.shape[0],
              start[1] - 1:start[1] - 1 + tiny.shape[1],
              start[2] - 1:start[2] - 1 + tiny.shape[2]] = tiny
        exempt_total += int(where.sum())
        _close(getattr(tstates[2], branch).numpy(), jstates[1][branch],
               branch, where=where)
    # the exemption covers a thin set of points (the symmetry plane)
    assert 0 < exempt_total < 0.2 * tstates[2].c.numel() * 3


def test_tracer_mask_is_idempotent():
    """The step sets C's seed ring once, before the solve (the JAX chained
    step's order); setting it again after the corrector, as the unchained
    JAX step does, changes nothing."""
    ts = nt.ChorinSolver(nt.preset_gpu(nx=NX, dtype="float64",
                                       compat=False), device="cpu")
    c = torch.rand(ts.grid.shape_c, dtype=torch.float64)
    once = mask_tracer(c, ts.masks)
    assert torch.equal(mask_tracer(once, ts.masks), once)


@pytest.fixture(scope="module")
def multi_runs():
    """Two steps of the multi preset in float64 in both packages (the
    plain folded solve with the x-lo zero-gradient operator)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NS3D_FUSED_INTERPRET", "1")
        js = ns.ChorinSolver(ns.preset_multi(nx=NX, dtype="float64",
                                             compat=False))
        assert js.advect_method == "selectshift" and not js.extended
        step = jax.jit(js.step)
        st = js.init_state()
        jstates, jstats = [], []
        for _ in range(2):
            st, s = step(st)
            jstates.append({k: np.asarray(getattr(st, k)) for k in FIELDS})
            jstats.append(s)
    ts = nt.ChorinSolver(nt.preset_multi(nx=NX, dtype="float64",
                                         compat=False), device="cpu")
    st = ts.init_state()
    tstates, tstats = [], []
    for _ in range(2):
        st, s = ts.step(st)
        tstates.append(st)
        tstats.append(s)
    return jstates, jstats, tstates, tstats


def test_f64_multi_matches(multi_runs):
    """Equal iteration and clamp counts and err; every field within 1e-9
    of its max after step 1, pr and dprdtau after step 2."""
    jstates, jstats, tstates, tstats = multi_runs
    for j, t in zip(jstats, tstats):
        assert t.iters == int(j.iters)
        assert t.advect_clamped == int(j.advect_clamped)
        assert t.iters_ext is None and t.pr_lo is None
        np.testing.assert_allclose(t.err, float(j.err), rtol=1e-9)
    for k in FIELDS:
        _close(getattr(tstates[0], k).numpy(), jstates[0][k], k)
    for k in ("pr", "dprdtau"):
        _close(getattr(tstates[1], k).numpy(), jstates[1][k], k)


@pytest.mark.parametrize("make", [nt.preset_gpu, nt.preset_multi])
def test_f64_routes_to_the_plain_versions_on_any_device(make):
    """The dtype rule (models/chorin.py `uses_kernels`, the JAX package's:
    its Pallas kernels are float32-only): a float64 solver on a device
    other than the CPU is built without error and routes the predictor,
    the corrector, every Poisson iteration, the advection (`plain`) and
    the distributed solves to the plain versions, with the plain folded
    solve and no accuracy phase; a float32 one routes to the kernel
    wrappers. Built on the meta device: no card, no allocation."""
    from navierstokes3d_tpu_torch.kernels import fused_step as k_step
    from navierstokes3d_tpu_torch.kernels import poisson as kp
    from navierstokes3d_tpu_torch.models.chorin import uses_kernels
    from navierstokes3d_tpu_torch.parallel import make_mesh
    mesh = make_mesh((3, 1, 1), "cpu")
    f64 = nt.ChorinSolver(make(nx=NX, dtype="float64", compat=False),
                          device="meta")
    f32 = nt.ChorinSolver(make(nx=NX, dtype="float32", compat=False),
                          device="meta")
    assert not uses_kernels(f64.cfg) and uses_kernels(f32.cfg)
    routes = ("_predict", "_correct", "_poisson_iter", "_poisson_iter_sweeps",
              "_poisson_iter_ext", "_poisson_iter_bc")
    plain = (k_step.predict_plain, k_step.correct_plain,
             kp.poisson_iter_plain, kp.poisson_iter_sweeps_plain,
             kp.poisson_iter_ext_plain, kp.poisson_iter_bc_plain)
    wrappers = (k_step.predict, k_step.correct, kp.poisson_iter,
                kp.poisson_iter_sweeps, kp.poisson_iter_ext,
                kp.poisson_iter_bc)
    assert tuple(getattr(f64, r) for r in routes) == plain
    assert tuple(getattr(f32, r) for r in routes) == wrappers
    assert f64.plain and not f32.plain    # k_advect.advect's `plain`
    assert not f64._dist_kernels(mesh) and f32._dist_kernels(mesh)
    assert f64.acc == "none" and not f64.extended and f64._bc_op is None
    assert f32.acc in ("defect", "extended")


def test_f64_multi63_counts_are_chip_smokes_reference():
    """chip_smoke.py's float64 phase holds the card's preset_multi(nx=63,
    float64) run against REF_ITERS_F64_63: here both packages' CPU runs
    (the JAX package with select-shift advection) take exactly those
    iterations over 8 steps from init_state, with no clamp."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    want = list(smoke.REF_ITERS_F64_63)
    nx, nsteps = smoke.MULTI_NX_SMALL, smoke.F64_STEPS
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NS3D_FUSED_INTERPRET", "1")
        js = ns.ChorinSolver(ns.preset_multi(nx=nx, dtype="float64",
                                             compat=False))
        assert js.advect_method == "selectshift"
        step = jax.jit(js.step)
        st, got = js.init_state(), []
        for _ in range(nsteps):
            st, s = step(st)
            got.append((int(s.iters), int(s.advect_clamped)))
    assert got == [(n, 0) for n in want]
    ts = nt.ChorinSolver(nt.preset_multi(nx=nx, dtype="float64",
                                         compat=False), device="cpu")
    st, got = ts.init_state(), []
    for _ in range(nsteps):
        st, s = ts.step(st)
        got.append((s.iters, s.advect_clamped))
    assert got == [(n, 0) for n in want]
