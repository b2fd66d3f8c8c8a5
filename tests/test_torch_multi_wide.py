"""The multi preset on the wide grid (511x307x307, the benchmark's
multi511.pt cell): its route, what it counts, and the benchmark's readers
of it (bench_torch/metrics/ext_roofline.py, ext.iters_per_step.py).

  * the route at 511x307x307 on 132 SMs, read from the plan functions
    without allocating the grid: no resident plan (neither K10 nor K12),
    the sweep depths (2, 3), the sweep plan s = 3 over phase 1's budget of
    83 checks of 306, and `_ext_loop`'s body is K2's chain;
  * K2's `.iterations`, one a launch or call, and the stored-state
    guarantee's `ChorinSolver.guarantee_iterations`, both cleared by
    kernels.reset_counts;
  * that route at a small grid (the sweep plan forced on, the resident
    plan off, as the wide grid has them): every Poisson iteration of a
    step is a K8 iteration, a K1 call (the warm-in's), the exact first
    iteration or a K2 call, and iters_ext is the K2 calls, the
    guarantee's included;
  * one step on that route against the plain float64 reference
    (bench_torch/reference/chorin.py) within the cell's limits;
  * the readers' arithmetic on hand-built trace summaries at 511.

At the test grids phase 1 meets the cell's eps_it = 1e-3 before its
float32 floor, so the extended phase would not run; the route's steps
lower the program's eps_it below that floor (as
tests/test_torch_resident_ext.py does), so that K2 carries the extended
phase as it does at 511."""

import dataclasses
import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import navierstokes3d_tpu_torch as nt
from navierstokes3d_tpu_torch import kernels
from navierstokes3d_tpu_torch.grid import make_grid
from navierstokes3d_tpu_torch.kernels import poisson as kp
from navierstokes3d_tpu_torch.models.chorin import ChorinSolver, sweep_depths

torch.set_num_threads(2)
BENCH = Path(__file__).resolve().parents[1] / "bench_torch"
WIDE = (511, 307, 307)
CELL = "multi511.pt"
SEED = 2**31 + 4332


def test_wide_multi_route_from_the_plans():
    """At 511x307x307 on an H100's 132 SMs: no resident plan, so phase 1
    takes the sweep plan at s = 3 (nchk 306, 83 checks, a tail of 152) and
    `_ext_loop` K2's chain, one launch an iteration."""
    cfg = nt.preset_multi(nx=511, compat=False, dtype="float32")
    g = make_grid(cfg)
    assert g.shape_c == WIDE and (g.nchk, g.niter) == (306, 25550)
    plan = kp.resident_plan(WIDE, kp.H100_SMS)
    assert plan is None and not kp.resident_ext_fits(plan)
    assert sweep_depths(g.ny, g.nz) == (2, 3)
    solver = types.SimpleNamespace(grid=g, _sweep_depths=(2, 3),
                                   _resident_plan=plan, _stall=None)
    nchunks, rem = ChorinSolver._budget(solver)
    assert (nchunks, rem) == (83, 152)
    assert ChorinSolver._sweep_plan(solver, nchunks * g.nchk) == 3
    seen = {}

    def fused(body, chain, carry, it0, n_checked, rem, eps, stall):
        seen.update(body=body, it0=it0, n_checked=n_checked, rem=rem)
    solver._fused = fused
    chain = object()
    ChorinSolver._ext_loop(solver, chain, None, 1.0, None, nchunks, rem,
                           1e-3)
    assert seen == {"body": chain, "it0": 0, "n_checked": 25398, "rem": 152}


def _pair_operator(shape=(9, 8, 7)):
    nx, ny, nz = shape
    m = {k: np.ones(n - 2) for k, n in zip(("xm", "xp", "ym", "yp", "zm",
                                            "zp"), (nx, nx, ny, ny, nz, nz))}
    m["xm"][0] = 0.0
    return kp.make_operator(
        m, types.SimpleNamespace(dx=0.1, dy=0.1, dz=0.1, dtau=0.01,
                                 damp=0.9), torch.float32, "cpu")


def test_k2_plain_counts_one_iteration_a_call():
    shape = (9, 8, 7)
    op = _pair_operator(shape)
    hi, lo, rhs = torch.rand(shape), torch.zeros(shape), torch.rand(shape)
    dpr = torch.zeros(shape)
    kernels.reset_counts()
    for check in (False, True, False):
        kp.poisson_iter_ext(hi, lo, torch.empty_like(hi),
                            torch.empty_like(hi), dpr, rhs, op, check)
    assert kp.poisson_iter_ext_plain.calls == 3
    assert kp.poisson_iter_ext_plain.iterations == 3
    # a CPU call runs the plain version: the wrapper launched nothing
    assert kp.poisson_iter_ext.launches == 0
    assert kp.poisson_iter_ext.iterations == 0


def test_reset_counts_clears_k2_and_guarantee_iterations():
    kp.poisson_iter_ext.iterations = 7
    kp.poisson_iter_ext_plain.iterations = 9
    ChorinSolver.guarantee_iterations = 306
    kernels.reset_counts()
    assert kp.poisson_iter_ext.iterations == 0
    assert kp.poisson_iter_ext_plain.iterations == 0
    assert ChorinSolver.guarantee_iterations == 0


def _wide_route(solver, eps_it):
    """The wide grid's route on a small grid: the sweep plan forced on at
    the depths a lane-tiled build offers, no resident plan, and the
    program's eps_it lowered below phase 1's float32 floor."""
    solver._sweep_depths = (2, 3)
    solver._resident_plan = None
    solver.cfg = solver.cfg.replace(numerics=dataclasses.replace(
        solver.cfg.numerics, eps_it=eps_it))


@pytest.fixture(scope="module")
def route_steps():
    """Two multi steps at nx = 31 (nchk 18: bodies of two K8(3) launches)
    on the wide route at eps_it 1e-9, where step 2's extended phase
    stalls and the stored-state guarantee runs; the counts taken per
    step."""
    solver = nt.ChorinSolver(nt.preset_multi(nx=31, compat=False,
                                             dtype="float32"), device="cpu")
    _wide_route(solver, 1e-9)
    g = solver.grid
    assert solver._sweep_plan((g.niter // g.nchk) * g.nchk) == 3
    st, out = solver.init_state(), []
    for _ in range(2):
        kernels.reset_counts()
        st, stats = solver.step(st)
        out.append((stats, kp.poisson_iter_sweeps_plain.iterations,
                    kp.poisson_iter_plain.calls,
                    kp.poisson_iter_ext_plain.calls,
                    kp.poisson_iter_ext_plain.iterations,
                    ChorinSolver.guarantee_iterations,
                    kp.poisson_iter_resident_ext_plain.calls))
    return g.nchk, out


def test_route_iterations_are_k8_k1_first_and_k2(route_steps):
    """iters = K8 iterations + K1 calls + 1 + K2 calls, and iters_ext = K2
    calls (one iteration each): the identities ext_roofline and
    ext.iters_per_step read the extended phase by."""
    _, out = route_steps
    for stats, n8, k1, k2, k2_iters, _, k12 in out:
        assert k1 == 1                 # the warm-in's K1 launch
        assert k2 == k2_iters == stats.iters_ext > 0
        assert stats.iters == n8 + k1 + 1 + k2
        assert k12 == 0


def test_route_guarantee_counts_its_chunks(route_steps):
    """Step 1's extended phase converges; step 2's stalls, and the
    guarantee adds whole check intervals of K2 iterations, counted in
    iters_ext and in its own counter."""
    nchk, ((s1, *_, g1, _), (s2, *_, g2, _)) = route_steps
    assert g1 == 0
    assert g2 > 0 and g2 % nchk == 0 and g2 < s2.iters_ext


@pytest.fixture
def bench(monkeypatch):
    """bench_torch's harness, work.py and a loader of the readers in
    bench_torch/metrics/, with the benchmark's directory on the path."""
    monkeypatch.syspath_prepend(str(BENCH))
    import harness
    import work

    def reader(name):
        spec = importlib.util.spec_from_file_location(
            "bench_metric_" + name.replace(".", "_"),
            BENCH / "metrics" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    k2 = {g["group"]: g for g in work.load_groups()}["K2 poisson_iter_ext"]
    return types.SimpleNamespace(harness=harness, work=work, reader=reader,
                                 k2=k2)


def test_route_step_against_the_reference(bench):
    """One seeded step of the cell at nx 31 on the wide route (eps_it
    1e-7: K2 runs the extended phase) against the plain float64
    reference: every number within the cell's limits (set on the card at
    511, bench_torch/limits/multi511.pt.json)."""
    h = bench.harness
    cell = h.load_cell(CELL, 31)
    cfg = cell.config
    ref = cell.reference.Reference(cfg, "cpu")
    solver = h.build_solver(cfg, cell.traffic, "cpu")
    _wide_route(solver, 1e-7)
    start = h.start_state(solver, ref, cfg, SEED, "cpu")
    kernels.reset_counts()
    new, stats = solver.step(h.copy_state(start))
    assert stats.iters_ext == kp.poisson_iter_ext_plain.calls > 0

    def physical(st):
        f = h.fields_of(st)
        f["pr"] = f["pr"].double() + (0.0 if f.get("pr_lo") is None
                                      else f["pr_lo"].double())
        return f
    nums = ref.check_step(physical(start), physical(new),
                          cell.limits["ill_ulps"])
    limits = cell.limits["limits"]
    for k, v in nums.items():
        if k in limits:
            assert v <= limits[k], (k, v, limits[k])
    assert stats.err < limits["err"]


def _trace(work, k2_launches, k2_ms):
    """A trace summary as bench_torch/tracing.py summarize makes it, with
    K2's group filled in."""
    groups = {g["group"]: {"us": 0.0, "launches": 0, "layer": g["layer"],
                           "spec": g} for g in work.load_groups()}
    groups["K2 poisson_iter_ext"].update(launches=k2_launches,
                                         us=k2_ms * 1e3)
    return {"groups": groups, "steps": []}


def _ctx(work, trace):
    return {"trace": trace, "grid": WIDE, "peaks": work.load_peaks(),
            "log": lambda *a: None}


def test_ext_roofline_bytes_bound(bench):
    """K2 moves 28 B a cell a launch: 1348.5 MB at 511, 0.4025 ms of HBM
    time at 3.35 TB/s; 1500 launches at 0.65 ms read 61.93% (the
    operations of one iteration, 47 a cell, 0.0332 ms, lie below)."""
    work = bench.work
    b = work.bytes_per_launch(bench.k2, WIDE)
    assert round(b / 1e6, 1) == 1348.5
    t_launch = b / 3.35e12
    assert work.ops_per_unit(bench.k2, WIDE) / 67e12 < t_launch
    share = bench.reader("ext_roofline").read(
        _ctx(work, _trace(work, 1500, 1500 * 0.65)))
    assert share == pytest.approx(100.0 * t_launch / 0.65e-3, rel=1e-12)
    assert 61.9 < share < 62.0


def test_ext_roofline_without_k2_is_none(bench):
    r = bench.reader("ext_roofline")
    assert r.read(_ctx(bench.work, None)) is None
    assert r.read(_ctx(bench.work, _trace(bench.work, 0, 0.0))) is None


def test_ext_iters_per_step_reads_the_whole_cycles(bench):
    """The mean over the window's whole cycles of nt = 2 steps: a last
    cycle cut after its first step is left out, unless no cycle is
    whole."""
    r = bench.reader("ext.iters_per_step")
    cell = types.SimpleNamespace(traffic={"poisson_backend": "pt"},
                                 config={"nt": 2})
    lines = []

    def steps(*ext):
        return [{"iters_ext": e, "cycle": k // 2, "j": k % 2}
                for k, e in enumerate(ext)]
    ctx = {"cell": cell, "log": lines.append,
           "window_steps": steps(2448, 3366, 2448, 3366, 2448)}
    kernels.reset_counts()
    assert r.read(ctx) == 2907.0
    assert "0 K2 iterations" in lines[-1]
    assert r.read(dict(ctx, window_steps=steps(2448))) == 2448.0
    assert r.read(dict(ctx, window_steps=[])) is None
    assert r.read(dict(ctx, window_steps=steps(None, 3366))) is None
    cell.traffic = {"poisson_backend": "fdm"}
    assert r.read(ctx) is None
