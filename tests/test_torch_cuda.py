"""The port's CUDA kernels on the card against their plain PyTorch versions
(small grids; chip_smoke.py covers the 255x153x153 main path).

Marked `cuda`: each test skips, with its reason, where no CUDA device is
present (decided inside the test, never at import). On a machine with a
card, run them as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(tests/conftest.py configures jax for the CPU suite). Both sides round
every operation in float32 in the same order (the kernels are built with
--fmad=false), so the expected difference is zero."""

import dataclasses
import functools
import math
import types

import numpy as np
import pytest
import torch

import advect_faults
import navierstokes3d_tpu_torch as nt
from navierstokes3d_tpu_torch import kernels, ptloop
from navierstokes3d_tpu_torch.kernels import _build
from navierstokes3d_tpu_torch.kernels import advect as ka
from navierstokes3d_tpu_torch.kernels import fused_step as kf
from navierstokes3d_tpu_torch.kernels import poisson as kp
from navierstokes3d_tpu_torch.ops import ds

pytestmark = pytest.mark.cuda


def _solver(nx, preset="gpu"):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    make = nt.preset_gpu if preset == "gpu" else nt.preset_multi
    return nt.ChorinSolver(make(nx=nx, compat=False, dtype="float32"),
                           device="cuda")


@pytest.fixture
def solver():
    return _solver(17)


@pytest.fixture
def multi():
    return _solver(17, "multi")


def _rand(rng, shape, scale=1.0):
    return torch.tensor(rng.normal(size=shape).astype(np.float32) * scale,
                        device="cuda")


def test_k1_matches_plain(solver):
    g, rng = solver.grid, np.random.default_rng(0)
    pr = solver.set_bc_pr(_rand(rng, g.shape_c, 100.0))
    rhs = _rand(rng, g.shape_c, 1e5)
    dpr = torch.zeros_like(pr)
    dpr[1:-1, 1:-1, 1:-1] = _rand(rng, (g.nx - 2, g.ny - 2, g.nz - 2), 1e3)
    for check in (False, True):
        pa, da = torch.empty_like(pr), dpr.clone()
        pb, db = torch.empty_like(pr), dpr.clone()
        ea = kp.poisson_iter(pr, pa, da, rhs, solver._op, check)
        eb = kp.poisson_iter_plain(pr, pb, db, rhs, solver._op, check)
        assert torch.equal(pa, pb) and torch.equal(da, db)
        if check:
            assert float(ea) == float(eb)


def test_k1_multi_operator_matches_plain(multi):
    test_k1_matches_plain(multi)


@pytest.mark.parametrize("preset", ["gpu", "multi"])
@pytest.mark.parametrize("s", [2, 3, 4])
def test_k8_matches_k1_launches_and_plain(preset, s):
    """K8 at 64x39x39 (2 x-segments, 3 y-tiles, 2 z-tiles of blocks):
    bitwise equal to s K1 launches and to its plain version, the check
    value equal to the last K1 launch's, every cell of both outputs
    written."""
    solver = _solver(64, preset)
    g, rng = solver.grid, np.random.default_rng(6)
    pr = solver.set_bc_pr(_rand(rng, g.shape_c, 100.0))
    rhs = _rand(rng, g.shape_c, 1e5)
    dpr = torch.zeros_like(pr)
    dpr[1:-1, 1:-1, 1:-1] = _rand(rng, (g.nx - 2, g.ny - 2, g.nz - 2), 1e3)
    op = solver._op
    for check in (False, True):
        po, do = (torch.full_like(pr, float("nan")) for _ in range(2))
        ek = kp.poisson_iter_sweeps(pr, dpr, rhs, po, do, op, s, check)
        p, d, e1 = pr.clone(), dpr.clone(), None
        for j in range(s):
            q = torch.empty_like(pr)
            e1 = kp.poisson_iter(p, q, d, rhs, op, check and j == s - 1)
            p = q
        pp, dp = torch.empty_like(pr), torch.empty_like(pr)
        ep = kp.poisson_iter_sweeps_plain(pr, dpr, rhs, pp, dp, op, s, check)
        assert torch.equal(po.view(torch.int32), p.view(torch.int32))
        assert torch.equal(do.view(torch.int32), d.view(torch.int32))
        assert torch.equal(po, pp) and torch.equal(do, dp)
        if check:
            assert float(ek) == float(e1) == float(ep)
    with pytest.raises(ValueError, match="alias"):
        kp.poisson_iter_sweeps(pr, dpr, rhs, pr, do, op, s, False)


def _sweep_operator(shape, zero_grad_x):
    """The folded operator on any grid: y and z zero-gradient at both
    ends, x-hi Dirichlet, x-lo Dirichlet (the gpu operator) or
    zero-gradient (zero_grad_x, the multi one)."""
    nx, ny, nz = shape
    m = {k: np.ones(n - 2) for k, n in zip(("xm", "xp", "ym", "yp", "zm",
                                            "zp"), (nx, nx, ny, ny, nz, nz))}
    m["ym"][0] = m["yp"][-1] = m["zm"][0] = m["zp"][-1] = 0.0
    if zero_grad_x:
        m["xm"][0] = 0.0
    grid = types.SimpleNamespace(dx=0.1, dy=0.13, dz=0.07, dtau=0.01,
                                 damp=0.9)
    return kp.make_operator(m, grid, torch.float32, "cuda")


def _check_k8(shape, s, zero_grad_x, plan=None, seed=7):
    """K8 (under `plan`, or the wrapper's own) on seeded inputs with
    NaN-filled outputs: pr_out and dpr_out bitwise equal to s K1 launches
    and to the plain version, the check value equal to both."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    op = _sweep_operator(shape, zero_grad_x)
    rng = np.random.default_rng(seed)
    nx, ny, nz = shape
    pr = _rand(rng, shape, 50.0)
    rhs = _rand(rng, shape, 1e5)
    dpr = torch.zeros_like(pr)
    dpr[1:-1, 1:-1, 1:-1] = _rand(rng, (nx - 2, ny - 2, nz - 2), 1e3)
    for check in (False, True):
        po, do = (torch.full_like(pr, float("nan")) for _ in range(2))
        if plan is None:
            ek = kp.poisson_iter_sweeps(pr, dpr, rhs, po, do, op, s, check)
        else:
            ek = kp.launch_sweeps(pr, dpr, rhs, po, do, op, plan, check)
        p, d, e1 = pr.clone(), dpr.clone(), None
        for j in range(s):
            q = torch.empty_like(pr)
            e1 = kp.poisson_iter(p, q, d, rhs, op, check and j == s - 1)
            p = q
        pp, dp = torch.empty_like(pr), torch.empty_like(pr)
        ep = kp.poisson_iter_sweeps_plain(pr, dpr, rhs, pp, dp, op, s, check)
        assert torch.equal(po.view(torch.int32), p.view(torch.int32))
        assert torch.equal(do.view(torch.int32), d.view(torch.int32))
        assert torch.equal(po.view(torch.int32), pp.view(torch.int32))
        assert torch.equal(do.view(torch.int32), dp.view(torch.int32))
        if check:
            assert float(ek) == float(e1) == float(ep)


def _forced_plan(shape, s, uy, uz, seg):
    nx, ny, nz = shape
    return kp.SweepPlan(s, uy, uz, -(-ny // uy), -(-nz // uz), seg,
                        -(-nx // seg))


# K8's tile edges, each a grid and a plan: ny and nz one more than a
# multiple of the tile (the last tile one row and one lane wide) with
# three x segments, the last short; an x segment longer than nx; nx =
# 2s + 1 under the wrapper's own plan; rows of tiles wider than a warp.
# Then the edges of the run map (a thread owns 4 z-consecutive cells of a
# region row, the row padded to whole runs): a region width (uz + 2s) 1, 2
# and 3 past a multiple of 4; the domain's last z lane the third cell of
# a run (zc 6 of the last tile's region); a tile one lane wide
K8_EDGES = {
    "yz_one_past": lambda s: ((20, 3 * 6 + 1, 2 * 10 + 1),
                              dict(uy=6, uz=10, seg=8)),
    "seg_past_nx": lambda s: ((9, 17, 23), dict(uy=5, uz=7, seg=16)),
    "nx_2s_plus_1": lambda s: ((2 * s + 1, 19, 21), None),
    "long_rows": lambda s: ((30, 25, 70), dict(uy=9, uz=33, seg=11)),
    "w_1_past_run": lambda s: ((12, 14, 2 * (13 - 2 * s) + 3),
                               dict(uy=5, uz=13 - 2 * s, seg=5)),
    "w_2_past_run": lambda s: ((12, 14, 2 * (14 - 2 * s) + 3),
                               dict(uy=5, uz=14 - 2 * s, seg=5)),
    "w_3_past_run": lambda s: ((12, 14, 2 * (15 - 2 * s) + 3),
                               dict(uy=5, uz=15 - 2 * s, seg=5)),
    "last_lane_in_run": lambda s: ((10, 11, 19 - s),
                                   dict(uy=4, uz=6, seg=4)),
    "one_lane_tile": lambda s: ((8, 9, 5), dict(uy=4, uz=1, seg=3)),
}


@pytest.mark.parametrize("zero_grad_x", [False, True], ids=["gpu", "multi"])
@pytest.mark.parametrize("s", [2, 3, 4])
@pytest.mark.parametrize("edge", sorted(K8_EDGES))
def test_k8_tile_edges(edge, s, zero_grad_x):
    shape, kw = K8_EDGES[edge](s)
    plan = None if kw is None else _forced_plan(shape, s, **kw)
    _check_k8(shape, s, zero_grad_x, plan)


@pytest.mark.parametrize("zero_grad_x", [False, True], ids=["gpu", "multi"])
@pytest.mark.parametrize("s", [2, 3, 4])
def test_k8_wide_grid(s, zero_grad_x):
    """The wide grid 511x307x307 under the wrapper's plan (one wave)."""
    _check_k8((511, 307, 307), s, zero_grad_x)


def _check_k2(multi, seed):
    """K2 under the multi solver's operator on seeded inputs, NaN in its
    outputs: hi_out, lo_out, dpr and the check value bitwise its plain
    version's, with and without the check flag."""
    g, rng = multi.grid, np.random.default_rng(seed)
    hi = multi.set_bc_pr(_rand(rng, g.shape_c, 50.0))
    lo = _rand(rng, g.shape_c, 50.0 * 2.0 ** -24)
    rhs = _rand(rng, g.shape_c, 1e5)
    dpr = torch.zeros_like(hi)
    dpr[1:-1, 1:-1, 1:-1] = _rand(rng, (g.nx - 2, g.ny - 2, g.nz - 2), 1e3)
    for check in (False, True):
        a = [torch.full_like(hi, float("nan")) for _ in range(2)]
        b = [torch.empty_like(hi) for _ in range(2)]
        da, db = dpr.clone(), dpr.clone()
        ea = kp.poisson_iter_ext(hi, lo, *a, da, rhs, multi._op, check)
        eb = kp.poisson_iter_ext_plain(hi, lo, *b, db, rhs, multi._op, check)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        assert torch.equal(da, db)
        if check:
            assert float(ea) == float(eb)


def test_k2_matches_plain(multi):
    _check_k2(multi, 3)


def test_k2_wide_grid_multi_operator():
    """K2 at 511x307x307 under the multi preset's operator (the extended
    phase's kernel there, where no resident plan fits)."""
    multi = _solver(511, "multi")
    assert kp.resident_plan(multi.grid.shape_c,
                            kp.resident_sms(multi.device)) is None
    _check_k2(multi, 5)


@pytest.mark.parametrize("variant,split", [("multi", False),
                                           ("gpu", False), ("gpu", True)])
def test_k7_matches_plain(variant, split):
    """K7 with each BC spec (the multi, the unsplit gpu and the split gpu
    one, whose z constants are nonzero): both outputs bitwise, every cell
    written."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    make = nt.preset_gpu if variant == "gpu" else nt.preset_multi
    cfg = make(nx=17, dtype="float32")
    g = nt.make_grid(cfg)
    op = kp.make_bc_operator(kp.poisson_bc_spec(variant, g, cfg.physics,
                                                split), g, "cuda")
    rng = np.random.default_rng(5)
    pr = _rand(rng, g.shape_c, 50.0)
    rhs = _rand(rng, g.shape_c, 1e5)
    dpr = torch.zeros_like(pr)
    dpr[1:-1, 1:-1, 1:-1] = _rand(rng, (g.nx - 2, g.ny - 2, g.nz - 2), 1e3)
    a = [torch.full_like(pr, float("nan")) for _ in range(2)]
    b = [torch.empty_like(pr) for _ in range(2)]
    kp.poisson_iter_bc(pr, dpr, rhs, *a, op)
    kp.poisson_iter_bc_plain(pr, dpr, rhs, *b, op)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_k4_multi_matches_plain(multi):
    g, rng, k = multi.grid, np.random.default_rng(4), multi._consts
    v = [_rand(rng, s) for s in (g.shape_vx, g.shape_vy, g.shape_vz)]
    pr = _rand(rng, g.shape_c, 50.0)
    a = kf.correct(*v, pr, multi.masks, k)
    for x, y in zip(a, kf.correct_plain(*v, pr, multi.masks, k)):
        assert torch.equal(x, y)
    assert bool((a[0][0] == multi.cfg.physics.vin).all())


def test_k3_k4_match_plain(solver):
    g, rng, k = solver.grid, np.random.default_rng(1), solver._consts
    v = [_rand(rng, s) for s in (g.shape_vx, g.shape_vy, g.shape_vz)]
    pr = _rand(rng, g.shape_c, 50.0)
    for a, b in zip(kf.predict(*v, solver.masks, k),
                    kf.predict_plain(*v, solver.masks, k)):
        assert torch.equal(a, b)
    for a, b in zip(kf.correct(*v, pr, solver.masks, k),
                    kf.correct_plain(*v, pr, solver.masks, k)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("scale", [0.25, 3.0])
def test_k5_matches_plain(solver, scale):
    g, rng = solver.grid, np.random.default_rng(2)
    v = [_rand(rng, s, scale) for s in (g.shape_vx, g.shape_vy, g.shape_vz)]
    c = torch.rand(g.shape_c, device="cuda")
    a = ka.advect(*v, c, solver._consts, 2)
    b = ka.advect(*v, c, solver._consts, 2, plain=True)
    for x, y in zip(a[:4], b[:4]):
        assert torch.equal(x, y)
    assert int(a[4].item()) == int(b[4].item())
    assert (int(a[4].item()) > 0) == (scale > 1.0)


@pytest.fixture
def nan_outputs(monkeypatch):
    """New float tensors from torch.empty / empty_like start as NaN, so an
    output cell a kernel leaves unwritten shows."""
    empty, empty_like = torch.empty, torch.empty_like

    def nan(t):
        return t.fill_(float("nan")) if t.is_floating_point() else t
    monkeypatch.setattr(torch, "empty", lambda *a, **kw: nan(empty(*a, **kw)))
    monkeypatch.setattr(torch, "empty_like",
                        lambda *a, **kw: nan(empty_like(*a, **kw)))


def _bitwise(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _k3_inputs(shape, seed, preset=None):
    """Seeded velocities and either a preset solver's masks and constants
    at `shape` (nx of the preset) or random masks with its constants."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    nx, ny, nz = shape
    rng = np.random.default_rng(seed)
    v = [_rand(rng, s) for s in ((nx + 1, ny, nz), (nx, ny + 1, nz),
                                 (nx, ny, nz + 1))]
    if preset is not None:
        s = _solver(nx, preset)
        assert (s.grid.nx, s.grid.ny, s.grid.nz) == shape
        return v, s.masks, s._consts

    def mask(*sh):
        return torch.tensor(rng.uniform(size=sh) < 0.2, device="cuda")
    masks = types.SimpleNamespace(mask_vx=mask(nx + 1, ny),
                                  mask_vy=mask(nx, ny + 1),
                                  mask_vz=mask(nx, ny), mask_c=mask(nx, ny))
    k = kf.StepConsts(dt=0.0137, dx=0.1, dy=0.07, dz=0.09, mu=3e-3,
                      rho=1.0, g_eff=9.81, variant="gpu", vin=1.0)
    return v, masks, k


def _check_k3(v, masks, k):
    a = kf.predict(*v, masks, k)
    b = kf.predict_plain(*v, masks, k)
    for name, x, y in zip(("vx*", "vy*", "vz*", "divv"), a, b):
        assert _bitwise(x, y), name


# K3's tile is 14 x 30 points of the (nx+1, ny+1, nz+1) union grid: shapes
# whose union ends one past a tile multiple, exactly on one, nx = 3, and
# plans of one plane per segment, segments longer than nx and ragged ones
K3_EDGES = {
    "ragged": ((9, 28, 60), None),
    "exact": ((13, 27, 59), None),
    "nx3": ((3, 14, 30), None),
    "seg_longer_than_nx": ((5, 13, 29), (64, 1)),
    "ragged_segments": ((12, 28, 60), (5, 3)),
    "one_plane_segments": ((6, 15, 31), (1, 7)),
}


@pytest.mark.parametrize("edge", sorted(K3_EDGES))
def test_k3_tile_edges_bitwise(edge, nan_outputs, monkeypatch):
    """K3 with NaN-filled outputs, bitwise equal to predict_plain on all
    four outputs, with a nonzero g_eff, at ragged tiles and x segments."""
    shape, forced = K3_EDGES[edge]
    v, masks, k = _k3_inputs(shape, 11)
    if forced is not None:
        nx, ny, nz = shape
        seg, segs = forced
        plan = kf.PredictPlan(-(-(ny + 1) // kf.PREDICT_TILE_Y),
                              -(-(nz + 1) // kf.PREDICT_TILE_Z), seg, segs)
        monkeypatch.setattr(kf, "predict_plan", lambda shape, sms: plan)
    _check_k3(v, masks, k)


@pytest.mark.parametrize("preset,nx", [("gpu", 17), ("multi", 17),
                                       ("gpu", 255), ("multi", 255),
                                       ("gpu", 511)])
def test_k3_presets_bitwise(preset, nx, nan_outputs):
    """K3 with each preset's masks and constants (gpu: g_eff 0 under the
    split; multi: g = 0), and with a nonzero g_eff, at a small grid, the
    main paths' 255x153x153 and the wide grid's 511x307x307."""
    s = _solver(nx, preset)
    g = s.grid
    v, masks, k = _k3_inputs((g.nx, g.ny, g.nz), 12, preset)
    _check_k3(v, masks, k)
    _check_k3(v, masks, dataclasses.replace(k, g_eff=9.81))


@pytest.mark.parametrize("window", [2, 3])
@pytest.mark.parametrize("scale", [0.25, 3.0])
def test_k5_one_launch_and_branches_bitwise(solver, scale, window,
                                            nan_outputs):
    """K5's one launch and its one-branch launches, NaN-filled outputs:
    each of the four fields bitwise equal to advect_branch_plain, the
    clamp counts equal, with and without clamped points."""
    g, rng = solver.grid, np.random.default_rng(5)
    v = [_rand(rng, s, scale) for s in (g.shape_vx, g.shape_vy, g.shape_vz)]
    c = torch.tensor(rng.uniform(size=g.shape_c).astype(np.float32),
                     device="cuda")
    k = solver._consts
    kernels.reset_counts()
    a = ka.advect(*v, c, k, window)
    assert ka.advect.launches == 1 and ka.advect_branch.launches == 0
    n1 = torch.zeros((1,), dtype=torch.int32, device="cuda")
    n_plain = 0
    for name, f, out in zip(("vx", "vy", "vz", "c"), (*v, c), a[:4]):
        one = ka.advect_branch(name, f, *v, k, window, n1)
        ref, ncl = ka.advect_branch_plain(name, f, *v, k, window)
        n_plain += int(ncl)
        assert _bitwise(out, ref) and _bitwise(one, ref), name
    assert int(a[4].item()) == int(n1.item()) == n_plain
    assert (n_plain > 0) == (scale > 1.0)


@pytest.mark.parametrize("preset", ["gpu", "multi"])
def test_step_on_card_matches_cpu(preset):
    """Two steps at nx=15 (the gpu preset diverges at nx=17 and 24 in the
    JAX package too): every field bitwise equal to the CPU run. The multi
    preset runs at eps_it=1e-9, where K2 carries every solve."""
    solver = _solver(15, preset)
    if preset == "multi":
        cfg = solver.cfg
        solver = nt.ChorinSolver(cfg.replace(numerics=dataclasses.replace(
            cfg.numerics, eps_it=1e-9)), device="cuda")
    kernels.reset_counts()
    cpu = nt.ChorinSolver(solver.cfg, device="cpu")
    a, b = solver.init_state(), cpu.init_state()
    for _ in range(2):
        a, sa = solver.step(a)
        b, sb = cpu.step(b)
        assert (sa.iters, sa.iters_ext, sa.advect_clamped) == (
            sb.iters, sb.iters_ext, sb.advect_clamped)
        for name in ("pr", "vx", "vy", "vz", "c", "dprdtau", "pr_lo"):
            assert torch.equal(getattr(a, name).cpu(), getattr(b, name))
    # nx=15 is no wide grid: the sweep plan is off and K8 does not launch;
    # the folded loops run one K10 launch a loop and the
    # extended phase one K12 launch (no K1 or K2 runs: no solve exhausts
    # its budget or exits marginally); K7 (compat) and the dist kernels
    # (sharded solves) are off this path
    # the gpu preset's defect phase runs K13's single word once a step;
    # its pair form launches where the CPU run took the stored-state
    # guarantee (its plain version's calls)
    on_path = {"K10", "K3", "K4", "K5"} | ({"K12"} if preset == "multi"
                                           else {"K13"})
    if kp.pair_residual_plain.calls:
        on_path.add("K13-pair")
    assert kp.compensated_residual.launches == \
        kp.compensated_residual_plain.calls
    assert kp.pair_residual.launches == kp.pair_residual_plain.calls
    for k in kernels.KERNELS:
        assert ((k.wrapper.launches > 0)
                == (k.name.split()[0] in on_path)), k.name


@pytest.mark.parametrize("preset", ["gpu", "multi"])
def test_sweep_plan_step_on_card_matches_cpu(preset):
    """Two steps at nx=15 with the sweep plan forced on (s=2, the depths
    the JAX package's lane-tiled build offers): K8 launches, and every
    field is bitwise equal to the CPU run and to the card's run with the
    plan off."""
    solver = _solver(15, preset)
    cpu = nt.ChorinSolver(solver.cfg, device="cpu")
    off = nt.ChorinSolver(solver.cfg, device="cuda")
    solver._sweep_depths = cpu._sweep_depths = (2, 3)
    assert off._sweep_depths == ()
    kernels.reset_counts()
    a, b, c = solver.init_state(), cpu.init_state(), off.init_state()
    for _ in range(2):
        a, sa = solver.step(a)
        b, sb = cpu.step(b)
        c, sc = off.step(c)
        assert ((sa.iters, sa.iters_ext) == (sb.iters, sb.iters_ext)
                == (sc.iters, sc.iters_ext))
        for name in ("pr", "vx", "vy", "vz", "c", "dprdtau", "pr_lo"):
            assert torch.equal(getattr(a, name).cpu(), getattr(b, name))
            assert torch.equal(getattr(a, name), getattr(c, name))
    k8 = next(k for k in kernels.KERNELS if k.name == "K8 poisson_iter_sweeps")
    assert k8.wrapper.launches > 0


def test_wide_grid_step_runs_on_k8():
    """One gpu step at 511x307x307 on the normal path: the sweep plan is on
    at s = 3, and K8 carries over 99% of the step's Poisson iterations by
    its wrapper's counter; the rest are K1 launches (the warm-in's one,
    the guarantee's) and the exact first iteration. No resident kernel
    and no K2 launch."""
    solver = _solver(511)
    g = solver.grid
    assert solver._sweep_plan((g.niter // g.nchk) * g.nchk) == 3
    kernels.reset_counts()
    st, stats = solver.step(solver.init_state())
    n8 = kp.poisson_iter_sweeps.iterations
    assert n8 == 3 * kp.poisson_iter_sweeps.launches - 2   # two K8(2)
    assert n8 == stats.iters - kp.poisson_iter.launches - 1
    assert n8 > 0.99 * stats.iters
    assert stats.err < 1e-3 and bool(torch.isfinite(st.pr).all())
    for k in (kp.poisson_iter_resident, kp.poisson_iter_resident_ext,
              kp.poisson_iter_ext):
        assert k.launches == 0


def test_wide_grid_multi_step_runs_on_k8_and_k2():
    """One multi step at 511x307x307 on the normal path: phase 1 on the
    sweep plan at s = 3, the extended phase on K2, one launch an
    iteration: iters = K8 iterations + K1 launches + 1 + K2 launches, and
    iters_ext = K2 launches (the guarantee's included). No resident
    kernel."""
    solver = _solver(511, "multi")
    g = solver.grid
    assert solver._resident_plan is None
    assert solver._sweep_plan((g.niter // g.nchk) * g.nchk) == 3
    kernels.reset_counts()
    st, stats = solver.step(solver.init_state())
    n8, n2 = kp.poisson_iter_sweeps.iterations, kp.poisson_iter_ext.launches
    assert n8 == 3 * kp.poisson_iter_sweeps.launches - 2   # two K8(2)
    assert stats.iters_ext == n2 == kp.poisson_iter_ext.iterations > 0
    assert stats.iters == n8 + kp.poisson_iter.launches + 1 + n2
    assert stats.err < 1e-3 and bool(torch.isfinite(st.pr).all())
    for k in (kp.poisson_iter_resident, kp.poisson_iter_resident_ext):
        assert k.launches == 0


@pytest.mark.parametrize("preset", ["gpu", "multi"])
def test_compat_step_on_card_matches_cpu(preset):
    """Two compat float32 steps at nx=15: K7 is the only kernel launched,
    and every field is bitwise equal to the CPU run (the torch ops of the
    compat chain round alike on both devices)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    make = nt.preset_gpu if preset == "gpu" else nt.preset_multi
    cfg = make(nx=15, dtype="float32")
    kernels.reset_counts()
    card = nt.ChorinSolver(cfg, device="cuda")
    cpu = nt.ChorinSolver(cfg, device="cpu")
    a, b = card.init_state(), cpu.init_state()
    for _ in range(2):
        a, sa = card.step(a)
        b, sb = cpu.step(b)
        assert sa.iters == sb.iters
        for name in ("pr", "vx", "vy", "vz", "c", "dprdtau"):
            assert torch.equal(getattr(a, name).cpu(), getattr(b, name))
    for k in kernels.KERNELS:
        assert (k.wrapper.launches > 0) == (k.name == "K7 poisson_iter_bc")


def _dist_inputs(variant, split, shape, seed=7):
    """A BC operator of the preset `variant` on a grid of `shape` and
    seeded (pr, lo, dpr, rhs) on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    nx, ny, nz = shape
    make = nt.preset_gpu if variant == "gpu" else nt.preset_multi
    cfg = make(nx=nx, dtype="float32")
    cfg = cfg.replace(numerics=dataclasses.replace(
        cfg.numerics, ny_override=ny, nz_override=nz))
    g = nt.make_grid(cfg)
    assert g.shape_c == shape
    op = kp.make_bc_operator(kp.poisson_bc_spec(variant, g, cfg.physics,
                                                split), g, "cuda")
    rng = np.random.default_rng(seed)
    pr = _rand(rng, shape, 50.0)
    lo = _rand(rng, shape, 50.0 * 2.0 ** -24)
    rhs = _rand(rng, shape, 1e5)
    dpr = torch.zeros_like(pr)
    dpr[1:-1, 1:-1, 1:-1] = _rand(rng, (nx - 2, ny - 2, nz - 2), 1e3)
    return op, (pr, lo, dpr, rhs)


def _check_dist_shards(op, fields, nshards):
    """K7-dist and K2-dist on every one of `nshards` shards of bx = nx //
    nshards planes (and on the last bx planes, where bx does not divide
    nx), with and without the check: NaN-filled outputs and every output
    bitwise equal to the plain versions', the check values equal."""
    pr, lo, dpr, rhs = fields
    nx = pr.shape[0]
    bx = nx // nshards
    for x0 in sorted({*range(0, nx - bx + 1, bx), nx - bx}):
        x1 = x0 + bx
        sl = slice(x0, x1)
        halo = [(f[x0 - 1] if x0 else None, f[x1] if x1 < nx else None)
                for f in (pr, lo)]
        for check in (False, True):
            a = [torch.full_like(pr[sl], float("nan")) for _ in range(2)]
            b = [torch.full_like(pr[sl], float("nan")) for _ in range(2)]
            ea = kp.poisson_iter_bc_dist(pr[sl], dpr[sl], rhs[sl], *a,
                                         *halo[0], x0, op, check)
            eb = kp.poisson_iter_bc_dist_plain(pr[sl], dpr[sl], rhs[sl], *b,
                                               *halo[0], x0, op, check)
            assert all(_bitwise(x, y) for x, y in zip(a, b)), (nshards, x0)
            a = [torch.full_like(pr[sl], float("nan")) for _ in range(3)]
            b = [torch.full_like(pr[sl], float("nan")) for _ in range(3)]
            fa = kp.poisson_iter_ext_bc_dist(
                pr[sl], lo[sl], dpr[sl], rhs[sl], *a, *halo[0], *halo[1],
                x0, op, check)
            fb = kp.poisson_iter_ext_bc_dist_plain(
                pr[sl], lo[sl], dpr[sl], rhs[sl], *b, *halo[0], *halo[1],
                x0, op, check)
            assert all(_bitwise(x, y) for x, y in zip(a, b)), (nshards, x0)
            if check:
                assert float(ea) == float(eb) and float(fa) == float(fb)


# the dist kernels' grids: ragged tiles (24 rows in two tiles of 12, 37
# lanes in 19 + 18), ny and nz one past a tile multiple (15 = 14 + 1,
# 31 = 30 + 1) and one past two (29, 61)
DIST_SHAPES = [(40, 24, 37), (20, 15, 31), (12, 29, 61)]


@pytest.mark.parametrize("shape", DIST_SHAPES,
                         ids=lambda t: "x".join(map(str, t)))
@pytest.mark.parametrize("variant,split", [("multi", False),
                                           ("gpu", False), ("gpu", True)])
def test_dist_kernels_match_plain(variant, split, shape):
    """K7-dist and K2-dist under their plan over 1, 2, 3, 4, 6 and 20
    shards (where a shard keeps two planes): every shard bitwise equal to
    the plain versions, check values equal."""
    op, fields = _dist_inputs(variant, split, shape)
    for nshards in (1, 2, 3, 4, 6, 20):
        if shape[0] // nshards >= 2:
            _check_dist_shards(op, fields, nshards)
    pr, _, dpr, rhs = fields
    with pytest.raises(ValueError, match="halo plane"):
        kp.poisson_iter_bc_dist(pr[4:8], dpr[4:8], rhs[4:8],
                                *(torch.empty_like(pr[:4]) for _ in
                                  range(2)), None, pr[8], 4, op, False)


@pytest.mark.parametrize("variant,split", [("multi", False), ("gpu", True)])
def test_dist_kernels_forced_plans(variant, split, monkeypatch):
    """The dist kernels under tilings the wrapper would not choose: tiles
    of two and three rows and lanes, of four to six, and two tiles of 19
    and 18 lanes; bitwise as above."""
    op, fields = _dist_inputs(variant, split, (12, 11, 37))
    for cut in ((1, 1), (2, 2), (2, 9)):
        def plan(shape, cut=cut):
            bx, ny, nz = shape
            return kp.DistPlan(ny // (2 * cut[0]), nz // (2 * cut[1]))
        monkeypatch.setattr(kp, "dist_plan", plan)
        for nshards in (1, 2, 3, 6):
            _check_dist_shards(op, fields, nshards)


@pytest.mark.parametrize("compat", [False, True])
def test_sharded_step_on_card_matches_cpu(compat):
    """Two sharded multi steps at nx=16 on a (4,1,1) mesh of card shards
    against the same on CPU shards: equal counts, every field bitwise; the
    solve launches only its dist kernel (K7-dist under compat, K2-dist
    otherwise) and the rest of the step no kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    from navierstokes3d_tpu_torch.parallel import make_mesh
    cfg = nt.preset_multi(nx=16, compat=compat, dtype="float32")
    card = nt.ChorinSolver(cfg, device="cuda")
    cpu = nt.ChorinSolver(cfg, device="cpu")
    sa = card.step_shard_map(make_mesh((4, 1, 1), "cuda:0"))
    sb = cpu.step_shard_map(make_mesh((4, 1, 1), "cpu"))
    kernels.reset_counts()
    a, b = card.init_state(), cpu.init_state()
    for _ in range(2):
        a, ta = sa(a)
        b, tb = sb(b)
        assert (ta.iters, ta.advect_clamped) == (tb.iters, tb.advect_clamped)
        for name in ("pr", "vx", "vy", "vz", "c", "dprdtau"):
            assert torch.equal(getattr(a, name).cpu(), getattr(b, name)), name
    on = "K7-dist" if compat else "K2-dist"
    for k in kernels.KERNELS:
        assert (k.wrapper.launches > 0) == k.name.startswith(on), k.name


def _nan_pads(branch, vels):
    """K6's operands with NaN in the pads of the branch's staggered axis
    (its write region keeps them unread)."""
    axis = ka._PAD_AXIS[branch]
    out = []
    for v in vels:
        v = v.clone()
        if axis is not None:
            v.select(axis, 0).fill_(float("nan"))
            v.select(axis, -1).fill_(float("nan"))
        out.append(v)
    return tuple(out)


def _k6_inputs(shape, scale, seed):
    nx, ny, nz = shape
    rng = np.random.default_rng(seed)
    vx = _rand(rng, (nx + 1, ny, nz), scale)
    vy = _rand(rng, (nx, ny + 1, nz), scale)
    vz = _rand(rng, (nx, ny, nz + 1), scale)
    c = torch.tensor(rng.uniform(size=shape).astype(np.float32),
                     device="cuda")
    return vx, vy, vz, c


@pytest.mark.parametrize("scale", [0.25, 3.0])
def test_k6_matches_plain_and_k5(solver, scale):
    """K6 on the four branches from their torch-op face averages (NaN in
    the pads, which its write region keeps unread), in one launch:
    bitwise equal to its plain version and to K5 on the same velocities,
    equal clamp counts."""
    vx, vy, vz, c = _k6_inputs(solver.grid.shape_c, scale, 3)
    k, w = solver._consts, solver.advect_k
    fields = dict(zip(("vx", "vy", "vz", "c"), (vx, vy, vz, c)))
    vels = {name: ka.pre_velocities(name, vx, vy, vz) for name in fields}
    n6 = torch.zeros((1,), dtype=torch.int32, device="cuda")
    n0 = ka.advect_pre.launches
    out = ka.advect_pre(fields, {name: _nan_pads(name, v)
                                 for name, v in vels.items()}, k, w, n6)
    assert ka.advect_pre.launches == n0 + 1
    ref, n_plain = ka.advect_pre_plain(fields, vels, k, w)
    k5 = ka.advect(vx, vy, vz, c, k, w)
    for i, name in enumerate(fields):
        assert torch.equal(out[name], ref[name]), name
        assert torch.equal(out[name], k5[i]), name
    assert int(n6.item()) == int(n_plain.item()) == int(k5[4].item())
    assert (int(n6.item()) > 0) == (scale > 1.0)


def _departure_inputs(shape):
    """Velocities whose displacements (dt = h = 1) hit the departure
    corner's fault points (tests/advect_faults.py): vx varies along z,
    vy along x, vz along y, each over a tiny positive dl, a whole number
    and one ulp above it, one ulp short of -1, 0, +-1 and 0.3."""
    nx, ny, nz = shape
    one = np.float32(1.0)
    vals = np.array([np.spacing(np.float32(2.0)) / 4,
                     np.nextafter(one, np.float32(2.0)),
                     -np.nextafter(one, np.float32(0.0)), 0.0, 1.0, -1.0,
                     0.3], dtype=np.float32)

    def along(n, axis, full):
        v = vals[np.arange(n) % len(vals)]
        view = [1, 1, 1]
        view[axis] = n
        return torch.tensor(np.broadcast_to(v.reshape(view), full).copy(),
                            device="cuda")
    vx = along(nz, 2, (nx + 1, ny, nz))
    vy = along(nx, 0, (nx, ny + 1, nz))
    vz = along(ny, 1, (nx, ny, nz + 1))
    c = torch.tensor(np.random.default_rng(4).uniform(size=shape)
                     .astype(np.float32), device="cuda")
    return vx, vy, vz, c


def test_k5_k6_departure_points_bitwise():
    """At the points where the source's departure corner reads the next
    cell, K5 and K6 (NaN pads) are bitwise equal to their plain versions,
    which take the corner as i - ceil(dl)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    k = dataclasses.replace(_solver(17)._consts, dt=1.0, dx=1.0, dy=1.0,
                            dz=1.0)
    vx, vy, vz, c = _departure_inputs((21, 15, 33))
    names = ("vx", "vy", "vz", "c")
    faults = {n: advect_faults.fault_points(n, vx.cpu(), vy.cpu(), vz.cpu(),
                                            k, 2) for n in names}
    assert all(f.any() for f in faults.values())
    fields = dict(zip(names, (vx, vy, vz, c)))
    vels = {n: ka.pre_velocities(n, vx, vy, vz) for n in names}
    k5 = ka.advect(vx, vy, vz, c, k, 2)
    plain = ka.advect(vx, vy, vz, c, k, 2, plain=True)
    n6 = torch.zeros((1,), dtype=torch.int32, device="cuda")
    k6 = ka.advect_pre(fields, {n: _nan_pads(n, v) for n, v in vels.items()},
                       k, 2, n6)
    ref6, n_plain = ka.advect_pre_plain(fields, vels, k, 2)
    for i, n in enumerate(names):
        assert _bitwise(k5[i], plain[i]), n
        assert _bitwise(k6[n], ref6[n]), n
    assert int(k5[4].item()) == int(plain[4].item())
    assert int(n6.item()) == int(n_plain.item())


@pytest.mark.parametrize("shape", [(9, 8, 32), (10, 9, 33), (7, 17, 65)])
@pytest.mark.parametrize("mask", range(1, 16))
def test_k6_one_launch_masks(shape, mask):
    """K6's one launch on every mask of one to four branches, on grids
    whose union grid is one past a block multiple (ny + 1, nz + 1 against
    the 8 x 32 block), with NaN pads and clamped points: bitwise equal to
    the plain version, equal clamp counts, and the outputs of the other
    branches not written."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    vx, vy, vz, c = _k6_inputs(shape, 3.0, mask)
    k = _solver(17)._consts
    names = [n for i, n in enumerate(("vx", "vy", "vz", "c"))
             if mask >> i & 1]
    fields = {n: f for n, f in zip(("vx", "vy", "vz", "c"),
                                   (vx, vy, vz, c)) if n in names}
    vels = {n: ka.pre_velocities(n, vx, vy, vz) for n in names}
    n6 = torch.zeros((1,), dtype=torch.int32, device="cuda")
    out = ka.advect_pre(fields, {n: _nan_pads(n, v) for n, v in vels.items()},
                        k, 2, n6)
    ref, n_plain = ka.advect_pre_plain(fields, vels, k, 2)
    assert sorted(out) == sorted(names)
    for n in names:
        assert torch.equal(out[n], ref[n]), n
    assert int(n6.item()) == int(n_plain.item()) > 0


def _k10_inputs(shape, seed=8):
    rng = np.random.default_rng(seed)
    return (_rand(rng, shape), _rand(rng, shape, 0.01), _rand(rng, shape))


def _k10_operator(shape, zero_grad_x=False):
    nx, ny, nz = shape
    m = {k: np.ones(n - 2) for k, n in zip(("xm", "xp", "ym", "yp", "zm",
                                            "zp"), (nx, nx, ny, ny, nz, nz))}
    m["ym"][0] = m["yp"][-1] = m["zm"][0] = m["zp"][-1] = 0.0
    if zero_grad_x:
        m["xm"][0] = 0.0
    grid = types.SimpleNamespace(dx=0.1, dy=0.12, dz=0.09, dtau=0.01,
                                 damp=0.9)
    return kp.make_operator(m, grid, torch.float32, "cuda")


def _k10_against_k1(shape, op, nit, plan=None):
    """K10 (under `plan`, or resident_plan's) from seeded inputs, NaN in
    the scratch, against nit K1 launches and the plain version: pr, dpr
    and the check value bitwise, the result in the caller's tensors."""
    pr, dpr, rhs = _k10_inputs(shape)
    p, d = pr.clone(), dpr.clone()
    scratch = torch.full_like(pr, float("nan"))
    if plan is None:
        e = kp.poisson_iter_resident(p, d, rhs, op, nit, scratch)
    else:
        e = kp.launch_resident(p, d, rhs, op, nit, plan, scratch)
    q, dq = pr.clone(), dpr.clone()
    for j in range(nit):
        o = torch.empty_like(q)
        e1 = kp.poisson_iter(q, o, dq, rhs, op, j == nit - 1)
        q = o
    pp, dp = pr.clone(), dpr.clone()
    ep = kp.poisson_iter_resident_plain(pp, dp, rhs, op, nit)
    assert torch.equal(p, q) and torch.equal(d, dq)
    assert torch.equal(p, pp) and torch.equal(d, dp)
    assert float(e) == float(e1) == float(ep)


@pytest.mark.parametrize("nit", [1, 2, 5, 38])
def test_k10_matches_k1_launches_and_plain(nit):
    """K10 at 64x39x39 under resident_plan's plan (38 x 2 blocks of one y
    row of 32 z): one launch bitwise equal to nit K1 launches and to its
    plain version, the check value that of the last K1 launch, the result
    in the caller's pr and dpr."""
    solver = _solver(64)
    plan = kp.resident_plan(solver.grid.shape_c,
                            kp.resident_sms(torch.device("cuda")))
    assert plan is not None and plan.per_block == kp.RESIDENT_LANES
    _k10_against_k1(solver.grid.shape_c, solver._op, nit)


@pytest.mark.parametrize("nit", [1, 2, 3, 6])
@pytest.mark.parametrize("below", [0, 1])
@pytest.mark.parametrize("zero_grad_x", [False, True])
def test_k10_grid_form_at_its_x_limit(nit, below, zero_grad_x):
    """K10 on 38x38 planes at the most planes its plan holds (one y row of
    32 z a block, their dpr through every plane filling a block's shared
    memory) and one plane below it: bitwise equal to nit K1 launches and
    the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    sms = kp.resident_sms(torch.device("cuda"))
    ny = nz = 38
    columns = kp.resident_plan((1, ny, nz), sms).per_block
    limit = (kp.SMEM_LIMIT - kp.RESIDENT_STATIC_SMEM) // (4 * columns)
    assert kp.resident_plan((limit + 1, ny, nz), sms) is None
    shape = (limit - below, ny, nz)
    plan = kp.resident_plan(shape, sms)
    assert plan.per_block == columns
    _k10_against_k1(shape, _k10_operator(shape, zero_grad_x), nit, plan)


def test_k10_is_deterministic_at_63():
    """K10 at 63x38x38 (nit 37) from a state near its float32 noise floor
    (100 launches in place first) and from the seeded one: forty launches
    from the same state all give the same pr, dpr and check value, the K1
    chain's. (A grid barrier that let a block read its neighbours' pr
    early would show here now and then, not in every run.)"""
    solver = _solver(63)
    op, shape = solver._op, solver.grid.shape_c
    pr, dpr, rhs = _k10_inputs(shape)
    p, d = pr.clone(), dpr.clone()
    for _ in range(100):
        kp.poisson_iter_resident(p, d, rhs, op, 37)
    for p0, d0 in ((pr, dpr), (p, d)):
        want = None
        for _ in range(40):
            q, dq = p0.clone(), d0.clone()
            e = float(kp.poisson_iter_resident(q, dq, rhs, op, 37))
            if want is None:
                want = (q, dq, e)
                k1, dk1 = p0.clone(), d0.clone()
                for j in range(37):
                    o = torch.empty_like(k1)
                    e1 = kp.poisson_iter(k1, o, dk1, rhs, op, j == 36)
                    k1 = o
                assert torch.equal(q, k1) and torch.equal(dq, dk1)
                assert e == float(e1)
            assert torch.equal(q, want[0]) and torch.equal(dq, want[1])
            assert e == want[2]


def _grid_plan(shape, cut_y):
    """The grid form's plan for a forced number of y parts (z in rows of
    RESIDENT_LANES, as always)."""
    nx, ny, nz = shape
    cut = (cut_y, -(-nz // kp.RESIDENT_LANES))
    columns = -(-ny // cut_y) * kp.RESIDENT_LANES
    return kp.ResidentPlan(cut[0] * cut[1], columns,
                           max(kp.grid_smem(columns, nx),
                               kp.RESIDENT_SOLO_SMEM), cut)


@pytest.mark.parametrize("nit", [1, 2, 7])
@pytest.mark.parametrize("shape,cut_y", [((40, 25, 70), None),
                                         ((33, 17, 65), None),
                                         ((12, 9, 33), None),
                                         ((40, 25, 70), 1),
                                         ((33, 17, 65), 2),
                                         ((12, 20, 31), 5),
                                         ((12, 9, 33), 3),
                                         ((7, 3, 3), 3)])
def test_k10_grid_form(nit, shape, cut_y):
    """K10's grid form (dpr in shared memory, x-streamed columns) on grids
    ragged in y and z (z one past a row of 32 lanes, or short of one),
    under resident_plan's plan (one row a block: runs of one to a few
    planes) and forced cuts of 1 x k (all 25 rows a block,
    one run of all 40 planes), k x 1 (z within one row) and a few blocks:
    bitwise equal to nit K1 launches and the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    sms = _build.sm_count(torch.device("cuda"))
    plan = (kp.resident_plan(shape, sms) if cut_y is None
            else _grid_plan(shape, cut_y))
    assert plan is not None
    for zero_grad_x in (False, True):
        _k10_against_k1(shape, _k10_operator(shape, zero_grad_x), nit, plan)


def test_k10_refused_launches_raise():
    """A launch the card refuses raises with its CUDA error and does not
    fall back: no count, no plain version, no K1 launch; a grid with no
    resident plan raises before launching."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    shape = (12, 9, 33)
    op = _k10_operator(shape)
    pr, dpr, rhs = _k10_inputs(shape)
    sms = _build.sm_count(torch.device("cuda"))
    kernels.reset_counts()
    # more blocks than the card holds co-resident (y parts of one or two
    # rows on a plane of many rows)
    tall = (4, 2 * sms + 4, 33)
    with pytest.raises(RuntimeError, match="poisson_iter_resident"):
        kp.launch_resident(*_k10_inputs(tall), _k10_operator(tall), 3,
                           kp.ResidentPlan(4 * sms, 64, kp.SMEM_LIMIT,
                                           (2 * sms, 2)))
    refused = (
        # a cut whose blocks are not the plan's, one with more y parts
        # than the plane has rows, one whose z rows are not 32 lanes
        kp.ResidentPlan(5, 160, kp.RESIDENT_SOLO_SMEM, (2, 2)),
        kp.ResidentPlan(20, 32, kp.RESIDENT_SOLO_SMEM, (10, 2)),
        kp.ResidentPlan(3, 96, kp.RESIDENT_SOLO_SMEM, (3, 1)),
        # less shared memory than the region's dpr
        kp.ResidentPlan(4, 160, 4 * 160 * 12 - 4, (2, 2)),
        # more shared memory than a block has
        kp.ResidentPlan(4, 160, kp.SMEM_LIMIT + 4096, (2, 2)))
    for plan in refused:
        with pytest.raises(RuntimeError, match="poisson_iter_resident"):
            kp.launch_resident(pr.clone(), dpr.clone(), rhs, op, 3, plan)
    # one plane more than the grid form holds at 153x153 (the dpr of the
    # largest region's columns through every plane)
    room = kp.SMEM_LIMIT - kp.RESIDENT_STATIC_SMEM
    columns = kp.resident_plan((255, 153, 153), sms).per_block
    big = (room // (4 * columns) + 1, 153, 153)
    assert kp.resident_plan(big, sms) is None
    p = torch.zeros(big, device="cuda")
    with pytest.raises(ValueError, match="no resident plan"):
        kp.poisson_iter_resident(p, p.clone(), p.clone(),
                                 _k10_operator(big), 2)
    assert kp.make_resident(2, big, "cuda") is None
    for k in kernels.KERNELS:
        assert k.wrapper.launches == 0 and k.plain.calls == 0, k.name


def test_k10_route_at_255_is_k1_route():
    """Step 1 of the multi preset at 255x153x153 from init_state with the
    folded loops' K10 route and the extended phase's K12 route on (one
    launch per check interval) and off (`_resident_plan = None`: K1 and
    K2 bodies): the same 3192 iterations, err and check history, every
    field bitwise equal; phase 1's 2887 iterations after the exact first
    one are one K10 launch that took 19 checks on the card (151
    iterations, then 152 each), and 2887 K1 launches with the route off;
    the extended phase's 304 iterations are 2 K12 launches, and 304 K2
    launches with the route off."""
    on = _solver(255, "multi")
    assert on._resident_plan is not None
    off = nt.ChorinSolver(on.cfg, device="cuda")
    off._resident_plan = None
    kernels.reset_counts()
    b, sb = off.step(off.init_state())
    assert (kp.poisson_iter.launches, kp.poisson_iter_resident.launches) == (
        2887, 0)
    assert (kp.poisson_iter_ext.launches,
            kp.poisson_iter_resident_ext.launches) == (304, 0)
    kernels.reset_counts()
    a, sa = on.step(on.init_state())
    assert (kp.poisson_iter.launches, kp.poisson_iter_resident.launches,
            kp.poisson_iter_resident.iterations,
            kp.poisson_iter_resident.checks) == (0, 1, 2887, 19)
    assert (kp.poisson_iter_ext.launches,
            kp.poisson_iter_resident_ext.launches,
            kp.poisson_iter_resident_ext.iterations) == (0, 2, 304)
    assert sa.iters == sb.iters == 3192
    assert (sa.iters_ext, sa.err) == (sb.iters_ext, sb.err)
    np.testing.assert_array_equal(sa.err_hist, sb.err_hist)
    for name in ("pr", "vx", "vy", "vz", "c", "dprdtau", "pr_lo"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def _k12_inputs(shape, seed=9):
    """A pressure pair (lo at the rounding level of hi), dpr and rhs,
    seeded, on the card."""
    rng = np.random.default_rng(seed)
    return (_rand(rng, shape, 50.0), _rand(rng, shape, 50.0 * 2.0 ** -24),
            _rand(rng, shape, 0.01), _rand(rng, shape))


def _k12_against_k2(shape, op, nit, plan=None):
    """K12 (under `plan`, or resident_plan's) from seeded inputs, NaN in
    both scratch tensors, against nit K2 launches (the check on the last)
    and the plain version: hi, lo, dpr and the check value bitwise, the
    result in the caller's tensors."""
    hi, lo, dpr, rhs = _k12_inputs(shape)
    h, l, d = hi.clone(), lo.clone(), dpr.clone()
    sh, sl = (torch.full_like(hi, float("nan")) for _ in range(2))
    if plan is None:
        e = kp.poisson_iter_resident_ext(h, l, d, rhs, op, nit, sh, sl)
    else:
        e = kp.launch_resident_ext(h, l, d, rhs, op, nit, plan, sh, sl)
    q = (hi.clone(), lo.clone(), torch.empty_like(hi), torch.empty_like(lo))
    dq = dpr.clone()
    for j in range(nit):
        e2 = kp.poisson_iter_ext(*q, dq, rhs, op, j == nit - 1)
        q = (q[2], q[3], q[0], q[1])
    hp, lp, dp = hi.clone(), lo.clone(), dpr.clone()
    ep = kp.poisson_iter_resident_ext_plain(hp, lp, dp, rhs, op, nit)
    assert torch.equal(h, q[0]) and torch.equal(l, q[1])
    assert torch.equal(d, dq)
    assert torch.equal(h, hp) and torch.equal(l, lp) and torch.equal(d, dp)
    assert float(e) == float(e2) == float(ep)


@pytest.mark.parametrize("nx,nit", [(63, 1), (63, 2), (63, 37), (63, 38),
                                    (255, 151), (255, 152)])
def test_k12_matches_k2_launches_and_plain(nx, nit):
    """K12 at 63x38x38 and 255x153x153 under resident_plan's plan with
    the multi preset's operator: one launch bitwise equal to nit K2
    launches and to its plain version, odd and even nit."""
    solver = _solver(nx, "multi")
    assert solver._resident_plan is not None
    _k12_against_k2(solver.grid.shape_c, solver._op, nit)


@pytest.mark.parametrize("nit", [1, 2, 7])
@pytest.mark.parametrize("shape,cut_y", [((40, 25, 70), None),
                                         ((33, 17, 65), None),
                                         ((12, 9, 33), None),
                                         ((40, 24, 70), 1),
                                         ((33, 17, 65), 2),
                                         ((12, 20, 31), 5),
                                         ((12, 9, 33), 3),
                                         ((7, 3, 3), 3)])
def test_k12_forced_plans(nit, shape, cut_y):
    """K12 on K10's ragged grids (z one past a row of 32 lanes, or short
    of one) under resident_plan's plan and forced cuts (all 24 rows a
    block: 768 column slots, one a thread, one run of all 40 planes; z
    within one row; a few blocks), both x-lo conditions: bitwise equal to
    nit K2 launches and the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    sms = _build.sm_count(torch.device("cuda"))
    plan = (kp.resident_plan(shape, sms) if cut_y is None
            else _grid_plan(shape, cut_y))
    assert plan is not None
    for zero_grad_x in (False, True):
        _k12_against_k2(shape, _k10_operator(shape, zero_grad_x), nit, plan)


@pytest.mark.parametrize("nit", [1, 2, 3])
@pytest.mark.parametrize("below", [0, 1])
def test_k12_at_its_x_limit(nit, below):
    """K12 on 38x38 planes at the most planes K10's plan holds (one y row
    of 32 z a block, their dpr through every plane filling a block's
    shared memory) and one plane below it: bitwise equal to nit K2
    launches and the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    sms = kp.resident_sms(torch.device("cuda"))
    columns = kp.resident_plan((1, 38, 38), sms).per_block
    limit = (kp.SMEM_LIMIT - kp.RESIDENT_STATIC_SMEM) // (4 * columns)
    shape = (limit - below, 38, 38)
    plan = kp.resident_plan(shape, sms)
    assert plan.per_block == columns
    _k12_against_k2(shape, _k10_operator(shape, True), nit, plan)


def test_k12_is_deterministic_at_63():
    """Twenty K12 launches at 63x38x38 (nit 37) from the same seeded
    state give the same hi, lo, dpr and check value. (A grid barrier
    that let a block read its neighbours' words early would show here now
    and then.)"""
    solver = _solver(63, "multi")
    hi, lo, dpr, rhs = _k12_inputs(solver.grid.shape_c)
    want = None
    for _ in range(20):
        h, l, d = hi.clone(), lo.clone(), dpr.clone()
        e = float(kp.poisson_iter_resident_ext(h, l, d, rhs, solver._op,
                                               37))
        if want is None:
            want = (h, l, d, e)
        assert torch.equal(h, want[0]) and torch.equal(l, want[1])
        assert torch.equal(d, want[2]) and e == want[3]


def test_k12_refused_launches_raise():
    """Operands the wrapper refuses (aliased, of another dtype or shape),
    a plan the card refuses and a grid with no resident plan raise, with
    no count, no plain version and no K2 launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    shape = (12, 9, 33)
    op = _k10_operator(shape)
    hi, lo, dpr, rhs = _k12_inputs(shape)
    kernels.reset_counts()
    run = kp.poisson_iter_resident_ext
    aliased = ((hi, hi, dpr, rhs, None, None),      # lo is hi
               (hi, lo, dpr, dpr, None, None),      # rhs is dpr
               (hi, lo, dpr, rhs, hi, None),        # hi's scratch is hi
               (hi, lo, dpr, rhs, None, lo),        # lo's scratch is lo
               (hi, lo, dpr, rhs, rhs, None))       # a scratch is rhs
    for h, l, d, r, sh, sl in aliased:
        with pytest.raises(ValueError, match="distinct"):
            run(h, l, d, r, op, 3, sh, sl)
    wrong = ((hi.double(), lo, dpr, rhs, None, None),
             (hi, lo, dpr[:-1].contiguous(), rhs, None, None),
             (hi, lo, dpr, rhs, torch.empty(1, device="cuda"), None),
             (hi, lo, dpr, rhs, None, lo.cpu()),
             (hi, lo.transpose(1, 2).contiguous().transpose(1, 2), dpr,
              rhs, None, None))
    for h, l, d, r, sh, sl in wrong:
        with pytest.raises(ValueError):
            run(h, l, d, r, op, 3, sh, sl)
    with pytest.raises(ValueError, match="nit"):
        run(hi, lo, dpr, rhs, op, 0)
    # a cut whose blocks are not the plan's
    with pytest.raises(RuntimeError, match="poisson_iter_resident_ext"):
        kp.launch_resident_ext(hi, lo, dpr, rhs, op, 3, kp.ResidentPlan(
            5, 160, kp.RESIDENT_SOLO_SMEM, (2, 2)))
    # K10's plan for a region of 25 rows of 32 lanes (800 column slots),
    # more than K12's blocks hold: the C entry refuses a forced launch,
    # the wrapper the grid
    sms = _build.sm_count(torch.device("cuda"))
    tall = (4, sms // 2 * 24 + 1, 33)
    plan = kp.resident_plan(tall, sms)
    assert plan.per_block == 800 and not kp.resident_ext_fits(plan)
    t = _k12_inputs(tall)
    with pytest.raises(RuntimeError, match="poisson_iter_resident_ext"):
        kp.launch_resident_ext(*t, _k10_operator(tall), 3, plan)
    with pytest.raises(ValueError, match="no resident plan"):
        run(*t, _k10_operator(tall), 3)
    room = kp.SMEM_LIMIT - kp.RESIDENT_STATIC_SMEM
    columns = kp.resident_plan((255, 153, 153), sms).per_block
    big = (room // (4 * columns) + 1, 153, 153)
    p = torch.zeros(big, device="cuda")
    with pytest.raises(ValueError, match="no resident plan"):
        run(p, p.clone(), p.clone(), p.clone(), _k10_operator(big), 2)
    for k in kernels.KERNELS:
        assert k.wrapper.launches == 0 and k.plain.calls == 0, k.name


@pytest.mark.parametrize("preset", ["gpu", "multi"])
@pytest.mark.parametrize("kw", [{"fused_step": False},
                                {"poisson_mode": "dma"}])
def test_unchained_and_dma_steps_on_card_match_cpu(preset, kw):
    """Two steps at nx=15 of the unchained step (K6, the chain as torch
    ops) and of the dma-mode solve (K7 under the gpu preset, the pair
    solve as torch ops under the multi one): equal counts, every field
    bitwise equal to the CPU run, and only the path's kernels launched."""
    solver = _solver(15, preset)
    card = nt.ChorinSolver(solver.cfg, device="cuda", **kw)
    cpu = nt.ChorinSolver(solver.cfg, device="cpu", **kw)
    kernels.reset_counts()
    a, b = card.init_state(), cpu.init_state()
    for _ in range(2):
        a, sa = card.step(a)
        b, sb = cpu.step(b)
        assert (sa.iters, sa.iters_ext, sa.advect_clamped) == (
            sb.iters, sb.iters_ext, sb.advect_clamped)
        for name in ("pr", "vx", "vy", "vz", "c", "dprdtau", "pr_lo"):
            x, y = getattr(a, name), getattr(b, name)
            assert (x is None) == (y is None), name
            assert x is None or torch.equal(x.cpu(), y), name
    # at nx=15 the multi solves converge in phase 1 (no K2); the folded
    # loops run on K10 (one launch a loop), and the gpu preset's defect
    # phase K13; the dma pair solve (multi) takes K13's pair form for its
    # compensated residual
    if "fused_step" in kw:
        on_path = {"K10", "K6"} | ({"K13"} if preset == "gpu" else set())
    else:
        on_path = {"K3", "K4", "K5"} | ({"K7"} if preset == "gpu"
                                        else {"K13-pair"})
    launched = {k.name.split()[0] for k in kernels.KERNELS
                if k.wrapper.launches > 0}
    assert launched == on_path


def _fdm_solver(nx, preset, device="cuda", **num):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    make = nt.preset_gpu if preset == "gpu" else nt.preset_multi
    cfg = make(nx=nx, compat=False, dtype="float32")
    return nt.ChorinSolver(cfg.replace(numerics=dataclasses.replace(
        cfg.numerics, poisson_backend="fdm", **num)), device=device)


@pytest.mark.parametrize("preset", ["gpu", "multi"])
def test_fdm_step_bitwise_with_tf32_on(preset):
    """The fdm solve computes in IEEE float32 whatever the caller set:
    with TF32 turned on (set_float32_matmul_precision('high')) two steps
    give bitwise the fields of two steps with it off, on two refinement
    budgets (the direct solve alone, and rounds forced by eps_it 1e-7);
    the caller's setting is restored after each step."""
    prev = torch.get_float32_matmul_precision()
    for num in ({}, {"eps_it": 1e-7}):
        s = _fdm_solver(33, preset, **num)
        runs = []
        for precision in ("highest", "high"):
            torch.set_float32_matmul_precision(precision)
            try:
                st, rounds = s.init_state(), []
                for _ in range(2):
                    st, stats = s.step(st)
                    rounds.append(stats.iters)
                    assert torch.get_float32_matmul_precision() == precision
            finally:
                torch.set_float32_matmul_precision(prev)
            runs.append((st, rounds))
        (a, ra), (b, rb) = runs
        assert ra == rb
        for name in ("pr", "pr_lo", "vx", "vy", "vz", "c", "dprdtau"):
            assert _bitwise(getattr(a, name), getattr(b, name)), name


@pytest.mark.parametrize("nx", [17, 255])
def test_k3_g_eff_of_the_fdm_step_bitwise(nx, nan_outputs):
    """The fdm gpu step has no hydrostatic split, so K3 carries the body
    force (g_eff = g): with that solver's own masks and constants, K3 is
    bitwise equal to its plain version."""
    s = _fdm_solver(nx, "gpu")
    assert s._consts.g_eff == s.cfg.physics.g != 0.0
    g, rng = s.grid, np.random.default_rng(13)
    v = [_rand(rng, sh) for sh in (g.shape_vx, g.shape_vy, g.shape_vz)]
    _check_k3(v, s.masks, s._consts)


@pytest.mark.parametrize("preset", ["gpu", "multi"])
def test_fdm_step_on_card_matches_cpu(preset):
    """Two float32 fdm steps at nx=20 on the card against the CPU: equal
    refinement rounds and clamp counts, err below eps_it on both, pr
    within 1e-5 of max|pr| (cuBLAS and the CPU's BLAS sum the transforms
    in other orders; the refinement holds both to the same residual) and
    the velocities within 1e-5 of their max away from vy's symmetry
    plane (tests/test_torch_fdm.py); K3, K4 and K5 launched, and K13's
    pair form for the refinement's residuals, no Poisson iteration
    kernel."""
    s = _fdm_solver(20, preset)
    cpu = _fdm_solver(20, preset, device="cpu")
    assert s.grid.ny % 2 == 0   # vy has a face on the symmetry plane
    kernels.reset_counts()
    a, b = s.init_state(), cpu.init_state()
    for _ in range(2):
        a, sa = s.step(a)
        b, sb = cpu.step(b)
        assert (sa.iters, sa.advect_clamped) == (sb.iters, sb.advect_clamped)
        assert sa.err < 1e-3 and sb.err < 1e-3
        for name in ("pr", "vx", "vy", "vz", "c"):
            x, y = getattr(a, name).cpu().numpy(), getattr(b, name).numpy()
            far = np.abs(x - y) > 1e-5 * max(1.0, np.abs(y).max())
            if name == "vy":
                far[:, s.grid.ny // 2] = False
            assert not far.any(), name
    on_path = {"K3", "K4", "K5", "K13-pair"}
    for k in kernels.KERNELS:
        assert ((k.wrapper.launches > 0)
                == (k.name.split()[0] in on_path)), k.name


@pytest.mark.parametrize("compat", [False, True])
def test_fullstep_on_card_matches_shard_map(compat):
    """Two full steps (ChorinSolver.step_fullstep) of the multi preset at
    nx=63 on a (3,1,1) mesh of card shards against step_shard_map on the
    same mesh: equal counts, every field bitwise (the same torch ops on
    every owned cell, the same dist kernel); the solve launches only its
    dist kernel, 3 launches per iteration, and no plain version runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    from navierstokes3d_tpu_torch.parallel import make_mesh
    from navierstokes3d_tpu_torch.parallel.fullstep import from_dist, to_dist
    s = nt.ChorinSolver(nt.preset_multi(nx=63, compat=compat,
                                        dtype="float32"), device="cuda")
    mesh = make_mesh((3, 1, 1), "cuda:0")
    fs, sm = s.step_fullstep(mesh), s.step_shard_map(mesh)
    d, st = to_dist(s.init_state(), mesh), s.init_state()
    iters = 0
    for _ in range(2):
        kernels.reset_counts()
        d, ta = fs(d)
        iters += ta.iters
        on = "K7-dist" if compat else "K2-dist"
        for k in kernels.KERNELS:
            assert k.plain.calls == 0, k.name
            assert k.wrapper.launches == (3 * ta.iters if k.name.startswith(on)
                                          else 0), k.name
        st, tb = sm(st)
        assert (ta.iters, ta.err, ta.advect_clamped) == (
            tb.iters, tb.err, tb.advect_clamped)
        got = from_dist(d)
        for name in ("pr", "vx", "vy", "vz", "c", "dprdtau"):
            assert torch.equal(getattr(got, name), getattr(st, name)), name
    assert iters > 0


@pytest.mark.parametrize("preset", ["gpu", "multi"])
def test_float64_step_on_card_matches_cpu(preset):
    """float64 outside compat on the card (the dtype rule: the plain
    versions on every device, no kernel launched): two steps at nx=20
    against the same on the CPU, equal counts and err, every field within
    1e-12 of max(1, max|field|)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    make = nt.preset_gpu if preset == "gpu" else nt.preset_multi
    cfg = make(nx=20, compat=False, dtype="float64")
    card = nt.ChorinSolver(cfg, device="cuda")
    cpu = nt.ChorinSolver(cfg, device="cpu")
    assert card.plain
    kernels.reset_counts()
    a, b = card.init_state(), cpu.init_state()
    for _ in range(2):
        a, sa = card.step(a)
        b, sb = cpu.step(b)
        assert (sa.iters, sa.advect_clamped) == (sb.iters, sb.advect_clamped)
        np.testing.assert_allclose(sa.err, sb.err, rtol=1e-12)
        for name in ("pr", "vx", "vy", "vz", "c", "dprdtau"):
            x, y = getattr(a, name).cpu().numpy(), getattr(b, name).numpy()
            assert a.pr.dtype == torch.float64
            np.testing.assert_allclose(
                x / max(1.0, np.abs(y).max()), y / max(1.0, np.abs(y).max()),
                rtol=0, atol=1e-12, err_msg=name)
    for k in kernels.KERNELS:
        assert k.wrapper.launches == 0, k.name


@functools.lru_cache(maxsize=None)
def _loop_case(preset, nx):
    """A solver on the card and a folded loop's inputs from its preset's
    first step: the first iteration's pr and dpr and the folded RHS."""
    s = _solver(nx, preset)
    state = s.init_state()
    divv = s.predictor_divv(state)
    pr, dpr = s._first_iteration(state.pr, state.dprdtau, divv)
    return s, s._rhs3d(divv), pr, dpr


def _host_driven_k10(s, rhs, carry, it0, n_checked, rem, eps, stall, err0):
    """The folded loop as the host drove K10 before its checks moved onto
    the card: pt_loop_fused over one K10 launch from global iteration it
    to the next check, its check value read after each."""
    nchk, err_scale = s.grid.nchk, s._err_scale()

    def body(c, it):
        nit = nchk - it % nchk
        ec = kp.poisson_iter_resident(c[0], c[2], rhs, s._op, nit, c[1])
        return c, ec * err_scale, nit
    return s._fused(body, s._kernel_chain(rhs, err_scale), carry, it0,
                    n_checked, rem, eps, stall, err0)


# each way a folded loop ends: (eps, stall, checks of budget, rem, err0,
# dtau factor); None: the whole budget and its rem; eps "mid": the check
# value halfway down a budget of 8 checks, read first from the
# host-driven loop
K10_EXITS = {
    "eps_it": ("mid", None, 8, 0, None, 1.0),
    "defect_1000_eps": (1.0, (0.96, 5), None, 0, None, 1.0),
    "stall": (1e-30, (0.96, 5), None, None, None, 1.0),
    "nonfinite": (1e-30, None, 12, 0, None, 2.0),
    "budget_tail": (1e-30, None, 6, 5, None, 1.0),
    "budget_no_tail": (1e-30, None, 6, 0, None, 1.0),
    "err0_no_op": (1e-3, None, None, None, 5e-4, 1.0),
}


# the exit the defect phase 1's loop (1000 x eps_it, the stall window on)
# takes from each preset's first step, where it is not the eps exit: at
# 255 the gpu preset's stalls above 1000 x eps_it (2888 iterations, err
# 1.29), on both routes alike
DEFECT_1000_EPS_EXIT = {("gpu", 255): "stall"}


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("it0", [1, 0])
@pytest.mark.parametrize("exit_by", list(K10_EXITS))
@pytest.mark.parametrize("nx", [63, 255])
@pytest.mark.parametrize("preset", ["gpu", "multi"])
def test_k10_device_loop_is_host_driven_loop(preset, nx, exit_by, it0):
    """A folded loop on K10's route (one launch that takes each check's
    exit decision on the card, `_folded_loop`) against pt_loop_fused over
    host-driven K10 launches, one a check interval, each read by the
    host, with NaN in the scratch half of pr on both sides: pr, dpr,
    iterations, err and check history bit for bit; the loop ends as
    named; one launch and one host read (none for the no-op), its checks
    (`poisson_iter_resident.checks`) the host-driven loop's launches."""
    s, rhs, pr, dpr = _loop_case(preset, nx)
    eps, stall, n_checks, rem, err0, dtau = K10_EXITS[exit_by]
    nchk = s.grid.nchk
    budget, tail = s._budget()
    n_checked = (n_checks or budget) * nchk
    rem = tail if rem is None else rem
    err0 = None if err0 is None else np.float32(err0)
    op = s._op
    s._op = dataclasses.replace(op, dtau=op.dtau * dtau)
    try:
        if eps == "mid":
            carry = (pr.clone(), torch.full_like(pr, float("nan")),
                     dpr.clone(), None)
            h = _host_driven_k10(s, rhs, carry, it0, n_checked, 0,
                                 np.float32(1e-30), None, None)[3]
            eps = h[4]
        eps = np.float32(eps)
        out, counts = [], []
        for device_loop in (False, True):
            kernels.reset_counts()
            ptloop.reset_reads()
            carry = (pr.clone(), torch.full_like(pr, float("nan")),
                     dpr.clone(), None)
            if device_loop:
                out.append(s._folded_loop(rhs, s._err_scale(), carry, it0,
                                          n_checked, rem, eps, stall, err0))
            else:
                out.append(_host_driven_k10(s, rhs, carry, it0, n_checked,
                                            rem, eps, stall, err0))
            counts.append((kp.poisson_iter_resident.launches,
                           kp.poisson_iter_resident.iterations,
                           kp.poisson_iter_resident.checks,
                           ptloop.host_scalar.reads))
    finally:
        s._op = op
    (c_ref, it_ref, e_ref, h_ref), (c, it, e, h) = out
    assert it == it_ref and _bits(e) == _bits(e_ref)
    np.testing.assert_array_equal(_bits(h), _bits(h_ref))
    for a, b in ((c[0], c_ref[0]), (c[2], c_ref[2])):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    tail = rem if it == n_checked + rem else 0
    ends = {"eps_it": e < eps and it < n_checked,
            "stall": np.isfinite(e) and e >= eps and it < n_checked,
            "nonfinite": not np.isfinite(e) and it < n_checked,
            "budget_tail": it == n_checked + rem and rem > 0,
            "budget_no_tail": it == n_checked and rem == 0,
            "err0_no_op": it == it0}
    if exit_by == "defect_1000_eps":
        exit_by = DEFECT_1000_EPS_EXIT.get((preset, nx), "eps_it")
    assert ends[exit_by], (it, e)
    (launches_ref, iters_ref, _, reads_ref), (launches, iters, checks,
                                              reads) = counts
    assert iters == iters_ref == it - tail - it0
    assert checks == launches_ref == reads_ref
    assert launches == reads == (checks > 0)


# ---- K13: the compensated residual ----

INNER = (slice(1, -1),) * 3


def _k13_case(preset, nx, when):
    """The solver and K13's inputs: the pressure (hi, lo) and the defect
    phase's whole-grid rhs pair of the seeded start state ("start": pr
    from init_state plus noise, lo at its rounding level) or of the state
    a step's solve stored ("solved": its pr and pr_lo against the rhs
    pair of that step's predictor divergence, where r is small and every
    rounding shows)."""
    s = _solver(nx, preset)
    st = s.init_state()
    divv = s.predictor_divv(st)
    rho_dt = s.cfg.physics.rho / s.grid.dt
    rh, rl = ds.rhs_pair(divv, rho_dt, s._z_hoist)
    g = torch.Generator(device="cuda").manual_seed(nx)
    if when == "start":
        hi = st.pr + 1e-3 * torch.randn(st.pr.shape, device="cuda",
                                        generator=g)
        lo = hi * 2.0 ** -24 * torch.randn(hi.shape, device="cuda",
                                           generator=g)
    else:
        after, _ = s.step(st)
        hi, lo = after.pr, after.pr_lo
    return s, hi.contiguous(), lo.contiguous(), rh, rl


def _same(a, b):
    """Bitwise equal, NaN where NaN."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("when", ["start", "solved"])
@pytest.mark.parametrize("nx", [63, 255])
@pytest.mark.parametrize("preset", ["gpu", "multi"])
def test_k13_matches_plain(preset, nx, when):
    """K13's single-word form (the defect restart: r on the whole grid,
    0 on the ring) and its pair form (r on the interior, and max|r| alone)
    bitwise their plain versions on the card (torch ops, the parent
    route) and on the CPU; the pair form against interior views of the
    whole-grid rhs (the guarantee's) and against contiguous copies
    (stored_residual_err's); each call one launch."""
    s, hi, lo, rh, rl = _k13_case(preset, nx, when)
    op = s._op
    kernels.reset_counts()
    r1, e1 = kp.compensated_residual(hi, rh, rl, op)
    assert kp.compensated_residual.launches == 1
    assert kp.compensated_residual_plain.calls == 0
    r0, e0 = kp.compensated_residual_plain(hi, rh, rl, op)
    assert _same(r1, r0) and _same(e1, e0)
    assert bool((r1[0] == 0).all() and (r1[-1] == 0).all()
                and (r1[:, 0] == 0).all() and (r1[:, :, -1] == 0).all())
    rc, ec = kp.compensated_residual_plain(*(t.cpu() for t in (hi, rh, rl)),
                                           _cpu_op(s))
    assert _same(r1.cpu(), rc) and _same(e1.cpu(), ec)
    for rhs in ((rh[INNER], rl[INNER]),
                (rh[INNER].contiguous(), rl[INNER].contiguous())):
        kernels.reset_counts()
        r2, e2 = kp.pair_residual(hi, lo, *rhs, op)
        m2 = kp.pair_residual_max(hi, lo, *rhs, op)
        assert kp.pair_residual.launches == 2
        assert kp.pair_residual_plain.calls == 0
        q0, f0 = kp.pair_residual_plain(hi, lo, *rhs, op)
        assert _same(r2, q0) and _same(e2, f0) and _same(m2, f0)
    assert float(e2) > 0.0 and float(e1) > 0.0


def _cpu_op(s):
    """The CPU solver's operator of the card solver s's configuration."""
    return nt.ChorinSolver(s.cfg, device="cpu")._op


@pytest.mark.parametrize("what", ["nan_p", "inf_p", "inf_rhs_lo"])
def test_k13_non_finite_max(what):
    """A NaN in p gives a NaN max|r| in both forms, as torch.max does (the
    kernel's max over float bits: fabsf of a NaN sorts above +inf); an
    inf in p gives NaN too, in the plain versions as in the kernel (the
    error-free transformations take inf - inf); an inf in the rhs's lo
    word reaches r as an inf, and max|r| is +inf."""
    s, hi, lo, rh, rl = _k13_case("gpu", 63, "solved")
    op = s._op
    cell = (31, 17, 20)
    if what == "nan_p":
        hi[cell] = float("nan")
    elif what == "inf_p":
        hi[cell] = float("inf")
    else:
        rl[cell] = float("inf")
    e1 = kp.compensated_residual(hi, rh, rl, op)[1]
    e0 = kp.compensated_residual_plain(hi, rh, rl, op)[1]
    m2 = kp.pair_residual_max(hi, lo, rh[INNER], rl[INNER], op)
    f0 = kp.pair_residual_plain(hi, lo, rh[INNER], rl[INNER], op)[1]
    want = math.inf if what == "inf_rhs_lo" else math.nan
    for got in (e1, e0, m2, f0):
        got = float(got)
        assert (math.isnan(got) if math.isnan(want) else got == want), what


def _parent_route(s):
    """The solver's compensated residuals as torch ops on the card, the
    route before K13."""
    s._compensated_residual = kp.compensated_residual_plain
    s._pair_residual = kp.pair_residual_plain
    s._pair_residual_max = lambda *a: kp.pair_residual_plain(*a)[1]
    return s


@pytest.mark.parametrize("guarantee", [False, True])
def test_k13_defect_and_guarantee_steps_are_the_parent_route(guarantee):
    """Two gpu steps at 63 on K13 against the same steps on the torch-op
    route: the stored pressure pair, dprdtau and every StepStats field
    bitwise. guarantee=True takes the stored-state guarantee on every
    step (its marginal-exit test forced), so the pair form runs there."""
    a, b = _solver(63), _parent_route(_solver(63))
    if guarantee:
        for s in (a, b):
            s._marginal = lambda err: True
    kernels.reset_counts()
    sa, sb = a.init_state(), b.init_state()
    for _ in range(2):
        sa, ta = a.step(sa)
        sb, tb = b.step(sb)
        for name in ("pr", "pr_lo", "dprdtau", "vx", "c"):
            assert torch.equal(getattr(sa, name), getattr(sb, name)), name
        assert (ta.iters, ta.iters_ext, ta.err) == (tb.iters, tb.iters_ext,
                                                    tb.err)
        assert np.array_equal(ta.err_hist, tb.err_hist, equal_nan=True)
    assert kp.compensated_residual.launches == 2
    assert kp.compensated_residual_plain.calls == 2
    assert (kp.pair_residual.launches > 0) == guarantee
    assert kp.pair_residual.launches == kp.pair_residual_plain.calls


# the C entry point each wrapper of kernels.KERNELS launches
ENTRY_POINTS = {
    "K1 poisson_iter": "ns3d_poisson_iter",
    "K2 poisson_iter_ext": "ns3d_poisson_iter_ext",
    "K3 predict": "ns3d_predict", "K4 correct": "ns3d_correct",
    "K5 advect": "ns3d_advect", "K6 advect_pre": "ns3d_advect",
    "K7 poisson_iter_bc": "ns3d_poisson_iter_bc",
    "K8 poisson_iter_sweeps": "ns3d_poisson_iter_sweeps",
    "K10 poisson_iter_resident": "ns3d_poisson_iter_resident",
    "K12 poisson_iter_resident_ext": "ns3d_poisson_iter_resident_ext",
    "K7-dist poisson_iter_bc_dist": "ns3d_poisson_iter_bc_dist",
    "K2-dist poisson_iter_ext_bc_dist": "ns3d_poisson_iter_ext_bc_dist",
    "K13 compensated_residual": "ns3d_comp_residual",
    "K13-pair pair_residual": "ns3d_comp_residual",
}
FIRST_STEP_SCRIPT = """
import json
import navierstokes3d_tpu_torch as nt
from navierstokes3d_tpu_torch import kernels
from navierstokes3d_tpu_torch.utils import profiling
s = nt.ChorinSolver(nt.preset_multi(nx=63, compat=False, dtype="float32"),
                    device="cuda")
st = s.init_state()
kernels.reset_counts()
st, _ = s.step(st)
launched = {k.name: k.wrapper.launches for k in kernels.KERNELS}
n = len(profiling.setup_records())
st, _ = s.step(st)
print(json.dumps({"serial": s.serial, "launched": launched,
                  "after_second": len(profiling.setup_records()) - n,
                  "records": profiling.setup_records()}))
"""


def test_first_step_records_the_library_and_each_first_launch():
    """A fresh process's first step on the card (multi preset at 63, K10
    and K12 on their plan): the library's load once inside it, one
    ns3d.setup.launch inside it per C entry point its wrappers launched,
    the pool's new segments and bytes in its detail; the second step
    records nothing."""
    import json
    import os
    import subprocess
    import sys
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    out = subprocess.run(
        [sys.executable, "-c", FIRST_STEP_SCRIPT], capture_output=True,
        text=True, timeout=600,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    recs = got["records"]
    (step,) = [r for r in recs if r["name"] == "ns3d.setup.first_step"]
    assert step["solver"] == got["serial"] and step["parent"] is None
    assert step["detail"]["new_segments"] >= 0
    assert step["detail"]["new_bytes"] >= 0
    (load,) = [r for r in recs if r["name"] == "ns3d.setup.kernels"]
    assert load["parent"] == step["id"]
    launches = [r for r in recs if r["name"] == "ns3d.setup.launch"]
    assert all(r["parent"] == step["id"] for r in launches)
    entries = [r["detail"]["entry"] for r in launches]
    want = {ENTRY_POINTS[k] for k, n in got["launched"].items() if n}
    assert {"ns3d_predict", "ns3d_poisson_iter_resident"} <= want
    assert sorted(entries) == sorted(want)
    assert got["after_second"] == 0
