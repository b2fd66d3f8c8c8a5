"""K12, nit of K2's (hi, lo) iterations in one launch resident on chip, and
the extended phase's route onto it (models/chorin.py `_ext_loop`): where
K10 has a plan for the grid (`_resident_plan`), each check interval of
the extended phase runs as one K12 launch. On the CPU the plain versions
run (the plan is decided as on an H100), and the route must take every
decision of the K2 loop:

  1. K12's plain version against nit calls of K2's, odd and even nit:
     hi, lo, dpr and the check value bitwise, the result in the caller's
     tensors;
  2. whole steps of the multi preset at an eps_it that the float32 phase
     1 cannot reach (so the extended phase runs), route on against
     `_resident_plan = None`: every field bitwise equal, the same
     iterations, errors and check history; one case runs the stored-state
     guarantee (K2) after the route;
  3. `_ext_loop` alone, on a budget that runs out unconverged (so the
     trailing `rem` iterations run on K2) and on one where the stall exit
     fires: the K2 loop's carry, iterations, err and history; under a
     plan whose blocks K12's do not hold, K2 alone;
  4. K12's kernel group puts its launches in the poisson layer."""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import navierstokes3d_tpu_torch as nt
from navierstokes3d_tpu_torch import kernels
from navierstokes3d_tpu_torch.kernels import poisson as kp
from navierstokes3d_tpu_torch.ptloop import pt_loop_fused

torch.set_num_threads(2)
FIELDS = ("pr", "vx", "vy", "vz", "c", "dprdtau", "pr_lo")


def _multi(nx, eps_it):
    cfg = nt.preset_multi(nx=nx, compat=False, dtype="float32")
    return cfg.replace(numerics=dataclasses.replace(cfg.numerics,
                                                    eps_it=eps_it))


def _solver(cfg, route: bool):
    s = nt.ChorinSolver(cfg, device="cpu")
    assert s._sweep_depths == () and s._resident_plan is not None
    if not route:
        s._resident_plan = None
    return s


def _pair_inputs(s, seed=3):
    """A pressure pair (lo at the rounding level of hi), a zero-ring dpr
    and a right-hand side on the solver's grid."""
    g, rng = s.grid, np.random.default_rng(seed)

    def field(scale):
        return torch.tensor(rng.standard_normal(g.shape_c).astype(np.float32)
                            * scale)
    hi = s.set_bc_pr(field(50.0))
    lo = field(50.0 * 2.0 ** -24)
    dpr = torch.zeros(g.shape_c)
    dpr[1:-1, 1:-1, 1:-1] = field(1e3)[1:-1, 1:-1, 1:-1]
    return hi, lo, dpr, field(1e5)


@pytest.mark.parametrize("nit", [1, 2, 5, 8])
def test_k12_plain_is_nit_k2_plain(nit):
    """K12's plain version against nit calls of K2's plain version, the
    check on the last: hi, lo, dpr and the check value bitwise, the
    result in the caller's hi and lo (for odd nit too, through the
    scratch copy), NaN in the scratch never read."""
    s = nt.ChorinSolver(_multi(15, 1e-3), device="cpu")
    hi, lo, dpr, rhs = _pair_inputs(s)
    h, l, d = hi.clone(), lo.clone(), dpr.clone()
    sh, sl = (torch.full_like(hi, float("nan")) for _ in range(2))
    kernels.reset_counts()
    e = kp.poisson_iter_resident_ext(h, l, d, rhs, s._op, nit, sh, sl)
    assert (kp.poisson_iter_resident_ext_plain.calls,
            kp.poisson_iter_resident_ext_plain.iterations,
            kp.poisson_iter_ext_plain.calls) == (1, nit, 0)
    q = (hi.clone(), lo.clone(), torch.empty_like(hi), torch.empty_like(lo))
    dq = dpr.clone()
    for j in range(nit):
        e2 = kp.poisson_iter_ext_plain(*q, dq, rhs, s._op, j == nit - 1)
        q = (q[2], q[3], q[0], q[1])
    assert torch.equal(h, q[0]) and torch.equal(l, q[1])
    assert torch.equal(d, dq)
    assert float(e) == float(e2)
    # the scratch is allocated where the caller gives none
    h2, l2, d2 = hi.clone(), lo.clone(), dpr.clone()
    e3 = kp.poisson_iter_resident_ext_plain(h2, l2, d2, rhs, s._op, nit)
    assert torch.equal(h2, h) and torch.equal(l2, l) and torch.equal(d2, d)
    assert float(e3) == float(e)
    with pytest.raises(ValueError, match="nit"):
        kp.poisson_iter_resident_ext(h, l, d, rhs, s._op, 0)


def _steps(s, n=2):
    state, stats = s.init_state(), []
    for _ in range(n):
        state, st = s.step(state)
        stats.append(st)
    return state, stats


@pytest.mark.parametrize("nx,eps_it,guarantee", [(15, 1e-9, False),
                                                 (31, 1e-7, False),
                                                 (31, 1e-9, True)],
                         ids=["multi15", "multi31", "multi31-guarantee"])
def test_ext_route_steps_are_k2_steps(nx, eps_it, guarantee):
    """Two steps of the multi preset from init_state with the route on
    and off, at an eps_it below phase 1's float32 floor so that the
    extended phase runs: the same iterations, iters_ext, err and check
    history, every field bitwise equal. With the route on the extended
    phase runs on K12 (its iterations and K2's together the route-off
    run's K2 iterations); at 31 and 1e-9 step 2's phase stalls and the
    stored-state guarantee runs K2 after the route."""
    cfg = _multi(nx, eps_it)
    runs = []
    for route in (False, True):
        s = _solver(cfg, route)
        kernels.reset_counts()
        state, stats = _steps(s)
        runs.append((state, stats, kp.poisson_iter_ext_plain.calls,
                     kp.poisson_iter_resident_ext_plain.calls,
                     kp.poisson_iter_resident_ext_plain.iterations))
    (b, stats_off, k2_off, k12_off, _), (a, stats_on, k2_on, k12_on,
                                         k12_iters) = runs
    for sa, sb in zip(stats_on, stats_off):
        assert (sa.iters, sa.iters_ext, sa.err, sa.advect_clamped) == (
            sb.iters, sb.iters_ext, sb.err, sb.advect_clamped)
        np.testing.assert_array_equal(sa.err_hist, sb.err_hist)
    assert sum(st.iters_ext for st in stats_on) == k2_off > 0
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        assert x is None or torch.equal(x, y), f
    assert k12_off == 0 and k12_on > 0
    assert k12_iters + k2_on == k2_off
    assert (k2_on > 0) == guarantee


@pytest.mark.parametrize("exit_by", ["budget", "stall"])
@pytest.mark.parametrize("rem", [5, 0])
def test_ext_loop_route_is_k2_loop(exit_by, rem):
    """`_ext_loop` on a budget of 6 checks and rem = 5 or 0 from the pair
    (hi, 0): with eps_it out of reach it runs out of budget and the
    trailing rem iterations run (on K2); with a stall window of one check
    at ratio 0.5 it stalls on a check before the last. The route's carry,
    iterations, err and history are the K2 loop's, and both are the loop
    of K2 iterations over the whole budget of 6 checks and rem, with no
    tail; K12 ran once a check, for the iterations less the tail."""
    cfg = _multi(15, 1e-3)
    on, off = _solver(cfg, True), _solver(cfg, False)
    hi, _, dpr, rhs = _pair_inputs(on)
    nchk = on.grid.nchk
    stall = (0.5, 1) if exit_by == "stall" else None
    eps = np.float32(1e-30)

    def carry():
        return (hi.clone(), torch.zeros_like(hi), torch.empty_like(hi),
                torch.empty_like(hi), dpr.clone())
    off._stall = stall
    chain = off._ext_chain(rhs, off._err_scale())
    c_ref, it_ref, e_ref, h_ref = pt_loop_fused(
        chain, carry(), 0, 6 * nchk + rem, nchk, 6, eps, off.dtype,
        stall=stall)
    out = []
    for s in (off, on):
        s._stall = stall
        kernels.reset_counts()
        out.append(s._ext_loop(s._ext_chain(rhs, s._err_scale()), rhs,
                               s._err_scale(), carry(), 6, rem, eps))
    (c_off, it_off, e_off, h_off), (c_on, it_on, e_on, h_on) = out
    assert (it_off, e_off) == (it_ref, e_ref)
    np.testing.assert_array_equal(h_off, h_ref)
    for k in (0, 1, 4):
        assert torch.equal(c_off[k], c_ref[k]), k
    if exit_by == "budget":
        assert it_off == 6 * nchk + rem
        tail = rem
    else:
        assert nchk < it_off < 6 * nchk and it_off % nchk == 0
        tail = 0
    assert (it_on, e_on) == (it_off, e_off)
    np.testing.assert_array_equal(h_on, h_off)
    for k in (0, 1, 4):
        assert torch.equal(c_on[k], c_off[k]), k
    assert kp.poisson_iter_resident_ext_plain.calls == (it_on - tail) // nchk
    assert kp.poisson_iter_resident_ext_plain.iterations == it_on - tail
    assert kp.poisson_iter_ext_plain.calls == tail


def test_ext_loop_takes_k2_where_k12_blocks_do_not_hold_the_plan():
    """K10's plans of more column slots a block than K12's blocks have
    threads (`resident_ext_fits`) keep the K2 bodies: under such a plan
    `_ext_loop` runs K2 alone and ends as the K2 loop. The presets'
    plans fit."""
    sms = kp.H100_SMS
    for shape in ((255, 153, 153), (63, 38, 38)):
        assert kp.resident_ext_fits(kp.resident_plan(shape, sms))
    wide = kp.resident_plan((8, sms // 2 * 24 + 1, 33), sms)
    assert wide.per_block == 800 > kp.RESIDENT_EXT_THREADS
    assert not kp.resident_ext_fits(wide) and not kp.resident_ext_fits(None)
    cfg = _multi(15, 1e-3)
    s, off = _solver(cfg, True), _solver(cfg, False)
    s._resident_plan = wide
    hi, _, dpr, rhs = _pair_inputs(s)
    out = []
    for solver in (off, s):
        kernels.reset_counts()
        carry = (hi.clone(), torch.zeros_like(hi), torch.empty_like(hi),
                 torch.empty_like(hi), dpr.clone())
        out.append(solver._ext_loop(
            solver._ext_chain(rhs, solver._err_scale()), rhs,
            solver._err_scale(), carry, 2, 3, np.float32(1e-30)))
    assert out[1][1] == out[0][1] == 2 * s.grid.nchk + 3
    assert all(torch.equal(a, b) for a, b in zip(out[1][0], out[0][0]))
    assert kp.poisson_iter_resident_ext_plain.calls == 0
    assert kp.poisson_iter_ext_plain.calls == out[1][1]


def _bench_work():
    """bench_torch/work.py, loaded from its file as the benchmark's own
    modules are not on the tests' path."""
    import importlib.util
    path = Path(__file__).resolve().parents[1] / "bench_torch" / "work.py"
    spec = importlib.util.spec_from_file_location("bench_work", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_k12_kernel_group_counts_the_route():
    """K12's kernel group (bench_torch/layers/k12_poisson_resident_ext.json)
    puts the route's launches in the poisson layer: its pattern matches
    the kernel of csrc/poisson.cu and neither K10's nor K2's, no other
    group's pattern matches it, and one launch counts its own 20 B a
    cell, 119.4 MB at 255x153x153, with K2's operations an iteration.
    The group names no counter (the tracer resolves every group's counter
    in the program it traces, and a program without K12 has no such
    wrapper); the wrapper counts its launches all the same."""
    work = _bench_work()
    groups = {g["group"]: g for g in work.load_groups()}
    group = groups["K12 poisson_iter_resident_ext"]
    assert group["layer"] == "poisson"
    assert "counter" not in group
    assert hasattr(kp.poisson_iter_resident_ext, "launches")
    src = (Path(kp.__file__).resolve().parents[1] / "csrc" / "poisson.cu"
           ).read_text()
    name = "poisson_resident_ext_kernel"
    assert f"{name}(" in src
    for other in ("poisson_resident_grid_kernel", "poisson_iter_ext_kernel"):
        assert other in src
        assert not any(re.search(p, other) for p in group["patterns"])
    assert [g for g in groups.values()
            if any(re.search(p, name) for p in g["patterns"])] == [group]
    assert round(work.bytes_per_launch(group, (255, 153, 153)) / 1e6,
                 1) == 119.4
    assert group["ops_per_cell"] == groups["K2 poisson_iter_ext"][
        "ops_per_cell"]
