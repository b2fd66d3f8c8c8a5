"""The folded loops' K10 route (models/chorin.py `_folded_loop`): where
the sweep plan is off and K10 has a plan for the grid (`_resident_plan`),
each folded loop runs as one K10 launch that takes every check's exit
decision on the card (ptloop.pt_loop_device, kernels/poisson.py
`poisson_loop_resident`). On the CPU the plain versions run (K10's plan
is decided as on an H100), and the route must take every decision of the
K1 loop and of the host-driven K10 loop it replaces:

  1. whole steps of the gpu (defect) and multi (extended) presets and of
     accuracy='none', route on against `_resident_plan = None`: every
     field bitwise equal, the same iterations, errors and check history;
     K10 called once per folded loop that checked, for the checks and
     iterations (less the trailing partial chunk) the K1 loops ran;
  2. `_folded_loop` alone, on a budget that runs out unconverged (so the
     trailing `rem` iterations run on K1, where rem > 0) and on one where
     the stall exit fires, from global iteration 1 and 0, with K10 bodies
     and with the sweep plan's K8 bodies forced on: the K1 loop's carry,
     iterations, err and history;
  3. `_folded_loop` on each way a loop ends (eps_it, the defect phase 1's
     1000 x eps_it, the stall window, an inf and a NaN err, the budget
     with and without a tail, an err0 that makes the loop a no-op), from
     global iteration 1 and 0, against pt_loop_fused over host-driven
     K10 chunks (one launch a check interval, the parent route): the
     same carry, iterations, err and history, bit for bit, and one host
     read a loop."""

import dataclasses

import numpy as np
import pytest
import torch

import navierstokes3d_tpu_torch as nt
from navierstokes3d_tpu_torch import kernels, ptloop
from navierstokes3d_tpu_torch.kernels import poisson as kp

torch.set_num_threads(2)
FIELDS = ("pr", "vx", "vy", "vz", "c", "dprdtau", "pr_lo")


def _cfg(case):
    preset, nx, acc = case
    make = nt.preset_gpu if preset == "gpu" else nt.preset_multi
    cfg = make(nx=nx, compat=False, dtype="float32")
    if acc is not None:
        cfg = cfg.replace(numerics=dataclasses.replace(cfg.numerics,
                                                       accuracy=acc))
    return cfg


def _solver(cfg, route: bool):
    s = nt.ChorinSolver(cfg, device="cpu")
    assert s._sweep_depths == () and s._resident_plan is not None
    if not route:
        s._resident_plan = None
    return s


def _record_loops(s):
    """Wrap the solver's _folded_loop: each call's (it0, n_checked, rem,
    iterations run)."""
    calls, loop = [], s._folded_loop

    def wrapped(rhs, err_scale, carry, it0, n_checked, rem, *a, **kw):
        out = loop(rhs, err_scale, carry, it0, n_checked, rem, *a, **kw)
        calls.append((it0, n_checked, rem, out[1]))
        return out
    s._folded_loop = wrapped
    return calls


def _checks_and_iterations(loops, nchk):
    """The folded loops that took a check, the checks they ran and their
    iterations less the trailing partial chunk."""
    ran = checks = iters = 0
    for it0, n_checked, _rem, it in loops:
        end = min(it, n_checked)
        ran += end > it0
        checks += end // nchk - it0 // nchk
        iters += end - it0
    return ran, checks, iters


@pytest.mark.parametrize("case", [("gpu", 15, None), ("multi", 15, None),
                                  ("multi", 31, None), ("multi", 15, "none")],
                         ids=["gpu15", "multi15", "multi31", "none15"])
def test_route_steps_are_k1_steps(case):
    """Two steps from init_state with the route on and off (the gpu preset
    diverges at nx 24 in the JAX package itself, so it runs at 15)."""
    cfg = _cfg(case)
    on, off = _solver(cfg, True), _solver(cfg, False)
    loops = _record_loops(off)
    runs = []
    for s in (off, on):
        kernels.reset_counts()
        state, stats = s.init_state(), []
        for _ in range(2):
            state, st = s.step(state)
            stats.append(st)
        runs.append((state, stats))
    (b, stats_off), (a, stats_on) = runs
    for sa, sb in zip(stats_on, stats_off):
        assert (sa.iters, sa.iters_ext, sa.err, sa.advect_clamped) == (
            sb.iters, sb.iters_ext, sb.err, sb.advect_clamped)
        np.testing.assert_array_equal(sa.err_hist, sb.err_hist)
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        assert x is None or torch.equal(x, y), f
    # the counts are the route's run's (reset before it)
    ran, checks, iters = _checks_and_iterations(loops, on.grid.nchk)
    assert checks > 0
    assert kp.poisson_iter_resident_plain.calls == ran
    assert kp.poisson_iter_resident_plain.checks == checks
    assert kp.poisson_iter_resident_plain.iterations == iters
    assert kp.poisson_iter_resident.launches == 0


def _loop_inputs(s):
    """A folded loop's inputs from the multi preset's first step: the
    first iteration's carry and the folded RHS."""
    state = s.init_state()
    divv = s.predictor_divv(state)
    pr, dpr = s._first_iteration(state.pr, state.dprdtau, divv)
    return s._rhs3d(divv), pr, dpr


@pytest.mark.parametrize("it0", [1, 0])
@pytest.mark.parametrize("exit_by", ["budget", "stall"])
@pytest.mark.parametrize("body,rem", [("k10", 5), ("k10", 0), ("k8", 5)])
def test_folded_loop_route_is_k1_loop(it0, exit_by, body, rem):
    """`_folded_loop` on a budget of 6 checks and rem = 5 or 0: with eps_it
    out of reach it runs out of budget and the trailing rem iterations run
    (on K1); with a stall window of one check at ratio 0.5 it stalls on a
    check before the last. The route's carry, iterations, err and history
    are the K1 loop's. K10 bodies: K10 ran once for the loop, for its
    checks and its iterations less the tail. K8 bodies (the sweep plan
    forced on at depth 2, nchk 8): from global iteration 1, one K1 and
    one K8(2) launch first, then two K8(2) launches a body."""
    cfg = _cfg(("multi", 15, None))
    on, off = _solver(cfg, True), _solver(cfg, False)
    if body == "k8":
        on._sweep_depths = (2,)
    rhs, pr, dpr = _loop_inputs(on)
    nchk = on.grid.nchk
    n_checked = 6 * nchk
    stall = (0.5, 1) if exit_by == "stall" else None
    out = []
    for s in (off, on):
        kernels.reset_counts()
        carry = (pr.clone(), torch.empty_like(pr), dpr.clone(), None)
        out.append(s._folded_loop(rhs, s._err_scale(), carry, it0, n_checked,
                                  rem, np.float32(1e-30), stall))
    (c_off, it_off, e_off, h_off), (c_on, it_on, e_on, h_on) = out
    if exit_by == "budget":
        assert it_off == n_checked + rem
        tail = rem
    else:
        assert nchk < it_off < n_checked and it_off % nchk == 0
        tail = 0
    assert (it_on, e_on) == (it_off, e_off)
    np.testing.assert_array_equal(h_on, h_off)
    assert torch.equal(c_on[0], c_off[0]) and torch.equal(c_on[2], c_off[2])
    if body == "k10":
        assert kp.poisson_iter_resident_plain.calls == 1
        assert kp.poisson_iter_resident_plain.checks == (it_on - tail) // nchk
        assert kp.poisson_iter_resident_plain.iterations == (
            it_on - tail - it0)
        assert kp.poisson_iter_plain.calls == tail
    else:
        assert on._sweep_plan(n_checked) == 2
        start = 4 if it0 == 1 else 0
        assert kp.poisson_iter_resident_plain.calls == 0
        assert kp.poisson_iter_sweeps_plain.calls == (
            (it0 == 1) + (it_on - tail - start) // 2)
        assert kp.poisson_iter_plain.calls == tail + (it0 == 1)


# each way a folded loop ends: (preset, eps, stall, checks of budget, rem,
# err0, dtau factor); None: the solver's own (eps_it and its stall window,
# the whole budget and its rem). At nx 15 the multi preset's checks fall
# from 7.0e-4 below 1e-5 at the tenth; the gpu preset's from 34 below 1
# at the eighth; dtau x 2 (multi) and x 1.5 (gpu) make the iteration grow
# until a check reads NaN and inf.
EXITS = {
    "eps_it": ("multi", 1e-5, None, None, None, None, 1.0),
    "defect_1000_eps": ("gpu", 1.0, None, None, 0, None, 1.0),
    "stall": ("multi", 1e-30, (0.5, 1), 6, 5, None, 1.0),
    "nan": ("multi", 1e-30, None, 12, 0, None, 2.0),
    "inf": ("gpu", 1e-30, None, 12, 0, None, 1.5),
    "budget_tail": ("multi", 1e-30, None, 6, 5, None, 1.0),
    "budget_no_tail": ("multi", 1e-30, None, 6, 0, None, 1.0),
    "err0_no_op": ("multi", 1e-3, None, None, None, 5e-4, 1.0),
}


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _host_driven_k10(s, rhs, carry, it0, n_checked, rem, eps, stall, err0):
    """The folded loop as the host drove K10 before its checks moved onto
    the card: pt_loop_fused over one K10 launch (here its plain version)
    from global iteration it to the next check, its check value read
    after each."""
    nchk, err_scale = s.grid.nchk, s._err_scale()

    def body(c, it):
        nit = nchk - it % nchk
        ec = kp.poisson_iter_resident_plain(c[0], c[2], rhs, s._op, nit, c[1])
        return c, ec * err_scale, nit
    return s._fused(body, s._kernel_chain(rhs, err_scale), carry, it0,
                    n_checked, rem, eps, stall, err0)


@pytest.mark.parametrize("it0", [1, 0])
@pytest.mark.parametrize("exit_by", list(EXITS))
def test_device_loop_is_host_driven_k10_loop(exit_by, it0):
    """`_folded_loop` on K10's route (one launch a loop, its exits decided
    on the card) against pt_loop_fused over host-driven K10 chunks: the
    carry (pr, dpr), iterations, err and check history bit for bit; the
    loop ends as named; one read of the host (none for the no-op), one
    call of K10's plain version for the loop's checks and iterations."""
    preset, eps, stall, n_checks, rem, err0, dtau = EXITS[exit_by]
    s = _solver(_cfg((preset, 15, None)), True)
    rhs, pr, dpr = _loop_inputs(s)
    s._op = dataclasses.replace(s._op, dtau=s._op.dtau * dtau)
    num, nchk = s.cfg.numerics, s.grid.nchk
    budget, tail = s._budget()
    n_checked = (n_checks or budget) * nchk
    rem = tail if rem is None else rem
    stall = stall or (num.stall_ratio, num.stall_checks)
    eps = np.float32(eps)
    err0 = None if err0 is None else np.float32(err0)
    out = []
    for loop in (_host_driven_k10, type(s)._folded_loop):
        kernels.reset_counts()
        ptloop.reset_reads()
        carry = (pr.clone(), torch.empty_like(pr), dpr.clone(), None)
        out.append(loop(s, rhs, carry, it0, n_checked, rem, eps, stall,
                        err0) if loop is _host_driven_k10 else
                   loop(s, rhs, s._err_scale(), carry, it0, n_checked, rem,
                        eps, stall, err0))
    (c_ref, it_ref, e_ref, h_ref), (c, it, e, h) = out
    assert it == it_ref and _bits(e) == _bits(e_ref)
    np.testing.assert_array_equal(_bits(h), _bits(h_ref))
    for a, b in ((c[0], c_ref[0]), (c[2], c_ref[2])):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    tail = rem if it == n_checked + rem else 0
    checks = (it - tail) // nchk - it0 // nchk
    ends = {"eps_it": e < eps and it < n_checked,
            "defect_1000_eps": e < eps and it < n_checked,
            "stall": e >= eps and it < n_checked,
            "nan": np.isnan(e) and it < n_checked,
            "inf": np.isinf(e) and it < n_checked,
            "budget_tail": it == n_checked + rem and rem > 0,
            "budget_no_tail": it == n_checked and rem == 0,
            "err0_no_op": it == it0}
    assert ends[exit_by]
    # the card decided to run on at least once before the loop ended
    assert (checks >= 2) == (exit_by != "err0_no_op")
    assert ptloop.host_scalar.reads == (checks > 0)
    assert kp.poisson_iter_resident_plain.calls == (checks > 0)
    assert kp.poisson_iter_resident_plain.checks == checks
    assert kp.poisson_iter_resident_plain.iterations == it - tail - it0
    assert kp.poisson_iter_plain.calls == tail


def test_folded_loop_refuses_a_tail_before_it0():
    """A budget of no checked iterations from global iteration 1 with a
    tail would run the tail from the budget's end, before it0: refused
    (make_grid's niter is at least nchk, so no solve asks for it)."""
    cfg = _cfg(("multi", 15, None))
    s = _solver(cfg, True)
    rhs, pr, dpr = _loop_inputs(s)
    carry = (pr, torch.empty_like(pr), dpr, None)
    with pytest.raises(ValueError, match="_folded_loop"):
        s._folded_loop(rhs, s._err_scale(), carry, 1, 0, 5,
                       np.float32(1e-30), None)


def _bench_work():
    """bench_torch/work.py, loaded from its file as the benchmark's own
    modules are not on the tests' path."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "bench_torch" / "work.py"
    spec = importlib.util.spec_from_file_location("bench_work", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_k10_kernel_group_counts_the_route():
    """K10's kernel group (bench_torch/layers/k10_poisson_resident.json)
    puts the route's launches in the poisson layer: its counter is the
    wrapper's launch count, its patterns match the resident kernel of
    csrc/poisson.cu, and one launch counts K1's 20 B a cell, 119.4 MB at
    255x153x153."""
    import re
    from pathlib import Path
    work = _bench_work()
    group = {g["group"]: g for g in work.load_groups()}[
        "K10 poisson_iter_resident"]
    assert group["layer"] == "poisson"
    module, fn = group["counter"].split(".")
    assert getattr(kernels, module) is kp
    assert hasattr(getattr(kp, fn), "launches")
    src = (Path(kp.__file__).resolve().parents[1] / "csrc" / "poisson.cu"
           ).read_text()
    name = "poisson_resident_grid_kernel"
    assert name in src
    assert any(re.search(p, name) for p in group["patterns"])
    assert round(work.bytes_per_launch(group, (255, 153, 153)) / 1e6,
                 1) == 119.4
