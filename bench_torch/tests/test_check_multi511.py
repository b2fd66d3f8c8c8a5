"""The check that decides `correct` for the multi511.pt cell, on the CPU,
as test_check_gpu511.py holds gpu511.pt: a whole run (harness.run_cell,
the look for a card skipped) through the program's plain versions on the
cell's own route is correct; the same run with the timed path broken
underneath is not; and the control, the plain reference put in the
program's place in bfloat16, fails the cell's limits.

Route: at 511x307x307 no resident plan fits (kernels/poisson.py
resident_plan), so phase 1 runs on the sweep plan's K8 bodies and the
extended (hi, lo) phase on K2, one launch an iteration (models/chorin.py
`_ext_loop`). At a test grid the rows of ny*nz lanes are too few for the
sweep plan and a resident plan fits, so the solver hook forces the depths
on and the plan off. Phase 1 also meets the cell's eps_it = 1e-3 there
before its float32 floor, where at 511 it stalls above it and hands off
to the extended phase; the hook lowers the program's eps_it to 1e-7,
below that floor, so that K2's plain version runs the extended phase of
both steps (18 and 72 iterations; the harness still holds `err` and
`failed` to the configuration's 1e-3).

Grid: nx = 31 (31x19x19): nchk = 18 admits the cell's own depth, bodies of
two K8(3) launches. The solve stopped early is the run at 10 x the cell's
eps_it on the same route without the lowering. Where float32 alone meets
eps_it, as on this grid, a solve without its accuracy phase is sound: that
fault shows only at the cell's own size (calibrate.py's `accuracy_none`
reading on the card, PERF.md section 4).

Window: a run keeps one cycle, a reservoir sample drawn from the seed
(harness.run_window). SEED keeps cycle 0 among the first 16, and SECONDS
outlasts a cycle several times over and stays under 16 cycles, so the
kept cycle is the first one, whole: both steps are checked. A broken run
needs one step only (SHORT)."""

import dataclasses

import pytest
import torch

import harness
from navierstokes3d_tpu_torch import kernels
from navierstokes3d_tpu_torch.kernels import poisson as kp
from test_check import FAULTS

SEED = 2**31 + 4332
SECONDS = 3.0
SHORT = 0.3
CELL = "multi511.pt"
NX = 31
EPS_ROUTE = 1e-7


def _route(solver, eps_it=EPS_ROUTE):
    """The sweep plan forced on, the resident plan off, the program's
    eps_it set to `eps_it`; the kernels' counts reset."""
    solver._sweep_depths = (2, 3)
    solver._resident_plan = None
    solver.cfg = solver.cfg.replace(numerics=dataclasses.replace(
        solver.cfg.numerics, eps_it=eps_it))
    kernels.reset_counts()


def _run(seconds, fault=None, eps_it=EPS_ROUTE):
    iters = []

    def hook(solver):
        _route(solver, eps_it)
        step = solver.step

        def counted(st):
            new, stats = step(st)
            iters.append((int(stats.iters), int(stats.iters_ext)))
            return new, stats
        solver.step = counted
        if fault is not None:
            fault(solver)
    r = harness.run_cell(CELL, SEED, seconds, False, device="cpu", nx=NX,
                         require_card=False, solver_hook=hook)
    return r, iters


def test_sound_run_is_correct_on_k8_and_k2():
    r, iters = _run(SECONDS)
    assert r["correct"], r["checks"]
    assert r["checks"]["steps"]["value"] == 2.0
    assert r["failed"] == 0 and r["attempted"] >= 2
    assert list(r)[-1] == "checks"
    # the warm-up cycle and the window's steps: K8 and K2 carry the
    # iterations but one K1 launch a step (the warm-in's) and the exact
    # first iteration; K2 carries every extended iteration
    n8, n2 = (kp.poisson_iter_sweeps_plain.iterations,
              kp.poisson_iter_ext_plain.iterations)
    assert n2 == sum(e for _, e in iters) > 0
    assert n8 + n2 == sum(i for i, _ in iters) - \
        kp.poisson_iter_plain.calls - len(iters)
    assert kp.poisson_iter_resident_ext_plain.calls == 0
    assert kp.poisson_iter_resident_plain.calls == 0


@pytest.mark.parametrize("fault", sorted(set(FAULTS) - {"early_stop"}))
def test_broken_timed_path_is_not_correct(fault):
    """test_check.py's faults on the route: the state unchanged, a
    pressure value altered, half the field left out."""
    r, _ = _run(SHORT, FAULTS[fault])
    assert not r["correct"], r["checks"]


def test_early_stop_is_not_correct():
    """The solve stopped at 10 x the cell's eps_it, on the route."""
    r, _ = _run(SHORT, FAULTS["early_stop"], eps_it=1e-3)
    assert not r["correct"], r["checks"]


def test_bf16_control_fails_the_limits():
    cell = harness.load_cell(CELL, NX)
    cfg = cell.config
    ref = cell.reference.Reference(cfg, "cpu")
    ref16 = cell.reference.Reference(cfg, "cpu", dtype=torch.bfloat16)
    solver = harness.build_solver(cfg, cell.traffic, "cpu")
    start = harness.start_state(solver, ref, cfg, SEED, "cpu")
    st = {k: v.double() for k, v in harness.fields_of(start).items()}
    st["pr"] = ref.physical_pressure(st["pr"], solver.pressure_split)
    new, _ = ref16.step(st)
    nums = ref.check_step(st, {k: v.double() for k, v in new.items()},
                          cell.limits["ill_ulps"])
    limits = cell.limits["limits"]
    assert any(not nums[k] <= limits[k] for k in nums if k in limits), nums
