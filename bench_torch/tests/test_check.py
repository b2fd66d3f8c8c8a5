"""The check that decides `correct`, on the CPU at grids a test run can
hold: a whole run of each cell (harness.run_cell, the look for a card
skipped) through the program's plain versions is correct; the same run
with the timed path broken underneath is not; and the control, the plain
reference put in the program's place in bfloat16, fails the cell's
limits. The card's readings that set the limits are in PERF.md.

Grid: nx = 63 (from rest at 15 nothing moves in the interior in the
first steps), the cell's own cycle."""

import dataclasses

import pytest
import torch

import harness

SEED = 2**31 + 4321
CELLS = {"multi255.step1.pt": 63}


@pytest.fixture
def small():
    """run_cell on the CPU at the cell's test grid."""
    def run(workload, hook=None):
        return harness.run_cell(workload, SEED, 0.3, False, device="cpu",
                                nx=CELLS[workload], require_card=False,
                                solver_hook=hook)
    return run


def _wrap(change):
    """A solver hook whose step runs the program's and then `change(old,
    new)` on the state it returns."""
    def hook(solver):
        step = solver.step

        def broken(st):
            new, stats = step(st)
            return change(st, new), stats
        solver.step = broken
    return hook


def _unchanged(old, new):
    return old


def _altered(old, new):
    pr = new.pr.clone()
    mid = tuple(n // 2 for n in pr.shape)
    pr[mid] += 0.1 * float(pr.abs().max()) + 1.0
    return new.replace(pr=pr)


def _half_left_out(old, new):
    vx, c = new.vx.clone(), new.c.clone()
    vx[: vx.shape[0] // 2] = old.vx[: vx.shape[0] // 2]
    c[: c.shape[0] // 2] = old.c[: c.shape[0] // 2]
    return new.replace(vx=vx, c=c)


def _early_stop(solver):
    """The solve stopped at 10 x eps_it: a tenfold weaker convergence."""
    num = solver.cfg.numerics
    solver.cfg = solver.cfg.replace(numerics=dataclasses.replace(
        num, eps_it=10.0 * num.eps_it))


FAULTS = {"unchanged": _wrap(_unchanged), "altered": _wrap(_altered),
          "half_left_out": _wrap(_half_left_out), "early_stop": _early_stop}


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_sound_run_is_correct(small, workload):
    r = small(workload)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", sorted(CELLS))
def test_broken_timed_path_is_not_correct(small, workload, fault):
    r = small(workload, FAULTS[fault])
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_early_stop_fails_p_gap(small, workload):
    """The reference's own reading catches a solve stopped early, also
    where the program reported its err below eps_it."""
    r = small(workload, _early_stop)
    assert not r["checks"]["p_gap"]["value"] <= r["checks"]["p_gap"]["limit"]


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_bf16_control_fails_the_limits(workload):
    cell = harness.load_cell(workload, CELLS[workload])
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
