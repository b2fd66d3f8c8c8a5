"""The check that decides `correct` for the gpu255.pt cell, on the CPU, as
test_check.py holds the cells it names: a whole run (harness.run_cell,
the look for a card skipped) through the program's plain versions is
correct; the same run with the timed path broken underneath is not; and
the control, the plain reference put in the program's place in bfloat16,
fails the cell's limits.

Grid: nx = 79. Smaller grids of the gpu preset do not hold four sound
steps: at 15 the flow passes two cells a step from step 2 on (the
select-shift window clamps 116 points, where the reference's gather does
not), at 55, 63, 71 and 75 at step 4, and 31-67 blow up in between (as
the JAX package's gpu preset does at 24). At 79 no point clamps in the
four steps of the cycle (largest |vx| 1.96 vin).

Window: a run keeps one cycle, a reservoir sample drawn from the seed
(harness.run_window), and the window may end inside a cycle. SEED keeps
cycle 0 among the first 16, and SECONDS outlasts three steps, so the
kept cycle is the first one, whole: all four steps are checked."""

import pytest
import torch

import harness
from test_check import FAULTS, _early_stop

SEED = 2**31 + 4332
SECONDS = 10.0
CELL = "gpu255.pt"
NX = 79


@pytest.fixture
def small():
    """run_cell on the CPU at the test grid."""
    def run(hook=None):
        return harness.run_cell(CELL, SEED, SECONDS, False, device="cpu",
                                nx=NX, require_card=False, solver_hook=hook)
    return run


def test_sound_run_is_correct(small):
    r = small()
    assert r["correct"], r["checks"]
    assert r["checks"]["steps"]["value"] == 4.0
    assert r["failed"] == 0 and r["attempted"] >= 4
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_timed_path_is_not_correct(small, fault):
    r = small(FAULTS[fault])
    assert not r["correct"], r["checks"]


def test_early_stop_fails_a_reference_reading(small):
    """The reference's own readings catch a solve stopped early, also
    where the program reported its err below eps_it: at 79 the residual
    (p_gap, how far the pressure lies from the exact solve, stays within
    its limit at this grid)."""
    r = small(_early_stop)
    assert any(not r["checks"][k]["value"] <= r["checks"][k]["limit"]
               for k in ("resid", "p_gap")), r["checks"]


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
