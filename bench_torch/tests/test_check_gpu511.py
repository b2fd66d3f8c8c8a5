"""The check that decides `correct` for the gpu511.pt cell, on the CPU, as
test_check_gpu255.py holds gpu255.pt: a whole run (harness.run_cell, the
look for a card skipped) through the program's plain versions on the
cell's own route, the sweep plan, is correct; the same run with the
timed path broken underneath (the solve stopped early among them) is not;
and the control, the plain reference put in the program's place
in bfloat16, fails the cell's limits.

Route: at 511x307x307 the folded loops run on the sweep plan (K8 bodies
in both PT phases; models/chorin.py sweep_depths is (2, 3) there). At a
test grid the rows of ny*nz lanes are too few for it, so the solver hook
forces the depths on, as tests/test_torch_slice_wide.py does, and K8's
plain version runs the bodies of both phases.

Grid: nx = 101 (101x61x61): nchk = ny - 1 = 60 admits the cell's own
depth, bodies of two K8(3) launches (nchk % 6 == 0), and the gpu
preset's two steps are sound there (1440 and 1380 iterations; p_gap
5.995e-07 at step 1, under the cell's limit of 8e-07). On the other grids
of that kind near it step 1 reads p_gap 2.5-3.1e-6 (nx 61, 71, 81, 91),
6.5e-7 (111) and 1.27e-6 (121): all but 111 above the limit, which the
card's readings at 511 set (PERF.md section 4).

Window: a run keeps one cycle, a reservoir sample drawn from the seed
(harness.run_window). SEED keeps cycle 0 among the first 16, and
SECONDS outlasts a step several times over, so the kept cycle is the
first one, whole: both steps are checked. A broken run needs one step
only (SHORT)."""

import pytest
import torch

import harness
from navierstokes3d_tpu_torch import kernels
from navierstokes3d_tpu_torch.kernels import poisson as kp
from test_check import FAULTS

SEED = 2**31 + 4332
SECONDS = 10.0
SHORT = 0.3
CELL = "gpu511.pt"
NX = 101


def _sweeps(solver, iters):
    """The sweep plan forced on; each step's Poisson iterations appended
    to `iters`; the kernels' counts reset."""
    solver._sweep_depths = (2, 3)
    step = solver.step

    def counted(st):
        new, stats = step(st)
        iters.append(int(stats.iters))
        return new, stats
    solver.step = counted
    kernels.reset_counts()


def _run(seconds, fault=None):
    iters = []

    def hook(solver):
        _sweeps(solver, iters)
        if fault is not None:
            fault(solver)
    r = harness.run_cell(CELL, SEED, seconds, False, device="cpu", nx=NX,
                         require_card=False, solver_hook=hook)
    return r, iters


def test_sound_run_is_correct_on_k8():
    r, iters = _run(SECONDS)
    assert r["correct"], r["checks"]
    assert r["checks"]["steps"]["value"] == 2.0
    assert r["failed"] == 0 and r["attempted"] >= 2
    assert list(r)[-1] == "checks"
    # the warm-up cycle and the window's steps: K8 carries the iterations
    # but one K1 launch a step (the warm-in's; more for tails or the
    # guarantee) and the exact first iteration
    n8 = kp.poisson_iter_sweeps_plain.iterations
    assert n8 == 3 * kp.poisson_iter_sweeps_plain.calls - 2 * len(iters)
    assert n8 == sum(iters) - kp.poisson_iter_plain.calls - len(iters)
    assert n8 > 0.9 * sum(iters)


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_timed_path_is_not_correct(fault):
    """test_check.py's faults: the state unchanged, a pressure value
    altered, half the field left out, the solve stopped early."""
    r, _ = _run(SHORT, FAULTS[fault])
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
