"""What the wide grid's sweep plan counts, and the benchmark's readers of
it (bench_torch/metrics/sweeps_roofline.py, wide.iters_per_step.py):

  * K8's `.iterations`, s a launch or call, beside `.launches` and
    `.calls`, cleared by kernels.reset_counts;
  * on a sweep-plan step, every Poisson iteration the step counts
    (StepStats.iters) is a K8 iteration, a K1 launch (the warm-in's one,
    tails, the stored-state guarantee) or the exact first iteration (torch
    ops, one a step): the identity sweeps_roofline reads K8's iterations
    by from a trace;
  * sweeps_roofline's arithmetic on hand-built trace summaries at
    511x307x307: K8's 963.2 MB a launch against 0.2875 ms of HBM time
    (PERF.md section 6), the larger of the bytes and operations bounds,
    and None where no K8 launch was traced.

On the CPU the solver runs the plain versions; the sweep plan is forced on
at the depths a lane-tiled build offers (2 and 3), as
tests/test_torch_slice_wide.py does."""

import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import navierstokes3d_tpu_torch as nt
from navierstokes3d_tpu_torch import kernels
from navierstokes3d_tpu_torch.kernels import poisson as kp

torch.set_num_threads(2)
BENCH = Path(__file__).resolve().parents[1] / "bench_torch"
WIDE = (511, 307, 307)


@pytest.mark.parametrize("s", [2, 3, 4])
def test_k8_plain_counts_s_iterations_a_call(s):
    shape = (9, 8, 7)
    pr = torch.rand(shape)
    dpr, rhs = torch.zeros(shape), torch.rand(shape)
    op = kp.make_operator(
        {k: np.ones(n - 2) for k, n in
         zip(("xm", "xp", "ym", "yp", "zm", "zp"), (9, 9, 8, 8, 7, 7))},
        types.SimpleNamespace(dx=0.1, dy=0.1, dz=0.1, dtau=0.01, damp=0.9),
        torch.float32, "cpu")
    kernels.reset_counts()
    for _ in range(3):
        kp.poisson_iter_sweeps(pr, dpr, rhs, torch.empty_like(pr),
                               torch.empty_like(pr), op, s, False)
    assert kp.poisson_iter_sweeps_plain.calls == 3
    assert kp.poisson_iter_sweeps_plain.iterations == 3 * s
    # a CPU call runs the plain version: the wrapper launched nothing
    assert kp.poisson_iter_sweeps.launches == 0
    assert kp.poisson_iter_sweeps.iterations == 0


def test_reset_counts_clears_k8_iterations():
    kp.poisson_iter_sweeps.iterations = 7
    kp.poisson_iter_sweeps_plain.iterations = 9
    kernels.reset_counts()
    assert kp.poisson_iter_sweeps.iterations == 0
    assert kp.poisson_iter_sweeps_plain.iterations == 0


@pytest.fixture(scope="module")
def sweep_steps():
    """Two gpu steps at nx = 15 on the sweep plan (nchk 8: bodies of two
    K8(2) launches), the counts taken per step."""
    solver = nt.ChorinSolver(nt.preset_gpu(nx=15, compat=False,
                                           dtype="float32"), device="cpu")
    assert solver._sweep_depths == ()
    solver._sweep_depths = (2, 3)
    assert solver._sweep_plan(
        (solver.grid.niter // solver.grid.nchk) * solver.grid.nchk) == 2
    st, out = solver.init_state(), []
    for _ in range(2):
        kernels.reset_counts()
        st, stats = solver.step(st)
        out.append((stats, kp.poisson_iter_sweeps_plain.calls,
                    kp.poisson_iter_sweeps_plain.iterations,
                    kp.poisson_iter_plain.calls))
    return out


def test_sweep_step_counts_s_iterations_a_call(sweep_steps):
    for stats, calls, iters8, _ in sweep_steps:
        assert calls > 0 and iters8 == 2 * calls


def test_sweep_step_iterations_are_k8_k1_and_the_first(sweep_steps):
    """iters = K8's iterations + K1's calls + 1: the identity
    sweeps_roofline reads K8's iterations by (one K1 launch is one
    iteration; the exact first iteration runs as torch ops)."""
    for stats, _, iters8, k1 in sweep_steps:
        # the warm-in's K1 launch in phase 1; more only for tails and the
        # guarantee
        assert k1 >= 1
        assert iters8 == stats.iters - k1 - 1
        assert iters8 > 0.9 * stats.iters


@pytest.fixture
def bench(monkeypatch):
    """bench_torch/work.py and a loader of the readers in
    bench_torch/metrics/, each from its file with the benchmark's
    directory on the path (a reader's `import work`)."""
    monkeypatch.syspath_prepend(str(BENCH))
    import work

    def reader(name):
        spec = importlib.util.spec_from_file_location(
            "bench_metric_" + name.replace(".", "_"),
            BENCH / "metrics" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    k8 = {g["group"]: g for g in work.load_groups()}["K8 poisson_iter_sweeps"]
    return types.SimpleNamespace(work=work, reader=reader, k8=k8)


def _trace(work, k8_launches, k8_ms, k1_launches, iters):
    """A trace summary as bench_torch/tracing.py summarize makes it: K8's
    and K1's groups, and the traced steps."""
    groups = {g["group"]: {"us": 0.0, "launches": 0, "layer": g["layer"],
                           "spec": g} for g in work.load_groups()}
    groups["K8 poisson_iter_sweeps"].update(launches=k8_launches,
                                            us=k8_ms * 1e3)
    groups["K1 poisson_iter"].update(launches=k1_launches,
                                     us=0.5 * k1_launches * 1e3)
    return {"groups": groups, "steps": [{"iters": i} for i in iters]}


def _ctx(work, trace):
    return {"trace": trace, "grid": WIDE, "peaks": work.load_peaks(),
            "log": lambda *a: None}


def test_sweeps_roofline_bytes_bound(bench):
    """3300 K8(3) launches at 0.5471 ms, the probe's time a launch at 511:
    963.2 MB a launch over 3.35 TB/s is 0.2875 ms, 52.55% of it (the
    operations of 3 iterations, 0.0488 ms, lie below)."""
    work = bench.work
    t_launch = work.bytes_per_launch(bench.k8, WIDE) / 3.35e12
    assert round(work.bytes_per_launch(bench.k8, WIDE) / 1e6, 1) == 963.2
    assert round(t_launch * 1e3, 4) == 0.2875
    # two steps: 9900 K8 iterations, 2 K1 warm-in launches, 2 first ones
    tr = _trace(work, 3300, 3300 * 0.5471, 2, [4952, 4952])
    share = bench.reader("sweeps_roofline").read(_ctx(work, tr))
    assert share == pytest.approx(100.0 * t_launch / 0.5471e-3, rel=1e-12)
    assert 52.5 < share < 52.6


def test_sweeps_roofline_operations_bound(bench):
    """Where the iterations' operations outweigh the launches' bytes (a
    launch of many iterations), the operations bound sets the share:
    23 operations a cell-iteration over 67 TFLOP/s."""
    work = bench.work
    tr = _trace(work, 1, 10.0, 0, [101])    # 100 K8 iterations in 10 ms
    t_ops = 100 * work.ops_per_unit(bench.k8, WIDE) / 67e12
    assert t_ops > work.bytes_per_launch(bench.k8, WIDE) / 3.35e12
    share = bench.reader("sweeps_roofline").read(_ctx(work, tr))
    assert share == pytest.approx(100.0 * t_ops / 10e-3, rel=1e-12)


def test_sweeps_roofline_without_k8_is_none(bench):
    r = bench.reader("sweeps_roofline")
    assert r.read(_ctx(bench.work, None)) is None
    assert r.read(_ctx(bench.work,
                       _trace(bench.work, 0, 0.0, 3, [3000]))) is None


def test_wide_iters_per_step_reads_the_window(bench):
    r = bench.reader("wide.iters_per_step")
    cell = types.SimpleNamespace(traffic={"poisson_backend": "pt"})
    ctx = {"cell": cell, "window_steps": [{"iters": 9792}, {"iters": 10098}]}
    assert r.read(ctx) == 9945.0
    assert r.read(dict(ctx, window_steps=[])) is None
    cell.traffic = {"poisson_backend": "fdm"}
    assert r.read(ctx) is None
