"""The port's set-up records (utils/profiling.py `setup_span`), on the CPU
at small grids: a solver's build, init_state and first step are recorded
once each, in order, grouped by the solver's serial number, whichever
step function runs the first step; the kernel library's load and each C
entry point's first call (kernels/_build.py `load`, `Library`) once a
process, inside the first step that reaches them (a fake library here:
the CPU runs no kernel); with spans off no record_function range opens,
inside trace() the Chrome trace holds the set-up spans; a compile in
`_build.build` (nvcc faked) counts one build and its seconds.

The card's own first step (the real library) is tests/test_torch_cuda.py
`test_first_step_records_the_library_and_each_first_launch`."""

import json
import os
import subprocess
import types

import pytest
import torch

import navierstokes3d_tpu_torch as nt
from navierstokes3d_tpu_torch.kernels import _build
from navierstokes3d_tpu_torch.parallel import make_mesh
from navierstokes3d_tpu_torch.parallel.fullstep import to_dist
from navierstokes3d_tpu_torch.utils import profiling

torch.set_num_threads(2)
STEPS = ("step", "shard_map", "fullstep")
PER_SOLVER = ("ns3d.setup.solver", "ns3d.setup.init_state",
              "ns3d.setup.first_step")


def _solver(nx=9):
    return nt.ChorinSolver(nt.preset_multi(nx=nx, compat=False,
                                           dtype="float32"), device="cpu")


def _two_steps(s, how="step"):
    """init_state, then two steps through the step function `how`."""
    st = s.init_state()
    if how == "step":
        step = s.step
    else:
        mesh = make_mesh((2, 1, 1), "cpu")
        if how == "shard_map":
            step = s.step_shard_map(mesh)
        else:
            step, st = s.step_fullstep(mesh), to_dist(st, mesh)
    for _ in range(2):
        st, stats = step(st)
    assert stats.iters > 0


def _of(solver):
    return [r for r in profiling.setup_records()
            if r["solver"] == solver.serial]


@pytest.mark.parametrize("how", STEPS)
def test_build_init_state_and_first_step_are_recorded_once(how):
    """Each of the solver's three set-up spans once, in order, closed, at
    the top level; the second step records nothing."""
    profiling.reset_setup()
    s = _solver(9 if how == "step" else 16)
    _two_steps(s, how)
    recs = _of(s)
    assert [r["name"] for r in recs] == list(PER_SOLVER)
    assert all(r["parent"] is None and r["end"] >= r["start"]
               for r in recs)
    assert all(a["end"] <= b["start"] for a, b in zip(recs, recs[1:]))
    assert profiling.setup_records() == recs
    assert recs[-1]["detail"] == {}       # no pool counts off the card


def test_each_solver_records_its_own_group():
    profiling.reset_setup()
    a, b = _solver(), _solver()
    assert b.serial > a.serial
    _two_steps(b)
    _two_steps(a)
    for s in (a, b):
        assert sorted(r["name"] for r in _of(s)) == sorted(PER_SOLVER)
    assert len(profiling.setup_records()) == 6


def _fake_library(monkeypatch, tmp_path):
    """_build.load() over a fake CDLL whose entry points return 0 and count
    their calls; load's cache cleared before and after."""
    calls = {}

    def entry(name):
        def fn(*args):
            calls[name] = calls.get(name, 0) + 1
            return 0
        return fn

    cdll = types.SimpleNamespace(**{n: entry(n) for n in _build.SIGNATURES},
                                 _name="fake")
    lib = tmp_path / "libfake.so"
    monkeypatch.setattr(_build, "build", lambda: _build.BuildResult(
        lib, False, 0.0, ""))
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: cdll)
    _build.load.cache_clear()
    return calls


def test_the_library_and_first_launches_are_recorded_once_a_process(
        monkeypatch, tmp_path):
    """Inside solver a's first step: the load once, one ns3d.setup.launch
    per entry point at its first call (detail naming it), none at its
    second; solver b's first step, launching the same entry points,
    records neither again. Names the library lacks come from the CDLL."""
    calls = _fake_library(monkeypatch, tmp_path)
    try:
        a, b = _solver(), _solver()
        profiling.reset_setup()
        entries = ("ns3d_predict", "ns3d_poisson_iter_resident",
                   "ns3d_predict", "ns3d_advect")
        for s in (a, b):
            with s._first_step():
                for name in entries:
                    assert _build.check(getattr(_build.load(), name)(1, 2),
                                        name) is None
        assert calls == {"ns3d_predict": 4, "ns3d_poisson_iter_resident": 2,
                         "ns3d_advect": 2}
        assert _build.load()._name == "fake"
        step_a, load, *launches = _of(a)
        assert step_a["name"] == "ns3d.setup.first_step"
        assert load["name"] == "ns3d.setup.kernels"
        assert [r["name"] for r in launches] == ["ns3d.setup.launch"] * 3
        assert [r["detail"]["entry"] for r in launches] == [
            "ns3d_predict", "ns3d_poisson_iter_resident", "ns3d_advect"]
        assert all(r["parent"] == step_a["id"] for r in (load, *launches))
        assert [r["name"] for r in _of(b)] == ["ns3d.setup.first_step"]
    finally:
        _build.load.cache_clear()


def _no_range(*a, **k):
    raise AssertionError("record_function called with spans off")


def test_setup_spans_off_open_no_record_function(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _no_range)
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        _no_range)
    profiling.reset_setup()
    assert profiling.spans_on is False
    s = _solver()
    _two_steps(s)
    assert [r["name"] for r in _of(s)] == list(PER_SOLVER)


def test_trace_holds_the_setup_spans(tmp_path):
    """Built, initialised and stepped inside trace(): the set-up spans are
    ranges of its Chrome trace, ns3d.step inside ns3d.setup.first_step."""
    profiling.reset_setup()
    with profiling.trace(str(tmp_path / "t")):
        _two_steps(_solver())
    with open(os.path.join(tmp_path, "t", "trace.json")) as f:
        ev = [e for e in json.load(f)["traceEvents"]
              if str(e.get("name", "")).startswith("ns3d.")
              and e.get("ph") == "X"]
    names = [e["name"] for e in ev]
    for name in PER_SOLVER:
        assert names.count(name) == 1, name
    first = next(e for e in ev if e["name"] == "ns3d.setup.first_step")
    steps = sorted((e for e in ev if e["name"] == "ns3d.step"),
                   key=lambda e: e["ts"])
    assert len(steps) == 2
    assert first["ts"] <= steps[0]["ts"] and (
        steps[0]["ts"] + steps[0]["dur"] <= first["ts"] + first["dur"])
    assert steps[1]["ts"] >= first["ts"] + first["dur"]


def test_a_compile_counts_one_build_and_its_seconds(monkeypatch, tmp_path):
    """_build.build with nvcc faked: the first call compiles (one build, its
    seconds counted, an ns3d.setup.kernels.build record of that length);
    the second finds the keyed library and counts nothing."""
    ran = []

    class Proc:
        def __init__(self, cmd, **kw):
            ran.append(cmd)
            open(cmd[cmd.index("-o") + 1], "w").close()
            self.returncode = 0

        def communicate(self):
            return ("ptxas info: fake\n", None)

    def run(cmd, **kw):
        ran.append(cmd)
        open(cmd[cmd.index("-o") + 1], "w").close()
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", Proc)
    monkeypatch.setattr(_build.subprocess, "run", run)
    monkeypatch.setattr(_build, "builds", 0)
    monkeypatch.setattr(_build, "build_s", 0.0)
    profiling.reset_setup()
    res = _build.build()
    assert res.compiled and res.path.exists() and "fake" in res.log
    assert len(ran) == len(list(_build.SRC_DIR.glob("*.cu"))) + 1
    assert _build.builds == 1 and _build.build_s == res.seconds > 0
    (rec,) = profiling.setup_records()
    assert rec["name"] == "ns3d.setup.kernels.build"
    assert 0 < rec["end"] - rec["start"] <= res.seconds
    again = _build.build()
    assert not again.compiled and again.path == res.path
    assert _build.builds == 1 and _build.build_s == res.seconds
    assert len(profiling.setup_records()) == 1
