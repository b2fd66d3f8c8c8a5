"""The set-up readers (metrics/setup.*.py) on synthetic record lists: the
first solver's records are taken where a second solver (the spans pass's)
follows; nvcc's build inside the first step is left out of
setup.first_step_s; a program without set-up records reads None; and the
readers on the records of a real solver on the CPU."""

import re

import pytest

import harness
from navierstokes3d_tpu_torch.utils import profiling

NAMES = ("setup.before_program_s", "setup.solver_s", "setup.first_step_s")


def _reader(name):
    return harness.load_module(harness.ROOT / "metrics" / f"{name}.py",
                               "bench_metric_" + re.sub(r"\W", "_", name))


def _rec(i, name, start, end, parent=None, solver=None, **detail):
    return {"id": i, "name": name, "start": start, "end": end,
            "parent": parent, "solver": solver, "detail": detail}


# process start at 0: import 5-6; solver 1 built 6-7.5, init_state 7.5-8,
# its first step 8-12 with the library's load 8-10.5 (nvcc 8.2-10.2 in
# it) and two first launches; then the spans pass's solver 2, 20-30
RECS = [
    _rec(1, "ns3d.setup.import", 5.0, 6.0),
    _rec(2, "ns3d.setup.solver", 6.0, 7.5, solver=1),
    _rec(3, "ns3d.setup.init_state", 7.5, 8.0, solver=1),
    _rec(4, "ns3d.setup.first_step", 8.0, 12.0, solver=1, new_segments=3,
         new_bytes=6 << 20),
    _rec(5, "ns3d.setup.kernels", 8.0, 10.5, parent=4, solver=1),
    _rec(6, "ns3d.setup.kernels.build", 8.2, 10.2, parent=5, solver=1),
    _rec(7, "ns3d.setup.launch", 10.5, 10.75, parent=4, solver=1,
         entry="ns3d_predict"),
    _rec(8, "ns3d.setup.launch", 11.0, 11.5, parent=4, solver=1,
         entry="ns3d_poisson_iter_resident"),
    _rec(9, "ns3d.setup.solver", 20.0, 20.5, solver=2),
    _rec(10, "ns3d.setup.init_state", 20.5, 20.6, solver=2),
    _rec(11, "ns3d.setup.first_step", 21.0, 30.0, solver=2),
]


def test_the_first_solver_is_read_where_two_were_built():
    solver_s = _reader("setup.solver_s")
    assert solver_s.first_solver(RECS) == 1
    assert solver_s.parts(RECS) == {"import": 1.0, "solver": 1.5,
                                    "init_state": 0.5}
    # the second solver alone: its own group
    second = [RECS[0]] + RECS[8:]
    assert solver_s.parts(second) == pytest.approx(
        {"import": 1.0, "solver": 0.5, "init_state": 0.1})
    assert _reader("setup.first_step_s").split(second)["value"] == 9.0
    assert _reader("setup.before_program_s").before_program_s(
        RECS, process_start=0.5) == 4.5


def test_nvcc_is_left_out_of_the_first_step():
    p = _reader("setup.first_step_s").split(RECS)
    assert p["value"] == pytest.approx(4.0 - 2.0)
    assert p["nvcc_s"] == pytest.approx(2.0)
    assert p["load_s"] == pytest.approx(0.5)
    assert p["launches"] == [("ns3d_predict", 0.25),
                             ("ns3d_poisson_iter_resident", 0.5)]
    # the step less its children (the load with nvcc, two launches)
    assert p["self_s"] == pytest.approx(4.0 - 2.5 - 0.75)
    assert p["value"] == pytest.approx(p["load_s"] + 0.75 + p["self_s"])
    assert (p["new_segments"], p["new_bytes"]) == (3, 6 << 20)
    # without the build the step reads whole
    no_build = [r for r in RECS if r["name"] != "ns3d.setup.kernels.build"]
    assert _reader("setup.first_step_s").split(no_build)["value"] == 4.0


def test_none_without_the_records(monkeypatch):
    monkeypatch.delattr(profiling, "setup_records")
    ctx = {"log": print}
    assert [_reader(n).read(ctx) for n in NAMES] == [None] * 3


def test_none_before_a_solver_or_its_first_step():
    assert _reader("setup.solver_s").parts(RECS[:1]) is None
    assert _reader("setup.first_step_s").split(RECS[:3]) is None
    assert _reader("setup.before_program_s").before_program_s(
        RECS[1:], 0.0) is None


def test_the_readers_on_a_solver_on_the_cpu(monkeypatch):
    """A solver built, initialised and stepped here, the process's first
    after the import (the records of earlier ones set aside): every reader
    reads a positive number of seconds and logs its split."""
    import navierstokes3d_tpu_torch as nt
    monkeypatch.setattr(profiling, "_setup", [
        r for r in profiling._setup if r["name"] == "ns3d.setup.import"])
    s = nt.ChorinSolver(nt.preset_multi(nx=9, compat=False,
                                        dtype="float32"), device="cpu")
    s.step(s.init_state())
    lines = []
    values = [_reader(n).read({"log": lines.append}) for n in NAMES]
    assert all(v is not None and v > 0 for v in values), values
    assert any(line.startswith("bench: setup.first_step_s") for line in lines)
