"""The port's spans (utils/profiling.py `span`) and its count of host reads
(ptloop.host_scalar.reads), on the CPU at nx 15: with spans off a step
creates no record_function range; with spans on each phase span appears
once a step, nested as the step runs, and ns3d.read once per counted
read; every .item() of a step is a counted read; trace()'s Chrome trace
holds the step span; ptloop.reset_reads clears the count.

Paths: 'extended' (the multi preset's K2 accuracy phase), 'guarantee'
(the same with the stored-state guarantee forced), 'defect' (the gpu
preset's defect correction), 'plain' (accuracy 'none'); eps_it 1e-9, so
the accuracy phases run at nx 15."""

import collections
import dataclasses
import json
import os

import pytest
import torch

import navierstokes3d_tpu_torch as nt
from navierstokes3d_tpu_torch import kernels, ptloop
from navierstokes3d_tpu_torch.kernels import poisson as kp
from navierstokes3d_tpu_torch.parallel import make_mesh
from navierstokes3d_tpu_torch.parallel.fullstep import to_dist
from navierstokes3d_tpu_torch.utils import profiling

torch.set_num_threads(2)
PATHS = ("extended", "guarantee", "defect", "plain")
PHASES = {"extended": ("first", "phase1", "phase2", "pair"),
          "guarantee": ("first", "phase1", "phase2", "guarantee", "pair"),
          "defect": ("first", "phase1", "phase2", "pair"),
          "plain": ("first", "phase1")}


def _solver(path, monkeypatch=None):
    preset = nt.preset_gpu if path == "defect" else nt.preset_multi
    cfg = preset(nx=15, compat=False, dtype="float32")
    num = dataclasses.replace(cfg.numerics, eps_it=1e-9,
                              accuracy="none" if path == "plain" else None)
    s = nt.ChorinSolver(cfg.replace(numerics=num), device="cpu")
    if path == "guarantee":
        monkeypatch.setattr(s, "_marginal", lambda err: True)
    return s


def _state(s):
    """The state after one step from init_state (a moving flow)."""
    return s.step(s.init_state())[0]


def _no_range(*a, **k):
    raise AssertionError("record_function called with spans off")


@pytest.mark.parametrize("path", PATHS)
def test_spans_off_create_no_record_function(path, monkeypatch):
    s = _solver(path, monkeypatch)
    st = _state(s)
    assert profiling.spans_on is False
    monkeypatch.setattr(torch.profiler, "record_function", _no_range)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _no_range)
    st, stats = s.step(st)
    assert stats.iters > 0


def _ns3d_parent(e):
    p = e.cpu_parent
    while p is not None and not p.name.startswith("ns3d."):
        p = p.cpu_parent
    return None if p is None else p.name


@pytest.mark.parametrize("path", PATHS)
def test_spans_nest_as_the_step_runs(path, monkeypatch):
    """One step under torch.profiler with spans on: the four phase spans
    under ns3d.step, the solve's under ns3d.poisson, each once (so none
    sits in a loop body, which runs once an iteration); ns3d.read once a
    counted read, inside phase 1, phase 2, the guarantee or the
    advection, which reads once. Each span's reads are counted exactly:
    one a folded loop on K10's route (phase 1, and the defect solve's
    phase 2), one a K12 launch of the extended phase 2, the guarantee's
    one a test of its loop and one for its result, the defect's r0 and
    the advection's clamp count."""
    s = _solver(path, monkeypatch)
    st = _state(s)
    kernels.reset_counts()
    r0 = ptloop.host_scalar.reads
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof, \
            profiling.spans():
        st, stats = s.step(st)
    reads = ptloop.host_scalar.reads - r0
    assert profiling.spans_on is False
    ev = [e for e in prof.events() if e.name.startswith("ns3d.")]
    want = {"ns3d.step": None}
    want.update({f"ns3d.{n}": "ns3d.step"
                 for n in ("predict", "poisson", "correct", "advect")})
    want.update({f"ns3d.poisson.{n}": "ns3d.poisson" for n in PHASES[path]})
    if path == "defect":
        want["ns3d.poisson.defect"] = "ns3d.poisson.phase2"
    for name, parent in want.items():
        got = [e for e in ev if e.name == name]
        assert len(got) == 1, (name, len(got))
        assert _ns3d_parent(got[0]) == parent, name
    spans = {e.name for e in ev}
    assert spans == set(want) | {"ns3d.read"}
    read_parents = [_ns3d_parent(e) for e in ev if e.name == "ns3d.read"]
    assert s._resident_plan is not None
    want_reads = {"ns3d.poisson.phase1": 1, "ns3d.advect": 1}
    if path == "defect":
        want_reads.update({"ns3d.poisson.defect": 1,
                           "ns3d.poisson.phase2": 1})
    elif path != "plain":
        launches = kp.poisson_iter_resident_ext_plain.calls
        assert launches > 0
        want_reads["ns3d.poisson.phase2"] = launches
    if path == "guarantee":
        want_reads["ns3d.poisson.guarantee"] = (
            2 + nt.ChorinSolver.guarantee_iterations // s.grid.nchk)
    assert len(read_parents) == reads
    assert collections.Counter(read_parents) == want_reads
    if path != "plain":
        assert stats.iters_ext > 0


def test_defect_span_once_a_step_inside_phase2():
    """The gpu preset's defect solve, two steps with spans on: one
    ns3d.poisson.defect a step, inside ns3d.poisson.phase2, holding the
    compensated residual's one read; the same two steps with spans off
    count the same host reads, step for step."""
    s = _solver("defect")
    st0 = _state(s)
    counts = []
    for on in (False, True):
        st, per_step = st0, []
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            for _ in range(2):
                r0 = ptloop.host_scalar.reads
                if on:
                    with profiling.spans():
                        st, stats = s.step(st)
                else:
                    st, stats = s.step(st)
                per_step.append(ptloop.host_scalar.reads - r0)
                assert stats.iters_ext > 0
        counts.append(per_step)
        ev = [e for e in prof.events() if e.name.startswith("ns3d.")]
        defect = [e for e in ev if e.name == "ns3d.poisson.defect"]
        assert len(defect) == (2 if on else 0)
        assert all(_ns3d_parent(e) == "ns3d.poisson.phase2" for e in defect)
        inside = [e for e in ev if e.name == "ns3d.read"
                  and _ns3d_parent(e) == "ns3d.poisson.defect"]
        assert len(inside) == (2 if on else 0)
    assert counts[0] == counts[1] and min(counts[0]) > 2


def _count_items(monkeypatch):
    """Count every .item() and .tolist() (ptloop.host_array's one read of a
    whole tensor)."""
    calls = [0]
    for name in ("item", "tolist"):
        read = getattr(torch.Tensor, name)

        def counted(self, read=read):
            calls[0] += 1
            return read(self)
        monkeypatch.setattr(torch.Tensor, name, counted)
    return calls


@pytest.mark.parametrize("path", (*PATHS, "fdm", "fullstep"))
def test_every_item_of_a_step_is_a_counted_read(path, monkeypatch):
    """Every .item() a step calls goes through ptloop.host_scalar, and
    every .tolist() through ptloop.host_array, which count them; also on
    the fdm step and the full step on a (2, 1, 1) mesh of CPU shards (nx
    16)."""
    if path == "fdm":
        cfg = nt.preset_gpu(nx=15, compat=False, dtype="float32")
        s = nt.ChorinSolver(cfg.replace(numerics=dataclasses.replace(
            cfg.numerics, poisson_backend="fdm")), device="cpu")
        step, st = s.step, _state(s)
    elif path == "fullstep":
        s = nt.ChorinSolver(nt.preset_multi(nx=16, compat=False,
                                            dtype="float32"), device="cpu")
        mesh = make_mesh((2, 1, 1), "cpu")
        step, st = s.step_fullstep(mesh), to_dist(_state(s), mesh)
    else:
        s = _solver(path, monkeypatch)
        step, st = s.step, _state(s)
    calls = _count_items(monkeypatch)
    ptloop.reset_reads()
    step(st)
    assert calls[0] == ptloop.host_scalar.reads > 0


def test_trace_writes_the_step_span(tmp_path):
    """trace() turns spans on for its block (and off after it): its Chrome
    trace holds ns3d.step and the solve's spans."""
    s = _solver("extended")
    st = _state(s)
    with profiling.trace(str(tmp_path / "t")):
        assert profiling.spans_on is True
        st, _ = s.step(st)
    assert profiling.spans_on is False
    with open(os.path.join(tmp_path, "t", "trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"ns3d.step", "ns3d.poisson.phase2", "ns3d.read"} <= names


def test_reset_reads_clears_the_read_counter():
    s = _solver("plain")
    _state(s)
    assert ptloop.host_scalar.reads > 0
    ptloop.reset_reads()
    assert ptloop.host_scalar.reads == 0
    assert ptloop.host_scalar(torch.tensor(2.5), float) == 2.5
    assert ptloop.host_scalar(3.0, float) == 3.0
    assert ptloop.host_scalar.reads == 1
