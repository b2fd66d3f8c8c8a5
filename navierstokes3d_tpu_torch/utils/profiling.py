"""Profiling helpers: the program's spans, its set-up records and
torch.profiler traces.

  * span(name): a named range around a phase of the step. With spans on
    (`spans()`), it is a torch.profiler.record_function range, on the
    same timeline and clock as the kernels of any torch.profiler trace,
    nested in the span around it; with spans off (the default) it is one
    shared no-op context manager (`NO_SPAN`), so an untraced step creates
    no range. The step's spans (models/chorin.py, ptloop.py,
    parallel/fullstep.py): ns3d.step > ns3d.predict, ns3d.poisson (>
    ns3d.poisson.first, .phase1, .phase2, .guarantee, .pair),
    ns3d.correct, ns3d.advect; ns3d.read around every read of a device
    scalar by the host (ptloop.host_scalar), inside whichever of these is
    open. None is entered inside a per-iteration loop body.
  * setup_span(name, **detail): a span around a part of set-up, which
    runs before any span switch or profiler is on. It always appends one
    record to the process's list (`setup_records()`): its name, start and
    end on time.perf_counter(), the enclosing set-up span (`parent`), the
    solver it belongs to (ChorinSolver.serial) and `detail`; with spans on
    it is also the record_function range of that name. The set-up spans:
    ns3d.setup.import (the package's __init__), ns3d.setup.solver
    (ChorinSolver.__init__), ns3d.setup.init_state, ns3d.setup.first_step
    (a solver's first step, `first_step`: on a CUDA device its detail
    holds the caching allocator's new segments and bytes over the step) >
    ns3d.setup.kernels (the kernel library's load, kernels/_build.py
    `load`) > ns3d.setup.kernels.build (nvcc, where `build` compiles),
    and ns3d.setup.launch (the first call in the process of each C entry
    point, `detail` entry naming it: the module's lazy load and its
    cudaFuncSetAttribute). Each runs once a process or once a solver.
  * trace(): context manager that profiles the enclosed work (CPU, and
    the card's kernels where the process has one) with spans on and
    writes a Chrome trace (trace.json, for chrome://tracing or Perfetto).
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time
from typing import List, Optional

import torch

# the span switch: read by span() on every call, set by spans()
spans_on = False
NO_SPAN = contextlib.nullcontext()

# the set-up records of the process, in the order their spans opened, and
# those of the set-up spans open now (the innermost last)
_setup: List[dict] = []
_open: List[dict] = []
_ids = itertools.count(1)


def span(name: str):
    """A record_function range named `name` with spans on, else the shared
    no-op context manager."""
    if not spans_on:
        return NO_SPAN
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def spans(on: bool = True):
    """Turn the program's spans on (or off) for the enclosed block."""
    global spans_on
    prev, spans_on = spans_on, bool(on)
    try:
        yield
    finally:
        spans_on = prev


@contextlib.contextmanager
def setup_span(name: str, *, solver: Optional[int] = None,
               start: Optional[float] = None, **detail):
    """Record the enclosed part of set-up as `name` (the module
    docstring); yields the record, whose `detail` the caller may extend.
    `solver` defaults to the enclosing set-up span's; `start`, a
    time.perf_counter() reading, dates the record's start back (the
    package's import, timed from its first statement)."""
    parent = _open[-1] if _open else None
    rec = {"id": next(_ids), "name": name,
           "start": time.perf_counter() if start is None else start,
           "end": None,
           "parent": None if parent is None else parent["id"],
           "solver": solver if solver is not None or parent is None
           else parent["solver"],
           "detail": detail}
    _setup.append(rec)
    _open.append(rec)
    try:
        with span(name):
            yield rec
    finally:
        rec["end"] = time.perf_counter()
        _open.pop()


def _pool(device) -> tuple:
    """(segments, bytes) the caching allocator has taken from the card so
    far."""
    s = torch.cuda.memory_stats(device)
    return (s.get("segment.all.allocated", 0),
            s.get("reserved_bytes.all.allocated", 0))


@contextlib.contextmanager
def first_step(solver: int, device: torch.device):
    """ns3d.setup.first_step around solver `solver`'s first step; on a CUDA
    device its detail gets `new_segments` and `new_bytes`, what the
    caching allocator took from the card during the step."""
    before = _pool(device) if device.type == "cuda" else None
    with setup_span("ns3d.setup.first_step", solver=solver) as rec:
        yield rec
        if before is not None:
            after = _pool(device)
            rec["detail"].update(new_segments=after[0] - before[0],
                                 new_bytes=after[1] - before[1])


def setup_records() -> List[dict]:
    """Copies of the process's set-up records, in the order their spans
    opened (a span still open has end None)."""
    return [dict(r, detail=dict(r["detail"])) for r in _setup]


def reset_setup() -> None:
    """Forget the process's set-up records (tests)."""
    _setup.clear()


@contextlib.contextmanager
def trace(log_dir: str = "ns3d_trace"):
    """Profile the enclosed block with torch.profiler (CPU activity, and
    CUDA where available), the program's spans on, and write
    log_dir/trace.json on exit. Yields log_dir."""
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof, spans():
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
