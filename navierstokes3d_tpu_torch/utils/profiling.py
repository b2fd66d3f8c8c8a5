"""Profiling helpers: the program's spans, torch.profiler traces and step
timing.

  * span(name): a named range around a phase of the step. With spans on
    (`spans()`), it is a torch.profiler.record_function range, on the
    same timeline and clock as the kernels of any torch.profiler trace,
    nested in the span around it; with spans off (the default) it is one
    shared no-op context manager, so an untraced step creates no range.
    The step's spans (models/chorin.py, ptloop.py, parallel/fullstep.py):
    ns3d.step > ns3d.predict, ns3d.poisson (> ns3d.poisson.first, .phase1,
    .phase2, .guarantee, .pair), ns3d.correct, ns3d.advect; ns3d.read
    around every read of a device scalar by the host (ptloop.host_scalar),
    inside whichever of these is open. None is entered inside a
    per-iteration loop body.
  * trace(): context manager that profiles the enclosed work (CPU, and
    the card's kernels where the process has one) with spans on and
    writes a Chrome trace (trace.json, for chrome://tracing or Perfetto),
  * profile_steps(): times N solver steps, synchronizing the device around
    each, and returns the RunTimer summary.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch

from .timers import RunTimer

# the span switch: read by span() on every call, set by spans()
spans_on = False
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A record_function range named `name` with spans on, else the shared
    no-op context manager."""
    if not spans_on:
        return _NO_SPAN
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


def profile_steps(solver, state, n_steps: int = 3,
                  trace_dir: Optional[str] = None) -> dict:
    """Run n_steps solver steps (after a warm-up step of the caller's:
    the first step builds the kernels) with the device synchronized around
    each, and return the timing summary; with trace_dir, under trace()."""
    sync = (torch.cuda.synchronize if solver.device.type == "cuda"
            else (lambda: None))
    timer = RunTimer()
    ctx = trace(trace_dir) if trace_dir else contextlib.nullcontext()
    with ctx:
        for it in range(n_steps):
            sync()
            timer.start()
            state, stats = solver.step(state)
            sync()
            timer.stop(it, int(stats.iters), float(stats.err))
    return timer.summary(skip_first=0)
