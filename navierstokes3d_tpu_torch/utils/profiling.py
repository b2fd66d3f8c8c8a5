"""Profiling helpers: torch.profiler traces and step instrumentation.

  * trace(): context manager that profiles the enclosed work (CPU, and
    the card's kernels where the process has one) and writes a Chrome
    trace (trace.json, for chrome://tracing or Perfetto),
  * profile_steps(): times N solver steps, synchronizing the device around
    each, and returns the RunTimer summary with the Poisson iteration's
    bandwidth roofline where the card's memory rate is known.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch

from .timers import RunTimer, poisson_roofline_iters_per_sec

# device memory rates by card name (NVIDIA's data sheets), GB/s
_HBM_GBPS = {"h100": 3350.0}


def device_hbm_gbps(device: torch.device | str = "cuda") -> Optional[float]:
    """The device memory rate of `device` in GB/s, keyed on
    torch.cuda.get_device_name; None for the CPU or a card not in the
    table (no rate is assumed)."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(device).lower()
    for key, gbps in _HBM_GBPS.items():
        if key in name:
            return gbps
    return None


@contextlib.contextmanager
def trace(log_dir: str = "ns3d_trace"):
    """Profile the enclosed block with torch.profiler (CPU activity, and
    CUDA where available) and write log_dir/trace.json on exit. Yields
    log_dir."""
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def profile_steps(solver, state, n_steps: int = 3,
                  trace_dir: Optional[str] = None) -> dict:
    """Run n_steps solver steps (after a warm-up step of the caller's:
    the first step builds the kernels) with the device synchronized around
    each, and return the timing summary. roofline_iters_per_sec and
    roofline_fraction are None where the device's memory rate is unknown
    (the CPU included)."""
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
    g = solver.grid
    summary = timer.summary(skip_first=0)
    gbps = device_hbm_gbps(solver.device)
    roof = None if gbps is None else poisson_roofline_iters_per_sec(
        g.nx * g.ny * g.nz, solver.dtype.itemsize, gbps)
    summary["roofline_iters_per_sec"] = roof
    summary["roofline_fraction"] = (
        None if roof is None else summary["poisson_iters_per_sec"] / roof)
    return summary
