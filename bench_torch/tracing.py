"""The benchmark's own tracing: spans around the calls into the program,
nvidia-smi readings beside the window, and one cycle traced with
torch.profiler, reduced to device time per kernel group, busy and idle
time, and the breakdown of the result's last line.

The profiler's method is chip_smoke.py's `profile_step`: the tracer
drops launches at the start of its window, so the schedule has a warm-up
phase and a spin kernel (`torch.cuda._sleep`) opens the active window;
the spin and the profiler's own ranges are left out of every sum. Where
fewer launches of a kernel group were traced than the program's counter
saw, the next cycle is traced instead (a re-trace), up to `TRIES` times.
"""

from __future__ import annotations

import bisect
import importlib
import re
import subprocess
from typing import Dict, List, Optional

import torch

SMI = "clocks.sm,power.draw,power.limit,temperature.gpu"
TRIES = 3
SPIN_CYCLES = 2_000_000
# host activity under an idle gap: the check reads of the PT loop are
# device-to-host copies of one scalar
READS = ("Memcpy DtoH", "Memcpy Device -> Host")
# the host side of such a read: the copy and the wait for it
HOST_READS = ("cudaMemcpyAsync", "cudaMemcpy", "cudaStreamSynchronize",
              "aten::item", "aten::_local_scalar_dense")


def span(name: str):
    """A named range around a call into the program (on the profiler's
    timeline while it records)."""
    return torch.profiler.record_function(name)


def smi(query: str) -> str:
    """One nvidia-smi reading of `query` (csv, no header), or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({type(e).__name__})"
    return out.stdout.strip() or f"not read ({out.stderr.strip()[:80]})"


def _counter(path: str):
    """The wrapper whose `.launches` counts a group's launches
    (navierstokes3d_tpu_torch.kernels.<module>.<function>)."""
    mod, fn = path.rsplit(".", 1)
    return getattr(importlib.import_module(
        f"navierstokes3d_tpu_torch.kernels.{mod}"), fn)


class Tracer:
    """Traces one whole cycle of the window (the second, or a later one
    after a re-trace) and keeps its summary."""

    def __init__(self, device, groups: List[dict]):
        self.device = torch.device(device)
        self.groups = groups
        self.on_card = self.device.type == "cuda"
        self.summary: Optional[dict] = None
        self.tries = 0
        self.prof = None
        self.counts0: Dict[str, int] = {}

    def wants(self, cycle: int) -> bool:
        return cycle >= 1 and self.summary is None and self.tries < TRIES

    def _counts(self) -> Dict[str, int]:
        out = {}
        for g in self.groups:
            if g.get("counter"):
                out[g["group"]] = _counter(g["counter"]).launches
        return out

    def open(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(
            activities=acts,
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=1,
                                             repeat=1))
        self.prof.__enter__()
        if self.on_card:
            torch.cuda._sleep(SPIN_CYCLES // 4)
            torch.cuda.synchronize(self.device)
        self.prof.step()
        if self.on_card:
            torch.cuda._sleep(SPIN_CYCLES)
        self.counts0 = self._counts()

    def close(self, steps: List[dict]) -> None:
        counted = {k: v - self.counts0.get(k, 0)
                   for k, v in self._counts().items()}
        self.prof.step()
        self.prof.__exit__(None, None, None)
        self.tries += 1
        summary = summarize(self.prof, self.groups)
        self.prof = None
        summary["steps"] = steps
        missing = {k: (summary["groups"][k]["launches"], n)
                   for k, n in counted.items()
                   if summary["groups"][k]["launches"] < n}
        print(f"bench: trace {self.tries}: {len(steps)} steps, "
              f"{summary['kernels']} kernels, busy "
              f"{summary['busy_us'] / 1e3:.3f} ms of "
              f"{summary['span_us'] / 1e3:.3f} ms"
              + (f"; launches missing (traced, counted): {missing}"
                 if missing else ""), flush=True)
        if not missing and summary["kernels"] > 0:
            self.summary = summary


def _group_of(name: str, groups: List[dict]) -> Optional[dict]:
    for g in groups:
        if any(re.search(p, name) for p in g["patterns"]):
            return g
    return None


def summarize(prof, groups: List[dict]) -> dict:
    """Device time per kernel name and per group, busy time, the span from
    the first kernel's start to the last one's end, and the breakdown:
    the ten device operations that took most time and the idle gaps
    summed by what the host was doing at them."""
    dev, host = [], []
    for e in prof.events():
        name = e.name
        # the profiler's and the harness's own ranges (also mirrored on
        # the device's timeline) and the spin kernel are no device work
        if name.startswith(("ProfilerStep", "bench.")) \
                or "sleep" in name.lower() or "spin_kernel" in name:
            continue
        iv = (e.time_range.start, e.time_range.end, name)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append(iv)
        else:
            host.append(iv)
    dev.sort()
    by_name: Dict[str, List[float]] = {}
    gsum = {g["group"]: {"us": 0.0, "launches": 0, "layer": g["layer"],
                         "spec": g} for g in groups}
    unclaimed = 0.0
    for s, e, name in dev:
        rec = by_name.setdefault(name, [0.0, 0])
        rec[0] += e - s
        rec[1] += 1
    for name, (us, n) in by_name.items():
        g = _group_of(name, groups)
        if g is None:
            unclaimed += us
        else:
            gsum[g["group"]]["us"] += us
            gsum[g["group"]]["launches"] += n
    busy, gaps = 0.0, []
    if dev:
        cur_s, cur_e, last = dev[0][0], dev[0][1], dev[0][2]
        for s, e, name in dev[1:]:
            if s > cur_e:
                busy += cur_e - cur_s
                gaps.append((cur_e, s, last))
                cur_s = s
            if e >= cur_e:
                cur_e, last = e, name
        busy += cur_e - cur_s
    span_us = dev[-1][1] - dev[0][0] if dev else 0.0
    idle: Dict[str, float] = {}
    counts: Dict[str, int] = {}
    label = _gap_labeller(host)
    for g0, g1, before in gaps:
        lb = label(g0, g1, before)
        idle[lb] = idle.get(lb, 0.0) + (g1 - g0)
        counts[lb] = counts.get(lb, 0) + 1
    for label, us in sorted(idle.items(), key=lambda t: -t[1]):
        print(f"bench: idle {us / 1e3:.3f} ms in {counts[label]} gaps: "
              f"{label}", flush=True)
    top = sorted(by_name.items(), key=lambda t: -t[1][0])
    for name, (us, n) in top[:12]:
        print(f"bench: device {us / 1e3:10.3f} ms {n:6d} launches  "
              f"{name[:90]}", flush=True)
    return {
        "kernels": len(dev), "busy_us": busy, "span_us": span_us,
        "groups": gsum, "unclaimed_us": unclaimed,
        "breakdown": {
            "device_ops": [[n[:100], v[0] * 1e-6] for n, v in top[:10]],
            "idle_gaps": [[k, v * 1e-6] for k, v in
                          sorted(idle.items(), key=lambda t: -t[1])[:10]]},
    }


def _gap_labeller(host):
    """label(g0, g1, before): what the host was doing while the device sat
    idle from g0 to g1: a cycle restart or a step boundary (the harness's
    spans), a check read (the device's last operation before the gap,
    `before`, was a copy to the host, or the host sat in such a copy or
    the wait for it: the loop's scalar read), else the innermost host
    operation at the gap's middle."""
    restarts = sorted((s, e) for s, e, n in host
                      if n == "bench.cycle_restart")
    step_ends = sorted(e for s, e, n in host if n == "bench.step")
    ops = sorted((s, e, n) for s, e, n in host if not n.startswith("bench."))
    starts = [s for s, _, _ in ops]

    def label(g0, g1, before):
        if any(s < g1 and e > g0 for s, e in restarts):
            return "cycle restart"
        i = bisect.bisect_left(step_ends, g0)
        if i < len(step_ends) and step_ends[i] <= g1:
            return "step boundary"
        if any(r in before for r in READS):
            return "check read"
        mid = 0.5 * (g0 + g1)
        best = None
        # the host ops that started before the middle, the latest first:
        # the innermost one still running is among the last few hundred
        for k in range(bisect.bisect_right(starts, mid) - 1,
                       max(-1, bisect.bisect_right(starts, mid) - 400), -1):
            s, e, n = ops[k]
            if e >= mid and (best is None or e - s < best[0]):
                best = (e - s, n)
        if best is None:
            return "host: python"
        if best[1] in HOST_READS:
            return "check read"
        return "host: " + best[1][:60]
    return label
