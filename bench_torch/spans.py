"""The program's own spans and host-read counter, read from one more
traced cycle.

The harness's trace pass keeps the program's spans off, so its readers
see the device timeline without the ranges the profiler mirrors onto it.
This pass runs after the check, once a run (the first reader that asks
triggers it; `result` caches it in the readers' context), on the card
the harness traced: it builds the cell's solver anew
(harness.build_solver), starts from harness.start_state with seed 0
(step 1's Poisson work is the same on every seed), warms one cycle up
and replays the cycle in a short window (harness.run_window), where
`SpanTracer`, a tracing.Tracer with the program's spans switched on while
it records, traces TRACED_CYCLES whole cycles, each with the harness's
warm-up schedule, spin kernel and re-trace: cycles, from the second on,
that follow a cycle in which the caching allocator made no new
cudaMalloc call. So the traced cycles run on a pool that has stopped
growing, as the cycles of the timed window do; the window's second
cycle, which the harness traces, may still grow it (PERF.md section 5).
The numbers are those of all traced cycles together: the host's pace
after each read varies from cycle to cycle.

The reduction (`reduce`) places every device operation and every idle gap
in the program's spans (the `ns3d.` ranges of
navierstokes3d_tpu_torch/utils/profiling.py):

  * a device operation belongs to the innermost span open on the host
    when it was launched: the runtime call (cudaLaunchKernel,
    cudaMemcpyAsync, ...) that shares its correlation id;
  * an idle gap in which the device waited on the host (the operation
    after it was launched after the gap began) belongs to the innermost
    span open on the host when the device ran out of work (the gap's
    start); a gap before an operation already queued (its launch call had
    returned when the gap began: the device's own dispatch between
    operations) belongs to the span that launched that operation; inside
    a step a gap counts only within that step's device window, from the
    start of the first operation launched in the step to the end of the
    last one; a gap that begins outside every step, and the part of a gap
    past its step's device window, is the harness's;
  * a runtime call (cudaMalloc) belongs to the innermost span open at its
    start.

It logs each span's count, host time, self time (host time less that of
its child spans), device time of what it launched, the device time of
the torch ops among those (no kernel group of layers/*.json claims them),
the idle in which the device waited on the host, the queued gaps, its
reads and its cudaMalloc calls (log only: a step on a pool that has
stopped growing makes none), per step, and returns the numbers the
per-layer readers report: `read_wait_ms_per_step` counts the waits begun
in ns3d.read; `step_idle_pct` every gap inside the steps. A program without
spans (ptloop.host_scalar.reads, utils.profiling.spans) gets None: the
pass is not run.
"""

from __future__ import annotations

import bisect
import gc
import re
from typing import Dict, List, Optional, Sequence, Tuple

import torch

import harness
import tracing as btrace
import work

PREFIX = "ns3d."
STEP = "ns3d.step"
READ = "ns3d.read"
# the replay's window: the cycles before the traced ones, then the traced
# cycles (and their re-traces) whatever the clock says
WINDOW_S = 3.0
TRACED_CYCLES = 4
# tracing starts at this cycle at the latest, whether the pool still
# grows or not
LAST_COLD_CYCLE = 8
# ranges the profiler mirrors onto the device's timeline: no device work
_NOT_WORK = (PREFIX, "bench.", "ProfilerStep")

Span = Tuple[float, float, str]              # host start, end (us), name
Op = Tuple[float, float, str, int]           # start, end, name, corr. id


def program_hooks():
    """(utils.profiling, ptloop.host_scalar) of the program, or None where
    it has no span switch or read counter."""
    from navierstokes3d_tpu_torch import ptloop
    from navierstokes3d_tpu_torch.utils import profiling
    if not hasattr(profiling, "spans") or not hasattr(ptloop.host_scalar,
                                                      "reads"):
        return None
    return profiling, ptloop.host_scalar


def pool_segments(device) -> int:
    """The memory segments the caching allocator has allocated so far
    (its cudaMalloc calls); 0 off the card."""
    if torch.device(device).type != "cuda":
        return 0
    return torch.cuda.memory_stats(device).get("segment.all.allocated", 0)


class SpanTracer(btrace.Tracer):
    """tracing.Tracer with the program's spans on while it records, that
    traces TRACED_CYCLES cycles once the pool has stopped growing (or from
    cycle LAST_COLD_CYCLE on); keeps the events and the host reads of each
    cycle it traced whole (on the CPU, of each it traced)."""

    def __init__(self, device, groups: List[dict], profiling, host_scalar):
        super().__init__(device, groups)
        self.profiling, self.host_scalar = profiling, host_scalar
        self.switch = None
        self.reads0 = 0
        self.segments = pool_segments(device)
        self.grown: List[int] = []       # new segments in each cycle
        self.cycles: List[dict] = []

    def wants(self, cycle: int) -> bool:
        segments = pool_segments(self.device)
        if cycle >= 1:
            self.grown.append(segments - self.segments)
        self.segments = segments
        steady = cycle >= 1 and self.grown[-1] == 0
        return (len(self.cycles) < TRACED_CYCLES
                and self.tries < TRACED_CYCLES + btrace.TRIES
                and (steady or cycle >= LAST_COLD_CYCLE))

    def open(self) -> None:
        self.switch = self.profiling.spans()
        self.switch.__enter__()
        super().open()
        self.reads0 = self.host_scalar.reads

    def close(self, steps: List[dict]) -> None:
        reads = self.host_scalar.reads - self.reads0
        prof = self.prof
        try:
            super().close(steps)
        finally:
            self.switch.__exit__(None, None, None)
            self.switch = None
        if self.summary is not None or not self.on_card:
            self.cycles.append({"events": events_of(prof), "reads": reads,
                                "steps": len(steps),
                                "cycle": len(self.grown)})
        self.summary = None


def events_of(prof) -> Tuple[List[Span], List[Op], List[Op]]:
    """(the program's spans, device operations, runtime calls) of a
    finished torch.profiler run."""
    spans, dev, calls = [], [], []
    for e in prof.events():
        iv = (e.time_range.start, e.time_range.end, e.name)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not (e.name.startswith(_NOT_WORK) or "sleep" in e.name.lower()
                    or "spin_kernel" in e.name):
                dev.append((*iv, e.id))
        elif e.name.startswith(PREFIX):
            spans.append(iv)
        elif e.name.startswith("cu"):
            calls.append((*iv, e.id))
    return spans, dev, calls


def _gaps(dev: Sequence[Op]) -> List[Tuple[float, float, int]]:
    """The device's idle intervals between its first operation's start and
    its last one's end, each with the correlation id of the operation
    that ends it."""
    out = []
    ops = sorted(dev)
    if ops:
        cur = ops[0][1]
        for s, e, _, cid in ops[1:]:
            if s > cur:
                out.append((cur, s, cid))
            cur = max(cur, e)
    return out


def reduce(spans: Sequence[Span], dev: Sequence[Op], calls: Sequence[Op],
           groups: Sequence[dict] = ()) -> dict:
    """Device operations, idle gaps and runtime calls placed in the spans
    (the module docstring's rules). Returns per span path (the names from
    the outermost span down, joined by '>') its count and sums in us, and
    the sums the readers report."""
    spans = sorted(spans, key=lambda t: (t[0], -t[1]))
    starts = [s for s, _, _ in spans]
    parent: List[Optional[int]] = []
    stack: List[int] = []
    for i, (s, e, _) in enumerate(spans):
        while stack and spans[stack[-1]][1] <= s:
            stack.pop()
        parent.append(stack[-1] if stack else None)
        stack.append(i)
    path = []
    for i, (_, _, name) in enumerate(spans):
        p = parent[i]
        path.append(name if p is None else f"{path[p]}>{name}")

    def innermost(t: float) -> Optional[int]:
        # nested ranges: the containing span that started last
        for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
            if spans[i][1] > t:
                return i
        return None

    def step_of(i: Optional[int]) -> Optional[int]:
        while i is not None and spans[i][2] != STEP:
            i = parent[i]
        return i

    n = len(spans)
    dev_self, torch_self = [0.0] * n, [0.0] * n
    wait_self, queued_self = [0.0] * n, [0.0] * n
    mallocs_self = [0] * n
    window: Dict[int, List[float]] = {}          # step -> [first, last]
    launch = {cid: (s, e) for s, e, name, cid in calls}
    unmatched = hidden_reads = 0
    for s, e, name, cid in dev:
        t = launch.get(cid)
        i = None if t is None else innermost(t[0])
        unmatched += t is None
        if i is None:
            continue
        dev_self[i] += e - s
        if not any(re.search(p, name) for g in groups
                   for p in g["patterns"]):
            torch_self[i] += e - s
        if ("DtoH" in name or "Device -> Host" in name) and \
                spans[i][2] != READ:
            hidden_reads += 1
        st = step_of(i)
        if st is not None:
            w = window.setdefault(st, [s, e])
            w[0], w[1] = min(w[0], s), max(w[1], e)
    step_idle = read_wait = outside_idle = 0.0
    waits: List[Tuple[float, str]] = []
    for g0, g1, cid in _gaps(dev):
        t = launch.get(cid)
        # the operation after the gap was queued before the device ran out
        # of work (its launch call had returned): a dispatch gap, which
        # belongs to the span that launched that operation
        queued = t is not None and t[1] <= g0
        i = innermost(t[0]) if queued else innermost(g0)
        st = step_of(i)
        w = window.get(st) if st is not None else None
        idle = 0.0 if w is None else max(0.0, min(g1, w[1]) - max(g0, w[0]))
        outside_idle += g1 - g0 - idle
        if idle <= 0.0:
            continue
        step_idle += idle
        if queued:
            queued_self[i] += idle
            continue
        wait_self[i] += idle
        waits.append((idle, path[i]))
        if spans[i][2] == READ:
            read_wait += idle
    mallocs_steps = 0
    for s, _, name, _ in calls:
        if name == "cudaMalloc":
            i = innermost(s)
            if i is not None:
                mallocs_self[i] += 1
                mallocs_steps += step_of(i) is not None
    mallocs_out = len([c for c in calls if c[2] == "cudaMalloc"]) \
        - mallocs_steps
    # roll the self sums up to every enclosing span
    sums = {"device_us": dev_self, "torch_ops_us": torch_self,
            "wait_us": wait_self, "queued_us": queued_self,
            "reads": [int(sp[2] == READ) for sp in spans],
            "mallocs": mallocs_self}
    sums = {k: list(v) for k, v in sums.items()}
    child_host = [0.0] * n
    for i in range(n - 1, -1, -1):
        p = parent[i]
        if p is not None:
            for acc in sums.values():
                acc[p] += acc[i]
            child_host[p] += spans[i][1] - spans[i][0]
    by_path: Dict[str, dict] = {}
    for i, (s, e, _) in enumerate(spans):
        r = by_path.setdefault(path[i], dict(
            count=0, host_us=0.0, self_us=0.0, **{k: 0 for k in sums}))
        r["count"] += 1
        r["host_us"] += e - s
        r["self_us"] += e - s - child_host[i]
        for k, acc in sums.items():
            r[k] += acc[i]
    return {
        "steps": sum(1 for sp in spans if sp[2] == STEP),
        "device_ops": len(dev), "unmatched": unmatched,
        "hidden_reads": hidden_reads, "spans": by_path,
        "step_idle_us": step_idle,
        "step_window_us": sum(w[1] - w[0] for w in window.values()),
        "read_wait_us": read_wait, "outside_idle_us": outside_idle,
        "mallocs_in_steps": mallocs_steps, "mallocs_outside": mallocs_out,
        "longest_waits": sorted(waits, reverse=True)[:8],
    }


def merge(reds: Sequence[dict]) -> dict:
    """The reductions of several traced cycles as one: counts and sums
    added, per span path too; the longest waits of them all."""
    out = {k: sum(r[k] for r in reds) for k, v in reds[0].items()
           if isinstance(v, (int, float))}
    out["spans"] = {}
    for r in reds:
        for p, row in r["spans"].items():
            acc = out["spans"].setdefault(p, dict.fromkeys(row, 0))
            for k, v in row.items():
                acc[k] += v
    out["longest_waits"] = sorted((w for r in reds
                                   for w in r["longest_waits"]),
                                  reverse=True)[:8]
    return out


def metrics(red: dict, reads: int, steps: int) -> dict:
    """The three per-layer numbers: host reads a step from the program's
    counter; the device's from the reduction, None without device
    operations (a CPU trace) or steps."""
    out = {"host_reads_per_step": reads / steps if steps else None,
           "read_wait_ms_per_step": None, "step_idle_pct": None}
    n = red["steps"]
    if red["device_ops"] and n:
        out["read_wait_ms_per_step"] = red["read_wait_us"] / 1e3 / n
        if red["step_window_us"] > 0:
            out["step_idle_pct"] = (100.0 * red["step_idle_us"]
                                    / red["step_window_us"])
    return out


def log_table(red: dict, log) -> None:
    """Each span path's sums per step (times in ms), and the longest
    gaps in which the device waited on the host."""
    n = max(red["steps"], 1)
    log(f"bench: spans per step ({red['steps']} steps, {red['device_ops']}"
        f" device ops, {red['unmatched']} without their launch, "
        f"{red['hidden_reads']} copies to the host outside ns3d.read; "
        f"outside the steps: idle {red['outside_idle_us'] / 1e3:.3f} ms, "
        f"cudaMalloc {red['mallocs_outside']}): count, host, self, device, "
        f"torch ops, waited on the host, queued gaps, reads, cudaMalloc")
    for p, r in red["spans"].items():
        depth = p.count(">")
        log(f"bench: span {'  ' * depth}{p.rsplit('>', 1)[-1]:<24s} "
            + " ".join(f"{r[k] / n:8.2f}" if k in ("count", "reads",
                                                    "mallocs")
                       else f"{r[k] / 1e3 / n:9.3f}"
                       for k in ("count", "host_us", "self_us", "device_us",
                                 "torch_ops_us", "wait_us", "queued_us",
                                 "reads", "mallocs")))
    log("bench: spans: longest waits on the host (ms, span): " + ", ".join(
        f"{us / 1e3:.3f} {p.split('>', 1)[-1]}"
        for us, p in red["longest_waits"]))


def run(ctx, device) -> Optional[dict]:
    """The pass on `device` (the module docstring); None where the
    program has no spans or read counter."""
    log = ctx["log"]
    hooks = program_hooks()
    if hooks is None:
        log("bench: spans: the program has no spans or read counter; "
            "no spans pass")
        return None
    log("bench: spans: more traced cycles, the program's spans on (their "
        "`bench: trace` lines count the mirrored ranges as device work)")
    cell = ctx["cell"]
    cfg, traffic = cell.config, cell.traffic
    ref = cell.reference.Reference(cfg, device)
    solver = harness.build_solver(cfg, traffic, device)
    start = harness.start_state(solver, ref, cfg, 0, device)
    nt = int(cfg["nt"])
    st = harness.copy_state(start)
    for _ in range(nt):
        st, _ = solver.step(st)
    harness.sync(device)
    groups = work.load_groups()
    tracer = SpanTracer(device, groups, *hooks)
    harness.run_window(solver, start, nt, WINDOW_S, 0, device, st, tracer)
    del solver, start, st, ref
    gc.collect()
    if not tracer.cycles:
        log("bench: spans: no cycle traced")
        return None
    log(f"bench: spans: new pool segments in each cycle of the window "
        f"{tracer.grown}; traced cycles "
        f"{[c['cycle'] for c in tracer.cycles]}")
    reds = []
    for c in tracer.cycles:
        reds.append(reduce(*c["events"], groups))
        one = metrics(reds[-1], c["reads"], c["steps"])
        log(f"bench: spans: cycle {c['cycle']}: " + ", ".join(
            f"{k} {v!r}" for k, v in one.items()))
    red = merge(reds)
    reads = sum(c["reads"] for c in tracer.cycles)
    steps = sum(c["steps"] for c in tracer.cycles)
    log_table(red, log)
    out = metrics(red, reads, steps)
    log(f"bench: spans: {reads} host reads in {steps} traced steps; "
        + ", ".join(f"{k} {v!r}" for k, v in out.items()))
    return out


def result(ctx) -> Optional[dict]:
    """The spans pass's numbers for this run (run on the first call, then
    cached in the readers' context), or None where the program has no
    spans. The harness hands its readers no device: its trace summary
    (ctx["trace"]) exists only where its tracer saw device work, on the
    card it ran on, the current CUDA device; where there is none (a CPU
    run, or a trace that failed) the pass does not run."""
    if "ns3d_spans" not in ctx:
        ctx["ns3d_spans"] = None if ctx.get("trace") is None else run(
            ctx, torch.device("cuda", torch.cuda.current_device()))
    return ctx["ns3d_spans"]
