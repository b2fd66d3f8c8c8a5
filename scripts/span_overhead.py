"""The cost of the program's spans on one NVIDIA GPU, and when the caching
allocator's pool stops growing under the benchmark's replayed cycle.

    python3 scripts/span_overhead.py [--workload multi255.step1.pt]
        [--steps 12] [--pairs 3] [--seed 7]

Builds the cell's solver and start state as bench_torch/harness.py does
and warms one cycle up. Then, as the harness's trace does, it replays the
cycle in a short window (harness.run_window) and traces the window's
second cycle, with the program's spans on (bench_torch/spans.py's
tracer, made to trace that cycle whatever the pool does; this process's
first profiler session, as the harness's is), and prints the memory
segments the caching allocator allocated (cudaMalloc) in each cycle and
the traced cycle's cudaMalloc calls inside and outside ns3d.step. Then it
replays the cycle's first step from the start state (a copy of it each
time, as the window does) and prints the new segments of each of
2 * --steps replays. Then it times blocks of
--steps replays with the spans off and on, alternated in one process
(off, on, then on, off, ...; --pairs pairs), each block between two
synchronisations, and prints ms a step per block, the medians, on/off - 1
and the segments taken during the blocks. Prints the card's name and power
limit first.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path[:0] = [os.path.join(REPO, "bench_torch"), REPO]

import torch  # noqa: E402

import harness  # noqa: E402
import spans  # noqa: E402
import work  # noqa: E402
from navierstokes3d_tpu_torch.utils import profiling  # noqa: E402


class SecondCycleTracer(spans.SpanTracer):
    """spans.SpanTracer that traces one cycle from the window's second on,
    as the harness's tracing.Tracer does (a re-trace where launches went
    missing), and goes on counting new segments."""

    def wants(self, cycle: int) -> bool:
        super().wants(cycle)
        return (cycle >= 1 and not self.cycles
                and self.tries < spans.btrace.TRIES)


def segments(dev) -> int:
    return torch.cuda.memory_stats(dev).get("segment.all.allocated", 0)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", default="multi255.step1.pt")
    p.add_argument("--steps", type=int, default=12)
    p.add_argument("--pairs", type=int, default=3)
    p.add_argument("--seed", type=int, default=7)
    a = p.parse_args(argv)
    dev = torch.device("cuda:0")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip(), flush=True)
    cell = harness.load_cell(a.workload)
    cfg = cell.config
    ref = cell.reference.Reference(cfg, dev)
    solver = harness.build_solver(cfg, cell.traffic, dev)
    start = harness.start_state(solver, ref, cfg, a.seed, dev)
    nt = int(cfg["nt"])
    st = harness.copy_state(start)
    for _ in range(nt):
        st, _ = solver.step(st)
    torch.cuda.synchronize(dev)
    groups = work.load_groups()
    tracer = SecondCycleTracer(dev, groups, *spans.program_hooks())
    harness.run_window(solver, start, nt, 1.5, a.seed, dev, st, tracer)
    del st, ref
    red = spans.reduce(*tracer.cycles[0]["events"], groups)
    print(f"span_overhead: cycle {tracer.cycles[0]['cycle']} of the window "
          f"traced: new pool segments in each cycle {tracer.grown}; "
          f"cudaMalloc in ns3d.step "
          f"{red['mallocs_in_steps']}, outside {red['mallocs_outside']}; "
          f"step_idle_pct {spans.metrics(red, 0, 1)['step_idle_pct']!r}",
          flush=True)
    spans.log_table(red, print)
    grown = []
    for _ in range(2 * a.steps):
        s0 = segments(dev)
        solver.step(harness.copy_state(start))
        torch.cuda.synchronize(dev)
        grown.append(segments(dev) - s0)
    print(f"span_overhead: new pool segments in each of {len(grown)} "
          f"replays: {grown}", flush=True)

    def block(on: bool) -> float:
        with profiling.spans(on):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for _ in range(a.steps):
                solver.step(harness.copy_state(start))
            torch.cuda.synchronize(dev)
            return 1e3 * (time.perf_counter() - t0) / a.steps

    res = {False: [], True: []}
    order = []
    s0 = segments(dev)
    for i in range(a.pairs):
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            ms = block(on)
            res[on].append(ms)
            order.append(("on" if on else "off", ms))
    print(f"span_overhead: blocks of {a.steps} (spans, ms a step): {order}")
    for on in (False, True):
        print(f"span_overhead: spans {'on' if on else 'off'}: median "
              f"{statistics.median(res[on])!r} ms a step, all {res[on]}")
    d = statistics.median(res[True]) / statistics.median(res[False]) - 1
    print(f"span_overhead: on/off - 1: {100 * d:+.4f}%; new pool segments "
          f"during the blocks: {segments(dev) - s0}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
