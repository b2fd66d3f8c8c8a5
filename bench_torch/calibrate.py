"""Readings that set a cell's correctness limits (bench_torch/limits/).

    python3 bench_torch/calibrate.py --workload <name> --seeds 12 \\
        [--flow-seeds 3] [--controls 3] [--nx N --device cpu]

In one process, for each seed: the start state, one cycle of the
program's steps (the timed path's entry, ChorinSolver.step, at the
cell's own size), every step judged by the plain reference. The cell's
seeds perturb the tracer only, so its velocities and pressure are the
same on each; `--flow-seeds` more start states add uniform noise of
FLOW_NOISE m/s to the velocities too (interior, outside the
cylinder), so that the flow, the pressure and the points where the
advection's departure formula is near its jumps differ from seed to
seed. Those count among the sound readings.

Then, on the first `--controls` seeds: the control, the reference
itself put in the program's place and computed in bfloat16 (the
precision below the configuration's float32), judged the same way; and
readings of faults planted in the program: a step that returns its
state unchanged; an answer altered where it is produced (one pressure
value, the inlet pressure plane, one velocity value); the float32 solve
without its accuracy phase; the solve stopped early, at 10 x eps_it.
Prints one line per step and one JSON summary line: the largest reading
of each number over the sound seeds (the lower reading) and the smallest
over each control or fault (the upper one). The program's own readings
(`err`, the largest convergence measure it reported over the cycle, and
`failed`, its steps with err >= eps_it) are read with each. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(1, os.path.dirname(HERE))

import torch  # noqa: E402

import harness  # noqa: E402

FLOW_NOISE = 1e-3   # m/s, a thousandth of the inflow: the flow changes


def physical(ref, st, split: bool) -> dict:
    f = harness.fields_of(st)
    pr = f["pr"].double()
    if f.get("pr_lo") is not None:
        pr = pr + f["pr_lo"].double()
    f["pr"] = ref.physical_pressure(pr, split)
    return f


def judge(ref, label: str, states: list, ulps: float,
          stats: list = ()) -> dict:
    """The worst of each number over the steps states[0] -> states[1] ->
    ...; NaN stays. `stats` (the program's StepStats of those steps)
    adds its own `err` and `failed`."""
    worst = {}
    for j in range(len(states) - 1):
        nums = ref.check_step(states[j], states[j + 1], ulps)
        print(f"{label} step {j + 1}: " + ", ".join(
            f"{k} {v:.6e}" for k, v in nums.items()), flush=True)
        for k, v in nums.items():
            w = worst.get(k, -math.inf)
            worst[k] = v if math.isnan(v) or not v <= w else w
    if stats:
        eps = ref.cfg["eps_it"]
        worst["err"] = max((s["err"] for s in stats),
                           key=lambda e: (math.isnan(e), e))
        worst["failed"] = float(sum(1 for s in stats if not s["err"] < eps))
    return worst


def program_cycle(solver, start, nt: int):
    st, out, stats = start, [start], []
    for _ in range(nt):
        st, s = solver.step(st)
        out.append(st)
        stats.append(harness.stats_of(s))
    return out, stats


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--first-seed", type=int, default=3_000_000_017)
    p.add_argument("--flow-seeds", type=int, default=3)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--nx", type=int, default=None)
    p.add_argument("--device", default="cuda:0")
    a = p.parse_args(argv)
    cell = harness.load_cell(a.workload, a.nx)
    cfg, dev = cell.config, a.device
    ulps = cell.limits["ill_ulps"]
    if torch.device(dev).type == "cuda":
        harness.card_lines(dev)
    ref = cell.reference.Reference(cfg, dev)
    solver = harness.build_solver(cfg, cell.traffic, dev)
    split = bool(solver.pressure_split)
    nt = int(cfg["nt"])
    seeds = [a.first_seed + 7919 * k for k in range(a.seeds)]
    flow = [a.first_seed + 7919 * (a.seeds + k)
            for k in range(a.flow_seeds)]
    flow_cfg = dict(cfg, perturbation=dict(cfg["perturbation"],
                                           velocity=FLOW_NOISE))
    summary = {"workload": a.workload, "seeds": seeds, "flow_seeds": flow,
               "flow_noise": FLOW_NOISE, "sound": {}, "iters": {}}
    starts = {}
    for seed in seeds + flow:
        start = harness.start_state(solver, ref,
                                    flow_cfg if seed in flow else cfg,
                                    seed, dev)
        starts[seed] = start
        t0 = time.perf_counter()
        states, stats = program_cycle(solver, harness.copy_state(start), nt)
        harness.sync(dev)
        t1 = time.perf_counter()
        summary["iters"][seed] = [s["iters"] for s in stats]
        print(f"seed {seed}{' (flow)' if seed in flow else ''}: iters "
              f"{[s['iters'] for s in stats]} err "
              f"{[s['err'] for s in stats]} clamped "
              f"{[s['clamped'] for s in stats]} ({t1 - t0:.3f} s)",
              flush=True)
        phys = [physical(ref, s, split) for s in states]
        worst = judge(ref, f"seed {seed}", phys, ulps, stats)
        harness.sync(dev)
        print(f"seed {seed}: reference check {time.perf_counter() - t1:.3f} "
              f"s for {nt} steps", flush=True)
        for k, v in worst.items():
            summary["sound"].setdefault(k, []).append(v)
    upper = {}

    def reading(label, worst):
        for k, v in worst.items():
            upper.setdefault(label, {}).setdefault(k, []).append(v)

    ref16 = cell.reference.Reference(cfg, dev, dtype=torch.bfloat16)
    for seed in seeds[:a.controls]:
        st = physical(ref, starts[seed], split)
        st["dprdtau"] = starts[seed].dprdtau
        states = [st]
        t0 = time.perf_counter()
        for _ in range(nt):
            st, info = ref16.step(st)
            print(f"control seed {seed}: iters {info['iters']} err "
                  f"{info['err']:.4e}", flush=True)
            states.append({k: v.double() for k, v in st.items()})
        print(f"control seed {seed}: {time.perf_counter() - t0:.3f} s",
              flush=True)
        reading("control_bf16", judge(ref, f"control seed {seed}", states,
                                      ulps))
    eps = cfg["eps_it"]
    solvers = {"accuracy_none": {"accuracy": "none"},
               "early_stop": {"eps_it": 10.0 * eps}}
    for seed in seeds[:a.controls]:
        start = starts[seed]
        phys0 = physical(ref, start, split)
        reading("unchanged", judge(ref, f"unchanged seed {seed}",
                                   [phys0, phys0], ulps))
        states, _ = program_cycle(solver, harness.copy_state(start), 1)
        alt = physical(ref, states[1], split)
        alt["pr"] = alt["pr"].clone()
        mid = tuple(n // 2 for n in alt["pr"].shape)
        alt["pr"][mid] += 1e-3 * float(alt["pr"].abs().max())
        reading("altered_pr", judge(ref, f"altered pr seed {seed}",
                                    [phys0, alt], ulps))
        alt = physical(ref, states[1], split)
        alt["pr"] = alt["pr"].clone()
        alt["pr"][0] += 1e-3 * float(alt["pr"].abs().max()) + 1e-3
        reading("altered_bc", judge(ref, f"altered bc seed {seed}",
                                    [phys0, alt], ulps))
        alt = physical(ref, states[1], split)
        alt["vx"] = alt["vx"].clone()
        alt["vx"][mid] += 1e-3 * float(alt["vx"].abs().max())
        reading("altered_vx", judge(ref, f"altered vx seed {seed}",
                                    [phys0, alt], ulps))
        for label, numerics in solvers.items():
            bad = harness.build_solver(cfg, cell.traffic, dev,
                                       numerics=numerics)
            states, stats = program_cycle(bad, harness.copy_state(start),
                                          nt)
            print(f"{label} seed {seed}: iters "
                  f"{[s['iters'] for s in stats]} err "
                  f"{[s['err'] for s in stats]}", flush=True)
            reading(label, judge(
                ref, f"{label} seed {seed}",
                [physical(ref, s, bool(bad.pressure_split))
                 for s in states], ulps, stats))
            del bad

    def least(v):
        finite = [x for x in v if not math.isnan(x)]
        return min(finite) if finite else math.nan

    summary["lower"] = {k: max(v, key=lambda x: (not math.isnan(x), x))
                        if all(not math.isnan(x) for x in v) else math.nan
                        for k, v in summary["sound"].items()}
    summary["upper"] = {label: {k: least(v) for k, v in d.items()}
                        for label, d in upper.items()}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
