"""The folded loops' K10 route and the extended phase's K12 route against
their K1 and K2 bodies, on one NVIDIA GPU.

    python3 scripts/k10_route_probe.py [--cases gpu:63:10 multi:63:10 ...]
        [--pairs 3] [--k12-only]

For each case preset:nx:steps, builds two float32 solvers of the preset,
one with the routes on (ChorinSolver's default where K10 has a form for
the grid and the sweep plan is off) and one with them off (the private
`_resident_plan` set to None: 1-iteration K1 and K2 bodies), and runs one
step of each untimed (the build and the caching allocator's first
blocks). Then it times blocks of `steps` steps from init_state, off and
on alternated (off, on, then on, off, ...; --pairs pairs), each block
between two synchronisations on the host's clock, and prints ms a step
per block, the medians, on/off - 1, the K10 and K12 launches and
iterations and the K1 and K2 launches a block. Every block's iteration
counts and final fields must be the same on both routes, bitwise. Prints
the card's name and power limit first, and one JSON line of the medians
last.

--k12-only keeps K10 on both sides and turns off only the extended
phase's K12 route (kernels/poisson.py `resident_ext_fits` reads False
while the off side's blocks run: K2 bodies there), so the pairs time K12
against K2 on the multi path alone.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)

import torch  # noqa: E402

import navierstokes3d_tpu_torch as nt  # noqa: E402
from navierstokes3d_tpu_torch import kernels  # noqa: E402
from navierstokes3d_tpu_torch.kernels import poisson as kp  # noqa: E402

FIELDS = ("pr", "vx", "vy", "vz", "c", "dprdtau", "pr_lo")
DEFAULT_CASES = ("gpu:63:10", "multi:63:10", "gpu:255:4", "multi:255:4")


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({type(e).__name__})"


def block(solver, steps: int):
    """steps steps from init_state: (ms a step, iterations per step, final
    state, and the launch counts printed beside them)."""
    state = solver.init_state()
    torch.cuda.synchronize()
    kernels.reset_counts()
    iters = []
    t0 = time.perf_counter()
    for _ in range(steps):
        state, stats = solver.step(state)
        iters.append(stats.iters)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    counts = (f"K10 {kp.poisson_iter_resident.launches} launches for "
              f"{kp.poisson_iter_resident.iterations} iterations, K1 "
              f"{kp.poisson_iter.launches} launches, K12 "
              f"{kp.poisson_iter_resident_ext.launches} launches for "
              f"{kp.poisson_iter_resident_ext.iterations} iterations, K2 "
              f"{kp.poisson_iter_ext.launches} launches")
    return ms, iters, state, counts


class K12Off:
    """Within it, solvers take K2 bodies in the extended phase: the route's
    gate `resident_ext_fits` reads False."""

    def __enter__(self):
        self.fits, kp.resident_ext_fits = kp.resident_ext_fits, \
            lambda plan: False

    def __exit__(self, *exc):
        kp.resident_ext_fits = self.fits


def run_case(preset: str, nx: int, steps: int, pairs: int,
             k12_only: bool = False) -> dict:
    make = nt.preset_gpu if preset == "gpu" else nt.preset_multi
    cfg = make(nx=nx, compat=False, dtype="float32")
    on = nt.ChorinSolver(cfg, device="cuda")
    off = nt.ChorinSolver(cfg, device="cuda")
    if not k12_only:
        off._resident_plan = None

    def run(name, s):
        if name == "off" and k12_only:
            with K12Off():
                return block(s, steps)
        return block(s, steps)
    label = f"{preset} {nx}" + (" k12-only" if k12_only else "")
    print(f"[{label}] grid {on.grid.shape_c}, nchk {on.grid.nchk}, "
          f"K10 plan {on._resident_plan}, sweep depths {on._sweep_depths}",
          flush=True)
    if on._resident_plan is None:
        raise SystemExit(f"[{label}] K10 has no plan here: nothing to time")
    for name, s in (("on", on), ("off", off)):
        run(name, s)
    times = {"on": [], "off": []}
    for p in range(pairs):
        order = (("off", off), ("on", on)) if p % 2 == 0 else \
            (("on", on), ("off", off))
        got = {}
        for name, s in order:
            ms, iters, state, counts = run(name, s)
            times[name].append(ms)
            got[name] = (iters, state)
            print(f"[{label}] pair {p} {name:3s} {ms:10.4f} ms/step, "
                  f"iterations {iters}, {counts}", flush=True)
        (i_on, s_on), (i_off, s_off) = got["on"], got["off"]
        same = i_on == i_off and all(
            (getattr(s_on, f) is None and getattr(s_off, f) is None)
            or torch.equal(getattr(s_on, f), getattr(s_off, f))
            for f in FIELDS)
        if not same:
            raise SystemExit(f"[{label}] pair {p}: the routes differ")
    med = {k: statistics.median(v) for k, v in times.items()}
    print(f"[{label}] medians: on {med['on']:.4f}, off {med['off']:.4f} "
          f"ms/step, on/off - 1 = {100 * (med['on'] / med['off'] - 1):+.2f}%"
          f"; every pair bitwise equal", flush=True)
    return {"case": label, "steps": steps, "plan": str(on._resident_plan),
            "on_ms": times["on"], "off_ms": times["off"],
            "on_median_ms": med["on"], "off_median_ms": med["off"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cases", nargs="+", default=list(DEFAULT_CASES))
    p.add_argument("--pairs", type=int, default=3)
    p.add_argument("--k12-only", action="store_true",
                   help="K10 on both sides; only the K12 route toggled")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("k10_route_probe: needs a CUDA device", file=sys.stderr)
        return 2
    print(f"card: {card()}; torch {torch.__version__}", flush=True)
    rows = []
    for c in a.cases:
        preset, nx, steps = c.split(":")
        rows.append(run_case(preset, int(nx), int(steps), a.pairs,
                             a.k12_only))
    print(json.dumps({"card": card(), "cases": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
