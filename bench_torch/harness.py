"""One run of one benchmark cell of navierstokes3d_tpu_torch.

A cell (an entry of BENCHMARK.json's `workloads`) names a configuration
(bench_torch/configs/<name>.json, with the plain reference its
`reference` key names under bench_torch/reference/) and a traffic mix
(bench_torch/traffic/<name>.json). Its correctness limits are in
bench_torch/limits/<cell>.json, its per-layer metrics' readers in
bench_torch/metrics/<metric>.py, and the kernel groups that split the
device time into layers in bench_torch/layers/*.json. Nothing here names
a cell, a configuration or a metric: adding one is adding its files.

A run:
  set-up   build the solver (ChorinSolver from the configuration's
           preset, compat off, on cuda:0; the kernels' library builds on
           first use into the package's own _build/), make the start
           state (init_state() plus noise drawn from the seed), replay
           one cycle as the warm-up;
  window   replay the cycle of the configuration's nt steps from a fresh
           copy of the start state, over and over, for `seconds`; no new
           step starts after that; the window ends at the synchronise
           after its last step. One cycle, drawn from the seed, is kept;
  check    after the window, with the solver freed, the plain reference
           judges every step of the kept cycle (reference/*.py
           check_step); each number is held against its limit;
  trace    with trace=True one cycle inside the window runs under
           torch.profiler and the per-layer readers turn it into metrics.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import os
import random
import re
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

import tracing as btrace
import work

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
FIELDS = ("pr", "vx", "vy", "vz", "c", "dprdtau", "pr_lo")


class NoCard(RuntimeError):
    """The run needs more CUDA devices than the machine has."""


def log(*args) -> None:
    print(*args, flush=True)


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def load_module(path: Path, name: str):
    """A module of the benchmark found by its file's name (once a
    process)."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    reference: object      # the reference module


def load_cell(workload: str, nx: Optional[int] = None) -> Cell:
    """The cell's entries and files; nx replaces the configuration's grid
    (the CPU rehearsal's tiny grids)."""
    bench = load_json(REPO / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cfg = load_json(REPO / entry["file"])
    if nx is not None:
        cfg = dict(cfg, nx=nx, ny=math.ceil(nx * cfg["ly_lx"]),
                   nz=math.ceil(nx * cfg["lz_lx"]))

    def applies(m):
        return workload in m.get("workloads", [workload])

    return Cell(
        name=workload, chips=int(w["chips"]), config=cfg,
        traffic=load_json(ROOT / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(ROOT / "limits" / f"{workload}.json"),
        end_to_end=[m for m in bench["end_to_end"] if applies(m)],
        per_layer=[m for m in bench["per_layer"] if applies(m)],
        reference=load_module(ROOT / "reference" / f"{cfg['reference']}.py",
                              f"bench_reference_{cfg['reference']}"))


# ---- the program under test ----

def build_solver(cfg: dict, traffic: dict, device, numerics=None):
    """ChorinSolver of the configuration and the traffic's backend;
    `numerics` overrides NumericsConfig fields (the calibration's fault
    readings) after the preset has been held against the configuration
    file. Raises where the program's preset differs from that file."""
    import navierstokes3d_tpu_torch as ns
    preset = {"gpu": ns.preset_gpu, "multi": ns.preset_multi}[cfg["variant"]]
    sim = preset(nx=cfg["nx"], nt=cfg["nt"], compat=bool(cfg["compat"]),
                 dtype=cfg["dtype"])
    num = dataclasses.replace(sim.numerics,
                              poisson_backend=traffic["poisson_backend"])
    ph = sim.physics
    stated = {"rho": ph.rho, "vin": ph.vin, "mu": ph.mu, "re": ph.re,
              "g": ph.g, "lx": ph.lx, "ly_lx": ph.ly_lx, "lz_lx": ph.lz_lx,
              "eps_it": num.eps_it, "niter_scale": num.niter_scale,
              "cfl_tau": num.cfl_tau, "cfl_visc": num.cfl_visc,
              "cfl_adv": num.cfl_adv,
              "ny": num.ny(ph), "nz": num.nz(ph)}
    cyl = {"a_lx": ph.a_lx, "b_lx": ph.b_lx, "ox_lx": ph.ox_lx,
           "oy_lx": ph.oy_lx, "beta": ph.beta}
    off = {k: (v, cfg[k]) for k, v in stated.items() if v != cfg[k]}
    off.update({k: (v, cfg["cylinder"][k]) for k, v in cyl.items()
                if v != cfg["cylinder"][k]})
    if off:
        raise ValueError(f"the program's preset differs from the "
                         f"configuration (program, file): {off}")
    num = dataclasses.replace(num, **(numerics or {}))
    return ns.ChorinSolver(sim.replace(numerics=num), device=device)


def start_state(solver, ref, cfg: dict, seed: int, device):
    """init_state() plus uniform noise in [-a, a] (a from the
    configuration's `perturbation`) on the interior points of vx, vy, vz
    and C that lie outside the cylinder, drawn on the device from the
    seed."""
    st = solver.init_state()
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    amp = cfg["perturbation"]
    out = {}
    for name, key, mask in (("vx", "velocity", "vx"),
                            ("vy", "velocity", "vy"),
                            ("vz", "velocity", "vz"), ("c", "c", "c")):
        f = getattr(st, name)
        noise = torch.rand(f.shape, generator=gen, device=device,
                           dtype=f.dtype).mul_(2.0).sub_(1.0).mul_(amp[key])
        keep = torch.zeros_like(f, dtype=torch.bool)
        keep[1:-1, 1:-1, 1:-1] = True
        keep &= ~ref.masks[mask].to(device)[:, :, None]
        out[name] = f + torch.where(keep, noise, torch.zeros_like(noise))
    return st.replace(**out)


def copy_state(st):
    return st.replace(**{k: None if getattr(st, k) is None
                         else getattr(st, k).clone() for k in FIELDS})


def fields_of(st) -> Dict[str, torch.Tensor]:
    return {k: getattr(st, k) for k in FIELDS if getattr(st, k) is not None}


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def stats_of(stats) -> dict:
    return {"iters": int(stats.iters), "err": float(stats.err),
            "iters_ext": None if stats.iters_ext is None
            else int(stats.iters_ext),
            "clamped": None if stats.advect_clamped is None
            else int(stats.advect_clamped)}


# ---- the window ----

@dataclasses.dataclass
class Window:
    seconds: float = 0.0
    steps: List[dict] = dataclasses.field(default_factory=list)
    cycles: int = 0
    kept: List = dataclasses.field(default_factory=list)  # (j, fields)
    kept_cycle: int = -1


def run_window(solver, start, nt: int, seconds: float, seed: int, device,
               template, tracer=None) -> Window:
    """Replay the cycle for `seconds` (see the module docstring). The kept
    cycle is a reservoir sample of one cycle, drawn from the seed; its
    outputs are copied on the device as they come, into buffers shaped
    after `template` (a step's output) and made before the window, so
    nothing is allocated for them inside it. `tracer` (tracing.Tracer)
    traces one whole cycle, retrying where launches went missing; the
    window then runs until that cycle has been traced."""
    rng = random.Random(int(seed) ^ 0x5EED)
    w = Window()
    snap = [{k: torch.empty_like(v) for k, v in fields_of(template).items()}
            for _ in range(nt)]
    sync(device)
    gc.collect()
    gc.disable()
    try:
        t0 = time.perf_counter()
        while True:
            tracing = tracer is not None and tracer.wants(w.cycles)
            if not tracing and time.perf_counter() - t0 >= seconds:
                break
            keep = rng.random() * (w.cycles + 1) < 1.0
            if keep:
                w.kept, w.kept_cycle = [], w.cycles
            if tracing:
                tracer.open()
            with btrace.span("bench.cycle_restart"):
                state = copy_state(start)
            done = 0
            for j in range(nt):
                if not tracing and time.perf_counter() - t0 >= seconds:
                    break
                with btrace.span("bench.step"):
                    state, stats = solver.step(state)
                w.steps.append(dict(stats_of(stats), cycle=w.cycles, j=j))
                done += 1
                if keep:
                    out = fields_of(state)
                    for k, v in out.items():
                        if k not in snap[j]:
                            snap[j][k] = torch.empty_like(v)
                        snap[j][k].copy_(v)
                    w.kept.append((j, {k: snap[j][k] for k in out}))
            if tracing:
                sync(device)
                tracer.close(w.steps[-done:])
            w.cycles += 1
            if done < nt:
                break
        sync(device)
        w.seconds = time.perf_counter() - t0
    finally:
        gc.enable()
    return w


# ---- the run ----

def card_lines(device) -> dict:
    """The card's name, count and power limit (an earlier line)."""
    name = torch.cuda.get_device_name(device)
    count = torch.cuda.device_count()
    limit = btrace.smi("power.limit")
    log(f"bench: card {name}, {count} device(s) visible, power.limit "
        f"{limit}")
    return {"kind": name, "count": count}


def process_age() -> float:
    """Seconds since this process started (Linux's /proc), or 0."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda:0", nx: Optional[int] = None,
             require_card: bool = True, t_start: Optional[float] = None,
             age0: float = 0.0, solver_hook: Optional[Callable] = None
             ) -> dict:
    """One run of one cell; returns the result object of the last line.
    require_card=False skips the look for a card (the CPU rehearsal and
    the fault tests, on the CPU at a tiny nx); solver_hook(solver) may
    replace parts of the solver (the fault tests break the timed path
    with it)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = load_cell(workload, nx)
    on_card = torch.device(device).type == "cuda"
    if require_card:
        if not torch.cuda.is_available():
            raise NoCard("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < cell.chips:
            raise NoCard(f"{torch.cuda.device_count()} CUDA device(s), the "
                         f"cell needs {cell.chips}")
    cfg, traffic = cell.config, cell.traffic
    dev_info = card_lines(device) if on_card else {"kind": "cpu",
                                                   "count": 0}
    ref = cell.reference.Reference(cfg, device)
    solver = build_solver(cfg, traffic, device)
    if solver_hook is not None:
        solver_hook(solver)
    geo = ref.geo
    if (solver.grid.niter, solver.grid.nchk) != (geo.niter, geo.nchk) or \
            not math.isclose(solver.grid.dt, geo.dt, rel_tol=1e-12):
        raise ValueError("the program's grid constants differ from the "
                         "reference's")
    start = start_state(solver, ref, cfg, seed, device)
    nt = int(cfg["nt"])
    # warm-up: one cycle of the cell's own shapes
    st = copy_state(start)
    warm = []
    for _ in range(nt):
        st, stats = solver.step(st)
        warm.append(stats_of(stats))
    sync(device)
    log(f"bench: warm-up cycle iters {[s['iters'] for s in warm]} err "
        f"{[s['err'] for s in warm]}")
    tracer = btrace.Tracer(device, work.load_groups()) if trace else None
    setup_s = age0 + time.perf_counter() - t_start
    if on_card:
        # clocks and power beside the window (not inside it: nvidia-smi
        # is a process of its own, which would share the host's cores
        # with the launch loop)
        log(f"bench: nvidia-smi before the window {btrace.smi(btrace.SMI)}")
    w = run_window(solver, start, nt, seconds, seed, device, st, tracer)
    del st
    if on_card:
        log(f"bench: nvidia-smi after the window {btrace.smi(btrace.SMI)}")
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    eps = cfg["eps_it"]
    failed = sum(1 for s in w.steps if not (s["err"] < eps))
    log(f"bench: window {w.seconds:.6f} s, {len(w.steps)} steps in "
        f"{w.cycles} cycles, {failed} failed; kept cycle {w.kept_cycle}")
    for j in range(nt):
        it = sorted({s["iters"] for s in w.steps if s["j"] == j})
        log(f"bench: step {j + 1} of the cycle: iters {it}")

    # ---- the check: the solver freed, the reference after the peak ----
    split = bool(getattr(solver, "pressure_split", False))
    del solver
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    kept_err = max((s["err"] for s in w.steps
                    if s["cycle"] == w.kept_cycle),
                   key=lambda e: (math.isnan(e), e), default=math.nan)
    checks = check(ref, cell, start, w.kept, split,
                   {"failed": float(failed), "err": kept_err})
    correct = all(c["ok"] for c in checks.values())
    metrics = {}
    steps_done = len(w.steps)
    result = {"correct": correct, "attempted": steps_done,
              "failed": failed}
    if not trace:
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": m["unit"]}
            elif m["name"] == "step_ms":
                metrics["step_ms"] = {
                    "value": 1e3 * w.seconds / max(steps_done, 1),
                    "unit": m["unit"]}
    else:
        ctx = {"cell": cell, "window_steps": w.steps,
               "grid": (geo.nx, geo.ny, geo.nz), "peaks": work.load_peaks(),
               "trace": tracer.summary if tracer else None, "log": log}
        for m in cell.per_layer:
            reader = load_module(ROOT / "metrics" / f"{m['name']}.py",
                                 "bench_metric_" + re.sub(r"\W", "_",
                                                          m["name"]))
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = dict(platform="gpu" if on_card else "cpu",
                            kind=dev_info["kind"], count=cell.chips,
                            memory_peak_bytes=int(peak))
    if trace and tracer and tracer.summary:
        s = tracer.summary
        result["device"]["busy_s"] = s["busy_us"] * 1e-6
        result["device"]["window_s"] = s["span_us"] * 1e-6
        result["breakdown"] = s["breakdown"]
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                        for k, c in checks.items()}
    return result


def check(ref, cell: Cell, start, kept, split: bool,
          program: Dict[str, float]) -> Dict[str, dict]:
    """Every step of the kept cycle against the reference; the worst of
    each number over those steps beside its limit (bench_torch/limits).
    `program` adds the program's own readings: `failed`, the window's
    steps that did not converge (limit 0), and `err`, the largest
    convergence measure the program reported over the kept cycle, held
    strictly below its limit, the configuration's eps_it."""
    lim = cell.limits
    worst: Dict[str, float] = dict(program)

    def physical(f):
        f = dict(f)
        pr = f["pr"].double()
        if f.get("pr_lo") is not None:
            pr = pr + f["pr_lo"].double()
        f["pr"] = ref.physical_pressure(pr, split)
        return f

    prev = {0: physical(fields_of(start))}
    for j, st in kept:
        prev[j + 1] = physical(st)
    for j, _ in kept:
        nums = ref.check_step(prev[j], prev[j + 1], ulps=lim["ill_ulps"])
        log(f"bench: check step {j + 1}: " + ", ".join(
            f"{k} {v:.6e}" for k, v in nums.items()))
        for k, v in nums.items():
            # the worst reading; a NaN stays (it fails every limit)
            w = worst.get(k, -math.inf)
            worst[k] = v if math.isnan(v) or not v <= w else w
    worst["steps"] = float(len(kept))
    out = {}
    for name, limit in lim["limits"].items():
        v = worst.get(name, math.nan)
        if name == "steps":
            ok = v >= limit
        elif name == "err":
            ok = v < limit        # NaN fails
        else:
            ok = v <= limit       # NaN fails
        out[name] = {"value": v, "limit": limit, "ok": bool(ok)}
    return out
