"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. device: CUDA must be available; prints the card's name and power limit
  2. build: compiles the port's CUDA kernels from csrc/*.cu (nvcc)
  3. kernels: each hand-written kernel (K1 poisson_iter, K3 predict,
     K4 correct, K5 advect) against its plain PyTorch version on the card,
     at the main path's 255x153x153 float32 shapes with seeded inputs:
     max ulp / abs difference, kernel and plain times (CUDA events)
  4. main path: ChorinSolver(preset_gpu(nx=255, compat=False,
     dtype='float32'), device='cuda') for 4 steps from init_state; every
     solve must converge with finite fields, no advection clamps and a
     stored-state residual below eps_it, and every kernel of the path must
     have launched (and no plain version run)
  5. reference: a small grid (nx=15, 2 steps) on the card against the same
     solver's plain path on the CPU (the path the CPU tests hold against
     the JAX package)
The line before the last is a JSON object of per-kernel results; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import navierstokes3d_tpu_torch as nt  # noqa: E402
from navierstokes3d_tpu_torch import kernels  # noqa: E402
from navierstokes3d_tpu_torch.kernels import _build  # noqa: E402
from navierstokes3d_tpu_torch.kernels import advect as k_advect  # noqa: E402
from navierstokes3d_tpu_torch.kernels import fused_step as k_step  # noqa: E402
from navierstokes3d_tpu_torch.kernels import poisson as k_poisson  # noqa: E402

NX = 255
NSTEPS = 4
# Poisson iterations per step of the JAX package's run of the same
# configuration and initial state (runs/long_r5.jsonl.gz): iteration
# counts, a wiring cross-check for the port (not times)
REF_ITERS = (4560, 3952, 3648, 3496)
# tolerances of the kernel-vs-plain comparisons: both round every
# operation in float32 in the same order (the kernels are built with
# --fmad=false), so the expected difference is 0; 4 ulp leaves room for
# a library division that rounds differently
MAX_ULP = 4
K5_ABS_TOL = 1e-5   # advected fields are O(1)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def max_ulp(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in units in the last place between two float32
    tensors (+0 and -0 are equal; NaN counts as infinitely far)."""
    def ordered(t):
        i = t.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    if bool(torch.isnan(a).any() | torch.isnan(b).any()):
        return 2 ** 31
    return int(torch.max(torch.abs(ordered(a) - ordered(b))).item())


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of fn on the card (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_device() -> str:
    require(torch.cuda.is_available(), "CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return smi


def phase_build() -> None:
    res = _build.build()
    print(f"[build] {res.path.name}: "
          + (f"compiled in {res.seconds:.1f} s" if res.compiled
             else "up to date"))
    for line in res.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build]   {line.strip()}")
    _build.load()


def seeded(rng, *shape, scale=1.0):
    return torch.tensor(rng.normal(size=shape).astype(np.float32) * scale,
                        device="cuda")


def phase_kernels(solver) -> dict:
    """Each kernel against its plain version on identical inputs."""
    rng = np.random.default_rng(2024)
    g, k, masks = solver.grid, solver._consts, solver.masks
    nx, ny, nz = g.nx, g.ny, g.nz
    vx = seeded(rng, nx + 1, ny, nz, scale=0.5) + 1.0
    vy = seeded(rng, nx, ny + 1, nz, scale=0.3)
    vz = seeded(rng, nx, ny, nz + 1, scale=0.3)
    pr = seeded(rng, nx, ny, nz, scale=50.0)
    results = {}

    # K1, with and without the check reduction
    rhs = seeded(rng, nx, ny, nz, scale=1e5)
    dpr0 = torch.zeros_like(pr)
    dpr0[1:-1, 1:-1, 1:-1] = seeded(rng, nx - 2, ny - 2, nz - 2,
                                    scale=1e3)
    op = solver._op
    worst_ulp, worst_abs = 0, 0.0
    for check in (False, True):
        pa, da = torch.empty_like(pr), dpr0.clone()
        pb, db = torch.empty_like(pr), dpr0.clone()
        ea = k_poisson.poisson_iter(pr, pa, da, rhs, op, check)
        eb = k_poisson.poisson_iter_plain(pr, pb, db, rhs, op, check)
        torch.cuda.synchronize()
        u = max(max_ulp(pa, pb), max_ulp(da, db))
        worst_ulp = max(worst_ulp, u)
        worst_abs = max(worst_abs, float((pa - pb).abs().max()),
                        float((da - db).abs().max()))
        if check:
            ra, rb = float(ea), float(eb)
            require(abs(ra - rb) <= 1e-6 * abs(rb),
                    f"K1 check err {ra} vs plain {rb}")
            print(f"[kernels] K1 check err {ra:.9e} plain {rb:.9e}")
    require(worst_ulp <= MAX_ULP, f"K1 differs by {worst_ulp} ulp")
    pa, da = torch.empty_like(pr), dpr0.clone()
    ms = cuda_ms(lambda: k_poisson.poisson_iter(pr, pa, da, rhs, op, False),
                 50)
    plain_ms = cuda_ms(
        lambda: k_poisson.poisson_iter_plain(pr, pa, da, rhs, op, False), 20)
    ms_chk = cuda_ms(lambda: k_poisson.poisson_iter(pr, pa, da, rhs, op,
                                                    True), 20)
    print(f"[kernels] K1 poisson_iter: max ulp {worst_ulp} max abs "
          f"{worst_abs:.3e}; {ms:.4f} ms (check iteration {ms_chk:.4f} ms)"
          f", plain {plain_ms:.4f} ms")
    results["K1 poisson_iter"] = (worst_abs, ms, plain_ms)

    # K3
    a = k_step.predict(vx, vy, vz, masks, k)
    b = k_step.predict_plain(vx, vy, vz, masks, k)
    u = max(max_ulp(x, y) for x, y in zip(a[:3], b[:3]))
    dv_abs = float((a[3] - b[3]).abs().max())
    dv_tol = 8 * 1.2e-7 * float(b[3].abs().max())
    require(u <= MAX_ULP, f"K3 velocities differ by {u} ulp")
    require(dv_abs <= dv_tol, f"K3 divv differs by {dv_abs} > {dv_tol}")
    worst_abs = max(dv_abs, *(float((x - y).abs().max())
                              for x, y in zip(a[:3], b[:3])))
    ms = cuda_ms(lambda: k_step.predict(vx, vy, vz, masks, k), 20)
    plain_ms = cuda_ms(lambda: k_step.predict_plain(vx, vy, vz, masks, k), 5)
    print(f"[kernels] K3 predict: max ulp {u} divv abs {dv_abs:.3e} "
          f"(tol {dv_tol:.3e}); {ms:.4f} ms, plain {plain_ms:.4f} ms")
    results["K3 predict"] = (worst_abs, ms, plain_ms)

    # K4
    bc = solver.set_bc_vel
    a = k_step.correct(vx, vy, vz, pr, masks, k, bc)
    b = k_step.correct_plain(vx, vy, vz, pr, masks, k, bc)
    u = max(max_ulp(x, y) for x, y in zip(a, b))
    require(u <= MAX_ULP, f"K4 differs by {u} ulp")
    worst_abs = max(float((x - y).abs().max()) for x, y in zip(a, b))
    ms = cuda_ms(lambda: k_step.correct(vx, vy, vz, pr, masks, k, bc), 20)
    plain_ms = cuda_ms(
        lambda: k_step.correct_plain(vx, vy, vz, pr, masks, k, bc), 5)
    print(f"[kernels] K4 correct: max ulp {u} max abs {worst_abs:.3e}; "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms")
    results["K4 correct"] = (worst_abs, ms, plain_ms)

    # K5, once with sub-window displacements and once with clamped points
    c = torch.tensor(rng.uniform(size=(nx, ny, nz)).astype(np.float32),
                     device="cuda")
    worst_abs = 0.0
    for scale in (0.5, 2.5):
        fields = (vx * scale, vy * scale, vz * scale, c)
        a = k_advect.advect(*fields, k, solver.advect_k)
        b = k_advect.advect(*fields, k, solver.advect_k, plain=True)
        ncl_a, ncl_b = int(a[4].item()), int(b[4].item())
        require(ncl_a == ncl_b, f"K5 clamp count {ncl_a} vs plain {ncl_b}")
        d = max(float((x - y).abs().max()) for x, y in zip(a[:4], b[:4]))
        u = max(max_ulp(x, y) for x, y in zip(a[:4], b[:4]))
        require(d <= K5_ABS_TOL, f"K5 differs by {d} (scale {scale})")
        worst_abs = max(worst_abs, d)
        print(f"[kernels] K5 advect (velocity scale {scale}): clamped "
              f"{ncl_a}, max ulp {u} max abs {d:.3e}")
        require((ncl_a > 0) == (scale > 1.0),
                f"K5 case of velocity scale {scale}: {ncl_a} clamped points")
    fields = (vx, vy, vz, c)
    ms4 = cuda_ms(lambda: k_advect.advect(*fields, k, solver.advect_k), 10)
    plain4 = cuda_ms(lambda: k_advect.advect(*fields, k, solver.advect_k,
                                             plain=True), 3)
    print(f"[kernels] K5 advect: four branches {ms4:.4f} ms, plain "
          f"{plain4:.4f} ms")
    results["K5 advect"] = (worst_abs, ms4 / 4, plain4 / 4)
    return results


def phase_main_path(solver) -> tuple:
    """4 steps of the main path; returns (per-kernel launches, seconds)."""
    g, eps_it = solver.grid, solver.cfg.numerics.eps_it
    state = solver.init_state()
    torch.cuda.synchronize()
    kernels.reset_counts()
    wall, iters, before_last = [], [], None
    for step in range(NSTEPS):
        if step == NSTEPS - 1:
            before_last = state
        t0 = time.perf_counter()
        state, stats = solver.step(state)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
        iters.append(stats.iters)
        print(f"[main] step {step + 1}: iters {stats.iters} (JAX reference "
              f"{REF_ITERS[step]}) iters_ext {stats.iters_ext} err "
              f"{float(stats.err):.6e} advect_clamped "
              f"{stats.advect_clamped} wall {wall[-1]:.3f} s", flush=True)
        require(bool(np.isfinite(stats.err)) and stats.err < eps_it,
                f"step {step + 1} did not converge (err {stats.err})")
        require(stats.iters < g.niter,
                f"step {step + 1} used the whole budget {g.niter}")
        require(stats.advect_clamped == 0,
                f"step {step + 1} clamped {stats.advect_clamped} points")
        for name in ("pr", "vx", "vy", "vz", "c", "dprdtau", "pr_lo"):
            require(bool(torch.isfinite(getattr(state, name)).all()),
                    f"step {step + 1}: non-finite {name}")
    counts = {kk.name: (kk.wrapper.launches, kk.plain.calls)
              for kk in kernels.KERNELS}
    # stored-state criterion of the last step (after the counts are read:
    # the predictor snapshot launches K3 once more)
    divv = solver.predictor_divv(before_last)
    stored = solver.stored_residual_err(state, divv=divv)
    print(f"[main] stored-state err of step {NSTEPS}: {float(stored):.6e}")
    for name, (launches, plain) in counts.items():
        print(f"[main] {name}: {launches} launches, plain version "
              f"{plain} calls")
        require(launches > 0, f"{name} never launched on the main path")
        require(plain == 0, f"{name} ran its plain version {plain} times")
    require(float(stored) < eps_it, f"stored-state err {stored}")
    for step in (0, 1):
        ref = REF_ITERS[step]
        require(abs(iters[step] - ref) <= 0.2 * ref,
                f"step {step + 1} iterations {iters[step]} not within 20% "
                f"of {ref}")
    total = sum(wall)
    print(f"[main] {total / NSTEPS:.4f} s/step, "
          f"{sum(iters) / total:.1f} Poisson iterations/s "
          f"({sum(iters)} iterations in {total:.3f} s)")
    return counts, wall, iters


def phase_reference() -> None:
    """The port on the card against the same solver's plain path on the
    CPU, at a small grid, for 2 steps: equal iteration counts and clamp
    counts, pr within 1e-5 (step 1) and 1e-3 (step 2) of max|pr| (the CPU
    tests' standard against the JAX package)."""
    cfg = nt.preset_gpu(nx=15, dtype="float32", compat=False)
    gpu, cpu = nt.ChorinSolver(cfg, "cuda"), nt.ChorinSolver(cfg, "cpu")
    a, b = gpu.init_state(), cpu.init_state()
    for step, tol in enumerate((1e-5, 1e-3)):
        a, sa = gpu.step(a)
        b, sb = cpu.step(b)
        pa, pb = a.pr.cpu().numpy(), b.pr.numpy()
        scale = max(1.0, float(np.abs(pb).max()))
        dp = float(np.abs(pa - pb).max()) / scale
        print(f"[reference] nx=15 step {step + 1}: iters {sa.iters}/"
              f"{sb.iters} iters_ext {sa.iters_ext}/{sb.iters_ext} clamped "
              f"{sa.advect_clamped}/{sb.advect_clamped} pr diff {dp:.3e}")
        require((sa.iters, sa.iters_ext, sa.advect_clamped)
                == (sb.iters, sb.iters_ext, sb.advect_clamped),
                "card and CPU counts differ")
        require(dp <= tol, f"card and CPU pr differ by {dp}")


def main() -> int:
    smi = phase_device()
    phase_build()
    cfg = nt.preset_gpu(nx=NX, compat=False, dtype="float32")
    solver = nt.ChorinSolver(cfg, device="cuda")
    g = solver.grid
    print(f"[main] grid {g.nx}x{g.ny}x{g.nz} float32, niter {g.niter}, "
          f"nchk {g.nchk}, eps_it {cfg.numerics.eps_it} ({smi})")
    results = phase_kernels(solver)
    counts, _, _ = phase_main_path(solver)
    phase_reference()
    rows = []
    for kk in kernels.KERNELS:
        err, ms, plain_ms = results[kk.name]
        rows.append({"name": kk.name, "route": "cuda", "source": kk.source,
                     "replaces": kk.replaces,
                     "launches": counts[kk.name][0], "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
