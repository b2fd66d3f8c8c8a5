"""Command-line entry point of the port (the main path of navierstokes3d_tpu/run.py).

    python -m navierstokes3d_tpu_torch.run --preset {gpu,multi} [--nx N] \
        [--nt 4] [--dtype float32] [--compat] [--device cuda]

Runs the gpu or multi preset from its initial state and prints one line
per step: Poisson iterations, accuracy-phase iterations, the final
residual, advection clamp count and wall seconds. --compat runs the
reference's own semantics (compat mode: K7 in float32, the exact
iteration in float64, which runs on the card there too); without it the
main path (compat=False), whose float64 runs on the CPU only. --nx
defaults to 255 (gpu) or 63 (multi), as bench.py's; `--preset gpu --nx
511` runs the wide grid (511x307x307, ~10 GB of device memory), whose
Poisson loops take bodies of two K8 launches of 3 iterations each, as the
JAX package's lane-tiled build does. The solver runs on the card;
--device cpu runs the plain PyTorch versions of the kernels.
The remaining flags of the JAX package's CLI (I/O, resume, watchdog,
clamp policy) are not ported yet.
"""

from __future__ import annotations

import argparse
import time

import torch

from .config import preset_gpu, preset_multi
from .models.chorin import ChorinSolver

PRESETS = {"gpu": (preset_gpu, 255), "multi": (preset_multi, 63)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", choices=sorted(PRESETS), default="gpu")
    ap.add_argument("--nx", type=int, default=None,
                    help="default: 255 (gpu) / 63 (multi)")
    ap.add_argument("--nt", type=int, default=4)
    ap.add_argument("--dtype", choices=["float32", "float64"],
                    default="float32")
    ap.add_argument("--compat", action="store_true",
                    help="replicate the reference's quirks (compat mode)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    make, nx_default = PRESETS[args.preset]
    nx = nx_default if args.nx is None else args.nx
    cfg = make(nx=nx, nt=args.nt, compat=args.compat, dtype=args.dtype)
    solver = ChorinSolver(cfg, device=args.device)
    g = solver.grid
    mode = "compat" if args.compat else f"accuracy phase {solver.acc}"
    print(f"{args.preset} preset, grid {g.nx}x{g.ny}x{g.nz} {args.dtype} "
          f"on {solver.device} (niter {g.niter}, nchk {g.nchk}, eps_it "
          f"{cfg.numerics.eps_it}, {mode})")
    state = solver.init_state()
    for it in range(1, args.nt + 1):
        t0 = time.perf_counter()
        state, stats = solver.step(state)
        if solver.device.type == "cuda":
            torch.cuda.synchronize(solver.device)
        print(f"step {it}: iters {stats.iters} iters_ext {stats.iters_ext} "
              f"err {float(stats.err):.6e} advect_clamped "
              f"{stats.advect_clamped} wall {time.perf_counter() - t0:.3f}s",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
