"""Command-line entry point of the port (the main path of navierstokes3d_tpu/run.py).

    python -m navierstokes3d_tpu_torch.run --preset gpu --nx 255 --nt 4 \
        [--dtype float32] [--device cuda]

Runs the gpu preset (compat=False) from its initial state and prints one
line per step: Poisson iterations, accuracy-phase iterations, the final
residual, advection clamp count and wall seconds. The remaining flags of
the JAX package's CLI (I/O, resume, watchdog, clamp policy) are not
ported yet.
"""

from __future__ import annotations

import argparse
import time

import torch

from .config import preset_gpu
from .models.chorin import ChorinSolver


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", choices=["gpu"], default="gpu")
    ap.add_argument("--nx", type=int, default=255)
    ap.add_argument("--nt", type=int, default=4)
    ap.add_argument("--dtype", choices=["float32", "float64"],
                    default="float32")
    ap.add_argument("--device", default="cuda" if torch.cuda.is_available()
                    else "cpu")
    args = ap.parse_args(argv)
    cfg = preset_gpu(nx=args.nx, nt=args.nt, compat=False, dtype=args.dtype)
    solver = ChorinSolver(cfg, device=args.device)
    g = solver.grid
    print(f"grid {g.nx}x{g.ny}x{g.nz} {args.dtype} on {solver.device} "
          f"(niter {g.niter}, nchk {g.nchk}, eps_it {cfg.numerics.eps_it})")
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
