"""Command-line entry point of the port (the main path of navierstokes3d_tpu/run.py).

    python -m navierstokes3d_tpu_torch.run --preset {gpu,multi} [--nx N] \
        [--nt 4] [--dtype float32] [--compat] [--device cuda] \
        [--mesh PXxPYxPZ|auto] [--comm {auto,shard_map,fullstep}] \
        [--halo-width 1]

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

--mesh decomposes the grid over a mesh of shards, all on --device
(`auto`: one shard per visible CUDA device, in the JAX package's mesh
shape); --comm shard_map runs the distributed Poisson solve
(parallel/halo.py: K2-dist or K7-dist per shard on an x-only mesh with
--halo-width 1, the plain torch-ops loop otherwise). --comm auto resolves
as the JAX package's run.py does; a one-shard mesh runs the single-device
step. The `fullstep` schedule and the global-view `sharded` path are not
ported yet (ROADMAP.md queue 1, item 11) and exit with an error. The
remaining flags of the JAX package's CLI (I/O, resume, watchdog, clamp
policy) are not ported yet.
"""

from __future__ import annotations

import argparse
import sys
import time
import warnings

import torch

from .config import ParallelConfig, preset_gpu, preset_multi
from .models.chorin import ChorinSolver
from .parallel import choose_mesh_shape, make_mesh

PRESETS = {"gpu": (preset_gpu, 255), "multi": (preset_multi, 63)}


def resolve_auto_comm(comm, mesh_size, mesh_shape, nx, poisson_backend,
                      halo_width, advect_k):
    """Resolve --comm for a mesh (copy of the JAX package's rule,
    run.py:135-178). Raises SystemExit for the fdm backend under an
    explicit shard_map/fullstep schedule on a >1-shard mesh. On an x-only
    mesh that splits nx evenly, auto picks fullstep where the slabs are
    thick enough for the advection halo (bx >= advect_k + 2) and
    halo_width is 1, else shard_map; other meshes take the global-view
    'sharded' path; a one-shard mesh keeps 'auto'."""
    if (mesh_size > 1 and poisson_backend == "fdm"
            and comm in ("shard_map", "fullstep")):
        raise SystemExit(f"--poisson-backend fdm requires the "
                         f"global-view SPMD path on a multi-device "
                         f"mesh (--comm auto or omit --comm); "
                         f"--comm {comm} runs its own pseudo-"
                         f"transient loop")
    if comm != "auto" or mesh_size <= 1:
        return comm
    if poisson_backend == "fdm":
        return "sharded"
    x_only = mesh_shape[1] == 1 and mesh_shape[2] == 1
    if x_only and nx % mesh_shape[0] == 0:
        bx = nx // mesh_shape[0]
        return ("fullstep" if halo_width == 1 and bx >= advect_k + 2
                else "shard_map")
    return "sharded"


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
    ap.add_argument("--mesh", default=None,
                    help="mesh PXxPYxPZ, e.g. 3x1x1, or 'auto' (default: "
                         "one device, no mesh)")
    ap.add_argument("--comm", choices=("auto", "shard_map", "fullstep"),
                    default="auto",
                    help="the sharded schedule: 'shard_map' runs the "
                         "distributed Poisson solve (parallel/halo.py)")
    ap.add_argument("--halo-width", type=int, default=1,
                    help="Poisson iterations per halo exchange in "
                         "shard_map mode (temporal blocking)")
    args = ap.parse_args(argv)
    make, nx_default = PRESETS[args.preset]
    nx = nx_default if args.nx is None else args.nx
    cfg = make(nx=nx, nt=args.nt, compat=args.compat, dtype=args.dtype)
    device = torch.device(args.device)
    mesh, comm, mesh_note = None, None, ""
    if args.mesh:
        if args.mesh.lower() == "auto":
            n = torch.cuda.device_count() if device.type == "cuda" else 1
            shape = choose_mesh_shape(max(n, 1), nx=nx)
        else:
            shape = tuple(int(p) for p in args.mesh.lower().split("x"))
        mesh = make_mesh(shape, devices=device)
        comm = resolve_auto_comm(args.comm, mesh.size, shape, nx,
                                 cfg.numerics.poisson_backend,
                                 args.halo_width, ChorinSolver.advect_k)
        if comm in ("fullstep", "sharded"):
            print(f"--comm {args.comm} -> {comm} on mesh "
                  f"{'x'.join(map(str, shape))}: the {comm} path is not "
                  "ported yet (ROADMAP.md queue 1, item 11: parallel/ "
                  "fullstep, then the multi-process transport); run --comm "
                  "shard_map", file=sys.stderr)
            return 2
        if comm == "shard_map":
            cfg = cfg.replace(parallel=ParallelConfig(
                mesh_shape=shape, halo=args.halo_width))
            if (mesh.size > 1 and args.dtype == "float32"
                    and not args.compat and args.halo_width > 1):
                # halo_width > 1 disqualifies the per-shard kernels, and
                # the plain loop runs float32 without the (hi, lo) pair,
                # which the no-split multi variant needs once the flow
                # develops (the JAX package's run.py:275-290)
                warnings.warn(
                    "--comm shard_map with --halo-width > 1 runs the plain "
                    "f32 distributed loop (no stored pair); developed-flow "
                    "f32 runs may stall above eps_it. Use --halo-width 1 "
                    "(per-shard kernels, pair-capable) or --dtype "
                    "float64.", RuntimeWarning)
        mesh_note = (f", mesh {'x'.join(map(str, shape))} of "
                     f"{mesh.devices[0]}, comm {comm}")
    solver = ChorinSolver(cfg, device=device)
    step = (solver.step_shard_map(mesh) if comm == "shard_map"
            else solver.step)
    g = solver.grid
    mode = "compat" if args.compat else f"accuracy phase {solver.acc}"
    print(f"{args.preset} preset, grid {g.nx}x{g.ny}x{g.nz} {args.dtype} "
          f"on {solver.device} (niter {g.niter}, nchk {g.nchk}, eps_it "
          f"{cfg.numerics.eps_it}, {mode}{mesh_note})")
    state = solver.init_state()
    for it in range(1, args.nt + 1):
        t0 = time.perf_counter()
        state, stats = step(state)
        if solver.device.type == "cuda":
            torch.cuda.synchronize(solver.device)
        print(f"step {it}: iters {stats.iters} iters_ext {stats.iters_ext} "
              f"err {float(stats.err):.6e} advect_clamped "
              f"{stats.advect_clamped} wall {time.perf_counter() - t0:.3f}s",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
