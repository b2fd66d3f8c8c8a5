"""Command-line entry point of the port, the JAX package's run.py CLI.

The reference's run loops (runme, NavierStokes3D_gpu.jl:12-173, and
run_navierstokes3D, NavierStokes3D_multi_gpu.jl:287-536) over both
presets, on the card.

    python -m navierstokes3d_tpu_torch.run --preset multi --nx 63 --nt 100 \
        --save --vis --checkpoint-every 50 [--resume] [--dtype float32] \
        [--poisson-backend fdm] [--device cuda]

Defaults are the JAX package's: --preset multi --nx 63 --nt 10, float32,
compat off. --nt is the TOTAL horizon: with --resume the run continues
from the newest checkpoint in --ckpt-dir up to step --nt (nothing to do
when the checkpoint has reached it). Output: a header line and one line
per step on stdout (Poisson iterations, accuracy-phase iterations, the
final residual, advection clamp count and wall seconds; --quiet drops
them), then the JSON timing summary as the last line of stdout.

--save writes the reference's .bin frames (out_{C,Pr,Vx,Vy,Vz}_v_%04d.bin,
frame = step // nsave) and step_{it}.mat snapshots into --out-dir; --vis
writes slice PNGs (frame = step // nvis) into --viz-dir and needs
matplotlib (--animate also PIL); --checkpoint-every N writes
ckpt_%07d.npz into --ckpt-dir, with the JAX package's keys.
--poisson-backend fdm replaces the pseudo-transient loop by the direct
solve with compensated refinement (ops/fdm_poisson.py; stats.iters then
counts refinement rounds). Policies: --on-clamp (warn, abort, or switch
the advection to the exact gather), --abort-on-nan (writes a
nanstate_*.npz snapshot, which --resume never picks, and exits non-zero),
--stall-timeout S (exits with code 3 after S seconds without a completed
step), --sync-every N (host-side records processed in batches of N
steps; I/O cadences sync regardless).

The solver runs on the card (--device cuda); --device cpu runs the plain
PyTorch versions of the kernels. --mesh decomposes the grid over a mesh
of shards, all on --device (`auto`: one shard per visible CUDA device, in
the JAX package's mesh shape); --comm shard_map runs the distributed
Poisson solve (parallel/halo.py: K2-dist or K7-dist per shard on an
x-only mesh with --halo-width 1, the plain torch-ops loop otherwise);
--comm fullstep runs every stage of the step per shard on the owned-face
layout with the same solve (parallel/fullstep.py; the state is converted
at every I/O boundary). --comm auto resolves as the JAX package's run.py
does (fullstep on an x-only mesh whose slabs are at least advect_k + 2
planes thick); a one-shard mesh runs the single-device step. The
global-view `sharded` path (which auto picks on other meshes and the fdm
backend takes on a mesh) is not ported yet (ROADMAP.md queue 1, item 6)
and exits with code 2.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import warnings

import numpy as np
import torch

from .config import ParallelConfig, preset_gpu, preset_multi
from .io import binio, checkpoint, matio
from .models.chorin import ChorinSolver
from .parallel import choose_mesh_shape, make_mesh
from .parallel.fullstep import from_dist, to_dist
from .utils.timers import RunTimer, StallWatchdog, StepRecord

PRESETS = {"gpu": preset_gpu, "multi": preset_multi}


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", choices=sorted(PRESETS), default="multi")
    ap.add_argument("--nx", type=int, default=63)
    ap.add_argument("--nt", type=int, default=10,
                    help="TOTAL number of time steps (the reference's nt); "
                         "with --resume the run continues to this total")
    ap.add_argument("--dtype", choices=["float32", "float64"],
                    default="float32")
    ap.add_argument("--compat", action="store_true",
                    help="replicate the reference's quirks (compat mode)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--vis", action="store_true")
    ap.add_argument("--save", action="store_true")
    ap.add_argument("--nvis", type=int, default=10)
    ap.add_argument("--nsave", type=int, default=10)
    ap.add_argument("--out-dir", default="out_save")
    ap.add_argument("--viz-dir", default="viz3D_out")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="ckpt")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--mesh", default=None,
                    help="mesh PXxPYxPZ, e.g. 3x1x1, or 'auto' (default: "
                         "one device, no mesh)")
    ap.add_argument("--comm", choices=("auto", "shard_map", "fullstep"),
                    default="auto",
                    help="the sharded schedule: 'shard_map' runs the "
                         "distributed Poisson solve (parallel/halo.py), "
                         "'fullstep' every stage per shard "
                         "(parallel/fullstep.py)")
    ap.add_argument("--halo-width", type=int, default=1,
                    help="Poisson iterations per halo exchange in "
                         "shard_map mode (temporal blocking)")
    ap.add_argument("--log-jsonl", default=None,
                    help="append one JSON record per step (it, iters, err, "
                         "advect_clamped, wall_s) to this file")
    ap.add_argument("--on-clamp", choices=("warn", "abort", "gather"),
                    default="warn",
                    help="when a step reports advection departure points "
                         "clamped to the select-shift window: 'warn' keeps "
                         "going, 'abort' exits non-zero, 'gather' switches "
                         "the advection to the exact global-clamp gather "
                         "for all later steps")
    ap.add_argument("--abort-on-nan", action="store_true",
                    help="stop the run, after writing a nanstate_*.npz "
                         "snapshot (named so --resume still picks the last "
                         "good checkpoint), when a step's residual is "
                         "non-finite")
    ap.add_argument("--stall-timeout", type=float, default=0,
                    help="seconds without a completed host sync before "
                         "the run exits with code 3 (0 = off)")
    ap.add_argument("--sync-every", type=int, default=1,
                    help="process the per-step records (log, policies) "
                         "in batches of N steps; I/O cadences sync "
                         "regardless; policies react up to N-1 steps late")
    ap.add_argument("--poisson-backend", choices=("pt", "fdm"),
                    default="pt",
                    help="'pt': the reference's damped pseudo-transient "
                         "iteration; 'fdm': the fast-diagonalization "
                         "direct solve + compensated refinement "
                         "(stats.iters then counts refinement rounds)")
    ap.add_argument("--animate", action="store_true",
                    help="after the run, assemble the viz frames in "
                         "--viz-dir into per-field/plane GIFs")
    ap.add_argument("--quiet", action="store_true")
    return ap


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


def clamp_escalation(policy, solver, it, n_clamped, rebuild_step):
    """Apply the --on-clamp policy after a step reported clamped
    semi-Lagrangian departure points (the select-shift window k was
    exceeded; there the result differs from the reference's global-bound
    clamp, gpu.jl:290-293). With the advective CFL constraint binding,
    k=2 covers |V| <= 2*vin/CFL_adv (docs/numerics.md).

    Returns a replacement step function when the policy swaps the
    advection (solver.advect_method = 'gather', which every later step
    reads), else None; raises SystemExit for 'abort'."""
    if not n_clamped:
        return None
    msg = (f"step {it}: {n_clamped} advection departure points exceeded "
           f"the select-shift window k={solver.advect_k} (safe envelope "
           f"|V| <= {solver.advect_k}*vin/CFL_adv; values there differ "
           "from the reference's gather semantics)")
    if policy == "abort":
        raise SystemExit("ABORT: " + msg)
    print("WARNING: " + msg, file=sys.stderr)
    if policy == "gather" and solver.advect_method != "gather":
        print("on-clamp=gather: switching the advection backend to "
              "'gather' (exact global-clamp semantics) for subsequent "
              "steps", file=sys.stderr)
        solver.advect_method = "gather"
        return rebuild_step()
    return None


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    cfg = PRESETS[args.preset](nx=args.nx, nt=args.nt, compat=args.compat,
                               dtype=args.dtype)
    if args.poisson_backend != "pt":
        if args.compat:
            raise SystemExit("--poisson-backend fdm changes the solver "
                             "and cannot compose with --compat")
        cfg = cfg.replace(numerics=dataclasses.replace(
            cfg.numerics, poisson_backend=args.poisson_backend))
    device = torch.device(args.device)
    mesh, comm, mesh_note = None, None, ""
    if args.mesh:
        if args.mesh.lower() == "auto":
            n = torch.cuda.device_count() if device.type == "cuda" else 1
            shape = choose_mesh_shape(max(n, 1), nx=args.nx)
        else:
            shape = tuple(int(p) for p in args.mesh.lower().split("x"))
        mesh = make_mesh(shape, devices=device)
        comm = resolve_auto_comm(args.comm, mesh.size, shape, args.nx,
                                 cfg.numerics.poisson_backend,
                                 args.halo_width, ChorinSolver.advect_k)
        if comm == "sharded":
            print(f"--comm {args.comm} -> {comm} on mesh "
                  f"{'x'.join(map(str, shape))}: the global-view sharded "
                  "path is not ported yet (ROADMAP.md queue 1, item 6, with "
                  "the multi-process transport); run --comm shard_map or "
                  "fullstep", file=sys.stderr)
            return 2
        if comm in ("shard_map", "fullstep"):
            cfg = cfg.replace(parallel=ParallelConfig(
                mesh_shape=shape, halo=args.halo_width))
            if (comm == "shard_map" and mesh.size > 1
                    and args.dtype == "float32" and not args.compat
                    and args.halo_width > 1):
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
    g = solver.grid

    def build_step():
        # the solver's step reads solver.advect_method on every call, the
        # full step when it is built
        if comm == "fullstep":
            return solver.step_fullstep(mesh)
        return (solver.step_shard_map(mesh) if comm == "shard_map"
                else solver.step)

    step = build_step()
    if not args.quiet:
        mode = ("compat" if args.compat else
                "fdm direct solve" if solver._fdm is not None else
                f"accuracy phase {solver.acc}")
        print(f"{args.preset} preset, grid {g.nx}x{g.ny}x{g.nz} "
              f"{args.dtype} on {solver.device} (niter {g.niter}, nchk "
              f"{g.nchk}, eps_it {cfg.numerics.eps_it}, {mode}"
              f"{mesh_note})", flush=True)

    it0 = 0
    ck = checkpoint.latest_checkpoint(args.ckpt_dir) if args.resume else None
    if ck is not None:
        state, it0 = checkpoint.load_checkpoint(
            ck, dtype=solver.dtype,
            expect_pressure_split=solver.pressure_split,
            device=solver.device)
        if not args.quiet:
            print(f"resumed from {ck} at step {it0}", file=sys.stderr)
    else:
        state = solver.init_state()
    # the full step keeps the owned-face layout between steps; every I/O
    # boundary sees the canonical state
    if comm == "fullstep":
        state, to_flow = to_dist(state, mesh), from_dist
    else:
        def to_flow(st):
            return st

    # vis and save run on independent cadences (gpu.jl:143,168); .bin
    # dumps are frame-indexed, .mat snapshots keyed by the step with
    # full-shape fields (multi_gpu.jl:515-523; gpu.jl:169). Frame indices
    # derive from the STEP (it // cadence), so a resumed run continues
    # the original numbering instead of overwriting earlier frames.

    def dump_save(it, state):
        c, pr, vx, vy, vz = solver.gather_inner(state)
        binio.save_fields(args.out_dir, it // args.nsave,
                          {"C": c, "Pr": pr, "Vx": vx, "Vy": vy, "Vz": vz})
        matio.save_step_mat(
            args.out_dir, it,
            *(t.cpu().numpy() for t in (solver.full_pressure(state.pr),
                                        state.vx, state.vy, state.vz,
                                        state.c)),
            g.dx, g.dy, g.dz)

    def dump_vis(it, state, stats=None):
        from .io import viz
        ivis = it // args.nvis
        c, pr, vx, vy, vz = solver.gather_inner(state)
        viz.save_frame(args.viz_dir, ivis, g,
                       {"C": c, "Pr": pr, "Vx": vx, "Vy": vy, "Vz": vz},
                       t=it * g.dt)
        if stats is not None:
            hist = np.asarray(stats.err_hist)
            valid = ~np.isnan(hist)
            if valid.any():
                iters_axis = (np.arange(len(hist))[valid] + 1) * g.nchk / g.ny
                viz.save_convergence(args.viz_dir, ivis, iters_axis,
                                     hist[valid])

    if args.save:
        dump_save(it0, to_flow(state))
    if args.vis:
        dump_vis(it0, to_flow(state))

    it_last = args.nt
    if args.resume and it0 >= it_last:
        print(f"checkpoint step {it0} already >= --nt {it_last}; "
              "nothing to do (raise --nt to extend the run)",
              file=sys.stderr)
        return 0
    sync = (torch.cuda.synchronize if solver.device.type == "cuda"
            else (lambda: None))
    timer = RunTimer()
    sync_every = max(1, args.sync_every)
    pending = []  # (it, stats) not yet processed on the host
    watchdog = None
    if args.stall_timeout > 0:
        watchdog = StallWatchdog(
            args.stall_timeout,
            message=(f"Re-run with --resume to continue from the last "
                     f"checkpoint in {args.ckpt_dir}."
                     if args.checkpoint_every else
                     "No --checkpoint-every was set; progress is lost.")
        ).start()
    try:
        t_block = time.time()
        for it in range(it0 + 1, it_last + 1):
            state, stats = step(state)
            pending.append((it, stats))
            # the first step syncs on its own, so that its set-up (the
            # kernels' build) lands in record 1, which the summary drops
            need_sync = (len(pending) >= sync_every or it == it_last
                         or it == it0 + 1
                         or (args.save and it % args.nsave == 0)
                         or (args.vis and it % args.nvis == 0)
                         or (args.checkpoint_every
                             and it % args.checkpoint_every == 0))
            if not need_sync:
                continue
            sync()
            per_step = (time.time() - t_block) / len(pending)
            for itp, stp in pending:
                rec = StepRecord(it=itp, wall_s=per_step,
                                 poisson_iters=int(stp.iters),
                                 err=float(stp.err))
                timer.records.append(rec)
                n_clamped = stp.advect_clamped or 0
                if args.log_jsonl:
                    with open(args.log_jsonl, "a") as f:
                        f.write(json.dumps(dict(
                            it=itp, iters=rec.poisson_iters, err=rec.err,
                            advect_clamped=n_clamped,
                            wall_s=round(rec.wall_s, 4))) + "\n")
                if not args.quiet:
                    print(f"step {itp}: iters {stp.iters} iters_ext "
                          f"{stp.iters_ext} err {rec.err:.6e} "
                          f"advect_clamped {stp.advect_clamped} wall "
                          f"{rec.wall_s:.3f}s", flush=True)
                if args.abort_on_nan and not np.isfinite(rec.err):
                    # the reference only breaks the Poisson loop on a
                    # non-finite residual and keeps stepping (gpu.jl:135);
                    # the snapshot (the newest state, up to N-1 steps past
                    # the offender with --sync-every N) is named so that
                    # latest_checkpoint never resumes from it
                    snap = os.path.join(args.ckpt_dir,
                                        f"nanstate_{it:07d}.npz")
                    checkpoint.save_checkpoint(
                        snap, to_flow(state), it,
                        pressure_split=solver.pressure_split)
                    raise SystemExit(
                        f"non-finite residual at step {itp} "
                        f"(err={rec.err!r}); state snapshot written to "
                        f"{snap}")
                new_step = clamp_escalation(args.on_clamp, solver, itp,
                                            n_clamped, build_step)
                if new_step is not None:
                    step = new_step
            pending.clear()
            if args.save and it % args.nsave == 0:
                dump_save(it, to_flow(state))
            if args.vis and it % args.nvis == 0:
                dump_vis(it, to_flow(state), stats)
            if args.checkpoint_every and it % args.checkpoint_every == 0:
                checkpoint.save_checkpoint(
                    os.path.join(args.ckpt_dir, f"ckpt_{it:07d}.npz"),
                    to_flow(state), it, pressure_split=solver.pressure_split)
            if watchdog is not None:
                watchdog.beat()
            t_block = time.time()
    finally:
        if watchdog is not None:
            watchdog.stop()

    if args.animate:
        import glob

        from .io import viz
        for field in ("Pr", "C", "Vx", "Vy", "Vz"):
            for plane in ("xy", "xz"):
                if glob.glob(os.path.join(
                        args.viz_dir,
                        f"3D_NavierStokes_{plane}_{field}_*.png")):
                    p = viz.make_animation(args.viz_dir, field, plane)
                    if not args.quiet:
                        print(f"animation: {p}", file=sys.stderr)
    print(json.dumps(timer.summary()), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
