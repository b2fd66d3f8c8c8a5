"""Drop-in equivalents of the reference's two public entry functions.

A user of the reference calls `run_navierstokes3D(...)` (the multi-GPU
script, NavierStokes3D_multi_gpu.jl:287) or `runme(...)` (the single-GPU
script, NavierStokes3D_gpu.jl:12). These wrappers give the same
signatures, side effects (out_save/ dumps, viz3D_out/ frames, progress
prints) and return values on top of the solver, with the JAX package's
defaults (compat mode, float64: the reference's own dtype,
@init_parallel_stencil(..., Float64, 3)). They run on the card; `device`
moves them (the tests pass "cpu").
"""

from __future__ import annotations

import sys

import numpy as np
import torch


def run_navierstokes3d(do_vis: bool = False, do_save: bool = False,
                       do_print: bool = False, nx: int = 255, nt: int = 10,
                       *, compat: bool = True, dtype: str = "float64",
                       out_dir: str = "out_save", viz_dir: str = "viz3D_out",
                       device: torch.device | str = "cuda"):
    """The multi-GPU script's run function
    (NavierStokes3D_multi_gpu.jl:287-536).

    Returns (C_v, Pr_v, Vx_v, Vy_v, Vz_v): the global inner fields as numpy
    arrays, as the reference's final gather does (:528-535)."""
    from . import ChorinSolver, preset_multi
    from .io import binio

    cfg = preset_multi(nx=nx, nt=nt, compat=compat, dtype=dtype)
    solver = ChorinSolver(cfg, device=device)
    g = solver.grid
    state = solver.init_state()
    nvis = nsave = 10  # reference cadence (:330,:332)
    iframe = 0

    def dump(state):
        nonlocal iframe
        c, pr, vx, vy, vz = solver.gather_inner(state)
        fields = {"C": c, "Pr": pr, "Vx": vx, "Vy": vy, "Vz": vz}
        if do_save:
            binio.save_fields(out_dir, iframe, fields)
        if do_vis:
            from .io import viz
            viz.save_frame(viz_dir, iframe, g, fields, t=iframe * nvis * g.dt)
        iframe += 1

    if do_save or do_vis:
        dump(state)

    for it in range(1, nt + 1):
        state, stats = solver.step(state)
        if do_print:
            print(f"#it = {it}", file=sys.stderr)
            for kchk, err in enumerate(stats.err_hist):
                if not np.isnan(err):
                    print(f"  #iter = {(kchk + 1) * g.nchk}, "
                          f"err = {err:1.3e}", file=sys.stderr)
        if (do_vis and it % nvis == 0) or (do_save and it % nsave == 0):
            dump(state)

    return solver.gather_inner(state)


def runme(do_vis: bool = True, do_save: bool = False, *,
          nx: int = 255, nt: int = 10000, compat: bool = True,
          dtype: str = "float64", out_dir: str = "out_save",
          viz_dir: str = "viz3D_out", device: torch.device | str = "cuda"):
    """The single-GPU script's run function (NavierStokes3D_gpu.jl:12-173):
    hydrostatic +100 Pa head forcing, .mat snapshots every 10 steps.
    Returns the final FlowState (on `device`)."""
    from . import ChorinSolver, preset_gpu
    from .io import matio

    cfg = preset_gpu(nx=nx, nt=nt, compat=compat, dtype=dtype)
    solver = ChorinSolver(cfg, device=device)
    g = solver.grid
    state = solver.init_state()
    nvis = nsave = 10
    iframe = 0

    def fields_of(state):
        return tuple(t.cpu().numpy() for t in (
            solver.full_pressure(state.pr), state.vx, state.vy, state.vz,
            state.c))

    def frame(state, t):
        from .io import viz
        pr, vx, vy, vz, c = fields_of(state)
        viz.save_frame(viz_dir, iframe, g,
                       {"Pr": pr, "C": c, "Vx": vx, "Vy": vy, "Vz": vz},
                       t=t, fixed_clims=False)

    if do_save:
        matio.save_step_mat(out_dir, 0, *fields_of(state), g.dx, g.dy, g.dz)
    if do_vis:
        frame(state, 0.0)
        iframe += 1

    for it in range(1, nt + 1):
        state, stats = solver.step(state)
        print(f"#it = {it}", file=sys.stderr)
        if do_vis and it % nvis == 0:
            frame(state, it * g.dt)
            iframe += 1
        if do_save and it % nsave == 0:
            matio.save_step_mat(out_dir, it, *fields_of(state),
                                g.dx, g.dy, g.dz)
    return state
