"""Chorin projection solver, single device (torch port of
navierstokes3d_tpu/models/chorin.py for the gpu and multi presets, with
and without compat mode).

Step structure outside compat mode (the JAX package's `_step_chained`,
chorin.py:1843-1884; reference time loops NavierStokes3D_gpu.jl:119-171
and NavierStokes3D_multi_gpu.jl:383-444):

  1. fused predictor (K3): stress -> V* -> cylinder mask -> div V*;
     the tracer's seed ring is set outside the kernel
  2. pseudo-transient Poisson solve in a host-driven loop: exact first
     iteration + set_bc_pr, phase 1 on the folded kernel (K1), then the
     float32 accuracy phase the config selects (`_init_split`):
       'defect'   (gpu, under the hydrostatic split): hand-off at
                  1000*eps_it, one compensated-residual restart (K13),
                  restarted defect correction with K1;
       'extended' (multi, no split): phase 1 to eps_it or its stall, then
                  the double-single (hi, lo) iteration (K2) from lo = 0;
       'none':    K1 alone over the whole budget;
     the first two end with the stored-state guarantee (the stored
     pair's compensated residual on K13's pair form) and the stored
     (hi, lo) pressure pair. On wide grids (where the JAX package's TPU
     build lane-tiles the iteration: 511x307x307) the folded loops run
     bodies of two K8 launches of s = 3 (or 2) iterations each instead
     of one K1, with the same iterations and check values
     (`sweep_depths`, `_sweep_plan`); elsewhere, where K10 has a plan
     for the grid (`_resident_plan`: 255x153x153, 63x38x38), one K10
     launch per folded loop, which takes each check's exit decision on
     the card (the host reads once a loop), and the extended phase one
     K12 launch per check interval instead of K2's, again with the same
     iterations and check values
  3. fused corrector + cylinder mask + the variant's velocity BCs (K4)
  4. four semi-Lagrangian advection branches (K5)

float32 runs that path on any device (CUDA tensors launch the kernels,
CPU tensors run their plain versions). The dtype rule (`uses_kernels`, the
JAX package's own: its Pallas kernels are float32-only, chorin.py:333,
:416, :507): float64 runs the plain versions on every device, the card
included, with the plain folded solve and no accuracy phase, as the JAX
package does when its extended precision is off (chorin.py:1041-1067);
no kernel is launched.

compat mode, the reference's own semantics (the JAX package's unfused
`_step_impl` branch, chorin.py:1806-1841), on any device in either dtype:
  1. update_tau, predict_v (with g: no hydrostatic split), cylinder mask,
     update_divv, as torch ops
  2. the reference's Poisson loop (`pt_loop`, no stall exit): chunks of
     nchk iterations, each chunk checked by a separate residual
     evaluation, the trailing partial chunk only on an unconverged budget
     exhaustion. float32 iterates K7 (the iteration with set_bc_Pr!
     applied in-kernel); float64 iterates the reference's exact form
     (poisson_iter + set_bc_pr, torch ops, as `_poisson_solve_jnp`)
  3. correct_v, cylinder mask, the compat velocity BCs (the multi
     reference's omitted bc_y!(Vy)/bc_z!(Vz)), as torch ops
  4. gather advection with the reference's Vz bug (Vz never advected)

poisson_backend='fdm' (outside compat, on any device, in either dtype):
steps 1, 3 and 4 as in the main path, with K3 carrying
the body force in the gpu variant (the fdm backend has no hydrostatic
split, so g_eff = g), and the Poisson solve a direct one by fast
diagonalization (ops/fdm_poisson.py: six dense transforms as matmuls)
followed by compensated iterative refinement of the stored (hi, lo) pair
(`_poisson_solve_fdm`); no accuracy phase, stats.iters counts the
refinement rounds.

Two keyword arguments of ChorinSolver pick the JAX package's other
single-device paths, which it picks with environment variables:

  fused_step=False (its NS3D_FUSED_STEP=0, `_step_impl`'s unchained
  branch, chorin.py:1806-1841): steps 1 and 3 as torch ops (update_tau,
  predict_v with g_eff, the cylinder mask, update_divv; correct_v, the
  cylinder mask, set_bc_vel), the same Poisson solve, and the four
  advection branches on K6, each from face-averaged velocities computed
  as torch ops outside the kernel (kernels/advect.py advect_unchained);
  poisson_mode='dma' (its NS3D_PALLAS_MODE=dma, chorin.py:331): no
  folded protocol (:382) and no extended kernel (:397). The float32
  solves without an extended accuracy phase (the gpu preset) run K7
  under the reference's loop with the stall exit, on the variant's BC
  spec (split under the hydrostatic split): the non-folded branch of
  `_poisson_solve_pallas` (:1274-1295), no accuracy phase, no stored
  pair. Where the accuracy phase is the extended pair (the multi preset)
  the JAX package drops to its folded jnp solve (:726-735), whose
  extended branch iterates the (hi, lo) pair from the first iteration
  and finishes with a compensated defect correction: XLA code there,
  torch ops here (`_poisson_solve_pair`), so no kernel runs in that
  solve. compat is non-folded in both modes.

`step_shard_map(mesh)` is the distributed step (`--comm shard_map`): the
Poisson solve runs over a mesh of shards (parallel/halo.py; per shard
K2-dist on the (hi, lo) pair outside compat mode, K7-dist under it, on an
x-only mesh), the rest of the step is the unfused chain as torch ops.
`step_fullstep(mesh)` (`--comm fullstep`, parallel/fullstep.py) runs every
stage per shard on the owned-face layout, with the same Poisson solve.
"""

from __future__ import annotations

import functools
import itertools
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..bc import folded_masks, make_bc_fns, make_bc_pr_pair
from ..config import SimConfig
from ..grid import Grid, make_grid
from ..kernels import advect as k_advect
from ..kernels import fused_step as k_step
from ..kernels import poisson as k_poisson
from ..ops import advect as adv
from ..ops import ds
from ..ops import physics as ph
from ..ops.stencil import div
from ..ops.cylinder import (CylinderMasks, apply_cylinder, build_masks,
                            mask_tracer)
from ..ops.fdm_poisson import build_fdm_solver, solve_host_f64
from ..parallel.halo import build_poisson_shard_map
from ..parallel.mesh import Mesh
from ..ptloop import (host_scalar, np_float, pt_loop, pt_loop_device,
                      pt_loop_fused)
from ..state import FIELDS, FlowState, StepStats, zeros_state
from ..utils import profiling
from ..utils.profiling import NO_SPAN, setup_span, span

INNER = (slice(1, -1),) * 3
# the Poisson kernel modes (the JAX package's NS3D_PALLAS_MODE): 'blocked'
# runs the folded protocol (K1, K8, K2), 'dma' the non-folded iteration
# with in-kernel BCs (K7, the counterpart of the dma-mode kernel K11)
POISSON_MODES = ("blocked", "dma")
# the JAX package's default temporal-sweep depth (kernels/poisson.py SWD)
SWEEP_DEPTH = 3


def sweep_depths(ny: int, nz: int) -> Tuple[int, ...]:
    """The sweep depths s the folded loops may run K8 at, by the JAX
    package's default (kernels/poisson.py:174-193 and :856-866,
    models/chorin.py:556-593): temporal sweeps are on exactly where its
    TPU build lane-tiles the folded iteration (rows of W = round_up(ny*nz,
    128) > 2**15 lanes, T = round(W/24576) >= 2 tiles, not degenerate),
    at the depths 2..SWEEP_DEPTH whose reach s*(nz+1) fits the tile halo.
    () means sweeps off."""
    nyz = ny * nz
    w = -(-nyz // 128) * 128
    t = max(1, round(w / 24576)) if w > (1 << 15) else 1
    if t < 2:
        return ()
    hw = -(-SWEEP_DEPTH * (nz + 1) // 128) * 128
    if -(-nyz // (t * hw)) * hw < hw:
        return ()
    return tuple(s for s in range(2, SWEEP_DEPTH + 1) if s * (nz + 1) <= hw)


def uses_kernels(cfg: SimConfig) -> bool:
    """The dtype rule of the solver's kernel routes: the hand-written
    kernels are float32 (the JAX package's Pallas kernels are float32-only
    too, models/chorin.py:333, :416, :507), so a float64 solver takes the
    plain versions on every device, as does use_pallas=False. A float32
    solver's wrappers launch the kernels on CUDA tensors (and run their
    plain versions on CPU tensors)."""
    return (cfg.use_pallas is not False
            and cfg.numerics.torch_dtype == torch.float32)


def _two_sum(a, b):
    """Knuth two_sum: s = fl(a + b), e such that a + b = s + e exactly."""
    s = a + b
    ap = s - b
    bp = s - ap
    return s, (a - ap) + (b - bp)


class ChorinSolver:
    """Owns the config-derived constants, masks and BC closures of one
    device; exposes `init_state`, `step`, `run`, `poisson_solve`,
    `predictor_divv` and `stored_residual_err`. The solver runs on the
    card unless the caller passes device="cpu"."""

    # select-shift advection's window: k=2 is a 2x margin over the
    # CFL_adv=1 displacement bound, clamp-counted beyond (ops/advect.py)
    advect_k = 2
    # the iterations the stored-state guarantee added, over every solver
    # of the process (kernels.reset_counts clears it)
    guarantee_iterations = 0
    # each solver's serial number, which groups its set-up records
    _serials = itertools.count(1)

    def __init__(self, cfg: SimConfig, device: torch.device | str = "cuda",
                 *, fused_step: bool = True, poisson_mode: str = "blocked"):
        self.serial = next(ChorinSolver._serials)
        self._stepped = False
        with setup_span("ns3d.setup.solver", solver=self.serial):
            self._setup(cfg, device, fused_step, poisson_mode)

    def _setup(self, cfg: SimConfig, device, fused_step: bool,
               poisson_mode: str) -> None:
        self.cfg = cfg
        self.device = torch.device(device)
        if poisson_mode not in POISSON_MODES:
            raise ValueError(f"poisson_mode must be one of {POISSON_MODES}, "
                             f"got {poisson_mode!r}")
        # the JAX package's NS3D_FUSED_STEP=0 and NS3D_PALLAS_MODE
        self.fused_step = bool(fused_step)
        self.poisson_mode = poisson_mode
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but CUDA is not "
                               "available")
        self.grid: Grid = make_grid(cfg)
        self.dtype = cfg.numerics.torch_dtype
        self._init_split()
        grid, phys = self.grid, cfg.physics
        self.set_bc_vel, self.set_bc_pr = make_bc_fns(
            cfg, grid, pressure_split=self.pressure_split)
        self.set_bc_pr_pair = make_bc_pr_pair(
            cfg, grid, pressure_split=self.pressure_split)
        self.masks: CylinderMasks = build_masks(cfg, grid, self.device)
        self._op = k_poisson.make_operator(
            folded_masks(cfg, grid, self.pressure_split), grid, self.dtype,
            self.device)
        self._consts = k_step.StepConsts(
            dt=grid.dt, dx=grid.dx, dy=grid.dy, dz=grid.dz, mu=phys.mu,
            rho=phys.rho, g_eff=0.0 if self.pressure_split else phys.g,
            variant=cfg.variant, vin=phys.vin)
        # stall exit: None = auto, which is on outside compat mode (the
        # reference's loop has none)
        stall_on = cfg.numerics.stall_exit
        if stall_on is None:
            stall_on = not cfg.compat
        self._stall = ((cfg.numerics.stall_ratio, cfg.numerics.stall_checks)
                       if stall_on else None)
        # compat keeps the reference's gather advection (any displacement,
        # clamped to the array bounds); otherwise select-shift (advect_k)
        self.advect_method = "gather" if cfg.compat else "selectshift"
        # the dtype rule (uses_kernels): float64 and use_pallas=False run
        # the plain PyTorch versions on every device; otherwise the
        # wrappers launch the hand-written kernels for CUDA tensors (CPU
        # tensors always take the plain versions)
        self.plain = not uses_kernels(cfg)
        # K7's constants: the float32 solves that iterate with the BCs
        # applied in-kernel (the JAX package's non-folded kernel, which it
        # builds under compat and in dma mode, chorin.py:382): compat, and
        # dma mode wherever no extended kernel is wanted (it has none in
        # that mode, :397, and solves the extended accuracy phase's
        # configurations with its folded jnp solve: `_poisson_solve_pair`).
        # float64 iterates the reference's exact form (compat) or the plain
        # folded solve.
        self._bc_op = None
        if self.dtype == torch.float32 and (
                cfg.compat or (poisson_mode == "dma"
                               and self.acc != "extended")):
            self._bc_op = k_poisson.make_bc_operator(
                k_poisson.poisson_bc_spec(cfg.variant, grid, phys,
                                          self.pressure_split),
                grid, self.device)
        kp = k_poisson
        (self._poisson_iter, self._poisson_iter_sweeps,
         self._poisson_iter_ext, self._poisson_iter_resident_ext,
         self._poisson_iter_bc) = (
            (kp.poisson_iter_plain, kp.poisson_iter_sweeps_plain,
             kp.poisson_iter_ext_plain, kp.poisson_iter_resident_ext_plain,
             kp.poisson_iter_bc_plain)
            if self.plain else
            (kp.poisson_iter, kp.poisson_iter_sweeps, kp.poisson_iter_ext,
             kp.poisson_iter_resident_ext, kp.poisson_iter_bc))
        # K13, the compensated residuals: the defect restart's single word,
        # the stored pair's r and max, and its max alone
        (self._compensated_residual, self._pair_residual,
         self._pair_residual_max) = (
            (kp.compensated_residual_plain, kp.pair_residual_plain,
             lambda *a: kp.pair_residual_plain(*a)[1])
            if self.plain else
            (kp.compensated_residual, kp.pair_residual,
             kp.pair_residual_max))
        # the sweep depths the folded loops may run K8 at; () keeps them on
        # 1-iteration K1 bodies (the JAX default, see sweep_depths)
        self._sweep_depths = sweep_depths(grid.ny, grid.nz)
        # K10's plan for this grid on this device (kernels/poisson.py
        # resident_plan): where the sweep plan is off, each folded loop
        # runs as one K10 launch (poisson_loop_resident), and the extended
        # phase one K12 launch per check interval; None keeps the K1 and
        # K2 bodies. The plain solver (float64) keeps its K1 bodies
        self._resident_plan = (
            None if self.plain else
            kp.resident_plan(grid.shape_c, kp.resident_sms(self.device)))
        if cfg.compat:
            # the unfused chain of the JAX package's _step_impl, torch ops
            self._predict = k_step.predict_ops
            self._correct = functools.partial(k_step.correct_ops,
                                              set_bc_vel=self.set_bc_vel)
        elif self.plain:
            self._predict = k_step.predict_plain
            self._correct = k_step.correct_plain
        else:
            self._predict = k_step.predict
            self._correct = k_step.correct
        # the fdm backend: the direct solver and, for the gpu variant, the
        # static boundary-driven part of the solution
        self._fdm = self._fdm_static = None
        if cfg.numerics.poisson_backend == "fdm":
            self._fdm = build_fdm_solver(grid, cfg.variant, self.dtype,
                                         self.device)
            if cfg.variant == "gpu":
                self._fdm_static = self._build_fdm_static()

    def _build_fdm_static(self) -> torch.Tensor:
        """gpu-variant fdm backend: the hydrostatic Dirichlet x planes
        (gpu.jl:257-261) put ~1e9-scale boundary terms in the Poisson RHS,
        which would drown the physics in float32. The static
        boundary-driven part is solved once in float64 on the host; each
        step solves only the dynamic rho/dt divv part on the device."""
        grid = self.grid
        prof2d = np.broadcast_to(self._p_static()[None, :],
                                 (grid.ny, grid.nz))
        cx = 1.0 / (grid.dx * grid.dx)
        rhs_b = np.zeros((grid.nx - 2, grid.ny - 2, grid.nz - 2))
        rhs_b[0] -= (prof2d[1:-1, 1:-1] + 100.0) * cx
        rhs_b[-1] -= prof2d[1:-1, 1:-1] * cx
        static = solve_host_f64(grid, self.cfg.variant, rhs_b)
        return torch.tensor(static.astype(np_float(self.dtype)),
                            device=self.device)

    def _p_static(self) -> np.ndarray:
        """The hydrostatic profile P_static(z) = rho*g*(nz-iz+0.5)*dz of
        the init and the Dirichlet x planes (gpu.jl:87,257-261), float64,
        shape (nz,)."""
        grid, phys = self.grid, self.cfg.physics
        iz = np.arange(1, grid.nz + 1, dtype=np.float64)
        return phys.rho * phys.g * (grid.nz - iz + 0.5) * grid.dz

    def full_pressure(self, pr: torch.Tensor) -> torch.Tensor:
        """Physical pressure Pr from the state's pressure field (identity
        unless the hydrostatic split is active)."""
        if not self.pressure_split:
            return pr
        return pr + torch.tensor(self._p_static(), dtype=pr.dtype,
                                 device=pr.device)[None, None, :]

    def gather_inner(self, state: FlowState):
        """gather_inner with the physical (unsplit) pressure."""
        if self.pressure_split:
            state = state.replace(pr=self.full_pressure(state.pr))
        return gather_inner(state)

    def _init_split(self):
        """Hydrostatic pressure split and the float32 accuracy policy
        (the JAX package's _init_split, chorin.py:186-272, its Pallas
        policy): under the split (gpu variant) state.pr stores p' = Pr -
        P_static(z) with P_static the exact linear init/BC profile
        rho*g*(nz-iz+0.5)*dz. float32 carries the stored (hi, lo) pair;
        the accuracy phase defaults to restarted defect correction under
        the split and to the extended pair kernel without it (the multi
        variant, whose correction solve would stall above eps_it)."""
        cfg, phys, grid, num = self.cfg, self.cfg.physics, self.grid, \
            self.cfg.numerics
        fdm = num.poisson_backend == "fdm"
        if cfg.compat and fdm:
            raise ValueError(
                "poisson_backend='fdm' replaces the reference's Poisson "
                "loop (direct solve + compensated refinement against the "
                "folded operator) and cannot compose with compat mode")
        want = num.pressure_split
        if want is None:
            want = (cfg.variant == "gpu" and not cfg.compat
                    and phys.g != 0.0 and not fdm)
        elif want and fdm:
            raise NotImplementedError(
                "pressure_split composes only with the 'pt' backend (the "
                "fdm backend hoists the static boundary terms itself)")
        self.pressure_split = bool(want)
        ext = num.extended_precision
        if ext is None:
            # fdm handles its own accuracy (no accuracy phase)
            ext = (self.dtype == torch.float32 and not cfg.compat
                   and not fdm)
        elif ext and cfg.compat:
            raise ValueError("extended_precision changes the iterate and "
                             "cannot compose with compat mode")
        self.extended = bool(ext)
        acc = num.accuracy
        if acc not in (None, "defect", "extended", "none"):
            raise ValueError(f"accuracy must be defect/extended/none, "
                             f"got {acc!r}")
        if not self.extended or acc == "none":
            self.acc = "none"
        elif acc == "extended" or (acc is None and not self.pressure_split):
            self.acc = "extended"
        else:
            self.acc = "defect"
        # folded-BC RHS hoist: the affine-z BC of the split field drops a
        # CONSTANT -+rho*g*dz neighbor term at the z-adjacent interior
        # planes; rhs_folded = rhs - hoist
        zh = np.zeros(grid.nz)
        if self.pressure_split:
            rho_g_dz = phys.rho * phys.g * grid.dz
            zh[1] = -rho_g_dz / grid.dz / grid.dz
            zh[grid.nz - 2] = +rho_g_dz / grid.dz / grid.dz
        self._z_hoist = zh

    # ---- initialization ----

    def init_state(self) -> FlowState:
        """Initial conditions per variant (profiles evaluated in numpy
        float64, then cast).

        multi (NavierStokes3D_multi_gpu.jl:368-373): inflow plane velocity
        (written to Vy[1,:,:] in the reference, a typo compat keeps; Vx
        otherwise), hydrostatic pressure from global z (zero when g = 0),
        then the cylinder mask.
        gpu (NavierStokes3D_gpu.jl:84-88): 1/6-power-law Vx profile and
        hydrostatic pressure, which under the split is p' = 0 exactly."""
        with setup_span("ns3d.setup.init_state", solver=self.serial):
            return self._initial_state()

    def _initial_state(self) -> FlowState:
        cfg, grid, phys = self.cfg, self.grid, self.cfg.physics
        st = zeros_state(grid, self.dtype, self.device)
        if cfg.variant == "multi":
            vx, vy = st.vx.clone(), st.vy.clone()
            (vy if cfg.compat else vx)[0] = phys.vin
            # Pr(iz) = -(z_g(iz) - dz/2) rho g with z_g(iz) = (iz-1) dz
            iz = np.arange(1, grid.nz + 1)
            prof = -(((iz - 1) * grid.dz) - grid.dz / 2) * phys.rho * phys.g
            pr = torch.tensor(prof, dtype=self.dtype, device=self.device)
            pr = pr.expand(grid.shape_c).contiguous()
            c, vx, vy, vz = apply_cylinder(st.c, vx, vy, st.vz, self.masks)
            return st.replace(pr=pr, vx=vx, vy=vy, vz=vz, c=c)
        zc = grid.zc()
        prof = phys.vin * (7.0 / 6.0) * (
            (zc + grid.lz / 2) / grid.lz) ** (1.0 / 6.0)
        vx = np.broadcast_to(prof[None, None, :], grid.shape_vx)
        vx = torch.tensor(np.ascontiguousarray(vx), dtype=self.dtype,
                          device=self.device)
        if self.pressure_split:
            return st.replace(vx=vx)
        prof = -(zc - grid.lz / 2) * phys.rho * phys.g
        pr = torch.tensor(prof, dtype=self.dtype, device=self.device)
        return st.replace(vx=vx, pr=pr.expand(grid.shape_c).contiguous())

    # ---- Poisson solve ----

    def poisson_solve(self, pr, dprdtau, divv
                      ) -> Tuple[torch.Tensor, torch.Tensor, StepStats]:
        """(pr, dprdtau, stats); stats.pr_lo carries the stored pair's low
        word on the float32 accuracy paths."""
        if self._fdm is not None:
            return self._poisson_solve_fdm(pr, dprdtau, divv)
        if self._bc_op is not None:
            return self._poisson_solve_bc(pr, dprdtau, divv)
        if self.cfg.compat:
            return self._poisson_solve_exact(pr, dprdtau, divv)
        if self.dtype == torch.float64:
            return self._poisson_solve_folded(pr, dprdtau, divv)
        if self.poisson_mode == "dma" and self.acc == "extended":
            return self._poisson_solve_pair(pr, dprdtau, divv)
        return {"defect": self._poisson_solve_defect,
                "extended": self._poisson_solve_extended,
                "none": self._poisson_solve_plain}[self.acc](
                    pr, dprdtau, divv)

    def _budget(self):
        grid = self.grid
        nchunks = grid.niter // grid.nchk
        return nchunks, grid.niter - nchunks * grid.nchk

    def _err_scale(self) -> float:
        return (self.grid.ly * self.grid.ly) / self.cfg.physics.psc

    def _rhs3d(self, divv):
        """The folded Poisson RHS (rho/dt)*divv - z_hoist, full shape, in
        the solver's dtype (the hi word of ds.rhs_pair)."""
        zh = torch.tensor(self._z_hoist, dtype=self.dtype, device=self.device)
        return (self.cfg.physics.rho / self.grid.dt) * divv - zh

    def _poisson_solve_bc(self, pr, dprdtau, divv):
        """K7 under the reference's loop, the non-folded branch of the JAX
        package's `_poisson_solve_pallas` (chorin.py:1274-1295), which it
        runs under compat and in dma mode (there on its K11): the unhoisted
        RHS (rho/dt)*divv, no exact first iteration, after each chunk the
        check value max|poisson_residual(pr)| * ly^2/psc, the stall exit
        where it is on (outside compat), the trailing partial chunk on an
        unconverged budget exhaustion; no accuracy phase and no stored
        pair. K7's BC spec is the variant's, split where the solver splits
        the pressure (the gpu preset outside compat)."""
        grid, phys, num = self.grid, self.cfg.physics, self.cfg.numerics
        nchunks, rem = self._budget()
        rhs = (phys.rho / grid.dt) * divv
        err_scale = self._err_scale()
        op, k7 = self._bc_op, self._poisson_iter_bc
        # two (pr, dpr) output pairs in turn: K7 reads its inputs whole,
        # and the caller's state is never written
        bufs = [(torch.empty_like(pr), torch.empty_like(pr))
                for _ in range(2)]

        def run_iters(p, d, n, _k):
            for _ in range(n):
                p_out, d_out = bufs[0]
                k7(p, d, rhs, p_out, d_out, op)
                bufs.reverse()
                p, d = p_out, d_out
            return p, d

        def residual_err(p):
            rp = ph.poisson_residual(p, divv, phys.rho, grid.dt, grid.dx,
                                     grid.dy, grid.dz)
            return torch.max(torch.abs(rp)) * err_scale

        pr, dpr, it, err, hist = pt_loop(
            run_iters, residual_err, pr, dprdtau, nchunks, grid.nchk, rem,
            num.eps_it, self.dtype, stall=self._stall)
        return pr, dpr, StepStats(iters=it, err=err, err_hist=hist)

    def _poisson_solve_exact(self, pr, dprdtau, divv):
        """compat in float64: the reference's exact iteration (poisson_iter
        + set_bc_pr) under its loop with no stall exit, the JAX package's
        `_poisson_solve_jnp` (chorin.py:1609-1640)."""
        grid, phys = self.grid, self.cfg.physics
        nchunks, rem = self._budget()
        args = (phys.rho, grid.dt, grid.dtau, grid.damp, grid.dx, grid.dy,
                grid.dz)

        def run_iters(p, d, n, _k):
            for _ in range(n):
                p, d = ph.poisson_iter(p, d, divv, *args)
                p = self.set_bc_pr(p)
            return p, d

        def residual_err(p):
            # (max|Rp| * ly^2) / psc, the reference's order (gpu.jl:132)
            rp = ph.poisson_residual(p, divv, phys.rho, grid.dt, grid.dx,
                                     grid.dy, grid.dz)
            return div(torch.max(torch.abs(rp)) * (grid.ly * grid.ly),
                       phys.psc)

        pr, dpr, it, err, hist = pt_loop(
            run_iters, residual_err, pr, dprdtau, nchunks, grid.nchk, rem,
            self.cfg.numerics.eps_it, self.dtype, stall=None)
        return pr, dpr, StepStats(iters=it, err=err, err_hist=hist)

    def _first_iteration(self, pr, dprdtau, divv):
        """The folded protocol's global iteration 1 in exact form (it reads
        the incoming boundary planes as the reference does), then the
        Dirichlet planes are frozen via set_bc_pr."""
        grid, phys = self.grid, self.cfg.physics
        with span("ns3d.poisson.first"):
            pr, dpr = ph.poisson_iter(pr, dprdtau, divv, phys.rho, grid.dt,
                                      grid.dtau, grid.damp, grid.dx, grid.dy,
                                      grid.dz)
            return self.set_bc_pr(pr), dpr

    def _poisson_solve_folded(self, pr, dprdtau, divv):
        """Plain folded solve (JAX `_poisson_solve_jnp_folded` with the
        extended pair off): zero-gradient faces are dropped neighbor terms,
        Dirichlet planes are frozen, the affine-z constants are hoisted
        into the RHS."""
        grid, num = self.grid, self.cfg.numerics
        nchunks, rem = self._budget()
        dtau, damp, nchk = grid.dtau, grid.damp, grid.nchk
        err_scale = self._err_scale()
        rhs = self._rhs3d(divv)[INNER]
        op = self._op

        def step_fn(carry, it):
            p, dpr = carry
            resid = k_poisson.folded_lap(p, op) - rhs
            dpr = dpr.clone()
            dpr[INNER] = dpr[INNER] * (1.0 - damp) + dtau * resid
            p = p + dtau * dpr
            e = (torch.max(torch.abs(resid)) * err_scale
                 if (it + 1) % nchk == 0 else None)
            return (p, dpr), e, 1

        carry = self._first_iteration(pr, dprdtau, divv)
        (pr, dprdtau), it1, err1, hist1 = pt_loop_fused(
            step_fn, carry, 1, nchunks * nchk + rem, nchk, nchunks,
            num.eps_it, self.dtype, stall=self._stall)
        return self.set_bc_pr(pr), dprdtau, StepStats(
            iters=it1, err=err1, err_hist=hist1)

    def _poisson_solve_pair(self, pr, dprdtau, divv):
        """dma mode where the accuracy phase is the extended pair (the
        multi preset): the JAX package has no extended kernel in that mode
        (chorin.py:397), so its poisson_solve drops to the extended branch
        of `_poisson_solve_jnp_folded` (:975-1124), XLA code, here torch
        ops: the exact first iteration, then the (hi, lo) pair iterated
        from lo = 0 with the jnp folded Laplacian over the whole budget,
        then one compensated residual r0 of the pair and a plain folded
        correction solve of lap(delta) = -r0 (err0-seeded, dpr carried
        over), the pair (hi, lo + delta) renormalized. err is the
        correction loop's exit residual, or the compensated one where the
        pair loop had converged."""
        grid, phys, num = self.grid, self.cfg.physics, self.cfg.numerics
        nchunks, rem = self._budget()
        nchk, eps_it = grid.nchk, num.eps_it
        dtau, decay = grid.dtau, 1.0 - grid.damp
        ft = np_float(self.dtype)
        err_scale = self._err_scale()
        op = self._op
        zh = self._z_hoist[1:-1] if self.pressure_split else None
        rhs, rhs_lo = ds.rhs_pair(divv[INNER], phys.rho / grid.dt, zh)

        def update(dpr, resid):
            dpr = dpr.clone()
            dpr[INNER] = dpr[INNER] * decay + dtau * resid
            return dpr

        def check(resid, it):
            return (torch.max(torch.abs(resid)) * err_scale
                    if (it + 1) % nchk == 0 else None)

        def pair_step(carry, it):
            hi, lo, dpr = carry
            resid = ((k_poisson.folded_lap(hi, op) - rhs)
                     + k_poisson.folded_lap(lo, op))
            dpr = update(dpr, resid)
            hi, lo = _two_sum(hi, lo + dtau * dpr)
            return (hi, lo, dpr), check(resid, it), 1

        def correction_step(carry, it):
            d, dpr = carry
            resid = k_poisson.folded_lap(d, op) - rhs_c
            dpr = update(dpr, resid)
            return (d + dtau * dpr, dpr), check(resid, it), 1

        p1, dpr = self._first_iteration(pr, dprdtau, divv)
        (hi1, lo1, dpr), it1, _, hist1 = pt_loop_fused(
            pair_step, (p1, torch.zeros_like(p1), dpr), 1,
            nchunks * nchk + rem, nchk, nchunks, eps_it, self.dtype,
            stall=self._stall)
        r0, emax = self._comp_residual(hi1, lo1, rhs, rhs_lo)
        errh = host_scalar(emax * err_scale, ft)
        rhs_c = -r0
        (dl, dpr), it2, err2, hist2 = pt_loop_fused(
            correction_step, (torch.zeros_like(hi1), dpr), 0,
            nchunks * nchk + rem, nchk, nchunks, eps_it, self.dtype,
            stall=self._stall, err0=errh)
        hist = np.where(np.isnan(hist1), np.roll(hist2, it1 // nchk), hist1)
        hi, lo = self.set_bc_pr_pair(*_two_sum(hi1, lo1 + dl))
        return hi, dpr, StepStats(iters=it1 + it2,
                                  err=err2 if it2 > 0 else errh,
                                  err_hist=hist, iters_ext=it2, pr_lo=lo)

    def _poisson_solve_fdm(self, pr, dprdtau, divv):
        """Direct solve by fast diagonalization plus compensated iterative
        refinement, the JAX package's `_poisson_solve_fdm` (chorin.py:738-
        878): the direct solve of the (hi of the) RHS, plus the static
        field (gpu variant), zero-padded, the BCs applied (set_bc_pr, then
        the (hi, lo) image set_bc_pr_pair in float32); then up to
        fdm_refine rounds of { r = compensated residual of the (hi, lo)
        pressure pair against the (hi, lo) RHS pair; e = fdm(-r); pair
        (+)= e } while err >= eps_it, err read on the host once a round.
        stats.iters counts the rounds; stats.err is the stored pair's
        residual. float64 refines on the plain folded residual. The
        incoming pr is not read, and dprdtau passes through untouched."""
        grid, phys, num = self.grid, self.cfg.physics, self.cfg.numerics
        ft = np_float(self.dtype)
        eps = ft(num.eps_it)
        err_scale = self._err_scale()
        fdm, op = self._fdm, self._op
        use_pair = self.dtype == torch.float32
        if use_pair:
            # lo carries the float32 rounding of the RHS, so the
            # refinement targets the true (float64-defined) right-hand side
            rhs_hi, rhs_lo = ds.rhs_pair(divv[INNER], phys.rho / grid.dt)

            def resid(p, lo):
                return self._comp_residual(p, lo, rhs_hi, rhs_lo)
        else:
            rhs_hi = (phys.rho / grid.dt) * divv[INNER]

            def resid(p, lo):
                r = k_poisson.folded_lap(p, op) - rhs_hi
                return r, torch.max(torch.abs(r))

        p_int = fdm(rhs_hi)
        if self._fdm_static is not None:
            p_int = p_int + self._fdm_static
        pr = self.set_bc_pr(torch.nn.functional.pad(p_int,
                                                    (1, 1, 1, 1, 1, 1)))
        lo = torch.zeros_like(pr)
        if use_pair:
            # the pair image of the Dirichlet planes (their f64 profile's
            # rounding remainder in lo) before the refinement, which
            # leaves the planes frozen: the correction problem has
            # homogeneous BCs, the operator fdm diagonalizes
            pr, lo = self.set_bc_pr_pair(pr, lo)
        nchunks = grid.niter // grid.nchk
        hist = np.full(nchunks, np.nan, ft)
        r, emax = resid(pr, lo)
        err = host_scalar(emax * err_scale, ft)
        hist[0] = err
        rounds = 0
        while err >= eps and rounds < num.fdm_refine:
            # r = lap(p) - rhs, so the correction solves lap(e) = -r
            e = fdm(-r)
            nh, t = ds.two_sum(pr[INNER], e)
            nh, nl = ds.two_sum(nh, lo[INNER] + t)
            pr[INNER] = nh     # pr and lo are this solve's own tensors
            lo[INNER] = nl
            r, emax = resid(pr, lo)
            err = host_scalar(emax * err_scale, ft)
            rounds += 1
            hist[min(rounds, nchunks - 1)] = err
        if use_pair:
            pr, lo = self.set_bc_pr_pair(pr, lo)
            return pr, dprdtau, StepStats(iters=rounds, err=err,
                                          err_hist=hist, pr_lo=lo)
        # float64: the folded field (lo stays at its two_sum remainders,
        # which the plain residual does not read)
        return self.set_bc_pr(pr), dprdtau, StepStats(
            iters=rounds, err=err, err_hist=hist)

    def _kernel_chain(self, rhs, err_scale) -> Callable:
        """Loop body of one K1 iteration on the carry (p_in, p_out, d_in,
        d_out): pr ping-pongs, dpr is updated in place (d_out is K8's
        spare, None where no sweep runs); the reduction runs only on
        iterations the loop checks."""
        op, nchk, k1 = self._op, self.grid.nchk, self._poisson_iter

        def step(carry, it):
            p_in, p_out, d_in, d_out = carry
            ec = k1(p_in, p_out, d_in, rhs, op, (it + 1) % nchk == 0)
            return ((p_out, p_in, d_in, d_out),
                    None if ec is None else ec * err_scale, 1)
        return step

    def _sweep(self, carry, rhs, s, check):
        """One K8 launch of s iterations on the carry (p_in, p_out, d_in,
        d_out): both pairs ping-pong. Returns (carry, check value)."""
        p_in, p_out, d_in, d_out = carry
        ec = self._poisson_iter_sweeps(p_in, d_in, rhs, p_out, d_out,
                                       self._op, s, check)
        return (p_out, p_in, d_out, d_in), ec

    def _sweep_plan(self, budget: int) -> Optional[int]:
        """The JAX package's `_sweep_plan` (models/chorin.py:556-593): the
        largest depth s of `_sweep_depths` whose bodies of two K8(s)
        launches (2s iterations) keep every check and the budget's end on
        a body boundary (nchk % 2s == 0, nchk >= 4s, budget % 2s == 0,
        budget >= 2s), so exit decisions and iteration counts are the 1x
        loop's; None keeps the 1-iteration K1 bodies."""
        nchk = self.grid.nchk
        for s in sorted(self._sweep_depths, reverse=True):
            n = 2 * s
            if (nchk % n == 0 and nchk >= 2 * n and budget % n == 0
                    and budget >= n):
                return s
        return None

    def _folded_loop(self, rhs, err_scale, carry, it0: int, n_checked: int,
                     rem: int, eps, stall, err0=None):
        """pt_loop_fused over the folded iteration from global iteration
        it0 (1 after the exact first iteration, 0 for a correction phase)
        with a budget of n_checked iterations, on the carry (p_in, p_out,
        d_in, d_out); the trailing `rem` iterations run on K1 after the
        loop where it ends on its budget unconverged and not stalled. The
        body is chosen once; every body runs the same iterations with the
        same check values:
          * where the sweep plan is on (the JAX package's :1199-1233 and
            :1321-1345), two K8(s) launches with the check flag on the
            second; from it0 = 1 the loop first runs to global iteration
            2s (one K1, then s-1 K8(2) launches);
          * else, where K10 has a plan for the grid (`_resident_plan`),
            the whole loop as one K10 launch (ptloop.pt_loop_device,
            kernels/poisson.py `poisson_loop_resident`): check intervals
            of nit = nchk - it % nchk iterations from it0, pr and dpr
            updated in place (carry[1] is its scratch), each check value
            the one the flagged K1 launch would emit and each exit
            decision taken on the card, read by the host once;
          * else one K1 iteration."""
        nchk = self.grid.nchk
        if rem and it0 > n_checked:
            # the tail starts where the budget ends, so the budget must
            # reach it0: make_grid's niter is at least max(ny, nz) > nchk
            # = ny - 1 for niter_scale >= 1 (and 0, with no tail, for 0)
            raise ValueError(f"_folded_loop: a budget of {n_checked} "
                             f"iterations from it0 {it0} with a tail of "
                             f"{rem}")
        chain = self._kernel_chain(rhs, err_scale)
        s = self._sweep_plan(n_checked)
        if s is not None:
            if carry[3] is None:
                carry = (*carry[:3], torch.empty_like(carry[2]))
            if it0 == 1:
                carry = chain(carry, 0)[0]   # global iteration 2, unchecked
                for _ in range(s - 1):
                    carry = self._sweep(carry, rhs, 2, False)[0]
                it0 = 2 * s

            def body(c, it):
                c = self._sweep(c, rhs, s, False)[0]
                c, ec = self._sweep(c, rhs, s, (it + 2 * s) % nchk == 0)
                return c, None if ec is None else ec * err_scale, 2 * s
        elif self._resident_plan is not None:
            def run_loop(c, rule):
                return c, k_poisson.poisson_loop_resident(
                    c[0], c[2], rhs, self._op, rule, c[1])

            return pt_loop_device(run_loop, carry, it0, n_checked, nchk,
                                  eps, self.dtype, err_scale, stall=stall,
                                  err0=err0, rem=rem,
                                  tail_fn=self._tail(chain, rem))
        else:
            body = chain
        return self._fused(body, chain, carry, it0, n_checked, rem, eps,
                           stall, err0)

    @staticmethod
    def _tail(chain, rem: int) -> Callable:
        """The trailing partial chunk: `rem` single unchecked iterations
        of `chain`."""
        def tail(c):
            for _ in range(rem):
                c = chain(c, 0)[0]       # it=0: no check flag
            return c
        return tail

    def _fused(self, body, chain, carry, it0: int, n_checked: int, rem: int,
               eps, stall, err0=None):
        """pt_loop_fused of `body` from global iteration it0 over a budget
        of n_checked iterations, then `rem` single iterations of `chain`
        as its tail."""
        nchk = self.grid.nchk
        return pt_loop_fused(body, carry, it0, n_checked, nchk,
                             n_checked // nchk, eps, self.dtype, stall=stall,
                             err0=err0, rem=rem,
                             tail_fn=self._tail(chain, rem))

    def _poisson_solve_defect(self, pr, dprdtau, divv):
        """The folded + defect branch of the JAX package's
        `_poisson_solve_pallas` (chorin.py:1127-1462), both phases on
        `_folded_loop`'s bodies (one K10 launch a loop where it has a plan
        for the grid, K8 where the sweep plan is on, else K1)."""
        grid, phys, num = self.grid, self.cfg.physics, self.cfg.numerics
        nchunks, rem = self._budget()
        nchk, eps_it = grid.nchk, num.eps_it
        ft = np_float(self.dtype)
        err_scale = self._err_scale()
        # (hi, lo) RHS pair: hi is bit-identical to the plain computation
        # (same hot-loop trajectory); lo feeds the compensated residuals
        rhs3d, rhs_lo3d = ds.rhs_pair(divv, phys.rho / grid.dt,
                                      self._z_hoist)
        pr, dpr = self._first_iteration(pr, dprdtau, divv)

        # ---- phase 1: the folded kernel, handing off EARLY at
        # 1000*eps_it (the correction phase continues the same PT
        # trajectory with better arithmetic); a stall detector always
        # runs here, and the trailing partial chunk belongs to phase 2
        stall1 = self._stall or (num.stall_ratio, num.stall_checks)
        with span("ns3d.poisson.phase1"):
            carry, it1, _, hist1 = self._folded_loop(
                rhs3d, err_scale, (pr, torch.empty_like(pr), dpr, None), 1,
                nchunks * nchk, 0, eps_it * 1000.0, stall1)
        p1, dpr = carry[0], carry[2]

        # ---- phase 2: restarted defect correction. r0 is evaluated ONCE
        # with compensated arithmetic (error ~eps*|r0|), then lap(delta) =
        # -r0 is solved with the SAME kernel; delta starts at 0 and dpr
        # CARRIES OVER (by linearity the correction continues phase 1's
        # trajectory). Seeding err0 makes the loop a no-op when phase 1
        # already converged.
        with span("ns3d.poisson.phase2"):
            with span("ns3d.poisson.defect"):
                r0, emax = self._compensated_residual(
                    p1, rhs3d, rhs_lo3d, self._op)
                errh = host_scalar(emax * err_scale, ft)
                rhs2 = -r0
            n2 = nchunks * nchk + rem
            carry, it2, err, hist2 = self._folded_loop(
                rhs2, err_scale, (torch.zeros_like(p1), torch.empty_like(p1),
                                  dpr, carry[3]),
                0, nchunks * nchk, rem, eps_it, self._stall, err0=errh)
        chain2 = self._kernel_chain(rhs2, err_scale)
        hist = np.where(np.isnan(hist1), np.roll(hist2, it1 // nchk), hist1)

        def pair_of(carry):
            return self.set_bc_pr_pair(*_two_sum(p1, carry[0]))

        if self._marginal(err) and it2 > 0:
            carry, it2, err = self._stored_state_guarantee(
                carry, chain2, it2, n2, pair_of, (rhs3d, rhs_lo3d))
        with span("ns3d.poisson.pair"):
            hi, lo = pair_of(carry)
        return hi, carry[2], StepStats(iters=it1 + it2, err=err,
                                       err_hist=hist, iters_ext=it2,
                                       pr_lo=lo)

    def _ext_chain(self, rhs, err_scale) -> Callable:
        """Loop body of one K2 iteration on a ping-pong carry (hi, lo,
        hi_out, lo_out, dpr)."""
        op, nchk, k2 = self._op, self.grid.nchk, self._poisson_iter_ext

        def step(carry, it):
            hi, lo, hi_out, lo_out, dpr = carry
            ec = k2(hi, lo, hi_out, lo_out, dpr, rhs, op,
                    (it + 1) % nchk == 0)
            return ((hi_out, lo_out, hi, lo, dpr),
                    None if ec is None else ec * err_scale, 1)
        return step

    def _ext_loop(self, chain, rhs, err_scale, carry, nchunks: int,
                  rem: int, eps):
        """pt_loop_fused over the (hi, lo) iteration from global iteration
        0 with a budget of nchunks checks, on the carry (hi, lo, hi_out,
        lo_out, dpr) with the result in carry[0] and carry[1]; the
        trailing `rem` iterations run as single iterations of `chain`
        (`_ext_chain`, K2) after the loop where it ends on its budget
        unconverged and not stalled. The body is chosen once: where K10
        has a plan for the grid (`_resident_plan`) that K12's blocks hold
        (kernels/poisson.py `resident_ext_fits`: every plan on the presets'
        grids), one K12 launch from global iteration it to the next check
        (nit = nchk - it % nchk, hi, lo and dpr in place, carry[2] and
        carry[3] its scratch); else `chain`. Both take the same iterations
        and check values."""
        nchk = self.grid.nchk
        if k_poisson.resident_ext_fits(self._resident_plan):
            def body(c, it):
                nit = nchk - it % nchk
                ec = self._poisson_iter_resident_ext(
                    c[0], c[1], c[4], rhs, self._op, nit, c[2], c[3])
                return c, ec * err_scale, nit
        else:
            body = chain
        return self._fused(body, chain, carry, 0, nchunks * nchk, rem, eps,
                           self._stall)

    def _poisson_solve_extended(self, pr, dprdtau, divv):
        """The folded + extended hybrid branch of the JAX package's
        `_poisson_solve_pallas` (chorin.py:1127-1298 phase 1, on
        `_folded_loop`'s K10, K8 or K1 bodies; :1464-1607 phase 2, on
        `_ext_loop`'s K12 or K2 bodies)."""
        num, nchk = self.cfg.numerics, self.grid.nchk
        eps_it = num.eps_it
        nchunks, rem = self._budget()
        ft = np_float(self.dtype)
        err_scale = self._err_scale()
        rhs3d = self._rhs3d(divv)
        pr, dpr = self._first_iteration(pr, dprdtau, divv)

        # ---- phase 1: the folded kernel down to eps_it or its float32
        # noise floor, where the stall detector (always on here) hands
        # off; the trailing partial chunk belongs to phase 2
        stall1 = self._stall or (num.stall_ratio, num.stall_checks)
        with span("ns3d.poisson.phase1"):
            carry, it1, err1, hist1 = self._folded_loop(
                rhs3d, err_scale, (pr, torch.empty_like(pr), dpr, None), 1,
                nchunks * nchk, 0, eps_it, stall1)
        p1, dpr = carry[0], carry[2]
        if not (err1 >= ft(eps_it) and np.isfinite(err1)):
            # phase 1 converged (or failed): the pair is (pr1, 0)
            with span("ns3d.poisson.pair"):
                hi, lo = self.set_bc_pr_pair(p1, torch.zeros_like(p1))
            return hi, dpr, StepStats(iters=it1, err=err1, err_hist=hist1,
                                      iters_ext=0, pr_lo=lo)

        # ---- phase 2: the double-single kernel from the warm start
        # (hi, lo) = (pr1, 0), dpr carried over; the pair carries ~48
        # bits, so the iteration keeps converging below phase 1's floor
        n2 = nchunks * nchk + rem
        chain2 = self._ext_chain(rhs3d, err_scale)
        with span("ns3d.poisson.phase2"):
            carry = (p1, torch.zeros_like(p1), torch.empty_like(p1),
                     torch.empty_like(p1), dpr)
            carry, it2, err, hist2 = self._ext_loop(
                chain2, rhs3d, err_scale, carry, nchunks, rem, eps_it)

        def pair_of(carry):
            return self.set_bc_pr_pair(carry[0], carry[1])

        if self._marginal(err):
            carry, it2, err = self._stored_state_guarantee(
                carry, chain2, it2, n2, pair_of,
                ds.rhs_pair(divv, self.cfg.physics.rho / self.grid.dt,
                            self._z_hoist))
        hist = np.where(np.isnan(hist1), np.roll(hist2, it1 // nchk), hist1)
        with span("ns3d.poisson.pair"):
            hi, lo = pair_of(carry)
        return hi, carry[4], StepStats(iters=it1 + it2, err=err,
                                       err_hist=hist, iters_ext=it2,
                                       pr_lo=lo)

    def _poisson_solve_plain(self, pr, dprdtau, divv):
        """The folded non-hybrid branch of the JAX package's
        `_poisson_solve_pallas` (chorin.py:1290-1295; accuracy='none'):
        K1 over the whole budget, trailing partial chunk included, then
        the boundary planes; no stored pair."""
        nchunks, rem = self._budget()
        pr, dpr = self._first_iteration(pr, dprdtau, divv)
        with span("ns3d.poisson.phase1"):
            carry, it, err, hist = self._folded_loop(
                self._rhs3d(divv), self._err_scale(),
                (pr, torch.empty_like(pr), dpr, None), 1,
                nchunks * self.grid.nchk, rem, self.cfg.numerics.eps_it,
                self._stall)
        return self.set_bc_pr(carry[0]), carry[2], StepStats(
            iters=it, err=err, err_hist=hist)

    def _marginal(self, err) -> bool:
        """A loop exit just under eps_it (0.85*eps_it <= err < eps_it),
        where the stored pair's true residual can land above eps_it."""
        ft = np_float(self.dtype)
        eps_it = self.cfg.numerics.eps_it
        return bool(ft(0.85 * eps_it) <= err < ft(eps_it))

    def _stored_state_guarantee(self, carry, chain, it, budget, pair_of,
                                rhs_pair):
        """The stored-state guarantee (chorin.py:1412-1458, :1502-1555):
        the loop's exit check is one iteration stale and float32-evaluated,
        so on a marginal exit re-evaluate the STORED pair pair_of(carry)
        with the compensated residual and keep iterating in nchk chunks
        until it meets eps_it or the budget runs out, each chunk counted
        in `guarantee_iterations`. Returns (carry, it, err) with err the
        stored pair's compensated residual."""
        ft = np_float(self.dtype)
        eps, nchk = ft(self.cfg.numerics.eps_it), self.grid.nchk
        err_scale = self._err_scale()
        rhs_hi, rhs_lo = rhs_pair[0][INNER], rhs_pair[1][INNER]

        def true_err(c):
            emax = self._pair_residual_max(*pair_of(c), rhs_hi, rhs_lo,
                                           self._op)
            return host_scalar(emax * err_scale, ft)

        with span("ns3d.poisson.guarantee"):
            while true_err(carry) >= eps and it + nchk <= budget:
                for _ in range(nchk):
                    carry = chain(carry, 0)[0]   # it=0: no check flag
                it += nchk
                ChorinSolver.guarantee_iterations += nchk
            return carry, it, true_err(carry)

    def _comp_residual(self, hi, lo, rhs_hi, rhs_lo):
        """Compensated folded residual of a (hi, lo) pressure pair against
        a (hi, lo) RHS pair (the JAX package's _comp_residual_fn,
        chorin.py:909, term order x-, x+, y-, y+, z-, z+; kernels/poisson.py
        `pair_residual`, K13). Returns (r, max|r|) on the interior."""
        return self._pair_residual(hi, lo, rhs_hi, rhs_lo, self._op)

    # ---- full step ----

    def predictor_divv(self, state: FlowState) -> torch.Tensor:
        """The predictor-velocity divergence a step taken FROM `state`
        hands to its Poisson solve (the step's own prelude); snapshot it
        before stepping to feed stored_residual_err."""
        predict = self._predict if self.fused_step else k_step.predict_ops
        return predict(state.vx, state.vy, state.vz, self.masks,
                       self._consts)[3]

    def stored_residual_err(self, state_after: FlowState, *,
                            state_before: Optional[FlowState] = None,
                            divv: Optional[torch.Tensor] = None):
        """The reference's convergence criterion re-evaluated on the STORED
        pressure pair of `state_after`: max |lap(pr (+) pr_lo) - rhs| *
        ly^2/psc in compensated arithmetic, with rhs rebuilt from the
        pre-step predictor divergence (pass `state_before` or its
        `predictor_divv`). Returns a numpy scalar of the solver's dtype."""
        if divv is None:
            divv = self.predictor_divv(state_before)
        grid, phys = self.grid, self.cfg.physics
        zh = self._z_hoist[1:-1] if self.pressure_split else None
        rhs_hi, rhs_lo = ds.rhs_pair(divv[INNER], phys.rho / grid.dt, zh)
        lo = (state_after.pr_lo if state_after.pr_lo is not None
              else torch.zeros_like(state_after.pr))
        emax = self._pair_residual_max(state_after.pr, lo, rhs_hi, rhs_lo,
                                       self._op)
        ft = np_float(self.dtype)
        # (emax * ly^2) / psc, in the JAX expression's order
        return ft(host_scalar(emax, ft) * ft(grid.ly * grid.ly)) \
            / ft(phys.psc)

    def step(self, state: FlowState) -> Tuple[FlowState, StepStats]:
        return self._step_impl(state, self.poisson_solve,
                               chained=self.fused_step)

    def _first_step(self):
        """The ns3d.setup.first_step span around the solver's first step,
        whichever step function runs it (`_step_impl`, fullstep's)."""
        self._stepped = True
        return profiling.first_step(self.serial, self.device)

    def _check_state_device(self, state: FlowState) -> None:
        """Raise unless every tensor of `state` lies on the solver's
        device (a state made with state_from_numpy's or zeros_state's
        default lies on the card; pass the solver's device)."""
        dev = self.device   # a CUDA tensor's device carries its index
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        for name in (*FIELDS, "pr_lo"):
            t = getattr(state, name)
            if t is not None and t.device != dev:
                raise ValueError(
                    f"state.{name} lies on {t.device}, the solver on "
                    f"{self.device}: make the state on the solver's device "
                    f"(state_from_numpy(..., device=...)) or move it there")

    def _step_impl(self, state: FlowState, poisson_fn: Callable,
                   chained: bool = True, advect_kernel: bool = True
                   ) -> Tuple[FlowState, StepStats]:
        """One step around `poisson_fn(pr, dprdtau, divv) -> (pr, dprdtau,
        stats)`, the JAX package's `_step_impl` (chorin.py:1776-1841).
        chained=False runs its unchained branch: the chain as torch ops
        (update_tau, predict_v, cylinder mask, update_divv; correct_v,
        cylinder mask, set_bc_vel) and select-shift advection on K6 from
        face averages computed outside it (`_advect_pallas`).
        advect_kernel=False advects with torch ops instead (what its
        distributed step runs on a mesh of more than one device,
        allow_pallas_advect=False); compat always advects by gather."""
        with NO_SPAN if self._stepped else self._first_step(), \
                span("ns3d.step"):
            self._check_state_device(state)
            k = self._consts
            if chained:
                predict, correct = self._predict, self._correct
            else:
                predict = k_step.predict_ops
                correct = functools.partial(k_step.correct_ops,
                                            set_bc_vel=self.set_bc_vel)
            with span("ns3d.predict"):
                vx, vy, vz, divv = predict(state.vx, state.vy, state.vz,
                                           self.masks, k)
                c = mask_tracer(state.c, self.masks)
            with span("ns3d.poisson"):
                pr, dprdtau, stats = poisson_fn(state.pr, state.dprdtau,
                                                divv)
            # pop the stored-pair low word out of the stats channel into
            # the state (the corrector and the next solve use hi only)
            pr_lo, stats.pr_lo = stats.pr_lo, None
            with span("ns3d.correct"):
                vx, vy, vz = correct(vx, vy, vz, pr, self.masks, k)
            with span("ns3d.advect"):
                if self.advect_method == "gather" or not advect_kernel:
                    vx, vy, vz, c, n_clamped = adv.advect(
                        vx, vy, vz, c, k.dt, k.dx, k.dy, k.dz,
                        compat=self.cfg.compat, method=self.advect_method,
                        k=self.advect_k)
                elif chained:
                    vx, vy, vz, c, n_clamped = k_advect.advect(
                        vx, vy, vz, c, k, self.advect_k, plain=self.plain)
                else:
                    vx, vy, vz, c, n_clamped = k_advect.advect_unchained(
                        vx, vy, vz, c, k, self.advect_k, plain=self.plain)
                stats.advect_clamped = host_scalar(n_clamped, int)
            return (FlowState(pr=pr, vx=vx, vy=vy, vz=vz, c=c,
                              dprdtau=dprdtau, pr_lo=pr_lo), stats)

    def step_shard_map(self, mesh: Mesh, use_pallas: Optional[bool] = None
                       ) -> Callable:
        """A step whose Poisson solve runs distributed over `mesh`
        (parallel/halo.py), the JAX package's `step_shard_map_jit`
        (models/chorin.py:1642-1688). The state stays global-view on the
        solver's device; the solve splits pr, dprdtau and the RHS into the
        mesh's blocks at entry and joins them at exit. On a mesh of more
        than one shard the rest of the step is the unfused chain as torch
        ops; on one shard it is the solver's own (K3, K4, K5 outside
        compat mode, or with fused_step=False the torch-ops chain and
        K6). The solve's iters, err and err_hist go into the
        StepStats; there is no stored pair (pr_lo is None).

        use_pallas (auto: `_dist_kernels`): the per-shard kernel loop,
        K2-dist on the (hi, lo) pair where the solver is extended, else
        K7-dist; otherwise the plain torch-ops loop (any 3D mesh, any halo
        width)."""
        self._check_pt("the distributed solve")
        if use_pallas is None:
            use_pallas = self._dist_kernels(mesh)
        solve = build_poisson_shard_map(
            mesh, self.grid, self.cfg.physics, self.cfg.numerics.eps_it,
            self.cfg.variant, self.dtype, halo_width=self.cfg.parallel.halo,
            pressure_split=self.pressure_split, stall=self._stall,
            use_pallas=use_pallas, extended=self.extended and use_pallas)
        rho_dt = self.cfg.physics.rho / self.grid.dt

        def poisson(pr, dprdtau, divv):
            pr, dprdtau, iters, err, hist = solve(pr, dprdtau, rho_dt * divv)
            return pr, dprdtau, StepStats(iters=iters, err=err,
                                          err_hist=hist)

        def step(state: FlowState) -> Tuple[FlowState, StepStats]:
            return self._step_impl(
                state, poisson, chained=self.fused_step and mesh.size == 1,
                advect_kernel=mesh.size == 1)
        return step

    def step_fullstep(self, mesh: Mesh, use_pallas: Optional[bool] = None
                      ) -> Callable:
        """The step with every stage per shard on the owned-face layout
        and explicit halo exchanges (parallel/fullstep.py), the JAX
        package's `step_fullstep_jit` (models/chorin.py:1690-1699): returns
        step(dist) -> (dist, stats) on a parallel.fullstep.DistState
        (to_dist / from_dist convert at the I/O boundaries). use_pallas as
        in step_shard_map. The step reads advect_method when it is built."""
        from ..parallel.fullstep import build_fullstep
        self._check_pt("the full step")
        return build_fullstep(self, mesh, use_pallas=use_pallas)

    def _check_pt(self, what: str) -> None:
        if self._fdm is not None:
            raise NotImplementedError(
                f"the fdm backend runs on one device: {what} runs the "
                "pseudo-transient loop")

    def _dist_kernels(self, mesh: Mesh) -> bool:
        """use_pallas's auto rule of the distributed steps (the JAX
        package's, models/chorin.py:1656-1660): the solver's kernels carry
        its hot path (float32 and use_pallas not False, `uses_kernels`),
        the mesh is x-only and the halo width 1."""
        return (not self.plain and mesh.shape[1] == 1 and mesh.shape[2] == 1
                and self.cfg.parallel.halo == 1)

    def run(self, nt: Optional[int] = None,
            state: Optional[FlowState] = None,
            callback=None) -> Tuple[FlowState, List[StepStats]]:
        """Host loop over nt steps (default cfg.numerics.nt);
        callback(it, state, stats) runs after each step."""
        nt = self.cfg.numerics.nt if nt is None else nt
        state = self.init_state() if state is None else state
        all_stats = []
        for it in range(1, nt + 1):
            state, stats = self.step(state)
            all_stats.append(stats)
            if callback is not None:
                callback(it, state, stats)
        return state, all_stats


def gather_inner(state: FlowState):
    """Inner fields as the reference's final gather returns them
    (NavierStokes3D_multi_gpu.jl:528-535), as numpy arrays: C, Pr
    (nx-2, ny-2, nz-2) and the velocities with their staggered dim one
    larger."""
    sl = (slice(1, -1),) * 3
    return tuple(getattr(state, k)[sl].cpu().numpy()
                 for k in ("c", "pr", "vx", "vy", "vz"))
