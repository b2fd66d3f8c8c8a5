"""Boundary conditions (torch port of navierstokes3d_tpu/bc.py).

The primitives are functional (they read the pre-update planes, as the
reference kernels do) and the orchestrators keep the reference's exact
application order (edges and corners depend on it):

  gpu variant (NavierStokes3D_gpu.jl:221-286):
    velocity: zero-gradient x/y, no-slip bottom + free-slip top (bc_zV!);
    pressure: zero-gradient y/z + hydrostatic Dirichlet on both x planes,
              with a +100 Pa inlet head that drives the flow (:257-260);
              under the hydrostatic split the image of the same sequence
              on p' = Pr - P_static(z).
  multi variant (NavierStokes3D_multi_gpu.jl:108-184):
    velocity: zero-gradient on all faces (compat keeps the reference's
              omitted bc_y!(Vy) and bc_z!(Vz), :160-163), then the inlet
              plane Vx = vin;
    pressure: zero-gradient on all faces, then the outlet plane Pr = 0.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from .config import SimConfig
from .grid import Grid


def _check_variant(cfg: SimConfig, pressure_split: bool):
    if cfg.variant not in ("gpu", "multi"):
        raise ValueError(f"unknown variant {cfg.variant!r}")
    if pressure_split and cfg.variant != "gpu":
        raise NotImplementedError(
            "pressure_split is defined for the gpu variant's hydrostatic "
            "profile (the multi preset has g=0, making the split an "
            "identity)")


# ---- plane primitives ----

def zero_grad_x(a):
    """bc_x!: copy 2nd/2nd-last yz-planes outward (gpu.jl:221-225)."""
    b = a.clone()
    b[0] = a[1]
    b[-1] = a[-2]
    return b


def zero_grad_y(a):
    b = a.clone()
    b[:, 0] = a[:, 1]
    b[:, -1] = a[:, -2]
    return b


def zero_grad_z(a):
    b = a.clone()
    b[:, :, 0] = a[:, :, 1]
    b[:, :, -1] = a[:, :, -2]
    return b


def dirichlet_x_lo(a, val):
    """bc_x_Vx!-style inlet plane (multi_gpu.jl:138-141)."""
    b = a.clone()
    b[0] = val
    return b


def dirichlet_x_hi(a, val):
    """bc_x_Pr!-style outlet plane (multi_gpu.jl:147-150)."""
    b = a.clone()
    b[-1] = val
    return b


def noslip_bottom_slip_top(a):
    """bc_zV!: no-slip invert, free-slip top (gpu.jl:239-243)."""
    b = a.clone()
    b[:, :, 0] = 0.0
    b[:, :, -1] = a[:, :, -2]
    return b


def hydrostatic_x(pr, grid: Grid, rho, g, inlet_head):
    """bc_xhydstatic!: hydrostatic Dirichlet on both x planes; the inlet
    gets an extra +`inlet_head` Pa (gpu.jl:257-261). 1-based iz arithmetic,
    evaluated in the field's dtype as the JAX function does:
    value(iz) = rho*g*(nz - iz + 0.5)*dz."""
    iz = torch.arange(1, grid.nz + 1, dtype=pr.dtype, device=pr.device)
    prof = rho * g * (grid.nz - iz + 0.5) * grid.dz        # (nz,)
    b = pr.clone()
    b[0] = (prof + inlet_head).expand(grid.ny, grid.nz)
    b[-1] = prof.expand(grid.ny, grid.nz)
    return b


def affine_grad_z(a, lo_add, hi_add):
    """Zero-gradient z planes with an additive offset: the split-pressure
    (p' = Pr - P_static(z)) image of bc_z! — Pr[:,:,1]=Pr[:,:,2] becomes
    p'[:,:,1] = p'[:,:,2] - rho*g*dz (P_static is linear in z)."""
    b = a.clone()
    b[:, :, 0] = a[:, :, 1] + lo_add
    b[:, :, -1] = a[:, :, -2] + hi_add
    return b


# ---- orchestrators ----

def velocity_bc(variant: str, vin: float, compat: bool = False) -> Callable:
    """set_bc_vel(vx, vy, vz) -> (vx, vy, vz) of a variant; K4's plain
    version builds its BC stack here from StepConsts (compat=False)."""
    if variant == "multi":
        def set_bc_vel(vx, vy, vz):
            # Order: NavierStokes3D_multi_gpu.jl:156-169; compat keeps the
            # reference's omitted bc_y!(Vy) and bc_z!(Vz) (:160-163)
            vx = zero_grad_z(zero_grad_y(zero_grad_x(vx)))
            vy = zero_grad_x(vy)
            vy = zero_grad_z(vy if compat else zero_grad_y(vy))
            vz = zero_grad_y(zero_grad_x(vz))
            vz = vz if compat else zero_grad_z(vz)
            return dirichlet_x_lo(vx, vin), vy, vz   # inlet (:164-166)
    elif variant == "gpu":
        def set_bc_vel(vx, vy, vz):
            # Order: NavierStokes3D_gpu.jl:264-279 (the inlet-profile BCs
            # are commented out in the reference; the pressure head drives
            # the flow)
            vx = noslip_bottom_slip_top(zero_grad_y(zero_grad_x(vx)))
            vy = noslip_bottom_slip_top(zero_grad_y(zero_grad_x(vy)))
            vz = noslip_bottom_slip_top(zero_grad_y(zero_grad_x(vz)))
            return vx, vy, vz
    else:
        raise ValueError(f"unknown variant {variant!r}")
    return set_bc_vel


def make_bc_fns(cfg: SimConfig, grid: Grid, pressure_split: bool = False
                ) -> Tuple[Callable, Callable]:
    """(set_bc_vel, set_bc_pr) of the configured variant:
      set_bc_vel(vx, vy, vz) -> (vx, vy, vz)
      set_bc_pr(pr) -> pr   (gpu under the split: the field
                             p' = Pr - P_static(z))"""
    _check_variant(cfg, pressure_split)
    phys = cfg.physics
    set_bc_vel = velocity_bc(cfg.variant, phys.vin, cfg.compat)
    if cfg.variant == "multi":
        def set_bc_pr(pr):
            # Order: NavierStokes3D_multi_gpu.jl:175-184
            pr = zero_grad_z(zero_grad_y(zero_grad_x(pr)))
            return dirichlet_x_hi(pr, 0.0)   # outlet (:179-181)
        return set_bc_vel, set_bc_pr
    if not pressure_split:
        def set_bc_pr(pr):
            # Order: NavierStokes3D_gpu.jl:281-286
            pr = zero_grad_z(zero_grad_y(pr))
            return hydrostatic_x(pr, grid, phys.rho, phys.g, inlet_head=100.0)
        return set_bc_vel, set_bc_pr
    rho_g_dz = phys.rho * phys.g * grid.dz

    def set_bc_pr(pr):
        # split image of NavierStokes3D_gpu.jl:281-286 (same order)
        pr = zero_grad_y(pr)
        pr = affine_grad_z(pr, -rho_g_dz, +rho_g_dz)
        pr[0] = 100.0
        pr[-1] = 0.0
        return pr

    return set_bc_vel, set_bc_pr


def folded_masks(cfg: SimConfig, grid: Grid,
                 pressure_split: bool = False) -> Dict[str, np.ndarray]:
    """The pressure BCs folded into the Poisson stencil: per axis and side,
    a float64 coefficient mask over the interior cells (length n-2) that
    is 0 where that neighbor is a zero-gradient copy of the center (the
    difference term vanishes after the BC) and 1 elsewhere. Both variants:
    y and z are zero-gradient at both ends (gpu.jl:281-284 /
    multi_gpu.jl:175-178). x: gpu has Dirichlet planes at both ends, read
    as frozen values; multi is zero-gradient at the inlet and Dirichlet
    (frozen 0) at the outlet (the JAX solver's _folded_masks,
    models/chorin.py:896-904). Keys xm, xp, ym, yp, zm, zp (m: the -1
    neighbor, p: the +1 one)."""
    _check_variant(cfg, pressure_split)
    x_lo_zero_grad = cfg.variant == "multi"
    out = {}
    for axis, n, lo_zg, hi_zg in (("x", grid.nx, x_lo_zero_grad, False),
                                  ("y", grid.ny, True, True),
                                  ("z", grid.nz, True, True)):
        am = np.ones(n - 2)
        ap = np.ones(n - 2)
        if lo_zg:
            am[0] = 0.0
        if hi_zg:
            ap[-1] = 0.0
        out[axis + "m"], out[axis + "p"] = am, ap
    return out


def make_bc_pr_pair(cfg: SimConfig, grid: Grid,
                    pressure_split: bool = False) -> Callable:
    """(hi, lo) double-single image of set_bc_pr: set_bc_pr_pair(hi, lo)
    -> (hi, lo) such that hi + lo satisfies the pressure BC in near-real
    arithmetic. Zero-gradient faces copy both words; the affine-z copy
    carries the rounding error of `hi_neighbor + add` into lo through an
    exact two_sum; the split's Dirichlet values 100 and 0 are exact in f32,
    and the unsplit gpu planes put the rounded float64 profile in hi and
    its representation error in lo."""
    _check_variant(cfg, pressure_split)
    if cfg.variant == "multi":
        # every face is a zero-gradient copy (exact for both words) and the
        # outlet Dirichlet 0.0 is exactly representable: set_bc_pr on each
        set_bc_pr = make_bc_fns(cfg, grid)[1]

        def multi_pair_bc(hi, lo):
            return set_bc_pr(hi), set_bc_pr(lo)
        return multi_pair_bc
    if not pressure_split:
        return _unsplit_gpu_pair_bc(cfg, grid)
    rho_g_dz = cfg.physics.rho * cfg.physics.g * grid.dz

    def two_sum_const(a, c):
        """s = fl(a + c), e = a + c - s exactly (c a scalar constant)."""
        s = a + c
        ap = s - c
        bp = s - ap
        return s, (a - ap) + (c - bp)

    def pair_bc(hi, lo):
        hi = zero_grad_y(hi)
        lo = zero_grad_y(lo)
        s_lo, e_lo = two_sum_const(hi[:, :, 1], -rho_g_dz)
        s_hi, e_hi = two_sum_const(hi[:, :, -2], +rho_g_dz)
        # hi and lo are fresh copies here (zero_grad_y), so the plane
        # writes below touch no caller tensor
        hi[:, :, 0] = s_lo
        hi[:, :, -1] = s_hi
        lo[:, :, 0] = lo[:, :, 1] + e_lo
        lo[:, :, -1] = lo[:, :, -2] + e_hi
        hi[0] = 100.0
        hi[-1] = 0.0
        lo[0] = 0.0
        lo[-1] = 0.0
        return hi, lo

    return pair_bc


def _unsplit_gpu_pair_bc(cfg: SimConfig, grid: Grid) -> Callable:
    """The unsplit gpu pair BCs (NavierStokes3D_gpu.jl:281-286): zero-
    gradient y/z copies of both words, then the hydrostatic Dirichlet
    planes with hi = the float64 profile rounded to the words' dtype and
    lo = the representation error of that rounding."""
    phys = cfg.physics
    iz = np.arange(1, grid.nz + 1, dtype=np.float64)
    prof64 = phys.rho * phys.g * (grid.nz - iz + 0.5) * grid.dz
    prof2d = np.broadcast_to(prof64[None, :], (grid.ny, grid.nz))

    def words(plane, t):
        npdt = np.float32 if t.dtype == torch.float32 else np.float64
        hi = plane.astype(npdt)
        return (torch.tensor(hi, device=t.device),
                torch.tensor((plane - hi).astype(npdt), device=t.device))

    def pair_bc(hi, lo):
        hi = zero_grad_z(zero_grad_y(hi))
        lo = zero_grad_z(zero_grad_y(lo))
        hi[0], lo[0] = words(prof2d + 100.0, hi)
        hi[-1], lo[-1] = words(prof2d, hi)
        return hi, lo

    return pair_bc
