"""Boundary conditions (torch port of navierstokes3d_tpu/bc.py).

The primitives are functional (they read the pre-update planes, as the
reference kernels do) and the orchestrators keep the reference's exact
application order (edges and corners depend on it):

  gpu variant (NavierStokes3D_gpu.jl:221-286), under the hydrostatic split:
    velocity: zero-gradient x/y, no-slip bottom + free-slip top (bc_zV!);
    pressure: zero-gradient y/z + hydrostatic Dirichlet on both x planes,
              with a +100 Pa inlet head that drives the flow (:257-260).
  multi variant (NavierStokes3D_multi_gpu.jl:108-184), compat=False:
    velocity: zero-gradient on all faces, then the inlet plane Vx = vin;
    pressure: zero-gradient on all faces, then the outlet plane Pr = 0.

Not ported: compat mode (the multi reference's omitted velocity BCs) and
the unsplit gpu pressure BCs (ROADMAP queue 1, items 4 and 10).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np

from .config import SimConfig
from .grid import Grid


def _not_ported(cfg: SimConfig, pressure_split: bool):
    if cfg.variant not in ("gpu", "multi"):
        raise ValueError(f"unknown variant {cfg.variant!r}")
    if cfg.compat:
        raise NotImplementedError(
            "compat-mode boundary conditions are not ported yet (ROADMAP "
            "queue 1, item 10)")
    if cfg.variant == "multi":
        if pressure_split:
            raise NotImplementedError(
                "pressure_split is defined for the gpu variant's "
                "hydrostatic profile (the multi preset has g=0)")
        return
    if not pressure_split:
        raise NotImplementedError(
            "the gpu variant is ported under the hydrostatic pressure "
            "split only (the unsplit and compat paths are ROADMAP queue 1, "
            "items 4 and 10)")


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


def affine_grad_z(a, lo_add, hi_add):
    """Zero-gradient z planes with an additive offset: the split-pressure
    (p' = Pr - P_static(z)) image of bc_z! — Pr[:,:,1]=Pr[:,:,2] becomes
    p'[:,:,1] = p'[:,:,2] - rho*g*dz (P_static is linear in z)."""
    b = a.clone()
    b[:, :, 0] = a[:, :, 1] + lo_add
    b[:, :, -1] = a[:, :, -2] + hi_add
    return b


# ---- orchestrators ----

def velocity_bc(variant: str, vin: float) -> Callable:
    """set_bc_vel(vx, vy, vz) -> (vx, vy, vz) of a variant (compat=False);
    K4's plain version builds its BC stack here from StepConsts."""
    if variant == "multi":
        def set_bc_vel(vx, vy, vz):
            # Order: NavierStokes3D_multi_gpu.jl:156-169 (the fixed path
            # applies the bc_y!/bc_z! calls the reference omits)
            vx = zero_grad_z(zero_grad_y(zero_grad_x(vx)))
            vy = zero_grad_z(zero_grad_y(zero_grad_x(vy)))
            vz = zero_grad_z(zero_grad_y(zero_grad_x(vz)))
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
      set_bc_pr(pr) -> pr   (gpu: the split field p' = Pr - P_static(z))"""
    _not_ported(cfg, pressure_split)
    set_bc_vel = velocity_bc(cfg.variant, cfg.physics.vin)
    if cfg.variant == "multi":
        def set_bc_pr(pr):
            # Order: NavierStokes3D_multi_gpu.jl:175-184
            pr = zero_grad_z(zero_grad_y(zero_grad_x(pr)))
            return dirichlet_x_hi(pr, 0.0)   # outlet (:179-181)
        return set_bc_vel, set_bc_pr
    rho_g_dz = cfg.physics.rho * cfg.physics.g * grid.dz

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
    _not_ported(cfg, pressure_split)
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
    exact two_sum; the Dirichlet values 100 and 0 are exact in f32."""
    _not_ported(cfg, pressure_split)
    if cfg.variant == "multi":
        # every face is a zero-gradient copy (exact for both words) and the
        # outlet Dirichlet 0.0 is exactly representable: set_bc_pr on each
        set_bc_pr = make_bc_fns(cfg, grid)[1]

        def multi_pair_bc(hi, lo):
            return set_bc_pr(hi), set_bc_pr(lo)
        return multi_pair_bc
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
