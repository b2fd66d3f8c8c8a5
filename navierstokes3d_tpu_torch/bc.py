"""Boundary conditions of the gpu variant (torch port of
navierstokes3d_tpu/bc.py).

The primitives are functional (they read the pre-update planes, as the
reference kernels do) and the orchestrators keep the reference's exact
application order (NavierStokes3D_gpu.jl:221-286; edges and corners
depend on it):
  velocity: zero-gradient x/y, no-slip bottom + free-slip top (bc_zV!);
  pressure: zero-gradient y/z + hydrostatic Dirichlet on both x planes,
            with a +100 Pa inlet head that drives the flow (:257-260).

The port implements the gpu variant under the hydrostatic pressure split
(the main path). The multi variant's float32 path needs the extended
(double-single) Poisson kernel and is not ported yet (ROADMAP queue 2, K2).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np

from .config import SimConfig
from .grid import Grid


def _not_ported(cfg: SimConfig, pressure_split: bool):
    if cfg.variant == "multi":
        raise NotImplementedError(
            "the multi variant is not ported yet: its float32 path needs "
            "the extended Poisson kernel (ROADMAP queue 2, K2)")
    if cfg.variant != "gpu":
        raise ValueError(f"unknown variant {cfg.variant!r}")
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

def make_bc_fns(cfg: SimConfig, grid: Grid, pressure_split: bool = False
                ) -> Tuple[Callable, Callable]:
    """(set_bc_vel, set_bc_pr) for the gpu variant under the split:
      set_bc_vel(vx, vy, vz) -> (vx, vy, vz)
      set_bc_pr(pr) -> pr   (the split field p' = Pr - P_static(z))"""
    _not_ported(cfg, pressure_split)
    rho_g_dz = cfg.physics.rho * cfg.physics.g * grid.dz

    def set_bc_vel(vx, vy, vz):
        # Order: NavierStokes3D_gpu.jl:264-279 (the inlet-profile BCs are
        # commented out in the reference; the pressure head drives it)
        vx = noslip_bottom_slip_top(zero_grad_y(zero_grad_x(vx)))
        vy = noslip_bottom_slip_top(zero_grad_y(zero_grad_x(vy)))
        vz = noslip_bottom_slip_top(zero_grad_y(zero_grad_x(vz)))
        return vx, vy, vz

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
    difference term vanishes after the BC) and 1 elsewhere. gpu variant:
    y and z are zero-gradient at both ends (gpu.jl:281-284); the x planes
    are Dirichlet, read as frozen values (the JAX package's
    poisson_bc_spec, kernels/poisson.py:61, and its weight rows :216-219).
    Keys xm, xp, ym, yp, zm, zp (m: the -1 neighbor, p: the +1 one)."""
    _not_ported(cfg, pressure_split)
    out = {}
    for axis, n, zero_grad in (("x", grid.nx, False), ("y", grid.ny, True),
                               ("z", grid.nz, True)):
        am = np.ones(n - 2)
        ap = np.ones(n - 2)
        if zero_grad:
            am[0] = 0.0
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
