"""Physics of the Chorin projection step as plain torch functions (port of
navierstokes3d_tpu/ops/physics.py).

Each function replicates one @parallel kernel of the reference
(scripts/NavierStokes3D_gpu.jl:177-219) with the JAX package's expression
order. Interior updates are `full + pad(delta)`, so the boundary is
`x + 0.0` (not a select), as in the JAX functions. These are the plain
versions the fused kernels (kernels/fused_step.py) are held against.
"""

from __future__ import annotations

import torch.nn.functional as F

from . import stencil as st
from .stencil import div


def _pad1(a):
    """Zero-pad an interior-shaped array back to full shape."""
    return F.pad(a, (1, 1, 1, 1, 1, 1))


def update_tau(vx, vy, vz, mu, dx, dy, dz):
    """Deviatoric viscous stress on the staggered grid (update_τ!,
    NavierStokes3D_gpu.jl:177-185). Returns (txx, tyy, tzz) at centers
    (nx,ny,nz) and (txy, txz, tyz) at edges (nx-1,ny-1,nz-1)."""
    dvxdx = div(st.d_xa(vx), dx)
    dvydy = div(st.d_ya(vy), dy)
    dvzdz = div(st.d_za(vz), dz)
    divv = dvxdx + dvydy + dvzdz
    th = div(divv, 3.0)
    txx = 2.0 * mu * (dvxdx - th)
    tyy = 2.0 * mu * (dvydy - th)
    tzz = 2.0 * mu * (dvzdz - th)
    txy = mu * (div(vx[1:-1, 1:, 1:] - vx[1:-1, :-1, 1:], dy)
                + div(vy[1:, 1:-1, 1:] - vy[:-1, 1:-1, 1:], dx))
    txz = mu * (div(vx[1:-1, 1:, 1:] - vx[1:-1, 1:, :-1], dz)
                + div(vz[1:, 1:, 1:-1] - vz[:-1, 1:, 1:-1], dx))
    tyz = mu * (div(vy[1:, 1:-1, 1:] - vy[1:, 1:-1, :-1], dz)
                + div(vz[1:, 1:, 1:-1] - vz[1:, :-1, 1:-1], dy))
    return txx, tyy, tzz, txy, txz, tyz


def predict_v(vx, vy, vz, txx, tyy, tzz, txy, txz, tyz, rho, g, dt, dx, dy,
              dz):
    """Chorin step 1: V* = V + dt/ρ (∇·τ), with gravity on Vz
    (predict_V!, NavierStokes3D_gpu.jl:187-192). Interior-only updates."""
    fx = (div(txx[1:, 1:-1, 1:-1] - txx[:-1, 1:-1, 1:-1], dx)
          + div(txy[:, 1:, :-1] - txy[:, :-1, :-1], dy)
          + div(txz[:, :-1, 1:] - txz[:, :-1, :-1], dz))
    vx = vx + _pad1(dt / rho * fx)
    fy = (div(tyy[1:-1, 1:, 1:-1] - tyy[1:-1, :-1, 1:-1], dy)
          + div(txy[1:, :, :-1] - txy[:-1, :, :-1], dx)
          + div(tyz[:-1, :, 1:] - tyz[:-1, :, :-1], dz))
    vy = vy + _pad1(dt / rho * fy)
    fz = (div(tzz[1:-1, 1:-1, 1:] - tzz[1:-1, 1:-1, :-1], dz)
          + div(txz[1:, :-1, :] - txz[:-1, :-1, :], dx)
          + div(tyz[:-1, 1:, :] - tyz[:-1, :-1, :], dy)
          - rho * g)
    vz = vz + _pad1(dt / rho * fz)
    return vx, vy, vz


def update_divv(vx, vy, vz, dx, dy, dz):
    """Velocity divergence at cell centers (update_∇V!, gpu.jl:194-197)."""
    return st.divergence(vx, vy, vz, dx, dy, dz)


def poisson_iter(pr, dprdtau, divv, rho, dt, dtau, damp, dx, dy, dz):
    """One damped pseudo-transient iteration in the reference's exact form
    (update_dPrdτ! + update_Pr!, NavierStokes3D_gpu.jl:199-207):
      dPrdτ <- dPrdτ (1-damp) + dτ (∇²Pr - ρ/dt ∇·V)   on the interior
      Pr    <- Pr + dτ dPrdτ
    The folded solve runs it once as its exact first iteration."""
    lap = st.laplacian_inner(pr, dx, dy, dz)
    resid = lap - (rho / dt) * st.inn(divv)
    dprdtau = dprdtau * (1.0 - damp) + dtau * _pad1(resid)
    pr = pr + dtau * dprdtau
    return pr, dprdtau


def poisson_residual(pr, divv, rho, dt, dx, dy, dz):
    """Poisson residual on the interior, (nx-2, ny-2, nz-2) (compute_res!,
    NavierStokes3D_gpu.jl:209-212): compat's convergence check."""
    return st.laplacian_inner(pr, dx, dy, dz) - (rho / dt) * st.inn(divv)


def correct_v(vx, vy, vz, pr, dt, rho, dx, dy, dz):
    """Chorin step 2: project out the pressure gradient, interior only
    (correct_V!, NavierStokes3D_gpu.jl:214-219)."""
    c = -dt / rho
    vx = vx + _pad1(div(c * (pr[1:, 1:-1, 1:-1] - pr[:-1, 1:-1, 1:-1]), dx))
    vy = vy + _pad1(div(c * (pr[1:-1, 1:, 1:-1] - pr[1:-1, :-1, 1:-1]), dy))
    vz = vz + _pad1(div(c * (pr[1:-1, 1:-1, 1:] - pr[1:-1, 1:-1, :-1]), dz))
    return vx, vy, vz
