"""Immersed elliptic-cylinder mask (torch port of
navierstokes3d_tpu/ops/cylinder.py).

Reference: set_cylinder! (NavierStokes3D_gpu.jl:336-368). The geometry is
static: the masks are evaluated once on the host in numpy as 2D (x, y)
planes (the cylinder is extruded along z) and kept as bool tensors on the
solver's device, broadcast along z where they are applied:

  C  <- 1 where (xc,yc) inside 1.05 x radius   (tracer seed ring)
  Vi <- 0 where the component's own staggered location is inside the radius
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import SimConfig
from ..grid import Grid


@dataclasses.dataclass(frozen=True)
class CylinderMasks:
    """2D (x,y) bool masks, broadcast along z at application time."""
    mask_c: torch.Tensor    # (nx, ny)
    mask_vx: torch.Tensor   # (nx+1, ny)
    mask_vy: torch.Tensor   # (nx, ny+1)
    mask_vz: torch.Tensor   # (nx, ny)


def _inside(x, y, cfg: SimConfig, thresh: float) -> np.ndarray:
    phys = cfg.physics
    sinb, cosb = np.sin(phys.beta), np.cos(phys.beta)
    xr = (x - phys.ox) * cosb - (y - phys.oy) * sinb
    yr = (x - phys.ox) * sinb + (y - phys.oy) * cosb
    return (xr * xr / phys.a2 + yr * yr / phys.b2) < thresh


def build_masks(cfg: SimConfig, grid: Grid,
                device: torch.device | str = "cpu") -> CylinderMasks:
    """Evaluate the reference's per-location coordinate formulas
    (gpu variant: NavierStokes3D_gpu.jl:337-338, where compat=True keeps
    the reference's yc = yv + dx/2 quirk; multi: multi_gpu.jl:250-251)."""
    nx, ny = grid.nx, grid.ny
    dx, dy = grid.dx, grid.dy
    # 1-based index arithmetic as in the reference kernels
    i_c = np.arange(1, nx + 2)   # covers both nx and nx+1 sized x-dims
    j_c = np.arange(1, ny + 2)
    xc = -(grid.lx - dx) / 2 + (i_c - 1) * dx
    yv_ = (j_c - 1) * dy - grid.ly / 2
    if cfg.variant == "gpu" and cfg.compat:
        yc = yv_ + dx / 2  # reference quirk: dx instead of dy (gpu.jl:338)
    else:
        yc = yv_ + dy / 2
    xv = xc - dx / 2

    def grid2d(xs, ys, shape):
        return (np.broadcast_to(xs[: shape[0], None], shape),
                np.broadcast_to(ys[None, : shape[1]], shape))

    xcc, ycc = grid2d(xc, yc, (nx, ny))
    xvv, ycv = grid2d(xv, yc, (nx + 1, ny))
    xcv, yvv = grid2d(xc, yv_, (nx, ny + 1))

    def t(m):
        return torch.tensor(np.ascontiguousarray(m), dtype=torch.bool,
                            device=device)
    return CylinderMasks(
        mask_c=t(_inside(xcc, ycc, cfg, 1.05)),
        mask_vx=t(_inside(xvv, ycv, cfg, 1.0)),
        mask_vy=t(_inside(xcv, yvv, cfg, 1.0)),
        mask_vz=t(_inside(xcc, ycc, cfg, 1.0)),
    )


def mask_tracer(c, masks: CylinderMasks):
    """C=1 inside the tracer seed ring (broadcast along z)."""
    one = torch.ones((), dtype=c.dtype, device=c.device)
    return torch.where(masks.mask_c[:, :, None], one, c)


def mask_velocities(vx, vy, vz, masks: CylinderMasks):
    """V=0 inside the solid, each component at its own staggered location
    (broadcast along z)."""
    zero = torch.zeros((), dtype=vx.dtype, device=vx.device)
    return (torch.where(masks.mask_vx[:, :, None], zero, vx),
            torch.where(masks.mask_vy[:, :, None], zero, vy),
            torch.where(masks.mask_vz[:, :, None], zero, vz))


def apply_cylinder(c, vx, vy, vz, masks: CylinderMasks):
    """C=1 inside the tracer ring; V=0 inside the solid (broadcast along z)."""
    return (mask_tracer(c, masks), *mask_velocities(vx, vy, vz, masks))
