"""Staggered MAC grid geometry and derived numerics (numpy only).

Copy of navierstokes3d_tpu/grid.py:
  - cell-centered fields Pr, C, divV, tau-normals: (nx, ny, nz)
  - face-centered velocities: Vx (nx+1, ny, nz), Vy (nx, ny+1, nz),
    Vz (nx, ny, nz+1)
  - edge-centered shear stresses: (nx-1, ny-1, nz-1)
(NavierStokes3D_gpu.jl:57-82; NavierStokes3D_multi_gpu.jl:337-360)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from .config import SimConfig


@dataclasses.dataclass(frozen=True)
class Grid:
    nx: int
    ny: int
    nz: int
    lx: float
    ly: float
    lz: float
    dx: float
    dy: float
    dz: float
    # derived time-stepping numerics
    dt: float
    dtau: float
    damp: float
    niter: int
    nchk: int

    @property
    def shape_c(self) -> Tuple[int, int, int]:
        """Cell-centered field shape."""
        return (self.nx, self.ny, self.nz)

    @property
    def shape_vx(self) -> Tuple[int, int, int]:
        return (self.nx + 1, self.ny, self.nz)

    @property
    def shape_vy(self) -> Tuple[int, int, int]:
        return (self.nx, self.ny + 1, self.nz)

    @property
    def shape_vz(self) -> Tuple[int, int, int]:
        return (self.nx, self.ny, self.nz + 1)

    @property
    def shape_edge(self) -> Tuple[int, int, int]:
        """Shear-stress (edge) shape (NavierStokes3D_gpu.jl:72-74)."""
        return (self.nx - 1, self.ny - 1, self.nz - 1)

    # ---- coordinates (numpy, host-side; used for init and masks) ----

    def xc(self) -> np.ndarray:
        return np.linspace(-(self.lx - self.dx) / 2, (self.lx - self.dx) / 2, self.nx)

    def yc(self) -> np.ndarray:
        return np.linspace(-(self.ly - self.dy) / 2, (self.ly - self.dy) / 2, self.ny)

    def zc(self) -> np.ndarray:
        return np.linspace(-(self.lz - self.dz) / 2, (self.lz - self.dz) / 2, self.nz)

    def xv(self) -> np.ndarray:
        return np.linspace(-self.lx / 2, self.lx / 2, self.nx + 1)

    def yv(self) -> np.ndarray:
        return np.linspace(-self.ly / 2, self.ly / 2, self.ny + 1)

    def zv(self) -> np.ndarray:
        return np.linspace(-self.lz / 2, self.lz / 2, self.nz + 1)

    def field_shapes(self) -> Dict[str, Tuple[int, int, int]]:
        return {
            "pr": self.shape_c,
            "c": self.shape_c,
            "vx": self.shape_vx,
            "vy": self.shape_vy,
            "vz": self.shape_vz,
            "dprdtau": self.shape_c,  # stored full-shape; boundary ring inactive
        }


def make_grid(cfg: SimConfig) -> Grid:
    """Derive grid geometry and time-stepping constants from config
    (NavierStokes3D_gpu.jl:47-61 / NavierStokes3D_multi_gpu.jl:327-341;
    `damp = 2/nx` uses the global nx)."""
    phys, num = cfg.physics, cfg.numerics
    nx = num.nx
    ny = num.ny(phys)
    nz = num.nz(phys)
    dx, dy, dz = phys.lx / nx, phys.ly / ny, phys.lz / nz
    h = max(dx, dy, dz)
    dt = min(num.cfl_visc * h * h * phys.rho / phys.mu,
             num.cfl_adv * h / phys.vin)
    damp = 2.0 / nx
    dtau = num.cfl_tau * h
    if cfg.variant == "gpu":
        # gpu script: niter = 50*max(ny,nz), nchk = ny-1 (:48-49)
        niter = num.niter_scale * max(ny, nz)
        nchk = ny - 1
    else:
        # multi script: niter = 50*max(nx_g,ny_g,nz_g), nchk = ny_g-1 (:328-329)
        niter = num.niter_scale * max(nx, ny, nz)
        nchk = ny - 1
    return Grid(nx=nx, ny=ny, nz=nz,
                lx=phys.lx, ly=phys.ly, lz=phys.lz,
                dx=dx, dy=dy, dz=dz,
                dt=dt, dtau=dtau, damp=damp, niter=niter, nchk=nchk)
