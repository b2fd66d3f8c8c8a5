"""Configuration for the PyTorch/CUDA port of the Navier-Stokes solver.

Field-for-field copy of navierstokes3d_tpu/config.py (the JAX package's
config imports jax.numpy, so the port carries its own dataclasses; a test
asserts the two stay identical in field names and defaults). The only
difference is the dtype accessor: `NumericsConfig.torch_dtype` maps the
`dtype` string to a torch.dtype where the JAX package has `jnp_dtype`.

Reference: mattbuergler/NavierStokes3D, scripts/NavierStokes3D_gpu.jl:13-61
and scripts/NavierStokes3D_multi_gpu.jl:288-341.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class PhysicsConfig:
    """Physical constants. Reference: NavierStokes3D_multi_gpu.jl:288-319."""

    lx: float = 1.0          # streamwise domain size [m]
    rho: float = 1000.0      # density [kg/m^3]
    vin: float = 1.0         # inflow velocity [m/s]
    mu: float = 0.001        # dynamic viscosity [Pa s]
    re: float = 1e4          # Reynolds number (documentation only)
    fr: float = math.inf     # Froude number; g = vin^2/(Fr^2 lx)
    g_override: Optional[float] = None  # gpu script hardcodes g=9.81 (:38)
    ly_lx: float = 0.6       # lateral aspect ratio
    lz_lx: float = 0.6       # vertical aspect ratio
    a_lx: float = 0.05       # cylinder semi-axis (streamwise) / lx
    b_lx: float = 0.05       # cylinder semi-axis (lateral) / lx
    ox_lx: float = -0.4      # cylinder center x / lx (gpu script: -0.3)
    oy_lx: float = 0.0       # cylinder center y / lx
    beta: float = 0.0        # cylinder rotation about z [rad]

    @property
    def ly(self) -> float:
        return self.ly_lx * self.lx

    @property
    def lz(self) -> float:
        return self.lz_lx * self.lx

    @property
    def g(self) -> float:
        """Gravity: gpu script uses 9.81 (:38); multi derives from Fr (:316)."""
        if self.g_override is not None:
            return self.g_override
        if math.isinf(self.fr):
            return 0.0
        return (1.0 / self.fr**2) * self.vin**2 / self.lx

    @property
    def psc(self) -> float:
        """Pressure scale rho*vin^2 (NavierStokes3D_gpu.jl:21)."""
        return self.rho * self.vin**2

    @property
    def ox(self) -> float:
        return self.ox_lx * self.lx

    @property
    def oy(self) -> float:
        return self.oy_lx * self.lx

    @property
    def a2(self) -> float:
        return (self.a_lx * self.lx) ** 2

    @property
    def b2(self) -> float:
        return (self.b_lx * self.lx) ** 2


@dataclasses.dataclass(frozen=True)
class NumericsConfig:
    """Discretization / iteration constants (see the JAX package's
    NumericsConfig for the rationale of each field).

    Reference: NavierStokes3D_gpu.jl:43-61, NavierStokes3D_multi_gpu.jl:321-341.
    """

    nx: int = 255                   # global cells, streamwise
    eps_it: float = 1e-3            # Poisson convergence criterion
    niter_scale: int = 50           # niter = niter_scale * max(nx,ny,nz)
    cfl_tau: float = 1.0 / math.sqrt(3.1)   # pseudo-transient CFL
    cfl_visc: float = 1.0 / 4.1             # diffusion CFL
    cfl_adv: float = 1.0                    # advection CFL
    nt: int = 10
    dtype: str = "float64"          # reference runs Float64 throughout
    poisson_backend: str = "pt"     # 'pt' | 'fdm' (direct solve)
    fdm_refine: int = 8
    # Hydrostatic split p' = Pr - P_static(z); None = auto (on for the
    # gpu variant, compat=False, g != 0, 'pt' backend).
    pressure_split: Optional[bool] = None
    # Stored (hi, lo) pressure pair in float32; None = auto.
    extended_precision: Optional[bool] = None
    # Accuracy phase of the float32 solve ('defect' | 'extended' | 'none');
    # None = auto ('defect' under the split).
    accuracy: Optional[str] = None
    flat_state: bool = False        # TPU layout option; the port ignores it
    stall_exit: Optional[bool] = None
    stall_ratio: float = 0.96
    stall_checks: int = 5
    ny_override: Optional[int] = None
    nz_override: Optional[int] = None

    # Derived sizes follow ceil(nx * aspect) (NavierStokes3D_gpu.jl:45-46).
    def ny(self, phys: PhysicsConfig) -> int:
        if self.ny_override is not None:
            return self.ny_override
        return math.ceil(self.nx * phys.ly_lx)

    def nz(self, phys: PhysicsConfig) -> int:
        if self.nz_override is not None:
            return self.nz_override
        return math.ceil(self.nx * phys.lz_lx)

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"float32": torch.float32, "float64": torch.float64}[self.dtype]


@dataclasses.dataclass(frozen=True)
class IOConfig:
    """Output cadence (NavierStokes3D_gpu.jl:50-52)."""

    do_vis: bool = False
    do_save: bool = False
    do_print: bool = False
    nvis: int = 10
    nsave: int = 10
    out_dir: str = "out_save"
    viz_dir: str = "viz3D_out"


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Device mesh layout for spatial domain decomposition: the mesh shape
    (px, py, pz) and the halo width of the distributed Poisson solve
    (iterations per exchange; parallel/halo.py)."""

    mesh_shape: Tuple[int, int, int] = (1, 1, 1)
    halo: int = 1


@dataclasses.dataclass(frozen=True)
class SimConfig:
    physics: PhysicsConfig = dataclasses.field(default_factory=PhysicsConfig)
    numerics: NumericsConfig = dataclasses.field(default_factory=NumericsConfig)
    io: IOConfig = dataclasses.field(default_factory=IOConfig)
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)
    variant: str = "multi"   # 'multi' | 'gpu' — which reference script's BCs/init
    compat: bool = False     # replicate reference quirks (compat mode)
    # Hand-written CUDA kernels for the hot path: None = auto (on for CUDA
    # tensors), True/False = force. On CPU the plain PyTorch versions run.
    use_pallas: Optional[bool] = None

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)


def preset_multi(nx: int = 63, nt: int = 1, *, compat: bool = True,
                 dtype: str = "float64", **kw) -> SimConfig:
    """The multi-GPU script's configuration (NavierStokes3D_multi_gpu.jl:287-341)."""
    return SimConfig(
        physics=PhysicsConfig(ox_lx=-0.4, fr=math.inf),
        numerics=NumericsConfig(nx=nx, nt=nt, dtype=dtype),
        variant="multi",
        compat=compat,
        **kw,
    )


def preset_gpu(nx: int = 255, nt: int = 10000, *, compat: bool = True,
               dtype: str = "float64", **kw) -> SimConfig:
    """The single-GPU script's configuration (NavierStokes3D_gpu.jl:13-61):
    g=9.81 with hydrostatic pressure BCs (+100 Pa inlet head drives the
    flow, NavierStokes3D_gpu.jl:257-260); cylinder at ox=-0.3 lx."""
    return SimConfig(
        physics=PhysicsConfig(ox_lx=-0.3, g_override=9.81),
        numerics=NumericsConfig(nx=nx, nt=nt, dtype=dtype),
        variant="gpu",
        compat=compat,
        **kw,
    )
