"""Fast-diagonalization direct Poisson solver (torch port of
navierstokes3d_tpu/ops/fdm_poisson.py; the optional 'fdm' backend).

The folded pressure-Poisson operator is separable,
A = Ax (x) I (x) I + I (x) Ay (x) I + I (x) I (x) Az, each Ak a symmetric
tridiagonal second difference with the folded boundary conditions
(zero-gradient ends drop the boundary coupling, Dirichlet ends keep it).
So A is diagonalized by the tensor product of the 1D eigenbases:

    p = Qx (x) Qy (x) Qz  [ (Qx' (x) Qy' (x) Qz' f) / (lx + ly + lz) ]

The eigendecompositions are numpy float64 on the host, once. The six
modal transforms are dense products that the JAX package leaves to XLA
(einsums outside any Pallas kernel); here they are `torch.matmul` calls on
the field's own layout (x slowest, z fastest), with no reshuffling copy:
x as an (mx, mx) matrix times the field viewed as (mx, my*mz), y as a
product batched over x, z as the field viewed as (mx*my, mz) times an
(mz, mz) matrix. Q and Q' are device tensors built once.

Precision: the JAX package forces Precision.HIGHEST, since a
reduced-precision product costs ~1.5 orders of magnitude of residual. On
the card TF32 is a process-wide switch any caller may turn on, so every
solve runs under `ieee_float32_matmul`, which sets the matmul precision to
'highest' for its duration and restores the caller's setting after.
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import numpy as np
import torch


def _axis_operator(m: int, d: float, lo_zero_grad: bool,
                   hi_zero_grad: bool) -> np.ndarray:
    """1D interior operator (m = n-2 cells) with folded BCs: a
    zero-gradient end drops the boundary coupling (diag -1 instead of -2);
    a Dirichlet end keeps -2 (the frozen boundary value contributes to the
    RHS; for the homogeneous outlet it contributes 0)."""
    a = np.zeros((m, m))
    for i in range(m):
        diag = -2.0
        if i == 0 and lo_zero_grad:
            diag = -1.0
        if i == m - 1 and hi_zero_grad:
            diag = -1.0
        a[i, i] = diag
        if i > 0:
            a[i, i - 1] = 1.0
        if i < m - 1:
            a[i, i + 1] = 1.0
    return a / (d * d)


def _axis_eigs(grid, variant: str):
    nx, ny, nz = grid.nx, grid.ny, grid.nz
    if variant == "multi":
        ax = _axis_operator(nx - 2, grid.dx, True, False)
    else:
        ax = _axis_operator(nx - 2, grid.dx, False, False)
    ay = _axis_operator(ny - 2, grid.dy, True, True)
    az = _axis_operator(nz - 2, grid.dz, True, True)
    return (np.linalg.eigh(ax), np.linalg.eigh(ay), np.linalg.eigh(az))


def solve_host_f64(grid, variant: str, rhs: np.ndarray) -> np.ndarray:
    """One-off exact host solve in float64 (for static boundary-driven
    parts that must not pollute float32 device solves); the contractions
    go through BLAS (optimize=True)."""
    (lx, qx), (ly, qy), (lz, qz) = _axis_eigs(grid, variant)
    t = np.einsum("ia,ajk->ijk", qx.T, rhs, optimize=True)
    t = np.einsum("jb,ibk->ijk", qy.T, t, optimize=True)
    t = np.einsum("kc,ijc->ijk", qz.T, t, optimize=True)
    t /= (lx[:, None, None] + ly[None, :, None] + lz[None, None, :])
    p = np.einsum("ai,ijk->ajk", qx, t, optimize=True)
    p = np.einsum("jb,ibk->ijk", qy, p, optimize=True)
    return np.einsum("kc,ijc->ijk", qz, p, optimize=True)


@contextlib.contextmanager
def ieee_float32_matmul():
    """float32 matmuls in IEEE float32 (no TF32) inside the block, whatever
    the caller set with torch.set_float32_matmul_precision or
    torch.backends.cuda.matmul.allow_tf32 (both read and write the same
    setting); the caller's setting is restored on exit."""
    prev = torch.get_float32_matmul_precision()
    if prev != "highest":
        torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        if prev != "highest":
            torch.set_float32_matmul_precision(prev)


class FdmSolver:
    """solve(rhs_interior, refine=1) -> p_interior, both (nx-2, ny-2,
    nz-2) tensors on the solver's device in its dtype.

    variant 'multi': x zero-gradient at the inlet, Dirichlet-0 at the
    outlet (multi_gpu.jl:175-184); 'gpu': Dirichlet at both x faces (the
    hydrostatic plane values enter through the RHS). y and z are
    zero-gradient in both. The x axis always has a Dirichlet end, so the
    operator has no zero mode."""

    def __init__(self, grid, variant: str, dtype: torch.dtype,
                 device: torch.device | str = "cuda"):
        self.grid, self.variant = grid, variant
        (lx, qx), (ly, qy), (lz, qz) = _axis_eigs(grid, variant)
        np_dtype = {torch.float32: np.float32,
                    torch.float64: np.float64}[dtype]
        # the 1-D eigenvalue vectors in the solver's dtype, as the JAX
        # package's solve.eig_consts
        self.eig_consts = tuple(np.asarray(v, np_dtype) for v in (lx, ly, lz))

        def dev(a):
            return torch.tensor(np.ascontiguousarray(a, np_dtype),
                                device=device)
        self._qx, self._qy, self._qz = dev(qx), dev(qy), dev(qz)
        self._qxT, self._qyT, self._qzT = dev(qx.T), dev(qy.T), dev(qz.T)
        lx_d, ly_d, lz_d = (dev(v) for v in self.eig_consts)
        # the 3-D eigenvalue sum, built once on the device in the JAX
        # expression's order: (lx + ly) + lz
        self._lam = (lx_d[:, None, None] + ly_d[None, :, None]
                     + lz_d[None, None, :])
        self._cx = 1.0 / (grid.dx * grid.dx)
        self._cy = 1.0 / (grid.dy * grid.dy)
        self._cz = 1.0 / (grid.dz * grid.dz)

    @property
    def shape(self) -> Tuple[int, int, int]:
        return tuple(self._lam.shape)

    def _x(self, q, f):
        mx, my, mz = f.shape
        return torch.matmul(q, f.reshape(mx, my * mz)).view(mx, my, mz)

    def _z(self, f, q):
        mx, my, mz = f.shape
        return torch.matmul(f.reshape(mx * my, mz), q).view(mx, my, mz)

    def to_modal(self, f):
        """Q' f: contraction with Qx', then Qy' (batched over x), then Qz'
        (the field times Qz on its fastest axis)."""
        t = self._x(self._qxT, f)
        t = torch.matmul(self._qyT, t)
        return self._z(t, self._qz)

    def from_modal(self, t):
        p = self._x(self._qx, t)
        p = torch.matmul(self._qy, p)
        return self._z(p, self._qzT)

    def modal_scale(self, t):
        return t / self._lam

    def apply_a(self, p):
        """A p through the folded stencil (for iterative refinement): the
        zero pad models homogeneous Dirichlet ends, zero-gradient ends drop
        the boundary-coupling term."""
        pad = torch.nn.functional.pad(p, (1, 1, 1, 1, 1, 1))
        xl = pad[:-2, 1:-1, 1:-1] - p
        xr = pad[2:, 1:-1, 1:-1] - p
        yl = pad[1:-1, :-2, 1:-1] - p
        yr = pad[1:-1, 2:, 1:-1] - p
        zl = pad[1:-1, 1:-1, :-2] - p
        zr = pad[1:-1, 1:-1, 2:] - p
        if self.variant == "multi":
            xl[0] = 0.0                  # inlet zero-gradient
        yl[:, 0] = 0.0
        yr[:, -1] = 0.0
        zl[:, :, 0] = 0.0
        zr[:, :, -1] = 0.0
        return (self._cx * (xl + xr) + self._cy * (yl + yr)
                + self._cz * (zl + zr))

    def __call__(self, rhs, refine: int = 1):
        with ieee_float32_matmul():
            p = self.from_modal(self.modal_scale(self.to_modal(rhs)))
            for _ in range(refine):
                r = rhs - self.apply_a(p)
                p = p + self.from_modal(self.modal_scale(self.to_modal(r)))
        return p


def build_fdm_solver(grid, variant: str, dtype: torch.dtype,
                     device: torch.device | str = "cuda") -> FdmSolver:
    """The direct solver of the folded operator on `device` (the card
    unless the caller asks for the CPU): solve(rhs, refine=1) with
    .apply_a and .eig_consts, as the JAX package's build_fdm_solver."""
    return FdmSolver(grid, variant, dtype, device)
