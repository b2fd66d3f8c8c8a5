"""Finite-difference stencil micro-ops as pure slicing (torch port of
navierstokes3d_tpu/ops/stencil.py).

These replicate ParallelStencil.FiniteDifferences3D macros used by the
reference kernels (scripts/NavierStokes3D_gpu.jl:175-219):

  @inn(A)[i,j,k]   -> A[i+1,j+1,k+1]
  @d_xa(A)[i,j,k]  -> A[i+1,j,k] - A[i,j,k]
  @d2_xi(A)[i,j,k] -> A[i+2,j+1,k+1] - 2 A[i+1,j+1,k+1] + A[i,j+1,k+1]
  (and the y/z analogues)

Division by a Python scalar goes through `div`, which divides by a 0-dim
tensor on the operand's device: on a CUDA tensor PyTorch evaluates
`tensor / python_scalar` as a multiply by the rounded reciprocal, which
rounds differently from the JAX expressions these functions mirror.
"""

from __future__ import annotations

import torch


def div(a: torch.Tensor, s: float) -> torch.Tensor:
    """a / s with s rounded to a's dtype and a true division on every
    device (see the module docstring)."""
    return a / torch.full((), s, dtype=a.dtype, device=a.device)


def d_xa(a):
    """Forward difference along x over the full array: out (nx-1, ny, nz)."""
    return a[1:, :, :] - a[:-1, :, :]


def d_ya(a):
    return a[:, 1:, :] - a[:, :-1, :]


def d_za(a):
    return a[:, :, 1:] - a[:, :, :-1]


def d2_xi(a):
    """Second difference along x on inner y/z planes: out (nx-2, ny-2, nz-2)."""
    return a[2:, 1:-1, 1:-1] - 2.0 * a[1:-1, 1:-1, 1:-1] + a[:-2, 1:-1, 1:-1]


def d2_yi(a):
    return a[1:-1, 2:, 1:-1] - 2.0 * a[1:-1, 1:-1, 1:-1] + a[1:-1, :-2, 1:-1]


def d2_zi(a):
    return a[1:-1, 1:-1, 2:] - 2.0 * a[1:-1, 1:-1, 1:-1] + a[1:-1, 1:-1, :-2]


def inn(a):
    """Interior view A[1:-1,1:-1,1:-1]."""
    return a[1:-1, 1:-1, 1:-1]


def laplacian_inner(a, dx, dy, dz):
    """d2_xi/dx/dx + d2_yi/dy/dy + d2_zi/dz/dz: out (nx-2, ny-2, nz-2).
    Two successive divisions (not /(dx*dx)), as the reference rounds
    (NavierStokes3D_gpu.jl:200,210)."""
    return (div(div(d2_xi(a), dx), dx)
            + div(div(d2_yi(a), dy), dy)
            + div(div(d2_zi(a), dz), dz))


def divergence(vx, vy, vz, dx, dy, dz):
    """Staggered divergence at cell centers: the @∇V macro
    (NavierStokes3D_gpu.jl:175). out (nx, ny, nz)."""
    return div(d_xa(vx), dx) + div(d_ya(vy), dy) + div(d_za(vz), dz)
