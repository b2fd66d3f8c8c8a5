"""K5: semi-Lagrangian advection, one launch per advected field.

`advect_branch` launches the CUDA kernel of csrc/advect.cu for CUDA
tensors and runs `advect_branch_plain` for CPU tensors. It replaces the
Pallas kernel of navierstokes3d_tpu/kernels/advect.py:537
(`build_advect_branch_flat`, assembled into the four reference branches
by `build_advect_flat` :556-630): face averages of the advecting
velocities, departure displacement clamped to ±k (k=2 on the main path)
with a clamp count, and the trilinear interpolant in the select-shift
(p, q, o) term order. The plain version is ops/advect.py.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from ..ops import advect as adv
from . import _build
from .fused_step import StepConsts


def advect_branch_plain(branch: str, a, vx, vy, vz, k: StepConsts,
                        window: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of one K5 launch: (a', n_clamped)."""
    advect_branch_plain.calls += 1
    return adv.advect_branch(branch, a, vx, vy, vz, k.dt, k.dx, k.dy, k.dz,
                             window)


advect_branch_plain.calls = 0


def advect_branch(branch: str, a, vx, vy, vz, k: StepConsts, window: int,
                  n_clamped: torch.Tensor | None = None) -> torch.Tensor:
    """Advect field `a` (branch 'vx', 'vy', 'vz' or 'c') with the post-BC
    velocities; returns the new field (the inputs are read only). The
    clamp count is added into n_clamped (an int32 tensor of shape (1,) on
    the device, zeroed by the caller) when given."""
    if not _build.on_cuda(a, "advect"):
        out, ncl = advect_branch_plain(branch, a, vx, vy, vz, k, window)
        if n_clamped is not None:
            n_clamped += ncl
        return out
    nx, ny, nz = vx.shape[0] - 1, vx.shape[1], vx.shape[2]
    dev = a.device
    b = adv.BRANCHES.index(branch)
    shape = (nx + (b == 0), ny + (b == 1), nz + (b == 2))
    _build.require("a", a, shape, torch.float32, dev)
    _build.require("vx", vx, (nx + 1, ny, nz), torch.float32, dev)
    _build.require("vy", vy, (nx, ny + 1, nz), torch.float32, dev)
    _build.require("vz", vz, (nx, ny, nz + 1), torch.float32, dev)
    if n_clamped is None:
        n_clamped = torch.zeros((1,), dtype=torch.int32, device=dev)
    _build.require("n_clamped", n_clamped, (1,), torch.int32, dev)
    out = torch.empty_like(a)
    f32 = lambda x: ctypes.c_float(float(np.float32(x)))  # noqa: E731
    lib = _build.load()
    rc = lib.ns3d_advect(b, a.data_ptr(), vx.data_ptr(), vy.data_ptr(),
                         vz.data_ptr(), out.data_ptr(), n_clamped.data_ptr(),
                         f32(k.dt), f32(k.dx), f32(k.dy), f32(k.dz), window,
                         nx, ny, nz, _build.stream_of(a))
    _build.check(rc, "advect")
    advect_branch.launches += 1
    return out


advect_branch.launches = 0


def advect(vx, vy, vz, c, k: StepConsts, window: int = 2,
           plain: bool = False):
    """The four reference branches (gpu.jl:308-332, compat=False) from the
    post-BC snapshots. Returns (vx', vy', vz', c', n_clamped) with
    n_clamped an int32 tensor of shape (1,) on the fields' device.
    plain=True runs the plain version on every device."""
    n_clamped = torch.zeros((1,), dtype=torch.int32, device=vx.device)
    outs = []
    for name, a in zip(adv.BRANCHES, (vx, vy, vz, c)):
        if plain:
            out, ncl = advect_branch_plain(name, a, vx, vy, vz, k, window)
            n_clamped += ncl
        else:
            out = advect_branch(name, a, vx, vy, vz, k, window, n_clamped)
        outs.append(out)
    return (*outs, n_clamped)
