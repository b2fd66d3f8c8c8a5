"""K5 and K6: semi-Lagrangian advection.

`advect` (K5) advects the four fields in ONE launch of the CUDA kernel of
csrc/advect.cu for CUDA tensors, and runs `advect_branch_plain` per
branch for CPU tensors; `advect_branch` launches the same kernel for one
branch. K5 replaces the Pallas kernel of navierstokes3d_tpu/kernels/
advect.py:537 (`build_advect_branch_flat`, assembled into the four
reference branches by `build_advect_flat` :556-630): face averages of the
advecting velocities, departure displacement clamped to ±k (k=2 on the
main path) with a clamp count, and the trilinear interpolant in the
select-shift (p, q, o) term order. `advect_pre` (K6) launches the
kernel's other form, which replaces the one of :218
(`build_advect_branch`, assembled by `build_advect` :245-310): it takes
each branch's advecting velocities precomputed, zero-padded to the
branch's staggered shape (`pre_velocities`), and advects every branch it
is given in one launch; `advect_branch_pre` is its one-branch call, and
`advect_unchained` is `build_advect`'s `advect_fn`, which the unchained
step runs. The plain versions are ops/advect.py.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

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


def _check_velocities(vx, vy, vz, dev) -> Tuple[int, int, int]:
    nx, ny, nz = vx.shape[0] - 1, vx.shape[1], vx.shape[2]
    _build.require("vx", vx, (nx + 1, ny, nz), torch.float32, dev)
    _build.require("vy", vy, (nx, ny + 1, nz), torch.float32, dev)
    _build.require("vz", vz, (nx, ny, nz + 1), torch.float32, dev)
    return nx, ny, nz


def _counter(n_clamped, dev) -> torch.Tensor:
    if n_clamped is None:
        n_clamped = torch.zeros((1,), dtype=torch.int32, device=dev)
    _build.require("n_clamped", n_clamped, (1,), torch.int32, dev)
    return n_clamped


def _launch(fields: dict, vels, n_clamped, k: StepConsts, window,
            grid_shape, pre: bool) -> dict:
    """One launch for the branches of `fields` (name -> field); `vels` are
    the post-BC velocities (vx, vy, vz) for K5, or name -> that branch's
    advecting velocities for K6. Returns name -> new field."""
    outs = {name: torch.empty_like(a) for name, a in fields.items()}
    mask = sum(1 << adv.BRANCHES.index(name) for name in fields)
    ptrs = [_build.ptr(fields.get(name)) for name in adv.BRANCHES]
    ptrs += [_build.ptr(outs.get(name)) for name in adv.BRANCHES]
    if pre:
        vel_ptrs = [_build.ptr(v) if name in vels else None
                    for name in adv.BRANCHES
                    for v in vels.get(name, (None,) * 3)]
    else:
        vel_ptrs = [v.data_ptr() for v in vels] + [None] * 9
    vel_array = (ctypes.c_void_p * 12)(*vel_ptrs)
    f32 = lambda x: ctypes.c_float(float(np.float32(x)))  # noqa: E731
    a = next(iter(fields.values()))
    lib = _build.load()
    rc = lib.ns3d_advect(mask, *ptrs, ctypes.cast(vel_array, ctypes.c_void_p),
                         n_clamped.data_ptr(), f32(k.dt), f32(k.dx),
                         f32(k.dy), f32(k.dz), window, *grid_shape, int(pre),
                         _build.stream_of(a))
    _build.check(rc, "advect_pre" if pre else "advect")
    return outs


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
    dev = a.device
    nx, ny, nz = _check_velocities(vx, vy, vz, dev)
    b = adv.BRANCHES.index(branch)
    shape = (nx + (b == 0), ny + (b == 1), nz + (b == 2))
    _build.require("a", a, shape, torch.float32, dev)
    out = _launch({branch: a}, (vx, vy, vz), _counter(n_clamped, dev), k,
                  window, (nx, ny, nz), False)[branch]
    advect_branch.launches += 1
    return out


advect_branch.launches = 0


# ---- K6: the branch from precomputed advecting velocities ----

# each branch's staggered axis, whose face velocities are zero-padded by
# one at both ends (None: the tracer's region is the whole field)
_PAD_AXIS = {"vx": 0, "vy": 1, "vz": 2, "c": None}


def pre_velocities(branch: str, vx, vy, vz):
    """The advecting velocities K6 takes for one branch: ops/advect.py's
    face averages on the branch's write region (the JAX package's
    `build_advect` expressions, 0.25 * (((a + b) + c) + d) and
    0.5 * (a + b)), zero-padded to the branch's staggered shape as
    jnp.pad does there."""
    vels = adv.face_velocities(branch, vx, vy, vz)
    axis = _PAD_AXIS[branch]
    if axis is None:
        return tuple(v.contiguous() for v in vels)
    pad = [0] * 6
    pad[2 * (2 - axis)] = pad[2 * (2 - axis) + 1] = 1
    return tuple(F.pad(v, pad) for v in vels)


def advect_branch_pre_plain(branch: str, a, vxc, vyc, vzc, k: StepConsts,
                            window: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K6 on one branch: ops/advect.py's
    select-shift backtrack (`backtrack_selectshift`) on the given
    velocities, cropped to the branch's write region (the pads are never
    read); (a', n_clamped)."""
    advect_branch_pre_plain.calls += 1
    starts = adv._STARTS[branch]
    axis = _PAD_AXIS[branch]
    crop = [slice(None)] * 3
    if axis is not None:
        crop[axis] = slice(1, -1)
    vels = tuple(v[tuple(crop)] for v in (vxc, vyc, vzc))
    vals, ncl = adv.backtrack_selectshift(a, *vels, starts, k.dt, k.dx, k.dy,
                                          k.dz, window)
    return adv._place(a, starts, vals), ncl


advect_branch_pre_plain.calls = 0


def advect_pre_plain(fields: dict, vels: dict, k: StepConsts, window: int
                     ) -> Tuple[dict, torch.Tensor]:
    """Plain PyTorch version of one K6 launch: `advect_branch_pre_plain`
    on each branch of `fields`; (name -> a', the summed clamp count, an
    int32 tensor of shape (1,))."""
    advect_pre_plain.calls += 1
    a = next(iter(fields.values()))
    n_clamped = torch.zeros((1,), dtype=torch.int32, device=a.device)
    outs = {}
    for name, f in fields.items():
        outs[name], ncl = advect_branch_pre_plain(name, f, *vels[name], k,
                                                  window)
        n_clamped += ncl
    return outs, n_clamped


advect_pre_plain.calls = 0


def advect_pre(fields: dict, vels: dict, k: StepConsts, window: int,
               n_clamped: torch.Tensor | None = None) -> dict:
    """Advect the fields of `fields` (branch 'vx', 'vy', 'vz' or 'c' ->
    field) with the advecting velocities `vels` (branch -> (vxc, vyc,
    vzc) at that field's shape, see `pre_velocities`; the values outside
    the branch's write region are not read), every branch in ONE launch;
    returns branch -> new field (the inputs are read only). The clamp
    count is added into n_clamped (an int32 tensor of shape (1,) on the
    device, zeroed by the caller) when given."""
    a = next(iter(fields.values()))
    if not _build.on_cuda(a, "advect_pre"):
        outs, ncl = advect_pre_plain(fields, vels, k, window)
        if n_clamped is not None:
            n_clamped += ncl
        return outs
    if set(vels) != set(fields) or not set(fields) <= set(adv.BRANCHES):
        raise ValueError(f"advect_pre: branches {sorted(fields)} with "
                         f"velocities for {sorted(vels)}")
    # the union grid, from any branch's field (its staggered axis one longer)
    name = next(iter(fields))
    b = adv.BRANCHES.index(name)
    grid_shape = tuple(n - (b == axis) for axis, n in enumerate(a.shape))
    dev = a.device
    for name, f in fields.items():
        b = adv.BRANCHES.index(name)
        shape = tuple(n + (b == axis) for axis, n in enumerate(grid_shape))
        _build.require(name, f, shape, torch.float32, dev)
        for v in vels[name]:
            _build.require(f"{name} velocity", v, shape, torch.float32, dev)
    outs = _launch(fields, vels, _counter(n_clamped, dev), k, window,
                   grid_shape, True)
    advect_pre.launches += 1
    return outs


advect_pre.launches = 0


def advect_branch_pre(branch: str, a, vxc, vyc, vzc, k: StepConsts,
                      window: int, n_clamped: torch.Tensor | None = None
                      ) -> torch.Tensor:
    """`advect_pre` on one branch: field `a` of branch 'vx', 'vy', 'vz' or
    'c' with the advecting velocities vxc, vyc, vzc given at a's shape;
    returns the new field."""
    return advect_pre({branch: a}, {branch: (vxc, vyc, vzc)}, k, window,
                      n_clamped)[branch]


def advect_unchained(vx, vy, vz, c, k: StepConsts, window: int = 2,
                     plain: bool = False):
    """The four reference branches as the JAX package's `build_advect`
    runs them (its `advect_fn`, kernels/advect.py:263-310): per branch the
    face-averaged velocities as torch ops, zero-padded to the branch's
    shape, then ONE K6 launch for the four. Returns (vx', vy', vz', c',
    n_clamped) with n_clamped an int32 tensor of shape (1,) on the fields'
    device. plain=True runs the plain version on every device."""
    fields = dict(zip(adv.BRANCHES, (vx, vy, vz, c)))
    vels = {name: pre_velocities(name, vx, vy, vz) for name in fields}
    if plain:
        outs, n_clamped = advect_pre_plain(fields, vels, k, window)
    else:
        n_clamped = torch.zeros((1,), dtype=torch.int32, device=vx.device)
        outs = advect_pre(fields, vels, k, window, n_clamped)
    return (*outs.values(), n_clamped)


def advect(vx, vy, vz, c, k: StepConsts, window: int = 2,
           plain: bool = False):
    """The four reference branches (gpu.jl:308-332, compat=False) from the
    post-BC snapshots, in one kernel launch (K5). Returns (vx', vy', vz',
    c', n_clamped) with n_clamped an int32 tensor of shape (1,) on the
    fields' device. plain=True runs the plain version on every device."""
    fields = dict(zip(adv.BRANCHES, (vx, vy, vz, c)))
    dev = vx.device
    n_clamped = torch.zeros((1,), dtype=torch.int32, device=dev)
    if plain or not _build.on_cuda(vx, "advect"):
        outs = []
        for name, a in fields.items():
            out, ncl = advect_branch_plain(name, a, vx, vy, vz, k, window)
            n_clamped += ncl
            outs.append(out)
        return (*outs, n_clamped)
    nx, ny, nz = _check_velocities(vx, vy, vz, dev)
    _build.require("c", c, (nx, ny, nz), torch.float32, dev)
    outs = _launch(fields, (vx, vy, vz), n_clamped, k, window, (nx, ny, nz),
                   False)
    advect.launches += 1
    return (*outs.values(), n_clamped)


advect.launches = 0
