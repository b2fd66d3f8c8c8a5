"""Semi-Lagrangian advection, select-shift method (torch port of the
`selectshift` backend of navierstokes3d_tpu/ops/advect.py).

Reference: advect!/backtrack!/lerp (NavierStokes3D_gpu.jl:288-334). Each
staggered component averages the other two velocity components onto its
own face, backtracks the departure point one dt, and trilinearly
interpolates the post-BC snapshot there. The select-shift form bounds the
departure displacement to ±k cells (clamped beyond, and counted), so the
interpolation is a select-weighted stencil of (2k+2)^3 shifted slices,
summed in the JAX backend's (p, q, o) term order with its weight
expressions. compat=False semantics (Vz advected properly); the gather
method and compat's never-advected Vz are not ported yet.

These are the plain versions the advection kernel (kernels/advect.py) is
held against.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .stencil import div

# the four reference branches (gpu.jl:308-332): advected field, 1-based
# region starts per axis, and the staggered-axis the region trims
BRANCHES = ("vx", "vy", "vz", "c")
_STARTS = {"vx": (2, 1, 1), "vy": (1, 2, 1), "vz": (1, 1, 2),
           "c": (1, 1, 1)}


def face_velocities(branch: str, vx, vy, vz):
    """The advecting velocities of one branch on its write region, with
    ops/advect.py's face-average expressions ((a+b)+c)+d."""
    if branch == "vx":
        return (vx[1:-1, :, :],
                0.25 * (vy[:-1, :-1, :] + vy[:-1, 1:, :]
                        + vy[1:, :-1, :] + vy[1:, 1:, :]),
                0.25 * (vz[:-1, :, :-1] + vz[:-1, :, 1:]
                        + vz[1:, :, :-1] + vz[1:, :, 1:]))
    if branch == "vy":
        return (0.25 * (vx[:-1, :-1, :] + vx[1:, :-1, :]
                        + vx[:-1, 1:, :] + vx[1:, 1:, :]),
                vy[:, 1:-1, :],
                0.25 * (vz[:, :-1, :-1] + vz[:, :-1, 1:]
                        + vz[:, 1:, :-1] + vz[:, 1:, 1:]))
    if branch == "vz":
        return (0.25 * (vx[:-1, :, :-1] + vx[1:, :, :-1]
                        + vx[:-1, :, 1:] + vx[1:, :, 1:]),
                0.25 * (vy[:, :-1, :-1] + vy[:, 1:, :-1]
                        + vy[:, :-1, 1:] + vy[:, 1:, 1:]),
                vz[:, :, 1:-1])
    if branch == "c":
        return (0.5 * (vx[:-1, :, :] + vx[1:, :, :]),
                0.5 * (vy[:, :-1, :] + vy[:, 1:, :]),
                0.5 * (vz[:, :, :-1] + vz[:, :, 1:]))
    raise ValueError(f"unknown advection branch {branch!r}")


def backtrack_selectshift(a_o, vxc, vyc, vzc, starts, dt, dx, dy, dz, k):
    """Gather-free backtrack!: the trilinear corners lie within a bounded
    (2k+2)^3 neighborhood, so the interpolation is a select-weighted
    stencil of static shifted slices. `starts` are the 1-based region
    starts per axis. Returns (values, n_clamped) with n_clamped the number
    of region points whose displacement exceeded k on any axis."""
    n1, n2, n3 = a_o.shape
    dtype, dev = a_o.dtype, a_o.device
    rs = torch.broadcast_shapes(vxc.shape, vyc.shape, vzc.shape)

    def axis_terms(v, d, axis, start, extent, n):
        shape = [1, 1, 1]
        shape[axis] = extent
        idx = torch.arange(start, start + extent, dtype=dtype,
                           device=dev).reshape(shape)   # 1-based
        dl_raw = div(dt * v, d)
        dl = torch.clamp(dl_raw, -k, k)
        i1 = torch.clamp(torch.floor(idx - dl), 1, n)
        t = (dl > 0).to(dtype) - torch.fmod(dl, 1.0)
        o1 = (i1 - idx).to(torch.int32)              # in [-k-1, k]
        o2 = (torch.clamp(i1 + 1, max=n) - idx).to(torch.int32)
        return o1, o2, t, torch.abs(dl_raw) > k

    sx, sy, sz = starts
    ox1, ox2, tx, cx = axis_terms(vxc, dx, 0, sx, rs[0], n1)
    oy1, oy2, ty, cy = axis_terms(vyc, dy, 1, sy, rs[1], n2)
    oz1, oz2, tz, cz = axis_terms(vzc, dz, 2, sz, rs[2], n3)
    n_clamped = torch.sum((cx | cy | cz).expand(rs).to(torch.int32))
    P = k + 1
    ap = F.pad(a_o, (P, P, P, P, P, P))
    one = torch.ones((), dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    acc = torch.zeros(rs, dtype=dtype, device=dev)
    bx, by, bz = P + sx - 1, P + sy - 1, P + sz - 1

    def weight(o1, o2, t, o):
        return torch.where(o1 == o, one - t, zero) + torch.where(o2 == o, t,
                                                                  zero)

    offs = range(-P, k + 1)
    wxs = [weight(ox1, ox2, tx, o) for o in offs]
    # term order (p, q, o) — y, then z, then x innermost — with each term
    # (wx * (wy*wz)) * sample, as the JAX backend and its kernels sum
    for p in offs:
        wy = weight(oy1, oy2, ty, p)
        for q in offs:
            wyz = wy * weight(oz1, oz2, tz, q)
            for io, o in enumerate(offs):
                sl = ap[bx + o:bx + o + rs[0],
                        by + p:by + p + rs[1],
                        bz + q:bz + q + rs[2]]
                acc = acc + (wxs[io] * wyz) * sl
    return acc, n_clamped


def advect_branch(branch: str, a, vx, vy, vz, dt, dx, dy, dz, k):
    """One branch: returns (a', n_clamped) with a' the advected field on
    the branch's write region and the input elsewhere."""
    vals, ncl = backtrack_selectshift(
        a, *face_velocities(branch, vx, vy, vz), _STARTS[branch],
        dt, dx, dy, dz, k)
    out = a.clone()
    sx, sy, sz = _STARTS[branch]
    out[sx - 1:sx - 1 + vals.shape[0], sy - 1:sy - 1 + vals.shape[1],
        sz - 1:sz - 1 + vals.shape[2]] = vals
    return out, ncl


def advect(vx, vy, vz, c, dt, dx, dy, dz, *, k: int = 2):
    """Advect Vx, Vy, Vz and the tracer C from the post-BC snapshots
    (gpu.jl:308-332, compat=False). Returns (vx', vy', vz', c', n_clamped)."""
    outs, total = [], 0
    for branch, a in zip(BRANCHES, (vx, vy, vz, c)):
        o, n = advect_branch(branch, a, vx, vy, vz, dt, dx, dy, dz, k)
        outs.append(o)
        total = total + n
    return (*outs, total)
