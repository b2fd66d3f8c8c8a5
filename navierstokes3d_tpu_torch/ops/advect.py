"""Semi-Lagrangian advection (torch port of navierstokes3d_tpu/ops/
advect.py).

Reference: advect!/backtrack!/lerp (NavierStokes3D_gpu.jl:288-334). Each
staggered component averages the other two velocity components onto its
own face, backtracks the departure point one dt, and trilinearly
interpolates the post-BC snapshot there. Two methods:

  gather:      the reference's literal semantics (departure indices clamp
               to the array bounds, any displacement): 8 gathers per
               field, torch ops as XLA computes them in the JAX package;
  selectshift: the displacement bounded to ±k cells (clamped beyond, and
               counted), so the interpolation is a select-weighted stencil
               of (2k+2)^3 shifted slices, summed in the JAX backend's
               (p, q, o) term order with its weight expressions. Its
               branches are the plain versions K5 (kernels/advect.py) is
               held against.

compat=True keeps the reference bug where the third branch advects Vy a
second time with Vz-face velocities and Vy's bounds, so Vz is never
advected (gpu.jl:321-326), and the source's departure cell, floor of the
rounded i - dl (`departure_cell`); compat=False advects Vz properly and
takes the departure cell as i - ceil(dl).

Sharded composition (parallel/fullstep.py): the inputs may be halo-padded
local blocks of the global fields. `origin` (the global 0-based cell index
of the local element [0,0,0]) and `gshape` (the global cell-centred shape)
clamp departure points at the GLOBAL bounds, as the reference's per-rank
clamp into its halos does; `set_fn` masks each branch's write to its global
region and `count_box` restricts the clamp count to the owned cells. The
defaults are the single-device semantics (local == global).
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


def _lerp(a, b, t):
    """lerp(a,b,t) = b t + a (1-t) (NavierStokes3D_gpu.jl:306)."""
    return b * t + a * (1.0 - t)


def _ranges(dtype, device, *specs):
    """1-based index axes, shaped for broadcasting: specs are (start,
    stop)."""
    out = []
    for axis, (start, stop) in enumerate(specs):
        shape = [1, 1, 1]
        shape[axis] = stop - start + 1
        out.append(torch.arange(start, stop + 1, dtype=dtype,
                                device=device).reshape(shape))
    return out


def departure_cell(i, dl, compat: bool = False):
    """The unclamped departure cell of a point at the 1-based index i
    displaced by dl cells. The source takes floor(i - dl) of the rounded
    difference (gpu.jl:290-293), while its fraction t = (dl > 0) -
    fmod(dl, 1) is taken from dl: where i - dl rounds onto a whole number
    (0 < dl below half an ulp of i, or dl that close to a whole number),
    the corner moves and t does not, so the point reads the cell next to
    its own. i - ceil(dl) is floor(i - dl) in exact arithmetic, computed
    exactly, and agrees with t at every point; compat keeps the source's
    expression, as compat keeps the reference's other quirks."""
    if compat:
        return torch.floor(i - dl)
    return i - torch.ceil(dl)


def _backtrack(a_o, vxc, vyc, vzc, ix, iy, iz, dt, dx, dy, dz,
               origin=(0, 0, 0), gshape=None, compat=False):
    """Vectorized backtrack! (NavierStokes3D_gpu.jl:288-304): ix/iy/iz are
    the 1-based LOCAL indices of the write region (broadcastable);
    departure indices clamp to the global bounds gshape (default a_o's
    shape), with a_o's element [0,0,0] at the global 0-based index
    `origin`; the departure cell is `departure_cell`'s. Returns the
    interpolated values over the write region."""
    gsh = a_o.shape if gshape is None else gshape
    dlx = div(dt * vxc, dx)
    dly = div(dt * vyc, dy)
    dlz = div(dt * vzc, dz)

    def corners(i, dl, n, o, n_local):
        # the second clamp keeps a NaN displacement's index in bounds (its
        # interpolant is NaN through t all the same); the local clamp reads
        # a displacement beyond a sharded block's halo at the halo's edge,
        # as the JAX package's clamped gather does
        i1 = torch.clamp(departure_cell(i + o, dl, compat), 1,
                         n).long().clamp(1, n)
        i2 = torch.clamp(i1 + 1, max=n)
        return ((i1 - o).clamp(1, n_local), (i2 - o).clamp(1, n_local))

    (ix1, ix2), (iy1, iy2), (iz1, iz2) = (
        corners(i, dl, n, o, nl) for i, dl, n, o, nl in zip(
            (ix, iy, iz), (dlx, dly, dlz), gsh, origin, a_o.shape))
    # Julia: δ = (δ>0) - (δ%1); % is the truncated remainder, fmod
    tx = (dlx > 0).to(a_o.dtype) - torch.fmod(dlx, 1.0)
    ty = (dly > 0).to(a_o.dtype) - torch.fmod(dly, 1.0)
    tz = (dlz > 0).to(a_o.dtype) - torch.fmod(dlz, 1.0)
    ix1, iy1, iz1, ix2, iy2, iz2 = torch.broadcast_tensors(
        ix1, iy1, iz1, ix2, iy2, iz2)

    def at(i, j, k):  # 1-based -> 0-based gather
        return a_o[i - 1, j - 1, k - 1]

    fy1z1 = _lerp(at(ix1, iy1, iz1), at(ix2, iy1, iz1), tx)
    fy1z2 = _lerp(at(ix1, iy1, iz2), at(ix2, iy1, iz2), tx)
    fy2z1 = _lerp(at(ix1, iy2, iz1), at(ix2, iy2, iz1), tx)
    fy2z2 = _lerp(at(ix1, iy2, iz2), at(ix2, iy2, iz2), tx)
    fz1 = _lerp(fy1z1, fy2z1, ty)
    fz2 = _lerp(fy1z2, fy2z2, ty)
    return _lerp(fz1, fz2, tz)


def backtrack_gather(a_o, vxc, vyc, vzc, starts, dt, dx, dy, dz,
                     origin=(0, 0, 0), gshape=None, compat=False):
    """_backtrack over the region that starts at the 1-based local
    `starts` and spans the advecting velocities' broadcast shape."""
    rs = torch.broadcast_shapes(vxc.shape, vyc.shape, vzc.shape)
    ix, iy, iz = _ranges(a_o.dtype, a_o.device,
                         *((s, s + n - 1) for s, n in zip(starts, rs)))
    return _backtrack(a_o, vxc, vyc, vzc, ix, iy, iz, dt, dx, dy, dz,
                      origin, gshape, compat)


def backtrack_selectshift(a_o, vxc, vyc, vzc, starts, dt, dx, dy, dz, k,
                          origin=(0, 0, 0), gshape=None, count_box=None,
                          compat=False):
    """Gather-free backtrack!: the trilinear corners lie within a bounded
    (2k+2)^3 neighborhood, so the interpolation is a select-weighted
    stencil of static shifted slices. `starts` are the 1-based local
    region starts per axis; origin/gshape as in _backtrack (a sharded
    caller's block then needs >= k+1 cells of valid halo around every
    output it keeps: samples outside the global bounds get zero weight).
    Returns (values, n_clamped) with n_clamped the number of region points
    whose displacement exceeded k on any axis, counted only inside
    count_box where given (per-axis half-open 0-based local bounds: a
    sharded caller's owned block, so halo points are not counted twice).
    The departure cell is `departure_cell`'s."""
    n1, n2, n3 = a_o.shape if gshape is None else gshape
    dtype, dev = a_o.dtype, a_o.device
    rs = torch.broadcast_shapes(vxc.shape, vyc.shape, vzc.shape)

    def axis_terms(v, d, axis, start, extent, n):
        shape = [1, 1, 1]
        shape[axis] = extent
        start = start + origin[axis]                    # global 1-based
        idx = torch.arange(start, start + extent, dtype=dtype,
                           device=dev).reshape(shape)
        dl_raw = div(dt * v, d)
        dl = torch.clamp(dl_raw, -k, k)
        i1 = torch.clamp(departure_cell(idx, dl, compat), 1, n)
        t = (dl > 0).to(dtype) - torch.fmod(dl, 1.0)
        o1 = (i1 - idx).to(torch.int32)              # in [-k-1, k]
        o2 = (torch.clamp(i1 + 1, max=n) - idx).to(torch.int32)
        return o1, o2, t, torch.abs(dl_raw) > k

    sx, sy, sz = starts
    ox1, ox2, tx, cx = axis_terms(vxc, dx, 0, sx, rs[0], n1)
    oy1, oy2, ty, cy = axis_terms(vyc, dy, 1, sy, rs[1], n2)
    oz1, oz2, tz, cz = axis_terms(vzc, dz, 2, sz, rs[2], n3)
    clamped = cx | cy | cz
    for axis, (lo, hi) in enumerate(count_box or ()):
        local0 = torch.arange(rs[axis], device=dev) + (starts[axis] - 1)
        shape = [1, 1, 1]
        shape[axis] = rs[axis]
        clamped = clamped & ((local0 >= lo) & (local0 < hi)).reshape(shape)
    n_clamped = torch.sum(clamped.expand(rs).to(torch.int32))
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
    return _place(a, _STARTS[branch], vals), ncl


def _region(starts, vals):
    """The slices of the region that starts at the 1-based `starts` and
    spans vals."""
    return tuple(slice(s - 1, s - 1 + n) for s, n in zip(starts, vals.shape))


def _place(a, starts, vals):
    return set_region(a, _region(starts, vals), vals, None)


def set_region(target, region, vals, gbounds):
    """The default write of advect's set_fn: a copy of target with vals
    in region (gbounds unused)."""
    out = target.clone()
    out[region] = vals
    return out


def advect(vx, vy, vz, c, dt, dx, dy, dz, *, compat: bool = False,
           method: str = "selectshift", k: int = 2, origin=(0, 0, 0),
           gshape=None, set_fn=None, count_box=None):
    """Advect Vx, Vy, Vz and the tracer C from the post-BC snapshots
    (gpu.jl:308-332) with the given method; compat keeps the reference's
    third branch (below). Returns (vx', vy', vz', c', n_clamped) with
    n_clamped an int32 0-dim tensor (always 0 for 'gather').

    Sharded composition (module docstring): origin and gshape clamp the
    departure points at the global bounds (each branch derives its
    field's global staggered shape from the cell-centred gshape);
    set_fn(target, region, vals, gbounds) replaces the write of vals into
    target[region] (`set_region`), gbounds being the branch's 1-based
    global inclusive write range per axis on the target's index space
    (None: the whole axis); count_box restricts the clamp count
    (backtrack_selectshift)."""
    n_clamped = torch.zeros((), dtype=torch.int32, device=vx.device)
    gn = tuple(c.shape if gshape is None else gshape)
    set_fn = set_region if set_fn is None else set_fn

    def staggered(axis):
        """The global shape of the field staggered along axis (3: the
        cell-centred C)."""
        return tuple(n + (d == axis) for d, n in enumerate(gn))

    def bt(a_o, vels, starts, gsh):
        nonlocal n_clamped
        if method == "gather":
            return backtrack_gather(a_o, *vels, starts, dt, dx, dy, dz,
                                    origin, gsh, compat)
        if method != "selectshift":
            raise ValueError(f"unknown advection method {method!r}")
        vals, n = backtrack_selectshift(a_o, *vels, starts, dt, dx, dy, dz,
                                        k, origin, gsh, count_box, compat)
        n_clamped = n_clamped + n
        return vals

    new = {}
    for axis, (branch, a) in enumerate(zip(BRANCHES, (vx, vy, vz, c))):
        vels = face_velocities(branch, vx, vy, vz)
        if branch == "vz" and compat:
            # Reference bug (gpu.jl:325): Vy is written again, from the Vy
            # snapshot with Vy's clamp bounds, over iy 1..ny and iz 2..nz,
            # overwriting branch 2 where the regions overlap; Vz is left
            # as it is
            vals = bt(vy, vels, (1, 1, 2), staggered(1))
            new["vy"] = set_fn(new["vy"], _region((1, 1, 2), vals), vals,
                               (None, (1, gn[1]), (2, gn[2])))
            new["vz"] = vz
        else:
            # the write region: faces 2..n of the staggered axis
            starts = _STARTS[branch]
            vals = bt(a, vels, starts, staggered(axis))
            new[branch] = set_fn(a, _region(starts, vals), vals, tuple(
                (2, gn[d]) if d == axis else None for d in range(3)))
    return new["vx"], new["vy"], new["vz"], new["c"], n_clamped
