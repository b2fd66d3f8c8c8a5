"""The full-step distributed schedule (`--comm fullstep`, port of
navierstokes3d_tpu/parallel/fullstep.py): every stage of the Chorin step
runs per shard on owned-face blocks, with an explicit halo exchange before
each stage that reads a neighbour.

  reference                      here
  ---------                      ----
  update_halo!(τxx,τyy,τzz) :450  velocity k=2 halo BEFORE update_τ/predict
                                  (τ is recomputed in the pad ring, so its
                                  own exchange disappears)
  update_halo!(C,Vx,Vy,Vz)  :453  none: the cylinder masks are
                                  position-local
  update_halo!(∇V)          :455  ∇V from the (0,1) staggered-face halo
  Pr halo in the loop       :462  parallel/halo.py's solve (the plain loop,
                                  or K2-dist / K7-dist per shard)
  update_halo!(Vx,Vy,Vz)    :477  velocity k=advect_k+1 halo BEFORE advect
                                  (the select-shift footprint plus the
                                  trilinear corner)

(NavierStokes3D_multi_gpu.jl line numbers.) Owned-face layout: each
velocity keeps its n (not n+1) owned faces per global cell row, face i
with cell i, so all six volumetric fields are (nx, ny, nz) and split into
equal blocks over the three mesh axes. The global (n+1)-th face family is
a 2D plane of state (it carries pre-advect BC copies across steps), held
by every shard along its own axis and split over the other two: vx_hi
(ny, nz) over (y, z), vy_hi (nx, nz) over (x, z), vz_hi (nx, ny) over
(x, y).

Stencil stages build halo-padded local canonical arrays (the staggered
axis padded one deeper on the hi side, the hi-face plane inserted on the
axis-edge shard), apply the single-device ops (ops/physics.py,
ops/advect.py), crop the owned block and keep cells outside each op's
global write region through position masks, so the owned cells' arithmetic
is the single-device step's. Advection clamps departure points at the
GLOBAL bounds (ops/advect's origin/gshape) and masks each branch's writes
to its global region (set_fn).

As in parallel/halo.py, the shards live in this process (parallel/mesh.py)
and every exchange goes through parallel/transport.py.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence, Tuple

import torch

from ..ops import advect as adv
from ..ops import physics as ph
from ..ops.stencil import div
from ..ptloop import host_scalar
from ..state import FlowState, StepStats
from ..utils.profiling import NO_SPAN, span
from .halo import build_poisson_shard_map, halo_pad, halo_pad_asym
from .mesh import Mesh, join_blocks, split_blocks
from .transport import mesh_sum, pick_hi

Blocks = List[torch.Tensor]
VELOCITIES = ("vx", "vy", "vz")


@dataclasses.dataclass
class DistState:
    """A flow state in the owned-face layout (module docstring): per-shard
    lists, in the mesh's shard order, of the six (bx, by, bz) blocks and of
    the hi-face planes' blocks."""
    mesh: Mesh
    pr: Blocks
    vx: Blocks          # owned faces of Vx
    vy: Blocks
    vz: Blocks
    c: Blocks
    dprdtau: Blocks
    vx_hi: Blocks       # global face nx plane (ny, nz): (by, bz) blocks
    vy_hi: Blocks       # global face ny plane (nx, nz): (bx, bz) blocks
    vz_hi: Blocks       # global face nz plane (nx, ny): (bx, by) blocks


def _other_axes(axis: int) -> Tuple[int, int]:
    return tuple(d for d in range(3) if d != axis)


def to_dist(state: FlowState, mesh: Mesh) -> DistState:
    """Canonical FlowState -> owned-face DistState on the mesh's shards
    (a stored pair's low word, if any, is dropped: the distributed solves
    keep none)."""
    parts = {name: split_blocks(getattr(state, name), mesh)
             for name in ("pr", "c", "dprdtau")}
    for axis, name in enumerate(VELOCITIES):
        v = getattr(state, name)
        n = v.shape[axis] - 1
        parts[name] = split_blocks(v.narrow(axis, 0, n), mesh)
        parts[f"{name}_hi"] = [
            b.squeeze(axis) for b in split_blocks(v.narrow(axis, n, 1), mesh,
                                                  full_axis=axis)]
    return DistState(mesh=mesh, **parts)


def from_dist(dist: DistState) -> FlowState:
    """Owned-face DistState -> canonical FlowState on the first shard's
    device."""
    mesh = dist.mesh
    fields = {name: join_blocks(getattr(dist, name), mesh)
              for name in ("pr", "c", "dprdtau")}
    for axis, name in enumerate(VELOCITIES):
        hi = join_blocks([h.unsqueeze(axis) for h in getattr(dist,
                                                            f"{name}_hi")],
                         mesh, full_axis=axis)
        fields[name] = torch.cat((join_blocks(getattr(dist, name), mesh),
                                  hi), axis)
    return FlowState(**fields)


def stag_pad_local(vo: Sequence[torch.Tensor], vh: Sequence[torch.Tensor],
                   axis: int, k: int, mesh: Mesh) -> Blocks:
    """Each shard's halo-padded local canonical staggered array: faces
    [go-k, go+b+k] on `axis` (k lo, k+1 hi), cells [go-k, go+b+k) on the
    others. The global hi-face plane goes in at its true position on the
    axis-edge shard only; pads beyond the global domain hold zeros (buffer
    cells, never consumed with effect)."""
    widths = [(k, k)] * 3
    widths[axis] = (k, k + 1)
    padded = halo_pad_asym(vo, mesh, widths)
    # the plane padded over its own two axes, so the corners align
    vh_p = (halo_pad_asym(vh, mesh, [(k, k)] * 2, _other_axes(axis))
            if k > 0 else vh)
    idx = k + vo[0].shape[axis]
    for p, h, pos in zip(padded, vh_p, mesh.coords()):
        if pos[axis] == mesh.shape[axis] - 1:
            p.select(axis, idx).copy_(h)   # p is halo_pad_asym's new tensor
    return padded


def build_fullstep(solver, mesh: Mesh, use_pallas: bool | None = None
                   ) -> Callable[[DistState], Tuple[DistState, StepStats]]:
    """The full step of `solver` over `mesh`: step(dist) -> (dist, stats).

    The Poisson stage is parallel/halo.py's local solve (the plain loop on
    any mesh, or on an x-only mesh with halo width 1 the kernel loop, one
    K2-dist launch per shard and iteration on the (hi, lo) pair where the
    solver is extended, else K7-dist); use_pallas None takes the kernel
    loop where the solver's kernels carry its hot path (the rule of
    step_shard_map). Every other stage exchanges its halos as the module
    docstring says. stats.iters, err and err_hist are the solve's,
    advect_clamped the mesh's sum of the owned cells' clamps."""
    cfg, grid = solver.cfg, solver.grid
    phys = cfg.physics
    nx, ny, nz = grid.nx, grid.ny, grid.nz
    dx, dy, dz = grid.dx, grid.dy, grid.dz
    rho, mu, dt, vin = phys.rho, phys.mu, grid.dt, phys.vin
    g_eff = 0.0 if solver.pressure_split else phys.g
    variant, compat = cfg.variant, cfg.compat
    npx, npy, npz = mesh.shape
    if nx % npx or ny % npy or nz % npz:
        raise ValueError("grid dims must divide mesh dims")
    blk = (nx // npx, ny // npy, nz // npz)
    adv_k = solver.advect_k
    K = adv_k + 1   # the advection halo: the window k plus the corner
    if min(blk) < K + 1:
        raise ValueError(
            f"the full step needs local blocks >= {K + 1} cells per axis "
            f"(advection halo depth); got {blk}")
    if use_pallas is None:
        use_pallas = solver._dist_kernels(mesh)
    poisson_local = build_poisson_shard_map(
        mesh, grid, phys, cfg.numerics.eps_it, variant, solver.dtype,
        halo_width=cfg.parallel.halo, pressure_split=solver.pressure_split,
        stall=solver._stall, use_pallas=use_pallas,
        extended=solver.extended and use_pallas, wrap=False)
    method = solver.advect_method
    coords, shape = mesh.coords(), mesh.shape
    offs = [tuple(p * b for p, b in zip(pos, blk)) for pos in coords]

    def range_mask(ranges, off0, device):
        """Bool mask over an owned block: per-axis GLOBAL 0-based inclusive
        [lo, hi] ranges; off0 = the block's global origin."""
        m = torch.ones(blk, dtype=torch.bool, device=device)
        for d, (lo, hi) in enumerate(ranges):
            g = off0[d] + torch.arange(blk[d], device=device)
            view = [1, 1, 1]
            view[d] = blk[d]
            m = m & ((g >= lo) & (g <= hi)).reshape(view)
        return m

    # the @inn write regions (global 0-based) of the predictor and the
    # corrector, per shard
    inn = [tuple(range_mask(r, off0, dev) for r in (
        [(1, nx - 1), (1, ny - 2), (1, nz - 2)],
        [(1, nx - 2), (1, ny - 1), (1, nz - 2)],
        [(1, nx - 2), (1, ny - 2), (1, nz - 1)]))
        for off0, dev in zip(offs, mesh.devices)]

    # the cylinder's 2D masks over each shard's (x, y) extent, and over the
    # hi-face planes' (Vx face nx: mask row nx; Vy face ny: column ny; Vz:
    # z-extruded, the block's own)
    masks = solver.masks
    bx, by, bz = blk
    cyl = []
    for (ox, oy, _), dev in zip(offs, mesh.devices):
        sl = (slice(ox, ox + bx), slice(oy, oy + by))
        cyl.append({
            "c": masks.mask_c[sl], "vx": masks.mask_vx[sl],
            "vy": masks.mask_vy[sl], "vz": masks.mask_vz[sl],
            "vx_hi": masks.mask_vx[nx, oy:oy + by][:, None],
            "vy_hi": masks.mask_vy[ox:ox + bx, ny][:, None],
            "vz_hi": masks.mask_vz[sl]})
        for name in ("c", *VELOCITIES):   # broadcast along z
            cyl[-1][name] = cyl[-1][name][:, :, None]
        cyl[-1] = {name: m.to(dev) for name, m in cyl[-1].items()}

    def cylinder_local(st):
        """set_cylinder! (gpu.jl:336-368) on the owned blocks and the
        hi-face planes, through the precomputed masks (ops/cylinder.py)."""
        for name in ("c", *VELOCITIES, "vx_hi", "vy_hi", "vz_hi"):
            val = 1.0 if name == "c" else 0.0
            st[name] = [torch.where(m[name], val, a)
                        for m, a in zip(cyl, st[name])]

    # ---- boundary conditions, guarded by shard position (bc.py's order)

    def edited(blocks, edit):
        """[edit(block, shard position)]; an edit writes into a copy of
        the block it changes (the shards at a global edge)."""
        return [edit(a, pos) for a, pos in zip(blocks, coords)]

    def zero_grad(d, ax):
        """zero_grad along block axis d at the global edges of mesh axis
        ax: the edge plane copies its neighbour."""
        def edit(a, pos):
            lo, hi = pos[ax] == 0, pos[ax] == shape[ax] - 1
            if lo or hi:
                a, n = a.clone(), a.shape[d]
            if lo:
                a.select(d, 0).copy_(a.select(d, 1))
            if hi:
                a.select(d, n - 1).copy_(a.select(d, n - 2))
            return a
        return edit

    def zg3(blocks, d):
        return edited(blocks, zero_grad(d, d))

    def zg2(planes, mesh_axis, d2):
        """zero_grad on a 2D hi-face plane along its axis d2, which lies
        along mesh axis mesh_axis."""
        return edited(planes, zero_grad(d2, mesh_axis))

    def zg_stag(blocks, d):
        """zero_grad along the field's own staggered axis d: the lo face
        from the block, the hi face (the plane) from the axis-hi shard's
        last owned face. Returns (blocks, planes)."""
        def edit(a, pos):
            if pos[d] == 0:
                a = a.clone()
                a.select(d, 0).copy_(a.select(d, 1))
            return a
        blocks = edited(blocks, edit)
        return blocks, pick_hi([a.select(d, a.shape[d] - 1) for a in blocks],
                               mesh, d)

    def nbst3(blocks, cells: bool):
        """noslip_bottom_slip_top (bc_zV!, gpu.jl:239-243) along z. For the
        z-cell fields (Vx, Vy) on the blocks only (their planes take z
        through nbst2); for the z-staggered Vz face 0 = 0 and face nz =
        face nz-1 (picked across z), returning (blocks, planes)."""
        def edit(a, pos):
            lo, hi = pos[2] == 0, cells and pos[2] == shape[2] - 1
            if lo or hi:
                a = a.clone()
            if lo:
                a[:, :, 0] = 0.0
            if hi:
                a[:, :, -1] = a[:, :, -2]
            return a
        blocks = edited(blocks, edit)
        if cells:
            return blocks
        return blocks, pick_hi([a[:, :, -1] for a in blocks], mesh, 2)

    def nbst2(planes):
        """bc_zV! on a 2D (·, z-cells) hi-face plane."""
        def edit(a, pos):
            lo, hi = pos[2] == 0, pos[2] == shape[2] - 1
            if lo or hi:
                a = a.clone()
            if lo:
                a[:, 0] = 0.0
            if hi:
                a[:, -1] = a[:, -2]
            return a
        return edited(planes, edit)

    def inlet(a, pos):
        """the inlet's Dirichlet Vx plane (rank-guarded in the reference,
        multi_gpu.jl:164-166)"""
        if pos[0] == 0:
            a = a.clone()
            a[0] = vin
        return a

    def bc_vel_local(st):
        vx, vy, vz = st["vx"], st["vy"], st["vz"]
        vxh, vyh, vzh = st["vx_hi"], st["vy_hi"], st["vz_hi"]
        if variant == "multi":
            # order: NavierStokes3D_multi_gpu.jl:156-169 (bc.py)
            vx, vxh = zg_stag(vx, 0)           # bc_x!(Vx) incl. face nx
            vx = zg3(vx, 1)
            vxh = zg2(vxh, 1, 0)               # the x=nx plane is Vx's
            vx = zg3(vx, 2)
            vxh = zg2(vxh, 2, 1)
            vy = zg3(vy, 0)
            vyh = zg2(vyh, 0, 0)
            if not compat:
                vy, vyh = zg_stag(vy, 1)       # omitted in ref (:160-161)
            vy = zg3(vy, 2)
            vyh = zg2(vyh, 2, 1)
            vz = zg3(vz, 0)
            vzh = zg2(vzh, 0, 0)
            vz = zg3(vz, 1)
            vzh = zg2(vzh, 1, 1)
            if not compat:
                vz, vzh = zg_stag(vz, 2)       # omitted in ref (:162-163)
            vx = edited(vx, inlet)
        else:  # gpu: NavierStokes3D_gpu.jl:264-279
            vx, vxh = zg_stag(vx, 0)
            vx = zg3(vx, 1)
            vxh = zg2(vxh, 1, 0)
            vx = nbst3(vx, True)
            vxh = nbst2(vxh)
            vy = zg3(vy, 0)
            vyh = zg2(vyh, 0, 0)
            vy, vyh = zg_stag(vy, 1)
            vy = nbst3(vy, True)
            vyh = nbst2(vyh)
            vz = zg3(vz, 0)
            vzh = zg2(vzh, 0, 0)
            vz = zg3(vz, 1)
            vzh = zg2(vzh, 1, 1)
            vz, vzh = nbst3(vz, False)
        st.update(vx=vx, vy=vy, vz=vz, vx_hi=vxh, vy_hi=vyh, vz_hi=vzh)

    def stag_pads(st, k):
        return [stag_pad_local(st[name], st[f"{name}_hi"], axis, k, mesh)
                for axis, name in enumerate(VELOCITIES)]

    def set_masked(origin):
        """advect's set_fn for a shard whose padded block starts at the
        global cell `origin`: the write keeps the target outside the
        branch's global region."""
        def set_fn(target, region, vals, gbounds):
            m = None
            for d, b in enumerate(gbounds):
                if b is None:
                    continue
                lo1, hi1 = b
                g1 = (origin[d] + (region[d].start or 0) + 1
                      + torch.arange(vals.shape[d], device=vals.device))
                view = [1, 1, 1]
                view[d] = vals.shape[d]
                md = ((g1 >= lo1) & (g1 <= hi1)).reshape(view)
                m = md if m is None else m & md
            out = target.clone()
            out[region] = (vals if m is None
                           else torch.where(m, vals, target[region]))
            return out
        return set_fn

    owned = tuple((K, K + b) for b in blk)
    own_sl = tuple(slice(K, K + b) for b in blk)
    sl2 = tuple(slice(2, 2 + b) for b in blk)
    c_corr = -dt / rho

    def step(dist: DistState) -> Tuple[DistState, StepStats]:
        with NO_SPAN if solver._stepped else solver._first_step(), \
                span("ns3d.step"):
            return _step(dist)

    def _step(dist: DistState) -> Tuple[DistState, StepStats]:
        if dist.mesh != mesh:
            raise ValueError("the state lies on another mesh than the step's")
        st = {f.name: list(getattr(dist, f.name))
              for f in dataclasses.fields(DistState) if f.name != "mesh"}

        # -- stress + predictor (velocity k=2 halo; τ recomputed locally,
        #    replacing update_halo!(τxx,τyy,τzz), multi_gpu.jl:450) --
        vp = stag_pads(st, 2)
        for s in range(mesh.size):
            pads = [p[s] for p in vp]
            taus = ph.update_tau(*pads, mu, dx, dy, dz)
            new = ph.predict_v(*pads, *taus, rho, g_eff, dt, dx, dy, dz)
            for name, m, v in zip(VELOCITIES, inn[s], new):
                st[name][s] = torch.where(m, v[sl2], st[name][s])
        # the hi-face planes are outside @inn: the predictor keeps them

        # -- cylinder (position-local; no exchange) --
        cylinder_local(st)

        # -- divergence (one staggered-face halo per velocity: the
        #    update_halo!(∇V) analog, multi_gpu.jl:455) --
        vp = stag_pads(st, 0)
        rhs = [(rho / dt) * ph.update_divv(*(p[s] for p in vp), dx, dy, dz)
               for s in range(mesh.size)]

        # -- pressure Poisson (parallel/halo.py's distributed solve) --
        pr, dpr, iters, err, hist = poisson_local(st["pr"], st["dprdtau"],
                                                  rhs)
        st["pr"], st["dprdtau"] = pr, dpr

        # -- corrector (pr width-1 halo) --
        for s, p in enumerate(halo_pad(pr, mesh, 1)):
            own = p[1:bx + 1, 1:by + 1, 1:bz + 1]
            grads = (own - p[0:bx, 1:by + 1, 1:bz + 1],
                     own - p[1:bx + 1, 0:by, 1:bz + 1],
                     own - p[1:bx + 1, 1:by + 1, 0:bz])
            for name, m, gr, h in zip(VELOCITIES, inn[s], grads,
                                      (dx, dy, dz)):
                st[name][s] = st[name][s] + torch.where(
                    m, div(c_corr * gr, h), 0.0)

        # -- cylinder + velocity BCs --
        cylinder_local(st)
        bc_vel_local(st)

        # -- semi-Lagrangian advection (velocity k=advect_k+1 halo: the
        #    update_halo!(Vx,Vy,Vz) analog, multi_gpu.jl:477) --
        vp = stag_pads(st, K)
        cp = halo_pad(st["c"], mesh, K)
        clamped = []
        for s, off0 in enumerate(offs):
            origin = tuple(o - K for o in off0)
            out = adv.advect(
                *(p[s] for p in vp), cp[s], dt, dx, dy, dz, compat=compat,
                method=method, k=adv_k, origin=origin, gshape=(nx, ny, nz),
                set_fn=set_masked(origin), count_box=owned)
            for name, a in zip((*VELOCITIES, "c"), out[:4]):
                st[name][s] = a[own_sl]
            clamped.append(out[4])
        # advect never writes the hi-face planes (regions end at face n-1)
        n_clamped = host_scalar(mesh_sum(clamped, mesh), int)
        return (DistState(mesh=mesh, **st),
                StepStats(iters=iters, err=err, err_hist=hist,
                          advect_clamped=n_clamped))

    return step
