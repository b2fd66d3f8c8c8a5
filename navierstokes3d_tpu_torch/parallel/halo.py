"""Halo exchange and the distributed pseudo-transient Poisson solve (port
of navierstokes3d_tpu/parallel/halo.py).

The reference exchanges halos with ImplicitGlobalGrid's update_halo! and
reduces the residual with MPI.Allreduce(MAX) (max_g,
NavierStokes3D_multi_gpu.jl:21); the JAX package runs the whole loop
under shard_map with lax.ppermute face shifts and lax.pmax. Here the mesh's
shards live in one process (parallel/mesh.py), the loop is driven from the
host as the port's other solves are (ptloop.pt_loop_fused: one device read
per check), and the exchange goes through transport.shift and
transport.mesh_max.

Each shard owns an un-haloed block of the global grid, the same blocks as
mesh.split_blocks. Three loops, as in the JAX package:
  * the plain width-1 loop (any 3D mesh): per iteration the pressure's
    halo, the shard's stencil, the position-guarded BCs (`_bc_pr_local`);
  * halo_width k > 1: k iterations per k-deep exchange of pr, dpr and rhs
    (`run_batch`), batches clipped at checks and at the budget's end;
  * the kernel loop (x-only meshes, k = 1): one K7-dist launch per shard
    and iteration, or K2-dist on the (hi, lo) pair where `extended`, with
    the two x-face planes of each word exchanged before the launch and the
    check iteration's residual max-reduced over the mesh.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import poisson as k_poisson
from ..ops.stencil import div
from ..ptloop import np_float, pt_loop_fused
from .mesh import Mesh, join_blocks, split_blocks
from .transport import mesh_max, shift


def _zeros_or(h: Optional[torch.Tensor], like: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(like) if h is None else h


def halo_pad(blocks: Sequence[torch.Tensor], mesh: Mesh,
             width: int = 1) -> List[torch.Tensor]:
    """Each shard's block padded by `width` cells per side per mesh axis
    with its neighbours' face slabs (zeros at open global boundaries):
    halo_pad_asym's symmetric case."""
    return halo_pad_asym(blocks, mesh, [(width, width)] * 3)


def halo_pad_asym(blocks: Sequence[torch.Tensor], mesh: Mesh,
                  widths: Sequence[Tuple[int, int]],
                  mesh_axes: Sequence[int] = (0, 1, 2)
                  ) -> List[torch.Tensor]:
    """halo_pad with per-axis (lo, hi) widths (the JAX package's
    halo_pad_asym, parallel/halo.py:66-87): the owned-face layout of
    parallel/fullstep.py pads a velocity's staggered axis one deeper on
    the hi side. Block axis d is exchanged along mesh axis mesh_axes[d]
    (a 2D hi-face plane names its own two), in order, so corner pads carry
    the diagonal neighbours' data; a (0, 0) axis is skipped."""
    out = list(blocks)
    for dim, (ax, (lo_w, hi_w)) in enumerate(zip(mesh_axes, widths)):
        if not (lo_w or hi_w):
            continue
        n = out[0].shape[dim]
        hi_faces = [b.narrow(dim, n - lo_w, lo_w) for b in out]
        lo_faces = [b.narrow(dim, 0, hi_w) for b in out]
        from_left = shift(hi_faces, mesh, ax, +1)
        from_right = shift(lo_faces, mesh, ax, -1)
        out = [torch.cat((_zeros_or(left, hf), b, _zeros_or(right, lf)), dim)
               for b, lf, hf, left, right in zip(out, lo_faces, hi_faces,
                                                 from_left, from_right)]
    return out


def _bc_pr_local(pr, pos, mesh_shape, variant: str, xlo_plane, xhi_plane,
                 z_lo_add=0.0, z_hi_add=0.0):
    """The reference's set_bc_Pr! on a shard's block, guarded by the
    shard's position (ix, iy, iz) on a mesh of mesh_shape as the multi
    script guards by rank (multi_gpu.jl:175-184). Needs >= 2 cells per
    sharded axis (copy sources are then owned). z_*_add are the affine
    offsets of the split-pressure bc_z!. Returns a new tensor."""
    return _bc_pr_local_padded(pr, pos, mesh_shape, variant, xlo_plane,
                               xhi_plane, 0, z_lo_add, z_hi_add)


def _bc_pr_local_padded(pr, pos, mesh_shape, variant: str, xlo_plane,
                        xhi_plane, m: int, z_lo_add=0.0, z_hi_add=0.0):
    """_bc_pr_local on an m-deep halo-padded block: the global boundary
    planes sit at padded index m / -(1+m) on edge shards (a halo never holds
    a foreign BC plane for m <= block-1)."""
    (ix, iy, iz), (npx, npy, npz) = pos, mesh_shape
    lo, hi = m, -1 - m
    pr = pr.clone()
    if variant == "multi":
        if ix == 0:
            pr[lo] = pr[lo + 1]
        if ix == npx - 1:
            pr[hi] = pr[hi - 1]
        if iy == 0:
            pr[:, lo] = pr[:, lo + 1]
        if iy == npy - 1:
            pr[:, hi] = pr[:, hi - 1]
        if iz == 0:
            pr[:, :, lo] = pr[:, :, lo + 1]
        if iz == npz - 1:
            pr[:, :, hi] = pr[:, :, hi - 1]
        if ix == npx - 1:
            pr[hi] = 0.0
        return pr
    # gpu variant: bc_y, bc_z, hydrostatic x planes (gpu.jl:281-286)
    if iy == 0:
        pr[:, lo] = pr[:, lo + 1]
    if iy == npy - 1:
        pr[:, hi] = pr[:, hi - 1]
    if iz == 0:
        pr[:, :, lo] = pr[:, :, lo + 1] + z_lo_add
    if iz == npz - 1:
        pr[:, :, hi] = pr[:, :, hi - 1] + z_hi_add
    if ix == 0:
        pr[lo] = xlo_plane
    if ix == npx - 1:
        pr[hi] = xhi_plane
    return pr


def build_poisson_shard_map(mesh: Mesh, grid, phys, eps_it: float,
                            variant: str, dtype: torch.dtype,
                            halo_width: int = 1,
                            pressure_split: bool = False,
                            stall: Optional[Tuple[float, int]] = None,
                            use_pallas: bool = False,
                            extended: bool = False,
                            wrap: bool = True) -> Callable:
    """The distributed pseudo-transient Poisson solve (the JAX package's
    build_poisson_shard_map without `interpret`: the kernel wrappers run
    their plain versions on CPU tensors).

    pressure_split: the fields are p' = Pr - P_static(z) (gpu variant):
    the x Dirichlet planes are constants and bc_z! gains affine offsets.
    stall: (ratio, checks) plateau exit, or None. use_pallas: the kernel
    loop (x-only mesh, halo_width 1, float32); extended adds the pair's lo
    word (K2-dist), which the solve drops at its exit.

    Returns solve(pr, dprdtau, rhs) -> (pr, dprdtau, iters, err, hist) on
    global tensors: split into the mesh's blocks at entry and joined back
    on pr's device at exit (the JAX shard_map's in/out specs). wrap=False
    returns the local solve instead, on lists of per-shard blocks in
    mesh order, for composition into a step that keeps its state
    sharded."""
    nx, ny, nz = grid.nx, grid.ny, grid.nz
    dx, dy, dz = grid.dx, grid.dy, grid.dz
    dtau, damp = grid.dtau, grid.damp
    nchk, niter = grid.nchk, grid.niter
    nchunks = niter // nchk
    err_scale = (grid.ly * grid.ly) / phys.psc
    npx, npy, npz = mesh.shape
    if nx % npx or ny % npy or nz % npz:
        raise ValueError("grid dims must divide mesh dims")
    bx, by, bz = nx // npx, ny // npy, nz // npz
    if min(bx, by, bz) < 2:
        raise ValueError("local blocks must be >= 2 cells per axis")
    k = int(halo_width)
    if k < 1 or (k > 1 and k > min(bx, by, bz) - 1):
        raise ValueError(
            f"halo_width {k} must be in [1, min(block)-1={min(bx,by,bz)-1}] "
            "(a wider halo would contain foreign BC planes)")
    coords = mesh.coords()

    # gpu-variant hydrostatic x planes (value depends only on global z,
    # gpu.jl:257-261); under the split they are constants (0 here, +100
    # added at use) and bc_z! carries affine offsets instead
    npdt = np_float(dtype)
    z_lo_add = z_hi_add = 0.0
    if variant == "gpu" and pressure_split:
        prof_full = np.zeros((ny, nz), npdt)
        rho_g_dz = phys.rho * phys.g * dz
        z_lo_add, z_hi_add = -rho_g_dz, +rho_g_dz
    elif variant == "gpu":
        izg = np.arange(1, nz + 1, dtype=np.float64)
        prof = phys.rho * phys.g * (nz - izg + 0.5) * dz
        prof_full = np.broadcast_to(prof[None, :], (ny, nz)).astype(npdt)
    else:
        prof_full = np.zeros((ny, nz), npdt)

    def local_interior_mask(shape, pos, device, off=0):
        """True on the globally interior cells of a shard's block; `off`
        is the halo depth when shape is a padded block's."""
        m = None
        for ax, (n, b, g) in enumerate(zip(shape, (bx, by, bz),
                                           (nx, ny, nz))):
            gi = pos[ax] * b - off + torch.arange(n, device=device)
            view = [1, 1, 1]
            view[ax] = n
            on = ((gi >= 1) & (gi <= g - 2)).reshape(view)
            m = on if m is None else m & on
        return m

    def lap_of(pad):
        c = pad[1:-1, 1:-1, 1:-1]
        return (div(div(pad[2:, 1:-1, 1:-1] - 2 * c + pad[:-2, 1:-1, 1:-1],
                        dx), dx)
                + div(div(pad[1:-1, 2:, 1:-1] - 2 * c + pad[1:-1, :-2, 1:-1],
                          dy), dy)
                + div(div(pad[1:-1, 1:-1, 2:] - 2 * c + pad[1:-1, 1:-1, :-2],
                          dz), dz))

    def masked_max(mask, resid):
        return torch.max(torch.where(mask, torch.abs(resid),
                                     torch.zeros_like(resid)))

    def err_of(es):
        return mesh_max(es, mesh) * err_scale

    def loop(step_fn, carry):
        return pt_loop_fused(step_fn, carry, 0, niter, nchk, nchunks, eps_it,
                             dtype, stall=stall)

    def wrapped(solve_local):
        if not wrap:
            return solve_local

        def solve(pr, dpr, rhs):
            p, d, iters, err, hist = solve_local(
                split_blocks(pr, mesh), split_blocks(dpr, mesh),
                split_blocks(rhs, mesh))
            return (join_blocks(p, mesh, device=pr.device),
                    join_blocks(d, mesh, device=pr.device), iters, err, hist)
        return solve

    if use_pallas:
        # the kernel per shard: each iteration exchanges the two x-face
        # planes of each word, and the kernels' BC guards key on the
        # global x position x_off + row (the reference's rank-guarded
        # set_bc_Pr!, multi_gpu.jl:175-184, fused into the iteration)
        if npy != 1 or npz != 1:
            raise ValueError(
                "the per-shard Poisson kernels require an x-only mesh "
                f"(px,1,1); got {(npx, npy, npz)}")
        if k != 1:
            raise ValueError("the per-shard Poisson kernels apply the BCs "
                             "every iteration; halo_width must be 1")
        if dtype != torch.float32:
            raise ValueError("the per-shard Poisson kernels are float32")
        spec = k_poisson.poisson_bc_spec(variant, grid, phys, pressure_split)
        ops = {d: k_poisson.make_bc_operator(spec, grid, d)
               for d in set(mesh.devices)}
        op_of = [ops[d] for d in mesh.devices]
        x_offs = [pos[0] * bx for pos in coords]
        nw = 2 if extended else 1   # pressure words: hi (and lo)

        def solve_local_kernel(pr, dpr, rhs):
            words = [list(pr)]
            if extended:
                words.append([torch.zeros_like(p) for p in pr])
            # two output sets in turn: the kernels read their inputs whole
            # (and the neighbours' faces), and the caller's blocks are
            # never written
            bufs = [[[torch.empty_like(p) for p in pr]
                     for _ in range(nw + 1)] for _ in range(2)]

            def step_fn(c, it):
                inp, (out, spare) = c
                halos = [(shift([q[-1] for q in w], mesh, 0, +1),
                          shift([q[0] for q in w], mesh, 0, -1))
                         for w in inp[:nw]]
                check = (it + 1) % nchk == 0
                es = []
                for s in range(mesh.size):
                    if extended:
                        (hl, hh), (ll, lh) = ((h[0][s], h[1][s])
                                              for h in halos)
                        e = k_poisson.poisson_iter_ext_bc_dist(
                            inp[0][s], inp[1][s], inp[2][s], rhs[s],
                            out[0][s], out[1][s], out[2][s], hl, hh, ll, lh,
                            x_offs[s], op_of[s], check)
                    else:
                        e = k_poisson.poisson_iter_bc_dist(
                            inp[0][s], inp[1][s], rhs[s], out[0][s],
                            out[1][s], halos[0][0][s], halos[0][1][s],
                            x_offs[s], op_of[s], check)
                    es.append(e)
                return ((out, (spare, out)), err_of(es) if check else None,
                        1)

            (res, _), iters, err, hist = loop(step_fn,
                                              ([*words, list(dpr)], bufs))
            # the pair's lo word is dropped (the JAX p_unpack, :379-380)
            return res[0], res[-1], iters, err, hist

        return wrapped(solve_local_kernel)

    # the k-padded profile (edge-replicated; edge pads are never consumed)
    prof_pad = np.pad(prof_full, k, mode="edge")

    def planes_of(pos, device, m=0):
        """The gpu variant's x Dirichlet planes over a shard's (m-padded)
        y/z extent: (xlo, xhi), xlo = profile + 100 in the solve's dtype."""
        y0, z0 = pos[1] * by + k - m, pos[2] * bz + k - m
        xplane = torch.tensor(
            prof_pad[y0:y0 + by + 2 * m, z0:z0 + bz + 2 * m], dtype=dtype,
            device=device)
        return xplane + 100.0, xplane

    def solve_local(pr, dpr, rhs):
        devs = [p.device for p in pr]
        masks = [local_interior_mask(p.shape, pos, d)
                 for p, pos, d in zip(pr, coords, devs)]
        planes = [planes_of(pos, d) for pos, d in zip(coords, devs)]

        if k == 1:
            def step_fn(c, it):
                prs, dprs = c
                pads = halo_pad(prs, mesh)
                check = (it + 1) % nchk == 0
                out_p, out_d, es = [], [], []
                for s, pos in enumerate(coords):
                    resid = lap_of(pads[s]) - rhs[s]
                    if check:
                        es.append(masked_max(masks[s], resid))
                    d = torch.where(masks[s],
                                    dprs[s] * (1.0 - damp) + dtau * resid,
                                    torch.zeros_like(dprs[s]))
                    p = _bc_pr_local(prs[s] + dtau * d, pos, mesh.shape,
                                     variant, *planes[s], z_lo_add, z_hi_add)
                    out_p.append(p)
                    out_d.append(d)
                return (out_p, out_d), err_of(es) if check else None, 1
        else:
            def run_batch(prs, dprs, m, check):
                """m iterations on m-deep halo-padded blocks: one exchange of
                pr, dpr and rhs, then m local width-1 sweeps whose halo
                validity shrinks one cell per sweep; the check value is the
                owned cells' max |resid| of the last sweep."""
                prp = halo_pad(prs, mesh, m)
                dpp = halo_pad(dprs, mesh, m)
                rhp = halo_pad(rhs, mesh, m)
                out_p, out_d, es = [], [], []
                for s, pos in enumerate(coords):
                    p, d, r = prp[s], dpp[s], rhp[s]
                    xlo_p, xhi_p = planes_of(pos, devs[s], m)
                    maskp = local_interior_mask(p.shape, pos, devs[s],
                                                off=m)[1:-1, 1:-1, 1:-1]
                    own = maskp.clone().fill_(True)
                    for ax, b_ax in enumerate((bx, by, bz)):
                        ii = torch.arange(own.shape[ax], device=devs[s])
                        view = [1, 1, 1]
                        view[ax] = own.shape[ax]
                        own = own & ((ii >= m - 1)
                                     & (ii < m - 1 + b_ax)).reshape(view)
                    for j in range(m):
                        resid = lap_of(p) - r[1:-1, 1:-1, 1:-1]
                        if check and j == m - 1:
                            es.append(masked_max(maskp & own, resid))
                        inner = torch.where(
                            maskp,
                            d[1:-1, 1:-1, 1:-1] * (1.0 - damp) + dtau * resid,
                            torch.zeros_like(resid))
                        d = d.clone()
                        d[1:-1, 1:-1, 1:-1] = inner
                        p = _bc_pr_local_padded(p + dtau * d, pos,
                                                mesh.shape, variant, xlo_p,
                                                xhi_p, m, z_lo_add, z_hi_add)
                    sl = (slice(m, -m),) * 3
                    out_p.append(p[sl])
                    out_d.append(d[sl])
                return out_p, out_d, es

            def step_fn(c, it):
                # batches of up to k sweeps per exchange, clipped so no
                # batch crosses a check or the budget's end
                m = max(min(k, nchk - it % nchk, niter - it), 1)
                check = (it + m) % nchk == 0
                prs, dprs, es = run_batch(c[0], c[1], m, check)
                return (prs, dprs), err_of(es) if check else None, m

        (prs, dprs), iters, err, hist = loop(step_fn, (list(pr), list(dpr)))
        return prs, dprs, iters, err, hist

    return wrapped(solve_local)
