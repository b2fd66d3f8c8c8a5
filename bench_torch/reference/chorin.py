"""Plain PyTorch reference of one Chorin projection step.

A straightforward transcription of the reference Julia scripts'
semantics (mattbuergler/NavierStokes3D, scripts/NavierStokes3D_gpu.jl
:119-171 and :175-368, scripts/NavierStokes3D_multi_gpu.jl:108-184 and
:446-477), written for the benchmark's correctness check. It imports no
module of the program under test and reads nothing the program made:
grid constants, cylinder masks, boundary values and the hydrostatic
profile are all computed here from the configuration file.

The step, in physical variables (no hydrostatic split), on a staggered
MAC grid (Pr, C at cells; Vx, Vy, Vz on faces):

  1. stress, predictor V* = V + dt/rho (div tau) - dt g e_z, cylinder
     mask, div V*; the tracer's seed ring C = 1;
  2. the pressure solve lap(Pr) = rho/dt div V* with the variant's
     pressure boundary conditions;
  3. V = V* - dt/rho grad Pr, cylinder mask, the variant's velocity BCs;
  4. semi-Lagrangian advection of Vx, Vy, Vz and C (the reference's
     gather form: backtrack one dt, clamp to the array, trilinear),
     Vz advected properly (the non-compat semantics).

`Reference.check_step` judges a step some program took: it rebuilds the
right-hand side from the step's input, evaluates the residual of the
program's pressure against it, applies the boundary conditions to that
pressure, corrects and advects with it, and measures how far the
program's velocities and tracer lie from the result. `Reference.step`
runs the whole step itself, with a pseudo-transient solve in the
reference's own form: the control computes it in a lower precision.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

FIELDS = ("pr", "vx", "vy", "vz", "c")


@dataclasses.dataclass(frozen=True)
class Geometry:
    nx: int
    ny: int
    nz: int
    lx: float
    ly: float
    lz: float
    dx: float
    dy: float
    dz: float
    dt: float
    dtau: float
    damp: float
    niter: int
    nchk: int


def geometry(cfg: dict) -> Geometry:
    """Grid and time-stepping constants (gpu.jl:43-61, multi_gpu.jl:
    321-341): ny = ceil(nx ly/lx), dt from the viscous and advective CFL
    limits, dtau from the pseudo-transient CFL, damp = 2/nx, niter =
    niter_scale * max(dims) (the gpu script over ny and nz only), nchk =
    ny - 1."""
    nx = int(cfg["nx"])
    lx = float(cfg["lx"])
    ly, lz = lx * cfg["ly_lx"], lx * cfg["lz_lx"]
    ny, nz = math.ceil(nx * cfg["ly_lx"]), math.ceil(nx * cfg["lz_lx"])
    dx, dy, dz = lx / nx, ly / ny, lz / nz
    h = max(dx, dy, dz)
    dt = min(cfg["cfl_visc"] * h * h * cfg["rho"] / cfg["mu"],
             cfg["cfl_adv"] * h / cfg["vin"])
    dims = (ny, nz) if cfg["variant"] == "gpu" else (nx, ny, nz)
    return Geometry(nx=nx, ny=ny, nz=nz, lx=lx, ly=ly, lz=lz, dx=dx, dy=dy,
                    dz=dz, dt=dt, dtau=cfg["cfl_tau"] * h, damp=2.0 / nx,
                    niter=int(cfg["niter_scale"]) * max(dims), nchk=ny - 1)


def gravity(cfg: dict) -> float:
    """g: the gpu script sets 9.81 (gpu.jl:38); the multi script derives
    it from the Froude number, infinite by default (g = 0)."""
    return float(cfg.get("g", 0.0))


def hydrostatic_profile(cfg: dict, geo: Geometry, dtype, device):
    """P_static(iz) = rho g (nz - iz + 0.5) dz, iz = 1..nz (gpu.jl:87,
    :257-261): the init and Dirichlet x-plane profile, shape (nz,)."""
    iz = torch.arange(1, geo.nz + 1, dtype=torch.float64, device=device)
    prof = cfg["rho"] * gravity(cfg) * (geo.nz - iz + 0.5) * geo.dz
    return prof.to(dtype)


def cylinder_masks(cfg: dict, geo: Geometry, device) -> Dict[str, torch.Tensor]:
    """(x, y) masks of the immersed elliptic cylinder, extruded along z
    (set_cylinder!, gpu.jl:336-368): C = 1 inside 1.05 x the radius;
    each velocity component is 0 where its own face lies inside it."""
    cyl = cfg["cylinder"]
    lx, ly = geo.lx, geo.ly
    a2, b2 = (cyl["a_lx"] * lx) ** 2, (cyl["b_lx"] * lx) ** 2
    ox, oy, beta = cyl["ox_lx"] * lx, cyl["oy_lx"] * lx, cyl["beta"]
    f64 = dict(dtype=torch.float64, device=device)
    xc = -(lx - geo.dx) / 2 + torch.arange(geo.nx + 1, **f64) * geo.dx
    yv = torch.arange(geo.ny + 1, **f64) * geo.dy - ly / 2
    yc = yv + geo.dy / 2
    xv = xc - geo.dx / 2

    def inside(x, y, thresh):
        x, y = torch.broadcast_tensors(x[:, None], y[None, :])
        xr = (x - ox) * math.cos(beta) - (y - oy) * math.sin(beta)
        yr = (x - ox) * math.sin(beta) + (y - oy) * math.cos(beta)
        return (xr * xr / a2 + yr * yr / b2) < thresh

    nx, ny = geo.nx, geo.ny
    return {"c": inside(xc[:nx], yc[:ny], 1.05),
            "vx": inside(xv[:nx + 1], yc[:ny], 1.0),
            "vy": inside(xc[:nx], yv[:ny + 1], 1.0),
            "vz": inside(xc[:nx], yc[:ny], 1.0)}


def _interior(a):
    return a[1:-1, 1:-1, 1:-1]


def _pad(a):
    return F.pad(a, (1, 1, 1, 1, 1, 1))


def _zero_grad(a, axis):
    """Copy the second and second-last planes of `axis` outward."""
    b = a.clone()
    idx = [slice(None)] * 3
    src = [slice(None)] * 3
    idx[axis], src[axis] = 0, 1
    b[tuple(idx)] = a[tuple(src)]
    idx[axis], src[axis] = -1, -2
    b[tuple(idx)] = a[tuple(src)]
    return b


class Reference:
    """The reference step of one configuration on one device, in `dtype`
    (float64 for the check; the control passes a lower precision)."""

    def __init__(self, cfg: dict, device, dtype=torch.float64):
        if cfg["variant"] not in ("gpu", "multi"):
            raise ValueError(f"unknown variant {cfg['variant']!r}")
        self.cfg, self.device, self.dtype = cfg, torch.device(device), dtype
        self.geo = geometry(cfg)
        self.masks = cylinder_masks(cfg, self.geo, self.device)
        self.g = gravity(cfg)

    def t(self, a):
        return a.to(device=self.device, dtype=self.dtype)

    # ---- boundary conditions ----

    def set_bc_pr(self, pr):
        """gpu (gpu.jl:281-286): zero gradient in y, then z, then the
        hydrostatic Dirichlet x planes, the inlet +inlet_head Pa. multi
        (multi_gpu.jl:175-184): zero gradient in x, y, z, then Pr = 0 on
        the outlet plane."""
        if self.cfg["variant"] == "gpu":
            pr = _zero_grad(_zero_grad(pr, 1), 2)
            prof = hydrostatic_profile(self.cfg, self.geo, pr.dtype,
                                       pr.device)
            pr[0] = (prof + self.cfg["inlet_head_pa"])[None, :]
            pr[-1] = prof[None, :]
            return pr
        pr = _zero_grad(_zero_grad(_zero_grad(pr, 0), 1), 2)
        pr[-1] = 0.0
        return pr

    def set_bc_vel(self, vx, vy, vz):
        """gpu (gpu.jl:264-279): zero gradient in x and y, then no-slip
        at the bottom (the z = 0 plane set to 0) and free slip at the top
        (zero gradient), for each component. multi (multi_gpu.jl:156-169,
        with bc_y!(Vy) and bc_z!(Vz)): zero gradient on every face, then
        the inlet plane Vx = vin."""
        if self.cfg["variant"] == "gpu":
            out = []
            for v in (vx, vy, vz):
                v = _zero_grad(_zero_grad(v, 0), 1)
                v[:, :, -1] = v[:, :, -2]
                v[:, :, 0] = 0.0
                out.append(v)
            return tuple(out)
        vx, vy, vz = (_zero_grad(_zero_grad(_zero_grad(v, 0), 1), 2)
                      for v in (vx, vy, vz))
        vx[0] = self.cfg["vin"]
        return vx, vy, vz

    def mask_velocities(self, vx, vy, vz):
        m = self.masks
        return (vx.masked_fill(m["vx"][:, :, None], 0.0),
                vy.masked_fill(m["vy"][:, :, None], 0.0),
                vz.masked_fill(m["vz"][:, :, None], 0.0))

    def mask_tracer(self, c):
        return c.masked_fill(self.masks["c"][:, :, None], 1.0)

    # ---- the step's parts ----

    def predict(self, vx, vy, vz):
        """Stress, predictor, cylinder mask, divergence (gpu.jl:121-124,
        :177-197): returns (vx*, vy*, vz*, div V*)."""
        geo, cfg = self.geo, self.cfg
        mu, rho, dt = cfg["mu"], cfg["rho"], geo.dt
        dx, dy, dz = geo.dx, geo.dy, geo.dz
        exx = (vx[1:] - vx[:-1]) / dx
        eyy = (vy[:, 1:] - vy[:, :-1]) / dy
        ezz = (vz[:, :, 1:] - vz[:, :, :-1]) / dz
        third = (exx + eyy + ezz) / 3.0
        txx, tyy, tzz = (2.0 * mu * (e - third) for e in (exx, eyy, ezz))
        txy = mu * ((vx[1:-1, 1:, 1:] - vx[1:-1, :-1, 1:]) / dy
                    + (vy[1:, 1:-1, 1:] - vy[:-1, 1:-1, 1:]) / dx)
        txz = mu * ((vx[1:-1, 1:, 1:] - vx[1:-1, 1:, :-1]) / dz
                    + (vz[1:, 1:, 1:-1] - vz[:-1, 1:, 1:-1]) / dx)
        tyz = mu * ((vy[1:, 1:-1, 1:] - vy[1:, 1:-1, :-1]) / dz
                    + (vz[1:, 1:, 1:-1] - vz[1:, :-1, 1:-1]) / dy)
        fx = ((txx[1:, 1:-1, 1:-1] - txx[:-1, 1:-1, 1:-1]) / dx
              + (txy[:, 1:, :-1] - txy[:, :-1, :-1]) / dy
              + (txz[:, :-1, 1:] - txz[:, :-1, :-1]) / dz)
        fy = ((tyy[1:-1, 1:, 1:-1] - tyy[1:-1, :-1, 1:-1]) / dy
              + (txy[1:, :, :-1] - txy[:-1, :, :-1]) / dx
              + (tyz[:-1, :, 1:] - tyz[:-1, :, :-1]) / dz)
        fz = ((tzz[1:-1, 1:-1, 1:] - tzz[1:-1, 1:-1, :-1]) / dz
              + (txz[1:, :-1, :] - txz[:-1, :-1, :]) / dx
              + (tyz[:-1, 1:, :] - tyz[:-1, :-1, :]) / dy
              - rho * self.g)
        vx = vx + _pad(dt / rho * fx)
        vy = vy + _pad(dt / rho * fy)
        vz = vz + _pad(dt / rho * fz)
        vx, vy, vz = self.mask_velocities(vx, vy, vz)
        divv = ((vx[1:] - vx[:-1]) / dx + (vy[:, 1:] - vy[:, :-1]) / dy
                + (vz[:, :, 1:] - vz[:, :, :-1]) / dz)
        return vx, vy, vz, divv

    def laplacian(self, pr):
        """The 7-point Laplacian on the interior cells."""
        geo = self.geo
        c = _interior(pr)
        return ((pr[2:, 1:-1, 1:-1] - 2.0 * c + pr[:-2, 1:-1, 1:-1])
                / (geo.dx * geo.dx)
                + (pr[1:-1, 2:, 1:-1] - 2.0 * c + pr[1:-1, :-2, 1:-1])
                / (geo.dy * geo.dy)
                + (pr[1:-1, 1:-1, 2:] - 2.0 * c + pr[1:-1, 1:-1, :-2])
                / (geo.dz * geo.dz))

    def residual(self, pr, divv):
        """lap(Pr) - rho/dt div V* on the interior (compute_res!,
        gpu.jl:209-212)."""
        return self.laplacian(pr) - (self.cfg["rho"] / self.geo.dt) * \
            _interior(divv)

    def _modes(self):
        """Eigenpairs of the three 1-D second differences over the
        interior cells, with the boundary conditions set_bc_pr gives the
        Laplacian: in y and z the ghost plane copies its neighbour (the
        end rows read -1/h^2); in x the gpu variant's ghost planes hold
        known values (Dirichlet: -2/h^2 on the end rows, the values move
        to the right-hand side), the multi variant's inlet ghost copies
        its neighbour and its outlet ghost is 0. Made once, in float64."""
        if getattr(self, "_eig", None) is None:
            geo = self.geo
            f64 = dict(dtype=torch.float64, device=self.device)
            out = []
            for axis, (n, h) in enumerate(((geo.nx, geo.dx), (geo.ny, geo.dy),
                                           (geo.nz, geo.dz))):
                m = n - 2
                d = (torch.diag(torch.full((m,), -2.0, **f64))
                     + torch.diag(torch.ones(m - 1, **f64), 1)
                     + torch.diag(torch.ones(m - 1, **f64), -1))
                if axis > 0:
                    d[0, 0] = d[-1, -1] = -1.0
                elif self.cfg["variant"] == "multi":
                    d[0, 0] = -1.0
                lam, q = torch.linalg.eigh(d / (h * h))
                out.append((lam, q))
            self._eig = out
        return self._eig

    def exact_pressure(self, divv):
        """The discrete pressure equation lap(Pr) = rho/dt div V* with the
        variant's boundary conditions, solved directly (no iteration) in
        float64 by the eigenvectors of `_modes`: the Pr that a converged
        solve approaches, with its boundary planes set."""
        geo, cfg = self.geo, self.cfg
        rhs = (cfg["rho"] / geo.dt) * _interior(divv).double()
        if cfg["variant"] == "gpu":
            prof = hydrostatic_profile(cfg, geo, torch.float64,
                                       rhs.device)[1:-1]
            rhs = rhs.clone()
            rhs[0] -= (prof + cfg["inlet_head_pa"])[None, :] / geo.dx ** 2
            rhs[-1] -= prof[None, :] / geo.dx ** 2
        (lx, qx), (ly, qy), (lz, qz) = self._modes()
        f = torch.einsum("ia,ijk,jb,kc->abc", qx, rhs, qy, qz)
        f = f / (lx[:, None, None] + ly[None, :, None] + lz[None, None, :])
        p = torch.einsum("ia,abc,jb,kc->ijk", qx, f, qy, qz)
        pr = torch.zeros((geo.nx, geo.ny, geo.nz), dtype=torch.float64,
                         device=rhs.device)
        pr[1:-1, 1:-1, 1:-1] = p
        return self.set_bc_pr(pr)

    def err_scale(self) -> float:
        """The convergence measure's scale ly^2 / psc, psc = rho vin^2
        (gpu.jl:132)."""
        return self.geo.ly ** 2 / (self.cfg["rho"] * self.cfg["vin"] ** 2)

    def correct(self, vx, vy, vz, pr):
        """V = V* - dt/rho grad Pr on the interior faces, cylinder mask,
        velocity BCs (gpu.jl:138-140, :214-219)."""
        geo = self.geo
        k = -geo.dt / self.cfg["rho"]
        vx = vx + _pad(k * (pr[1:, 1:-1, 1:-1] - pr[:-1, 1:-1, 1:-1])
                       / geo.dx)
        vy = vy + _pad(k * (pr[1:-1, 1:, 1:-1] - pr[1:-1, :-1, 1:-1])
                       / geo.dy)
        vz = vz + _pad(k * (pr[1:-1, 1:-1, 1:] - pr[1:-1, 1:-1, :-1])
                       / geo.dz)
        return self.set_bc_vel(*self.mask_velocities(vx, vy, vz))

    def solve(self, pr, dprdtau, divv) -> Tuple[torch.Tensor, int, float]:
        """The reference's pseudo-transient loop (gpu.jl:126-137): damped
        iterations with the pressure BCs after each, the residual checked
        every nchk iterations, until err < eps_it, a non-finite err or
        niter iterations. Returns (Pr, iterations, err)."""
        geo, cfg = self.geo, self.cfg
        rhs = (cfg["rho"] / geo.dt) * _interior(divv)
        decay = 1.0 - geo.damp
        dpr = dprdtau.clone()
        err = math.inf
        for it in range(1, geo.niter + 1):
            dpr[1:-1, 1:-1, 1:-1] = (_interior(dpr) * decay + geo.dtau
                                     * (self.laplacian(pr) - rhs))
            pr = pr + geo.dtau * dpr
            pr = self.set_bc_pr(pr)
            if it % geo.nchk == 0:
                err = float(torch.max(torch.abs(self.laplacian(pr) - rhs))
                            * self.err_scale())
                if err < cfg["eps_it"] or not math.isfinite(err):
                    return pr, it, err
        return pr, geo.niter, err

    # ---- advection ----

    def _branch(self, a, vels, starts, ulps):
        """backtrack! over one branch's region (gpu.jl:288-304): the
        departure point x = i - dl per axis, dl = dt v / h (1-based i over
        the region that starts at `starts`), clamped to the array,
        trilinear with t = (dl > 0) - dl % 1. Returns (values, ill, lo,
        hi).

        t is taken as x - floor(x), the source's t in exact arithmetic at
        every dl but the whole m >= 1 below. The source's expression,
        evaluated in any floating-point precision, reads the next cell
        a[i + 1] where 0 < dl < half an ulp of i: x rounds to i, so its
        floor is i, while t stays ~1. In exact arithmetic it reads ~a[i]
        there, continuously in dl; x - floor(x) reads that too.

        The formula jumps where dl is a whole number m >= 1: at dl = m it
        reads t = 1 on the corners (i - m, i - m + 1), a[i - m + 1], while
        on either side of m it reads a[i - m]. Its clamp makes it jump at
        x = 1 too: just below, the corners clamp to (1, 2) with t ~1,
        a[2]; at x = 1, a[1]. For i >= 2 that is dl = i - 1, a whole m >=
        1; at i = 1 it is dl = 0. A program in float32 rounds dl and x = i
        - dl to within a few ulps (of the axis's largest index) of the
        float64 ones, so at a jump it may read either side. `ill` marks
        the points whose dl lies within `ulps` such ulps of a whole m >= 1
        on some axis, or of 0 at i = 1; lo and hi bound the formula's
        values there: on each marked axis the corners (i - m, i - m + 1),
        clamped, with t = 0 and with t = 1, every combination over the
        marked axes (the usual corners and t on the others). Elsewhere lo
        = hi = the value. ulps = 0 marks none. Nothing else is marked near
        dl = 0, where the formula is continuous."""
        geo = self.geo
        shape = torch.broadcast_shapes(*(v.shape for v in vels))
        ill = torch.zeros(shape, dtype=torch.bool, device=a.device)
        axes = []
        for axis, (v, h, s) in enumerate(zip(vels, (geo.dx, geo.dy, geo.dz),
                                            starts)):
            n = a.shape[axis]
            view = [1, 1, 1]
            view[axis] = shape[axis]
            i = torch.arange(s, s + shape[axis], dtype=a.dtype,
                             device=a.device).reshape(view)
            dl = geo.dt * v / h
            # the second clamp keeps a non-finite departure point's index
            # in bounds (its value is NaN through t all the same)
            x = i - dl
            fl = torch.floor(x)
            i1 = torch.clamp(fl, 1, n).long().clamp(1, n)
            t = x - fl
            m = torch.round(dl)
            jump = torch.zeros_like(ill)
            if ulps:
                band = ulps * 2.0 ** (math.floor(math.log2(n)) - 23)
                jump = (((m >= 1) | ((m == 0) & (i == 1)))
                        & (torch.abs(dl - m) < band)).expand(shape)
                ill = ill | jump
            j1 = torch.clamp(torch.nan_to_num(i - m), 1, n).long()
            axes.append(tuple(torch.broadcast_to(q, shape) for q in (
                jump, i1, torch.clamp(i1 + 1, max=n), t, j1,
                torch.clamp(j1 + 1, max=n))))

        def trilinear(corners):
            (x1, x2, tx), (y1, y2, ty), (z1, z2, tz) = corners

            def lerp(p, q, t):
                return q * t + p * (1.0 - t)

            def at(i, j, k):
                return a[i - 1, j - 1, k - 1]

            fz1 = lerp(lerp(at(x1, y1, z1), at(x2, y1, z1), tx),
                       lerp(at(x1, y2, z1), at(x2, y2, z1), tx), ty)
            fz2 = lerp(lerp(at(x1, y1, z2), at(x2, y1, z2), tx),
                       lerp(at(x1, y2, z2), at(x2, y2, z2), tx), ty)
            return lerp(fz1, fz2, tz)

        vals = trilinear([(i1, i2, t) for _, i1, i2, t, _, _ in axes])
        lo, hi = vals.clone(), vals.clone()
        if bool(ill.any()):
            for side in range(8):
                f = trilinear([
                    (torch.where(jump, j1, i1), torch.where(jump, j2, i2),
                     torch.where(jump, float((side >> axis) & 1), t))
                    for axis, (jump, i1, i2, t, j1, j2) in enumerate(axes)])
                lo, hi = torch.minimum(lo, f), torch.maximum(hi, f)
        return vals, ill, lo, hi

    def advect(self, vx, vy, vz, c, ulps: float = 0.0):
        """The four branches (gpu.jl:308-332, Vz advected from its own
        snapshot), each from the post-BC snapshots: returns (vx, vy, vz,
        c, bounds) with bounds[field] = (ill, lo, hi) over the whole field
        (`_branch`; outside the branch's region ill is False and lo = hi
        = the value)."""
        def avg4(a, b, cc, d):
            return 0.25 * (a + b + cc + d)

        branches = {
            "vx": (vx, (vx[1:-1],
                        avg4(vy[:-1, :-1], vy[:-1, 1:], vy[1:, :-1],
                             vy[1:, 1:]),
                        avg4(vz[:-1, :, :-1], vz[:-1, :, 1:], vz[1:, :, :-1],
                             vz[1:, :, 1:])), (2, 1, 1)),
            "vy": (vy, (avg4(vx[:-1, :-1], vx[1:, :-1], vx[:-1, 1:],
                             vx[1:, 1:]),
                        vy[:, 1:-1],
                        avg4(vz[:, :-1, :-1], vz[:, :-1, 1:], vz[:, 1:, :-1],
                             vz[:, 1:, 1:])), (1, 2, 1)),
            "vz": (vz, (avg4(vx[:-1, :, :-1], vx[1:, :, :-1], vx[:-1, :, 1:],
                             vx[1:, :, 1:]),
                        avg4(vy[:, :-1, :-1], vy[:, 1:, :-1], vy[:, :-1, 1:],
                             vy[:, 1:, 1:]),
                        vz[:, :, 1:-1]), (1, 1, 2)),
            "c": (c, (0.5 * (vx[:-1] + vx[1:]), 0.5 * (vy[:, :-1] + vy[:, 1:]),
                      0.5 * (vz[:, :, :-1] + vz[:, :, 1:])), (1, 1, 1)),
        }
        out, bounds = {}, {}
        for name, (a, vels, starts) in branches.items():
            vals, bad, lo_r, hi_r = self._branch(a, vels, starts, ulps)
            region = tuple(slice(s - 1, s - 1 + n)
                           for s, n in zip(starts, vals.shape))
            new = a.clone()
            new[region] = vals
            ill = torch.zeros(a.shape, dtype=torch.bool, device=a.device)
            ill[region] = bad
            lo, hi = new.clone(), new.clone()
            lo[region], hi[region] = lo_r, hi_r
            out[name], bounds[name] = new, (ill, lo, hi)
        return out["vx"], out["vy"], out["vz"], out["c"], bounds

    # ---- whole steps ----

    def physical_pressure(self, pr, split: bool):
        """The physical pressure of a stored field: under the hydrostatic
        split the field stores Pr - P_static(z)."""
        if not split:
            return pr
        return pr + hydrostatic_profile(self.cfg, self.geo, pr.dtype,
                                        pr.device)[None, None, :]

    def step(self, state: Dict[str, torch.Tensor]
             ) -> Tuple[Dict[str, torch.Tensor], dict]:
        """The whole step in this reference's dtype from a state of
        physical fields (pr, vx, vy, vz, c, dprdtau): returns the new
        state and {iters, err}."""
        s = {k: self.t(v) for k, v in state.items()}
        vx, vy, vz, divv = self.predict(s["vx"], s["vy"], s["vz"])
        c = self.mask_tracer(s["c"])
        pr, iters, err = self.solve(s["pr"], s["dprdtau"], divv)
        vx, vy, vz = self.correct(vx, vy, vz, pr)
        vx, vy, vz, c, _ = self.advect(vx, vy, vz, c)
        return ({"pr": pr, "vx": vx, "vy": vy, "vz": vz, "c": c,
                 "dprdtau": s["dprdtau"]}, {"iters": iters, "err": err})

    def check_step(self, before: Dict[str, torch.Tensor],
                   after: Dict[str, torch.Tensor], ulps: float) -> dict:
        """The numbers by which the step `before` -> `after` (physical
        fields; `after["pr"]` the stored pressure, its low word added)
        departs from this reference:

          resid   max |lap(Pr) - rho/dt div V*| ly^2/psc over the interior,
                  Pr the program's pressure with the boundary planes this
                  reference sets from its interior, div V* this
                  reference's from `before`;
          p_gap   max |Pr - Pr*| / psc over the interior, Pr* the exact
                  solution of the discrete pressure equation for that
                  div V* (`exact_pressure`): how far the solve stopped
                  from convergence, which the residual's maximum, set by
                  the float32 predictor's rounding at the cylinder, does
                  not show;
          bc_gap  max |Pr - that Pr| over the boundary planes, over
                  max |Pr|;
          v_gap   max over vx, vy, vz of max |program - reference|, the
                  reference corrected with that Pr and advected, over the
                  largest |reference| velocity component; at the points
                  `_branch` calls ill the distance from [lo, hi] instead;
          c_gap   the same for the tracer, over max |reference C|;
          ill     the share of the points judged by [lo, hi];
          nonfinite  the number of non-finite values the program left.
        """
        b = {k: self.t(v) for k, v in before.items()}
        a = {k: self.t(v) for k, v in after.items()}
        nonfinite = sum(int((~torch.isfinite(a[k])).sum()) for k in FIELDS)
        vx, vy, vz, divv = self.predict(b["vx"], b["vy"], b["vz"])
        c = self.mask_tracer(b["c"])
        pr = self.set_bc_pr(a["pr"].clone())
        ring = torch.ones_like(pr, dtype=torch.bool)
        ring[1:-1, 1:-1, 1:-1] = False
        scale = float(torch.max(torch.abs(pr)))
        bc_gap = float(torch.max(torch.abs(a["pr"] - pr)[ring])) / max(
            scale, 1e-30)
        resid = float(torch.max(torch.abs(self.residual(pr, divv)))) * \
            self.err_scale()
        psc = self.cfg["rho"] * self.cfg["vin"] ** 2
        p_gap = float(torch.max(torch.abs(_interior(
            pr - self.exact_pressure(divv))))) / psc
        *new, bounds = self.advect(*self.correct(vx, vy, vz, pr), c,
                                   ulps=ulps)
        gaps, n_ill, n_all = {}, 0, 0
        for name, ref in zip(("vx", "vy", "vz", "c"), new):
            ill, lo, hi = bounds[name]
            p = a[name]
            n_ill += int(ill.sum())
            n_all += ill.numel()
            diff = torch.where(ill, torch.clamp(torch.maximum(p - hi, lo - p),
                                                min=0.0),
                               torch.abs(p - ref))
            gaps[name] = float(torch.max(diff))
        # the velocities' gaps over the flow's speed scale (a transverse
        # component can be all but zero), the tracer's over its own
        v_scale = max(float(torch.max(torch.abs(r))) for r in new[:3])
        c_scale = float(torch.max(torch.abs(new[3])))
        return {"resid": resid, "p_gap": p_gap, "bc_gap": bc_gap,
                "v_gap": max(gaps["vx"], gaps["vy"], gaps["vz"])
                / max(v_scale, 1e-30),
                "c_gap": gaps["c"] / max(c_scale, 1e-30),
                "ill": n_ill / n_all, "nonfinite": nonfinite}
