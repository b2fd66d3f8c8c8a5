"""K8's plain version (s folded iterations per launch) and the port's
kernels at the shapes where the JAX package lane-tiles its own, against
the JAX package's Pallas kernels in interpret mode:

  1. K8 against the lane-tiled s-sweep (`sweep_fns[s]`, lane_tiles=3,
     sweep_depth=4, as tests/test_pallas.py:576-613 builds it), s = 2, 3,
     4, with x-lo zero-gradient (the multi operator) and Dirichlet (gpu);
  2. K8 at s = 2 against the untiled two-sweep (`sweep2`, mrows 1 and 2);
  3. K8's plain version bitwise equal to s calls of K1's;
  4. K1 against the lane-tiled iteration K9a (lane_tiles=3);
  5. K3, K4 and K5 against the lane-tiled K3t, K4t and K5t
     (CommonLayout(..., lane_tiles=3) passed to build_predict,
     build_correct and build_advect_flat).

Standards: XLA's CPU compilation of the interpreted kernels contracts
a*b + c into FMAs, which the plain versions (and the CUDA kernels, built
with --fmad=false) do not, so in this process the Poisson fields agree to
tests/test_torch_poisson.py's atol 1e-6 of max|field| and the emitted
residuals to rtol 1e-6; with the contraction off
(XLA_FLAGS=--xla_cpu_max_isa=AVX, in a child process because XLA reads
its flags once per process) fields and residuals are bitwise equal. K3-K5
are held to tests/test_torch_fused_step.py's and test_torch_advect.py's
per-element standard (4 ulp, or 1e-6 of max|field|; K3's divergence to
its rounding bound), with equal clamp counts."""

import functools
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import navierstokes3d_tpu as ns
from navierstokes3d_tpu.kernels.advect import build_advect_flat
from navierstokes3d_tpu.kernels.fused_step import (CommonLayout, build_correct,
                                                   build_predict)
from navierstokes3d_tpu.kernels.poisson import (PoissonBCSpec,
                                                build_poisson_iter)
import navierstokes3d_tpu_torch as nt
from navierstokes3d_tpu_torch.kernels import advect as ka
from navierstokes3d_tpu_torch.kernels import fused_step as kf
from navierstokes3d_tpu_torch.kernels import poisson as kp

torch.set_num_threads(2)
SHAPE = (20, 20, 18)
H = 0.1
DTAU, DAMP = 0.01, 0.9


def _bc(zero_grad_x, ny, nz):
    if zero_grad_x:
        return PoissonBCSpec(True, None, np.zeros(ny * nz))
    return PoissonBCSpec(False, np.full(ny * nz, 2.0), np.zeros(ny * nz))


def _operator(shape, zero_grad_x):
    """The port's folded operator for the JAX kernel's BC spec: y and z
    zero-gradient at both ends, x-lo zero-gradient or Dirichlet, x-hi
    Dirichlet."""
    nx, ny, nz = shape
    m = {k: np.ones(n - 2) for k, n in zip(("xm", "xp", "ym", "yp", "zm",
                                            "zp"), (nx, nx, ny, ny, nz, nz))}
    m["ym"][0] = m["yp"][-1] = m["zm"][0] = m["zp"][-1] = 0.0
    if zero_grad_x:
        m["xm"][0] = 0.0
    grid = types.SimpleNamespace(dx=H, dy=H, dz=H, dtau=DTAU, damp=DAMP)
    return kp.make_operator(m, grid, torch.float32, "cpu")


def _inputs(shape, seed):
    """Seeded pr, dpr (zero ring) and rhs, float32 numpy."""
    rng = np.random.default_rng(seed)
    nx, ny, nz = shape
    pr = rng.standard_normal(shape).astype(np.float32)
    dpr = np.zeros(shape, np.float32)
    dpr[1:-1, 1:-1, 1:-1] = rng.standard_normal((nx - 2, ny - 2, nz - 2))
    rhs = rng.standard_normal(shape).astype(np.float32)
    return pr, dpr, rhs


@functools.lru_cache(maxsize=None)
def _jax_iter(shape, zero_grad_x, slab=None, mrows=None, lane_tiles=None,
              sweep_depth=None):
    return build_poisson_iter(
        *shape, H, H, H, dtau=DTAU, damp=DAMP,
        bc=_bc(zero_grad_x, *shape[1:]), dtype=jnp.float32, slab=slab,
        interpret=True, mode="blocked", folded=True, mrows=mrows,
        lane_tiles=lane_tiles, sweep_depth=sweep_depth)


def _port_sweeps(shape, zero_grad_x, s, inputs):
    pr, dpr, rhs = (torch.tensor(a) for a in inputs)
    po, do = torch.empty_like(pr), torch.empty_like(pr)
    e = kp.poisson_iter_sweeps(pr, dpr, rhs, po, do,
                               _operator(shape, zero_grad_x), s, True)
    return po.numpy(), do.numpy(), float(e)


# each case: ((jax pr, jax dpr, jax residual), (port pr, port dpr, port
# residual)), the residual that of the state entering the last iteration

def case_tiled_sweep(s, zero_grad_x):
    """1: the lane-tiled s-sweep kernel (K8a)."""
    it, pack, unpack = _jax_iter(SHAPE, zero_grad_x, slab=5, mrows=2,
                                 lane_tiles=3, sweep_depth=4)
    assert it.lane_tiles == 3 and s in it.sweep_fns
    inputs = _inputs(SHAPE, 9)
    pp, df, rf = pack(*(jnp.asarray(a) for a in inputs))
    p, d, e = it.sweep_fns[s](pp, df, rf, do_chk=1)
    want = [np.asarray(a) for a in unpack(p, d)] + [float(np.max(e))]
    return want, _port_sweeps(SHAPE, zero_grad_x, s, inputs)


def case_sweep2(mrows, zero_grad_x):
    """2: the untiled two-sweep kernel (K8b)."""
    it, pack, unpack = _jax_iter(SHAPE, zero_grad_x, slab=5, mrows=mrows)
    assert it.lane_tiles == 1 and hasattr(it, "sweep2")
    inputs = _inputs(SHAPE, 5)
    pp, df, rf = pack(*(jnp.asarray(a) for a in inputs))
    p, d, e = jax.jit(lambda p, d: it.sweep2(p, d, rf, True))(pp, df)
    want = [np.asarray(a) for a in unpack(p, d)] + [float(np.max(e))]
    return want, _port_sweeps(SHAPE, zero_grad_x, 2, inputs)


def case_tiled_iter(zero_grad_x, niter=3):
    """4: niter calls of the lane-tiled iteration (K9a) against K1, the
    check on every one (the last residual is returned)."""
    shape = (24, 20, 18)
    it, pack, unpack = _jax_iter(shape, zero_grad_x, mrows=1, lane_tiles=3)
    assert it.lane_tiles == 3
    inputs = _inputs(shape, 7)
    pp, df, rf = pack(*(jnp.asarray(a) for a in inputs))
    pr, dpr, rhs = (torch.tensor(a) for a in inputs)
    op, out = _operator(shape, zero_grad_x), torch.empty_like(pr)
    step = jax.jit(lambda p, d: it(p, d, rf, do_chk=1))
    for _ in range(niter):
        pp, df, ej = step(pp, df)
        et = kp.poisson_iter(pr, out, dpr, rhs, op, True)
        pr, out = out, pr
    want = [np.asarray(a) for a in unpack(pp, df)] + [float(np.max(ej))]
    return want, (pr.numpy(), dpr.numpy(), float(et))


POISSON_CASES = {
    **{f"tiled_sweep s={s} zero_grad_x={z}":
       functools.partial(case_tiled_sweep, s, z)
       for s in (2, 3, 4) for z in (True, False)},
    **{f"sweep2 mrows={m} zero_grad_x={z}":
       functools.partial(case_sweep2, m, z)
       for m in (1, 2) for z in (True, False)},
    **{f"tiled_iter zero_grad_x={z}": functools.partial(case_tiled_iter, z)
       for z in (True, False)},
}


def _close(got, want, msg):
    """atol 1e-6 of the field's max (tests/test_torch_poisson.py)."""
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=1e-6,
                               err_msg=msg)


@pytest.mark.parametrize("name", sorted(POISSON_CASES))
def test_poisson_kernels_match_interpret(name):
    (pj, dj, ej), (pt, dt, et) = POISSON_CASES[name]()
    _close(pt, pj, f"{name}: pr")
    _close(dt, dj, f"{name}: dpr")
    np.testing.assert_allclose(et, ej, rtol=1e-6, err_msg=f"{name}: resid")


@pytest.mark.parametrize("s", [2, 3, 4])
def test_k8_plain_is_k1_plain_s_times(s):
    """3: bitwise, the check value included; and dpr's ring stays 0."""
    for zero_grad_x in (True, False):
        op = _operator(SHAPE, zero_grad_x)
        pr, dpr, rhs = (torch.tensor(a) for a in _inputs(SHAPE, 3))
        po = torch.full_like(pr, float("nan"))
        do = torch.full_like(pr, float("nan"))
        e8 = kp.poisson_iter_sweeps_plain(pr, dpr, rhs, po, do, op, s, True)
        p, d, e1 = pr.clone(), dpr.clone(), None
        for j in range(s):
            q = torch.empty_like(pr)
            e1 = kp.poisson_iter_plain(p, q, d, rhs, op, j == s - 1)
            p = q
        assert torch.equal(po, p) and torch.equal(do, d)
        assert float(e8) == float(e1)
        ring = torch.ones_like(pr, dtype=torch.bool)
        ring[1:-1, 1:-1, 1:-1] = False
        assert bool((do[ring] == 0).all())


def test_k8_refuses_aliases_and_depths():
    op = _operator(SHAPE, False)
    pr, dpr, rhs = (torch.tensor(a) for a in _inputs(SHAPE, 4))
    out = torch.empty_like(pr)
    for s in (1, 5):
        with pytest.raises(ValueError, match="2 <= s"):
            kp.poisson_iter_sweeps(pr, dpr, rhs, out, out.clone(), op, s,
                                   False)


def test_poisson_kernels_bitwise_without_fma():
    repo = Path(__file__).resolve().parent.parent
    path = os.pathsep.join(p for p in (str(repo),
                                       os.environ.get("PYTHONPATH")) if p)
    env = dict(os.environ, XLA_FLAGS="--xla_cpu_max_isa=AVX",
               JAX_PLATFORMS="cpu", PYTHONPATH=path)
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--bitwise"],
        capture_output=True, text=True, timeout=600, env=env, cwd=repo)
    assert proc.returncode == 0, proc.stderr[-3000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(report) == set(POISSON_CASES)
    for name, equal in report.items():
        assert equal == {"pr": True, "dpr": True, "resid": True}, name


# ---- K3t, K4t and K5t ----

def _step_setup(nx):
    js = ns.ChorinSolver(ns.preset_gpu(nx=nx, nt=1, compat=False,
                                       dtype="float32"))
    ts = nt.ChorinSolver(nt.preset_gpu(nx=nx, nt=1, compat=False,
                                       dtype="float32"), device="cpu")
    return js, ts


def _fields(shapes, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) * scale for s in shapes]


def _close_ulp(got, want, msg):
    """Per element within 4 ulp, or 1e-6 of the field's max."""
    for a, b in zip(got, want):
        a, b = a.numpy(), np.asarray(b)
        ok = np.abs(a - b) <= np.maximum(
            4 * np.spacing(np.abs(b).astype(np.float32)),
            1e-6 * np.abs(b).max())
        assert ok.all(), (msg, np.abs(a - b).max())


def test_k3_k4_match_lane_tiled_kernels():
    js, ts = _step_setup(24)
    g, phys = js.grid, js.cfg.physics
    lay = CommonLayout(g.nx, g.ny, g.nz, lane_tiles=3)
    assert lay.T == 3
    vx, vy, vz, pr = _fields((g.shape_vx, g.shape_vy, g.shape_vz,
                              g.shape_c), 5)
    pf = build_predict(g.nx, g.ny, g.nz, dt=g.dt, dx=g.dx, dy=g.dy, dz=g.dz,
                       mu=phys.mu, rho=phys.rho, g_eff=0.0, masks=js.masks,
                       interpret=True, layout=lay)
    want = jax.jit(pf)(*map(jnp.asarray, (vx, vy, vz)))
    got = kf.predict(*map(torch.tensor, (vx, vy, vz)), ts.masks, ts._consts)
    _close_ulp(got[:3], want[:3], "K3t velocities")
    # the divergence of nearly cancelling fluxes: its rounding bound
    # (tests/test_torch_fused_step.py)
    scale = np.abs(np.asarray(want[3])).max()
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                               rtol=1e-5, atol=8 * 1.2e-7 * scale)
    cf = build_correct(g.nx, g.ny, g.nz, dt=g.dt, dx=g.dx, dy=g.dy, dz=g.dz,
                       rho=phys.rho, masks=js.masks, interpret=True,
                       variant="gpu", vin=phys.vin, layout=lay)
    want = jax.jit(cf)(*map(jnp.asarray, (vx, vy, vz, pr)))
    got = kf.correct(*map(torch.tensor, (vx, vy, vz, pr)), ts.masks,
                     ts._consts)
    _close_ulp(got, want, "K4t")


@pytest.mark.parametrize("dims,dt,scale,clamps", [
    ((17, 9, 9), 0.9, 0.5, False),
    ((16, 8, 8), 1.0, 3.0, True),
])
def test_k5_matches_lane_tiled_kernel(dims, dt, scale, clamps):
    nx, ny, nz = dims
    dx, dy, dz = 1.0, 1.1, 0.95
    fields = _fields(((nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1)),
                     0, scale)
    fields.append(np.random.default_rng(1).uniform(
        size=dims).astype(np.float32))
    lay = CommonLayout(nx, ny, nz, lane_tiles=3, halo_k=3)
    assert lay.T == 3
    kern = build_advect_flat(nx, ny, nz, dt, dx, dy, dz, k=2,
                             dtype=jnp.float32, interpret=True, layout=lay)
    want = jax.jit(kern.on3d)(*map(jnp.asarray, fields))
    consts = kf.StepConsts(dt=dt, dx=dx, dy=dy, dz=dz, mu=0.0, rho=1.0,
                           g_eff=0.0, variant="gpu", vin=1.0)
    got = ka.advect(*map(torch.tensor, fields), consts, 2)
    _close_ulp(got[:4], want[:4], "K5t")
    n = int(got[4].item())
    assert n == int(want[4])
    assert (n > 0) == clamps


def _child_bitwise_report():
    out = {}
    for name, case in POISSON_CASES.items():
        (pj, dj, ej), (pt, dt, et) = case()
        out[name] = {"pr": bool(np.array_equal(pt, pj)),
                     "dpr": bool(np.array_equal(dt, dj)),
                     "resid": et == ej}
    return out


if __name__ == "__main__" and sys.argv[1:] == ["--bitwise"]:
    jax.config.update("jax_platforms", "cpu")
    print(json.dumps(_child_bitwise_report()))
