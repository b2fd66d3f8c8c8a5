"""K7's plain version (the Poisson iteration with the reference's BC
sequence applied in-kernel, compat mode's loop body) against the JAX
package's Pallas kernel in interpret mode, build_poisson_iter(...,
folded=False), built the way tests/test_pallas.py builds it. Three BC
specs: the multi variant's (x-lo zero-gradient, outlet 0), the unsplit gpu
variant's (hydrostatic Dirichlet planes on both x faces) and the split gpu
variant's (nonzero z constants). Inputs are seeded numpy arrays handed to
both packages.

Standards: XLA's CPU compilation of the interpreted kernel contracts
a*b + c into FMAs, which the plain version (and the CUDA kernel, built
with --fmad=false) does not, so in this process pr and dpr agree per
element within 4 ulp or 1e-6 of the field's max. With the contraction off
(XLA_FLAGS=--xla_cpu_max_isa=AVX, set in a child process because XLA
reads its flags once per process) the two are bitwise equal over 1 and 10
chained iterations. Against the reference's exact form (ph.poisson_iter,
which divides by dx twice where K7 multiplies by 1/dx^2, then set_bc_pr)
K7 agrees at the tolerances of tests/test_pallas.py:70-78."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import navierstokes3d_tpu as ns
from navierstokes3d_tpu.kernels.poisson import (build_poisson_iter,
                                                poisson_bc_spec as jspec)
from navierstokes3d_tpu.ops import physics as jph
import navierstokes3d_tpu_torch as nt
from navierstokes3d_tpu_torch import bc as tbc
from navierstokes3d_tpu_torch.kernels import poisson as kp

torch.set_num_threads(2)
NX = 12
NITER = 10
# (preset, pressure_split): the three BC specs K7 runs
SPECS = {"multi": ("multi", False), "gpu": ("gpu", False),
         "gpu split": ("gpu", True)}


def _setup(name):
    variant, split = SPECS[name]
    preset = nt.preset_multi if variant == "multi" else nt.preset_gpu
    cfg = preset(nx=NX, dtype="float32")
    grid = nt.make_grid(cfg)
    spec = kp.poisson_bc_spec(variant, grid, cfg.physics, split)
    return cfg, grid, spec, split


def _inputs(grid, seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    pr = (rng.standard_normal(grid.shape_c) * 50).astype(f)
    dpr = np.zeros(grid.shape_c, f)
    dpr[1:-1, 1:-1, 1:-1] = rng.standard_normal(
        (grid.nx - 2, grid.ny - 2, grid.nz - 2)) * 1e3
    rhs = (rng.standard_normal(grid.shape_c) * 1e5).astype(f)
    return pr, dpr, rhs


def _run_both(name, seed=1):
    """NITER chained iterations of the interpreted JAX kernel and of the
    plain version from the same inputs: {1: (jax, port), NITER: ...} with
    each side a (pr, dpr) pair of numpy arrays."""
    cfg, g, spec, split = _setup(name)
    it_fn, pack, unpack = build_poisson_iter(
        g.nx, g.ny, g.nz, g.dx, g.dy, g.dz, g.dtau, g.damp,
        jspec(cfg.variant, ns.make_grid(cfg), cfg.physics, split),
        dtype=jnp.float32, interpret=True)
    pr, dpr, rhs = _inputs(g, seed)
    pj, dj, rj = pack(*(jnp.asarray(a) for a in (pr, dpr, rhs)))
    step = jax.jit(lambda p, d: it_fn(p, d, rj)[:2])
    op = kp.make_bc_operator(spec, g, "cpu")
    p, d, r = (torch.tensor(a) for a in (pr, dpr, rhs))
    out = {}
    for i in range(1, NITER + 1):
        pj, dj = step(pj, dj)
        po, do = torch.empty_like(p), torch.empty_like(p)
        kp.poisson_iter_bc_plain(p, d, r, po, do, op)
        p, d = po, do
        if i in (1, NITER):
            out[i] = ([np.asarray(a) for a in unpack(pj, dj)],
                      [p.numpy(), d.numpy()])
    return out


@pytest.fixture(scope="module")
def runs():
    return {name: _run_both(name) for name in SPECS}


def _close(got, want, msg):
    """Per element within 4 ulp or 1e-6 of the field's max."""
    scale = np.abs(want).max()
    tol = np.maximum(4 * np.spacing(np.abs(want).astype(np.float32)),
                     1e-6 * scale)
    bad = np.abs(got.astype(np.float64) - want) > tol
    assert not bad.any(), (msg, np.abs(got - want).max(), scale)


def test_bc_spec_copy_matches_jax():
    """The port's copy of poisson_bc_spec builds the JAX package's specs."""
    for name in SPECS:
        cfg, g, spec, split = _setup(name)
        want = jspec(cfg.variant, ns.make_grid(cfg), cfg.physics, split)
        assert spec.zero_grad_x == want.zero_grad_x
        assert (spec.z_lo_add, spec.z_hi_add) == (want.z_lo_add,
                                                  want.z_hi_add)
        for a, b in ((spec.xlo_plane, want.xlo_plane),
                     (spec.xhi_plane, want.xhi_plane)):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
    assert _setup("gpu split")[2].z_lo_add != 0.0


@pytest.mark.parametrize("niter", [1, NITER])
@pytest.mark.parametrize("name", list(SPECS))
def test_k7_plain_matches_interpret_kernel(runs, name, niter):
    (pj, dj), (pt, dt) = runs[name][niter]
    _close(pt, pj, "pr")
    _close(dt, dj, "dpr")
    ring = np.ones(dt.shape, bool)
    ring[1:-1, 1:-1, 1:-1] = False
    assert (dt[ring] == 0).all() and (dj[ring] == 0).all()


@pytest.mark.parametrize("variant", ["multi", "gpu"])
def test_k7_matches_the_exact_form(variant):
    """One K7 iteration against ph.poisson_iter + set_bc_pr (the JAX
    package's functions, float32), at tests/test_pallas.py's tolerances;
    the dpr ring stays exactly 0."""
    cfg, g, spec, _ = _setup(variant)
    rng = np.random.default_rng(3)
    pr = rng.standard_normal(g.shape_c).astype(np.float32)
    dpr = np.zeros(g.shape_c, np.float32)
    dpr[1:-1, 1:-1, 1:-1] = rng.standard_normal(
        (g.nx - 2, g.ny - 2, g.nz - 2))
    divv = rng.standard_normal(g.shape_c).astype(np.float32)
    rho, dt = cfg.physics.rho, g.dt
    jcfg = (ns.preset_multi if variant == "multi" else ns.preset_gpu)(
        nx=NX, dtype="float32")
    set_bc_pr = ns.bc.make_bc_fns(jcfg, ns.make_grid(jcfg))[1]
    p1, d1 = jph.poisson_iter(jnp.asarray(pr), jnp.asarray(dpr),
                              jnp.asarray(divv), rho, dt, g.dtau, g.damp,
                              g.dx, g.dy, g.dz)
    p1, d1 = np.asarray(set_bc_pr(p1)), np.asarray(d1)
    op = kp.make_bc_operator(spec, g, "cpu")
    p2, d2 = torch.empty(g.shape_c), torch.empty(g.shape_c)
    kp.poisson_iter_bc_plain(torch.tensor(pr), torch.tensor(dpr),
                             (rho / dt) * torch.tensor(divv), p2, d2, op)
    scale = max(1.0, np.abs(p1).max())
    np.testing.assert_allclose(p2.numpy() / scale, p1 / scale, rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(d2.numpy(), d1, rtol=1e-4, atol=1e-3)
    ring = np.ones(g.shape_c, bool)
    ring[1:-1, 1:-1, 1:-1] = False
    assert (d2.numpy()[ring] == 0).all()


def test_k7_ring_takes_the_updated_source():
    """Every cell of both outputs is written; in the multi spec each ring
    cell is the UPDATED value at its clamped source (corner (0,0,0) is
    q(1,1,1)) and the outlet plane is 0; in the split gpu spec the z faces
    add their constants and the x planes are the Dirichlet values."""
    for name in ("multi", "gpu split"):
        _, g, spec, _ = _setup(name)
        op = kp.make_bc_operator(spec, g, "cpu")
        pr, dpr, rhs = (torch.tensor(a) for a in _inputs(g, 5))
        po = torch.full_like(pr, float("nan"))
        do = torch.full_like(pr, float("nan"))
        kp.poisson_iter_bc_plain(pr, dpr, rhs, po, do, op)
        assert bool(torch.isfinite(po).all() & torch.isfinite(do).all())
        q = pr + op.dtau * do   # the update, before the BC sequence
        if name == "multi":
            assert po[0, 0, 0] == q[1, 1, 1]
            assert po[0, 4, 0] == q[1, 4, 1]
            assert po[3, -1, -1] == q[3, -2, -2]
            assert bool((po[-1] == 0).all())
        else:
            lo = np.float32(op.z_lo_add)
            assert po[3, 0, 0] == np.float32(q[3, 1, 1]) + lo
            assert po[3, 4, 0] == np.float32(q[3, 4, 1]) + lo
            assert bool((po[0] == 100.0).all() & (po[-1] == 0.0).all())


def test_k7_planes_and_set_bc_pr_planes():
    """Each path keeps its own Dirichlet planes: K7's are the float64
    profile rounded once (the JAX kernel's lanes()), set_bc_pr's are
    hydrostatic_x's, evaluated in float32 as the JAX function does; the two
    agree within one ulp."""
    cfg, g, spec, _ = _setup("gpu")
    op = kp.make_bc_operator(spec, g, "cpu")
    want = np.asarray(spec.xlo_plane, np.float32).reshape(g.ny, g.nz)
    np.testing.assert_array_equal(op.xlo.numpy(), want)
    pr = torch.zeros(g.shape_c)
    po, do = torch.empty_like(pr), torch.empty_like(pr)
    kp.poisson_iter_bc_plain(pr, pr.clone(), pr.clone(), po, do, op)
    np.testing.assert_array_equal(po[0].numpy(), want)
    jcfg = ns.preset_gpu(nx=NX, dtype="float32")
    jpr = ns.bc.hydrostatic_x(jnp.zeros(g.shape_c, jnp.float32),
                              ns.make_grid(jcfg), cfg.physics.rho,
                              cfg.physics.g, inlet_head=100.0)
    tpr = tbc.hydrostatic_x(pr, g, cfg.physics.rho, cfg.physics.g,
                            inlet_head=100.0)
    np.testing.assert_array_equal(tpr.numpy(), np.asarray(jpr))
    for a, b in ((tpr[0], op.xlo), (tpr[-1], op.xhi)):
        ulp = np.abs(a.numpy().view(np.int32) - b.numpy().view(np.int32))
        assert ulp.max() <= 1


def _child_bitwise_report():
    out = {}
    for name in SPECS:
        res = _run_both(name)
        out[name] = {str(i): all(np.array_equal(a, b)
                                 for a, b in zip(*res[i])) for i in res}
    return out


def test_plain_version_bitwise_without_fma():
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
    for name in SPECS:
        assert report[name] == {"1": True, str(NITER): True}, (name, report)


if __name__ == "__main__" and sys.argv[1:] == ["--bitwise"]:
    jax.config.update("jax_platforms", "cpu")
    print(json.dumps(_child_bitwise_report()))
