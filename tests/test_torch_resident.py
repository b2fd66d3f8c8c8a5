"""K10's plain version (`poisson_iter_resident_plain`, behind
`make_resident`) and `pt_loop_fused(seed0=True)` against K1's plain
version and the JAX package:

  1. make_resident(nit) is bitwise nit poisson_iter_plain calls (the last
     one flagged): pr and dpr updated in the caller's tensors, the check
     value that of the state entering the last iteration;
  2. against the JAX package's `make_resident` in interpret mode at
     tests/test_pallas.py:208-262's shapes (20x6x6, slab 5, x-lo
     zero-gradient), nit in {1, 2, 5}: bitwise;
  3. the composition of tests/test_pallas.py:263-304: a resident pre-call
     of nit = nchk feeding the seeded loop reproduces the unseeded K1
     loop's (iters, err, hist) and fields, in the port (bitwise) and
     against the JAX composition (bitwise).

The JAX side runs in a child process with XLA's FMA contraction off
(XLA_FLAGS=--xla_cpu_max_isa=AVX): with it on, the interpreted kernels
differ from the plain versions by an ulp (tests/test_torch_sweeps.py)."""

import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from navierstokes3d_tpu_torch.kernels import poisson as kp
from navierstokes3d_tpu_torch.ptloop import pt_loop_fused

torch.set_num_threads(2)
SHAPE = (20, 6, 6)
H, DTAU, DAMP = 0.1, 0.01, 0.9
NITS = (1, 2, 5)
NCHK, NCHUNKS, EPS = 4, 6, 1e-4


def _operator(zero_grad_x=True):
    nx, ny, nz = SHAPE
    m = {k: np.ones(n - 2) for k, n in zip(("xm", "xp", "ym", "yp", "zm",
                                            "zp"), (nx, nx, ny, ny, nz, nz))}
    m["ym"][0] = m["yp"][-1] = m["zm"][0] = m["zp"][-1] = 0.0
    if zero_grad_x:
        m["xm"][0] = 0.0
    grid = types.SimpleNamespace(dx=H, dy=H, dz=H, dtau=DTAU, damp=DAMP)
    return kp.make_operator(m, grid, torch.float32, "cpu")


def _inputs():
    """tests/test_pallas.py:232-238's inputs."""
    nx, ny, nz = SHAPE
    rng = np.random.default_rng(7)
    pr = rng.standard_normal(SHAPE).astype(np.float32)
    dpr = np.zeros(SHAPE, np.float32)
    dpr[1:-1, 1:-1, 1:-1] = rng.standard_normal((nx - 2, ny - 2, nz - 2))
    rhs = rng.standard_normal(SHAPE).astype(np.float32)
    return pr, dpr, rhs


def _loop_inputs():
    """tests/test_pallas.py:283-287's inputs (seed 13)."""
    rng = np.random.default_rng(13)
    pr = (0.01 * rng.standard_normal(SHAPE)).astype(np.float32)
    rhs = (0.01 * rng.standard_normal(SHAPE)).astype(np.float32)
    return pr, np.zeros(SHAPE, np.float32), rhs


def _jax_reference(out_path):
    """The JAX side (run in the child): make_resident per nit, and the
    seeded and unseeded loops of tests/test_pallas.py:263-304."""
    import jax
    import jax.numpy as jnp
    from navierstokes3d_tpu.kernels.poisson import (PoissonBCSpec,
                                                    build_poisson_iter)
    from navierstokes3d_tpu.ptloop import pt_loop_fused as jloop
    jax.config.update("jax_platforms", "cpu")
    nx, ny, nz = SHAPE
    it, pack, unpack = build_poisson_iter(
        nx, ny, nz, H, H, H, dtau=DTAU, damp=DAMP,
        bc=PoissonBCSpec(True, None, np.zeros(ny * nz)), dtype=jnp.float32,
        slab=5, interpret=True, mode="blocked", folded=True)
    out = {}
    pp, df, rf = pack(*map(jnp.asarray, _inputs()))
    for nit in NITS:
        p, d, e = jax.jit(it.make_resident(nit))(pp, df, rf)
        p, d = unpack(p, d)
        out.update({f"res{nit}_pr": p, f"res{nit}_dpr": d,
                    f"res{nit}_err": jnp.reshape(e, ())})
    pp, df, rf = pack(*map(jnp.asarray, _loop_inputs()))
    res = it.make_resident(NCHK)

    def step_fn(carry, i):
        p, d = carry
        p, d, ec = it(p, d, rf, ((i + 1) % NCHK) == 0)
        return (p, d), jnp.max(ec), jnp.int32(1)

    def unseeded():
        return jloop(step_fn, (pp, df), 0, NCHUNKS * NCHK, NCHK, NCHUNKS,
                     eps_it=EPS, dtype=jnp.float32)

    def seeded():
        p, d, ec = res(pp, df, rf)
        return jloop(step_fn, (p, d), NCHK, NCHUNKS * NCHK, NCHK, NCHUNKS,
                     eps_it=EPS, dtype=jnp.float32, err0=ec, seed0=True)

    for name, fn in (("unseeded", unseeded), ("seeded", seeded)):
        (p, d), iters, err, hist = jax.jit(fn)()
        p, d = unpack(p, d)
        out.update({f"{name}_pr": p, f"{name}_dpr": d,
                    f"{name}_iters": iters, f"{name}_err": err,
                    f"{name}_hist": hist})
    np.savez(out_path, **{k: np.asarray(v) for k, v in out.items()})


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("resident") / "jax.npz"
    repo = Path(__file__).resolve().parent.parent
    pp = os.pathsep.join(p for p in (str(repo), os.environ.get("PYTHONPATH"))
                         if p)
    env = dict(os.environ, XLA_FLAGS="--xla_cpu_max_isa=AVX",
               JAX_PLATFORMS="cpu", PYTHONPATH=pp)
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--jax", str(path)],
        capture_output=True, text=True, timeout=600, env=env, cwd=repo)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(path))


def _k1_chain(pr, dpr, rhs, op, nit):
    """nit poisson_iter_plain calls, the last flagged."""
    p, d = pr.clone(), dpr.clone()
    for j in range(nit):
        q = torch.empty_like(p)
        e = kp.poisson_iter_plain(p, q, d, rhs, op, j == nit - 1)
        p = q
    return p, d, e


@pytest.mark.parametrize("nit", (1, 2, 5, 8))
@pytest.mark.parametrize("zero_grad_x", (True, False))
def test_resident_is_k1_chain(nit, zero_grad_x):
    op = _operator(zero_grad_x)
    pr, dpr, rhs = (torch.tensor(a) for a in _inputs())
    want = _k1_chain(pr, dpr, rhs, op, nit)
    p, d = pr.clone(), dpr.clone()
    kp.poisson_iter_resident_plain.calls = 0
    p_out, d_out, e = kp.make_resident(nit)(p, d, rhs, op)
    assert kp.poisson_iter_resident_plain.calls == 1
    # the result lands in the caller's tensors
    assert p_out is p and d_out is d
    assert torch.equal(p, want[0]) and torch.equal(d, want[1])
    assert e.shape == () and float(e) == float(want[2])


def test_resident_rejects_no_iterations():
    with pytest.raises(ValueError, match="nit"):
        kp.make_resident(0)
    pr = torch.zeros(SHAPE)
    with pytest.raises(ValueError, match="nit"):
        kp.poisson_iter_resident(pr, pr.clone(), pr.clone(), _operator(), 0)


@pytest.mark.parametrize("nit", NITS)
def test_resident_matches_jax(jax_ref, nit):
    pr, dpr, rhs = (torch.tensor(a) for a in _inputs())
    _, _, e = kp.make_resident(nit)(pr, dpr, rhs, _operator())
    np.testing.assert_array_equal(pr.numpy(), jax_ref[f"res{nit}_pr"])
    np.testing.assert_array_equal(dpr.numpy(), jax_ref[f"res{nit}_dpr"])
    assert np.float32(e) == jax_ref[f"res{nit}_err"]


def _port_loops():
    op = _operator()
    pr0, dpr0, rhs = (torch.tensor(a) for a in _loop_inputs())

    def step_fn(carry, it):
        p_in, p_out, d = carry
        e = kp.poisson_iter_plain(p_in, p_out, d, rhs, op,
                                  (it + 1) % NCHK == 0)
        return (p_out, p_in, d), e, 1

    def run(seed0):
        p, d = pr0.clone(), dpr0.clone()
        it0, err0 = 0, None
        if seed0:
            p, d, err0 = kp.make_resident(NCHK)(p, d, rhs, op)
            it0 = NCHK
        (p, _, d), iters, err, hist = pt_loop_fused(
            step_fn, (p, torch.empty_like(p), d), it0, NCHUNKS * NCHK, NCHK,
            NCHUNKS, EPS, torch.float32, err0=err0, seed0=seed0)
        return p, d, iters, err, hist
    return run(False), run(True)


def test_seeded_loop_is_unseeded_loop():
    (p1, d1, i1, e1, h1), (p2, d2, i2, e2, h2) = _port_loops()
    assert i1 > NCHK and np.isfinite(h1).all()
    assert i1 == i2 and e1 == e2
    np.testing.assert_array_equal(h1, h2)
    assert torch.equal(p1, p2) and torch.equal(d1, d2)


def test_seeded_loop_matches_jax_composition(jax_ref):
    for name, (p, d, iters, err, hist) in zip(("unseeded", "seeded"),
                                              _port_loops()):
        assert iters == int(jax_ref[f"{name}_iters"]), name
        assert err == jax_ref[f"{name}_err"], name
        np.testing.assert_array_equal(hist, jax_ref[f"{name}_hist"])
        np.testing.assert_array_equal(p.numpy(), jax_ref[f"{name}_pr"])
        np.testing.assert_array_equal(d.numpy(), jax_ref[f"{name}_dpr"])


if __name__ == "__main__" and sys.argv[1:2] == ["--jax"]:
    _jax_reference(sys.argv[2])
