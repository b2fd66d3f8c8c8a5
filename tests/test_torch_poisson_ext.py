"""K2's plain version (the double-single Poisson iteration) and K1's plain
version with the multi variant's operator against the JAX package's
Pallas kernels in interpret mode: the solver's own `_pallas_ext` and
`_pallas` (build_poisson_iter(..., folded=True, extended=True/False)) of
a ChorinSolver(preset_multi(nx=15, float32, compat=False)) with
use_pallas=True. Inputs are seeded numpy arrays handed to both packages.

Standard (docs/numerics.md "Cross-program rounding"): XLA's CPU
compilation of the interpreted kernels contracts a*b + c into FMAs, which
the plain versions (and the CUDA kernels, built with --fmad=false) do
not, so hi, hi + lo (in float64), dpr and the check value agree per
element within 4 ulp or 1e-6 of the field's max; lo alone is
rounding-level (a 1-ulp move of hi shifts it by the same amount). With
the contraction off (XLA_FLAGS=--xla_cpu_max_isa=AVX, set in a child
process because XLA reads its flags once per process) the interpreted
kernels and the plain versions are bitwise equal."""

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
import navierstokes3d_tpu_torch as nt
from navierstokes3d_tpu_torch.kernels import poisson as kp

torch.set_num_threads(2)
NX = 15
NITER = 10


def _solvers():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NS3D_FUSED_INTERPRET", "1")
        js = ns.ChorinSolver(ns.preset_multi(
            nx=NX, compat=False, dtype="float32").replace(use_pallas=True))
    assert js._pallas_ext is not None and js._pallas_folded
    ts = nt.ChorinSolver(nt.preset_multi(nx=NX, compat=False,
                                         dtype="float32"), device="cpu")
    return js, ts


def _inputs(ts, seed=1):
    """A pressure pair with the multi BCs applied (as the solve leaves
    it), lo at the rounding level of hi, a zero-ring dpr and a RHS."""
    g, rng = ts.grid, np.random.default_rng(seed)
    hi = ts.set_bc_pr(torch.tensor(
        rng.standard_normal(g.shape_c).astype(np.float32) * 50))
    lo = torch.tensor(rng.standard_normal(g.shape_c).astype(np.float32)
                      * 50 * 2.0 ** -24)
    dpr = torch.zeros(g.shape_c)
    dpr[1:-1, 1:-1, 1:-1] = torch.tensor(rng.standard_normal(
        (g.nx - 2, g.ny - 2, g.nz - 2)).astype(np.float32) * 1e3)
    rhs = torch.tensor(rng.standard_normal(g.shape_c).astype(np.float32)
                       * 1e5)
    return hi, lo, dpr, rhs


def _run_both(js, ts, niter, ext):
    """niter chained iterations, every one checked, in both packages:
    (JAX fields, port fields, JAX checks, port checks)."""
    hi, lo, dpr, rhs = _inputs(ts)
    J = jnp.asarray
    if ext:
        it_fn, pack, unpack = js._pallas_ext
        hf, _, df, rf = pack(J(hi.numpy()), J(dpr.numpy()), J(rhs.numpy()))
        lf = pack(J(lo.numpy()), J(dpr.numpy()), J(rhs.numpy()))[0]
        carry_j = (hf, lf, df)
        carry_t = (hi.clone(), lo.clone(), torch.empty_like(hi),
                   torch.empty_like(hi), dpr.clone())
    else:
        it_fn, pack, unpack = js._pallas
        carry_j = pack(J(hi.numpy()), J(dpr.numpy()), J(rhs.numpy()))[:2]
        rf = pack(J(hi.numpy()), J(dpr.numpy()), J(rhs.numpy()))[2]
        carry_t = (hi.clone(), torch.empty_like(hi), dpr.clone())
    step = jax.jit(it_fn)
    ej, et = [], []
    for _ in range(niter):
        *carry_j, e = step(*carry_j, rf, True)
        ej.append(float(np.max(e)))
        if ext:
            h, lw, ho, lwo, d = carry_t
            et.append(float(kp.poisson_iter_ext(h, lw, ho, lwo, d, rhs,
                                                ts._op, True)))
            carry_t = (ho, lwo, h, lw, d)
        else:
            p, po, d = carry_t
            et.append(float(kp.poisson_iter(p, po, d, rhs, ts._op, True)))
            carry_t = (po, p, d)
    want = [np.asarray(a) for a in unpack(*carry_j)]
    got = ([carry_t[0], carry_t[1], carry_t[4]] if ext
           else [carry_t[0], carry_t[2]])
    return want, [t.numpy() for t in got], ej, et


def _close(got, want, msg):
    """Per element within 4 ulp or 1e-6 of the field's max."""
    scale = np.abs(want).max()
    tol = np.maximum(4 * np.spacing(np.abs(want).astype(np.float32)),
                     1e-6 * scale)
    bad = np.abs(got.astype(np.float64) - want) > tol
    assert not bad.any(), (msg, np.abs(got - want).max(), scale)


@pytest.mark.parametrize("niter", [1, NITER])
def test_k2_plain_matches_interpret_kernel(niter):
    js, ts = _solvers()
    (hj, lj, dj), (ht, lt, dt), ej, et = _run_both(js, ts, niter, ext=True)
    _close(ht, hj, "hi")
    _close(ht.astype(np.float64) + lt, hj.astype(np.float64) + lj, "hi+lo")
    _close(dt, dj, "dpr")
    np.testing.assert_allclose(et, ej, rtol=1e-6)
    # lo stays at the rounding level of hi (the two_sum renormalizes)
    assert np.abs(lt).max() <= np.spacing(np.float32(np.abs(ht).max()))


@pytest.mark.parametrize("niter", [1, NITER])
def test_k1_multi_operator_matches_interpret_kernel(niter):
    js, ts = _solvers()
    assert ts._op.zero_grad_x
    (pj, dj), (pt, dt), ej, et = _run_both(js, ts, niter, ext=False)
    _close(pt, pj, "pr")
    _close(dt, dj, "dpr")
    np.testing.assert_allclose(et, ej, rtol=1e-6)


def test_k2_writes_every_cell_and_keeps_the_pair():
    """Every cell of both outputs is written, dpr's ring is 0, and off
    the interior the pair is renormalized: hi + lo keeps its exact value
    there (two_sum is error-free)."""
    _, ts = _solvers()
    hi, lo, dpr, rhs = _inputs(ts, seed=3)
    ho = torch.full_like(hi, float("nan"))
    lo_o = torch.full_like(hi, float("nan"))
    kp.poisson_iter_ext(hi, lo, ho, lo_o, dpr, rhs, ts._op, False)
    assert bool(torch.isfinite(ho).all() & torch.isfinite(lo_o).all())
    ring = torch.ones_like(hi, dtype=torch.bool)
    ring[1:-1, 1:-1, 1:-1] = False
    assert bool((dpr[ring] == 0).all())
    pair = hi.double() + lo.double()
    np.testing.assert_array_equal((ho.double() + lo_o.double())[ring],
                                  pair[ring])


def test_k1_zero_grad_x_drops_the_inlet_neighbor():
    """With x-lo zero-gradient the first interior plane reads no x-1
    neighbor: changing the inlet plane (x = 0) changes nothing."""
    _, ts = _solvers()
    hi, _, dpr, rhs = _inputs(ts, seed=4)
    other = hi.clone()
    other[0] += 1e3
    outs = []
    for p in (hi, other):
        out, d = torch.empty_like(p), dpr.clone()
        outs.append((out, d, kp.poisson_iter(p, out, d, rhs, ts._op, True)))
    (a, da, ea), (b, db, eb) = outs
    assert torch.equal(a[1:], b[1:]) and torch.equal(da, db)
    assert float(ea) == float(eb)


def _child_bitwise_report():
    """Run in a child process with XLA's FMA contraction off: the plain
    versions against the interpreted kernels over NITER iterations."""
    js, ts = _solvers()
    out = {}
    for ext in (True, False):
        want, got, ej, et = _run_both(js, ts, NITER, ext)
        out["K2" if ext else "K1"] = {
            "fields_equal": all(np.array_equal(g, w)
                                for g, w in zip(got, want)),
            "checks_equal": ej == et}
    return out


def test_plain_versions_bitwise_without_fma():
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
    for name in ("K1", "K2"):
        assert report[name] == {"fields_equal": True,
                                "checks_equal": True}, (name, report)


if __name__ == "__main__" and sys.argv[1:] == ["--bitwise"]:
    jax.config.update("jax_platforms", "cpu")
    print(json.dumps(_child_bitwise_report()))
