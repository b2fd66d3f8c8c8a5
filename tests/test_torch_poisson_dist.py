"""K7-dist's and K2-dist's plain versions (one x-shard of the distributed
Poisson solve) against the JAX package's Pallas kernel built for a shard,
build_poisson_iter(..., local_rows=bx, interpret=True), on the first,
middle and last shard of an x-decomposed grid (12x8x10 over 3 shards, and
the 2-plane shards of 6), for the multi, unsplit gpu and split gpu BC
specs. Inputs are seeded numpy arrays handed to both packages; the JAX
side gets its operands as parallel/halo.py's `face_rows` gives them (the
-x neighbour's last plane as the halo operand, the +x neighbour's first
plane in ghost row bx, zeros at the open faces, x_off = shard * bx).

Standards: in this process XLA's CPU compilation contracts a*b + c into
FMAs, which the plain versions (and the CUDA kernels, built with
--fmad=false) do not: fields agree per element within 4 ulp or 1e-6 of
the field's max (K2-dist's pair as the float64 sum hi + lo, whose lo word
is hi's rounding error and moves with any ulp of hi) and the check values
within 1e-5 relative. With the
contraction off (XLA_FLAGS=--xla_cpu_max_isa=AVX, in a child process:
XLA reads its flags once per process) every output and the check value
are bitwise equal."""

import dataclasses
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
import navierstokes3d_tpu_torch as nt
from navierstokes3d_tpu_torch.kernels import poisson as kp

torch.set_num_threads(2)
NX = 12
SPECS = {"multi": ("multi", False), "gpu": ("gpu", False),
         "gpu split": ("gpu", True)}
SHARDS = (3, 6)   # shard counts: bx = 4 and the minimum, bx = 2


def _setup(name):
    variant, split = SPECS[name]
    preset = nt.preset_multi if variant == "multi" else nt.preset_gpu
    cfg = preset(nx=NX, dtype="float32")
    # nz = 10: rho*g*dz is not a float32, so the split's z constants have
    # nonzero lo words
    cfg = cfg.replace(numerics=dataclasses.replace(cfg.numerics,
                                                   nz_override=10))
    grid = nt.make_grid(cfg)
    return cfg, grid, kp.poisson_bc_spec(variant, grid, cfg.physics, split)


def _inputs(grid, seed=7):
    rng = np.random.default_rng(seed)
    f = np.float32
    pr = (rng.standard_normal(grid.shape_c) * 50).astype(f)
    lo = (rng.standard_normal(grid.shape_c) * 50 * 2.0 ** -24).astype(f)
    dpr = np.zeros(grid.shape_c, f)
    dpr[1:-1, 1:-1, 1:-1] = rng.standard_normal(
        (grid.nx - 2, grid.ny - 2, grid.nz - 2)) * 1e3
    rhs = (rng.standard_normal(grid.shape_c) * 1e5).astype(f)
    return pr, lo, dpr, rhs


def _run_both(name, extended, nshards):
    """One iteration of every shard, check on, in both packages: a list
    over shards of (jax outputs, port outputs), each (fields..., err) as
    numpy arrays."""
    cfg, g, spec = _setup(name)
    bx = g.nx // nshards
    variant, split = SPECS[name]
    it_fn, pack, unpack = build_poisson_iter(
        g.nx, g.ny, g.nz, g.dx, g.dy, g.dz, g.dtau, g.damp,
        jspec(variant, ns.make_grid(cfg), cfg.physics, split),
        dtype=jnp.float32, interpret=True, extended=extended, local_rows=bx)
    op = kp.make_bc_operator(spec, g, "cpu")
    pr, lo, dpr, rhs = _inputs(g)
    nyz = g.ny * g.nz
    out = []
    for s in range(nshards):
        sl = slice(s * bx, (s + 1) * bx)
        x_off = s * bx

        def flat(a):
            """(the shard's packed slab with the +x face in ghost row bx,
            the -x face as the halo operand)."""
            f = pack(jnp.asarray(a[sl]), jnp.asarray(dpr[sl]),
                     jnp.asarray(rhs[sl]))[0]
            w = f.shape[1]
            row = lambda p: jnp.zeros((1, w), jnp.float32).at[0, :nyz].set(
                jnp.asarray(p).ravel())   # noqa: E731
            hi = row(a[x_off + bx]) if s < nshards - 1 else row(
                np.zeros((g.ny, g.nz), np.float32))
            lo_ = row(a[x_off - 1]) if s > 0 else row(
                np.zeros((g.ny, g.nz), np.float32))
            return f.at[bx:bx + 1].set(hi), lo_

        packed = pack(jnp.asarray(pr[sl]), jnp.asarray(dpr[sl]),
                      jnp.asarray(rhs[sl]))
        xo = jnp.full((1, 1), x_off, jnp.int32)
        hf, hl = flat(pr)
        t = lambda a: torch.tensor(np.ascontiguousarray(a))  # noqa: E731
        halo = lambda a: ((t(a[x_off - 1]) if s > 0 else None),   # noqa
                          (t(a[x_off + bx]) if s < nshards - 1 else None))
        if extended:
            lf, ll = flat(lo)
            res = it_fn(hf, lf, packed[2], packed[3], hl, ll, xo, True)
            jout = [np.asarray(a) for a in unpack(*res[:3])]
            outs = [torch.empty(bx, g.ny, g.nz) for _ in range(3)]
            e = kp.poisson_iter_ext_bc_dist_plain(
                t(pr[sl]), t(lo[sl]), t(dpr[sl]), t(rhs[sl]), *outs,
                *halo(pr), *halo(lo), x_off, op, True)
        else:
            res = it_fn(hf, packed[1], packed[2], hl, xo, True)
            jout = [np.asarray(a) for a in unpack(*res[:2])]
            outs = [torch.empty(bx, g.ny, g.nz) for _ in range(2)]
            e = kp.poisson_iter_bc_dist_plain(
                t(pr[sl]), t(dpr[sl]), t(rhs[sl]), *outs, *halo(pr), x_off,
                op, True)
        jout.append(np.asarray(res[-1]).reshape(()))
        out.append((jout, [o.numpy() for o in outs] + [e.numpy()]))
    return out


CASES = [(name, ext) for name in SPECS for ext in (False, True)]


@pytest.fixture(scope="module")
def runs():
    return {(name, ext, n): _run_both(name, ext, n)
            for name, ext in CASES for n in SHARDS}


def _close(got, want, msg):
    scale = np.abs(want).max()
    tol = np.maximum(4 * np.spacing(np.abs(want).astype(np.float32)),
                     1e-6 * scale)
    bad = np.abs(got.astype(np.float64) - want) > tol
    assert not bad.any(), (msg, np.abs(got - want).max(), scale)


@pytest.mark.parametrize("nshards", SHARDS)
@pytest.mark.parametrize("name,extended", CASES)
def test_dist_plain_matches_interpret_kernel(runs, name, extended, nshards):
    """Every shard (first, middle and last) of both dist kernels."""
    for s, (jout, tout) in enumerate(runs[(name, extended, nshards)]):
        if extended:   # the pair's value, then dpr
            pair = [o[0].astype(np.float64) + o[1] for o in (tout, jout)]
            tout, jout = [pair[0], tout[2]], [pair[1], jout[2]]
            _close(tout[0], jout[0], f"shard {s} hi + lo")
            _close(tout[1], jout[1], f"shard {s} dpr")
            np.testing.assert_allclose(tout[-1], jout[-1], rtol=1e-5)
            continue
        for i, (a, b) in enumerate(zip(tout[:-1], jout[:-1])):
            _close(a, b, f"shard {s} output {i}")
        np.testing.assert_allclose(tout[-1], jout[-1], rtol=1e-5)


def test_lo_words_of_the_z_constants():
    """K2-dist's lo-word constants are the JAX kernel's zlo_lo/zhi_lo:
    float64 minus its float32 rounding, rounded (nonzero under the split)."""
    _, g, spec = _setup("gpu split")
    op = kp.make_bc_operator(spec, g, "cpu")
    for c, c_lo in ((spec.z_lo_add, op.zlo_lo), (spec.z_hi_add, op.zhi_lo)):
        hi = np.float32(c)
        assert c_lo == float(np.float32(np.float64(c) - np.float64(hi)))
        assert c_lo != 0.0
    assert op.nx == NX


def test_whole_grid_is_the_single_device_form():
    """x_off = 0 with no halo planes on the whole grid: K7-dist is K7
    (bitwise), and K2-dist's lo word stays 0 on the Dirichlet planes."""
    for name in SPECS:
        _, g, spec = _setup(name)
        op = kp.make_bc_operator(spec, g, "cpu")
        pr, lo, dpr, rhs = (torch.tensor(a) for a in _inputs(g, 8))
        a = [torch.empty_like(pr) for _ in range(2)]
        b = [torch.empty_like(pr) for _ in range(2)]
        kp.poisson_iter_bc_dist_plain(pr, dpr, rhs, *a, None, None, 0, op,
                                      False)
        kp.poisson_iter_bc_plain(pr, dpr, rhs, *b, op)
        assert all(torch.equal(x, y) for x, y in zip(a, b)), name
        c = [torch.empty_like(pr) for _ in range(3)]
        kp.poisson_iter_ext_bc_dist_plain(pr, lo, dpr, rhs, *c, None, None,
                                          None, None, 0, op, False)
        if op.xhi is not None:
            assert bool((c[1][-1] == 0).all() & (c[0][-1] == op.xhi).all())


def _child_bitwise_report():
    out = {}
    for name, ext in CASES:
        for n in SHARDS:
            out[f"{name} {ext} {n}"] = [
                all(np.array_equal(a, b) for a, b in zip(jout, tout))
                for jout, tout in _run_both(name, ext, n)]
    return out


def test_dist_plain_bitwise_without_fma():
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
    assert len(report) == len(CASES) * len(SHARDS)
    for key, shards in report.items():
        assert all(shards), (key, shards)


if __name__ == "__main__" and sys.argv[1:] == ["--bitwise"]:
    jax.config.update("jax_platforms", "cpu")
    print(json.dumps(_child_bitwise_report()))
