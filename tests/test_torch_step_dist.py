"""The port's plain distributed Poisson loop and its sharded step in
float64 (parallel/halo.py, ChorinSolver.step_shard_map) against the JAX
package's (parallel/halo.build_poisson_shard_map with its jnp loop,
step_shard_map_jit) on a (2,2,2) mesh: the JAX side on the 8 virtual CPU
devices of tests/conftest.py, the port's on 8 CPU shards, from the same
seeded inputs (tests/test_sharded.py's random developed state and short
Poisson budget).

  * the solve at halo width 1, 2 and 3, both variants, nx=16: equal
    iteration counts, err within 1e-10 relative, fields within 1e-12 of
    max|field| (tests/test_sharded.py:220-269's bound; XLA rewrites the
    loop's divisions by constants, so the two are not bitwise);
  * the whole step, nx=16: the multi variant (select-shift advection) and,
    under compat mode, both variants (gather advection): equal counts,
    every field within 1e-12 of its max, no stored pair."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import navierstokes3d_tpu as ns
from navierstokes3d_tpu.parallel import make_mesh as jmake
from navierstokes3d_tpu.parallel import shard_state as jshard
from navierstokes3d_tpu.parallel.halo import build_poisson_shard_map as jbuild
import navierstokes3d_tpu_torch as nt
from navierstokes3d_tpu_torch.parallel import (build_poisson_shard_map,
                                               make_mesh)

torch.set_num_threads(2)
FIELDS = ("pr", "vx", "vy", "vz", "c", "dprdtau")
PRESETS = {"multi": nt.preset_multi, "gpu": nt.preset_gpu}


def _short(cfg, **kw):
    return cfg.replace(numerics=dataclasses.replace(
        cfg.numerics, niter_scale=1, **kw))


def _random_state(g, seed=0):
    """tests/test_sharded.py's random developed state (dprdtau's ring 0)."""
    rng = np.random.default_rng(seed)
    f = lambda s: rng.uniform(-0.7, 0.7, s)   # noqa: E731
    st = {k: f(s) for k, s in g.field_shapes().items()}
    d = st["dprdtau"]
    d[0] = d[-1] = d[:, 0] = d[:, -1] = d[:, :, 0] = d[:, :, -1] = 0.0
    return st


def _close(got, want, tol, msg):
    scale = max(1.0, np.abs(want).max())
    np.testing.assert_allclose(np.asarray(got) / scale, want / scale,
                               rtol=0, atol=tol, err_msg=msg)


@pytest.fixture(scope="module")
def jax_meshes():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jmake((2, 2, 2), jax.devices()[:8])


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("variant", ["multi", "gpu"])
def test_plain_solve_matches_jax(jax_meshes, variant, k):
    cfg = _short(PRESETS[variant](nx=16, compat=False))
    s = nt.ChorinSolver(cfg, device="cpu")
    g = s.grid
    st = _random_state(g, 1)
    rng = np.random.default_rng(2)
    rhs = rng.uniform(-50, 50, g.shape_c)
    args = (g, cfg.physics, cfg.numerics.eps_it, cfg.variant)
    kw = dict(halo_width=k, pressure_split=s.pressure_split, stall=s._stall)
    jsolve = jax.jit(jbuild(jax_meshes, ns.make_grid(cfg), *args[1:],
                            jnp.float64, **kw))
    jp, jd, jit, jerr, _ = jsolve(*(jnp.asarray(a) for a in
                                    (st["pr"], st["dprdtau"], rhs)))
    tsolve = build_poisson_shard_map(make_mesh((2, 2, 2), "cpu"), *args,
                                     torch.float64, **kw)
    tp, td, tit, terr, _ = tsolve(*(torch.tensor(a) for a in
                                    (st["pr"], st["dprdtau"], rhs)))
    assert tit == int(jit) and tit > 0
    np.testing.assert_allclose(float(terr), float(jerr), rtol=1e-10)
    _close(tp, np.asarray(jp), 1e-12, "pr")
    _close(td, np.asarray(jd), 1e-12, "dprdtau")


@pytest.mark.parametrize("variant,compat", [("multi", False),
                                            ("multi", True), ("gpu", True)])
def test_sharded_step_matches_jax(jax_meshes, variant, compat):
    jcfg = _short(getattr(ns, f"preset_{variant}")(nx=16, compat=compat))
    cfg = _short(PRESETS[variant](nx=16, compat=compat))
    js, ts = ns.ChorinSolver(jcfg), nt.ChorinSolver(cfg, device="cpu")
    # the JAX solver picks gather advection on a CPU backend; the port
    # keeps the configuration's method everywhere
    js.advect_method = ts.advect_method
    st = _random_state(ts.grid, 3)
    jst, jstats = js.step_shard_map_jit(jax_meshes)(
        jshard(ns.FlowState(**{k: jnp.asarray(v) for k, v in st.items()}),
               jax_meshes))
    tst, tstats = ts.step_shard_map(make_mesh((2, 2, 2), "cpu"))(
        nt.state_from_numpy(st, device="cpu"))
    assert tstats.iters == int(jstats.iters)
    assert tstats.advect_clamped == int(jstats.advect_clamped)
    np.testing.assert_allclose(float(tstats.err), float(jstats.err),
                               rtol=1e-10)
    for name in FIELDS:
        _close(getattr(tst, name), np.asarray(getattr(jst, name)), 1e-12,
               name)
    assert tst.pr_lo is None and tstats.iters_ext is None
