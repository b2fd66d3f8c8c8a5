"""The port's distributed Poisson solve and sharded step on their kernel
path (parallel/halo.py's kernel loop, ChorinSolver.step_shard_map) against
the JAX package's (build_poisson_shard_map(use_pallas=True),
step_shard_map_jit with its interpreted kernels) on meshes of CPU shards,
from the same seeded inputs. The plain loop and the float64 step are held
in tests/test_torch_step_dist.py.

  * the kernel loop on a (4,1,1) mesh (K7-dist, and K2-dist on the pair),
    tests/test_sharded.py:311-365's shapes (nx=40, random pr and rhs), and
    two float32 steps at nx=16 from init_state of the multi preset with
    and without compat mode, against the JAX package with use_pallas=True,
    run in a child with XLA's FMA contraction off
    (XLA_FLAGS=--xla_cpu_max_isa=AVX) and the configuration's advection
    method (its CPU default is gather): the solves equal in iteration
    count, err and fields bitwise; the steps equal in counts with pr
    within 1e-5 (step 1) and 1e-3 (step 2) of max|pr| (the unfused chain is
    XLA-compiled on the JAX side, tests/test_torch_slice.py's standard);
  * the port's solves at P = 4 (and (2,2,2) for the plain loop) bitwise
    equal to its P = 1 solves on the same inputs, and its local solve
    (wrap=False, per-shard blocks in and out) bitwise equal to the
    global-view one;
  * `python -m navierstokes3d_tpu_torch.run --mesh 4x1x1 --comm shard_map
    --device cpu` at nx=16 for 2 steps, and `--comm auto`, which resolves
    to fullstep there (tests/test_torch_fullstep.py holds that step)."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import navierstokes3d_tpu_torch as nt
from navierstokes3d_tpu_torch import kernels
from navierstokes3d_tpu_torch import run as trun
from navierstokes3d_tpu_torch.parallel import (build_poisson_shard_map,
                                               join_blocks, make_mesh,
                                               split_blocks)
from navierstokes3d_tpu_torch.parallel.fullstep import to_dist

torch.set_num_threads(2)
FIELDS = ("pr", "vx", "vy", "vz", "c", "dprdtau")
PRESETS = {"multi": nt.preset_multi, "gpu": nt.preset_gpu}
STEP_CASES = [("multi", False), ("multi", True)]


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


def _pois_inputs(g, seed=5):
    """tests/test_sharded.py's `_rand_pois`: random float32 pr and rhs,
    dpr 0."""
    rng = np.random.default_rng(seed)
    pr = rng.uniform(-100.0, 100.0, g.shape_c).astype(np.float32)
    rhs = rng.uniform(-50.0, 50.0, g.shape_c).astype(np.float32)
    return pr, np.zeros(g.shape_c, np.float32), rhs


def _kernel_cfg(extended, make):
    cfg = make(nx=40, nt=1, compat=False, dtype="float32", use_pallas=True)
    return _short(cfg, stall_exit=False,
                  accuracy="extended" if extended else None)


def _jax_reference(out_path):
    """The JAX side (run in the child, FMA contraction off): the kernel
    solves on (4,1,1) and (1,1,1), and two kernel-path steps on (4,1,1)."""
    import jax
    import jax.numpy as jnp
    import navierstokes3d_tpu as ns
    from navierstokes3d_tpu.parallel import make_mesh as jmake
    from navierstokes3d_tpu.parallel.halo import (
        build_poisson_shard_map as jbuild)
    jax.config.update("jax_platforms", "cpu")
    out = {}
    for ext in (False, True):
        cfg = _kernel_cfg(ext, ns.preset_gpu if ext else ns.preset_multi)
        s = ns.ChorinSolver(cfg)
        g = s.grid
        ins = [jnp.asarray(a) for a in _pois_inputs(g)]
        for p in (4, 1):
            solve = jbuild(jmake((p, 1, 1), jax.devices()[:p]), g,
                           cfg.physics, cfg.numerics.eps_it, cfg.variant,
                           jnp.float32, pressure_split=s.pressure_split,
                           stall=None, use_pallas=True, extended=ext,
                           interpret=True)
            pr, dpr, it, err, _ = jax.jit(solve)(*ins)
            out.update({f"solve{ext}{p}_pr": pr, f"solve{ext}{p}_dpr": dpr,
                        f"solve{ext}{p}_counts": [it],
                        f"solve{ext}{p}_err": err})
    mesh = jmake((4, 1, 1), jax.devices()[:4])
    for variant, compat in STEP_CASES:
        cfg = getattr(ns, f"preset_{variant}")(
            nx=16, compat=compat, dtype="float32", use_pallas=True)
        s = ns.ChorinSolver(cfg)
        s.advect_method = "gather" if compat else "selectshift"
        step = s.step_shard_map_jit(mesh)
        st = ns.parallel.shard_state(s.init_state(), mesh)
        for k in range(2):
            st, stats = step(st)
            key = f"step{variant}{compat}{k}"
            # the step donates its input: read before the next one
            out[f"{key}_pr"] = np.asarray(st.pr)
            out[f"{key}_counts"] = [int(stats.iters),
                                    int(stats.advect_clamped)]
    np.savez(out_path, **{k: np.asarray(v) for k, v in out.items()})


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("dist") / "jax.npz"
    repo = Path(__file__).resolve().parent.parent
    pp = os.pathsep.join(p for p in (str(repo), os.environ.get("PYTHONPATH"))
                         if p)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=pp,
               XLA_FLAGS="--xla_cpu_max_isa=AVX "
                         "--xla_force_host_platform_device_count=8")
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--jax", str(path)],
        capture_output=True, text=True, timeout=600, env=env, cwd=repo)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(path))


def _kernel_solve(extended, p):
    """The port's kernel-loop solve at the JAX reference's inputs on a
    (p,1,1) mesh of CPU shards."""
    cfg = _kernel_cfg(extended, nt.preset_gpu if extended
                      else nt.preset_multi)
    s = nt.ChorinSolver(cfg, device="cpu")
    solve = build_poisson_shard_map(
        make_mesh((p, 1, 1), "cpu"), s.grid, cfg.physics,
        cfg.numerics.eps_it, cfg.variant, torch.float32,
        pressure_split=s.pressure_split, stall=None, use_pallas=True,
        extended=extended)
    return solve(*(torch.tensor(a) for a in _pois_inputs(s.grid)))


@pytest.mark.parametrize("extended", [False, True])
def test_kernel_solve_matches_jax(jax_ref, extended):
    kernels.reset_counts()
    pr, dpr, iters, err, _ = _kernel_solve(extended, 4)
    plain = (nt.kernels.poisson.poisson_iter_ext_bc_dist_plain if extended
             else nt.kernels.poisson.poisson_iter_bc_dist_plain)
    assert plain.calls == 4 * iters
    key = f"solve{extended}4"
    assert iters == int(jax_ref[f"{key}_counts"][0])
    assert np.float32(err) == np.float32(jax_ref[f"{key}_err"])
    np.testing.assert_array_equal(pr.numpy(), jax_ref[f"{key}_pr"])
    np.testing.assert_array_equal(dpr.numpy(), jax_ref[f"{key}_dpr"])
    # the JAX package's own 1-shard reference agrees with its 4 shards
    assert int(jax_ref[f"solve{extended}1_counts"][0]) == iters


@pytest.mark.parametrize("variant,compat", STEP_CASES)
def test_kernel_path_steps_match_jax(jax_ref, variant, compat):
    cfg = PRESETS[variant](nx=16, compat=compat, dtype="float32")
    s = nt.ChorinSolver(cfg, device="cpu")
    step = s.step_shard_map(make_mesh((4, 1, 1), "cpu"))
    st = s.init_state()
    kernels.reset_counts()
    for k, tol in enumerate((1e-5, 1e-3)):
        st, stats = step(st)
        key = f"step{variant}{compat}{k}"
        assert [stats.iters, stats.advect_clamped] == list(
            jax_ref[f"{key}_counts"]), k
        _close(st.pr, jax_ref[f"{key}_pr"], tol, f"pr step {k + 1}")
        for name in FIELDS:
            assert bool(torch.isfinite(getattr(st, name)).all()), name
    # the solve ran its dist kernel (plain versions here) and nothing else
    on = "K7-dist" if compat else "K2-dist"
    for kk in kernels.KERNELS:
        assert kk.wrapper.launches == 0, kk.name
        assert (kk.plain.calls > 0) == kk.name.startswith(on), kk.name


@pytest.mark.parametrize("extended", [False, True])
def test_kernel_solve_p4_equals_p1(extended):
    a, b = _kernel_solve(extended, 4), _kernel_solve(extended, 1)
    assert a[2:4] == b[2:4]
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("variant", ["multi", "gpu"])
def test_plain_solve_decomposition_is_exact(variant, k):
    cfg = _short(PRESETS[variant](nx=16, compat=False, dtype="float32"))
    s = nt.ChorinSolver(cfg, device="cpu")
    st = _random_state(s.grid, 4)
    ins = [torch.tensor(st[n], dtype=torch.float32)
           for n in ("pr", "dprdtau", "c")]
    outs = []
    for shape in ((4, 1, 1), (2, 2, 2), (1, 1, 1)):
        solve = build_poisson_shard_map(
            make_mesh(shape, "cpu"), s.grid, cfg.physics,
            cfg.numerics.eps_it, cfg.variant, torch.float32, halo_width=k,
            pressure_split=s.pressure_split, stall=s._stall)
        outs.append(solve(*ins))
    for o in outs[:2]:
        assert o[2:4] == outs[2][2:4]
        assert torch.equal(o[0], outs[2][0]) and torch.equal(o[1],
                                                             outs[2][1])


@pytest.mark.parametrize("use_pallas,extended",
                         [(True, False), (True, True), (False, False)])
def test_unwrapped_solve_equals_wrapped(use_pallas, extended):
    """wrap=False returns the local solve: the same solve on lists of
    per-shard blocks in mesh order, bitwise."""
    cfg = _short(nt.preset_multi(nx=16, compat=False, dtype="float32"))
    s = nt.ChorinSolver(cfg, device="cpu")
    mesh = make_mesh((4, 1, 1), "cpu")
    ins = [torch.tensor(a) for a in _pois_inputs(s.grid)]

    def build(wrap):
        return build_poisson_shard_map(
            mesh, s.grid, cfg.physics, cfg.numerics.eps_it, cfg.variant,
            torch.float32, pressure_split=s.pressure_split, stall=s._stall,
            use_pallas=use_pallas, extended=extended, wrap=wrap)
    want = build(True)(*ins)
    got = build(False)(*(split_blocks(a, mesh) for a in ins))
    assert got[2:4] == want[2:4] and want[2] > 0
    for blocks, whole in zip(got[:2], want[:2]):
        assert len(blocks) == mesh.size
        assert all(torch.equal(b, w)
                   for b, w in zip(blocks, split_blocks(whole, mesh)))
        assert torch.equal(join_blocks(blocks, mesh), whole)


def test_one_shard_step_takes_the_fused_chain():
    """On a one-shard mesh the step runs the solver's own chain (K3, K4,
    K5: plain versions here), on a larger mesh the unfused torch ops."""
    cfg = nt.preset_multi(nx=16, compat=False, dtype="float32")
    s = nt.ChorinSolver(cfg, device="cpu")
    for shape, fused in (((1, 1, 1), True), ((2, 1, 1), False)):
        kernels.reset_counts()
        s.step_shard_map(make_mesh(shape, "cpu"))(s.init_state())
        calls = {k.name.split()[0]: k.plain.calls for k in kernels.KERNELS}
        assert (calls["K3"] > 0 and calls["K4"] > 0
                and calls["K5"] > 0) == fused
        assert calls["K2-dist"] > 0
        assert calls["K1"] == calls["K2"] == calls["K8"] == 0


def test_use_pallas_rule():
    """The kernel loop only where JAX's step_shard_map_jit takes it:
    float32 (kernels on), x-only mesh, halo width 1."""
    cfg = nt.preset_multi(nx=16, compat=False, dtype="float32")
    mesh = make_mesh((2, 2, 1), "cpu")
    kernels.reset_counts()
    nt.ChorinSolver(cfg, device="cpu").step_shard_map(mesh)(
        nt.ChorinSolver(cfg, device="cpu").init_state())
    assert all(k.plain.calls == 0 for k in kernels.KERNELS
               if "dist" in k.name)
    with pytest.raises(ValueError, match="x-only"):
        build_poisson_shard_map(mesh, nt.make_grid(cfg), cfg.physics, 1e-3,
                                "multi", torch.float32, use_pallas=True)
    with pytest.raises(ValueError, match="halo_width must be 1"):
        build_poisson_shard_map(make_mesh((2, 1, 1), "cpu"),
                                nt.make_grid(cfg), cfg.physics, 1e-3,
                                "multi", torch.float32, halo_width=2,
                                use_pallas=True)


def test_cli_shard_map(capsys):
    argv = ["--preset", "multi", "--nx", "16", "--nt", "2", "--device",
            "cpu"]
    assert trun.main(argv + ["--mesh", "4x1x1", "--comm", "shard_map"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert "mesh 4x1x1 of cpu, comm shard_map" in lines[0]
    cfg = nt.preset_multi(nx=16, compat=False, dtype="float32")
    s = nt.ChorinSolver(cfg, device="cpu")
    step, st = s.step_shard_map(make_mesh((4, 1, 1), "cpu")), s.init_state()
    for k in range(2):
        st, stats = step(st)
        assert lines[k + 1].startswith(f"step {k + 1}: iters {stats.iters} ")
    # auto on an x-only mesh of slabs >= advect_k + 2 resolves to fullstep
    assert trun.main(argv + ["--mesh", "4x1x1"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert "mesh 4x1x1 of cpu, comm fullstep" in lines[0]
    mesh = make_mesh((4, 1, 1), "cpu")
    step, d = s.step_fullstep(mesh), to_dist(s.init_state(), mesh)
    for k in range(2):
        d, stats = step(d)
        assert lines[k + 1].startswith(f"step {k + 1}: iters {stats.iters} ")
    # a one-shard mesh under auto runs the single-device step
    assert trun.main(argv + ["--mesh", "1x1x1"]) == 0
    assert "comm auto" in capsys.readouterr().out


if __name__ == "__main__" and sys.argv[1:2] == ["--jax"]:
    _jax_reference(sys.argv[2])
