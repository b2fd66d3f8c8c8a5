"""The dma-mode Poisson solve (ChorinSolver(..., poisson_mode='dma'))
against the JAX package's, which it takes under NS3D_PALLAS_MODE=dma, and
the dma-mode kernel K11 against K7's plain version:

  1. K11 (build_poisson_iter(..., mode='dma', interpret=True),
     kernels/poisson.py:1451, as tests/test_pallas.py:40-80 runs it) is
     bitwise `poisson_iter_bc_plain` under the split gpu spec, the multi
     spec and the unsplit gpu (compat) spec, with one slab and with
     several (the manual double-buffered DMA pipeline): K7's kernel
     computes K11's function, so K7 serves it;
  2. two steps of the gpu preset at nx=15: the JAX package's chained
     step (its fused kernels interpreted, NS3D_FUSED_INTERPRET=1) around
     K11 under its reference loop, against the port's chained step around
     K7: the split BC spec, no exact first iteration, no accuracy phase,
     no stored pair;
  3. the multi preset at nx=15 (2 steps) and nx=31 (3 steps, the third
     runs the defect finisher): the JAX package has no extended kernel in
     dma mode and drops to its jnp folded solve with the (hi, lo) pair
     from the first iteration; the port runs the same algorithm as torch
     ops (`_poisson_solve_pair`). (Its blocked hybrid, K1 then K2, takes
     90 iterations at nx=31 step 3 where this takes 108.)

The JAX side runs in a child process with XLA's FMA contraction off
(XLA_FLAGS=--xla_cpu_max_isa=AVX). Standard of the steps
(docs/numerics.md "Cross-program rounding", as tests/test_torch_slice.py):
equal Poisson, accuracy-phase and clamp counts; pr within 1e-5 (step 1)
and 1e-3 (later steps) of max|pr|; finite fields; err below eps_it in
both (the err is a residual evaluated at convergence, a cancellation that
XLA's rewrites of divisions by constants move by up to a few percent)."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import navierstokes3d_tpu_torch as nt
from navierstokes3d_tpu_torch import kernels
from navierstokes3d_tpu_torch.kernels import poisson as kp

torch.set_num_threads(2)
FIELDS = ("pr", "vx", "vy", "vz", "c", "dprdtau")
# name: (preset, nx, steps)
STEPS = {"gpu15": ("preset_gpu", 15, 2), "multi15": ("preset_multi", 15, 2),
         "multi31": ("preset_multi", 31, 3)}
# K11 cases: name: (preset, variant, pressure split, slab)
SPECS = {"gpu": ("preset_gpu", "gpu", True), "multi": ("preset_multi",
                                                       "multi", False),
         "gpu_compat": ("preset_gpu", "gpu", False)}
K11_CASES = [(spec, slab) for spec in SPECS for slab in (None, 3)]
K11_NX = 15


def _k11_inputs(shape):
    rng = np.random.default_rng(5)
    nx, ny, nz = shape
    pr = (50.0 * rng.standard_normal(shape)).astype(np.float32)
    dpr = np.zeros(shape, np.float32)
    dpr[1:-1, 1:-1, 1:-1] = 1e3 * rng.standard_normal((nx - 2, ny - 2,
                                                       nz - 2))
    rhs = (1e5 * rng.standard_normal(shape)).astype(np.float32)
    return pr, dpr, rhs


def _jax_reference(out_path):
    """The JAX side (run in the child): one K11 call per case, and the
    dma-mode steps."""
    import jax
    import jax.numpy as jnp
    import navierstokes3d_tpu as ns
    from navierstokes3d_tpu.kernels.poisson import (build_poisson_iter,
                                                    poisson_bc_spec)
    jax.config.update("jax_platforms", "cpu")
    os.environ.update(NS3D_PALLAS_MODE="dma", NS3D_FUSED_INTERPRET="1")
    out, report = {}, {}
    for spec, slab in K11_CASES:
        preset, variant, split = SPECS[spec]
        cfg = getattr(ns, preset)(nx=K11_NX, compat=False, dtype="float32")
        g = ns.ChorinSolver(cfg.replace(use_pallas=False)).grid
        it, pack, unpack = build_poisson_iter(
            g.nx, g.ny, g.nz, g.dx, g.dy, g.dz, g.dtau, g.damp,
            poisson_bc_spec(variant, g, cfg.physics, split),
            dtype=jnp.float32, slab=slab, interpret=True, mode="dma")
        outs = it(*pack(*map(jnp.asarray, _k11_inputs(g.shape_c))))
        p, d = unpack(*outs[:2])
        out.update({f"k11{spec}{slab}_pr": p, f"k11{spec}{slab}_dpr": d})
    for name, (preset, nx, nsteps) in STEPS.items():
        cfg = getattr(ns, preset)(nx=nx, compat=False, dtype="float32")
        s = ns.ChorinSolver(cfg.replace(use_pallas=True))
        report[name] = {"kernel": s._pallas is not None,
                        "folded": s._pallas_folded,
                        "extended_kernel": s._pallas_ext is not None,
                        "chained": s._advect_flat is not None}
        step = jax.jit(s.step)
        st = s.init_state()
        for k in range(nsteps):
            st, stats = step(st)
            for f in FIELDS:
                out[f"{name}{k}_{f}"] = getattr(st, f)
            out[f"{name}{k}_counts"] = [
                stats.iters, -1 if stats.iters_ext is None
                else stats.iters_ext, stats.advect_clamped]
            out[f"{name}{k}_err"] = stats.err
            out[f"{name}{k}_pair"] = st.pr_lo is not None
    np.savez(out_path, **{k: np.asarray(v) for k, v in out.items()})
    return report


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("dma") / "jax.npz"
    repo = Path(__file__).resolve().parent.parent
    pp = os.pathsep.join(p for p in (str(repo), os.environ.get("PYTHONPATH"))
                         if p)
    env = dict(os.environ, XLA_FLAGS="--xla_cpu_max_isa=AVX",
               JAX_PLATFORMS="cpu", PYTHONPATH=pp)
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--jax", str(path)],
        capture_output=True, text=True, timeout=600, env=env, cwd=repo)
    assert proc.returncode == 0, proc.stderr[-3000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    return report, dict(np.load(path))


def _close(got, want, tol, msg):
    scale = max(1.0, np.abs(want).max())
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=tol,
                               err_msg=msg)


@pytest.mark.parametrize("spec,slab", K11_CASES)
def test_k11_is_k7_bitwise(jax_ref, spec, slab):
    ref = jax_ref[1]
    preset, variant, split = SPECS[spec]
    cfg = getattr(nt, preset)(nx=K11_NX, compat=False, dtype="float32")
    grid = nt.make_grid(cfg)
    op = kp.make_bc_operator(kp.poisson_bc_spec(variant, grid, cfg.physics,
                                                split), grid, "cpu")
    outs = [torch.empty(grid.shape_c) for _ in range(2)]
    kp.poisson_iter_bc(*map(torch.tensor, _k11_inputs(grid.shape_c)), *outs,
                       op)
    np.testing.assert_array_equal(outs[0].numpy(), ref[f"k11{spec}{slab}_pr"])
    np.testing.assert_array_equal(outs[1].numpy(),
                                  ref[f"k11{spec}{slab}_dpr"])


def test_jax_child_ran_dma_mode(jax_ref):
    report, _ = jax_ref
    for name in STEPS:
        assert report[name] == {"kernel": True, "folded": False,
                                "extended_kernel": False,
                                "chained": True}, name


@pytest.mark.parametrize("name", list(STEPS))
def test_dma_steps_match_jax(jax_ref, name):
    ref = jax_ref[1]
    preset, nx, nsteps = STEPS[name]
    cfg = getattr(nt, preset)(nx=nx, compat=False, dtype="float32")
    s = nt.ChorinSolver(cfg, device="cpu", poisson_mode="dma")
    st = s.init_state()
    kernels.reset_counts()
    ext = 0
    for k in range(nsteps):
        st, got = s.step(st)
        counts = [got.iters, -1 if got.iters_ext is None else got.iters_ext,
                  got.advect_clamped]
        assert counts == list(ref[f"{name}{k}_counts"]), k
        ext += max(counts[1], 0)
        assert got.err < 1e-3 and float(ref[f"{name}{k}_err"]) < 1e-3
        assert (st.pr_lo is not None) == bool(ref[f"{name}{k}_pair"])
        for f in FIELDS:
            assert bool(torch.isfinite(getattr(st, f)).all()), f
        _close(st.pr.numpy(), ref[f"{name}{k}_pr"], 1e-5 if k == 0 else 1e-3,
               f"pr step {k + 1}")
    calls = {kk.name.split()[0]: kk.plain.calls for kk in kernels.KERNELS}
    if name == "gpu15":
        # K7 is the only Poisson kernel; the chain runs K3, K4 and K5
        assert calls["K7"] > 0
        assert calls["K1"] == calls["K2"] == calls["K8"] == 0
        assert min(calls["K3"], calls["K4"], calls["K5"]) > 0
    else:
        # the pair solve is torch ops: no Poisson kernel
        assert calls["K1"] == calls["K2"] == calls["K7"] == 0
    if name == "multi31":
        assert ext > 0


def test_poisson_mode_is_checked():
    cfg = nt.preset_gpu(nx=15, compat=False, dtype="float32")
    with pytest.raises(ValueError, match="poisson_mode"):
        nt.ChorinSolver(cfg, device="cpu", poisson_mode="lanes")
    # float64 keeps its folded solve; compat its K7 solve in either mode
    s64 = nt.ChorinSolver(cfg.replace(numerics=dataclasses.replace(
        cfg.numerics, dtype="float64")), device="cpu", poisson_mode="dma")
    assert s64._bc_op is None
    for mode in ("blocked", "dma"):
        sc = nt.ChorinSolver(nt.preset_gpu(nx=15, dtype="float32"),
                             device="cpu", poisson_mode=mode)
        assert sc._bc_op is not None and sc._bc_op.z_lo_add == 0.0


if __name__ == "__main__" and sys.argv[1:2] == ["--jax"]:
    print(json.dumps(_jax_reference(sys.argv[2])))
