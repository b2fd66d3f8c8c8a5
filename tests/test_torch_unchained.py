"""The unchained step (ChorinSolver(..., fused_step=False): the chain as
torch ops, the same Poisson solve, the advection branches on K6, one call for the four) against
the JAX package's unchained `_step_impl` branch, which it takes under
NS3D_FUSED_STEP=0 (models/chorin.py:1806-1841): two steps of the gpu
preset at nx=15 (it diverges at 24 in the JAX package itself) and of the
multi preset at nx=15, float32, use_pallas=True.

The JAX side runs in a child process (XLA reads its flags once per
process) with XLA's FMA contraction off (XLA_FLAGS=--xla_cpu_max_isa=AVX),
where its interpreted K1 and K2 are bitwise the port's plain versions.
Its CPU build never makes `_advect_pallas` (models/chorin.py:421 requires
a TPU), so it advects with the jnp select-shift, which
tests/test_advect_pallas.py holds bitwise to K6's Pallas kernel and
tests/test_torch_advect_pre.py to the port's K6.

Standard (docs/numerics.md "Cross-program rounding", as
tests/test_torch_slice.py): equal Poisson, accuracy-phase and clamp
counts; pr within 1e-5 (step 1) and 1e-3 (step 2) of max|pr|, the
advected fields of step 1 within 1e-5 of their max; finite fields; the
stored (hi, lo) pair below eps_it. On the CPU the port's
unchained step is bitwise its chained one (K3's and K4's plain versions
are the same torch ops, K6's plain version is K5's sum)."""

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
from navierstokes3d_tpu_torch.kernels import advect as ka

torch.set_num_threads(2)
FIELDS = ("pr", "vx", "vy", "vz", "c", "dprdtau")
CASES = {"gpu": ("preset_gpu", 15), "multi": ("preset_multi", 15)}
NSTEPS = 2


def _jax_reference(out_path):
    """The JAX side (run in the child): NSTEPS unchained steps per case."""
    import jax
    import navierstokes3d_tpu as ns
    jax.config.update("jax_platforms", "cpu")
    # NS3D_FUSED_INTERPRET=1 makes the CPU build pick select-shift
    # advection (its accelerator default) and would interpret the fused
    # chain, which NS3D_FUSED_STEP=0 turns off
    os.environ.update(NS3D_FUSED_STEP="0", NS3D_FUSED_INTERPRET="1")
    out, report = {}, {}
    for name, (preset, nx) in CASES.items():
        cfg = getattr(ns, preset)(nx=nx, compat=False, dtype="float32")
        s = ns.ChorinSolver(cfg.replace(use_pallas=True))
        report[name] = {"unchained": s._fused_pre is None,
                        "folded_kernel": s._pallas_folded,
                        "advect_kernel": s._advect_pallas is not None,
                        "advect_method": s.advect_method}
        step = jax.jit(s.step)
        st = s.init_state()
        for k in range(NSTEPS):
            st, stats = step(st)
            for f in FIELDS + ("pr_lo",):
                out[f"{name}{k}_{f}"] = getattr(st, f)
            out[f"{name}{k}_counts"] = [stats.iters, stats.iters_ext,
                                        stats.advect_clamped]
    np.savez(out_path, **{k: np.asarray(v) for k, v in out.items()})
    return report


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("unchained") / "jax.npz"
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


def _solver(name, **kw):
    preset, nx = CASES[name]
    cfg = getattr(nt, preset)(nx=nx, compat=False, dtype="float32")
    return nt.ChorinSolver(cfg, device="cpu", **kw)


def test_jax_child_ran_the_unchained_branch(jax_ref):
    report, _ = jax_ref
    for name in CASES:
        assert report[name] == {"unchained": True, "folded_kernel": True,
                                "advect_kernel": False,
                                "advect_method": "selectshift"}, name


@pytest.mark.parametrize("name", list(CASES))
def test_unchained_steps_match_jax(jax_ref, name):
    ref = jax_ref[1]
    s = _solver(name, fused_step=False)
    st = s.init_state()
    kernels.reset_counts()
    for k, tol in enumerate((1e-5, 1e-3)):
        divv = s.predictor_divv(st)
        st, got = s.step(st)
        assert [got.iters, got.iters_ext, got.advect_clamped] == list(
            ref[f"{name}{k}_counts"]), k
        assert got.iters < s.grid.niter and got.err < 1e-3
        for f in FIELDS + ("pr_lo",):
            assert bool(torch.isfinite(getattr(st, f)).all()), f
        _close(st.pr.numpy(), ref[f"{name}{k}_pr"], tol, f"pr step {k + 1}")
        if k == 0:
            # step 2 clamps (gpu): there an ulp of velocity can move a
            # departure point across floor()'s discontinuity at CFL_adv=1
            # (docs/numerics.md's exception), so only step 1's advected
            # fields are held
            for f in ("vx", "vy", "vz", "c"):
                _close(getattr(st, f).numpy(), ref[f"{name}{k}_{f}"], tol,
                       f"{f} step {k + 1}")
        assert s.stored_residual_err(st, divv=divv) < 1e-3
    # K6 ran once a step, on the four branches; K3, K4 and K5 not at all
    # (predictor_divv runs the unchained chain too); the folded loops ran
    # on K10, one call a loop
    calls = {kk.name.split()[0]: kk.plain.calls for kk in kernels.KERNELS}
    assert calls["K6"] == NSTEPS
    assert ka.advect_branch_pre_plain.calls == 4 * NSTEPS
    assert calls["K3"] == calls["K4"] == calls["K5"] == 0
    assert calls["K10"] > 0


@pytest.mark.parametrize("name", list(CASES))
def test_unchained_is_chained_on_the_cpu(name):
    a, b = _solver(name), _solver(name, fused_step=False)
    sa = sb = a.init_state()
    for _ in range(NSTEPS):
        sa, ta = a.step(sa)
        sb, tb = b.step(sb)
        assert (ta.iters, ta.iters_ext, ta.err, ta.advect_clamped) == (
            tb.iters, tb.iters_ext, tb.err, tb.advect_clamped)
        for f in FIELDS + ("pr_lo",):
            assert torch.equal(getattr(sa, f), getattr(sb, f)), f


def test_unchained_plain_runs_k6_plain():
    """use_pallas=False takes the plain versions: K6's here."""
    preset, nx = CASES["gpu"]
    cfg = getattr(nt, preset)(nx=nx, compat=False, dtype="float32")
    s = nt.ChorinSolver(cfg.replace(use_pallas=False), device="cpu",
                        fused_step=False)
    kernels.reset_counts()
    _, stats = s.step(s.init_state())
    assert stats.iters > 0
    calls = {kk.name.split()[0]: kk.plain.calls for kk in kernels.KERNELS}
    assert calls["K6"] == 1 and calls["K5"] == 0
    assert ka.advect_branch_pre_plain.calls == 4


if __name__ == "__main__" and sys.argv[1:2] == ["--jax"]:
    print(json.dumps(_jax_reference(sys.argv[2])))
