"""The port's wide-grid main path in miniature against the JAX package's:
the JAX solver with its lane-tiled kernels forced on (NS3D_LANE_TILES=3,
NS3D_FUSED_LANE_TILES=3, the chain in interpret mode with
NS3D_FUSED_INTERPRET=1) and its temporal sweeps on (NS3D_SWEEP2=1, the
default of a lane-tiled build), against the port on the CPU with its sweep
plan forced on at the depths a lane-tiled build offers (2 and 3: K8's
plain version runs the sweep bodies).

  * the Poisson solve at nx=21 (nchk=12: bodies of two 3-sweeps), the
    multi preset at eps_it=1e-6 (216 iterations; the gpu preset's PT
    iteration diverges at nx=21, 31 and 41 in both packages), from the
    same state and predictor divergence: equal iteration and
    accuracy-phase counts, pr within 1e-6 of max|pr| (docs/numerics.md
    "Cross-program rounding");
  * two whole steps of the gpu preset at nx=15 (nchk=8: bodies of two
    2-sweeps) to tests/test_torch_slice.py's standard: equal counts, pr
    within 1e-5 (step 1) and 1e-3 (step 2) of max|pr|, the stored pair
    below eps_it;
  * the port with the plan on is bitwise equal to the port with it off.

The JAX side runs in a child process with XLA's FMA contraction off
(XLA_FLAGS=--xla_cpu_max_isa=AVX; XLA reads its flags once per process).
With it on (XLA's code for an x86 host with AVX-512 and FMA), the JAX
package's own lane-tiled s-sweep kernel leaves its 1-sweep path: at nx=15
step 2 it takes 160/96 iterations where its 1-sweep kernels (and the
port) take 152/88, and the nx=21 multi solve at eps_it <= 1e-5 diverges
from its 8th check (ROADMAP.md §3)."""

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
from navierstokes3d_tpu_torch.kernels import poisson as kp
from navierstokes3d_tpu_torch.models.chorin import sweep_depths

torch.set_num_threads(2)
FIELDS = ("pr", "vx", "vy", "vz", "c", "dprdtau")
TILED = {"NS3D_FUSED_INTERPRET": "1", "NS3D_LANE_TILES": "3",
         "NS3D_FUSED_LANE_TILES": "3", "NS3D_SWEEP2": "1"}
SOLVE_NX, SOLVE_EPS = 21, 1e-6
STEP_NX = 15


def _cfg(make, nx, eps_it=None):
    cfg = make(nx=nx, dtype="float32", compat=False)
    if eps_it is not None:
        cfg = cfg.replace(numerics=dataclasses.replace(cfg.numerics,
                                                       eps_it=eps_it))
    return cfg


def _port(cfg, sweeps=True):
    s = nt.ChorinSolver(cfg, device="cpu")
    assert s._sweep_depths == ()
    if sweeps:
        s._sweep_depths = (2, 3)
    return s


def _budget(s):
    return (s.grid.niter // s.grid.nchk) * s.grid.nchk


def _close(got, want, tol, msg):
    scale = max(1.0, np.abs(want).max())
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=tol,
                               err_msg=msg)


def _jax_reference(out_path):
    """The JAX side (run in the child): the nx=21 multi solve and two
    gpu steps at nx=15, into an npz, with the JAX sweep plans."""
    import jax
    import navierstokes3d_tpu as ns
    jax.config.update("jax_platforms", "cpu")
    os.environ.update(TILED)
    out, plans = {}, {}
    for name, make, nx, eps in (("solve", ns.preset_multi, SOLVE_NX,
                                 SOLVE_EPS),
                                ("steps", ns.preset_gpu, STEP_NX, None)):
        s = ns.ChorinSolver(_cfg(make, nx, eps).replace(use_pallas=True))
        it = s._pallas[0]
        assert it.lane_tiles == 3 and s._advect_flat.layout.T == 3
        plans[name] = s._sweep_plan(it, _budget(s))[0]
        st = s.init_state()
        if name == "solve":
            divv = jax.jit(s.predictor_divv)(st)
            pr, dpr, stats = jax.jit(s.poisson_solve)(st.pr, st.dprdtau,
                                                      divv)
            out.update(solve_in_pr=st.pr, solve_in_dpr=st.dprdtau,
                       solve_in_divv=divv, solve_pr=pr, solve_dpr=dpr,
                       solve_counts=[stats.iters, stats.iters_ext])
            continue
        step = jax.jit(s.step)
        for k in range(2):
            st, stats = step(st)
            out[f"step{k}_pr"] = st.pr
            out[f"step{k}_counts"] = [stats.iters, stats.iters_ext,
                                      stats.advect_clamped]
    np.savez(out_path, **{k: np.asarray(v) for k, v in out.items()})
    return plans


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("wide") / "jax.npz"
    repo = Path(__file__).resolve().parent.parent
    pp = os.pathsep.join(p for p in (str(repo), os.environ.get("PYTHONPATH"))
                         if p)
    env = dict(os.environ, XLA_FLAGS="--xla_cpu_max_isa=AVX",
               JAX_PLATFORMS="cpu", PYTHONPATH=pp)
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--jax", str(path)],
        capture_output=True, text=True, timeout=600, env=env, cwd=repo)
    assert proc.returncode == 0, proc.stderr[-3000:]
    plans = json.loads(proc.stdout.strip().splitlines()[-1])
    return plans, dict(np.load(path))


def test_sweep_depths_follow_the_jax_tiling():
    """On at 511x307x307 (T = 4 tiles), off at the 255 grid (W = 23424
    lanes, untiled) and where W > 2**15 still rounds to one tile."""
    assert sweep_depths(307, 307) == (2, 3)
    assert sweep_depths(192, 192) == (2, 3)   # W = 36864: T = round(1.5)
    assert sweep_depths(191, 191) == ()       # W = 36608: T = 1
    assert sweep_depths(153, 153) == ()
    assert sweep_depths(13, 13) == ()
    wide = nt.ChorinSolver(_cfg(nt.preset_gpu, 511), device="meta")
    assert wide._sweep_plan(_budget(wide)) == 3


def test_plans_match_jax(jax_ref):
    plans, _ = jax_ref
    solve = _port(_cfg(nt.preset_multi, SOLVE_NX, SOLVE_EPS))
    steps = _port(_cfg(nt.preset_gpu, STEP_NX))
    assert plans == {"solve": 3, "steps": 2}
    assert solve._sweep_plan(_budget(solve)) == 3
    assert steps._sweep_plan(_budget(steps)) == 2


def test_poisson_solve_matches_jax(jax_ref):
    ref = jax_ref[1]
    cfg = _cfg(nt.preset_multi, SOLVE_NX, SOLVE_EPS)
    args = [torch.tensor(ref[f"solve_in_{k}"]) for k in ("pr", "dpr",
                                                          "divv")]
    kp.poisson_iter_sweeps_plain.calls = 0
    pt, dt, st = _port(cfg).poisson_solve(*args)
    assert kp.poisson_iter_sweeps_plain.calls > 0
    assert [st.iters, st.iters_ext] == list(ref["solve_counts"])
    assert st.err < SOLVE_EPS
    _close(pt.numpy(), ref["solve_pr"], 1e-6, "pr")
    # the plan off: the same solve, bitwise
    po, do, so = _port(cfg, sweeps=False).poisson_solve(*args)
    assert (so.iters, so.iters_ext, so.err) == (st.iters, st.iters_ext,
                                                st.err)
    for a, b in ((po, pt), (do, dt), (so.pr_lo, st.pr_lo)):
        assert torch.equal(a, b)


def test_two_steps_match_jax(jax_ref):
    ref = jax_ref[1]
    cfg = _cfg(nt.preset_gpu, STEP_NX)
    ts, off = _port(cfg), _port(cfg, sweeps=False)
    st = st_off = ts.init_state()
    for step, tol in enumerate((1e-5, 1e-3)):
        divv = ts.predictor_divv(st)
        st, got = ts.step(st)
        st_off, got_off = off.step(st_off)
        assert [got.iters, got.iters_ext, got.advect_clamped] == list(
            ref[f"step{step}_counts"]), step
        assert got.iters < ts.grid.niter and got.err < 1e-3
        for k in FIELDS + ("pr_lo",):
            assert bool(torch.isfinite(getattr(st, k)).all()), k
        _close(st.pr.numpy(), ref[f"step{step}_pr"], tol,
               f"pr step {step + 1}")
        assert ts.stored_residual_err(st, divv=divv) < 1e-3
        # the plan off: bitwise
        assert (got_off.iters, got_off.iters_ext) == (got.iters,
                                                      got.iters_ext)
        for k in FIELDS + ("pr_lo",):
            assert torch.equal(getattr(st, k), getattr(st_off, k)), k


if __name__ == "__main__" and sys.argv[1:2] == ["--jax"]:
    print(json.dumps(_jax_reference(sys.argv[2])))
