"""The port's main path (ChorinSolver on the CPU, plain versions of the
kernels) against the JAX package's real main path in interpret mode:
preset_gpu(nx=15, float32, compat=False).replace(use_pallas=True) under
NS3D_FUSED_INTERPRET=1, i.e. the folded Pallas Poisson kernel with the
defect-correction accuracy phase and the chained predict/correct/advect
kernels. Standard of tests/test_fused_step.py:149-162: equal Poisson
iteration counts, accuracy-phase counts and clamp counts; pr within 1e-5
(step 1) and 1e-3 (step 2) of max|pr|; finite fields. The stored (hi, lo)
pressure must meet eps_it after every step.

nx=15 because the same preset diverges in the JAX package itself at nx=24
(err ~5e28 after step 1); nx=15 step 2 clamps 116 advection points, so it
exercises the clamp counter too."""

import jax
import numpy as np
import pytest
import torch

import navierstokes3d_tpu as ns
import navierstokes3d_tpu_torch as nt

torch.set_num_threads(2)
NX = 15
FIELDS = ("pr", "vx", "vy", "vz", "c", "dprdtau")


def _np_state(st):
    out = {k: np.asarray(getattr(st, k)) for k in FIELDS}
    out["pr_lo"] = None if st.pr_lo is None else np.asarray(st.pr_lo)
    return out


@pytest.fixture(scope="module")
def jax_run():
    """Two steps of the JAX main path in interpret mode: the state before
    each step, and each step's stats."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NS3D_FUSED_INTERPRET", "1")
        cfg = ns.preset_gpu(nx=NX, dtype="float32",
                            compat=False).replace(use_pallas=True)
        s = ns.ChorinSolver(cfg)
        assert s._advect_flat is not None and s._pallas is not None
        assert s.acc_pallas == "defect"
        step = jax.jit(s.step)
        st = s.init_state()
        states, stats = [_np_state(st)], []
        for _ in range(2):
            st, sts = step(st)
            states.append(_np_state(st))
            stats.append(sts)
    return states, stats


def _compare_pr(got, want, tol, msg):
    scale = max(1.0, np.abs(want).max())
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=tol,
                               err_msg=msg)


def test_f32_main_path_matches_jax(jax_run):
    states, stats = jax_run
    s = nt.ChorinSolver(nt.preset_gpu(nx=NX, dtype="float32", compat=False),
                        device="cpu")
    st = s.init_state()
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(st, k).numpy(), states[0][k])
    for step, tol in enumerate((1e-5, 1e-3)):
        divv = s.predictor_divv(st)
        st, got = s.step(st)
        want = stats[step]
        assert got.iters == int(want.iters), f"step {step} iters"
        assert got.iters_ext == int(want.iters_ext), f"step {step} ext"
        assert got.advect_clamped == int(want.advect_clamped)
        assert got.iters < s.grid.niter and got.err < 1e-3
        for k in FIELDS + ("pr_lo",):
            assert bool(torch.isfinite(getattr(st, k)).all()), k
        _compare_pr(st.pr.numpy(), states[step + 1]["pr"], tol,
                    f"pr step {step}")
        assert s.stored_residual_err(st, divv=divv) < 1e-3
    assert stats[1].advect_clamped > 0


def test_state_carried_across(jax_run):
    """state_from_numpy(JAX state after step 1, pr_lo set) -> one port
    step is the JAX step 2 from the same state."""
    states, stats = jax_run
    assert states[1]["pr_lo"] is not None
    st = nt.state_from_numpy(states[1], device="cpu")
    back = nt.state_to_numpy(st)
    for k in FIELDS + ("pr_lo",):
        np.testing.assert_array_equal(back[k], states[1][k])
        assert getattr(st, k).dtype == torch.float32
    s = nt.ChorinSolver(nt.preset_gpu(nx=NX, dtype="float32", compat=False),
                        device="cpu")
    st, got = s.step(st)
    assert (got.iters, got.iters_ext, got.advect_clamped) == (
        int(stats[1].iters), int(stats[1].iters_ext),
        int(stats[1].advect_clamped))
    _compare_pr(st.pr.numpy(), states[2]["pr"], 1e-5, "pr")
    # the stored pair's value hi + lo (lo alone is rounding-level: a 1-ulp
    # move of hi shifts it by the same amount)
    pair = st.pr.double().numpy() + st.pr_lo.double().numpy()
    want = states[2]["pr"].astype(np.float64) + states[2]["pr_lo"]
    _compare_pr(pair, want, 1e-5, "pr + pr_lo")
