"""The port's multi-preset main path (ChorinSolver on the CPU, plain
versions of the kernels) against the JAX package's main path in interpret
mode: preset_multi(nx=15, float32, compat=False).replace(use_pallas=True)
under NS3D_FUSED_INTERPRET=1, i.e. the folded Pallas Poisson kernel with
the extended (hi, lo) accuracy phase on the K2 kernel, and the chained
predict/correct/advect kernels. Also the gpu preset with accuracy
'extended' and 'none', and without the hydrostatic split (the unsplit
planes and pair BCs).

Two regimes of the multi preset:
  eps_it=1e-3: phase 1 converges on its own and K2 never runs; the
    iteration, accuracy-phase and clamp counts are equal and pr agrees
    within 1e-5 (step 1) and 1e-3 (later steps) of max|pr|, the standard
    of tests/test_torch_slice.py.
  eps_it=1e-9: phase 1 stops on its stall detector at the float32 noise
    floor and K2 carries the solve to eps_it on every step. Where a loop
    exits on noise, the exit iteration depends on the last bits of the
    check values, and those differ between the two programs: XLA's CPU
    compilation of the JAX step contracts a*b + c into FMAs and rewrites
    divisions by constants into multiplications by reciprocals, which the
    plain versions (and the CUDA kernels built with --fmad=false) do
    not; the JAX package itself takes other counts with the contraction
    off (PERF.md). So here both programs must run K2 on every step, its
    iteration count (the second phase, which ends on eps_it) agrees
    within one check (nchk iterations), the total, whose first phase
    ends on the stall detector, within two, and, both having solved to
    1e-9, pr agrees within 1e-5 of max|pr|. Each step starts from the
    JAX state (state_from_numpy, pr_lo included), so errors do not
    compound.
The stored (hi, lo) pressure must meet eps_it after every step."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import advect_faults
import navierstokes3d_tpu as ns
import navierstokes3d_tpu_torch as nt

torch.set_num_threads(2)
NX = 15
NSTEPS = 3
FIELDS = ("pr", "vx", "vy", "vz", "c", "dprdtau")
_JIT_STEPS = {}   # JAX solver -> its compiled step, for steps from port states


def _np_state(st):
    out = {k: np.asarray(getattr(st, k)) for k in FIELDS}
    out["pr_lo"] = None if st.pr_lo is None else np.asarray(st.pr_lo)
    return out


def _with(cfg, **numerics):
    return cfg.replace(numerics=dataclasses.replace(cfg.numerics,
                                                    **numerics))


def _jax_steps(cfg, nsteps):
    """nsteps of the JAX main path in interpret mode: the state before
    each step (and after the last), and each step's stats. The step does
    not read the incoming pr_lo, so the initial state gets a zero one
    where the step emits a pair: one compilation serves every step."""
    s = ns.ChorinSolver(cfg.replace(use_pallas=True))
    assert s._advect_flat is not None and s._pallas is not None
    step = jax.jit(s.step)
    _JIT_STEPS[s] = step
    st = s.init_state()
    if s.acc_pallas != "none":
        st = st.replace(pr_lo=jnp.zeros_like(st.pr))
    states, stats = [_np_state(st)], []
    for _ in range(nsteps):
        st, sts = step(st)
        states.append(_np_state(st))
        stats.append(sts)
    return s, states, stats


@pytest.fixture(scope="module")
def jax_runs():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NS3D_FUSED_INTERPRET", "1")
        multi = ns.preset_multi(nx=NX, dtype="float32", compat=False)
        gpu = ns.preset_gpu(nx=NX, dtype="float32", compat=False)
        runs = {
            "multi 1e-3": _jax_steps(multi, NSTEPS),
            "multi 1e-9": _jax_steps(_with(multi, eps_it=1e-9), NSTEPS),
            "gpu extended": _jax_steps(_with(gpu, accuracy="extended"), 2),
            "gpu none": _jax_steps(_with(gpu, accuracy="none"), 2),
            "gpu unsplit": _jax_steps(_with(gpu, pressure_split=False,
                                            eps_it=5e-3), 2),
        }
    assert runs["multi 1e-3"][0].acc_pallas == "extended"
    return runs


def _port(name):
    multi = nt.preset_multi(nx=NX, dtype="float32", compat=False)
    gpu = nt.preset_gpu(nx=NX, dtype="float32", compat=False)
    cfg = {"multi 1e-3": multi,
           "multi 1e-9": _with(multi, eps_it=1e-9),
           "gpu extended": _with(gpu, accuracy="extended"),
           "gpu none": _with(gpu, accuracy="none"),
           "gpu unsplit": _with(gpu, pressure_split=False,
                                eps_it=5e-3)}[name]
    return nt.ChorinSolver(cfg, device="cpu")


def _compare_pr(got, want, tol, msg):
    scale = max(1.0, np.abs(want).max())
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=tol,
                               err_msg=msg)


def _counts(stats):
    ext = stats.iters_ext
    return (int(stats.iters), None if ext is None else int(ext),
            int(stats.advect_clamped))


def _check_state(s, st, divv, eps_it):
    for k in FIELDS + ("pr_lo",):
        assert bool(torch.isfinite(getattr(st, k)).all()), k
    assert s.stored_residual_err(st, divv=divv) < eps_it


def test_multi_init_state_matches_jax(jax_runs):
    _, states, _ = jax_runs["multi 1e-3"]
    st = _port("multi 1e-3").init_state()
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(st, k).numpy(), states[0][k])
    assert st.pr_lo is None
    assert bool((st.vx[0] == 1.0).all())


def _compare_step(got, want, tol, faults, msg):
    """One step's output against the JAX step's from the same state: pr
    within tol of max|pr|, the advected fields within 1e-5 of their max
    everywhere but at the points where the source's departure corner
    reads the next cell (tests/advect_faults.py)."""
    _compare_pr(got.pr.numpy(), want["pr"], tol, f"pr {msg}")
    for k in ("vx", "vy", "vz", "c"):
        far = np.abs(getattr(got, k).numpy() - want[k]) > 1e-5 * max(
            1.0, np.abs(want[k]).max())
        far &= ~faults[k]
        assert not far.any(), (k, msg, np.argwhere(far)[:5])


def _jax_state(st):
    """The port's state as the JAX step's input, with a zero pr_lo where
    the port's has none (the step does not read it)."""
    fields = {k: jnp.asarray(getattr(st, k).numpy()) for k in FIELDS}
    lo = st.pr_lo
    fields["pr_lo"] = (jnp.zeros_like(fields["pr"]) if lo is None
                       else jnp.asarray(lo.numpy()))
    return ns.FlowState(**fields)


def test_multi_f32_main_path_matches_jax(jax_runs, monkeypatch):
    """eps_it=1e-3: K2 skipped, counts equal, 3 steps from init_state.
    The port's own trajectory leaves the JAX package's where the source's
    departure corner reads the next cell (tests/advect_faults.py), by
    7.7e-3 of max|pr| at step 3, so each step is held against the JAX
    step from the same state, twice: along the port's own chained
    trajectory (the JAX step from the port's state before it), and from
    the JAX state before it. Both agree with `_compare_step`'s standard,
    and the counts with the JAX chain's."""
    js, states, stats = jax_runs["multi 1e-3"]
    jstep = _JIT_STEPS[js]
    s = _port("multi 1e-3")
    assert s.acc == "extended"
    faults = advect_faults.record_advect(monkeypatch)
    st = s.init_state()
    for step, tol in enumerate((1e-5, 1e-3, 1e-3)):
        divv = s.predictor_divv(st)
        with monkeypatch.context() as mp:
            mp.setenv("NS3D_FUSED_INTERPRET", "1")
            jst, jstats = jstep(_jax_state(st))
        st, got = s.step(st)
        assert _counts(got) == _counts(stats[step]), f"step {step}"
        assert _counts(got) == _counts(jstats), f"step {step}"
        assert got.iters_ext == 0 and got.err < 1e-3
        _check_state(s, st, divv, 1e-3)
        assert not bool(st.pr_lo.any())   # phase 1 alone: lo = 0
        _compare_step(st, _np_state(jst), tol, faults[-1],
                      f"chained step {step}")
        one, got = s.step(nt.state_from_numpy(states[step], device="cpu"))
        assert _counts(got) == _counts(stats[step]), f"step {step}"
        _compare_step(one, states[step + 1], tol, faults[-1],
                      f"step {step} from the JAX state")


def test_multi_f32_k2_path_matches_jax(jax_runs):
    """eps_it=1e-9: K2 runs on every step of both programs; each step
    from the JAX state."""
    _, states, stats = jax_runs["multi 1e-9"]
    s = _port("multi 1e-9")
    nchk = s.grid.nchk
    for step in range(NSTEPS):
        st = nt.state_from_numpy(states[step], device="cpu")
        divv = s.predictor_divv(st)
        st, got = s.step(st)
        want = _counts(stats[step])
        assert got.iters_ext > 0 and want[1] > 0, (got.iters_ext, want)
        assert abs(got.iters - want[0]) <= 2 * nchk, (got.iters, want)
        assert abs(got.iters_ext - want[1]) <= nchk, (got.iters_ext, want)
        assert got.advect_clamped == want[2]
        assert got.iters < s.grid.niter and got.err < 1e-9
        _check_state(s, st, divv, 1e-9)
        _compare_pr(st.pr.numpy(), states[step + 1]["pr"], 1e-5,
                    f"pr step {step}")


def test_multi_k2_path_from_init_state(jax_runs):
    """The port's own 3 steps from init_state at eps_it=1e-9: K2 runs and
    every stored pair meets eps_it; K2's count stays within one check
    of the JAX package's, the total within two."""
    _, _, stats = jax_runs["multi 1e-9"]
    s = _port("multi 1e-9")
    nchk = s.grid.nchk
    st = s.init_state()
    for step in range(NSTEPS):
        divv = s.predictor_divv(st)
        st, got = s.step(st)
        want = _counts(stats[step])
        assert got.iters_ext > 0
        assert abs(got.iters - want[0]) <= 2 * nchk, (step, got.iters, want)
        assert abs(got.iters_ext - want[1]) <= nchk, (step, got.iters_ext,
                                                      want)
        _check_state(s, st, divv, 1e-9)


def test_multi_state_carried_across(jax_runs):
    """state_from_numpy(JAX state after step 1, pr_lo set by K2) -> one
    port step is the JAX step 2 from the same state: the stored pair's
    value hi + lo within 1e-5 of max|pr| (lo alone is rounding-level: a
    1-ulp move of hi shifts it by the same amount)."""
    _, states, stats = jax_runs["multi 1e-9"]
    assert states[1]["pr_lo"] is not None and states[1]["pr_lo"].any()
    st = nt.state_from_numpy(states[1], device="cpu")
    back = nt.state_to_numpy(st)
    for k in FIELDS + ("pr_lo",):
        np.testing.assert_array_equal(back[k], states[1][k])
        assert getattr(st, k).dtype == torch.float32
    st, got = _port("multi 1e-9").step(st)
    assert got.advect_clamped == int(stats[1].advect_clamped)
    pair = st.pr.double().numpy() + st.pr_lo.double().numpy()
    want = states[2]["pr"].astype(np.float64) + states[2]["pr_lo"]
    _compare_pr(pair, want, 1e-5, "pr + pr_lo")


@pytest.mark.parametrize("acc", ["extended", "none"])
def test_gpu_accuracy_setting_matches_jax(jax_runs, acc):
    """The gpu preset with accuracy='extended' (phase 1 to eps_it, then
    K2 when it stalls above) and 'none' (K1 alone over the whole budget),
    each step from the JAX state: step 1 has equal counts; step 2 (the
    one that clamps 116 advection points) exits on a check value within
    float32 evaluation noise of eps_it (8.5e-4 in the JAX run), so its
    iteration count may move by one check (nchk). pr within 1e-5."""
    js, states, stats = jax_runs[f"gpu {acc}"]
    s = _port(f"gpu {acc}")
    assert s.acc == js.acc_pallas == acc
    for step in range(2):
        st = nt.state_from_numpy(states[step], device="cpu")
        divv = s.predictor_divv(st)
        st, got = s.step(st)
        want = _counts(stats[step])
        if step == 0:
            assert _counts(got) == want
        assert abs(got.iters - want[0]) <= s.grid.nchk, (got.iters, want)
        assert (got.iters_ext, got.advect_clamped) == want[1:]
        assert got.err < 1e-3
        assert (st.pr_lo is None) == (acc == "none")
        if acc == "extended":
            _check_state(s, st, divv, 1e-3)
        _compare_pr(st.pr.numpy(), states[step + 1]["pr"], 1e-5,
                    f"pr step {step}")


def test_gpu_unsplit_matches_jax(jax_runs):
    """The gpu preset without the hydrostatic split (the unsplit planes,
    init and (hi, lo) pair BCs; the extended hybrid) at eps_it=5e-3, where
    the unsplit float32 check value exits on eps_it and not at its noise
    floor (tests/test_pallas.py:155-160): each step from the JAX state
    takes the JAX counts (step 2 clamps 116 advection points), pr within
    1e-5 of max|pr|."""
    js, states, stats = jax_runs["gpu unsplit"]
    s = _port("gpu unsplit")
    assert not s.pressure_split and not js.pressure_split
    assert s.acc == js.acc_pallas == "extended"
    np.testing.assert_array_equal(s.init_state().pr.numpy(),
                                  states[0]["pr"])
    for step in range(2):
        st, got = s.step(nt.state_from_numpy(states[step], device="cpu"))
        assert _counts(got) == _counts(stats[step])
        _compare_pr(st.pr.numpy(), states[step + 1]["pr"], 1e-5,
                    f"pr step {step}")


if __name__ == "__main__":
    # Per-step counts of the multi preset (float32, compat=False) from
    # init_state: the JAX package's Pallas interpret path (which
    # chip_smoke.py holds the port against), the port's plain path, and
    # the port stepped from each JAX state:
    #   python tests/test_torch_slice_multi.py NX NSTEPS [EPS_IT]
    # (XLA_FLAGS=--xla_cpu_max_isa=AVX in the environment turns XLA's FMA
    # contraction off.)
    import os
    import sys
    os.environ["NS3D_FUSED_INTERPRET"] = "1"
    jax.config.update("jax_platforms", "cpu")
    nx, nsteps = int(sys.argv[1]), int(sys.argv[2])
    eps = float(sys.argv[3]) if len(sys.argv) > 3 else 1e-3
    cfg = _with(ns.preset_multi(nx=nx, dtype="float32", compat=False),
                eps_it=eps)
    _, states, stats = _jax_steps(cfg, nsteps)
    port = nt.ChorinSolver(
        _with(nt.preset_multi(nx=nx, dtype="float32", compat=False),
              eps_it=eps), device="cpu")
    st = port.init_state()
    for i, sts in enumerate(stats):
        st, own = port.step(st)
        _, from_jax = port.step(nt.state_from_numpy(states[i], device="cpu"))
        print(f"step {i + 1}: JAX iters {int(sts.iters)} iters_ext "
              f"{int(sts.iters_ext)} err {float(sts.err):.6e} clamped "
              f"{int(sts.advect_clamped)}; port {_counts(own)}, "
              f"from the JAX state {_counts(from_jax)}")
