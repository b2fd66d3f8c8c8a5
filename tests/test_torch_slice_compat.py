"""The port's compat path, the reference's own semantics (ChorinSolver on
the CPU: float64 iterates the reference's exact form, float32 K7's plain
version), against the repo's references:

  float64 vs tests/oracle_scalar.py (the line-by-line transcription of the
    Julia multi script): equal iteration counts and the tolerances of
    tests/test_step_oracle.py:33-41;
  float64 vs tests/test_golden.py's values (multi nx=63, 3 steps from
    init_state): iterations [37, 259, 296], the Pr probes within rtol
    3e-3, Vz never advected;
  float32 vs the JAX package's compat float32 step with use_pallas=True
    (K7 interpreted, gather advection, the unfused step), 2 steps from
    init_state: equal iteration counts, which exit on eps_it here and not
    at the float32 noise floor, and fields within rtol 1e-3 / atol 1e-4,
    tests/test_pallas.py:191-204's standard (both round each operation in
    float32; XLA contracts FMAs, so a few ulp per iteration). dprdtau is
    not compared: at convergence it integrates the residual's noise
    (docs/numerics.md "Cross-program rounding"). The gpu preset at nx=12
    diverges in both packages (the reference's documented blow-up,
    docs/numerics.md), at the same step and iteration counts.
Also the compat policy (stall exit, advection method, no split or pair)
against the JAX solver's, init_state, and the CLI's --compat."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import oracle_scalar as orc
import navierstokes3d_tpu as ns
import navierstokes3d_tpu_torch as nt
from navierstokes3d_tpu_torch import kernels
from navierstokes3d_tpu_torch import run as trun
from navierstokes3d_tpu_torch.kernels import poisson as kp
from test_golden import INDS_X, INDS_Y, INDS_Z, ITERS_GOLDEN, PR_GOLDEN

torch.set_num_threads(2)
FIELDS = ("pr", "vx", "vy", "vz", "c")
PRESETS = {"multi": (ns.preset_multi, nt.preset_multi),
           "gpu": (ns.preset_gpu, nt.preset_gpu)}


def test_f64_two_steps_vs_oracle():
    nsteps = 2
    ref = orc.run_multi(nx=9, nt=nsteps, compat=True)
    s = nt.ChorinSolver(nt.preset_multi(nx=9, nt=nsteps), device="cpu")
    assert s.dtype == torch.float64 and s.cfg.compat
    state = s.init_state()
    iters = []
    for _ in range(nsteps):
        state, stats = s.step(state)
        iters.append(stats.iters)
    assert iters == ref["iters"]
    tols = dict(pr=5e-3, c=1e-10, vx=5e-5, vy=5e-5, vz=5e-5)
    for name, atol in tols.items():
        np.testing.assert_allclose(getattr(state, name).numpy(), ref[name],
                                   rtol=0, atol=atol, err_msg=name)
    ring = state.dprdtau.clone()
    ring[1:-1, 1:-1, 1:-1] = 0.0
    assert not bool(ring.any())


def test_f64_golden_nx63():
    s = nt.ChorinSolver(nt.preset_multi(nx=63, nt=3), device="cpu")
    state = s.init_state()
    iters = []
    for _ in range(3):
        state, stats = s.step(state)
        iters.append(stats.iters)
    assert iters == ITERS_GOLDEN
    c, pr, vx, vy, vz = nt.gather_inner(state)
    probe = pr[np.ix_(INDS_X, INDS_Y, INDS_Z)]
    np.testing.assert_allclose(probe, PR_GOLDEN, rtol=3e-3, atol=1e-8)
    # Vz is never advected (the reference's advect! bug, gpu.jl:321-326)
    assert np.abs(vz).max() < 1e-10
    # tracer ring: 32 masked (x,y) cells x 38 z-planes stay seeded at 1
    assert abs(float(state.c.sum()) - 1216.0) < 1.0


def _jax_steps(variant, nx, nsteps):
    s = ns.ChorinSolver(PRESETS[variant][0](nx=nx, dtype="float32")
                        .replace(use_pallas=True))
    assert s._pallas is not None and not s._pallas_folded
    assert s.advect_method == "gather" and s._fused_pre is None
    step = jax.jit(s.step)
    st, out = s.init_state(), []
    for _ in range(nsteps):
        st, stats = step(st)
        out.append(({k: np.asarray(getattr(st, k)) for k in FIELDS},
                    int(stats.iters), float(stats.err)))
    return out


@pytest.mark.parametrize("variant,nx", [("multi", 12), ("gpu", 15)])
def test_f32_steps_match_jax(variant, nx):
    want = _jax_steps(variant, nx, 2)
    kernels.reset_counts()
    s = nt.ChorinSolver(PRESETS[variant][1](nx=nx, dtype="float32"),
                        device="cpu")
    st = s.init_state()
    for fields, iters, err in want:
        st, stats = s.step(st)
        assert stats.iters == iters
        assert stats.err < 1e-3 and err < 1e-3
        assert stats.iters_ext is None and st.pr_lo is None
        for k in FIELDS:
            np.testing.assert_allclose(getattr(st, k).numpy(), fields[k],
                                       rtol=1e-3, atol=1e-4, err_msg=k)
    calls = {k.name: k.plain.calls for k in kernels.KERNELS}
    assert calls.pop("K7 poisson_iter_bc") > 0
    assert not any(calls.values()), calls


def test_f32_gpu_blow_up_matches_jax():
    """gpu at nx=12: the +100 Pa head drives the flow past the advection
    CFL and both packages diverge: err inf after 126 iterations of step 1,
    NaN at the first check of step 2."""
    want = _jax_steps("gpu", 12, 2)
    s = nt.ChorinSolver(nt.preset_gpu(nx=12, dtype="float32"), device="cpu")
    st = s.init_state()
    got = []
    for _ in want:
        st, stats = s.step(st)
        got.append((stats.iters, float(stats.err)))
    assert [i for _, i, _ in want] == [i for i, _ in got] == [126, 7]
    for errs in ([e for _, _, e in want], [e for _, e in got]):
        assert np.isposinf(errs[0]) and np.isnan(errs[1])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("variant", ["multi", "gpu"])
def test_init_state_matches_jax(variant, dtype):
    """compat init: the multi inflow plane in Vy (the reference's typo), the
    unsplit gpu hydrostatic pressure."""
    js = ns.ChorinSolver(PRESETS[variant][0](nx=15, dtype=dtype))
    ts = nt.ChorinSolver(PRESETS[variant][1](nx=15, dtype=dtype),
                         device="cpu")
    a, b = ts.init_state(), js.init_state()
    for k in FIELDS + ("dprdtau",):
        np.testing.assert_array_equal(getattr(a, k).numpy(),
                                      np.asarray(getattr(b, k)))
    if variant == "multi":
        assert bool((a.vy[0] == 1.0).all()) and not bool(a.vx.any())
    else:
        assert bool(a.pr.any()) and not ts.pressure_split


@pytest.mark.parametrize("compat", [True, False])
@pytest.mark.parametrize("variant", ["multi", "gpu"])
def test_policy_matches_jax(variant, compat):
    """The stall exit is off under compat with stall_exit=None (on outside
    it), as the JAX solver's _stall; compat has no split, no stored pair
    and gather advection."""
    for stall_exit in (None, True, False):
        kw = dict(nx=15, compat=compat, dtype="float32")
        cj, ct = (p(**kw) for p in PRESETS[variant])
        cj, ct = (c.replace(numerics=dataclasses.replace(
            c.numerics, stall_exit=stall_exit)) for c in (cj, ct))
        js, ts = ns.ChorinSolver(cj), nt.ChorinSolver(ct, device="cpu")
        assert ts._stall == js._stall, stall_exit
        assert ts.pressure_split == js.pressure_split
        assert ts.extended == js.extended
    ts = nt.ChorinSolver(PRESETS[variant][1](**kw), device="cpu")
    assert (ts._stall is None) == compat
    assert ts.advect_method == ("gather" if compat else "selectshift")
    if compat:
        ct = ct.replace(numerics=dataclasses.replace(
            ct.numerics, extended_precision=True))
        with pytest.raises(ValueError, match="compat"):
            nt.ChorinSolver(ct, device="cpu")


def test_use_pallas_false_takes_the_plain_k7():
    cfg = nt.preset_multi(nx=9, dtype="float32")
    a = nt.ChorinSolver(cfg, device="cpu")
    b = nt.ChorinSolver(cfg.replace(use_pallas=False), device="cpu")
    assert b._poisson_iter_bc is kp.poisson_iter_bc_plain
    assert a._poisson_iter_bc is kp.poisson_iter_bc
    sa, ta = a.step(a.init_state())
    sb, tb = b.step(b.init_state())
    assert ta.iters == tb.iters and torch.equal(sa.pr, sb.pr)


def test_cli_compat(capsys):
    assert trun.main(["--preset", "multi", "--nx", "9", "--nt", "2",
                      "--compat", "--dtype", "float64",
                      "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "compat" in out
    assert out.count("step ") == 2
