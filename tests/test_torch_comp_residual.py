"""K13, the compensated residual, on the CPU: the operator's quad rows
(the layout the kernel reads), both wrappers' CPU route (the plain
versions, whose results the kernel must reproduce bitwise on the card:
tests/test_torch_cuda.py), the solver's routes by dtype, the plain
versions' answers on non-finite inputs, and the kernel's operand checks.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import navierstokes3d_tpu_torch as nt
from navierstokes3d_tpu_torch import kernels
from navierstokes3d_tpu_torch.kernels import poisson as kp
from navierstokes3d_tpu_torch.ops import ds

INNER = (slice(1, -1),) * 3


def _solver(preset, dtype="float32", **kw):
    make = nt.preset_gpu if preset == "gpu" else nt.preset_multi
    return nt.ChorinSolver(make(nx=15, compat=False, dtype=dtype, **kw),
                           device="cpu")


def _inputs(s, seed=0):
    """A pressure pair and the defect phase's whole-grid rhs pair."""
    rng = np.random.default_rng(seed)
    shape = s.grid.shape_c
    hi = torch.tensor(rng.normal(size=shape).astype(np.float32) * 50.0)
    lo = torch.tensor(rng.normal(size=shape).astype(np.float32) * 3e-6)
    rh, rl = ds.rhs_pair(s.predictor_divv(s.init_state()),
                         s.cfg.physics.rho / s.grid.dt, s._z_hoist)
    return hi, lo, rh, rl


@pytest.mark.parametrize("preset", ["gpu", "multi"])
def test_quad_rows_pack_each_axis_quads(preset):
    op = _solver(preset)._op
    for a, n in zip("xyz", _solver(preset).grid.shape_c):
        rows = op.quad_rows[a]
        assert rows.shape == (n - 2, 8) and rows.dtype == torch.float32
        assert rows.is_contiguous()
        for half, side in ((slice(0, 4), "m"), (slice(4, 8), "p")):
            want = torch.stack([q.reshape(-1) for q in op.quads[a + side]],
                               dim=1)
            assert torch.equal(rows[:, half], want)


@pytest.mark.parametrize("preset", ["gpu", "multi"])
def test_cpu_route_of_the_single_word_is_the_plain_version(preset):
    s = _solver(preset)
    hi, _, rh, rl = _inputs(s)
    kernels.reset_counts()
    r, e = kp.compensated_residual(hi, rh, rl, s._op)
    r0, e0 = kp.compensated_residual_plain(hi, rh, rl, s._op)
    assert torch.equal(r, r0) and torch.equal(e, e0)
    assert r.shape == hi.shape and e.shape == ()
    assert kp.compensated_residual.launches == 0
    assert kp.compensated_residual_plain.calls == 2
    ring = torch.ones_like(r, dtype=torch.bool)
    ring[INNER] = False
    assert bool((r[ring] == 0).all()) and float(e) > 0.0
    assert float(e) == float(r.abs().max())


@pytest.mark.parametrize("preset", ["gpu", "multi"])
def test_cpu_route_of_the_pair_is_the_plain_version(preset):
    s = _solver(preset)
    hi, lo, rh, rl = _inputs(s)
    kernels.reset_counts()
    for rhs in ((rh[INNER], rl[INNER]),
                (rh[INNER].contiguous(), rl[INNER].contiguous())):
        r, e = kp.pair_residual(hi, lo, *rhs, s._op)
        m = kp.pair_residual_max(hi, lo, *rhs, s._op)
        r0, e0 = kp.pair_residual_plain(hi, lo, *rhs, s._op)
        assert torch.equal(r, r0) and torch.equal(e, e0)
        assert torch.equal(m, e0) and r.shape == rhs[0].shape
        # the solver's own evaluation is the same function
        r1, e1 = s._comp_residual(hi, lo, *rhs)
        assert torch.equal(r1, r0) and torch.equal(e1, e0)
    assert kp.pair_residual.launches == 0
    assert kp.pair_residual_plain.calls == 8
    kernels.reset_counts()
    assert kp.pair_residual_plain.calls == 0
    assert kp.compensated_residual_plain.calls == 0


@pytest.mark.parametrize("dtype,use_pallas,plain", [
    ("float32", None, False), ("float64", None, True),
    ("float32", False, True)])
def test_solver_routes_by_the_dtype_rule(dtype, use_pallas, plain):
    """float32 takes the wrappers (CPU tensors then run the plain
    versions, CUDA tensors launch K13); float64 and use_pallas=False take
    the plain versions on every device, as the other kernels do."""
    cfg = nt.preset_gpu(nx=15, compat=False, dtype=dtype)
    if use_pallas is not None:
        cfg = cfg.replace(use_pallas=use_pallas)
    for device in ("cpu", "meta"):
        s = nt.ChorinSolver(cfg, device=device)
        assert s.plain == plain
        assert s._compensated_residual is (
            kp.compensated_residual_plain if plain
            else kp.compensated_residual)
        assert s._pair_residual is (kp.pair_residual_plain if plain
                                    else kp.pair_residual)
        if not plain:
            assert s._pair_residual_max is kp.pair_residual_max


def test_float64_solver_evaluates_the_stored_pair_plainly():
    s = _solver("gpu", dtype="float64")
    st = s.init_state()
    kernels.reset_counts()
    err = s.stored_residual_err(st, state_before=st)
    assert np.isfinite(err) and err.dtype == np.float64
    assert kp.pair_residual_plain.calls == 1
    assert kp.pair_residual.launches == 0


@pytest.mark.parametrize("what", ["nan_p", "inf_p", "inf_rhs_lo"])
def test_plain_versions_on_non_finite_inputs(what):
    """What the kernel's max over float bits must reproduce: a NaN in p
    gives a NaN max|r|; an inf in p a NaN too (the error-free
    transformations take inf - inf); an inf in the rhs's lo word an inf
    r and max|r| = +inf."""
    s = _solver("gpu")
    hi, lo, rh, rl = _inputs(s, seed=1)
    cell = (7, 4, 5)
    if what == "nan_p":
        hi[cell] = math.nan
    elif what == "inf_p":
        hi[cell] = math.inf
    else:
        rl[cell] = math.inf
    got = [float(kp.compensated_residual(hi, rh, rl, s._op)[1]),
           float(kp.pair_residual_max(hi, lo, rh[INNER], rl[INNER],
                                      s._op))]
    for g in got:
        assert math.isinf(g) and g > 0 if what == "inf_rhs_lo" \
            else math.isnan(g)


def test_other_devices_raise():
    s = nt.ChorinSolver(nt.preset_gpu(nx=15, compat=False,
                                      dtype="float32"), device="meta")
    t = torch.empty(s.grid.shape_c, device="meta")
    inner = t[INNER]
    with pytest.raises(ValueError, match="no kernel or plain version"):
        kp.compensated_residual(t, t, t, s._op)
    with pytest.raises(ValueError, match="no kernel or plain version"):
        kp.pair_residual(t, t, inner, inner, s._op)
    with pytest.raises(ValueError, match="no kernel or plain version"):
        kp.pair_residual_max(t, t, inner, inner, s._op)


@pytest.mark.parametrize("fault", [
    "ok", "ok_pair_views", "lo_dtype", "rhs_shape", "rhs_z_stride",
    "rhs_device", "r_shape", "small_grid", "quad_rows"])
def test_k13_operand_checks(fault):
    """The checks before a launch (run here on CPU tensors standing in
    for the card's): words of one contiguous float32 shape, an
    interior-shaped rhs pair with contiguous z rows (any x and y
    strides), r of the form's shape, the quad rows of the grid."""
    s = _solver("gpu")
    op = s._op
    hi, lo, rh, rl = _inputs(s)
    words, rhs, r = (hi, lo), (rh[INNER], rl[INNER]), None
    if fault == "ok":
        words, r = (hi,), torch.empty_like(hi)
        rhs = (rh[INNER].contiguous(), rl[INNER].contiguous())
    elif fault == "lo_dtype":
        words = (hi, lo.double())
    elif fault == "rhs_shape":
        rhs = (rh, rl)
    elif fault == "rhs_z_stride":
        shape = rh[INNER].shape
        rhs = (torch.zeros(shape[::-1]).permute(2, 1, 0), rl[INNER])
        assert rhs[0].shape == shape and rhs[0].stride(2) != 1
    elif fault == "rhs_device":
        rhs = (rh[INNER], torch.empty(rhs[1].shape, device="meta"))
    elif fault == "r_shape":
        r = torch.empty_like(hi)
    elif fault == "small_grid":
        words, rhs = (hi[:2], lo[:2]), (rh[:0, 1:-1, 1:-1],) * 2
    elif fault == "quad_rows":
        op = dataclasses.replace(s._op, quad_rows=dict(
            s._op.quad_rows, y=s._op.quad_rows["y"][:-1]))
    if fault.startswith("ok"):
        kp._check_k13("k13", words, *rhs, r, op)
    else:
        with pytest.raises(ValueError):
            kp._check_k13("k13", words, *rhs, r, op)
