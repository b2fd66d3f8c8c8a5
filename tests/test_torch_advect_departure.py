"""The advection's departure cell at the points where the rounded i - dl
lands on a whole number (ops/advect.py `departure_cell`).

The source takes the corner from floor(fl(i - dl)) and the fraction t =
(dl > 0) - fmod(dl, 1) from dl (gpu.jl:290-299). Where 0 < dl is below half
an ulp of i (or dl lies that close above a whole number, or below a
negative one), fl(i - dl) rounds onto the next whole number while t does
not move, and the point reads the cell next to its own. The port's
non-compat corner is i - ceil(dl), floor(i - dl) computed exactly: the
gather, the select-shift backtrack, K5's plain version (`ka.advect`) and
K6's (`advect_branch_pre_plain`) read the exact interpolation there, and
move no other point. compat=True keeps the source's expressions: the
gather and the select-shift backtrack read the next cell there, as the
scalar transcription of the source (tests/oracle_scalar.py) and the JAX
package do.

The tracer C varies along x only and is advected with a uniform
displacement dl along x (dt = dx = 1, so dl is the velocity itself, and
the face averages of a uniform field are exact); every x index i of the
grid is a point, and `_fault` marks those where floor(fl(i - dl)) differs
from i - ceil(dl)."""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle_scalar as orc
from navierstokes3d_tpu.ops.advect import advect as jadvect
from navierstokes3d_tpu_torch.kernels import advect as ka
from navierstokes3d_tpu_torch.kernels.fused_step import StepConsts
from navierstokes3d_tpu_torch.ops import advect as tadv

torch.set_num_threads(2)
NX, NY, NZ = 24, 3, 3
# the points compared: no corner of the source's or the exact formula
# clamps there (|dl| <= 1 + ulp), so select-shift's one-corner weight
# (1 - t) + t at a clamped edge is left out
CORE = np.zeros(NX, dtype=bool)
CORE[2:NX - 2] = True
DTYPES = {"float32": np.float32, "float64": np.float64}


def _tiny(np_dtype):
    """A positive dl below half an ulp of every i >= 3."""
    return np_dtype(np.spacing(np_dtype(2.0)) / 4)


def _dls(name):
    """The displacements of the cases: (label, dl, fault expected)."""
    f = DTYPES[name]
    one = f(1.0)
    return [("tiny", _tiny(f), True),
            ("whole_plus", np.nextafter(one, f(2.0)), True),
            ("minus_whole_minus", -np.nextafter(one, f(0.0)), True),
            ("zero", f(0.0), False),
            ("whole", one, False),
            ("minus_whole", -one, False),
            ("negative", f(-0.3), False),
            ("positive", f(0.7), False)]


CASES = [(name, label) for name in DTYPES for label, _, _ in _dls(name)]


def _case(name, label):
    f = DTYPES[name]
    dl = {lab: d for lab, d, _ in _dls(name)}[label]
    rng = np.random.default_rng(3)
    prof = rng.uniform(-1.0, 1.0, size=NX).astype(f)
    c = np.broadcast_to(prof[:, None, None], (NX, NY, NZ)).copy()
    vx = np.full((NX + 1, NY, NZ), dl, dtype=f)
    vy = np.zeros((NX, NY + 1, NZ), dtype=f)
    vz = np.zeros((NX, NY, NZ + 1), dtype=f)
    return dl, prof, c, vx, vy, vz


def _fault(dl, np_dtype):
    """x indices (1-based) where the rounded i - dl crosses a whole
    number: floor(fl(i - dl)) != i - ceil(dl)."""
    i = np.arange(1, NX + 1, dtype=np_dtype)
    return np.floor(i - np_dtype(dl)) != i - np.ceil(np_dtype(dl))


def _exact(prof, dl):
    """The trilinear interpolant at x = i - dl in exact arithmetic
    (t = x - floor(x)), with the gather's clamp of the corners; NaN where
    a corner clamps (the fraction is then the source's, not x's)."""
    n, d = len(prof), Fraction(float(dl))
    out = np.full(n, np.nan)
    for i in range(1, n + 1):
        x = i - d
        f = x.numerator // x.denominator
        if 1 <= f and f + 1 <= n:
            t = x - f
            out[i - 1] = float(Fraction(float(prof[f - 1])) * (1 - t)
                               + Fraction(float(prof[f])) * t)
    return out


def _source(prof, dl, np_dtype):
    """The source's value: the corner floor(fl(i - dl)), t = (dl > 0) -
    fmod(dl, 1), in the dtype."""
    n = len(prof)
    i = np.arange(1, n + 1, dtype=np_dtype)
    i1 = np.clip(np.floor(i - np_dtype(dl)), 1, n).astype(int)
    i2 = np.minimum(i1 + 1, n)
    t = np_dtype(dl > 0) - np.fmod(np_dtype(dl), np_dtype(1.0))
    return prof[i2 - 1] * t + prof[i1 - 1] * (np_dtype(1.0) - t)


def _consts():
    return StepConsts(dt=1.0, dx=1.0, dy=1.0, dz=1.0, mu=0.0, rho=1.0,
                      g_eff=0.0, variant="gpu", vin=1.0)


def _along_x(out):
    """The x profile of an advected C (constant over y and z)."""
    out = out.numpy()
    assert (out == out[:, :1, :1]).all()
    return out[:, 0, 0]


def _methods(c, vx, vy, vz, compat):
    """C advected by each method on `c` (CPU tensors): name -> x profile."""
    vels = tadv.face_velocities("c", vx, vy, vz)
    out = {"gather": tadv.backtrack_gather(c, *vels, (1, 1, 1), 1.0, 1.0,
                                           1.0, 1.0, compat=compat),
           "selectshift": tadv.backtrack_selectshift(
               c, *vels, (1, 1, 1), 1.0, 1.0, 1.0, 1.0, 2,
               compat=compat)[0]}
    if not compat:
        out["k5_plain"] = ka.advect(vx, vy, vz, c, _consts(), 2)[3]
        out["k6_plain"] = ka.advect_branch_pre_plain(
            "c", c, *vels, _consts(), 2)[0]
    return {k: _along_x(v) for k, v in out.items()}


@pytest.mark.parametrize("name,label", CASES)
def test_fix_reads_the_exact_interpolation(name, label):
    """Non-compat: the exact x - floor(x) interpolation (to a few ulps of
    the field) at every point where no corner clamps, the fault's points
    included, where the source's formula reads the next cell; at a whole
    positive dl (t = 1 at the corner i - dl) and everywhere off the
    fault's points, the source's value bit for bit."""
    f = DTYPES[name]
    dl, prof, c, vx, vy, vz = _case(name, label)
    fault = _fault(dl, f)
    want_fault = {lab: w for lab, _, w in _dls(name)}[label]
    assert fault.any() == want_fault
    assert (fault & CORE).any() == want_fault
    exact, source = _exact(prof, dl), _source(prof, dl, f)
    tol = 8 * np.finfo(f).eps
    if want_fault:
        # the source's formula reads a[i + 1] for ~a[i]: O(1) off
        assert (np.abs(source - exact)[fault & CORE] > 1e-3).all()
    for method, got in _methods(*map(torch.tensor, (c, vx, vy, vz)),
                                compat=False).items():
        keep = CORE & ~fault
        np.testing.assert_array_equal(got[keep], source[keep],
                                      err_msg=method)
        if label != "whole":
            assert (np.abs(got - exact)[CORE] <= tol).all(), method
        else:
            # the formula's jump at a whole dl > 0 (t = 1): the
            # one-sided value, a[i] for the exact a[i - 1], as the source
            np.testing.assert_array_equal(got[CORE], prof[CORE],
                                          err_msg=method)


@pytest.mark.parametrize("name,label", CASES)
def test_compat_keeps_the_source_expressions(name, label):
    """compat=True: the gather and the select-shift backtrack read the
    source's value bit for bit at every point, the fault's included,
    where they read the next cell; the JAX package's gather and
    select-shift (the source's expressions) agree bit for bit."""
    f = DTYPES[name]
    dl, prof, c, vx, vy, vz = _case(name, label)
    source = _source(prof, dl, f)
    got = _methods(*map(torch.tensor, (c, vx, vy, vz)), compat=True)
    jf = [jnp.asarray(a) for a in (vx, vy, vz, c)]
    for method, prof_got in got.items():
        np.testing.assert_array_equal(prof_got[CORE], source[CORE],
                                      err_msg=method)
        want = jadvect(*jf, 1.0, 1.0, 1.0, 1.0, compat=False, method=method,
                       k=2)[3]
        np.testing.assert_array_equal(
            prof_got, np.asarray(want)[:, 0, 0], err_msg=method)


@pytest.mark.parametrize("label", ["tiny", "whole_plus",
                                   "minus_whole_minus"])
def test_compat_gather_is_the_scalar_transcription(label):
    """In float64, the compat gather of all four fields is the scalar
    transcription of the source (tests/oracle_scalar.py advect) bit for
    bit at the fault's points, and the non-compat gather departs from it
    exactly there (C's branch; the velocities are uniform, so their own
    branches read the same value from either corner)."""
    dl, prof, c, vx, vy, vz = _case("float64", label)
    fault = _fault(dl, np.float64)
    want = orc.advect(vx, vy, vz, c, 1.0, 1.0, 1.0, 1.0, compat=True)
    t = [torch.tensor(a) for a in (vx, vy, vz, c)]
    got = tadv.advect(*t, 1.0, 1.0, 1.0, 1.0, compat=True, method="gather")
    for a, b in zip(got[:4], want):
        np.testing.assert_array_equal(a.numpy(), b)
    fixed = _along_x(tadv.advect(*t, 1.0, 1.0, 1.0, 1.0, compat=False,
                                 method="gather")[3])
    np.testing.assert_array_equal((fixed != want[3][:, 0, 0])[CORE],
                                  fault[CORE])
