"""The port's host-driven pt_loop_fused against the JAX package's device
loop, on synthetic step functions (after tests/test_ptloop.py): both must
give the same (iters, err, hist) and carry — the check value is the
residual entering iteration k*nchk, the stall window and err0 seeding
behave alike, and the trailing partial chunk runs unchecked."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokes3d_tpu.ptloop import pt_loop_fused as jax_loop
from navierstokes3d_tpu_torch.ptloop import pt_loop_fused as torch_loop

torch.set_num_threads(2)


def geometric(rate, lib):
    """Carry is a scalar residual x; one iteration multiplies it by rate;
    the emitted err is the value ENTERING the iteration."""
    if lib == "jax":
        return lambda c, it: (c * rate, c, jnp.int32(1))
    return lambda c, it: (c * rate, c, 1)


def sequence(values, lib):
    """Emits values[it] entering iteration it (a scripted residual)."""
    if lib == "jax":
        arr = jnp.asarray(values, jnp.float32)
        return lambda c, it: (c + 1, arr[jnp.minimum(it, len(values) - 1)],
                              jnp.int32(1))
    arr = torch.tensor(values, dtype=torch.float32)
    return lambda c, it: (c + 1, arr[min(it, len(values) - 1)], 1)


def run_both(make, x0, it0, niter, nchk, nchunks, eps, **kw):
    cj, ij, ej, hj = jax_loop(make("jax"), jnp.asarray(x0, jnp.float32),
                              it0, niter, nchk, nchunks, eps, jnp.float32,
                              **{k: (jnp.asarray(v, jnp.float32)
                                     if k == "err0" else v)
                                 for k, v in kw.items()})
    ct, it_, et, ht = torch_loop(make("torch"),
                                 torch.tensor(x0, dtype=torch.float32),
                                 it0, niter, nchk, nchunks, eps,
                                 torch.float32, **kw)
    assert int(ij) == it_
    assert np.float32(ej) == et or (np.isnan(ej) and np.isnan(et))
    assert et.dtype == np.float32
    np.testing.assert_array_equal(np.asarray(hj), ht)
    np.testing.assert_array_equal(np.asarray(cj), ct.numpy())
    return it_, et, ht


def test_converges_before_budget():
    it, err, hist = run_both(lambda lib: geometric(0.5, lib), 1.0, 0, 40, 4,
                             10, 1e-3)
    assert it == 12  # 0.5**11 < 1e-3 is first seen at the 3rd check


@pytest.mark.parametrize("rem", [0, 3])
def test_budget_exhaustion_runs_the_unchecked_tail(rem):
    nchk, nchunks = 4, 3
    it, err, hist = run_both(lambda lib: geometric(0.99, lib), 1.0, 1,
                             nchunks * nchk + rem, nchk, nchunks, 1e-8)
    assert it == nchunks * nchk + rem
    assert not np.isnan(hist).any()


def test_stall_exit():
    def flat(lib):
        if lib == "jax":
            return lambda c, it: (c, c, jnp.int32(1))
        return lambda c, it: (c, c, 1)
    it, _, _ = run_both(flat, 1.0, 0, 100, 2, 50, 1e-8, stall=(0.95, 3))
    assert it < 100


def test_noisy_floor_trips_the_window():
    vals = [1.0, 0.5, 0.44, 0.51, 0.48, 0.46, 0.5, 0.47, 0.45, 0.5, 0.48,
            0.46] * 4
    it, _, _ = run_both(lambda lib: sequence(vals, lib), 0.0, 0, 48, 1, 48,
                        1e-3, stall=(0.9, 3))
    assert it < 48


def test_marginal_threshold_compares_in_float32():
    """A check value equal to f32(eps) < eps keeps the loop running, as in
    JAX: a float64 comparison against the Python eps would exit."""
    eps = 0.7
    e32 = np.float32(eps)
    assert float(e32) < eps
    vals = [1.0, 0.9, float(e32), float(e32), float(e32), float(e32)]
    it, err, _ = run_both(lambda lib: sequence(vals, lib), 0.0, 0, 6, 2, 3,
                          eps)
    assert it == 6 and err == e32


@pytest.mark.parametrize("err0", [5e-4, 2.0])
def test_err0_seeding(err0):
    """err0 below eps makes the loop a no-op; above it, the loop runs."""
    it, err, _ = run_both(lambda lib: geometric(0.7, lib), 1.0, 0, 40, 4,
                          10, 1e-3, stall=(0.96, 5), err0=err0)
    assert (it == 0) == (err0 < 1e-3)


def test_plain_python_scalars_as_err():
    """step_fn may emit host scalars (numpy or Python) as well as tensors."""
    carry, it, err, hist = torch_loop(
        lambda c, it: (c * 0.5, np.float32(c), 1), 1.0, 0, 40, 4, 10, 1e-3,
        np.float32)
    assert it == 12 and isinstance(err, np.float32)
