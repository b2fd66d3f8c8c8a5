"""The port's host-driven pt_loop_fused and pt_loop against the JAX
package's device loops, on synthetic step functions (after
tests/test_ptloop.py): both must give the same (iters, err, hist) and
carry — the check value is the residual entering iteration k*nchk
(pt_loop_fused) or a residual evaluated after each chunk (pt_loop), the
stall window and err0 seeding behave alike, and the trailing partial chunk
runs unchecked, in pt_loop only on an unconverged budget exhaustion. Also
pt_loop_device, whose body takes each exit decision itself (ExitRule),
against pt_loop_fused on scripted check values, and its refusal of a
body that decided otherwise than ExitRule."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokes3d_tpu.ptloop import pt_loop as jax_chunks
from navierstokes3d_tpu.ptloop import pt_loop_fused as jax_loop
from navierstokes3d_tpu_torch.ptloop import pt_loop as torch_chunks
from navierstokes3d_tpu_torch.ptloop import pt_loop_device
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
    """kw as the loops take it; err0 a number, tail_fn a maker as `make`."""
    def args(lib):
        out = dict(kw)
        if "err0" in kw and lib == "jax":
            out["err0"] = jnp.asarray(kw["err0"], jnp.float32)
        if "tail_fn" in kw:
            out["tail_fn"] = kw["tail_fn"](lib)
        return out
    cj, ij, ej, hj = jax_loop(make("jax"), jnp.asarray(x0, jnp.float32),
                              it0, niter, nchk, nchunks, eps, jnp.float32,
                              **args("jax"))
    ct, it_, et, ht = torch_loop(make("torch"),
                                 torch.tensor(x0, dtype=torch.float32),
                                 it0, niter, nchk, nchunks, eps,
                                 torch.float32, **args("torch"))
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


def _tail(lib):
    """The trailing partial chunk: scales the carry, so the result shows
    whether it ran."""
    return lambda c: c * 0.25


def _checked(values, nchk=4, n=24):
    """A scripted residual whose k-th check (entering iteration k*nchk)
    reads values[k-1], the last value from then on."""
    out = [values[0]] * n
    for k in range(1, n // nchk + 1):
        out[k * nchk - 1] = values[min(k, len(values)) - 1]
    return out


@pytest.mark.parametrize("make,eps,stall,rem,ran", [
    # the budget runs out unconverged: the tail runs
    (lambda lib: geometric(0.99, lib), 1e-8, None, 3, True),
    (lambda lib: geometric(0.99, lib), 1e-8, (0.999, 2), 5, True),
    # converged at a check, or no tail to run: it does not
    (lambda lib: geometric(0.5, lib), 1e-3, None, 3, False),
    (lambda lib: geometric(0.99, lib), 1e-8, None, 0, False),
    # stalled at the last check, or a non-finite err: it does not
    (lambda lib: sequence(_checked([1.0, 0.5, 0.25, 0.125, 0.3]), lib),
     1e-8, (0.95, 2), 3, False),
    (lambda lib: sequence(_checked([1.0, float("nan")]), lib), 1e-8, None,
     3, False),
])
def test_tail_runs_only_on_unconverged_exhaustion(make, eps, stall, rem,
                                                  ran):
    """rem/tail_fn (JAX ptloop.py:118-129): after a loop over the checked
    budget, the tail's `rem` iterations run only where the budget ran out
    without convergence, a non-finite err or a stall: the same iteration
    count, err, history and carry in both packages."""
    nchk, nchunks = 4, 5
    it, err, hist = run_both(make, 1.0, 0, nchunks * nchk, nchk, nchunks,
                             eps, stall=stall, rem=rem, tail_fn=_tail)
    assert (it == nchunks * nchk + rem and rem > 0) == ran


def test_plain_python_scalars_as_err():
    """step_fn may emit host scalars (numpy or Python) as well as tensors."""
    carry, it, err, hist = torch_loop(
        lambda c, it: (c * 0.5, np.float32(c), 1), 1.0, 0, 40, 4, 10, 1e-3,
        np.float32)
    assert it == 12 and isinstance(err, np.float32)


@pytest.mark.parametrize("stall", [None, (0.95, 3)])
def test_seed0_matches_unseeded_loop(stall):
    """seed0=True (tests/test_ptloop.py:97-123): the caller ran the whole
    first chunk (a resident-chunk launch of nit = nchk), err0 is the k = 0
    check; the seeded loop gives the unseeded loop's (iters, err, hist)
    in both packages, also for an err0 of shape (1, 1) like K10's."""
    nchk, nchunks, rate = 4, 10, 0.9
    it1, err1, hist1 = run_both(lambda lib: geometric(rate, lib), 1.0, 0,
                                nchunks * nchk, nchk, nchunks, 1e-3,
                                stall=stall)
    carry_pre = np.float32(1.0) * np.float32(rate) ** nchk
    err0 = np.float32(1.0) * np.float32(rate) ** (nchk - 1)
    it2, err2, hist2 = run_both(lambda lib: geometric(rate, lib), carry_pre,
                                nchk, nchunks * nchk, nchk, nchunks, 1e-3,
                                stall=stall, err0=err0, seed0=True)
    assert it1 == it2
    np.testing.assert_allclose(err2, err1, rtol=1e-6)
    np.testing.assert_allclose(hist2, hist1, rtol=1e-6)
    _, it3, err3, hist3 = torch_loop(
        geometric(rate, "torch"), torch.tensor(carry_pre), nchk,
        nchunks * nchk, nchk, nchunks, 1e-3, torch.float32, stall=stall,
        err0=torch.full((1, 1), float(err0)), seed0=True)
    assert (it3, err3) == (it2, err2)
    np.testing.assert_array_equal(hist3, hist2)


def test_seed0_stall_window_is_seeded():
    """tests/test_ptloop.py:126-142: the seeded k = 0 check enters the
    stall window, so a flat residual exits at the same iteration."""
    nchk, nchunks = 2, 50

    def flat(lib):
        if lib == "jax":
            return lambda c, it: (c, c, jnp.int32(1))
        return lambda c, it: (c, c, 1)
    it1, err1, _ = run_both(flat, 1.0, 0, nchunks * nchk, nchk, nchunks,
                            1e-8, stall=(0.95, 3))
    it2, err2, _ = run_both(flat, 1.0, nchk, nchunks * nchk, nchk, nchunks,
                            1e-8, stall=(0.95, 3), err0=1.0, seed0=True)
    assert it1 == it2 < nchunks * nchk and err1 == err2


@pytest.mark.parametrize("it0,err0", [(3, 0.5), (4, None)])
def test_seed0_requires_full_first_chunk(it0, err0):
    """tests/test_ptloop.py:145-153: seed0 needs err0 and it0 == nchk."""
    with pytest.raises(ValueError, match="seed0"):
        torch_loop(geometric(0.9, "torch"), torch.tensor(1.0), it0, 40, 4,
                   10, 1e-3, torch.float32, err0=err0, seed0=True)


# ---- pt_loop: the reference's chunk loop (compat) ----

def chunks_both(values, nchunks, nchk, rem, eps, stall=None):
    """pt_loop in both packages on a scripted residual: the carry pr counts
    the iterations run (dpr the run_iters calls), and the check after the
    chunk that ends at iteration i reads values[i // nchk - 1] (the last
    value past the end)."""
    last = len(values) - 1
    arr_j = jnp.asarray(values, jnp.float32)
    arr_t = torch.tensor(values, dtype=torch.float32)

    def run_j(p, d, n, k):
        return p + n, d + 1

    def err_j(p):
        return arr_j[jnp.minimum(p.astype(jnp.int32) // nchk - 1, last)]

    def err_t(p):
        return arr_t[min(int(p.item()) // nchk - 1, last)]

    zero = np.zeros((), np.float32)
    pj, dj, ij, ej, hj = jax_chunks(run_j, err_j, jnp.asarray(zero),
                                    jnp.asarray(zero), nchunks, nchk, rem,
                                    eps, jnp.float32, stall=stall)
    pt, dt, it_, et, ht = torch_chunks(run_j, err_t, torch.tensor(zero),
                                       torch.tensor(zero), nchunks, nchk,
                                       rem, eps, torch.float32, stall=stall)
    assert int(ij) == it_ == int(pt.item())
    assert float(dj) == float(dt.item())
    assert np.float32(ej) == et or (np.isnan(ej) and np.isnan(et))
    assert et.dtype == np.float32
    np.testing.assert_array_equal(np.asarray(hj), ht)
    return it_, et, ht


def test_chunks_converge_at_a_check():
    it, err, hist = chunks_both([1.0, 0.1, 5e-4, 1e-5], 10, 4, 3, 1e-3)
    assert it == 12 and err == np.float32(5e-4)
    assert np.isnan(hist[3:]).all()


@pytest.mark.parametrize("values,iters", [
    ([1.0, 0.5, 0.2], 3 * 4 + 3),      # unconverged: the tail runs
    ([1.0, 0.5, 5e-4], 3 * 4),         # converged at the last check
    ([1.0, float("nan"), 0.2], 2 * 4),  # NaN exit, no tail
    ([1.0, float("inf"), 0.2], 2 * 4),  # inf exit, no tail
])
def test_chunks_tail_and_non_finite_exit(values, iters):
    it, err, _ = chunks_both(values, 3, 4, 3, 1e-3)
    assert it == iters


def test_chunks_stall_window():
    """A flat residual trips the stall window after `window` checks (and
    skips the tail); with stall=None the loop runs the whole budget."""
    flat = [1.0, 0.5] + [0.4] * 10
    it, _, _ = chunks_both(flat, 10, 2, 1, 1e-3, stall=(0.96, 3))
    assert it < 20
    it, _, _ = chunks_both(flat, 10, 2, 1, 1e-3)
    assert it == 21


def test_chunks_marginal_threshold_compares_in_float32():
    eps = 0.7
    e32 = float(np.float32(eps))
    assert e32 < eps
    it, err, _ = chunks_both([1.0, e32, e32], 3, 2, 1, eps)
    assert it == 7 and err == np.float32(eps)


# scripted check values, one a check of nchk = 4 iterations over a budget
# of 6 checks: (values, eps, stall, err0, rem)
DEVICE_EXITS = {
    "eps": ([1.0, 0.5, 0.25, 1e-4, 1e-5, 1e-6], 1e-3, (0.9, 2), None, 3),
    "stall": ([1.0, 0.8, 0.79, 0.78, 0.77, 0.76], 1e-9, (0.9, 2), None, 3),
    "nan": ([1.0, 0.5, float("nan"), 0.1, 0.1, 0.1], 1e-9, None, None, 3),
    "inf": ([1.0, float("inf"), 0.1, 0.1, 0.1, 0.1], 1e-9, None, None, 3),
    "budget_tail": ([1.0, 0.9, 0.8, 0.7, 0.6, 0.5], 1e-9, (0.9, 2), None,
                    3),
    "budget_no_tail": ([1.0, 0.9, 0.8, 0.7, 0.6, 0.5], 1e-9, None, None,
                       0),
    "err0_no_op": ([1.0, 0.5, 0.25, 1e-4, 1e-5, 1e-6], 1e-3, None, 5e-4,
                   3),
}


def scripted_device(values, nchk, decide=None):
    """A body that runs the whole loop: from rule.it0, check intervals to
    the next multiple of nchk, the k-th check reading values[k-1], until
    rule.stops (or `decide(rule, it, errs)`, a device that decides
    otherwise); the carry counts the iterations."""
    decide = decide or (lambda rule, it, errs: rule.stops(it, errs))

    def run_loop(c, rule):
        it, errs = rule.it0, []
        while True:
            it = (it // nchk + 1) * nchk
            errs.append(values[it // nchk - 1])
            if decide(rule, it, errs):
                return c + (it - rule.it0), np.array(errs, np.float32)
    return run_loop


def scripted_chunks(values, nchk):
    """pt_loop_fused's body on the same values: one check interval a step,
    its check value values[k-1]."""
    def step(c, it):
        nit = nchk - it % nchk
        return c + nit, values[(it + nit) // nchk - 1], nit
    return step


@pytest.mark.parametrize("it0", [0, 1])
@pytest.mark.parametrize("exit_by", list(DEVICE_EXITS))
def test_device_loop_takes_pt_loop_fused_decisions(exit_by, it0):
    """pt_loop_device, its body deciding by ExitRule, gives pt_loop_fused's
    carry, iterations, err and history bit for bit, the tail included."""
    values, eps, stall, err0, rem = DEVICE_EXITS[exit_by]
    nchk, niter = 4, 24
    kw = dict(stall=stall, err0=err0, rem=rem, tail_fn=lambda c: c + 1000)
    ref = torch_loop(scripted_chunks(values, nchk), 0, it0, niter, nchk,
                     niter // nchk, eps, torch.float32, **kw)
    got = pt_loop_device(scripted_device(values, nchk), 0, it0, niter, nchk,
                         eps, torch.float32, 1.0, **kw)
    assert got[:2] == ref[:2]
    np.testing.assert_array_equal(np.float32(got[2]).view(np.int32),
                                  np.float32(ref[2]).view(np.int32))
    np.testing.assert_array_equal(got[3].view(np.int32),
                                  ref[3].view(np.int32))
    ran_tail = got[0] >= 1000
    assert ran_tail == (exit_by == "budget_tail")
    assert (got[1] == it0) == (exit_by == "err0_no_op")


@pytest.mark.parametrize("decide,match", [
    (lambda rule, it, errs: len(errs) == 1, "not ExitRule's"),
    (lambda rule, it, errs: rule.stops(it, errs[:-1]) if len(errs) > 1
     else False, "not ExitRule's"),
    (None, "took no check"),
])
def test_device_loop_refuses_another_decision(decide, match):
    """A body that stops early, runs on past ExitRule's stop or takes no
    check makes pt_loop_device raise."""
    values, eps, stall, _, _ = DEVICE_EXITS["eps"]
    run_loop = (scripted_device(values, 4, decide) if decide is not None
                else lambda c, rule: (c, np.zeros((0,), np.float32)))
    with pytest.raises(RuntimeError, match=match):
        pt_loop_device(run_loop, 0, 1, 24, 4, eps, torch.float32, 1.0,
                       stall=stall)
