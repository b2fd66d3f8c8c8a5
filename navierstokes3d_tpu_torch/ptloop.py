"""Chunked pseudo-transient convergence loops, driven from the host (torch
port of navierstokes3d_tpu/ptloop.py: `pt_loop_fused` and `pt_loop`).

Replicates the reference's `for iter=1:niter ... break` control flow
(NavierStokes3D_gpu.jl:126-137): iterate, check the residual every nchk
iterations, stop on convergence (err < eps_it), a non-finite err, or the
budget. The JAX package runs this as one lax.while_loop on the device;
here the host drives it and reads ONE device scalar per nchk-iteration
chunk (the check value), so the card never waits on the host between
checks. `pt_loop_device` is the same loop for a body that runs all its
check intervals in one launch and takes every exit decision on the card
(`ExitRule`), so the host reads once a loop. `pt_loop` is the
reference's exact loop, which compat mode runs: the check value is a
separate residual evaluation after each chunk, also one device read per
chunk.

All exit comparisons run in the loop's dtype (numpy float32 for float32
solves), with the Python constants rounded to that dtype first, exactly as
JAX's weak-type promotion rounds them: promoting a float32 err to a Python
float would flip marginal checks and shift iteration counts.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .utils.profiling import span


def np_float(dtype) -> type:
    """numpy scalar type of a torch or numpy float dtype."""
    if isinstance(dtype, torch.dtype):
        return {torch.float32: np.float32, torch.float64: np.float64}[dtype]
    return np.dtype(dtype).type


def host_scalar(e, ft: type):
    """A device or host scalar as a numpy scalar of type ft (one device
    read for a tensor, counted in `host_scalar.reads` and spanned as
    ns3d.read). Every read of a device scalar by the step goes through
    here, so the count is the number of times a step makes the card wait
    on the host (reset_reads clears it)."""
    if isinstance(e, torch.Tensor):
        host_scalar.reads += 1
        with span("ns3d.read"):
            e = e.item()
    return ft(e)


host_scalar.reads = 0


def host_array(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array of its dtype (float32, float64 or int32):
    one device read for the whole tensor, counted in `host_scalar.reads`
    and spanned as ns3d.read, as host_scalar's."""
    host_scalar.reads += 1
    with span("ns3d.read"):
        values = t.tolist()
    return np.asarray(values, dtype=np.int32 if t.dtype == torch.int32
                      else np_float(t.dtype))


def reset_reads() -> None:
    """Set the count of device scalars read by the host to 0."""
    host_scalar.reads = 0


class _Stall:
    """The stall window: exit when err > ratio**window times the err of
    `window` checks earlier (errbuf starts at `big`, so the first `window`
    checks cannot trip it). stall=None turns it off."""

    def __init__(self, stall: Optional[Tuple[float, int]], ft: type):
        self.on = stall is not None
        ratio, window = stall if self.on else (0.0, 1)
        window = self.window = max(int(window), 1)
        self.thresh = ft(ratio ** window)
        self.big = ft(1e30)
        self.errbuf = [self.big] * (window + 1)

    def push(self, err) -> None:
        self.errbuf = self.errbuf[1:] + [err]

    def stalled(self, err) -> bool:
        e0 = self.errbuf[0]
        return self.on and bool((err > self.thresh * e0) & (e0 < self.big))


def _unconverged(err, eps) -> bool:
    return bool(err >= eps) and bool(np.isfinite(err))


@dataclasses.dataclass(frozen=True)
class ExitRule:
    """pt_loop_fused's exit decision, in the numbers a kernel that runs
    the whole loop takes it from (kernels/poisson.py
    `poisson_loop_resident`). The loop starts at global iteration it0 <
    niter (a multiple of nchk) and runs check intervals, each to the next
    multiple of nchk. After the check landing on iteration it, with errs
    the loop's check values so far (the newest last, each max|resid| x
    scale), it stops where it >= niter, where the newest is not >= eps or
    not finite, or where the stall window fires (window > 0: the newest >
    thresh x the value `window` checks before it, where there is one and
    it is below big). Every number and operation is float32, as _Stall
    takes them."""
    it0: int
    niter: int
    nchk: int
    eps: np.float32
    scale: np.float32
    window: int
    thresh: np.float32
    big: np.float32

    @property
    def max_checks(self) -> int:
        """The most checks the loop can take before its budget ends."""
        return self.niter // self.nchk - self.it0 // self.nchk

    def stalled(self, errs) -> bool:
        """The stall window fires on the newest of errs."""
        if not self.window or len(errs) <= self.window:
            return False
        err, e0 = errs[-1], errs[-1 - self.window]
        return bool((err > self.thresh * e0) & (e0 < self.big))

    def stops(self, it: int, errs) -> bool:
        return (not (it < self.niter and _unconverged(errs[-1], self.eps))
                or self.stalled(errs))


def pt_loop(run_iters: Callable, residual_err: Callable, pr, dpr,
            nchunks: int, nchk: int, rem: int, eps_it: float, dtype,
            stall: Optional[Tuple[float, int]] = None):
    """The reference's chunk loop (JAX `pt_loop`): run_iters(pr, dpr, n, k)
    -> (pr, dpr) advances n iterations (k = chunk index); residual_err(pr)
    -> err (a device scalar, read once per chunk). Chunks run while
    k < nchunks, err >= eps_it, err is finite and (with a stall window)
    the iteration has not stalled; the trailing `rem` iterations run only
    when the loop ends on the chunk budget without converging or stalling.
    Returns (pr, dpr, iters, err, hist)."""
    ft = np_float(dtype)
    eps = ft(eps_it)
    window = _Stall(stall, ft)
    hist = np.full((max(nchunks, 1),), np.nan, ft)
    err, k = window.big, 0

    def unconverged(err):
        return _unconverged(err, eps)

    while k < nchunks and unconverged(err) and not window.stalled(err):
        pr, dpr = run_iters(pr, dpr, nchk, k)
        err = host_scalar(residual_err(pr), ft)
        hist[k] = err
        window.push(err)
        k += 1
    iters = k * nchk
    if (rem > 0 and k >= nchunks and unconverged(err)
            and not window.stalled(err)):
        pr, dpr = run_iters(pr, dpr, rem, k)
        iters += rem
    return pr, dpr, iters, err, hist


def pt_loop_fused(step_fn: Callable, carry, it0: int, niter: int, nchk: int,
                  nchunks: int, eps_it: float, dtype,
                  stall: Optional[Tuple[float, int]] = None, err0=None,
                  rem: int = 0, tail_fn: Optional[Callable] = None,
                  seed0: bool = False):
    """Flat loop over ITERATIONS for backends whose iteration emits its own
    residual max.

    step_fn(carry, it) -> (carry, err, nadv): advance nadv iterations from
    global iteration `it`; err is the residual (already in err units) of
    the state ENTERING the last iteration performed. It is read only when
    the iteration count lands on a check (a multiple of nchk within the
    first nchunks*nchk iterations), so step_fn may return None elsewhere.

    Semantics (identical to the JAX loop): the k-th check value is the
    residual entering iteration k*nchk; past the last full chunk the
    remaining niter budget runs unchecked (the reference's trailing partial
    chunk); the stall exit fires when err > ratio**window times the err of
    `window` checks earlier. it0: iterations already performed outside the
    loop. err0: initial err (default a sentinel that cannot trigger the
    eps exit) — a value below eps_it makes the loop a no-op.
    tail_fn(carry) -> carry: the trailing partial chunk of `rem`
    iterations, run after the loop (so niter can stay a multiple of the
    body's advance) and only where the loop ran out of budget without
    converging, without a non-finite err and without stalling: the same
    predicate as pt_loop's tail.
    seed0=True: err0 IS the k = 0 check (the caller ran the whole first
    chunk outside the loop, e.g. one resident-chunk launch of nit = nchk
    iterations, kernels/poisson.py make_resident): it goes into hist[0]
    and the stall window, so the loop sees the check sequence of a loop
    whose first body emitted it. Requires err0 and it0 == nchk.
    Returns (carry, iters, err, hist)."""
    ft = np_float(dtype)
    window = _Stall(stall, ft)
    eps = ft(eps_it)
    nhist = max(nchunks, 1)
    n_checked = nchunks * nchk

    def unconverged(err):
        return _unconverged(err, eps)

    def running(it, err):
        return it < niter and unconverged(err) and not window.stalled(err)

    hist = np.full((nhist,), np.nan, ft)
    err = window.big if err0 is None else host_scalar(err0, ft)
    it = int(it0)
    if seed0:
        if err0 is None or it != nchk:
            raise ValueError("seed0 requires err0 and it0 == nchk")
        hist[0] = err
        window.push(err)
    while running(it, err):
        carry, e, nadv = step_fn(carry, it)
        it += int(nadv)
        if it % nchk == 0 and it <= n_checked:
            err = host_scalar(e, ft)
            hist[min(max(it // nchk - 1, 0), nhist - 1)] = err
            window.push(err)
    if (rem > 0 and tail_fn is not None and it >= niter and unconverged(err)
            and not window.stalled(err)):
        carry = tail_fn(carry)
        it += rem
    return carry, it, err, hist


def pt_loop_device(run_loop: Callable, carry, it0: int, niter: int,
                   nchk: int, eps_it: float, dtype, err_scale: float,
                   stall: Optional[Tuple[float, int]] = None, err0=None,
                   rem: int = 0, tail_fn: Optional[Callable] = None):
    """pt_loop_fused over a budget of niter iterations (a multiple of
    nchk, so every check lies within it) for a body that runs the whole
    loop itself and takes each exit decision on the device.

    run_loop(carry, rule) -> (carry, errs): from global iteration
    rule.it0, run check intervals to the next multiple of nchk until
    `rule` (an ExitRule) stops the loop, and return the check values it
    took, in order, as a numpy float32 array in err units (max|resid| x
    err_scale in float32), read in one host_array. The host takes the
    first decision itself (an err0 below eps_it makes the loop a no-op,
    with no launch), checks each of the device's decisions against
    rule.stops (raising where they differ), and runs the trailing `rem`
    iterations (tail_fn) on pt_loop_fused's predicate. Returns
    pt_loop_fused's (carry, iters, err, hist)."""
    if niter % nchk:
        raise ValueError(f"pt_loop_device: niter {niter} is not a multiple "
                         f"of nchk {nchk}")
    ft = np_float(dtype)
    window = _Stall(stall, ft)
    eps = ft(eps_it)
    hist = np.full((max(niter // nchk, 1),), np.nan, ft)
    err = window.big if err0 is None else host_scalar(err0, ft)
    it = int(it0)
    rule = ExitRule(it, niter, nchk, eps, ft(err_scale),
                    window.window if window.on else 0, window.thresh,
                    window.big)
    errs = ()
    # the window is empty before the loop's first check: it cannot stall
    if it < niter and _unconverged(err, eps):
        carry, errs = run_loop(carry, rule)
        for n in range(len(errs)):
            it = (it // nchk + 1) * nchk
            if rule.stops(it, errs[:n + 1]) != (n == len(errs) - 1):
                raise RuntimeError(f"pt_loop_device: the device's decision "
                                   f"after the check at iteration {it} is "
                                   f"not ExitRule's")
            hist[it // nchk - 1] = errs[n]
        if len(errs) == 0:
            raise RuntimeError("pt_loop_device: the device took no check")
        err = ft(errs[-1])
    if (rem > 0 and tail_fn is not None and it >= niter
            and _unconverged(err, eps) and not rule.stalled(errs)):
        carry = tail_fn(carry)
        it += rem
    return carry, it, err, hist
