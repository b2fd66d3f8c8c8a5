"""Chunked pseudo-transient convergence loop, driven from the host (torch
port of navierstokes3d_tpu/ptloop.py `pt_loop_fused`).

Replicates the reference's `for iter=1:niter ... break` control flow
(NavierStokes3D_gpu.jl:126-137): iterate, check the residual every nchk
iterations, stop on convergence (err < eps_it), a non-finite err, or the
budget. The JAX package runs this as one lax.while_loop on the device;
here the host drives it and reads ONE device scalar per nchk-iteration
chunk (the check value), so the card never waits on the host between
checks.

All exit comparisons run in the loop's dtype (numpy float32 for float32
solves), with the Python constants rounded to that dtype first, exactly as
JAX's weak-type promotion rounds them: promoting a float32 err to a Python
float would flip marginal checks and shift iteration counts.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch


def np_float(dtype) -> type:
    """numpy scalar type of a torch or numpy float dtype."""
    if isinstance(dtype, torch.dtype):
        return {torch.float32: np.float32, torch.float64: np.float64}[dtype]
    return np.dtype(dtype).type


def host_scalar(e, ft: type):
    """A device or host scalar as a numpy scalar of type ft (one device
    read for a tensor)."""
    if isinstance(e, torch.Tensor):
        e = e.item()
    return ft(e)


def pt_loop_fused(step_fn: Callable, carry, it0: int, niter: int, nchk: int,
                  nchunks: int, eps_it: float, dtype,
                  stall: Optional[Tuple[float, int]] = None, err0=None):
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
    Returns (carry, iters, err, hist)."""
    ft = np_float(dtype)
    big = ft(1e30)
    stall_on = stall is not None
    ratio, window = stall if stall_on else (0.0, 1)
    window = max(int(window), 1)
    thresh = ft(ratio ** window)
    eps = ft(eps_it)
    nhist = max(nchunks, 1)
    n_checked = nchunks * nchk

    def stalled(err, errbuf):
        return bool((err > thresh * errbuf[0]) & (errbuf[0] < big))

    def running(it, err, errbuf):
        ok = it < niter and bool(err >= eps) and bool(np.isfinite(err))
        return ok and not (stall_on and stalled(err, errbuf))

    hist = np.full((nhist,), np.nan, ft)
    errbuf = [big] * (window + 1)
    err = big if err0 is None else host_scalar(err0, ft)
    it = int(it0)
    while running(it, err, errbuf):
        carry, e, nadv = step_fn(carry, it)
        it += int(nadv)
        if it % nchk == 0 and it <= n_checked:
            err = host_scalar(e, ft)
            hist[min(max(it // nchk - 1, 0), nhist - 1)] = err
            errbuf = errbuf[1:] + [err]
    return carry, it, err, hist
