"""Flow state and per-step statistics.

FlowState holds the fields as tensors on the solver's device in the JAX
package's canonical 3D layout (x slowest, z fastest). dprdtau is stored at
full cell-centered shape with an inactive (zero) boundary ring.

The solver has no weights, so its state is what crosses between the two
packages: `state_from_numpy` / `state_to_numpy` carry the JAX FlowState's
fields (as numpy arrays) into the port and back out.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from .grid import Grid

FIELDS = ("pr", "vx", "vy", "vz", "c", "dprdtau")


@dataclasses.dataclass
class FlowState:
    pr: torch.Tensor        # pressure, (nx, ny, nz)
    vx: torch.Tensor        # (nx+1, ny, nz)
    vy: torch.Tensor        # (nx, ny+1, nz)
    vz: torch.Tensor        # (nx, ny, nz+1)
    c: torch.Tensor         # tracer concentration, (nx, ny, nz)
    dprdtau: torch.Tensor   # pseudo-time pressure derivative, (nx, ny, nz)
    # low word of the stored (hi, lo) pressure pair (float32 accuracy
    # phases); None until the first step
    pr_lo: Optional[torch.Tensor] = None

    def replace(self, **kw) -> "FlowState":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class StepStats:
    """Per-step record, read on the host (the Poisson loop is host-driven,
    so these are plain numbers, not device tensors).

    err_hist[k] is the residual at the k-th convergence check (NaN for
    checks that never ran); iters_ext counts the accuracy-phase iterations
    (None outside the float32 defect path); advect_clamped counts points
    whose departure displacement exceeded the select-shift window."""
    iters: int
    err: np.floating
    err_hist: np.ndarray
    advect_clamped: Optional[int] = None
    iters_ext: Optional[int] = None
    pr_lo: Optional[torch.Tensor] = None  # internal channel, popped by step


def zeros_state(grid: Grid, dtype: torch.dtype,
                device: torch.device | str = "cuda") -> FlowState:
    def z(shape):
        return torch.zeros(shape, dtype=dtype, device=device)
    return FlowState(
        pr=z(grid.shape_c),
        vx=z(grid.shape_vx),
        vy=z(grid.shape_vy),
        vz=z(grid.shape_vz),
        c=z(grid.shape_c),
        dprdtau=z(grid.shape_c),
    )


def state_from_numpy(fields: Dict[str, np.ndarray],
                     device: torch.device | str = "cuda",
                     dtype: Optional[torch.dtype] = None) -> FlowState:
    """FlowState from a dict of numpy arrays keyed by field name
    (pr, vx, vy, vz, c, dprdtau and optionally pr_lo; a missing or None
    pr_lo stays None). The arrays are copied onto `device`: the card
    unless the caller asks for the CPU, as ChorinSolver's default."""
    def t(a):
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype,
                            device=device)
    lo = fields.get("pr_lo")
    return FlowState(**{k: t(fields[k]) for k in FIELDS},
                     pr_lo=None if lo is None else t(lo))


def state_to_numpy(state: FlowState) -> Dict[str, np.ndarray]:
    """Inverse of state_from_numpy (pr_lo maps to None when absent)."""
    out = {k: getattr(state, k).detach().cpu().numpy() for k in FIELDS}
    out["pr_lo"] = (None if state.pr_lo is None
                    else state.pr_lo.detach().cpu().numpy())
    return out
