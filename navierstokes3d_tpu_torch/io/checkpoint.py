"""Checkpoint / resume.

One .npz holds every FlowState field, the step and the pressure
convention, with the JAX package's keys (navierstokes3d_tpu/io/
checkpoint.py): `it`, `pressure_split`, pr, vx, vy, vz, c, dprdtau and,
where the state carries the stored pair's low word, `pr_lo`. So a
checkpoint of either package loads into the other, and a resumed run
continues bit for bit. The fields leave the device here (`.cpu()`) and
return to it through state_from_numpy.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..state import FIELDS, FlowState, state_from_numpy, state_to_numpy


def save_checkpoint(path: str, state: FlowState, it: int,
                    pressure_split: bool = False) -> str:
    """pressure_split records whether state.pr stores p' = Pr - P_static(z)
    (the solver's pressure_split); a resume must use the same convention.
    Returns the written path (numpy appends .npz where it is missing)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrs = state_to_numpy(state)
    if arrs["pr_lo"] is None:
        del arrs["pr_lo"]
    np.savez(path, it=np.int64(it), pressure_split=np.bool_(pressure_split),
             **arrs)
    return path if path.endswith(".npz") else path + ".npz"


def load_checkpoint(path: str, dtype: Optional[torch.dtype] = None,
                    expect_pressure_split: Optional[bool] = None,
                    device: torch.device | str = "cuda"
                    ) -> Tuple[FlowState, int]:
    """(state, it): the state on `device` (the card unless the caller asks
    for the CPU), cast to `dtype` where given."""
    with np.load(path) as z:
        arrs = {f: z[f] for f in FIELDS}
        arrs["pr_lo"] = z["pr_lo"] if "pr_lo" in z else None
        it = int(z["it"])
        split = bool(z["pressure_split"]) if "pressure_split" in z else False
    if expect_pressure_split is not None and split != expect_pressure_split:
        raise ValueError(
            f"checkpoint {path} stores pressure_split={split} but the "
            f"solver expects {expect_pressure_split}; resume with a "
            "matching NumericsConfig.pressure_split")
    return state_from_numpy(arrs, device=device, dtype=dtype), it


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The newest ckpt_*.npz in ckpt_dir (by name: the step is zero-padded),
    or None. nanstate_*.npz snapshots never match."""
    if not os.path.isdir(ckpt_dir):
        return None
    cands = [f for f in os.listdir(ckpt_dir)
             if f.startswith("ckpt_") and f.endswith(".npz")]
    return os.path.join(ckpt_dir, max(cands)) if cands else None
