"""MAT-file snapshots in the reference's format.

The gpu script writes `out_save/step_{it}.mat` with keys Pr/Vx/Vy/Vz/C/
dx/dy/dz every nsave steps (NavierStokes3D_gpu.jl:89,169). The
reference's step-0 dict loses Vy to a duplicate key ("Vy"=>Vy then
"Vy"=>Vz, :89); all five fields are written here. Needs scipy; without it
save_step_mat returns None and load_step_mat raises.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

try:
    from scipy.io import loadmat as _loadmat
    from scipy.io import savemat as _savemat
except ImportError:  # pragma: no cover - scipy is optional
    _savemat = _loadmat = None


def save_step_mat(out_dir: str, it: int, pr, vx, vy, vz, c,
                  dx: float, dy: float, dz: float) -> Optional[str]:
    if _savemat is None:
        return None
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"step_{it}.mat")
    _savemat(path, {
        "Pr": np.asarray(pr), "Vx": np.asarray(vx), "Vy": np.asarray(vy),
        "Vz": np.asarray(vz), "C": np.asarray(c),
        "dx": dx, "dy": dy, "dz": dz,
    })
    return path


def load_step_mat(path: str) -> dict:
    if _loadmat is None:
        raise RuntimeError("scipy not available")
    return _loadmat(path)
