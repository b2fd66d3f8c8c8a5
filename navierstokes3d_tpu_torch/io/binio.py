"""Raw-binary field dumps in the reference's format.

The reference's save_array (NavierStokes3D_multi_gpu.jl:27-30) writes the
gathered global inner fields as raw Float32 in Julia's column-major order
(A[i,j,k] with i fastest), named `out_save/out_{C,Pr,Vx,Vy,Vz}_v_%04d.bin`
(:515-523). numpy is row-major, so the byte-for-byte layout needs a
Fortran-order serialization: the native runtime (native.py) does it when
it is built, numpy otherwise, with identical bytes. Arrays arrive here as
numpy arrays: tensors leave the device at the caller's I/O boundary.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from . import native


def save_array(path_noext: str, a: np.ndarray, *,
               asynchronous: bool = False) -> str:
    """Write `a` as Float32 raw binary in Julia (column-major) element
    order to `path_noext + '.bin'`; `asynchronous=True` queues the disk
    write on the native runtime's writer thread (native.drain() before
    reading frames back)."""
    fname = path_noext + ".bin"
    arr = np.asarray(a)
    if arr.ndim == 3 and native.write_f32(fname, arr,
                                          asynchronous=asynchronous):
        return fname
    np.asarray(arr, dtype=np.float32).flatten(order="F").tofile(fname)
    return fname


def load_array(fname: str, shape, dtype=np.float32) -> np.ndarray:
    """Read back a reference-format .bin (column-major)."""
    return np.fromfile(fname, dtype=dtype).reshape(shape, order="F")


def save_fields(out_dir: str, iframe: int, fields: Dict[str, np.ndarray]):
    """Frame dump with the reference's naming,
    out_save/out_{name}_v_%04d.bin (NavierStokes3D_multi_gpu.jl:517-521).
    Returns {name: path}."""
    os.makedirs(out_dir, exist_ok=True)
    return {name: save_array(os.path.join(out_dir,
                                          f"out_{name}_v_{iframe:04d}"), arr)
            for name, arr in fields.items()}
