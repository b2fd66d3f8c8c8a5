"""PyTorch/CUDA port of the navierstokes3d_tpu solver.

Chorin projection on a staggered MAC grid with a damped pseudo-transient
pressure-Poisson loop, semi-Lagrangian advection and an immersed cylinder,
on one device. The hot path runs hand-written CUDA kernels for CUDA
tensors (navierstokes3d_tpu_torch/csrc) and their plain PyTorch versions
for CPU tensors. The JAX package navierstokes3d_tpu is the reference this
package is held against; this package imports torch and never jax.
"""

import time as _time

# the import's set-up record starts here (utils/profiling.py setup_span)
_T0 = _time.perf_counter()

from .utils.profiling import setup_span as _setup_span  # noqa: E402

with _setup_span("ns3d.setup.import", start=_T0):
    from .config import (IOConfig, NumericsConfig, ParallelConfig,
                         PhysicsConfig, SimConfig, preset_gpu, preset_multi)
    from .grid import Grid, make_grid
    from .models.chorin import ChorinSolver, gather_inner
    from .state import (FlowState, StepStats, state_from_numpy,
                        state_to_numpy, zeros_state)

__version__ = "0.1.0"

__all__ = [
    "SimConfig", "PhysicsConfig", "NumericsConfig", "IOConfig",
    "ParallelConfig", "preset_gpu", "preset_multi", "Grid", "make_grid",
    "ChorinSolver", "gather_inner", "FlowState", "StepStats", "zeros_state",
    "state_from_numpy", "state_to_numpy",
]
