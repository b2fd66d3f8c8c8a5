"""Hand-written CUDA kernels of the solver's main path, each beside its
plain PyTorch version.

Every wrapper launches its kernel for CUDA tensors (building the library
on first use, kernels/_build.py) and runs the plain version for CPU
tensors. Each wrapper counts its launches (`wrapper.launches`) and each
plain version its calls (`plain.calls`), so a run can show which path it
took; K2's, K8's, K10's and K12's also count the iterations they
advanced (`.iterations`), and K10's the checks its folded loops took on
the card (`.checks`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from . import advect, fused_step, poisson


@dataclasses.dataclass(frozen=True)
class Kernel:
    name: str
    source: str        # CUDA source, relative to the repository root
    replaces: str      # the Pallas call site it replaces
    wrapper: Callable  # carries .launches
    plain: Callable    # carries .calls


KERNELS = (
    Kernel("K1 poisson_iter", "navierstokes3d_tpu_torch/csrc/poisson.cu",
           "navierstokes3d_tpu/kernels/poisson.py:914",
           poisson.poisson_iter, poisson.poisson_iter_plain),
    Kernel("K2 poisson_iter_ext", "navierstokes3d_tpu_torch/csrc/poisson.cu",
           "navierstokes3d_tpu/kernels/poisson.py:1230",
           poisson.poisson_iter_ext, poisson.poisson_iter_ext_plain),
    Kernel("K3 predict", "navierstokes3d_tpu_torch/csrc/fused_step.cu",
           "navierstokes3d_tpu/kernels/fused_step.py:440",
           fused_step.predict, fused_step.predict_plain),
    Kernel("K4 correct", "navierstokes3d_tpu_torch/csrc/fused_step.cu",
           "navierstokes3d_tpu/kernels/fused_step.py:632",
           fused_step.correct, fused_step.correct_plain),
    Kernel("K5 advect", "navierstokes3d_tpu_torch/csrc/advect.cu",
           "navierstokes3d_tpu/kernels/advect.py:537",
           advect.advect, advect.advect_branch_plain),
    Kernel("K6 advect_pre", "navierstokes3d_tpu_torch/csrc/advect.cu",
           "navierstokes3d_tpu/kernels/advect.py:218",
           advect.advect_pre, advect.advect_pre_plain),
    Kernel("K7 poisson_iter_bc", "navierstokes3d_tpu_torch/csrc/poisson.cu",
           "navierstokes3d_tpu/kernels/poisson.py:914",
           poisson.poisson_iter_bc, poisson.poisson_iter_bc_plain),
    Kernel("K8 poisson_iter_sweeps",
           "navierstokes3d_tpu_torch/csrc/poisson.cu",
           "navierstokes3d_tpu/kernels/poisson.py:836 (K8a), :1007 (K8b)",
           poisson.poisson_iter_sweeps, poisson.poisson_iter_sweeps_plain),
    Kernel("K10 poisson_iter_resident",
           "navierstokes3d_tpu_torch/csrc/poisson.cu",
           "navierstokes3d_tpu/kernels/poisson.py:1151",
           poisson.poisson_iter_resident, poisson.poisson_iter_resident_plain),
    Kernel("K12 poisson_iter_resident_ext",
           "navierstokes3d_tpu_torch/csrc/poisson.cu",
           "none (K10's design carried over to K2)",
           poisson.poisson_iter_resident_ext,
           poisson.poisson_iter_resident_ext_plain),
    Kernel("K7-dist poisson_iter_bc_dist",
           "navierstokes3d_tpu_torch/csrc/poisson.cu",
           "navierstokes3d_tpu/kernels/poisson.py:914 (local_rows)",
           poisson.poisson_iter_bc_dist, poisson.poisson_iter_bc_dist_plain),
    Kernel("K2-dist poisson_iter_ext_bc_dist",
           "navierstokes3d_tpu_torch/csrc/poisson.cu",
           "navierstokes3d_tpu/kernels/poisson.py:1230 (folded=False, "
           "local_rows)",
           poisson.poisson_iter_ext_bc_dist,
           poisson.poisson_iter_ext_bc_dist_plain),
    # K13's two forms: the single word and the (hi, lo) pair, one template
    Kernel("K13 compensated_residual",
           "navierstokes3d_tpu_torch/csrc/poisson.cu",
           "none (XLA computes it: navierstokes3d_tpu/kernels/poisson.py:"
           "1362)",
           poisson.compensated_residual, poisson.compensated_residual_plain),
    Kernel("K13-pair pair_residual",
           "navierstokes3d_tpu_torch/csrc/poisson.cu",
           "none (XLA computes it: navierstokes3d_tpu/models/chorin.py:909)",
           poisson.pair_residual, poisson.pair_residual_plain),
)


def reset_counts() -> None:
    """Set every launch and plain-call count to 0 (also that of
    advect_branch, K5's kernel for one branch, off the main path, and of
    advect_branch_pre_plain, the per-branch part of K6's plain version),
    K2's, K8's, K10's and K12's iteration counts, K10's checks, and the
    iterations the solver's stored-state guarantee added
    (`ChorinSolver.guarantee_iterations`)."""
    from ..models.chorin import ChorinSolver
    for k in KERNELS:
        k.wrapper.launches = 0
        k.plain.calls = 0
    poisson.poisson_iter_ext.iterations = 0
    poisson.poisson_iter_ext_plain.iterations = 0
    poisson.poisson_iter_sweeps.iterations = 0
    poisson.poisson_iter_sweeps_plain.iterations = 0
    poisson.poisson_iter_resident.iterations = 0
    poisson.poisson_iter_resident_plain.iterations = 0
    poisson.poisson_iter_resident.checks = 0
    poisson.poisson_iter_resident_plain.checks = 0
    poisson.poisson_iter_resident_ext.iterations = 0
    poisson.poisson_iter_resident_ext_plain.iterations = 0
    advect.advect_branch.launches = 0
    advect.advect_branch_pre_plain.calls = 0
    ChorinSolver.guarantee_iterations = 0
