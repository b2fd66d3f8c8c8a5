"""K3 (predict) and K4 (correct): the fused non-Poisson chain of the step.

`predict` launches the CUDA kernel of csrc/fused_step.cu for CUDA tensors
and runs `predict_plain` for CPU tensors; `correct` / `correct_plain`
likewise. They replace the Pallas kernels of navierstokes3d_tpu/kernels/
fused_step.py (`build_predict` :440 and `build_correct` :632):

  predict: stress -> predictor V* = V + dt/rho div(tau) (g_eff = 0 under
           the hydrostatic split and for the multi preset, whose g is 0)
           -> cylinder mask -> div(V*);
  correct: V** = V* - dt/rho grad(p) -> cylinder mask -> the velocity BC
           stack of StepConsts.variant ('gpu' or 'multi'; the kernel
           raises ValueError for any other).

The plain versions ARE the ops/physics.py + ops/cylinder.py + bc.py chain,
in the JAX functions' expression order (`predict_ops` / `correct_ops`,
which compat mode runs as the JAX package's unfused `_step_impl` branch
runs them, uncounted). Constants reach the kernels
pre-rounded to float32 exactly as jnp's weak-type promotion rounds them
(the JAX kernels' `_f`, fused_step.py:62). The tracer's mask set
(c = where(mask_c, 1, c)) stays outside both kernels, as in the JAX
package's chained step.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from ..bc import velocity_bc
from ..ops import physics as ph
from ..ops.cylinder import CylinderMasks, mask_velocities
from . import _build

# K4's variant codes (csrc/fused_step.cu ns3d_correct)
VARIANTS = {"gpu": 0, "multi": 1}


@dataclasses.dataclass(frozen=True)
class StepConsts:
    """Physical and grid constants of the step chain (Python floats), and
    the variant whose velocity BC stack K4 applies (with its inlet
    velocity vin, used by the multi variant)."""
    dt: float
    dx: float
    dy: float
    dz: float
    mu: float
    rho: float
    g_eff: float   # 0 under the hydrostatic split
    variant: str
    vin: float


def _f32(x: float) -> ctypes.c_float:
    """A Python constant rounded to float32 as jnp's weak typing rounds it."""
    return ctypes.c_float(float(np.float32(x)))


def _check_velocities(vx, vy, vz, nx, ny, nz, dev):
    _build.require("vx", vx, (nx + 1, ny, nz), torch.float32, dev)
    _build.require("vy", vy, (nx, ny + 1, nz), torch.float32, dev)
    _build.require("vz", vz, (nx, ny, nz + 1), torch.float32, dev)


def _check_masks(masks: CylinderMasks, nx, ny, dev):
    _build.require("mask_vx", masks.mask_vx, (nx + 1, ny), torch.bool, dev)
    _build.require("mask_vy", masks.mask_vy, (nx, ny + 1), torch.bool, dev)
    _build.require("mask_vz", masks.mask_vz, (nx, ny), torch.bool, dev)


# ---- K3 ----

# K3's launch geometry (csrc/fused_step.cu): a block of 16 x 32 threads
# owns a tile of PREDICT_TILE_Y x PREDICT_TILE_Z points of the union grid
# (the threads around it are its halo) and streams a segment of x planes;
# two blocks fit an SM
PREDICT_TILE_Y = 14
PREDICT_TILE_Z = 30
PREDICT_BLOCKS_PER_SM = 2
# PredictSmem: a ring of three stages of three 17 x 33 velocity planes,
# fourteen 512-float planes of stresses and predicted velocities
PREDICT_SMEM_BYTES = 4 * (3 * 3 * 17 * 33 + 14 * 512)


@dataclasses.dataclass(frozen=True)
class PredictPlan:
    """How one K3 launch cuts the (nx+1, ny+1, nz+1) union grid: tiles_y x
    tiles_z tiles of PREDICT_TILE_Y x PREDICT_TILE_Z points (the last of
    each axis ragged) times `segs` x segments of `seg` planes; one block
    per (tile, segment)."""
    tiles_y: int
    tiles_z: int
    seg: int
    segs: int

    @property
    def blocks(self) -> int:
        return self.tiles_y * self.tiles_z * self.segs


@functools.lru_cache(maxsize=64)
def predict_plan(shape: Tuple[int, int, int], sms: int) -> PredictPlan:
    """K3's plan for a grid of `shape` (cells) on a card of `sms` SMs: as
    many x segments as keep the blocks within one wave of
    PREDICT_BLOCKS_PER_SM per SM (at least one). At 255x153x153 on 132
    SMs: 11 x 6 tiles x 4 segments of 64 planes = 264 blocks; at
    511x307x307: 22 x 11 tiles, one segment of 512 planes."""
    nx, ny, nz = shape
    if min(shape) < 1 or sms < 1:
        raise ValueError(f"predict_plan: shape {shape}, sms {sms}")
    tiles_y = -(-(ny + 1) // PREDICT_TILE_Y)
    tiles_z = -(-(nz + 1) // PREDICT_TILE_Z)
    segs = min(nx + 1, max(1, PREDICT_BLOCKS_PER_SM * sms
                           // (tiles_y * tiles_z)))
    seg = -(-(nx + 1) // segs)
    return PredictPlan(tiles_y, tiles_z, seg, -(-(nx + 1) // seg))


def predict_ops(vx, vy, vz, masks: CylinderMasks, k: StepConsts
                ) -> Tuple[torch.Tensor, ...]:
    """Stress, predictor, cylinder mask and divergence as torch ops:
    (vx*, vy*, vz*, divv)."""
    taus = ph.update_tau(vx, vy, vz, k.mu, k.dx, k.dy, k.dz)
    vx, vy, vz = ph.predict_v(vx, vy, vz, *taus, k.rho, k.g_eff, k.dt,
                              k.dx, k.dy, k.dz)
    vx, vy, vz = mask_velocities(vx, vy, vz, masks)
    return vx, vy, vz, ph.update_divv(vx, vy, vz, k.dx, k.dy, k.dz)


def predict_plain(vx, vy, vz, masks: CylinderMasks, k: StepConsts
                  ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of K3: (vx*, vy*, vz*, divv)."""
    predict_plain.calls += 1
    return predict_ops(vx, vy, vz, masks, k)


predict_plain.calls = 0


def predict(vx, vy, vz, masks: CylinderMasks, k: StepConsts
            ) -> Tuple[torch.Tensor, ...]:
    """Fused stress + predictor + cylinder mask + divergence. Returns new
    tensors (vx*, vy*, vz*, divv); the inputs are read only."""
    if not _build.on_cuda(vx, "predict"):
        return predict_plain(vx, vy, vz, masks, k)
    nx, ny, nz = vx.shape[0] - 1, vx.shape[1], vx.shape[2]
    dev = vx.device
    _check_velocities(vx, vy, vz, nx, ny, nz, dev)
    _check_masks(masks, nx, ny, dev)
    outs = (torch.empty_like(vx), torch.empty_like(vy), torch.empty_like(vz),
            torch.empty((nx, ny, nz), dtype=vx.dtype, device=dev))
    plan = predict_plan((nx, ny, nz), _build.sm_count(dev))
    lib = _build.load()
    rc = lib.ns3d_predict(
        vx.data_ptr(), vy.data_ptr(), vz.data_ptr(),
        masks.mask_vx.data_ptr(), masks.mask_vy.data_ptr(),
        masks.mask_vz.data_ptr(), *(o.data_ptr() for o in outs),
        _f32(k.dx), _f32(k.dy), _f32(k.dz), _f32(k.mu), _f32(2.0 * k.mu),
        _f32(3.0), _f32(k.dt / k.rho), _f32(k.rho * k.g_eff),
        nx, ny, nz, plan.tiles_y, plan.tiles_z, plan.seg,
        _build.stream_of(vx))
    _build.check(rc, "predict")
    predict.launches += 1
    return outs


predict.launches = 0


# ---- K4 ----

def correct_ops(vx, vy, vz, pr, masks: CylinderMasks, k: StepConsts,
                set_bc_vel) -> Tuple[torch.Tensor, ...]:
    """correct_v + cylinder mask + set_bc_vel as torch ops."""
    vx, vy, vz = ph.correct_v(vx, vy, vz, pr, k.dt, k.rho, k.dx, k.dy, k.dz)
    vx, vy, vz = mask_velocities(vx, vy, vz, masks)
    return set_bc_vel(vx, vy, vz)


def correct_plain(vx, vy, vz, pr, masks: CylinderMasks, k: StepConsts
                  ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of K4: correct_v + cylinder mask + the
    variant's BCs (bc.velocity_bc)."""
    correct_plain.calls += 1
    return correct_ops(vx, vy, vz, pr, masks, k,
                       velocity_bc(k.variant, k.vin))


correct_plain.calls = 0


def correct(vx, vy, vz, pr, masks: CylinderMasks, k: StepConsts
            ) -> Tuple[torch.Tensor, ...]:
    """Fused pressure correction + cylinder mask + the velocity BC stack of
    k.variant, which the kernel implements as a separable clamped read
    (gpu: no-slip floor; multi: zero-gradient floor, then the inlet plane
    vx = vin). Returns new tensors; the inputs are read only."""
    if not _build.on_cuda(vx, "correct"):
        return correct_plain(vx, vy, vz, pr, masks, k)
    if k.variant not in VARIANTS:
        raise ValueError(f"correct: no kernel for variant {k.variant!r}")
    nx, ny, nz = pr.shape
    dev = vx.device
    _check_velocities(vx, vy, vz, nx, ny, nz, dev)
    _build.require("pr", pr, (nx, ny, nz), torch.float32, dev)
    _check_masks(masks, nx, ny, dev)
    outs = (torch.empty_like(vx), torch.empty_like(vy), torch.empty_like(vz))
    lib = _build.load()
    rc = lib.ns3d_correct(
        vx.data_ptr(), vy.data_ptr(), vz.data_ptr(), pr.data_ptr(),
        masks.mask_vx.data_ptr(), masks.mask_vy.data_ptr(),
        masks.mask_vz.data_ptr(), *(o.data_ptr() for o in outs),
        _f32(k.dx), _f32(k.dy), _f32(k.dz), _f32(-k.dt / k.rho),
        VARIANTS[k.variant], _f32(k.vin), nx, ny, nz, _build.stream_of(vx))
    _build.check(rc, "correct")
    correct.launches += 1
    return outs


correct.launches = 0
