"""The mesh of shards and the block layout of a state on it (port of
navierstokes3d_tpu/parallel/mesh.py).

The reference decomposes the grid over MPI ranks (ImplicitGlobalGrid,
NavierStokes3D_multi_gpu.jl:325); the JAX package lays its fields over a
jax.sharding.Mesh with axes ('x', 'y', 'z'). Here a mesh is P = px*py*pz
shards in one process, each naming its device (shards may share one), and
a sharded field is the list of its blocks in the mesh's C order over
(ix, iy, iz). Cell-centred fields split into equal blocks over all three
axes; a staggered velocity, whose own axis has n+1 entries, splits over
its two other axes and every shard holds its whole staggered extent (the
JAX layout's replication, `state_shardings` :78-96).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import List, Optional, Sequence, Tuple

import torch

from ..state import FIELDS, FlowState

AXES = ("x", "y", "z")
# the staggered axis of each velocity (the others are cell-centred)
STAGGERED = {"vx": 0, "vy": 1, "vz": 2}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """shape (px, py, pz) over AXES and one device per shard, in C order
    over (ix, iy, iz)."""
    shape: Tuple[int, int, int]
    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def coords(self) -> List[Tuple[int, int, int]]:
        """Each shard's position (ix, iy, iz), in shard order."""
        return list(itertools.product(*(range(n) for n in self.shape)))

    def index(self, pos: Sequence[int]) -> int:
        """The shard at position pos."""
        ix, iy, iz = pos
        return (ix * self.shape[1] + iy) * self.shape[2] + iz


def choose_mesh_shape(n_devices: int, nx: Optional[int] = None,
                      min_bx: int = 8) -> Tuple[int, int, int]:
    """Factor n_devices into a mesh shape (px, py, pz) (copy of the JAX
    package's rule, parallel/mesh.py:32-64): the x-only shape (n, 1, 1)
    when nx splits evenly into slabs of at least min_bx planes (the only
    decomposition on which the per-shard Poisson kernels compose), else the
    near-cubic factorization that minimizes halo surface, ties toward
    larger px."""
    if nx is not None and nx % n_devices == 0 and nx // n_devices >= min_bx:
        return (n_devices, 1, 1)
    best = (n_devices, 1, 1)
    best_score = None
    for px in range(1, n_devices + 1):
        if n_devices % px:
            continue
        rest = n_devices // px
        for py in range(1, rest + 1):
            if rest % py:
                continue
            pz = rest // py
            # prefer balanced shapes; tie-break toward larger px
            score = (max(px, py, pz) / min(px, py, pz), -px)
            if best_score is None or score < best_score:
                best, best_score = (px, py, pz), score
    return best


def make_mesh(shape: Optional[Tuple[int, int, int]] = None,
              devices=None) -> Mesh:
    """A mesh of the given shape. devices: one device per shard, or a
    single device (a str or torch.device) that every shard shares; by
    default the visible CUDA devices, one shard each. shape: by default
    choose_mesh_shape(number of devices)."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("make_mesh: no CUDA device is visible; pass "
                               "devices")
    elif isinstance(devices, (str, torch.device)):
        devices = [devices] * (math.prod(shape) if shape else 1)
    devices = tuple(torch.device(d) for d in devices)
    if shape is None:
        shape = choose_mesh_shape(len(devices))
    shape = tuple(int(n) for n in shape)
    if len(shape) != 3 or math.prod(shape) != len(devices):
        raise ValueError(f"mesh shape {shape} != {len(devices)} devices")
    return Mesh(shape, devices)


def split_blocks(t: torch.Tensor, mesh: Mesh,
                 full_axis: Optional[int] = None) -> List[torch.Tensor]:
    """t's blocks on the mesh's block grid, each on its shard's device (a
    view of t where the device is t's and the block is contiguous);
    along full_axis every shard holds the whole extent."""
    sizes = []
    for a, (n, p) in enumerate(zip(t.shape, mesh.shape)):
        if a != full_axis and n % p:
            raise ValueError(f"extent {n} of axis {AXES[a]} does not split "
                             f"into {p} equal blocks")
        sizes.append(n if a == full_axis else n // p)
    out = []
    for pos, dev in zip(mesh.coords(), mesh.devices):
        sl = tuple(slice(None) if a == full_axis
                   else slice(i * b, (i + 1) * b)
                   for a, (i, b) in enumerate(zip(pos, sizes)))
        out.append(t[sl].to(dev).contiguous())
    return out


def join_blocks(blocks: Sequence[torch.Tensor], mesh: Mesh,
                full_axis: Optional[int] = None,
                device=None) -> torch.Tensor:
    """Inverse of split_blocks: the global tensor on `device` (default the
    first shard's); along full_axis the blocks of index 0 are taken."""
    device = mesh.devices[0] if device is None else device
    rng = [range(1) if a == full_axis else range(n)
           for a, n in enumerate(mesh.shape)]
    xs = []
    for ix in rng[0]:
        ys = []
        for iy in rng[1]:
            zs = [blocks[mesh.index((ix, iy, iz))].to(device)
                  for iz in rng[2]]
            ys.append(torch.cat(zs, dim=2))
        xs.append(torch.cat(ys, dim=1))
    return torch.cat(xs, dim=0)


def shard_state(state: FlowState, mesh: Mesh) -> List[FlowState]:
    """Each shard's blocks of a global state (the JAX layout: cell fields
    split over all three axes, a velocity over its two non-staggered
    ones)."""
    per = {name: split_blocks(getattr(state, name), mesh,
                              STAGGERED.get(name)) for name in FIELDS}
    lo = (None if state.pr_lo is None
          else split_blocks(state.pr_lo, mesh))
    return [FlowState(**{name: per[name][s] for name in FIELDS},
                      pr_lo=None if lo is None else lo[s])
            for s in range(mesh.size)]


def unshard_state(shards: Sequence[FlowState], mesh: Mesh,
                  device=None) -> FlowState:
    """Inverse of shard_state: the global state on `device` (default the
    first shard's)."""
    fields = {name: join_blocks([getattr(s, name) for s in shards], mesh,
                                STAGGERED.get(name), device)
              for name in FIELDS}
    lo = (None if shards[0].pr_lo is None
          else join_blocks([s.pr_lo for s in shards], mesh, device=device))
    return FlowState(**fields, pr_lo=lo)
