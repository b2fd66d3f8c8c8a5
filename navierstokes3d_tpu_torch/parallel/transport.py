"""The mesh's transport: a neighbour shift, a max and a sum over the mesh,
and the axis-hi shard's plane to every shard on its axis (the JAX
package's `lax.ppermute` face shift, `lax.pmax` and `lax.psum`,
parallel/halo.py:31-41 and :297, parallel/fullstep.py:235-241 and :443).

Every shard lives in this process, so a shift hands each shard its
neighbour's tensor, copied only where the two shards' devices differ (on
one device the neighbour's plane is read in place: its consumers take
their faces from buffers that no shard writes while they read). The
shard positions are known on the host, so the JAX package's
`axis_index` guards become a choice of source shard. These four functions
are the whole interface the distributed solve and the full step use, so
a multi-process transport can take their place without touching them.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from .mesh import Mesh


def shift(faces: Sequence[torch.Tensor], mesh: Mesh, axis: int,
          direction: int) -> List[Optional[torch.Tensor]]:
    """Each shard's face data received from its neighbour on the
    -direction side along mesh axis `axis` (direction +1: the left
    neighbour's, -1: the right one's), on the shard's device; None at the
    open global boundary, which the consumer reads as zeros (lax.ppermute's
    missing links)."""
    out = []
    for s, pos in enumerate(mesh.coords()):
        src = list(pos)
        src[axis] -= direction
        if not 0 <= src[axis] < mesh.shape[axis]:
            out.append(None)
            continue
        out.append(faces[mesh.index(src)].to(mesh.devices[s]))
    return out


def mesh_max(values: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """The max over the shards' 0-dim values, on the first shard's device
    (exact: a max rounds nothing)."""
    dev = mesh.devices[0]
    return torch.max(torch.stack([v.to(dev) for v in values]))


def mesh_sum(values: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """The sum over the shards' 0-dim integer values, on the first shard's
    device."""
    dev = mesh.devices[0]
    return torch.sum(torch.stack([v.to(dev) for v in values]))


def pick_hi(planes: Sequence[torch.Tensor], mesh: Mesh,
            axis: int) -> List[torch.Tensor]:
    """Each shard's copy of the plane held by the shard at the high end of
    mesh axis `axis` with its other two coordinates (the plane a global
    hi-face family keeps replicated along its own axis), on the shard's
    device."""
    out = []
    for s, pos in enumerate(mesh.coords()):
        src = list(pos)
        src[axis] = mesh.shape[axis] - 1
        out.append(planes[mesh.index(src)].to(mesh.devices[s]))
    return out
