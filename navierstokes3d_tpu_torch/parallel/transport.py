"""The mesh's transport: a neighbour shift and a max over the mesh (the
JAX package's `lax.ppermute` face shift and `lax.pmax`,
parallel/halo.py:31-41 and :297).

Every shard lives in this process, so a shift hands each shard its
neighbour's tensor, copied only where the two shards' devices differ (on
one device the neighbour's plane is read in place: the solve takes its
faces from the iteration's input buffers, which no shard writes during
the iteration). These two functions are the whole interface the
distributed solve uses, so a multi-process transport can take their
place without touching it.
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
