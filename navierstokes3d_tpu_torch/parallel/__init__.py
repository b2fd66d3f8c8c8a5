"""Spatial domain decomposition of the port: the mesh of shards, the block
layout of a state on it, the transport between shards and the distributed
Poisson solve (the JAX package's parallel/ package, `--comm shard_map`)."""

from .halo import build_poisson_shard_map, halo_pad
from .mesh import (Mesh, choose_mesh_shape, join_blocks, make_mesh,
                   shard_state, split_blocks, unshard_state)
from .transport import mesh_max, shift

__all__ = ["Mesh", "choose_mesh_shape", "make_mesh", "split_blocks",
           "join_blocks", "shard_state", "unshard_state", "shift",
           "mesh_max", "halo_pad", "build_poisson_shard_map"]
