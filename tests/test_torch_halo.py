"""The port's mesh, transport and halo helpers (navierstokes3d_tpu_torch/
parallel) against the JAX package's: halo_pad, _bc_pr_local and
_bc_pr_local_padded run under shard_map on the 8 virtual CPU devices of
tests/conftest.py on a (2,2,2) mesh, the port's on a (2,2,2) mesh of CPU
shards, from the same seeded float64 blocks: exact. shard_state against
the JAX layout (state_shardings), choose_mesh_shape and resolve_auto_comm
against the JAX package's over a grid of inputs."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import navierstokes3d_tpu as ns
from navierstokes3d_tpu import run as jrun
from navierstokes3d_tpu.parallel import halo as jhalo
from navierstokes3d_tpu.parallel import mesh as jmesh
import navierstokes3d_tpu_torch as nt
from navierstokes3d_tpu_torch import run as trun
from navierstokes3d_tpu_torch.parallel import halo as thalo
from navierstokes3d_tpu_torch.parallel import mesh as tmesh
from navierstokes3d_tpu_torch.parallel import transport

torch.set_num_threads(2)
SHAPE = (2, 2, 2)
BLOCK = (4, 3, 5)          # a shard's block: the global field is (8, 6, 10)
SPEC = P("x", "y", "z")


@pytest.fixture(scope="module")
def meshes():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return (jmesh.make_mesh(SHAPE, jax.devices()[:8]),
            tmesh.make_mesh(SHAPE, "cpu"))


def _global(seed, shape=None):
    rng = np.random.default_rng(seed)
    shape = shape or tuple(b * p for b, p in zip(BLOCK, SHAPE))
    return rng.standard_normal(shape)


def _jax_blocks(jmesh_, fn, x, out_block):
    """fn run per device under shard_map; returns the JAX output's block
    of each mesh position, in the port's shard order."""
    out = np.asarray(jax.jit(shard_map(fn, mesh=jmesh_, in_specs=SPEC,
                                       out_specs=SPEC, check_vma=False))(
        jnp.asarray(x)))
    return [out[tuple(slice(i * b, (i + 1) * b)
                      for i, b in zip(pos, out_block))]
            for pos in itertools.product(*(range(n) for n in SHAPE))]


def _assert_blocks(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("width", [1, 2])
def test_halo_pad_matches_jax(meshes, width):
    jm, tm = meshes
    x = _global(0)
    want = _jax_blocks(jm, lambda b: jhalo.halo_pad(b, width=width), x,
                       tuple(b + 2 * width for b in BLOCK))
    got = thalo.halo_pad(tmesh.split_blocks(torch.tensor(x), tm), tm, width)
    _assert_blocks(got, want)


def _planes(seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(BLOCK[1:]), rng.standard_normal(BLOCK[1:])


@pytest.mark.parametrize("variant,zadd", [("multi", (0.0, 0.0)),
                                          ("gpu", (0.0, 0.0)),
                                          ("gpu", (-0.75, 1.25))])
def test_bc_pr_local_matches_jax(meshes, variant, zadd):
    jm, tm = meshes
    x = _global(1)
    xlo, xhi = _planes(2)
    want = _jax_blocks(jm, lambda b: jhalo._bc_pr_local(
        b, variant, jnp.asarray(xlo), jnp.asarray(xhi), *zadd), x, BLOCK)
    blocks = tmesh.split_blocks(torch.tensor(x), tm)
    got = [thalo._bc_pr_local(b, pos, tm.shape, variant, torch.tensor(xlo),
                              torch.tensor(xhi), *zadd)
           for b, pos in zip(blocks, tm.coords())]
    _assert_blocks(got, want)


@pytest.mark.parametrize("variant", ["multi", "gpu"])
@pytest.mark.parametrize("m", [1, 2])
def test_bc_pr_local_padded_matches_jax(meshes, variant, m):
    jm, tm = meshes
    padded = tuple(b + 2 * m for b in BLOCK)
    x = _global(3, tuple(b * p for b, p in zip(padded, SHAPE)))
    rng = np.random.default_rng(4)
    xlo, xhi = (rng.standard_normal(padded[1:]) for _ in range(2))
    want = _jax_blocks(jm, lambda b: jhalo._bc_pr_local_padded(
        b, variant, jnp.asarray(xlo), jnp.asarray(xhi), m, -0.5, 0.25), x,
        padded)
    blocks = tmesh.split_blocks(torch.tensor(x), tm)
    got = [thalo._bc_pr_local_padded(b, pos, tm.shape, variant,
                                     torch.tensor(xlo), torch.tensor(xhi), m,
                                     -0.5, 0.25)
           for b, pos in zip(blocks, tm.coords())]
    _assert_blocks(got, want)


def test_shard_state_matches_the_jax_layout(meshes):
    """Every shard's block of every field is the JAX sharded array's data
    on the device at the same mesh position (velocities whole along their
    staggered axis), and unshard_state inverts shard_state."""
    jm, tm = meshes
    cfg = nt.preset_multi(nx=16, dtype="float64")
    g = nt.make_grid(cfg)
    rng = np.random.default_rng(5)
    fields = {k: rng.standard_normal(s) for k, s in g.field_shapes().items()}
    jst = jmesh.shard_state(ns.FlowState(**{k: jnp.asarray(v) for k, v in
                                            fields.items()}), jm)
    tst = nt.state_from_numpy(fields, device="cpu")
    shards = tmesh.shard_state(tst, tm)
    dev_pos = {d: pos for pos, d in np.ndenumerate(jm.devices)}
    for name in fields:
        for sh in getattr(jst, name).addressable_shards:
            s = tm.index(dev_pos[sh.device])
            np.testing.assert_array_equal(
                getattr(shards[s], name).numpy(), np.asarray(sh.data), name)
    back = tmesh.unshard_state(shards, tm)
    for name in fields:
        assert torch.equal(getattr(back, name), getattr(tst, name)), name
    assert back.pr_lo is None


def test_shift_and_mesh_max():
    tm = tmesh.make_mesh((3, 1, 2), "cpu")
    faces = [torch.full((2,), float(s)) for s in range(tm.size)]
    right = transport.shift(faces, tm, 0, +1)   # from the left neighbour
    left = transport.shift(faces, tm, 0, -1)
    for s, (ix, iy, iz) in enumerate(tm.coords()):
        want_r = None if ix == 0 else tm.index((ix - 1, iy, iz))
        want_l = None if ix == 2 else tm.index((ix + 1, iy, iz))
        for got, want in ((right[s], want_r), (left[s], want_l)):
            assert (got is None) == (want is None)
            if want is not None:
                assert torch.equal(got, faces[want])
    zs = transport.shift(faces, tm, 2, +1)
    assert [z is None for z in zs] == [iz == 0 for _, _, iz in tm.coords()]
    vals = [torch.tensor(v) for v in (0.5, 3.25, -1.0, 3.0, 2.0, 0.0)]
    assert float(transport.mesh_max(vals, tm)) == 3.25


def test_make_mesh():
    m = tmesh.make_mesh((4, 1, 1), "cpu")
    assert m.size == 4 and m.devices == (torch.device("cpu"),) * 4
    with pytest.raises(ValueError, match="mesh shape"):
        tmesh.make_mesh((2, 2, 1), ["cpu"] * 3)


def test_choose_mesh_shape_matches_jax():
    for n in (1, 2, 3, 4, 6, 8, 12, 16):
        for nx in (None, 15, 16, 32, 63, 64, 255, 256):
            assert (tmesh.choose_mesh_shape(n, nx=nx)
                    == jmesh.choose_mesh_shape(n, nx=nx)), (n, nx)


def test_resolve_auto_comm_matches_jax():
    shapes = [(1, 1, 1), (2, 1, 1), (3, 1, 1), (4, 1, 1), (8, 1, 1),
              (2, 2, 2), (1, 2, 1), (2, 1, 2)]
    for comm, shape, nx, backend, halo, k in itertools.product(
            ("auto", "shard_map", "fullstep"), shapes, (16, 63, 255),
            ("pt", "fdm"), (1, 2), (2, 5)):
        size = int(np.prod(shape))
        args = (comm, size, shape, nx, backend, halo, k)
        try:
            want = jrun.resolve_auto_comm(*args)
        except SystemExit as e:
            with pytest.raises(SystemExit) as got:
                trun.resolve_auto_comm(*args)
            assert str(got.value) == str(e)
            continue
        assert trun.resolve_auto_comm(*args) == want, args
