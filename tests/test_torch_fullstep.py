"""The port's full-step distributed schedule (parallel/fullstep.py,
ChorinSolver.step_fullstep, `--comm fullstep`) and the pieces it adds
(ops/advect.py's sharded arguments, parallel/halo.py's halo_pad_asym,
parallel/transport.py's mesh_sum and pick_hi) against the JAX package's
(navierstokes3d_tpu/parallel/fullstep.py, tests/test_fullstep.py) and
against the port's own single-device and shard_map steps, on meshes of CPU
shards, from the same seeded inputs.

The grid is nx=20 (20x12x12): the smallest multi/gpu grid that splits
into (2,2,2) and (4,1,1) meshes with every block >= advect_k + 2 = 4 cells
and on which tests/test_fullstep.py's random state stays developed over
two full-budget steps (at nx=16 and 32 it blows up under compat, and the
select-shift window clamps thousands of points). The random state is
tests/test_fullstep.py's `_random_state` construction (O(1) velocities keep
departure points off the backtrack formula's integer-δ discontinuity).
Standard (tests/test_fullstep.py:61-70): float64, equal iteration counts,
zero clamps, every field within 1e-9 of max(1, max|field|), dprdtau
within 100x that."""

import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import navierstokes3d_tpu as ns
import navierstokes3d_tpu_torch as nt
from navierstokes3d_tpu.ops.advect import advect as jadvect
from navierstokes3d_tpu.parallel import fullstep as jfs
from navierstokes3d_tpu.parallel.mesh import make_mesh as jmake_mesh
from navierstokes3d_tpu_torch import kernels
from navierstokes3d_tpu_torch import run as trun
from navierstokes3d_tpu_torch.io import checkpoint
from navierstokes3d_tpu_torch.ops import advect as tadv
from navierstokes3d_tpu_torch.parallel import make_mesh, split_blocks
from navierstokes3d_tpu_torch.parallel.fullstep import (build_fullstep,
                                                        from_dist,
                                                        stag_pad_local,
                                                        to_dist)
from navierstokes3d_tpu_torch.parallel.halo import halo_pad_asym
from navierstokes3d_tpu_torch.parallel.transport import mesh_sum, pick_hi

torch.set_num_threads(2)
NX = 20
FIELDS = ("pr", "vx", "vy", "vz", "c", "dprdtau")
CASES = [("multi", False), ("multi", True), ("gpu", False)]
SHAPES = [(2, 2, 2), (4, 1, 1)]
PRESETS = {"multi": (ns.preset_multi, nt.preset_multi),
           "gpu": (ns.preset_gpu, nt.preset_gpu)}


def _random_state(g, seed=0, vscale=0.7):
    """tests/test_fullstep.py's `_random_state`, as numpy arrays."""
    rng = np.random.default_rng(seed)
    f = lambda s, sc=vscale: rng.uniform(-sc, sc, s)   # noqa: E731
    st = dict(pr=f(g.shape_c, 50.0), vx=f(g.shape_vx), vy=f(g.shape_vy),
              vz=f(g.shape_vz), c=f(g.shape_c, 1.0),
              dprdtau=f(g.shape_c, 0.1))
    d = st["dprdtau"]
    d[0] = d[-1] = d[:, 0] = d[:, -1] = d[:, :, 0] = d[:, :, -1] = 0.0
    return st


def _jax_mesh(shape):
    return jmake_mesh(shape, jax.devices()[:int(np.prod(shape))])


def _jax_state(fields):
    from navierstokes3d_tpu.state import FlowState
    return FlowState(**{k: jnp.asarray(fields[k]) for k in FIELDS})


def _solvers(variant, compat, dtype="float64", **kw):
    jmake, tmake = PRESETS[variant]
    js = ns.ChorinSolver(jmake(nx=NX, nt=2, compat=compat, dtype=dtype,
                               **kw))
    ts = nt.ChorinSolver(tmake(nx=NX, nt=2, compat=compat, dtype=dtype,
                               **kw), device="cpu")
    # the JAX package picks the gather method on the CPU; the port's
    # method is the configuration's (gather under compat only)
    js.advect_method = ts.advect_method
    return js, ts


def _assert_close(want, got, atol=1e-9, msg=""):
    for f in FIELDS:
        a = np.asarray(want[f])
        b = np.asarray(got[f])
        scale = max(1.0, np.abs(a).max())
        tol = 100 * atol if f == "dprdtau" else atol
        np.testing.assert_allclose(b / scale, a / scale, rtol=0, atol=tol,
                                   err_msg=f"{msg} {f}")


def _numpy(state):
    return {f: getattr(state, f).numpy() for f in FIELDS}


# ---- DistState ----

def test_dist_roundtrip_and_blocks_match_jax():
    """to_dist then from_dist is bitwise the input; each shard's blocks
    are the JAX package's to_dist shards on a (2,2,2) mesh."""
    js, ts = _solvers("multi", False)
    fields = _random_state(ts.grid)
    st = nt.state_from_numpy(fields, device="cpu")
    mesh = make_mesh((2, 2, 2), "cpu")
    d = to_dist(st, mesh)
    back = from_dist(d)
    for f in FIELDS:
        assert torch.equal(getattr(back, f), getattr(st, f)), f
    jmesh = _jax_mesh((2, 2, 2))
    jd = jfs.to_dist(_jax_state(fields), jmesh)
    for name in ("pr", "vx", "vy", "vz", "c", "dprdtau", "vx_hi", "vy_hi",
                 "vz_hi"):
        for shard in getattr(jd, name).addressable_shards:
            pos = tuple(int(i) for i in
                        np.argwhere(jmesh.devices == shard.device)[0])
            np.testing.assert_array_equal(
                getattr(d, name)[mesh.index(pos)].numpy(),
                np.asarray(shard.data), err_msg=f"{name} at {pos}")


# ---- ops/advect.py's sharded arguments ----

def _jax_set_masked(origin):
    """parallel/fullstep.py's set_masked (:421-432) for a block origin."""
    def set_fn(target, region, vals, gbounds):
        sub = target[region]
        m = jnp.ones(vals.shape, bool)
        for d, b in enumerate(gbounds):
            if b is None:
                continue
            lo1, hi1 = b
            start = region[d].start or 0
            g1 = (origin[d] + start + 1
                  + jax.lax.broadcasted_iota(jnp.int32, vals.shape, d))
            m = m & (g1 >= lo1) & (g1 <= hi1)
        return target.at[region].set(jnp.where(m, vals, sub))
    return set_fn


def _torch_set_masked(origin):
    def set_fn(target, region, vals, gbounds):
        m = torch.ones(vals.shape, dtype=torch.bool)
        for d, b in enumerate(gbounds):
            if b is None:
                continue
            view = [1, 1, 1]
            view[d] = vals.shape[d]
            g1 = (origin[d] + (region[d].start or 0) + 1
                  + torch.arange(vals.shape[d])).reshape(view)
            m = m & (g1 >= b[0]) & (g1 <= b[1])
        out = target.clone()
        out[region] = torch.where(m, vals, target[region])
        return out
    return set_fn


def _padded_blocks(fields, off0, blk, K):
    """The K-padded local canonical blocks of the four advected fields for
    a block at global cell origin off0 (zeros beyond the global domain),
    as stag_pad_local and halo_pad build them."""
    out = []
    for name, stag in (("vx", 0), ("vy", 1), ("vz", 2), ("c", None)):
        a = np.pad(fields[name], K)
        sl = tuple(slice(o, o + b + 2 * K + (d == stag))
                   for d, (o, b) in enumerate(zip(off0, blk)))
        out.append(a[sl])
    return out


@pytest.mark.parametrize("compat", [False, True])
@pytest.mark.parametrize("method", ["selectshift", "gather"])
@pytest.mark.parametrize("off0", [(0, 0, 0), (5, 6, 3), (15, 6, 9)])
def test_advect_sharded_args_match_jax(method, compat, off0):
    """advect on a halo-padded local block with origin, gshape, set_fn and
    count_box: the JAX package's result (values and clamp count) on the
    same block (for gather on the owned cells: in the halo ring a
    departure point may leave the block, where the JAX package's index
    wraps negative values around and the port clamps; the step crops that
    ring); on the owned cells, the global advect's result."""
    rng = np.random.default_rng(3)
    n, blk, k = (20, 12, 12), (5, 6, 3), 2
    K = k + 1
    fields = {"vx": rng.uniform(-2.5, 2.5, (n[0] + 1, n[1], n[2])),
              "vy": rng.uniform(-2.5, 2.5, (n[0], n[1] + 1, n[2])),
              "vz": rng.uniform(-2.5, 2.5, (n[0], n[1], n[2] + 1)),
              "c": rng.uniform(0, 1, n)}
    dt, dx, dy, dz = 0.9, 1.0, 1.1, 0.95
    pads = _padded_blocks(fields, off0, blk, K)
    origin = tuple(o - K for o in off0)
    owned = tuple((K, K + b) for b in blk)
    kw = dict(compat=compat, method=method, k=k, origin=origin,
              gshape=n, count_box=owned)
    got = tadv.advect(*(torch.tensor(a) for a in pads), dt, dx, dy, dz,
                      set_fn=_torch_set_masked(origin), **kw)
    want = jadvect(*(jnp.asarray(a) for a in pads), dt, dx, dy, dz,
                   with_stats=True, set_fn=_jax_set_masked(origin), **kw)
    own = tuple(slice(K, K + b) for b in blk)
    cut = own if method == "gather" else (slice(None),) * 3
    for g, w, name in zip(got, want, ("vx", "vy", "vz", "c")):
        np.testing.assert_allclose(g[cut].numpy(), np.asarray(w)[cut],
                                   rtol=0, atol=1e-12, err_msg=name)
    assert int(got[4]) == int(want[4])
    whole = tadv.advect(*(torch.tensor(fields[f]) for f in
                          ("vx", "vy", "vz", "c")), dt, dx, dy, dz,
                        compat=compat, method=method, k=k)
    gsl = tuple(slice(o, o + b) for o, b in zip(off0, blk))
    for g, w, name in zip(got, whole, ("vx", "vy", "vz", "c")):
        np.testing.assert_array_equal(g[own].numpy(), w[gsl].numpy(),
                                      err_msg=name)
    if method == "selectshift":
        assert int(got[4]) > 0          # the velocity scale clamps points
    else:
        assert int(got[4]) == 0


@pytest.mark.parametrize("compat", [False, True])
@pytest.mark.parametrize("method", ["selectshift", "gather"])
def test_advect_defaults_are_the_global_path(method, compat):
    """The defaults (origin 0, gshape the arrays' own, the plain write,
    every point counted) are the single-device advect bit for bit."""
    rng = np.random.default_rng(4)
    n = (9, 8, 7)
    fields = [torch.tensor(rng.uniform(-2.5, 2.5, s)) for s in
              ((n[0] + 1, n[1], n[2]), (n[0], n[1] + 1, n[2]),
               (n[0], n[1], n[2] + 1), n)]
    args = (*fields, 0.9, 1.0, 1.1, 0.95)
    want = tadv.advect(*args, compat=compat, method=method, k=2)
    got = tadv.advect(*args, compat=compat, method=method, k=2,
                      origin=(0, 0, 0), gshape=n, set_fn=tadv.set_region,
                      count_box=tuple((0, m + 1) for m in n))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ---- halo_pad_asym and the transport additions ----

@pytest.mark.parametrize("widths", [[(1, 2), (2, 0), (0, 1)],
                                    [(2, 2), (2, 2), (2, 2)],
                                    [(0, 1), (0, 0), (3, 3)]])
def test_halo_pad_asym_matches_global(widths):
    """Each shard's asymmetric pad is the zero-padded global array's
    slice around its block, corners included (axes exchanged in order);
    a 2D plane over its own two mesh axes likewise."""
    mesh = make_mesh((2, 2, 2), "cpu")
    g = torch.arange(8 * 8 * 6, dtype=torch.float64).reshape(8, 8, 6) + 1
    blocks = split_blocks(g, mesh)
    gp = torch.nn.functional.pad(g, sum(reversed(widths), ()))
    blk = blocks[0].shape
    for pos, got in zip(mesh.coords(), halo_pad_asym(blocks, mesh, widths)):
        sl = tuple(slice(p * b, p * b + b + lo + hi)
                   for p, b, (lo, hi) in zip(pos, blk, widths))
        assert torch.equal(got, gp[sl]), pos
    # a (y, z) plane, replicated along x
    plane = torch.arange(8 * 6, dtype=torch.float64).reshape(8, 6) + 1
    planes = [b.squeeze(0) for b in split_blocks(plane[None], mesh,
                                                 full_axis=0)]
    w2 = widths[1:]
    pp = torch.nn.functional.pad(plane, sum(reversed(w2), ()))
    for pos, got in zip(mesh.coords(),
                        halo_pad_asym(planes, mesh, w2, (1, 2))):
        sl = tuple(slice(p * b, p * b + b + lo + hi)
                   for p, b, (lo, hi) in zip(pos[1:], (4, 3), w2))
        assert torch.equal(got, pp[sl]), pos


def test_mesh_sum_and_pick_hi():
    mesh = make_mesh((2, 3, 2), "cpu")
    vals = [torch.tensor(3 * s + 1, dtype=torch.int32)
            for s in range(mesh.size)]
    assert int(mesh_sum(vals, mesh)) == sum(3 * s + 1 for s in range(12))
    planes = [torch.full((2, 2), float(s)) for s in range(mesh.size)]
    for axis in range(3):
        got = pick_hi(planes, mesh, axis)
        for pos, p in zip(mesh.coords(), got):
            src = list(pos)
            src[axis] = mesh.shape[axis] - 1
            assert torch.equal(p, planes[mesh.index(src)]), (axis, pos)


def test_stag_pad_inserts_the_hi_plane_at_the_edge():
    """The padded staggered array of a velocity is the global canonical
    field's zero-padded slice, the hi-face plane at its true position on
    the axis-edge shard only."""
    mesh = make_mesh((2, 2, 2), "cpu")
    g = torch.rand(8, 9, 6, dtype=torch.float64) + 1    # vy: y-staggered
    d = to_dist(nt.FlowState(pr=torch.zeros(8, 8, 6), vx=torch.zeros(9, 8, 6),
                             vy=g, vz=torch.zeros(8, 8, 7),
                             c=torch.zeros(8, 8, 6),
                             dprdtau=torch.zeros(8, 8, 6)), mesh)
    for k in (0, 2):
        gp = torch.nn.functional.pad(g, (k, k, k, k, k, k))
        for pos, got in zip(mesh.coords(),
                            stag_pad_local(d.vy, d.vy_hi, 1, k, mesh)):
            sl = (slice(4 * pos[0], 4 * pos[0] + 4 + 2 * k),
                  slice(4 * pos[1], 4 * pos[1] + 5 + 2 * k),
                  slice(3 * pos[2], 3 * pos[2] + 3 + 2 * k))
            assert torch.equal(got, gp[sl]), (k, pos)


# ---- the full step ----

@pytest.fixture(scope="module")
def jax_fullsteps():
    """Two full-budget JAX build_fullstep steps per case and mesh."""
    out = {}
    for variant, compat in CASES:
        js, ts = _solvers(variant, compat)
        fields = _random_state(ts.grid)
        for shape in SHAPES:
            step = jfs.build_fullstep(js, _jax_mesh(shape))
            d = jfs.to_dist(_jax_state(fields), _jax_mesh(shape))
            for _ in range(2):
                d, stats = step(d)
                assert int(stats.advect_clamped) == 0
            st = jfs.from_dist(d)
            out[variant, compat, shape] = (
                int(stats.iters), {f: np.asarray(getattr(st, f))
                                   for f in FIELDS})
    return out


def _port_fullstep(variant, compat, shape):
    _, ts = _solvers(variant, compat)
    mesh = make_mesh(shape, "cpu")
    step = ts.step_fullstep(mesh)
    d = to_dist(nt.state_from_numpy(_random_state(ts.grid), device="cpu"),
                mesh)
    for _ in range(2):
        d, stats = step(d)
        assert stats.advect_clamped == 0
    return ts, stats, from_dist(d)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("variant,compat", CASES)
def test_fullstep_matches_jax(jax_fullsteps, variant, compat, shape):
    _, stats, st = _port_fullstep(variant, compat, shape)
    iters, want = jax_fullsteps[variant, compat, shape]
    assert stats.iters == iters
    _assert_close(want, _numpy(st))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("variant,compat", CASES)
def test_fullstep_equals_single(variant, compat, shape):
    """tests/test_fullstep.py's test_fullstep_equals_single on the port:
    two full-budget steps of the full step match the solver's own
    single-device steps."""
    ts, stats, st = _port_fullstep(variant, compat, shape)
    ref = nt.state_from_numpy(_random_state(ts.grid), device="cpu")
    for _ in range(2):
        ref, ref_stats = ts.step(ref)
    assert stats.iters == ref_stats.iters
    _assert_close(_numpy(ref), _numpy(st))


@pytest.mark.parametrize("compat", [False, True])
def test_fullstep_kernel_loop_matches_shard_map(compat):
    """float32 multi on a (4,1,1) mesh with use_pallas=True: the solve is
    the kernel loop (the plain K2-dist per shard on CPU tensors, K7-dist
    under compat), held against step_shard_map(mesh, use_pallas=True) as
    tests/test_fullstep.py:121-160 holds the JAX package's (equal
    iterations, err within rtol 1e-3, fields within 2e-5 of max(1,
    max|field|)); the port's two steps run the same torch ops in the same
    order on every owned cell, so here they are equal bit for bit."""
    cfg = nt.preset_multi(nx=NX, nt=1, compat=compat, dtype="float32",
                          use_pallas=True)
    cfg = cfg.replace(numerics=dataclasses.replace(
        cfg.numerics, niter_scale=1, stall_exit=False))
    ts = nt.ChorinSolver(cfg, device="cpu")
    mesh = make_mesh((4, 1, 1), "cpu")
    fields = _random_state(ts.grid)
    kernels.reset_counts()
    d, stats_fs = ts.step_fullstep(mesh)(to_dist(
        nt.state_from_numpy(fields, device="cpu", dtype=torch.float32),
        mesh))
    on = "K7-dist" if compat else "K2-dist"
    for kk in kernels.KERNELS:
        assert kk.wrapper.launches == 0, kk.name
        assert kk.plain.calls == (4 * stats_fs.iters
                                  if kk.name.startswith(on) else 0), kk.name
    st, stats_sm = ts.step_shard_map(mesh, use_pallas=True)(
        nt.state_from_numpy(fields, device="cpu", dtype=torch.float32))
    assert stats_fs.iters == stats_sm.iters > 0
    assert stats_fs.err == stats_sm.err
    got = from_dist(d)
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(st, f)), f


def test_fullstep_checks():
    _, ts = _solvers("multi", False)
    with pytest.raises(ValueError, match="local blocks >= 4"):
        ts.step_fullstep(make_mesh((10, 1, 1), "cpu"))
    with pytest.raises(ValueError, match="divide"):
        ts.step_fullstep(make_mesh((3, 1, 1), "cpu"))
    fdm = nt.preset_gpu(nx=NX, compat=False, dtype="float64")
    fdm = fdm.replace(numerics=dataclasses.replace(fdm.numerics,
                                                   poisson_backend="fdm"))
    with pytest.raises(NotImplementedError, match="fdm"):
        nt.ChorinSolver(fdm, device="cpu").step_fullstep(
            make_mesh((4, 1, 1), "cpu"))
    step = build_fullstep(ts, make_mesh((4, 1, 1), "cpu"))
    d = to_dist(ts.init_state(), make_mesh((2, 2, 2), "cpu"))
    with pytest.raises(ValueError, match="another mesh"):
        step(d)


def test_cli_fullstep_resume_is_bitwise(tmp_path, capsys):
    """`--comm fullstep` through run.main with checkpoints and .bin dumps
    (from_dist at every I/O boundary, to_dist after the resume): a run
    resumed at step 2 ends bitwise where the uninterrupted run ends."""
    base = ["--preset", "multi", "--nx", "16", "--device", "cpu", "--mesh",
            "4x1x1", "--comm", "fullstep", "--checkpoint-every", "1",
            "--save", "--nsave", "1"]
    a, b = tmp_path / "a", tmp_path / "b"
    for d, nts in ((a, ("3",)), (b, ("2", "3"))):
        for n in nts:
            argv = base + ["--nt", n, "--ckpt-dir", str(d / "ck"),
                           "--out-dir", str(d / "out")]
            assert trun.main(argv + (["--resume"] if n == "3" and
                                     d == b else [])) == 0
    assert "comm fullstep" in capsys.readouterr().out
    sa, ia = checkpoint.load_checkpoint(str(a / "ck" / "ckpt_0000003.npz"),
                                        device="cpu")
    sb, ib = checkpoint.load_checkpoint(str(b / "ck" / "ckpt_0000003.npz"),
                                        device="cpu")
    assert ia == ib == 3
    for f in FIELDS:
        assert np.array_equal(np.asarray(getattr(sa, f)),
                              np.asarray(getattr(sb, f))), f
    assert len(glob.glob(os.path.join(a / "out", "out_Pr_v_*.bin"))) == 4
