"""K6's plain version (select-shift advection of one branch from
precomputed advecting velocities) and `advect_unchained` (the four
branches as the JAX package's `build_advect` assembles them) against the
JAX package: its Pallas kernel of kernels/advect.py:218 in interpret mode
(`build_advect(..., interpret=True)`, as tests/test_advect_pallas.py:36
runs it) and the jnp `advect(method='selectshift')` run op by op; with
and without clamped displacements, at k = 2 and 3.

Against the eager jnp backend the values are bitwise equal. Against the
jitted kernel they agree to 4 ulp per element (or 1e-6 of max|field|
where an element is near zero): XLA's CPU compilation rewrites the
displacement dt*v/d of constants dt and d (a division by the reciprocal's
product), which the port evaluates as written (with dt = 1 and a
multiplication by the float32 reciprocal the two are bitwise equal). The
clamp counts are equal. Inside the port, K6 fed the torch-op face
averages is bitwise K5 (the same select-shift sum), and K6 reads no
velocity outside the branch's write region (the zero pads of
`pre_velocities`, the JAX kernel's `wmask`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokes3d_tpu.kernels.advect import build_advect
from navierstokes3d_tpu.ops.advect import advect as jadvect
from navierstokes3d_tpu_torch.kernels import advect as ka
from navierstokes3d_tpu_torch.kernels.fused_step import StepConsts
from navierstokes3d_tpu_torch.ops import advect as tadv

torch.set_num_threads(2)
DX, DY, DZ = 1.0, 1.1, 0.95
# (dims, dt, velocity scale, window k, clamps expected)
CASES = [((17, 9, 9), 0.9, 0.5, 2, False),
         ((16, 8, 8), 1.0, 3.0, 2, True),
         ((12, 7, 5), 0.9, 0.5, 3, False),
         ((16, 8, 8), 1.0, 4.5, 3, True)]


def _fields(nx, ny, nz, seed, scale):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.normal(size=(nx + 1, ny, nz)).astype(f) * scale,
            rng.normal(size=(nx, ny + 1, nz)).astype(f) * scale,
            rng.normal(size=(nx, ny, nz + 1)).astype(f) * scale,
            rng.uniform(size=(nx, ny, nz)).astype(f))


def _consts(dt):
    return StepConsts(dt=dt, dx=DX, dy=DY, dz=DZ, mu=0.0, rho=1.0,
                      g_eff=0.0, variant="gpu", vin=1.0)


def _close(a, b):
    a, b = a.numpy(), np.asarray(b)
    ok = np.abs(a - b) <= np.maximum(
        4 * np.spacing(np.abs(b).astype(np.float32)),
        1e-6 * np.abs(b).max())
    assert ok.all(), np.abs(a - b).max()


@pytest.mark.parametrize("dims,dt,scale,k,clamps", CASES)
def test_advect_unchained_matches_jax_kernel(dims, dt, scale, k, clamps):
    fields = _fields(*dims, 0, scale)
    fn = build_advect(*dims, dt, DX, DY, DZ, k=k, dtype=jnp.float32,
                      interpret=True)
    want = jax.jit(fn)(*map(jnp.asarray, fields))
    ka.advect_branch_pre_plain.calls = 0
    got = ka.advect_unchained(*map(torch.tensor, fields), _consts(dt), k)
    assert ka.advect_branch_pre_plain.calls == 4
    for a, b in zip(got[:4], want[:4]):
        _close(a, b)
    n = int(got[4].item())
    assert n == int(want[4])
    assert (n > 0) == clamps


@pytest.mark.parametrize("dims,dt,scale,k,clamps", CASES)
def test_advect_unchained_bitwise_vs_eager_jnp(dims, dt, scale, k, clamps):
    fields = _fields(*dims, 1, scale)
    with jax.disable_jit():
        want = jadvect(*map(jnp.asarray, fields), dt, DX, DY, DZ,
                       compat=False, method="selectshift", with_stats=True,
                       k=k)
    got = ka.advect_unchained(*map(torch.tensor, fields), _consts(dt), k)
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(got[4].item()) == int(want[4])


@pytest.mark.parametrize("dims,dt,scale,k,clamps", CASES)
def test_k6_is_k5_on_torch_face_averages(dims, dt, scale, k, clamps):
    fields = tuple(map(torch.tensor, _fields(*dims, 2, scale)))
    a = ka.advect_unchained(*fields, _consts(dt), k)
    b = ka.advect(*fields, _consts(dt), k)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("branch", tadv.BRANCHES)
def test_pads_are_zero_and_never_read(branch):
    """pre_velocities pads the branch's staggered axis with zeros (as
    jnp.pad does); K6 reads no velocity there: NaN pads change nothing."""
    vx, vy, vz, c = map(torch.tensor, _fields(10, 7, 6, 3, 2.0))
    a = {"vx": vx, "vy": vy, "vz": vz, "c": c}[branch]
    vels = ka.pre_velocities(branch, vx, vy, vz)
    axis = ka._PAD_AXIS[branch]
    for v in vels:
        assert v.shape == a.shape and v.is_contiguous()
        if axis is not None:
            for end in (0, -1):
                assert not bool(v.select(axis, end).any())
    out, ncl = ka.advect_branch_pre_plain(branch, a, *vels, _consts(1.0), 2)
    if axis is not None:
        poisoned = []
        for v in vels:
            v = v.clone()
            v.select(axis, 0).fill_(float("nan"))
            v.select(axis, -1).fill_(float("nan"))
            poisoned.append(v)
        out2, ncl2 = ka.advect_branch_pre_plain(branch, a, *poisoned,
                                                _consts(1.0), 2)
        assert torch.equal(out, out2) and int(ncl) == int(ncl2)
    ref, ncl_ref = ka.advect_branch_plain(branch, a, vx, vy, vz,
                                          _consts(1.0), 2)
    assert torch.equal(out, ref) and int(ncl) == int(ncl_ref)


def test_wrapper_adds_into_the_clamp_count():
    vx, vy, vz, c = map(torch.tensor, _fields(16, 8, 8, 0, 3.0))
    total = torch.zeros((1,), dtype=torch.int32)
    for branch, a in zip(tadv.BRANCHES, (vx, vy, vz, c)):
        ka.advect_branch_pre(branch, a, *ka.pre_velocities(branch, vx, vy,
                                                           vz),
                             _consts(1.0), 2, total)
    assert int(total.item()) == int(ka.advect_unchained(
        vx, vy, vz, c, _consts(1.0), 2)[4].item()) > 0


@pytest.fixture(scope="module")
def jax_clamped():
    """The JAX package's K6 (build_advect, interpret mode) on CASES[1]'s
    inputs, where displacements clamp."""
    dims, dt, scale, k, _ = CASES[1]
    fields = _fields(*dims, 4, scale)
    fn = build_advect(*dims, dt, DX, DY, DZ, k=k, dtype=jnp.float32,
                      interpret=True)
    return fields, jax.jit(fn)(*map(jnp.asarray, fields))


@pytest.mark.parametrize("mask", range(1, 16))
def test_advect_pre_is_one_branch_calls_and_jax(jax_clamped, mask):
    """K6's call on the branches of a mask (one launch on the card): its
    plain path bitwise equal to one `advect_branch_pre` call per branch,
    the clamp count their sum, and each branch against the JAX package's
    K6 as test_advect_unchained_matches_jax_kernel holds it."""
    fields, want = jax_clamped
    dims, dt, scale, k, _ = CASES[1]
    tensors = dict(zip(tadv.BRANCHES, map(torch.tensor, fields)))
    names = [b for i, b in enumerate(tadv.BRANCHES) if mask >> i & 1]
    vels = {b: ka.pre_velocities(b, tensors["vx"], tensors["vy"],
                                 tensors["vz"]) for b in names}
    total = torch.zeros((1,), dtype=torch.int32)
    ka.advect_pre_plain.calls = ka.advect_branch_pre_plain.calls = 0
    got = ka.advect_pre({b: tensors[b] for b in names}, vels, _consts(dt), k,
                        total)
    assert ka.advect_pre_plain.calls == 1
    assert ka.advect_branch_pre_plain.calls == len(names)
    assert list(got) == names
    one = torch.zeros((1,), dtype=torch.int32)
    for b in names:
        ref = ka.advect_branch_pre(b, tensors[b], *vels[b], _consts(dt), k,
                                   one)
        assert torch.equal(got[b], ref), b
        _close(got[b], want[tadv.BRANCHES.index(b)])
    assert int(total.item()) == int(one.item()) > 0
