"""The points at which the port's advection departs from the source's
departure formula, for the tests that hold the port against the JAX
package, which keeps the source's expressions.

The source takes the departure corner from floor(fl(i - dl)) (gpu.jl
:290-293); the port's non-compat corner is i - ceil(dl), the same floor
computed exactly (ops/advect.py `departure_cell`). The two differ only
where the rounded i - dl lands on a whole number; there the source reads
the cell next to its own. `fault_points` marks those points from the
advecting velocities alone, independently of the advection's code: the
select-shift displacement dl = clip(dt v / h, -k, k) on each axis, both
corners clamped to [1, n] as the advection clamps them."""

import torch

from navierstokes3d_tpu_torch.kernels import advect as ka
from navierstokes3d_tpu_torch.ops import advect as adv
from navierstokes3d_tpu_torch.ops.stencil import div


def _field_shape(branch, vx, vy, vz):
    if branch == "vx":
        return vx.shape
    if branch == "vy":
        return vy.shape
    if branch == "vz":
        return vz.shape
    return (vy.shape[0], vx.shape[1], vx.shape[2])


def fault_points(branch, vx, vy, vz, consts, window):
    """A bool array of the branch's field shape (numpy): True at the
    points of its write region where, on some axis, clamp(floor(fl(i -
    dl)), 1, n) != clamp(i - ceil(dl), 1, n)."""
    vels = adv.face_velocities(branch, vx, vy, vz)
    shape = _field_shape(branch, vx, vy, vz)
    starts = adv._STARTS[branch]
    rs = torch.broadcast_shapes(*(v.shape for v in vels))
    bad = torch.zeros(rs, dtype=torch.bool)
    for axis, (v, h) in enumerate(zip(vels, (consts.dx, consts.dy,
                                             consts.dz))):
        n = shape[axis]
        view = [1, 1, 1]
        view[axis] = rs[axis]
        i = torch.arange(starts[axis], starts[axis] + rs[axis],
                         dtype=v.dtype).reshape(view)
        dl = torch.clamp(div(consts.dt * v, h), -window, window)
        source = torch.clamp(torch.floor(i - dl), 1, n)
        exact = torch.clamp(i - torch.ceil(dl), 1, n)
        bad = bad | (source != exact)
    out = torch.zeros(shape, dtype=torch.bool)
    out[tuple(slice(s - 1, s - 1 + m) for s, m in zip(starts, rs))] = bad
    return out.numpy()


def record_advect(monkeypatch):
    """Record the post-BC velocities, constants and window of each of K5's
    calls (kernels/advect.py `advect`) from here on: a list of dicts,
    branch -> fault_points, one per call."""
    calls = []
    launch = ka.advect

    def recorded(vx, vy, vz, c, k, window=2, plain=False):
        calls.append({b: fault_points(b, vx, vy, vz, k, window)
                      for b in adv.BRANCHES})
        return launch(vx, vy, vz, c, k, window, plain)
    monkeypatch.setattr(ka, "advect", recorded)
    return calls
