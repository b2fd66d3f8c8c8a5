"""Work arithmetic of the benchmark: bytes and operations of each kernel
group from the grid's shape, and the roofline bounds built from them.

A kernel group is a file under bench_torch/layers/ (see `load_groups`):

  group            the group's name
  layer            the key of the layer it belongs to (poisson,
                   predict_correct, advect, ...)
  patterns         regular expressions matched against the profiler's
                   kernel names
  counter          optional: navierstokes3d_tpu_torch.kernels.<module>.<fn>,
                   whose `.launches` counts the group's launches
  bytes_per_launch [[array, count, bytes per element], ...]: each input
                   read once and each output written once, per launch
  ops_per_cell     floating-point operations per interior cell, per
                   launch or per iteration (`ops_per`): a lower count of
                   the plain version's arithmetic
  ops_per          "launch" or "iteration"

Arrays: "c" a cell-centred field (nx*ny*nz), "v" the three staggered
velocities together, "mask2d" the three (x, y) velocity masks of the
cylinder (one byte each), "c_inner" the interior cells.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

ROOT = Path(__file__).resolve().parent


def load_peaks() -> dict:
    return json.loads((ROOT / "peaks.json").read_text())


def load_groups() -> List[dict]:
    """Every kernel group file, in name order."""
    return [json.loads(p.read_text())
            for p in sorted((ROOT / "layers").glob("*.json"))]


def array_sizes(nx: int, ny: int, nz: int) -> Dict[str, int]:
    return {
        "c": nx * ny * nz,
        "v": (nx + 1) * ny * nz + nx * (ny + 1) * nz + nx * ny * (nz + 1),
        "mask2d": (nx + 1) * ny + nx * (ny + 1) + nx * ny,
        "c_inner": (nx - 2) * (ny - 2) * (nz - 2),
    }


def bytes_per_launch(group: dict, shape: Tuple[int, int, int]
                     ) -> Optional[float]:
    spec = group.get("bytes_per_launch")
    if not spec:
        return None
    sizes = array_sizes(*shape)
    return float(sum(sizes[name] * count * width
                     for name, count, width in spec))


def ops_per_unit(group: dict, shape: Tuple[int, int, int]) -> Optional[float]:
    """Operations per launch or per iteration (`ops_per`)."""
    ops = group.get("ops_per_cell")
    if ops is None:
        return None
    return float(ops) * array_sizes(*shape)["c_inner"]


def launch_bound(group: dict, shape, peaks) -> Optional[Tuple[float, str]]:
    """The least time one launch could take on the card, in seconds, and
    which bound sets it ("bytes" or "operations"); None without bytes."""
    b = bytes_per_launch(group, shape)
    if b is None:
        return None
    t_bytes = b / peaks["hbm_bytes_per_s"]
    ops = ops_per_unit(group, shape) if group.get("ops_per") == "launch" \
        else None
    t_ops = 0.0 if ops is None else ops / peaks["fp32_flops_per_s"]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def per_launch_roofline(layer: str, trace: dict, shape, peaks
                        ) -> Optional[Tuple[float, str]]:
    """A layer whose kernels do one unit of work a launch: the sum of its
    launches' bounds over the sum of their device time, in percent, and
    which bound set the larger part. None where no launch of the layer
    was traced."""
    bound = time = 0.0
    which: Dict[str, float] = {}
    for g in trace["groups"].values():
        if g["layer"] != layer or g["launches"] == 0:
            continue
        lb = launch_bound(g["spec"], shape, peaks)
        if lb is None:
            continue
        bound += lb[0] * g["launches"]
        which[lb[1]] = which.get(lb[1], 0.0) + lb[0] * g["launches"]
        time += g["us"] * 1e-6
    if time <= 0.0:
        return None
    return 100.0 * bound / time, max(which, key=which.get)


def iteration_roofline(layer: str, trace: dict, iterations: int, shape,
                       peaks) -> Optional[Tuple[float, str]]:
    """A layer whose launches may each do several iterations: max(launches
    x bytes per launch / bandwidth, iterations x operations per
    cell-iteration x cells / FLOP rate) over the layer's device time, in
    percent, with the operations of the cheapest group that ran (so the
    bound never counts more work than was done). None where no launch of
    the layer was traced."""
    t_bytes = time = 0.0
    ops = []
    for g in trace["groups"].values():
        if g["layer"] != layer or g["launches"] == 0:
            continue
        b = bytes_per_launch(g["spec"], shape)
        if b is not None:
            t_bytes += g["launches"] * b / peaks["hbm_bytes_per_s"]
        o = ops_per_unit(g["spec"], shape)
        if o is not None:
            ops.append(o)
        time += g["us"] * 1e-6
    if time <= 0.0:
        return None
    t_ops = (iterations * min(ops) / peaks["fp32_flops_per_s"]
             if ops else 0.0)
    if t_bytes >= t_ops:
        return 100.0 * t_bytes / time, "bytes"
    return 100.0 * t_ops / time, "operations"
