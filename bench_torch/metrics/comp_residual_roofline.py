"""comp_residual_roofline: K13's share of its roofline over the traced
cycle (the compensated residual of the defect phase's restart and of the
stored-state guarantee): max(launches x bytes per launch / HBM bandwidth,
launches x operations per cell x cells / FP32 rate) over the group's
device time, with work.py's bytes and operations of the K13 group, which
count both forms alike (16 B and 180 operations a cell, one evaluation a
launch). None where the trace holds no K13 launch, as on a program
without the kernel."""

import work

K13 = "K13 comp_residual"


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    g = tr["groups"].get(K13)
    if g is None or g["launches"] == 0 or g["us"] <= 0.0:
        return None
    peaks, grid, n = ctx["peaks"], ctx["grid"], g["launches"]
    t_bytes = (n * work.bytes_per_launch(g["spec"], grid)
               / peaks["hbm_bytes_per_s"])
    t_ops = n * work.ops_per_unit(g["spec"], grid) / peaks[
        "fp32_flops_per_s"]
    share = 100.0 * max(t_bytes, t_ops) / (g["us"] * 1e-6)
    steps = len(tr["steps"])
    ctx["log"](f"bench: comp_residual_roofline {share:.4f}%, set by the "
               f"{'bytes' if t_bytes >= t_ops else 'operations'} bound, "
               f"{n} K13 launches in {g['us'] / 1e3:.3f} ms "
               f"({g['us'] / n:.2f} us a launch; "
               f"{n / max(steps, 1):.2f} launches a step over {steps} "
               f"steps)")
    return share
