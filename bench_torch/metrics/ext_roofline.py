"""ext_roofline: K2's share of its roofline over the traced cycle (the
extended (hi, lo) phase where no resident plan fits the grid, one K2
launch an iteration): max(K2 launches x bytes per launch / HBM bandwidth,
K2 launches x operations per cell-iteration x cells / FP32 rate) over
the K2 group's device time, with work.py's bytes and operations of the
K2 group. None where the trace holds no K2 launch."""

import work

K2 = "K2 poisson_iter_ext"


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    k2 = tr["groups"].get(K2)
    if k2 is None or k2["launches"] == 0 or k2["us"] <= 0.0:
        return None
    peaks, grid, n = ctx["peaks"], ctx["grid"], k2["launches"]
    t_bytes = (n * work.bytes_per_launch(k2["spec"], grid)
               / peaks["hbm_bytes_per_s"])
    t_ops = n * work.ops_per_unit(k2["spec"], grid) / peaks[
        "fp32_flops_per_s"]
    share = 100.0 * max(t_bytes, t_ops) / (k2["us"] * 1e-6)
    ctx["log"](f"bench: ext_roofline {share:.4f}%, set by the "
               f"{'bytes' if t_bytes >= t_ops else 'operations'} bound, "
               f"{n} K2 launches in {k2['us'] / 1e3:.3f} ms "
               f"({k2['us'] / n:.2f} us a launch)")
    return share
