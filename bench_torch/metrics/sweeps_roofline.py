"""sweeps_roofline: K8's share of its roofline over the traced cycle (the
wide grid's sweep plan): max(K8 launches x bytes per launch / HBM
bandwidth, K8 iterations x operations per cell-iteration x cells / FP32
rate) over K8's device time, with work.py's bytes and operations of the
K8 group.

K8's iterations are the traced steps' Poisson iterations (StepStats.iters)
less those no K8 launch advances: one K1 launch is one iteration (the
sweep plan's warm-in, the tails and the stored-state guarantee), and each
step's exact first iteration runs as torch ops. None where the trace holds
no K8 launch."""

import work

K8 = "K8 poisson_iter_sweeps"
K1 = "K1 poisson_iter"


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    k8 = tr["groups"].get(K8)
    if k8 is None or k8["launches"] == 0 or k8["us"] <= 0.0:
        return None
    k1 = tr["groups"].get(K1, {"launches": 0})["launches"]
    steps = tr["steps"]
    iters = sum(s["iters"] for s in steps) - k1 - len(steps)
    peaks, grid = ctx["peaks"], ctx["grid"]
    t_bytes = (k8["launches"] * work.bytes_per_launch(k8["spec"], grid)
               / peaks["hbm_bytes_per_s"])
    t_ops = (iters * work.ops_per_unit(k8["spec"], grid)
             / peaks["fp32_flops_per_s"])
    share = 100.0 * max(t_bytes, t_ops) / (k8["us"] * 1e-6)
    ctx["log"](f"bench: sweeps_roofline {share:.4f}%, set by the "
               f"{'bytes' if t_bytes >= t_ops else 'operations'} bound, "
               f"{k8['launches']} K8 launches for {iters} iterations in "
               f"{k8['us'] / 1e3:.3f} ms")
    return share
