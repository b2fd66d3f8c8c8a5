"""predict_correct_roofline: K3 and K4's launch bounds (bytes per launch
over HBM bandwidth, or operations over the FP32 rate, the larger) summed
over the traced cycle, over their device time."""

import work


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    r = work.per_launch_roofline("predict_correct", tr, ctx["grid"],
                                 ctx["peaks"])
    if r is None:
        return None
    ctx["log"](f"bench: predict_correct_roofline {r[0]:.4f}%, set by the "
               f"{r[1]} bound")
    return r[0]
