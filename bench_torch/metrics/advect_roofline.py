"""advect_roofline: K5's launch bounds summed over the traced cycle, over
its device time."""

import work


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    r = work.per_launch_roofline("advect", tr, ctx["grid"], ctx["peaks"])
    if r is None:
        return None
    ctx["log"](f"bench: advect_roofline {r[0]:.4f}%, set by the {r[1]} "
               f"bound")
    return r[0]
