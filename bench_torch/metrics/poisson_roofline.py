"""poisson_roofline: the Poisson iteration layer's share of its roofline
over the traced cycle: max(launches x bytes per launch / HBM bandwidth,
iterations x operations per cell-iteration x cells / FP32 rate) over the
layer's device time, iterations from StepStats (work.iteration_roofline),
so a kernel that runs several iterations a launch cannot pass 100%."""

import work


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    iters = sum(s["iters"] for s in tr["steps"])
    r = work.iteration_roofline("poisson", tr, iters, ctx["grid"],
                                ctx["peaks"])
    if r is None:
        return None
    ctx["log"](f"bench: poisson_roofline {r[0]:.4f}%, set by the {r[1]} "
               f"bound, over {iters} iterations")
    return r[0]
