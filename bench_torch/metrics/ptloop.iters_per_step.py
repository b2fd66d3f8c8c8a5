"""ptloop.iters_per_step: Poisson iterations per step over the window's
steps (StepStats.iters summed, over the steps), on the pt backend."""


def read(ctx):
    if ctx["cell"].traffic["poisson_backend"] != "pt":
        return None
    steps = ctx["window_steps"]
    if not steps:
        return None
    return sum(s["iters"] for s in steps) / len(steps)
