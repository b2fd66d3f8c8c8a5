"""wide.iters_per_step: the wide grid's Poisson iterations per step, both
phases (StepStats.iters summed over the window's steps, over the steps),
on the pt backend."""


def read(ctx):
    if ctx["cell"].traffic["poisson_backend"] != "pt":
        return None
    steps = ctx["window_steps"]
    if not steps:
        return None
    return sum(s["iters"] for s in steps) / len(steps)
