"""defect.iters_per_step: the defect-correction phase's Poisson iterations
per step (StepStats.iters_ext, the guarantee's rounds included) over the
window's steps, on the pt backend. None where a step reports no
iters_ext (a solve without an accuracy phase)."""


def read(ctx):
    if ctx["cell"].traffic["poisson_backend"] != "pt":
        return None
    steps = ctx["window_steps"]
    if not steps or any(s["iters_ext"] is None for s in steps):
        return None
    return sum(s["iters_ext"] for s in steps) / len(steps)
