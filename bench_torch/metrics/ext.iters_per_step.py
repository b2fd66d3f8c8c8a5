"""ext.iters_per_step: the extended (hi, lo) phase's Poisson iterations
per step (StepStats.iters_ext, the stored-state guarantee's included) over
the window's whole cycles, on the pt backend: the window's last cycle may
end after its first step, and the cycle's steps differ (multi511.pt:
2448 and 3366), so a cut cycle would move the mean with where the window
ends. All the window's steps where no cycle is whole. None where a step
reports no iters_ext (a solve without an accuracy phase).

Where the program counts them, the log also splits the process's K2
iterations (`.iterations` of the wrapper and the plain version) into the
loop's and the guarantee's (`ChorinSolver.guarantee_iterations`); a
program without those counters logs nothing more."""

from collections import Counter


def read(ctx):
    if ctx["cell"].traffic["poisson_backend"] != "pt":
        return None
    steps = ctx["window_steps"]
    if not steps or any(s["iters_ext"] is None for s in steps):
        return None
    per_cycle = Counter(s["cycle"] for s in steps)
    nt = int(ctx["cell"].config["nt"])
    steps = [s for s in steps if per_cycle[s["cycle"]] == nt] or steps
    value = sum(s["iters_ext"] for s in steps) / len(steps)
    try:
        import navierstokes3d_tpu_torch as ns
        from navierstokes3d_tpu_torch.kernels import poisson
        k2 = (poisson.poisson_iter_ext.iterations
              + poisson.poisson_iter_ext_plain.iterations)
        added = ns.ChorinSolver.guarantee_iterations
    except AttributeError:
        return value
    ctx["log"](f"bench: ext.iters_per_step {value:.1f}; over the process, "
               f"{k2} K2 iterations, {added} of them the stored-state "
               f"guarantee's and {k2 - added} the loop's")
    return value
