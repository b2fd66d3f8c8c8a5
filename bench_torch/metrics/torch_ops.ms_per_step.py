"""torch_ops.ms_per_step: device time of every operation that no kernel
group (layers/*.json) claims, over the traced steps: the torch ops around
the kernels (accuracy phase, residual checks, BCs), copies and fills."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr["steps"] or tr["kernels"] == 0:
        return None
    return tr["unclaimed_us"] / 1e3 / len(tr["steps"])
