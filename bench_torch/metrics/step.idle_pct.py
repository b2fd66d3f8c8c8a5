"""step.idle_pct: the device's idle share of the program's steps: the idle
time in gaps that began while the host sat in ns3d.step, over the steps'
device windows (each from the start of the first operation launched in
the step to the end of the last one), in the spans pass's traced cycle
(bench_torch/spans.py). The harness's restarts and step boundaries lie
outside."""

import spans


def read(ctx):
    r = spans.result(ctx)
    return None if r is None else r["step_idle_pct"]
