"""ptloop.read_wait_ms_per_step: the device's idle time in the gaps that
began while the host sat in ns3d.read (a read of a device scalar), within
the step's device window, per step of the spans pass's traced cycle
(bench_torch/spans.py)."""

import spans


def read(ctx):
    r = spans.result(ctx)
    return None if r is None else r["read_wait_ms_per_step"]
