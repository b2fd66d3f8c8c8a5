"""ptloop.host_reads_per_step: reads of a device scalar by the host
(ptloop.host_scalar.reads, the program's counter) over the spans pass's
traced cycle, per step (bench_torch/spans.py)."""

import spans


def read(ctx):
    r = spans.result(ctx)
    return None if r is None else r["host_reads_per_step"]
