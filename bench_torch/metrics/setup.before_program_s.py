"""setup.before_program_s: seconds from the process's start to the start
of the program's import (its set-up record ns3d.setup.import): the
interpreter, the torch import, the harness's nvidia-smi call, the CUDA
context and the reference's masks, none of which a change of the program
can move. The process's start on time.perf_counter()'s clock is
perf_counter() less harness.process_age() (10 ms resolution) at the read.
None on a program without set-up records, or where the process's age is
not known."""

import time
from pathlib import Path

import harness

base = harness.load_module(Path(__file__).with_name("setup.solver_s.py"),
                           "bench_metric_setup_solver_s")


def before_program_s(recs, process_start: float):
    imp = base.first(recs, base.IMPORT)
    return None if imp is None else imp["start"] - process_start


def read(ctx):
    recs = base.records()
    age = harness.process_age()
    if recs is None or age <= 0.0:
        return None
    return before_program_s(recs, time.perf_counter() - age)
