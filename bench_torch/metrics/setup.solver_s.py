"""setup.solver_s: the program's set-up before its first step, in seconds
on the host's clock, from its set-up records
(navierstokes3d_tpu_torch/utils/profiling.py `setup_records`): the
package's import (ns3d.setup.import), then the first solver's build
(ns3d.setup.solver) and init_state (ns3d.setup.init_state). The first
solver built in the process is the harness's; the spans pass builds a
second one before the readers run. None on a program without set-up
records.

The other set-up readers (setup.before_program_s, setup.first_step_s)
load this module for the records and the first solver's."""

from typing import List, Optional

IMPORT = "ns3d.setup.import"
SOLVER = "ns3d.setup.solver"
INIT_STATE = "ns3d.setup.init_state"


def records() -> Optional[List[dict]]:
    """The program's set-up records, or None where it keeps none."""
    from navierstokes3d_tpu_torch.utils import profiling
    read = getattr(profiling, "setup_records", None)
    return None if read is None else read()


def seconds(rec: dict) -> float:
    return rec["end"] - rec["start"]


def first(recs: List[dict], name: str, solver=None) -> Optional[dict]:
    """The first finished record named `name` (of solver `solver` where
    given), or None."""
    for r in recs:
        if r["name"] == name and r["end"] is not None and (
                solver is None or r["solver"] == solver):
            return r
    return None


def first_solver(recs: List[dict]) -> Optional[int]:
    """The serial number of the first solver built in the process."""
    r = first(recs, SOLVER)
    return None if r is None else r["solver"]


def parts(recs: List[dict]) -> Optional[dict]:
    """Seconds of the import and of the first solver's build and
    init_state, or None where one is missing."""
    s = first_solver(recs)
    got = {"import": first(recs, IMPORT), "solver": first(recs, SOLVER, s),
           "init_state": first(recs, INIT_STATE, s)}
    if s is None or None in got.values():
        return None
    return {k: seconds(r) for k, r in got.items()}


def read(ctx):
    recs = records()
    p = None if recs is None else parts(recs)
    if p is None:
        return None
    value = sum(p.values())
    ctx["log"](f"bench: setup.solver_s {value:.6f} s: " + ", ".join(
        f"{k} {v:.6f}" for k, v in p.items())
        + f"; {len(recs)} set-up records in the process")
    return value
