"""setup.first_step_s: the first solver's first step (its set-up record
ns3d.setup.first_step), less nvcc's build of the kernel library inside it
(ns3d.setup.kernels.build), in seconds on the host's clock: the step's
own work plus what runs once a process, the library's load
(ns3d.setup.kernels), each C entry point's first launch
(ns3d.setup.launch: the module's lazy load, cudaFuncSetAttribute) and
torch's own lazy loads. Its log line splits it into those, the step's
self time (what no child span covers), the caching allocator's new
segments and bytes over the step (on the card) and nvcc's seconds (the
program's counters kernels._build.builds and build_s, where it has
them). None on a program without set-up records."""

from pathlib import Path

import harness

base = harness.load_module(Path(__file__).with_name("setup.solver_s.py"),
                           "bench_metric_setup_solver_s")

FIRST_STEP = "ns3d.setup.first_step"
KERNELS = "ns3d.setup.kernels"
BUILD = "ns3d.setup.kernels.build"
LAUNCH = "ns3d.setup.launch"


def split(recs):
    """The first solver's first step and its parts (seconds), or None."""
    s = base.first_solver(recs)
    step = None if s is None else base.first(recs, FIRST_STEP, s)
    if step is None:
        return None
    parent = {r["id"]: r["parent"] for r in recs}

    def inside(r):
        p = r["parent"]
        while p is not None and p != step["id"]:
            p = parent.get(p)
        return p is not None

    below = [r for r in recs if r["end"] is not None and inside(r)]

    def total(name):
        return sum(base.seconds(r) for r in below if r["name"] == name)

    nvcc = total(BUILD)
    children = [r for r in below if r["parent"] == step["id"]]
    return {"value": base.seconds(step) - nvcc,
            "load_s": total(KERNELS) - nvcc, "nvcc_s": nvcc,
            "launches": [(r["detail"].get("entry"), base.seconds(r))
                         for r in below if r["name"] == LAUNCH],
            "self_s": base.seconds(step) - sum(base.seconds(r)
                                               for r in children),
            "new_segments": step["detail"].get("new_segments"),
            "new_bytes": step["detail"].get("new_bytes")}


def read(ctx):
    recs = base.records()
    p = None if recs is None else split(recs)
    if p is None:
        return None
    try:
        from navierstokes3d_tpu_torch.kernels import _build
        built = f"; nvcc in the process {_build.builds} builds, " \
                f"{_build.build_s:.6f} s"
    except (ImportError, AttributeError):
        built = ""
    launched = sum(t for _, t in p["launches"])
    ctx["log"](
        f"bench: setup.first_step_s {p['value']:.6f} s: library load "
        f"{p['load_s']:.6f}, first launches {launched:.6f} ("
        + ", ".join(f"{e} {t:.6f}" for e, t in p["launches"])
        + f"), self {p['self_s']:.6f}; pool {p['new_segments']} new "
        f"segments, {p['new_bytes']} new bytes; nvcc in the step "
        f"{p['nvcc_s']:.6f} s{built}")
    return p["value"]
