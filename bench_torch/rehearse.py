"""Rehearse every cell of BENCHMARK.json on the CPU at a tiny grid.

    python3 bench_torch/rehearse.py [--nx 63] [--seconds 3]

Runs each cell's traffic through the program's plain PyTorch versions
(CPU tensors), untraced and traced: the set-up, the replayed cycle, the
check against the plain reference and the per-layer readers. It checks
the control flow and the shape of each result's last line and prints the
names it would report, never a number under a device metric's name: a
CPU run measures no device. Exits 1 on a malformed result or a cell that
is not correct at the tiny grid.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(1, os.path.dirname(HERE))

import harness  # noqa: E402

KEYS = ("correct", "attempted", "failed", "metrics", "device")
DEVICE_KEYS = ("platform", "kind", "count", "memory_peak_bytes")


def shape_faults(result: dict, cell: harness.Cell, trace: bool) -> list:
    """What is wrong with a result's shape, against the contract of the
    last line; [] where nothing is."""
    out = [f"no {k}" for k in KEYS if k not in result]
    out += [f"no device.{k}" for k in DEVICE_KEYS
            if k not in result.get("device", {})]
    if list(result)[-1] != "checks":
        out.append("checks is not the last key")
    want = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    got = set(result.get("metrics", {}))
    if not got <= want:
        out.append(f"metrics not in the cell's list: {got - want}")
    if not trace and got != want:
        out.append(f"end-to-end metrics missing: {want - got}")
    for name, m in result.get("metrics", {}).items():
        if set(m) != {"value", "unit"} or not isinstance(
                m["value"], (int, float)):
            out.append(f"metric {name} malformed: {m}")
    json.dumps(result)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--nx", type=int, default=63)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seed", type=int, default=2**31 + 12345)
    a = p.parse_args(argv)
    bench = harness.load_json(harness.REPO / "BENCHMARK.json")
    bad = 0
    for w in bench["workloads"]:
        cell = harness.load_cell(w["name"], a.nx)
        for trace in (False, True):
            r = harness.run_cell(w["name"], a.seed, a.seconds, trace,
                                 device="cpu", nx=a.nx, require_card=False)
            faults = shape_faults(r, cell, trace)
            checks = ", ".join(f"{k} {c['value']:.3e} (limit {c['limit']})"
                               for k, c in r["checks"].items())
            print(f"rehearse {w['name']} trace={int(trace)}: correct "
                  f"{r['correct']}, attempted {r['attempted']}, failed "
                  f"{r['failed']}, metrics {sorted(r['metrics'])} (CPU "
                  f"run: values not device numbers); checks: {checks}"
                  + (f"; SHAPE FAULTS {faults}" if faults else ""),
                  flush=True)
            bad += bool(faults) or not r["correct"]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
