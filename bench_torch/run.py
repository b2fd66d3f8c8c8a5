"""Run one benchmark cell of navierstokes3d_tpu_torch on the card, once.

    python3 bench_torch/run.py --workload <name> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

from the root of a checkout. Prints what it measured on earlier lines,
each number compared beside its limit as the last lines of standard
error, and the result as one JSON object on the last line of standard
output. Exits 2, printing no result, where torch finds no CUDA device or
fewer than the cell needs; the harness never falls back to the CPU (the
CPU rehearsal is bench_torch/rehearse.py).
"""

from __future__ import annotations

import os
import sys
import time

T_START = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
# every build and kernel cache inside the checkout, at fixed paths
CACHE = os.path.join(HERE, "_cache")
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = os.path.join(CACHE, sub)
if REPO not in sys.path:
    sys.path.insert(1, REPO)

import argparse  # noqa: E402
import json  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    import harness
    age0 = harness.process_age() - (time.perf_counter() - T_START)
    try:
        result = harness.run_cell(a.workload, a.seed, a.seconds,
                                  bool(a.trace), t_start=T_START,
                                  age0=max(age0, 0.0))
    except harness.NoCard as e:
        print(f"bench: {e}; no result", file=sys.stderr)
        return 2
    print("bench: correct" if result["correct"] else "bench: NOT correct",
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
